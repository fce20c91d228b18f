"""The port's block-BoxMG elastic solver
(multigrid_feanet_torch/solvers/elastic_boxmg.py) against the JAX
``ElasticBoxMG``, on the CPU, in f64, at n = 16 and full depth.

The f = 0 decay protocol from a standard normal start (rng 3) on the
bi-material plane-stress problem (E = 212e3, nu = 0.288, circle (1, 20)):
8 V(2,2) and 8 W(2,2) cycles, every residual within 1e-9 relative of the
JAX solver's.  Both solvers run the port's setup (carried into JAX), so the
cycles are held apart from the setup, which tests/test_torch_boxmg_elastic.py
holds against JAX's; tests/test_torch_elastic_boxmg_solver_n32.py runs the
port on JAX's setup, carried across by
``core/convert.elastic_boxmg_setup_from_arrays``, and holds the convergence
claim at n = 64.  The JAX solver's two cycles are compiled as one program.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.ops.elasticity import elastic_interior_norm
from multigrid_feanet_tpu.solvers import elastic as jes
from multigrid_feanet_tpu.solvers.elastic_boxmg import ElasticBoxMG as JElasticBoxMG

from multigrid_feanet_torch.core.convert import elastic_boxmg_setup_from_arrays
from multigrid_feanet_torch.ops.boxmg_elastic import boxmg_elastic_setup
from multigrid_feanet_torch.solvers import elastic as tes
from multigrid_feanet_torch.solvers.elastic_boxmg import ElasticBoxMG

E, NU = 212e3, 0.288  # Plane_Stress_modify.m:11-12
COEF = (1.0, 20.0)
CIRCLE = ("circle", (0.0, 0.0), 0.5)
CYCLES = 8


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tail_q(hist, k=6):
    return float(np.exp(np.mean(np.diff(np.log(np.asarray(hist)))[-k:])))


def _start(n, seed):
    u0 = np.random.default_rng(seed).standard_normal((2, n + 1, n + 1))
    g = np.zeros((n + 1, n + 1))
    g[1:-1, 1:-1] = 1.0
    return u0 * g, np.zeros_like(u0)


def jax_histories(jl, setup, u0, f, num_levels=None):
    """The JAX solver's V(2,2) and W(2,2) histories over CYCLES cycles, in
    one compiled program (the chunked loop of ``ElasticBoxMG.solve``)."""
    bm = JElasticBoxMG(jl, num_levels=num_levels, setup=setup)
    geo = jl[0].geo[None]

    @jax.jit
    def run(u):
        hists = []
        for gamma in (1, 2):
            def body(u, _, gamma=gamma):
                u = bm.v_cycle(u, f, 2, 2, gamma=gamma)
                return u, elastic_interior_norm((f - bm._apply(0, u)) * geo)
            hists.append(jax.lax.scan(body, u * geo, None, length=CYCLES)[1])
        return hists

    return [np.asarray(h) for h in run(jnp.asarray(u0))]


@pytest.fixture(scope="module")
def n16():
    """The n = 16 problem on both sides, the port's setup and the JAX
    solver's histories on it."""
    n = 16
    kw = dict(inclusion=CIRCLE, coefficients=COEF)
    jl = jes.build_elastic_hierarchy(n, E, NU, dtype=jnp.float64, **kw)
    tl = tes.build_elastic_hierarchy(n, E, NU, dtype=torch.float64, device="cpu", **kw)
    u0, f = _start(n, 3)
    setup = boxmg_elastic_setup(tl)
    jsetup = [tuple(jnp.asarray(x.numpy()) for x in pair) for pair in setup]
    return dict(tl=tl, u0=u0, f=f, setup=setup, hist=jax_histories(jl, jsetup, u0, f))


@pytest.mark.parametrize("gamma", [1, 2], ids=["V", "W"])
def test_histories_match_jax(n16, gamma):
    bm = ElasticBoxMG(n16["tl"])
    assert all(torch.equal(a, b) for p, q in zip(bm.setup, n16["setup"]) for a, b in zip(p, q))
    _, h = bm.solve(n16["f"], u0=n16["u0"], eps=0.0, max_cycles=CYCLES, gamma=gamma)
    assert len(h) == CYCLES
    np.testing.assert_allclose(h, n16["hist"][gamma - 1], rtol=1e-9, atol=0)


def test_setup_from_arrays_round_trip(n16):
    """elastic_boxmg_setup_from_arrays keeps each array's values and dtype,
    or casts to the one asked for."""
    arrays = [tuple(x.numpy() for x in pair) for pair in n16["setup"]]
    carried = elastic_boxmg_setup_from_arrays(arrays, device="cpu")
    for pair, apair in zip(carried, arrays):
        for x, a in zip(pair, apair):
            assert x.dtype == torch.float64 and np.array_equal(x.numpy(), a)
    f32 = elastic_boxmg_setup_from_arrays(arrays, device="cpu", dtype=torch.float32)
    assert all(x.dtype == torch.float32 for pair in f32 for x in pair)


def test_solve_stops_at_eps(n16):
    """``eps`` cuts the history at its first norm <= eps; u carries that
    whole chunk, and solve refits a u0 given off the interior."""
    bm = ElasticBoxMG(n16["tl"])
    _, full = bm.solve(n16["f"], u0=n16["u0"], eps=0.0, max_cycles=12, gamma=2)
    eps = float(full[9])
    ring = np.ones_like(n16["u0"])
    ring[:, 1:-1, 1:-1] = 0.0
    _, h = bm.solve(n16["f"], u0=n16["u0"] + 5.0 * ring, eps=eps, max_cycles=40, gamma=2)
    assert len(h) == 10 and h[-1] <= eps
    np.testing.assert_allclose(h, full[:10], rtol=1e-12)
