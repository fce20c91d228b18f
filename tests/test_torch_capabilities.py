"""Two capabilities of the JAX package that its tests hold, held for the
port against it on the CPU: batched leading dims through the plain V-cycle
(tests/test_misc_capabilities.py::test_batched_solvers_vmap) and a
non-square domain given as a ``geo`` mask, the L-shaped domain
(tests/test_nonsquare_domain.py).

The port's solvers/multigrid.py::v_cycle on a (3, 17, 17) right-hand side
equals three single runs exactly and JAX's ``vmap`` within 1e-5; on the
L-shaped hierarchy 30 V(1,1) cycles match JAX's iterate within 1e-5
relative and the dense FEM oracle on the masked node set within 1e-4, and
the cut-out quadrant stays exactly 0.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.core.problem import GridHierarchy as JHierarchy
from multigrid_feanet_tpu.core.problem import Problem as JProblem
from multigrid_feanet_tpu.ops import stencil as jst
from multigrid_feanet_tpu.solvers import multigrid as jmg

from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
from multigrid_feanet_torch.ops import stencil as tst
from multigrid_feanet_torch.solvers import multigrid as tmg


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_batched_v_cycle_matches_singles_and_jax_vmap():
    n, cycles = 16, 12
    jh = JHierarchy.create(JProblem(n=n, dtype=jnp.float32))
    th = GridHierarchy.create(Problem(n=n), device="cpu")
    F = np.random.default_rng(5).standard_normal((3, n + 1, n + 1)).astype(np.float32)
    f = tst.apply_mass(torch.as_tensor(F), th.finest.h)

    def cycles_from_zero(fi):
        u = torch.zeros_like(fi)
        for _ in range(cycles):
            u = tmg.v_cycle(th, u, fi, 1, 1)
        return u

    def jax_cycles(fi):
        return jax.lax.fori_loop(0, cycles, lambda _, u: jmg.v_cycle(jh, u, fi, 1, 1),
                                 jnp.zeros_like(fi))

    u_batched = cycles_from_zero(f)
    assert u_batched.shape == (3, n + 1, n + 1)
    for i in range(3):
        assert torch.equal(u_batched[i], cycles_from_zero(f[i]))
    fj = jst.apply_mass(jnp.asarray(F), jh.finest.h)
    u_jax = np.asarray(jax.jit(jax.vmap(jax_cycles))(fj))
    np.testing.assert_allclose(u_batched.numpy(), u_jax, rtol=1e-5, atol=1e-6)


def _l_mask(n):
    """Interior mask of the L-shaped domain on an (n+1)^2 grid: the square's
    interior minus its closed top-right quadrant (i, j >= n/2)."""
    g = np.zeros((n + 1, n + 1), np.float32)
    g[1:-1, 1:-1] = 1.0
    g[n // 2 :, n // 2 :] = 0.0
    return g


def _dense_oracle(table, geo, f):
    """Solve A u = f over the masked node set (u = 0 elsewhere) in f64."""
    idx = {(i, j): k for k, (i, j) in enumerate(zip(*np.nonzero(geo > 0.5)))}
    A = np.zeros((len(idx), len(idx)))
    b = np.zeros(len(idx))
    for (i, j), row in idx.items():
        b[row] = f[i, j]
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                q = (i + dr, j + dc)
                if q in idx:
                    A[row, idx[q]] += table[1 + dr, 1 + dc]
    ui = np.linalg.solve(A, b)
    u = np.zeros(geo.shape)
    for (i, j), row in idx.items():
        u[i, j] = ui[row]
    return u


def test_l_shaped_domain_matches_jax_and_dense_oracle():
    n, cycles = 32, 30
    jh = JHierarchy.create(JProblem(n=n, dtype=jnp.float32))
    jh = JHierarchy(levels=tuple(lv.replace(geo=jnp.asarray(_l_mask(lv.n))) for lv in jh.levels))
    th = GridHierarchy.create(Problem(n=n), device="cpu")
    th = GridHierarchy(levels=tuple(dataclasses.replace(lv, geo=torch.as_tensor(_l_mask(lv.n)))
                                    for lv in th.levels))
    lv = th.finest
    geo = _l_mask(n)
    f = tst.apply_mass(torch.ones(n + 1, n + 1), lv.h) * lv.geo

    u = torch.zeros_like(f)
    res = []
    for _ in range(cycles):
        u = tmg.v_cycle(th, u, f)
        r = (f - lv.apply(u)) * lv.geo
        res.append(float(torch.sqrt(torch.sum(r * r))))
    # the masked residual decays like a healthy V-cycle to the f32 floor
    assert res[-1] < max(1e-6 * res[0], 5e-7)

    run = jax.jit(lambda u: jmg.v_cycle(jh, u, jnp.asarray(f.numpy())))
    uj = jnp.zeros((n + 1, n + 1), jnp.float32)
    for _ in range(cycles):
        uj = run(uj)
    got, want = u.numpy(), np.asarray(uj)
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-5

    u_oracle = _dense_oracle(lv.table.double().numpy(), geo, f.double().numpy())
    assert np.max(np.abs(got - u_oracle)) / np.max(np.abs(u_oracle)) < 1e-4
    # the cut-out quadrant stays exactly at the Dirichlet value
    assert np.all(got[n // 2 :, n // 2 :] == 0.0)
