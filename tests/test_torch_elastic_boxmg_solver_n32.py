"""The port's block-BoxMG elastic solver
(multigrid_feanet_torch/solvers/elastic_boxmg.py) against the JAX
``ElasticBoxMG`` at n = 32, on the CPU, in f64, and its convergence claim on
its own at n = 64.

n = 32 runs three levels (n = 32, 16 and the direct solve at 8), so that
JAX compiles its cycles in seconds: 8 V(2,2) and 8 W(2,2) cycles of the f =
0 decay protocol (rng 3) on the bi-material problem, every residual within
1e-9 relative of the JAX solver's, with the port's setup and with JAX's
carried across.  At n = 64 the port alone reproduces
tests/test_boxmg_elastic.py's claim: W(2,2) q < 0.5 and below the plain
bilinear hierarchy's by 0.2, and the homogeneous V(2,2) q < 0.33.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.ops import boxmg_elastic as jbe
from multigrid_feanet_tpu.solvers import elastic as jes

from multigrid_feanet_torch.core.convert import elastic_boxmg_setup_from_arrays
from multigrid_feanet_torch.solvers import elastic as tes
from multigrid_feanet_torch.solvers.elastic_boxmg import ElasticBoxMG

from test_torch_elastic_boxmg_solver import (CIRCLE, COEF, CYCLES, E, NU, _few_threads,  # noqa: F401
                                             _start, _tail_q, jax_histories)

LEVELS = 3


@pytest.fixture(scope="module")
def n32():
    """The n = 32 problem on both sides at 3 levels, JAX's setup and its
    histories."""
    n = 32
    kw = dict(inclusion=CIRCLE, coefficients=COEF, num_levels=LEVELS)
    jl = jes.build_elastic_hierarchy(n, E, NU, dtype=jnp.float64, **kw)
    tl = tes.build_elastic_hierarchy(n, E, NU, dtype=torch.float64, device="cpu", **kw)
    u0, f = _start(n, 3)
    jsetup = jbe.boxmg_elastic_setup(jl)
    return dict(tl=tl, u0=u0, f=f, jsetup=[tuple(np.asarray(x) for x in p) for p in jsetup],
                hist=jax_histories(jl, jsetup, u0, f))


@pytest.mark.parametrize("gamma", [1, 2], ids=["V", "W"])
@pytest.mark.parametrize("which", ["port_setup", "jax_setup"])
def test_histories_match_jax_n32(n32, gamma, which):
    setup = (None if which == "port_setup"
             else elastic_boxmg_setup_from_arrays(n32["jsetup"], device="cpu"))
    bm = ElasticBoxMG(n32["tl"], setup=setup)
    assert bm.L == LEVELS and bm.coarse_inv.shape == (98, 98)
    _, h = bm.solve(n32["f"], u0=n32["u0"], eps=0.0, max_cycles=CYCLES, gamma=gamma)
    assert len(h) == CYCLES
    np.testing.assert_allclose(h, n32["hist"][gamma - 1], rtol=1e-9, atol=0)


def test_boxmg_beats_plain_cycle_n64():
    """The f = 0 decay at n = 64 (f64): block-BoxMG W(2,2) holds the
    two-grid factor (~0.44) where the plain bilinear V(2,2) hierarchy
    degrades to ~0.82."""
    n = 64
    levels = tes.build_elastic_hierarchy(n, E, NU, inclusion=CIRCLE, coefficients=COEF,
                                         dtype=torch.float64, device="cpu")
    u0, f = _start(n, 3)
    _, h_b = ElasticBoxMG(levels).solve(f, u0=u0, eps=1e-8, max_cycles=80, gamma=2)
    _, h_p = tes.solve(levels, torch.as_tensor(f), u0=torch.as_tensor(u0), eps=1e-8,
                       max_cycles=24)
    q_b, q_p = _tail_q(h_b), _tail_q(h_p)
    assert len(h_b) < 80
    assert q_b < 0.5, q_b
    assert q_b < q_p - 0.2, (q_b, q_p)


def test_boxmg_homogeneous_n64():
    """On the homogeneous problem the block transfers are bilinear-quality:
    the full-depth V(2,2) factor stays at the plain hierarchy's (~0.29)."""
    n = 64
    levels = tes.build_elastic_hierarchy(n, E, NU, inclusion=None, coefficients=COEF,
                                         dtype=torch.float64, device="cpu")
    u0, f = _start(n, 4)
    _, h = ElasticBoxMG(levels).solve(f, u0=u0, eps=1e-10, max_cycles=60)
    assert _tail_q(h) < 0.33, _tail_q(h)
