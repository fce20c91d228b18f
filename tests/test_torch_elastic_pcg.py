"""The port's elastic V(1,1) cycle and MG-preconditioned flexible CG
(multigrid_feanet_torch/solvers/elastic.py) against the JAX
``PallasElasticMG`` in interpret mode, on the CPU, with the direct coarse
solve.  V(2,2) and the plain solver are in test_torch_elastic_solver.py,
whose helpers and bands this file shares.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_torch.ops.elasticity import apply_elastic_factored

from test_torch_elastic_solver import COEF, E, N, NU, assert_same_solve, pair, rhs


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def direct():
    return pair(direct=True)


def test_v11_matches_pallas(direct):
    """V(1,1): the zero-guess legs G4/G5 below level 0."""
    jm, th = direct
    f = rhs(seed=5)
    assert_same_solve(jm.solve(jnp.asarray(f), nu1=1, nu2=1, eps=1e-2, max_cycles=60),
                      th.solve(f, nu1=1, nu2=1, eps=1e-2, max_cycles=60), 60)


def test_pcg_matches_pallas(direct):
    """solve_pcg at V(2,2): the same iterations and history within the
    bands, in fewer than half the plain V(2,2) cycles."""
    jm, th = direct
    f = rhs(seed=0)
    jres = jm.solve_pcg(jnp.asarray(f), eps=1e-2, max_iters=40)
    tres = th.solve_pcg(f, eps=1e-2, max_iters=40)
    assert_same_solve(jres, tres, 40)
    hist = tres[1]
    assert hist.dtype == np.float32 and hist[-1] <= 1e-2 < hist[-2]
    _, h_plain = th.solve(f, eps=1e-2, max_cycles=120)
    assert len(hist) <= len(h_plain) // 2


def test_pcg_reports_true_residual(direct):
    """Post-iteration residuals with no lag: the returned u's true residual
    (in f64) is history[-1].  Checked at an eps of 0.5, where the f32
    operator's rounding (~2e-5 absolute at |A| ~ 4e6) is far below the
    residual."""
    _, th = direct
    f = rhs(seed=0)
    u, hist = th.solve_pcg(f, eps=0.5, max_iters=40)
    assert hist[-1] <= 0.5
    r = (torch.from_numpy(f).double() - th.levels[0].apply(u.double()))[:, 1:-1, 1:-1]
    np.testing.assert_allclose(float(torch.sqrt((r * r).sum())), hist[-1], rtol=1e-3)


def test_pcg_stops_at_max_iters_and_keeps_u0(direct):
    """max_iters caps the history; a nonzero u0 is masked to the interior and
    its residual starts the recurrence."""
    _, th = direct
    f = rhs(seed=6)
    _, h = th.solve_pcg(f, eps=0.0, max_iters=3)
    assert len(h) == 3
    u0 = np.full_like(f, 0.25)
    u, h0 = th.solve_pcg(np.zeros_like(f), u0=u0, eps=0.0, max_iters=1)
    assert len(h0) == 1 and float(u[:, 0].abs().max()) == 0.0


def test_apply_fused_is_the_masked_operator(direct):
    """apply_fused(p) is A p at interior nodes and zero on the boundary."""
    _, th = direct
    p = torch.from_numpy(rhs(seed=7))
    ap = th.apply_fused(p)
    lv = th.levels[0]
    want = apply_elastic_factored(lv.phase, p, E, NU, *COEF) * lv.geo
    assert float((ap - want).abs().max()) <= 2e-5 * float(want.abs().max())
    assert ap.shape == (2, N + 1, N + 1) and float(ap[:, :, 0].abs().max()) == 0.0
