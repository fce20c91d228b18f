"""The MG-preconditioned flexible CG of ``HierarchyV2`` and
``BoxMGHierarchy`` (``solvers/common.py::solve_pcg``) against
``PallasHierarchyV2.solve_pcg`` and ``PallasBoxMG.solve_pcg`` in interpret
mode, on the CPU.

Bands: those of tests/test_torch_mg2.py (iteration counts +-1, first
residual to 1e-4, history ratios within [0.8, 1.25], u to 1e-3 of its
scale).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_torch.solvers.jacobi import interior_norm

from test_torch_boxmg import _boxmg_pair
from test_torch_mg2 import _assert_same_solve, _pair

CIRCLE = ("circle", (0.0, 0.0), 0.5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _true_res(th, f, u):
    lv0 = th.hier.finest
    return float(interior_norm(torch.from_numpy(f).double() - lv0.apply(u.double())))


@pytest.mark.parametrize("bc", [None, 0.7], ids=["bc0", "bc07"])
def test_v2_pcg_matches_pallas(bc):
    """HierarchyV2.solve_pcg against PallasHierarchyV2.solve_pcg; the
    history is the true residual of the returned u (post-iteration)."""
    n = 64
    jh, th = _pair(n, CIRCLE, None, True)
    rng = np.random.default_rng(3)
    f = rng.standard_normal((n + 1, n + 1)).astype(np.float32)
    f[[0, -1]] = 0.0
    f[:, [0, -1]] = 0.0
    kw = dict(eps=5e-3, max_iters=40) if bc is None else dict(eps=1e-4, max_iters=60, bc_value=bc)
    jres = jh.solve_pcg(jnp.asarray(f), **kw)
    tres = th.solve_pcg(f, **kw)
    _assert_same_solve(jres, tres, kw["max_iters"])
    u, hist = tres
    assert hist.dtype == np.float32 and hist[-1] <= kw["eps"]
    np.testing.assert_allclose(_true_res(th, f, u), hist[-1], rtol=1e-2)
    if bc is not None:
        np.testing.assert_allclose(u.numpy()[0, :], bc, atol=1e-6)
    else:
        _, h_plain = th.solve(f, eps=kw["eps"], max_cycles=120)
        assert len(hist) <= max(2, int(0.6 * len(h_plain)) + 1)


def test_v2_pcg_breakdown_guard_stops_at_floor():
    """Below the f32 floor (eps = 0) the guards stop CG or it hovers at the
    floor; it never climbs above its start (tests/test_pallas_mg2.py)."""
    n = 32
    jh, th = _pair(n, CIRCLE, None, True)
    f = np.random.default_rng(4).standard_normal((n + 1, n + 1)).astype(np.float32)
    _, hj = jh.solve_pcg(jnp.asarray(f), bc_value=0.7, eps=0.0, max_iters=60)
    _, hist = th.solve_pcg(f, bc_value=0.7, eps=0.0, max_iters=60)
    for h in (np.asarray(hj), hist):
        assert h[-1] <= 20.0 * h.min()
        assert h.max() == h[0]
    m = min(len(hj), len(hist), 8)
    ratio = hist[:m] / np.asarray(hj)[:m]
    assert np.all(ratio > 0.8) and np.all(ratio < 1.25), ratio


@pytest.mark.parametrize("nu", [(1, 1), (2, 1)], ids=["v11", "v21"])
def test_boxmg_pcg_matches_pallas(nu):
    """BoxMGHierarchy.solve_pcg against PallasBoxMG.solve_pcg (f32 planes,
    direct coarse solve); at least as fast as the plain BoxMG cycle."""
    n = 64
    jb, tb = _boxmg_pair(n, False, True)
    rng = np.random.default_rng(3)
    f = rng.standard_normal((n + 1, n + 1)).astype(np.float32)
    f[[0, -1]] = 0.0
    f[:, [0, -1]] = 0.0
    kw = dict(nu1=nu[0], nu2=nu[1], eps=5e-3, max_iters=40)
    jres = jb.solve_pcg(jnp.asarray(f), **kw)
    tres = tb.solve_pcg(f, **kw)
    _assert_same_solve(jres, tres, 40)
    u, hist = tres
    np.testing.assert_allclose(_true_res(tb, f, u), hist[-1], rtol=1e-2)
    _, hv = tb.solve(f, nu1=nu[0], nu2=nu[1], eps=5e-3, max_cycles=60)
    assert len(hist) <= len(hv)


def test_boxmg_pcg_keeps_boundary_value():
    n = 32
    _, tb = _boxmg_pair(n, False, True)
    f = np.random.default_rng(5).standard_normal((n + 1, n + 1)).astype(np.float32)
    u, hist = tb.solve_pcg(f, bc_value=0.7, eps=1e-3, max_iters=60)
    assert hist[-1] <= 1e-3
    np.testing.assert_allclose(u.numpy()[0, :], 0.7, atol=1e-6)
