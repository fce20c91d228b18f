"""The port's round-1 solvers against the JAX package, on the CPU:
``solvers/mg.py::Hierarchy`` (``solve``, ``solve_jacobi``) against
``PallasHierarchy`` in interpret mode.  The plain twins are in
tests/test_torch_multigrid.py.

Both sides run on the identical operator: the port's hierarchy is built
with hierarchy_from_arrays from the JAX GridHierarchy's fields.  Bands as in
tests/test_pallas_mg.py: cycle counts +-1, histories to 6e-2 relative, u to
1e-3 relative (+1e-5 absolute).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.core.problem import GridHierarchy as JGrid
from multigrid_feanet_tpu.core.problem import Problem as JProblem
from multigrid_feanet_tpu.ops import stencil as jst
from multigrid_feanet_tpu.solvers.pallas_mg import PallasHierarchy

from multigrid_feanet_torch.core.convert import hierarchy_from_arrays
from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
from multigrid_feanet_torch.solvers import jacobi as tjac
from multigrid_feanet_torch.solvers.mg import Hierarchy

CIRCLE = ("circle", (0.0, 0.0), 0.5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _arrays(jh, jp):
    return [dict(n=lv.n, h=lv.h, a0=lv.a0, a1=lv.a1, table=np.asarray(lv.table),
                 pid=None if lv.pid is None else np.asarray(lv.pid), geo=np.asarray(lv.geo),
                 diag=np.asarray(lv.diag), phase=jp.phase(lv.n))
            for lv in jh.levels]


def _setup(n, inclusion, threshold, num_levels=None, direct=False):
    """JAX hierarchy, PallasHierarchy and the port's Hierarchy (CPU) on the
    same operator, with the mass-convolved f = 1 right-hand side."""
    jp = JProblem(n=n, inclusion=inclusion, dtype=jnp.float32)
    jh = JGrid.create(jp, num_levels)
    ph = PallasHierarchy(jh, pallas_threshold=threshold, interpret=True, direct_coarse=direct)
    th = Hierarchy(hierarchy_from_arrays(_arrays(jh, jp), device="cpu"),
                   kernel_threshold=threshold, direct_coarse=direct, device="cpu")
    assert [p is None for p in th.ps] == [p is None for p in ph.ps]
    f = jst.apply_mass(jnp.ones((n + 1, n + 1), jnp.float32), jh.finest.h)
    return jh, ph, th, f


def _same(jres, tres, rtol=6e-2):
    (uj, hj), (ut, ht) = jres, tres
    assert abs(len(hj) - len(ht)) <= 1
    m = min(len(hj), len(ht))
    np.testing.assert_allclose(ht[:m], np.asarray(hj)[:m], rtol=rtol)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-3, atol=1e-5)


CASES = {
    # name: (n, inclusion, kernel threshold, num_levels, direct, nu, eps)
    "bim_v11_kernels": (32, CIRCLE, 16, None, False, 1, 5e-5),
    "bim_v11_plain": (32, CIRCLE, 10_000, None, False, 1, 5e-5),
    "bim_v22_kernels": (32, CIRCLE, 16, None, False, 2, 5e-5),
    "bim_v22_plain": (32, CIRCLE, 10_000, None, False, 2, 5e-5),
    "hom_v11_mixed": (64, None, 32, None, False, 1, 1e-5),
    "hom_v22_mixed": (64, None, 32, None, False, 2, 1e-5),
    "bim_v11_direct": (64, CIRCLE, 16, 4, True, 1, 1e-4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_solve_matches_pallas_hierarchy(case):
    """Hierarchy.solve against PallasHierarchy.solve: C1 (V(1,1)) and C2
    (V(2,2)) on the kernel levels, the plain Jacobi step below."""
    n, inc, thr, nl, direct, nu, eps = CASES[case]
    _, ph, th, f = _setup(n, inc, thr, nl, direct)
    jres = ph.solve(f, nu1=nu, nu2=nu, eps=eps)
    tres = th.solve(np.asarray(f), nu1=nu, nu2=nu, eps=eps)
    _same(jres, tres)
    assert tres[1].dtype == np.float32 and tres[1][-1] <= eps


def test_solve_history_is_the_residual_of_u():
    """Post-cycle residuals: history[-1] is the residual of the returned u
    (no extra cycle, unlike HierarchyV2), and a cap records every cycle."""
    _, _, th, f = _setup(32, CIRCLE, 16)
    f = torch.from_numpy(np.asarray(f))
    u, hist = th.solve(f, eps=1e-4)
    r = tjac.interior_norm(f - th.hier.finest.apply(u))
    np.testing.assert_allclose(float(r), hist[-1], rtol=1e-3)
    _, capped = th.solve(f, eps=0.0, max_cycles=5)
    assert len(capped) == 5


@pytest.mark.parametrize("fuse", [1, 4])
def test_solve_jacobi_matches_pallas_hierarchy(fuse):
    """The lagged free residual: the same iteration count (a multiple of
    fuse) and u, with the final residual recomputed."""
    _, ph, th, f = _setup(16, None, 8)
    uj, kj, rj = ph.solve_jacobi(f, eps=1e-5, fuse=fuse)
    ut, kt, rt = th.solve_jacobi(np.asarray(f), eps=1e-5, fuse=fuse)
    assert kt == kj and kt % fuse == 0
    np.testing.assert_allclose(rt, rj, rtol=2e-2)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=5e-6)
    # with the plain finest level too
    _, ph, th, f = _setup(16, None, 10_000)
    uj, kj, rj = ph.solve_jacobi(f, eps=1e-5, fuse=fuse)
    ut, kt, rt = th.solve_jacobi(np.asarray(f), eps=1e-5, fuse=fuse)
    assert kt == kj
    np.testing.assert_allclose(rt, rj, rtol=2e-2)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=5e-6)


def test_solve_jacobi_keeps_the_boundary_value():
    _, _, th, f = _setup(16, None, 8)
    u, k, res = th.solve_jacobi(np.asarray(f), bc_value=0.7, eps=1e-4, fuse=2)
    assert res <= 1e-4 * 1.05 and k % 2 == 0
    np.testing.assert_allclose(u.numpy()[0], 0.7, atol=1e-7)


def test_hierarchy_refuses_a_mismatched_device(monkeypatch):
    hier = GridHierarchy.create(Problem(n=16), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Hierarchy(hier)
    with pytest.raises(ValueError, match="sweep_k"):
        Hierarchy(hier, kernel_threshold=8, device="cpu").solve(
            np.zeros((17, 17), np.float32), nu1=9, nu2=9, max_cycles=1)
