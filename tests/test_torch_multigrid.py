"""The port's plain ``solvers/multigrid.py`` (``solve``, ``fmg``,
``convergence_factor``) and ``solvers/jacobi.py::solve_jacobi`` against
their JAX twins, on the CPU, with the q ~ 0.259 V(1,1) anchor.

Both sides run on the identical operator: the port's hierarchy is built
with hierarchy_from_arrays from the JAX GridHierarchy's fields.  Bands as in
tests/test_torch_mg.py: cycle counts +-1, histories to 6e-2 relative, u to
1e-3 relative (+1e-5 absolute).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.core.problem import GridHierarchy as JGrid
from multigrid_feanet_tpu.core.problem import Problem as JProblem
from multigrid_feanet_tpu.ops import stencil as jst
from multigrid_feanet_tpu.solvers import jacobi as jjac
from multigrid_feanet_tpu.solvers import multigrid as jmg

from multigrid_feanet_torch.core.convert import hierarchy_from_arrays
from multigrid_feanet_torch.solvers import jacobi as tjac
from multigrid_feanet_torch.solvers import multigrid as tmg
from multigrid_feanet_torch.solvers.coarse import coarse_inverse

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


def _same(jres, tres, rtol=6e-2):
    (uj, hj), (ut, ht) = jres, tres
    assert abs(len(hj) - len(ht)) <= 1
    m = min(len(hj), len(ht))
    np.testing.assert_allclose(ht[:m], np.asarray(hj)[:m], rtol=rtol)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-3, atol=1e-5)


def _plain_pair(n, inclusion, num_levels=None):
    jp = JProblem(n=n, inclusion=inclusion, dtype=jnp.float32)
    jh = JGrid.create(jp, num_levels)
    return jh, hierarchy_from_arrays(_arrays(jh, jp), device="cpu")


@pytest.mark.parametrize("nu", [(1, 1), (2, 1)], ids=["v11", "v21"])
@pytest.mark.parametrize("inc", [None, CIRCLE], ids=["hom", "bim"])
def test_multigrid_solve_matches_jax(inc, nu):
    n = 32
    jh, th = _plain_pair(n, inc)
    f = jst.apply_mass(jnp.ones((n + 1, n + 1), jnp.float32), jh.finest.h)
    uj, hj = jmg.solve(jh, f, nu1=nu[0], nu2=nu[1], eps=5e-5, chunk=4)
    ut, ht = tmg.solve(th, torch.from_numpy(np.array(f)), nu1=nu[0], nu2=nu[1], eps=5e-5,
                       chunk=4)
    _same((uj, hj), (ut, ht))
    np.testing.assert_allclose(ht[:3], hj[:3], rtol=1e-3)  # far above the f32 floor


def test_multigrid_q_anchor_and_direct_coarse():
    """V(1,1) on the homogeneous n = 64 problem contracts by q ~ 0.259
    (README, tests/test_solvers.py, from the reference's random initial
    guess coef0 U(0, 1) + coef1, coef ~ 1e5, f = 0); the truncated hierarchy
    with the direct coarse solve and a boundary value matches the JAX
    solve."""
    n = 64
    jh, th = _plain_pair(n, None)
    rng = np.random.default_rng(1)
    coef = 100000.0 + 50000.0 * rng.uniform(size=2)
    u0 = (coef[0] * rng.uniform(size=(n + 1, n + 1)) + coef[1]).astype(np.float32)
    f0 = np.zeros((n + 1, n + 1), np.float32)
    _, hj = jmg.solve(jh, jnp.asarray(f0), u0=jnp.asarray(u0), eps=1e-6)
    _, ht = tmg.solve(th, torch.from_numpy(f0), u0=torch.from_numpy(u0), eps=1e-6)
    q = tmg.convergence_factor(ht)
    assert abs(q - 0.2590) < 0.015, q
    assert abs(len(ht) - len(hj)) <= 1
    np.testing.assert_allclose(q, jmg.convergence_factor(hj), rtol=2e-2)
    assert tmg.convergence_factor(ht, 5) == pytest.approx(float(ht[5] / ht[4]))
    jh, th = _plain_pair(n, CIRCLE, 4)
    inv_j = jmg.coarse.coarse_inverse(jh.levels[-1])
    inv_t = coarse_inverse(th.levels[-1])
    f = np.random.default_rng(2).standard_normal((n + 1, n + 1)).astype(np.float32)
    uj, hj = jmg.solve(jh, jnp.asarray(f), bc_value=0.7, eps=1e-3, coarse_inv=inv_j)
    ut, ht = tmg.solve(th, torch.from_numpy(f), bc_value=0.7, eps=1e-3, coarse_inv=inv_t)
    assert len(ht) == len(hj)
    scale = float(np.max(np.abs(np.asarray(uj))))
    assert float(np.max(np.abs(ut.numpy() - np.asarray(uj)))) / scale < 1e-3


@pytest.mark.parametrize("direct", [False, True], ids=["relaxed_coarse", "direct"])
@pytest.mark.parametrize("bc", [0.0, 0.7], ids=["bc0", "bc07"])
def test_fmg_matches_jax(bc, direct):
    n = 64
    jh, th = _plain_pair(n, CIRCLE, 4 if direct else None)
    f = np.random.default_rng(3).standard_normal((n + 1, n + 1)).astype(np.float32)
    # 8 sweeps of the relax-only coarsest level (one interior node) keep the
    # JAX compile short
    kw_j = (dict(coarse_inv=jmg.coarse.coarse_inverse(jh.levels[-1])) if direct
            else dict(coarse_sweeps=8))
    kw_t = dict(coarse_inv=coarse_inverse(th.levels[-1])) if direct else dict(coarse_sweeps=8)
    uj = jmg.fmg(jh, jnp.asarray(f), bc_value=bc, **kw_j)
    ut = tmg.fmg(th, torch.from_numpy(f), bc_value=bc, **kw_t)
    scale = float(np.max(np.abs(np.asarray(uj))))
    assert float(np.max(np.abs(ut.numpy() - np.asarray(uj)))) / scale < 1e-4
    np.testing.assert_allclose(ut.numpy()[0], bc, atol=1e-6)


def test_plain_solve_jacobi_matches_jax():
    """jacobi.solve_jacobi: post-sweep histories and u, one chunk cut at eps."""
    n = 16
    jh, th = _plain_pair(n, None)
    f = jst.apply_mass(jnp.ones((n + 1, n + 1), jnp.float32), jh.finest.h)
    ft = torch.from_numpy(np.array(f))
    uj, hj = jjac.solve_jacobi(jh.finest, f, eps=1e-5, chunk=64)
    ut, ht = tjac.solve_jacobi(th.finest, ft, eps=1e-5, chunk=64)
    assert len(ht) == len(hj) and ht[-1] <= 1e-5 < ht[-2]
    np.testing.assert_allclose(ht, hj, rtol=6e-2)
    np.testing.assert_allclose(ht[:100], hj[:100], rtol=1e-4)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-6)
    _, capped = tjac.solve_jacobi(th.finest, ft, eps=None, max_iters=40, chunk=16)
    assert len(capped) == 40
