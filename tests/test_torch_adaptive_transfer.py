"""The port's content-adaptive transfers and scalar BoxMG hierarchy
(multigrid_feanet_torch/ops/adaptive_transfer.py) against the JAX package,
on the CPU.

The weights are numpy f64 on both sides and must agree to 1e-12; the
transfers and the Galerkin stencils are the same tensor arithmetic (f64:
1e-10 of the result's scale).  ``BoxMG`` histories over 8 V(1,1) cycles of
the f = 0 decay protocol at n = 32 agree within 1e-9 relative in f64 and
1e-4 in f32.  The port's own BoxMG is then held to the claims of
tests/test_adaptive_transfer.py: the classical pair on the homogeneous
operator, R = P^T, probes against a dense R A P, q < 0.30 on the heat
theta-system, the data/fem.py oracle to 5e-4.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.core.problem import GridHierarchy as JHierarchy
from multigrid_feanet_tpu.core.problem import Problem as JProblem
from multigrid_feanet_tpu.ops import adaptive_transfer as jat
from multigrid_feanet_tpu.ops import heat as jheat

from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
from multigrid_feanet_torch.data import fem
from multigrid_feanet_torch.ops import adaptive_transfer as tat
from multigrid_feanet_torch.ops import heat
from multigrid_feanet_torch.ops.stencil import apply_mass
from multigrid_feanet_torch.ops.transfer import prolong_bilinear, restrict_full_weighting

CIRCLE = ("circle", (0.0, 0.0), 0.5)
INCLUSIONS = {"hom": None, "bim": CIRCLE}
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) / max(1e-300, float(np.max(np.abs(want))))


def _tail_q(hist, k=5):
    return float(np.exp(np.mean(np.diff(np.log(np.asarray(hist) + 1e-30))[-k:])))


@functools.lru_cache(maxsize=None)
def _hiers(n, inc, dt="f64", system=False):
    """The JAX and the port's hierarchies of one problem (the heat theta
    system's when ``system``)."""
    jdt, tdt = DTYPES[dt]
    jp = JProblem(n=n, inclusion=INCLUSIONS[inc], dtype=jdt)
    tp = Problem(n=n, inclusion=INCLUSIONS[inc], dtype=tdt)
    if system:
        return (jheat.heat_system_hierarchy(jp, dt=0.05, theta=0.5),
                heat.heat_system_hierarchy(tp, dt=0.05, theta=0.5, device="cpu"))
    return JHierarchy.create(jp), GridHierarchy.create(tp, device="cpu")


def _transfers(n, inc, dt="f64"):
    jh, th = _hiers(n, inc, dt)
    jdt, tdt = DTYPES[dt]
    ja = jat.AdaptiveTransfer(jat.node_stencils(jh.finest), jh.finest.geo, jh.levels[1].geo,
                              dtype=jdt)
    ta = tat.AdaptiveTransfer(tat.node_stencils(th.finest), th.finest.geo, th.levels[1].geo,
                              dtype=tdt)
    return ja, ta, th


@pytest.mark.parametrize("inc", list(INCLUSIONS))
@pytest.mark.parametrize("system", [False, True], ids=["stiffness", "heat"])
def test_node_stencils_match_jax(inc, system):
    jh, th = _hiers(16, inc, "f64", system)
    for jl, tl in zip(jh.levels[:2], th.levels[:2]):
        assert _rel(tat.node_stencils(tl), jat.node_stencils(jl)) == 0.0


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("inc", list(INCLUSIONS))
def test_weights_and_transfers_match_jax(inc, dt):
    """The Fx / Fy / Fc weights (numpy f64 on both sides, then cast), and
    prolong and restrict on the same random fields; a leading batch dim
    equals its members one by one."""
    ja, ta, th = _transfers(32, inc, dt)
    for name in ("wx", "wy", "wc"):
        got, want = getattr(ta, name), getattr(ja, name)
        assert got.dtype == DTYPES[dt][1] and got.device == th.device
        assert _rel(got, want) == 0.0
    tol = 1e-10 if dt == "f64" else 1e-5
    rng = np.random.default_rng(7)
    uc = rng.standard_normal((3, 17, 17)).astype(DTYPES[dt][0])
    r = rng.standard_normal((3, 33, 33)).astype(DTYPES[dt][0])
    P, R = ta.prolong(torch.as_tensor(uc)), ta.restrict(torch.as_tensor(r))
    j_prolong, j_restrict = jax.jit(ja.prolong), jax.jit(ja.restrict)
    for k in range(3):
        assert _rel(P[k], j_prolong(uc[k])) <= tol
        assert _rel(R[k], j_restrict(r[k])) <= tol
        assert torch.equal(P[k], ta.prolong(torch.as_tensor(uc[k])))
        assert torch.equal(R[k], ta.restrict(torch.as_tensor(r[k])))


@pytest.mark.parametrize("inc", list(INCLUSIONS))
def test_galerkin_stencils_match_jax(inc):
    ja, ta, th = _transfers(32, inc)
    jh, _ = _hiers(32, inc)
    Sc = tat.galerkin_stencils(th.finest.apply, ta, 17)
    assert Sc.dtype == torch.float64 and Sc.shape == (17, 17, 3, 3)
    assert _rel(Sc, jat.galerkin_stencils(jh.finest.apply, ja, 17)) <= 1e-10


def test_adjointness_bimaterial():
    """<P u_c, r> == <u_c, R r>: R is built as the transpose."""
    _, ta, th = _transfers(32, "bim")
    rng = np.random.default_rng(1)
    uc = torch.as_tensor(rng.standard_normal((17, 17))) * th.levels[1].geo
    r = torch.as_tensor(rng.standard_normal((33, 33))) * th.finest.geo
    lhs = float(torch.sum(ta.prolong(uc) * r))
    rhs = float(torch.sum(uc * ta.restrict(r)))
    assert lhs == pytest.approx(rhs, rel=1e-12)


def test_homogeneous_reduces_to_classical_pair():
    """On the constant-coefficient operator P is bilinear and R = P^T is 4 x
    full weighting, the reference's scaling."""
    _, ta, th = _transfers(16, "hom")
    rng = np.random.default_rng(0)
    uc = torch.as_tensor(rng.standard_normal((9, 9))) * th.levels[1].geo
    r = torch.as_tensor(rng.standard_normal((17, 17))) * th.finest.geo
    torch.testing.assert_close(ta.prolong(uc), prolong_bilinear(uc, th.finest.geo),
                               rtol=0, atol=1e-12)
    torch.testing.assert_close(ta.restrict(r), 4.0 * restrict_full_weighting(r),
                               rtol=0, atol=1e-12)


def test_galerkin_stencils_match_dense_rap():
    """The probed S_c equals R A P applied to unit coarse vectors."""
    _, ta, th = _transfers(16, "bim")
    lv = th.finest
    m = 9
    Sc = tat.galerkin_stencils(lv.apply, ta, m)
    rng = np.random.default_rng(2)
    for _ in range(4):
        I, J = rng.integers(1, m - 1, 2)
        e = torch.zeros(m, m, dtype=torch.float64)
        e[I, J] = 1.0
        col = ta.restrict(lv.apply(ta.prolong(e)))
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                # S_c[I + dr, J + dc, 1 - dr, 1 - dc] couples that node to (I, J)
                assert float(col[I + dr, J + dc]) == pytest.approx(
                    float(Sc[I + dr, J + dc, 1 - dr, 1 - dc]), rel=1e-10, abs=1e-12)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_boxmg_history_matches_jax(dt):
    """8 V(1,1) cycles of the f = 0 decay at n = 32 (bi-material, full
    depth, direct coarse solve)."""
    jh, th = _hiers(32, "bim", dt)
    jdt, tdt = DTYPES[dt]
    u0 = np.random.default_rng(0).standard_normal((33, 33)).astype(jdt) * np.asarray(
        jh.finest.geo)
    _, hj = jat.BoxMG(jh).solve(jnp.zeros_like(jnp.asarray(u0)), u0=jnp.asarray(u0), eps=0.0,
                                max_cycles=8)
    bm = tat.BoxMG(th)
    assert bm.num_levels == 5 and bm.coarse_inv.dtype == tdt
    _, ht = bm.solve(torch.zeros(33, 33, dtype=tdt), u0=torch.as_tensor(u0), eps=0.0,
                     max_cycles=8)
    assert len(ht) == len(hj) == 8
    np.testing.assert_allclose(ht, hj, rtol=1e-9 if dt == "f64" else 1e-4, atol=0)


def test_boxmg_on_heat_theta_system():
    """Built on the bi-material heat theta-system hierarchy (B = M + theta dt
    K), the BoxMG cycle converges at least as fast as on stiffness alone."""
    _, th = _hiers(32, "bim", "f32", system=True)
    bm = tat.BoxMG(th)
    u0 = torch.as_tensor(np.random.default_rng(5).standard_normal((33, 33)),
                         dtype=torch.float32) * th.finest.geo
    _, h = bm.solve(torch.zeros(33, 33), u0=u0, eps=0.0, max_cycles=12)
    assert _tail_q(h) < 0.30, _tail_q(h)


def test_boxmg_solves_to_oracle():
    """Nonzero f: the BoxMG solve of the interface problem matches the
    port's dense-FEM partition solve (data/fem.py)."""
    n = 32
    _, th = _hiers(n, "bim", "f32")
    F = np.random.default_rng(4).standard_normal((n + 1, n + 1)).astype(np.float32)
    ff = apply_mass(torch.as_tensor(F), th.finest.h)
    u, _ = tat.BoxMG(th).solve(ff, eps=1e-8, max_cycles=60)
    prob = Problem(n=n, inclusion=CIRCLE)
    u_ref = fem.solve_dirichlet(n, F.astype(np.float64), phase=prob.phase(n),
                                coefficients=prob.coefficients)
    err = np.max(np.abs(u.numpy() - u_ref)) / max(1e-12, float(np.max(np.abs(u_ref))))
    assert err < 5e-4, err


def test_boxmg_without_galerkin_keeps_the_hierarchy_levels():
    """``galerkin=False`` swaps only the transfers: the coarse levels are the
    hierarchy's own and the coarse inverse is ``coarse_inverse``'s."""
    from multigrid_feanet_torch.solvers.coarse import coarse_inverse

    _, th = _hiers(16, "bim", "f32")
    bm = tat.BoxMG(th, num_levels=3, galerkin=False)
    assert bm.levels[1:] == list(th.levels[1:3])
    torch.testing.assert_close(bm.coarse_inv, coarse_inverse(th.levels[2]))
    u0 = torch.as_tensor(np.random.default_rng(6).standard_normal((17, 17)),
                         dtype=torch.float32) * th.finest.geo
    _, h = bm.solve(torch.zeros(17, 17), u0=u0, eps=0.0, max_cycles=6)
    assert np.all(np.isfinite(h)) and h[-1] < h[0]


def test_boxmg_deeper_than_the_hierarchy():
    """Levels past the hierarchy's depth take an interior-ring mask as their
    geo, and the deeper cycle still contracts."""
    _, th = _hiers(16, "bim", "f32")
    short = GridHierarchy(levels=th.levels[:2])
    bm = tat.BoxMG(short, num_levels=4)
    assert [lv.n for lv in bm.levels] == [16, 8, 4, 2]
    for lv, want in zip(bm.levels[2:], th.levels[2:4]):
        assert isinstance(lv, tat.GeneralLevel) and torch.equal(lv.geo, want.geo)
    u0 = torch.as_tensor(np.random.default_rng(8).standard_normal((17, 17)),
                         dtype=torch.float32) * th.finest.geo
    _, h = bm.solve(torch.zeros(17, 17), u0=u0, eps=0.0, max_cycles=8)
    assert _tail_q(h) < 0.35, _tail_q(h)
