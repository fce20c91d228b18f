"""The port's BoxMG setup (multigrid_feanet_torch/ops/boxmg.py) and solver
(multigrid_feanet_torch/solvers/boxmg.py) against the JAX package, on the
CPU.

The setup is plain tensor code on both sides and must agree to 1e-12 in f64
(only the order in which XLA and PyTorch round the same sums differs); its
defining identities (R = P^T, the variational identity at every depth) are
checked on the port's own output, as tests/test_boxmg_setup.py does for the
JAX one.  The solve runs the JAX PallasBoxMG in interpret mode and the
port's BoxMGHierarchy (plain versions of D1-D5) on the same hierarchy and
setup, within the bands of tests/test_torch_mg2.py: cycle count +-1, the
first residual to 1e-4 relative, every history ratio within [0.8, 1.25],
the solution to 1e-3 of its scale.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.core.problem import GridHierarchy as JHierarchy
from multigrid_feanet_tpu.core.problem import Problem as JProblem
from multigrid_feanet_tpu.ops import adaptive_transfer as jat
from multigrid_feanet_tpu.ops import boxmg as jboxmg
from multigrid_feanet_tpu.solvers.pallas_boxmg import PallasBoxMG

from multigrid_feanet_torch.core.convert import boxmg_setup_from_arrays, hierarchy_from_arrays
from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
from multigrid_feanet_torch.ops import adaptive_transfer as tat
from multigrid_feanet_torch.ops import boxmg as tboxmg
from multigrid_feanet_torch.solvers.boxmg import BoxMGHierarchy
from multigrid_feanet_torch.solvers.mg2 import HierarchyV2

CIRCLE = ("circle", (0.0, 0.0), 0.5)
INCLUSIONS = {"hom": None, "bim": CIRCLE}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _hiers(n, inc):
    """The JAX and the port's f64 hierarchies of one problem."""
    jh = JHierarchy.create(JProblem(n=n, inclusion=INCLUSIONS[inc], dtype=jnp.float64))
    th = GridHierarchy.create(Problem(n=n, inclusion=INCLUSIONS[inc], dtype=torch.float64),
                              device="cpu")
    return jh, th


def _zero_ring(x):
    x = x.clone()
    x[0], x[-1], x[:, 0], x[:, -1] = 0, 0, 0, 0
    return x


@pytest.mark.parametrize("inc", list(INCLUSIONS))
def test_setup_matches_jax(inc):
    """node_stencil_planes, every W4_l and every Sc_{l+1} to 1e-12 (f64)."""
    jh, th = _hiers(32, inc)
    np.testing.assert_allclose(
        tboxmg.node_stencil_planes(th.levels[0], torch.float64).numpy(),
        np.asarray(jboxmg.node_stencil_planes(jh.levels[0], jnp.float64)), rtol=0, atol=1e-12)
    jouts = jboxmg.boxmg_setup(jh, dtype=jnp.float64)
    touts = tboxmg.boxmg_setup(th, dtype=torch.float64)
    assert len(touts) == len(jouts) == th.num_levels - 1
    for (jw, js), (tw, ts) in zip(jouts, touts):
        assert tw.shape == jw.shape and ts.shape == js.shape
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-12)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-12)
    # deeper than the hierarchy: ring masks stand in for the missing levels
    jdeep = jboxmg.boxmg_setup(JHierarchy(levels=jh.levels[:3]), 4, dtype=jnp.float64)
    tdeep = tboxmg.boxmg_setup(GridHierarchy(levels=th.levels[:3]), 4, dtype=torch.float64)
    np.testing.assert_allclose(tdeep[-1][1].numpy(), np.asarray(jdeep[-1][1]),
                               rtol=0, atol=1e-12)


def test_transfers_are_adjoint_and_match_jax():
    """<P u_c, r> = <u_c, R r>; both transfers equal the JAX ones."""
    _, th = _hiers(32, "bim")
    lv0, lv1 = th.levels[0], th.levels[1]
    S = tboxmg.node_stencil_planes(lv0, torch.float64)
    W4 = tboxmg.transfer_weights(S, lv0.geo, lv1.geo)
    rng = np.random.default_rng(1)
    uc = torch.from_numpy(rng.standard_normal((17, 17)))
    r = torch.from_numpy(rng.standard_normal((33, 33)))
    lhs = float(torch.sum(tboxmg.prolong_w4(uc, W4) * r))
    rhs = float(torch.sum(uc * tboxmg.restrict_w4(r, W4)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-13)
    jW4 = jnp.asarray(W4.numpy())
    np.testing.assert_allclose(tboxmg.prolong_w4(uc, W4).numpy(),
                               np.asarray(jboxmg.prolong_w4(jnp.asarray(uc.numpy()), jW4)),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(tboxmg.restrict_w4(r, W4).numpy(),
                               np.asarray(jboxmg.restrict_w4(jnp.asarray(r.numpy()), jW4)),
                               rtol=0, atol=1e-12)
    u = torch.from_numpy(rng.standard_normal((33, 33)))
    np.testing.assert_allclose(tboxmg.apply_s9(S, u).numpy(),
                               np.asarray(jboxmg.apply_s9(jnp.asarray(S.numpy()),
                                                          jnp.asarray(u.numpy()))),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("inc", list(INCLUSIONS))
def test_galerkin_variational_at_depth(inc):
    """<A_c u_c, v_c> = <A P u_c, P v_c> for every level pair of the port's
    setup, on zero-ring fields (where the ring-centre guard is invisible)."""
    _, th = _hiers(32, inc)
    touts = tboxmg.boxmg_setup(th, dtype=torch.float64)
    rng = np.random.default_rng(4)
    S = tboxmg.node_stencil_planes(th.levels[0], torch.float64)
    for l, (W4, Sc) in enumerate(touts):
        m = Sc.shape[0]
        uc = _zero_ring(torch.from_numpy(rng.standard_normal((m, m))))
        vc = _zero_ring(torch.from_numpy(rng.standard_normal((m, m))))
        lhs = float(torch.sum(tboxmg.apply_s9(Sc, uc) * vc))
        Pu, Pv = tboxmg.prolong_w4(uc, W4), tboxmg.prolong_w4(vc, W4)
        rhs = float(torch.sum(tboxmg.apply_s9(S, Pu) * Pv))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-11, err_msg=f"level {l}")
        S = Sc


def test_general_coarse_inverse_matches_jax():
    """The dense coarse inverse of a Galerkin level: host f64 on both
    sides, bitwise equal; GeneralLevel's apply and guarded diagonal too."""
    jh, th = _hiers(32, "bim")
    Sc = tboxmg.boxmg_setup(th, dtype=torch.float64)[2][1]  # n = 4
    jl = jat.GeneralLevel(Sc.numpy(), jh.levels[3].geo, dtype=jnp.float64)
    tl = tat.GeneralLevel(Sc, th.levels[3].geo, dtype=torch.float64)
    np.testing.assert_array_equal(tat.general_coarse_inverse(tl, torch.float64).numpy(),
                                  np.asarray(jat.general_coarse_inverse(jl, jnp.float64)))
    np.testing.assert_array_equal(tl.diag.numpy(), np.asarray(jl.diag))
    v = torch.from_numpy(np.random.default_rng(5).standard_normal((5, 5)))
    np.testing.assert_allclose(tl.apply(v).numpy(), np.asarray(jl.apply(jnp.asarray(v.numpy()))),
                               rtol=0, atol=1e-12)


def test_setup_from_arrays_carries_dtype_and_device():
    arrays = [(np.ones((5, 5, 2, 2), np.float32), np.ones((3, 3, 3, 3), np.float64))]
    (w4, sc), = boxmg_setup_from_arrays(arrays, device="cpu")
    assert w4.dtype == torch.float32 and sc.dtype == torch.float64 and w4.device.type == "cpu"
    (w4, sc), = boxmg_setup_from_arrays(arrays, device="cpu", dtype=torch.float32)
    assert sc.dtype == torch.float32 and sc.shape == (3, 3, 3, 3)


def _boxmg_pair(n, bf16, direct):
    """JAX PallasBoxMG and the port's BoxMGHierarchy on the same hierarchy
    and setup (port on the CPU), with bf16 or f32 coefficient planes."""
    jp = JProblem(n=n, inclusion=CIRCLE)
    jb = PallasBoxMG(jp, pallas_threshold=16, rows=32, interpret=True, direct_coarse=direct,
                     coef_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    arrays = [dict(n=lv.n, h=lv.h, a0=lv.a0, a1=lv.a1, table=np.asarray(lv.table),
                   pid=None if lv.pid is None else np.asarray(lv.pid), geo=np.asarray(lv.geo),
                   diag=np.asarray(lv.diag), phase=jp.phase(lv.n))
              for lv in jb.hier.levels]
    setup = boxmg_setup_from_arrays([(np.asarray(w), np.asarray(s)) for w, s in jb.setup],
                                    device="cpu")
    tb = BoxMGHierarchy(Problem(n=n, inclusion=CIRCLE), kernel_threshold=16,
                        direct_coarse=direct, hier=hierarchy_from_arrays(arrays, device="cpu"),
                        setup=setup, coef_dtype=torch.bfloat16 if bf16 else torch.float32,
                        device="cpu")
    assert tb.K == jb.K
    if direct:
        np.testing.assert_allclose(tb.coarse_inv.numpy(), np.asarray(jb.coarse_inv),
                                   rtol=0, atol=1e-6 * float(np.abs(jb.coarse_inv).max()))
    return jb, tb


def _assert_same_solve(jres, tres, max_cycles):
    (uj, hj), (ut, ht) = jres, tres
    hj, ht = np.asarray(hj), np.asarray(ht)
    assert ut.device == torch.device("cpu") and ut.dtype == torch.float32
    assert abs(len(hj) - len(ht)) <= 1
    assert len(hj) < max_cycles and len(ht) < max_cycles  # converged, not capped
    assert abs(ht[0] - hj[0]) / hj[0] < 1e-4
    m = min(len(hj), len(ht))
    ratio = ht[:m] / hj[:m]
    assert np.all(ratio > 0.8) and np.all(ratio < 1.25), ratio
    uj = np.asarray(uj)
    scale = float(np.max(np.abs(uj)))
    assert float(np.max(np.abs(ut.numpy() - uj))) / scale < 1e-3


CASES = {
    # name: (n, bf16 planes, direct_coarse, solve kwargs)
    "decay_f32": (64, False, True, dict(eps=1e-6, max_cycles=60, chunk=2, decay=True)),
    "decay_bf16": (64, True, True, dict(eps=1e-6, max_cycles=60, chunk=2, decay=True)),
    "v21_bc": (32, False, True, dict(eps=1e-3, max_cycles=40, nu1=2, nu2=1, bc_value=0.7)),
    "plain_subtree": (64, False, False, dict(eps=1e-3, max_cycles=40)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_solve_matches_pallas_boxmg(case):
    n, bf16, direct, kw = CASES[case]
    kw = dict(kw)
    jb, tb = _boxmg_pair(n, bf16, direct)
    rng = np.random.default_rng(0)
    if kw.pop("decay", False):
        # the f = 0 decay protocol from a seeded random iterate
        f = np.zeros((n + 1, n + 1), np.float32)
        kw["u0"] = (150000.0 * rng.uniform(size=(n + 1, n + 1))).astype(np.float32)
    else:
        f = rng.standard_normal((n + 1, n + 1)).astype(np.float32)
    jkw = {k: jnp.asarray(v) if k == "u0" else v for k, v in kw.items()}
    jres = jb.solve(jnp.asarray(f), **jkw)
    tres = tb.solve(f, **kw)
    _assert_same_solve(jres, tres, kw["max_cycles"])
    if "bc_value" in kw:
        np.testing.assert_allclose(tres[0].numpy()[0, :], kw["bc_value"], atol=1e-6)


def test_boxmg_beats_the_plain_vcycle():
    """On the interface problem the operator-induced hierarchy takes fewer
    cycles to the same eps than HierarchyV2, at a tail factor near the
    homogeneous problem's, as tests/test_pallas_boxmg.py checks for JAX."""
    n = 64
    prob = Problem(n=n, inclusion=CIRCLE)
    bm = BoxMGHierarchy(prob, kernel_threshold=16, device="cpu")
    hv = HierarchyV2(prob, kernel_threshold=16, device="cpu")
    rng = np.random.default_rng(0)
    f0 = np.zeros((n + 1, n + 1), np.float32)
    u0 = rng.standard_normal((n + 1, n + 1)).astype(np.float32) * 100.0
    _, h_b = bm.solve(f0, u0=u0, eps=1e-6, max_cycles=60)
    _, h_p = hv.solve(f0, u0=u0, eps=1e-6, max_cycles=60)
    assert len(h_b) < 60 and len(h_p) < 60
    assert len(h_b) < len(h_p)
    q_b = float(np.exp(np.mean(np.diff(np.log(h_b))[2:])))
    q_p = float(np.exp(np.mean(np.diff(np.log(h_p))[2:])))
    assert q_b < 0.40 and q_b < q_p - 0.05, (q_b, q_p)


def test_later_slices_and_bad_arguments_raise():
    prob = Problem(n=32, inclusion=CIRCLE)
    bm = BoxMGHierarchy(prob, num_levels=3, kernel_threshold=16, device="cpu")
    # solve_pcg, once refused here, now runs (held to the JAX solver in
    # tests/test_torch_pcg.py)
    f = np.random.default_rng(7).standard_normal((33, 33)).astype(np.float32)
    u, hist = bm.solve_pcg(f, eps=1e-3, max_iters=40)
    assert hist[-1] <= 1e-3 and bool(torch.isfinite(u).all())
    with pytest.raises(ValueError, match="kernel_threshold"):
        BoxMGHierarchy(prob, num_levels=3, kernel_threshold=64, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        BoxMGHierarchy(prob, num_levels=4, hier=bm.hier, kernel_threshold=16, device="cpu")
    with pytest.raises(ValueError, match="level pairs"):
        BoxMGHierarchy(prob, num_levels=3, setup=bm.setup[:1], kernel_threshold=16,
                       device="cpu")

    # the phase-affine level form, once refused here, now gives each node's
    # row of the system table (held to the JAX function in
    # tests/test_torch_heat.py)
    from multigrid_feanet_torch.ops.heat import heat_system_hierarchy

    lv = heat_system_hierarchy(Problem(n=16, inclusion=CIRCLE, dtype=torch.float64), 0.01,
                               device="cpu").finest
    assert lv.base is not None and lv.a0 is None
    S = tboxmg.node_stencil_planes(lv)
    torch.testing.assert_close(S, lv.table[lv.pid.long()], rtol=1e-12, atol=1e-15)
