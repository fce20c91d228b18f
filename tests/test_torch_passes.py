"""Kernels X1-X4 (multigrid_feanet_torch/ops/passes.py): their plain
versions, the twins the CUDA kernels are held to on the card, against the
JAX package's XLA-fused passes on the CPU, and the paths that run them.

- X1 against ``HeatSolver.rhs`` (f32, and f64 with ``HeatSolver.step``);
  X2 and X3 against
  ``4.0 * restrict_full_weighting`` and ``u + prolong_bilinear(u_c, geo)``;
  X4 against ``_outer64``'s arithmetic (solvers/pallas_mg.py:313-318) in
  x64: the same seeded numpy inputs on both sides, at n = 32, 64 and 128,
  homogeneous and circle (1, 20).  Tolerances: max|difference| over
  max|field|, 1e-6 in f32 (the two frameworks round the same ops in other
  orders), 1e-12 in f64.
- The slice against JAX: the round-1 ``Hierarchy.solve`` with X2/X3 wired
  into its V-cycle (tests/test_torch_mg.py's bands), ``solve_ir`` on
  ``HierarchyV2`` (tests/test_torch_ir.py's), ``HeatSolver.march`` in f32
  (tests/test_torch_heat.py's) and with bf16 levels (within 4 bf16 ulps of
  max|u|, tests/test_torch_bf16.py's band); each path is counted through
  its pass.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.core.problem import Problem as JProblem
from multigrid_feanet_tpu.core.problem import build_level as jbuild_level
from multigrid_feanet_tpu.ops import heat as jheat
from multigrid_feanet_tpu.ops import transfer as jtr
from multigrid_feanet_tpu.solvers import jacobi as jjac
from multigrid_feanet_tpu.solvers import pallas_mg as jmg

from multigrid_feanet_torch.core.problem import GridHierarchy, Problem, build_level
from multigrid_feanet_torch.ops import heat as theat
from multigrid_feanet_torch.ops import passes as px
from multigrid_feanet_torch.ops import stencil as tst
from multigrid_feanet_torch.ops import sweep as sw
from multigrid_feanet_torch.solvers.mg import solve_ir

from test_torch_heat import _solvers as _heat_solvers
from test_torch_ir import _rhs, _same_ir
from test_torch_mg import CASES as _R1_CASES
from test_torch_mg import _same as _same_solve
from test_torch_mg import _setup as _r1_setup
from test_torch_mg2 import _pair as _v2_pair

CIRCLE = ("circle", (0.0, 0.0), 0.5)
INCLUSIONS = {"hom": None, "bim": CIRCLE}
SIZES = (32, 64, 128)
F32_TOL, F64_TOL = 1e-6, 1e-12
DT = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got = got.double().numpy() if torch.is_tensor(got) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-300)


def _fields(n, seed, count, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n + 1, n + 1)).astype(dtype) for _ in range(count)]


def _stiffness(n, inc, dtype=torch.float32):
    """The port's finest level of the problem (its K: bitplane or table)."""
    return build_level(Problem(n=n, inclusion=INCLUSIONS[inc], dtype=dtype), n, device="cpu")


# ---- X1-X4 against the JAX package's passes ----


@pytest.mark.parametrize("timedep", [False, True], ids=["f_const", "f_knots"])
@pytest.mark.parametrize("theta", [0.5, 1.0])
@pytest.mark.parametrize("inc", list(INCLUSIONS))
@pytest.mark.parametrize("n", SIZES)
def test_heat_rhs_matches_jax(n, inc, theta, timedep):
    """X1 against HeatSolver.rhs: one f (the time-independent march passes
    it as both knots) or two knots."""
    u, f0, f1 = _fields(n, 10 + n, 3)
    f1 = f1 if timedep else f0
    js = jheat.HeatSolver(JProblem(n=n, inclusion=INCLUSIONS[inc]), DT, theta=theta)
    want = js.rhs(jnp.asarray(u), jnp.asarray(f0), jnp.asarray(f1))
    form = px.operator_form(_stiffness(n, inc))
    got = px.heat_rhs_plain(*map(torch.from_numpy, (u, f0, f1)), h=2.0 / n, theta=theta,
                            dt=DT, **form)
    assert got.dtype == torch.float32 and _rel(got, want) <= F32_TOL
    # HeatSolver.rhs itself is X1's dispatch
    ts = theat.HeatSolver(Problem(n=n, inclusion=INCLUSIONS[inc]), DT, theta=theta,
                          device="cpu")
    assert torch.equal(ts.rhs(u, f0, f1), got)


@pytest.mark.parametrize("theta", [0.5, 1.0])
@pytest.mark.parametrize("inc", list(INCLUSIONS))
def test_heat_f64_matches_jax(inc, theta):
    """A float64 HeatSolver (the JAX package's heat tests run in f64): X1's
    plain version computes in f64 against JAX's f64 rhs at 1e-12, and one
    implicit step solved to eps = 1e-12 against JAX's f64 step at 1e-10 of
    max|u| (the two solves may stop a cycle apart, each below eps)."""
    n, dt = 16, 0.05  # tests/test_heat.py's backward-Euler size and step
    rng = np.random.default_rng(70)
    u = np.zeros((n + 1, n + 1))
    u[1:-1, 1:-1] = rng.standard_normal((n - 1, n - 1))
    f0, f1 = rng.standard_normal((2, n + 1, n + 1))
    jprob = JProblem(n=n, inclusion=INCLUSIONS[inc], dtype=jnp.float64)
    js = jheat.HeatSolver(jprob, dt, theta=theta)
    ts = theat.HeatSolver(Problem(n=n, inclusion=INCLUSIONS[inc], dtype=torch.float64), dt,
                          theta=theta, device="cpu")
    b = ts.rhs(u, f0, f1)
    assert b.dtype == torch.float64
    assert _rel(b, js.rhs(*map(jnp.asarray, (u, f0, f1)))) <= F64_TOL
    uj, _ = js.step(*map(jnp.asarray, (u, f0, f1)), eps=1e-12)
    ut, ht = ts.step(u, f0, f1, eps=1e-12)
    assert ut.dtype == torch.float64 and ht[-1] <= 1e-12
    assert _rel(ut, uj) <= 1e-10
    # X1's float64 weights are the plain version's f64 numbers; the kernel
    # takes a float64 u only with float64 f
    w = np.ctypeslib.as_array(px._rhs_weights(2.0 / n, theta, dt, 1.0, 20.0, (0.0,) * 9, True))
    assert w.dtype == np.float64
    np.testing.assert_array_equal(w[:9], ((2.0 / n) ** 2 * np.asarray(tst.MASS_KERNEL)).ravel())
    np.testing.assert_array_equal(w[-4:], [theta, 1.0 - theta, (1.0 - theta) * dt, dt])
    with pytest.raises(ValueError, match="float64 f0 and f1"):
        px.heat_rhs_cuda(b, b.float(), b.float(), h=2.0 / n, theta=theta, dt=dt,
                         **px.operator_form(ts.stiff.finest))


def _residual(n, inc, seed):
    """A residual field of the level's operator, zero on the boundary ring,
    as the V-cycle restricts it."""
    u, f = _fields(n, seed, 2)
    lv = _stiffness(n, inc)
    r = torch.from_numpy(f) - lv.apply(torch.from_numpy(u))
    return (r * lv.geo).numpy(), lv


@pytest.mark.parametrize("inc", list(INCLUSIONS))
@pytest.mark.parametrize("n", SIZES)
def test_restrict_matches_jax(n, inc):
    """X2 against 4 restrict_full_weighting(r), and bitwise the port's
    restrict_full_weighting it moves."""
    from multigrid_feanet_torch.ops.transfer import restrict_full_weighting

    r, _ = _residual(n, inc, 20 + n)
    got = px.restrict_plain(torch.from_numpy(r))
    assert got.shape == (n // 2 + 1, n // 2 + 1)
    assert _rel(got, 4.0 * jtr.restrict_full_weighting(jnp.asarray(r))) <= F32_TOL
    assert torch.equal(got, 4.0 * restrict_full_weighting(torch.from_numpy(r)))
    assert not got[0].any() and not got[:, -1].any()


@pytest.mark.parametrize("inc", list(INCLUSIONS))
@pytest.mark.parametrize("n", SIZES)
def test_prolong_add_matches_jax(n, inc):
    """X3 against u + prolong_bilinear(u_c, geo)."""
    (u,), (uc,) = _fields(n, 30 + n, 1), _fields(n // 2, 31 + n, 1)
    geo = _stiffness(n, inc).geo
    got = px.prolong_add_plain(torch.from_numpy(u), torch.from_numpy(uc), geo)
    want = jnp.asarray(u) + jtr.prolong_bilinear(jnp.asarray(uc), jnp.asarray(geo.numpy()))
    assert _rel(got, want) <= F32_TOL
    np.testing.assert_array_equal(got.numpy()[0], u[0])  # the ring keeps u


@pytest.mark.parametrize("e_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("inc", list(INCLUSIONS))
@pytest.mark.parametrize("n", SIZES)
def test_outer_step_matches_jax(n, inc, e_dtype):
    """X4 against _outer64's arithmetic in x64: u + e geo, r = f - A u, the
    interior norm; e a float32 or a bf16 (the bf16 hierarchy's) correction."""
    u, f = _fields(n, 40 + n, 2, np.float64)
    (e,) = _fields(n, 41 + n, 1)
    e = 1e-3 * e
    je = jnp.asarray(e, jnp.bfloat16 if e_dtype == "bf16" else jnp.float32)
    te = torch.from_numpy(e).to(torch.bfloat16 if e_dtype == "bf16" else torch.float32)
    lj = jbuild_level(JProblem(n=n, inclusion=INCLUSIONS[inc], dtype=jnp.float64), n)
    geo = lj.geo.astype(jnp.float64)
    uj = jnp.asarray(u) + je.astype(jnp.float64) * geo
    rj = jnp.asarray(f) - lj.apply(uj)
    lt = _stiffness(n, inc, torch.float64)
    ut, r32, rsq = px.outer_step_plain(torch.from_numpy(u), te, torch.from_numpy(f), lt.geo,
                                       **px.operator_form(lt))
    assert ut.dtype == torch.float64 and r32.dtype == torch.float32 and rsq.dim() == 0
    assert _rel(ut, uj) <= F64_TOL
    assert _rel(r32, rj.astype(jnp.float32)) <= F32_TOL
    assert abs(float(torch.sqrt(rsq)) / float(jjac.interior_norm(rj)) - 1.0) <= F64_TOL


# ---- the kernels' arguments ----


def test_kernel_taps_follow_the_plain_dicts():
    """csrc/passes.cu sums S9's taps in UNIT_S9's dict order and each S4's
    as (centre, row edge, column edge, corner) with the weights (C, E, E,
    D); the weights the wrappers pack are the plain versions' float32 (X1)
    and float64 (X4) roundings."""
    assert px.S9_ORDER == tuple(tst.UNIT_S9)
    rows = (-1, -1, 1, 1)
    cols = (-1, 1, -1, 1)
    for e, taps in enumerate(tst.UNIT_S4):
        assert tuple(taps) == ((0, 0), (rows[e], 0), (0, cols[e]), (rows[e], cols[e]))
        assert list(taps.values()) == list(tst.UNIT_S4[0].values())
    h, theta = 2.0 / 64, 0.5
    w = np.ctypeslib.as_array(px._rhs_weights(h, theta, DT, 1.0, 20.0, (0.0,) * 9))
    assert w.shape == (36,) and w.dtype == np.float32
    m = ((h * h) * torch.as_tensor(tst.MASS_KERNEL, dtype=torch.float32)).reshape(-1)
    np.testing.assert_array_equal(w[:9], m.numpy())
    np.testing.assert_array_equal(w[27:], np.float32([2 / 3, -1 / 6, -1 / 3, 1.0, 19.0, 0.5,
                                                      0.5, 0.5 * DT, DT]))
    w64 = np.ctypeslib.as_array(px._outer_weights(None, None, tuple(range(9))))
    assert w64.shape == (23,) and w64.dtype == np.float64
    np.testing.assert_array_equal(w64[:9], np.arange(9.0))


def test_operator_forms_and_refusals():
    """operator_form reads the bitplane form or the homogeneous table and
    refuses the phase-affine one; the kernels refuse the gathered pattern
    table and CPU tensors, the dispatchers run the plain versions on the
    CPU."""
    bim, hom = _stiffness(32, "bim"), _stiffness(32, "hom")
    assert set(px.operator_form(bim)) == {"pid", "a0", "a1"}
    form = px.operator_form(hom)
    assert form["pid"] is None and np.asarray(form["table"]).shape == (3, 3)
    sys = theat.heat_system_hierarchy(Problem(n=32, inclusion=CIRCLE), DT, device="cpu")
    with pytest.raises(ValueError, match="phase-affine"):
        px.operator_form(sys.finest)
    general = build_level(Problem(n=32, inclusion=CIRCLE, coefficients=(1.0, 5.0, 9.0)), 32,
                          device="cpu")
    with pytest.raises(ValueError, match="gathered"):
        px._kernel_form(general.pid, None, None, general.table.tolist())
    (u,) = map(torch.from_numpy, _fields(32, 50, 1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        px.restrict_cuda(u)
    with pytest.raises(ValueError, match="CUDA tensors"):
        px.heat_rhs_cuda(u, u, u, h=1.0, theta=0.5, dt=DT, **form)
    assert torch.equal(px.restrict(u), px.restrict_plain(u))
    with pytest.raises(ValueError, match="even"):
        px._even(31)
    # the plain gather form is Level.apply's
    (v,) = map(torch.from_numpy, _fields(32, 51, 1, np.float64))
    g64 = build_level(Problem(n=32, inclusion=CIRCLE, coefficients=(1.0, 5.0, 9.0),
                              dtype=torch.float64), 32, device="cpu")
    _, r32, _ = px.outer_step_plain(v, torch.zeros(33, 33), v, g64.geo, g64.pid,
                                    table=g64.table)
    assert torch.equal(r32, (v - g64.apply(v)).float())


# ---- the slice against JAX ----


def _counting(monkeypatch, name):
    calls = []
    fn = getattr(px, name)
    monkeypatch.setattr(px, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


def _r1(case, monkeypatch):
    """A round-1 solve of tests/test_torch_mg.py's CASES with X2/X3 on its
    kernel levels (64 and 32 homogeneous; 64, 32 and 16 bi-material, direct
    coarse)."""
    n, inc, thr, nl, direct, nu, eps = _R1_CASES[case]
    _, ph, th, f = _r1_setup(n, inc, thr, nl, direct)
    restricts, prolongs = (_counting(monkeypatch, k) for k in ("restrict", "prolong_add"))
    tres = th.solve(np.asarray(f), nu1=nu, nu2=nu, eps=eps)
    _same_solve(ph.solve(f, nu1=nu, nu2=nu, eps=eps), tres)
    kernel_transfers = sum(p is not None for p in th.ps[:-1])
    assert kernel_transfers >= 2 and tres[1][-1] <= eps
    assert len(restricts) == len(prolongs) == kernel_transfers * len(tres[1])


def _ir(inc, monkeypatch):
    """solve_ir on HierarchyV2 with bench.py's 6 cycles a correction: one
    X4 outer step per history entry."""
    jh, th = _v2_pair(64, INCLUSIONS[inc], None, True)
    steps = _counting(monkeypatch, "outer_step")
    f = _rhs(64)
    kw = dict(eps=1e-10, cycles_per_correction=6, max_outer=12)
    tres = solve_ir(th, f, **kw)
    _same_ir(jmg.solve_ir(jh, jnp.asarray(f), **kw), tres)
    assert tres[1][-1] <= 1e-10 and len(steps) == len(tres[1])


def _march(dtype, monkeypatch):
    """The fused march, 4 steps of 2 V(1,1) cycles: one X1 a step."""
    n, steps = (64, 4) if dtype == "f32" else (32, 2)
    if dtype == "f32":
        js, ts = _heat_solvers(n, "bim", 0.01, 1.0, direct_coarse=False)
        band = 5e-5
    else:
        js = jheat.HeatSolver(JProblem(n=n, inclusion=CIRCLE), 0.002, theta=0.5,
                              backend="pallas",
                              pallas_kw=dict(pallas_threshold=16, rows=32, interpret=True,
                                             dtype=jnp.bfloat16))
        ts = theat.HeatSolver(Problem(n=n, inclusion=CIRCLE), 0.002, theta=0.5,
                              backend="fused",
                              kernel_kw=dict(kernel_threshold=16, dtype=torch.bfloat16),
                              device="cpu")
    rhs = _counting(monkeypatch, "heat_rhs")
    rng = np.random.default_rng(11)
    u0 = np.zeros((n + 1, n + 1), np.float32)
    u0[1:-1, 1:-1] = rng.standard_normal((n - 1, n - 1)).astype(np.float32)
    f = rng.standard_normal((n + 1, n + 1)).astype(np.float32)
    mj = np.asarray(js.march(jnp.asarray(u0), jnp.asarray(f), steps, cycles_per_step=2)
                    .astype(jnp.float32))
    mt = ts.march(u0, f, steps, cycles_per_step=2)
    assert len(rhs) == steps
    if dtype == "bf16":
        assert mt.dtype == torch.bfloat16
        band = 4 * sw.TOL_BF16 * np.abs(mj).max()
    np.testing.assert_allclose(mt.float().numpy(), mj, atol=band)


SLICE = {"r1_hom": lambda mp: _r1("hom_v11_mixed", mp),
         "r1_bim": lambda mp: _r1("bim_v11_direct", mp),
         "ir_v2_hom": lambda mp: _ir("hom", mp), "ir_v2_bim": lambda mp: _ir("bim", mp),
         "march_f32": lambda mp: _march("f32", mp), "march_bf16": lambda mp: _march("bf16", mp)}


@pytest.mark.parametrize("case", list(SLICE))
def test_slice_matches_jax(case, monkeypatch):
    """The paths of this slice, each through its pass, against the JAX
    solvers they port."""
    SLICE[case](monkeypatch)


def test_hierarchy_transfers_below_the_threshold_stay_plain(monkeypatch):
    """Levels under the kernel threshold keep the plain transfers: only the
    fine side of a transfer decides."""
    hier = GridHierarchy.create(Problem(n=64, inclusion=CIRCLE), 4, device="cpu")
    from multigrid_feanet_torch.solvers.mg import Hierarchy

    h = Hierarchy(hier, kernel_threshold=32, device="cpu")  # kernel levels 64, 32
    restricts = _counting(monkeypatch, "restrict")
    prolongs = _counting(monkeypatch, "prolong_add")
    h.solve(np.zeros((65, 65), np.float32), u0=_fields(64, 60, 1)[0], eps=0.0, max_cycles=2)
    assert len(restricts) == len(prolongs) == 2 * 2
