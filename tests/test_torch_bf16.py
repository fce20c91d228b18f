"""bf16 level storage of the port's fused V-cycle (``SweepLevel``,
``HierarchyV2``, ``solve_ir`` and ``HeatSolver`` with ``dtype=torch.bfloat16``)
against the JAX package's ``dtype=jnp.bfloat16`` (Pallas kernels in
interpret mode), on the CPU.

Inputs are made with numpy from a seed and rounded to bf16 on both sides
(JAX's ``pad``, torch's ``.to``: both round to nearest even).  Tolerances:

- a leg's bf16 output agrees with the JAX kernel's within one bf16 ulp per
  element beyond ``TOL`` of max(1, max|ref|) (``ops.sweep.bf16_excess``):
  both compute in f32 in other orders and round once; rsq, an f32 sum of the
  f32 residual, to 1e-5 relative;
- a solve takes the JAX solver's cycles, its history within 1% (bf16
  rounding flips, re-injected every cycle, move the histories apart);
- ``solve_ir`` takes the JAX solver's outer steps to an f64 residual <= eps
  (1e-7, clear of both sides' histories by 4x);
- the heat step's first residuals within 1%, the march's u within 4 bf16
  ulps of max|u|: the JAX march forms its right-hand side from the bf16
  iterate in bf16 arithmetic, the port in f32.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.core.problem import Problem as JProblem
from multigrid_feanet_tpu.ops import heat as jheat
from multigrid_feanet_tpu.ops import stencil as jst
from multigrid_feanet_tpu.ops.pallas_sweep import PallasLevel
from multigrid_feanet_tpu.solvers import pallas_mg as jmg
from multigrid_feanet_tpu.solvers.pallas_mg2 import PallasHierarchyV2

from multigrid_feanet_torch.core.convert import hierarchy_from_arrays
from multigrid_feanet_torch.core.problem import Problem, build_level
from multigrid_feanet_torch.ops import heat as theat
from multigrid_feanet_torch.ops import sweep as sw
from multigrid_feanet_torch.ops.sweep import SweepLevel
from multigrid_feanet_torch.solvers.mg import solve_ir
from multigrid_feanet_torch.solvers.mg2 import HierarchyV2

BF16 = torch.bfloat16
CIRCLE = ("circle", (0.0, 0.0), 0.5)
INCLUSIONS = {"hom": None, "bim": CIRCLE}
R = 32  # PallasLevel row block
RSQ_TOL = 1e-5
HEAT_DT, HEAT_THETA = 1e-3, 0.5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _agree(got, want):
    assert got.dtype == BF16
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    assert sw.bf16_excess(got, want) <= sw.TOL


def _rsq_agree(got, want):
    assert abs(float(got) - float(want)) <= RSQ_TOL * abs(float(want))


def _level_pair(n, inc, form):
    """The JAX bf16 level (and its coarse layout twin) and the port's, in
    the default stiffness form (difference form) or the heat level's mass
    form, plus seeded inputs rounded to bf16 for the port."""
    phase = JProblem(n=n, inclusion=INCLUSIONS[inc]).phase(n) if inc == "bim" else None
    kw = {}
    if form == "mass":
        td = HEAT_THETA * HEAT_DT
        kw = dict(coefficients=(td, 20.0 * td),
                  mass=theat.heat_mass(build_level(Problem(n=n), n, device="cpu")))
    jl = PallasLevel(n, phase=phase, Wp=128, rows=R, rows_next=R, interpret=True,
                     dtype=jnp.bfloat16, **kw)
    jc = PallasLevel(n // 2, stride=2, Wp=128, rows=R, rows_next=R, interpret=True,
                     dtype=jnp.bfloat16)
    tl = SweepLevel(n, phase=phase, dtype=BF16, device="cpu", **kw)
    assert tl.dform == jl.dform == (form != "mass")
    rng = np.random.default_rng(0)
    H, Hc = n + 1, n // 2 + 1
    geo = np.zeros((H, H), np.float32)
    geo[1:-1, 1:-1] = 1.0
    u = (rng.standard_normal((H, H)).astype(np.float32) * geo
         + np.float32(0.7) * (1 - geo))  # a nonzero Dirichlet ring
    f = rng.standard_normal((H, H)).astype(np.float32)
    uc = rng.standard_normal((Hc, Hc)).astype(np.float32)
    return jl, jc, tl, u, f, uc


@pytest.mark.parametrize("form", ["stiffness", "mass"])
@pytest.mark.parametrize("inc", list(INCLUSIONS))
def test_bf16_legs_match_pallas(inc, form):
    """Every SweepLevel leg in bf16 storage against
    PallasLevel(dtype=bfloat16) at n = 64: A1 (sweep, residual, psweep),
    A2, A3 and A4 in both forms, A5 and A6 in the stiffness form."""
    jl, jc, tl, u, f, uc = _level_pair(64, inc, form)
    up, fp, ucp = (lv.pad(jnp.asarray(x)) for lv, x in ((jl, u), (jl, f), (jc, uc)))
    tu, tf, tuc = (torch.from_numpy(x).to(BF16) for x in (u, f, uc))

    for name, (want, rsq_w), (got, rsq_g) in (
            ("sweep", jl.sweep(up, fp), tl.sweep(tu, tf)),
            ("residual", jl.residual(up, fp), tl.residual(tu, tf)),
            ("psweep", jl.psweep(up, fp, ucp, R_up=R), tl.psweep(tu, tf, tuc))):
        _agree(got, jl.unpad(want))
        _rsq_agree(rsq_g, rsq_w)
    np.testing.assert_array_equal(tl.sweep(tu, tf)[0][0].float().numpy(),
                                  tu[0].float().numpy())  # boundary kept

    u1_w, fc_w, rsq_w = jl.sweep_restrict(up, fp)
    u1_g, fc_g, rsq_g = tl.sweep_restrict(tu, tf)
    _agree(u1_g, jl.unpad(u1_w))
    _agree(fc_g, jc.unpad(fc_w))
    _rsq_agree(rsq_g, rsq_w)

    _agree(tl.zsweep_restrict(tf), jc.unpad(jl.zsweep_restrict(fp)))
    _agree(tl.zpsweep(tf, tuc), jl.unpad(jl.zpsweep(fp, ucp, R_up=R)))
    if form == "mass":
        return
    fc_w, rsq_w = jl.restrict_residual(up, fp)
    fc_g, rsq_g = tl.restrict_residual(tu, tf)
    _agree(fc_g, jc.unpad(fc_w))
    _rsq_agree(rsq_g, rsq_w)

    u4_w, fc_w, rsq_w = jl.pswrr(up, fp, ucp)
    u4_g, fc_g, rsq_g = tl.pswrr(tu, tf, tuc)
    _agree(u4_g, jl.unpad(u4_w))
    _agree(fc_g, jc.unpad(fc_w))
    _rsq_agree(rsq_g, rsq_w)


def test_bf16_plain_versions_round_only_what_they_store():
    """A2's residual comes from its unrounded u1, A6's u4 from its
    unrounded u3: rounding the intermediate changes the result."""
    n = 32
    _, _, tl, u, f, uc = _level_pair(n, "bim", "stiffness")
    tu, tf, tuc = (torch.from_numpy(x).to(BF16) for x in (u, f, uc))
    cfg = dict(a0=tl.a0, da=tl.da, omega=tl.omega, dform=True)
    u1, fc, _ = sw.swrr_plain(tu, tf, tl.ph, **cfg)
    exact, _ = sw.sweep_plain(tu.float(), tf.float(), tl.ph, **cfg)
    torch.testing.assert_close(u1, exact.to(BF16), rtol=0, atol=0)
    r1, _ = sw.sweep_plain(exact, tf.float(), tl.ph, mode="residual", **cfg)
    torch.testing.assert_close(fc, sw._restrict4(r1).to(BF16), rtol=0, atol=0)
    u3, _ = sw.sweep_plain(tu.float(), tf.float(), tl.ph, tuc.float(), **cfg)
    u4_exact, _ = sw.sweep_plain(u3, tf.float(), tl.ph, **cfg)
    u4_rounded, _ = sw.sweep_plain(u3.to(BF16), tf, tl.ph, **cfg)
    u4, _, _ = sw.pswrr_plain(tu, tf, tl.ph, tuc, **cfg)
    torch.testing.assert_close(u4, u4_exact.to(BF16), rtol=0, atol=0)
    assert not torch.equal(u4, u4_rounded)


def test_bf16_level_refuses_other_dtypes():
    """A bf16 level takes bf16 fields only, on the CPU too; the levels store
    float32 or bfloat16 and nothing else; the CUDA wrappers fall back to no
    other type."""
    tl = SweepLevel(8, dtype=BF16, device="cpu")
    u = torch.zeros(9, 9)
    with pytest.raises(ValueError, match="float32"):
        tl.sweep(u, u.to(BF16))
    with pytest.raises(ValueError, match="float32"):
        tl.zsweep_restrict(u)
    with pytest.raises(ValueError, match="float32"):
        tl.sweep(u.to(BF16), u.to(BF16), out=torch.empty(9, 9))
    with pytest.raises(ValueError, match="float16"):
        SweepLevel(8, dtype=torch.float16, device="cpu")
    assert sw._storage(u) == 0 and sw._storage(u.to(BF16)) == 1
    with pytest.raises(ValueError, match="float64"):
        sw._storage(u.double())
    out, rsq = tl.sweep(u.to(BF16), u.to(BF16))
    assert out.dtype == BF16 and rsq.dtype == torch.float32


def _solver_pair(n, inc, dtype=BF16):
    """PallasHierarchyV2 and HierarchyV2 on the same hierarchy: n = 64, 4
    levels, kernel threshold 32 (levels 0-1 fused), direct coarse solve."""
    jp = JProblem(n=n, inclusion=INCLUSIONS[inc])
    jh = PallasHierarchyV2(jp, num_levels=4, pallas_threshold=32, rows=R, rows_coarse=R,
                           interpret=True, dtype=jnp.bfloat16 if dtype == BF16 else jnp.float32)
    arrays = [dict(n=lv.n, h=lv.h, a0=lv.a0, a1=lv.a1, table=np.asarray(lv.table),
                   pid=None if lv.pid is None else np.asarray(lv.pid),
                   geo=np.asarray(lv.geo), diag=np.asarray(lv.diag), phase=jp.phase(lv.n))
              for lv in jh.hier.levels]
    th = HierarchyV2(Problem(n=n, inclusion=INCLUSIONS[inc]), kernel_threshold=32,
                     hier=hierarchy_from_arrays(arrays, np.asarray(jh.coarse_inv), device="cpu"),
                     dtype=dtype, device="cpu")
    assert th.K == jh.K == 2
    return jh, th


def _decay_start(n):
    u0 = np.random.default_rng(0).standard_normal((n + 1, n + 1)).astype(np.float32)
    return u0, np.zeros((n + 1, n + 1), np.float32)


@pytest.mark.parametrize("inc,pswrr", [("hom", False), ("bim", False), ("bim", True)],
                         ids=["hom", "bim", "bim_pswrr"])
def test_bf16_solve_matches_pallas(inc, pswrr):
    """The f = 0 decay solve with bf16 storage: the JAX solver's cycles,
    its history within 1%, a bf16 u; and the cycles of f32 storage (the
    JAX docstring's "same cycle count")."""
    n = 64
    jh, th = _solver_pair(n, inc)
    u0, f0 = _decay_start(n)
    kw = dict(eps=1e-6, max_cycles=40, use_pswrr=pswrr)
    uj, hj = jh.solve(jnp.asarray(f0), u0=jnp.asarray(u0), **kw)
    ut, ht = th.solve(f0, u0=u0, **kw)
    hj = np.asarray(hj)
    assert ut.dtype == BF16 and uj.dtype == jnp.bfloat16 and ht.dtype == np.float32
    assert len(ht) == len(hj) and ht[-1] <= 1e-6
    np.testing.assert_allclose(ht, hj, rtol=1e-2)
    _, h32 = HierarchyV2(Problem(n=n, inclusion=INCLUSIONS[inc]), num_levels=4,
                         kernel_threshold=32, device="cpu").solve(f0, u0=u0, **kw)
    assert abs(len(h32) - len(ht)) <= 1


@pytest.mark.parametrize("inc", list(INCLUSIONS))
def test_bf16_solve_ir_matches_pallas(inc):
    """solve_ir with bf16 corrections (pallas_mg2.py's recommended pairing)
    on f = apply_mass(1, h): the JAX solver's outer steps, its first two
    residuals, a final f64 residual <= eps."""
    n, eps = 64, 1e-7
    jh, th = _solver_pair(n, inc)
    f = np.array(jst.apply_mass(jnp.ones((n + 1, n + 1), jnp.float32), 2.0 / n))
    kw = dict(eps=eps, cycles_per_correction=4, max_outer=20)
    uj, hj = jmg.solve_ir(jh, jnp.asarray(f), **kw)
    ut, ht = solve_ir(th, f, **kw)
    hj = np.asarray(hj)
    assert ut.dtype == torch.float64 and len(ht) == len(hj) and ht[-1] <= eps
    np.testing.assert_allclose(ht[:2], hj[:2], rtol=1e-3)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-8)


def test_bf16_pcg_refused_where_jax_stalls():
    """solve_pcg with bf16 storage raises; the JAX solver runs it and, on a
    random right-hand side at n = 64, stalls at the bf16 floor: its
    residual is still above 0.5 after 20 iterations (f32 reaches 1e-3 in
    5, tests/test_torch_pcg.py's solver)."""
    n = 64
    f = np.random.default_rng(6).standard_normal((n + 1, n + 1)).astype(np.float32)
    jh, th = _solver_pair(n, "hom")
    _, hj = jh.solve_pcg(jnp.asarray(f), eps=1e-3, max_iters=20)
    hj = np.asarray(hj)
    assert len(hj) == 20 and hj[-1] > 0.5
    with pytest.raises(NotImplementedError, match="bfloat16"):
        th.solve_pcg(f, eps=1e-3, max_iters=20)
    _, h32 = HierarchyV2(Problem(n=n), num_levels=4, kernel_threshold=32,
                         device="cpu").solve_pcg(f, eps=1e-3, max_iters=20)
    assert len(h32) <= 6 and h32[-1] <= 1e-3


def test_bf16_heat_step_and_march_match_jax():
    """HeatSolver with bf16 fused levels at n = 32 (JAX: pallas_kw dtype):
    one backward-Euler step stalls at the bf16 floor on both sides (its
    first residuals within 1%, u a bf16 field within 4 ulps of max|u|), and
    the fixed-cycle march returns a bf16 u within 4 ulps of max|u|."""
    n, dt = 32, 0.002
    jp = JProblem(n=n, inclusion=CIRCLE)
    js = jheat.HeatSolver(jp, dt, theta=0.5, backend="pallas",
                          pallas_kw=dict(pallas_threshold=16, rows=R, interpret=True,
                                         dtype=jnp.bfloat16))
    ts = theat.HeatSolver(Problem(n=n, inclusion=CIRCLE), dt, theta=0.5, backend="fused",
                          kernel_kw=dict(kernel_threshold=16, dtype=BF16), device="cpu")
    assert ts.ph.K == js.ph.K and ts.ph.dtype == BF16
    rng = np.random.default_rng(7)
    u = np.zeros((n + 1, n + 1), np.float32)
    u[1:-1, 1:-1] = rng.standard_normal((n - 1, n - 1))
    f = rng.standard_normal((n + 1, n + 1)).astype(np.float32)
    uj, hj = js.step(jnp.asarray(u), jnp.asarray(f), jnp.asarray(f), eps=1e-6, max_cycles=8)
    ut, ht = ts.step(u, f, f, eps=1e-6, max_cycles=8)
    hj = np.asarray(hj)
    assert ut.dtype == BF16 and len(ht) == len(hj) == 7 and hj[-1] > 1e-6
    np.testing.assert_allclose(ht[:3], hj[:3], rtol=1e-2)
    uj = np.asarray(uj.astype(jnp.float32))
    assert np.abs(ut.float().numpy() - uj).max() <= 4 * sw.TOL_BF16 * np.abs(uj).max()

    mj = np.asarray(js.march(jnp.asarray(u), jnp.asarray(f), 2, cycles_per_step=2)
                    .astype(jnp.float32))
    mt = ts.march(u, f, 2, cycles_per_step=2)
    assert mt.dtype == BF16
    assert np.abs(mt.float().numpy() - mj).max() <= 4 * sw.TOL_BF16 * np.abs(mj).max()
