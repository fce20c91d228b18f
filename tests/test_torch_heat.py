"""The port's heat path (multigrid_feanet_torch/ops/heat.py, the mass form of
the legs of ops/sweep.py) against the JAX package, on the CPU.

- The theta-system hierarchy (``table``, ``diag``, ``base``, ``bit_scale``),
  its phase-affine apply, ``node_stencil_planes`` and ``boxmg_setup`` of it
  agree with JAX's in f64 to 1e-12: the same sums in another order.
- The six legs' plain versions in mass form agree with ``PallasLevel(mass=)``
  in interpret mode to 2e-5 of max(1, max|ref|) (2e-5 relative on rsq), f32
  reassociation as in tests/test_torch_sweep.py.
- The fused ``HeatSolver`` (kernel levels as plain versions here) takes the
  JAX Pallas backend's steps within tests/test_heat.py's bands: a step to
  2e-5 absolute, the march to 5e-5, the time-dependent march to 1e-6 of
  the constant one; each backend's run and march agree with the JAX XLA
  backend's to 2e-5.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.core.problem import Problem as JProblem
from multigrid_feanet_tpu.ops import boxmg as jboxmg
from multigrid_feanet_tpu.ops import heat as jheat
from multigrid_feanet_tpu.ops.pallas_sweep import PallasLevel

from multigrid_feanet_torch.core.convert import hierarchy_from_arrays
from multigrid_feanet_torch.core.problem import Problem
from multigrid_feanet_torch.ops import boxmg as tboxmg
from multigrid_feanet_torch.ops import heat as theat
from multigrid_feanet_torch.ops.sweep import SweepLevel

CIRCLE = ("circle", (0.0, 0.0), 0.5)
INCLUSIONS = {"hom": None, "bim": CIRCLE}
TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _problems(n, inc, f64=False):
    jd, td = (jnp.float64, torch.float64) if f64 else (jnp.float32, torch.float32)
    return (JProblem(n=n, inclusion=INCLUSIONS[inc], dtype=jd),
            Problem(n=n, inclusion=INCLUSIONS[inc], dtype=td))


@pytest.mark.parametrize("inc", list(INCLUSIONS))
def test_system_hierarchy_matches_jax(inc):
    """Every level's fields and apply, and the mass table, in f64."""
    jp, tp = _problems(16, inc, f64=True)
    js = jheat.heat_system_hierarchy(jp, 0.01, theta=0.5)
    ts = theat.heat_system_hierarchy(tp, 0.01, theta=0.5, device="cpu")
    rng = np.random.default_rng(0)
    for jl, tl in zip(js.levels, ts.levels, strict=True):
        assert (jl.a0, jl.a1) == (tl.a0, tl.a1)
        for name in ("table", "diag", "base"):
            a, b = getattr(jl, name), getattr(tl, name)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12, atol=1e-15)
        assert tl.bit_scale == jl.bit_scale
        u = rng.standard_normal((tl.n + 1, tl.n + 1))
        np.testing.assert_allclose(tl.apply(torch.from_numpy(u)).numpy(),
                                   np.asarray(jl.apply(jnp.asarray(u))), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(theat.mass_table(0.125, device="cpu").numpy(),
                               np.asarray(jheat.mass_table(0.125)), rtol=1e-15)


def test_affine_apply_matches_gather_and_carries_over():
    """The phase-affine apply equals the system table's gather apply
    (test_affine_bitplane_matches_gather_table), and hierarchy_from_arrays
    carries ``base`` and ``bit_scale`` from the JAX hierarchy's arrays."""
    from multigrid_feanet_torch.ops import stencil as tst

    jp, tp = _problems(32, "bim", f64=True)
    js = jheat.heat_system_hierarchy(jp, dt=0.01, theta=0.5)
    arrays = [dict(n=lv.n, h=lv.h, a0=lv.a0, a1=lv.a1, table=np.asarray(lv.table),
                   pid=np.asarray(lv.pid), geo=np.asarray(lv.geo), diag=np.asarray(lv.diag),
                   phase=jp.phase(lv.n), base=np.asarray(lv.base), bit_scale=lv.bit_scale)
              for lv in js.levels]
    th = hierarchy_from_arrays(arrays, device="cpu")
    u = torch.from_numpy(np.random.default_rng(1).standard_normal((33, 33)))
    for jl, tl in zip(js.levels[:2], th.levels[:2]):
        assert tl.base is not None and tl.a0 is None
        uu = u[: tl.n + 1, : tl.n + 1]
        want = tst.apply_stencil(tl.table, tl.pid, uu)
        torch.testing.assert_close(tl.apply(uu), want, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(tl.apply(uu).numpy(), np.asarray(jl.apply(jnp.asarray(uu))),
                                   rtol=1e-12, atol=1e-12)


def test_node_stencil_planes_and_boxmg_setup_of_heat_hierarchy():
    """The phase-affine branch of node_stencil_planes, and the BoxMG setup it
    feeds, against the JAX functions on the bi-material heat system (f64)."""
    jp, tp = _problems(32, "bim", f64=True)
    js = jheat.heat_system_hierarchy(jp, 0.01, theta=0.5, num_levels=4)
    ts = theat.heat_system_hierarchy(tp, 0.01, theta=0.5, num_levels=4, device="cpu")
    np.testing.assert_allclose(tboxmg.node_stencil_planes(ts.finest).numpy(),
                               np.asarray(jboxmg.node_stencil_planes(js.finest)),
                               rtol=1e-12, atol=1e-15)
    jset = jboxmg.boxmg_setup(js, 4, dtype=jnp.float64)
    tset = tboxmg.boxmg_setup(ts, 4, dtype=torch.float64)
    assert len(jset) == len(tset) == 3
    for (jw, jsc), (tw, tsc) in zip(jset, tset):
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-12, atol=1e-15)


def _rel_err(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want))))


def _rsq_err(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


@pytest.mark.parametrize("inc", list(INCLUSIONS))
def test_mass_legs_match_pallas(inc):
    """A1 (sweep, residual, psweep), A2, A3, A4, A5 and A6 with the heat
    level's operands: theta dt (1, 20), mass h^2 (1/18, 1/18, -1/36)."""
    n, td = 64, 0.5 * 1e-3
    phase = JProblem(n=n, inclusion=INCLUSIONS[inc]).phase(n)
    hh = (2.0 / n) ** 2
    mass = (hh / 18.0, hh / 18.0, -hh / 36.0)
    coeffs = (td * 1.0, td * 20.0)
    jl = PallasLevel(n, phase=phase, coefficients=coeffs, mass=mass, Wp=256, rows=32,
                     rows_next=32, interpret=True)
    jc = PallasLevel(n // 2, stride=2, Wp=256, rows=32, rows_next=32, interpret=True)
    tl = SweepLevel(n, phase=phase, coefficients=coeffs, mass=mass, device="cpu")
    assert not jl.dform and not tl.dform
    rng = np.random.default_rng(3)
    H, Hc = n + 1, n // 2 + 1
    geo = np.zeros((H, H), np.float32)
    geo[1:-1, 1:-1] = 1.0
    u = rng.standard_normal((H, H)).astype(np.float32) * geo + np.float32(0.7) * (1 - geo)
    f = (rng.standard_normal((H, H)) * 1e-3).astype(np.float32)
    uc = rng.standard_normal((Hc, Hc)).astype(np.float32)
    up, fp, ucp = jl.pad(jnp.asarray(u)), jl.pad(jnp.asarray(f)), jc.pad(jnp.asarray(uc))
    tu, tf, tuc = map(torch.from_numpy, (u, f, uc))

    for name, want, got in (("sweep", jl.sweep(up, fp), tl.sweep(tu, tf)),
                            ("residual", jl.residual(up, fp), tl.residual(tu, tf)),
                            ("psweep", jl.psweep(up, fp, ucp, R_up=32), tl.psweep(tu, tf, tuc))):
        assert _rel_err(got[0], jl.unpad(want[0])) < TOL, name
        assert _rsq_err(got[1], want[1]) < TOL, name
    u1_w, fc_w, rsq_w = jl.sweep_restrict(up, fp)
    u1_g, fc_g, rsq_g = tl.sweep_restrict(tu, tf)
    assert _rel_err(u1_g, jl.unpad(u1_w)) < TOL and _rel_err(fc_g, jc.unpad(fc_w)) < TOL
    assert _rsq_err(rsq_g, rsq_w) < TOL
    assert _rel_err(tl.zsweep_restrict(tf), jc.unpad(jl.zsweep_restrict(fp))) < TOL
    assert _rel_err(tl.zpsweep(tf, tuc), jl.unpad(jl.zpsweep(fp, ucp, R_up=32))) < TOL
    fc_w, rsq_w = jl.restrict_residual(up, fp)
    fc_g, rsq_g = tl.restrict_residual(tu, tf)
    assert _rel_err(fc_g, jc.unpad(fc_w)) < TOL and _rsq_err(rsq_g, rsq_w) < TOL
    u4_w, fc_w, rsq_w = jl.pswrr(up, fp, ucp, R_up=32)
    u4_g, fc_g, rsq_g = tl.pswrr(tu, tf, tuc)
    assert _rel_err(u4_g, jl.unpad(u4_w)) < TOL and _rel_err(fc_g, jc.unpad(fc_w)) < TOL
    assert _rsq_err(rsq_g, rsq_w) < TOL


def test_mass_twins_match_the_system_table():
    """The mass-form apply equals the assembled theta-system stencil
    (an independent construction of the same operator): interior
    residuals agree."""
    from multigrid_feanet_torch.ops import sweep as sw
    from multigrid_feanet_torch.ops import stencil as tst

    n, dt, theta = 64, 1e-3, 0.5
    tp = Problem(n=n, inclusion=CIRCLE)
    lv = theat.heat_system_hierarchy(tp, dt, theta, num_levels=1, device="cpu").finest
    tl = SweepLevel(n, phase=lv.phase, coefficients=(theta * dt, 20 * theta * dt),
                    mass=theat.heat_mass(lv), device="cpu")
    rng = np.random.default_rng(5)
    u = torch.from_numpy(rng.standard_normal((n + 1, n + 1)).astype(np.float32))
    f = torch.from_numpy(rng.standard_normal((n + 1, n + 1)).astype(np.float32) * 1e-3)
    want = torch.where(sw._interior(u), f - tst.apply_stencil(lv.table, lv.pid, u), 0.0)
    assert _rel_err(tl.residual(u, f)[0], want) < TOL


def _solvers(n, inc, dt, theta, **kw):
    jp, tp = _problems(n, inc)
    js = jheat.HeatSolver(jp, dt, theta=theta, backend="pallas",
                          pallas_kw=dict(pallas_threshold=16, rows=32, interpret=True, **kw))
    ts = theat.HeatSolver(tp, dt, theta=theta, backend="fused",
                          kernel_kw=dict(kernel_threshold=16, **kw), device="cpu")
    return js, ts


def test_fused_step_matches_jax():
    """One backward-Euler step on the bi-material problem, fused backends
    (test_heatsolver_pallas_backend_step's band)."""
    n = 64
    js, ts = _solvers(n, "bim", 0.05, 1.0)
    assert ts.ph.K == js.ph.K
    rng = np.random.default_rng(7)
    u_n = np.zeros((n + 1, n + 1), np.float32)
    u_n[1:-1, 1:-1] = rng.standard_normal((n - 1, n - 1)).astype(np.float32)
    f = rng.standard_normal((n + 1, n + 1)).astype(np.float32)
    uj, hj = js.step(jnp.asarray(u_n), jnp.asarray(f), jnp.asarray(f), eps=1e-8)
    ut, ht = ts.step(u_n, f, f, eps=1e-8)
    assert abs(len(ht) - len(hj)) <= 1
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=2e-5)
    np.testing.assert_allclose(ht[0], np.asarray(hj)[0], rtol=1e-3)


def test_fused_march_matches_jax():
    """The fused march against JAX's Pallas march (test_march_pallas_matches_xla:
    4 steps, 2 cycles each, relax-only coarsest level), and the per-knot
    time-dependent march against the constant one."""
    n, steps = 64, 4
    js, ts = _solvers(n, "bim", 0.01, 1.0, direct_coarse=False)
    rng = np.random.default_rng(11)
    u0 = np.zeros((n + 1, n + 1), np.float32)
    u0[1:-1, 1:-1] = rng.standard_normal((n - 1, n - 1)).astype(np.float32)
    f = rng.standard_normal((n + 1, n + 1)).astype(np.float32)
    uj = js.march(jnp.asarray(u0), jnp.asarray(f), steps, cycles_per_step=2)
    ut = ts.march(u0, f, steps, cycles_per_step=2)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=5e-5)
    ftd = np.repeat(f[None], steps + 1, axis=0)
    np.testing.assert_allclose(ts.march(u0, ftd, steps, cycles_per_step=2).numpy(),
                               ut.numpy(), atol=1e-6)


RUN_N, RUN_DT, RUN_STEPS = 32, 0.002, 4


def _mode_and_source(n):
    x = np.linspace(-1, 1, n + 1)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    return ((np.cos(np.pi * xx / 2) * np.cos(np.pi * yy / 2)).astype(np.float32),
            (np.cos(np.pi * xx) * np.cos(np.pi * yy)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_run_and_march():
    """The JAX XLA backend's adaptive run and fixed-cycle march on
    test_march_matches_step_loop's problem (computed once)."""
    mode, f = _mode_and_source(RUN_N)
    js = jheat.HeatSolver(_problems(RUN_N, "hom")[0], RUN_DT, theta=0.5)
    run = js.run(jnp.asarray(mode), lambda t: jnp.asarray(f), 0.0, RUN_STEPS, eps=1e-9)
    march = js.march(jnp.asarray(mode), jnp.asarray(f), RUN_STEPS, cycles_per_step=4)
    return np.asarray(run), np.asarray(march)


@pytest.mark.parametrize("backend", theat.BACKENDS)
def test_run_and_march_match_jax(backend, jax_run_and_march):
    """Each backend's adaptive run and fixed-cycle march against the JAX
    XLA backend's (the fused one relax-only at its coarsest level, as the
    XLA march is)."""
    mode, f = _mode_and_source(RUN_N)
    kw = dict(kernel_kw=dict(kernel_threshold=16, direct_coarse=False)) if backend == "fused" else {}
    ts = theat.HeatSolver(_problems(RUN_N, "hom")[1], RUN_DT, theta=0.5, backend=backend,
                          device="cpu", **kw)
    uj, mj = jax_run_and_march
    ut = ts.run(mode, lambda t: f, 0.0, RUN_STEPS, eps=1e-9)
    np.testing.assert_allclose(ut.numpy(), uj, atol=2e-5)
    mt = ts.march(mode, f, RUN_STEPS, cycles_per_step=4)
    np.testing.assert_allclose(mt.numpy(), mj, atol=2e-5)
    np.testing.assert_allclose(mt.numpy(), ut.numpy(), atol=2e-5)
    with pytest.raises(ValueError, match="backend"):
        theat.HeatSolver(_problems(RUN_N, "hom")[1], RUN_DT, backend="pallas", device="cpu")
