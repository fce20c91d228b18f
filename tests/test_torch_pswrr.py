"""The rest of the V2 level against the JAX package in interpret mode, on
the CPU: A5 (``SweepLevel.restrict_residual``) and A6 (``SweepLevel.pswrr``)
against ``PallasLevel``, and ``HierarchyV2.solve`` with ``use_pswrr``
against ``PallasHierarchyV2`` and the split path.

Kernels: 2e-5 relative, as tests/test_torch_sweep.py.  Solves: the bands of
tests/test_torch_mg2.py (cycle counts +-1, first residual to 1e-4, history
ratios within [0.8, 1.25], u to 1e-3 of its scale).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.core.problem import Problem as JProblem
from multigrid_feanet_tpu.ops.pallas_sweep import PallasLevel

from multigrid_feanet_torch.core.problem import Problem
from multigrid_feanet_torch.ops import sweep as sw
from multigrid_feanet_torch.ops.sweep import SweepLevel
from multigrid_feanet_torch.solvers.mg2 import HierarchyV2

from test_torch_mg2 import _assert_same_solve, _pair

TOL = 2e-5
CIRCLE = ("circle", (0.0, 0.0), 0.5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel_err(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want))))


def _rsq_err(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


@pytest.mark.parametrize("dform", [False, True], ids=["plain", "dform"])
@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
@pytest.mark.parametrize("n,stride", [(64, 1), (64, 2)], ids=["n64", "n64_coarse"])
def test_a5_a6_match_pallas(n, stride, bim, dform):
    """A5 (restrict_residual) and A6 (pswrr) on seeded inputs with a
    nonzero Dirichlet ring, against the Pallas kernels."""
    phase = JProblem(n=n, inclusion=CIRCLE).phase(n) if bim else None
    jl = PallasLevel(n, stride=stride, phase=phase, Wp=256, rows=32, rows_next=32,
                     interpret=True, dform=dform)
    jc = PallasLevel(n // 2, stride=2 * stride, phase=None, Wp=256, rows=32, rows_next=32,
                     interpret=True)
    tl = SweepLevel(n, phase=phase, dform=dform, device="cpu")
    rng = np.random.default_rng(11)
    H = n + 1
    geo = np.zeros((H, H), np.float32)
    geo[1:-1, 1:-1] = 1.0
    u = rng.standard_normal((H, H)).astype(np.float32) * geo + np.float32(0.7) * (1 - geo)
    f = rng.standard_normal((H, H)).astype(np.float32)
    uc = rng.standard_normal((n // 2 + 1, n // 2 + 1)).astype(np.float32)
    up, fp, ucp = jl.pad(jnp.asarray(u)), jl.pad(jnp.asarray(f)), jc.pad(jnp.asarray(uc))
    tu, tf, tuc = map(torch.from_numpy, (u, f, uc))

    fc_w, rsq_w = jl.restrict_residual(up, fp)
    fc_g, rsq_g = tl.restrict_residual(tu, tf)
    assert _rel_err(fc_g, jc.unpad(fc_w)) < TOL
    assert _rsq_err(rsq_g, rsq_w) < TOL

    u4_w, fc_w, rsq_w = jl.pswrr(up, fp, ucp, R_up=32)
    u4_g, fc_g, rsq_g = tl.pswrr(tu, tf, tuc)
    assert _rel_err(u4_g, jl.unpad(u4_w)) < TOL
    assert _rel_err(fc_g, jc.unpad(fc_w)) < TOL
    assert _rsq_err(rsq_g, rsq_w) < TOL
    np.testing.assert_array_equal(u4_g.numpy()[0], u[0])  # boundary kept


@pytest.mark.parametrize("n", [sw.A6_ONE_PASS_MAX_N, sw.A6_ONE_PASS_MAX_N + 2],
                         ids=["one_pass_side", "streaming_side"])
def test_a6_matches_pallas_across_the_threshold(n):
    """A6 (pswrr) in the interface solve's form (bi-material, difference
    form) against the Pallas kernel at the largest level the wrapper runs on
    one-pass tiles and the smallest it streams (``A6_ONE_PASS_MAX_N``)."""
    phase = JProblem(n=n, inclusion=CIRCLE).phase(n)
    jl = PallasLevel(n, stride=1, phase=phase, rows=32, rows_next=32, interpret=True,
                     dform=True)
    jc = PallasLevel(n // 2, stride=2, phase=None, Wp=jl.Wp, rows=32, rows_next=32,
                     interpret=True)
    tl = SweepLevel(n, phase=phase, dform=True, device="cpu")
    rng = np.random.default_rng(n)
    H = n + 1
    geo = np.zeros((H, H), np.float32)
    geo[1:-1, 1:-1] = 1.0
    u = rng.standard_normal((H, H)).astype(np.float32) * geo + np.float32(0.7) * (1 - geo)
    f = rng.standard_normal((H, H)).astype(np.float32)
    uc = rng.standard_normal((n // 2 + 1, n // 2 + 1)).astype(np.float32)
    u4_w, fc_w, rsq_w = jl.pswrr(jl.pad(jnp.asarray(u)), jl.pad(jnp.asarray(f)),
                                 jc.pad(jnp.asarray(uc)), R_up=32)
    u4_g, fc_g, rsq_g = tl.pswrr(*map(torch.from_numpy, (u, f, uc)))
    assert _rel_err(u4_g, jl.unpad(u4_w)) < TOL
    assert _rel_err(fc_g, jc.unpad(fc_w)) < TOL
    assert _rsq_err(rsq_g, rsq_w) < TOL


@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
def test_a5_a6_equal_their_compositions(bim):
    """restrict_residual == sweep_restrict without the sweep; pswrr ==
    psweep then sweep_restrict, with the middle iterate's rsq."""
    n = 64
    phase = JProblem(n=n, inclusion=CIRCLE).phase(n) if bim else None
    tl = SweepLevel(n, phase=phase, device="cpu")
    rng = np.random.default_rng(12)
    u, f = (torch.from_numpy(rng.standard_normal((n + 1, n + 1)).astype(np.float32))
            for _ in range(2))
    uc = torch.from_numpy(rng.standard_normal((n // 2 + 1, n // 2 + 1)).astype(np.float32))
    r, rsq = tl.residual(u, f)
    fc, rsq5 = tl.restrict_residual(u, f)
    assert float(rsq5) == float(rsq)
    np.testing.assert_array_equal(fc.numpy(), sw._restrict4(r).numpy())
    u1, fc_fused, _ = tl.sweep_restrict(u, f)
    np.testing.assert_array_equal(tl.restrict_residual(u1, f)[0].numpy(), fc_fused.numpy())
    u3, _ = tl.psweep(u, f, uc)
    u4, fc4, rsq3 = tl.sweep_restrict(u3, f)
    got = tl.pswrr(u, f, uc)
    np.testing.assert_array_equal(got[0].numpy(), u4.numpy())
    np.testing.assert_array_equal(got[1].numpy(), fc4.numpy())
    assert float(got[2]) == float(rsq3)


@pytest.mark.parametrize("case", ["bim_rhs", "hom_decay"])
def test_pswrr_solve_matches_pallas_and_split_path(case):
    """use_pswrr: the JAX pswrr solve within the bands, and the port's
    split path with the same history to 1e-4 (tests/test_solve_semantics.py
    holds the two JAX paths together)."""
    n = 64
    inclusion = CIRCLE if case == "bim_rhs" else None
    jh, th = _pair(n, inclusion, 4, True)
    rng = np.random.default_rng(0)
    if case == "hom_decay":
        f = np.zeros((n + 1, n + 1), np.float32)
        kw = dict(u0=(150000.0 * rng.uniform(size=(n + 1, n + 1))).astype(np.float32),
                  eps=1e-5, max_cycles=60, chunk=2)
    else:
        f = rng.standard_normal((n + 1, n + 1)).astype(np.float32)
        kw = dict(eps=1e-3, max_cycles=40)
    jkw = {k: jnp.asarray(v) if k == "u0" else v for k, v in kw.items()}
    jres = jh.solve(jnp.asarray(f), use_pswrr=True, **jkw)
    tres = th.solve(f, use_pswrr=True, **kw)
    _assert_same_solve(jres, tres, kw["max_cycles"])
    _, h_split = th.solve(f, **kw)
    assert len(h_split) == len(tres[1])
    np.testing.assert_allclose(tres[1], h_split, rtol=1e-4)


def test_pswrr_history_convention():
    """At eps = 0 the pswrr solve records max_cycles - 1 cycles, as the
    split path; chunk is rounded up to even and changes nothing else."""
    n = 32
    th = HierarchyV2(Problem(n=n, inclusion=CIRCLE), num_levels=3, kernel_threshold=16,
                     device="cpu")
    f = np.random.default_rng(5).standard_normal((n + 1, n + 1)).astype(np.float32)
    _, h = th.solve(f, eps=0.0, max_cycles=7, use_pswrr=True)
    _, h_split = th.solve(f, eps=0.0, max_cycles=7)
    assert len(h) == len(h_split) == 6
    np.testing.assert_allclose(h, h_split, rtol=1e-4)
    _, h1 = th.solve(f, eps=1e-3, max_cycles=40, use_pswrr=True, chunk=1)
    _, h3 = th.solve(f, eps=1e-3, max_cycles=40, use_pswrr=True, chunk=3)
    np.testing.assert_array_equal(h1, h3)
    # other schedules ignore use_pswrr, as the JAX solver does
    _, h21 = th.solve(f, nu1=2, nu2=1, eps=1e-3, max_cycles=40, use_pswrr=True)
    _, h21s = th.solve(f, nu1=2, nu2=1, eps=1e-3, max_cycles=40)
    np.testing.assert_array_equal(h21, h21s)
