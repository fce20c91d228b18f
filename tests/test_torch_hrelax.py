"""The port's H-relax step and fused H-MG legs
(multigrid_feanet_torch/ops/hrelax.py) against the JAX pallas_hrelax kernels
in interpret mode, and the model's h_relax against JAX's, on the CPU.

Here every leg runs its plain PyTorch version (the tensors lie on the CPU);
the CUDA kernels E1-E5 are held against those same plain versions on the
card by chip_smoke.py.  Inputs are made with numpy from a seed and handed to
both sides; the JAX buffers are padded into PallasLevel's ghost-block
stride-lane layout and unpadded for comparison, as tests/test_torch_sweep.py
does.  Tolerance: max|diff| <= 2e-5 * max(1, max|ref|) on fields and 2e-5
relative on rsq: f32 reassociation and FMA contraction differ by about one
ulp per term.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.core.problem import Problem as JProblem, build_level as j_build_level
from multigrid_feanet_tpu.models import hnet as jhnet
from multigrid_feanet_tpu.ops import pallas_hrelax as phx
from multigrid_feanet_tpu.ops.pallas_sweep import PallasLevel

from multigrid_feanet_torch.core.problem import build_level, Problem
from multigrid_feanet_torch.models import hnet
from multigrid_feanet_torch.ops import hrelax as hx
from multigrid_feanet_torch.ops.sweep import SweepLevel

TOL = 2e-5
R = 32  # PallasLevel row block
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


def _levels(n, stride, bim, L, seed=0):
    """A JAX PallasLevel (and its coarse layout twin) and the port's level,
    plus seeded inputs as numpy f32 and (L, 3, 3) kernels."""
    phase = JProblem(n=n, inclusion=CIRCLE).phase(n) if bim else None
    jl = PallasLevel(n, stride=stride, phase=phase, Wp=256, rows=R, rows_next=R,
                     interpret=True)
    jc = PallasLevel(n // 2, stride=2 * stride, phase=None, Wp=256, rows=R,
                     rows_next=R, interpret=True)
    tl = SweepLevel(n, phase=phase, device="cpu")
    rng = np.random.default_rng(seed)
    H, Hc = n + 1, n // 2 + 1
    geo = np.zeros((H, H), np.float32)
    geo[1:-1, 1:-1] = 1.0
    u = (rng.standard_normal((H, H)).astype(np.float32) * geo
         + np.float32(0.7) * (1 - geo))  # a nonzero Dirichlet ring
    f = rng.standard_normal((H, H)).astype(np.float32)
    uc = rng.standard_normal((Hc, Hc)).astype(np.float32)
    params = (0.1 * rng.standard_normal((L, 3, 3))).astype(np.float32)
    return jl, jc, tl, u, f, uc, params


# level 0 (stride 1) at n = 64 and 128, and a coarse level (stride 2)
LEVELS = [(64, 1), (128, 1), (64, 2)]
CASES = dict(
    argnames="n,stride,bim,L,dform",
    argvalues=[(n, s, bim, L, dform) for n, s in LEVELS for bim in (False, True)
               for L in (1, 3) for dform in (False, True)],
    ids=[f"n{n}{'_coarse' if s > 1 else ''}-{'bim' if bim else 'hom'}-L{L}-"
         f"{'dform' if dform else 'plain'}"
         for n, s in LEVELS for bim in (False, True) for L in (1, 3) for dform in (False, True)])


@pytest.mark.parametrize(**CASES)
def test_e2_e3_match_pallas(n, stride, bim, L, dform):
    """hrelax_plain (E1's math), E2 (hswrr: u1, f_c, rsq) and E3 (phrelax)."""
    jl, jc, tl, u, f, uc, params = _levels(n, stride, bim, L)
    up, fp, ucp = jl.pad(jnp.asarray(u)), jl.pad(jnp.asarray(f)), jc.pad(jnp.asarray(uc))
    jp = jnp.asarray(params)
    tu, tf, tuc, tp = map(torch.from_numpy, (u, f, uc, params))

    want, rsq_w = phx.hrelax(jl, up, fp, jp, dform=dform)
    got, rsq_g = hx.hrelax_plain(tu, tf, tl.ph, tp, a0=tl.a0, da=tl.da, omega=tl.omega,
                                 dform=dform)
    assert _rel_err(got, jl.unpad(want)) < TOL
    assert _rsq_err(rsq_g, rsq_w) < TOL
    np.testing.assert_array_equal(got.numpy()[0], u[0])  # boundary kept

    u1_w, fc_w, rsq_w = phx.hswrr(jl, up, fp, jp, dform=dform)
    u1_g, fc_g, rsq_g = hx.hswrr(tl, tu, tf, tp, dform=dform)
    assert _rel_err(u1_g, jl.unpad(u1_w)) < TOL
    assert _rel_err(fc_g, jc.unpad(fc_w)) < TOL
    assert _rsq_err(rsq_g, rsq_w) < TOL

    u3_w = phx.phrelax(jl, up, fp, ucp, jp, R_up=R, dform=dform)
    assert _rel_err(hx.phrelax(tl, tu, tf, tuc, tp, dform=dform), jl.unpad(u3_w)) < TOL


@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
def test_hrelax_plain_matches_h_relax(bim):
    """E1's element-factored math equals the model's h_relax on the
    assembled stencil (models/hnet.py), an independent construction."""
    n = 64
    _, _, tl, u, f, _, params = _levels(n, 1, bim, 3, seed=3)
    lv = build_level(Problem(n=n, inclusion=CIRCLE if bim else None), n, device="cpu")
    tu, tf, tp = map(torch.from_numpy, (u * np.asarray(lv.geo), f, params))
    got, _ = hx.hrelax_plain(tu, tf, tl.ph, tp, a0=tl.a0, da=tl.da, omega=tl.omega,
                             dform=False)
    assert _rel_err(got, hnet.h_relax(lv, tp, tu, tf, 1)) < TOL


def test_even_depth_raises_in_prolongation_legs():
    """The prolongation-fused legs need an odd chain depth, as the JAX
    wrappers assert."""
    _, _, tl, u, f, uc, params = _levels(16, 1, True, 2)
    tu, tf, tuc, tp = map(torch.from_numpy, (u, f, uc, params))
    with pytest.raises(ValueError, match="odd"):
        hx.phrelax(tl, tu, tf, tuc, tp)
    with pytest.raises(ValueError, match="odd"):
        hx.zphrelax(tl, tf, tuc, tp)
    with pytest.raises(ValueError, match="odd"):
        hx.phrelax_cuda(tu, tf, tl.ph, tuc, tp, a0=1.0, da=19.0, omega=2 / 3, dform=False)
    # the descent legs take any depth on the plain path
    hx.hswrr(tl, tu, tf, tp)
    hx.zhswrr(tl, tf, tp)


@pytest.mark.parametrize("L", [2, 5])
def test_unsupported_depth_raises(L):
    """The kernels are built for L = 1 and 3; any other depth raises in the
    wrappers, whatever device the tensors lie on."""
    _, _, tl, u, f, uc, params = _levels(16, 1, False, L)
    tu, tf, tuc, tp = map(torch.from_numpy, (u, f, uc, params))
    cfg = dict(a0=1.0, da=0.0, omega=2 / 3, dform=False)
    with pytest.raises(ValueError, match="chain depths"):
        hx.hswrr_cuda(tu, tf, None, tp, **cfg)
    with pytest.raises(ValueError, match="chain depths"):
        hx.zhswrr_cuda(tf, None, tp, **cfg)
    with pytest.raises(ValueError, match="odd" if L % 2 == 0 else "chain depths"):
        hx.zphrelax_cuda(tf, None, tuc, tp, **cfg)


def test_wrappers_check_operands():
    """Malformed kernels are refused; the kernel wrappers refuse CPU
    tensors before any build or launch."""
    _, _, tl, u, f, uc, _ = _levels(16, 1, False, 1)
    tu, tf, tuc = map(torch.from_numpy, (u, f, uc))
    cfg = dict(a0=1.0, da=0.0, omega=2 / 3, dform=False)
    with pytest.raises(ValueError, match=r"\(L, 3, 3\)"):
        hx.hswrr(tl, tu, tf, torch.zeros(3, 3))
    with pytest.raises(ValueError, match=r"\(L, 3, 3\)"):
        hx.zhswrr(tl, tf, torch.zeros(0, 3, 3))
    p1 = torch.zeros(1, 3, 3)
    with pytest.raises(ValueError, match="CUDA"):
        hx.hswrr_cuda(tu, tf, None, p1, **cfg)
    with pytest.raises(ValueError, match="CUDA"):
        hx.phrelax_cuda(tu, tf, None, tuc, p1, **cfg)
    with pytest.raises(ValueError, match="CUDA"):
        hx.zhswrr_cuda(tf, None, p1, **cfg)
    with pytest.raises(ValueError, match="CUDA"):
        hx.zphrelax_cuda(tf, None, tuc, p1, **cfg)


def test_plain_versions_fill_out_buffers():
    """``out``/``fc_out``/``rsq`` buffers are written in place and returned."""
    n = 32
    _, _, tl, u, f, uc, params = _levels(n, 1, True, 1)
    tu, tf, tuc, tp = map(torch.from_numpy, (u, f, uc, params))
    out, fc, rsq = torch.empty_like(tu), torch.empty(n // 2 + 1, n // 2 + 1), torch.empty(())
    res = hx.hswrr(tl, tu, tf, tp, out=out, fc_out=fc, rsq=rsq, dform=True)
    assert res[0] is out and res[1] is fc and res[2] is rsq
    for a, b in zip(res, hx.hswrr(tl, tu, tf, tp, dform=True)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert hx.phrelax(tl, tu, tf, tuc, tp, out=out) is out
    assert hx.zhswrr(tl, tf, tp, out=fc) is fc
    assert hx.zphrelax(tl, tf, tuc, tp, out=out) is out


@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("dform", [False, True], ids=["plain", "dform"])
def test_hrelax_matches_pallas_n32(bim, L, dform):
    """E1's plain version against the Pallas _hrelax_kernel at n = 32, on an
    iterate whose ring is not zero (bc=None keeps it, as the kernel does),
    to 1e-5 (the two differ by ~2e-7 here)."""
    jl, _, tl, u, f, _, params = _levels(32, 1, bim, L, seed=7)
    want, rsq_w = phx.hrelax(jl, jl.pad(jnp.asarray(u)), jl.pad(jnp.asarray(f)),
                             jnp.asarray(params), dform=dform)
    tu, tf, tp = map(torch.from_numpy, (u, f, params))
    got, rsq_g = hx.hrelax(tl, tu, tf, tp, dform=dform)
    assert _rel_err(got, jl.unpad(want)) < 1e-5
    assert _rsq_err(rsq_g, rsq_w) < 1e-5


H_CASES = [(n, bim, L) for n in (2, 32, 64) for bim in (False, True) for L in (1, 3)]


@pytest.mark.parametrize("n,bim,L", H_CASES,
                         ids=[f"n{n}-{'bim' if b else 'hom'}-L{L}" for n, b, L in H_CASES])
def test_h_relax_matches_jax(n, bim, L):
    """The model's h_relax (plain path) and E1's plain version with a
    boundary value, one sweep at a time, both give JAX's models/hnet.py
    h_relax to 1e-5: from u0 = 0 under a nonzero Dirichlet field (the
    learned-iterator protocol, where jac - u carries bc - u on the ring
    into the first conv) and from a random iterate, with a field and a
    scalar boundary value."""
    inc = CIRCLE if bim else None
    jl = j_build_level(JProblem(n=n, inclusion=inc), n)
    tl = build_level(Problem(n=n, inclusion=inc), n, device="cpu")
    rng = np.random.default_rng(11 + n)
    H = n + 1
    ring = np.ones((H, H), np.float32)
    ring[1:-1, 1:-1] = 0.0
    f = rng.standard_normal((H, H)).astype(np.float32)
    bcf = rng.standard_normal((H, H)).astype(np.float32) * ring
    params = (0.2 * rng.standard_normal((L, 3, 3))).astype(np.float32)
    tf, tp = torch.from_numpy(f), torch.from_numpy(params)
    cfg = dict(a0=1.0, da=19.0 if bim else 0.0, omega=2.0 / 3.0, dform=False)
    for u0 in (np.zeros((H, H), np.float32), rng.standard_normal((H, H)).astype(np.float32)):
        for bc in (bcf, 0.7):
            want = np.asarray(jhnet.h_relax(jl, jnp.asarray(params), jnp.asarray(u0),
                                            jnp.asarray(f), 3, jnp.asarray(bc)))
            tbc = torch.from_numpy(bc) if isinstance(bc, np.ndarray) else bc
            got = hnet.h_relax(tl, tp, torch.from_numpy(u0), tf, 3, tbc)
            scale = max(1.0, float(np.abs(want).max()))
            assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale
            e = torch.from_numpy(u0)
            for _ in range(3):
                e, _ = hx.hrelax_plain(e, tf, tl.phase, tp, bc=tbc, **cfg)
            assert float(np.abs(e.numpy() - want).max()) <= 1e-5 * scale
            np.testing.assert_array_equal(e.numpy()[0], np.broadcast_to(np.float32(bc), (H, H))[0])


def test_e1_wrapper_refuses_cpu_tensors_and_bad_bc():
    """hrelax_cuda refuses CPU tensors before any build or launch; a
    boundary field must be an (n+1)^2 float32 tensor."""
    _, _, tl, u, f, _, params = _levels(16, 1, True, 1)
    tu, tf, tp = map(torch.from_numpy, (u, f, params))
    cfg = dict(a0=1.0, da=19.0, omega=2 / 3, dform=False)
    with pytest.raises(ValueError, match="CUDA"):
        hx.hrelax_cuda(tu, tf, tl.ph, tp, **cfg)
    with pytest.raises(ValueError, match="chain depths"):
        hx.hrelax_cuda(tu, tf, tl.ph, torch.zeros(2, 3, 3), **cfg)
    with pytest.raises(ValueError, match="bc"):
        hx._bc_operand(torch.zeros(5, 5), 16, torch.device("cpu"))
    assert hx._bc_operand(None, 16, None) == (None, 0.0, 0)
    assert hx._bc_operand(0.5, 16, None) == (None, 0.5, 1)
