"""The port's fused V-cycle legs (multigrid_feanet_torch/ops/sweep.py) against
the JAX PallasLevel kernels in interpret mode, on the CPU.

Here every SweepLevel method runs its plain PyTorch version (the tensors lie
on the CPU); the CUDA kernels are held against those same plain versions on
the card by chip_smoke.py.  Inputs are made with numpy from a seed and
handed to both sides; the JAX buffers are padded into PallasLevel's
ghost-block stride-lane layout and unpadded for comparison, as
tests/test_pallas_sweep.py does.  Tolerance: max|diff| <= 2e-5 * max(1,
max|ref|) on fields and 2e-5 relative on rsq, f32 reassociation and FMA
contraction differing by about one ulp per term.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.core.problem import Problem as JProblem
from multigrid_feanet_tpu.ops.pallas_sweep import PallasLevel

from multigrid_feanet_torch.ops import stencil as tst
from multigrid_feanet_torch.ops import sweep as sw
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


def _levels(n, stride, bim, dform, seed=0):
    """A JAX PallasLevel (and its coarse layout twin) and the port's level,
    plus seeded inputs as numpy f32."""
    phase = JProblem(n=n, inclusion=CIRCLE).phase(n) if bim else None
    jl = PallasLevel(n, stride=stride, phase=phase, Wp=256, rows=R, rows_next=R,
                     interpret=True, dform=dform)
    jc = PallasLevel(n // 2, stride=2 * stride, phase=None, Wp=256, rows=R,
                     rows_next=R, interpret=True)
    tl = SweepLevel(n, phase=phase, dform=dform, device="cpu")
    rng = np.random.default_rng(seed)
    H, Hc = n + 1, n // 2 + 1
    geo = np.zeros((H, H), np.float32)
    geo[1:-1, 1:-1] = 1.0
    u = (rng.standard_normal((H, H)).astype(np.float32) * geo
         + np.float32(0.7) * (1 - geo))  # a nonzero Dirichlet ring
    f = rng.standard_normal((H, H)).astype(np.float32)
    uc = rng.standard_normal((Hc, Hc)).astype(np.float32)
    return jl, jc, tl, u, f, uc


# level 0 (stride 1) at n = 64 and 128, and a coarse level (stride 2)
LEVELS = [(64, 1), (128, 1), (64, 2)]


@pytest.mark.parametrize("dform", [False, True], ids=["plain", "dform"])
@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
@pytest.mark.parametrize("n,stride", LEVELS, ids=["n64", "n128", "n64_coarse"])
def test_a1_a2_match_pallas(n, stride, bim, dform):
    """A1 in all modes (sweep, residual, psweep) and A2 (sweep_restrict)."""
    jl, jc, tl, u, f, uc = _levels(n, stride, bim, dform)
    up, fp, ucp = jl.pad(jnp.asarray(u)), jl.pad(jnp.asarray(f)), jc.pad(jnp.asarray(uc))
    tu, tf, tuc = map(torch.from_numpy, (u, f, uc))

    want, rsq_w = jl.sweep(up, fp)
    got, rsq_g = tl.sweep(tu, tf)
    assert _rel_err(got, jl.unpad(want)) < TOL
    assert _rsq_err(rsq_g, rsq_w) < TOL
    np.testing.assert_array_equal(got.numpy()[0], u[0])  # boundary kept

    want, rsq_w = jl.residual(up, fp)
    got, rsq_g = tl.residual(tu, tf)
    assert _rel_err(got, jl.unpad(want)) < TOL
    assert _rsq_err(rsq_g, rsq_w) < TOL

    want, rsq_w = jl.psweep(up, fp, ucp, R_up=R)
    got, rsq_g = tl.psweep(tu, tf, tuc)
    assert _rel_err(got, jl.unpad(want)) < TOL
    assert _rsq_err(rsq_g, rsq_w) < TOL

    u1_w, fc_w, rsq_w = jl.sweep_restrict(up, fp)
    u1_g, fc_g, rsq_g = tl.sweep_restrict(tu, tf)
    assert _rel_err(u1_g, jl.unpad(u1_w)) < TOL
    assert _rel_err(fc_g, jc.unpad(fc_w)) < TOL
    assert _rsq_err(rsq_g, rsq_w) < TOL


@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
@pytest.mark.parametrize("n,stride", LEVELS, ids=["n64", "n128", "n64_coarse"])
def test_a3_a4_match_pallas(n, stride, bim):
    """A3 (zsweep_restrict) and A4 (zpsweep): plain form on both sides
    whatever the level's dform."""
    jl, jc, tl, u, f, uc = _levels(n, stride, bim, dform=True, seed=1)
    fp, ucp = jl.pad(jnp.asarray(f)), jc.pad(jnp.asarray(uc))
    tf, tuc = torch.from_numpy(f), torch.from_numpy(uc)
    assert _rel_err(tl.zsweep_restrict(tf), jc.unpad(jl.zsweep_restrict(fp))) < TOL
    assert _rel_err(tl.zpsweep(tf, tuc), jl.unpad(jl.zpsweep(fp, ucp, R_up=R))) < TOL


@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
def test_zero_guess_legs_equal_their_compositions(bim):
    """zsweep_restrict == sweep(0) then restriction of the residual;
    zpsweep == sweep(0) then psweep, with the plain form."""
    n = 64
    _, _, tl, _, f, uc = _levels(n, 1, bim, dform=False, seed=2)
    tf, tuc = torch.from_numpy(f), torch.from_numpy(uc)
    u1, _ = tl.sweep(torch.zeros_like(tf), tf)
    _, fc, _ = tl.sweep_restrict(torch.zeros_like(tf), tf)
    assert _rel_err(tl.zsweep_restrict(tf), fc) < 1e-6
    u3, _ = tl.psweep(u1, tf, tuc)
    assert _rel_err(tl.zpsweep(tf, tuc), u3) < 1e-6


def test_difference_form_annihilates_constants():
    """r = f - A c is exactly f at the interior for a constant field under
    the difference form (the property behind its stability at 4097^2)."""
    n = 64
    phase = JProblem(n=n, inclusion=CIRCLE).phase(n)
    f = torch.from_numpy(np.random.default_rng(3).standard_normal((n + 1, n + 1)).astype(np.float32))
    c = torch.full((n + 1, n + 1), 150000.0)
    r, _ = SweepLevel(n, phase=phase, dform=True, device="cpu").residual(c, f)
    np.testing.assert_array_equal(r.numpy()[1:-1, 1:-1], f.numpy()[1:-1, 1:-1])


@pytest.mark.parametrize("dform", [False, True], ids=["plain", "dform"])
@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
def test_twins_match_assembled_stencil(bim, dform):
    """Each form of the element-factored apply equals the 16-pattern stencil
    assembled from the element matrix (ops/stencil.py), an independent
    construction of the same operator: interior residuals agree."""
    n = 64
    phase = JProblem(n=n, inclusion=CIRCLE).phase(n) if bim else np.zeros((n, n), np.int8)
    rng = np.random.default_rng(5)
    u = torch.from_numpy(rng.standard_normal((n + 1, n + 1)).astype(np.float32))
    f = torch.from_numpy(rng.standard_normal((n + 1, n + 1)).astype(np.float32))
    pid = torch.from_numpy(tst.pattern_ids_np(phase))
    au = tst.apply_stencil_bitplane(pid, u, 1.0, 20.0 if bim else 1.0)
    want = torch.where(sw._interior(u), f - au, 0.0)
    got, _ = SweepLevel(n, phase=phase if bim else None, dform=dform,
                        device="cpu").residual(u, f)
    assert _rel_err(got, want) < TOL


def test_dform_with_mass_is_refused():
    """The reference's _apply_op silently drops ``mass`` when dform=True
    (pallas_sweep.py:225); the port refuses the pair."""
    mass = (1e-4, 1e-4, -5e-5)
    with pytest.raises(ValueError, match="mass"):
        SweepLevel(16, mass=mass, dform=True, device="cpu")
    with pytest.raises(NotImplementedError, match="mass"):
        SweepLevel(16, mass=mass, device="cpu")


def test_plain_versions_fill_out_buffers():
    """``out``/``rsq`` buffers are written in place and returned."""
    n = 32
    _, _, tl, u, f, uc = _levels(n, 1, True, True)
    tu, tf, tuc = map(torch.from_numpy, (u, f, uc))
    out, fc, rsq = torch.empty_like(tu), torch.empty(n // 2 + 1, n // 2 + 1), torch.empty(())
    res = tl.sweep_restrict(tu, tf, out=out, fc_out=fc, rsq=rsq)
    assert res[0] is out and res[1] is fc and res[2] is rsq
    ref = tl.sweep_restrict(tu, tf)
    for a, b in zip(res, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert tl.zpsweep(tf, tuc, out=out) is out


def test_cuda_wrappers_check_operands():
    """The kernel wrappers refuse what the kernels do not take, before any
    build or launch."""
    u = torch.zeros(17, 17)
    cfg = dict(a0=1.0, da=19.0, omega=2 / 3)
    with pytest.raises(ValueError, match="CUDA"):
        sw.swrr_cuda(u, u, None, dform=True, **cfg)
    with pytest.raises(ValueError, match="CUDA"):
        sw.zrr_cuda(u, None, **cfg)
    with pytest.raises(ValueError, match="CUDA"):
        sw.zpsweep_cuda(u, None, torch.zeros(9, 9), **cfg)
    with pytest.raises(ValueError, match="mode"):
        sw.sweep_plain(u, u, None, torch.zeros(9, 9), dform=True, mode="residual", **cfg)
