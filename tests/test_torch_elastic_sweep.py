"""The port's fused elastic V-cycle legs (multigrid_feanet_torch/ops/elastic.py)
against the JAX PallasElasticLevel kernels in interpret mode, on the CPU.

Here every ElasticSweepLevel method runs its plain PyTorch version (the
tensors lie on the CPU); the CUDA kernels G1-G5 are held against those same
plain versions on the card by chip_smoke.py.  Inputs are made with numpy
from a seed and handed to both sides; the JAX buffers are padded into
PallasElasticLevel's ghost-block stride-lane layout and unpadded for
comparison, coarse buffers with a PallasElasticLevel of the next level.
Tolerance: max|diff| <= 2e-5 * max(1, max|ref|) on fields and 2e-5 relative
on rsq, f32 reassociation and FMA contraction differing by about one ulp
per term.
"""

from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.ops.pallas_elastic import PallasElasticLevel

from multigrid_feanet_torch.ops import elastic as eg
from multigrid_feanet_torch.ops.elastic import ElasticSweepLevel
from multigrid_feanet_torch.ops.elasticity import apply_elastic_factored

TOL = 2e-5
R = 32  # PallasElasticLevel row block
E, NU = 212e3, 0.288  # Plane_Stress_modify.m:11-12
COEF = (1.0, 20.0)


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


def _levels(n, stride, bim, plane="stress", seed=0):
    """A JAX PallasElasticLevel, its next level's layout twin, the port's
    level, and seeded f32 inputs: u with a nonzero Dirichlet ring and two
    different components, f, a coarse correction; a random asymmetric phase
    map when ``bim``."""
    rng = np.random.default_rng(seed)
    phase = (rng.random((n, n)) < 0.4).astype(np.int8) if bim else None
    jl = PallasElasticLevel(n, E, NU, stride=stride, phase=phase, coefficients=COEF,
                            plane=plane, Wp=256, rows=R, rows_next=R, interpret=True)
    jc = PallasElasticLevel(n // 2, E, NU, stride=2 * stride, coefficients=COEF, plane=plane,
                            Wp=256, rows=R, rows_next=R, interpret=True)
    tl = ElasticSweepLevel(n, E, NU, phase=phase, coefficients=COEF, plane=plane, device="cpu")
    H, Hc = n + 1, n // 2 + 1
    geo = np.zeros((H, H), np.float32)
    geo[1:-1, 1:-1] = 1.0
    u = rng.standard_normal((2, H, H)).astype(np.float32) * geo
    u[0] += np.float32(0.7) * (1 - geo)
    u[1] -= np.float32(0.3) * (1 - geo)
    f = rng.standard_normal((2, H, H)).astype(np.float32)
    uc = rng.standard_normal((2, Hc, Hc)).astype(np.float32)
    return jl, jc, tl, u, f, uc


# a level-0 layout (stride 1) and a coarse-level layout (stride 2) at two n
LEVELS = [(32, 1), (64, 1), (32, 2), (64, 2)]
LEVEL_IDS = ["n32", "n64", "n32_coarse", "n64_coarse"]


@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
@pytest.mark.parametrize("n,stride", LEVELS, ids=LEVEL_IDS)
def test_g1_g2_g3_match_pallas(n, stride, bim):
    """G1 (sweep and residual), G2 (sweep_restrict) and G3 (psweep)."""
    jl, jc, tl, u, f, uc = _levels(n, stride, bim)
    ub, fb, ucb = jl.pad(jnp.asarray(u)), jl.pad(jnp.asarray(f)), jc.pad(jnp.asarray(uc))
    tu, tf, tuc = map(torch.from_numpy, (u, f, uc))

    want, rsq_w = jl.sweep(*ub, *fb)
    got, rsq_g = tl.sweep(tu, tf)
    assert _rel_err(got, jl.unpad(*want)) < TOL
    assert _rsq_err(rsq_g, rsq_w) < TOL
    np.testing.assert_array_equal(got.numpy()[:, 0], u[:, 0])  # boundary kept

    want, rsq_w = jl.residual(*ub, *fb)
    got, rsq_g = tl.residual(tu, tf)
    assert _rel_err(got, jl.unpad(*want)) < TOL
    assert _rsq_err(rsq_g, rsq_w) < TOL

    ux1, uy1, fcx, fcy, rsq_w = jl.sweep_restrict(*ub, *fb)
    u1_g, fc_g, rsq_g = tl.sweep_restrict(tu, tf)
    assert _rel_err(u1_g, jl.unpad(ux1, uy1)) < TOL
    assert _rel_err(fc_g, jc.unpad(fcx, fcy)) < TOL
    assert _rsq_err(rsq_g, rsq_w) < TOL

    want = jl.psweep(*ub, *fb, *ucb, R_up=R)
    assert _rel_err(tl.psweep(tu, tf, tuc), jl.unpad(*want)) < TOL


@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
@pytest.mark.parametrize("n,stride", LEVELS, ids=LEVEL_IDS)
def test_g4_g5_match_pallas(n, stride, bim):
    """G4 (zsweep_restrict) and G5 (zpsweep)."""
    jl, jc, tl, _, f, uc = _levels(n, stride, bim, seed=1)
    fb, ucb = jl.pad(jnp.asarray(f)), jc.pad(jnp.asarray(uc))
    tf, tuc = torch.from_numpy(f), torch.from_numpy(uc)
    assert _rel_err(tl.zsweep_restrict(tf), jc.unpad(*jl.zsweep_restrict(*fb))) < TOL
    assert _rel_err(tl.zpsweep(tf, tuc), jl.unpad(*jl.zpsweep(*fb, *ucb, R_up=R))) < TOL


def test_plane_strain_legs_match_pallas():
    """The plane-strain constants through G1 and G2."""
    jl, jc, tl, u, f, _ = _levels(32, 1, True, plane="strain", seed=2)
    ub, fb = jl.pad(jnp.asarray(u)), jl.pad(jnp.asarray(f))
    tu, tf = torch.from_numpy(u), torch.from_numpy(f)
    want, rsq_w = jl.sweep(*ub, *fb)
    got, rsq_g = tl.sweep(tu, tf)
    assert _rel_err(got, jl.unpad(*want)) < TOL and _rsq_err(rsq_g, rsq_w) < TOL
    ux1, uy1, fcx, fcy, _ = jl.sweep_restrict(*ub, *fb)
    u1_g, fc_g, _ = tl.sweep_restrict(tu, tf)
    assert _rel_err(u1_g, jl.unpad(ux1, uy1)) < TOL
    assert _rel_err(fc_g, jc.unpad(fcx, fcy)) < TOL


@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
def test_residual_is_the_factored_operator_in_f64(bim):
    """G1's plain residual in f64 equals f - A u of the whole-field
    factored apply at interior nodes, zero on the boundary."""
    n = 32
    rng = np.random.default_rng(3)
    phase = (rng.random((n, n)) < 0.4).astype(np.int8) if bim else None
    u = torch.from_numpy(rng.standard_normal((2, n + 1, n + 1)))
    f = torch.from_numpy(rng.standard_normal((2, n + 1, n + 1)))
    tl = ElasticSweepLevel(n, E, NU, phase=phase, coefficients=COEF, device="cpu")
    ph = None if phase is None else torch.from_numpy(phase)
    r, rsq = eg.el_sweep_plain(u, f, ph, a0=tl.a0, da=tl.da, omega=tl.omega,
                               consts=tl.consts, mode="residual")
    want = f - apply_elastic_factored(phase, u, E, NU, *COEF)
    want[:, 0], want[:, -1], want[:, :, 0], want[:, :, -1] = 0.0, 0.0, 0.0, 0.0
    assert float((r - want).abs().max()) <= 1e-12 * float(want.abs().max())
    assert abs(float(rsq) - float((want * want).sum())) <= 1e-12 * float(rsq)


@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
def test_zero_guess_legs_equal_their_compositions(bim):
    """zsweep_restrict == sweep(0) then restriction of the residual;
    zpsweep == sweep(0) then psweep."""
    _, _, tl, _, f, uc = _levels(32, 1, bim, seed=4)
    tf, tuc = torch.from_numpy(f), torch.from_numpy(uc)
    u1, _ = tl.sweep(torch.zeros_like(tf), tf)
    _, fc, _ = tl.sweep_restrict(torch.zeros_like(tf), tf)
    assert _rel_err(tl.zsweep_restrict(tf), fc) < 1e-6
    assert _rel_err(tl.zpsweep(tf, tuc), tl.psweep(u1, tf, tuc)) < 1e-6


def test_plain_versions_fill_out_buffers():
    """``out``/``fc_out``/``rsq`` buffers are written in place and returned."""
    n = 32
    _, _, tl, u, f, uc = _levels(n, 1, True)
    tu, tf, tuc = map(torch.from_numpy, (u, f, uc))
    out, fc, rsq = torch.empty_like(tu), torch.empty(2, n // 2 + 1, n // 2 + 1), torch.empty(())
    res = tl.sweep_restrict(tu, tf, out=out, fc_out=fc, rsq=rsq)
    assert res[0] is out and res[1] is fc and res[2] is rsq
    for a, b in zip(res, tl.sweep_restrict(tu, tf)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert tl.zpsweep(tf, tuc, out=out) is out
    assert tl.psweep(tu, tf, tuc, out=out) is out
    assert tl.zsweep_restrict(tf, out=fc) is fc


def test_cuda_wrappers_check_operands(monkeypatch):
    """The kernel wrappers refuse what the kernels do not take, before any
    build or launch."""
    tl = ElasticSweepLevel(16, E, NU, device="cpu")
    cfg = dict(a0=tl.a0, da=tl.da, omega=tl.omega, consts=tl.consts)
    u, uc = torch.zeros(2, 17, 17), torch.zeros(2, 9, 9)
    with pytest.raises(ValueError, match="CUDA"):
        eg.el_sweep_cuda(u, u, None, **cfg)
    with pytest.raises(ValueError, match="CUDA"):
        eg.el_swrr_cuda(u, u, None, **cfg)
    with pytest.raises(ValueError, match="CUDA"):
        eg.el_psweep_cuda(u, u, None, uc, **cfg)
    with pytest.raises(ValueError, match="CUDA"):
        eg.el_zrr_cuda(u, None, **cfg)
    with pytest.raises(ValueError, match="CUDA"):
        eg.el_zpsweep_cuda(u, None, uc, **cfg)
    with pytest.raises(ValueError, match="mode"):
        eg.el_sweep_plain(u, u, None, mode="psweep", **cfg)
    # G1 and G5 stage u, f, the phase and uc in 16-byte chunks counted from
    # the fields' base pointers: views that start 4 bytes past a boundary
    # are refused before any launch (the device check set aside)
    monkeypatch.setattr(eg, "_operands", lambda *args, **kw: None)
    off = torch.zeros(2 * 17 * 17 + 1)[1:].view(2, 17, 17)
    off_c = torch.zeros(2 * 9 * 9 + 1)[1:].view(2, 9, 9)
    ph = torch.zeros(16, 16, dtype=torch.int8)
    off_ph = torch.zeros(16 * 16 + 1, dtype=torch.int8)[1:].view(16, 16)
    for name, call in (("u", lambda: eg.el_sweep_cuda(off, u, ph, **cfg)),
                       ("f", lambda: eg.el_sweep_cuda(u, off, ph, mode="residual", **cfg)),
                       ("phase", lambda: eg.el_sweep_cuda(u, u, off_ph, **cfg)),
                       ("f", lambda: eg.el_zpsweep_cuda(off, ph, uc, **cfg)),
                       ("phase", lambda: eg.el_zpsweep_cuda(u, off_ph, uc, **cfg)),
                       ("uc", lambda: eg.el_zpsweep_cuda(u, None, off_c, **cfg))):
        with pytest.raises(ValueError, match=f"^{name} must start on a 16-byte boundary"):
            call()


def test_kernel_table():
    """Each kernel names its source and the line that defines the Pallas
    kernel it replaces."""
    root = Path(__file__).resolve().parent.parent
    names = {"G1": "_el_sweep_kernel", "G2": "_el_swrr_kernel", "G3": "_el_psweep_kernel",
             "G4": "_el_zrr_kernel", "G5": "_el_zpsweep_kernel"}
    assert sorted(eg.KERNELS) == sorted(names)
    for key, k in eg.KERNELS.items():
        assert (root / k.source).is_file()
        path, line = k.replaces.split(":")
        src = (root / path).read_text().splitlines()
        assert src[int(line) - 1].startswith(f"def {names[key]}(")
