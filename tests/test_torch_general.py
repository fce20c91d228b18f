"""The port's general-stencil legs (multigrid_feanet_torch/ops/general.py)
against the JAX GeneralPallasLevel kernels in interpret mode, on the CPU.

Here every GeneralSweepLevel method runs its plain PyTorch version (the
tensors lie on the CPU); the CUDA kernels D1-D5 are held against those same
plain versions on the card by chip_smoke.py.  The operator and the W4
transfers come from the JAX boxmg_setup at n = 64 and are carried across
with boxmg_setup_from_arrays; inputs are made with numpy from a seed.  The
JAX buffers are padded into GeneralPallasLevel's ghost-block stride-lane
layout and unpadded for comparison, as tests/test_pallas_general.py does.
Tolerance, as there: fields within 1e-4 * max(1, max|ref|) and rsq within
1e-5 relative, for the f32 reassociation of the 9-term sums.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.core.problem import GridHierarchy as JHierarchy
from multigrid_feanet_tpu.core.problem import Problem as JProblem
from multigrid_feanet_tpu.ops import boxmg as jboxmg
from multigrid_feanet_tpu.ops.pallas_general import GeneralPallasLevel

from multigrid_feanet_torch.core.convert import boxmg_setup_from_arrays
from multigrid_feanet_torch.ops import general as gen
from multigrid_feanet_torch.ops.general import GeneralSweepLevel
from multigrid_feanet_torch.ops.sweep import SweepLevel

N = 64
ROWS = 32
FIELD_TOL, RSQ_TOL = 1e-4, 1e-5
CIRCLE = ("circle", (0.0, 0.0), 0.5)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """The JAX problem, hierarchy and f32 BoxMG setup; the level-0 stencil
    field; the same setup as the port's tensors."""
    prob = JProblem(n=N, inclusion=CIRCLE)
    hier = JHierarchy.create(prob)
    outs = jboxmg.boxmg_setup(hier, dtype=jnp.float32)
    S0 = jboxmg.node_stencil_planes(hier.levels[0], jnp.float32)
    arrays = [(np.asarray(w4), np.asarray(sc)) for w4, sc in outs]
    return prob, outs, S0, boxmg_setup_from_arrays(arrays, device="cpu")


def _rel_err(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want))))


def _rsq_err(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def _fields(H, Hc, seed):
    """u with a nonzero Dirichlet ring, f, and a zero-ring coarse field."""
    rng = np.random.default_rng(seed)
    geo = np.zeros((H, H), np.float32)
    geo[1:-1, 1:-1] = 1.0
    u = (rng.standard_normal((H, H)).astype(np.float32) * geo
         + np.float32(0.7) * (1 - geo))
    f = rng.standard_normal((H, H)).astype(np.float32)
    uc = rng.standard_normal((Hc, Hc)).astype(np.float32)
    uc[0], uc[-1], uc[:, 0], uc[:, -1] = 0, 0, 0, 0
    return u, f, uc


def _pair(setup, which, dtype):
    """(JAX level, JAX next-coarser layout, port level) for ``which``:
    level 0 bi-material, level 0 on its stencil planes, or level 1."""
    prob, outs, S0, touts = setup
    jd, td = DTYPES[dtype]
    common = dict(Wp=128, rows=ROWS, rows_next=ROWS, interpret=True)
    if which == "l1":
        jl = GeneralPallasLevel(N // 2, stride=2, s9=outs[0][1], w4=outs[1][0],
                                coef_dtype=jd, **common)
        jc = GeneralPallasLevel(N // 4, stride=4, s9=outs[1][1], **common)
        tl = GeneralSweepLevel(N // 2, s9=touts[0][1], w4=touts[1][0], coef_dtype=td,
                               device="cpu")
        return jl, jc, tl
    jc = GeneralPallasLevel(N // 2, stride=2, s9=outs[0][1], **common)
    if which == "bim":
        phase = prob.phase(N)
        jl = GeneralPallasLevel(N, stride=1, phase=phase, coefficients=prob.coefficients,
                                w4=outs[0][0], coef_dtype=jd, **common)
        tl = GeneralSweepLevel(N, phase=phase, coefficients=prob.coefficients,
                               w4=touts[0][0], coef_dtype=td, device="cpu")
    else:
        jl = GeneralPallasLevel(N, stride=1, s9=S0, w4=outs[0][0], coef_dtype=jd, **common)
        tl = GeneralSweepLevel(N, s9=torch.from_numpy(np.array(S0)), w4=touts[0][0],
                               coef_dtype=td, device="cpu")
    return jl, jc, tl


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("which", ["bim", "gen", "l1"])
def test_d2_d3_match_pallas(setup, which, dtype):
    """D2 (swrr: u1, f_c, rsq of u) and D3 (psweep), on the exact
    bi-material level 0, on level 0's stencil planes, and on level 1."""
    jl, jc, tl = _pair(setup, which, dtype)
    n = tl.n
    u, f, uc = _fields(n + 1, n // 2 + 1, seed=0)
    up, fp, ucp = jl.pad(jnp.asarray(u)), jl.pad(jnp.asarray(f)), jc.pad(jnp.asarray(uc))
    tu, tf, tuc = map(torch.from_numpy, (u, f, uc))

    u1_w, fc_w, rsq_w = jl.swrr(up, fp)
    u1_g, fc_g, rsq_g = tl.swrr(tu, tf)
    assert _rel_err(u1_g, jl.unpad(u1_w)) < FIELD_TOL
    assert _rel_err(fc_g, jc.unpad(fc_w)) < FIELD_TOL
    assert _rsq_err(rsq_g, rsq_w) < RSQ_TOL
    np.testing.assert_array_equal(u1_g.numpy()[0], u[0])  # boundary kept

    want = jl.psweep(up, fp, ucp)
    got = tl.psweep(tu, tf, tuc)
    assert _rel_err(got, jl.unpad(want)) < FIELD_TOL


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["sweep", "residual"])
def test_d1_matches_pallas(setup, mode, dtype):
    """D1 on level 1 (stride 2 in the JAX layout): sweep and residual."""
    jl, _, tl = _pair(setup, "l1", dtype)
    u, f, _ = _fields(tl.n + 1, tl.n // 2 + 1, seed=1)
    up, fp = jl.pad(jnp.asarray(u)), jl.pad(jnp.asarray(f))
    tu, tf = torch.from_numpy(u), torch.from_numpy(f)
    want, rsq_w = getattr(jl, mode)(up, fp)
    got, rsq_g = getattr(tl, mode)(tu, tf)
    assert _rel_err(got, jl.unpad(want)) < FIELD_TOL
    assert _rsq_err(rsq_g, rsq_w) < RSQ_TOL


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_d4_d5_match_pallas(setup, dtype):
    """D4 (zwrr) and D5 (zpsweep) on level 1."""
    jl, jc, tl = _pair(setup, "l1", dtype)
    _, f, uc = _fields(tl.n + 1, tl.n // 2 + 1, seed=2)
    fp, ucp = jl.pad(jnp.asarray(f)), jc.pad(jnp.asarray(uc))
    tf, tuc = torch.from_numpy(f), torch.from_numpy(uc)
    assert _rel_err(tl.zwrr(tf), jc.unpad(jl.zwrr(fp))) < FIELD_TOL
    assert _rel_err(tl.zpsweep(tf, tuc), jl.unpad(jl.zpsweep(fp, ucp))) < FIELD_TOL


def test_zero_guess_legs_equal_their_compositions(setup):
    """zwrr == swrr from a zero iterate; zpsweep == sweep from zero, then
    psweep."""
    _, _, tl = _pair(setup, "l1", "f32")
    _, f, uc = _fields(tl.n + 1, tl.n // 2 + 1, seed=3)
    tf, tuc = torch.from_numpy(f), torch.from_numpy(uc)
    zero = torch.zeros_like(tf)
    assert _rel_err(tl.zwrr(tf), tl.swrr(zero, tf)[1]) < 1e-6
    u1, _ = tl.sweep(zero, tf)
    assert _rel_err(tl.zpsweep(tf, tuc), tl.psweep(u1, tf, tuc)) < 1e-6


def test_bim_level_sweeps_run_a1_in_difference_form(setup):
    """On a bi-material level, sweep and residual are kernel A1 in
    difference form, as GeneralPallasLevel delegates them."""
    prob = setup[0]
    phase = prob.phase(N)
    tl = GeneralSweepLevel(N, phase=phase, coefficients=prob.coefficients, device="cpu")
    ref = SweepLevel(N, phase=phase, coefficients=prob.coefficients, dform=True, device="cpu")
    u, f, _ = _fields(N + 1, N // 2 + 1, seed=4)
    tu, tf = torch.from_numpy(u), torch.from_numpy(f)
    for name in ("sweep", "residual"):
        for a, b in zip(getattr(tl, name)(tu, tf), getattr(ref, name)(tu, tf)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    # phase=None is the all-zero map: the homogeneous operator of a0
    hom = GeneralSweepLevel(N, device="cpu")
    assert hom.bim and int(hom.op.abs().sum()) == 0


def test_planes_are_stored_in_coef_dtype(setup):
    _, _, tl = _pair(setup, "l1", "bf16")
    H = tl.n + 1
    assert tl.op.shape == (9, H, H) and tl.op.dtype == torch.bfloat16 and tl.op.is_contiguous()
    assert tl.w4.shape == (4, H, H) and tl.w4.dtype == torch.bfloat16
    # plane 3*dr + dc is S[..., dr, dc]
    S = setup[3][0][1]
    np.testing.assert_array_equal(tl.op[5].float().numpy(),
                                  S[..., 1, 2].to(torch.bfloat16).float().numpy())


def test_plain_versions_fill_out_buffers(setup):
    _, _, tl = _pair(setup, "l1", "f32")
    n = tl.n
    u, f, uc = map(torch.from_numpy, _fields(n + 1, n // 2 + 1, seed=5))
    out, fc, rsq = torch.empty_like(u), torch.empty(n // 2 + 1, n // 2 + 1), torch.empty(())
    res = tl.swrr(u, f, out=out, fc_out=fc, rsq=rsq)
    assert res[0] is out and res[1] is fc and res[2] is rsq
    for a, b in zip(res, tl.swrr(u, f)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert tl.psweep(u, f, uc, out=out) is out
    assert tl.zpsweep(f, uc, out=out) is out
    assert tl.zwrr(f, out=fc) is fc


def test_level_and_wrappers_refuse_what_they_do_not_take(setup):
    prob, _, _, touts = setup
    with pytest.raises(ValueError, match="not both"):
        GeneralSweepLevel(N, s9=touts[0][1], phase=prob.phase(N), device="cpu")
    with pytest.raises(ValueError, match="coef_dtype"):
        GeneralSweepLevel(N, phase=prob.phase(N), coef_dtype=torch.float16, device="cpu")
    bim = GeneralSweepLevel(N, phase=prob.phase(N), device="cpu")
    f = torch.zeros(N + 1, N + 1)
    with pytest.raises(ValueError, match="general"):
        bim.zwrr(f)
    with pytest.raises(ValueError, match="transfer weights"):
        bim.swrr(f, f)
    u = torch.zeros(33, 33)
    s9, w4 = torch.zeros(9, 33, 33), torch.zeros(4, 33, 33)
    with pytest.raises(ValueError, match="CUDA"):
        gen.gsweep_cuda(u, u, s9, omega=2 / 3)
    with pytest.raises(ValueError, match="CUDA"):
        gen.gswrr_cuda(u, u, s9, w4, a0=1.0, da=0.0, omega=2 / 3)
    with pytest.raises(ValueError, match="CUDA"):
        gen.zgpsweep_cuda(u, s9, w4, torch.zeros(17, 17), omega=2 / 3)
    with pytest.raises(ValueError, match="general"):
        gen.zgwrr_cuda(u, torch.zeros(32, 32, dtype=torch.int8), w4, omega=2 / 3)
    with pytest.raises(ValueError, match="mode"):
        gen.gsweep_plain(u, u, s9, omega=2 / 3, mode="psweep")
