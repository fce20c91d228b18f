"""The port's bitplane-form sweeps (multigrid_feanet_torch/ops/stencil_sweep.py)
against the JAX PallasStencil kernels in interpret mode, on the CPU.

Every StencilLevel method runs its plain PyTorch version here (the tensors
lie on the CPU); chip_smoke.py holds the CUDA kernels C1 and C2 against
those plain versions, and C2 against chained C1 launches, on the card.
Inputs are made with numpy from a seed; the JAX side pads them into
PallasStencil's ghost-block layout.  Tolerance: max|diff| <= 2e-5 * max(1,
max|ref|) on fields and 2e-5 relative on rsq, as tests/test_torch_sweep.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.core.problem import GridHierarchy as JGrid
from multigrid_feanet_tpu.core.problem import Problem as JProblem
from multigrid_feanet_tpu.ops.pallas_stencil import PallasStencil

from multigrid_feanet_torch.ops import stencil as tst
from multigrid_feanet_torch.ops import stencil_sweep as ss
from multigrid_feanet_torch.ops.stencil_sweep import StencilLevel

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


def _levels(n, bim, seed=0):
    """The JAX PallasStencil and the port's level on the level's pattern ids
    (from the JAX hierarchy), plus seeded inputs with a nonzero Dirichlet
    ring."""
    lv = JGrid.create(JProblem(n=n, inclusion=CIRCLE if bim else None), 1).finest
    pid = None if lv.pid is None else np.array(lv.pid)
    js = PallasStencil(n, pid=None if pid is None else jnp.asarray(pid), interpret=True)
    tl = StencilLevel(n, pid=pid, device="cpu")
    rng = np.random.default_rng(seed)
    H = n + 1
    geo = np.zeros((H, H), np.float32)
    geo[1:-1, 1:-1] = 1.0
    u = rng.standard_normal((H, H)).astype(np.float32) * geo + np.float32(0.7) * (1 - geo)
    f = rng.standard_normal((H, H)).astype(np.float32)
    return js, tl, u, f


OPS = ["sweep", "residual", "k1", "k2", "k3", "k4"]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
@pytest.mark.parametrize("n", [32, 64], ids=["n32", "n64"])
def test_c1_c2_match_pallas(n, bim, op):
    """C1 (sweep, residual) and C2 (k = 1..4 fused sweeps) with their rsq."""
    js, tl, u, f = _levels(n, bim)
    up, fp = js.pad(jnp.asarray(u)), js.pad(jnp.asarray(f))
    tu, tf = torch.from_numpy(u), torch.from_numpy(f)
    if op == "sweep":
        (want, rsq_w), (got, rsq_g) = js.sweep_padded(up, fp), tl.sweep(tu, tf)
    elif op == "residual":
        (want, rsq_w), (got, rsq_g) = js.residual_padded(up, fp), tl.residual(tu, tf)
    else:
        k = int(op[1:])
        (want, rsq_w), (got, rsq_g) = js.sweep_k_padded(up, fp, k), tl.sweep_k(tu, tf, k)
    assert _rel_err(got, js.unpad(want)) < TOL
    assert _rsq_err(rsq_g, rsq_w) < TOL
    if op != "residual":
        np.testing.assert_array_equal(got.numpy()[0], u[0])  # boundary kept
    else:
        assert float(got.abs()[0].max()) == 0.0


@pytest.mark.parametrize("k", [2, 3, 5, 8])
@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
def test_c2_equals_chained_c1(bim, k):
    """C2's plain version is k chained C1 sweeps, with the rsq of the last
    sweep's input (lagging k - 1 sweeps)."""
    _, tl, u, f = _levels(32, bim, seed=1)
    tu, tf = torch.from_numpy(u), torch.from_numpy(f)
    got, rsq = tl.sweep_k(tu, tf, k)
    chain = tu
    for _ in range(k):
        chain, rsq_last = tl.sweep(chain, tf)
    np.testing.assert_array_equal(got.numpy(), chain.numpy())
    assert float(rsq) == float(rsq_last)


@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
def test_bitplane_apply_matches_assembled_stencil(bim):
    """The bitplane residual equals the residual of the 16-pattern stencil
    table applied by gather (ops/stencil.py), an independent construction
    of the same operator, in f64."""
    n = 32
    _, tl, u, f = _levels(n, bim, seed=2)
    tu, tf = torch.from_numpy(u).double(), torch.from_numpy(f).double()
    coef = (1.0, 20.0) if bim else (1.0, 1.0)
    table = torch.from_numpy(tst.make_stencil_table_np(coef))
    pid = tl.pid if bim else torch.zeros((n + 1, n + 1), dtype=torch.int8)
    want = (tf - tst.apply_stencil(table, pid, tu))[1:-1, 1:-1]
    r, _ = ss.relax_plain(tu, tf, tl.pid, a0=tl.a0, da=tl.da, omega=tl.omega,
                          mode="residual")
    assert float((r[1:-1, 1:-1] - want).abs().max()) < 1e-12 * float(want.abs().max())


def test_plain_versions_fill_out_buffers():
    _, tl, u, f = _levels(32, True)
    tu, tf = torch.from_numpy(u), torch.from_numpy(f)
    out, rsq = torch.empty_like(tu), torch.empty(())
    res = tl.sweep_k(tu, tf, 3, out=out, rsq=rsq)
    assert res[0] is out and res[1] is rsq
    ref = tl.sweep_k(tu, tf, 3)
    np.testing.assert_array_equal(out.numpy(), ref[0].numpy())
    assert tl.residual(tu, tf, out=out)[0] is out


def test_wrappers_check_operands(monkeypatch):
    """The kernel wrappers refuse what the kernels do not take, before any
    build or launch; k outside 1..8 and unknown modes raise on both paths."""
    u = torch.zeros(17, 17)
    cfg = dict(a0=1.0, da=19.0, omega=2 / 3)
    with pytest.raises(ValueError, match="CUDA"):
        ss.relax_cuda(u, u, None, **cfg)
    with pytest.raises(ValueError, match="CUDA"):
        ss.multi_cuda(u, u, None, k=2, **cfg)
    for k in (0, 9):
        with pytest.raises(ValueError, match="sweep_k"):
            ss.multi_plain(u, u, None, k=k, **cfg)
        with pytest.raises(ValueError, match="sweep_k"):
            ss.multi_cuda(u, u, None, k=k, **cfg)
    with pytest.raises(ValueError, match="mode"):
        ss.relax_plain(u, u, None, mode="psweep", **cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StencilLevel(16)  # the level defaults to the card
