"""The port's H-Net model (multigrid_feanet_torch/models/hnet.py), checkpoint
reader (utils/checkpoint.py), weight carry-over (core/convert.py) and the
notebook-faithful H-MG solve (solvers/hmg.py::solve) against the JAX
package, on the CPU.

Inputs and parameters are made with numpy from a seed and handed to both
sides.  The model functions follow the JAX sums term by term, so they agree
to f32 rounding (1e-6 relative); the solve to the tolerance of
tests/test_hmg.py on iterates (3e-4 relative) and to 1e-3 on histories.
"""

from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.core.problem import GridHierarchy as JHierarchy
from multigrid_feanet_tpu.core.problem import Problem as JProblem
from multigrid_feanet_tpu.models import hnet as jhnet
from multigrid_feanet_tpu.ops import stencil as jst
from multigrid_feanet_tpu.solvers import hmg as jhmg
from multigrid_feanet_tpu.utils import checkpoint as jckpt

from multigrid_feanet_torch.core.convert import hierarchy_from_arrays, hnet_params_from_arrays
from multigrid_feanet_torch.core.problem import Problem
from multigrid_feanet_torch.models import hnet
from multigrid_feanet_torch.solvers import hmg
from multigrid_feanet_torch.solvers.hmg import HMGHierarchy
from multigrid_feanet_torch.utils import checkpoint

ROOT = Path(__file__).resolve().parent.parent
CKPT_DIR = ROOT / "results" / "learn_iterator"
CIRCLE = ("circle", (0.0, 0.0), 0.5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _params(L, seed=0):
    return np.random.default_rng(seed).uniform(-1 / 3, 1 / 3, (L, 3, 3)).astype(np.float32)


def _port_hier(jh, jp):
    """The port's hierarchy on the JAX hierarchy's own fields (CPU)."""
    arrays = [dict(n=lv.n, h=lv.h, a0=lv.a0, a1=lv.a1, table=np.asarray(lv.table),
                   pid=None if lv.pid is None else np.asarray(lv.pid),
                   geo=np.asarray(lv.geo), diag=np.asarray(lv.diag), phase=jp.phase(lv.n))
              for lv in jh.levels]
    return hierarchy_from_arrays(arrays, device="cpu")


def _close(got, want, rtol=1e-6):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = max(1e-30, float(np.max(np.abs(want))))
    assert float(np.max(np.abs(got - want))) / scale < rtol


@pytest.mark.parametrize("L", [1, 3])
def test_conv_chain_and_composition_match_jax(L):
    """conv3x3, apply_hnet and compose_kernels at n = 32."""
    n = 32
    params = _params(L)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n + 1, n + 1)).astype(np.float32)
    geo = np.zeros((n + 1, n + 1), np.float32)
    geo[1:-1, 1:-1] = 1.0
    tp, tx, tg = map(torch.from_numpy, (params, x, geo))
    _close(hnet.conv3x3(tx, tp[0]), jhnet.conv3x3(jnp.asarray(x), jnp.asarray(params[0])))
    _close(hnet.apply_hnet(tp, tx, tg),
           jhnet.apply_hnet(jnp.asarray(params), jnp.asarray(x), jnp.asarray(geo)))
    comp = hnet.compose_kernels(tp)
    assert comp.shape == (2 * L + 1, 2 * L + 1) and comp.dtype == torch.float32
    _close(comp, jhnet.compose_kernels(jnp.asarray(params)))


@pytest.mark.parametrize("inc", [None, CIRCLE], ids=["hom", "bim"])
def test_h_relax_matches_jax(inc):
    """Two H-relax sweeps with a nonzero boundary value, at n = 32."""
    n = 32
    jp = JProblem(n=n, inclusion=inc)
    jh = JHierarchy.create(jp, 1)
    th = _port_hier(jh, jp)
    params = _params(3, seed=2)
    rng = np.random.default_rng(3)
    u = rng.standard_normal((n + 1, n + 1)).astype(np.float32)
    f = rng.standard_normal((n + 1, n + 1)).astype(np.float32)
    got = hnet.h_relax(th.finest, torch.from_numpy(params), torch.from_numpy(u),
                       torch.from_numpy(f), 2, 0.5)
    want = jhnet.h_relax(jh.finest, jnp.asarray(params), jnp.asarray(u), jnp.asarray(f), 2, 0.5)
    _close(got, want, rtol=2e-6)


def test_init_params_draws_from_the_generator():
    g = torch.Generator().manual_seed(7)
    p = hnet.init_params(3, generator=g)
    assert p.shape == (3, 3, 3) and p.dtype == torch.float32
    assert float(p.abs().max()) <= 1 / 3
    q = hnet.init_params(3, generator=torch.Generator().manual_seed(7))
    assert torch.equal(p, q)
    assert float(hnet.init_params(2, scale=0.01).abs().max()) <= 0.01


def test_hnet_module_state_dict_and_kernels():
    """The reference's state-dict layout (convLayers.{i}.weight, (1, 1, 3, 3))
    loads with load_state_dict, and kernels() gives back the (L, 3, 3)
    tensor; forward is apply_hnet."""
    params = _params(3, seed=4)
    net = hnet.HNet(3)
    sd = net.state_dict()
    assert list(sd) == [f"convLayers.{i}.weight" for i in range(3)]
    assert all(tuple(w.shape) == (1, 1, 3, 3) for w in sd.values())
    reference = {f"convLayers.{i}.weight": torch.from_numpy(params[i]).reshape(1, 1, 3, 3)
                 for i in range(3)}
    net.load_state_dict(reference)
    k = net.kernels()
    assert k.shape == (3, 3, 3) and k.dtype == torch.float32 and k.is_contiguous()
    assert not k.requires_grad
    np.testing.assert_array_equal(k.numpy(), params)
    assert list(hnet.HNet(1).state_dict()) == ["convLayers.0.weight"]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((17, 17)).astype(np.float32))
    geo = torch.ones(17, 17)
    out = net(x, geo)
    assert out.requires_grad
    np.testing.assert_array_equal(out.detach().numpy(),
                                  hnet.apply_hnet(torch.from_numpy(params), x, geo).numpy())


CHECKPOINTS = sorted(p.name for p in CKPT_DIR.glob("*.npz"))


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_checkpoint_load_matches_jax(name):
    got = checkpoint.load(CKPT_DIR / name)
    want = jckpt.load(str(CKPT_DIR / name))
    assert len(got) == len(want) >= 1
    for a, b in zip(got, want):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))


def test_checkpoint_refuses_other_forms(tmp_path):
    with pytest.raises(ValueError, match="Orbax"):
        checkpoint.load(tmp_path)
    with pytest.raises(ValueError, match="npz"):
        checkpoint.load(tmp_path / "weights.pth")


def test_hnet_params_from_arrays():
    params = checkpoint.load(CKPT_DIR / "hnet_decay_L1_hlNone.npz")[0]
    t = hnet_params_from_arrays(params, device="cpu")
    assert t.shape == (1, 3, 3) and t.dtype == torch.float32 and t.is_contiguous()
    np.testing.assert_array_equal(t.numpy(), params)
    t64 = hnet_params_from_arrays(params.astype(np.float64).transpose(0, 2, 1), device="cpu")
    assert t64.dtype == torch.float32 and t64.is_contiguous()
    with pytest.raises(ValueError, match=r"\(L, 3, 3\)"):
        hnet_params_from_arrays(np.zeros((3, 3)), device="cpu")


@pytest.mark.parametrize("mode", ["hjac", "jac"])
def test_solve_matches_jax(mode):
    """The notebook-faithful whole solve (unmasked residual, post-cycle
    history) against JAX hmg.solve, at n = 32 with the mass-convolved unit
    load, as tests/test_hmg.py."""
    n = 32
    jp = JProblem(n=n)
    jh = JHierarchy.create(jp)
    th = _port_hier(jh, jp)
    f = np.asarray(jst.apply_mass(jnp.ones((n + 1, n + 1), jnp.float32), jh.finest.h))
    params = _params(3, seed=6)
    uj, hj = jhmg.solve(jh, jnp.asarray(params), jnp.asarray(f), eps=1e-4, mode=mode)
    ut, ht = hmg.solve(th, params, f, eps=1e-4, mode=mode)
    assert len(ht) == len(hj) and ht.dtype == np.float32
    # the last residuals (~4e-5) are f32 sums of ~1e3 rounded terms: their
    # relative rounding reaches a few 1e-4
    np.testing.assert_allclose(ht, np.asarray(hj), rtol=1e-3)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=3e-4, atol=1e-6)


def test_solve_refuses_unknown_mode():
    th = _port_hier(JHierarchy.create(JProblem(n=8)), JProblem(n=8))
    with pytest.raises(ValueError, match="mode"):
        hmg.solve(th, _params(1), np.zeros((9, 9), np.float32), mode="sor")


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        HMGHierarchy(Problem(n=32), num_levels=3, kernel_threshold=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        hnet_params_from_arrays(_params(1))
    assert HMGHierarchy(Problem(n=32), num_levels=3, kernel_threshold=16,
                        device="cpu").device == torch.device("cpu")
