"""The port's H-Net training (multigrid_feanet_torch/learn/train_hnet.py),
h_relax_dynamic and checkpoints (utils/checkpoint.py) against the JAX
package's, on the CPU.

Inputs are made with numpy (or, for the JAX random start of measure_q,
with jax.random) and fed to both sides.  Tolerances: iterates 1e-5 and
gradients 1e-4 relative (float32 sums in another order, through several
sweeps); optimizer updates 1e-6.  Training itself draws from the port's
torch.Generator, so its losses are held to the JAX test's anchors
(tests/test_hnet.py, tests/test_checkpoint.py), not to JAX's numbers.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from multigrid_feanet_tpu.core.problem import GridHierarchy as JHierarchy, Problem as JProblem
from multigrid_feanet_tpu.core.problem import build_level as j_build_level
from multigrid_feanet_tpu.learn import train_hnet as jth
from multigrid_feanet_tpu.models import hnet as jhnet
from multigrid_feanet_tpu.utils import checkpoint as jckpt

from multigrid_feanet_torch.core.problem import GridHierarchy, Problem, build_level
from multigrid_feanet_torch.data import datasets
from multigrid_feanet_torch.learn import train_hnet as th
from multigrid_feanet_torch.models import hnet
from multigrid_feanet_torch.utils import checkpoint

CIRCLE = ("circle", (0.0, 0.0), 0.5)
L1 = "results/learn_iterator/hnet_decay_L1_hlNone.npz"


def _rel(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want))) / max(1e-30, float(np.max(np.abs(want))))


@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
def test_h_relax_dynamic_and_gradient_match_jax(bim):
    """The training loss of train_step (k of k_max sweeps from a batch of
    starts, against u*) and its gradient in the kernels, against
    jax.value_and_grad of the same function."""
    n, k, k_max = 16, 4, 6
    inc = CIRCLE if bim else None
    jl = j_build_level(JProblem(n=n, inclusion=inc), n)
    tl = build_level(Problem(n=n, inclusion=inc), n, device="cpu")
    rng = np.random.default_rng(0)
    H = n + 1
    u0, f, ustar = (rng.standard_normal((2, H, H)).astype(np.float32) for _ in range(3))
    bc = (rng.standard_normal((2, H, H)) * (1 - np.asarray(jl.geo))).astype(np.float32)
    params = (0.2 * rng.standard_normal((3, 3, 3))).astype(np.float32)

    def jloss(p):
        out = jhnet.h_relax_dynamic(jl, p, jnp.asarray(u0), jnp.asarray(f), k, k_max,
                                    jnp.asarray(bc))
        return jnp.sum((out - jnp.asarray(ustar)) ** 2), out

    (jl_val, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(params))
    tp = torch.tensor(params, requires_grad=True)
    out = hnet.h_relax_dynamic(tl, tp, torch.from_numpy(u0), torch.from_numpy(f), k, k_max,
                               torch.from_numpy(bc))
    loss = torch.sum((out - torch.from_numpy(ustar)) ** 2)
    loss.backward()
    assert _rel(out, jout) < 1e-5
    assert abs(float(loss.detach()) / float(jl_val) - 1) < 1e-5
    assert _rel(tp.grad, jgrad) < 1e-4
    # beyond max_sweeps nothing runs, as the masked scan does
    again = hnet.h_relax_dynamic(tl, tp.detach(), torch.from_numpy(u0), torch.from_numpy(f),
                                 k_max + 5, k_max, torch.from_numpy(bc))
    want = jhnet.h_relax_dynamic(jl, jnp.asarray(params), jnp.asarray(u0), jnp.asarray(f),
                                 k_max + 5, k_max, jnp.asarray(bc))
    assert _rel(again, want) < 1e-5


@pytest.mark.parametrize("which", ["adadelta", "adam"])
def test_optimizer_updates_match_optax(which):
    """Two updates with the same gradients: Adadelta (lr 1, rho 0.9, eps
    1e-6, the reference's) and Adam (lr 3e-3, make_decay_step's)."""
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((3, 3, 3)).astype(np.float32)
    grads = [rng.standard_normal((3, 3, 3)).astype(np.float32) for _ in range(2)]
    if which == "adadelta":
        tx = jth.make_optimizer()
        state = th.init_state(build_level(Problem(n=8), 8, device="cpu"), params=p0)
        assert isinstance(state.optimizer, torch.optim.Adadelta)
    else:
        tx = optax.adam(3e-3)
        init_fn, _ = th.make_decay_step([GridHierarchy.create(Problem(n=8), device="cpu")],
                                        learning_rate=3e-3)
        state = init_fn(params=p0)
        assert isinstance(state.optimizer, torch.optim.Adam)
    jp = jnp.asarray(p0)
    js = tx.init(jp)
    for g in grads:
        upd, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        state.params.grad = torch.from_numpy(g)
        state.optimizer.step()
    np.testing.assert_allclose(state.params.detach().numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("n,h_levels", [(32, None), (64, None), (64, 1)])
def test_hjac_vcycle_matches_jax(n, h_levels):
    jh = JHierarchy.create(JProblem(n=n, inclusion=CIRCLE, dtype=jnp.float32))
    tl = GridHierarchy.create(Problem(n=n, inclusion=CIRCLE), device="cpu")
    params = checkpoint.load(L1)[0]
    rng = np.random.default_rng(n)
    geo = np.asarray(jh.finest.geo)
    u = (rng.standard_normal((n + 1, n + 1)) * geo).astype(np.float32)
    f = rng.standard_normal((n + 1, n + 1)).astype(np.float32)
    ju, tu = jnp.asarray(u), torch.from_numpy(u)
    for _ in range(2):
        ju = jth._hjac_vcycle(jh, jnp.asarray(params), ju, jnp.asarray(f), h_levels=h_levels)
        tu = th._hjac_vcycle(tl, torch.from_numpy(params), tu, torch.from_numpy(f),
                             h_levels=h_levels)
    assert _rel(tu, ju) < 1e-5


@pytest.mark.parametrize("mode", ["hjac", "jac"])
def test_measure_q_matches_jax(mode):
    """measure_q from JAX's own random start (jax.random, key 0), fed to the
    port: the same residual norms and q."""
    n = 32
    jh = JHierarchy.create(JProblem(n=n, dtype=jnp.float32))
    tl = GridHierarchy.create(Problem(n=n), device="cpu")
    params = checkpoint.load(L1)[0]
    u0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n + 1, n + 1), jnp.float32))
    qj, rj = jth.measure_q(jh, jnp.asarray(params), m=6, mode=mode)
    qt, rt = th.measure_q(tl, torch.from_numpy(params), m=6, mode=mode, u0=u0)
    assert abs(qt / qj - 1) < 1e-4
    np.testing.assert_allclose(rt, rj, rtol=1e-4)


def _tiny_dataset(n=8, N=6):
    return build_level(Problem(n=n), n, device="cpu"), datasets.generate_isopoisson(n, N, seed=0)


def test_training_reduces_loss():
    """The anchor of tests/test_hnet.py::test_training_reduces_loss: n = 16,
    10 samples, 8 epochs of batch 5, k_max 4."""
    lv = build_level(Problem(n=16), 16, device="cpu")
    ds = datasets.generate_isopoisson(16, num_samples=10, seed=0)
    params, losses = th.train(lv, ds, num_epochs=8, batch_size=5, seed=0, k_max=4, verbose=False)
    assert losses[-1] < losses[0] * 0.9, losses
    assert tuple(params.shape) == (3, 3, 3) and not params.requires_grad


def test_train_resume_matches_straight_run(tmp_path):
    """The model of tests/test_checkpoint.py: 4 epochs straight against 2
    checkpointed epochs resumed to 4."""
    lv, ds = _tiny_dataset()
    kw = dict(batch_size=3, seed=0, k_max=4, verbose=False)
    p_full, l_full = th.train(lv, ds, num_epochs=4, **kw)
    ck = tmp_path / "hnet"
    th.train(lv, ds, num_epochs=2, ckpt_dir=ck, **kw)
    p_res, l_res = th.train(lv, ds, num_epochs=4, ckpt_dir=ck, **kw)
    assert len(l_res) == 4
    np.testing.assert_allclose(l_res, l_full, rtol=1e-6)
    np.testing.assert_allclose(p_res.numpy(), p_full.numpy(), rtol=1e-6)


def test_save_load_training_roundtrip(tmp_path):
    lv, ds = _tiny_dataset()
    state = th.init_state(lv, seed=0)
    for batch in datasets.batches(ds, 3, seed=0, device="cpu"):
        state, _ = th.train_step(lv, state, *batch, k_max=3)
    checkpoint.save_training(tmp_path, th.state_tree(state), 7, [1.0, 0.5])
    fresh = th.init_state(lv, seed=1)
    cold, epoch, losses = checkpoint.load_training(tmp_path / "none", th.state_tree(fresh))
    assert epoch == 0 and losses == []
    tree, epoch, losses = checkpoint.load_training(tmp_path, th.state_tree(fresh))
    assert epoch == 7 and losses == [1.0, 0.5]
    back = th.load_state_tree(fresh, tree)
    for a, b in zip(checkpoint._flatten(th.state_tree(back))[0],
                    checkpoint._flatten(th.state_tree(state))[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_decay_step_loss_falls():
    """make_decay_step at sizes (16, 32), L = 1: the error-decay loss (mean
    log q) falls over a few Adam steps."""
    hiers = [GridHierarchy.create(Problem(n=n), device="cpu") for n in (16, 32)]
    init_fn, step = th.make_decay_step(hiers, m=6, batch=2, warm=2)
    state = init_fn(seed=0, num_layers=1)
    losses = []
    for _ in range(6):
        state, loss = step(state)
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 0.05, losses


def test_params_npz_crosses_both_ways(tmp_path):
    """A params-only .npz written by the port loads with the JAX package's
    checkpoint.load, and the reverse; a JAX params array becomes a port
    training state."""
    rng = np.random.default_rng(3)
    p = rng.standard_normal((3, 3, 3)).astype(np.float32)
    checkpoint.save(tmp_path / "port.npz", torch.from_numpy(p))
    (back,) = jckpt.load(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(back, p)
    with np.load(tmp_path / "port.npz") as data:
        assert bytes(data["__treedef__"]).decode() == "PyTreeDef(*)"
    jckpt.save(str(tmp_path / "jax.npz"), jnp.asarray(p))
    (mine,) = checkpoint.load(tmp_path / "jax.npz")
    np.testing.assert_array_equal(mine, p)
    lv = build_level(Problem(n=8), 8, device="cpu")
    jstate = jth.init_state(j_build_level(JProblem(n=8), 8), seed=0)
    state = th.init_state(lv, params=np.asarray(jstate.params))
    np.testing.assert_array_equal(state.params.detach().numpy(), np.asarray(jstate.params))
    assert state.params.requires_grad and not state.optimizer.state


def test_tree_checkpoint_keeps_structure(tmp_path):
    """save/load of a nested tree: jax.tree.flatten's leaf order (dict keys
    sorted, None holds no leaf), tensors back on their like's dtype."""
    tree = {"b": [torch.ones(2), (np.arange(3), None)], "a": np.float64(2.5)}
    checkpoint.save(tmp_path / "t.npz", tree)
    leaves = checkpoint.load(tmp_path / "t.npz")
    assert [np.asarray(x).tolist() for x in leaves] == [2.5, [1.0, 1.0], [0, 1, 2]]
    assert jckpt.load(str(tmp_path / "t.npz"))[1].tolist() == [1.0, 1.0]
    back = checkpoint.load(tmp_path / "t.npz", like=tree)
    assert torch.is_tensor(back["b"][0]) and back["b"][1][1] is None
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load(tmp_path / "t.npz", like={"a": 0})
    with pytest.raises(ValueError, match=".npz"):
        checkpoint.save(tmp_path / "t.pth", tree)
