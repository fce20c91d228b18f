"""The port's learned inter-grid operators (multigrid_feanet_torch/
models/intergrid.py, learn/train_intergrid.py), the pattern split of
ops/stencil.py and the inter-grid converters of core/convert.py against the
JAX package's, on the CPU.

Inputs are made with numpy (or, for a JAX train step's own draws, with
jax.random from its state's key) and fed to both sides.  Tolerances:
stencil functions 1e-6; transfers and one cycle 1e-5 relative; five cycles,
q_m and gradients 1e-4 relative (float32 sums in another order, through
several cycles); optimizer updates 1e-6.  Training itself draws from the
port's torch.Generator, so its losses are held to the JAX test's anchors
(tests/test_intergrid.py), not to JAX's numbers.
"""

import glob

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from multigrid_feanet_tpu.core.problem import GridHierarchy as JHierarchy, Problem as JProblem
from multigrid_feanet_tpu.learn import train_intergrid as jti
from multigrid_feanet_tpu.models import intergrid as ji
from multigrid_feanet_tpu.ops import stencil as jst
from multigrid_feanet_tpu.utils import checkpoint as jckpt

from multigrid_feanet_torch.core.convert import (intergrid_params_from_arrays,
                                                 intergrid_params_from_npz)
from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
from multigrid_feanet_torch.data import rhs
from multigrid_feanet_torch.learn import train_intergrid as ti
from multigrid_feanet_torch.models import intergrid
from multigrid_feanet_torch.ops import stencil
from multigrid_feanet_torch.ops.transfer import prolong_bilinear, restrict_full_weighting

CIRCLE = ("circle", (0.0, 0.0), 0.5)
N64 = "results/intergrid_trained_interface_n64.npz"
CHECKPOINTS = sorted([N64, "results/intergrid_twogrid_interface.npz"]
                     + glob.glob("results/intergrid_boxmg/*.npz")
                     + glob.glob("results/intergrid_robust/*.npz"))


def _rel(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want))) / max(1e-30, float(np.max(np.abs(want))))


def _hiers(n, bim=True, num_levels=None):
    inc = CIRCLE if bim else None
    return (JHierarchy.create(JProblem(n=n, inclusion=inc, dtype=jnp.float32), num_levels),
            GridHierarchy.create(Problem(n=n, inclusion=inc), num_levels, device="cpu"))


def _random_params(C, seed):
    rng = np.random.default_rng(seed)
    conv = (intergrid.FULL_WEIGHTING_16 + 0.05 * rng.standard_normal((C, 3, 3))).astype(np.float32)
    deconv = (intergrid.BILINEAR_4 + 0.05 * rng.standard_normal((C, 3, 3))).astype(np.float32)
    w = np.array([3.7, 1.1], np.float32)
    return conv, deconv, w


def _both(conv, deconv, w):
    jp = ji.IntergridParams(conv=jnp.asarray(conv), deconv=jnp.asarray(deconv), w=jnp.asarray(w))
    return jp, intergrid_params_from_arrays(conv, deconv, w, device="cpu")


def rng_fields(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _npz_params(path):
    with np.load(path) as d:
        return d["conv"], d["deconv"], d["w"] if "w" in d.files else np.array([4.0, 1.0],
                                                                                np.float32)


# ---- ops/stencil.py ------------------------------------------------------


def test_stencil_table_permutation_and_pattern_ids_match_jax():
    for coef in ((1.0, 20.0), (1.0, 1.0), (3.0, 0.5)):
        np.testing.assert_allclose(stencil.make_stencil_table(coef, device="cpu").numpy(),
                                   np.asarray(jst.make_stencil_table(coef)), rtol=1e-6)
    np.testing.assert_array_equal(stencil.reference_pattern_permutation(),
                                  jst.reference_pattern_permutation())
    phase = (np.random.default_rng(0).uniform(size=(24, 24)) < 0.4).astype(np.int8)
    pid = stencil.pattern_ids(torch.from_numpy(phase))
    assert pid.dtype == torch.int8
    np.testing.assert_array_equal(pid.numpy(), np.asarray(jst.pattern_ids(jnp.asarray(phase))))


def test_gather_split_and_conv_apply_match_jax():
    rng = np.random.default_rng(1)
    phase = (rng.uniform(size=(24, 24)) < 0.4).astype(np.int8)
    pid = stencil.pattern_ids(torch.from_numpy(phase))
    jpid = jst.pattern_ids(jnp.asarray(phase))
    table = stencil.make_stencil_table((1.0, 20.0), device="cpu")
    jtable = jst.make_stencil_table((1.0, 20.0))
    np.testing.assert_allclose(stencil.gather_coefficients(table, pid).numpy(),
                               np.asarray(jst.gather_coefficients(jtable, jpid)), rtol=1e-6)
    u = rng.standard_normal((3, 25, 25)).astype(np.float32)
    for P in (16, 5):
        split = stencil.split_by_pattern(torch.from_numpy(u), pid, P)
        assert split.shape == (3, P, 25, 25)
        np.testing.assert_array_equal(split.numpy(),
                                      np.asarray(jst.split_by_pattern(jnp.asarray(u), jpid, P)))
    for x in (u, u[0]):
        got = stencil.apply_stencil_conv(table, pid, torch.from_numpy(x))
        want = jst.apply_stencil_conv(jtable, jpid, jnp.asarray(x))
        assert got.shape == x.shape
        assert _rel(got, want) < 1e-6
        assert _rel(got, stencil.apply_stencil(table, pid, torch.from_numpy(x))) < 1e-6


# ---- models/intergrid.py -------------------------------------------------


@pytest.mark.parametrize("bim", [True, False], ids=["bim", "hom"])
def test_transfers_match_jax(bim):
    """restrict_learned and prolong_learned with random non-init params, on
    the level-0 and level-1 pids of a 32^2 hierarchy."""
    jh, th = _hiers(32, bim, 2)
    C = 16 if bim else 1
    jp, tp = _both(*_random_params(C, 2))
    rng = np.random.default_rng(3)
    r = rng.standard_normal((2, 33, 33)).astype(np.float32)
    v = rng.standard_normal((2, 17, 17)).astype(np.float32)
    got = intergrid.restrict_learned(tp, torch.from_numpy(r), th.levels[0].pid)
    want = ji.restrict_learned(jp, jnp.asarray(r), jh.levels[0].pid)
    assert got.shape == (2, 17, 17) and _rel(got, want) < 1e-5
    got = intergrid.prolong_learned(tp, torch.from_numpy(v), th.levels[1].pid)
    want = ji.prolong_learned(jp, jnp.asarray(v), jh.levels[1].pid)
    assert got.shape == (2, 33, 33) and _rel(got, want) < 1e-5


def test_init_transfers_equal_classical():
    """At init the masks partition unity: the restriction is 4x full
    weighting, the prolongation's interior is bilinear."""
    _, th = _hiers(32, True, 2)
    params = intergrid.IntergridParams.init(device="cpu")
    rng = np.random.default_rng(0)
    r = torch.from_numpy(rng.standard_normal((2, 33, 33)).astype(np.float32))
    got = intergrid.restrict_learned(params, r, th.levels[0].pid)
    np.testing.assert_allclose(got.detach().numpy(), 4.0 * restrict_full_weighting(r).numpy(),
                               rtol=1e-5, atol=1e-5)
    v = torch.from_numpy(rng.standard_normal((2, 17, 17)).astype(np.float32))
    got = intergrid.prolong_learned(params, v, th.levels[1].pid)
    np.testing.assert_allclose(got.detach().numpy()[:, 1:-1, 1:-1],
                               prolong_bilinear(v).numpy()[:, 1:-1, 1:-1], rtol=1e-5, atol=1e-5)


def test_learned_cycles_match_jax_with_n64_checkpoint():
    """1 and 5 learned V-cycles with the trained n = 64 checkpoint."""
    jh, th = _hiers(64)
    jp, tp = _both(*_npz_params(N64))
    rng = np.random.default_rng(4)
    u = rng.standard_normal((2, 65, 65)).astype(np.float32)
    f = rng.standard_normal((2, 65, 65)).astype(np.float32)
    jcycle = jax.jit(lambda u, f: ji.learned_v_cycle(jh, jp, u, f))
    ju, tu = jnp.asarray(u), torch.from_numpy(u)
    with torch.no_grad():
        for i in range(5):
            ju = jcycle(ju, jnp.asarray(f))
            tu = intergrid.learned_v_cycle(th, tp, tu, torch.from_numpy(f))
            if i == 0:
                assert _rel(tu, ju) < 1e-5
    assert _rel(tu, ju) < 1e-4


def test_learned_cycle_at_init_converges():
    """tests/test_intergrid.py's anchor on the port: 20 cycles at init on
    f = mass(1) fall below 1e-5 with a mid-decay ratio below 0.8."""
    _, th = _hiers(32)
    params = intergrid.IntergridParams.init(device="cpu")
    f = stencil.apply_mass(torch.ones((1, 33, 33)), th.finest.h)
    u, hist = torch.zeros_like(f), []
    with torch.no_grad():
        for _ in range(20):
            u = intergrid.learned_v_cycle(th, params, u, f)
            hist.append(float(torch.linalg.norm((f - th.finest.apply(u))[0, 1:-1, 1:-1])))
    assert hist[-1] < 1e-5 and hist[9] / hist[8] < 0.8


# ---- q_m, its gradient and the train steps -------------------------------
#
# The JAX train steps draw their starts inside one jitted step; each test
# below makes the same draws from the JAX state's key as the step makes them
# (one split per step, or one key per size), feeds them to the port's
# objective, and holds its loss and gradient against jax.value_and_grad of
# the JAX step's loss function, run eagerly: XLA's fusion of the jitted
# function alone moves the gradient by up to 4e-4.  The tests share the
# batch of 2 on the 16^2 (3 levels) and 8^2 (2 levels) interface
# hierarchies, so that JAX compiles each eager operation once.  Then each
# checks that the port's step computes that objective on the start its own
# generator draws.


def _jax_objective(jh, f, v0, m, m0):
    """The loss_fn of the JAX package's train steps, on a given start."""

    def loss_fn(params):
        u = u_m0 = v0
        for i in range(m - 1):
            u = jax.lax.stop_gradient(ji.learned_v_cycle(jh, params, u, f))
            if i == m0 - 1:
                u_m0 = u
        return ji.qm_loss(jh, ji.learned_v_cycle(jh, params, u, f), u_m0, f, m, m0)

    return loss_fn


def _check(loss_fn, jparams, tparams, port_loss):
    """Port loss and gradient in conv, deconv and w against JAX's."""
    jloss, jgrad = jax.value_and_grad(loss_fn)(jparams)
    port_loss.backward()
    assert abs(float(port_loss.detach()) / float(jloss) - 1) < 1e-4
    for k in ("conv", "deconv", "w"):
        assert _rel(getattr(tparams, k).grad, getattr(jgrad, k)) < 1e-4, k


def _t(x):
    return torch.from_numpy(np.array(x))


def _replay(state):
    """A copy of the state's generator, to replay the step's draws."""
    return torch.Generator().set_state(state.generator.get_state())


def test_qm_objective_and_gradient_match_jax():
    """q_m of m = 6 cycles (m0 = 2) from a given start with random non-init
    params."""
    jh, th = _hiers(16, True, 3)
    jp, tp = _both(*_random_params(16, 5))
    F, v0 = rng_fields(6, (2, 17, 17)), rng_fields(7, (2, 17, 17))
    jf = jst.apply_mass(jnp.asarray(F), jh.finest.h)
    tf = stencil.apply_mass(_t(F), th.finest.h)
    _check(_jax_objective(jh, jf, jnp.asarray(v0), 6, 2), jp, tp,
           ti.qm_objective(th, tp, tf, _t(v0), 6, 2))


def test_adam_update_matches_optax():
    """Two updates of conv, deconv and w with the same gradients."""
    rng = np.random.default_rng(7)
    conv, deconv, w = _random_params(16, 8)
    jp, tp = _both(conv, deconv, w)
    state = ti.init_state(device="cpu", params=tp)
    tx = optax.adam(1e-3)
    js = tx.init(jp)
    for _ in range(2):
        g = {k: rng.standard_normal(getattr(tp, k).shape).astype(np.float32)
             for k in ("conv", "deconv", "w")}
        upd, js = tx.update(ji.IntergridParams(**{k: jnp.asarray(v) for k, v in g.items()}),
                            js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in g.items():
            getattr(tp, k).grad = torch.from_numpy(v)
        state.optimizer.step()
    for k in ("conv", "deconv", "w"):
        np.testing.assert_allclose(getattr(tp, k).detach().numpy(), np.asarray(getattr(jp, k)),
                                   rtol=1e-6, atol=1e-7)


def test_train_step_loss_and_gradient_match_jax():
    """train_step's q_m (f = mass(F), random constant-scaled start)."""
    jh, th = _hiers(16, True, 3)
    F = rng_fields(9, (2, 17, 17))
    _, k_v = jax.random.split(jti.init_state(0).key)
    v0 = jti.random_constant_field(k_v, F.shape, jnp.float32)
    jf = jst.apply_mass(jnp.asarray(F), jh.finest.h)
    tf = stencil.apply_mass(_t(F), th.finest.h)
    tp = intergrid.IntergridParams.init(device="cpu")
    _check(_jax_objective(jh, jf, v0, 4, 2), ji.IntergridParams.init(), tp,
           ti.qm_objective(th, tp, tf, _t(v0), 4, 2))
    state = ti.init_state(3, device="cpu")
    start = ti.random_constant_field(_replay(state), F.shape, tf)
    want = ti.qm_objective(th, intergrid.IntergridParams.init(device="cpu"), tf, start, 4, 2)
    _, got = ti.train_step(th, state, _t(F), m=4, m0=2)
    assert float(got) == pytest.approx(float(want.detach()), rel=1e-6)


def test_error_decay_step_matches_jax():
    """train_step_error_decay's q_m (f = 0, standard normal start)."""
    jh, th = _hiers(16, True, 3)
    shape = (2, 17, 17)
    _, k_v = jax.random.split(jti.init_state(1).key)
    v0 = jax.random.normal(k_v, shape, jnp.float32)
    tp = intergrid.IntergridParams.init(device="cpu")
    _check(_jax_objective(jh, jnp.zeros(shape, jnp.float32), v0, 4, 2),
           ji.IntergridParams.init(), tp, ti.qm_objective(th, tp, torch.zeros(shape), _t(v0), 4, 2))
    state = ti.init_state(2, device="cpu")
    start = torch.randn(shape, generator=_replay(state))
    want = ti.qm_objective(th, intergrid.IntergridParams.init(device="cpu"), torch.zeros(shape),
                           start, 4, 2)
    _, got = ti.train_step_error_decay(th, state, shape, m=4, m0=2)
    assert float(got) == pytest.approx(float(want.detach()), rel=1e-6)


@pytest.mark.parametrize("protocol", ["decay", "rhs"])
def test_multisize_steps_match_jax(protocol):
    """train_step_decay_multisize and train_step_rhs_multisize at sizes 8
    and 16: the mean q_m over the sizes."""
    pairs = [_hiers(8, True, 2), _hiers(16, True, 3)]
    jhs, ths = tuple(p[0] for p in pairs), tuple(p[1] for p in pairs)
    shapes = ((2, 9, 9), (2, 17, 17))
    Fs = [rng_fields(10 + i, s) for i, s in enumerate(shapes)]
    ks = jax.random.split(jti.init_state(4).key, len(shapes) + 1)[1:]
    if protocol == "decay":
        v0s = [jax.random.normal(k, s, jnp.float32) for k, s in zip(ks, shapes)]
        jfs = [jnp.zeros(s, jnp.float32) for s in shapes]
    else:
        v0s = [jti.random_constant_field(k, s, jnp.float32) for k, s in zip(ks, shapes)]
        jfs = [jst.apply_mass(jnp.asarray(F), jh.finest.h) for F, jh in zip(Fs, jhs)]

    def jloss(p):
        return sum(_jax_objective(jh, f, v, 4, 2)(p) for jh, f, v in zip(jhs, jfs, v0s)) / 2

    tp = intergrid.IntergridParams.init(device="cpu")
    tfs = [_t(f) for f in jfs]
    _check(jloss, ji.IntergridParams.init(), tp,
           ti.multisize_objective(ths, tp, tfs, [_t(v) for v in v0s], 4, 2))
    state = ti.init_state(5, device="cpu")
    gen = _replay(state)
    if protocol == "decay":
        starts = [torch.randn(s, generator=gen) for s in shapes]
        _, got = ti.train_step_decay_multisize(ths, state, shapes=shapes, m=4, m0=2)
    else:
        starts = [ti.random_constant_field(gen, s, f) for s, f in zip(shapes, tfs)]
        _, got = ti.train_step_rhs_multisize(ths, state, [_t(F) for F in Fs], shapes=shapes,
                                             m=4, m0=2)
    want = ti.multisize_objective(ths, intergrid.IntergridParams.init(device="cpu"), tfs, starts,
                                  4, 2)
    assert float(got) == pytest.approx(float(want.detach()), rel=1e-6)


def test_grad_mask_and_curriculum_step():
    """_grad_mask as JAX's; a train_kernel = 3 step moves channel 3 of conv
    and deconv only and never w; train_deconv=False freezes deconv;
    train_w=True moves w; every Adam slot advances, masked ones included
    (their gradients are zeros, not None)."""
    jm = jti._grad_mask(ji.IntergridParams.init(), 3)
    tm = ti._grad_mask(intergrid.IntergridParams.init(device="cpu"), 3)
    for k in ("conv", "deconv", "w"):
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(getattr(jm, k)))
    full = ti._grad_mask(intergrid.IntergridParams.init(device="cpu"), None)
    assert float(full["conv"].sum()) == 144.0 and float(full["w"].sum()) == 0.0
    _, th = _hiers(16, True, 3)
    F = _t(rng_fields(11, (4, 17, 17)))
    init = intergrid.IntergridParams.init(device="cpu")
    every = list(range(16))
    for kw, moved in (({"train_kernel": 3}, {"conv": [3], "deconv": [3]}),
                      ({"train_deconv": False}, {"conv": every}),
                      ({"train_w": True}, {"conv": every, "deconv": every, "w": [0, 1]})):
        state = ti.init_state(0, device="cpu")
        state, _ = ti.train_step(th, state, F, m=4, m0=2, **kw)
        for k in ("conv", "deconv", "w"):
            diff = (getattr(state.params, k) - getattr(init, k)).detach().abs()
            changed = {i for i in range(diff.shape[0]) if float(diff[i].max()) > 0}
            want = set(moved.get(k, []))
            # a channel whose pattern no level holds gets no gradient
            assert changed <= want and (changed or not want), (kw, k, changed)
        assert all(len(state.optimizer.state[p]) == 3 for p in state.params.parameters())


def test_two_grid_training_matches_jax_and_reduces_qm():
    """tests/test_intergrid.py's two-grid anchor (n = 16 interface, 2
    levels, 12 RHS, 30 Adam steps on q_m): the JAX step's own RHS and
    starts, replayed from its keys, through the port's objective and
    update give the JAX step's losses, and the mean of the last 5 is below
    the mean of the first 5."""
    from multigrid_feanet_tpu.data import rhs as jrhs

    jh, th = _hiers(16, True, 2)
    F = jrhs.make_dataset(jax.random.PRNGKey(0), 17, 12).astype(jnp.float32)
    jstate, key = jti.init_state(0), jti.init_state(0).key
    state = ti.init_state(0, device="cpu")
    f = stencil.apply_mass(_t(F), th.finest.h)
    jlosses, losses = [], []
    for _ in range(30):
        jstate, jl = jti.train_step(jh, jstate, F, m=6, m0=2)
        key, k_v = jax.random.split(key)
        v0 = _t(jti.random_constant_field(k_v, F.shape, jnp.float32))
        loss = ti.qm_objective(th, state.params, f, v0, 6, 2)
        state = ti._update(state, loss, ti._grad_mask(state.params, None), 1e-3)
        jlosses.append(float(jl))
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses

def test_train_resume_equals_straight_run(tmp_path):
    _, th = _hiers(16, True, 3)
    ds = rhs.make_dataset(17, 8, seed=1).numpy()
    kw = dict(batch_size=4, seed=0, m=4, m0=2, verbose=False)
    p_full, l_full = ti.train(th, ds, num_epochs=4, **kw)
    ti.train(th, ds, num_epochs=2, ckpt_dir=tmp_path, **kw)
    p_res, l_res = ti.train(th, ds, num_epochs=4, ckpt_dir=tmp_path, **kw)
    assert len(l_full) == 4 and l_full[-1] != l_full[0]
    np.testing.assert_allclose(l_res, l_full, rtol=1e-6)
    for k in ("conv", "deconv", "w"):
        np.testing.assert_allclose(getattr(p_res, k).detach().numpy(),
                                   getattr(p_full, k).detach().numpy(), rtol=1e-6, atol=1e-8)
    # a homogeneous hierarchy trains 1-channel parameters
    _, th1 = _hiers(16, False, 3)
    p1, _ = ti.train(th1, ds[:4], num_epochs=1, **kw)
    assert p1.conv.shape == (1, 3, 3)


# ---- checkpoints ---------------------------------------------------------


def test_import_torch_checkpoint_matches_jax(tmp_path):
    """A reference-layout MultiGrid state_dict written here, read by both."""
    sd = {"conv.net.weight": torch.from_numpy(rng_fields(12, (1, 16, 3, 3))),
          "deconv.net.weight": torch.from_numpy(rng_fields(13, (16, 1, 3, 3))),
          "w": torch.tensor([4.0, 1.0])}
    path = str(tmp_path / "multigrid.pth")
    torch.save(sd, path)
    got = intergrid.import_torch_checkpoint(path, device="cpu")
    want = ji.import_torch_checkpoint(path)
    for k in ("conv", "deconv", "w"):
        np.testing.assert_array_equal(getattr(got, k).detach().numpy(),
                                      np.asarray(getattr(want, k)))
    del sd["w"]
    torch.save(sd, path)
    np.testing.assert_array_equal(intergrid.import_torch_checkpoint(path, device="cpu")
                                  .w.detach().numpy(), [4.0, 1.0])


@pytest.mark.parametrize("path", CHECKPOINTS)
def test_every_intergrid_checkpoint_loads(path):
    """Every inter-grid .npz of results/: plain keys as np.load reads them,
    the leaf form as the JAX package's checkpoint.load."""
    got = intergrid_params_from_npz(path, device="cpu")
    with np.load(path) as d:
        plain = "conv" in d.files
    if plain:
        want = dict(zip(("conv", "deconv", "w"), _npz_params(path)))
    else:
        jp = jckpt.load(path, like=ji.IntergridParams.init())
        want = {k: np.asarray(getattr(jp, k)) for k in ("conv", "deconv", "w")}
    for k in ("conv", "deconv", "w"):
        np.testing.assert_array_equal(getattr(got, k).detach().numpy(), want[k])


def test_converter_rejects_bad_shapes():
    conv = np.zeros((16, 3, 3), np.float32)
    with pytest.raises(ValueError):
        intergrid_params_from_arrays(conv, np.zeros((15, 3, 3)), device="cpu")
    with pytest.raises(ValueError):
        intergrid_params_from_arrays(conv, conv, np.zeros(3), device="cpu")
