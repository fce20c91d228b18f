"""The port's elastic learned iterator (multigrid_feanet_torch/models/
hnet.py's elastic H-Net, learn/train_hnet.py's elastic training and
data/datasets.py's elastic dataset) against the JAX package's, on the CPU.

Inputs are made with numpy (or, for a JAX step's own draws, with
jax.random from its state's key) and fed to both sides.  Tolerances:
convolutions and sweeps 1e-5 relative, the loss and its gradient 1e-4
relative, optimizer updates 1e-6, the oracle's solutions 1e-6.  Training
itself draws from the port's torch.Generator, so its losses are held to the
JAX test's anchor (tests/test_hnet_elastic.py), not to JAX's numbers.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.data import fem as jfem
from multigrid_feanet_tpu.learn import train_hnet as jth
from multigrid_feanet_tpu.models import hnet as jhnet
from multigrid_feanet_tpu.ops import stencil as jst
from multigrid_feanet_tpu.solvers import elastic as jel

from multigrid_feanet_torch.core.convert import hnet_elastic_params_from_arrays
from multigrid_feanet_torch.data import datasets
from multigrid_feanet_torch.learn import train_hnet as th
from multigrid_feanet_torch.models import hnet
from multigrid_feanet_torch.ops import elasticity as el
from multigrid_feanet_torch.ops import stencil
from multigrid_feanet_torch.solvers import elastic

CIRCLE = ("circle", (0.0, 0.0), 0.5)


def _rel(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want))) / max(1e-30, float(np.max(np.abs(want))))


def _levels(n, bim):
    kw = dict(E=1.0, nu=0.3, inclusion=CIRCLE if bim else None,
              coefficients=(1.0, 20.0) if bim else (1.0, 1.0), num_levels=1)
    return (jel.build_elastic_hierarchy(n, **kw)[0],
            elastic.build_elastic_hierarchy(n, device="cpu", **kw)[0])


def _fields(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _params(seed, L=3):
    return (np.random.default_rng(seed).uniform(-1, 1, (L, 2, 2, 3, 3)) / np.sqrt(18.0)
            ).astype(np.float32)


def test_conv3x3_mc_and_apply_hnet_elastic_match_jax():
    x, geo = _fields(0, (3, 2, 9, 11), (9, 11))
    geo = (geo > 0).astype(np.float32)
    k = _params(1)
    for xx in (x, x[0]):
        got = hnet.conv3x3_mc(torch.from_numpy(xx), torch.from_numpy(k[0]))
        assert got.shape == xx.shape
        assert _rel(got, jhnet.conv3x3_mc(jnp.asarray(xx), jnp.asarray(k[0]))) < 1e-5
    got = hnet.apply_hnet_elastic(torch.from_numpy(k), torch.from_numpy(x), torch.from_numpy(geo))
    want = jhnet.apply_hnet_elastic(jnp.asarray(k), jnp.asarray(x), jnp.asarray(geo))
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
def test_h_relax_elastic_matches_jax(bim):
    """3 H-corrected block-Jacobi sweeps at n = 16, a batch of 2."""
    jl, tl = _levels(16, bim)
    u, f = _fields(2, (2, 2, 17, 17), (2, 2, 17, 17))
    k = _params(3)
    got = hnet.h_relax_elastic(tl, torch.from_numpy(k), torch.from_numpy(u),
                               torch.from_numpy(f), 3)
    want = jhnet.h_relax_elastic(jl, jnp.asarray(k), jnp.asarray(u), jnp.asarray(f), 3)
    assert _rel(got, want) < 1e-5


def test_zero_params_equal_block_jacobi():
    _, tl = _levels(16, True)
    u, f = _fields(4, (2, 17, 17), (2, 17, 17))
    u_h = hnet.h_relax_elastic(tl, torch.zeros((3, 2, 2, 3, 3)), torch.from_numpy(u),
                               torch.from_numpy(f), 3)
    u_j = elastic.relax(tl, torch.from_numpy(u), torch.from_numpy(f), 3)
    np.testing.assert_allclose(u_h.numpy(), u_j.numpy(), atol=1e-6)


def test_dynamic_matches_static():
    _, tl = _levels(16, False)
    u, f = _fields(5, (2, 17, 17), (2, 17, 17))
    k = torch.from_numpy(_params(6))
    for n_sweeps in (1, 3, 5, 7):
        a = hnet.h_relax_elastic(tl, k, torch.from_numpy(u), torch.from_numpy(f),
                                 min(n_sweeps, 5))
        b = hnet.h_relax_elastic_dynamic(tl, k, torch.from_numpy(u), torch.from_numpy(f),
                                         n_sweeps, 5)
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_init_params_elastic_range_and_converter():
    gen = torch.Generator().manual_seed(0)
    p = hnet.init_params_elastic(3, generator=gen)
    assert p.shape == (3, 2, 2, 3, 3) and float(p.abs().max()) <= 1 / np.sqrt(18.0)
    q = hnet_elastic_params_from_arrays(p.numpy(), device="cpu")
    assert q.dtype == torch.float32 and q.is_contiguous()
    with pytest.raises(ValueError):
        hnet_elastic_params_from_arrays(np.zeros((3, 3, 3)), device="cpu")


def test_train_step_elastic_loss_and_gradient_match_jax():
    """train_step_elastic on the JAX step's own draws (k and u0 from its key
    split): the JAX step's loss, and the gradient of jax.value_and_grad of
    its loss function; the port's step computes elastic_loss on the draws
    its own generator makes.  Homogeneous: under the tests' x64 mode the
    JAX bi-material apply returns float64, which its training scan refuses
    (the static sweeps above hold the bi-material level)."""
    jl, tl = _levels(16, False)
    u_star, f = _fields(7, (2, 2, 17, 17), (2, 2, 17, 17))
    k_max = 4
    params = jhnet.init_params_elastic(jax.random.PRNGKey(0))
    jstate = jth.TrainState(params, jth.make_optimizer().init(params), jax.random.PRNGKey(1))
    _, k_k, k_u = jax.random.split(jstate.key, 3)
    k = int(jax.random.randint(k_k, (), 1, k_max + 1))
    u0 = jax.random.normal(k_u, u_star.shape, jnp.float32)
    _, jloss_step = jth.train_step_elastic(jl, jstate, jnp.asarray(u_star), jnp.asarray(f),
                                           k_max=k_max)

    def jloss_fn(p):
        ff = jst.apply_mass(jnp.asarray(f), jl.h)
        out = jhnet.h_relax_elastic_dynamic(jl, p, u0, ff, k, k_max)
        return jnp.sum((out - jnp.asarray(u_star)) ** 2)

    jloss, jgrad = jax.jit(jax.value_and_grad(jloss_fn))(params)
    assert float(jloss) == pytest.approx(float(jloss_step), rel=1e-6)
    tp = torch.tensor(np.asarray(params), requires_grad=True)
    loss = th.elastic_loss(tl, tp, torch.from_numpy(u_star), torch.from_numpy(f),
                           torch.from_numpy(np.array(u0)), k, k_max)
    loss.backward()
    assert abs(float(loss.detach()) / float(jloss) - 1) < 1e-4
    assert _rel(tp.grad, jgrad) < 1e-4
    # the port's step, replayed from its generator
    p0 = np.array(params)
    state = th.init_state_elastic(tl, seed=2, params=p0)
    gen = torch.Generator().set_state(state.generator.get_state())
    k2 = int(torch.randint(1, k_max + 1, (), generator=gen))
    u02 = torch.randn(u_star.shape, generator=gen)
    with torch.no_grad():
        want = th.elastic_loss(tl, torch.from_numpy(p0), torch.from_numpy(u_star),
                               torch.from_numpy(f), u02, k2, k_max)
    _, got = th.train_step_elastic(tl, state, torch.from_numpy(u_star), torch.from_numpy(f),
                                   k_max=k_max)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_adadelta_update_matches_optax():
    """Two Adadelta updates of elastic kernels with the same gradients."""
    _, tl = _levels(8, False)
    p0 = _params(8)
    grads = [np.random.default_rng(9 + i).standard_normal(p0.shape).astype(np.float32)
             for i in range(2)]
    state = th.init_state_elastic(tl, params=p0)
    assert isinstance(state.optimizer, torch.optim.Adadelta)
    tx = jth.make_optimizer()
    jp = jnp.asarray(p0)
    js = tx.init(jp)
    import optax

    for g in grads:
        upd, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        state.params.grad = torch.from_numpy(g)
        state.optimizer.step()
    np.testing.assert_allclose(state.params.detach().numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)


def test_generate_elastic_matches_jax_oracle(tmp_path):
    """The dataset's solutions are the JAX package's dense oracle's on the
    same forces (homogeneous and bi-material), and the h5 files round-trip."""
    n = 8
    phase = (np.random.default_rng(10).uniform(size=(n, n)) < 0.3).astype(np.int8)
    for kw in ({}, dict(E=212e3, nu=0.288, phase=phase, coefficients=(1.0, 20.0))):
        ds = datasets.generate_elastic(n, 3, seed=4, **kw)
        assert ds.u.shape == ds.f.shape == (3, 2, n + 1, n + 1)
        for i in range(3):
            want = jfem.solve_dirichlet_elastic(n, ds.f[i].astype(np.float64), **kw)
            np.testing.assert_allclose(ds.u[i], want, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(want).max()))
    path = str(tmp_path / "elastic.h5")
    datasets.save_elastic(ds, path)
    back = datasets.load_elastic(path)
    np.testing.assert_array_equal(back.u, ds.u)
    np.testing.assert_array_equal(back.f, ds.f)
    assert len(back) == 3 and all(np.array_equal(a, b) for a, b in zip(back[1], ds[1]))


def _held_out(lv, params, seed=123):
    """Sweeps of block-Jacobi and of the H-corrected sweep to 1e-4 on a
    held-out problem from u = 0, and the H iterate's largest error against
    the oracle (tests/test_hnet_elastic.py's check)."""
    ds_test = datasets.generate_elastic(lv.n, num_samples=1, seed=seed)
    u_star = torch.from_numpy(ds_test.u[0])
    ff = stencil.apply_mass(torch.from_numpy(ds_test.f[0]), lv.h)

    def sweeps_to(eps, step):
        u = torch.zeros_like(u_star)
        for i in range(1, 3001):
            u = step(u)
            if float(el.elastic_interior_norm(ff - lv.apply(u))) <= eps:
                return i, u
        return 3001, u

    with torch.no_grad():
        n_jac, _ = sweeps_to(1e-4, lambda u: elastic.relax(lv, u, ff, 1))
        n_h, u = sweeps_to(1e-4, lambda u: hnet.h_relax_elastic(lv, params, u, ff, 1))
    return n_jac, n_h, float((u - u_star).abs().max())


def test_elastic_training_on_jax_draws_matches_jax_and_accelerates_jacobi():
    """tests/test_hnet_elastic.py's anchor: 12 epochs on the JAX package's
    generate_elastic(16, 10, seed=0) with the JAX run's own draws (its
    initial kernels, and k and u0 replayed from its keys) through the
    port's loss and Adadelta give the JAX run's losses, which fall by 10%;
    on a held-out problem the trained corrector reaches 1e-4 in fewer
    sweeps than block-Jacobi and ends within 5e-3 of the oracle."""
    from multigrid_feanet_tpu.data import datasets as jds

    n, k_max = 16, 4
    jl, lv = _levels(n, False)
    ds = jds.generate_elastic(n, num_samples=10, seed=0)
    _, jlosses = jth.train_elastic(jl, ds, num_epochs=12, batch_size=5, seed=0, k_max=k_max,
                                   verbose=False)
    kp, key = jax.random.split(jax.random.PRNGKey(0))
    state = th.init_state_elastic(lv, params=np.array(jhnet.init_params_elastic(kp)))
    losses = []
    for epoch in range(12):
        total = []
        for u_star, f in datasets.batches(datasets.ElasticDataset(u=ds.u, f=ds.f), 5,
                                          seed=epoch, device="cpu"):
            key, k_k, k_u = jax.random.split(key, 3)
            k = int(jax.random.randint(k_k, (), 1, k_max + 1))
            u0 = torch.from_numpy(np.array(jax.random.normal(k_u, u_star.shape, jnp.float32)))
            state.optimizer.zero_grad()
            loss = th.elastic_loss(lv, state.params, u_star, f, u0, k, k_max)
            loss.backward()
            state.optimizer.step()
            total.append(float(loss.detach()))
        losses.append(np.mean(total))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0] * 0.9, losses
    n_jac, n_h, err = _held_out(lv, state.params.detach())
    assert n_h < n_jac and err < 5e-3, (n_h, n_jac, err)


def test_elastic_training_on_port_draws_learns():
    """The same run on the port's own dataset and draws: its per-epoch
    losses are samples (random k and u0 per batch) and may rise, so the
    learning is read on a fixed evaluation, the loss of k = 1..4 sweeps on
    the training set from starts of a generator seeded 99, which falls by
    10%; and the held-out check holds."""
    n, k_max = 16, 4
    _, lv = _levels(n, False)
    ds = datasets.generate_elastic(n, num_samples=10, seed=0)
    params, losses = th.train_elastic(lv, ds, num_epochs=12, batch_size=5, seed=0,
                                      k_max=k_max, verbose=False)
    assert np.isfinite(losses).all()
    init = th.init_state_elastic(lv, seed=0).params.detach()
    before, after = (th.elastic_eval_loss(lv, p, ds, k_max) for p in (init, params))
    assert after < 0.9 * before, (before, after)
    n_jac, n_h, err = _held_out(lv, params)
    assert n_h < n_jac and err < 5e-3, (n_h, n_jac, err)


def test_train_elastic_resume_equals_straight_run(tmp_path):
    _, lv = _levels(8, False)
    ds = datasets.generate_elastic(8, 4, seed=1)
    kw = dict(batch_size=2, seed=0, k_max=3, verbose=False)
    p_full, l_full = th.train_elastic(lv, ds, num_epochs=4, **kw)
    th.train_elastic(lv, ds, num_epochs=2, ckpt_dir=tmp_path, **kw)
    p_res, l_res = th.train_elastic(lv, ds, num_epochs=4, ckpt_dir=tmp_path, **kw)
    np.testing.assert_allclose(l_res, l_full, rtol=1e-6)
    np.testing.assert_allclose(p_res.numpy(), p_full.numpy(), rtol=1e-6, atol=1e-8)
