"""The port's periodic multigrid (multigrid_feanet_torch/solvers/pbc_mg.py)
against the JAX package, on the CPU.

- The transfers agree with JAX's on a non-symmetric kernel, batched and 2-D,
  in f64 to 1e-12 (in f32 to 1e-6): the transposed convolution flips the
  kernel itself, and the one-row crop lands on fine index 0.
- One V-cycle and the analytic ``solve_pbc_mg`` (n = 32): in f64 the same
  cycles with the history to 1e-4 relative (it agrees to ~1e-11); in f32 on
  H1's plain version at the kernel levels, the same cycles with the
  history to 1e-2 (the last norms come out of a 4e4-fold cancellation).
- One ``pbc_train_step`` with JAX's initial kernel and JAX's u0 fed in:
  loss to 1e-5 relative, the Adam-updated kernel to 1e-6 absolute; 25 of
  the port's own steps do not raise the loss (test_pbc_mg.py's property).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.ops import pbc as jpbc
from multigrid_feanet_tpu.ops import stencil as jst
from multigrid_feanet_tpu.solvers import pbc_mg as jmg

from multigrid_feanet_torch.ops import pbc as tpbc
from multigrid_feanet_torch.ops import stencil as tst
from multigrid_feanet_torch.solvers import pbc_mg as tmg

# a non-symmetric 3x3 kernel (the learned restriction is not symmetric)
SKEW = np.array([[0.1, 0.7, 0.2], [0.4, 1.3, 0.9], [0.05, 0.6, 0.3]])


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("batched", [False, True], ids=["2d", "batched"])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_transfers_match_jax(batched, f64):
    rng = np.random.default_rng(0)
    shape = (3, 16, 16) if batched else (16, 16)
    dt_np = np.float64 if f64 else np.float32
    r = rng.standard_normal(shape).astype(dt_np)
    k = SKEW.astype(dt_np)
    tol = dict(rtol=1e-12, atol=1e-12) if f64 else dict(rtol=0, atol=1e-6)
    got = tmg.pbc_restrict(torch.from_numpy(r), k)
    want = jmg.pbc_restrict(jnp.asarray(r), jnp.asarray(k))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    v = r[..., :8, :8].copy()
    got = tmg.pbc_prolong(torch.from_numpy(v), k)
    want = jmg.pbc_prolong(jnp.asarray(v), jnp.asarray(k))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_bilinear_identities():
    """Restriction of a constant is 4 times it; the prolongation injects
    at even nodes and averages periodic neighbours elsewhere."""
    rc = tmg.pbc_restrict(torch.full((16, 16), 2.0), tmg.BILINEAR_4)
    assert rc.shape == (8, 8)
    np.testing.assert_allclose(rc.numpy(), 8.0, rtol=1e-6)
    v = np.random.default_rng(1).standard_normal((8, 8)).astype(np.float32)
    o = tmg.pbc_prolong(torch.from_numpy(v), tmg.BILINEAR_4).numpy()
    np.testing.assert_allclose(o[::2, ::2], v, atol=1e-6)
    np.testing.assert_allclose(o[1::2, ::2], 0.5 * (v + np.roll(v, -1, 0)), atol=1e-6)


def _analytic(n=32, f64=False):
    h = 2.0 / n
    x = np.linspace(-1.0, 1.0, n + 1, dtype=np.float32)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    rhs = (5.0 * np.sin(-4.0 * np.pi * (xx + 0.5)) * np.cos(3.0 * np.pi * yy)).astype(np.float32)
    jd, td = (jnp.float64, torch.float64) if f64 else (jnp.float32, torch.float32)
    jt = jst.make_homogeneous_stencil(dtype=jd)
    jf = jpbc.apply_mass_periodic(jpbc.from_wrapped(jnp.asarray(rhs, jd)), h)
    tt = tst.make_homogeneous_stencil(dtype=td, device="cpu")
    tf = tpbc.apply_mass_periodic(tpbc.from_wrapped(torch.tensor(rhs, dtype=td)), h)
    return (jt, jf), (tt, tf)


def test_v_cycle_matches_jax():
    """One cycle from a random u with skewed R and P (f64), and with the
    default kernels on H1's plain version at levels n >= 8 (f32)."""
    (jt, jf), (tt, tf) = _analytic(f64=True)
    u = np.random.default_rng(2).standard_normal((32, 32))
    want = jmg.v_cycle_pbc(jt, jnp.asarray(u), jf, 4, jnp.asarray(SKEW), jnp.asarray(SKEW.T))
    got = tmg.v_cycle_pbc(tt, torch.from_numpy(u), tf, 4, SKEW, SKEW.T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)
    (jt, jf), (tt, tf) = _analytic()
    u32 = u.astype(np.float32)
    want = jmg.v_cycle_pbc(jt, jnp.asarray(u32), jf, 5)
    torus = tmg.torus_levels(32, 5, kernel_threshold=8, device="cpu")
    assert [t is None for t in torus] == [False, False, False, True, True]
    got = tmg.v_cycle_pbc(tt, torch.from_numpy(u32), tf, 5, torus=torus)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="omega"):  # H1 would relax with the level's omega
        tmg.v_cycle_pbc(tt, torch.from_numpy(u32), tf, 5, omega=0.8, torus=torus)


@pytest.mark.parametrize("f64", [False, True], ids=["f32_torus_levels", "f64_plain"])
def test_solve_pbc_mg_matches_jax(f64):
    (jt, jf), (tt, tf) = _analytic(f64=f64)
    uj, hj = jmg.solve_pbc_mg(jt, jf, eps=5e-6)
    ut, ht = tmg.solve_pbc_mg(tt, tf, eps=5e-6, kernel_threshold=None if f64 else 16,
                              device="cpu")
    assert len(ht) == len(hj) <= 10
    np.testing.assert_allclose(ht, np.asarray(hj), rtol=1e-4 if f64 else 1e-2)
    d = ut.numpy() - np.asarray(uj)
    assert np.abs(d - d.mean()).max() < 1e-5


def _train_data(n=16, N=4):
    rng = np.random.default_rng(3)
    F = rng.standard_normal((N, n, n)).astype(np.float32)
    return F - (2.0 / n) ** 2 * F.sum(axis=(-2, -1), keepdims=True)  # compatibility shift


def test_train_step_matches_jax():
    table_j = jst.make_homogeneous_stencil(dtype=jnp.float32)
    F = _train_data()
    js = jmg.init_pbc_state(seed=0)
    r0 = np.asarray(js.r_kernel)
    _, k_u = jax.random.split(js.key)
    u0 = np.array(jax.random.normal(k_u, F.shape, jnp.float32))
    js, jloss = jmg.pbc_train_step(table_j, js, jnp.asarray(F), num_levels=3)
    rk = torch.tensor(r0, requires_grad=True)
    ts = tmg.PBCTrainState(rk, torch.optim.Adam([rk], lr=1e-3), torch.Generator())
    ts, tloss = tmg.pbc_train_step(tst.make_homogeneous_stencil(device="cpu"), ts, F, num_levels=3,
                                   u0=torch.from_numpy(u0))
    np.testing.assert_allclose(tloss, float(jloss), rtol=1e-5)
    np.testing.assert_allclose(ts.r_kernel.detach().numpy(), np.asarray(js.r_kernel),
                               rtol=0, atol=1e-6)


def test_training_does_not_raise_loss():
    table = tst.make_homogeneous_stencil(device="cpu")
    F = _train_data(N=8)
    state = tmg.init_pbc_state(seed=0, device="cpu")
    losses = []
    for _ in range(25):
        state, loss = tmg.pbc_train_step(table, state, F, num_levels=3)
        losses.append(loss)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) <= np.mean(losses[:5]) + 1e-3, losses
