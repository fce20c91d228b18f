"""The port's periodic operators and Jacobi solve (multigrid_feanet_torch/ops/pbc.py)
and the plain version of kernel H1 (ops/torus.py) against the JAX package,
on the CPU.

- Every function of ops/pbc.py agrees with its JAX twin in f64 to 1e-12.
- The reference's analytic problem (tests/test_pbc.py) takes exactly 46
  sweeps with its history head to 1e-4, with plain ``jacobi_step_pbc``
  steps and through ``solve_jacobi_pbc`` (whose sweeps are a ``TorusLevel``'s);
  in f64 the history agrees with JAX's to 1e-5 relative.  In
  f32 the last norms (5e-6 of an initial 0.27) come out of a 5e4-fold
  cancellation, so the two frameworks' f32 histories agree to 1e-2 there.
- H1's plain version against ``PallasTorusLevel`` in interpret mode (the
  bands of tests/test_pallas_torus.py: u to 3e-6 absolute, rsq to 1e-6
  relative, three chained sweeps to 1e-5) and against ``jacobi_step_pbc``
  at n = 2, 32 and 96; rsq + rsq_wrap is the wrapped norm^2 to 1e-6.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.ops import pbc as jpbc
from multigrid_feanet_tpu.ops import stencil as jst
from multigrid_feanet_tpu.ops.pallas_torus import PallasTorusLevel

from multigrid_feanet_torch.ops import pbc as tpbc
from multigrid_feanet_torch.ops import stencil as tst
from multigrid_feanet_torch.ops import torus as ttorus
from multigrid_feanet_torch.ops.torus import TorusLevel
from multigrid_feanet_torch.solvers.pbc_mg import solve_pbc_mg

REF_HEAD = [0.21556054, 0.16937497, 0.13308503, 0.10457049, 0.08216543]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _analytic(f64=False):
    """The reference's n = 32 problem: rhs = 5 sin(-4 pi (x + 1/2))
    cos(3 pi y), mass-convolved on the torus; (JAX table, f), (port
    table, f)."""
    n = 32
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


def test_functions_match_jax():
    """Wrap views, periodic applies, the compatibility shift, the wrapped
    norm and one Jacobi step, on a batch of f64 fields."""
    rng = np.random.default_rng(0)
    n, h = 16, 2.0 / 16
    u = rng.standard_normal((3, n, n))
    f = rng.standard_normal((3, n, n))
    jt = jst.make_homogeneous_stencil(dtype=jnp.float64)
    tt = tst.make_homogeneous_stencil(dtype=torch.float64, device="cpu")
    ju, jf, tu, tf = jnp.asarray(u), jnp.asarray(f), torch.from_numpy(u), torch.from_numpy(f)
    pairs = [
        (tpbc.to_wrapped(tu), jpbc.to_wrapped(ju)),
        (tpbc.from_wrapped(tpbc.to_wrapped(tu)), ju),
        (tpbc.apply_stencil_periodic(tt, tu[0]), jpbc.apply_stencil_periodic(jt, ju[0])),
        (tpbc.apply_mass_periodic(tf, h), jpbc.apply_mass_periodic(jf, h)),
        (tpbc.compatibility_shift(tf, h), jpbc.compatibility_shift(jf, h)),
        (tpbc.pbc_interior_norm(tf), jpbc.pbc_interior_norm(jf)),
        (tpbc.jacobi_step_pbc(tt, tu[1], tf[1]), jpbc.jacobi_step_pbc(jt, ju[1], jf[1])),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    w = tpbc.to_wrapped(tu[0])
    assert w.shape == (n + 1, n + 1)
    torch.testing.assert_close(w[-1], w[0], rtol=0, atol=0)
    torch.testing.assert_close(w[:, -1], w[:, 0], rtol=0, atol=0)


def test_constant_in_nullspace():
    c = torch.full((16, 16), 3.25)
    out = tpbc.apply_stencil_periodic(tst.make_homogeneous_stencil(device="cpu"), c)
    np.testing.assert_allclose(out.numpy(), 0.0, atol=1e-5)


def _step_history(table, f, eps, max_iters):
    """The history convention spelt out with plain ``jacobi_step_pbc``
    steps: the wrapped norm after each sweep, up to the first ``<= eps``."""
    u, hist = torch.zeros_like(f), []
    while len(hist) < max_iters and not (hist and hist[-1] <= eps):
        u = tpbc.jacobi_step_pbc(table, u, f)
        hist.append(float(tpbc.pbc_interior_norm(f - tpbc.apply_stencil_periodic(table, u))))
    return u, np.asarray(hist)


@pytest.mark.parametrize("on_level", [False, True], ids=["plain", "torus_level"])
def test_analytic_jacobi_history_f32(on_level):
    """46 sweeps to 5e-6 with the reference's history head and r0: with
    plain ``jacobi_step_pbc`` steps, and through ``solve_jacobi_pbc``, whose
    sweeps and norms are those of a ``TorusLevel`` (H1's plain version)."""
    (jt, jf), (tt, tf) = _analytic()
    _, hj = jpbc.solve_jacobi_pbc(jt, jf, eps=5e-6, max_iters=2000)
    if on_level:
        u, ht = tpbc.solve_jacobi_pbc(tt, tf, eps=5e-6, max_iters=2000, device="cpu")
    else:
        u, ht = _step_history(tt, tf, 5e-6, 2000)
    assert len(ht) == len(hj) == 46
    np.testing.assert_allclose(ht[:5], REF_HEAD, rtol=1e-4)
    np.testing.assert_allclose(float(tpbc.pbc_interior_norm(tf)), 0.27434009, rtol=1e-4)
    np.testing.assert_allclose(ht, hj, rtol=1e-2)
    assert u.shape == (32, 32) and u.dtype == torch.float32


def test_analytic_jacobi_history_f64():
    """In f64 the port's history is JAX's to 1e-5 relative, sweep for
    sweep, and the returned u (the end of the 256-sweep chunk) too."""
    (jt, jf), (tt, tf) = _analytic(f64=True)
    uj, hj = jpbc.solve_jacobi_pbc(jt, jf, eps=5e-6, max_iters=2000)
    ut, ht = tpbc.solve_jacobi_pbc(tt, tf, eps=5e-6, max_iters=2000, device="cpu")
    assert ut.dtype == torch.float64 and len(ht) == len(hj)
    np.testing.assert_allclose(ht, np.asarray(hj), rtol=1e-5)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-5, atol=1e-9)


def test_jacobi_chunks_and_caps():
    """The history does not depend on the chunk; ``u`` is the end of the
    chunk that met eps; eps=None runs max_iters sweeps; ``u`` after 3 and
    50 sweeps (in chunks of 20) is that of as many ``jacobi_step_pbc``
    steps."""
    (_, _), (tt, tf) = _analytic()

    def solve(**kw):
        return tpbc.solve_jacobi_pbc(tt, tf, device="cpu", **kw)

    u256, h256 = solve(eps=5e-6, max_iters=2000)
    u10, h10 = solve(eps=5e-6, max_iters=2000, chunk=10)
    np.testing.assert_allclose(h10, h256, rtol=1e-6)
    _, h50 = solve(eps=5e-6, max_iters=2000, chunk=50)
    u50, _ = solve(eps=None, max_iters=50)
    ul, hl = solve(eps=None, max_iters=50, chunk=20)
    assert len(hl) == 50
    np.testing.assert_allclose(ul.numpy(), u50.numpy(), atol=1e-6)
    want = tf * 0
    for j in range(50):
        want = tpbc.jacobi_step_pbc(tt, want, tf)
        if j == 2:
            u3, _ = solve(eps=None, max_iters=3)
            np.testing.assert_allclose(u3.numpy(), want.numpy(), atol=1e-7)
    np.testing.assert_allclose(ul.numpy(), want.numpy(), atol=1e-6)
    assert len(h50) == 46


def _rand(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)).astype(np.float32),
            rng.standard_normal((n, n)).astype(np.float32))


@pytest.mark.parametrize("on_level", [False, True], ids=["plain", "torus_level"])
def test_torus_sweep_matches_pallas_torus(on_level):
    """H1's plain version against the TPU kernel in interpret mode."""
    n = 128
    u, f = _rand(n, 0)
    jl = PallasTorusLevel(n, rows=32, interpret=True)
    tl = TorusLevel(n, device="cpu")

    def sweep(x, y):
        if on_level:
            return tl.sweep(x, y)
        return ttorus.torus_sweep_plain(x, y, a0=1.0, omega=2.0 / 3.0)

    tu, tf = torch.from_numpy(u), torch.from_numpy(f)
    got, rsq, _ = sweep(tu, tf)
    want, rsq_w = jl.sweep(jl.pad(jnp.asarray(u)), jl.pad(jnp.asarray(f)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jl.unpad(want)), rtol=0, atol=3e-6)
    np.testing.assert_allclose(float(rsq), float(rsq_w), rtol=1e-6)
    ub, fb, sp = jl.pad(jnp.asarray(u)), jl.pad(jnp.asarray(f)), jl.zeros()
    x = tu
    for _ in range(3):
        ub, _ = jl.sweep(ub, fb, dst=sp)
        x = sweep(x, tf)[0]
    np.testing.assert_allclose(x.numpy(), np.asarray(jl.unpad(ub)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [2, 32, 96])
def test_torus_sweep_matches_jacobi_step_and_wrapped_norm(n):
    """Against jacobi_step_pbc (n = 96 is no multiple of 128; at n = 2 both
    neighbours along an axis are one node); rsq is the unique norm^2 and
    rsq + rsq_wrap the wrapped one."""
    u, f = _rand(n, n)
    jt = jst.make_homogeneous_stencil(dtype=jnp.float32)
    got, rsq, rsq_wrap = ttorus.torus_sweep_plain(torch.from_numpy(u), torch.from_numpy(f),
                                                  a0=1.0, omega=2.0 / 3.0)
    want = jpbc.jacobi_step_pbc(jt, jnp.asarray(u), jnp.asarray(f))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=3e-6)
    r = jnp.asarray(f) - jpbc.apply_stencil_periodic(jt, jnp.asarray(u))
    np.testing.assert_allclose(float(rsq), float(jnp.sum(r * r)), rtol=1e-6)
    np.testing.assert_allclose(float(rsq) + float(rsq_wrap),
                               float(jpbc.pbc_interior_norm(r)) ** 2, rtol=1e-6)


def test_wrapped_norm_identity():
    """pbc_interior_norm^2 = unique sum + row 0 + column 0 + the corner."""
    r = torch.from_numpy(np.random.default_rng(4).standard_normal((24, 24)))
    want = (r * r).sum() + (r[0] ** 2).sum() + (r[:, 0] ** 2).sum() + r[0, 0] ** 2
    torch.testing.assert_close(tpbc.pbc_interior_norm(r) ** 2, want, rtol=1e-14, atol=0)


def test_kernel_paths_refuse_what_they_cannot_run():
    u = torch.zeros(16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ttorus.torus_sweep_cuda(u, u, a0=1.0, omega=2.0 / 3.0)
    tt = tst.make_homogeneous_stencil(device="cpu")
    with pytest.raises(ValueError, match="homogeneous"):
        tpbc.homogeneous_a0(torch.ones(3, 3))
    assert tpbc.homogeneous_a0(2.0 * tt) == pytest.approx(2.0, rel=1e-6)
    with pytest.raises(ValueError, match="homogeneous"):
        tpbc.solve_jacobi_pbc(torch.ones(3, 3), u, device="cpu")
    if not torch.cuda.is_available():  # device=None means CUDA
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpbc.solve_jacobi_pbc(tt, u)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solve_pbc_mg(tt, u)
