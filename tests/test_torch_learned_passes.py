"""Kernels X5 and X6 (multigrid_feanet_torch/ops/passes.py), the learned
restriction and prolongation-add, and the kernel route of
models/intergrid.py::learned_v_cycle, against the JAX package on the CPU.

- X5's and X6's plain versions, the twins the CUDA kernels are held to on
  the card, against JAX's ``restrict_learned`` and ``u + prolong_learned``
  at n = 32, 64 and 128, batch 1 and 2: bi-material with 16 random
  channels, homogeneous with one, and 12 channels where some pattern ids
  have none.  Random per-channel weights catch a fine / coarse pattern-id
  mix-up, which equal channels hide.  1e-5 relative (the tolerance of
  tests/test_torch_intergrid.py's transfers).
- ``learned_v_cycle`` without gradient, which takes the kernel route on
  the CPU too (C1's plain residual with ``jacobi_step``'s weight, the plain
  X5 and X6), against the jitted JAX cycle: the init parameters and
  results/intergrid_trained_interface_n64.npz at 64^2, that checkpoint on 2
  levels at 128^2; 1 cycle at 1e-5, 5 at 1e-4 relative (XLA's fusion sums
  in another order); and against the eager JAX cycle bit for bit.
- What the route launches (counting wrappers: C1 one call a batch), the
  operands it hands C1 (in its batch layout), the rule that takes every
  batch and picks the form by grad mode, C1's sweep and residual against
  ``jacobi_step`` on a zero ring (1e-5), and the wrappers' refusals.

Inputs come from ``np.random.default_rng``.
"""

import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.core.problem import GridHierarchy as JHierarchy, Problem as JProblem
from multigrid_feanet_tpu.models import intergrid as ji

from multigrid_feanet_torch import _build
from multigrid_feanet_torch.core.convert import intergrid_params_from_arrays
from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
from multigrid_feanet_torch.models import intergrid
from multigrid_feanet_torch.ops import passes as px
from multigrid_feanet_torch.ops import stencil_sweep as ss
from multigrid_feanet_torch.ops import sweep as sw
from multigrid_feanet_torch.solvers.jacobi import jacobi_step

CIRCLE = ("circle", (0.0, 0.0), 0.5)
N64 = "results/intergrid_trained_interface_n64.npz"
TRANSFER_TOL, CYCLE_TOL, CYCLES_TOL = 1e-5, 1e-5, 1e-4
# (inclusion, channels): bi-material 16, homogeneous 1, bi-material 12 (ids
# 12-15 in no channel)
VARIANTS = {"bim16": (CIRCLE, 16), "hom1": (None, 1), "bim12": (CIRCLE, 12)}


def _rel(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want))) / max(1e-30, float(np.max(np.abs(want))))


def _hiers(n, inclusion, num_levels=None):
    return (JHierarchy.create(JProblem(n=n, inclusion=inclusion, dtype=jnp.float32), num_levels),
            GridHierarchy.create(Problem(n=n, inclusion=inclusion), num_levels, device="cpu"))


def _random_params(C, seed):
    rng = np.random.default_rng(seed)
    conv = (intergrid.FULL_WEIGHTING_16 + 0.1 * rng.standard_normal((C, 3, 3))).astype(np.float32)
    deconv = (intergrid.BILINEAR_4 + 0.1 * rng.standard_normal((C, 3, 3))).astype(np.float32)
    return conv, deconv, np.array([3.7, 1.1], np.float32)


def _both(conv, deconv, w):
    jp = ji.IntergridParams(conv=jnp.asarray(conv), deconv=jnp.asarray(deconv), w=jnp.asarray(w))
    return jp, intergrid_params_from_arrays(conv, deconv, w, device="cpu")


def _torch_cycle(th, tp, u, f, n_relax=1):
    """The torch path's cycle (the split and the convolutions), which
    learned_v_cycle takes where it takes no kernel route."""
    return intergrid._torch_cycle(th, tp, u, f, n_relax, intergrid.DEFAULT_OMEGA, 0)


def _npz(path):
    with np.load(path) as d:
        w = d["w"] if "w" in d.files else np.array([4.0, 1.0], np.float32)
        return d["conv"], d["deconv"], w


# ---- X5 and X6: the plain versions against JAX ---------------------------


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("n", [32, 64, 128])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_transfers_match_jax(variant, n, batch):
    inclusion, C = VARIANTS[variant]
    jh, th = _hiers(n, inclusion, 2)
    conv, deconv, w = _random_params(C, n + C)
    jp, tp = _both(conv, deconv, w)
    rng = np.random.default_rng(n + batch)
    r = rng.standard_normal((batch, n + 1, n + 1)).astype(np.float32)
    u = rng.standard_normal((batch, n + 1, n + 1)).astype(np.float32)
    v = rng.standard_normal((batch, n // 2 + 1, n // 2 + 1)).astype(np.float32)
    if C == 12:  # the ids no channel holds occur on both levels
        assert int(th.levels[0].pid.max()) >= C and int(th.levels[1].pid.max()) >= C
    got = px.learned_restrict_plain(torch.from_numpy(r), th.levels[0].pid, tp.conv, tp.w)
    want = ji.restrict_learned(jp, jnp.asarray(r), jh.levels[0].pid)
    assert got.shape == (batch, n // 2 + 1, n // 2 + 1)
    assert _rel(got, want) < TRANSFER_TOL
    got = px.learned_prolong_add_plain(torch.from_numpy(u), torch.from_numpy(v),
                                       th.levels[1].pid, tp.deconv, tp.w)
    want = jnp.asarray(u) + ji.prolong_learned(jp, jnp.asarray(v), jh.levels[1].pid)
    assert got.shape == (batch, n + 1, n + 1)
    assert _rel(got, want) < TRANSFER_TOL
    # bit for bit where XLA's partial sums are known (x5_chain): 16 channels and 1
    if C != 12:
        np.testing.assert_array_equal(px.learned_restrict_plain(
            torch.from_numpy(r), th.levels[0].pid, tp.conv, tp.w).detach().numpy(),
            np.asarray(ji.restrict_learned(jp, jnp.asarray(r), jh.levels[0].pid)))
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    # the dispatchers take the plain versions on the CPU, into strided outputs too
    out = intergrid._buffer(batch, n // 2 + 1, "cpu")
    px.learned_restrict(torch.from_numpy(r), th.levels[0].pid, tp.conv, tp.w, out=out)
    assert torch.equal(out, px.learned_restrict_plain(torch.from_numpy(r), th.levels[0].pid,
                                                      tp.conv, tp.w))


def test_pattern_ids_pick_fine_and_coarse_weights():
    """X5 weighs a residual by its FINE node's id, X6 a correction by its
    COARSE node's id: at a fine node of the interface whose id p differs
    from the id q of a coarse node it reaches, scaling channel p moves X5's
    output and not X6's, scaling channel q the other way round."""
    _, th = _hiers(32, CIRCLE, 2)
    pf, pc = th.levels[0].pid, th.levels[1].pid
    # fine node (y, x), odd, reaches coarse node ((y - 1) / 2, (x - 1) / 2)
    y, x = next((y, x) for y in range(3, 30, 2) for x in range(3, 30, 2)
                if int(pf[y, x]) != int(pc[(y - 1) // 2, (x - 1) // 2]))
    c, d = (y - 1) // 2, (x - 1) // 2
    p, q = int(pf[y, x]), int(pc[c, d])
    conv, deconv, w = _random_params(16, 5)
    r = torch.zeros((1, 33, 33))
    r[0, y, x] = 1.0
    v = torch.zeros((1, 17, 17))
    v[0, c, d] = 1.0
    u = torch.zeros((1, 33, 33))

    def transfers(ch):
        k, kd = conv.copy(), deconv.copy()
        k[ch] *= 2.0
        kd[ch] *= 2.0
        _, tp = _both(k, kd, w)
        with torch.no_grad():
            return (px.learned_restrict_plain(r, pf, tp.conv, tp.w),
                    px.learned_prolong_add_plain(u, v, pc, tp.deconv, tp.w))

    fc, e = transfers([])
    fc_p, e_p = transfers(p)
    fc_q, e_q = transfers(q)
    assert float(fc.abs().sum()) > 0 and int((e != 0).sum()) == 9
    assert torch.allclose(fc_p, 2.0 * fc) and torch.equal(e_p, e)
    assert torch.equal(fc_q, fc) and torch.allclose(e_q, 2.0 * e)


# ---- the kernel route against the jitted JAX cycle -----------------------

ROUTE_CASES = {"init_64": (64, None, CIRCLE, "init"), "n64_64": (64, None, CIRCLE, N64),
               "n64_128_2levels": (128, 2, CIRCLE, N64), "hom_init_64": (64, None, None, "init")}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_kernel_route_matches_jitted_jax(case):
    n, levels, inclusion, params = ROUTE_CASES[case]
    jh, th = _hiers(n, inclusion, levels)
    C = 16 if inclusion is not None else 1
    if params == "init":
        jp, tp = ji.IntergridParams.init(C), intergrid.IntergridParams.init(C, device="cpu")
    else:
        jp, tp = _both(*_npz(params))
    assert intergrid.kernel_levels(th) == list(range(th.num_levels - 1))
    rng = np.random.default_rng(n)
    u = rng.standard_normal((2, n + 1, n + 1)).astype(np.float32)  # a nonzero ring too
    f = rng.standard_normal((2, n + 1, n + 1)).astype(np.float32)
    jcycle = jax.jit(lambda u, f: ji.learned_v_cycle(jh, jp, u, f))
    ju, tu, tf = jnp.asarray(u), torch.from_numpy(u), torch.from_numpy(f)
    with torch.no_grad():
        for i in range(5):
            ju = jcycle(ju, jnp.asarray(f))
            tu = intergrid.learned_v_cycle(th, tp, tu, tf)
            assert tu.shape == (2, n + 1, n + 1) and tu.is_contiguous()
            if i == 0:
                assert _rel(tu, ju) < CYCLE_TOL
    assert _rel(tu, ju) < CYCLES_TOL


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("case", ["init_64", "n64_64", "hom_init_64"])
def test_kernel_route_is_the_eager_jax_cycle(case, batch):
    """On the CPU the route computes the JAX package's eager cycle op for
    op: three cycles from 0 equal it bit for bit (the growing mode of
    tests/test_torch_intergrid_robust.py amplifies any other rounding)."""
    n, levels, inclusion, params = ROUTE_CASES[case]
    jh, th = _hiers(n, inclusion, levels)
    C = 16 if inclusion is not None else 1
    if params == "init":
        jp, tp = ji.IntergridParams.init(C), intergrid.IntergridParams.init(C, device="cpu")
    else:
        jp, tp = _both(*_npz(params))
    f = np.random.default_rng(n + batch).standard_normal((batch, n + 1, n + 1)).astype(np.float32)
    ju, tu = jnp.zeros(f.shape, jnp.float32), torch.zeros(f.shape)
    with torch.no_grad():
        for _ in range(3):
            ju = ji.learned_v_cycle(jh, jp, ju, jnp.asarray(f))
            tu = intergrid.learned_v_cycle(th, tp, tu, torch.from_numpy(f))
            np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))


# ---- what the route runs --------------------------------------------------


def _counting(monkeypatch):
    """Count the route's C1 calls (on the card one launch a batch),
    checking that every operand is in C1's batch layout, and its X5 and X6
    calls."""
    calls = {"C1": 0, "X5": 0, "X6": 0}
    sweep, residual = intergrid._Route._sweep, intergrid._Route._residual
    restrict, prolong = px.learned_restrict, px.learned_prolong_add

    def c1(fn):
        def run(self, l, u, f, out):
            calls["C1"] += 1
            H = u.shape[-1]
            for name, t in (("u", u), ("f", f), ("out", out)):
                assert ss.check_batch(t, name, H, t.device) == u.shape[0]
            return fn(self, l, u, f, out)
        return run

    def x5(*a, **kw):
        calls["X5"] += 1
        return restrict(*a, **kw)

    def x6(*a, **kw):
        calls["X6"] += 1
        return prolong(*a, **kw)

    monkeypatch.setattr(intergrid._Route, "_sweep", c1(sweep))
    monkeypatch.setattr(intergrid._Route, "_residual", c1(residual))
    monkeypatch.setattr(px, "learned_restrict", x5)
    monkeypatch.setattr(px, "learned_prolong_add", x6)
    return calls


@pytest.mark.parametrize("n_relax", [1, 2])
def test_route_launches_per_kernel_level(monkeypatch, n_relax):
    """Per cycle on a batch of N: C1 2 n_relax + 1 times (a launch a
    batch) on each kernel level (64 ... 4 of 64 ... 2; the coarsest runs
    the torch path), X5 and X6 once each; every C1 operand in C1's batch
    layout although sample 1 of a compact 65^2 batch is off a 16-byte
    boundary."""
    _, th = _hiers(64, CIRCLE)
    assert intergrid.kernel_levels(th) == [0, 1, 2, 3, 4]
    tp = intergrid.IntergridParams.init(device="cpu")
    rng = np.random.default_rng(2)
    u, f = (torch.from_numpy(rng.standard_normal((3, 65, 65)).astype(np.float32))
            for _ in range(2))
    assert not intergrid._aligned(u)  # 65^2 * 4 bytes = 16900 = 4 mod 16
    calls = _counting(monkeypatch)
    with torch.no_grad():
        want = _torch_cycle(th, tp, u, f, n_relax)
        assert calls == {"C1": 0, "X5": 0, "X6": 0}
        got = intergrid.learned_v_cycle(th, tp, u, f, n_relax)
    assert calls == {"C1": 5 * (2 * n_relax + 1), "X5": 5, "X6": 5}
    assert _rel(got, want) < CYCLE_TOL


@pytest.mark.parametrize("batch", [1, 17, 64])
def test_route_takes_batches_up_to_its_limit(monkeypatch, batch):
    """C1 takes a whole batch in one launch, so every batch size takes the
    route: every kernel level runs C1 three times a cycle whatever the
    batch, X5 and X6 once, and the route's cycle
    of the batch is the torch path's, and each sample's its cycle alone (to
    the tolerance: on the CPU X5 rounds as XLA does, whose partial sums
    depend on the batch, x5_chain)."""
    _, th = _hiers(32, CIRCLE)
    tp = intergrid.IntergridParams.init(device="cpu")
    rng = np.random.default_rng(6)
    f = torch.from_numpy(rng.standard_normal((batch, 33, 33)).astype(np.float32))
    calls = _counting(monkeypatch)
    with torch.no_grad():
        assert intergrid._kernel_route(tp, f, f)
        want = _torch_cycle(th, tp, torch.zeros_like(f), f)
        assert calls == {"C1": 0, "X5": 0, "X6": 0}
        got = intergrid.learned_v_cycle(th, tp, torch.zeros_like(f), f)
        assert calls == {"C1": 4 * 3, "X5": 4, "X6": 4}  # levels 32 ... 4 of 32 ... 2
        one = intergrid.learned_v_cycle(th, tp, torch.zeros_like(f[-1:]), f[-1:])
    assert _rel(got, want) < CYCLE_TOL and _rel(got[-1:], one) < CYCLE_TOL


def test_route_taken_by_grad_mode_dtype_and_device(monkeypatch):
    """The route takes float32 batches of one shape and float32
    parameters, and not the card: CPU fields take it too (its plain
    versions).  Grad mode picks its form only: with a gradient needed
    (grad mode on and any of params, u and f requiring one) the autograd
    form, which runs the same C1, X5 and X6 calls forward, and backward
    the C1 Functions' and X7 / X8 with X9 (``learned_*_backward``)."""
    _, th = _hiers(32, CIRCLE)
    tp = intergrid.IntergridParams.init(device="cpu")
    u = torch.zeros((1, 33, 33))
    f = torch.ones((1, 33, 33))
    assert intergrid._kernel_route(tp, u, f)  # the parameters require grad
    assert intergrid._needs_grad(tp.conv, u, f)
    assert not intergrid._kernel_route(tp, u[0], f[0])
    with torch.no_grad():
        assert intergrid._kernel_route(tp, u, f)
        assert not intergrid._needs_grad(tp.conv, u, f)
        assert not intergrid._kernel_route(tp, u.double(), f.double())
        assert not intergrid._kernel_route(tp, u, f[:, :-1, :-1])
    frozen = intergrid.IntergridParams(*(getattr(tp, k).detach() for k in ("conv", "deconv", "w")))
    for p in frozen.parameters():
        p.requires_grad_(False)
    assert intergrid._kernel_route(frozen, u, f)
    assert not intergrid._needs_grad(*frozen.parameters(), u, f)
    assert intergrid._needs_grad(*frozen.parameters(), u.clone().requires_grad_(), f)
    calls = _counting(monkeypatch)
    bwd = {"X7": 0, "X8": 0}
    for key, name in (("X7", "learned_restrict_backward"),
                      ("X8", "learned_prolong_add_backward")):
        def counted(*a, fn=getattr(px, name), key=key):
            bwd[key] += 1
            return fn(*a)
        monkeypatch.setattr(px, name, counted)
    out = intergrid.learned_v_cycle(th, tp, u, f)
    assert calls == {"C1": 4 * 3, "X5": 4, "X6": 4}  # levels 32 ... 4 of 32 ... 2
    out.sum().backward()
    assert tp.conv.grad is not None and bwd == {"X7": 4, "X8": 4}
    # backward: 2 C1 calls on level 0 (its last sweep), 5 on each coarser
    # kernel level (the last sweep 2, the residual 2, the first sweep 1)
    assert calls == {"C1": 4 * 3 + 2 + 3 * 5, "X5": 4, "X6": 4}
    with torch.no_grad():
        intergrid.learned_v_cycle(th, tp, u, f)
    assert calls == {"C1": 2 * 4 * 3 + 2 + 3 * 5, "X5": 8, "X6": 8}


def test_route_keeps_its_levels_and_buffers():
    """One sweep weight (on the card a StencilLevel) per kernel level for
    the hierarchy's life, the buffers per level and batch size reused, the
    result fresh memory."""
    _, th = _hiers(64, CIRCLE)
    tp = intergrid.IntergridParams.init(device="cpu")
    f = torch.ones((2, 65, 65))
    with torch.no_grad():
        u1 = intergrid.learned_v_cycle(th, tp, torch.zeros_like(f), f)
        route = intergrid._route(th, intergrid.DEFAULT_OMEGA)
        weight, bufs = dict(route.weight), {k: [b.data_ptr() for b in v]
                                            for k, v in route.buffers.items()}
        u1c = u1.clone()
        u2 = intergrid.learned_v_cycle(th, tp, u1, f)
    assert route.weight == weight and {k: [b.data_ptr() for b in v]
                               for k, v in route.buffers.items()} == bufs
    assert set(route.buffers) == {(l, 2) for l in intergrid.kernel_levels(th)}
    assert torch.equal(u1, u1c) and not torch.equal(u1, u2)
    for buf in route.buffers[(0, 2)]:
        assert all(buf[i].data_ptr() % 16 == 0 for i in range(2))


@pytest.mark.parametrize("bim", [True, False], ids=["bim", "hom"])
def test_c1_sweep_and_residual_match_jacobi_on_a_zero_ring(bim):
    """The card route's forms of the smoother (the StencilLevel it builds):
    a C1 sweep keeps the ring where jacobi_step resets it, so the two agree
    while u's ring is 0, as on the cycle; C1's residual is f - A u, 0 on the
    ring."""
    _, th = _hiers(64, CIRCLE if bim else None)
    lv = th.finest
    st = ss.StencilLevel(lv.n, pid=lv.pid, coefficients=intergrid._c1_coefficients(lv),
                         omega=intergrid.DEFAULT_OMEGA, device="cpu")
    rng = np.random.default_rng(7)
    u = torch.from_numpy(rng.standard_normal((65, 65)).astype(np.float32)) * lv.geo
    f = torch.from_numpy(rng.standard_normal((65, 65)).astype(np.float32))
    got, _ = st.sweep(u, f)
    assert _rel(got, jacobi_step(lv, u, f)) < 1e-5
    r, rsq = st.residual(u, f)
    want = (f - lv.apply(u)) * lv.geo
    assert _rel(r, want) < 1e-5 and abs(float(rsq) / float((want * want).sum()) - 1) < 1e-5


# ---- the wrappers' refusals -----------------------------------------------


def test_wrappers_refuse():
    _, th = _hiers(32, CIRCLE, 2)
    tp = intergrid.IntergridParams.init(device="cpu")
    r = torch.zeros((2, 33, 33))
    v = torch.zeros((2, 17, 17))
    with pytest.raises(ValueError, match="CUDA tensors"):
        px.learned_restrict_cuda(r, th.levels[0].pid, tp.conv, tp.w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        px.learned_prolong_add_cuda(r, v, th.levels[1].pid, tp.deconv, tp.w)
    with pytest.raises(ValueError, match="float32"):
        px.learned_restrict_cuda(r.double(), th.levels[0].pid, tp.conv, tp.w)
    with pytest.raises(ValueError, match="float32"):
        px.learned_prolong_add_cuda(r.double(), v, th.levels[1].pid, tp.deconv, tp.w)
    with pytest.raises(ValueError, match="even"):
        px.learned_restrict_cuda(torch.zeros((1, 34, 34)), None, tp.conv[:1], tp.w)
    # C1 takes no operand off a 16-byte boundary: sample 1 of a compact
    # (2, 33, 33) batch starts 4 bytes past one
    assert r[1].data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte boundary"):
        sw._check_aligned(("u", r[1]))
    with pytest.raises(ValueError, match="CUDA"):
        ss.relax_cuda(r[1], r[1], th.levels[0].pid, a0=1.0, da=19.0, omega=2 / 3)


def test_channel_limit_matches_the_kernels():
    src = (_build.CSRC / "passes.cu").read_text()
    assert int(re.search(r"constexpr int LK_MAX = (\d+);", src).group(1)) == px.LK_MAX
    assert px.KERNELS["X5"].replaces == "multigrid_feanet_tpu/models/intergrid.py:65"
    assert px.KERNELS["X6"].replaces == "multigrid_feanet_tpu/models/intergrid.py:82"
