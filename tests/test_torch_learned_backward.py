"""The backward of the learned cycle's kernel route
(multigrid_feanet_torch/models/intergrid.py: C1Sweep, C1Residual,
LearnedRestrict, LearnedProlongAdd; ops/passes.py: the plain versions of
X7, X8 and X9) against torch.autograd and the JAX package, on the CPU.

- X7's and X8's plain versions against torch.autograd of X5's and X6's
  plain versions in float64: vector-Jacobian products within 1e-12
  relative, with 16 random per-channel kernels, one homogeneous channel,
  and 12 channels where pattern ids 12-15 have none (no gradient reaches
  them).
- The C1 Functions against autograd of jacobi_step and of the masked
  residual in float64 (1e-12), which rests on A's symmetry (checked) and
  on the zero ring of u on the cycle: there the sweep is the Jacobi step
  bit for bit.
- The graded route against jax.value_and_grad of the JAX package's eager
  cycle at n = 32 and 64: the loss and the gradients in conv, deconv and w
  within 1e-4 relative (float32 sums in other orders), through one cycle
  and through two graded cycles in one loss; its forward bit for bit the
  no-gradient route's.
- A swap of the fine and coarse pattern ids in X7 or X8 departs from
  autograd and from JAX.
- Any batch: one C1 call a batch for every sweep and residual, forward and
  backward, X5, X6, X7 and X8 once a kernel level; the training step of
  learn/train_intergrid.py reaches the route in every cycle and in q_m and
  calls neither the pattern split nor a convolution.

Inputs come from np.random.default_rng.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from multigrid_feanet_tpu.core.problem import GridHierarchy as JHierarchy, Problem as JProblem
from multigrid_feanet_tpu.models import intergrid as ji

from multigrid_feanet_torch.core.convert import intergrid_params_from_arrays
from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
from multigrid_feanet_torch.learn import train_intergrid as ti
from multigrid_feanet_torch.models import intergrid
from multigrid_feanet_torch.ops import passes as px
from multigrid_feanet_torch.ops import stencil
from multigrid_feanet_torch.solvers.jacobi import jacobi_step

CIRCLE = ("circle", (0.0, 0.0), 0.5)
VJP_TOL, GRAD_TOL = 1e-12, 1e-4
# (inclusion, channels): bi-material 16, homogeneous 1, bi-material 12 (ids
# 12-15 in no channel)
VARIANTS = {"bim16": (CIRCLE, 16), "hom1": (None, 1), "bim12": (CIRCLE, 12)}
PARAMS = ("conv", "deconv", "w")


def _rel(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = want.detach().numpy() if torch.is_tensor(want) else np.asarray(want)
    return float(np.max(np.abs(got - want))) / max(1e-30, float(np.max(np.abs(want))))


def _hier(n, inclusion, num_levels=None, dtype=torch.float32):
    return GridHierarchy.create(Problem(n=n, inclusion=inclusion, dtype=dtype), num_levels,
                                device="cpu")


def _random_params(C, seed):
    rng = np.random.default_rng(seed)
    conv = intergrid.FULL_WEIGHTING_16 + 0.1 * rng.standard_normal((C, 3, 3))
    deconv = intergrid.BILINEAR_4 + 0.1 * rng.standard_normal((C, 3, 3))
    return conv.astype(np.float32), deconv.astype(np.float32), np.array([3.7, 1.1], np.float32)


def _f64(*xs):
    return [torch.from_numpy(np.asarray(x, np.float64)).requires_grad_() for x in xs]


# ---- X7 and X8: the plain versions against autograd ----------------------


def _restrict_vjp(r, pid, k, w, g, backward=px.learned_restrict_backward_plain):
    """(X7's plain version, autograd of X5's) on float64 operands."""
    got = backward(g, r.detach(), pid, k.detach(), w.detach())
    want = torch.autograd.grad(px.learned_restrict_plain(r, pid, k, w), (r, k, w), g)
    return got, want


def _prolong_vjp(u, v, pid_c, k, w, g):
    """(X8's plain version with grad u = g, autograd of X6's)."""
    got = (g, *px.learned_prolong_add_backward_plain(g, v.detach(), pid_c, k.detach(),
                                                     w.detach()))
    want = torch.autograd.grad(px.learned_prolong_add_plain(u, v, pid_c, k, w), (u, v, k, w), g)
    return got, want


def _operands(n, variant, batch, seed):
    inclusion, C = VARIANTS[variant]
    th = _hier(n, inclusion, 2, torch.float64)
    conv, deconv, w = _random_params(C, seed)
    rng = np.random.default_rng(seed + 1)
    H, Hc = n + 1, n // 2 + 1
    r, u = _f64(*(rng.standard_normal((batch, H, H)) for _ in range(2)))
    v, = _f64(rng.standard_normal((batch, Hc, Hc)))
    g_c = torch.from_numpy(rng.standard_normal((batch, Hc, Hc)))
    g = torch.from_numpy(rng.standard_normal((batch, H, H)))
    return th, C, dict(conv=_f64(conv)[0], deconv=_f64(deconv)[0], w=_f64(w)[0], r=r, u=u,
                       v=v, g_c=g_c, g=g)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_x7_x8_plain_are_the_vjps_of_x5_x6(variant, n, batch):
    th, C, x = _operands(n, variant, batch, n + batch + list(VARIANTS).index(variant))
    pid, pid_c = th.levels[0].pid, th.levels[1].pid
    if C == 12:  # ids no channel holds occur on both levels
        assert int(pid.max()) >= C and int(pid_c.max()) >= C
    got, want = _restrict_vjp(x["r"], pid, x["conv"], x["w"], x["g_c"])
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel(a, b) < VJP_TOL
    assert float(got[0][:, 0].abs().max()) == 0.0 and float(got[0][:, :, -1].abs().max()) == 0.0
    got, want = _prolong_vjp(x["u"], x["v"], pid_c, x["deconv"], x["w"], x["g"])
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel(a, b) < VJP_TOL


def test_x7_x8_plain_take_float32_as_the_kernels_round():
    """In float32 grad r and grad v are their float64 values rounded (within
    float32 rounding of a few terms) and the weight gradients sum in
    float64 (within 1e-6)."""
    th, C, x = _operands(32, "bim16", 2, 5)
    pid, pid_c = th.levels[0].pid, th.levels[1].pid
    f32 = {k: v.detach().float() for k, v in x.items()}
    for fn, args32, args64 in (
            (px.learned_restrict_backward_plain, (f32["g_c"], f32["r"], pid, f32["conv"],
                                                  f32["w"]),
             (x["g_c"], x["r"].detach(), pid, x["conv"].detach(), x["w"].detach())),
            (px.learned_prolong_add_backward_plain, (f32["g"], f32["v"], pid_c, f32["deconv"],
                                                     f32["w"]),
             (x["g"], x["v"].detach(), pid_c, x["deconv"].detach(), x["w"].detach()))):
        for a, b in zip(fn(*args32), fn(*args64)):
            assert a.dtype == torch.float32 and _rel(a.double(), b) < 1e-6


# ---- the C1 Functions: the adjoints of the Jacobi step and the residual ---


@pytest.mark.parametrize("inclusion", [CIRCLE, None], ids=["bim", "hom"])
def test_c1_functions_are_the_adjoints_of_jacobi_and_the_residual(inclusion):
    """On every kernel level of a float64 hierarchy (the route's CPU forms):
    A symmetric; on u's zero ring the sweep equals jacobi_step bit for bit
    and the residual the masked f - A u of u with its ring reset (the
    cycle's residual reads the iterate of a Jacobi step, reset); the
    Functions' vector-Jacobian products equal autograd's of those within
    1e-12, their ring entries 0: the reset keeps every ring gradient from
    the parameters."""
    th = _hier(32, inclusion, dtype=torch.float64)
    route = intergrid._Route(th, intergrid.DEFAULT_OMEGA)
    assert route.levels == [0, 1, 2, 3]
    rng = np.random.default_rng(3)
    for l in route.levels:
        lv = th.levels[l]
        H = lv.n_nodes
        x, y = (torch.from_numpy(rng.standard_normal((2, H, H))) * lv.geo for _ in range(2))
        assert abs(float((lv.apply(x) * y).sum() - (x * lv.apply(y)).sum())) < 1e-12 * float(
            (lv.apply(x) * y).abs().sum())
        u, f = _f64(rng.standard_normal((2, H, H)) * lv.geo.numpy(),
                    rng.standard_normal((2, H, H)))
        g = torch.from_numpy(rng.standard_normal((2, H, H)))
        for fn, ref in ((intergrid.C1Sweep, lambda u, f: jacobi_step(lv, u, f)),
                        (intergrid.C1Residual,
                         lambda u, f: (f - lv.apply(u * lv.geo)) * lv.geo)):
            out, want = fn.apply(u, f, route, l), ref(u, f)
            assert torch.equal(out, want)
            got = torch.autograd.grad(out, (u, f), g)
            for a, b in zip(got, torch.autograd.grad(want, (u, f), g)):
                assert _rel(a, b) < VJP_TOL
                assert float(a[:, 0].abs().max()) == 0.0 and float(a[:, -1].abs().max()) == 0.0
            # only f requiring a gradient: grad f alone, the same
            f_only = fn.apply(u.detach(), f, route, l)
            assert _rel(torch.autograd.grad(f_only, f, g)[0], got[1]) < VJP_TOL


# ---- the graded route against JAX -----------------------------------------


def _pair(n, inclusion, seed):
    jh = JHierarchy.create(JProblem(n=n, inclusion=inclusion, dtype=jnp.float32))
    th = _hier(n, inclusion)
    C = 16 if inclusion is not None else 1
    conv, deconv, w = _random_params(C, seed)
    jp = ji.IntergridParams(conv=jnp.asarray(conv), deconv=jnp.asarray(deconv), w=jnp.asarray(w))
    return jh, th, jp, intergrid_params_from_arrays(conv, deconv, w, device="cpu")


def _fields(n, batch, seed):
    rng = np.random.default_rng(seed)
    H = n + 1
    # u0 with a nonzero ring, which the first sweep resets
    return [rng.standard_normal((batch, H, H)).astype(np.float32) for _ in range(3)]


def _jax_loss(jh, u0, f, c, cycles):
    def loss(params):
        u = jnp.asarray(u0)
        for _ in range(cycles):
            u = ji.learned_v_cycle(jh, params, u, jnp.asarray(f))
        return jnp.sum(u * jnp.asarray(c))
    return loss


def _port_loss(th, tp, u0, f, c, cycles):
    u = torch.from_numpy(u0)
    for _ in range(cycles):
        u = intergrid.learned_v_cycle(th, tp, u, torch.from_numpy(f))
    return (u * torch.from_numpy(c)).sum()


def _check_grads(jloss_fn, jp, tp, loss):
    jloss, jgrad = jax.value_and_grad(jloss_fn)(jp)
    loss.backward()
    assert abs(float(loss.detach()) / float(jloss) - 1) < GRAD_TOL
    errs = {k: _rel(getattr(tp, k).grad, getattr(jgrad, k)) for k in PARAMS}
    return errs


@pytest.mark.parametrize("cycles", [1, 2])
@pytest.mark.parametrize("n,inclusion", [(32, CIRCLE), (64, CIRCLE), (32, None)],
                         ids=["bim32", "bim64", "hom32"])
def test_graded_route_matches_jax_value_and_grad(n, inclusion, cycles):
    """The loss sum(c * cycle^k(u0)) and its gradient in conv, deconv and w
    with random per-channel weights: one cycle, and two graded cycles in one
    loss (the second cycle's backward reads the first's saved tensors)."""
    jh, th, jp, tp = _pair(n, inclusion, n + cycles)
    u0, f, c = _fields(n, 2, n + 10 * cycles)
    errs = _check_grads(_jax_loss(jh, u0, f, c, cycles), jp, tp,
                        _port_loss(th, tp, u0, f, c, cycles))
    assert max(errs.values()) < GRAD_TOL, errs


def test_graded_forward_is_the_no_gradient_route():
    _, th, _, tp = _pair(64, CIRCLE, 1)
    u0, f, _ = _fields(64, 3, 4)
    u, f = torch.from_numpy(u0), torch.from_numpy(f)
    graded = intergrid.learned_v_cycle(th, tp, u, f)
    assert graded.requires_grad and graded.is_contiguous()
    with torch.no_grad():
        plain = intergrid.learned_v_cycle(th, tp, u, f)
    assert torch.equal(graded.detach(), plain)


# ---- a swap of the fine and coarse pattern ids is caught ------------------


def _swapped(pid_f, pid_c):
    """(the coarse ids on the fine grid, the fine ids at the coarse nodes):
    the ids X7 and X8 would read with the two levels swapped."""
    H = pid_f.shape[-1]
    up = pid_c.repeat_interleave(2, 0).repeat_interleave(2, 1)[:H, :H]
    return up.contiguous(), pid_f[::2, ::2].contiguous()


@pytest.mark.parametrize("leg", ["X7", "X8"])
def test_swapped_pattern_ids_are_caught(monkeypatch, leg):
    """X7 weighs by the fine node's id and X8 by the coarse node's; with the
    other level's ids in their place the VJP departs from autograd's (and
    the graded route's gradient from JAX's) beyond every tolerance, which
    equal channels would hide."""
    th, _, x = _operands(32, "bim16", 2, 9)
    pid, pid_c = th.levels[0].pid, th.levels[1].pid
    wrong_f, wrong_c = _swapped(pid, pid_c)
    assert not torch.equal(wrong_f, pid) and not torch.equal(wrong_c, pid_c)
    if leg == "X7":
        got, want = _restrict_vjp(x["r"], pid, x["conv"], x["w"], x["g_c"])
        bad, _ = _restrict_vjp(x["r"], wrong_f, x["conv"], x["w"], x["g_c"])
        name, fine = "learned_restrict_backward", True
    else:
        got, want = _prolong_vjp(x["u"], x["v"], pid_c, x["deconv"], x["w"], x["g"])
        bad, _ = _prolong_vjp(x["u"], x["v"], wrong_c, x["deconv"], x["w"], x["g"])
        name, fine = "learned_prolong_add_backward", False
    assert max(_rel(a, b) for a, b in zip(got, want)) < VJP_TOL
    assert max(_rel(a, b) for a, b in zip(bad, want)) > 1e-3
    # the route with the swap: its gradient departs from JAX's
    jh, th, jp, tp = _pair(32, CIRCLE, 3)
    swap = {}
    for l in range(th.num_levels - 1):
        wf, wc = _swapped(th.levels[l].pid, th.levels[l + 1].pid)
        swap[id(th.levels[l].pid if fine else th.levels[l + 1].pid)] = wf if fine else wc
    right = getattr(px, name)
    monkeypatch.setattr(px, name, lambda g, x, p, k, w: right(g, x, swap[id(p)], k, w))
    u0, f, c = _fields(32, 2, 11)
    errs = _check_grads(_jax_loss(jh, u0, f, c, 1), jp, tp, _port_loss(th, tp, u0, f, c, 1))
    assert errs["conv" if fine else "deconv"] > 1e-3, errs


# ---- what the route runs ----------------------------------------------------


def _counting(monkeypatch):
    """Count the route's C1 calls (one launch a batch on the card), X5, X6,
    X7 and X8, and the torch path's pattern split and convolutions."""
    calls = dict.fromkeys(("C1", "X5", "X6", "X7", "X8", "split", "conv"), 0)

    def counted(key, fn):
        def run(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return run

    for name in ("_sweep", "_residual"):
        monkeypatch.setattr(intergrid._Route, name, counted("C1", getattr(intergrid._Route, name)))
    for key, name in (("X5", "learned_restrict"), ("X6", "learned_prolong_add"),
                      ("X7", "learned_restrict_backward"),
                      ("X8", "learned_prolong_add_backward")):
        monkeypatch.setattr(px, name, counted(key, getattr(px, name)))
    monkeypatch.setattr(stencil, "split_by_pattern", counted("split", stencil.split_by_pattern))
    for name in ("conv2d", "conv_transpose2d"):
        monkeypatch.setattr(F, name, counted("conv", getattr(F, name)))
    return calls


@pytest.mark.parametrize("batch", [1, 2, 7, 64])
def test_graded_cycle_launches_per_batch(monkeypatch, batch):
    """A graded cycle at 33^2 (kernel levels 32 ... 4 of 32 ... 2) on any
    batch: forward C1 3 times a kernel level, X5 and X6 once; backward C1 2
    times on level 0 (its last sweep; its first sweep and residual need no
    gradient) and 5 on each coarser kernel level, X7 and X8 once a level."""
    _, th, _, tp = _pair(32, CIRCLE, 2)
    u0, f, c = (x[:1].repeat(batch, 0) for x in _fields(32, 1, 5))
    calls = _counting(monkeypatch)
    loss = _port_loss(th, tp, u0, f, c, 1)
    assert calls == dict(C1=12, X5=4, X6=4, X7=0, X8=0, split=0, conv=0)
    loss.backward()
    assert calls == dict(C1=12 + 2 + 3 * 5, X5=4, X6=4, X7=4, X8=4, split=0, conv=0)
    assert all(getattr(tp, k).grad is not None for k in PARAMS)


def test_train_step_reaches_the_route(monkeypatch):
    """ti.train_step at 17^2 (kernel levels 16 and 8 of 16 ... 4), m = 4,
    m0 = 2, a batch of 4: its three cycles without gradient, its graded
    cycle and q_m's two residuals all run the route's C1, X5 and X6, the
    backward X7, X8 and the C1 Functions, and no step calls the pattern
    split or a convolution (the tests of test_torch_intergrid.py,
    test_torch_train_intergrid.py and test_torch_intergrid_robust.py run
    through the same calls)."""
    th = _hier(16, CIRCLE, 3)
    state = ti.init_state(0, device="cpu")
    F_batch = torch.from_numpy(np.random.default_rng(8).standard_normal((4, 17, 17))
                               .astype(np.float32))
    calls = _counting(monkeypatch)
    ti.train_step(th, state, F_batch, m=4, m0=2)
    # C1: 3 cycles x 2 levels x 3, graded 6 + backward (2 + 5), q_m 2 + backward 2
    assert calls == dict(C1=18 + 6 + 7 + 2 + 2, X5=8, X6=8, X7=2, X8=2, split=0, conv=0)


# ---- C1 over a batch, and the kernels' geometry ---------------------------


def test_c1_batch_plain_and_layout():
    """relax_batch_plain is relax_plain a sample (no norm); StencilLevel's
    batch methods take it on the CPU; C1's batch layout is batch_plane
    values a sample, each on a 16-byte boundary, and the wrapper refuses
    any other layout, CPU tensors and a misaligned pid."""
    import re

    from multigrid_feanet_torch import _build
    from multigrid_feanet_torch.ops import stencil_sweep as ss

    th = _hier(32, CIRCLE, 1)
    lv = th.finest
    st = ss.StencilLevel(32, pid=lv.pid, coefficients=intergrid._c1_coefficients(lv),
                         omega=intergrid.DEFAULT_OMEGA, device="cpu")
    rng = np.random.default_rng(12)
    u, f = (intergrid._operand(torch.from_numpy(rng.standard_normal((3, 33, 33))
                                                .astype(np.float32))) for _ in range(2))
    for mode, batch, one in (("sweep", st.sweep_batch, st.sweep),
                             ("residual", st.residual_batch, st.residual)):
        got = batch(u, f)
        assert torch.equal(got, torch.stack([one(u[i], f[i])[0] for i in range(3)]))
        out = intergrid._buffer(3, 33, "cpu")
        assert batch(u, f, out=out) is out and torch.equal(out, got)
    assert ss.batch_plane(33) == 1092 and ss.batch_plane(65) == 4228 and ss.batch_plane(2) == 4
    assert ss.check_batch(u, "u", 33, u.device) == 3 and u.stride(0) == ss.batch_plane(33)
    assert all(u[i].data_ptr() % 16 == 0 for i in range(3))
    compact = u.contiguous()
    with pytest.raises(ValueError, match="batch_plane"):
        ss.check_batch(compact, "u", 33, u.device)
    with pytest.raises(ValueError, match="16-byte"):
        ss.check_batch(torch.empty(1092)[1:1 + 1089].view(1, 33, 33), "u", 33, u.device)
    with pytest.raises(ValueError, match="CUDA"):
        ss.relax_batch_cuda(u, f, lv.pid, a0=1.0, da=19.0, omega=2 / 3)
    src = (_build.CSRC / "stencil.cu").read_text()
    assert "return ((long long)H * H + 3) / 4 * 4;" in src
    entry = src[src.index("int st_relax("):]
    assert "int strip, int gx, int gy, int batch, void* stream" in entry[:entry.index("{")]
    assert re.search(r"constexpr int C1_RESIDUAL = 1, C1_BATCH = 2;", src)


def test_backward_geometry_matches_the_kernels(monkeypatch):
    """X7's and X8's blocks (the rows of partial sums X9 adds) as
    csrc/passes.cu's bwd_blocks counts them, its index map as bwd_start
    reads it, the strip the wrappers take for the card's SMs; the wrappers
    refuse CPU tensors and partial sums of the wrong width."""
    import re

    from multigrid_feanet_torch import _build

    src = (_build.CSRC / "passes.cu").read_text()
    px_, py_ = map(int, re.search(r"constexpr int PX = (\d+), PY = (\d+), PNT = PX \* PY;",
                                  src).groups())
    assert "constexpr int WARPS = PNT / 32;" in src and px_ * py_ // 32 == px.BWD_WARPS
    assert px.BWD_LANES == 32
    assert ("const long long nb = (Hc + 31) / 32, ns = ((long long)batch * Hc + strip - 1) "
            "/ strip;\n  return (nb * ns + WARPS - 1) / WARPS;") in src
    assert "const long long R0 = unit / nb * strip, smp = R0 / Hc;" in src
    assert "col = (int)(unit % nb) * 32 + threadIdx.x % 32;" in src
    assert "return row + 1 < Hc ? BwdRow{row + 1, a, b, o} : BwdRow{0, a + sa, b + sb, o + so};" \
        in src
    assert px.bwd_blocks(4096, 1, 16) == 65 * 129 // 8 + 1 == 1049
    assert px.bwd_blocks(64, 64, 2) == 2 * 64 * 33 // 2 // 8 == 264

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(px, "_BWD_TILES", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Props())
    dev = torch.device("cuda", 0)
    for n, N, strip in ((4096, 1, 16), (64, 64, 2), (4, 64, 2), (1024, 1, 2), (4096, 2, 32)):
        tiles = px.bwd_launch_tiles(n, N, dev)
        assert tiles == (strip, px.bwd_blocks(n, N, strip)) == (px.bwd_strip(n, N, 132),
                                                               tiles.blocks)
        assert px.bwd_launch_tiles(n, N, dev) is tiles
    for key in ("X7", "X8", "X9"):
        assert px.KERNELS[key].replaces == "multigrid_feanet_tpu/learn/train_intergrid.py:100"
    th = _hier(32, CIRCLE, 2)
    tp = intergrid.IntergridParams.init(device="cpu")
    g, r = torch.zeros((2, 17, 17)), torch.zeros((2, 33, 33))
    with pytest.raises(ValueError, match="CUDA"):
        px.learned_restrict_backward_cuda(g, r, th.levels[0].pid, tp.conv.detach(),
                                          tp.w.detach())
    with pytest.raises(ValueError, match="CUDA"):
        px.learned_prolong_add_backward_cuda(r, g, th.levels[1].pid, tp.deconv.detach(),
                                             tp.w.detach())
    with pytest.raises(ValueError):
        px.weight_grad_cuda(torch.zeros((4, 9)), tp.conv.detach(), tp.w.detach(), 0)
    # the plain X9 is the float64 sum of the rows, then X7's / X8's weights
    rng = np.random.default_rng(4)
    part = torch.from_numpy(rng.standard_normal((5, 144)).astype(np.float32))
    k, w = tp.conv.detach(), tp.w.detach()
    gk, gw = px.weight_grad_plain(part, k, w, 1)
    P = part.double().sum(0).float().reshape(16, 3, 3)
    assert torch.equal(gk, w[1] * P) and float(gw[0]) == 0.0
    assert abs(float(gw[1]) - float((k.double() * P.double()).sum())) < 1e-6


def _bwd_walk(n, N, strip, stride):
    """X7's and X8's index map as csrc/passes.cu walks it (bwd_start, then
    BwdRow::next a step), for every block of bwd_blocks, warp, lane and step
    of its strip: (block, sample, coarse row, column, offset of the node in
    a field whose samples lie ``stride`` values apart, counted from the
    pointers the kernel advances) of the lanes on the grid."""
    Hc = n // 2 + 1
    nb, blocks = -(-Hc // 32), px.bwd_blocks(n, N, strip)
    unit = np.arange(blocks * px.BWD_WARPS, dtype=np.int64)
    R0 = unit // nb * strip
    steps = np.clip(np.minimum(strip, N * Hc - R0), 0, None)
    smp = R0 // Hc
    row, base = R0 - smp * Hc, smp * stride
    col = (unit % nb)[:, None] * 32 + np.arange(32)[None, :]
    out = []
    for step in range(strip):
        go = (step < steps)[:, None] & (col < Hc)
        b, s, i, j = (np.broadcast_to(a, col.shape)[go] for a in (
            (unit // px.BWD_WARPS)[:, None], smp[:, None], row[:, None], col))
        out.append((b, s, i, j, np.broadcast_to((base + row * Hc)[:, None], col.shape)[go] + j))
        wrap = row + 1 == Hc
        row, base, smp = np.where(wrap, 0, row + 1), base + wrap * stride, smp + wrap
    return [np.concatenate(x) for x in zip(*out)]


# (n, batch): the training step's levels at its batch of 64, the multi-size
# steps' finest levels at their batches, the holds' 257^2 and 4097^2
BWD_WALKS = [(n, 64) for n in (4, 8, 16, 32, 64)] + [(16, 16), (32, 8), (64, 2), (256, 2),
                                                     (4096, 1)]


@pytest.mark.parametrize("spaced", [False, True], ids=["compact", "spaced"])
@pytest.mark.parametrize("n,N", BWD_WALKS)
def test_backward_walk_takes_each_node_once(n, N, spaced):
    """The index map of X7 and X8 (``_bwd_walk``) at the strip the wrappers
    take on a 132-SM card, and at 2, 6 and 16 rows below 4097^2: every
    coarse cell (X7) and node (X8) of every sample taken exactly once, at
    the offset its sample's stride gives (samples more than a plane apart
    when ``spaced``), X7's fine nodes written once each; every block holds
    a warp with rows, so the partial rows X9 adds are bwd_blocks; at most
    the parent's 1105 rows at 4097^2."""
    Hc, H = n // 2 + 1, n + 1
    strips = [px.bwd_strip(n, N, 132)] + ([] if n == 4096 else [2, 6, 16])
    stride = Hc * Hc + (37 if spaced else 0)
    for strip in strips:
        blk, smp, I, J, off = _bwd_walk(n, N, strip, stride)
        cells = np.bincount((smp * Hc + I) * Hc + J, minlength=N * Hc * Hc)
        assert cells.size == N * Hc * Hc and (cells == 1).all()
        assert (off == smp * stride + I * Hc + J).all()
        assert np.unique(blk).size == px.bwd_blocks(n, N, strip) == blk.max() + 1
        # X7's cell (I, J): fine nodes (2I - 1 + i, 2J - 1 + j) on the grid
        fine = np.zeros(N * H * H, np.int64)
        for i in (0, 1):
            for j in (0, 1):
                y, x = 2 * I - 1 + i, 2 * J - 1 + j
                on = (y >= 0) & (x >= 0)
                np.add.at(fine, (smp[on] * H + y[on]) * H + x[on], 1)
        assert (fine == 1).all()
    if n == 4096:
        assert px.bwd_blocks(n, N, strips[0]) <= 1105


@pytest.mark.parametrize("batch", [1, 4, 64])
def test_c1_batch_geometry(monkeypatch, batch):
    """A batch launch above C1_ONE_PASS_MAX_N takes row_strip's height for
    its own instance's occupancy (MODE + C1_BATCH) and the whole batch's
    blocks, kept per level and batch; at and below it the one-pass tile."""
    from multigrid_feanet_torch.ops import hrelax as hx
    from multigrid_feanet_torch.ops import stencil_sweep as ss

    class Props:
        multi_processor_count = 132

    asked = []

    def occupancy(symbol, *args):
        asked.append((symbol, *args))
        return 9

    monkeypatch.setattr(ss, "occupancy", occupancy)
    monkeypatch.setattr(ss, "_C1_TILES", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Props())
    dev = torch.device("cuda", 0)
    assert ss.c1_launch_tiles(256, True, 0, dev, batch) == ss.c1_one_pass_tiles(256)
    for n in (512, 4096):
        for bim, mode in ((False, 0), (True, 1)):
            tiles = ss.c1_launch_tiles(n, bim, mode, dev, batch)
            want = hx.row_strip(lambda s: ss.c1_tiles(n, s)._replace(
                gy=batch * ss.c1_tiles(n, s).gy), ss.C1_HALO_STEPS, 9 * 132, 132)
            assert tiles == ss.c1_tiles(n, want)
            assert asked[-1] == ("st_relax_occupancy", int(bim), mode + 2)
            assert ss.c1_launch_tiles(n, bim, mode, dev, batch) is tiles
    assert len(asked) == 4
