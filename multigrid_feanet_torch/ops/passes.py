"""The passes the JAX package leaves to XLA's fusion, as kernels X1-X6.

The JAX package computes these outside any Pallas kernel, and XLA fuses
each into one program inside a compiled loop: the heat right-hand side in
``HeatSolver.march``'s ``lax.scan``, the round-1 transfers in
``PallasHierarchy.solve``'s ``while_loop``, ``solve_ir``'s outer step in its
jitted ``_outer64``, the learned transfers in the jitted
``learned_v_cycle``, where XLA folds the pattern split into the
convolution.  Run as eager torch ops each is a chain of passes over the
whole grid (the learned transfers a 16-channel split and a cuDNN
convolution); here each is one hand-written CUDA C++ kernel
(``csrc/passes.cu``), the port's form of that fusion:

====  ==========================  ====================================================
name  C entry point               replaces (XLA-fused, no Pallas kernel)
====  ==========================  ====================================================
X1    ``px_heat_rhs``             ``ops/heat.py:124 HeatSolver.rhs``
X2    ``px_restrict``             ``ops/transfer.py:38 restrict_full_weighting`` x 4
X3    ``px_prolong_add``          ``ops/transfer.py:61 prolong_bilinear`` + the add
X4    ``px_outer_step``           ``solvers/pallas_mg.py:313 _outer64``
X5    ``px_learned_restrict``     ``models/intergrid.py:65 restrict_learned``
X6    ``px_learned_prolong_add``  ``models/intergrid.py:82 prolong_learned`` + the add
X7    ``px_learned_restrict_bwd``  the backward of X5 (``value_and_grad``,
                                  ``learn/train_intergrid.py:100``)
X8    ``px_learned_prolong_bwd``  the backward of X6 (the same)
X9    ``px_weight_grad``          X7's and X8's weight gradients (the same)
====  ==========================  ====================================================

Each has a wrapper ``<op>_cuda`` (checks, allocation, launch, launch count)
and a plain PyTorch version ``<op>_plain`` with the same signature: the torch
code the port ran before, moved here (X5 and X6: the per-node form of the
learned transfers, gathering each tap's weight by pattern id, with no split
and no convolution).  :func:`heat_rhs`, :func:`restrict`,
:func:`prolong_add`, :func:`outer_step`, :func:`learned_restrict` and
:func:`learned_prolong_add` take the plain version for CPU tensors and
launch the kernel for CUDA ones (or raise).  The kernels round where their
plain versions round (``csrc/passes.cu``): X1 (in float32 and float64; a
bf16 b within one bf16 ulp), X2, X3 and X6 equal them bit for bit, X4
agrees to ``TOL64``; X5's fused multiply-adds, which its plain version
takes in float64 and rounds to float32, differ from it only where that
double rounding meets a float32 tie.  X5 and X6 round as the JAX package's
convolutions round on the CPU (X5 in XLA's nine partial sums,
:func:`x5_chain`), so that ``learned_v_cycle``'s kernel route on CPU
fields is the JAX package's eager cycle bit for bit.

X5 and X6 take a batch of float32 fields (N, H, H) whose rows are compact
and whose samples lie any number of values apart (``learned_v_cycle``'s
16-byte aligned per-sample buffers), the (C, 3, 3) kernels and ``w``
(read on the card, never through the host), and the pattern ids of the
fine level (X5) or the coarse level (X6), or None for a homogeneous level
with one channel.

X7 and X8 are their backward: from the gradient of X5's f_c,
:func:`learned_restrict_backward` gives (grad r, grad k, grad w) with
grad r(p) = w[0] sum k[pid(p), a, b] g_c(I, J) over the coarse interior
nodes whose window holds p at tap (a, b) (0 on the fine ring), grad k =
w[0] P and grad w[0] = sum k P, P[c, a, b] = sum [pid(p) = c] g_c(I, J)
r(p); from the gradient g of X6's output,
:func:`learned_prolong_add_backward` gives (grad v, grad k, grad w) with
grad v(c) = w[1] sum_t k[pid_c(c), t] g(2c + t - 1) and Q[c, t] = sum
[pid_c = c] v g(2c + t - 1) in place of P (grad u = g needs no kernel).  The
weights go by the fine node's id in X7 and the coarse node's in X8, as
forward.  X7 and X8 walk the batch's coarse rows laid end to end, a warp a
band of 32 columns and a strip of rows (:func:`bwd_launch_tiles`); each
lane keeps its weight sums while its pattern ids stay, and each block
writes its partial sums of P (or Q), which X9 adds in a fixed order (no
float atomics) into grad k and grad w.
grad r and grad v equal their plain versions bit for bit (both sum from 0
in tap order, the weight last); the plain versions sum P in float64, and
grad k and grad w agree with them to ``TOL_WEIGHT_GRAD``.

X1 has two designs: the one-pass 32 x 8 tile up to ``X1_ONE_PASS_MAX_N``
elements per side, and above it row streaming (:func:`x1_tiles`,
:func:`x1_strip`), which computes the same bits; :func:`x1_launch_tiles`
chooses by size.

The operator arguments: X1's stiffness K and X4's f64 A are the two-phase
bitplane form (``pid`` with ``a0``, ``a1``) or a homogeneous (3, 3)
``table`` of host numbers (nested sequences); :func:`operator_form` reads
them from a level once.  The plain versions also take a (16, 3, 3) table
with ``pid`` (the gather form), which the kernels refuse.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from multigrid_feanet_torch.ops import hrelax as hx
from multigrid_feanet_torch.ops import stencil
from multigrid_feanet_torch.ops import sweep as sw
from multigrid_feanet_torch.ops.transfer import prolong_bilinear, restrict_full_weighting

TOL64 = 1e-12  # X4 against its plain version: relative to max|plain|
# X7 + X9 and X8 + X9 against their plain versions' weight gradients: each
# within this fraction of the same gradient of |g| and |r| (or |v|), the
# rounding of the kernels' float32 sums (a lane's running sums down its
# strip, added over the warp's lanes, then its block's 8 warps, then in
# float64) against the plain versions' float64 sums
TOL_WEIGHT_GRAD = 1e-5

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SOURCE = "multigrid_feanet_torch/csrc/passes.cu"
_TPU = "multigrid_feanet_tpu/"
KERNELS = {
    "X1": sw.CudaKernel("X1_heat_rhs", "px_heat_rhs", [_P] * 5 + [_I, _P] + [_I] * 6 + [_P],
                        _TPU + "ops/heat.py:124", _SOURCE),
    "X2": sw.CudaKernel("X2_restrict", "px_restrict", [_P, _P, _I, _P],
                        _TPU + "ops/transfer.py:38", _SOURCE),
    "X3": sw.CudaKernel("X3_prolong_add", "px_prolong_add", [_P] * 4 + [_I, _P],
                        _TPU + "ops/transfer.py:61", _SOURCE),
    "X4": sw.CudaKernel("X4_outer_step", "px_outer_step",
                        [_P] * 10 + [_I, ctypes.POINTER(ctypes.c_double), _I, _P],
                        _TPU + "solvers/pallas_mg.py:313", _SOURCE),
    "X5": sw.CudaKernel("X5_learned_restrict", "px_learned_restrict",
                        [_P] * 5 + [_I] * 3 + [_L] * 2 + [_P],
                        _TPU + "models/intergrid.py:65", _SOURCE),
    "X6": sw.CudaKernel("X6_learned_prolong_add", "px_learned_prolong_add",
                        [_P] * 6 + [_I] * 3 + [_L] * 3 + [_P],
                        _TPU + "models/intergrid.py:82", _SOURCE),
    "X7": sw.CudaKernel("X7_learned_restrict_bwd", "px_learned_restrict_bwd",
                        [_P] * 7 + [_I] * 5 + [_L] * 3 + [_P],
                        _TPU + "learn/train_intergrid.py:100", _SOURCE),
    "X8": sw.CudaKernel("X8_learned_prolong_bwd", "px_learned_prolong_bwd",
                        [_P] * 7 + [_I] * 5 + [_L] * 3 + [_P],
                        _TPU + "learn/train_intergrid.py:100", _SOURCE),
    "X9": sw.CudaKernel("X9_weight_grad", "px_weight_grad",
                        [_P, _I, _I, _P, _P, _I, _P, _P, _P],
                        _TPU + "learn/train_intergrid.py:100", _SOURCE),
}
# channels of X5's and X6's weight tables (csrc/passes.cu LK_MAX): every id
# an int8 pattern-id field holds
LK_MAX = 128

# The offsets of ops/stencil.py UNIT_S9's taps in the order of its dict, as
# csrc/passes.cu's s9_dr / s9_dc list them; every UNIT_S4 dict holds its
# (centre, row edge, column edge, corner) in that order.
S9_ORDER = ((0, 0), (-1, 0), (0, -1), (-1, -1), (0, 1), (-1, 1), (1, 0), (1, -1), (1, 1))


# ---------------------------------------------------------------------------
# Plain versions: the torch code of HeatSolver.rhs, the round-1 V-cycle's
# transfers and solve_ir's outer step.
# ---------------------------------------------------------------------------


def _apply(u, pid, a0, a1, table):
    """A u in the form the arguments give (``core.problem.Level.apply``)."""
    if pid is not None and a0 is not None:
        return stencil.apply_stencil_bitplane(pid, u, a0, a1)
    return stencil.apply_stencil(torch.as_tensor(table, dtype=u.dtype, device=u.device), pid, u)


def heat_rhs_plain(u, f0, f1, pid=None, *, h, theta, dt, a0=None, a1=None, table=None,
                   out=None):
    """X1: b = M_h u - (1 - theta) dt K u + dt M_h (theta f1 + (1 - theta)
    f0), computed in the wider of u's type (a bf16 ``u`` widened to
    float32) and the f's (the problem's, float32 or float64), returned in
    ``out``'s type (u's when None: a bf16 b is the float32 one rounded)."""
    dtype = u.dtype if out is None else out.dtype
    u = u.to(torch.promote_types(sw._widen(u)[0].dtype, f0.dtype))
    mu = stencil.apply_mass(u, h)
    ku = _apply(u, pid, a0, a1, table)
    f_mix = theta * f1 + (1.0 - theta) * f0
    b = mu - (1.0 - theta) * dt * ku + dt * stencil.apply_mass(f_mix, h)
    return sw._emit(b, out, dtype)


def restrict_plain(r, out=None):
    """X2: the coarse right-hand side 4 FW(r), zero on the coarse ring."""
    return sw._emit(4.0 * restrict_full_weighting(r), out)


def prolong_add_plain(u, uc, geo, out=None):
    """X3: u + geo P(uc), P the bilinear prolongation."""
    return sw._emit(u + prolong_bilinear(uc, geo), out)


def outer_step_plain(u, e, f, geo, pid=None, *, a0=None, a1=None, table=None, out=None):
    """X4: (u + e geo, r = f - A (u + e geo) as float32, the interior sum of
    r^2) from the f64 ``u``, ``f`` and ``geo`` and the float32 (or bf16)
    correction ``e``."""
    u = u + e.double() * geo
    r = f - _apply(u, pid, a0, a1, table)
    ri = r[..., 1:-1, 1:-1]
    return sw._emit(u, out), r.float(), torch.sum(ri * ri, dim=(-2, -1))


def _tap(k, pid, t, rows, cols):
    """Tap ``t`` (row-major in the 3 x 3 kernel) of the kernel of each node
    of ``pid[rows, cols]``: k[pid, t], 0 where no channel holds the id (the
    split's comparison puts it in none); k[0, t] when ``pid`` is None."""
    C = k.shape[0]
    kt = k.reshape(C, 9)[:, t]
    if pid is None:
        return kt[0]
    p = pid[rows, cols].long()
    return torch.where((p >= 0) & (p < C), kt[p.clamp(0, C - 1)], 0.0)


def x5_chain(t, p, C: int, single: bool):
    """The partial sum X5 adds tap ``t`` of a node of pattern id ``p`` to,
    in the order the JAX package's convolution sums on the CPU (XLA's
    contraction over the split's 9 C (tap, channel) products, index t C +
    p): eight chains by index mod 8 over the first 8 floor(9 C / 8)
    indices, a ninth (8) over the rest; one chain (0) where the batch has
    at most two coarse interior nodes."""
    if single:
        return torch.zeros_like(p)
    k = t * C + p
    return torch.where(k < 9 * C - 9 * C % 8, k % 8, 8)


def learned_restrict_plain(r, pid, k, w, out=None):
    """X5: the learned restriction (N, n+1, n+1) -> (N, n/2+1, n/2+1),
    f_c(I, J) = w[0] sum_{a,b} k[pid(y, x), a, b] r(y, x) with y = 2I - 1 +
    a, x = 2J - 1 + b on the coarse interior (the JAX package's crop and
    VALID stride-2 correlation), 0 on the ring; ``pid``: the fine level's
    ids.  Rounded as the JAX package's convolution rounds it on the CPU
    (bit for bit at 16 channels and at one): each product added to its
    chain (:func:`x5_chain`) by a fused multiply-add in tap order (taken in
    float64, where the product is exact, and rounded to float32), the
    chains summed ((0 + 1) + (4 + 5)) + ((2 + 3) + (6 + 7)), then + chain 8,
    w[0] last.  A float64 r sums in float64 (and autograd sees through
    it)."""
    N, n, C = r.shape[0], r.shape[-1] - 1, k.shape[0]
    m = n // 2 - 1  # coarse interior nodes a side
    acc = r.new_zeros((9, N, m, m))
    for a in range(3):
        for b in range(3):
            rows, cols = slice(1 + a, 2 * m + a, 2), slice(1 + b, 2 * m + b, 2)
            p = (torch.zeros((m, m), dtype=torch.long, device=r.device) if pid is None
                 else pid[rows, cols].long())
            q = x5_chain(3 * a + b, p, C, N * m * m <= 2).expand(1, N, m, m)
            prod = _tap(k, pid, 3 * a + b, rows, cols).double() * r[..., rows, cols].double()
            acc = acc.scatter(0, q, (acc.gather(0, q).double() + prod).to(r.dtype))
    s = ((acc[0] + acc[1]) + (acc[4] + acc[5])) + ((acc[2] + acc[3]) + (acc[6] + acc[7]))
    fc = r.new_zeros((N, n // 2 + 1, n // 2 + 1))
    fc[:, 1:-1, 1:-1] = w[0] * (s + acc[8])
    return sw._emit(fc, out)


def learned_prolong_add_plain(u, v, pid_c, k, w, out=None):
    """X6: u + w[1] P(v), P the learned prolongation (the stride-2
    transposed convolution, padding 1, of the pattern-split v) in gather
    form: fine index p = 2c + t - 1 takes tap t of coarse node c with the
    kernel of c's pattern id; ``pid_c``: the coarse level's ids.  Rounded as
    the JAX package's dilated convolution with the flipped kernel rounds it
    on the CPU: the products summed from 0 in reverse tap order, w[1] last,
    then the add."""
    m, H = v.shape[-1], u.shape[-1]
    # by tap t: the coarse nodes c with 0 <= 2c + t - 1 <= H - 1, and theirs
    src = (slice(1, m), slice(0, m), slice(0, m - 1))
    dst = (slice(1, H - 1, 2), slice(0, H, 2), slice(1, H - 1, 2))
    P = torch.zeros(u.shape, dtype=u.dtype, device=u.device)
    for t in (2, 1, 0):
        for s in (2, 1, 0):
            P[..., dst[t], dst[s]] += (_tap(k, pid_c, 3 * t + s, src[t], src[s])
                                       * v[..., src[t], src[s]])
    return sw._emit(u + w[1] * P, out)


def _bins(p, prod, C: int):
    """(C,) float64: the sums of ``prod`` (N, m, m) over the samples and the
    nodes of each id of ``p`` (m, m; None: all in channel 0), ids outside
    [0, C) in none."""
    s = prod.sum(0)
    out = torch.zeros(C, dtype=torch.float64, device=prod.device)
    if p is None:
        out[0] = s.sum()
        return out
    p = p.long()
    keep = (p >= 0) & (p < C)
    return out.index_add_(0, p[keep], s[keep])


def _weight_grads(P, k, w, which: int):
    """(grad k = w[which] P, grad w = sum k P at ``which`` and 0 at the
    other) from the (C, 9) float64 sums P, in k's type."""
    P = P.to(k.dtype)
    gk = (w[which] * P).reshape(k.shape)
    dot = (k.reshape(-1, 9).double() * P.double()).sum().to(w.dtype)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    return gk, torch.stack([dot, zero] if which == 0 else [zero, dot])


def weight_grad_plain(partial, k, w, which: int):
    """X9: (grad k, grad w) from rows of partial sums of the (C, 9) weights
    (X7's or X8's, one row a block), added in float64; ``which``: 0 for
    X7's (w[0]), 1 for X8's (w[1])."""
    return _weight_grads(partial.double().sum(0).reshape(-1, 9), k, w, which)


def learned_restrict_backward_plain(g, r, pid, k, w):
    """X7 and X9: the backward of X5 -> (grad r, grad k, grad w) from the
    gradient ``g`` (N, n/2+1, n/2+1) of its output; grad r(p) = w[0] sum
    k[pid(p), a, b] g(I, J) over the coarse interior nodes (I, J) with p =
    (2I - 1 + a, 2J - 1 + b), summed from 0 in tap order, w[0] last, 0 on
    the fine ring; the weight sums P in float64 (:func:`_weight_grads`).
    Any float type."""
    n, C = r.shape[-1] - 1, k.shape[0]
    m = n // 2 - 1
    gi = g[..., 1:-1, 1:-1]
    acc = torch.zeros_like(r)
    P = torch.zeros((C, 9), dtype=torch.float64, device=r.device)
    for a in range(3):
        for b in range(3):
            rows, cols = slice(1 + a, 2 * m + a, 2), slice(1 + b, 2 * m + b, 2)
            acc[..., rows, cols] += _tap(k, pid, 3 * a + b, rows, cols) * gi
            P[:, 3 * a + b] = _bins(None if pid is None else pid[rows, cols],
                                    gi.double() * r[..., rows, cols].double(), C)
    gr = torch.zeros_like(r)
    gr[..., 1:-1, 1:-1] = w[0] * acc[..., 1:-1, 1:-1]
    return (gr, *_weight_grads(P, k, w, 0))


def learned_prolong_add_backward_plain(g, v, pid_c, k, w):
    """X8 and X9: the backward of X6 -> (grad v, grad k, grad w) from the
    gradient ``g`` (N, n+1, n+1) of its output (grad u is g itself); grad
    v(c) = w[1] sum_t k[pid_c(c), t] g(2c + t - 1), g zero off the grid,
    summed from 0 in tap order, w[1] last; the weight sums Q in float64.
    Any float type."""
    m, C = v.shape[-1], k.shape[0]
    gp = F.pad(g, (1, 1, 1, 1))  # fine index 2c + t - 1 at 2c + t
    acc = torch.zeros_like(v)
    Q = torch.zeros((C, 9), dtype=torch.float64, device=v.device)
    every = slice(None)
    for t in range(3):
        for s in range(3):
            gt = gp[..., t:t + 2 * m - 1:2, s:s + 2 * m - 1:2]
            acc += _tap(k, pid_c, 3 * t + s, every, every) * gt
            Q[:, 3 * t + s] = _bins(pid_c, v.double() * gt.double(), C)
    return (w[1] * acc, *_weight_grads(Q, k, w, 1))


# ---------------------------------------------------------------------------
# CUDA kernels: wrappers.
# ---------------------------------------------------------------------------


def _field(t, name, shape, dtype, device):
    """Check a contiguous CUDA field of ``shape`` and ``dtype`` on ``device``."""
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, not {t.device} ones")
    sw._check(t, name, shape, dtype, device)


def _grid(x, name):
    """n of an (n+1, n+1) field."""
    if x.dim() != 2 or x.shape[0] != x.shape[1] or x.shape[0] < 2:
        raise ValueError(f"{name} must be an (n+1, n+1) field, got {tuple(x.shape)}")
    return x.shape[0] - 1


def _even(n):
    if n < 2 or n % 2:
        raise ValueError(f"the transfers take an even n >= 2, got n={n}")


def _kernel_form(pid, a0, a1, table):
    """(pid or None, the (3, 3) table's 9 numbers) of a form the kernels
    take: the bitplane form or the homogeneous stencil."""
    if pid is not None:
        if a0 is None or a1 is None:
            raise ValueError("the kernels take the two-phase bitplane form (pid with a0 and "
                             "a1) or a homogeneous table, not a gathered pattern table")
        return pid, (0.0,) * 9
    t = np.asarray(table, dtype=np.float64)
    if t.shape != (3, 3):
        raise ValueError(f"a homogeneous operator is a (3, 3) table, not {t.shape}")
    return None, tuple(float(x) for x in t.reshape(-1))


def _s4():
    """S4's (centre, edge, corner) and S9's taps in dict order."""
    sw_taps = list(stencil.UNIT_S4[0].values())
    return (sw_taps[0], sw_taps[1], sw_taps[3]), tuple(stencil.UNIT_S9[k] for k in S9_ORDER)


def _repeats(m, s9, d4) -> bool:
    """Whether the weights repeat as the row-streaming X1 takes them: the
    mass stencil's four corners equal, and its four edges; S9's eight
    neighbour taps equal, and equal to S4's corner d4.  Each product of a
    node with such a weight then serves every tap that weight has there."""
    return (m[0] == m[2] == m[6] == m[8] and m[1] == m[3] == m[5] == m[7]
            and all(x == d4 for x in s9[1:]))


@functools.lru_cache(maxsize=64)
def _rhs_weights(h, theta, dt, a0, a1, k9, f64=False):
    """X1's RhsW (csrc/passes.cu) in its arithmetic type, as the plain
    version rounds each: a scalar multiplies a field in the field's type
    (float32, or float64 when ``f64``).  Raises if the weights do not repeat
    as the row-streaming kernel assumes (:func:`_repeats`)."""
    dtype = torch.float64 if f64 else torch.float32
    m = ((h * h) * torch.as_tensor(stencil.MASS_KERNEL, dtype=dtype)).reshape(-1)
    (c4, e4, d4), s9 = _s4()
    da = 0.0 if a0 is None else float(a1) - float(a0)
    vals = (*m.tolist(), *k9, *s9, c4, e4, d4, 0.0 if a0 is None else float(a0), da, theta,
            1.0 - theta, (1.0 - theta) * dt, dt)
    if not f64:
        vals = np.asarray(vals, dtype=np.float32).tolist()
    if not _repeats(vals[:9], vals[18:27], vals[29]):
        raise ValueError("X1's mass and stiffness weights do not repeat as its kernels take them")
    return ((ctypes.c_double if f64 else ctypes.c_float) * 36)(*vals)


@functools.lru_cache(maxsize=64)
def _outer_weights(a0, a1, k9):
    """X4's OuterW (csrc/passes.cu) in float64."""
    (c4, e4, d4), s9 = _s4()
    da = 0.0 if a0 is None else float(a1) - float(a0)
    return (ctypes.c_double * 23)(*k9, *s9, c4, e4, d4, 0.0 if a0 is None else float(a0), da)


def _pid(pid, n, device):
    if pid is not None:
        _field(pid, "pid", (n + 1, n + 1), torch.int8, device)
    return sw._ptr(pid)


# X1's u (and b) types, as px_heat_rhs numbers them
_U_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}

# Launch geometry of X1 (csrc/passes.cu).  Levels of up to this many
# elements per side, by (whether X1 computes in float64, bi-material), run
# its one-pass tiles (x1_heat_rhs, 32 x 8 nodes a block); above, row-
# streaming strips (x1_heat_rhs_rows).  The largest size at which the tile
# was the faster on the H100 (``sweep_vs_parent.py --crossover --legs x1``,
# PERF.md): up to there a grid of short strips fills a wave or less, each
# block a chain of dependent steps; the homogeneous float64 instance, bound
# by its float64 operations, kept the tile at every size measured (the row
# stream mixes the source at its halo nodes too).
X1_ONE_PASS_MAX_N = {(False, True): 512, (False, False): 512, (True, True): 1024,
                     (True, False): 4096}
X1_HALO_STEPS = 2  # steps a block takes beyond its strip: the rows above and below it
X1_MIN_STRIP = 8


def x1_tiles(n: int, strip: int = sw.A12_STRIP) -> sw.Tiles:
    """X1 row streaming: a block owns the ``A12_THREADS A12_COLUMNS``
    columns its threads cover (csrc/common.cuh's RB) and ``strip`` rows."""
    sw._check_strip(strip)
    H, band = n + 1, sw.A12_THREADS * sw.A12_COLUMNS
    return sw.Tiles("X1", n, band, strip, -(-H // band), -(-H // strip))


def x1_one_pass_tiles(n: int) -> sw.Tiles:
    """X1 on one-pass tiles: one block per 32 x 8 nodes."""
    H = n + 1
    return sw.Tiles("X1_tile", n, 32, 8, -(-H // 32), -(-H // 8))


def x1_strip(n: int, slots: int) -> int:
    """The even strip height in [X1_MIN_STRIP, A12_STRIP_MAX] that finishes
    the level soonest on a card that holds ``slots`` blocks at once: A1's
    cost (``ops/sweep.py::balanced_strip``), whole waves of blocks each
    taking strip + X1_HALO_STEPS steps, so that the grid fills its last
    wave."""
    best = None
    for strip in range(X1_MIN_STRIP, sw.A12_STRIP_MAX + 1, 2):
        waves = -(-x1_tiles(n, strip).blocks // max(1, slots))
        cost = waves * (strip + X1_HALO_STEPS)
        if best is None or cost < best[0]:
            best = (cost, strip)
    return best[1]


_X1_TILES = {}


def x1_launch_tiles(n: int, u_type: int, f64: bool, bim: bool, one_f: bool,
                    device) -> sw.Tiles:
    """The geometry X1 launches with on ``device``: one-pass tiles up to
    ``X1_ONE_PASS_MAX_N[(f64, bim)]``, else row-streaming strips of
    :func:`x1_strip`'s height for the blocks per SM the card reports for the
    instance launched (``u_type`` as px_heat_rhs numbers it, computed once
    per level shape)."""
    if n <= X1_ONE_PASS_MAX_N[(bool(f64), bool(bim))]:
        return x1_one_pass_tiles(n)
    key = (n, u_type, bool(f64), bool(bim), bool(one_f), device.index)
    tiles = _X1_TILES.get(key)
    if tiles is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        slots = sms * hx.occupancy("px_heat_rhs_occupancy", u_type, int(f64), int(bim),
                                   int(one_f))
        tiles = _X1_TILES[key] = x1_tiles(n, x1_strip(n, slots))
    return tiles


def _aligned(t):
    """``t``, or a copy of it that starts on a 16-byte boundary: the row
    stream stages a field's rows in 16-byte chunks counted from its start,
    and a knot of a stacked time-dependent f may start anywhere."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def heat_rhs_cuda(u, f0, f1, pid=None, *, h, theta, dt, a0=None, a1=None, table=None,
                  out=None):
    """X1 on the card; same contract as :func:`heat_rhs_plain`, with f0 and
    f1 both float32 or both float64 (they may be one tensor, which the row
    stream then reads once), ``u`` float32, bf16 or (with float64 f)
    float64, and ``out`` of u's type.  The design is chosen by size
    (:func:`x1_launch_tiles`); a field the row stream takes that does not
    start on a 16-byte boundary is copied first."""
    n, dev = _grid(u, "u"), u.device
    if u.dtype not in _U_TYPES:
        raise ValueError(f"u must be float32, bfloat16 or float64, not {u.dtype}")
    if f0.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"f0 and f1 must be float32 or float64, not {f0.dtype}")
    if u.dtype == torch.float64 and f0.dtype != torch.float64:
        raise ValueError("a float64 u takes float64 f0 and f1")
    _field(u, "u", (n + 1, n + 1), u.dtype, dev)
    _field(f0, "f0", (n + 1, n + 1), f0.dtype, dev)
    _field(f1, "f1", (n + 1, n + 1), f0.dtype, dev)
    pid, k9 = _kernel_form(pid, a0, a1, table)
    out = sw._output(out, "out", (n + 1, n + 1), dev, (u, f0, f1), u.dtype)
    f64, one_f = f0.dtype == torch.float64, f0.data_ptr() == f1.data_ptr()
    w = _rhs_weights(float(h), float(theta), float(dt), a0, a1, k9, f64)
    tiles = x1_launch_tiles(n, _U_TYPES[u.dtype], f64, pid is not None, one_f, dev)
    one_pass = tiles.leg == "X1_tile"
    if not one_pass:
        u, pid, f0 = _aligned(u), _aligned(pid), _aligned(f0)
        f1 = f0 if one_f else _aligned(f1)
    KERNELS["X1"](u.data_ptr(), f0.data_ptr(), f1.data_ptr(), _pid(pid, n, dev), out.data_ptr(),
                  n, w, _U_TYPES[u.dtype], int(f64), int(one_pass), tiles.strip, tiles.gx,
                  tiles.gy, sw._stream(dev))
    return out


def restrict_cuda(r, out=None):
    """X2 on the card; same contract as :func:`restrict_plain` (float32)."""
    n, dev = _grid(r, "r"), r.device
    _even(n)
    _field(r, "r", (n + 1, n + 1), torch.float32, dev)
    out = sw._output(out, "out", (n // 2 + 1, n // 2 + 1), dev, (r,))
    KERNELS["X2"](r.data_ptr(), out.data_ptr(), n, sw._stream(dev))
    return out


def prolong_add_cuda(u, uc, geo, out=None):
    """X3 on the card; same contract as :func:`prolong_add_plain` (float32)."""
    n, dev = _grid(u, "u"), u.device
    _even(n)
    _field(u, "u", (n + 1, n + 1), torch.float32, dev)
    _field(uc, "uc", (n // 2 + 1, n // 2 + 1), torch.float32, dev)
    _field(geo, "geo", (n + 1, n + 1), torch.float32, dev)
    out = sw._output(out, "out", (n + 1, n + 1), dev, (u, uc, geo))
    KERNELS["X3"](u.data_ptr(), uc.data_ptr(), geo.data_ptr(), out.data_ptr(), n,
                  sw._stream(dev))
    return out


def outer_blocks(n: int) -> int:
    """Blocks of one X4 launch on an (n+1)^2 grid: csrc/passes.cu's tiles of
    32 x 8 nodes."""
    return -(-(n + 1) // 32) * -(-(n + 1) // 8)


def outer_step_cuda(u, e, f, geo, pid=None, *, a0=None, a1=None, table=None, out=None,
                    workspace=None):
    """X4 on the card; same contract as :func:`outer_step_plain`: ``u``,
    ``f``, ``geo`` (and ``out``) float64, ``e`` float32 or bf16;
    ``workspace`` (a dict) keeps the scratch of the norm between calls."""
    n, dev = _grid(u, "u"), u.device
    _field(u, "u", (n + 1, n + 1), torch.float64, dev)
    if e.dtype not in sw.STORAGE:
        raise ValueError(f"e must be float32 or bfloat16, not {e.dtype}")
    _field(e, "e", (n + 1, n + 1), e.dtype, dev)
    _field(f, "f", (n + 1, n + 1), torch.float64, dev)
    _field(geo, "geo", (n + 1, n + 1), torch.float64, dev)
    pid, k9 = _kernel_form(pid, a0, a1, table)
    out = sw._output(out, "out", (n + 1, n + 1), dev, (u, f, geo), torch.float64)
    r32 = torch.empty((n + 1, n + 1), dtype=torch.float32, device=dev)
    rsq = torch.empty((), dtype=torch.float64, device=dev)
    partial, done = sw._block_scratch(("X4", n), outer_blocks(n), dev, workspace,
                                      torch.float64)
    KERNELS["X4"](u.data_ptr(), e.data_ptr(), f.data_ptr(), geo.data_ptr(), _pid(pid, n, dev),
                  out.data_ptr(), r32.data_ptr(), partial.data_ptr(), done.data_ptr(),
                  rsq.data_ptr(), n, _outer_weights(a0, a1, k9), sw.STORAGE[e.dtype],
                  sw._stream(dev))
    return out, r32, rsq


def _batch(t, name, H, device):
    """Check an (N, H, H) float32 field on the card for X5 and X6: rows
    compact, samples at least a plane apart; its (N, values between two
    samples)."""
    if t.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected torch.float32")
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, not {t.device} ones")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dim() != 3 or tuple(t.shape[1:]) != (H, H) or not 1 <= t.shape[0] <= 65535:
        raise ValueError(f"{name} must be an (N, {H}, {H}) batch, got {tuple(t.shape)}")
    N = t.shape[0]
    if t.stride(2) != 1 or t.stride(1) != H or (N > 1 and t.stride(0) < H * H):
        raise ValueError(f"{name}'s rows must be compact and its samples a plane apart")
    return N, t.stride(0) if N > 1 else H * H


def _batch_out(out, N, H, device, inputs):
    if out is None:
        return torch.empty((N, H, H), dtype=torch.float32, device=device)
    if tuple(out.shape) != (N, H, H):
        raise ValueError(f"out has shape {tuple(out.shape)}, expected {(N, H, H)}")
    if any(x.data_ptr() == out.data_ptr() for x in inputs):
        raise ValueError("out must not alias an input")
    return out


def _weights(k, w, device):
    """Check the learned transfers' (C, 3, 3) kernels and w; C."""
    C = k.shape[0] if k.dim() == 3 else 0
    _field(k, "k", (C, 3, 3), torch.float32, device)
    _field(w, "w", (2,), torch.float32, device)
    if not 1 <= C <= LK_MAX:
        raise ValueError(f"the learned transfers take 1 to {LK_MAX} channels, not {C}")
    return C


def _learned_operands(pid, k, w, H, device):
    """Check X5's to X8's pattern ids (H x H) and weights; C."""
    C = _weights(k, w, device)
    if pid is None and C != 1:
        raise ValueError(f"a homogeneous level (pid None) takes one channel, not {C}")
    if pid is not None:
        _field(pid, "pid", (H, H), torch.int8, device)
    return C


def learned_restrict_cuda(r, pid, k, w, out=None):
    """X5 on the card; same contract as :func:`learned_restrict_plain`: r
    (and ``out``) float32 batches of compact rows, samples any number of
    values apart; ``k`` (C, 3, 3) and ``w`` (2,) float32 on the card."""
    dev = r.device
    n = r.shape[-1] - 1
    _even(n)
    N, sr = _batch(r, "r", n + 1, dev)
    C = _learned_operands(pid, k, w, n + 1, dev)
    out = _batch_out(out, N, n // 2 + 1, dev, (r,))
    _, so = _batch(out, "out", n // 2 + 1, dev)
    KERNELS["X5"](r.data_ptr(), sw._ptr(pid), k.data_ptr(), w.data_ptr(), out.data_ptr(), n, C,
                  N, sr, so, sw._stream(dev))
    return out


def learned_prolong_add_cuda(u, v, pid_c, k, w, out=None):
    """X6 on the card; same contract as :func:`learned_prolong_add_plain`:
    u, v (and ``out``) float32 batches of compact rows, samples any number
    of values apart; ``k`` (C, 3, 3) and ``w`` (2,) float32 on the card."""
    dev = u.device
    n = u.shape[-1] - 1
    _even(n)
    N, su = _batch(u, "u", n + 1, dev)
    Nv, sv = _batch(v, "v", n // 2 + 1, dev)
    if Nv != N:
        raise ValueError(f"u holds {N} samples and v {Nv}")
    C = _learned_operands(pid_c, k, w, n // 2 + 1, dev)
    out = _batch_out(out, N, n + 1, dev, (u, v))
    _, so = _batch(out, "out", n + 1, dev)
    KERNELS["X6"](u.data_ptr(), v.data_ptr(), sw._ptr(pid_c), k.data_ptr(), w.data_ptr(),
                  out.data_ptr(), n, C, N, su, sv, so, sw._stream(dev))
    return out


# X7's and X8's launch geometry (csrc/passes.cu bwd_blocks): a warp takes a
# band of BWD_LANES columns of coarse cells or nodes and a strip of the
# batch's coarse rows laid end to end, BWD_WARPS warps a block
BWD_LANES, BWD_WARPS = 32, 8
# blocks of 256 threads an SM holds at most (2048 threads): X7's and X8's
# blocks, X9's rows, stay within one such wave of the card
BWD_WAVE_BLOCKS = 8
BwdTiles = collections.namedtuple("BwdTiles", "strip blocks")


def bwd_blocks(n: int, N: int, strip: int) -> int:
    """Blocks of one X7 or X8 launch on a batch of N at level n in strips
    of ``strip`` rows: the rows of partial weight sums X9 adds."""
    Hc = n // 2 + 1
    return -(-(-(-Hc // BWD_LANES) * -(-N * Hc // strip)) // BWD_WARPS)


def bwd_strip(n: int, N: int, sms: int) -> int:
    """The shortest even strip (2 up to ``A12_STRIP_MAX`` rows) whose
    blocks, X9's rows, fit in BWD_WAVE_BLOCKS a card of ``sms`` SMs.

    Not ``ops/hrelax.py::row_strip``'s cost: for X7 at 4097^2 (3 blocks
    an SM) it picks one wave of 44-row strips with a halo of 1 to 3 steps,
    and 2-row strips (8329 partial rows) with none.  X7 and X8 carry no
    halo and no barrier a step, their blocks finish as their warps do, and
    the card balances many waves of short chains.  At
    4097^2 on the H100 X7 took 0.082 ms in strips of 16 rows, 0.095 in 32
    and 0.129 in 64 (``sweep_vs_parent.py --strip-scan --legs x7x8``,
    PERF.md); X9 takes longer the more rows it adds (0.013 ms on 16 rows'
    1049, 0.020 on 8 rows' 2089), so the shortest strip stops at one wave
    of blocks.  On the training step's levels that is 2 rows."""
    for strip in range(2, sw.A12_STRIP_MAX + 1, 2):
        if bwd_blocks(n, N, strip) <= BWD_WAVE_BLOCKS * sms:
            return strip
    return sw.A12_STRIP_MAX


_BWD_TILES = {}


def bwd_launch_tiles(n: int, N: int, device) -> BwdTiles:
    """The geometry X7 and X8 launch with on ``device`` for a batch of N at
    level n: :func:`bwd_strip`'s strip for the card's SMs."""
    key = (n, N, device.index)
    tiles = _BWD_TILES.get(key)
    if tiles is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        strip = bwd_strip(n, N, sms)
        tiles = _BWD_TILES[key] = BwdTiles(strip, bwd_blocks(n, N, strip))
    return tiles


def bwd_occupancy(key: str, C: int) -> int:
    """Blocks of X7 (``key`` "X7") or X8 with C channels' shared memory that
    one SM of the card holds at once (what ``chip_smoke.py`` reports)."""
    return hx.occupancy("px_learned_bwd_occupancy", int(key == "X8"), C)


def weight_grad_cuda(partial, k, w, which: int, gk=None, gw=None):
    """X9 on the card; same contract as :func:`weight_grad_plain`:
    ``partial`` float32 (blocks, 9 C), k (C, 3, 3) and w (2,) float32, into
    ``gk`` and ``gw`` when given."""
    dev = partial.device
    C = _weights(k, w, dev)
    if partial.dim() != 2 or partial.shape[1] != 9 * C or partial.shape[0] < 1:
        raise ValueError(f"partial must be (blocks, {9 * C}), got {tuple(partial.shape)}")
    _field(partial, "partial", tuple(partial.shape), torch.float32, dev)
    gk = sw._output(gk, "gk", tuple(k.shape), dev, (partial, k, w))
    gw = sw._output(gw, "gw", (2,), dev, (partial, k, w, gk))
    KERNELS["X9"](partial.data_ptr(), partial.shape[0], C, k.data_ptr(), w.data_ptr(), which,
                  gk.data_ptr(), gw.data_ptr(), sw._stream(dev))
    return gk, gw


def learned_restrict_bwd_cuda(g, r, pid, k, w, gr=None, partial=None):
    """X7 alone -> (grad r, its blocks' partial weight sums), into ``gr``
    and ``partial`` when given: g and r float32 batches of compact rows,
    samples any number of values apart."""
    dev = r.device
    n = r.shape[-1] - 1
    _even(n)
    N, sr = _batch(r, "r", n + 1, dev)
    Ng, sg = _batch(g, "g", n // 2 + 1, dev)
    if Ng != N:
        raise ValueError(f"r holds {N} samples and g {Ng}")
    C = _learned_operands(pid, k, w, n + 1, dev)
    gr = sw._output(gr, "gr", (N, n + 1, n + 1), dev, (g, r))
    tiles = bwd_launch_tiles(n, N, dev)
    partial = sw._output(partial, "partial", (tiles.blocks, 9 * C), dev, (g, r, gr))
    KERNELS["X7"](g.data_ptr(), r.data_ptr(), sw._ptr(pid), k.data_ptr(), w.data_ptr(),
                  gr.data_ptr(), partial.data_ptr(), n, C, N, *tiles, sg, sr, (n + 1) ** 2,
                  sw._stream(dev))
    return gr, partial


def learned_prolong_bwd_cuda(g, v, pid_c, k, w, gv=None, partial=None):
    """X8 alone -> (grad v, its blocks' partial weight sums), into ``gv``
    and ``partial`` when given: g and v float32 batches of compact rows,
    samples any number of values apart."""
    dev = g.device
    n = g.shape[-1] - 1
    _even(n)
    N, sg = _batch(g, "g", n + 1, dev)
    Nv, sv = _batch(v, "v", n // 2 + 1, dev)
    if Nv != N:
        raise ValueError(f"g holds {N} samples and v {Nv}")
    C = _learned_operands(pid_c, k, w, n // 2 + 1, dev)
    gv = sw._output(gv, "gv", (N, n // 2 + 1, n // 2 + 1), dev, (g, v))
    tiles = bwd_launch_tiles(n, N, dev)
    partial = sw._output(partial, "partial", (tiles.blocks, 9 * C), dev, (g, v, gv))
    KERNELS["X8"](g.data_ptr(), v.data_ptr(), sw._ptr(pid_c), k.data_ptr(), w.data_ptr(),
                  gv.data_ptr(), partial.data_ptr(), n, C, N, *tiles, sg, sv,
                  (n // 2 + 1) ** 2, sw._stream(dev))
    return gv, partial


def learned_restrict_backward_cuda(g, r, pid, k, w):
    """X7 and X9 on the card; same contract as
    :func:`learned_restrict_backward_plain` (float32)."""
    gr, partial = learned_restrict_bwd_cuda(g, r, pid, k, w)
    return (gr, *weight_grad_cuda(partial, k, w, 0))


def learned_prolong_add_backward_cuda(g, v, pid_c, k, w):
    """X8 and X9 on the card; same contract as
    :func:`learned_prolong_add_backward_plain` (float32)."""
    gv, partial = learned_prolong_bwd_cuda(g, v, pid_c, k, w)
    return (gv, *weight_grad_cuda(partial, k, w, 1))


# ---------------------------------------------------------------------------
# Dispatch: the plain version on the CPU, the kernel on the card.
# ---------------------------------------------------------------------------


def operator_form(level) -> dict:
    """The operator of a ``core.problem.Level`` as these passes take it:
    ``pid``, ``a0``, ``a1`` (two-phase) or ``pid`` and a nested ``table`` of
    host numbers (homogeneous, or a gathered pattern table, which only the
    plain versions take).  Reads a homogeneous table from the device once;
    raises for the phase-affine form (``base``)."""
    if level.base is not None:
        raise ValueError("the passes do not take the phase-affine operator form (base)")
    if level.pid is not None and level.a0 is not None:
        return dict(pid=level.pid, a0=float(level.a0), a1=float(level.a1))
    table = level.table.cpu().tolist()

    def freeze(x):
        return tuple(freeze(y) for y in x) if isinstance(x, list) else x

    return dict(pid=level.pid, table=freeze(table))


def heat_rhs(u, f0, f1, *, h, theta, dt, out=None, **form):
    """X1 (kernel on CUDA tensors, plain version on CPU ones)."""
    fn = heat_rhs_cuda if u.device.type == "cuda" else heat_rhs_plain
    return fn(u, f0, f1, h=h, theta=theta, dt=dt, out=out, **form)


def restrict(r, out=None):
    """X2 (kernel on CUDA tensors, plain version on CPU ones)."""
    return (restrict_cuda if r.device.type == "cuda" else restrict_plain)(r, out)


def prolong_add(u, uc, geo, out=None):
    """X3 (kernel on CUDA tensors, plain version on CPU ones)."""
    return (prolong_add_cuda if u.device.type == "cuda" else prolong_add_plain)(u, uc, geo, out)


def outer_step(u, e, f, geo, out=None, workspace=None, **form):
    """X4 (kernel on CUDA tensors, plain version on CPU ones; ``workspace``
    keeps the kernel's scratch)."""
    if u.device.type == "cuda":
        return outer_step_cuda(u, e, f, geo, out=out, workspace=workspace, **form)
    return outer_step_plain(u, e, f, geo, out=out, **form)


def learned_restrict(r, pid, k, w, out=None):
    """X5 (kernel on CUDA tensors, plain version on CPU ones)."""
    fn = learned_restrict_cuda if r.device.type == "cuda" else learned_restrict_plain
    return fn(r, pid, k, w, out)


def learned_prolong_add(u, v, pid_c, k, w, out=None):
    """X6 (kernel on CUDA tensors, plain version on CPU ones)."""
    fn = learned_prolong_add_cuda if u.device.type == "cuda" else learned_prolong_add_plain
    return fn(u, v, pid_c, k, w, out)


def learned_restrict_backward(g, r, pid, k, w):
    """X7 and X9 (kernels on CUDA tensors, plain version on CPU ones)."""
    fn = (learned_restrict_backward_cuda if r.device.type == "cuda"
          else learned_restrict_backward_plain)
    return fn(g, r, pid, k, w)


def learned_prolong_add_backward(g, v, pid_c, k, w):
    """X8 and X9 (kernels on CUDA tensors, plain version on CPU ones)."""
    fn = (learned_prolong_add_backward_cuda if v.device.type == "cuda"
          else learned_prolong_add_backward_plain)
    return fn(g, v, pid_c, k, w)
