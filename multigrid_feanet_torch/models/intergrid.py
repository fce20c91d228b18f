"""Learned inter-grid operators: trainable per-pattern restriction and
prolongation kernels inside the V-cycle.

Port of ``multigrid_feanet_tpu/models/intergrid.py`` (reference math:
FEANet/multigrid.py:50-184):

- restriction: 16 -> 1 channel stride-2 3x3 convolution over the
  pattern-split residual (crop the interior, convolve, zero-pad the ring),
  every channel initialised to full weighting / 16, scaled by w[0];
- prolongation: 16 -> 1 stride-2 3x3 transposed convolution (padding 1) of
  the pattern-split coarse correction, initialised to bilinear / 4, scaled
  by w[1];
- the V-cycle relaxes once, restricts the split residual, recurses from
  zero, adds the prolonged correction and relaxes again, also on the
  coarsest level (so it is relaxed twice); w = [4, 1] stays frozen in the
  reference.

The split is ``ops/stencil.split_by_pattern`` and channel k of the
parameters is the port's pid k (bit-encoded); ``import_torch_checkpoint``
permutes the reference's channel order into it.  :func:`restrict_learned`
and :func:`prolong_learned` are cuDNN convolutions in full f32
(``core/device.full_f32``) of the split, differentiable: the JAX package
computes them with ``lax.conv_general_dilated``, outside any Pallas kernel.
Fields are batched (N, H, W); the level's operator fields broadcast over N.

:func:`learned_v_cycle` runs on hand-written kernels (the kernel route)
whenever the fields and parameters are float32, at any batch size: on every
level that is not the coarsest and whose operator C1 takes (two-phase
bitplane or homogeneous; :func:`kernel_levels`), the relaxations are C1
sweeps and the residual C1's residual mode (``ops/stencil_sweep.py``, one
launch a batch, on per-sample planes of ``batch_plane`` values, each on a
16-byte boundary), the restriction is X5 and the prolongation-add X6
(``ops/passes.py``, one launch a batch), where the JAX package leaves the
transfers to XLA.  The coarsest level's double relaxation and float64 keep
the torch path above.  Grad mode picks the route's form: without a
gradient the cycle recycles per-level buffers (:meth:`_Route.cycle`); with
one every kernel level's operation is a ``torch.autograd.Function`` on
fresh outputs (:meth:`_Route.graded_cycle`): :class:`C1Sweep` and
:class:`C1Residual`, whose backward is two C1 launches, and
:class:`LearnedRestrict` and :class:`LearnedProlongAdd`, whose backward is
X7 or X8 and X9.  The route depends on dtype and sizes alone, never on the
device or a failure: a kernel that fails to build or launch raises.  On
CPU fields the route computes the JAX package's eager cycle op for op, bit
for bit at 16 channels and at one: the sweep and the residual with
``Level.apply`` and ``jacobi_step``'s weight omega / diag(A) (divided, as
the JAX package divides it), the plain X5 and X6, which round as its
convolutions do on the CPU, and the plain X7, X8 and X9 backward.  C1 on
the card weights by its own diagonal (2/3)(4 a0 + da popcount) in
float32, an ulp above the table's on nodes of four phase-1 elements, and
sums A u in the Pallas kernel's order: it agrees with ``jacobi_step`` to
``ops.sweep.TOL`` on the cycle's zero ring, and its backward uses the same
diagonal, the exact adjoint of what ran forward.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multigrid_feanet_torch.core.device import full_f32, resolve_device
from multigrid_feanet_torch.core.problem import GridHierarchy
from multigrid_feanet_torch.ops import passes, stencil
from multigrid_feanet_torch.ops.stencil_sweep import StencilLevel, batch_plane
from multigrid_feanet_torch.solvers.jacobi import DEFAULT_OMEGA, interior_norm, relax

FULL_WEIGHTING_16 = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=np.float32) / 16.0
BILINEAR_4 = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=np.float32) / 4.0

class IntergridParams(nn.Module):
    """``conv`` (C, 3, 3) restriction kernels (channel = pid), ``deconv``
    (C, 3, 3) prolongation kernels, ``w`` (2,) the restrict / prolong ratio
    (frozen [4, 1] in the reference, FEANet/multigrid.py:94-100)."""

    def __init__(self, conv: torch.Tensor, deconv: torch.Tensor, w: torch.Tensor):
        super().__init__()
        self.conv = nn.Parameter(conv)
        self.deconv = nn.Parameter(deconv)
        self.w = nn.Parameter(w)

    @classmethod
    def init(cls, num_patterns: int = 16, dtype=torch.float32, device=None) -> "IntergridParams":
        """Every channel full weighting / 16 and bilinear / 4, w = [4, 1],
        on ``device`` (None means CUDA)."""
        device = resolve_device(device)

        def channels(k):
            return torch.as_tensor(k, dtype=dtype, device=device).repeat(num_patterns, 1, 1)

        return cls(channels(FULL_WEIGHTING_16), channels(BILINEAR_4),
                   torch.tensor([4.0, 1.0], dtype=dtype, device=device))


def _split(x: torch.Tensor, pid: Optional[torch.Tensor], num_patterns: int) -> torch.Tensor:
    """(N, H, W) -> (N, C, H, W) pattern split; a single channel, the field
    itself, when ``pid`` is None (the single-pattern MeshSquare split)."""
    if pid is None:
        return x[:, None]
    return stencil.split_by_pattern(x, pid, num_patterns)


def restrict_learned(params: IntergridParams, r: torch.Tensor,
                     pid: Optional[torch.Tensor]) -> torch.Tensor:
    """w[0] * (crop the interior -> per-pattern stride-2 convolution ->
    zero-pad the ring): (N, H, W) fine residual -> (N, Hc, Wc) coarse RHS.
    (reference: MultiGrid.Restrict, FEANet/multigrid.py:115-122, and w[0])"""
    C = params.conv.shape[0]
    split = _split(r, pid, C)[..., 1:-1, 1:-1]
    with full_f32():
        out = F.conv2d(split, params.conv[None].to(r.dtype), stride=2)[:, 0]
    return params.w[0] * F.pad(out, (1, 1, 1, 1))


def prolong_learned(params: IntergridParams, v_c: torch.Tensor,
                    pid_c: Optional[torch.Tensor]) -> torch.Tensor:
    """w[1] * ConvTranspose2d(split coarse v; k = 3, s = 2, p = 1):
    (N, m, m) -> (N, 2m-1, 2m-1).  ``conv_transpose2d`` flips the kernel
    itself, so ``deconv`` goes in as the reference's weight, (C, 1, 3, 3);
    the JAX package flips it by hand for its dilated correlation.
    (reference: MultiGrid.Interpolate, FEANet/multigrid.py:124-130, and w[1])"""
    C = params.deconv.shape[0]
    split = _split(v_c, pid_c, C)
    with full_f32():
        out = F.conv_transpose2d(split, params.deconv[:, None].to(v_c.dtype), stride=2,
                                 padding=1)[:, 0]
    return params.w[1] * out


def learned_v_cycle(hier: GridHierarchy, params: IntergridParams, u: torch.Tensor,
                    f: torch.Tensor, n_relax: int = 1, omega: float = DEFAULT_OMEGA,
                    level: int = 0) -> torch.Tensor:
    """One V-cycle with the learned split transfers on batched (N, H, W)
    fields: on the kernel route (module docstring) for float32 fields and
    parameters, in its autograd form where a gradient is needed; else in
    torch ops (the split and cuDNN), where only one level's split exists at
    a time: the restriction's is freed before the recursion.  (reference:
    MultiGrid.iterate, FEANet/multigrid.py:159-184)"""
    if not _kernel_route(params, u, f):
        return _torch_cycle(hier, params, u, f, n_relax, omega, level)
    route = _route(hier, omega)
    if _needs_grad(params.conv, params.deconv, params.w, u, f):
        return route.graded_cycle(params, u, f, n_relax, level)
    return route.cycle(params, u, f, n_relax, level)


def _torch_cycle(hier, params, u, f, n_relax, omega, level):
    lv = hier.levels[level]
    u = relax(lv, u, f, n_relax, 0.0, omega)
    if level < hier.num_levels - 1:
        f_c = restrict_learned(params, f - lv.apply(u), lv.pid)
        u_c = _torch_cycle(hier, params, torch.zeros_like(f_c), f_c, n_relax, omega, level + 1)
        u = u + prolong_learned(params, u_c, hier.levels[level + 1].pid)
    # unconditional post-relax: the reference relaxes the coarsest level a
    # second time after its creation-relax (FEANet/multigrid.py:173)
    return relax(lv, u, f, n_relax, 0.0, omega)


def _kernel_route(params: IntergridParams, u: torch.Tensor, f: torch.Tensor) -> bool:
    """Whether the kernel route takes the cycle: u and f float32 batches of
    one shape, the parameters float32 (grad mode picks its form)."""
    return _float32(params.conv, params.deconv, params.w) and _batches(u, f)


def _float32(*tensors) -> bool:
    return all(t.dtype == torch.float32 for t in tensors)


def _batches(*fields) -> bool:
    """Whether the fields are float32 (N, H, H) batches of one shape."""
    return (_float32(*fields) and fields[0].dim() == 3
            and all(x.shape == fields[0].shape for x in fields))


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _c1_coefficients(lv) -> Optional[tuple]:
    """The coefficients of a ``StencilLevel`` with lv's operator, or None
    where C1 cannot take it (a general table, the phase-affine form, a
    homogeneous table other than a multiple of the unit stencil)."""
    if lv.base is not None:
        return None
    if lv.pid is not None:
        return None if lv.a0 is None else (lv.a0, lv.a1)
    unit = torch.as_tensor(stencil.make_stencil_table_np((1.0, 1.0))[0], dtype=lv.table.dtype)
    a0 = float(lv.table[1, 1]) / float(unit[1, 1])
    return (a0, a0) if torch.equal(lv.table.cpu(), (a0 * unit).to(lv.table.dtype)) else None


def kernel_levels(hier: GridHierarchy) -> list:
    """The levels the kernel route runs on C1, X5 and X6: from the finest,
    every level but the coarsest while C1 takes its operator."""
    out = []
    for l, lv in enumerate(hier.levels[:-1]):
        if _c1_coefficients(lv) is None:
            break
        out.append(l)
    return out


def _buffer(N: int, H: int, device, dtype=torch.float32) -> torch.Tensor:
    """An (N, H, H) field in C1's batch layout: rows compact, samples
    ``batch_plane(H)`` values apart, each on a 16-byte boundary."""
    return torch.empty((N, batch_plane(H)), dtype=dtype, device=device)[:, :H * H].view(N, H, H)


def _like(x: torch.Tensor) -> torch.Tensor:
    """A fresh field of x's shape and type in C1's batch layout."""
    return _buffer(x.shape[0], x.shape[-1], x.device, x.dtype)


def _aligned(t: torch.Tensor) -> bool:
    """Whether an (N, H, H) field is in C1's batch layout."""
    H = t.shape[-1]
    return (t.stride(2) == 1 and t.stride(1) == H and t.data_ptr() % 16 == 0
            and (t.shape[0] == 1 or t.stride(0) == batch_plane(H)))


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x, or a contiguous copy where its rows are not compact or its samples
    overlap (X5 to X8 take samples any number of values apart)."""
    H = x.shape[-1]
    if x.stride(2) == 1 and x.stride(1) == H and (x.shape[0] == 1 or x.stride(0) >= H * H):
        return x
    return x.contiguous()


def _operand(x: torch.Tensor) -> torch.Tensor:
    """x, or a copy of it in C1's batch layout (a copy autograd sees
    through)."""
    return x if _aligned(x) else _like(x).copy_(x)


class C1Sweep(torch.autograd.Function):
    """One Jacobi sweep of the route's level l, out = u + W (f - A u) on the
    interior (u on the ring), W = omega / diag(A), into a fresh field.
    Backward from g: h = W g (a sweep of u = 0, f = g), grad u = mask (g -
    A h) (the residual of u = h, f = g), grad f = h.  This is the adjoint
    for a symmetric A (the assembled Q1 stiffness) and, on the ring, that
    of the Jacobi step's reset, which the route's zero rings make the same
    sweep (tests/test_torch_learned_backward.py)."""

    @staticmethod
    def forward(ctx, u, f, route, l):
        ctx.route, ctx.l = route, l
        u, f = _operand(u), _operand(f)
        return route._sweep(l, u, f, _like(u))

    @staticmethod
    def backward(ctx, g):
        route, l = ctx.route, ctx.l
        g = _operand(g)
        h = route._sweep(l, route._zeros(l, g.shape[0]), g, _like(g))
        gu = None
        if ctx.needs_input_grad[0]:
            gu = route._residual(l, h, g, _like(g))
        return gu, h if ctx.needs_input_grad[1] else None, None, None


class C1Residual(torch.autograd.Function):
    """The residual of the route's level l, r = mask (f - A u), into a fresh
    field.  Backward from g: grad f = mask g (the residual of u = 0, f = g),
    grad u = -mask A (mask g) (the residual of u = mask g, f = 0), A
    symmetric."""

    @staticmethod
    def forward(ctx, u, f, route, l):
        ctx.route, ctx.l = route, l
        u, f = _operand(u), _operand(f)
        return route._residual(l, u, f, _like(u))

    @staticmethod
    def backward(ctx, g):
        route, l = ctx.route, ctx.l
        g = _operand(g)
        zero = route._zeros(l, g.shape[0])
        gf = route._residual(l, zero, g, _like(g))
        gu = None
        if ctx.needs_input_grad[0]:
            gu = route._residual(l, gf, zero, _like(g))
        return gu, gf if ctx.needs_input_grad[1] else None, None, None


class LearnedRestrict(torch.autograd.Function):
    """X5 into a fresh coarse field in C1's batch layout; backward X7 and
    X9 (``ops/passes.py``)."""

    @staticmethod
    def forward(ctx, r, k, w, pid):
        ctx.pid = pid
        ctx.save_for_backward(r, k, w)
        Hc = r.shape[-1] // 2 + 1
        return passes.learned_restrict(r, pid, k, w, out=_buffer(r.shape[0], Hc, r.device,
                                                                 r.dtype))

    @staticmethod
    def backward(ctx, g):
        r, k, w = ctx.saved_tensors
        return (*passes.learned_restrict_backward(_rows(g), r, ctx.pid, k, w), None)


class LearnedProlongAdd(torch.autograd.Function):
    """X6, u + w[1] P(v), into a fresh field in C1's batch layout; backward
    grad u = g, and X8 and X9 (``ops/passes.py``)."""

    @staticmethod
    def forward(ctx, u, v, k, w, pid_c):
        ctx.pid_c = pid_c
        ctx.save_for_backward(v, k, w)
        return passes.learned_prolong_add(u, v, pid_c, k, w, out=_like(u))

    @staticmethod
    def backward(ctx, g):
        v, k, w = ctx.saved_tensors
        return (g, *passes.learned_prolong_add_backward(_rows(g), v, ctx.pid_c, k, w), None)


class _Route:
    """The kernel route on one hierarchy and omega: its kernel levels, per
    level a ``StencilLevel`` on the card or the sweep's weight omega /
    diag(A) on the CPU (built once), and per level and batch size the
    buffers of the no-gradient cycle (two for u, one for f) and a field of
    zeros (the backward's), kept between cycles."""

    def __init__(self, hier: GridHierarchy, omega: float):
        self.hier = hier
        self.omega = float(omega)
        self.levels = kernel_levels(hier)
        self.cuda = torch.device(hier.device).type == "cuda"
        self.c1, self.weight = {}, {}
        for l in self.levels:
            lv = hier.levels[l]
            if self.cuda:
                self.c1[l] = StencilLevel(lv.n, pid=lv.pid, coefficients=_c1_coefficients(lv),
                                          omega=omega, device=hier.device)
            else:  # jacobi_step's omega / diag, divided, 0 on the ring
                self.weight[l] = torch.full_like(lv.diag, self.omega) / lv.diag * lv.geo
        self.buffers, self.zeros = {}, {}

    def _sweep(self, l: int, u, f, out):
        """One Jacobi sweep of the batch u (ring 0) on level l into out, all
        three in C1's batch layout: one C1 launch on the card; on the CPU
        jacobi_step's arithmetic."""
        if self.cuda:
            return self.c1[l].sweep_batch(u, f, out=out)
        return torch.add(u, self.weight[l] * (f - self.hier.levels[l].apply(u)), out=out)

    def _residual(self, l: int, u, f, out):
        """f - A u of the batch on level l into out, 0 on the ring: one
        launch of C1's residual mode on the card, Level.apply on the CPU."""
        if self.cuda:
            return self.c1[l].residual_batch(u, f, out=out)
        lv = self.hier.levels[l]
        return torch.mul(f - lv.apply(u), lv.geo, out=out)

    def _zeros(self, l: int, N: int):
        """A batch of zeros on level l in C1's batch layout, never written."""
        if (l, N) not in self.zeros:
            geo = self.hier.levels[l].geo
            self.zeros[(l, N)] = _buffer(N, geo.shape[-1], geo.device, geo.dtype).zero_()
        return self.zeros[(l, N)]

    def _buffers(self, l: int, N: int) -> list:
        key = (l, N)
        if key not in self.buffers:
            H = self.hier.levels[l].n_nodes
            self.buffers[key] = [_buffer(N, H, self.hier.device) for _ in range(3)]
        return self.buffers[key]

    def cycle(self, params, u, f, n_relax: int = 1, level: int = 0):
        """One cycle from ``level`` (float32 fields and parameters, no
        gradient): u and f copied into the level's buffers where C1 cannot
        take them as they are (u's ring zeroed, as the first Jacobi step
        resets it), the result in a fresh tensor."""
        N, lv = u.shape[0], self.hier.levels[level]
        if level not in self.levels:
            return _torch_cycle(self.hier, params, u, f, n_relax, self.omega, level)
        a, b, fb = self._buffers(level, N)
        if not _aligned(f):
            f = fb.copy_(f)
        if n_relax:
            torch.mul(u, lv.geo, out=a)
        else:
            a.copy_(u)
        out = _buffer(N, lv.n_nodes, u.device)
        out = self._level(params, level, a, b, f, n_relax, out)
        return out if N == 1 else out.contiguous()

    def _level(self, params, l, cur, other, f, n_relax, final=None):
        """The cycle on kernel level l from the iterate in ``cur`` (its
        buffer) with ``other`` free; the result in ``final`` when given,
        else in one of the two.  The residual goes into ``other`` and X6
        writes u + P(u_c) there."""
        for _ in range(n_relax):
            cur, other = self._sweep(l, cur, f, other), cur
        self._residual(l, cur, f, other)
        lc, levels = l + 1, self.hier.levels
        if lc in self.levels:
            ac, bc, fc = self._buffers(lc, cur.shape[0])
            passes.learned_restrict(other, levels[l].pid, params.conv, params.w, out=fc)
            uc = self._level(params, lc, ac.zero_(), bc, fc, n_relax)
        else:
            fc = passes.learned_restrict(other, levels[l].pid, params.conv, params.w)
            uc = _torch_cycle(self.hier, params, torch.zeros_like(fc), fc, n_relax, self.omega,
                              lc)
        cur, other = passes.learned_prolong_add(cur, uc, levels[lc].pid, params.deconv,
                                                params.w, out=other), cur
        for k in range(n_relax):
            dst = final if final is not None and k == n_relax - 1 else other
            cur, other = self._sweep(l, cur, f, dst), cur
        if final is not None and n_relax == 0:
            cur = final.copy_(cur)
        return cur

    def graded_cycle(self, params, u, f, n_relax: int = 1, level: int = 0):
        """:meth:`cycle` with autograd: the same operations in the same
        order (the same values, bit for bit), each kernel level's through
        the autograd Functions above on fresh outputs, so that no saved
        tensor is overwritten."""
        if level not in self.levels:
            return _torch_cycle(self.hier, params, u, f, n_relax, self.omega, level)
        if n_relax:
            u = u * self.hier.levels[level].geo
        out = self._graded(params, level, _operand(u), _operand(f), n_relax)
        return out if out.shape[0] == 1 else out.contiguous()

    def _graded(self, params, l, u, f, n_relax):
        for _ in range(n_relax):
            u = C1Sweep.apply(u, f, self, l)
        r = C1Residual.apply(u, f, self, l)
        lc, levels = l + 1, self.hier.levels
        fc = LearnedRestrict.apply(r, params.conv, params.w, levels[l].pid)
        if lc in self.levels:
            uc = self._graded(params, lc, self._zeros(lc, u.shape[0]), fc, n_relax)
        else:
            uc = _torch_cycle(self.hier, params, torch.zeros_like(fc), fc, n_relax, self.omega,
                              lc)
        u = LearnedProlongAdd.apply(u, uc, params.deconv, params.w, levels[lc].pid)
        for _ in range(n_relax):
            u = C1Sweep.apply(u, f, self, l)
        return u


def _route(hier: GridHierarchy, omega: float) -> _Route:
    """The hierarchy's kernel route for ``omega``, built at its first cycle
    and kept on the hierarchy."""
    routes = hier.__dict__.setdefault("_learned_routes", {})
    if float(omega) not in routes:
        routes[float(omega)] = _Route(hier, omega)
    return routes[float(omega)]


def qm_loss(hier: GridHierarchy, u_m: torch.Tensor, u_m0: torch.Tensor, f: torch.Tensor,
            m: int, m0: int) -> torch.Tensor:
    """Mean geometric convergence factor over the batch,
    q_m = mean((|r_m| / |r_m0|)^(1/(m-m0+1))), with the m0 residual
    detached.  Where the finest level is a kernel level and the fields
    float32 batches, both residuals are C1's (:class:`C1Residual`, the m0
    one without gradient).  (reference: MultiGrid.qm,
    FEANet/multigrid.py:132-136)"""
    lv = hier.finest
    route = _route(hier, DEFAULT_OMEGA) if _batches(u_m, u_m0, f) else None
    if route is not None and 0 in route.levels:
        r_m = C1Residual.apply(u_m, f, route, 0)
        with torch.no_grad():
            r_m0 = C1Residual.apply(u_m0, f, route, 0)
    else:
        r_m, r_m0 = f - lv.apply(u_m), f - lv.apply(u_m0)
    ratio = interior_norm(r_m) / interior_norm(r_m0).detach()
    return torch.mean(torch.pow(ratio, 1.0 / (m - m0 + 1)))


def import_torch_checkpoint(path: str, num_patterns: int = 16, device=None) -> IntergridParams:
    """Load a reference MultiGrid state_dict (.pth): ``conv.net.weight``
    (1, C, 3, 3), ``deconv.net.weight`` (C, 1, 3, 3) and ``w`` (2,), the
    channels permuted from the reference's pattern-key order into the
    port's pid order, on ``device`` (None means CUDA)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    perm = torch.as_tensor(stencil.reference_pattern_permutation()[:num_patterns],
                           dtype=torch.long)
    conv_ref = sd["conv.net.weight"][0]
    deconv_ref = sd["deconv.net.weight"][:, 0]
    conv, deconv = torch.zeros_like(conv_ref), torch.zeros_like(deconv_ref)
    conv[perm] = conv_ref
    deconv[perm] = deconv_ref
    w = sd["w"] if "w" in sd else torch.tensor([4.0, 1.0])
    device = resolve_device(device)
    return IntergridParams(conv.to(device), deconv.to(device), w.to(device))
