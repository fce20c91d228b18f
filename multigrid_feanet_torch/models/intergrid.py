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

:func:`learned_v_cycle` serves on hand-written kernels (the kernel route)
when no gradient is needed, the fields and parameters are float32 and the
batch holds at most ``KERNEL_MAX_BATCH`` samples: on every level that is
not the coarsest and whose operator C1 takes (two-phase bitplane or
homogeneous; :func:`kernel_levels`), the relaxations are C1 sweeps and the
residual C1's residual mode (``ops/stencil_sweep.py``, one launch a sample,
on 16-byte aligned per-sample buffers kept per level), the restriction is
X5 and the prolongation-add X6 (``ops/passes.py``, one launch a batch),
where the JAX package's jitted cycle leaves the transfers to XLA.  The
coarsest level's double relaxation, larger batches and every cycle that
needs a gradient keep the torch path above.  The route depends on grad
mode, dtype and sizes alone, never on the device or a failure: a kernel
that fails to build or launch raises.  On CPU fields the route computes
the JAX package's eager cycle op for op, bit for bit at 16 channels and
at one: the sweep and the
residual with ``Level.apply`` and ``jacobi_step``'s weight omega / diag(A)
(divided, as the JAX package divides it), the plain X5 and X6, which round
as its convolutions do on the CPU.  C1 on the card weights by its own
diagonal (2/3)(4 a0 + da popcount) in float32, an ulp above the table's on
nodes of four phase-1 elements, and sums A u in the Pallas kernel's order:
it agrees with ``jacobi_step`` to ``ops.sweep.TOL`` on the cycle's zero
ring.
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
from multigrid_feanet_torch.ops.stencil_sweep import StencilLevel
from multigrid_feanet_torch.solvers.jacobi import DEFAULT_OMEGA, interior_norm, relax

FULL_WEIGHTING_16 = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=np.float32) / 16.0
BILINEAR_4 = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=np.float32) / 4.0
# the most samples a batch may hold on the kernel route: C1 takes a launch
# a sample, where the torch path's launches do not grow with the batch.  At
# 65^2 (6 levels) on an H100 the route took 19.08 ms a cycle against the
# torch path's 33.03 at a batch of 16, and 34.99 against 34.40 at 32
# (sweep_vs_parent.py --legs learned)
KERNEL_MAX_BATCH = 16

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
    parameters, batches of at most ``KERNEL_MAX_BATCH`` and no gradient
    needed; else in torch ops (the split and cuDNN), where only one level's
    split exists at a time: the restriction's is freed before the
    recursion.  (reference:
    MultiGrid.iterate, FEANet/multigrid.py:159-184)"""
    if _kernel_route(params, u, f):
        return _route(hier, omega).cycle(params, u, f, n_relax, level)
    return _torch_cycle(hier, params, u, f, n_relax, omega, level)


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
    """Whether the kernel route takes the cycle: no gradient needed, u and f
    float32 batches of one shape and at most ``KERNEL_MAX_BATCH`` samples,
    the parameters float32."""
    tensors = (params.conv, params.deconv, params.w, u, f)
    if any(t.dtype != torch.float32 for t in tensors) or u.dim() != 3 or u.shape != f.shape:
        return False
    if u.shape[0] > KERNEL_MAX_BATCH:
        return False
    return not torch.is_grad_enabled() or not any(t.requires_grad for t in tensors)


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


def _plane(H: int) -> int:
    """Values between two samples of a per-level buffer: H^2 rounded up to
    a whole 16 bytes, so that every sample starts on a 16-byte boundary."""
    return -(-H * H // 4) * 4


def _buffer(N: int, H: int, device) -> torch.Tensor:
    """An (N, H, H) float32 field whose samples each start on a 16-byte
    boundary (C1's operands), rows compact, ``_plane(H)`` values apart."""
    return torch.empty((N, _plane(H)), dtype=torch.float32,
                       device=device)[:, :H * H].view(N, H, H)


def _aligned(t: torch.Tensor) -> bool:
    """Whether every sample of an (N, H, H) field is a compact field that
    starts on a 16-byte boundary."""
    H = t.shape[-1]
    return (t.stride(2) == 1 and t.stride(1) == H and t.data_ptr() % 16 == 0
            and (t.shape[0] == 1 or t.stride(0) % 4 == 0))


class _Route:
    """The kernel route on one hierarchy and omega: its kernel levels, per
    level a ``StencilLevel`` of a single sample on the card or the sweep's
    weight omega / diag(A) on the CPU (built once), and per level and batch
    size the aligned buffers of the cycle (two for u, one for f), kept
    between cycles."""

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
        self.rsq = {l: torch.empty((), dtype=torch.float32, device=hier.device)
                    for l in self.levels}
        self.buffers = {}

    def _sweep(self, l: int, u, f, out):
        """One Jacobi sweep of the batch u (ring 0) on level l into out: a
        C1 launch a sample on the card; on the CPU jacobi_step's
        arithmetic."""
        if self.cuda:
            for i in range(u.shape[0]):
                self.c1[l].sweep(u[i], f[i], out=out[i], rsq=self.rsq[l])
        else:
            torch.add(u, self.weight[l] * (f - self.hier.levels[l].apply(u)), out=out)
        return out

    def _residual(self, l: int, u, f, out):
        """f - A u of the batch on level l into out, 0 on the ring: C1's
        residual mode a sample on the card, Level.apply on the CPU."""
        if self.cuda:
            for i in range(u.shape[0]):
                self.c1[l].residual(u[i], f[i], out=out[i], rsq=self.rsq[l])
        else:
            lv = self.hier.levels[l]
            torch.mul(f - lv.apply(u), lv.geo, out=out)
        return out

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
    detached.  (reference: MultiGrid.qm, FEANet/multigrid.py:132-136)"""
    lv = hier.finest
    ratio = interior_norm(f - lv.apply(u_m)) / interior_norm(f - lv.apply(u_m0)).detach()
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
