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
permutes the reference's channel order into it.  The transfers are cuDNN
convolutions in full f32 (``core/device.full_f32``): the JAX package
computes them with ``lax.conv_general_dilated``, outside any Pallas kernel,
so no hand-written kernel is on this path.  Fields are batched
(N, H, W); the level's operator fields broadcast over N.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multigrid_feanet_torch.core.device import full_f32, resolve_device
from multigrid_feanet_torch.core.problem import GridHierarchy
from multigrid_feanet_torch.ops import stencil
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
    fields.  Only one level's split exists at a time: the restriction's is
    freed before the recursion.  (reference: MultiGrid.iterate,
    FEANet/multigrid.py:159-184)"""
    lv = hier.levels[level]
    u = relax(lv, u, f, n_relax, 0.0, omega)
    if level < hier.num_levels - 1:
        f_c = restrict_learned(params, f - lv.apply(u), lv.pid)
        u_c = learned_v_cycle(hier, params, torch.zeros_like(f_c), f_c, n_relax, omega,
                              level + 1)
        u = u + prolong_learned(params, u_c, hier.levels[level + 1].pid)
    # unconditional post-relax: the reference relaxes the coarsest level a
    # second time after its creation-relax (FEANet/multigrid.py:173)
    return relax(lv, u, f, n_relax, 0.0, omega)


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
