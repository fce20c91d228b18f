"""Stencil assembly and application for structured-quad Q1 FEM operators.

Port of the parts of ``multigrid_feanet_tpu/ops/stencil.py`` that the fused
V-cycle needs: the (16, 3, 3) stencil table, the homogeneous stencil, the
per-node pattern ids, and the plain applies (bitplane and phase-affine) that
the plain subtree of ``solvers/mg2.py`` and the tests use.  See the JAX
module for the derivation; the encoding is identical:

  element ``(r, c)`` spans nodes ``r..r+1`` x ``c..c+1``; the four elements
  around node ``(i, j)`` are, in bit order, SW ``(i-1, j-1)``, SE
  ``(i-1, j)``, NW ``(i, j-1)``, NE ``(i, j)``, and
  ``pid = b0 + 2*b1 + 4*b2 + 8*b3``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from multigrid_feanet_torch.core.device import resolve_device

# Q1 Laplace element stiffness on a square element, local nodes CCW.
KE = -(1.0 / 6.0) * np.array(
    [
        [-4.0, 1.0, 2.0, 1.0],
        [1.0, -4.0, 1.0, 2.0],
        [2.0, 1.0, -4.0, 1.0],
        [1.0, 2.0, 1.0, -4.0],
    ],
    dtype=np.float64,
)

# Q1 consistent-mass row as a 3x3 kernel (times h^2).
MASS_KERNEL = np.array(
    [[1.0, 4.0, 1.0], [4.0, 16.0, 4.0], [1.0, 4.0, 1.0]], dtype=np.float64
) / 36.0

# Offsets (dr, dc) of the four elements around a node, in pid bit order.
_ELEM_OFFSETS = ((-1, -1), (-1, 0), (0, -1), (0, 0))

# Unit-Ke taps of one coefficient-1 element per quadrant (SW, SE, NW, NE);
# the two-phase operator is  A u = a0 S9(u) + (a1 - a0) sum_e bit_e S4_e(u).
_C, _E, _D = 2.0 / 3.0, -1.0 / 6.0, -1.0 / 3.0
UNIT_S4 = (
    {(0, 0): _C, (-1, 0): _E, (0, -1): _E, (-1, -1): _D},  # SW
    {(0, 0): _C, (-1, 0): _E, (0, 1): _E, (-1, 1): _D},  # SE
    {(0, 0): _C, (1, 0): _E, (0, -1): _E, (1, -1): _D},  # NW
    {(0, 0): _C, (1, 0): _E, (0, 1): _E, (1, 1): _D},  # NE
)
UNIT_S9 = {}
for _t in UNIT_S4:
    for _k, _v in _t.items():
        UNIT_S9[_k] = UNIT_S9.get(_k, 0.0) + _v


def _element_local_nodes(r: int, c: int):
    """Local CCW node ordering of element (r, c): node (i, j) -> local index."""
    return {(r, c): 0, (r, c + 1): 1, (r + 1, c + 1): 2, (r + 1, c): 3}


def make_stencil_table_np(coefficients=(1.0, 20.0)) -> np.ndarray:
    """Host-side (16, 3, 3) f64 stencil table: ``table[pid, 1+dr, 1+dc]``
    couples a node to its ``(dr, dc)`` neighbour under pattern ``pid``."""
    a = np.asarray(coefficients, dtype=np.float64)
    table = np.zeros((16, 3, 3), dtype=np.float64)
    for pid in range(16):
        bits = [(pid >> k) & 1 for k in range(4)]
        for (dr, dc), phase_bit in zip(_ELEM_OFFSETS, bits):
            loc = _element_local_nodes(dr, dc)
            lp = loc[(0, 0)]
            for (qi, qj), lq in loc.items():
                table[pid, qi + 1, qj + 1] += a[phase_bit] * KE[lp, lq]
    return table


def make_homogeneous_stencil(dtype=torch.float32, device=None) -> torch.Tensor:
    """The (3, 3) stencil of the homogeneous (a = 1) Laplace operator, the
    FEM 9-point stencil (1/3) [[-1, -1, -1], [-1, 8, -1], [-1, -1, -1]].
    ``device=None`` means CUDA."""
    return torch.as_tensor(make_stencil_table_np((1.0, 1.0))[0], dtype=dtype,
                           device=resolve_device(device))


def pattern_ids_np(phase: np.ndarray) -> np.ndarray:
    """(n, n) element phases -> (n+1, n+1) int8 per-node pattern ids;
    elements outside the domain count as phase 0."""
    p = np.pad(np.asarray(phase).astype(np.int8), 1)
    return (p[:-1, :-1] + 2 * p[:-1, 1:] + 4 * p[1:, :-1]
            + 8 * p[1:, 1:]).astype(np.int8)


def apply_stencil(table: torch.Tensor, pid, u: torch.Tensor) -> torch.Tensor:
    """A @ u as a 9-tap spatially varying stencil with zero ghosts.

    ``pid`` is an (H, W) int8 field, or None for a homogeneous operator
    (then ``table`` is a single (3, 3) stencil)."""
    H, W = u.shape[-2:]
    up = F.pad(u, (1, 1, 1, 1))
    coeff = None
    if pid is not None:
        coeff = table.reshape(table.shape[0], 9)[pid.long()].reshape(H, W, 3, 3)
    out = torch.zeros_like(u)
    for dr in range(3):
        for dc in range(3):
            shifted = up[..., dr : dr + H, dc : dc + W]
            w = table[dr, dc] if coeff is None else coeff[..., dr, dc]
            out = out + w * shifted
    return out


def _taps(u: torch.Tensor, taps: dict) -> torch.Tensor:
    """Apply a {(dr, dc): weight} stencil to (..., H, W) with zero ghosts."""
    H, W = u.shape[-2:]
    up = F.pad(u, (1, 1, 1, 1))
    out = None
    for (dr, dc), w in taps.items():
        t = w * up[..., 1 + dr : 1 + dr + H, 1 + dc : 1 + dc + W]
        out = t if out is None else out + t
    return out


def apply_stencil_bitplane(pid: torch.Tensor, u: torch.Tensor, a0: float,
                           a1: float) -> torch.Tensor:
    """A @ u for the two-phase operator in bitplane form (no gather)."""
    da = float(a1) - float(a0)
    acc = float(a0) * _taps(u, UNIT_S9)
    p = pid.to(torch.int32)
    for e, taps in enumerate(UNIT_S4):
        bit = ((p >> e) & 1).to(u.dtype)
        acc = acc + (da * bit) * _taps(u, taps)
    return acc


def apply_stencil_bitplane_affine(pid: torch.Tensor, u: torch.Tensor,
                                  base: torch.Tensor, bit_scale: float) -> torch.Tensor:
    """A @ u for an operator affine in the 4 element-phase bits:
    ``base`` (a fixed 3x3 stencil) plus ``bit_scale * sum_e bit_e S4_e(u)``.
    The theta-scheme heat system M + theta dt K takes this form with
    base = h^2 MASS + theta dt a0 S9 and bit_scale = theta dt (a1 - a0)."""
    acc = apply_stencil(base.to(u.dtype), None, u)
    p = pid.to(torch.int32)
    for e, taps in enumerate(UNIT_S4):
        bit = ((p >> e) & 1).to(u.dtype)
        acc = acc + (bit_scale * bit) * _taps(u, taps)
    return acc


def stencil_diagonal(table: torch.Tensor, pid, shape=None) -> torch.Tensor:
    """diag(A) as a field: the centre entry of each node's stencil."""
    if pid is None:
        assert shape is not None
        return table[1, 1].expand(shape).clone()
    return table[:, 1, 1][pid.long()]


def apply_mass(f: torch.Tensor, h: float) -> torch.Tensor:
    """Consistent load vector M_f @ f as a fixed 3x3 stencil (h^2-scaled)."""
    k = (h * h) * torch.as_tensor(MASS_KERNEL, dtype=f.dtype, device=f.device)
    return apply_stencil(k, None, f)
