"""Vector-valued (2-DOF/node) elasticity stencils: plane stress / plane
strain Q1 elements as spatially varying 3x3 blocks of 2x2 couplings.

Port of ``multigrid_feanet_tpu/ops/elasticity.py``.  The element stiffness
and the block tables are assembled on the host in numpy exactly as in the
JAX package; the applies are plain PyTorch on whatever device the fields
lie on.  Fields are (..., 2, H, W) with component 0 = x (the column
displacement) and component 1 = y (the row displacement); "north" is row
+ 1.  The 16-pattern bi-material encoding is that of ``ops/stencil.py``:

    table[pid]: (3, 3, 2, 2) — tap (dr, dc) couples displacement components
    (out_c, in_c) of a node to its (dr, dc) neighbour.

Three forms of the same operator: the general 36-tap block stencil
(:func:`apply_elastic_stencil`), the gather-free bitplane form
(:func:`apply_elastic_bitplane`, the plain subtree's apply) and the
element-factored five-constant form (:func:`apply_elastic_factored`, the
form the fused kernels of ``ops/elastic.py`` evaluate).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_GAUSS = 1.0 / np.sqrt(3.0)
_QPTS = [(-_GAUSS, -_GAUSS), (_GAUSS, -_GAUSS), (_GAUSS, _GAUSS), (-_GAUSS, _GAUSS)]
# offsets (dr, dc) of the four elements around a node, in pid bit order
# (SW, SE, NW, NE)
_ELEM_OFFSETS = ((-1, -1), (-1, 0), (0, -1), (0, 0))


def elasticity_d_matrix(E: float, nu: float, plane: str = "stress") -> np.ndarray:
    """3x3 constitutive matrix of plane stress or plane strain."""
    if plane == "stress":
        c = E / (1.0 - nu * nu)
        return c * np.array([[1.0, nu, 0.0], [nu, 1.0, 0.0], [0.0, 0.0, (1.0 - nu) / 2.0]])
    if plane == "strain":
        c = E / ((1.0 + nu) * (1.0 - 2.0 * nu))
        return c * np.array(
            [[1.0 - nu, nu, 0.0], [nu, 1.0 - nu, 0.0], [0.0, 0.0, (1.0 - 2.0 * nu) / 2.0]])
    raise ValueError(plane)


def element_stiffness_elastic(E: float, nu: float, h: float, plane: str = "stress") -> np.ndarray:
    """8x8 Q1 element stiffness (local nodes CCW from lower-left, DOFs
    (ux, uy) interleaved), 2x2 Gauss quadrature on an h x h square."""
    D = elasticity_d_matrix(E, nu, plane)
    ke = np.zeros((8, 8))
    for (xi, eta) in _QPTS:
        dN_dxi = 0.25 * np.array([-(1 - eta), (1 - eta), (1 + eta), -(1 + eta)])
        dN_deta = 0.25 * np.array([-(1 - xi), -(1 + xi), (1 + xi), (1 - xi)])
        dN_dx = dN_dxi * (2.0 / h)
        dN_dy = dN_deta * (2.0 / h)
        B = np.zeros((3, 8))
        for a in range(4):
            B[0, 2 * a] = dN_dx[a]
            B[1, 2 * a + 1] = dN_dy[a]
            B[2, 2 * a] = dN_dy[a]
            B[2, 2 * a + 1] = dN_dx[a]
        ke += B.T @ D @ B * (h / 2.0) ** 2
    return ke


def _quadrant_blocks(ke: np.ndarray) -> np.ndarray:
    """(4, 3, 3, 2, 2): the block row of the centre node in each of its four
    elements (SW, SE, NW, NE), unscaled."""
    s4 = np.zeros((4, 3, 3, 2, 2))
    for e, (dr, dc) in enumerate(_ELEM_OFFSETS):
        loc = {(dr, dc): 0, (dr, dc + 1): 1, (dr + 1, dc + 1): 2, (dr + 1, dc): 3}
        lp = loc[(0, 0)]
        for (qi, qj), lq in loc.items():
            s4[e, qi + 1, qj + 1] += ke[2 * lp : 2 * lp + 2, 2 * lq : 2 * lq + 2]
    return s4


def make_elastic_stencil_table(E: float, nu: float, h: float, coefficients=(1.0, 1.0),
                               plane: str = "stress", dtype=torch.float32,
                               device="cpu") -> torch.Tensor:
    """(16, 3, 3, 2, 2) bi-material block-stencil table, assembled in f64 on
    the host and placed on ``device``; ``coefficients`` scale the element
    stiffness per phase."""
    s4 = _quadrant_blocks(element_stiffness_elastic(E, nu, h, plane))
    a = np.asarray(coefficients, dtype=np.float64)
    table = np.zeros((16, 3, 3, 2, 2))
    for pid in range(16):
        for e in range(4):
            table[pid] += a[(pid >> e) & 1] * s4[e]
    return torch.as_tensor(table, dtype=dtype, device=device)


def pattern_block_table(table: torch.Tensor, pid):
    """Gather (H, W, 3, 3, 2, 2) per-node blocks (or pattern 0's blocks)."""
    if pid is None:
        return table[0]
    flat = table.reshape(table.shape[0], -1)
    return flat[pid.long()].reshape(*pid.shape, 3, 3, 2, 2)


def apply_elastic_stencil(table: torch.Tensor, pid, u: torch.Tensor) -> torch.Tensor:
    """A @ u for displacement fields u: (..., 2, H, W) -> (..., 2, H, W).

    General form: 36 shifted FMAs with per-node gathered blocks when
    ``pid`` is given, constant blocks otherwise."""
    H, W = u.shape[-2:]
    up = F.pad(u, (1, 1, 1, 1))
    coeff = None if pid is None else pattern_block_table(table, pid)
    out = torch.zeros_like(u)
    for dr in range(3):
        for dc in range(3):
            shifted = up[..., dr : dr + H, dc : dc + W]
            for oc in range(2):
                for ic in range(2):
                    if pid is None:
                        w = table[0, dr, dc, oc, ic] if table.dim() == 5 else table[dr, dc, oc, ic]
                    else:
                        w = coeff[..., dr, dc, oc, ic]
                    out[..., oc, :, :] += w * shifted[..., ic, :, :]
    return out


def block_diagonal(table: torch.Tensor, pid, shape=None) -> torch.Tensor:
    """Per-node 2x2 diagonal blocks D_ii: (..., H, W, 2, 2)."""
    if pid is None:
        if shape is None:
            raise ValueError("a homogeneous block diagonal needs its shape")
        blk = table[0, 1, 1] if table.dim() == 5 else table[1, 1]
        return blk.expand(*shape, 2, 2)
    return pattern_block_table(table, pid)[..., 1, 1, :, :]


def invert_2x2(blocks: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 2, 2) blocks."""
    a, b = blocks[..., 0, 0], blocks[..., 0, 1]
    c, d = blocks[..., 1, 0], blocks[..., 1, 1]
    det = a * d - b * c
    inv = torch.stack([torch.stack([d, -b], dim=-1), torch.stack([-c, a], dim=-1)], dim=-2)
    return inv / det[..., None, None]


def jacobi_step_elastic(table: torch.Tensor, pid, dinv: torch.Tensor, geo: torch.Tensor,
                        u: torch.Tensor, f: torch.Tensor, bc_value=0.0,
                        omega: float = 2.0 / 3.0) -> torch.Tensor:
    """Block-Jacobi sweep: u <- reset(u + omega * Dinv (f - A u)).

    ``dinv``: precomputed (H, W, 2, 2) inverse diagonal blocks; ``geo``:
    (H, W) interior mask applied to both components."""
    gm = geo[..., None, :, :]
    u = u * gm + bc_value * (1.0 - gm)
    r = f - apply_elastic_stencil(table, pid, u)
    rr = torch.movedim(r, -3, -1)  # (..., H, W, 2)
    upd = torch.einsum("...hwij,...hwj->...hwi", dinv, rr)
    u = u + omega * torch.movedim(upd, -1, -3)
    return u * gm + bc_value * (1.0 - gm)


def elastic_interior_norm(r: torch.Tensor) -> torch.Tensor:
    """L2 norm of the interior residual over both components."""
    ri = r[..., 1:-1, 1:-1]
    return torch.sqrt(torch.sum(ri * ri, dim=(-3, -2, -1)))


def unit_block_taps(E: float, nu: float, plane: str = "stress"):
    """(S9_blocks, S4_blocks): homogeneous block stencil (3, 3, 2, 2) and the
    four per-quadrant element contributions (4, 3, 3, 2, 2), both for a
    coefficient-1 element.  Basis of the bitplane apply (h-independent)."""
    s4 = _quadrant_blocks(element_stiffness_elastic(E, nu, 1.0, plane))
    return s4.sum(axis=0), s4


def elastic_factor_constants(E: float, nu: float, plane: str = "stress"):
    """The scalars (al, be, ga, ep, de, ze) that generate every 2x2 block of
    the Q1 elastic element stiffness (h-independent): within one element,
    the coupling of node p to node q is

        same node:        [[al, s be], [s be, al]]
        col (x) neighbor: [[ga, -s ep], [s ep, de]]
        row (y) neighbor: [[de,  s ep], [-s ep, ga]]
        diagonal:         [[ze, -s be], [-s be, ze]]

    with s = +1 when p sits on the element's main (SW/NE) diagonal and -1
    on the anti-diagonal."""
    ke = element_stiffness_elastic(E, nu, 1.0, plane)
    return tuple(float(x) for x in (ke[0, 0], ke[0, 1], ke[0, 2], ke[1, 2], ke[1, 3], ke[0, 4]))


def elastic_q_corners(phase, shape, a0: float, a1: float, dtype, device="cpu"):
    """Per-node element coefficients (Q_ne, Q_nw, Q_se, Q_sw), each (H, W).
    Out-of-domain elements carry a0 (phase 0), as in the bitplane form."""
    H, W = shape
    if phase is None:
        q = torch.full((H + 1, W + 1), float(a0), dtype=dtype, device=device)
    else:
        p = torch.as_tensor(phase, device=device).to(dtype)
        q = float(a0) + (float(a1) - float(a0)) * F.pad(p, (1, 1, 1, 1))
    return q[1:, 1:], q[1:, :-1], q[:-1, 1:], q[:-1, :-1]


def apply_elastic_factored(phase, u: torch.Tensor, E: float, nu: float, a0: float, a1: float,
                           plane: str = "stress") -> torch.Tensor:
    """A @ u via the element-factored form: the sum over the 4 elements e
    around node p of Q_e times Ke's block row of p applied to e's nodes,
    with Q_e = a0 + (a1 - a0) * phase_e.

    ``phase``: (n, n) element map (None = homogeneous); ``u``: (..., 2, H,
    W) with component 0 = column (x) displacement."""
    al, be, ga, ep, de, ze = elastic_factor_constants(E, nu, plane)
    H, W = u.shape[-2:]
    Qne, Qnw, Qse, Qsw = elastic_q_corners(phase, (H, W), a0, a1, u.dtype, u.device)
    C4 = Qne + Qnw + Qse + Qsw
    C4s = Qne + Qsw - Qnw - Qse
    Qe, Qw = Qne + Qse, Qnw + Qsw
    Qn, Qs = Qne + Qnw, Qse + Qsw
    dE, dW = Qne - Qse, Qsw - Qnw
    dN, dS = Qne - Qnw, Qsw - Qse
    up = F.pad(u, (1, 1, 1, 1))

    def sh(c, dr, dc):  # u component c shifted so entry (i, j) = u[c, i+dr, j+dc]
        return up[..., c, 1 + dr : 1 + dr + H, 1 + dc : 1 + dc + W]

    out = []
    for c in range(2):  # out component: 0 = x (cols), 1 = y (rows)
        uc, vo = (0, 1) if c == 0 else (1, 0)  # same-component, cross-component
        sg = 1.0 if c == 0 else -1.0  # the cross ep sign flips between rows
        g_ew, g_ns = (ga, de) if c == 0 else (de, ga)
        o = (al * C4 * sh(uc, 0, 0)
             + g_ew * (Qe * sh(uc, 0, 1) + Qw * sh(uc, 0, -1))
             + g_ns * (Qn * sh(uc, 1, 0) + Qs * sh(uc, -1, 0))
             + ze * (Qne * sh(uc, 1, 1) + Qnw * sh(uc, 1, -1)
                     + Qse * sh(uc, -1, 1) + Qsw * sh(uc, -1, -1))
             + be * C4s * sh(vo, 0, 0)
             - sg * ep * (dE * sh(vo, 0, 1) + dW * sh(vo, 0, -1))
             + sg * ep * (dN * sh(vo, 1, 0) + dS * sh(vo, -1, 0))
             - be * (Qne * sh(vo, 1, 1) - Qnw * sh(vo, 1, -1)
                     - Qse * sh(vo, -1, 1) + Qsw * sh(vo, -1, -1)))
        out.append(o)
    return torch.stack(out, dim=-3)


def apply_elastic_bitplane(pid: torch.Tensor, u: torch.Tensor, E: float, nu: float,
                           a0: float, a1: float, plane: str = "stress") -> torch.Tensor:
    """A @ u for the two-phase elastic operator with no gathers:

        A u = a0 * S9b(u) + (a1 - a0) * sum_e bit_e(pid) .* S4b_e(u)

    the vector analogue of ``ops/stencil.apply_stencil_bitplane``."""
    s9, s4 = unit_block_taps(E, nu, plane)
    H, W = u.shape[-2:]
    up = F.pad(u, (1, 1, 1, 1))
    da = float(a1) - float(a0)

    def block_taps(table_np, scale_plane=None):
        comps = []
        for oc in range(2):
            acc_c = None
            for dr in range(3):
                for dc in range(3):
                    blk = table_np[dr, dc]
                    if not np.any(blk[oc]):
                        continue
                    shifted = up[..., dr : dr + H, dc : dc + W]
                    term = (float(blk[oc, 0]) * shifted[..., 0, :, :]
                            + float(blk[oc, 1]) * shifted[..., 1, :, :])
                    acc_c = term if acc_c is None else acc_c + term
            if scale_plane is not None:
                acc_c = acc_c * scale_plane
            comps.append(acc_c)
        return torch.stack(comps, dim=-3)

    acc = float(a0) * block_taps(s9)
    p = pid.to(torch.int32)
    for e in range(4):
        bit = ((p >> e) & 1).to(u.dtype)
        acc = acc + da * block_taps(s4[e], scale_plane=bit)
    return acc
