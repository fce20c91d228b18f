"""Block-BoxMG for the 2-DOF plane-stress elastic system: operator-induced
transfers and Galerkin coarsening with 2x2 displacement blocks.

Port of ``multigrid_feanet_tpu/ops/boxmg_elastic.py``, which runs in XLA
outside any Pallas kernel; here it is torch ops on the levels' device.  The
scalar Dendy collapse (``ops/boxmg.py``) carries over with every scalar
weight a 2x2 matrix acting on the displacement vector:

  Fx (even row, odd column): collapse the block stencil over rows,
      wW = -inv(sum_dr S[., dr, C]) @ sum_dr S[., dr, W], wE likewise;
  Fy: collapse over columns;
  Fc: w[dr, dc] = -inv(S[1, 1]) @ S[dr, dc] over the 8 neighbours, composed
      with the neighbours' own Fx / Fy matrices (the contribution through a
      neighbour nb is wc[nb] @ w_nb, in that order).

The composed weights ``W4E`` (H, W, 2, 2, 2, 2) give

  (P u_c)[o, i, j] = sum_{a, b, ic} W4E[i, j, a, b, o, ic] * u_c[ic, i//2 + a, j//2 + b]

and the restriction is the exact block transpose.  Galerkin R A P is
probed with the scalar module's nine 3-strided lattices times the two unit
displacement components, 18 probes run as one batch.  Boundary fine rows
and weights that target boundary coarse nodes are zeroed; the coarse
operators' ring centres are set to the identity block.  Fields are
component planes (2, H, W).

The applies and transfers are a handful of launches each, since the
solver's W-cycle visits the levels ~2^L times per cycle: each reads a
strided view of its input (the 9 taps of the padded field, the 4 coarse
samples of a once-repeated coarse field) beside its weights in the layout
the contraction wants (:func:`stencil_layout`, :func:`prolong_layout`,
:func:`restrict_layout`; contiguous copies of these views are what
``solvers/elastic_boxmg.py`` keeps).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from multigrid_feanet_torch.ops import elasticity as el
from multigrid_feanet_torch.ops.adaptive_transfer import gather_probes, probe_lattices
from multigrid_feanet_torch.ops.boxmg import restrict_stage, up_sample


def inv2x2_guarded(M: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Batched inverse over trailing (2, 2) axes; singular blocks (the
    Galerkin ring rows) give the identity."""
    a, b = M[..., 0, 0], M[..., 0, 1]
    c, d = M[..., 1, 0], M[..., 1, 1]
    det = a * d - b * c
    safe = det.abs() > eps
    ds = torch.where(safe, det, 1.0)
    inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2) / ds[..., None, None]
    eye = torch.eye(2, dtype=M.dtype, device=M.device).expand(M.shape)
    return torch.where(safe[..., None, None], inv, eye)


def elastic_node_stencils(level, dtype=None) -> torch.Tensor:
    """Per-node (H, W, 3, 3, 2, 2) block stencils of an ElasticLevel in
    bitplane form (no 16-entry gather): S = a0 B9 + (a1 - a0) sum_e bit_e B4_e
    with B4_e from ``ops/elasticity.unit_block_taps``."""
    H = level.n + 1
    dtype = dtype or level.geo.dtype
    dev = level.geo.device
    s9, s4 = el.unit_block_taps(level.E, level.nu, level.plane)
    s9 = torch.as_tensor(s9, dtype=dtype, device=dev)
    if level.pid is None:
        return s9.expand(H, H, 3, 3, 2, 2)
    a0 = float(level.a0)
    da = float(level.a1) - a0
    p = level.pid.to(torch.int32)
    S = (a0 * s9).expand(H, H, 3, 3, 2, 2)
    for e in range(4):
        bit = ((p >> e) & 1).to(dtype)
        S = S + (da * bit)[..., None, None, None, None] * torch.as_tensor(
            s4[e], dtype=dtype, device=dev)
    return S


def _shift_m(x: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """x[i + dr, j + dc] of an (H, W, ...) matrix field, zero past the edge."""
    H, W = x.shape[:2]
    xp = x.new_zeros((H + 2, W + 2, *x.shape[2:]))
    xp[1:-1, 1:-1] = x
    return xp[1 + dr : 1 + dr + H, 1 + dc : 1 + dc + W]


def elastic_transfer_weights(S: torch.Tensor, geo_f, geo_c) -> torch.Tensor:
    """Composed (H, W, 2, 2, 2, 2) block W4 from a block stencil field:
    axes 2, 3 are (a, b), axes 4, 5 the (out, in) components."""
    dtype = S.dtype
    H = S.shape[0]
    sx = S.sum(dim=2)  # (H, W, 3, 2, 2): [W, C, E]
    cxi = inv2x2_guarded(sx[..., 1, :, :])
    wxW = -(cxi @ sx[..., 0, :, :])
    wxE = -(cxi @ sx[..., 2, :, :])
    sy = S.sum(dim=3)  # [N, C, S]
    cyi = inv2x2_guarded(sy[..., 1, :, :])
    wyN = -(cyi @ sy[..., 0, :, :])
    wyS = -(cyi @ sy[..., 2, :, :])
    sci = inv2x2_guarded(S[..., 1, 1, :, :])
    wc = -(sci[:, :, None, None] @ S)

    fc00 = (wc[..., 0, 0, :, :] + wc[..., 0, 1, :, :] @ _shift_m(wxW, -1, 0)
            + wc[..., 1, 0, :, :] @ _shift_m(wyN, 0, -1))
    fc01 = (wc[..., 0, 2, :, :] + wc[..., 0, 1, :, :] @ _shift_m(wxE, -1, 0)
            + wc[..., 1, 2, :, :] @ _shift_m(wyN, 0, 1))
    fc10 = (wc[..., 2, 0, :, :] + wc[..., 2, 1, :, :] @ _shift_m(wxW, 1, 0)
            + wc[..., 1, 0, :, :] @ _shift_m(wyS, 0, -1))
    fc11 = (wc[..., 2, 2, :, :] + wc[..., 2, 1, :, :] @ _shift_m(wxE, 1, 0)
            + wc[..., 1, 2, :, :] @ _shift_m(wyS, 0, 1))

    i = torch.arange(H, device=S.device)
    re = (i[:, None] % 2 == 0)[..., None, None]
    ce = (i[None, :] % 2 == 0)[..., None, None]
    C, Fx, Fy, Fc = re & ce, re & ~ce, ~re & ce, ~re & ~ce
    eye = torch.eye(2, dtype=dtype, device=S.device).expand(wxW.shape)
    zero = torch.zeros_like(wxW)
    w00 = torch.where(C, eye, torch.where(Fx, wxW, torch.where(Fy, wyN, fc00)))
    w01 = torch.where(Fx, wxE, torch.where(Fc, fc01, zero))
    w10 = torch.where(Fy, wyS, torch.where(Fc, fc10, zero))
    w11 = torch.where(Fc, fc11, zero)
    W4 = torch.stack([torch.stack([w00, w01], dim=2), torch.stack([w10, w11], dim=2)], dim=2)
    if geo_f is not None:
        W4 = W4 * geo_f.to(dtype)[:, :, None, None, None, None]
    if geo_c is not None:
        gc = up_sample(geo_c.to(dtype)).permute(2, 3, 0, 1)  # (H, W, a, b)
        W4 = W4 * gc[..., None, None]
    return W4


def stencil_layout(S: torch.Tensor) -> torch.Tensor:
    """(H, W, 3, 3, 2, 2) [dr, dc, o, ic] -> (o, dr, dc, ic, H, W) view."""
    return S.permute(4, 2, 3, 5, 0, 1)


def prolong_layout(W4E: torch.Tensor) -> torch.Tensor:
    """(H, W, a, b, o, ic) -> (o, a, b, ic, H, W) view."""
    return W4E.permute(4, 2, 3, 5, 0, 1)


def restrict_layout(W4E: torch.Tensor) -> torch.Tensor:
    """(H, W, a, b, o, ic) -> (a, b, ic, o, H, W) view."""
    return W4E.permute(2, 3, 5, 4, 0, 1)


def block_apply(Sl: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A u for ``Sl`` = :func:`stencil_layout` of a block stencil field and u
    (..., 2, H, W): the 9 taps of the zero-padded u read as one strided
    view, contracted with Sl over (dr, dc, ic)."""
    H, W = u.shape[-2:]
    up = F.pad(u, (1, 1, 1, 1))
    *lead, sc_, sr, sc = up.stride()
    taps = up.as_strided((*u.shape[:-3], 3, 3, 2, H, W),
                         (*lead, sr, sc, sc_, sr, sc))  # (..., dr, dc, ic, H, W)
    return (Sl * taps[..., None, :, :, :, :, :]).sum((-5, -4, -3))


def block_prolong(uc: torch.Tensor, Wp: torch.Tensor) -> torch.Tensor:
    """(..., 2, m, m) -> (..., 2, 2m-1, 2m-1) for ``Wp`` =
    :func:`prolong_layout` of W4E: the 4 coarse samples of each component,
    one strided view, contracted with Wp over (a, b, ic)."""
    U = up_sample(uc).movedim(-5, -3)  # (..., a, b, ic, H, W)
    return (Wp * U[..., None, :, :, :, :, :]).sum((-5, -4, -3))


def block_restrict(r: torch.Tensor, Wr: torch.Tensor) -> torch.Tensor:
    """(..., 2, H, H) -> (..., 2, m, m), the exact block transpose of
    :func:`block_prolong`, for ``Wr`` = :func:`restrict_layout` of W4E: the
    weighted residual t[a, b, ic, o] collapses over rows (a), then columns
    (b), then the fine components o, in the JAX module's order."""
    t = Wr * r[..., None, None, None, :, :, :]  # (..., a, b, ic, o, H, W)
    rows = restrict_stage(t.select(-6, 0), t.select(-6, 1), -2)  # (..., b, ic, o, m, W)
    out = restrict_stage(rows.select(-5, 0), rows.select(-5, 1), -1)  # (..., ic, o, m, m)
    return out.sum(-3)


def prolong_w4_e(uc: torch.Tensor, W4E: torch.Tensor) -> torch.Tensor:
    """(..., 2, m, m) coarse -> (..., 2, 2m-1, 2m-1) fine."""
    return block_prolong(uc, prolong_layout(W4E))


def restrict_w4_e(r: torch.Tensor, W4E: torch.Tensor) -> torch.Tensor:
    """(..., 2, H, H) fine -> (..., 2, m, m) coarse, the exact block
    transpose: each node's 2x2 weight acts transposed (the out component
    contracts with the fine residual's component)."""
    return block_restrict(r, restrict_layout(W4E))


def apply_block_s9(S: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A u for an (H, W, 3, 3, 2, 2) block stencil field; u (..., 2, H, W)."""
    return block_apply(stencil_layout(S), u)


def galerkin_rap_e(S: torch.Tensor, W4E: torch.Tensor) -> torch.Tensor:
    """Block Galerkin product R A P from the scalar module's 9 strided
    lattices times the 2 unit components, the 18 probes run as one batch."""
    m = (S.shape[0] - 1) // 2 + 1
    dtype, dev = W4E.dtype, W4E.device
    lattices = probe_lattices(m, dev).to(dtype)
    # probe (a, b, ic): lattice (a, b) in component ic, zero in the other
    probes = lattices[:, :, None, None] * torch.eye(2, dtype=dtype, device=dev)[:, :, None, None]
    ys = restrict_w4_e(apply_block_s9(S, prolong_w4_e(probes.reshape(18, 2, m, m), W4E)),
                       W4E)  # (18, o, m, m)
    # (m, m, 3, 3, ic, o) -> Sc[..., o, ic]
    return gather_probes(ys.reshape(3, 3, 2, 2, m, m)).transpose(-1, -2)


def _guard_ring(Sc: torch.Tensor) -> torch.Tensor:
    """Identity centre blocks where a coarse operator's centre block is all
    zero (its Dirichlet ring), so the block-Jacobi inverse exists."""
    d = Sc[..., 1, 1, :, :]
    zero_ring = (d.abs().sum((-1, -2)) == 0.0)[..., None, None]
    Sc = Sc.clone()
    Sc[..., 1, 1, :, :] = torch.where(zero_ring, torch.eye(2, dtype=Sc.dtype, device=Sc.device),
                                      d)
    return Sc


def boxmg_elastic_setup(levels, num_levels: Optional[int] = None, dtype=None) -> list:
    """Block-BoxMG setup on the levels' device from an elastic hierarchy
    (``solvers/elastic.build_elastic_hierarchy``): ``[(W4E_0, Sc_1),
    (W4E_1, Sc_2), ...]``, each coarse operator's zero ring centres set to
    the identity block."""
    L = num_levels if num_levels is not None else len(levels)
    dtype = dtype or levels[0].geo.dtype
    geos = [levels[l].geo.to(dtype) for l in range(L)]
    S = elastic_node_stencils(levels[0], dtype)
    outs = []
    for l in range(L - 1):
        W4 = elastic_transfer_weights(S, geos[l], geos[l + 1])
        Sc = _guard_ring(galerkin_rap_e(S, W4))
        outs.append((W4, Sc))
        S = Sc
    return outs
