"""BoxMG setup: operator-induced transfers and Galerkin coarse operators.

Port of ``multigrid_feanet_tpu/ops/boxmg.py``.  Plain tensor code on the
level's device, as the JAX package leaves it to XLA outside any Pallas
kernel:

- ``node_stencil_planes``: the per-node (H, W, 3, 3) stencil field of the
  finest level (bitplane FMAs, no gather);
- ``transfer_weights``: the Dendy/BoxMG interpolation weights composed into
  one (H, W, 2, 2) tensor ``W4`` with

      (P u_c)[i, j] = sum_{a,b in {0,1}} W4[i, j, a, b] * u_c[i//2 + a, j//2 + b]

  (for even i the a=1 weights are zero, likewise b), with the fine and
  coarse interior masks folded in, so ``prolong_w4`` masks like
  ``prolong * geo_f`` and ``restrict_w4`` (its exact transpose) like
  ``geo_c * restrict(geo_f * r)``; coarse fields must carry a zero ring;
- ``galerkin_rap``: S_c = P^T A P by nine 3-strided lattice probes, run one
  at a time so the peak memory stays at a few (H, H) temporaries;
- ``boxmg_setup``: ``[(W4_0, Sc_1), (W4_1, Sc_2), ...]`` for a hierarchy,
  with a unit centre on each coarse operator's (all-zero) Dirichlet ring.

Every function follows its JAX counterpart's order of operations.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from multigrid_feanet_torch.ops import stencil as stencil_mod


def _guard(den, eps=1e-30):
    return torch.where(den.abs() > eps, den, 1.0)


def _taps_grid(taps: dict, dtype, device) -> torch.Tensor:
    """A {(dr, dc): weight} stencil as a (3, 3) tensor."""
    return torch.tensor([[taps.get((dr, dc), 0.0) for dc in (-1, 0, 1)]
                         for dr in (-1, 0, 1)], dtype=dtype, device=device)


def node_stencil_planes(level, dtype=None) -> torch.Tensor:
    """Per-node (H, W, 3, 3) stencil field of a hierarchy Level, computed
    with bitplane FMAs (no gather).

    Handles the three operator forms of ``core.problem.Level``: the
    homogeneous (3, 3) table, two-phase (a0, a1) and phase-affine
    (base + bit_scale * bitplanes, the heat system of ``ops/heat.py``)."""
    H = level.n + 1
    dtype = dtype or level.geo.dtype
    dev = level.geo.device
    if level.pid is None:
        table = level.table if level.table.ndim == 2 else level.table[0]
        return table.to(dtype).expand(H, H, 3, 3)
    p = level.pid.to(torch.int32)
    if level.base is not None:
        base = level.base.to(dtype)
        scale = float(level.bit_scale)
    else:
        base = float(level.a0) * _taps_grid(stencil_mod.UNIT_S9, dtype, dev)
        scale = float(level.a1) - float(level.a0)
    S = base.expand(H, H, 3, 3)
    for e, taps in enumerate(stencil_mod.UNIT_S4):
        bit = ((p >> e) & 1).to(dtype)  # (H, W)
        S = S + (scale * bit)[..., None, None] * _taps_grid(taps, dtype, dev)
    return S


def _shift(x, dr, dc):
    """x[i + dr, j + dc] with zero ghosts (|dr|, |dc| <= 1)."""
    H, W = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    return xp[1 + dr : 1 + dr + H, 1 + dc : 1 + dc + W]


def transfer_weights(S: torch.Tensor, geo_f, geo_c) -> torch.Tensor:
    """Composed (H, W, 2, 2) W4 weights from a per-node stencil field.

    Dendy collapse on the full grid (the parity masks discard off-class
    values): F-x nodes (even row, odd column) interpolate from their W/E
    coarse neighbours with the row-collapsed stencil, F-y nodes likewise by
    columns, F-c nodes (odd, odd) by their own stencil row composed with the
    neighbours' F-x/F-y weights and the C injections.  ``geo_f`` zeroes
    boundary fine rows; ``geo_c`` zeroes weights that target boundary
    coarse nodes."""
    H = S.shape[0]
    sx = S.sum(dim=2)  # (H, W, 3): row-collapsed [W, C, E]
    wxW = -sx[..., 0] / _guard(sx[..., 1])
    wxE = -sx[..., 2] / _guard(sx[..., 1])
    sy = S.sum(dim=3)  # (H, W, 3): col-collapsed [N, C, S]
    wyN = -sy[..., 0] / _guard(sy[..., 1])
    wyS = -sy[..., 2] / _guard(sy[..., 1])
    wc = -S / _guard(S[..., 1:2, 1:2])  # (H, W, 3, 3), centre unused

    i = torch.arange(H, device=S.device)
    re = (i[:, None] % 2 == 0)  # row-even
    ce = (i[None, :] % 2 == 0)  # col-even
    C, Fx, Fy, Fc = re & ce, re & ~ce, ~re & ce, ~re & ~ce

    fc00 = (wc[..., 0, 0] + wc[..., 0, 1] * _shift(wxW, -1, 0)
            + wc[..., 1, 0] * _shift(wyN, 0, -1))
    fc01 = (wc[..., 0, 2] + wc[..., 0, 1] * _shift(wxE, -1, 0)
            + wc[..., 1, 2] * _shift(wyN, 0, 1))
    fc10 = (wc[..., 2, 0] + wc[..., 2, 1] * _shift(wxW, 1, 0)
            + wc[..., 1, 0] * _shift(wyS, 0, -1))
    fc11 = (wc[..., 2, 2] + wc[..., 2, 1] * _shift(wxE, 1, 0)
            + wc[..., 1, 2] * _shift(wyS, 0, 1))
    del sx, sy, wc

    zero = torch.zeros_like(wxW)
    one = torch.ones_like(wxW)
    w = {(0, 0): torch.where(C, one, torch.where(Fx, wxW, torch.where(Fy, wyN, fc00))),
         (0, 1): torch.where(Fx, wxE, torch.where(Fc, fc01, zero)),
         (1, 0): torch.where(Fy, wyS, torch.where(Fc, fc10, zero)),
         (1, 1): torch.where(Fc, fc11, zero)}
    gc = None if geo_c is None else up_sample(geo_c.to(S.dtype))
    for (a, b), x in w.items():
        if geo_f is not None:
            x = x * geo_f.to(S.dtype)
        if gc is not None:
            x = x * gc[a, b]
        w[a, b] = x
    return torch.stack([torch.stack([w[0, 0], w[0, 1]], dim=-1),
                        torch.stack([w[1, 0], w[1, 1]], dim=-1)], dim=-2)


def up_sample(xc: torch.Tensor) -> torch.Tensor:
    """(..., m, m) coarse planes -> a (..., 2, 2, 2m-1, 2m-1) view whose
    [a, b] entry samples ``xc`` at (i//2 + a, j//2 + b), zero past the edge:
    one padded, twice-repeated copy of ``xc`` read at row offset 2a and
    column offset 2b."""
    m = xc.shape[-1]
    lead = xc.shape[:-2]
    xp = F.pad(xc, (0, 1, 0, 1))
    rep = xp[..., :, None, :, None].expand(*lead, m + 1, 2, m + 1, 2).reshape(
        *lead, 2 * m + 2, 2 * m + 2)
    sr, sc = rep.stride(-2), rep.stride(-1)
    return rep.as_strided((*lead, 2, 2, 2 * m - 1, 2 * m - 1),
                          (*rep.stride()[:-2], 2 * sr, 2 * sc, sr, sc))


def prolong_planes(uc, w00, w01, w10, w11):
    """Prolongation with the four W4 planes given separately (each (H, W));
    the sum runs over (a, b) = (0,0), (0,1), (1,0), (1,1) in that order."""
    U = up_sample(uc)
    out = None
    for w, (a, b) in zip((w00, w01, w10, w11), ((0, 0), (0, 1), (1, 0), (1, 1))):
        t = w * U[..., a, b, :, :]
        out = t if out is None else out + t
    return out


def prolong_w4(uc: torch.Tensor, W4: torch.Tensor) -> torch.Tensor:
    """(m, m) coarse -> (2m-1, 2m-1) fine via the composed weights (masks
    included: W4 carries the geo folds)."""
    return prolong_planes(uc, W4[..., 0, 0], W4[..., 0, 1], W4[..., 1, 0], W4[..., 1, 1])


def restrict_stage(t0, t1, dim: int):
    """One axis of the W4 restriction, along ``dim`` (-2: rows, -1:
    columns; any leading dims): ``out[I] = t1[2I-1] + t0[2I] + t0[2I+1]``
    (zero past the edges), where ``t0`` carries the a = 0 (b = 0) weights
    and ``t1`` the a = 1 (b = 1) ones."""
    def at(x, sl):
        return x[(..., sl) if dim == -1 else (..., sl, slice(None))]

    front, back = ((1, 0), (0, 1)) if dim == -1 else ((0, 0, 1, 0), (0, 0, 0, 1))
    up = F.pad(at(t1, slice(1, None, 2)), front)  # t1[2I-1], I >= 1
    dn = F.pad(at(t0, slice(1, None, 2)), back)  # t0[2I+1], I <= m-2
    return up + at(t0, slice(0, None, 2)) + dn


def restrict_planes(r, w00, w01, w10, w11):
    """Restriction with the four W4 planes given separately; see
    :func:`restrict_w4`.  Fields and planes may carry leading dims."""
    rows_0 = restrict_stage(w00 * r, w10 * r, -2)
    rows_1 = restrict_stage(w01 * r, w11 * r, -2)
    return restrict_stage(rows_0, rows_1, -1)


def restrict_w4(r: torch.Tensor, W4: torch.Tensor) -> torch.Tensor:
    """(H, H) fine -> (m, m) coarse, the exact transpose of prolong_w4:

        (P^T r)[I, J] = sum_{dr, dc in {-1,0,1}}
            W4[2I+dr, 2J+dc, a*(dr), b*(dc)] * r[2I+dr, 2J+dc]

    with a*(-1) = 1, a*(0) = a*(1) = 0 (a fine node at row 2I-1 reaches
    coarse row I through its a=1 weight)."""
    return restrict_planes(r, W4[..., 0, 0], W4[..., 0, 1], W4[..., 1, 0], W4[..., 1, 1])


def apply_s9(S: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A u for a per-node (H, W, 3, 3) stencil field (9 shifted FMAs)."""
    H, W = u.shape[-2:]
    up = F.pad(u, (1, 1, 1, 1))
    out = None
    for dr in range(3):
        for dc in range(3):
            t = S[..., dr, dc] * up[..., dr : dr + H, dc : dc + W]
            out = t if out is None else out + t
    return out


def galerkin_rap(S: torch.Tensor, W4: torch.Tensor) -> torch.Tensor:
    """Coarse per-node stencils S_c = P^T A P via nine 3-strided lattice
    probes, one at a time: within any coarse 3x3 window each offset is hit
    by exactly one lattice, so S_c[I, J, dr, dc] is the probe whose residues
    match (I + dr - 1, J + dc - 1)."""
    m = (S.shape[0] - 1) // 2 + 1
    dtype = W4.dtype
    I = torch.arange(m, device=S.device)
    ys = {}
    for a in range(3):
        for b in range(3):
            e = ((I[:, None] % 3 == a) & (I[None, :] % 3 == b)).to(dtype)
            ys[a, b] = restrict_w4(apply_s9(S, prolong_w4(e, W4)), W4)
    cols = []
    for dr in range(3):
        row_entries = []
        for dc in range(3):
            acc = None
            for a in range(3):
                ra = ((I + dr - 1) % 3 == a).to(dtype)[:, None]
                for b in range(3):
                    cb = ((I + dc - 1) % 3 == b).to(dtype)[None, :]
                    t = (ra * cb) * ys[a, b]
                    acc = t if acc is None else acc + t
            row_entries.append(acc)
        cols.append(torch.stack(row_entries, dim=-1))
    return torch.stack(cols, dim=-2)  # (m, m, 3, 3)


def _ring_mask(m: int, dtype, device) -> torch.Tensor:
    g = torch.zeros((m, m), dtype=dtype, device=device)
    g[1:-1, 1:-1] = 1.0
    return g


def boxmg_setup(hier, num_levels: Optional[int] = None, dtype=None):
    """BoxMG hierarchy setup from a GridHierarchy, on its device: returns
    ``[(W4_0, Sc_1), (W4_1, Sc_2), ...]``, the transfers of every level pair
    and the Galerkin stencil field of every coarse level.  Each coarse
    operator's Dirichlet ring (identically zero rows) gets a unit centre,
    so Jacobi's omega / d never divides by zero; ring values stay 0 because
    every leg masks updates to the interior."""
    L = num_levels if num_levels is not None else hier.num_levels
    fine = hier.levels[0]
    dtype = dtype or fine.geo.dtype
    geos = [hier.levels[l].geo.to(dtype) if l < hier.num_levels
            else _ring_mask((fine.n >> l) + 1, dtype, fine.geo.device)
            for l in range(L)]
    S = node_stencil_planes(fine, dtype)
    outs = []
    for l in range(L - 1):
        W4 = transfer_weights(S, geos[l], geos[l + 1])
        Sc = galerkin_rap(S, W4)
        d = Sc[..., 1, 1]
        Sc[..., 1, 1] = torch.where(d.abs() > 0, d, 1.0)
        outs.append((W4, Sc))
        S = Sc
    return outs
