"""Content-adaptive inter-grid transfers (operator-induced, "BoxMG"
transfers) and Galerkin coarsening: the scalar research hierarchy.

Port of ``multigrid_feanet_tpu/ops/adaptive_transfer.py``, which runs in XLA
outside any Pallas kernel; here it is torch ops on the fine level's device.
The transfer weights are induced by the assembled operator (Dendy's
black-box interpolation for 9-point stencils), so they follow the 20x
coefficient jump; with Galerkin coarse operators (R A P by 3-coloured
probes) the bi-material interface V(1,1) cycle reaches the homogeneous
problem's factor, with no training.

Vertex-centred coarsening by 2; fine node classes C (both indices even),
Fx (even row, odd column), Fy (odd row, even column), Fc (both odd).  With
S the per-node 3x3 stencil:

- Fx nodes collapse S over rows: wW = -sum_dr S[., dr, 0] / sum_dr S[., dr, 1];
- Fy nodes collapse over columns;
- Fc nodes solve their own stencil row: w[dr, dc] = -S[dr, dc] / S[1, 1]
  over the 8 neighbours (C, Fx, Fy values from the previous stage);
- restriction is the exact transpose R = P^T (for the homogeneous operator,
  bilinear P and 4 x full weighting, the reference's scaling).

- :class:`AdaptiveTransfer`: the weights of one fine level, computed on the
  host in numpy f64 as the JAX package computes them, then placed on the
  fine level's device; ``prolong`` / ``restrict`` take any leading dims.
- :func:`galerkin_stencils`: S_c = R A P from the nine 3-strided probes,
  run as one batch.
- :class:`BoxMG`: the V-cycle hierarchy on these transfers and Galerkin
  :class:`GeneralLevel` s, with ``solve`` in chunks of 8 cycles and one
  host sync per chunk.
- :class:`GeneralLevel` and :func:`general_coarse_inverse` also serve
  ``solvers/boxmg.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from multigrid_feanet_torch.ops import stencil as stencil_mod

CHUNK = 8  # cycles between host syncs in BoxMG.solve, as in the JAX solver


def node_stencils(level) -> torch.Tensor:
    """Per-node (H, W, 3, 3) stencil entries of a hierarchy Level.

    ``level.table`` holds the full 16-entry table of a bi-material level
    (the heat system's levels fold M + theta dt K into it), so the gather
    covers the phase-affine systems too."""
    if level.pid is None:
        H = level.n + 1
        table = level.table if level.table.ndim == 2 else level.table[0]
        return table.expand(H, H, 3, 3)
    return stencil_mod.gather_coefficients(level.table, level.pid)


def _interleave_last(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., k) and (..., k) -> (..., 2k): a[0], b[0], a[1], b[1], ..."""
    return torch.stack([a, b], dim=-1).flatten(-2)


def _pad(x, left=0, right=0, top=0, bottom=0):
    return F.pad(x, (left, right, top, bottom))


class AdaptiveTransfer:
    """Operator-induced P and R = P^T for one fine level.

    From the fine level's per-node stencils ``S`` (H, W, 3, 3) (any array
    or tensor) it precomputes, in numpy f64:
      ``wx`` (m, m-1, 2): the Fx weights (W, E) at even rows / odd columns;
      ``wy`` (m-1, m, 2): the Fy weights (N, S) at odd rows / even columns;
      ``wc`` (m-1, m-1, 3, 3): the Fc weights (centre zero) at odd / odd;
    with m = n/2 + 1, and stores them in ``dtype`` on ``geo_fine``'s
    device.  ``geo_fine`` masks the prolonged correction and ``geo_coarse``
    the restricted residual's coarse ring, as the classical pair does."""

    def __init__(self, S, geo_fine, geo_coarse=None, dtype=torch.float32):
        if isinstance(S, torch.Tensor):
            S = S.detach().cpu().numpy()
        S = np.asarray(S, np.float64)
        n = S.shape[0] - 1
        assert n % 2 == 0
        m = n // 2 + 1
        self.dtype = dtype
        device = geo_fine.device if geo_fine is not None else "cpu"

        def safe_div(num, den):
            den = np.where(np.abs(den) < 1e-300, 1.0, den)
            return num / den

        def dev(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        sx = S[0::2, 1::2].sum(axis=2)  # (m, m-1, 3): [W, C, E]
        self.wx = dev(np.stack([safe_div(-sx[..., 0], sx[..., 1]),
                                safe_div(-sx[..., 2], sx[..., 1])], axis=-1))
        sy = S[1::2, 0::2].sum(axis=3)  # (m-1, m, 3): [N, C, S]
        self.wy = dev(np.stack([safe_div(-sy[..., 0], sy[..., 1]),
                                safe_div(-sy[..., 2], sy[..., 1])], axis=-1))
        Sc = S[1::2, 1::2]  # (m-1, m-1, 3, 3)
        wc = safe_div(-Sc, Sc[..., 1:2, 1:2])
        wc[..., 1, 1] = 0.0
        self.wc = dev(wc)
        self.n, self.m = n, m
        self.geo_f = geo_fine
        self.geo_c = geo_coarse

    def prolong(self, uc: torch.Tensor) -> torch.Tensor:
        """(..., m, m) coarse correction -> (..., n+1, n+1) fine, masked by
        ``geo_f``."""
        wx, wy, wc = self.wx, self.wy, self.wc
        # even fine rows: injection at even columns, the Fx blend at odd ones
        fx = wx[..., 0] * uc[..., :, :-1] + wx[..., 1] * uc[..., :, 1:]
        even = torch.cat([_interleave_last(uc[..., :, :-1], fx), uc[..., :, -1:]], dim=-1)
        # odd fine rows: Fy at even columns from the C rows above and below
        fy = wy[..., 0] * uc[..., :-1, :] + wy[..., 1] * uc[..., 1:, :]
        # Fc at odd columns from the 8 neighbours: N/S are the adjacent even
        # fine rows (C and Fx values), W/E the same row's Fy values
        eN, eS = even[..., :-1, :], even[..., 1:, :]
        fc = (wc[..., 0, 0] * eN[..., :, 0:-2:2] + wc[..., 0, 1] * eN[..., :, 1:-1:2]
              + wc[..., 0, 2] * eN[..., :, 2::2]
              + wc[..., 2, 0] * eS[..., :, 0:-2:2] + wc[..., 2, 1] * eS[..., :, 1:-1:2]
              + wc[..., 2, 2] * eS[..., :, 2::2]
              + wc[..., 1, 0] * fy[..., :, :-1] + wc[..., 1, 2] * fy[..., :, 1:])
        odd = torch.cat([_interleave_last(fy[..., :, :-1], fc), fy[..., :, -1:]], dim=-1)
        body = torch.stack([even[..., :-1, :], odd], dim=-2).flatten(-3, -2)
        out = torch.cat([body, even[..., -1:, :]], dim=-2)
        if self.geo_f is not None:
            out = out * self.geo_f
        return out

    def restrict(self, r: torch.Tensor) -> torch.Tensor:
        """(..., n+1, n+1) fine residual -> (..., m, m) coarse RHS = P^T r.

        P = P2 P1 with P1: coarse -> {C, Fx, Fy} and P2 = I + N (N fills Fc
        from its 8 neighbours), so P^T r = P1^T (r + N^T r): each Fc value
        first scatters into its neighbours with its own weights, then Fx and
        Fy collapse into their C parents beside the injection."""
        if self.geo_f is not None:
            r = r * self.geo_f
        even = r[..., 0::2, :]  # (m, n+1): C and Fx slots
        odd = r[..., 1::2, :]  # (m-1, n+1): Fy and Fc slots
        rc_ = odd[..., :, 1::2]  # (m-1, m-1): the Fc values
        wc = self.wc

        def scatter_row(wrow):
            """Fc values weighted by wrow (m-1, m-1, 3) -> one (m-1, n+1)
            fine row: the Fc at odd column c sends wrow[..., k] to c + k - 1."""
            contrib_w = wrow[..., 0] * rc_  # lands at column c - 1 (even)
            contrib_c = wrow[..., 1] * rc_  # at c (odd)
            contrib_e = wrow[..., 2] * rc_  # at c + 1 (even)
            evenc = _pad(contrib_e, left=1) + _pad(contrib_w, right=1)  # (m-1, m)
            return torch.cat([_interleave_last(evenc[..., :, :-1], contrib_c),
                              evenc[..., :, -1:]], dim=-1)

        even = even + _pad(scatter_row(wc[..., 0, :]), bottom=1)
        even = even + _pad(scatter_row(wc[..., 2, :]), top=1)
        # the same row's W / E neighbours are Fy slots (even columns of odd rows)
        fy = odd[..., :, 0::2]  # (m-1, m)
        fy = fy + _pad(wc[..., 1, 2] * rc_, left=1) + _pad(wc[..., 1, 0] * rc_, right=1)
        # P1^T: Fx (odd columns of even rows) and Fy collapse into C, plus
        # the injection
        fx = even[..., :, 1::2]  # (m, m-1)
        out = (even[..., :, 0::2]
               + _pad(self.wx[..., 1] * fx, left=1) + _pad(self.wx[..., 0] * fx, right=1)
               + _pad(self.wy[..., 1] * fy, top=1) + _pad(self.wy[..., 0] * fy, bottom=1))
        if self.geo_c is not None:
            out = out * self.geo_c
        return out


class GeneralLevel:
    """A multigrid level with an arbitrary per-node (H, W, 3, 3) stencil
    field ``S``; duck-types the parts of ``core.problem.Level`` the solvers
    use: ``apply``, ``diag``, ``geo``, ``n``, ``n_nodes``."""

    def __init__(self, S, geo, dtype=torch.float32):
        self.S = torch.as_tensor(S, dtype=dtype)
        self.geo = geo
        self.n = self.S.shape[0] - 1
        # boundary rows of a Galerkin product are identically zero (the
        # transfers mask the Dirichlet ring): guard the Jacobi diagonal
        d = self.S[..., 1, 1]
        self.diag = torch.where(d.abs() > 0, d, 1.0)

    @property
    def n_nodes(self) -> int:
        return self.n + 1

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        H, W = u.shape[-2:]
        up = F.pad(u, (1, 1, 1, 1))
        out = torch.zeros_like(u)
        for dr in range(3):
            for dc in range(3):
                out = out + self.S[..., dr, dc] * up[..., dr : dr + H, dc : dc + W]
        return out


def probe_lattices(m: int, device) -> torch.Tensor:
    """The nine 3-strided coarse lattices, (3, 3, m, m) bool: [a, b] is true
    at the nodes with (I % 3, J % 3) == (a, b)."""
    I = torch.arange(m, device=device)
    lat = torch.arange(3, device=device)
    return ((I[None, None, :, None] % 3 == lat[:, None, None, None])
            & (I[None, None, None, :] % 3 == lat[None, :, None, None]))


def gather_probes(ys: torch.Tensor) -> torch.Tensor:
    """Galerkin stencils from the probes' images: ``ys`` (3, 3, *rest, m, m)
    holds R A P of lattice (a, b) -> (m, m, 3, 3, *rest).  In any coarse 3x3
    window each offset holds exactly one lattice point, so entry (I, J, dr,
    dc) is the image of the lattice whose residues match (I + dr - 1,
    J + dc - 1), read at (I, J)."""
    m = ys.shape[-1]
    I = torch.arange(m, device=ys.device)
    taps = (I[:, None] + torch.arange(3, device=ys.device)[None, :] - 1) % 3  # (m, 3)
    yp = ys.movedim((-2, -1), (0, 1))  # (I, J, a, b, *rest)
    return yp[I[:, None, None, None], I[None, :, None, None], taps[:, None, :, None],
              taps[None, :, None, :]]


def galerkin_stencils(apply_fine, at: AdaptiveTransfer, m: int,
                      dtype=torch.float64) -> torch.Tensor:
    """Coarse per-node stencils S_c = R A P from the nine 3-strided impulse
    probes of :func:`probe_lattices`, run as one (9, m, m) batch in the
    transfers' dtype (the probe values are exact 0 / 1), read off by
    :func:`gather_probes`.  Returns (m, m, 3, 3) in ``dtype`` on the
    transfers' device."""
    probes = probe_lattices(m, at.wx.device).reshape(9, m, m).to(at.wx.dtype)
    ys = at.restrict(apply_fine(at.prolong(probes)))
    return gather_probes(ys.to(dtype).reshape(3, 3, m, m))


def general_coarse_inverse(level: GeneralLevel, dtype=torch.float32) -> torch.Tensor:
    """Dense inv(A_interior) of a GeneralLevel, assembled and inverted in
    f64 on the host and placed on the level's device in ``dtype``; same
    contract as ``solvers.coarse.coarse_inverse``."""
    S = level.S.detach().cpu().numpy().astype(np.float64)
    n = level.n
    m = n - 1
    A = np.zeros((m * m, m * m), np.float64)
    for i in range(1, n):
        for j in range(1, n):
            row = (i - 1) * m + (j - 1)
            for dr in (-1, 0, 1):
                for dc in (-1, 0, 1):
                    ii, jj = i + dr, j + dc
                    if 1 <= ii < n and 1 <= jj < n:
                        A[row, (ii - 1) * m + (jj - 1)] += S[i, j, 1 + dr, 1 + dc]
    return torch.as_tensor(np.linalg.inv(A), dtype=dtype, device=level.S.device)


class BoxMG:
    """Multigrid with operator-induced transfers and Galerkin coarse levels:
    the content-adaptive hierarchy, built once from a fine Level (any
    operator the stencil table expresses).  Coarse levels are
    :class:`GeneralLevel` s with probed R A P stencils, the transfers
    :class:`AdaptiveTransfer` pairs; every tensor lives on the hierarchy's
    device.

    ``galerkin=False`` keeps the hierarchy's re-discretized coarse operators
    and swaps only the transfer pair; that isolates the two effects at
    shallow depth but does not converge at full depth on the interface
    (the coarse operator departs from P^T A P near the jump, level by
    level).  ``dtype`` defaults to the hierarchy's field dtype."""

    def __init__(self, hier, num_levels: Optional[int] = None,
                 galerkin: bool = True, dtype=None):
        from multigrid_feanet_torch.solvers import coarse as _coarse

        fine = hier.levels[0]
        dtype = dtype or fine.geo.dtype
        self.dtype = dtype
        device = fine.geo.device
        L = num_levels if num_levels is not None else hier.num_levels
        self.levels = [fine]
        self.transfers = []
        lv = fine
        for l in range(L - 1):
            S = lv.S if isinstance(lv, GeneralLevel) else node_stencils(lv)
            if l + 1 < hier.num_levels:
                geo_c = hier.levels[l + 1].geo
            else:
                mc = lv.n // 2 + 1
                geo_c = torch.zeros((mc, mc), dtype=dtype, device=device)
                geo_c[1:-1, 1:-1] = 1.0
            at = AdaptiveTransfer(S, lv.geo, geo_c, dtype=dtype)
            self.transfers.append(at)
            if galerkin:
                Sc = galerkin_stencils(lv.apply, at, lv.n // 2 + 1)
                nxt = GeneralLevel(Sc, geo_c, dtype=dtype)
            else:
                nxt = hier.levels[l + 1]
            self.levels.append(nxt)
            lv = nxt
        self.coarse_inv = None
        cl = self.levels[-1]
        if cl.n >= 2 and len(self.levels) > 1:
            self.coarse_inv = (general_coarse_inverse(cl, dtype)
                               if isinstance(cl, GeneralLevel)
                               else _coarse.coarse_inverse(cl, dtype))

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def v_cycle(self, u, f, nu1: int = 1, nu2: int = 1, omega: float = 2.0 / 3.0,
                level: int = 0):
        """One V(nu1, nu2) cycle from ``level`` with weighted-Jacobi
        smoothing (zero Dirichlet data) and the direct coarse solve."""
        from multigrid_feanet_torch.solvers.coarse import coarse_solve
        from multigrid_feanet_torch.solvers.jacobi import relax

        lv = self.levels[level]
        if level == self.num_levels - 1:
            if self.coarse_inv is not None and level > 0:
                return coarse_solve(self.coarse_inv, f).to(u.dtype)
            return relax(lv, u, f, nu1 + nu2, 0.0, omega)
        u = relax(lv, u, f, nu1, 0.0, omega)
        at = self.transfers[level]
        f_c = at.restrict((f - lv.apply(u)) * lv.geo)
        u_c = self.v_cycle(torch.zeros_like(f_c, dtype=u.dtype), f_c, nu1, nu2, omega,
                           level + 1)
        u = u + at.prolong(u_c)
        return relax(lv, u, f, nu2, 0.0, omega)

    def solve(self, f, u0=None, nu1: int = 1, nu2: int = 1, eps: float = 1e-6,
              max_cycles: int = 100, omega: float = 2.0 / 3.0):
        """V-cycles until the interior residual norm reaches ``eps`` (None:
        never) or ``max_cycles``, in chunks of 8 with the norms kept on the
        device and read back once a chunk.  Returns ``(u, history)``,
        ``history[k]`` the residual after cycle k+1; ``u`` carries the whole
        chunk in which ``eps`` was met, as in the JAX solver."""
        from multigrid_feanet_torch.solvers.common import run_chunks
        from multigrid_feanet_torch.solvers.jacobi import interior_norm

        lv0 = self.levels[0]
        device = lv0.geo.device
        f = torch.as_tensor(f, device=device)
        u = torch.zeros_like(f) if u0 is None else torch.as_tensor(u0, dtype=f.dtype,
                                                                    device=device)

        def run(u, k):
            norms = []
            for _ in range(k):
                u = self.v_cycle(u, f, nu1, nu2, omega)
                norms.append(interior_norm(f - lv0.apply(u)))
            return u, torch.stack(norms)

        return run_chunks(run, u, max_cycles, CHUNK, eps)
