"""Elastic multigrid with block-BoxMG transfers and Galerkin coarse levels
(``ops/boxmg_elastic.py``): the convergence-technology path of the 2-DOF
interface problem.

Port of ``multigrid_feanet_tpu/solvers/elastic_boxmg.py``, in torch ops on
the levels' device (the JAX module is XLA, with no Pallas kernel).  Its aim
is the cycle's asymptotic factor, which the bilinear transfers of
``solvers/elastic.py`` lose across the 20:1 coefficient jump; measure it
floor-free with the f = 0 random-start decay protocol in f64.  ``solve``
runs V- or W-cycles in chunks of 8 with the residual norms kept on the
device and read back once a chunk.

Each level keeps its operator and transfers in the layouts the contractions
of ``ops/boxmg_elastic.py`` read, so a level visit is a few dozen launches:
a W-cycle visits level l 2^l times.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from multigrid_feanet_torch.ops import boxmg_elastic as be
from multigrid_feanet_torch.ops.elasticity import elastic_interior_norm
from multigrid_feanet_torch.solvers.coarse import coarse_solve_elastic
from multigrid_feanet_torch.solvers.common import run_chunks

CHUNK = 8  # cycles between host syncs in ElasticBoxMG.solve, as in the JAX solver


def elastic_coarse_inverse(S_np, n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Dense inv(A_interior) of a block stencil field (n+1, n+1, 3, 3, 2, 2)
    (numpy or tensor), assembled and inverted in f64 on the host and placed
    on ``device`` in ``dtype`` (f32 by default, as in the JAX module).  DOF
    order: node-major, row-major, component-minor (``coarse_solve_elastic``'s)."""
    if isinstance(S_np, torch.Tensor):
        S_np = S_np.detach().cpu().numpy()
    S_np = np.asarray(S_np, np.float64)
    m = n - 1
    A = np.zeros((2 * m * m, 2 * m * m), np.float64)
    for i in range(1, n):
        for j in range(1, n):
            row = (i - 1) * m + (j - 1)
            for dr in (-1, 0, 1):
                for dc in (-1, 0, 1):
                    ii, jj = i + dr, j + dc
                    if 1 <= ii < n and 1 <= jj < n:
                        col = (ii - 1) * m + (jj - 1)
                        A[2 * row : 2 * row + 2, 2 * col : 2 * col + 2] += S_np[i, j, 1 + dr,
                                                                                1 + dc]
    return torch.as_tensor(np.linalg.inv(A), dtype=dtype, device=device)


class ElasticBoxMG:
    """Block-BoxMG hierarchy over a tuple of ElasticLevels
    (``solvers/elastic.build_elastic_hierarchy``), on their device.

    ``setup`` is a ``boxmg_elastic_setup`` result (computed here when None;
    ``core/convert.elastic_boxmg_setup_from_arrays`` carries another
    package's across).  The direct coarse solve uses the dense inverse of
    the coarsest Galerkin operator, rounded to f32 as the JAX solver rounds
    it and applied in the fields' dtype."""

    def __init__(self, levels, num_levels: Optional[int] = None, omega: float = 2.0 / 3.0,
                 direct_coarse: bool = True, setup=None):
        L = num_levels if num_levels is not None else len(levels)
        self.levels = tuple(levels[:L])
        self.L = L
        self.omega = float(omega)
        self.setup = setup if setup is not None else be.boxmg_elastic_setup(levels, L)
        fine = levels[0]
        self.dtype, self.device = fine.geo.dtype, fine.geo.device
        S = [None] + [self.setup[l][1] for l in range(L - 1)]
        # the contractions' layouts, kept contiguous: stencils, both
        # transfers, and the inverse diagonal blocks as (o, i, H, W)
        self._S = [None] + [be.stencil_layout(s).contiguous() for s in S[1:]]
        self._Wp = [be.prolong_layout(w).contiguous() for w, _ in self.setup[: L - 1]]
        self._Wr = [be.restrict_layout(w).contiguous() for w, _ in self.setup[: L - 1]]
        dinv = [fine.dinv] + [be.inv2x2_guarded(s[..., 1, 1, :, :]) for s in S[1:]]
        self._dinv = [d.permute(2, 3, 0, 1).contiguous() for d in dinv]
        self._geo = [lv.geo[None] for lv in self.levels]
        self.coarse_inv = None
        if direct_coarse and L > 1 and self.levels[L - 1].n >= 2:
            self.coarse_inv = elastic_coarse_inverse(
                S[L - 1], self.levels[L - 1].n, device=self.device).to(self.dtype)

    def _apply(self, l: int, u):
        if l == 0:
            return self.levels[0].apply(u)
        return be.block_apply(self._S[l], u)

    def _relax(self, l: int, u, f, k: int):
        """``k`` damped block-Jacobi sweeps on level ``l``."""
        geo, dinv = self._geo[l], self._dinv[l]
        for _ in range(k):
            r = (f - self._apply(l, u)) * geo
            # the masked residual makes the update zero on the ring
            u = torch.add(u, (dinv * r[None]).sum(1), alpha=self.omega)
        return u

    def v_cycle(self, u, f, nu1: int = 2, nu2: int = 2, level: int = 0, gamma: int = 1):
        """gamma = 1: V-cycle; gamma = 2: W-cycle.  The W-cycle matters here:
        the Galerkin coarse interface problems are themselves hard (each
        level's two-grid factor ~0.43-0.5), and a V-cycle compounds their
        inexactness level by level while the W-cycle holds the two-grid
        factor."""
        if level == self.L - 1:
            if self.coarse_inv is not None and level > 0:
                return coarse_solve_elastic(self.coarse_inv, f)
            return self._relax(level, u, f, nu1 + nu2)
        u = self._relax(level, u, f, nu1)
        r = (f - self._apply(level, u)) * self._geo[level]
        f_c = be.block_restrict(r, self._Wr[level])
        u_c = torch.zeros_like(f_c)
        for _ in range(gamma):
            u_c = self.v_cycle(u_c, f_c, nu1, nu2, level + 1, gamma)
        u = u + be.block_prolong(u_c, self._Wp[level])
        return self._relax(level, u, f, nu2)

    def solve(self, f, u0=None, nu1: int = 2, nu2: int = 2, eps: float = 1e-8,
              max_cycles: int = 100, gamma: int = 1):
        """V (gamma 1) or W (gamma 2) cycles until the interior residual norm
        reaches ``eps`` (None: never) or ``max_cycles``.  Returns ``(u,
        history)``, ``history[k]`` the norm after cycle k+1 (the
        ``solvers/elastic.solve`` convention); ``u`` carries the whole
        chunk in which ``eps`` was met."""
        f = torch.as_tensor(f, device=self.device)
        u = torch.zeros_like(f) if u0 is None else torch.as_tensor(u0, dtype=f.dtype,
                                                                    device=self.device)
        u = u * self._geo[0]

        def run(u, k):
            norms = []
            for _ in range(k):
                u = self.v_cycle(u, f, nu1, nu2, gamma=gamma)
                norms.append(elastic_interior_norm((f - self._apply(0, u)) * self._geo[0]))
            return u, torch.stack(norms)

        return run_chunks(run, u, max_cycles, CHUNK, eps)
