"""Levels with an arbitrary per-node 3x3 stencil, and their dense inverse.

Port of the part of ``multigrid_feanet_tpu/ops/adaptive_transfer.py`` that
the BoxMG solver needs (``GeneralLevel`` and ``general_coarse_inverse``):
the Galerkin coarse operators are spatially varying 9-point stencils that
leave the 16-pattern family, so the direct coarse solve assembles them
node by node.  The rest of the module (the research-scale transfers and
probes) comes with its own slice.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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
