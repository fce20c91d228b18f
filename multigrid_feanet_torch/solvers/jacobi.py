"""Weighted-Jacobi smoother.

Port of the step functions of ``multigrid_feanet_tpu/solvers/jacobi.py``:

    u <- reset(u);  u <- reset(u + omega / diag(A) * (f - A u))

``solve_jacobi`` is not ported yet.
"""

from __future__ import annotations

import torch

from multigrid_feanet_torch.core.geometry import reset_boundary
from multigrid_feanet_torch.core.problem import Level

DEFAULT_OMEGA = 2.0 / 3.0


def interior_norm(r: torch.Tensor) -> torch.Tensor:
    """L2 norm of the interior residual (boundary ring excluded)."""
    ri = r[..., 1:-1, 1:-1]
    return torch.sqrt(torch.sum(ri * ri, dim=(-2, -1)))


def jacobi_step(level: Level, u: torch.Tensor, f: torch.Tensor, bc_value=0.0,
                omega: float = DEFAULT_OMEGA) -> torch.Tensor:
    """One weighted-Jacobi sweep with Dirichlet reset."""
    u = reset_boundary(u, level.geo, bc_value)
    r = f - level.apply(u)
    u = u + (omega / level.diag) * r
    return reset_boundary(u, level.geo, bc_value)


def relax(level: Level, u: torch.Tensor, f: torch.Tensor, num_sweeps: int,
          bc_value=0.0, omega: float = DEFAULT_OMEGA) -> torch.Tensor:
    """``num_sweeps`` Jacobi sweeps."""
    for _ in range(num_sweeps):
        u = jacobi_step(level, u, f, bc_value, omega)
    return u
