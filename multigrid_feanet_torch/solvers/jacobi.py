"""Weighted-Jacobi smoother and its solve loop.

Port of ``multigrid_feanet_tpu/solvers/jacobi.py``:

    u <- reset(u);  u <- reset(u + omega / diag(A) * (f - A u))

``solve_jacobi`` runs sweeps in chunks with the residual norms kept on the
device and reads them back once per chunk: one host sync per chunk.  The
residual computed for sweep k's update is the post-update residual of
sweep k - 1, so each sweep costs one operator apply, plus one apply per
chunk for the last sweep's norm.
"""

from __future__ import annotations

import torch

from multigrid_feanet_torch.core.geometry import reset_boundary
from multigrid_feanet_torch.core.problem import Level
from multigrid_feanet_torch.solvers.common import run_chunks

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


def _jacobi_chunk(level: Level, u, f, bc_value, chunk: int, omega: float):
    """``chunk`` sweeps -> (u, the post-sweep residual norms on the device)."""
    pre = []
    for _ in range(chunk):
        ur = reset_boundary(u, level.geo, bc_value)
        r = f - level.apply(ur)
        u = reset_boundary(ur + (omega / level.diag) * r, level.geo, bc_value)
        pre.append(interior_norm(r))
    final = interior_norm(f - level.apply(reset_boundary(u, level.geo, bc_value)))
    return u, torch.stack(pre[1:] + [final])


def solve_jacobi(level: Level, f, u0=None, bc_value=0.0, eps=1e-5,
                 max_iters: int = 200_000, chunk: int = 256,
                 omega: float = DEFAULT_OMEGA):
    """Iterate to ``eps`` (absolute interior L2 residual; None = never) or
    ``max_iters``.

    Returns ``(u, history)``, ``history[k]`` = the residual norm after k+1
    sweeps, the reference's convention.  ``u`` carries the whole chunk in
    which ``eps`` was met, as in the JAX solver."""
    f = torch.as_tensor(f, device=level.device)
    u = torch.zeros_like(f) if u0 is None else torch.as_tensor(u0, dtype=f.dtype,
                                                                device=level.device)
    return run_chunks(lambda u, k: _jacobi_chunk(level, u, f, bc_value, k, omega), u,
                      max_iters, chunk, eps)
