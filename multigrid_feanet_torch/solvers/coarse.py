"""Coarse-grid direct solve as a precomputed dense-inverse matmul.

Port of ``multigrid_feanet_tpu/solvers/coarse.py``: the scalar operator and
the 2-DOF elastic one (components interleaved node-major).  The coarsest
interior operator is assembled densely once on the host in f64, inverted
there and cast to the level's dtype; the solve is one ``torch.matmul``.  Callers on CUDA must keep TF32 off for that product
(``torch.backends.cuda.matmul.allow_tf32 = False``): TF32 keeps about three
decimal digits and would cost the coarse solve its exactness.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from multigrid_feanet_torch.core.problem import Level


def dense_interior_matrix(level: Level) -> np.ndarray:
    """A restricted to interior nodes as a dense (m^2, m^2) f64 matrix,
    m = n - 1, row-major over interior (i, j) in [1, n-1]^2; columns on the
    boundary ring are dropped (zero Dirichlet)."""
    n = level.n
    m = n - 1
    table = level.table.detach().cpu().numpy().astype(np.float64)
    pid = None if level.pid is None else level.pid.detach().cpu().numpy()
    A = np.zeros((m * m, m * m), dtype=np.float64)
    for i in range(1, n):
        for j in range(1, n):
            st = table if pid is None else table[pid[i, j]]
            row = (i - 1) * m + (j - 1)
            for dr in (-1, 0, 1):
                for dc in (-1, 0, 1):
                    ii, jj = i + dr, j + dc
                    if 1 <= ii < n and 1 <= jj < n:
                        A[row, (ii - 1) * m + (jj - 1)] += st[1 + dr, 1 + dc]
    return A


def coarse_inverse(level: Level, dtype=None) -> torch.Tensor:
    """inv(A_interior) of ``level``, built in f64 on the host and placed on
    the level's device in ``dtype`` (default: the level's float dtype).
    Warns above n = 65 (O(n^4) memory) and when an f32 inverse meets a
    1-norm condition estimate above 1e6."""
    m = level.n - 1
    if m > 64:
        warnings.warn(
            f"coarse_inverse on an n={level.n} level ({m}^2 interior nodes): "
            "dense inverse is O(n^4) memory; intended for n <= 65 truncation "
            "points", stacklevel=2)
    A = dense_interior_matrix(level)
    inv = np.linalg.inv(A)
    cond1 = np.abs(A).sum(0).max() * np.abs(inv).sum(0).max()
    if dtype is None:
        dtype = level.geo.dtype
    if dtype == torch.float32 and cond1 > 1e6:
        warnings.warn(
            f"coarse_inverse: cond_1(A) ~ {cond1:.2e}; f32 coarse solves may "
            "lose exactness (use a smaller truncation point or f64)",
            stacklevel=2)
    return torch.as_tensor(inv, dtype=dtype, device=level.device)


def coarse_solve(inv: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Exact interior solve ``u = inv @ f_interior`` (zero boundary ring);
    ``f``: (..., n+1, n+1) -> u of the same shape."""
    mm = inv.shape[0]
    m = int(round(np.sqrt(mm)))
    if f.shape[-1] != m + 2:
        raise ValueError(
            f"coarse_inv is for an n={m + 1} level ({m}^2 interior nodes) but "
            f"the RHS has shape {tuple(f.shape)}; pass "
            "coarse_inverse(hier.levels[-1])")
    fi = f[..., 1:-1, 1:-1].reshape(*f.shape[:-2], mm)
    ui = fi @ inv.T
    return F.pad(ui.reshape(*f.shape[:-2], m, m), (1, 1, 1, 1))


# ---- elastic (2-DOF/node) coarse direct solve ----


def dense_interior_matrix_elastic(level) -> np.ndarray:
    """The elastic operator of an ``ElasticLevel`` restricted to interior
    nodes as a dense (2 m^2, 2 m^2) f64 matrix, m = n - 1, row-major over
    interior (i, j) with the 2 displacement components interleaved
    (node-major).  ``table[pid[i, j], 1+dr, 1+dc]`` is the 2x2 (out_c,
    in_c) block coupling node (i, j) to (i+dr, j+dc); boundary columns are
    dropped (zero Dirichlet)."""
    n = level.n
    m = n - 1
    table = level.table.detach().cpu().numpy().astype(np.float64)
    pid = None if level.pid is None else level.pid.detach().cpu().numpy()
    A = np.zeros((2 * m * m, 2 * m * m), dtype=np.float64)
    for i in range(1, n):
        for j in range(1, n):
            st = table[0] if pid is None else table[pid[i, j]]
            row = (i - 1) * m + (j - 1)
            for dr in (-1, 0, 1):
                for dc in (-1, 0, 1):
                    ii, jj = i + dr, j + dc
                    if 1 <= ii < n and 1 <= jj < n:
                        col = (ii - 1) * m + (jj - 1)
                        A[2 * row : 2 * row + 2, 2 * col : 2 * col + 2] += st[1 + dr, 1 + dc]
    return A


def coarse_inverse_elastic(level, dtype=None) -> torch.Tensor:
    """inv(A_interior) of an ``ElasticLevel``, built in f64 on the host and
    placed on the level's device in ``dtype`` (default: the level's float
    dtype).  Warns above 4096 interior unknowns and when an f32 inverse
    meets a 1-norm condition estimate above 1e6."""
    m = level.n - 1
    if m > 45:  # 2 m^2 > 4096 unknowns
        warnings.warn(
            f"coarse_inverse_elastic on an n={level.n} level ({2 * m * m} interior "
            "dofs): intended for small truncation points", stacklevel=2)
    A = dense_interior_matrix_elastic(level)
    inv = np.linalg.inv(A)
    cond1 = np.abs(A).sum(0).max() * np.abs(inv).sum(0).max()
    if dtype is None:
        dtype = level.geo.dtype
    if dtype == torch.float32 and cond1 > 1e6:
        warnings.warn(
            f"coarse_inverse_elastic: cond_1(A) ~ {cond1:.2e}; f32 coarse solves "
            "may lose exactness", stacklevel=2)
    return torch.as_tensor(inv, dtype=dtype, device=level.device)


def coarse_solve_elastic(inv: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Exact interior elastic solve; ``f``: (..., 2, n+1, n+1) -> u of the
    same shape (node-major interleaved matvec)."""
    mm2 = inv.shape[0]
    m = int(round(np.sqrt(mm2 // 2)))
    if f.shape[-1] != m + 2:
        raise ValueError(
            f"coarse_inverse_elastic is for an n={m + 1} level but the RHS has "
            f"shape {tuple(f.shape)}")
    fi = torch.movedim(f[..., :, 1:-1, 1:-1], -3, -1).reshape(*f.shape[:-3], mm2)
    ui = fi @ inv.T
    u = torch.movedim(ui.reshape(*f.shape[:-3], m, m, 2), -1, -3)
    return F.pad(u, (1, 1, 1, 1))
