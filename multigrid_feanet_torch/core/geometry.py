"""Domain geometry: interior masks, Dirichlet boundary values, phase maps.

Port of ``multigrid_feanet_tpu/core/geometry.py``.  Masks and phase maps are
built host-side in numpy, exactly as in the JAX package; ``interior_mask``
ships its result to the requested device once.
"""

from __future__ import annotations

import numpy as np
import torch


def interior_mask(n_nodes: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """(H, W) mask: 1 at interior nodes, 0 on the square boundary."""
    m = np.zeros((n_nodes, n_nodes), dtype=np.float64)
    m[1:-1, 1:-1] = 1.0
    return torch.as_tensor(m, dtype=dtype, device=device)


def reset_boundary(u: torch.Tensor, geo: torch.Tensor, bc_value=0.0) -> torch.Tensor:
    """Re-impose Dirichlet values: ``u * geo + bc_value * (1 - geo)``."""
    return u * geo + bc_value * (1.0 - geo)


def node_coords(size: float, n_elems: int) -> tuple[np.ndarray, np.ndarray]:
    """Node coordinate grids (y[i], x[j]) on [-size/2, size/2], both ascending."""
    c = np.linspace(-size / 2.0, size / 2.0, n_elems + 1)
    return np.meshgrid(c, c, indexing="ij")


def element_centroids(size: float, n_elems: int) -> tuple[np.ndarray, np.ndarray]:
    """Element centroid coordinate grids (y[r], x[c]), ascending."""
    h = size / n_elems
    c = np.linspace(-size / 2.0 + h / 2.0, size / 2.0 - h / 2.0, n_elems)
    return np.meshgrid(c, c, indexing="ij")


def circle_phase(size: float, n_elems: int, center=(0.0, 0.0), radius: float = 0.5) -> np.ndarray:
    """(n, n) int8 element phase map: 1 inside the circular inclusion
    (strict r^2 < radius^2)."""
    yy, xx = element_centroids(size, n_elems)
    r2 = (xx - center[0]) ** 2 + (yy - center[1]) ** 2
    return (r2 < radius**2).astype(np.int8)


def rect_phase(size: float, n_elems: int, center=(0.0, 0.0), r: float = 0.5) -> np.ndarray:
    """(n, n) int8 element phase map: 1 inside the axis-aligned square."""
    yy, xx = element_centroids(size, n_elems)
    return ((np.abs(xx - center[0]) < r) & (np.abs(yy - center[1]) < r)).astype(np.int8)
