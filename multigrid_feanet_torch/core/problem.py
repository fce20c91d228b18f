"""Problem specification and the multigrid level pyramid.

Port of ``multigrid_feanet_tpu/core/problem.py``.  A :class:`Problem`
describes the discretization (domain size, finest grid, two-phase
coefficients, inclusion geometry); a :class:`GridHierarchy` holds, per
level, the operator fields the solvers need.  Level fields are assembled
host-side in numpy exactly as the JAX package assembles them and are placed
once on one explicit device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from multigrid_feanet_torch.core import geometry
from multigrid_feanet_torch.core.device import resolve_device
from multigrid_feanet_torch.ops import stencil


@dataclasses.dataclass
class Level:
    """One multigrid level: sizes plus operator fields on one device."""

    n: int  # elements per edge
    h: float  # element size
    a0: Optional[float]  # two-phase coefficients (None for a general table)
    a1: Optional[float]
    table: torch.Tensor  # (16, 3, 3) stencil table, or (3, 3) if homogeneous
    pid: Optional[torch.Tensor]  # (n+1, n+1) int8 pattern ids; None if homogeneous
    geo: torch.Tensor  # (n+1, n+1) interior mask
    diag: torch.Tensor  # (n+1, n+1) diag(A)
    phase: Optional[torch.Tensor] = None  # (n, n) int8 element phases
    # phase-affine operator A = base (3, 3 stencil) + bit_scale * phase
    # bitplanes, for systems that are not pure stiffness (the theta-scheme
    # heat system M + theta dt K, ops/heat.py); a0 = a1 = None there
    base: Optional[torch.Tensor] = None
    bit_scale: Optional[float] = None

    @property
    def n_nodes(self) -> int:
        return self.n + 1

    @property
    def homogeneous(self) -> bool:
        return self.pid is None

    @property
    def device(self) -> torch.device:
        return self.geo.device

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """A @ u on this level (bitplane form when two-phase or
        phase-affine, the table gather otherwise)."""
        if self.pid is not None and self.base is not None:
            return stencil.apply_stencil_bitplane_affine(self.pid, u, self.base, self.bit_scale)
        if self.pid is not None and self.a0 is not None:
            return stencil.apply_stencil_bitplane(self.pid, u, self.a0, self.a1)
        return stencil.apply_stencil(self.table, self.pid, u)


@dataclasses.dataclass(frozen=True)
class Problem:
    """Discretization spec.  ``inclusion`` is None (homogeneous), a
    ('circle', (cx, cy), radius) / ('rect', (cx, cy), half_width) tuple, or a
    callable ``n -> (n, n) phase array``."""

    n: int  # finest-grid elements per edge (power of 2)
    size: float = 2.0
    coefficients: tuple = (1.0, 20.0)
    inclusion: object = None
    dtype: torch.dtype = torch.float32

    def phase(self, n: int) -> Optional[np.ndarray]:
        if self.inclusion is None:
            return None
        if callable(self.inclusion):
            return np.asarray(self.inclusion(n)).astype(np.int8)
        kind, center, radius = self.inclusion
        if kind == "circle":
            return geometry.circle_phase(self.size, n, center, radius)
        if kind == "rect":
            return geometry.rect_phase(self.size, n, center, radius)
        raise ValueError(f"unknown inclusion kind {kind!r}")


def build_level(problem: Problem, n: int, device=None) -> Level:
    """Assemble level ``n`` of ``problem`` in numpy and place it on
    ``device``; ``device=None`` means CUDA and raises when there is none."""
    device = resolve_device(device)
    h = problem.size / n
    phase = problem.phase(n)
    if phase is None:
        table_np = stencil.make_stencil_table_np((1.0, 1.0))[0]
        pid_np = None
        diag_np = np.full((n + 1, n + 1), table_np[1, 1])
    else:
        table_np = stencil.make_stencil_table_np(problem.coefficients)
        pid_np = stencil.pattern_ids_np(phase)
        diag_np = table_np[:, 1, 1][pid_np]
    a0 = a1 = None
    if phase is not None and len(problem.coefficients) == 2:
        a0, a1 = (float(c) for c in problem.coefficients)

    def dev(x, dtype):
        return None if x is None else torch.as_tensor(x, dtype=dtype, device=device)

    return Level(
        n=n, h=h, a0=a0, a1=a1,
        table=dev(table_np, problem.dtype),
        pid=dev(pid_np, torch.int8),
        geo=geometry.interior_mask(n + 1, dtype=problem.dtype, device=device),
        diag=dev(diag_np, problem.dtype),
        phase=dev(phase, torch.int8),
    )


@dataclasses.dataclass
class GridHierarchy:
    """Finest-to-coarsest tuple of Levels, all on one device.  ``coarse_inv``
    optionally carries a precomputed dense inverse of the coarsest interior
    operator (``solvers/coarse.py``) for the direct coarse solve."""

    levels: tuple = ()
    coarse_inv: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, problem: Problem, num_levels: Optional[int] = None,
               device=None) -> "GridHierarchy":
        """Levels n, n/2, ... (``log2(n)`` of them unless ``num_levels``).
        ``device=None`` means CUDA and raises when there is none."""
        device = resolve_device(device)
        n = problem.n
        L = int(np.log2(n)) if num_levels is None else num_levels
        return cls(levels=tuple(build_level(problem, n >> l, device)
                                for l in range(L)))

    @property
    def finest(self) -> Level:
        return self.levels[0]

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def device(self) -> torch.device:
        return self.finest.device
