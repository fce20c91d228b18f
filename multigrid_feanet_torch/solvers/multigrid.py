"""Geometric multigrid V-cycle with classical transfer operators, plain torch.

Port of ``multigrid_feanet_tpu/solvers/multigrid.py``, the plain twin of
``solvers/mg.py``.  The cycle is the reference's recursive V-cycle:

  relax nu1  ->  r = f - A v  ->  f_c = 4 * FW-restrict(r)  ->  recurse
  -> v += BC-reset(bilinear-prolong(v_c))  ->  relax nu2

with the coarsest level relax-only (nu1 then nu2 sweeps) unless a dense
inverse ``coarse_inv`` (``solvers/coarse.py``) solves it exactly.  ``solve``
runs cycles in chunks with the residual norms kept on the device and reads
them back once per chunk: one host sync per chunk.
"""

from __future__ import annotations

import numpy as np
import torch

from multigrid_feanet_torch.core.geometry import reset_boundary
from multigrid_feanet_torch.core.problem import GridHierarchy
from multigrid_feanet_torch.ops.transfer import prolong_bilinear, restrict_full_weighting
from multigrid_feanet_torch.solvers import coarse
from multigrid_feanet_torch.solvers.common import run_chunks
from multigrid_feanet_torch.solvers.jacobi import DEFAULT_OMEGA, interior_norm, relax


def v_cycle(hier: GridHierarchy, u, f, nu1: int = 1, nu2: int = 1, bc_value=0.0,
            omega: float = DEFAULT_OMEGA, level: int = 0, coarse_inv=None, ops=None):
    """One recursive V(nu1, nu2) cycle starting at ``level``; returns the
    updated u.  ``bc_value`` applies on the finest level only; the coarse
    error equations have zero Dirichlet data.  ``ops`` = ``(relax(l, u, f,
    nu), residual(l, u, f))`` replaces the plain Jacobi relax and residual
    (``solvers/mg.py::Hierarchy`` passes its kernel levels' ops); the
    boundary data are then the ops' own concern."""
    levels = hier.levels
    if coarse_inv is not None and level == len(levels) - 1 and level > 0:
        return coarse.coarse_solve(coarse_inv, f).to(u.dtype)
    if ops is None:
        ops = (lambda l, u, f, nu: relax(levels[l], u, f, nu, bc_value if l == 0 else 0.0, omega),
               lambda l, u, f: f - levels[l].apply(u))
    relax_at, residual_at = ops
    u = relax_at(level, u, f, nu1)
    if level < len(levels) - 1:
        # the h^2 scaling of the coarse right-hand side (factor 4)
        f_c = 4.0 * restrict_full_weighting(residual_at(level, u, f))
        u_c = v_cycle(hier, torch.zeros_like(f_c), f_c, nu1, nu2, 0.0, omega, level + 1,
                      coarse_inv, ops)
        u = u + prolong_bilinear(u_c, levels[level].geo)
    return relax_at(level, u, f, nu2)


def solve(hier: GridHierarchy, f, u0=None, nu1: int = 1, nu2: int = 1, bc_value=0.0,
          eps=1e-6, max_cycles: int = 400, chunk: int = 8,
          omega: float = DEFAULT_OMEGA, coarse_inv=None):
    """V-cycle to ``eps`` (absolute interior L2 residual; None = never) or
    ``max_cycles``.

    Returns ``(u, history)``; ``history[k]`` is the residual after cycle
    k+1, the reference's convention.  ``u`` carries the whole chunk in which
    ``eps`` was met, as in the JAX solver."""
    f = torch.as_tensor(f, device=hier.device)
    u = torch.zeros_like(f) if u0 is None else torch.as_tensor(u0, dtype=f.dtype,
                                                                device=hier.device)

    def run(u, k):
        norms = []
        for _ in range(k):
            u = v_cycle(hier, u, f, nu1, nu2, bc_value, omega, 0, coarse_inv)
            norms.append(interior_norm(f - hier.finest.apply(u)))
        return u, torch.stack(norms)

    return run_chunks(run, u, max_cycles, chunk, eps)


def fmg(hier: GridHierarchy, f, nu1: int = 1, nu2: int = 1, cycles_per_level: int = 1,
        bc_value=0.0, omega: float = DEFAULT_OMEGA, coarse_inv=None,
        coarse_sweeps: int = 64):
    """Full multigrid (F-cycle): nested iteration from the coarsest level up.

    The RHS is restricted down the pyramid (with the V-cycle's x4 scaling),
    the coarsest true equation is solved (exactly with ``coarse_inv``, else
    by ``coarse_sweeps`` Jacobi sweeps), and each prolonged iterate seeds
    ``cycles_per_level`` V(nu1, nu2) cycles on the next finer level.  A
    scalar ``bc_value`` is imposed at every level; an array-valued one on
    the finest level only."""
    levels = hier.levels
    L = len(levels)
    f = torch.as_tensor(f, device=hier.device)
    fs = [f]
    for _ in range(L - 1):
        fs.append(4.0 * restrict_full_weighting(fs[-1]))
    scalar_bc = np.ndim(bc_value) == 0

    def bc_at(l):
        return bc_value if l == 0 or scalar_bc else 0.0

    lvc = levels[-1]
    u = torch.zeros_like(fs[-1])
    if coarse_inv is not None and L > 1:
        # the partition solve: with u = u_i + u_bc (u_bc = the scalar bc on
        # the ring, zero inside), A u_i = f - A u_bc on the interior
        u_bc = (1.0 - lvc.geo) * float(bc_at(L - 1))
        u_i = coarse.coarse_solve(coarse_inv, fs[-1] - lvc.apply(u_bc))
        u = (u_i + u_bc).to(f.dtype)
    else:
        u = relax(lvc, u, fs[-1], coarse_sweeps, bc_at(L - 1), omega)
    for l in range(L - 2, -1, -1):
        u = prolong_bilinear(u, levels[l].geo)
        u = reset_boundary(u, levels[l].geo, bc_at(l))
        sub = GridHierarchy(levels=levels[l:])
        for _ in range(cycles_per_level):
            u = v_cycle(sub, u, fs[l], nu1, nu2, bc_at(l), omega, 0, coarse_inv)
    return u


def convergence_factor(res_history, m=None) -> float:
    """q = r[m] / r[m-1] (the last ratio by default), the reference's
    ``compute_q``."""
    r = np.asarray(res_history)
    if m is None:
        return float(r[-1] / r[-2])
    return float(r[m] / r[m - 1])
