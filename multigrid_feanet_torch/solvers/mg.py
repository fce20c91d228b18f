"""Round-1 multigrid and Jacobi solves on the kernels of ``ops/stencil_sweep.py``,
and mixed-precision iterative refinement.

Port of ``multigrid_feanet_tpu/solvers/pallas_mg.py``.  :class:`Hierarchy`
runs the V-cycle of ``solvers/multigrid.py`` with the levels at or above
``kernel_threshold`` on C1 (one sweep, the masked residual) and C2 (nu > 1
sweeps in one pass); the levels below, the transfers and the direct coarse
solve are plain torch ops.  Unlike ``HierarchyV2`` it computes an explicit
post-cycle residual, so ``history[-1]`` is the residual of the returned
``u``; the loop reads it back once per cycle.

:func:`solve_ir` keeps an f64 iterate and residual and solves each
correction with a few f32 V-cycles of a :class:`Hierarchy` or a
``HierarchyV2``: f32 cycles alone stall at the rounding floor of a nonzero
right-hand side.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multigrid_feanet_torch.core.device import resolve_device
from multigrid_feanet_torch.core.geometry import reset_boundary
from multigrid_feanet_torch.core.problem import GridHierarchy, Problem, build_level
from multigrid_feanet_torch.ops.stencil_sweep import StencilLevel
from multigrid_feanet_torch.solvers import jacobi as jac
from multigrid_feanet_torch.solvers import multigrid as mg
from multigrid_feanet_torch.solvers.coarse import coarse_inverse
from multigrid_feanet_torch.solvers.common import start_fields
from multigrid_feanet_torch.solvers.jacobi import DEFAULT_OMEGA


class Hierarchy:
    """A ``GridHierarchy`` whose levels with ``n >= kernel_threshold`` run C1
    and C2 (their plain versions when the hierarchy lives on the CPU).

    ``direct_coarse`` replaces the coarsest level's relax-only treatment by
    the dense-inverse solve (the hierarchy's own ``coarse_inv`` when it
    carries one).  ``device=None`` means CUDA and raises when there is none;
    ``hier`` must live on that device."""

    def __init__(self, hier: GridHierarchy, omega: float = DEFAULT_OMEGA,
                 kernel_threshold: int = 256, direct_coarse: bool = False, device=None):
        device = resolve_device(device)
        if hier.device != device:
            raise ValueError(f"hier lives on {hier.device}, not {device}")
        # TF32 keeps ~3 decimal digits: the direct coarse solve's matmul
        # must run in full f32 to stay exact.
        torch.backends.cuda.matmul.allow_tf32 = False
        self.hier = hier
        self.device = device
        self.omega = float(omega)
        self.coarse_inv = None
        if direct_coarse and hier.num_levels > 1:
            self.coarse_inv = (hier.coarse_inv if hier.coarse_inv is not None
                               else coarse_inverse(hier.levels[-1]))
        self.ps = [
            (StencilLevel(lv.n, pid=lv.pid, omega=omega, device=device,
                          **({} if lv.pid is None else dict(coefficients=(lv.a0, lv.a1))))
             if lv.n >= kernel_threshold else None)
            for lv in hier.levels]

    # ---- level-local ops ----

    def _relax(self, l: int, u, f, nu: int):
        """``nu`` sweeps: C2 for nu > 1 and C1 for one on a kernel level,
        the plain Jacobi step below."""
        ps = self.ps[l]
        if nu == 0:
            return u
        if ps is not None:
            return ps.sweep_k(u, f, nu)[0] if nu > 1 else ps.sweep(u, f)[0]
        for _ in range(nu):
            u = jac.jacobi_step(self.hier.levels[l], u, f, 0.0, self.omega)
        return u

    def _residual(self, l: int, u, f):
        ps = self.ps[l]
        return ps.residual(u, f)[0] if ps is not None else f - self.hier.levels[l].apply(u)

    def _res_norm(self, u, f):
        """Interior residual norm of ``u`` on the finest level (a 0-d tensor)."""
        ps = self.ps[0]
        if ps is not None:
            return torch.sqrt(ps.residual(u, f)[1])
        return jac.interior_norm(f - self.hier.finest.apply(u))

    def v_cycle(self, u, f, nu1: int, nu2: int, level: int = 0):
        """One recursive V(nu1, nu2) cycle from ``level``: ``solvers/multigrid.py``'s
        cycle on this hierarchy's relax and residual."""
        return mg.v_cycle(self.hier, u, f, nu1, nu2, level=level, coarse_inv=self.coarse_inv,
                          ops=(self._relax, self._residual))

    # ---- solve entry points ----

    def solve(self, f, u0=None, bc_value=None, nu1: int = 1, nu2: int = 1,
              eps: float = 1e-6, max_cycles: int = 100):
        """V-cycle solve to interior residual ``eps``.

        ``f`` is the mass-convolved RHS as an (n+1, n+1) field (tensor or
        array).  Returns ``(u, history)``: ``history[k]`` is the residual
        norm after cycle k+1, computed explicitly after the cycle, and
        ``len(history)`` the cycles run, so ``history[-1]`` is the residual
        of the returned ``u``."""
        f, u = start_fields(self.hier.finest, f, u0, bc_value)
        eps32 = float(np.float32(eps))  # the f32 comparison of the JAX loop
        hist, res = [], float("inf")
        while res > eps32 and len(hist) < max_cycles:
            u = self.v_cycle(u, f, nu1, nu2)
            res = float(self._res_norm(u, f))  # the one host sync per cycle
            hist.append(res)
        return u, np.asarray(hist, dtype=np.float32)

    def solve_jacobi(self, f, u0=None, bc_value=None, eps: float = 1e-5,
                     max_iters: int = 100_000, fuse: int = 1):
        """Weighted-Jacobi solve on the finest level.

        The convergence test uses the sweep's free pre-update residual (the
        post-update residual of the previous sweep), so each iteration is
        one kernel pass and one host sync; ``fuse`` > 1 runs that many sweeps
        per C2 pass and tests every ``fuse`` sweeps (iteration counts are
        then multiples of ``fuse``).  Returns ``(u, iters, res_final)``, the
        final residual recomputed for the returned ``u``."""
        f, u = start_fields(self.hier.finest, f, u0, bc_value)
        ps, lv0 = self.ps[0], self.hier.finest
        eps32 = float(np.float32(eps))
        k, res = 0, float("inf")
        while res > eps32 and k < max_iters:
            if ps is not None:
                u, rsq = ps.sweep_k(u, f, fuse) if fuse > 1 else ps.sweep(u, f)
                res = float(torch.sqrt(rsq))
            else:
                for _ in range(fuse):
                    u = jac.jacobi_step(lv0, u, f, 0.0, self.omega)
                res = float(jac.interior_norm(f - lv0.apply(u)))
            k += fuse
        return u, k, float(self._res_norm(u, f))


def _f64_twin(h):
    """The f64 twin of ``h``'s finest level, built once per hierarchy and
    kept on it: the homogeneous level assembled anew in f64, the two-phase
    level's fields cast to f64."""
    twin = getattr(h, "_ir_lv64", None)
    if twin is None:
        lv = h.hier.finest
        if lv.pid is None:
            problem64 = Problem(n=lv.n, size=lv.h * lv.n, dtype=torch.float64)
            twin = build_level(problem64, lv.n, device=lv.device)
        else:
            twin = dataclasses.replace(lv, table=lv.table.double(), diag=lv.diag.double(),
                                       geo=lv.geo.double())
        h._ir_lv64 = twin
    return twin


def solve_ir(h, f, u0=None, bc_value=None, nu1: int = 1, nu2: int = 1, eps: float = 1e-6,
             cycles_per_correction: int = 4, max_outer: int = 20):
    """Mixed-precision iterative refinement to absolute residual ``eps``.

    ``h`` is a :class:`Hierarchy` or a ``solvers.mg2.HierarchyV2``.  The
    iterate u and the residual r = f - A u are kept in f64 (one fused f64
    step per outer iteration, eager torch ops, and one host sync for its
    norm); each correction equation A e = r is solved from zero with
    ``cycles_per_correction`` f32 V(nu1, nu2) cycles and accumulated as
    u += e.  Returns ``(u, history)``: the f64 ``u`` and the f64 interior
    residual norms, one per outer iteration.

    At ``max_outer`` the JAX solver computes one more correction and
    throws it away; this one returns the same ``u`` and history without
    that solve."""
    lv64 = _f64_twin(h)
    geo64 = lv64.geo
    f64 = torch.as_tensor(f, dtype=torch.float64, device=lv64.device)
    u = torch.zeros_like(f64) if u0 is None else torch.as_tensor(
        u0, dtype=torch.float64, device=lv64.device)
    if bc_value is not None:
        u = reset_boundary(u, geo64, bc_value)
    e32 = torch.zeros(f64.shape, dtype=torch.float32, device=lv64.device)
    history = []
    for outer in range(max_outer):
        u = u + e32.double() * geo64
        r = f64 - lv64.apply(u)
        history.append(float(jac.interior_norm(r)))  # the one host sync per outer
        if history[-1] <= eps or outer == max_outer - 1:
            break
        # the correction, with zero Dirichlet data
        e32, _ = h.solve(r.float(), nu1=nu1, nu2=nu2, eps=0.0,
                         max_cycles=cycles_per_correction)
    return u, np.asarray(history)
