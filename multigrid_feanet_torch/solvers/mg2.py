"""Fully fused V-cycle solver on the CUDA kernels of ``ops/sweep.py``.

Port of ``multigrid_feanet_tpu/solvers/pallas_mg2.py``.  Levels with
``n >= kernel_threshold`` run the fused legs of :class:`SweepLevel`; the
levels below hand off to a plain PyTorch V-cycle (the counterpart of the JAX
package's XLA subtree) with an optional dense-inverse direct solve at the
coarsest level.  Per V(1,1) cycle:

- level 0: ``sweep_restrict`` (A2), the coarse correction, ``psweep`` (A1);
- levels 1..K-1: the zero-guess legs ``zsweep_restrict`` (A3) and
  ``zpsweep`` (A4): the pre-smoothed iterate u1 = (omega/d) f is recomputed
  inside both kernels and never stored;
- level K: the plain subtree.

The convergence test rides the pre-update residual norm that the first
level-0 kernel of every cycle emits for free.  The history stays on the
device in a preallocated tensor with -1 sentinels and is read back once per
``chunk`` cycles: one host sync per chunk.  The fused levels' buffers and
kernel scratch are allocated once, so on the card the cycles allocate
nothing above the plain subtree.
"""

from __future__ import annotations

from typing import Optional

import torch

from multigrid_feanet_torch.core.device import resolve_device
from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
from multigrid_feanet_torch.ops.sweep import SweepLevel
from multigrid_feanet_torch.ops.transfer import prolong_bilinear, restrict_full_weighting
from multigrid_feanet_torch.solvers import jacobi as jac
from multigrid_feanet_torch.solvers.coarse import coarse_inverse, coarse_solve
from multigrid_feanet_torch.solvers.common import solve_cycles
from multigrid_feanet_torch.solvers.jacobi import DEFAULT_OMEGA


class HierarchyV2:
    """Grid hierarchy whose levels with ``n >= kernel_threshold`` run the
    fused CUDA legs on compact fields (the plain PyTorch versions when the
    hierarchy lives on the CPU); smaller levels run the plain subtree.

    ``hier`` supplies a prebuilt hierarchy (for example from
    ``core.convert.hierarchy_from_arrays``) on ``device``; ``dform``
    overrides the difference-form default of the level-0 legs.
    ``device=None`` means CUDA and raises when there is none."""

    def __init__(self, problem: Problem, num_levels: Optional[int] = None,
                 omega: float = DEFAULT_OMEGA, kernel_threshold: int = 256,
                 direct_coarse: bool = True,
                 hier: Optional[GridHierarchy] = None,
                 dtype=torch.float32, dform: Optional[bool] = None,
                 device=None):
        if dtype != torch.float32:
            raise NotImplementedError(
                "bfloat16 storage of the level fields comes with a later "
                "slice of the port (ROADMAP queue 1, item 6)")
        device = resolve_device(device)
        # TF32 keeps ~3 decimal digits: the direct coarse solve's matmul
        # must run in full f32 to stay exact.
        torch.backends.cuda.matmul.allow_tf32 = False
        self.problem = problem
        self.device = device
        self.hier = hier if hier is not None else GridHierarchy.create(
            problem, num_levels, device=device)
        if self.hier.device != device:
            raise ValueError(f"hier lives on {self.hier.device}, not {device}")
        self.omega = float(omega)
        levels = self.hier.levels
        L = len(levels)
        # fused levels 0..K-1; level K is the first of the plain subtree
        K = 0
        while K < L - 1 and levels[K].n >= kernel_threshold:
            K += 1
        if K < 1:
            raise ValueError(
                "the finest level is below kernel_threshold: nothing to fuse")
        self.K = K
        self.sweep_levels = [
            SweepLevel(levels[l].n, phase=levels[l].phase,
                       coefficients=problem.coefficients, omega=omega,
                       dform=dform, device=device)
            for l in range(K)]
        self.coarse_inv = None
        if direct_coarse and L > 1:
            self.coarse_inv = (self.hier.coarse_inv if self.hier.coarse_inv is not None
                               else coarse_inverse(levels[-1]))
        # preallocated level buffers: the RHS of levels 1..K and the
        # iterate ping-pong pairs of levels 1..K-1, plus a scratch scalar
        # for the residual norms the cycle does not read
        self._fc = {l: self._field(l) for l in range(1, K + 1)}
        self._u = {l: (self._field(l), self._field(l)) for l in range(1, K)}
        self._rsq_scratch = torch.empty((), dtype=torch.float32, device=device)

    def _field(self, l: int) -> torch.Tensor:
        H = self.hier.levels[l].n_nodes
        return torch.empty((H, H), dtype=torch.float32, device=self.device)

    # ---- plain subtree (levels K..L-1) ----

    def _plain_vcycle(self, l: int, u, f, nu1: int, nu2: int):
        """V-cycle on the plain PyTorch ops; the counterpart of
        ``PallasHierarchyV2._xla_vcycle``."""
        levels = self.hier.levels
        L = len(levels)
        lv = levels[l]
        if l == L - 1 and l > 0 and self.coarse_inv is not None:
            return coarse_solve(self.coarse_inv, f).to(f.dtype)
        for _ in range(nu1):
            u = jac.jacobi_step(lv, u, f, 0.0, self.omega)
        if l < L - 1:
            r = (f - lv.apply(u)) * lv.geo
            f_c = 4.0 * restrict_full_weighting(r)
            u_c = self._plain_vcycle(l + 1, torch.zeros_like(f_c), f_c, nu1, nu2)
            u = u + prolong_bilinear(u_c, lv.geo)
        for _ in range(nu2):
            u = jac.jacobi_step(lv, u, f, 0.0, self.omega)
        return u

    # ---- fused V-cycle ----

    def _coarse_correction(self, l: int, fcb, nu1: int, nu2: int):
        """Solve the level-l error equation from a zero initial guess;
        ``fcb`` is the level-l RHS.  Returns the level-l correction."""
        if l >= self.K:
            return self._plain_vcycle(l, torch.zeros_like(fcb), fcb, nu1,
                                      nu2).contiguous()
        p = self.sweep_levels[l]
        cur, spare = self._u[l]
        rsq = self._rsq_scratch
        if nu1 == 1:
            # zero-initial-guess fast path: u1 = (omega/d) f is recomputed
            # pointwise inside both kernels and never stored
            fcc = p.zsweep_restrict(fcb, out=self._fc[l + 1])
            uc = self._coarse_correction(l + 1, fcc, nu1, nu2)
            p.zpsweep(fcb, uc, out=cur)
        else:
            cur.zero_()
            for _ in range(nu1 - 1):
                p.sweep(cur, fcb, out=spare, rsq=rsq)
                cur, spare = spare, cur
            p.sweep_restrict(cur, fcb, out=spare, fc_out=self._fc[l + 1], rsq=rsq)
            cur, spare = spare, cur
            uc = self._coarse_correction(l + 1, self._fc[l + 1], nu1, nu2)
            p.psweep(cur, fcb, uc, out=spare, rsq=rsq)
            cur, spare = spare, cur
        for _ in range(nu2 - 1):
            p.sweep(cur, fcb, out=spare, rsq=rsq)
            cur, spare = spare, cur
        return cur

    def _cycle0(self, u, sp, fb, nu1: int, nu2: int, rsq_pre):
        """One V(nu1, nu2) cycle at level 0 -> (u_new, spare_new).  Writes
        the squared interior residual norm of the INCOMING ``u`` (free from
        the first sweep) into ``rsq_pre``."""
        p = self.sweep_levels[0]
        cur, spare, rsq = u, sp, rsq_pre
        for _ in range(nu1 - 1):
            p.sweep(cur, fb, out=spare, rsq=rsq)
            rsq = self._rsq_scratch
            cur, spare = spare, cur
        # last pre-smooth fused with residual + restriction
        p.sweep_restrict(cur, fb, out=spare, fc_out=self._fc[1], rsq=rsq)
        cur, spare = spare, cur
        uc = self._coarse_correction(1, self._fc[1], nu1, nu2)
        p.psweep(cur, fb, uc, out=spare, rsq=self._rsq_scratch)
        cur, spare = spare, cur
        for _ in range(nu2 - 1):
            p.sweep(cur, fb, out=spare, rsq=self._rsq_scratch)
            cur, spare = spare, cur
        return cur, spare

    def solve(self, f, u0=None, bc_value=None, nu1: int = 1, nu2: int = 1,
              eps: float = 1e-6, max_cycles: int = 100, chunk: int = 1,
              use_pswrr: bool = False):
        """V-cycle solve to interior residual ``eps``.

        ``f`` is the mass-convolved RHS as an (n+1, n+1) field (tensor or
        array).  Returns ``(u, history)``: ``u`` an (n+1, n+1) tensor on the
        hierarchy's device, ``history`` a numpy array with ``history[j]`` =
        interior residual norm after cycle j+1 and ``len(history)`` = cycles
        to reach ``eps``.  As in the JAX solver, ``u`` includes one cycle
        beyond ``history`` (the one whose free pre-sweep residual detected
        convergence), plus up to ``chunk - 1`` more: the loop tests ``eps``
        once per ``chunk`` cycles, which is its one host sync per chunk."""
        if use_pswrr:
            raise NotImplementedError(
                "use_pswrr (the cross-cycle fused leg, TPU kernel A6) comes "
                "with a later slice of the port")
        return solve_cycles(
            lambda u, sp, fb, rsq: self._cycle0(u, sp, fb, nu1, nu2, rsq),
            self.hier.finest, f, u0, bc_value, eps, max_cycles, chunk)

    def solve_pcg(self, *args, **kwargs):
        raise NotImplementedError(
            "solve_pcg (the MG-preconditioned flexible CG) comes with a later "
            "slice of the port (ROADMAP queue 1, item 6)")
