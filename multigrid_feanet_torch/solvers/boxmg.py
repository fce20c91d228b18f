"""BoxMG V-cycle solver on the CUDA kernels of ``ops/general.py``.

Port of ``multigrid_feanet_tpu/solvers/pallas_boxmg.py``.  Level 0 keeps
the exact bi-material element-phase operator; every coarse level is a
Galerkin product P^T A P, a spatially varying 9-point stencil; all
transfers are the operator-induced W4 weights of ``ops/boxmg.py``.  Levels
with ``n >= kernel_threshold`` run the fused legs of
:class:`GeneralSweepLevel`; the levels below hand off to a plain PyTorch
V-cycle (the counterpart of the JAX package's XLA subtree) with an optional
dense-inverse direct solve at the coarsest level.  Per V(1,1) cycle:

- level 0: ``swrr`` (D2, bi-material), the coarse correction, ``psweep``
  (D3, bi-material);
- levels 1..K-1: the zero-guess legs ``zwrr`` (D4) and ``zpsweep`` (D5);
  with ``nu1 > 1`` the general legs instead: ``sweep`` (D1), ``swrr`` and
  ``psweep`` (D2, D3 on the planes); extra sweeps at level 0 run A1;
- level K: the plain subtree.

``coef_dtype=torch.bfloat16`` stores the kernel levels' S9 and W4 planes
in bfloat16: transfers and coarse operators are preconditioner-side, so the
rounding perturbs the cycle but not the fixed point (the convergence test
rides level 0's exact f32 residual).  The plain subtree and the coarse
inverse use the f32 setup, as in the JAX solver.  The solve loop, history
convention and one host sync per chunk are those of ``HierarchyV2``.
"""

from __future__ import annotations

from typing import Optional

import torch

from multigrid_feanet_torch.core.device import resolve_device
from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
from multigrid_feanet_torch.ops.adaptive_transfer import GeneralLevel, general_coarse_inverse
from multigrid_feanet_torch.ops.boxmg import apply_s9, boxmg_setup, prolong_w4, restrict_w4
from multigrid_feanet_torch.ops.general import GeneralSweepLevel
from multigrid_feanet_torch.solvers.coarse import coarse_solve
from multigrid_feanet_torch.solvers.common import (
    pcg_buffers, solve_cycles, solve_pcg, start_fields)
from multigrid_feanet_torch.solvers.jacobi import DEFAULT_OMEGA


class BoxMGHierarchy:
    """BoxMG hierarchy whose levels with ``n >= kernel_threshold`` run the
    fused CUDA legs on compact fields (their plain PyTorch versions when
    the hierarchy lives on the CPU); smaller levels run the plain subtree.

    ``hier`` supplies a prebuilt hierarchy on ``device``; ``setup`` a
    precomputed ``ops.boxmg.boxmg_setup`` list (for example from
    ``core.convert.boxmg_setup_from_arrays``), else it is computed on the
    device in f32.  Level 0's phase is the level's own (``Level.phase``).
    ``device=None`` means CUDA and raises when there is none."""

    def __init__(self, problem: Problem, num_levels: Optional[int] = None,
                 omega: float = DEFAULT_OMEGA, kernel_threshold: int = 256,
                 direct_coarse: bool = True, hier: Optional[GridHierarchy] = None,
                 setup=None, coef_dtype=torch.float32, device=None):
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
        levels = self.hier.levels
        L = self.hier.num_levels if num_levels is None else num_levels
        if L > self.hier.num_levels:
            raise ValueError(f"num_levels={L} exceeds the hierarchy's "
                             f"{self.hier.num_levels} levels")
        self.L = L
        self.omega = float(omega)
        self.setup = (setup if setup is not None
                      else boxmg_setup(self.hier, L, dtype=torch.float32))
        if len(self.setup) != L - 1:
            raise ValueError(f"setup has {len(self.setup)} level pairs, expected {L - 1}")
        # kernel levels 0..K-1; level K is the first of the plain subtree
        K = 0
        while K < L - 1 and levels[K].n >= kernel_threshold:
            K += 1
        if K < 1:
            raise ValueError("the finest level is below kernel_threshold: nothing to fuse")
        self.K = K
        lv0 = levels[0]
        cfg = dict(omega=omega, coef_dtype=coef_dtype, device=device)
        self.kernel_levels = [GeneralSweepLevel(
            lv0.n, phase=lv0.phase, coefficients=problem.coefficients,
            w4=self.setup[0][0], **cfg)]
        self.kernel_levels += [
            GeneralSweepLevel(levels[l].n, s9=self.setup[l - 1][1], w4=self.setup[l][0], **cfg)
            for l in range(1, K)]
        self._geo = [levels[l].geo for l in range(L)]
        self.coarse_inv = None
        if direct_coarse and L > 1:
            cl = GeneralLevel(self.setup[L - 2][1], self._geo[L - 1], dtype=torch.float64)
            if cl.n >= 2:
                self.coarse_inv = general_coarse_inverse(cl, torch.float32)
        # preallocated level buffers: the RHS of levels 1..K and the
        # iterate ping-pong pairs of levels 1..K-1, plus a scratch scalar
        # for the residual norms the cycle does not read
        self._fc = {l: self._field(l) for l in range(1, K + 1)}
        self._u = {l: (self._field(l), self._field(l)) for l in range(1, K)}
        self._rsq_scratch = torch.empty((), dtype=torch.float32, device=device)
        self._cg = None  # level 0's iterate pair and the CG vectors, at the first solve_pcg

    def _field(self, l: int) -> torch.Tensor:
        H = self.hier.levels[l].n_nodes
        return torch.empty((H, H), dtype=torch.float32, device=self.device)

    # ---- plain subtree (levels K..L-1) ----

    def _plain_relax(self, l: int, u, f, steps: int):
        S, geo = self.setup[l - 1][1], self._geo[l]
        d = S[..., 1, 1]  # the setup gave the Dirichlet ring a unit centre
        for _ in range(steps):
            r = (f - apply_s9(S, u)) * geo
            u = u + (self.omega / d) * r
        return u

    def _plain_vcycle(self, l: int, u, f, nu1: int, nu2: int):
        """V-cycle on the plain PyTorch ops; the counterpart of
        ``PallasBoxMG._xla_vcycle`` (called with l >= 1 only)."""
        L = self.L
        if l == L - 1 and l > 0 and self.coarse_inv is not None:
            return coarse_solve(self.coarse_inv, f).to(f.dtype)
        u = self._plain_relax(l, u, f, nu1)
        if l < L - 1:
            W4 = self.setup[l][0]
            r = (f - apply_s9(self.setup[l - 1][1], u)) * self._geo[l]
            f_c = restrict_w4(r, W4)
            u_c = self._plain_vcycle(l + 1, torch.zeros_like(f_c), f_c, nu1, nu2)
            u = u + prolong_w4(u_c, W4)
        return self._plain_relax(l, u, f, nu2)

    # ---- fused V-cycle ----

    def _coarse_correction(self, l: int, fcb, nu1: int, nu2: int):
        """Solve the level-l error equation from a zero initial guess;
        ``fcb`` is the level-l RHS.  Returns the level-l correction."""
        if l >= self.K:
            return self._plain_vcycle(l, torch.zeros_like(fcb), fcb, nu1, nu2).contiguous()
        p = self.kernel_levels[l]
        cur, spare = self._u[l]
        rsq, fcc = self._rsq_scratch, self._fc[l + 1]
        if nu1 == 1 and not p.bim:
            # zero-initial-guess fast path: u1 = (omega/d) f is recomputed
            # pointwise inside both kernels and never stored
            p.zwrr(fcb, out=fcc)
            uc = self._coarse_correction(l + 1, fcc, nu1, nu2)
            p.zpsweep(fcb, uc, out=cur)
        else:
            cur.zero_()
            for _ in range(nu1 - 1):
                p.sweep(cur, fcb, out=spare, rsq=rsq)
                cur, spare = spare, cur
            p.swrr(cur, fcb, out=spare, fc_out=fcc, rsq=rsq)
            cur, spare = spare, cur
            uc = self._coarse_correction(l + 1, fcc, nu1, nu2)
            p.psweep(cur, fcb, uc, out=spare)
            cur, spare = spare, cur
        for _ in range(nu2 - 1):
            p.sweep(cur, fcb, out=spare, rsq=rsq)
            cur, spare = spare, cur
        return cur

    def _cycle0(self, u, sp, fb, nu1: int, nu2: int, rsq_pre):
        """One V(nu1, nu2) cycle at level 0 -> (u_new, spare_new).  Writes
        the squared interior residual norm of the INCOMING ``u`` (free from
        the first sweep) into ``rsq_pre``."""
        p = self.kernel_levels[0]
        cur, spare, rsq = u, sp, rsq_pre
        for _ in range(nu1 - 1):
            p.sweep(cur, fb, out=spare, rsq=rsq)
            rsq = self._rsq_scratch
            cur, spare = spare, cur
        # last pre-smooth fused with residual + restriction
        p.swrr(cur, fb, out=spare, fc_out=self._fc[1], rsq=rsq)
        cur, spare = spare, cur
        uc = self._coarse_correction(1, self._fc[1], nu1, nu2)
        p.psweep(cur, fb, uc, out=spare)
        cur, spare = spare, cur
        for _ in range(nu2 - 1):
            p.sweep(cur, fb, out=spare, rsq=self._rsq_scratch)
            cur, spare = spare, cur
        return cur, spare

    def solve(self, f, u0=None, bc_value=None, nu1: int = 1, nu2: int = 1,
              eps: float = 1e-6, max_cycles: int = 100, chunk: int = 1):
        """V-cycle solve to interior residual ``eps``; the same arguments,
        returns and extra-cycle semantics as ``HierarchyV2.solve``."""
        return solve_cycles(
            lambda u, sp, fb, rsq: self._cycle0(u, sp, fb, nu1, nu2, rsq),
            self.hier.finest, f, u0, bc_value, eps, max_cycles, chunk)

    def solve_pcg(self, f, u0=None, bc_value=None, nu1: int = 1, nu2: int = 1,
                  eps: float = 1e-6, max_iters: int = 60):
        """Flexible CG with one BoxMG V(nu1, nu2) cycle from zero as the
        preconditioner (at level 0, bi-material: D2 and D3), ``A p`` through
        A1's residual mode with f = 0 and the true residual recomputed
        every iteration: ``solvers/common.py::solve_pcg``, shared with
        ``HierarchyV2.solve_pcg``.  Returns ``(u, history)`` with the
        post-iteration history (the returned u's residual is
        ``history[-1]``)."""
        if self._cg is None:
            self._u.setdefault(0, (self._field(0), self._field(0)))
            self._cg = pcg_buffers(self._field(0))
        f, u = start_fields(self.hier.finest, f, u0, bc_value)
        return solve_pcg(self.kernel_levels[0], lambda r: self._coarse_correction(0, r, nu1, nu2),
                         f, u, self._cg, eps, max_iters)
