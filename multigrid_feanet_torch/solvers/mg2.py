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

``dtype=torch.bfloat16`` stores the fused levels' fields in bfloat16, as
``PallasHierarchyV2(dtype=jnp.bfloat16)`` does: the legs compute in f32 and
round what they store, the plain subtree and the direct coarse solve run in
f32 (the handoff widens the level-K right-hand side and rounds the
correction back), and ``solve`` returns a bf16 ``u`` with an f32 history.

The convergence test rides the pre-update residual norm that the first
level-0 kernel of every cycle emits for free.  The history stays on the
device and is read back once per ``chunk`` cycles: one host sync per chunk.
The fused levels' buffers and kernel scratch are allocated once, so on the
card the cycles allocate nothing above the plain subtree.  On the card each
chunk of cycles (of A6 steps with ``use_pswrr``, each CG iteration) is one
replay of a CUDA graph captured once per schedule and chunk
(``solvers/common.py::ChunkGraphs``, kept in ``HierarchyV2.graphs``).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from multigrid_feanet_torch.core.device import resolve_device
from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
from multigrid_feanet_torch.ops.sweep import SweepLevel
from multigrid_feanet_torch.ops.transfer import prolong_bilinear, restrict_full_weighting
from multigrid_feanet_torch.solvers import jacobi as jac
from multigrid_feanet_torch.solvers.coarse import coarse_inverse, coarse_solve
from multigrid_feanet_torch.solvers.common import (
    ChunkGraphs, chunk_graphs, pcg_buffers, solve_cycles, solve_pcg, start_fields,
    trim_history)
from multigrid_feanet_torch.solvers.jacobi import DEFAULT_OMEGA


class HierarchyV2:
    """Grid hierarchy whose levels with ``n >= kernel_threshold`` run the
    fused CUDA legs on compact fields (the plain PyTorch versions when the
    hierarchy lives on the CPU); smaller levels run the plain subtree.

    ``hier`` supplies a prebuilt hierarchy (for example from
    ``core.convert.hierarchy_from_arrays``) on ``device``; ``dform``
    overrides the fused legs' difference-form default.  ``coefficients`` and
    ``mass_fn`` generalize the solver to any operator c K + M (stiffness
    scaled by a constant plus a pattern-independent per-element operator):
    the fused legs take the scaled pair ``(c a0, c a1)`` and the triple
    ``mass_fn(level) -> (mp, ms, mo) | None`` of each level (h differs per
    level), while ``hier`` (the system hierarchy, whose levels apply the
    same operator) drives the plain subtree and the direct coarse solve;
    ``ops/heat.py::heat_hierarchy`` builds the heat theta-system so.
    ``dtype`` is the fused levels' storage type, float32 or bfloat16 (the
    JAX solver recommends bf16 for the f = 0 decay protocol and as the
    correction solver of ``solvers/mg.py::solve_ir``; ``solve_pcg`` refuses
    it).  ``device=None`` means CUDA and raises when there is none."""

    def __init__(self, problem: Problem, num_levels: Optional[int] = None,
                 omega: float = DEFAULT_OMEGA, kernel_threshold: int = 256,
                 direct_coarse: bool = True,
                 hier: Optional[GridHierarchy] = None, coefficients=None,
                 mass_fn=None, dtype=torch.float32, dform: Optional[bool] = None,
                 device=None):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"the fused levels store float32 or bfloat16, not {dtype}")
        self.dtype = dtype
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
        coeffs = tuple(coefficients) if coefficients is not None else problem.coefficients
        self.sweep_levels = [
            SweepLevel(levels[l].n, phase=levels[l].phase, coefficients=coeffs, omega=omega,
                       dform=dform, mass=None if mass_fn is None else mass_fn(levels[l]),
                       dtype=dtype, device=device)
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
        self._cg = None  # level 0's iterate pair and the CG vectors, at the first solve_pcg
        self.graphs = ChunkGraphs(device)

    def _field(self, l: int) -> torch.Tensor:
        H = self.hier.levels[l].n_nodes
        return torch.empty((H, H), dtype=self.dtype, device=self.device)

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
        ``fcb`` is the level-l RHS.  Returns the level-l correction.  The
        plain subtree runs in f32 and its correction is rounded to the
        storage type, as ``pallas_mg2.py``'s handoff does."""
        if l >= self.K:
            f32 = fcb.float()
            return self._plain_vcycle(l, torch.zeros_like(f32), f32, nu1,
                                      nu2).to(self.dtype).contiguous()
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
              use_pswrr: bool = False, graph: bool = True):
        """V-cycle solve to interior residual ``eps``.

        ``f`` is the mass-convolved RHS as an (n+1, n+1) field (tensor or
        array).  Returns ``(u, history)``: ``u`` an (n+1, n+1) tensor on the
        hierarchy's device, ``history`` a numpy array with ``history[j]`` =
        interior residual norm after cycle j+1 and ``len(history)`` = cycles
        to reach ``eps``.  As in the JAX solver, ``u`` includes one cycle
        beyond ``history`` (the one whose free pre-sweep residual detected
        convergence), plus up to ``chunk - 1`` more: the loop tests ``eps``
        once per ``chunk`` cycles, which is its one host sync per chunk.

        ``use_pswrr`` (V(1,1) only; other schedules ignore it, as in the JAX
        solver) runs level 0 on the cross-cycle fused leg A6, which ends one
        cycle and starts the next in one pass, after a peeled first descent
        (A2) and before a closing ascent (A1); ``chunk`` is rounded up to
        even.  The history and the extra-cycle convention are the same.

        With bf16 storage ``f`` and ``u0`` are rounded to bf16 (as the JAX
        solver pads them) and ``u`` comes back in bf16.

        On the card each chunk is one replay of a CUDA graph (with
        ``use_pswrr``, the chunk of A6 steps between the peeled descent and
        the closing ascent), bit for bit the eager loop, which ``graph=False``
        runs instead."""
        graphs = chunk_graphs(self, graph)
        if use_pswrr and nu1 == 1 and nu2 == 1:
            return self._solve_pswrr(f, u0, bc_value, eps, max_cycles, chunk + (chunk & 1),
                                     graphs)
        return solve_cycles(
            lambda u, sp, fb, rsq: self._cycle0(u, sp, fb, nu1, nu2, rsq),
            self.hier.finest, f, u0, bc_value, eps, max_cycles, chunk, self.dtype,
            graphs=graphs, key=("solve", nu1, nu2))

    def _solve_pswrr(self, f, u0, bc_value, eps, max_cycles, chunk, graphs=None):
        """The V(1,1) solve on A6; port of ``pallas_mg2.py:270-312``.  With
        ``graphs`` each chunk of A6 steps (``chunk`` is even, so the iterate
        pair ends each chunk where it began) is one graph replay on static
        copies of f, the pair and the coarse correction."""
        p = self.sweep_levels[0]
        fb, u = start_fields(self.hier.finest, f, u0, bc_value, self.dtype)
        rsq, fc1 = torch.empty_like(self._rsq_scratch), self._fc[1]
        if graphs is None:
            pair, norms = (torch.empty_like(u), u), None
        else:
            key = ("pswrr", chunk, self.dtype)
            st = graphs.statics(key, lambda: SimpleNamespace(
                f=torch.empty_like(fb), pair=(torch.empty_like(u), torch.empty_like(u)),
                # the coarse correction: level 1's own buffer when it is a
                # fused level (the same one every cycle), else a copy
                uc=self._u[1][0] if self.K > 1 else torch.empty_like(self._fc[1]),
                rsq=torch.empty_like(rsq),
                norms=torch.empty(chunk, dtype=torch.float32, device=self.device)))
            st.f.copy_(fb)
            fb, pair, ucs, rsq, norms = st.f, st.pair, st.uc, st.rsq, st.norms
        hist = torch.full((max_cycles + chunk,), -1.0, dtype=torch.float32, device=self.device)
        # the peeled first descent: hist[0] is the residual of u0
        u1, free = pair
        p.sweep_restrict(u, fb, out=u1, fc_out=fc1, rsq=rsq)
        torch.sqrt(rsq, out=hist[0])
        uc = self._coarse_correction(1, fc1, 1, 1)

        def steps(u1, free, uc, out):
            for i in range(chunk):
                # ends cycle k (rsq: its residual) and starts cycle k + 1
                p.pswrr(u1, fb, uc, out=free, fc_out=fc1, rsq=rsq)
                u1, free = free, u1
                uc = self._coarse_correction(1, fc1, 1, 1)
                torch.sqrt(rsq, out=out[i])
            return u1, free, uc

        def body():
            _, _, last = steps(*pair, ucs, norms)
            if last is not ucs:
                ucs.copy_(last)

        if graphs is not None:  # the graph reads the coarse correction from ucs
            if uc is not ucs:
                ucs.copy_(uc)
            uc = ucs
        eps32 = float(np.float32(eps))
        k, res = 1, float("inf")
        while res > eps32 and k < max_cycles - 1:
            if graphs is None:
                u1, free, uc = steps(u1, free, uc, hist[k : k + chunk])
            else:
                graphs.run(key, body)
                hist[k : k + chunk].copy_(norms)
            k += chunk
            res = float(hist[k - 1])  # the one host sync per chunk
        out = free if graphs is None else torch.empty_like(free)  # never a static buffer
        p.psweep(u1, fb, uc, out=out, rsq=self._rsq_scratch)
        return out, trim_history(hist.cpu().numpy(), eps)

    # ---- Krylov acceleration ----

    def solve_pcg(self, f, u0=None, bc_value=None, nu1: int = 1, nu2: int = 1,
                  eps: float = 1e-6, max_iters: int = 60, graph: bool = True):
        """Flexible CG with one fused V(nu1, nu2) cycle from zero as the
        preconditioner (at level 0 with nu1 = 1: A3 and A4), ``A p`` through
        A1's residual mode with f = 0, the true residual recomputed every
        iteration: ``solvers/common.py::solve_pcg``, the loop the elastic
        and BoxMG solvers share.

        Returns ``(u, history)``: ``history[j]`` is the interior residual
        norm after iteration j+1 (post-iteration, no lag: the returned u's
        residual is ``history[-1]``).  On the card each iteration after the
        start is one graph replay (``graph=False``: the eager loop).

        Refused with bf16 storage (NotImplementedError).  The JAX solver
        runs it, iterate, vectors and dot products in bf16, and on a
        nonzero right-hand side it stalls at the bf16 floor: on a random f
        at n = 64 (homogeneous) its residual still stands at 1.25 after 20
        iterations, where f32 reaches 1e-3 in 5 (tests/test_torch_bf16.py).
        Nonzero f in bf16 goes through ``solvers/mg.py::solve_ir``."""
        if self.dtype != torch.float32:
            raise NotImplementedError(
                "solve_pcg with bfloat16 level storage: on a nonzero right-hand side the "
                "bf16 Krylov iteration stalls at the bf16 floor (the JAX solver's bf16 PCG "
                "does); use solve_ir with the bf16 hierarchy, or float32 storage")
        if self._cg is None:
            self._u.setdefault(0, (self._field(0), self._field(0)))
            self._cg = pcg_buffers(self._field(0))
        f, u = start_fields(self.hier.finest, f, u0, bc_value)
        return solve_pcg(self.sweep_levels[0], lambda r: self._coarse_correction(0, r, nu1, nu2),
                         f, u, self._cg, eps, max_iters, chunk_graphs(self, graph),
                         ("pcg", nu1, nu2))
