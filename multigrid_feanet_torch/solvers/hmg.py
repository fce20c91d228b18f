"""Multigrid with the learned H-Net smoother (H-MG).

Port of ``multigrid_feanet_tpu/solvers/hmg.py``.  Two solvers:

- :func:`solve`, the reference notebook's whole solve in plain PyTorch:
  V-cycles whose relaxation is one H-corrected Jacobi sweep (``"hjac"``) or
  one plain Jacobi sweep (``"jac"``) per level, with the notebook's
  UNMASKED residual transfer and a post-cycle residual history.
- :class:`HMGHierarchy`, the fused solve on the CUDA kernels of
  ``ops/hrelax.py``.  Levels with ``n >= kernel_threshold`` run fused legs;
  the levels below hand off to a plain PyTorch cycle (the counterpart of
  the JAX package's XLA subtree) with interior-masked residuals and an
  optional dense-inverse direct solve at the coarsest level.  Per V(1,1)
  cycle:

  - level 0: ``hswrr`` (E2: u1 = hrelax(u), the restricted residual and the
    residual norm of the incoming u), the coarse correction, ``phrelax``
    (E3: u3 = hrelax(u1 + P(uc)));
  - levels 1..K-1 below ``h_levels``: the zero-guess legs ``zhswrr`` (E4)
    and ``zphrelax`` (E5), whose pre-smoothed iterate hrelax(0) is
    recomputed inside both kernels and never stored; or, with
    ``coarse_zero_legs=False``, E2 from a zero iterate and E3;
  - levels 1..K-1 at or above ``h_levels``: the plain-Jacobi zero-guess
    legs ``zsweep_restrict`` (A3) and ``zpsweep`` (A4) of ``ops/sweep.py``;
  - level K: the plain subtree.

  The solve loop, history convention (free pre-update residual, one extra
  cycle in the returned u), one host sync per chunk and, on the card, one
  CUDA graph replay per chunk are those of ``solvers/common.py``.  Level
  buffers are allocated once, so on the card the cycles allocate nothing
  above the plain subtree.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from multigrid_feanet_torch.core.device import resolve_device
from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
from multigrid_feanet_torch.models import hnet
from multigrid_feanet_torch.ops import hrelax as hx
from multigrid_feanet_torch.ops.sweep import SweepLevel
from multigrid_feanet_torch.ops.transfer import prolong_bilinear, restrict_full_weighting
from multigrid_feanet_torch.solvers import jacobi
from multigrid_feanet_torch.solvers.coarse import coarse_inverse, coarse_solve
from multigrid_feanet_torch.solvers.common import ChunkGraphs, chunk_graphs, solve_cycles
from multigrid_feanet_torch.solvers.jacobi import DEFAULT_OMEGA

MODES = ("hjac", "jac")


def _cycle(hier, params, u, f, bc_value, mode, nu1, nu2, level=0):
    lv = hier.levels[level]
    bc = bc_value if level == 0 else 0.0

    def relax(u, k):
        if mode == "hjac":
            return hnet.h_relax(lv, params, u, f, k, bc)
        for _ in range(k):
            u = jacobi.jacobi_step(lv, u, f, bc)
        return u

    u = relax(u, nu1)
    if level < hier.num_levels - 1:
        # the notebook's unmasked residual
        r = f - lv.apply(u)
        f_c = 4.0 * restrict_full_weighting(r)
        u_c = _cycle(hier, params, torch.zeros_like(f_c), f_c, 0.0, mode, nu1, nu2, level + 1)
        u = u + prolong_bilinear(u_c, lv.geo)
    return relax(u, nu2)


def solve(hier: GridHierarchy, params, f, u0=None, bc_value=0.0, nu1: int = 1,
          nu2: int = 1, eps: float = 5e-5, max_cycles: int = 100, mode: str = "hjac"):
    """H-MG (``mode="hjac"``) or plain MG (``"jac"``) solve on the plain ops.

    Returns ``(u, history)``: ``history[j]`` is the interior residual norm
    after cycle j+1, ``len(history)`` the cycles to reach ``eps``, and ``u``
    has exactly ``len(history)`` cycles (post-cycle residuals, no lag)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    lv0 = hier.finest
    dev = lv0.device
    f = torch.as_tensor(f, dtype=torch.float32, device=dev)
    params = torch.as_tensor(params, dtype=torch.float32, device=dev)
    u = torch.zeros_like(f) if u0 is None else torch.as_tensor(u0, dtype=torch.float32,
                                                                device=dev)
    eps32 = float(np.float32(eps))  # the f32 comparison of the JAX loop
    hist = []
    res = float("inf")
    while res > eps32 and len(hist) < max_cycles:
        u = _cycle(hier, params, u, f, bc_value, mode, nu1, nu2)
        res = float(jacobi.interior_norm(f - lv0.apply(u)))
        hist.append(res)
    return u, np.asarray(hist, dtype=np.float32)


class HMGHierarchy:
    """H-MG hierarchy whose levels with ``n >= kernel_threshold`` run the
    fused CUDA legs on compact fields (their plain PyTorch versions when the
    hierarchy lives on the CPU); smaller levels run the plain subtree, whose
    coarsest level is relax-only unless ``direct_coarse``.

    ``h_levels``: apply the H-relax smoother on levels < h_levels and plain
    weighted Jacobi below (None = every level).  ``coarse_zero_legs=False``
    runs the H levels below level 0 through E2 from a zero iterate and E3
    instead of the zero-guess E4/E5.  ``dform`` selects the difference-form
    applies of the H legs (off by default, as in the JAX solver; the 4097^2
    bi-material interface needs it).  ``hier`` supplies a prebuilt hierarchy
    on ``device``; each level's phase is the level's own (``Level.phase``).
    ``device=None`` means CUDA and raises when there is none."""

    def __init__(self, problem: Problem, num_levels: Optional[int] = None,
                 omega: float = DEFAULT_OMEGA, kernel_threshold: int = 256,
                 direct_coarse: bool = False, h_levels: Optional[int] = None,
                 coarse_zero_legs: bool = True, dform: bool = False,
                 hier: Optional[GridHierarchy] = None, device=None):
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
        L = len(levels)
        self.h_levels = L if h_levels is None else int(h_levels)
        self.coarse_zero_legs = bool(coarse_zero_legs)
        self.dform = bool(dform)
        self.omega = float(omega)
        # fused levels 0..K-1; level K is the first of the plain subtree
        K = 0
        while K < L - 1 and levels[K].n >= kernel_threshold:
            K += 1
        if K < 1:
            raise ValueError("the finest level is below kernel_threshold: nothing to fuse")
        self.K = K
        self.sweep_levels = [
            SweepLevel(levels[l].n, phase=levels[l].phase, coefficients=problem.coefficients,
                       omega=omega, device=device)
            for l in range(K)]
        self.coarse_inv = None
        if direct_coarse and L > 1:
            self.coarse_inv = (self.hier.coarse_inv if self.hier.coarse_inv is not None
                               else coarse_inverse(levels[-1]))
        # preallocated level buffers: the RHS of levels 1..K, the iterate
        # pairs of levels 1..K-1, the zero iterate E2 starts from on coarse
        # levels (never written), and a scratch scalar for the residual
        # norms the cycle does not read
        self._fc = {l: self._field(l) for l in range(1, K + 1)}
        self._u = {l: (self._field(l), self._field(l)) for l in range(1, K)}
        self._zero = {} if coarse_zero_legs else {
            l: self._field(l).zero_() for l in range(1, min(K, self.h_levels))}
        self._rsq_scratch = torch.empty((), dtype=torch.float32, device=device)
        self.graphs = ChunkGraphs(device)

    def _field(self, l: int) -> torch.Tensor:
        H = self.hier.levels[l].n_nodes
        return torch.empty((H, H), dtype=torch.float32, device=self.device)

    def _params(self, params) -> torch.Tensor:
        """The (L, 3, 3) kernels as a contiguous float32 tensor on the
        device, converted once per solve (no copy when they already are)."""
        p = torch.as_tensor(params, dtype=torch.float32, device=self.device).contiguous()
        hx._depth(p, odd=True)
        return p

    # ---- plain subtree (levels K..L-1) ----

    def _plain_hcycle(self, l: int, u, f, params):
        """V-cycle on the plain PyTorch ops with interior-masked residuals;
        the counterpart of ``PallasHMG._xla_hcycle``."""
        levels = self.hier.levels
        L = len(levels)
        lv = levels[l]
        if l == L - 1 and l > 0 and self.coarse_inv is not None:
            return coarse_solve(self.coarse_inv, f).to(f.dtype)

        def rel(u):
            if l < self.h_levels:
                return hnet.h_relax(lv, params, u, f, 1, 0.0, self.omega)
            return jacobi.jacobi_step(lv, u, f, 0.0, self.omega)

        u = rel(u)
        if l < L - 1:
            r = (f - lv.apply(u)) * lv.geo
            f_c = 4.0 * restrict_full_weighting(r)
            u_c = self._plain_hcycle(l + 1, torch.zeros_like(f_c), f_c, params)
            u = u + prolong_bilinear(u_c, lv.geo)
        return rel(u)

    # ---- fused V-cycle ----

    def _coarse_correction(self, l: int, fcb, params):
        """Solve the level-l error equation from a zero initial guess;
        ``fcb`` is the level-l RHS.  Returns the level-l correction."""
        if l >= self.K:
            return self._plain_hcycle(l, torch.zeros_like(fcb), fcb, params).contiguous()
        p = self.sweep_levels[l]
        cur, spare = self._u[l]
        fcc = self._fc[l + 1]
        if l >= self.h_levels:
            # plain-Jacobi zero-guess legs below the H prefix
            p.zsweep_restrict(fcb, out=fcc)
            uc = self._coarse_correction(l + 1, fcc, params)
            return p.zpsweep(fcb, uc, out=cur)
        if self.coarse_zero_legs:
            hx.zhswrr(p, fcb, params, out=fcc, dform=self.dform)
            uc = self._coarse_correction(l + 1, fcc, params)
            return hx.zphrelax(p, fcb, uc, params, out=cur, dform=self.dform)
        hx.hswrr(p, self._zero[l], fcb, params, out=spare, fc_out=fcc,
                 rsq=self._rsq_scratch, dform=self.dform)
        uc = self._coarse_correction(l + 1, fcc, params)
        return hx.phrelax(p, spare, fcb, uc, params, out=cur, dform=self.dform)

    def _cycle0(self, u, sp, fb, params, rsq_pre):
        """One V(1,1) cycle at level 0 -> (u_new, spare_new): two fused
        passes, E2 into ``sp`` and E3 back into ``u``'s buffer.  Writes the
        squared interior residual norm of the INCOMING ``u`` into
        ``rsq_pre``."""
        p = self.sweep_levels[0]
        hx.hswrr(p, u, fb, params, out=sp, fc_out=self._fc[1], rsq=rsq_pre, dform=self.dform)
        uc = self._coarse_correction(1, self._fc[1], params)
        hx.phrelax(p, sp, fb, uc, params, out=u, dform=self.dform)
        return u, sp

    def solve(self, params, f, u0=None, bc_value=0.0, eps: float = 5e-5,
              max_cycles: int = 100, chunk: int = 1, graph: bool = True):
        """H-MG solve to interior residual ``eps`` with the (L, 3, 3) H-Net
        kernels ``params`` (tensor or array).

        ``f`` is the (n+1, n+1) RHS (tensor or array).  Returns ``(u,
        history)`` in the convention of ``HierarchyV2.solve``: ``history[j]``
        is the interior residual norm after cycle j+1, and ``u`` includes
        one cycle beyond ``history`` plus up to ``chunk - 1`` more, the loop
        testing ``eps`` once per ``chunk`` cycles (its one host sync per
        chunk).  ``chunk=1`` is the JAX solver's semantics.  On the card
        each chunk is one replay of a CUDA graph, which reads a static copy
        of ``params`` (``graph=False``: the eager loop)."""
        params = self._params(params)
        return solve_cycles(
            lambda u, sp, fb, rsq, params: self._cycle0(u, sp, fb, params, rsq),
            self.hier.finest, f, u0, bc_value, eps, max_cycles, chunk, extra=(params,),
            graphs=chunk_graphs(self, graph), key=("solve",))
