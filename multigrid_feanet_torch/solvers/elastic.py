"""Multigrid for the vector elasticity operator (plane stress / strain).

Port of ``multigrid_feanet_tpu/solvers/elastic.py``.  The same geometric
V-cycle as the scalar path, full-weighting restriction and bilinear
prolongation applied per displacement component, with a damped 2x2
block-Jacobi smoother.  Fields are (2, n+1, n+1), component 0 = x.

- :func:`build_elastic_hierarchy`, :func:`relax`, :func:`v_cycle` and
  :func:`solve` are the plain PyTorch forms (the JAX package's XLA forms);
  ``solve`` returns post-cycle residuals, no lag.
- :class:`ElasticHierarchy`, the port of ``PallasElasticMG``, runs levels
  with ``n >= kernel_threshold`` on the fused CUDA legs of
  ``ops/elastic.py`` and the levels below on the plain V-cycle, with an
  optional dense-inverse direct solve at the coarsest level.  Per
  V(nu1, nu2) cycle:

  - level 0: nu1 - 1 sweeps (G1), ``sweep_restrict`` (G2), the coarse
    correction, ``psweep`` (G3), nu2 - 1 sweeps (G1);
  - levels 1..K-1 with nu1 = 1: the zero-guess legs ``zsweep_restrict``
    (G4) and ``zpsweep`` (G5), then nu2 - 1 sweeps;
  - levels 1..K-1 with nu1 > 1: nu1 - 1 sweeps from a zero iterate, G2,
    the recursion, G3, nu2 - 1 sweeps;
  - level K: the plain subtree.

  ``solve`` rides the free pre-update residual of each cycle's first
  level-0 kernel (``solvers/common.py``: one host sync per chunk);
  ``solve_pcg`` is flexible CG with one such V-cycle from zero as its
  preconditioner (one host sync per iteration).  Level buffers are
  allocated once, so on the card the cycles allocate nothing above the
  plain subtree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from multigrid_feanet_torch.core import geometry
from multigrid_feanet_torch.core.device import resolve_device
from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
from multigrid_feanet_torch.ops import elasticity as el
from multigrid_feanet_torch.ops.elastic import ElasticSweepLevel
from multigrid_feanet_torch.ops.stencil import pattern_ids_np
from multigrid_feanet_torch.ops.transfer import prolong_bilinear, restrict_full_weighting
from multigrid_feanet_torch.solvers.coarse import coarse_inverse_elastic, coarse_solve_elastic
from multigrid_feanet_torch.solvers.common import (
    ChunkGraphs, chunk_graphs, pcg_buffers, solve_cycles, solve_pcg)
from multigrid_feanet_torch.solvers.jacobi import DEFAULT_OMEGA


@dataclasses.dataclass
class ElasticLevel:
    """One elastic level: sizes, material, and operator fields on one device."""

    n: int  # elements per edge
    h: float  # element size
    E: float = 1.0
    nu: float = 0.3
    plane: str = "stress"
    a0: Optional[float] = None  # two-phase coefficients (None if homogeneous)
    a1: Optional[float] = None
    table: torch.Tensor = None  # (16, 3, 3, 2, 2)
    pid: Optional[torch.Tensor] = None  # (n+1, n+1) int8 pattern ids
    geo: torch.Tensor = None  # (n+1, n+1) interior mask
    dinv: torch.Tensor = None  # (n+1, n+1, 2, 2) inverse diagonal blocks
    phase: Optional[torch.Tensor] = None  # (n, n) int8 element phases

    @property
    def n_nodes(self) -> int:
        return self.n + 1

    @property
    def device(self) -> torch.device:
        return self.geo.device

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """A @ u (bitplane form when two-phase)."""
        if self.pid is not None and self.a0 is not None:
            return el.apply_elastic_bitplane(self.pid, u, self.E, self.nu, self.a0, self.a1,
                                             self.plane)
        return el.apply_elastic_stencil(self.table, self.pid, u)


def build_elastic_hierarchy(n: int, E: float = 1.0, nu: float = 0.3, size: float = 2.0,
                            inclusion=None, coefficients=(1.0, 1.0), plane: str = "stress",
                            num_levels: Optional[int] = None, dtype=torch.float32,
                            device=None) -> tuple:
    """Tuple of ElasticLevels, finest to coarsest (n halving), assembled in
    numpy on the host and placed once on ``device`` (None means CUDA)."""
    device = resolve_device(device)
    L = int(np.log2(n)) if num_levels is None else num_levels
    problem = Problem(n=n, size=size, inclusion=inclusion)

    def dev(x, dt):
        return None if x is None else torch.as_tensor(x, dtype=dt, device=device)

    levels = []
    for l in range(L):
        nl = n >> l
        h = size / nl
        table = el.make_elastic_stencil_table(E, nu, h, coefficients, plane, dtype)
        # the diagonal inverse is taken from the table in its dtype, in f64
        table_np = table.to(torch.float64).numpy()
        phase = problem.phase(nl)
        if phase is None:
            pid_np = None
            db = np.broadcast_to(table_np[0, 1, 1], (nl + 1, nl + 1, 2, 2))
        else:
            pid_np = pattern_ids_np(phase)
            db = table_np[:, 1, 1][pid_np]
        a, b, c, d = db[..., 0, 0], db[..., 0, 1], db[..., 1, 0], db[..., 1, 1]
        det = a * d - b * c
        dinv_np = np.stack([np.stack([d, -b], -1), np.stack([-c, a], -1)], -2) / det[..., None, None]
        a0, a1 = ((float(coefficients[0]), float(coefficients[1])) if phase is not None
                  else (None, None))
        levels.append(ElasticLevel(
            n=nl, h=h, E=float(E), nu=float(nu), plane=plane, a0=a0, a1=a1,
            table=table.to(device), pid=dev(pid_np, torch.int8),
            geo=geometry.interior_mask(nl + 1, dtype=dtype, device=device),
            dinv=dev(dinv_np, dtype), phase=dev(phase, torch.int8)))
    return tuple(levels)


def relax(level: ElasticLevel, u, f, num_sweeps: int, bc_value=0.0,
          omega: float = DEFAULT_OMEGA):
    """``num_sweeps`` block-Jacobi sweeps with Dirichlet reset."""
    gm = level.geo
    for _ in range(num_sweeps):
        u = u * gm + bc_value * (1.0 - gm)
        r = f - level.apply(u)
        rx, ry = r[..., 0, :, :], r[..., 1, :, :]
        upd = torch.stack([level.dinv[..., 0, 0] * rx + level.dinv[..., 0, 1] * ry,
                           level.dinv[..., 1, 0] * rx + level.dinv[..., 1, 1] * ry], dim=-3)
        u = u + omega * upd
        u = u * gm + bc_value * (1.0 - gm)
    return u


def v_cycle(levels, u, f, nu1: int = 1, nu2: int = 1, bc_value=0.0,
            omega: float = DEFAULT_OMEGA, level: int = 0):
    """One V(nu1, nu2) cycle on the plain ops."""
    lv = levels[level]
    bc = bc_value if level == 0 else 0.0
    u = relax(lv, u, f, nu1, bc, omega)
    if level < len(levels) - 1:
        r = f - lv.apply(u)
        f_c = 4.0 * restrict_full_weighting(r)
        u_c = v_cycle(levels, torch.zeros_like(f_c), f_c, nu1, nu2, 0.0, omega, level + 1)
        u = u + prolong_bilinear(u_c, lv.geo)
    return relax(lv, u, f, nu2, bc, omega)


def solve(levels, f, u0=None, nu1: int = 2, nu2: int = 2, eps: float = 1e-8,
          max_cycles: int = 400, chunk: int = 8, omega: float = DEFAULT_OMEGA):
    """Elastic V-cycle solve on the plain ops -> (u, residual history).

    ``history[j]`` is the interior residual norm after cycle j+1 (no lag).
    Norms are tested against ``eps`` once per ``chunk`` cycles: the returned
    ``u`` has every cycle of the last chunk, the history stops at the first
    norm <= eps."""
    lv0 = levels[0]
    f = torch.as_tensor(f, device=lv0.device)
    u = torch.zeros_like(f) if u0 is None else torch.as_tensor(u0, device=lv0.device)
    hist = []
    done = 0
    while done < max_cycles:
        k = min(chunk, max_cycles - done)
        norms = []
        for _ in range(k):
            u = v_cycle(levels, u, f, nu1, nu2, omega=omega)
            norms.append(el.elastic_interior_norm(f - lv0.apply(u)))
        norms = torch.stack(norms).cpu().numpy()
        hist.append(norms)
        done += k
        if eps is not None and (norms <= eps).any():
            hist[-1] = norms[: int((norms <= eps).argmax()) + 1]
            break
        if not np.isfinite(norms[-1]):
            break
    return u, np.concatenate(hist)


class ElasticHierarchy:
    """Elastic V-cycle whose levels with ``n >= kernel_threshold`` run the
    fused CUDA legs on compact fields (their plain PyTorch versions when the
    hierarchy lives on the CPU); smaller levels run the plain subtree, with
    the exact dense-inverse solve at the coarsest level when
    ``direct_coarse``.

    ``hier`` supplies prebuilt levels on ``device`` (a ``GridHierarchy`` of
    ``ElasticLevel``s, for example from
    ``core.convert.elastic_hierarchy_from_arrays``); each fused level takes
    its phase map from its ``ElasticLevel``.  ``device=None`` means CUDA and
    raises when there is none.

    ``kernel_threshold`` defaults to 16, the value every elastic cell runs:
    the fused legs reach down to the 17^2 level and the plain subtree holds
    only the levels below.  ``PallasElasticMG``'s 512 is the TPU's choice;
    on the H100 it leaves levels 257^2 ... 17^2 to eager torch ops (one
    NVIDIA H100 80GB HBM3 at 700 W, V(2,2) at 2049^2, the wall per cycle of
    ``chip_smoke.py``'s ``elastic_2049`` and ``elastic_2049_t512``: 1.1 to
    1.8 ms at 16 against 98 to 140 ms at 512 over three runs)."""

    def __init__(self, n: int, E: float = 1.0, nu: float = 0.3, size: float = 2.0,
                 inclusion=None, coefficients=(1.0, 1.0), plane: str = "stress",
                 num_levels: Optional[int] = None, kernel_threshold: int = 16,
                 omega: float = DEFAULT_OMEGA, direct_coarse: bool = False,
                 hier: Optional[GridHierarchy] = None, device=None):
        device = resolve_device(device)
        # TF32 keeps ~3 decimal digits: the direct coarse solve's matmul
        # must run in full f32 to stay exact.
        torch.backends.cuda.matmul.allow_tf32 = False
        self.device = device
        if hier is None:
            hier = GridHierarchy(levels=build_elastic_hierarchy(
                n, E, nu, size, inclusion, coefficients, plane, num_levels, device=device))
        if hier.device != device:
            raise ValueError(f"hier lives on {hier.device}, not {device}")
        self.hier = hier
        self.levels = hier.levels
        self.omega = float(omega)
        L = len(self.levels)
        # fused levels 0..K-1; level K is the first of the plain subtree
        K = 0
        while K < L - 1 and self.levels[K].n >= kernel_threshold:
            K += 1
        if K < 1:
            raise ValueError("the finest level is below kernel_threshold: nothing to fuse")
        self.K = K
        self.sweep_levels = [
            ElasticSweepLevel(self.levels[l].n, E, nu, phase=self.levels[l].phase,
                              coefficients=coefficients, plane=plane, omega=omega,
                              device=device)
            for l in range(K)]
        self.coarse_inv = None
        if direct_coarse and L > 1:
            self.coarse_inv = (hier.coarse_inv if hier.coarse_inv is not None
                               else coarse_inverse_elastic(self.levels[-1]))
        # preallocated level buffers: the RHS of levels 1..K, the iterate
        # pairs of levels 1..K-1 (level 0's pair and the CG vectors come
        # with the first solve_pcg), and a scratch scalar for the residual
        # norms the cycle does not read
        self._fc = {l: self._field(l) for l in range(1, K + 1)}
        self._u = {l: (self._field(l), self._field(l)) for l in range(1, K)}
        self._rsq_scratch = torch.empty((), dtype=torch.float32, device=device)
        self._cg = None
        self.graphs = ChunkGraphs(device)

    def _field(self, l: int) -> torch.Tensor:
        H = self.levels[l].n_nodes
        return torch.empty((2, H, H), dtype=torch.float32, device=self.device)

    def _rhs(self, f) -> torch.Tensor:
        f = torch.as_tensor(f, dtype=torch.float32, device=self.device).contiguous()
        H = self.levels[0].n_nodes
        if tuple(f.shape) != (2, H, H):
            raise ValueError(f"f must be a (2, {H}, {H}) displacement RHS, not {tuple(f.shape)}")
        return f

    @staticmethod
    def _check_schedule(nu1: int, nu2: int):
        if nu1 < 1 or nu2 < 1:
            raise ValueError(f"the fused cycle needs nu1, nu2 >= 1, not ({nu1}, {nu2})")

    # ---- plain subtree (levels K..L-1) ----

    def _plain_vcycle(self, l: int, u, f, nu1: int, nu2: int):
        """V-cycle on the plain PyTorch ops; the counterpart of
        ``PallasElasticMG._xla_vcycle``."""
        lv = self.levels[l]
        L = len(self.levels)
        if l == L - 1 and l > 0 and self.coarse_inv is not None:
            return coarse_solve_elastic(self.coarse_inv, f).to(f.dtype)
        u = relax(lv, u, f, nu1, 0.0, self.omega)
        if l < L - 1:
            r = f - lv.apply(u)
            f_c = 4.0 * restrict_full_weighting(r)
            u_c = self._plain_vcycle(l + 1, torch.zeros_like(f_c), f_c, nu1, nu2)
            u = u + prolong_bilinear(u_c, lv.geo)
        return relax(lv, u, f, nu2, 0.0, self.omega)

    # ---- fused V-cycle ----

    def _coarse_correction(self, l: int, fcb, nu1: int, nu2: int):
        """Solve the level-l error equation from a zero initial guess;
        ``fcb`` is the level-l RHS.  Returns the level-l correction."""
        if l >= self.K:
            return self._plain_vcycle(l, torch.zeros_like(fcb), fcb, nu1, nu2).contiguous()
        p = self.sweep_levels[l]
        cur, spare = self._u[l]
        rsq = self._rsq_scratch
        if nu1 == 1:
            # zero-initial-guess legs: u1 = omega D^-1 f is recomputed inside
            # both kernels and never stored
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
            p.psweep(cur, fcb, uc, out=spare)
            cur, spare = spare, cur
        for _ in range(nu2 - 1):
            p.sweep(cur, fcb, out=spare, rsq=rsq)
            cur, spare = spare, cur
        return cur

    def _cycle0(self, u, sp, fb, nu1: int, nu2: int, rsq_pre):
        """One V(nu1, nu2) cycle at level 0 -> (u_new, spare_new); writes the
        squared interior residual norm of the INCOMING ``u`` into
        ``rsq_pre``."""
        p = self.sweep_levels[0]
        cur, spare, rsq = u, sp, rsq_pre
        for _ in range(nu1 - 1):
            p.sweep(cur, fb, out=spare, rsq=rsq)
            rsq = self._rsq_scratch
            cur, spare = spare, cur
        p.sweep_restrict(cur, fb, out=spare, fc_out=self._fc[1], rsq=rsq)
        cur, spare = spare, cur
        uc = self._coarse_correction(1, self._fc[1], nu1, nu2)
        p.psweep(cur, fb, uc, out=spare)
        cur, spare = spare, cur
        for _ in range(nu2 - 1):
            p.sweep(cur, fb, out=spare, rsq=self._rsq_scratch)
            cur, spare = spare, cur
        return cur, spare

    def solve(self, f, u0=None, bc_value=None, nu1: int = 2, nu2: int = 2,
              eps: float = 1e-8, max_cycles: int = 100, chunk: int = 1, graph: bool = True):
        """V-cycle solve to interior residual ``eps`` (both components).

        ``f`` is the (2, n+1, n+1) RHS (tensor or array).  Returns ``(u,
        history)`` in the convention of ``solvers/common.py``:
        ``history[j]`` is the residual after cycle j+1, and ``u`` includes
        one cycle beyond ``history`` plus up to ``chunk - 1`` more.  On the
        card each chunk is one CUDA graph replay (``graph=False``: the eager
        loop)."""
        self._check_schedule(nu1, nu2)
        return solve_cycles(
            lambda u, sp, fb, rsq: self._cycle0(u, sp, fb, nu1, nu2, rsq),
            self.levels[0], self._rhs(f), u0, bc_value, eps, max_cycles, chunk,
            graphs=chunk_graphs(self, graph), key=("solve", nu1, nu2))

    # ---- Krylov acceleration ----

    def apply_fused(self, p, out=None):
        """Interior-masked A p (zero on the boundary) through G1 in residual
        mode with f = 0, negated in place."""
        if self._cg is None:
            self._cg_buffers()
        r, _ = self.sweep_levels[0].residual(p, self._cg["zero"], out=out,
                                             rsq=self._rsq_scratch)
        return r.neg_()

    def _cg_buffers(self):
        self._u.setdefault(0, (self._field(0), self._field(0)))
        self._cg = pcg_buffers(self._field(0))

    def solve_pcg(self, f, u0=None, nu1: int = 2, nu2: int = 2, eps: float = 1e-8,
                  max_iters: int = 60, graph: bool = True):
        """Flexible CG with one fused V(nu1, nu2) cycle from zero as the
        preconditioner (``solvers/common.py::solve_pcg``: Polak-Ribiere beta
        clipped at 0, the true residual recomputed by G1 every iteration --
        the f32 recurrence drifts at |A| ~ 2e5 -- and the breakdown guards).
        ``u0`` is masked to the interior.

        Returns ``(u, history)``: ``history[j]`` is the interior residual
        norm after iteration j+1 (post-iteration, no lag: the returned u's
        residual is ``history[-1]``).  The loop reads two scalars back once
        per iteration; on the card each iteration after the start is one
        CUDA graph replay (``graph=False``: the eager loop)."""
        self._check_schedule(nu1, nu2)
        if self._cg is None:
            self._cg_buffers()
        f = self._rhs(f)
        u = torch.zeros_like(f) if u0 is None else torch.as_tensor(
            u0, dtype=torch.float32, device=self.device)
        u = (u * self.levels[0].geo).contiguous()
        return solve_pcg(self.sweep_levels[0], lambda r: self._coarse_correction(0, r, nu1, nu2),
                         f, u, self._cg, eps, max_iters, chunk_graphs(self, graph),
                         ("pcg", nu1, nu2))
