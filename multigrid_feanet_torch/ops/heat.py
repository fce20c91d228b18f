"""Time-dependent heat equation: implicit theta-scheme steps with multigrid.

Port of ``multigrid_feanet_tpu/ops/heat.py``.  Semi-discrete form
M du/dt + K u = M f; one theta-scheme step solves

    (M + theta dt K) u^{n+1} = (M - (1-theta) dt K) u^n
                               + dt M (theta f^{n+1} + (1-theta) f^n).

The system B = M + theta dt K is affine in the element-phase bits (the
consistent mass matrix does not see the coefficient), so its levels carry
the phase-affine form of ``core.problem.Level`` (``base``, ``bit_scale``),
and the fused legs of ``ops/sweep.py`` run it as the stiffness operator with
coefficients theta dt (a0, a1) plus the per-element mass triple
(mp, ms, mo) = h^2 (1/18, 1/18, -1/36) in the plain form.

``HeatSolver``'s backends: ``"plain"`` (the JAX package's ``"xla"``,
``solvers/multigrid.py`` on the system hierarchy) and ``"fused"`` (its
``"pallas"``, ``HierarchyV2`` on kernels A1-A4 with the mass triple).
``kernel_kw={"dtype": torch.bfloat16}`` (JAX: ``pallas_kw``) stores the
fused levels in bf16: ``step`` and ``march`` then return a bf16 u, and the
right-hand side is computed in f32 from it and rounded to bf16 for the
cycles (the JAX march pads it to bf16 the same way).

The right-hand side is kernel X1 on the card (``ops/passes.py``), its plain
version on the CPU, whatever the backend.  On the card the fused backend's
``march`` replays one CUDA graph per step (``solvers/common.py::
ChunkGraphs``): the body of the JAX march's ``lax.scan``, X1 and then the
step's V-cycles.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from multigrid_feanet_torch.core.device import resolve_device
from multigrid_feanet_torch.core.geometry import reset_boundary
from multigrid_feanet_torch.core.problem import GridHierarchy, Problem
from multigrid_feanet_torch.ops import passes, stencil
from multigrid_feanet_torch.solvers import multigrid
from multigrid_feanet_torch.solvers.common import ChunkGraphs, chunk_graphs
from multigrid_feanet_torch.solvers.mg2 import HierarchyV2

BACKENDS = ("plain", "fused")


def mass_table(h: float, num_patterns: int = 16, dtype=torch.float64,
               device=None) -> torch.Tensor:
    """(P, 3, 3) consistent-mass stencil table (the same for every phase
    pattern).  ``device=None`` means CUDA."""
    m = (h * h) * np.asarray(stencil.MASS_KERNEL)
    return torch.as_tensor(np.broadcast_to(m, (num_patterns, 3, 3)).copy(), dtype=dtype,
                           device=resolve_device(device))


def heat_system_hierarchy(problem: Problem, dt: float, theta: float = 1.0,
                          num_levels: Optional[int] = None, device=None) -> GridHierarchy:
    """Hierarchy whose level operators are B = M + theta dt K, assembled in
    numpy as the JAX package assembles them: homogeneous levels carry the
    (3, 3) system stencil; bi-material levels the (16, 3, 3) system table
    (diagonal, dense coarse inverse) and the phase-affine form
    base = h^2 MASS + theta dt a0 S9, bit_scale = theta dt (a1 - a0), with
    a0 = a1 = None.  ``device=None`` means CUDA."""
    base = GridHierarchy.create(problem, num_levels, device=device)
    s9_np = stencil.make_stencil_table_np((1.0, 1.0))[0]
    m_np = np.asarray(stencil.MASS_KERNEL)
    dtype, dev = base.finest.table.dtype, base.device

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    levels = []
    for lv in base.levels:
        hh = lv.h * lv.h
        if lv.pid is None:
            sys_np = hh * m_np + theta * dt * s9_np
            levels.append(dataclasses.replace(
                lv, table=t(sys_np), diag=t(np.full((lv.n + 1, lv.n + 1), sys_np[1, 1]))))
        else:
            sys_np = hh * m_np + theta * dt * stencil.make_stencil_table_np(problem.coefficients)
            pid_np = stencil.pattern_ids_np(problem.phase(lv.n))
            levels.append(dataclasses.replace(
                lv, table=t(sys_np), diag=t(sys_np[:, 1, 1][pid_np]), a0=None, a1=None,
                base=t(hh * m_np + (theta * dt * lv.a0) * s9_np),
                bit_scale=float(theta * dt * (lv.a1 - lv.a0))))
    return GridHierarchy(levels=tuple(levels))


def heat_mass(level) -> tuple:
    """The per-element mass triple h^2 (1/18, 1/18, -1/36) of a level."""
    hh = level.h * level.h
    return (hh / 18.0, hh / 18.0, -hh / 36.0)


def heat_hierarchy(problem: Problem, dt: float, theta: float = 1.0,
                   num_levels: Optional[int] = None, sys=None, device=None,
                   dtype=torch.float32, **kw) -> HierarchyV2:
    """``HierarchyV2`` for the theta-system B = M + theta dt K, the port of
    ``pallas_heat_hierarchy``: the fused legs run coefficients
    theta dt (a0, a1) with the mass triple; the plain subtree and the direct
    coarse solve run ``sys`` (default: :func:`heat_system_hierarchy`), so
    a solve is cycle for cycle ``multigrid.solve`` on that hierarchy.
    ``dtype`` is the fused levels' storage type (float32 or bfloat16: the
    mass form of A1-A6 in bf16).  ``device=None`` means CUDA."""
    device = resolve_device(device)
    if sys is None:
        sys = heat_system_hierarchy(problem, dt, theta, num_levels, device=device)
    td = float(theta) * float(dt)
    a0, a1 = problem.coefficients
    return HierarchyV2(problem, num_levels=num_levels, hier=sys,
                       coefficients=(td * a0, td * a1), mass_fn=heat_mass,
                       dtype=dtype, device=device, **kw)


@dataclasses.dataclass
class HeatSolver:
    """Implicit theta-scheme heat stepper with V(1,1) inner solves.
    ``kernel_kw`` holds extra ``HierarchyV2`` keywords of the fused backend;
    ``device=None`` means CUDA."""

    problem: Problem
    dt: float
    theta: float = 1.0  # 1 = backward Euler, 0.5 = Crank-Nicolson
    backend: str = "plain"  # "fused": inner solves on the fused CUDA legs
    kernel_kw: Optional[dict] = None
    device: object = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, not {self.backend!r}")
        self.device = resolve_device(self.device)
        self.sys = heat_system_hierarchy(self.problem, self.dt, self.theta, device=self.device)
        self.stiff = GridHierarchy.create(self.problem, device=self.device)
        self.h = self.problem.size / self.problem.n
        kw = dict(self.kernel_kw or {})
        # share self.sys unless the fused hierarchy is truncated
        share = "num_levels" not in kw
        self.ph = (heat_hierarchy(self.problem, self.dt, self.theta,
                                  sys=self.sys if share else None, device=self.device, **kw)
                   if self.backend == "fused" else None)
        self._k = passes.operator_form(self.stiff.finest)  # K as X1 takes it
        self.graphs = ChunkGraphs(self.device)

    def _field(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.problem.dtype, device=self.device)

    def rhs(self, u_n, f_n, f_np1) -> torch.Tensor:
        """(M - (1-theta) dt K) u^n + dt M (theta f^{n+1} + (1-theta) f^n), in
        the problem's type: X1 on the card."""
        u_n, f_n, f_np1 = (self._field(x).contiguous() for x in (u_n, f_n, f_np1))
        return self._rhs(u_n, f_n, f_np1)

    def _rhs(self, u, f_n, f_np1, out=None):
        """The right-hand side of u (the problem's type, or the fused levels'
        in the march), computed in the problem's type, into ``out`` (its
        type; u's when None)."""
        return passes.heat_rhs(u, f_n, f_np1, h=self.h, theta=self.theta, dt=self.dt, out=out,
                               **self._k)

    def step(self, u_n, f_n, f_np1, bc_value=0.0, eps: float = 1e-10, max_cycles: int = 100):
        """One implicit step -> (u^{n+1}, the inner solve's history)."""
        b = self.rhs(u_n, f_n, f_np1)
        if self.ph is not None:
            return self.ph.solve(b, u0=self._field(u_n), bc_value=bc_value, nu1=1, nu2=1,
                                 eps=eps, max_cycles=max_cycles)
        return multigrid.solve(self.sys, b, u0=self._field(u_n), nu1=1, nu2=1,
                               bc_value=bc_value, eps=eps, max_cycles=max_cycles)

    def run(self, u0, f_fn, t0: float, num_steps: int, bc_value=0.0, eps: float = 1e-10):
        """March ``num_steps`` adaptive steps; ``f_fn(t) -> (H, W)`` source."""
        u, t = self._field(u0), t0
        for _ in range(num_steps):
            u, _ = self.step(u, f_fn(t), f_fn(t + self.dt), bc_value, eps)
            t += self.dt
        return u

    def march(self, u0, f, num_steps: int, cycles_per_step: int = 2, bc_value=0.0,
              graph: bool = True):
        """``num_steps`` implicit steps with a FIXED number of V(1,1) cycles
        each and no host sync until it returns (the JAX package compiles the
        same loop as one ``lax.scan``).  ``f``: a time-independent (H, W)
        source, or per-time-knot sources (num_steps + 1, H, W) (knot j at
        t0 + j dt).  Returns the final u.

        On the card the fused backend replays one CUDA graph per step (X1
        and the step's cycles) on static copies of u and the (f^n, f^{n+1})
        pair, into which a time-dependent f's knots are copied before each
        step; the returned u is a copy.  It equals the eager loop, which
        ``graph=False`` runs instead, bit for bit.  The plain backend's
        march stays eager (its cycles are torch ops)."""
        f = self._field(f).contiguous()
        timedep = f.dim() == 3
        u = reset_boundary(self._field(u0), self.sys.finest.geo, bc_value)

        def knots(k):
            return (f[k], f[k + 1]) if timedep else (f, f)

        ph = self.ph
        if ph is None:
            for k in range(num_steps):
                b = self._rhs(u, *knots(k))
                for _ in range(cycles_per_step):
                    u = multigrid.v_cycle(self.sys, u, b, 1, 1, bc_value)
            return u
        u = u.to(ph.dtype).contiguous()

        def steps(u, sp, b, rsq, f_n, f_np1):
            """One step of the march: the right-hand side, then its cycles."""
            self._rhs(u, f_n, f_np1, out=b)
            for _ in range(cycles_per_step):
                u, sp = ph._cycle0(u, sp, b, 1, 1, rsq)
            return u, sp

        graphs = chunk_graphs(self, graph)
        if graphs is None:
            sp, b = torch.empty_like(u), torch.empty_like(u)
            rsq = torch.empty((), dtype=torch.float32, device=self.device)
            for k in range(num_steps):
                u, sp = steps(u, sp, b, rsq, *knots(k))
            return u
        key = ("march", cycles_per_step, timedep, ph.dtype)

        def make():
            fs = torch.empty(f.shape[-2:], dtype=f.dtype, device=self.device)
            return SimpleNamespace(
                u=torch.empty_like(u), sp=torch.empty_like(u), b=torch.empty_like(u),
                rsq=torch.empty((), dtype=torch.float32, device=self.device),
                # one buffer for both knots of a time-independent f
                f=(fs, torch.empty_like(fs) if timedep else fs))

        st = graphs.statics(key, make)
        st.u.copy_(u)

        def body():
            v, _ = steps(st.u, st.sp, st.b, st.rsq, *st.f)
            if v is not st.u:
                st.u.copy_(v)

        for k in range(num_steps):
            if timedep or k == 0:
                for buf, knot in zip(st.f, knots(k)):
                    buf.copy_(knot)
            graphs.run(key, body)
        return st.u.clone()
