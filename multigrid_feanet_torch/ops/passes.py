"""The passes the JAX package leaves to XLA's fusion, as kernels X1-X4.

The JAX package computes these outside any Pallas kernel, and XLA fuses
each into one program inside a compiled loop: the heat right-hand side in
``HeatSolver.march``'s ``lax.scan``, the round-1 transfers in
``PallasHierarchy.solve``'s ``while_loop``, ``solve_ir``'s outer step in its
jitted ``_outer64``.  Run as eager torch ops each is a chain of passes over
the whole grid; here each is one hand-written CUDA C++ kernel
(``csrc/passes.cu``), the port's form of that fusion:

====  =====================  ==================================================
name  C entry point          replaces (XLA-fused, no Pallas kernel)
====  =====================  ==================================================
X1    ``px_heat_rhs``        ``ops/heat.py:124 HeatSolver.rhs``
X2    ``px_restrict``        ``ops/transfer.py:38 restrict_full_weighting`` x 4
X3    ``px_prolong_add``     ``ops/transfer.py:61 prolong_bilinear`` + the add
X4    ``px_outer_step``      ``solvers/pallas_mg.py:313 _outer64``
====  =====================  ==================================================

Each has a wrapper ``<op>_cuda`` (checks, allocation, launch, launch count)
and a plain PyTorch version ``<op>_plain`` with the same signature: the torch
code the port ran before, moved here.  :func:`heat_rhs`, :func:`restrict`,
:func:`prolong_add` and :func:`outer_step` take the plain version for CPU
tensors and launch the kernel for CUDA ones (or raise).  The kernels round
where their plain versions round (``csrc/passes.cu``): X2 and X3 equal them
bit for bit, X1 agrees to ``ops.sweep.TOL`` of max|b| (``TOL64`` when it
computes in float64, the type of a float64 problem's f) and X4 to
``TOL64``.

The operator arguments: X1's stiffness K and X4's f64 A are the two-phase
bitplane form (``pid`` with ``a0``, ``a1``) or a homogeneous (3, 3)
``table`` of host numbers (nested sequences); :func:`operator_form` reads
them from a level once.  The plain versions also take a (16, 3, 3) table
with ``pid`` (the gather form), which the kernels refuse.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from multigrid_feanet_torch.ops import stencil
from multigrid_feanet_torch.ops import sweep as sw
from multigrid_feanet_torch.ops.transfer import prolong_bilinear, restrict_full_weighting

TOL64 = 1e-12  # X4 and float64 X1 against their plain versions: relative to max|plain|

_P, _I = ctypes.c_void_p, ctypes.c_int
_SOURCE = "multigrid_feanet_torch/csrc/passes.cu"
_TPU = "multigrid_feanet_tpu/"
KERNELS = {
    "X1": sw.CudaKernel("X1_heat_rhs", "px_heat_rhs", [_P] * 5 + [_I, _P, _I, _I, _P],
                        _TPU + "ops/heat.py:124", _SOURCE),
    "X2": sw.CudaKernel("X2_restrict", "px_restrict", [_P, _P, _I, _P],
                        _TPU + "ops/transfer.py:38", _SOURCE),
    "X3": sw.CudaKernel("X3_prolong_add", "px_prolong_add", [_P] * 4 + [_I, _P],
                        _TPU + "ops/transfer.py:61", _SOURCE),
    "X4": sw.CudaKernel("X4_outer_step", "px_outer_step",
                        [_P] * 10 + [_I, ctypes.POINTER(ctypes.c_double), _I, _P],
                        _TPU + "solvers/pallas_mg.py:313", _SOURCE),
}

# The offsets of ops/stencil.py UNIT_S9's taps in the order of its dict, as
# csrc/passes.cu's s9_dr / s9_dc list them; every UNIT_S4 dict holds its
# (centre, row edge, column edge, corner) in that order.
S9_ORDER = ((0, 0), (-1, 0), (0, -1), (-1, -1), (0, 1), (-1, 1), (1, 0), (1, -1), (1, 1))


# ---------------------------------------------------------------------------
# Plain versions: the torch code of HeatSolver.rhs, the round-1 V-cycle's
# transfers and solve_ir's outer step.
# ---------------------------------------------------------------------------


def _apply(u, pid, a0, a1, table):
    """A u in the form the arguments give (``core.problem.Level.apply``)."""
    if pid is not None and a0 is not None:
        return stencil.apply_stencil_bitplane(pid, u, a0, a1)
    return stencil.apply_stencil(torch.as_tensor(table, dtype=u.dtype, device=u.device), pid, u)


def heat_rhs_plain(u, f0, f1, pid=None, *, h, theta, dt, a0=None, a1=None, table=None,
                   out=None):
    """X1: b = M_h u - (1 - theta) dt K u + dt M_h (theta f1 + (1 - theta)
    f0), computed in the wider of u's type (a bf16 ``u`` widened to
    float32) and the f's (the problem's, float32 or float64), returned in
    ``out``'s type (u's when None: a bf16 b is the float32 one rounded)."""
    dtype = u.dtype if out is None else out.dtype
    u = u.to(torch.promote_types(sw._widen(u)[0].dtype, f0.dtype))
    mu = stencil.apply_mass(u, h)
    ku = _apply(u, pid, a0, a1, table)
    f_mix = theta * f1 + (1.0 - theta) * f0
    b = mu - (1.0 - theta) * dt * ku + dt * stencil.apply_mass(f_mix, h)
    return sw._emit(b, out, dtype)


def restrict_plain(r, out=None):
    """X2: the coarse right-hand side 4 FW(r), zero on the coarse ring."""
    return sw._emit(4.0 * restrict_full_weighting(r), out)


def prolong_add_plain(u, uc, geo, out=None):
    """X3: u + geo P(uc), P the bilinear prolongation."""
    return sw._emit(u + prolong_bilinear(uc, geo), out)


def outer_step_plain(u, e, f, geo, pid=None, *, a0=None, a1=None, table=None, out=None):
    """X4: (u + e geo, r = f - A (u + e geo) as float32, the interior sum of
    r^2) from the f64 ``u``, ``f`` and ``geo`` and the float32 (or bf16)
    correction ``e``."""
    u = u + e.double() * geo
    r = f - _apply(u, pid, a0, a1, table)
    ri = r[..., 1:-1, 1:-1]
    return sw._emit(u, out), r.float(), torch.sum(ri * ri, dim=(-2, -1))


# ---------------------------------------------------------------------------
# CUDA kernels: wrappers.
# ---------------------------------------------------------------------------


def _field(t, name, shape, dtype, device):
    """Check a contiguous CUDA field of ``shape`` and ``dtype`` on ``device``."""
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, not {t.device} ones")
    sw._check(t, name, shape, dtype, device)


def _grid(x, name):
    """n of an (n+1, n+1) field."""
    if x.dim() != 2 or x.shape[0] != x.shape[1] or x.shape[0] < 2:
        raise ValueError(f"{name} must be an (n+1, n+1) field, got {tuple(x.shape)}")
    return x.shape[0] - 1


def _even(n):
    if n < 2 or n % 2:
        raise ValueError(f"the transfers take an even n >= 2, got n={n}")


def _kernel_form(pid, a0, a1, table):
    """(pid or None, the (3, 3) table's 9 numbers) of a form the kernels
    take: the bitplane form or the homogeneous stencil."""
    if pid is not None:
        if a0 is None or a1 is None:
            raise ValueError("the kernels take the two-phase bitplane form (pid with a0 and "
                             "a1) or a homogeneous table, not a gathered pattern table")
        return pid, (0.0,) * 9
    t = np.asarray(table, dtype=np.float64)
    if t.shape != (3, 3):
        raise ValueError(f"a homogeneous operator is a (3, 3) table, not {t.shape}")
    return None, tuple(float(x) for x in t.reshape(-1))


def _s4():
    """S4's (centre, edge, corner) and S9's taps in dict order."""
    sw_taps = list(stencil.UNIT_S4[0].values())
    return (sw_taps[0], sw_taps[1], sw_taps[3]), tuple(stencil.UNIT_S9[k] for k in S9_ORDER)


@functools.lru_cache(maxsize=64)
def _rhs_weights(h, theta, dt, a0, a1, k9, f64=False):
    """X1's RhsW (csrc/passes.cu) in its arithmetic type, as the plain
    version rounds each: a scalar multiplies a field in the field's type
    (float32, or float64 when ``f64``)."""
    dtype = torch.float64 if f64 else torch.float32
    m = ((h * h) * torch.as_tensor(stencil.MASS_KERNEL, dtype=dtype)).reshape(-1)
    (c4, e4, d4), s9 = _s4()
    da = 0.0 if a0 is None else float(a1) - float(a0)
    vals = (*m.tolist(), *k9, *s9, c4, e4, d4, 0.0 if a0 is None else float(a0), da, theta,
            1.0 - theta, (1.0 - theta) * dt, dt)
    if f64:
        return (ctypes.c_double * 36)(*vals)
    return (ctypes.c_float * 36)(*np.asarray(vals, dtype=np.float32).tolist())


@functools.lru_cache(maxsize=64)
def _outer_weights(a0, a1, k9):
    """X4's OuterW (csrc/passes.cu) in float64."""
    (c4, e4, d4), s9 = _s4()
    da = 0.0 if a0 is None else float(a1) - float(a0)
    return (ctypes.c_double * 23)(*k9, *s9, c4, e4, d4, 0.0 if a0 is None else float(a0), da)


def _pid(pid, n, device):
    if pid is not None:
        _field(pid, "pid", (n + 1, n + 1), torch.int8, device)
    return sw._ptr(pid)


# X1's u (and b) types, as px_heat_rhs numbers them
_U_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


def heat_rhs_cuda(u, f0, f1, pid=None, *, h, theta, dt, a0=None, a1=None, table=None,
                  out=None):
    """X1 on the card; same contract as :func:`heat_rhs_plain`, with f0 and
    f1 both float32 or both float64 (they may be one tensor), ``u`` float32,
    bf16 or (with float64 f) float64, and ``out`` of u's type."""
    n, dev = _grid(u, "u"), u.device
    if u.dtype not in _U_TYPES:
        raise ValueError(f"u must be float32, bfloat16 or float64, not {u.dtype}")
    if f0.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"f0 and f1 must be float32 or float64, not {f0.dtype}")
    if u.dtype == torch.float64 and f0.dtype != torch.float64:
        raise ValueError("a float64 u takes float64 f0 and f1")
    _field(u, "u", (n + 1, n + 1), u.dtype, dev)
    _field(f0, "f0", (n + 1, n + 1), f0.dtype, dev)
    _field(f1, "f1", (n + 1, n + 1), f0.dtype, dev)
    pid, k9 = _kernel_form(pid, a0, a1, table)
    out = sw._output(out, "out", (n + 1, n + 1), dev, (u, f0, f1), u.dtype)
    f64 = f0.dtype == torch.float64
    w = _rhs_weights(float(h), float(theta), float(dt), a0, a1, k9, f64)
    KERNELS["X1"](u.data_ptr(), f0.data_ptr(), f1.data_ptr(), _pid(pid, n, dev), out.data_ptr(),
                  n, w, _U_TYPES[u.dtype], int(f64), sw._stream(dev))
    return out


def restrict_cuda(r, out=None):
    """X2 on the card; same contract as :func:`restrict_plain` (float32)."""
    n, dev = _grid(r, "r"), r.device
    _even(n)
    _field(r, "r", (n + 1, n + 1), torch.float32, dev)
    out = sw._output(out, "out", (n // 2 + 1, n // 2 + 1), dev, (r,))
    KERNELS["X2"](r.data_ptr(), out.data_ptr(), n, sw._stream(dev))
    return out


def prolong_add_cuda(u, uc, geo, out=None):
    """X3 on the card; same contract as :func:`prolong_add_plain` (float32)."""
    n, dev = _grid(u, "u"), u.device
    _even(n)
    _field(u, "u", (n + 1, n + 1), torch.float32, dev)
    _field(uc, "uc", (n // 2 + 1, n // 2 + 1), torch.float32, dev)
    _field(geo, "geo", (n + 1, n + 1), torch.float32, dev)
    out = sw._output(out, "out", (n + 1, n + 1), dev, (u, uc, geo))
    KERNELS["X3"](u.data_ptr(), uc.data_ptr(), geo.data_ptr(), out.data_ptr(), n,
                  sw._stream(dev))
    return out


def outer_blocks(n: int) -> int:
    """Blocks of one X4 launch on an (n+1)^2 grid: csrc/passes.cu's tiles of
    32 x 8 nodes."""
    return -(-(n + 1) // 32) * -(-(n + 1) // 8)


def outer_step_cuda(u, e, f, geo, pid=None, *, a0=None, a1=None, table=None, out=None,
                    workspace=None):
    """X4 on the card; same contract as :func:`outer_step_plain`: ``u``,
    ``f``, ``geo`` (and ``out``) float64, ``e`` float32 or bf16;
    ``workspace`` (a dict) keeps the scratch of the norm between calls."""
    n, dev = _grid(u, "u"), u.device
    _field(u, "u", (n + 1, n + 1), torch.float64, dev)
    if e.dtype not in sw.STORAGE:
        raise ValueError(f"e must be float32 or bfloat16, not {e.dtype}")
    _field(e, "e", (n + 1, n + 1), e.dtype, dev)
    _field(f, "f", (n + 1, n + 1), torch.float64, dev)
    _field(geo, "geo", (n + 1, n + 1), torch.float64, dev)
    pid, k9 = _kernel_form(pid, a0, a1, table)
    out = sw._output(out, "out", (n + 1, n + 1), dev, (u, f, geo), torch.float64)
    r32 = torch.empty((n + 1, n + 1), dtype=torch.float32, device=dev)
    rsq = torch.empty((), dtype=torch.float64, device=dev)
    partial, done = sw._block_scratch(("X4", n), outer_blocks(n), dev, workspace,
                                      torch.float64)
    KERNELS["X4"](u.data_ptr(), e.data_ptr(), f.data_ptr(), geo.data_ptr(), _pid(pid, n, dev),
                  out.data_ptr(), r32.data_ptr(), partial.data_ptr(), done.data_ptr(),
                  rsq.data_ptr(), n, _outer_weights(a0, a1, k9), sw.STORAGE[e.dtype],
                  sw._stream(dev))
    return out, r32, rsq


# ---------------------------------------------------------------------------
# Dispatch: the plain version on the CPU, the kernel on the card.
# ---------------------------------------------------------------------------


def operator_form(level) -> dict:
    """The operator of a ``core.problem.Level`` as these passes take it:
    ``pid``, ``a0``, ``a1`` (two-phase) or ``pid`` and a nested ``table`` of
    host numbers (homogeneous, or a gathered pattern table, which only the
    plain versions take).  Reads a homogeneous table from the device once;
    raises for the phase-affine form (``base``)."""
    if level.base is not None:
        raise ValueError("the passes do not take the phase-affine operator form (base)")
    if level.pid is not None and level.a0 is not None:
        return dict(pid=level.pid, a0=float(level.a0), a1=float(level.a1))
    table = level.table.cpu().tolist()

    def freeze(x):
        return tuple(freeze(y) for y in x) if isinstance(x, list) else x

    return dict(pid=level.pid, table=freeze(table))


def heat_rhs(u, f0, f1, *, h, theta, dt, out=None, **form):
    """X1 (kernel on CUDA tensors, plain version on CPU ones)."""
    fn = heat_rhs_cuda if u.device.type == "cuda" else heat_rhs_plain
    return fn(u, f0, f1, h=h, theta=theta, dt=dt, out=out, **form)


def restrict(r, out=None):
    """X2 (kernel on CUDA tensors, plain version on CPU ones)."""
    return (restrict_cuda if r.device.type == "cuda" else restrict_plain)(r, out)


def prolong_add(u, uc, geo, out=None):
    """X3 (kernel on CUDA tensors, plain version on CPU ones)."""
    return (prolong_add_cuda if u.device.type == "cuda" else prolong_add_plain)(u, uc, geo, out)


def outer_step(u, e, f, geo, out=None, workspace=None, **form):
    """X4 (kernel on CUDA tensors, plain version on CPU ones; ``workspace``
    keeps the kernel's scratch)."""
    if u.device.type == "cuda":
        return outer_step_cuda(u, e, f, geo, out=out, workspace=workspace, **form)
    return outer_step_plain(u, e, f, geo, out=out, **form)
