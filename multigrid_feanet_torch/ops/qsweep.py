"""The coefficient-stream ("Q-stream") bi-material Jacobi sweep.

Port of ``multigrid_feanet_tpu/ops/pallas_qsweep.py``.  The sweep of
``ops/sweep.py`` (A1) reads the int8 element phase map and forms
Q = a0 + da * phase itself; this one reads a precomputed (n, n) stream of
element coefficients Q instead (bfloat16 by default, or float32), and runs
the plain-form operator with no residual norm:

    out = u + (omega/d)(f - A_Q u) at interior nodes, u elsewhere,
    d = (2/3) (sum of the 4 element Q around the node).

bf16 holds the coefficient pair (1, 20) exactly, so there the sweep equals
A1's plain-form sweep; other coefficients round to bf16 (~3 digits).
Elements outside the domain count as Q = 0 (they touch boundary nodes
only, whose residual is zero).

One kernel, hand-written in CUDA C++ (``csrc/qsweep.cu``):

====  ===============  ============================================
name  C entry point    replaces
====  ===============  ============================================
F1    ``mg_qsweep``    ``pallas_qsweep.py:42 _qsweep_kernel``
====  ===============  ============================================

:func:`qsweep_cuda` launches it, :func:`qsweep_plain` is its plain PyTorch
version with the same signature, and the level-facing :func:`qsweep` takes
the plain version for CPU tensors and the kernel for CUDA ones (or raises).
They agree to ``ops.sweep.TOL``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from multigrid_feanet_torch.core.device import resolve_device
from multigrid_feanet_torch.ops import sweep as sw

TOL = sw.TOL
_QTYPES = (torch.bfloat16, torch.float32)


def make_q(phase, coefficients=(1.0, 20.0), dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """The (n, n) element-coefficient stream Q = a0 + (a1 - a0) * phase, in
    ``dtype`` on ``device`` (``pallas_qsweep.py``'s ``make_q_pad`` without the
    TPU layout).  ``device=None`` means CUDA."""
    a0, a1 = (float(c) for c in coefficients)
    q = np.asarray(phase, np.float32) * np.float32(a1 - a0) + np.float32(a0)
    return torch.as_tensor(q, device=resolve_device(device)).to(dtype).contiguous()


def qsweep_plain(u, f, q, *, omega, out=None):
    """F1: one plain-form weighted-Jacobi sweep with the element
    coefficients ``q`` -> out."""
    mask = sw._interior(u)
    Qp = F.pad(q.to(torch.float32), (1, 1, 1, 1))
    au, C4 = sw._apply_bim(u, Qp)
    r = torch.where(mask, f - au, 0.0)
    return sw._emit(u + (omega / sw._diag_bim(C4)) * r, out)


_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
KERNELS = {
    "F1": sw.CudaKernel("F1_qsweep", "mg_qsweep", [_P, _P, _P, _P, _I, _D, _I, _P],
                        "multigrid_feanet_tpu/ops/pallas_qsweep.py:42",
                        "multigrid_feanet_torch/csrc/qsweep.cu"),
}


def qsweep_cuda(u, f, q, *, omega, out=None):
    """F1 on the card; same contract as :func:`qsweep_plain`."""
    n, dev = u.shape[0] - 1, u.device
    sw._operands(n, dev, [("u", u), ("f", f)])
    if q.dtype not in _QTYPES:
        raise ValueError(f"q must be bfloat16 or float32, not {q.dtype}")
    sw._check(q, "q", (n, n), q.dtype, dev)
    out = sw._output(out, "out", (n + 1, n + 1), dev, (u, f))
    KERNELS["F1"](u.data_ptr(), f.data_ptr(), q.data_ptr(), out.data_ptr(), n, omega,
                  int(q.dtype == torch.bfloat16), sw._stream(dev))
    return out


def qsweep(level: sw.SweepLevel, u, f, q, out=None):
    """One weighted-Jacobi sweep with the Q-stream operator and the
    level's omega -> u_new."""
    fn = qsweep_cuda if u.is_cuda else qsweep_plain
    return fn(u, f, q, omega=level.omega, out=out)
