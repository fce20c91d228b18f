"""Weighted-Jacobi sweep on the periodic (torus) grid, kernel H1.

Port of ``multigrid_feanet_tpu/ops/pallas_torus.py``.  Fields are the unique
n x n torus grid as plain row-major float32 tensors; the TPU kernel's
ghost-block layout, its wrap-row refresh and its ``n % 128 == 0`` lane rule
have no counterpart here: any n >= 2 works.

====  ============  ==============================================  ==========
name  C entry point replaces                                        method
====  ============  ==============================================  ==========
H1    ``mg_torus``  ``pallas_torus.py:32 _torus_sweep_kernel``      sweep
====  ============  ==============================================  ==========

One sweep of the homogeneous operator a0 S9, u_new = u + (omega/d)(f - A u)
with d = (8/3) a0, at every node (no mask).  Besides the TPU kernel's
pre-update ``rsq`` over the unique grid, H1 emits ``rsq_wrap``: the extra
terms sum_j r[0, j]^2 + sum_i r[i, 0]^2 + r[0, 0]^2 of the reference's
norm over the (n+1)^2 wrapped grid (``ops/pbc.py::pbc_interior_norm``), so
that ``rsq + rsq_wrap`` is the wrapped norm^2 and the periodic Jacobi
history rides the free norms.

As in ``ops/sweep.py``, the wrapper ``torus_sweep_cuda`` launches the kernel
for CUDA tensors and raises on what it does not take; the plain PyTorch
version ``torus_sweep_plain`` (``ops/pbc.py::jacobi_step_pbc`` plus both
sums, in the kernel's order of operations) serves CPU tensors.  They agree
to ``ops.sweep.TOL``.
"""

from __future__ import annotations

import torch

from multigrid_feanet_torch import _build
from multigrid_feanet_torch.core.device import resolve_device
from multigrid_feanet_torch.ops.pbc import wrap_pad
from multigrid_feanet_torch.ops.sweep import (
    CudaKernel, _I, _D, _P, _check, _emit, _output, _scalar_out, _stream)

_SOURCE = "multigrid_feanet_torch/csrc/torus.cu"


def torus_sweep_plain(u, f, *, a0, omega, out=None, rsq=None, rsq_wrap=None):
    """H1's plain version -> (u_new, rsq, rsq_wrap)."""
    n = u.shape[-1]
    up = wrap_pad(u)

    def U(di, dj):
        return up[1 + di : 1 + di + n, 1 + dj : 1 + dj + n]

    t3 = {x: (U(x, 0) + U(x, 1)) + U(x, -1) for x in (-1, 0, 1)}
    au = (3.0 * a0) * U(0, 0) - (a0 / 3.0) * ((t3[-1] + t3[0]) + t3[1])
    r = f - au
    d = torch.tensor((8.0 / 3.0) * a0, dtype=u.dtype, device=u.device)
    r2 = r * r
    wrap = (torch.sum(r2[0]) + torch.sum(r2[:, 0])) + r2[0, 0]
    return _emit(u + (omega / d) * r, out), _emit(torch.sum(r2), rsq), _emit(wrap, rsq_wrap)


KERNELS = {
    "H1": CudaKernel("H1_torus_relax", "mg_torus", [_P, _P, _P, _P, _P, _P, _I, _D, _D, _P],
                     "multigrid_feanet_tpu/ops/pallas_torus.py:32", _SOURCE),
}


def _partials(n: int, device, workspace) -> torch.Tensor:
    key = ("torus_partials", n)
    buf = None if workspace is None else workspace.get(key)
    if buf is None:
        fn = _build.load().mg_torus_partials
        fn.argtypes, fn.restype = [_I], _I
        buf = torch.empty(fn(n), dtype=torch.float32, device=device)
        if workspace is not None:
            workspace[key] = buf
    return buf


def torus_sweep_cuda(u, f, *, a0, omega, out=None, rsq=None, rsq_wrap=None, workspace=None):
    """H1 on the card; same contract as :func:`torus_sweep_plain`."""
    n, dev = u.shape[-1], u.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, not {dev} ones")
    if n < 2:
        raise ValueError(f"the torus grid needs n >= 2, got n={n}")
    for name, t in (("u", u), ("f", f)):
        _check(t, name, (n, n), torch.float32, dev)
    out = _output(out, "out", (n, n), dev, (u, f))
    rsq, rsq_wrap = _scalar_out(rsq, dev), _scalar_out(rsq_wrap, dev)
    KERNELS["H1"](u.data_ptr(), f.data_ptr(), out.data_ptr(),
                  _partials(n, dev, workspace).data_ptr(), rsq.data_ptr(), rsq_wrap.data_ptr(),
                  n, a0, omega, _stream(dev))
    return out, rsq, rsq_wrap


class TorusLevel:
    """H1 bound to one periodic level of n x n unique nodes; counterpart of
    ``PallasTorusLevel`` on plain fields (no ``pad``/``unpad``).
    ``device=None`` means CUDA."""

    def __init__(self, n: int, a0: float = 1.0, omega: float = 2.0 / 3.0, device=None):
        self.device = resolve_device(device)
        self.n = int(n)
        self.a0 = float(a0)
        self.omega = float(omega)
        self._workspace = {}

    def sweep(self, u, f, out=None, rsq=None, rsq_wrap=None):
        """One periodic weighted-Jacobi sweep -> (u_new, rsq, rsq_wrap) of
        the incoming u's residual."""
        kw = dict(a0=self.a0, omega=self.omega, out=out, rsq=rsq, rsq_wrap=rsq_wrap)
        if not u.is_cuda:
            return torus_sweep_plain(u, f, **kw)
        return torus_sweep_cuda(u, f, workspace=self._workspace, **kw)
