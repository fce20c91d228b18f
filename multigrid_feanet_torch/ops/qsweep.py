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
They agree to ``ops.sweep.TOL``.  F1 streams rows (``csrc/qsweep.cu``): the
wrapper launches it on the bands and strips of :func:`f1_tiles`, with the
strip height ``ops.hrelax.row_strip`` picks for the grid's size and the
card's occupancy, and grids of up to ``F1_ONE_PASS_MAX_N`` on one-pass tiles
(:func:`f1_launch_tiles`); u, f and Q must start on a 16-byte boundary.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from multigrid_feanet_torch.core.device import resolve_device
from multigrid_feanet_torch.ops import sweep as sw
from multigrid_feanet_torch.ops.hrelax import occupancy, row_strip

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
    # u f q out; n omega bf16; one_pass strip gx gy; stream
    "F1": sw.CudaKernel("F1_qsweep", "mg_qsweep", [_P] * 4 + [_I, _D] + [_I] * 5 + [_P],
                        "multigrid_feanet_tpu/ops/pallas_qsweep.py:42",
                        "multigrid_feanet_torch/csrc/qsweep.cu"),
}

# steps an F1 block takes beyond its strip's rows: the u rows above and below
F1_HALO_STEPS = 2
# grids of up to this many elements per side run F1 on one-pass tiles
# (csrc/qsweep.cu f1_qsweep, 32 x 8 nodes a block): one wave holds the grid
# there, and a row-streaming strip's chain of steps takes longer.  The
# largest size at which the tile was the faster on the H100
# (``sweep_vs_parent.py --crossover``, PERF.md)
F1_ONE_PASS_MAX_N = 256


def f1_tiles(n: int, strip: int = sw.A12_STRIP) -> sw.Tiles:
    """F1: a block owns the ``A12_THREADS A12_COLUMNS`` columns its threads
    cover and a strip of the n + 1 rows."""
    sw._check_strip(strip)
    H, band = n + 1, sw.A12_THREADS * sw.A12_COLUMNS
    return sw.Tiles("F1", n, band, strip, -(-H // band), -(-H // strip))


def f1_one_pass_tiles(n: int) -> sw.Tiles:
    """F1 on one-pass tiles: one block (of one thread per node) per 32 x 8
    tile of nodes (csrc/common.cuh's TX x TY)."""
    H = n + 1
    return sw.Tiles("F1_tile", n, 32, 8, -(-H // 32), -(-H // 8))


_F1_TILES = {}


def f1_launch_tiles(n: int, bf16: bool, device) -> sw.Tiles:
    """The geometry F1 launches with on ``device``: one-pass tiles up to
    ``F1_ONE_PASS_MAX_N``, else row-streaming strips of ``row_strip``'s
    height for the occupancy the card reports for the instance launched
    (bf16 or float32 Q; computed once per grid size)."""
    if n <= F1_ONE_PASS_MAX_N:
        return f1_one_pass_tiles(n)
    key = (n, bool(bf16), device.index)
    tiles = _F1_TILES.get(key)
    if tiles is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        slots = sms * occupancy("mg_qsweep_occupancy", int(bf16))
        tiles = f1_tiles(n, row_strip(lambda s: f1_tiles(n, s), F1_HALO_STEPS, slots, sms))
        _F1_TILES[key] = tiles
    return tiles


def qsweep_cuda(u, f, q, *, omega, out=None):
    """F1 on the card; same contract as :func:`qsweep_plain`, and u, f and
    q must start on a 16-byte boundary (whole tensors do; an offset view may
    not, and raises ValueError)."""
    n, dev = u.shape[0] - 1, u.device
    sw._operands(n, dev, [("u", u), ("f", f)])
    if q.dtype not in _QTYPES:
        raise ValueError(f"q must be bfloat16 or float32, not {q.dtype}")
    sw._check(q, "q", (n, n), q.dtype, dev)
    out = sw._output(out, "out", (n + 1, n + 1), dev, (u, f))
    sw._check_aligned(("u", u), ("f", f), ("q", q))
    bf16 = q.dtype == torch.bfloat16
    tiles = f1_launch_tiles(n, bf16, dev)
    KERNELS["F1"](u.data_ptr(), f.data_ptr(), q.data_ptr(), out.data_ptr(), n, omega,
                  int(bf16), int(tiles.leg == "F1_tile"), tiles.strip, tiles.gx, tiles.gy,
                  sw._stream(dev))
    return out


def qsweep(level: sw.SweepLevel, u, f, q, out=None):
    """One weighted-Jacobi sweep with the Q-stream operator and the
    level's omega -> u_new."""
    fn = qsweep_cuda if u.is_cuda else qsweep_plain
    return fn(u, f, q, omega=level.omega, out=out)
