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
to ``ops.sweep.TOL``.  H1 streams rows (``csrc/torus.cu``): the wrapper
launches it on the bands and strips of :func:`h1_tiles`, with the strip
height ``ops.hrelax.row_strip`` picks for the level's size and the card's
occupancy, and grids of up to ``H1_ONE_PASS_MAX_N`` on one-pass tiles
(:func:`h1_launch_tiles`); u and f must start on a 16-byte boundary.
"""

from __future__ import annotations

import torch

from multigrid_feanet_torch.core.device import resolve_device
from multigrid_feanet_torch.ops.hrelax import occupancy, row_scratch, row_strip
from multigrid_feanet_torch.ops.pbc import wrap_pad
from multigrid_feanet_torch.ops.sweep import (
    A12_COLUMNS, A12_THREADS, CudaKernel, Tiles, _I, _D, _P, _check, _check_aligned,
    _check_strip, _emit, _output, _scalar_out, _stream)

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
    # u f out partial done rsq rsq_wrap; n a0 omega; one_pass strip gx gy; stream
    "H1": CudaKernel("H1_torus_relax", "mg_torus", [_P] * 7 + [_I, _D, _D] + [_I] * 4 + [_P],
                     "multigrid_feanet_tpu/ops/pallas_torus.py:32", _SOURCE),
}

# steps an H1 block takes beyond its strip's rows: the u rows above and below
H1_HALO_STEPS = 2
# grids of up to this many nodes per side run H1 on one-pass tiles
# (csrc/torus.cu h1_torus_tile, 32 x 8 nodes a block): one wave holds the
# grid there, and a row-streaming strip's chain of steps takes longer.  The
# largest level at which the tile was the faster on the H100
# (``sweep_vs_parent.py --crossover``, PERF.md)
H1_ONE_PASS_MAX_N = 512


def h1_tiles(n: int, strip: int = 32) -> Tiles:
    """H1: a block owns the ``A12_THREADS A12_COLUMNS`` columns its threads
    cover (the halo columns wrap) and a strip of the n rows."""
    _check_strip(strip)
    band = A12_THREADS * A12_COLUMNS
    return Tiles("H1", n, band, strip, -(-n // band), -(-n // strip))


def h1_one_pass_tiles(n: int) -> Tiles:
    """H1 on one-pass tiles: one block (of one thread per node) per 32 x 8
    tile of nodes (csrc/common.cuh's TX x TY)."""
    return Tiles("H1_tile", n, 32, 8, -(-n // 32), -(-n // 8))


_H1_TILES = {}


def h1_launch_tiles(n: int, device) -> Tiles:
    """The geometry H1 launches with on ``device``: one-pass tiles up to
    ``H1_ONE_PASS_MAX_N``, else row-streaming strips of ``row_strip``'s
    height for the occupancy the card reports (computed once per grid
    size)."""
    if n <= H1_ONE_PASS_MAX_N:
        return h1_one_pass_tiles(n)
    key = (n, device.index)
    tiles = _H1_TILES.get(key)
    if tiles is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        slots = sms * occupancy("mg_torus_occupancy")
        tiles = h1_tiles(n, row_strip(lambda s: h1_tiles(n, s), H1_HALO_STEPS, slots, sms))
        _H1_TILES[key] = tiles
    return tiles


def torus_sweep_cuda(u, f, *, a0, omega, out=None, rsq=None, rsq_wrap=None, workspace=None):
    """H1 on the card; same contract as :func:`torus_sweep_plain`, and u and
    f must start on a 16-byte boundary (whole tensors do; an offset view may
    not, and raises ValueError)."""
    n, dev = u.shape[-1], u.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, not {dev} ones")
    if n < 2:
        raise ValueError(f"the torus grid needs n >= 2, got n={n}")
    for name, t in (("u", u), ("f", f)):
        _check(t, name, (n, n), torch.float32, dev)
    out = _output(out, "out", (n, n), dev, (u, f))
    rsq, rsq_wrap = _scalar_out(rsq, dev), _scalar_out(rsq_wrap, dev)
    _check_aligned(("u", u), ("f", f))
    tiles = h1_launch_tiles(n, dev)
    partial, done = row_scratch(tiles, 2, dev, workspace)
    KERNELS["H1"](u.data_ptr(), f.data_ptr(), out.data_ptr(), partial.data_ptr(),
                  done.data_ptr(), rsq.data_ptr(), rsq_wrap.data_ptr(), n, a0, omega,
                  int(tiles.leg == "H1_tile"), tiles.strip, tiles.gx, tiles.gy, _stream(dev))
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
