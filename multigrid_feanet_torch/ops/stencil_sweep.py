"""Weighted-Jacobi sweeps of the two-phase Q1 operator in bitplane form.

Port of ``multigrid_feanet_tpu/ops/pallas_stencil.py``, the round-1 kernels
behind ``solvers/mg.py``.  Fields are compact row-major tensors: (n+1, n+1)
float32 node fields and the (n+1, n+1) int8 node pattern ids ``pid`` of
``core.problem.Level`` (bit e = phase of the node's element e, in the order
SW, SE, NW, NE); the TPU's ghost-block padding has no counterpart here.

The operator is the bitplane form

    A u = a0 S9(u) + da sum_e bit_e(pid) S4_e(u)

with the unit taps of ``ops/stencil.py`` (``UNIT_S9``, ``UNIT_S4``) and the
Jacobi diagonal (2/3) (4 a0 + da popcount(pid)); it has no difference form.

Two kernels, hand-written in CUDA C++ (``csrc/stencil.cu``):

====  ==================  ============================================  ==============
name  C entry point       replaces                                      level methods
====  ==================  ============================================  ==============
C1    ``st_relax``        ``pallas_stencil.py:122 _sweep_kernel``       sweep, residual
C2    ``st_multi``        ``pallas_stencil.py:364 _fused_sweeps_kernel``  sweep_k
====  ==================  ============================================  ==============

As in ``ops/sweep.py``, each has a wrapper ``<leg>_cuda`` and a plain
PyTorch version ``<leg>_plain`` with the same signature; tensors on the CPU
take the plain version, tensors on a CUDA device launch the kernel or raise.
Sweeps update interior nodes only (boundary nodes keep their value), the
residual is zero on the boundary, and ``rsq`` is the interior squared
residual norm of the incoming iterate (for ``sweep_k``: of the last sweep's
input, so it lags k - 1 sweeps behind the returned iterate).  The kernels
agree with their plain versions to ``ops.sweep.TOL``.

Each has two designs (``csrc/stencil.cu``), all four finishing the norm in
their last block: above ``C1_ONE_PASS_MAX_N`` C1's wrapper launches the
row-streaming kernel on the bands and strips of :func:`c1_tiles`, with the
strip height ``ops.hrelax.row_strip`` picks for the level's size and the
card's occupancy; at and below it the one-pass tiles of
:func:`c1_one_pass_tiles` (:func:`c1_launch_tiles` chooses).  C2 streams
its k sweeps as a wavefront for k up to ``C2_STREAM_MAX_K`` above
``C2_ONE_PASS_MAX_N[(bim, k)]`` (:func:`c2_tiles`), and runs its one-pass tiles
(:func:`c2_one_pass_tiles`) at and below it and for every deeper k
(:func:`c2_launch_tiles` chooses).  u, f and ``pid`` must start on a
16-byte boundary (whole tensors do; an offset view may not, and raises
ValueError).
"""

from __future__ import annotations

import torch

from multigrid_feanet_torch.core.device import resolve_device
from multigrid_feanet_torch.ops.hrelax import occupancy, row_scratch, row_strip
from multigrid_feanet_torch.ops.stencil import UNIT_S4, UNIT_S9
from multigrid_feanet_torch.ops.sweep import (
    A12_COLUMNS, A12_THREADS, CudaKernel, Tiles, _I, _D, _P, _check, _check_aligned,
    _check_strip, _emit, _interior, _operands, _output, _ptr, _scalar_out, _shifts, _stream)

_SOURCE = "multigrid_feanet_torch/csrc/stencil.cu"
MAX_FUSED = 8  # sweeps per pass of C2, as the TPU kernel


def _apply(u, pid, a0, da):
    """A u in bitplane form, in the Pallas kernel's order of operations:
    the S9 taps, then each element's S4 taps times da * bit_e."""
    U = _shifts(u)
    acc = None
    for (dr, dc), w in UNIT_S9.items():
        term = (a0 * w) * U(dr, dc)
        acc = term if acc is None else acc + term
    if pid is not None:
        p = pid.to(torch.int32)
        for e, taps in enumerate(UNIT_S4):
            bit = ((p >> e) & 1).to(torch.float32)
            t4 = None
            for (dr, dc), w in taps.items():
                term = w * U(dr, dc)
                t4 = term if t4 is None else t4 + term
            acc = acc + (da * bit) * t4
    return acc


def _diag(pid, a0, da, device):
    """Jacobi diagonal: per node when two-phase, an f32 scalar otherwise."""
    if pid is None:
        return torch.tensor(4.0 * (2.0 / 3.0) * a0, dtype=torch.float32, device=device)
    p = pid.to(torch.int32)
    nbits = ((p & 1) + ((p >> 1) & 1) + ((p >> 2) & 1) + ((p >> 3) & 1)).to(torch.float32)
    return (2.0 / 3.0) * (4.0 * a0 + da * nbits)


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the two kernels.
# ---------------------------------------------------------------------------


def relax_plain(u, f, pid=None, *, a0, da, omega, mode="sweep", out=None, rsq=None):
    """C1: one weighted-Jacobi sweep (``mode="sweep"``) or the masked
    residual (``mode="residual"``) -> (out, rsq of u)."""
    _check_mode(mode)
    r = torch.where(_interior(u), f - _apply(u, pid, a0, da), 0.0)
    res = r if mode == "residual" else u + (omega / _diag(pid, a0, da, u.device)) * r
    return _emit(res, out), _emit(torch.sum(r * r), rsq)


def multi_plain(u, f, pid=None, *, k, a0, da, omega, out=None, rsq=None):
    """C2: ``k`` chained C1 sweeps -> (u_k, rsq of the last sweep's input)."""
    _check_k(k)
    for _ in range(k):
        u, rsq0 = relax_plain(u, f, pid, a0=a0, da=da, omega=omega)
    return _emit(u, out), _emit(rsq0, rsq)


def _check_mode(mode):
    if mode not in ("sweep", "residual"):
        raise ValueError(f"mode must be 'sweep' or 'residual', not {mode!r}")


def _check_k(k):
    if not 1 <= k <= MAX_FUSED:
        raise ValueError(f"sweep_k fuses 1 to {MAX_FUSED} sweeps, not {k}")


# ---------------------------------------------------------------------------
# CUDA kernels: ctypes bindings, launch counts, wrappers.
# ---------------------------------------------------------------------------

KERNELS = {
    # u f pid out partial done rsq; n a0 da omega; bim mode one_pass strip gx gy; stream
    "C1": CudaKernel("C1_stencil_relax", "st_relax",
                     [_P] * 7 + [_I, _D, _D, _D] + [_I] * 6 + [_P],
                     "multigrid_feanet_tpu/ops/pallas_stencil.py:122", _SOURCE),
    # u f pid out partial done rsq; n a0 da omega; bim k one_pass strip gx gy; stream
    "C2": CudaKernel("C2_stencil_multi", "st_multi",
                     [_P] * 7 + [_I, _D, _D, _D] + [_I] * 6 + [_P],
                     "multigrid_feanet_tpu/ops/pallas_stencil.py:364", _SOURCE),
}

# steps a row-streaming C1 block takes beyond its strip's rows: the u rows
# above and below
C1_HALO_STEPS = 2
# levels of up to this many elements per side run C1 on one-pass tiles
# (csrc/stencil.cu c1_stencil_relax, 32 x 8 nodes a block): one wave holds
# the grid there, and a row-streaming strip's chain of steps takes longer.
# The largest level at which the tile was the faster on the H100
# (``sweep_vs_parent.py --crossover --legs c1e2``, PERF.md)
C1_ONE_PASS_MAX_N = 256


def c1_tiles(n: int, strip: int = 32) -> Tiles:
    """C1: a block owns the ``A12_THREADS A12_COLUMNS`` columns its threads
    cover and a strip of the (n+1) rows."""
    _check_strip(strip)
    H, band = n + 1, A12_THREADS * A12_COLUMNS
    return Tiles("C1", n, band, strip, -(-H // band), -(-H // strip))


def c1_one_pass_tiles(n: int) -> Tiles:
    """C1 on one-pass tiles: one block (of one thread per node) per 32 x 8
    tile of nodes (csrc/common.cuh's TX x TY)."""
    H = n + 1
    return Tiles("C1_tile", n, 32, 8, -(-H // 32), -(-H // 8))


_C1_TILES = {}


def c1_launch_tiles(n: int, bim: bool, mode: int, device) -> Tiles:
    """The geometry C1 launches with on ``device``: one-pass tiles up to
    ``C1_ONE_PASS_MAX_N``, else row-streaming strips of ``row_strip``'s
    height for the occupancy the card reports for the instance launched
    (computed once per level shape)."""
    if n <= C1_ONE_PASS_MAX_N:
        return c1_one_pass_tiles(n)
    key = (n, bool(bim), mode, device.index)
    tiles = _C1_TILES.get(key)
    if tiles is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        slots = sms * occupancy("st_relax_occupancy", int(bim), mode)
        tiles = c1_tiles(n, row_strip(lambda s: c1_tiles(n, s), C1_HALO_STEPS, slots, sms))
        _C1_TILES[key] = tiles
    return tiles


# the deepest chain of sweeps C2 streams (csrc/stencil.cu C2_STREAM_MAX_K):
# deeper chains run the one-pass tile at every size
C2_STREAM_MAX_K = 4
# levels of up to this many elements per side, by (bi-material, number of
# sweeps k), run C2 on one-pass tiles (csrc/stencil.cu c2_stencil_multi, 32
# x 32 nodes a block): the largest level at which the tile was the faster on
# the H100 (``sweep_vs_parent.py --crossover --legs e4c2``, PERF.md).  The
# bi-material sweeps' S4 taps lengthen a streamed step, so the two-phase
# chains stream only from larger levels on
C2_ONE_PASS_MAX_N = {(False, 1): 256, (False, 2): 256, (False, 3): 256, (False, 4): 512,
                     (True, 1): 512, (True, 2): 512, (True, 3): 1024, (True, 4): 1024}


def c2_halo_steps(k: int) -> int:
    """Steps a row-streaming C2 block takes beyond its strip's rows: the k
    u rows above and below it and the wavefront's lag of 2(k - 1) rows
    (each sweep reads rows the one before finished a step earlier)."""
    return 3 * k - 1


def c2_tiles(n: int, k: int, strip: int = 32) -> Tiles:
    """C2 with k chained sweeps: a block computes the ``A12_THREADS
    A12_COLUMNS`` columns its threads cover and owns ``A12_THREADS
    A12_COLUMNS - 2(k - 1)`` of them (every sweep after the first eats a
    column of halo on each side), and a strip of the (n+1) rows."""
    _check_strip(strip)
    H, band = n + 1, A12_THREADS * A12_COLUMNS - 2 * (k - 1)
    return Tiles("C2", n, band, strip, -(-H // band), -(-H // strip))


def c2_one_pass_tiles(n: int) -> Tiles:
    """C2 on one-pass tiles: one 256-thread block per 32 x 32 tile of nodes
    (csrc/common.cuh's MX x MY)."""
    H = n + 1
    return Tiles("C2_tile", n, 32, 32, -(-H // 32), -(-H // 32))


_C2_TILES = {}


def c2_launch_tiles(n: int, k: int, bim: bool, device) -> Tiles:
    """The geometry C2 launches with on ``device``: one-pass tiles up to
    ``C2_ONE_PASS_MAX_N[(bim, k)]`` and for every k above ``C2_STREAM_MAX_K``, else
    row-streaming strips of ``row_strip``'s height for the occupancy the
    card reports for the instance launched (computed once per level
    shape)."""
    if k > C2_STREAM_MAX_K or n <= C2_ONE_PASS_MAX_N[(bool(bim), k)]:
        return c2_one_pass_tiles(n)
    key = (n, k, bool(bim), device.index)
    tiles = _C2_TILES.get(key)
    if tiles is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        slots = sms * occupancy("st_multi_occupancy", int(bim), k)
        tiles = c2_tiles(n, k, row_strip(lambda s: c2_tiles(n, k, s), c2_halo_steps(k), slots,
                                         sms))
        _C2_TILES[key] = tiles
    return tiles


def _operands_c(u, f, pid, out, rsq):
    """Check one C1 or C2 launch's operands; (n, device, out, rsq)."""
    n, dev = u.shape[0] - 1, u.device
    _operands(n, dev, [("u", u), ("f", f)])
    if pid is not None:
        _check(pid, "pid", (n + 1, n + 1), torch.int8, dev)
    return n, dev, _output(out, "out", (n + 1, n + 1), dev, (u, f)), _scalar_out(rsq, dev)


def relax_cuda(u, f, pid=None, *, a0, da, omega, mode="sweep", out=None, rsq=None,
               workspace=None):
    """C1 on the card; same contract as :func:`relax_plain`, and u, f and
    ``pid`` must start on a 16-byte boundary (whole tensors do; an offset
    view may not, and raises ValueError)."""
    _check_mode(mode)
    n, dev, out, rsq = _operands_c(u, f, pid, out, rsq)
    _check_aligned(("u", u), ("f", f), ("pid", pid))
    m = 0 if mode == "sweep" else 1
    tiles = c1_launch_tiles(n, pid is not None, m, dev)
    partial, done = row_scratch(tiles, 1, dev, workspace)
    KERNELS["C1"](u.data_ptr(), f.data_ptr(), _ptr(pid), out.data_ptr(), partial.data_ptr(),
                  done.data_ptr(), rsq.data_ptr(), n, a0, da, omega, int(pid is not None), m,
                  int(tiles.leg == "C1_tile"), tiles.strip, tiles.gx, tiles.gy, _stream(dev))
    return out, rsq


def multi_cuda(u, f, pid=None, *, k, a0, da, omega, out=None, rsq=None, workspace=None):
    """C2 on the card; same contract as :func:`multi_plain`, and u, f and
    ``pid`` must start on a 16-byte boundary (whole tensors do; an offset
    view may not, and raises ValueError).  k up to ``C2_STREAM_MAX_K``
    streams above ``C2_ONE_PASS_MAX_N[(bim, k)]``; deeper k runs the
    one-pass tile at every size."""
    _check_k(k)
    n, dev, out, rsq = _operands_c(u, f, pid, out, rsq)
    _check_aligned(("u", u), ("f", f), ("pid", pid))
    tiles = c2_launch_tiles(n, k, pid is not None, dev)
    partial, done = row_scratch(tiles, 1, dev, workspace)
    KERNELS["C2"](u.data_ptr(), f.data_ptr(), _ptr(pid), out.data_ptr(), partial.data_ptr(),
                  done.data_ptr(), rsq.data_ptr(), n, a0, da, omega, int(pid is not None),
                  int(k), int(tiles.leg == "C2_tile"), tiles.strip, tiles.gx, tiles.gy,
                  _stream(dev))
    return out, rsq


# ---------------------------------------------------------------------------
# Level object.
# ---------------------------------------------------------------------------


class StencilLevel:
    """The two kernels bound to one level's operator; counterpart of
    ``PallasStencil`` on compact fields (no ``pad``/``unpad``).

    ``pid`` is the level's (n+1, n+1) int8 pattern-id field (None =
    homogeneous, coefficient ``coefficients[0]``).  Methods take optional
    ``out`` and ``rsq`` buffers; ``device=None`` means CUDA."""

    def __init__(self, n: int, pid=None, coefficients=(1.0, 20.0),
                 omega: float = 2.0 / 3.0, device=None):
        self.device = resolve_device(device)
        self.n = int(n)
        self.a0 = float(coefficients[0])
        self.da = (float(coefficients[1]) - float(coefficients[0])
                   if pid is not None else 0.0)
        self.omega = float(omega)
        self.pid = (None if pid is None else torch.as_tensor(
            pid, dtype=torch.int8, device=self.device).contiguous())
        self._workspace = {}

    def _call(self, cuda_fn, plain_fn, u, f, **kw):
        kw.update(a0=self.a0, da=self.da, omega=self.omega)
        if not u.is_cuda:
            return plain_fn(u, f, self.pid, **kw)
        return cuda_fn(u, f, self.pid, workspace=self._workspace, **kw)

    def sweep(self, u, f, out=None, rsq=None):
        """One weighted-Jacobi sweep -> (u_new, rsq of u)."""
        return self._call(relax_cuda, relax_plain, u, f, out=out, rsq=rsq)

    def residual(self, u, f, out=None, rsq=None):
        """Interior-masked residual f - A u -> (r, ||r||^2)."""
        return self._call(relax_cuda, relax_plain, u, f, mode="residual", out=out, rsq=rsq)

    def sweep_k(self, u, f, k: int, out=None, rsq=None):
        """``k`` <= 8 sweeps in one pass -> (u_k, rsq of the last sweep's
        input, lagging k - 1 sweeps)."""
        return self._call(multi_cuda, multi_plain, u, f, k=k, out=out, rsq=rsq)
