"""Device-memory bandwidth anchors: copy and triad.

Port of ``multigrid_feanet_tpu/ops/pallas_membench.py``.  A sweep's
"effective GB/s" means something only beside the rate the card reaches
streaming float32 fields of the sweep's size:

- copy, out = in + 1 (8 B per element: one read, one write), the streaming
  rate (the +1 makes each launch's values new);
- triad, out = a + 0.5 b (12 B per element: two reads, one write), the
  Jacobi sweep's stream count with no stencil math.

Two kernels, hand-written in CUDA C++ (``csrc/membench.cu``):

====  ==============  ===============================================
name  C entry point   replaces
====  ==============  ===============================================
B1    ``mb_copy``     ``pallas_membench.py:33 _copy_kernel``
B2    ``mb_triad``    ``pallas_membench.py:40 _triad_kernel``
====  ==============  ===============================================

Each has a wrapper ``<op>_cuda`` and a plain PyTorch version ``<op>_plain``;
CPU tensors take the plain version, and the two agree bitwise.
:func:`copy_gbps` and :func:`triad_gbps` measure the rates: on the card
from CUDA events around ``reps`` launches replayed from a CUDA graph, the
buffers ping-ponging as the JAX package's scan does; on the CPU (``device=
"cpu"``) from the host clock around the plain versions.
"""

from __future__ import annotations

import ctypes
import time

import torch

from multigrid_feanet_torch.core.device import resolve_device
from multigrid_feanet_torch.ops import sweep as sw

_P, _L = ctypes.c_void_p, ctypes.c_longlong
_SOURCE = "multigrid_feanet_torch/csrc/membench.cu"
_REPLACES = "multigrid_feanet_tpu/ops/pallas_membench.py:"
KERNELS = {
    "B1": sw.CudaKernel("B1_copy", "mb_copy", [_P, _P, _L, _P], _REPLACES + "33", _SOURCE),
    "B2": sw.CudaKernel("B2_triad", "mb_triad", [_P, _P, _P, _L, _P], _REPLACES + "40", _SOURCE),
}


def copy_plain(x, out=None):
    """B1: x + 1."""
    return sw._emit(x + 1.0, out)


def triad_plain(a, b, out=None):
    """B2: a + 0.5 b."""
    return sw._emit(a + 0.5 * b, out)


def _field(t, name, like):
    """Check a contiguous float32 CUDA field (of ``like``'s shape), 16-byte
    aligned for the kernels' vector loads."""
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, not {t.device} ones")
    sw._check(t, name, like.shape, torch.float32, like.device)
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def copy_cuda(x, out=None):
    """B1 on the card; same contract as :func:`copy_plain`."""
    _field(x, "x", x)
    out = torch.empty_like(x) if out is None else out
    _field(out, "out", x)
    KERNELS["B1"](x.data_ptr(), out.data_ptr(), x.numel(), sw._stream(x.device))
    return out


def triad_cuda(a, b, out=None):
    """B2 on the card; same contract as :func:`triad_plain`."""
    _field(a, "a", a)
    _field(b, "b", a)
    out = torch.empty_like(a) if out is None else out
    _field(out, "out", a)
    KERNELS["B2"](a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), sw._stream(a.device))
    return out


def _seconds_per_launch(launches, reps: int, device) -> float:
    """Time of one of ``launches`` (closures, run in turn ``reps`` times):
    on the card the device time of a CUDA-graph replay over ``reps``, the
    least of 3; on the CPU the host time, the least of 3."""
    for launch in launches:  # loads the kernels; warms the caches
        launch()
    best = float("inf")
    if device.type != "cuda":
        for _ in range(3):
            t0 = time.perf_counter()
            for i in range(reps):
                launches[i % len(launches)]()
            best = min(best, time.perf_counter() - t0)
        return best / reps
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            launches[i % len(launches)]()
    graph.replay()
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize(device)
        best = min(best, a.elapsed_time(b) / 1e3)
    return best / reps


def _fields(count, rows, cols, device):
    gen = torch.Generator().manual_seed(0)
    return [torch.randn((rows, cols), generator=gen).to(device) for _ in range(count)]


def copy_gbps(rows: int = 4097, cols: int = 4097, reps: int = 50, device=None) -> float:
    """Streaming rate (GB/s, read + write) of the copy on (rows, cols)
    float32 fields, two buffers ping-ponging.  ``device=None`` means CUDA."""
    device = resolve_device(device)
    a, b = _fields(2, rows, cols, device)
    fn = copy_cuda if device.type == "cuda" else copy_plain
    dt = _seconds_per_launch([lambda: fn(a, out=b), lambda: fn(b, out=a)], reps, device)
    return 8.0 * rows * cols / dt / 1e9


def triad_gbps(rows: int = 4097, cols: int = 4097, reps: int = 50, device=None) -> float:
    """Rate (GB/s, two reads + one write) of the triad on (rows, cols)
    float32 fields, three buffers rotating so that each launch reads the
    last two results.  ``device=None`` means CUDA."""
    device = resolve_device(device)
    a, b, c = _fields(3, rows, cols, device)
    fn = triad_cuda if device.type == "cuda" else triad_plain
    launches = [lambda: fn(a, b, out=c), lambda: fn(c, b, out=a), lambda: fn(a, c, out=b)]
    dt = _seconds_per_launch(launches, reps, device)
    return 12.0 * rows * cols / dt / 1e9
