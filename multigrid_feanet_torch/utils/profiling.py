"""Timing and tracing helpers: structured timing of a callable, per-kernel
roofline numbers (nnz/s, effective memory GB/s) and torch.profiler traces.

Port of ``multigrid_feanet_tpu/utils/profiling.py``.  ``time_callable``
times with CUDA events when the callable returns CUDA tensors and with the
host clock otherwise; ``trace`` writes a Chrome trace and, unlike the JAX
helper, lets a profiler failure propagate.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass
class KernelStats:
    name: str
    seconds_per_call: float
    nnz_per_s: float | None = None
    effective_gbps: float | None = None

    def as_dict(self):
        return dataclasses.asdict(self)


def _tensors(out):
    """The tensors in a (nested) tuple, list or dict output."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in _tensors(x)]
    return []


def time_callable(fn: Callable, *args, iters: int = 100, warmup: int = 1) -> float:
    """Mean seconds per call of ``fn(*args)`` over ``iters`` calls after
    ``warmup`` calls.  When the output holds CUDA tensors the calls are
    bracketed by CUDA events on the current stream (the device's clock);
    otherwise by the host clock.  The callable should amortize its own
    per-call overhead where that matters."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if out is None:
        out = fn(*args)
    if any(t.is_cuda for t in _tensors(out)):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


def stencil_roofline(n: int, seconds_per_sweep: float, bytes_per_node: float = 13.0,
                     name: str = "stencil_sweep") -> KernelStats:
    """nnz/s and effective memory bandwidth of one fused sweep over an
    (n+1)^2 grid with 9-point interior rows."""
    nnz = 9 * (n - 1) * (n - 1)
    nodes = (n + 1) * (n + 1)
    return KernelStats(
        name=name,
        seconds_per_call=seconds_per_sweep,
        nnz_per_s=nnz / seconds_per_sweep,
        effective_gbps=bytes_per_node * nodes / seconds_per_sweep / 1e9,
    )


@contextlib.contextmanager
def trace(logdir: str | None):
    """A torch.profiler context that writes ``trace.json`` (Chrome trace
    format) into ``logdir``, recording the CPU and, when there is one, the
    CUDA device; yields the profiler.  ``logdir=None`` is a no-op (yields
    None).  Profiler errors propagate."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def divergence_guard(res: float) -> bool:
    """True if the iteration has diverged (inf or nan residual), the
    reference's guard."""
    return not np.isfinite(res)
