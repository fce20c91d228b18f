"""Shared convention of the fused solvers.

Each cycle's first fused sweep emits the squared interior residual norm of
its INCOMING iterate, so the solve loop needs no extra residual pass; the
cost is a one-cycle lag.  :func:`trim_history` turns the raw device history
into the shared convention, as in ``multigrid_feanet_tpu/solvers/common.py``:

- ``history[j]`` = interior residual norm after cycle ``j + 1``;
- ``len(history)`` = cycles to reach ``eps`` (or the recorded cap);
- the returned ``u`` includes at least one extra cycle beyond
  ``history[-1]`` (plus up to ``chunk - 1`` more when chunked).

:func:`solve_cycles` is the solve loop both fused solvers run on it.
"""

from __future__ import annotations

import numpy as np
import torch

from multigrid_feanet_torch.core.geometry import reset_boundary

__all__ = ["solve_cycles", "trim_history"]


def trim_history(hist, eps: float) -> np.ndarray:
    """Trim a raw residual history to the shared convention.

    ``hist[i]`` = interior residual norm after ``i`` cycles (``hist[0]`` =
    the initial residual), with -1.0 sentinels marking never-written
    entries.  Returns ``history[j]`` = residual after cycle ``j + 1``, cut at
    the first entry ``<= eps``."""
    vals = np.asarray(hist)
    k = int(np.sum(vals >= 0.0))
    below = np.nonzero(vals[:k] <= eps)[0]
    c = int(below[0]) if below.size else k - 1
    return vals[1 : c + 1]


def solve_cycles(cycle, finest, f, u0=None, bc_value=None, eps: float = 1e-6,
                 max_cycles: int = 100, chunk: int = 1):
    """Run ``cycle(u, spare, f, rsq) -> (u_new, spare_new)`` on the finest
    level until the residual norm reaches ``eps``.

    ``cycle`` writes into ``rsq`` the squared interior residual norm of the
    iterate ENTERING it.  ``f`` is the (..., n+1, n+1) RHS (tensor or
    array; a scalar field, or the (2, n+1, n+1) displacement RHS of the
    elastic solver) and ``u0`` the initial iterate of the same shape (zero
    if None), whose boundary is set to ``bc_value``.  The history stays on
    the device, with -1 sentinels, and is read back once per ``chunk``
    cycles: one host sync per chunk.
    Returns ``(u, history)`` in the convention of :func:`trim_history`."""
    dev = finest.device
    f = torch.as_tensor(f, dtype=torch.float32, device=dev).contiguous()
    if u0 is None:
        u0 = torch.zeros_like(f)
    u0 = torch.as_tensor(u0, dtype=torch.float32, device=dev)
    u = reset_boundary(u0, finest.geo, 0.0 if bc_value is None else bc_value).contiguous()
    sp = torch.empty_like(u)
    rsq = torch.empty((), dtype=torch.float32, device=dev)
    hist = torch.full((max_cycles + chunk,), -1.0, dtype=torch.float32, device=dev)
    eps32 = float(np.float32(eps))  # the f32 comparison of the JAX loop
    k, res = 0, float("inf")
    while res > eps32 and k < max_cycles:
        for _ in range(chunk):
            u, sp = cycle(u, sp, f, rsq)
            # rsq is the residual of the state ENTERING this cycle, i.e.
            # after k completed cycles
            torch.sqrt(rsq, out=hist[k])
            k += 1
        res = float(hist[k - 1])
    return u, trim_history(hist.cpu().numpy(), eps)
