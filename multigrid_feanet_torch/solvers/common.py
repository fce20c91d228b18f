"""Shared convention of the fused solvers.

Each cycle's first fused sweep emits the squared interior residual norm of
its INCOMING iterate, so the solve loop needs no extra residual pass; the
cost is a one-cycle lag.  :func:`trim_history` turns the raw device history
into the shared convention, as in ``multigrid_feanet_tpu/solvers/common.py``:

- ``history[j]`` = interior residual norm after cycle ``j + 1``;
- ``len(history)`` = cycles to reach ``eps`` (or the recorded cap);
- the returned ``u`` includes at least one extra cycle beyond
  ``history[-1]`` (plus up to ``chunk - 1`` more when chunked).
"""

from __future__ import annotations

import numpy as np

__all__ = ["trim_history"]


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
