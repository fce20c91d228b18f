"""Plotting utilities: the reference's ``Utils/plot.py`` figures (a field,
a pattern map) and the residual-history curve of its notebooks.

Port of ``multigrid_feanet_tpu/utils/plot.py``; matplotlib-based, imported
when a function is called.  Inputs may be tensors (on any device) or
arrays.
"""

from __future__ import annotations

import numpy as np


def _array(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def _finish(ax, fname):
    if fname:
        ax.figure.savefig(fname, dpi=500, bbox_inches="tight")
    return ax


def plot_field(field, limit=None, fname=None, ax=None, cmap="jet"):
    """Render a 2-D field (any (H, W) or (1, 1, H, W)-shaped input) as an
    image with a colorbar."""
    import matplotlib.pyplot as plt

    arr = _array(field)
    arr = arr.reshape(arr.shape[-2], arr.shape[-1])
    if ax is None:
        _, ax = plt.subplots()
    vmin, vmax = limit if limit is not None else (None, None)
    im = ax.imshow(arr, cmap=cmap, vmin=vmin, vmax=vmax, origin="lower")
    ax.figure.colorbar(im, ax=ax)
    return _finish(ax, fname)


def plot_pattern(pid, key=None, fname=None, ax=None):
    """Show the per-node pattern-id field, or the indicator of one pattern
    ``key``."""
    import matplotlib.pyplot as plt

    arr = _array(pid)
    if key is not None:
        arr = (arr == key).astype(np.float32)
    if ax is None:
        _, ax = plt.subplots()
    im = ax.imshow(arr, cmap="viridis", origin="lower")
    ax.figure.colorbar(im, ax=ax)
    return _finish(ax, fname)


def plot_residual_history(histories: dict, fname=None, ax=None):
    """Semilog residual-against-iteration curves, one per labelled history."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    for label, hist in histories.items():
        ax.plot(_array(hist), label=label)
    ax.set_yscale("log")
    ax.set_xlabel("# iteration")
    ax.set_ylabel("|r|")
    ax.legend()
    return _finish(ax, fname)
