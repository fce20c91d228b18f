"""Checkpoints as ``.npz`` files: trees of arrays, and training resume.

Port of the ``.npz`` branch of ``multigrid_feanet_tpu/utils/checkpoint.py``.
A checkpoint is a flat numpy archive of leaves ``leaf_0``, ``leaf_1``, ...
in the tree's flatten order (``jax.tree.flatten``'s: dict entries by sorted
key, lists and tuples in order, None holds no leaf) and a ``__treedef__``
string that describes the tree (``PyTreeDef(*)`` for a single array, as the
JAX package writes it).  So the H-Net checkpoints under
``results/learn_iterator/`` (one leaf, the (L, 3, 3) kernels) load here, and
a params-only file written here loads with the JAX package's ``load``.
Leaves are numpy arrays, tensors or numbers; Orbax checkpoint directories
are not read.  The training state of ``learn/train_hnet.py`` goes through
:func:`save_training` / :func:`load_training` as a tree of its tensors.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


def _flatten(tree) -> tuple[list, str]:
    """(leaves, structure) of ``tree`` in ``jax.tree.flatten``'s order."""
    if tree is None:
        return [], "None"
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        body = ", ".join(f"{k!r}: {s}" for k, (_, s) in zip(keys, parts))
        return [x for leaves, _ in parts for x in leaves], "{" + body + "}"
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(t) for t in tree]
        body = ", ".join(s for _, s in parts)
        return [x for leaves, _ in parts for x in leaves], f"[{body}]" if isinstance(
            tree, list) else f"({body})"
    return [tree], "*"


def _as_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _unflatten(like, leaves):
    """``like``'s tree with its leaves taken in order from the iterator
    ``leaves``; a tensor leaf of ``like`` gives a tensor of its dtype on its
    device, any other leaf a numpy array."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        items = [_unflatten(t, leaves) for t in like]
        return items if isinstance(like, list) else tuple(items)
    leaf = next(leaves)
    if torch.is_tensor(like):
        return torch.as_tensor(leaf, dtype=like.dtype, device=like.device)
    return leaf


def save(path, tree: Any) -> None:
    """Write ``tree`` to the ``.npz`` file at ``path``."""
    path = os.fspath(path)
    if not path.endswith(".npz"):
        raise ValueError(f"{path} is not a .npz path: the port writes .npz checkpoints only")
    leaves, structure = _flatten(tree)
    np.savez(path, __treedef__=np.frombuffer(f"PyTreeDef({structure})".encode(), dtype=np.uint8),
             **{f"leaf_{i}": _as_numpy(leaf) for i, leaf in enumerate(leaves)})


def load(path, like: Any = None):
    """The leaves of the ``.npz`` checkpoint at ``path``, in order, as numpy
    arrays; with ``like``, the tree of ``like``'s structure built from them.
    Raises ValueError for a directory (the Orbax form) or for any path that
    is not a ``.npz`` file."""
    path = os.fspath(path)
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory: Orbax checkpoints are not read by the "
                         "port; save the tree as .npz with the JAX package's "
                         "utils.checkpoint.save")
    if not path.endswith(".npz"):
        raise ValueError(f"{path} is not a .npz checkpoint")
    with np.load(path) as data:
        n = len([k for k in data.files if k.startswith("leaf_")])
        leaves = [data[f"leaf_{i}"] for i in range(n)]
    if like is None:
        return leaves
    want = len(_flatten(like)[0])
    if want != n:
        raise ValueError(f"{path} holds {n} leaves, the tree to load takes {want}")
    return _unflatten(like, iter(leaves))


def save_training(ckpt_dir, tree: Any, epoch: int, losses) -> None:
    """Per-epoch training checkpoint: writes ``{ckpt_dir}/latest.npz``
    atomically with (the training state's tree, epochs completed, loss
    history)."""
    ckpt_dir = os.fspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, ".latest.tmp.npz")
    save(tmp, {"state": tree, "epoch": np.asarray(epoch),
               "losses": np.asarray(losses, np.float64)})
    os.replace(tmp, os.path.join(ckpt_dir, "latest.npz"))


def load_training(ckpt_dir, like: Any):
    """Resume from :func:`save_training`: ``(tree, start_epoch, losses)``
    with the tree in ``like``'s structure, or ``(like, 0, [])`` when no
    checkpoint exists."""
    path = os.path.join(os.fspath(ckpt_dir), "latest.npz")
    if not os.path.exists(path):
        return like, 0, []
    tree = load(path, like={"state": like, "epoch": np.asarray(0), "losses": np.zeros(0)})
    return tree["state"], int(tree["epoch"]), [float(x) for x in tree["losses"]]
