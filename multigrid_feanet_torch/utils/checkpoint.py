"""Read the repository's ``.npz`` checkpoints.

Port of the ``.npz`` branch of ``multigrid_feanet_tpu/utils/checkpoint.py``
``load``: a checkpoint is a flat numpy archive of leaves ``leaf_0``,
``leaf_1``, ... in the saved tree's flatten order (plus a ``__treedef__``
string this reader does not need).  The H-Net checkpoints under
``results/learn_iterator/`` hold one leaf, the (L, 3, 3) float32 kernels.
Only numpy is used.  Orbax checkpoint directories, and writing checkpoints
(``save``, ``save_training``, ``load_training``), come with the training
slice of the port.
"""

from __future__ import annotations

import os

import numpy as np


def load(path) -> list:
    """The leaves of the ``.npz`` checkpoint at ``path``, in order, as numpy
    arrays.  Raises ValueError for a directory (the Orbax form) or for any
    path that is not a ``.npz`` file."""
    path = os.fspath(path)
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory: Orbax checkpoints are not read by the "
                         "port; save the tree as .npz with the JAX package's "
                         "utils.checkpoint.save")
    if not path.endswith(".npz"):
        raise ValueError(f"{path} is not a .npz checkpoint")
    with np.load(path) as data:
        n = len([k for k in data.files if k.startswith("leaf_")])
        return [data[f"leaf_{i}"] for i in range(n)]
