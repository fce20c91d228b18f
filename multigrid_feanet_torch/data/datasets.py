"""HDF5 datasets, batching and the dataset generators.

Port of ``multigrid_feanet_tpu/data/datasets.py`` (the reference's
Data/dataset.py:6-104).  Each dataset is a container of numpy arrays with
``__len__`` / ``__getitem__``; :func:`batches` stacks them into tensors on
a device.  Field names and shapes mirror the reference's h5 layout, so the
repository's h5 files load unchanged.  ``h5py`` is imported only by the
functions that read or write h5 files.

The generators recreate the reference's missing dataset files with the
port's FEM oracles (``data/fem.py``, ``oracle/``) and right-hand sides drawn
from a ``torch.Generator`` (``data/rhs.py``): the same distributions as the
JAX package's, not the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from multigrid_feanet_torch.core.device import resolve_device
from multigrid_feanet_torch.data import fem, rhs


def _h5py():
    import h5py

    return h5py


@dataclasses.dataclass
class RHSDataset:
    """RHS-only fields ('train'/'test' keys).  (reference: Data/dataset.py:6-24)"""

    data: np.ndarray

    @classmethod
    def from_h5(cls, path: str, case: str = "train") -> "RHSDataset":
        with _h5py().File(path, "r") as h5:
            return cls(np.array(h5[case], dtype=np.float32))

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, idx):
        return self.data[idx]


@dataclasses.dataclass
class IsoPoissonDataset:
    """(u, f, bc_value, bc_index) quadruples.  (reference: Data/dataset.py:26-51)"""

    u: np.ndarray
    f: np.ndarray
    bc_value: np.ndarray
    bc_index: np.ndarray

    @classmethod
    def from_h5(cls, path: str) -> "IsoPoissonDataset":
        with _h5py().File(path, "r") as h5:
            return cls(
                u=np.array(h5["u"], dtype=np.float32),
                f=np.array(h5["rhs"], dtype=np.float32),
                bc_value=np.array(h5["boundary_value"], dtype=np.float32),
                bc_index=np.array(h5["boundary_index"], dtype=np.float32),
            )

    def __len__(self):
        return self.f.shape[0]

    def __getitem__(self, idx):
        return self.u[idx], self.f[idx], self.bc_value[idx], self.bc_index[idx]


@dataclasses.dataclass
class IsoPoissonPBCDataset:
    """Periodic problems: f only.  (reference: Data/dataset.py:53-69)"""

    f: np.ndarray

    @classmethod
    def from_h5(cls, path: str) -> "IsoPoissonPBCDataset":
        with _h5py().File(path, "r") as h5:
            return cls(f=np.array(h5["rhs"], dtype=np.float32))

    def __len__(self):
        return self.f.shape[0]

    def __getitem__(self, idx):
        return self.f[idx]


@dataclasses.dataclass
class TestPoissonDataset:
    """7-field general test set (float64).  (reference: Data/dataset.py:71-104)"""

    dirich_idx: np.ndarray
    dirich_value: np.ndarray
    neumann_idx: np.ndarray
    neumann_value: np.ndarray
    material: np.ndarray
    source: np.ndarray
    solution: np.ndarray

    @classmethod
    def from_h5(cls, path: str) -> "TestPoissonDataset":
        def _sq(x):
            a = np.array(x, dtype=np.float64)
            return a[..., 0] if a.ndim == 4 else a  # drop trailing channel dim

        with _h5py().File(path, "r") as h5:
            return cls(**{name: _sq(h5[name]) for name in (
                "dirich_idx", "dirich_value", "neumann_idx", "neumann_value", "material",
                "source", "solution")})

    def __len__(self):
        return self.source.shape[0]

    def __getitem__(self, idx):
        return (self.dirich_idx[idx], self.dirich_value[idx], self.neumann_idx[idx],
                self.neumann_value[idx], self.material[idx], self.source[idx],
                self.solution[idx])


def batches(dataset, batch_size: int, *, shuffle: bool = True, seed: int = 0,
            drop_remainder: bool = False, device=None) -> Iterator:
    """Iterate minibatches of tensors on ``device`` (stacked tuple fields),
    in the JAX package's order: a ``np.random.default_rng(seed)`` shuffle.
    ``device=None`` means CUDA."""
    device = resolve_device(device)
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    stop = n - (n % batch_size) if drop_remainder else n
    for start in range(0, stop, batch_size):
        items = [dataset[int(i)] for i in order[start : start + batch_size]]
        if isinstance(items[0], tuple):
            yield tuple(torch.as_tensor(np.stack(f), device=device) for f in zip(*items))
        else:
            yield torch.as_tensor(np.stack(items), device=device)


def _grf(gen, n: int, alpha: float) -> np.ndarray:
    return rhs.gaussian_random_field(gen, n, alpha=alpha).numpy().astype(np.float64)


def generate_isopoisson(n: int, num_samples: int, seed: int = 0,
                        alpha: float = 10.6) -> IsoPoissonDataset:
    """Recreate the IsoPoisson dataset with the FEM oracles.

    Per sample: smooth GRF RHS (alpha = 10.6, reference python_fem.ipynb
    cell 2), random GRF Dirichlet boundary values, f64 partition solve
    (dense for n <= 64, the C++ CG oracle to 1e-11 above).  Sample i draws
    from a generator seeded with ``(seed, i)``.
    """
    H = n + 1
    us, fs, bvs, bis = [], [], [], []
    # reference convention: boundary_index is 1 at INTERIOR nodes, 0 on the
    # boundary ring (it is used directly as the reset mask, u*idx + value)
    bc_index = np.ones((H, H), dtype=np.float32)
    bc_index[0, :] = bc_index[-1, :] = bc_index[:, 0] = bc_index[:, -1] = 0.0
    boundary_ring = 1.0 - bc_index.astype(np.float64)
    use_cg = n > 64  # dense O(N^3) is intractable past ~64
    if use_cg:
        from multigrid_feanet_torch import oracle
    for i in range(num_samples):
        gen = torch.Generator().manual_seed(seed * 1_000_003 + i)
        f = _grf(gen, H, alpha)
        bc = _grf(gen, H, alpha) * boundary_ring
        if use_cg:
            u, iters, res = oracle.solve(n, f, phase=None, coefficients=(1.0, 1.0), bc=bc,
                                         tol=1e-11)
            if iters < 0:
                raise RuntimeError(f"the CG oracle did not converge on sample {i}: {res}")
        else:
            u = fem.solve_dirichlet(n, f, bc_value=bc)
        us.append(u.astype(np.float32))
        fs.append(f.astype(np.float32))
        bvs.append(bc.astype(np.float32))
        bis.append(bc_index)
    return IsoPoissonDataset(u=np.stack(us), f=np.stack(fs), bc_value=np.stack(bvs),
                             bc_index=np.stack(bis))


def generate_isopoisson_pbc(n: int, num_samples: int, seed: int = 0) -> IsoPoissonPBCDataset:
    """Recreate the periodic RHS dataset (f fields only): (n+1)^2 wrapped
    GRFs, periodic by construction on the torus.  Sample i draws from a
    generator seeded with ``(seed, i)``."""
    fs = []
    for i in range(num_samples):
        gen = torch.Generator().manual_seed(seed * 1_000_003 + i)
        f_unique = rhs.gaussian_random_field(gen, n, alpha=4.0).numpy()
        fs.append(np.pad(f_unique, ((0, 1), (0, 1)), mode="wrap").astype(np.float32))
    return IsoPoissonPBCDataset(f=np.stack(fs))


def save_isopoisson(ds: IsoPoissonDataset, path: str) -> None:
    with _h5py().File(path, "w") as h5:
        h5["u"] = ds.u
        h5["rhs"] = ds.f
        h5["boundary_value"] = ds.bc_value
        h5["boundary_index"] = ds.bc_index


def save_rhs(path: str, train: np.ndarray, test: np.ndarray) -> None:
    """Write an RHS dataset in the reference's layout (train/test keys)."""
    with _h5py().File(path, "w") as h5:
        h5["train"] = train
        h5["test"] = test


def save_isopoisson_pbc(ds: IsoPoissonPBCDataset, path: str) -> None:
    with _h5py().File(path, "w") as h5:
        h5["rhs"] = ds.f
