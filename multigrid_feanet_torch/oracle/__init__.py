"""ctypes binding for the C++ FEM oracle (``fem_oracle.cc``, beside this file).

Port of ``multigrid_feanet_tpu/oracle/__init__.py`` with its own copy of the
source.  The shared library is built at first use with ``g++`` into
``build/oracle/`` at the root of the checkout, named by a hash of the source
and the flags, so an edit rebuilds and an unchanged source is reused; no
library under the JAX package is ever loaded.  See ``fem_oracle.cc`` for
the ABI.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fem_oracle.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "oracle"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(FLAGS).encode() + b"\0" + SOURCE.read_bytes())
    return BUILD_DIR / f"libfem_oracle-{digest.hexdigest()[:16]}.so"


def get_lib() -> ctypes.CDLL:
    """The loaded oracle library, built first when it is not there yet."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            so = Path(tmp) / "lib.so"
            done = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(so)],
                                  capture_output=True, text=True)
            if done.returncode != 0:
                raise RuntimeError(f"g++ failed to build the FEM oracle:\n{done.stderr}")
            os.replace(so, path)
    lib = ctypes.CDLL(str(path))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.fem_solve.restype = ctypes.c_int
    lib.fem_solve.argtypes = [ctypes.c_int, dp, ctypes.c_double, ctypes.c_double, dp, dp,
                              ctypes.c_double, ctypes.c_int, dp, dp]
    _lib = lib
    return lib


def solve(n: int, f: np.ndarray, phase: np.ndarray | None = None,
          coefficients=(1.0, 20.0), bc: np.ndarray | None = None,
          tol: float = 1e-12, max_iter: int = 100_000):
    """Solve the bi-material Poisson problem with the native CG oracle.

    ``f``: (n+1, n+1) nodal source; ``phase``: optional (n, n) element
    phases; ``bc``: optional (n+1, n+1) Dirichlet values (boundary ring).
    Returns (u, cg_iterations, final_residual_norm); the iteration count is
    -1 when CG did not reach ``tol`` in ``max_iter`` iterations.
    """
    H = n + 1
    lib = get_lib()

    def f64(a, size):
        return np.ascontiguousarray(np.asarray(a, dtype=np.float64).reshape(size))

    def ptr(a):
        return None if a is None else a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    fv = f64(f, H * H)
    pv = None if phase is None else f64(phase, n * n)
    bv = None if bc is None else f64(bc, H * H)
    u = np.zeros(H * H, dtype=np.float64)
    res = ctypes.c_double(0.0)
    iters = lib.fem_solve(n, ptr(pv), float(coefficients[0]), float(coefficients[1]), ptr(fv),
                          ptr(bv), float(tol), int(max_iter), ptr(u), ctypes.byref(res))
    return u.reshape(H, H), int(iters), float(res.value)
