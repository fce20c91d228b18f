"""Build the port's CUDA source into a shared library at first use.

``csrc/sweep.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  The library lands
in ``build/kernels/`` at the root of the checkout, named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one is
reused.  The compiler's log (``-Xptxas -v``: registers, shared memory,
spills) is kept beside it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "sweep.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsweep-{digest.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """The loaded kernel library, compiled first if it is not built yet;
    raises with the compiler's log when the compile fails."""
    global _lib
    if _lib is None:
        lib = library_path()
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            done = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
            if done.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{done.stdout}")
            os.replace(tmp, lib)
            lib.with_suffix(".log").write_text(done.stdout)
        _lib = ctypes.CDLL(str(lib))
    return _lib
