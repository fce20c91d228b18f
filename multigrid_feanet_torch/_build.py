"""Build the port's CUDA sources into one shared library at first use.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process for ``sm_90a``
(all started together), and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``.  The library lands in
``build/kernels/`` at the root of the checkout, named by a hash of every
source and header under ``csrc/`` and of the flags, so an edit to any of
them rebuilds and an unchanged tree is reused.  The compilers' logs
(``-Xptxas -v``: registers, shared memory, spills) are kept beside it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def sources() -> list[Path]:
    """The compiled sources, one object each."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"libkernels-{digest.hexdigest()[:16]}.so"


def _compile(lib: Path) -> str:
    """Compile every source in parallel and link them into ``lib``; returns
    the compilers' log, raises with it when a step fails."""
    srcs, compiler = sources(), nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in srcs]
        procs = [subprocess.Popen([compiler, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        outs = [p.communicate()[0] for p in procs]
        log = "".join(f"== {src.name}\n{out}" for src, out in zip(srcs, outs))
        failed = [src.name for src, p in zip(srcs, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        so = Path(tmp) / "lib.so"
        done = subprocess.run([compiler, *ARCH_FLAGS, "-shared", "-o", str(so), *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed to link the kernel library:\n{done.stdout}")
        os.replace(so, lib)
    return log


def load() -> ctypes.CDLL:
    """The loaded kernel library, compiled first if it is not built yet;
    raises with the compilers' log when the build fails."""
    global _lib
    if _lib is None:
        lib = library_path()
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            log = _compile(lib)
            lib.with_suffix(".log").write_text(log)
        _lib = ctypes.CDLL(str(lib))
    return _lib
