"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (``extern "C"`` entry points that return the launch's
``cudaError_t``), for ``sm_90a``:

    nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a -Xptxas -v \
         -shared -Xcompiler -fPIC -o _build/<name>-<sha>.so csrc/<name>.cu

A source may include the shared headers ``csrc/*.cuh``.  The library goes
into ``kernels/_build/`` (git-ignored), named by a hash of the source, of
every header and of the flags, at first use: a checkout builds what it
runs, and an edited source or header rebuilds.  nvcc's output (ptxas's
registers, shared memory and spills of each kernel) is kept beside the
library as ``<library>.log``.  Nothing is built or imported at module
import time.
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
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-O3", "-std=c++17", *ARCH_FLAGS, "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's usual place."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) \
            + [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "(the port's kernels build on the machine with the "
                       "card)")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu``'s library goes: named by a hash of the
    source, of every ``csrc/*.cuh`` it may include and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> Path:
    """nvcc's output for the library of ``csrc/<name>.cu``."""
    return library_path(name).with_suffix(".log")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library's path and raises with nvcc's output on failure."""
    lib = library_path(name)
    if lib.exists():
        return str(lib)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name, then rename: a library that exists is
    # always complete
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"kernel build failed: {name}: nvcc exit "
                           f"{proc.returncode}\n{proc.stdout}")
    build_log(name).write_text(proc.stdout)
    os.replace(tmp, lib)
    return str(lib)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    needed (once per process)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _loaded[name] = lib
    return lib
