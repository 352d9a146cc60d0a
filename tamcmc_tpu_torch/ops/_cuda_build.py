"""Build the package's native sources into plain-C shared libraries.

Each `csrc/<name>.cu` (CUDA, nvcc for sm_90a) or `csrc/<name>.cpp` (host
C++, g++) compiles at first use into
`build/tamcmc_tpu_torch/<name>-<hash>.so` at the repository root, keyed by a
hash of the source and the flags, and loads with ctypes.  The sources include
no PyTorch headers (a plain C interface builds in seconds; one that includes
`torch/extension.h` takes minutes) and use no library kernels.  A build that
fails raises with the compiler's output; nothing falls back.  Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tamcmc_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-Wall",
             "-Wextra")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                       "the CUDA kernels are built from csrc/ at first use "
                       "and need the CUDA toolkit")


def _cxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found on PATH: the host libraries are built "
                       "from csrc/ at first use and need a C++ compiler")


def _source(name: str) -> tuple:
    """(source path, compiler, flags) of csrc/<name>.cu or csrc/<name>.cpp."""
    cu = CSRC / f"{name}.cu"
    if cu.exists():
        return cu, _nvcc, NVCC_FLAGS
    return CSRC / f"{name}.cpp", _cxx, CXX_FLAGS


def library_path(name: str) -> pathlib.Path:
    src, _, flags = _source(name)
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> dict:
    """Compile csrc/<name>.cu or .cpp unless its library is already built.

    Returns {"path", "seconds", "log"}: `log` is the compiler's output (for
    nvcc the register and shared-memory use per kernel, from -Xptxas -v);
    empty when cached."""
    lib = library_path(name)
    if lib.exists():
        return {"path": lib, "seconds": 0.0, "log": ""}
    src, compiler, flags = _source(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [compiler(), *flags, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cmd[0]} failed with code {res.returncode}: "
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)          # atomic: concurrent builders never see a
    return {"path": lib, "seconds": seconds,   # half-written library
            "log": res.stdout + res.stderr}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name> (building it first if needed)."""
    return ctypes.CDLL(str(build(name)["path"]))
