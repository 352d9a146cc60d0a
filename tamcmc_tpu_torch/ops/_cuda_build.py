"""Build the package's CUDA sources with nvcc into plain-C shared libraries.

Each `csrc/<name>.cu` compiles at first use into
`build/tamcmc_tpu_torch/<name>-<hash>.so` at the repository root, keyed by a
hash of the source and the flags, and loads with ctypes.  The sources include
no PyTorch headers (a plain C interface builds in seconds; one that includes
`torch/extension.h` takes minutes) and use no library kernels.  Nothing here
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


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> dict:
    """Compile csrc/<name>.cu unless its library is already built.

    Returns {"path", "seconds", "log"}: `log` is nvcc's output (register and
    shared-memory use per kernel, from -Xptxas -v); empty when cached."""
    lib = library_path(name)
    if lib.exists():
        return {"path": lib, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {res.returncode}: "
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)          # atomic: concurrent builders never see a
    return {"path": lib, "seconds": seconds,   # half-written library
            "log": res.stdout + res.stderr}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu (building it first if needed)."""
    return ctypes.CDLL(str(build(name)["path"]))
