"""ctypes bindings of the port's host record I/O (csrc/recordio.cpp; the
counterpart of tamcmc_tpu/io/native.py).

`NativeRecordWriter` is the asynchronous double-buffered `.bin` writer that
every fresh phase of `run`, `run --mesh` and `batch --stacked` writes
through (io/outputs.py); `native_read_table` is the `strtod` table reader
behind `io.data.read_spectrum` for ASCII spectra.  The library is built with
g++ at first use (ops/_cuda_build.py, into build/tamcmc_tpu_torch/); a build
that fails, and a write that fails, raise.  There is no Python fallback.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

_F64 = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from tamcmc_tpu_torch.ops import _cuda_build
    lib = _cuda_build.load("recordio")
    lib.rw_open.restype = ctypes.c_void_p
    lib.rw_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.rw_append.restype = ctypes.c_int
    lib.rw_append.argtypes = [ctypes.c_void_p, _F64, ctypes.c_long]
    lib.rw_count.restype = ctypes.c_long
    lib.rw_count.argtypes = [ctypes.c_void_p]
    for fn in (lib.rw_flush, lib.rw_close):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
    lib.ascii_read_table.restype = ctypes.c_long
    lib.ascii_read_table.argtypes = [ctypes.c_char_p, _F64, ctypes.c_long,
                                     ctypes.POINTER(ctypes.c_int)]
    return lib


def available() -> bool:
    """Whether the library builds and loads here (a query: nothing on the
    run path branches on it)."""
    try:
        _lib()
    except (OSError, RuntimeError):
        return False
    return True


class NativeRecordWriter:
    """Records of `nvars` float64 values to `path` (truncated), written by a
    background thread while the caller goes on (the reference's buffered
    `outputs.cpp` writer).  `flush` is the barrier before a checkpoint."""

    def __init__(self, path, nvars: int):
        self._c = _lib()
        self._h = self._c.rw_open(os.fsencode(path), nvars)
        if not self._h:
            raise OSError(f"rw_open could not open {path} for writing")
        self.path, self.nvars = path, nvars

    def append(self, records: np.ndarray):
        arr = np.ascontiguousarray(records, dtype=np.float64)
        if arr.ndim != 2 or arr.shape[1] != self.nvars:
            raise ValueError(f"records of shape {arr.shape}; this writer "
                             f"takes (n, {self.nvars})")
        if self._c.rw_append(self._h, arr, arr.shape[0]):
            raise OSError(f"rw_append: a write to {self.path} failed")

    @property
    def count(self) -> int:
        return int(self._c.rw_count(self._h))

    def flush(self):
        """Return once every appended record is in the file."""
        if self._c.rw_flush(self._h):
            raise OSError(f"rw_flush: a write to {self.path} failed")

    def close(self):
        if self._h:
            h, self._h = self._h, None
            if self._c.rw_close(h):
                raise OSError(f"rw_close: a write to {self.path} failed")


_READ_ERRORS = {-1: "cannot be opened", -2: "is a ragged table (rows of "
                "different column counts)", -3: "holds more values than the "
                "buffer"}


def native_read_table(path, max_elems: int | None = None) -> np.ndarray:
    """A whitespace-separated numeric ASCII table -> (rows, cols) float64,
    comment lines ('#', '!', '*') and blank lines skipped, each value parsed
    by `strtod`.  The buffer holds `max_elems` values, by default as many as
    the file can hold (every value takes one byte and all but the first
    follow one more); a table larger than the buffer is refused."""
    if max_elems is None:
        max_elems = os.path.getsize(path) // 2 + 1
    buf = np.empty(max_elems, dtype=np.float64)
    ncols = ctypes.c_int(0)
    n = _lib().ascii_read_table(os.fsencode(path), buf, max_elems,
                                ctypes.byref(ncols))
    if n < 0:
        raise (OSError if n == -1 else ValueError)(
            f"ascii_read_table: {path} {_READ_ERRORS[n]} ({n})")
    c = ncols.value
    return buf[:n * c].reshape(n, c).copy() if c else np.empty((0, 0))
