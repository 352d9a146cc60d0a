"""The port's host record I/O (tamcmc_tpu_torch/io/native.py over
csrc/recordio.cpp, built with g++ at first use): the counterparts of
tests/test_native.py, the native .bin byte for byte the plain handle's
through append / flush / abort / resume, the ASCII reader bitwise the plain
parser's and the reference reader's, its refusals, a failed build that
raises, and six processes that build the library at once."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tamcmc_tpu.io.data import read_spectrum as j_read_spectrum
from tamcmc_tpu_torch import cli
from tamcmc_tpu_torch.io import native
from tamcmc_tpu_torch.io.data import (read_spectrum, read_table_plain,
                                      write_spectrum)
from tamcmc_tpu_torch.io.native import NativeRecordWriter, native_read_table
from tamcmc_tpu_torch.io.outputs import (OutputWriter, PlainRecordWriter,
                                         read_bin_samples)
from tamcmc_tpu_torch.ops import _cuda_build

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_the_library_builds_here_and_loads():
    assert native.available()
    assert _cuda_build.library_path("recordio").exists()
    assert "recordio" in _cuda_build.library_path("recordio").name


class TestNativeWriter:
    def test_exact_roundtrip(self, tmp_path):
        p = tmp_path / "x.bin"
        w = NativeRecordWriter(p, 3)
        rng = np.random.default_rng(1)
        blocks = [rng.normal(size=(257, 3)) for _ in range(7)]
        for b in blocks:
            w.append(b)
        assert w.count == 7 * 257
        w.close()
        back = np.fromfile(p).reshape(-1, 3)
        np.testing.assert_array_equal(back, np.concatenate(blocks))

    def test_flush_is_a_barrier(self, tmp_path):
        """After `flush` every appended record is in the file while the
        writer is still open; non-contiguous input is copied first."""
        p = tmp_path / "x.bin"
        w = NativeRecordWriter(p, 2)
        a = np.arange(40.0).reshape(10, 4)[:, ::2]        # not contiguous
        for _ in range(3):
            w.append(a)
            w.flush()
            assert p.stat().st_size == w.count * 2 * 8
        w.close()
        w.close()                                          # idempotent
        np.testing.assert_array_equal(np.fromfile(p).reshape(-1, 2),
                                      np.concatenate([a] * 3))

    def test_refusals(self, tmp_path):
        with pytest.raises(OSError, match="rw_open"):
            NativeRecordWriter(tmp_path / "no" / "such" / "dir.bin", 2)
        w = NativeRecordWriter(tmp_path / "x.bin", 2)
        with pytest.raises(ValueError, match=r"takes \(n, 2\)"):
            w.append(np.zeros((4, 3)))
        w.close()

    def test_outputwriter_uses_native(self, tmp_path):
        w = OutputWriter(str(tmp_path), ["a", "b"], 2, 3)
        outs = {"theta0": np.arange(18.0).reshape(3, 3, 2),
                "logL": np.zeros((3, 2, 3)), "logP0": np.zeros((3, 3)),
                "log_sigma": np.zeros((3, 2)), "acc_rate": np.zeros((3, 2)),
                "mu0": np.zeros((3, 2))}
        w.append_chunk("A", outs)
        assert isinstance(w._bin_handles["A"], NativeRecordWriter)
        w.close()
        samples, names = read_bin_samples(str(tmp_path), "A")
        np.testing.assert_array_equal(samples, np.arange(18.0).reshape(9, 2))
        assert names == ["a", "b"]


def _chunk(rng, E, T, C, Df):
    return {"theta0": rng.normal(size=(E, C, Df)),
            "logL": rng.normal(size=(E, T, C)),
            "acc_rate": rng.uniform(size=(E, T))}


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if p.suffix in (".bin", ".hdr")}


@pytest.mark.parametrize("shard", [{}, {"walker_slice": (2, 5),
                                        "shard_tag": "host1"}])
def test_native_bin_is_the_plain_handle_s_byte_for_byte(tmp_path, shard):
    """The same records through the native writer and the plain handle,
    with a checkpoint barrier, an abort, a resume that cuts and appends
    and a finished phase: the same files, for a whole writer and for a
    mesh shard."""
    E, T, C, Df = 3, 2, 6, 4
    dirs = {}
    for native_ in (True, False):
        rng = np.random.default_rng(5)
        d = dirs[native_] = tmp_path / str(native_)
        w = OutputWriter(str(d), list("abcd"), T, C, native=native_, **shard)
        w.append_chunk("B", _chunk(rng, E, T, C, Df))
        w.close()
        for _ in range(4):
            w.append_chunk("L", _chunk(rng, E, T, C, Df))
            w.save_partial("L")
        w.append_chunk("L", _chunk(rng, E, T, C, Df))
        assert isinstance(w._bin_handles["L"], NativeRecordWriter if native_
                          else PlainRecordWriter)
        w.abort()
        r = OutputWriter(str(d), list("abcd"), T, C, native=native_, **shard)
        r.resume_phase("L", 3 * E * r.walkers_written)
        assert isinstance(r._bin_handles["L"], PlainRecordWriter)
        r.append_chunk("L", _chunk(rng, E, T, C, Df))
        r.close()
    assert _files(dirs[True]) == _files(dirs[False])
    assert len(_files(dirs[True])) == 4
    for p in ("B", "L"):
        a, b = (np.load(dirs[k] / f"{p}_chains.npz") for k in (True, False))
        assert a.files == b.files
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes()


class TestNativeAsciiReader:
    def test_matches_loadtxt_with_comments(self, tmp_path):
        p = tmp_path / "t.data"
        p.write_text("# c\n! gnuplot\n* star\n\n  1 2.5\n\t3 4.5e-2\n")
        t = native_read_table(str(p))
        np.testing.assert_array_equal(t, [[1, 2.5], [3, 0.045]])
        np.testing.assert_array_equal(t, read_table_plain(p))

    def test_ragged_is_refused(self, tmp_path):
        p = tmp_path / "r.data"
        p.write_text("1 2\n3 4 5\n")
        with pytest.raises(ValueError, match=r"ragged table.*\(-2\)"):
            native_read_table(str(p))
        with pytest.raises(ValueError, match="ragged"):
            read_spectrum(str(p))

    def test_a_table_over_the_buffer_is_refused(self, tmp_path):
        p = tmp_path / "t.data"
        p.write_text("1 2\n3 4\n5 6\n")
        assert native_read_table(str(p), max_elems=6).shape == (3, 2)
        with pytest.raises(ValueError, match=r"more values than the buffer "
                                             r"\(-3\)"):
            native_read_table(str(p), max_elems=5)

    def test_a_missing_file(self, tmp_path):
        with pytest.raises(OSError):
            native_read_table(str(tmp_path / "none.data"))

    def test_the_default_buffer_holds_the_densest_file(self, tmp_path):
        """One-character values with one separator each: the most values
        a file of its size can hold, read without a refusal."""
        p = tmp_path / "dense.data"
        p.write_text("1 2 3\n4 5 6\n7 8 9")
        np.testing.assert_array_equal(native_read_table(str(p)),
                                      np.arange(1, 10.0).reshape(3, 3))

    def test_random_doubles_bitwise(self, tmp_path):
        """Shortest repr, 17 significant digits, and subnormal, huge and
        negative values: strtod gives Python's float bit for bit."""
        rng = np.random.default_rng(3)
        v = np.concatenate([rng.normal(size=3000) * 10.0 **
                            rng.integers(-300, 300, 3000),
                            [5e-324, 2.2250738585072014e-308, 1.7e308,
                             -0.0, 0.1, 1 / 3]])
        v = v[: v.size // 3 * 3].reshape(-1, 3)
        p = tmp_path / "r.data"
        with open(p, "w") as f:
            for row in v:
                f.write(" ".join(repr(float(x)) if i % 2 else f"{x:.17e}"
                                 for i, x in enumerate(row)) + "\n")
        got = native_read_table(str(p))
        assert got.tobytes() == read_table_plain(p).tobytes()
        assert got.tobytes() == v.tobytes()

    def test_spectrum_of_make_example_bitwise(self, tmp_path):
        """`make-example`'s float64 grid column and its power column read
        by the native reader, the plain parser and the reference's reader
        (its C++ reader or numpy), bit for bit."""
        cli.main(["make-example", "--demo", "ms_global", "--device", "cpu",
                  "--ngrid", "2000", "--outdir", str(tmp_path)])
        path = tmp_path / "spectrum.data"
        got = read_spectrum(str(path))
        plain = read_table_plain(path)
        ref = j_read_spectrum(str(path))
        assert got["nu"].shape == (2000,)
        for i, k in enumerate(("nu", "power")):
            assert got[k].tobytes() == np.ascontiguousarray(
                plain[:, i]).tobytes()
            assert got[k].tobytes() == np.ascontiguousarray(ref[k]).tobytes()

    def test_write_then_read(self, tmp_path):
        nu = np.linspace(0, 9, 10)
        pw = np.arange(10.0)
        write_spectrum(str(tmp_path / "s.data"), nu, pw, sigma=pw + 1)
        d = read_spectrum(str(tmp_path / "s.data"))
        np.testing.assert_array_equal(d["nu"], nu)
        np.testing.assert_array_equal(d["sigma"], pw + 1)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No compiler: the build raises, and so do the writer and the reader
    that need it; nothing falls back to Python."""
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda_build, "_cxx",
                        lambda: str(tmp_path / "no-such-g++"))
    _cuda_build.load.cache_clear()
    native._lib.cache_clear()
    try:
        with pytest.raises(FileNotFoundError, match="no-such-g"):
            _cuda_build.build("recordio")
        with pytest.raises(FileNotFoundError):
            NativeRecordWriter(tmp_path / "x.bin", 2)
        (tmp_path / "t.data").write_text("1 2\n")
        with pytest.raises(FileNotFoundError):
            read_spectrum(str(tmp_path / "t.data"))
        assert native.available() is False
        monkeypatch.setattr(_cuda_build, "_cxx", lambda: "false")
        with pytest.raises(RuntimeError, match="failed with code 1"):
            _cuda_build.build("recordio")
        assert not list((tmp_path / "build").glob("*"))
    finally:
        _cuda_build.load.cache_clear()
        native._lib.cache_clear()


BUILD_ONE = """
import pathlib, sys
from tamcmc_tpu_torch.ops import _cuda_build
_cuda_build.BUILD_DIR = pathlib.Path(sys.argv[1])
from tamcmc_tpu_torch.io import native
w = native.NativeRecordWriter(sys.argv[2], 1)
w.append(__import__("numpy").ones((3, 1)))
w.close()
print(_cuda_build.library_path("recordio").name)
"""


def test_six_processes_build_at_once_and_all_load(tmp_path):
    build = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_ONE, str(build),
                               str(tmp_path / f"{k}.bin")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for k in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, outs
    names = {o[0].strip() for o in outs}
    assert len(names) == 1
    assert [p.name for p in build.iterdir()] == [names.pop()]
    for k in range(6):
        assert np.fromfile(tmp_path / f"{k}.bin").tolist() == [1.0] * 3
