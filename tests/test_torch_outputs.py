"""The port's sample writer and reader against the reference's: the files
are byte-identical, each package's reader reads the other's writer (flat and
per chain), a mid-phase resume truncates whatever a kill left behind, and
host-shard files of the reference's layout merge as the reference merges
them."""

import numpy as np
import pytest

from tamcmc_tpu.io import outputs as j_out
from tamcmc_tpu_torch.io import outputs as t_out

NAMES = ["alpha", "beta", "gamma"]
T, C, DF = 2, 4, 3


def _chunk(rng, E):
    return {"theta0": rng.standard_normal((E, C, DF)).astype(np.float32),
            "logL": rng.standard_normal((E, T, C)).astype(np.float32),
            "logP": rng.standard_normal((E, T, C)).astype(np.float32),
            "logP0": rng.standard_normal((E, C)).astype(np.float32),
            "log_sigma": rng.standard_normal((E, T)).astype(np.float32),
            "acc_rate": rng.uniform(size=(E, T)).astype(np.float32),
            "mu0": rng.standard_normal((E, DF)).astype(np.float32),
            "cov_diag0": rng.uniform(size=(E, DF)).astype(np.float32),
            "swap_att": np.ones((E, T), np.float32),
            "swap_acc": np.ones((E, T), np.float32)}


def _plain_file_writer(monkeypatch):
    """The reference writer with its optional C++ record writer out of the
    way: the plain-file handle the port always uses."""
    monkeypatch.setattr(
        j_out.OutputWriter, "_open_writer",
        lambda self, phase, nvars, append=False:
        open(self._bin_path(phase), "ab" if append else "wb"))


def _write(mod, outdir, chunks):
    w = mod.OutputWriter(str(outdir), NAMES, T, C)
    for c in chunks:
        w.append_chunk("A", c)
    w.close()


def test_files_are_byte_identical_to_the_reference_writer(tmp_path,
                                                           monkeypatch):
    _plain_file_writer(monkeypatch)
    rng = np.random.default_rng(0)
    chunks = [_chunk(rng, 5), _chunk(rng, 5)]
    _write(t_out, tmp_path / "t", chunks)
    _write(j_out, tmp_path / "j", chunks)
    for name in ("A_samples.bin", "A_samples.hdr"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    zt, zj = (np.load(tmp_path / d / "A_chains.npz") for d in "tj")
    assert zt.files == zj.files
    for k in zj.files:
        assert zt[k].dtype == zj[k].dtype
        np.testing.assert_array_equal(zt[k], zj[k], k)


@pytest.mark.parametrize("writer,reader", [(t_out, j_out), (j_out, t_out),
                                           (t_out, t_out)])
@pytest.mark.parametrize("with_chains", [False, True])
def test_each_reader_reads_the_other_writer(tmp_path, writer, reader,
                                            with_chains):
    rng = np.random.default_rng(1)
    chunks = [_chunk(rng, 6), _chunk(rng, 6)]
    _write(writer, tmp_path, chunks)
    got, names = reader.read_bin_samples(str(tmp_path), "A",
                                         with_chains=with_chains)
    want = np.concatenate([c["theta0"] for c in chunks]).astype(np.float64)
    assert names == NAMES
    np.testing.assert_array_equal(
        got, want if with_chains else want.reshape(-1, DF))


@pytest.mark.parametrize("left_behind", ["nothing", "whole records",
                                         "a torn record"])
def test_resume_phase_truncates_what_a_kill_left(tmp_path, left_behind):
    """save_partial after two chunks, then more bytes reach the .bin before
    the kill: the resumed writer ends with the uninterrupted run's files."""
    rng = np.random.default_rng(2)
    chunks = [_chunk(rng, 4) for _ in range(4)]
    _write(t_out, tmp_path / "clean", chunks)

    w = t_out.OutputWriter(str(tmp_path / "run"), NAMES, T, C)
    for c in chunks[:2]:
        w.append_chunk("A", c)
    w.save_partial("A")
    w.append_chunk("A", chunks[2])          # past the checkpoint
    w.abort()                               # the process dies: no .hdr
    bin_path = tmp_path / "run" / "A_samples.bin"
    if left_behind == "nothing":
        with open(bin_path, "rb+") as f:
            f.truncate(2 * 4 * C * DF * 8)
    elif left_behind == "a torn record":
        with open(bin_path, "ab") as f:
            f.write(b"\x01\x02\x03\x04\x05")
    assert not (tmp_path / "run" / "A_samples.hdr").exists()
    assert (tmp_path / "run" / "A_chains_partial.npz").exists()

    w = t_out.OutputWriter(str(tmp_path / "run"), NAMES, T, C)
    w.resume_phase("A", 2 * 4 * C)
    for c in chunks[2:]:
        w.append_chunk("A", c)
    w.close()
    for name in ("A_samples.bin", "A_samples.hdr"):
        assert (tmp_path / "run" / name).read_bytes() == \
            (tmp_path / "clean" / name).read_bytes(), name
    za, zb = (np.load(tmp_path / d / "A_chains.npz") for d in ("run", "clean"))
    for k in zb.files:
        assert za[k].tobytes() == zb[k].tobytes(), k
    assert not (tmp_path / "run" / "A_chains_partial.npz").exists()
    with pytest.raises(FileNotFoundError, match="cannot resume"):
        t_out.OutputWriter(str(tmp_path / "run"), NAMES, T, C) \
            .resume_phase("L", 0)


def test_partial_file_is_the_reference_layout_and_written_atomically(
        tmp_path, monkeypatch):
    """The reference's resume_phase reads the port's partial file; a write
    that dies half way leaves the previous partial file in place."""
    _plain_file_writer(monkeypatch)
    rng = np.random.default_rng(3)
    chunks = [_chunk(rng, 3) for _ in range(3)]
    w = t_out.OutputWriter(str(tmp_path), NAMES, T, C)
    for c in chunks[:2]:
        w.append_chunk("A", c)
    w.save_partial("A")
    before = (tmp_path / "A_chains_partial.npz").read_bytes()
    assert int(np.load(tmp_path / "A_chains_partial.npz")["__count__"]) \
        == 2 * 3 * C

    def dies(f, **arrays):
        f.write(b"PK half a zip")
        raise KeyboardInterrupt

    w.append_chunk("A", chunks[2])
    monkeypatch.setattr(np, "savez", dies)
    with pytest.raises(KeyboardInterrupt):
        w.save_partial("A")
    monkeypatch.undo()
    w.abort()
    assert (tmp_path / "A_chains_partial.npz").read_bytes() == before

    _plain_file_writer(monkeypatch)
    jw = j_out.OutputWriter(str(tmp_path), NAMES, T, C)
    jw.resume_phase("A", 2 * 3 * C)
    jw.append_chunk("A", chunks[2])
    jw.close()
    got, _ = t_out.read_bin_samples(str(tmp_path), "A", with_chains=True)
    np.testing.assert_array_equal(
        got, np.concatenate([c["theta0"] for c in chunks]).astype(np.float64))
    assert np.load(tmp_path / "A_chains.npz")["logL"].shape == (9, T, C)


@pytest.mark.parametrize("with_chains", [False, True])
@pytest.mark.parametrize("desynced", [False, True])
def test_host_shards_merge_as_the_reference_merges_them(tmp_path, capsys,
                                                        with_chains,
                                                        desynced):
    """Two per-process shard files of the reference's multi-host layout
    (walkers 0-1 and 2-3), the second one an emit short when desynced."""
    rng = np.random.default_rng(4)
    chunk = _chunk(rng, 6)
    for k, (lo, hi) in enumerate(((0, 2), (2, 4))):
        w = j_out.OutputWriter(str(tmp_path), NAMES, T, C,
                               walker_slice=(lo, hi), shard_tag=f"host{k}",
                               keep_chains=(k == 0))
        cut = 5 if (desynced and k == 1) else 6
        w.append_chunk("A", {key: v[:cut] for key, v in chunk.items()})
        w.close()
    got, names = t_out.read_bin_samples(str(tmp_path), "A",
                                        with_chains=with_chains)
    t_err = capsys.readouterr().err
    want, j_names = j_out.read_bin_samples(str(tmp_path), "A",
                                           with_chains=with_chains)
    assert names == j_names == NAMES
    np.testing.assert_array_equal(got, want)
    if not with_chains and not desynced:
        np.testing.assert_array_equal(got, np.concatenate(
            [chunk["theta0"][:, :2].reshape(-1, DF),
             chunk["theta0"][:, 2:].reshape(-1, DF)]).astype(np.float64))
    assert ("desynced" in t_err) == (with_chains and desynced)
    assert t_err == capsys.readouterr().err
    with pytest.raises(FileNotFoundError):
        t_out.read_bin_samples(str(tmp_path), "L")


def test_hdr_without_nchains_reads_as_one_pseudo_chain(tmp_path, capsys):
    rng = np.random.default_rng(5)
    _write(t_out, tmp_path, [_chunk(rng, 3)])
    hdr = tmp_path / "A_samples.hdr"
    hdr.write_text("".join(ln for ln in hdr.read_text().splitlines(True)
                           if not ln.startswith("Nchains")))
    got, _ = t_out.read_bin_samples(str(tmp_path), "A", with_chains=True)
    assert "no usable Nchains" in capsys.readouterr().err
    want, _ = j_out.read_bin_samples(str(tmp_path), "A", with_chains=True)
    assert got.shape == want.shape == (3 * C, 1, DF)


def test_a_write_removes_what_a_killed_write_left(tmp_path):
    """A process killed inside atomic_savez leaves `<name>.<pid>.tmp`; the
    next write of that file, or the phase's end, removes it."""
    target = tmp_path / "L_chains_partial.npz"
    stale = tmp_path / "L_chains_partial.npz.4617.tmp"
    stale.write_bytes(b"torn")
    other = tmp_path / "restore.npz.4617.tmp"
    other.write_bytes(b"torn")
    t_out.atomic_savez(target, a=np.arange(3))
    assert not stale.exists() and other.exists()
    assert np.array_equal(np.load(target)["a"], np.arange(3))
    stale.write_bytes(b"torn")
    w = t_out.OutputWriter(str(tmp_path), ["x"], 1, 1)
    w.discard_partial("L")
    assert not stale.exists() and not target.exists() and other.exists()
