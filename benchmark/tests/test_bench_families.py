"""Configuration families loaded by name: a new family is a new file of
benchmark/reference and runs with no edit to any other file, a missing one
is named at load_cell, and the shared code names no family."""

import dataclasses
import json
import pathlib
import re
import shutil
import sys
import time

import pytest

from benchmark import harness, reference
from benchmark.tests import tiny

HERE = pathlib.Path(__file__).resolve().parents[1]
SHARED = ["harness.py", "traffic.py", "check.py", "work.py", "spans.py",
          "trace.py", "run.py", "reference/posterior.py",
          "reference/spectrum.py", "reference/priors.py",
          "reference/__init__.py", "tests/tiny.py"]


@pytest.fixture
def new_family(tmp_path, monkeypatch):
    """benchmark/reference/ms_global.py copied as `ms_copy` into a
    directory of its own, which the loader searches instead."""
    shutil.copy(HERE / "reference" / "ms_global.py", tmp_path / "ms_copy.py")
    monkeypatch.setattr(reference, "DIR", tmp_path)
    yield tmp_path / "ms_copy.py"
    sys.modules.pop("benchmark.reference.ms_copy", None)


def test_a_new_familys_file_runs_a_cell(new_family):
    fam = reference.family("ms_copy")
    assert pathlib.Path(fam.__file__) == new_family
    assert reference.family("ms_copy") is fam
    cell = tiny.small("kepler_full.stack8")
    cell = dataclasses.replace(cell, config=dict(cell.config,
                                                 family="ms_copy"))
    out = harness.run(cell, 2**31 + 41, 0.5, False, "cpu",
                      time.perf_counter(), log=lambda m: None)
    assert out["correct"] and out["failed"] == 0
    assert out["metrics"]["walker_steps_per_s"]["value"] > 0


def test_a_missing_family_is_named_at_load_cell(tmp_path):
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    conf = next(c for c in bench["configs"] if c["name"] == "kepler_full")
    cfg = json.loads((HERE.parent / conf["file"]).read_text())
    (tmp_path / "cfg.json").write_text(json.dumps(
        dict(cfg, family="no_such_family")))
    conf["file"] = "cfg.json"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    want = str(reference.DIR / "no_such_family.py")
    with pytest.raises(FileNotFoundError, match=re.escape(want)):
        harness.load_cell("kepler_full.stack8", root=tmp_path)


@pytest.mark.parametrize("name", ["../harness", "a.b", ""])
def test_a_family_name_is_a_module_name(name):
    with pytest.raises(FileNotFoundError):
        reference.family(name)


@pytest.mark.parametrize("path", SHARED)
def test_the_shared_code_names_no_family(path):
    text = (HERE / path).read_text()
    for name in ("ms_global", "rgb_asympt"):
        assert name not in text, (path, name)
