"""How the ranks of a mesh run leave their process group
(tamcmc_tpu_torch/parallel/distributed.py `shutdown`, `joined`; cli
`cmd_run`).

Under a launcher's environment (env://) rank 0's process hosts the group's
TCPStore.  Rank 0 must not leave before every other rank has destroyed its
group: a rank still tearing down when the store's host exits can abort with
"terminate called without an active exception".  Here rank 1 reaches the
teardown a second after rank 0, so a rank 0 that does not wait exits first.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from tamcmc_tpu_torch import cli

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LATE_S = 1.0      # how much later rank 1 reaches the teardown

RANK = """
import json, os, sys, time
import torch
torch.set_num_threads(1)
from tamcmc_tpu_torch.parallel import distributed as D
with D.joined("cpu"):
    if D.rank() == 1:
        time.sleep({late})
    t_start = time.time()
t_end = time.time()
print(json.dumps({{"rank": int(os.environ["RANK"]), "start": t_start,
                  "end": t_end}}), flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launcher_env(port, rank, world=2):
    return dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))


def test_rank0_leaves_after_every_other_rank():
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK.format(late=LATE_S)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                 **_launcher_env(port, r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-2000:]}"
        assert "terminate called" not in err, f"rank {r}: {err[-2000:]}"
    t = {d["rank"]: d for d in (json.loads(o.strip().splitlines()[-1])
                                for o, _ in outs)}
    # rank 0 reached the teardown at once and left only after rank 1 had
    # reached it (the barrier) and destroyed its group (the store's key)
    assert t[1]["start"] - t[0]["start"] >= 0.8 * LATE_S
    assert t[0]["end"] >= t[1]["start"]
    assert t[0]["end"] - t[0]["start"] >= 0.8 * LATE_S


FIT = ["run", "--demo", "ms_global", "--device", "cpu", "--n-orders", "2",
       "--ngrid", "2000", "--temps", "2", "--chains", "4", "--burnin", "10",
       "--learning", "10", "--acquire", "10", "--thin", "5", "--no-report"]


def test_run_distributed_leaves_the_group_it_joined(tmp_path, monkeypatch):
    """`run --distributed` under a launcher's environment (a group of one
    here) has left its group when it returns, and when it fails."""
    for k, v in _launcher_env(_free_port(), 0, world=1).items():
        monkeypatch.setenv(k, v)
    res = cli.main([*FIT, "--mesh", "1x1", "--distributed", "--outdir",
                    str(tmp_path / "fit")])
    assert res["mesh"] == "1x1" and res["phases"]["A"]["steps"] == 10
    assert not dist.is_initialized()
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    with pytest.raises(SystemExit, match="needs 2 processes; this run has 1"):
        cli.main([*FIT, "--mesh", "2x1", "--distributed", "--outdir",
                  str(tmp_path / "refused")])
    assert not dist.is_initialized()
