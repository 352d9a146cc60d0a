"""Process-group bring-up, the backend and device of each rank, and the
collectives of the multi-process runner (port of
tamcmc_tpu/parallel/distributed.py).

    init_distributed(device)   joins the group a launcher started, from the
                               environment torchrun exports (MASTER_ADDR,
                               MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK);
                               False for a single process
    joined(device)             a context: joins, and on leaving it takes
                               shutdown(clean=True) after success (rank 0,
                               the store's host, leaves last), shutdown()
                               after an error
    launch_local(argv, n)      `run --mesh TxC` without --distributed: starts
                               T*C ranks on this machine (spawn start
                               method) and exits non-zero if one fails

The backend rule, with no other switch: ranks on CUDA use `nccl` when the
machine has a card for each rank (device_count() >= world size), else
`gloo`, as do ranks on the CPU.  Rank r computes on cuda:{LOCAL_RANK %
device_count}, so ranks share cards when there are fewer cards than ranks
(NCCL refuses two ranks on one card).  gloo moves host tensors: a CUDA
tensor goes through the host explicitly (`_staged`), and only at the points
the runner communicates (a swap step's boundary rows, an adapting step's
walker sums, a chunk's records, a checkpoint's state).

Every group has a timeout (DIST_TIMEOUT_S): a rank that never joins or stops
answering ends the others' wait with an error instead of a hang, and the
local launcher stops every rank as soon as one fails.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import shutil
import signal
import sys
import tempfile

import torch
import torch.distributed as dist

DIST_TIMEOUT_S = 300      # rendezvous and every collective
_CTX: dict = {}           # backend and device of this process
_GROUPS: dict = {}        # (n_temp, n_chain) -> this rank's walker group


def backend_for(device_type: str, world: int) -> str:
    """`nccl` when every rank of a CUDA run owns a card, else `gloo`."""
    if device_type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def init_distributed(device="cuda", init_method=None,
                     timeout_s: int = DIST_TIMEOUT_S) -> bool:
    """Join the process group (idempotent).  Without `init_method` it reads
    the launcher's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
    LOCAL_RANK); with none of it the run is a single process and this
    returns False.  Returns True when the group has more than one rank."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if init_method is None:
        if not all(k in env for k in ("MASTER_ADDR", "MASTER_PORT",
                                      "WORLD_SIZE", "RANK")):
            return False
        init_method = "env://"
    world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    local = int(env.get("LOCAL_RANK", rank))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {device}: no CUDA device is "
                             "available (use --device cpu)")
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend_for(dev.type, world)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    _CTX.update(backend=backend, device=dev)
    # one collective of every rank first: NCCL's point-to-point calls may
    # not be a group's first call unless every rank takes part, and a swap
    # step's boundary exchange involves only the ranks beside a boundary
    dist.barrier()
    return world > 1


def shutdown(clean: bool = False):
    """Leave the process group (a no-op outside one).

    clean: every rank's work succeeded.  Every rank takes a barrier; then
    every rank but 0 destroys its group and says so on the group's store,
    and rank 0 waits (DIST_TIMEOUT_S) until all of them have before it
    destroys its own.  Under a launcher's environment rank 0's process
    hosts that store (env://, a TCPStore): a rank still tearing down when
    the store's host exits can abort ("terminate called without an active
    exception").  Otherwise (an error path) the group is destroyed at
    once: a barrier could wait on a rank that died."""
    if dist.is_initialized():
        world, rank_ = dist.get_world_size(), dist.get_rank()
        if clean and world > 1:
            dist.barrier()
            store = dist.distributed_c10d._get_default_store()
            if rank_:
                dist.destroy_process_group()
                store.set(f"tamcmc_left/{rank_}", "1")
            else:
                store.set_timeout(datetime.timedelta(seconds=DIST_TIMEOUT_S))
                store.wait([f"tamcmc_left/{r}" for r in range(1, world)])
                dist.destroy_process_group()
        else:
            dist.destroy_process_group()
    _CTX.clear()
    _GROUPS.clear()


@contextlib.contextmanager
def joined(device="cuda", init_method=None):
    """The body runs in the process group init_distributed joins; then the
    group is left: `shutdown(clean=True)` when the body returned,
    `shutdown()` when it raised."""
    init_distributed(device, init_method=init_method)
    try:
        yield
    except BaseException:
        shutdown()
        raise
    shutdown(clean=True)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def backend() -> str:
    """The group's backend, or "none" for a single process."""
    return _CTX.get("backend", "none")


def rank_device(device="cuda") -> torch.device:
    """The device this rank computes on: the one init_distributed chose, or
    `device` for a single process."""
    return _CTX.get("device", torch.device(device))


def process_local_slice(arr_len: int):
    """(start, stop) of this process's share of a leading axis of length
    arr_len split evenly over the processes: the walkers whose cold-rung
    samples this process writes."""
    n, pid = world_size(), rank()
    per, extra = divmod(arr_len, n)
    start = pid * per + min(pid, extra)
    return start, start + per + (1 if pid < extra else 0)


# ---- collectives (gloo: through the host) ----

def _staged(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.cpu() if backend() == "gloo" else x


def walker_group(mesh):
    """The process group of this rank's temperature row (the ranks whose
    walkers share one mean), created once per mesh by every rank in the
    same order."""
    key = (mesh.n_temp, mesh.n_chain)
    if key not in _GROUPS:
        if mesh.n_temp == 1:
            _GROUPS[key] = dist.group.WORLD
        else:
            mine = None
            for ti in range(mesh.n_temp):
                g = dist.new_group(mesh.row_ranks(ti))
                if ti == mesh.ti:
                    mine = g
            _GROUPS[key] = mine
    return _GROUPS[key]


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the ranks of `group`, on x's device (a contiguous
    device tensor x is summed in place)."""
    buf = _staged(x)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(x.device)


def all_gather_flat(x: torch.Tensor):
    """Every rank's 1-D tensor x (one shape on every rank), in rank order,
    on the host."""
    buf = _staged(x)
    out = [torch.empty_like(buf) for _ in range(world_size())]
    dist.all_gather(out, buf)
    return [o.cpu() for o in out]


def exchange(sends):
    """Point-to-point: sends = [(peer, tensor), ...]; each peer sends this
    rank a tensor of the same shape at the same time.  Returns the received
    tensors, in the order of `sends`, on the senders' tensors' device."""
    ops, recvs = [], []
    for peer, t in sends:
        s = _staged(t)
        r = torch.empty_like(s)
        ops += [dist.P2POp(dist.isend, s, peer),
                dist.P2POp(dist.irecv, r, peer)]
        recvs.append((r, t.device))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return [r.to(d) for r, d in recvs]


def gather_objects(obj):
    """Every rank's picklable `obj`, in rank order (small, once a run)."""
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


# ---- the local launcher ----

def _die_with_parent():
    """Linux: this process gets SIGKILL when the launcher dies, so a killed
    launcher leaves no rank running (or waiting in a collective)."""
    if sys.platform.startswith("linux"):
        import ctypes
        prctl = ctypes.CDLL(None, use_errno=True).prctl
        prctl.argtypes, prctl.restype = [ctypes.c_int, ctypes.c_ulong], \
            ctypes.c_int
        PR_SET_PDEATHSIG = 1
        if prctl(PR_SET_PDEATHSIG, signal.SIGKILL) != 0:
            raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG)")


def _rank_main(rank_: int, argv, world: int, init_method: str):
    """One rank of `launch_local`: join the group, then run the command."""
    _die_with_parent()
    os.environ.update(RANK=str(rank_), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank_), LOCAL_WORLD_SIZE=str(world))
    from tamcmc_tpu_torch import cli
    args = cli._parser().parse_args(argv)
    if torch.device(args.device).type == "cpu":
        # the ranks share this machine's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    with joined(args.device, init_method=init_method):
        cli.main([*argv, "--distributed"])


def launch_local(argv, n_ranks: int):
    """Run `argv` (a `run --mesh` command line without --distributed) as
    n_ranks processes of one group on this machine, started with the spawn
    method (a CUDA context does not survive fork), rendezvous through a
    file in a fresh temporary directory (no port to collide).  Returns when
    every rank has ended with code 0; when one fails, the others are stopped
    and this exits non-zero."""
    import torch.multiprocessing as mp
    rdv = tempfile.mkdtemp(prefix="tamcmc-rendezvous-")
    try:
        sys.stdout.flush()
        mp.start_processes(_rank_main,
                           args=(list(argv), n_ranks, f"file://{rdv}/store"),
                           nprocs=n_ranks, join=True, start_method="spawn")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        raise SystemExit(f"--mesh: rank {e.error_index} of {n_ranks} failed "
                         f"({str(e).strip().splitlines()[0]}); the other "
                         "ranks were stopped")
    finally:
        shutil.rmtree(rdv, ignore_errors=True)
