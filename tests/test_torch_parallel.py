"""The port's multi-process runner (tamcmc_tpu_torch/parallel/) on the CPU:
gloo ranks started here with the spawn method, rendezvous through a file in
tmp_path (no port to collide under xdist), against the local runner and the
reference's swap (the counterparts of tests/test_shardmap.py).

  * the boundary exchange of a swap sweep equals tempering_swap on the whole
    ladder bit for bit, both parities, and the reference's within 1e-6
  * temperature-sharded runs (2x1, 4x1) are the local run bit for bit
    (std_gaussian, drift, dN_mixing=2, adapting then frozen: 90 steps)
  * walker-sharded runs (1x2, 2x2) agree within test_shardmap.py's
    tolerances and count the same swap attempts
  * every pair is attempted and the swap cadence holds across ranks
  * the "auto" covariance estimator resolves from the global walker count
  * the writer's shards read back in walker order with 11 of them
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from tamcmc_tpu_torch import convert
from tamcmc_tpu_torch.io.outputs import OutputWriter, read_bin_samples
from tamcmc_tpu_torch.parallel import distributed as D
from tamcmc_tpu_torch.parallel.mesh import STATE_SPLIT, SamplerMesh, parse_mesh
from tamcmc_tpu_torch.parallel.sharded import gather_state, shard_state
from tamcmc_tpu_torch.parallel.shardmap_runner import swap_across
from tamcmc_tpu_torch.sampler.analytic import std_gaussian
from tamcmc_tpu_torch.sampler.driver import run_phase
from tamcmc_tpu_torch.sampler.mala import init_state
from tamcmc_tpu_torch.sampler.state import MALAHyper, SamplerState
from tamcmc_tpu_torch.sampler.tempering import (make_beta_ladder,
                                                tempering_swap)

torch.set_num_threads(1)


# name -> (ndim, MALAHyper kwargs, T, C, ladder ratio, [(steps, adapt)],
# thin, chunk)
SCENARIOS = {
    "drift": (3, dict(use_drift=True, dN_mixing=2), 4, 8, 1.5,
              [(60, True), (30, False)], 3, 5),
    "pairs": (2, dict(use_drift=False, dN_mixing=1), 4, 4, 1.3,
              [(20, True)], 4, 5),
    "cadence": (2, dict(use_drift=False, dN_mixing=3), 4, 4, 1.4,
                [(24, True)], 6, 4),
    "auto": (5, dict(use_drift=False, dN_mixing=3, cov_estimator="auto"),
             2, 8, 1.5, [(30, True)], 5, 6),
}


def _fit(name, mesh_shape=None, rank=0):
    """A scenario's fit, local or on this rank of a mesh; (whole final
    state as {field: array}, records of the last phase)."""
    ndim, hp_kw, T, C, ratio, phases, thin, chunk = SCENARIOS[name]
    p, hp = std_gaussian(ndim), MALAHyper(**hp_kw)
    betas = make_beta_ladder(T, ratio)
    g = torch.Generator().manual_seed(0)
    state = init_state(p, hp, T, C, g)
    mesh = None
    if mesh_shape is not None:
        mesh = SamplerMesh(*mesh_shape, rank, T, C)
        state = shard_state(state, mesh)
    for steps, adapt in phases:
        state, outs = run_phase(p, hp, betas, state, g, steps, adapt=adapt,
                                thin=thin, chunk=chunk, mesh=mesh,
                                runner_kind="shardmap")
    if mesh is not None:
        state = gather_state(state, mesh)
    return convert.state_to_arrays(state), outs


def _swap_case(parity):
    """A ladder of six rungs (two ranks of three: each parity has a pair
    inside a block, and parity 0 one across the boundary) with its uniforms
    and a state whose swaps accept about half the time."""
    rng = np.random.default_rng(21 + parity)
    T, C, Df = 6, 4, 3
    arrays = {f: rng.normal(size=(T, C, Df)).astype(np.float32)
              for f in ("theta", "gradL", "gradP", "mu")}
    arrays.update(
        logL=rng.normal(-50.0, 20.0, (T, C)).astype(np.float32),
        logP=rng.normal(-3.0, 1.0, (T, C)).astype(np.float32),
        cov=np.broadcast_to(np.eye(Df, dtype=np.float32), (T, C, Df, Df)),
        chol=np.broadcast_to(np.eye(Df, dtype=np.float32), (T, C, Df, Df)),
        ichol=np.broadcast_to(np.eye(Df, dtype=np.float32), (T, C, Df, Df)),
        log_sigma=np.zeros((T, C), np.float32),
        acc_rate=np.zeros((T, C), np.float32), step=np.asarray(10, np.int32),
        naccept=np.zeros(T, np.float32), nprop=np.asarray(10.0, np.float32),
        nswap_att=np.arange(T, dtype=np.float32),
        nswap_acc=np.zeros(T, np.float32),
        scales0=np.ones(Df, np.float32), u_center=np.zeros(Df, np.float32),
        u_scale=np.ones(Df, np.float32))
    betas = np.asarray([1.0, 0.8, 0.6, 0.45, 0.3, 0.2], np.float32)
    u = rng.uniform(size=(T, C)).astype(np.float32)
    return arrays, betas, u


# ---- the ranks' side: module-level functions the spawned ranks import ----

def _rank(r, job, world, init, out, args):
    os.environ.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r))
    torch.set_num_threads(1)
    D.init_distributed("cpu", init_method=init)
    try:
        job(r, out, *args)
    finally:
        D.shutdown()


def _job_swaps(r, out, shape):
    """Each parity's swap on this rank's blocks; the rank's rows saved."""
    for parity in (0, 1):
        arrays, betas, u = _swap_case(parity)
        mesh = SamplerMesh(*shape, r, 6, 4)
        state = shard_state(convert.state_from_arrays(arrays), mesh)
        new = swap_across(torch.as_tensor(betas), state, parity,
                          torch.as_tensor(u), mesh,
                          D.walker_group(mesh) if shape[1] > 1 else None)
        np.savez(os.path.join(out, f"swap{parity}_r{r}.npz"),
                 **convert.state_to_arrays(new))


def _job_fits(r, out, shape, names):
    for name in names:
        state, outs = _fit(name, shape, r)
        if r == 0:
            np.savez(os.path.join(out, f"{name}.npz"), **state,
                     **{f"rec_{k}": v for k, v in outs.items()})


def _spawn(tmp_path, shape, job, *args):
    world = shape[0] * shape[1]
    out = tmp_path / f"mesh{shape[0]}x{shape[1]}_{job.__name__}"
    out.mkdir()
    (out / "rdv").mkdir()
    mp.start_processes(_rank, args=(job, world, f"file://{out}/rdv/store",
                                    str(out), (shape, *args)),
                       nprocs=world, start_method="spawn")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn per mesh shape, every scenario of that shape inside it."""
    tmp = tmp_path_factory.mktemp("mesh_runs")
    plan = {(2, 1): ["drift"], (4, 1): ["drift", "pairs", "cadence"],
            (1, 2): ["drift"], (2, 2): ["drift"], (1, 4): ["auto"]}
    done = {}
    for shape, names in plan.items():
        d = _spawn(tmp, shape, _job_fits, names)
        for name in names:
            done[shape, name] = dict(np.load(d / f"{name}.npz"))
    done["swaps"] = _spawn(tmp, (2, 1), _job_swaps)
    done["swaps 2x2"] = _spawn(tmp, (2, 2), _job_swaps)
    return done


def _local(name):
    state, outs = _fit(name)
    return {**state, **{f"rec_{k}": v for k, v in outs.items()}}


@pytest.mark.parametrize("shape", [(2, 2), (2, 1)], ids=["2x2", "2x1"])
@pytest.mark.parametrize("parity", [0, 1])
def test_boundary_exchange_is_tempering_swap(runs, shape, parity):
    """The ranks' swap, assembled, is the port's tempering_swap on the whole
    ladder bit for bit (with walker shards too: the counter is an integer
    count summed over the shards), and the reference's within 1e-6."""
    import jax
    import jax.numpy as jnp
    from tamcmc_tpu.sampler.state import SamplerState as JState
    from tamcmc_tpu.sampler.tempering import tempering_swap as j_swap
    arrays, betas, u = _swap_case(parity)
    whole = convert.state_to_arrays(tempering_swap(
        torch.as_tensor(betas), convert.state_from_arrays(arrays), parity,
        u=torch.as_tensor(u)))
    mesh = SamplerMesh(*shape, 0, 6, 4)
    key = "swaps" if shape == (2, 1) else "swaps 2x2"
    for r in range(mesh.size):
        got = np.load(runs[key] / f"swap{parity}_r{r}.npz")
        tsl, csl = mesh.blocks(r)
        for f in ("theta", "logL", "logP", "gradL", "gradP"):
            assert np.array_equal(got[f], whole[f][tsl, csl]), (r, f)
        for f in ("nswap_att", "nswap_acc"):
            assert np.array_equal(got[f], whole[f][tsl]), (r, f)
    moved = (whole["theta"] != arrays["theta"]).any(-1)
    assert moved.any() and not moved.all()
    if parity == 0:                 # the pair (2, 3) crosses the boundary
        assert moved[2].any() and np.array_equal(moved[2], moved[3])
    else:                           # rungs 0 and 5 are unpaired
        assert not moved[[0, 5]].any()
    jn = j_swap(jnp.asarray(betas),
                JState(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                jax.random.PRNGKey(0), jnp.asarray(parity),
                u=jnp.asarray(u))
    for f in ("theta", "logL", "logP", "gradL", "gradP", "nswap_att",
              "nswap_acc"):
        np.testing.assert_allclose(whole[f], np.asarray(getattr(jn, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("shape", [(2, 1), (4, 1)], ids=["2x1", "4x1"])
def test_temperature_shards_are_the_local_run_bitwise(runs, shape):
    want = _local("drift")
    got = runs[shape, "drift"]
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert want["rec_theta0"].shape == (10, 8, 3)
    assert want["nswap_att"][:-1].min() > 0


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_walker_shards_agree_with_the_local_run(runs, shape):
    """The walker sums reassociate across ranks: test_shardmap.py's
    tolerances, and the same swap attempts."""
    want = _local("drift")
    got = runs[shape, "drift"]
    np.testing.assert_allclose(got["theta"], want["theta"], rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(got["rec_logL"], want["rec_logL"], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(got["nswap_att"], want["nswap_att"])
    np.testing.assert_allclose(got["rec_mu0"], want["rec_mu0"], rtol=2e-3,
                               atol=2e-3)


def test_every_pair_is_attempted_across_ranks(runs):
    st = runs[(4, 1), "pairs"]         # one rung a rank
    att, acc = st["nswap_att"], st["nswap_acc"]
    assert np.all(att[:-1] > 0), att
    assert np.all(acc <= att + 1e-6)
    assert np.all(np.isfinite(st["theta"]))


def test_swap_cadence_holds_across_ranks(runs):
    """24 steps at dN_mixing=3: 8 swap events of alternating parity, 4 even
    (rungs 0, 2 low) and 4 odd (rung 1 low)."""
    np.testing.assert_allclose(runs[(4, 1), "cadence"]["nswap_att"],
                               [4.0, 4.0, 4.0, 0.0])


def test_auto_estimator_resolves_from_the_global_walker_count(runs):
    """Df=5, C=8: the ensemble estimator (2C >= Df); a shard of 2 walkers
    alone would pick the per-walker one."""
    want, got = _local("auto"), runs[(1, 4), "auto"]
    np.testing.assert_allclose(got["cov"], want["cov"], rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(got["mu"], want["mu"], rtol=2e-4, atol=2e-6)


def test_mesh_table_and_slices():
    assert parse_mesh("4X2") == (4, 2)
    assert set(STATE_SPLIT) == {f.name for f in
                                dataclasses.fields(SamplerState)}
    assert STATE_SPLIT["theta"] == "TC" and STATE_SPLIT["nswap_acc"] == "T"
    m = SamplerMesh(2, 2, 3, 6, 8)
    assert (m.ti, m.ci, m.tsl, m.csl) == (1, 1, slice(3, 6), slice(4, 8))
    with pytest.raises(ValueError, match="must divide"):
        SamplerMesh(4, 1, 0, 6, 8)
    assert D.process_local_slice(10) == (0, 10)     # one process
    assert D.backend() == "none"


def test_eleven_shards_read_back_in_walker_order(tmp_path):
    """host10 sorts after host9, not after host1 (the reference's reader
    sorts the file names as strings)."""
    E, C, Df = 3, 22, 2
    theta0 = np.arange(E * C * Df, dtype=np.float64).reshape(E, C, Df)
    for k in range(11):
        w = OutputWriter(str(tmp_path), ["a", "b"], 1, C,
                         walker_slice=(2 * k, 2 * k + 2),
                         shard_tag=f"host{k}", keep_chains=k == 0)
        w.append_chunk("A", {"theta0": theta0, "logL": np.zeros((E, 1, C))})
        w.close()
    got, names = read_bin_samples(str(tmp_path), "A", with_chains=True)
    assert names == ["a", "b"]
    assert np.array_equal(got, theta0)
    flat, _ = read_bin_samples(str(tmp_path), "A")
    assert np.array_equal(flat[:E * 2], theta0[:, :2].reshape(-1, Df))
    assert np.array_equal(flat[-E * 2:], theta0[:, 20:].reshape(-1, Df))
    assert np.load(tmp_path / "A_chains.npz")["logL"].shape == (E, 1, C)
