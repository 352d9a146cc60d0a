"""The inputs of each cell, pinned: at the CPU cut of `tiny.small`, the
sha256 of every star's problem.toml and spectrum.npz arrays, and of the
reference's log-posterior parts and gradients at the start points, to the
last bit, as the harness computed them before the families were loaded
by name.  A change to the harness that leaves the cells reading what they
read keeps every digest."""

import hashlib

import numpy as np
import pytest
import torch

from benchmark import traffic
from benchmark.tests import tiny

SEED = 2**31 + 29

PINNED = {
    "kepler_full.f64.c512": {
        "star_0/problem.toml":
            "c6933cbfb4b7a9c9f7745ddf3ed34c431984194945b06e1b5cff42ed1c527f94",
        "star_0/spectrum.npz:nu":
            "a9cd8c52b13c6f347017c948459cce8f6e05c186c6457ebcab369dcf64092340",
        "star_0/spectrum.npz:power":
            "07217d3803fa8d584b8c975e6ec77697cba2c8033ae0539d8c30f8bab428f357",
        "log_parts_and_grad":
            "a830b16eaa26a6425839902bb27fd3043c4f69ee94df8cfb657fdc3138bd0af2",
    },
    "kepler_full.stack8": {
        "star_0/problem.toml":
            "1ccb731e549c1c81b25ad060cf7e0c008b71f3cc40f2de713cc7da5ca36e715d",
        "star_0/spectrum.npz:nu":
            "a9cd8c52b13c6f347017c948459cce8f6e05c186c6457ebcab369dcf64092340",
        "star_0/spectrum.npz:power":
            "479b2a79fea38bb57257caaac82696d576df3824826e40b64e83a4cd576e131f",
        "star_1/problem.toml":
            "3f43beb859595a192f8a91a8abb698eadb6324ff648ab38a5dcde467fa753475",
        "star_1/spectrum.npz:nu":
            "a9cd8c52b13c6f347017c948459cce8f6e05c186c6457ebcab369dcf64092340",
        "star_1/spectrum.npz:power":
            "237b6b639ad4730e361510c4e10843fbca6cad62a889ad6ed95f4794605b9554",
        "log_parts_and_grad":
            "3923878593ff9b564c4c71046d778c3d4cd16c2a774b86ab123bccf55aafaefd",
    },
    "subgiant_mixed.stack63": {
        "star_0/problem.toml":
            "254df928ecb29a9f2642ed9987ab4f231966c4684b90bef3fdf9682e6160eb4f",
        "star_0/spectrum.npz:nu":
            "e096bb872b848863851d815f54972dc3ecac3834f70a592d669d4fa056d0d2ed",
        "star_0/spectrum.npz:power":
            "7b4791b85124839323efbc97aa93b612b5e1788168843627ba44681048cf571e",
        "star_1/problem.toml":
            "c09099cd3f338e085cbf46575c93e53146a697138b60fec4d735df17fcaa9b96",
        "star_1/spectrum.npz:nu":
            "e096bb872b848863851d815f54972dc3ecac3834f70a592d669d4fa056d0d2ed",
        "star_1/spectrum.npz:power":
            "e02fd584099930a539f171c0de6f40f3544f129a489027b2d8fa14f7fe51e82c",
        "log_parts_and_grad":
            "d442684feffd3e5b28580ca213d4a255ebbbcd8ec380bf657a6e2912ca343e39",
    },
}


def _sha(*chunks):
    h = hashlib.sha256()
    for c in chunks:
        h.update(c)
    return h.hexdigest()


def _array(a):
    a = np.asarray(a)
    return _sha(f"{a.dtype.str}{a.shape}".encode(), a.tobytes())


def digests(name, tmp):
    """{item: sha256} of the cell `name` at its tiny.small cut."""
    c = tiny.small(name)
    cfg, tr = c.config, c.traffic
    stars = traffic.make_stars(cfg, tr["stars"], tr["catalogue_seed"], SEED,
                               "cpu")
    out = {}
    for path in traffic.write_problems(cfg, stars, cfg["n_temps"],
                                       tr["chains"], tmp):
        star = path.parent.name
        out[f"{star}/problem.toml"] = _sha(path.read_bytes())
        with np.load(path.parent / "spectrum.npz") as z:
            for k in sorted(z.files):
                out[f"{star}/spectrum.npz:{k}"] = _array(z[k])
    target = traffic.reference_target(cfg, stars, "cpu")
    x = torch.as_tensor(stars.p0[:, stars.free])
    (lL, lP), (gL, gP) = target.log_parts_and_grad(
        torch.arange(x.shape[0]), x)
    out["log_parts_and_grad"] = _sha(*(_array(t.numpy()).encode()
                                       for t in (lL, lP, gL, gP)))
    return out


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_cells_inputs_are_pinned(name, tmp_path):
    assert digests(name, tmp_path) == PINNED[name]
