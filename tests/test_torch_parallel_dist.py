"""The DistMesh (one shard per torch.distributed rank) against the
LocalMesh (every shard in one process), on the CPU over `gloo`.

2 and 4 ranks (and a 2x2 mesh of 4) run tests/torch_parallel_dist_worker.py
as separate processes, joined through a `file://` store in tmp_path; every
wait has a timeout, so a hang fails the test instead of eating the suite.
The sharded dense WCSPH and PCISPH steps (and the 2-D PCISPH) equal the
LocalMesh run bit for bit, rank by rank: the exchanges are copies, and
psum/pmax act on counts and maxima. The Materials gradient of the
differentiated step (all-reduced across ranks) and the sharded training
step (all_gather and psum through autograd) match within a tolerance: an
all-reduce may sum in another order than autograd does on one process.
"""

import os
import subprocess
import sys

import pytest
import torch
import torch_parallel_dist_worker as worker

from dieselfluid_tpu_torch.parallel.mesh import LocalMesh

torch.set_num_threads(1)
TIMEOUT_S = 120
# Relative to the LocalMesh run, measured: the Materials gradients at most
# 1.8e-9 (one ulp of one field: the all-reduce's order), the training
# step's loss, velocities and Materials 0. Bounds allow for a reordered
# float32 sum over 4 ranks.
GRAD_REL_TOL = 1e-6
TRAIN_REL_TOL = 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spawn(tmp_path, shape):
    world = 1
    for s in shape:
        world *= s
    init = tmp_path / "init"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tests"), env.get("PYTHONPATH", "")])
    script = os.path.join(ROOT, "tests", "torch_parallel_dist_worker.py")
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, script, str(init), str(world), str(r), outs[r],
         "x".join(str(s) for s in shape)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [torch.load(o, weights_only=True) for o in outs]


def _block(t, rank, world):
    n = t.shape[0] // world
    return t[rank * n:(rank + 1) * n]


def _assert_ranks_equal_local(ranks, local, case, world):
    for r, res in enumerate(ranks):
        got = res[case]
        for f in ("pos", "vel", "alive", "pressure"):
            assert torch.equal(got[f], _block(local[case][f], r, world)), \
                (case, f, r)
        for f in ("dropped", "max_vel", "n_live", "ovf", "per_slab"):
            assert torch.equal(got[f], local[case][f]), (case, f, r)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("world", [2, 4])
def test_dist_mesh_equals_local_mesh(tmp_path, world):
    ranks = _spawn(tmp_path, (world,))
    local = worker.run_cases(LocalMesh((world,), "cpu"))
    for case in ("wcsph", "pcisph"):
        _assert_ranks_equal_local(ranks, local, case, world)
    assert int(local["pcisph"]["n_live"]) == 216
    for r, res in enumerate(ranks):
        assert _rel(res["grad"]["grads"], local["grad"]["grads"]) \
            <= GRAD_REL_TOL
        t, lt = res["train"], local["train"]
        assert _rel(t["loss"], lt["loss"]) <= TRAIN_REL_TOL
        assert _rel(t["mats"], lt["mats"]) <= TRAIN_REL_TOL
        assert _rel(t["vel0"], _block(lt["vel0"], r, world)) <= TRAIN_REL_TOL


def test_dist_mesh_2d_equals_local_mesh(tmp_path):
    ranks = _spawn(tmp_path, (2, 2))
    local = worker.run_cases(LocalMesh((2, 2), "cpu"))
    _assert_ranks_equal_local(ranks, local, "pcisph_2d", 4)
    assert local["pcisph_2d"]["per_slab"].shape == (2, 2)
