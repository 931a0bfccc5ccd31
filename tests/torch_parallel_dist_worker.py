"""One rank of the DistMesh tests (tests/test_torch_parallel_dist.py), and
the cases both meshes run.

    python tests/torch_parallel_dist_worker.py INIT_FILE WORLD RANK OUT

joins a `gloo` group of WORLD ranks through the file INIT_FILE, runs
`run_cases` on a DistMesh (one shard per rank) and writes its results
with torch.save to OUT. The test runs the same cases on a LocalMesh in its
own process and compares. Inputs are made from seeds with numpy, on the
CPU: a dam break (n3 = 6) with seeded velocities and warm pressures.
"""

import sys

import numpy as np
import torch

N3 = 6
STEPS = 2


def _params_and_state():
    from dieselfluid_tpu_torch.config import FluidParams
    from dieselfluid_tpu_torch.models.particles import dam_break_state

    dx = (2.0 / N3) * 0.5
    params = FluidParams.for_spacing(dx)
    s = dam_break_state(N3, params, torch.device("cpu"))
    params = params.replace(d0=float(1.1 * params.d0))
    rng = np.random.default_rng(11)
    vel = torch.from_numpy((rng.normal(size=tuple(s.vel.shape))
                            * 0.5).astype(np.float32))
    jitter = torch.from_numpy(rng.uniform(-0.2, 0.2, tuple(
        s.pos.shape)).astype(np.float32)) * dx
    press = torch.from_numpy(rng.uniform(0, 100, s.n).astype(np.float32))
    return params, s._replace(pos=s.pos + jitter, vel=vel,
                              pressure=press), dx


def _rows(slabs):
    return {f: getattr(slabs, f).detach().clone()
            for f in ("pos", "vel", "alive", "pressure", "dropped")}


def run_cases(mesh):
    """Every case on `mesh`; returns {case: {name: tensor}} with the slab
    rows this process holds."""
    from dieselfluid_tpu_torch.models.materials import Materials
    from dieselfluid_tpu_torch.parallel import dense_halo as tdh
    from dieselfluid_tpu_torch.parallel import dense_halo2d as td2
    from dieselfluid_tpu_torch.parallel.halo import local_slabs
    from dieselfluid_tpu_torch.parallel.sharding import (
        shard_state,
        sharded_train_step,
    )
    from dieselfluid_tpu_torch.solvers.pcisph import compute_pci_delta

    params, state, dx = _params_and_state()
    delta = compute_pci_delta(params, dx)
    out = {}
    if len(mesh.shape) == 1:
        n = mesh.shape[0]
        spec = tdh.DenseSlabSpec.build(n, params.h, capacity=256,
                                       migrate_capacity=64, cell_capacity=16)
        glob = tdh.distribute_dense(state, spec)
        for name, step in (
                ("wcsph", tdh.make_dense_halo_wcsph_step(mesh, spec, params)),
                ("pcisph", tdh.make_dense_halo_pcisph_step(
                    mesh, spec, params, delta, warm_start=True))):
            slabs = local_slabs(mesh, glob)
            for _ in range(STEPS):
                slabs, max_vel, n_live, ovf, per_slab = step(slabs)
            out[name] = {**_rows(slabs), "max_vel": max_vel,
                         "n_live": n_live, "ovf": ovf, "per_slab": per_slab}

        mats = Materials.from_params(params, torch.device("cpu"),
                                     requires_grad=True)
        gstep = tdh.make_dense_halo_wcsph_step(mesh, spec, params,
                                               materials_arg=True)
        slabs, *_ = gstep(local_slabs(mesh, glob), mats)
        loss = ((slabs.alive > 0)[:, None] * torch.sin(3.0 * slabs.pos)).sum()
        grads = list(torch.autograd.grad(loss, list(mats)))
        mesh.sync_grads(grads)
        out["grad"] = {"grads": torch.stack(grads)}

        train = sharded_train_step(mesh, params, n_sim_steps=2,
                                   neighbor_k=32)
        sstate = shard_state(state, mesh)
        loss, vel0, new_mats = train(
            sstate.vel, Materials.from_params(params, torch.device("cpu")),
            sstate)
        out["train"] = {"loss": loss, "vel0": vel0,
                        "mats": torch.stack(list(new_mats))}
    else:
        spec = td2.DenseSlab2DSpec.build_for_state(
            state, mesh.shape[0], mesh.shape[1], params.h,
            migrate_capacity=32)
        slabs = local_slabs(mesh, td2.distribute_2d(state, spec))
        step = td2.make_dense_halo_pcisph_step_2d(mesh, spec, params, delta,
                                                  warm_start=True)
        for _ in range(STEPS):
            slabs, max_vel, n_live, ovf, per_slab = step(slabs)
        out["pcisph_2d"] = {**_rows(slabs), "max_vel": max_vel,
                            "n_live": n_live, "ovf": ovf,
                            "per_slab": per_slab}
    return out


def main(argv) -> int:
    import torch.distributed as dist

    from dieselfluid_tpu_torch.parallel.mesh import DistMesh

    init_file, world, rank, out_path, shape = argv
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=int(world), rank=int(rank))
    try:
        mesh = DistMesh(tuple(int(s) for s in shape.split("x")))
        torch.save(run_cases(mesh), out_path)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
