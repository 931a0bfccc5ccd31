"""Slab-decomposed dense PCISPH on the port: a mesh of shards on one card.

    python -m dieselfluid_tpu_torch.examples.distributed_slab [--cpu]
        [--shards 8] [--frames 4] [--out out/slab_ckpt]

Twin of examples/distributed_slab.py: a 512-particle (n3 = 8) dam break
with d0 calibrated on the state, cut into `--shards` x-slabs of whole cell
columns (the JAX example's 8 virtual devices) on a LocalMesh, stepped by
the sharded dense PCISPH with plane-column halos and a warm start, with
the per-slab load printed every other frame; then a slab checkpoint
written, read back and compared. Runs on the CUDA card unless `--cpu` is
given (no fallback).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    p.add_argument("--shards", type=int, default=8)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--out", type=str, default="out/slab_ckpt")
    args = p.parse_args(argv)

    import torch

    from dieselfluid_tpu_torch.config import FluidParams
    from dieselfluid_tpu_torch.io.checkpoint import (
        load_slab_checkpoint,
        save_slab_checkpoint,
    )
    from dieselfluid_tpu_torch.models.particles import dam_break_state
    from dieselfluid_tpu_torch.neighbors.calibrate import (
        calibrate_rest_density)
    from dieselfluid_tpu_torch.parallel.dense_halo import (
        DenseSlabSpec,
        distribute_dense,
        make_dense_halo_pcisph_step,
    )
    from dieselfluid_tpu_torch.parallel.sharding import particle_mesh
    from dieselfluid_tpu_torch.solvers.pcisph import compute_pci_delta

    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        raise RuntimeError("no CUDA device: pass --cpu to run on the CPU")

    n3, extent = 8, 0.5
    dx = (2.0 / n3) * extent
    params = FluidParams.for_spacing(dx)
    state = dam_break_state(n3, params, device, extent=extent)
    params = calibrate_rest_density(state.pos, params)
    delta = compute_pci_delta(params, dx)

    mesh = particle_mesh(args.shards, device)
    spec = DenseSlabSpec.build(args.shards, params.h, capacity=512,
                               migrate_capacity=128, cell_capacity=32)
    slabs = distribute_dense(state, spec)
    step = make_dense_halo_pcisph_step(mesh, spec, params, delta,
                                       warm_start=True)
    for frame in range(args.frames):
        slabs, max_vel, n_live, ovf, per_slab = step(slabs)
        if frame % 2 == 0:
            occ = [int(c) for c in per_slab.tolist()]
            print(f"frame {frame}: n_live={int(n_live)} "
                  f"max|v|={float(max_vel):.3f} overflow={int(ovf)} "
                  f"per-slab={occ} "
                  f"imbalance={max(occ) / max(sum(occ) / len(occ), 1):.2f}")

    save_slab_checkpoint(args.out, slabs, args.frames, params)
    restored, frame, _ = load_slab_checkpoint(args.out, device)
    assert frame == args.frames
    assert float((restored.pos - slabs.pos).abs().max()) < 1e-6
    print("checkpoint round-trip OK: resume with the same step function")
    return 0


if __name__ == "__main__":
    sys.exit(main())
