"""Dam break end to end on the port: simulate, render a frame, export,
view.

    python -m dieselfluid_tpu_torch.examples.dam_break [--cpu]
        [--frames 300] [--out out/dam_break]

Twin of examples/dam_break.py: a 4,096-particle (n3 = 16) PCISPH dam break
with cell-grid neighbors and a warm start, the positions of every fifth
frame streamed to a .dfc file, a 256x256 splat frame at the middle frame,
and the WebGL viewer installed next to the trajectory. Runs on the CUDA
card unless `--cpu` is given (no fallback).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--out", type=str, default="out/dam_break")
    args = p.parse_args(argv)

    import torch

    from dieselfluid_tpu_torch.app.serve import install_viewer
    from dieselfluid_tpu_torch.config import SimConfig
    from dieselfluid_tpu_torch.io.native import StreamWriter
    from dieselfluid_tpu_torch.models.sph import Simulation
    from dieselfluid_tpu_torch.render.camera import Camera
    from dieselfluid_tpu_torch.render.splat import splat_particles

    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        raise RuntimeError("no CUDA device: pass --cpu to run on the CPU")

    config = SimConfig(n3=16, solver="pcisph", neighbors="cellgrid",
                       warm_start=True)
    sim = Simulation.create(config, device, extent=0.5, scene="dam_break")
    print(f"{sim.n()} particles, h={sim.params.h:.3f}, "
          f"dt={sim.params.dt:.5f}, on {device}")

    cam = Camera.at([0.0, 0.6, -2.8], front=[0.0, -0.35, 1.0],
                    fov_deg=55.0, aspect=1.0, device=device)
    stream = StreamWriter(args.out, "dam_break", sim.n(), mode="dfc")
    middle = args.frames // 2
    for frame in range(args.frames):
        sim.step()
        if frame % 5 == 0:
            stream.append(sim.state.pos.detach().cpu().numpy())
        if frame == middle:
            img = splat_particles(sim.state.pos, sim.dx * 0.7, cam, 256, 256)
            print(f"frame {frame}: coverage {float(img.alpha.mean()):.3f}, "
                  f"max |v| = {float(sim.state.vel.abs().max()):.2f}")

    frames = stream.close()
    install_viewer(args.out)
    print(f"wrote {frames} frames -> {args.out}/dam_break.dfc")
    print(f"view:  python -m dieselfluid_tpu_torch.app.serve {args.out}")
    print("       then open /viewer.html?file=dam_break.dfc")
    return 0


if __name__ == "__main__":
    sys.exit(main())
