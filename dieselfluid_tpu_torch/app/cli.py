"""dieselfluid batch CLI on the PyTorch port: run a simulation, render
frames, export animations, checkpoint (counterpart of
dieselfluid_tpu/app/cli.py, same flags, defaults and summary line).

Usage:
  python -m dieselfluid_tpu_torch.app.cli --neighbors dense --solver pcisph \\
      --column-skip --warm-start --render --guard --checkpoint-every 50 \\
      --stream dfc --viewer --out out

Runs on the CUDA card unless `--cpu` is given; without a card it raises
(it never falls back to the CPU). `--neighbors cellgrid` (the default) and
`bruteforce` run the fixed-degree neighbor solvers, `dense` the dense-cell
solvers and their kernels. `--render` draws the eager splat renderer, lit
by the baked sky with `--sky`, and composited over a ray-traced glTF scene
with `--gltf`. The last
line of standard output is a JSON summary: steps, particles, wall_s,
particle_steps_per_s, max_vel, overflow, recoveries, outputs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dieselfluid", description=__doc__)
    p.add_argument("--n3", type=int, default=12,
                   help="cubic root of particle count (ref default 16 -> 4096)")
    p.add_argument("--solver", choices=["wcsph", "pcisph"], default="wcsph")
    p.add_argument("--neighbors", choices=["cellgrid", "bruteforce", "dense"],
                   default="cellgrid",
                   help="'dense' = the dense-cell path and its kernels")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--extent", type=float, default=0.5,
                   help="dam-break column extent")
    p.add_argument("--scene", choices=["dam_break", "lattice"],
                   default="dam_break")
    p.add_argument("--out", type=str, default="out")
    p.add_argument("--render", action="store_true",
                   help="render frames while stepping")
    p.add_argument("--gltf", type=str, default=None,
                   help="GLTF scene to composite the fluid into")
    p.add_argument("--sky", action="store_true",
                   help="bake an atmosphere cubemap as the environment light")
    p.add_argument("--sun-dir", type=str, default="0.3,0.8,0.5",
                   help="sun direction for --sky as 'x,y,z'")
    p.add_argument("--sky-size", type=int, default=48,
                   help="cubemap face resolution for --sky")
    p.add_argument("--render-every", type=int, default=5)
    p.add_argument("--size", type=int, default=384, help="render resolution")
    p.add_argument("--video", action="store_true",
                   help="write mp4 from rendered frames")
    p.add_argument("--ply", action="store_true",
                   help="write per-frame PLY point clouds")
    p.add_argument("--stream", choices=["dfc", "ply"], default=None,
                   help="stream frames to disk on the native writer thread "
                        "(io/native.py StreamWriter) instead of buffering "
                        "the trajectory in memory")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint dir to resume")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    p.add_argument("--warm-start", action="store_true",
                   help="PCISPH: carry pressure across frames (fewer "
                        "correction iterations; deviates from the "
                        "reference's per-frame Press=0 reset)")
    p.add_argument("--column-skip", action="store_true",
                   help="dense PCISPH: skip re-sweeping converged regions "
                        "(tol/10 freeze; the active-gated sweeps, see "
                        "dense_step.pcisph_skip_loop)")
    p.add_argument("--viewer", action="store_true",
                   help="install the WebGL trajectory viewer next to the "
                        "outputs (serve with python -m "
                        "dieselfluid_tpu_torch.app.serve OUT)")
    p.add_argument("--guard", action="store_true",
                   help="run under failure detection: periodic health "
                        "checks on the device, rollback + dt backoff on "
                        "divergence (utils/guard.py)")
    p.add_argument("--control", type=str, default=None,
                   help="poll this JSON file between frames and honor "
                        '{"paused": bool, "quit": bool} (app/serve.py '
                        "POST /control writes it)")
    return p


def _poll_control(path, state_cache):
    """Honor control.json between frames. Returns 'quit' or 'run'; blocks
    in a short sleep loop while paused (re-reading the file each time)."""

    def read():
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            return None
        if state_cache.get("mtime") == mtime:
            return state_cache.get("last")
        try:
            with open(path) as f:
                parsed = json.load(f)
        except (OSError, ValueError):
            return state_cache.get("last")
        state_cache["mtime"] = mtime
        state_cache["last"] = parsed
        return parsed

    while True:
        c = read() or {}
        if c.get("quit"):
            return "quit"
        if not c.get("paused"):
            return "run"
        if not state_cache.get("announced_pause"):
            print("control: paused (POST /control {\"paused\": false} to "
                  "resume)", flush=True)
            state_cache["announced_pause"] = True
        time.sleep(0.2)


def _frame_renderer(args, sim, cam, device):
    """pos -> (H, W, 3) frame: the eager splat render, lit by the baked sky
    cubemap with --sky, composited over the ray-traced glTF scene (its
    materials, UVs and textures) with --gltf."""
    from dieselfluid_tpu_torch.render.splat import splat_particles

    env = None
    if args.sky:
        from dieselfluid_tpu_torch.sky.bake import bake_sky_cubemap

        sun = tuple(float(c) for c in args.sun_dir.split(","))
        env = bake_sky_cubemap(sun, size=args.sky_size, device=device)
    if not args.gltf:
        return lambda pos: splat_particles(pos, sim.dx * 0.7, cam, args.size,
                                           args.size, env_cube=env).color
    from dieselfluid_tpu_torch.render.composite import render_composite
    from dieselfluid_tpu_torch.render.scene import Scene

    sc = Scene.load(args.gltf)
    tris, norms, mats = sc.triangle_soup(device=device)
    uvs = sc.triangle_uvs(device=device)
    textures, base_tex, norm_tex = sc.texture_stack(device=device)
    materials = sc.stacked_materials(device=device)

    def render_frame(pos):
        return render_composite(
            pos, sim.dx * 0.7, cam, tris, norms, mats, materials,
            light_pos=(2.0, 3.0, -2.0), env_cube=env, width=args.size,
            height=args.size, tri_uvs=uvs, textures=textures,
            mat_base_tex=base_tex, mat_normal_tex=norm_tex).color

    return render_frame


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from dieselfluid_tpu_torch.config import SimConfig
    from dieselfluid_tpu_torch.io.animation import AnimationWriter
    from dieselfluid_tpu_torch.io.checkpoint import (Checkpointer,
                                                     load_checkpoint)
    from dieselfluid_tpu_torch.models.sph import Simulation
    from dieselfluid_tpu_torch.render.camera import Camera

    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "false): pass --cpu to run on the CPU")

    config = SimConfig(n3=args.n3, solver=args.solver,
                       neighbors=args.neighbors, warm_start=args.warm_start,
                       column_skip=args.column_skip)
    sim = Simulation.create(config, device, extent=args.extent,
                            scene=args.scene)
    if args.resume:
        state, step, _, _ = load_checkpoint(args.resume, device)
        sim.state = state
        sim.step_count = step
        print(f"resumed from {args.resume} at step {step}")

    print(f"dieselfluid_tpu_torch: {sim.n()} particles, "
          f"{args.solver}/{args.neighbors} on {device}, "
          f"h={sim.params.h:.4f} dt={sim.params.dt:.5f} d0={sim.params.d0:.1f}"
          + (f" delta={sim.delta:.1f}" if args.solver == "pcisph" else ""))

    cam = Camera.at([0.0, 0.6, -2.8], front=[0.0, -0.35, 1.0],
                    fov_deg=55.0, aspect=1.0, device=device)

    render_frame = None
    if args.render:
        render_frame = _frame_renderer(args, sim, cam, device)

    def host(pos):
        return pos.detach().cpu().numpy()

    writer = AnimationWriter(args.out, name=f"{args.solver}_{args.n3}")
    stream = None
    if args.stream:
        from dieselfluid_tpu_torch.io.native import StreamWriter

        stream = StreamWriter(args.out, f"{args.solver}_{args.n3}", sim.n(),
                              mode=args.stream)
    ckptr = (Checkpointer(args.out + "/ckpt", interval=args.checkpoint_every)
             if args.checkpoint_every else None)

    runner = None
    if args.guard:
        from dieselfluid_tpu_torch.models.sph import build_step_fn
        from dieselfluid_tpu_torch.utils.guard import GuardedRunner

        runner = GuardedRunner(
            sim.state, sim.params,
            lambda prm: build_step_fn(config, prm, sim.delta),
            check_every=max(1, args.render_every), checkpointer=ckptr)

    t0 = time.perf_counter()
    diag = None
    rep = None
    ctl = {}
    if runner is not None:
        frame = 0
        while frame < args.steps:
            if args.control and _poll_control(args.control, ctl) == "quit":
                print(f"control: quit at frame {frame}", flush=True)
                break
            n = min(max(1, args.render_every), args.steps - frame)
            rep = runner.run(n)
            frame += n
            sim.state, sim.step_count = runner.state, runner.step_count
            if stream is not None:
                stream.append(host(sim.state.pos))
            if args.render:
                writer.add_frame(sim.state.pos,
                                 image=render_frame(sim.state.pos))
            elif args.ply:
                writer.add_frame(sim.state.pos)
        if runner.recoveries:
            print(f"guard: {runner.recoveries} recoveries, "
                  f"dt now {runner.params.dt:.6f}")
    else:
        for frame in range(args.steps):
            if args.control and _poll_control(args.control, ctl) == "quit":
                print(f"control: quit at frame {frame}", flush=True)
                break
            diag = sim.step()
            if stream is not None and frame % args.render_every == 0:
                stream.append(host(sim.state.pos))
            if args.render and frame % args.render_every == 0:
                writer.add_frame(sim.state.pos,
                                 image=render_frame(sim.state.pos))
            elif args.ply:
                writer.add_frame(sim.state.pos)
            elif stream is None and frame % args.render_every == 0:
                # The npz trajectory samples, unless --stream already
                # drains the frames to disk with bounded host memory.
                writer.add_frame(sim.state.pos)
            if ckptr:
                ckptr.maybe_save(sim.state, sim.step_count, sim.params,
                                 config)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0

    outputs = {}
    if writer.frames:
        outputs["npz"] = writer.write_npz({"config": config.to_json()})
    if args.viewer:
        from dieselfluid_tpu_torch.app.serve import install_viewer

        outputs["viewer"] = install_viewer(args.out)
    if stream is not None:
        outputs["stream"] = f"{stream.close()} frames ({args.stream})"
    if args.ply:
        outputs["ply"] = f"{len(writer.write_ply_sequence())} files"
    if args.video and writer.images:
        outputs["video"] = writer.write_video()

    max_vel = overflow = None
    if diag is not None:
        max_vel = float(diag.max_vel)
        overflow = int(diag.overflow)
    elif rep is not None:
        max_vel = float(rep.max_vel)
        overflow = int(rep.overflow)
    if overflow:
        print(f"WARNING: neighbor-structure overflow={overflow} on the last "
              "step; raise cell_capacity", file=sys.stderr)
    print(json.dumps({
        "steps": args.steps,
        "particles": sim.n(),
        "wall_s": round(dt, 2),
        "particle_steps_per_s": round(sim.n() * args.steps / dt, 1),
        "max_vel": max_vel,
        "overflow": overflow,
        "recoveries": runner.recoveries if runner else 0,
        "outputs": outputs,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
