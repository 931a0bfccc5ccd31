#!/usr/bin/env python3
"""How sensitive the splat renderer's position gradient is, on the CPU.

    python3 tools/splat_rim_probe.py [--seeds 3 12]

Two measurements, printed as JSON lines:

  1. tiled vs scatter: for 300 seeded splats at 256x144 (the frame of
     tests/test_torch_render.py), the port's tiled renderer (plain K11/K12)
     against its eager scatter renderer: the largest difference of
     d sum(color^2)/d positions relative to the largest entry, beside the
     frame's `splat_tiled.rim_gap` (how near a live pair comes to the
     disc's rim, where 0.5 / sqrt(1 - r2) amplifies one ulp);
  2. JAX against itself: `bench.py` config 3 at n3=8, 256x144, k = 256 (the
     frame of tests/test_torch_sim_render_grad.py after its step), the
     JAX package's `splat_particles_tiled` gradient compiled (jax.jit, as
     the package runs it) against op by op (`jax.disable_jit`), in
     interpret mode, and the alpha = 1 - exp(-acc_a) of the pixel where the
     two images differ most, beside float64's.

Runs the JAX package on the CPU (Pallas interpret mode); a few minutes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402


def tiled_vs_scatter(seed: int) -> dict:
    import torch

    from dieselfluid_tpu_torch.render import splat_tiled as st
    from dieselfluid_tpu_torch.render.camera import Camera
    from dieselfluid_tpu_torch.render.splat import splat_particles

    cam = Camera.at((0.0, 0.0, -2.0), front=(0.0, 0.0, 1.0), fov_deg=60.0,
                    aspect=256 / 144, device="cpu")
    pos = torch.from_numpy(np.random.default_rng(seed).uniform(
        -0.5, 0.5, (300, 3)).astype(np.float32))
    spec = st.TileSpec(256, 144, k=256)
    gap = st.rim_gap(st.tile_entries(pos, 0.05, cam, spec)[0], spec)
    grads = []
    for tiled in (False, True):
        p = pos.clone().requires_grad_()
        img = (st.splat_particles_tiled(p, 0.05, cam, 256, 144, k=256)
               if tiled else splat_particles(p, 0.05, cam, 256, 144))
        (g,) = torch.autograd.grad((img.color ** 2).sum(), p)
        grads.append(g.double())
    rel = float((grads[1] - grads[0]).abs().max() / grads[0].abs().max())
    return {"seed": seed, "rim_gap": gap, "tiled_vs_scatter_rel": rel}


def jax_jit_vs_op_by_op() -> dict:
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from dieselfluid_tpu.config import FluidParams
    from dieselfluid_tpu.models.particles import dam_break_state
    from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density
    from dieselfluid_tpu.ops.cellops import DenseCellSpec
    from dieselfluid_tpu.render.camera import Camera
    from dieselfluid_tpu.render.splat_pallas import splat_particles_tiled
    from dieselfluid_tpu.solvers.dense_step import dense_wcsph_step

    jax.config.update("jax_platforms", "cpu")
    dx = 2.0 / 8 * 0.5
    params = lattice_rest_density(dx, FluidParams.for_spacing(dx))
    s = dam_break_state(8, params, extent=0.5)
    rng = np.random.default_rng(80)
    s = s._replace(pos=s.pos + jnp.asarray(rng.uniform(
        -0.2 * dx, 0.2 * dx, s.pos.shape).astype(np.float32)))
    off = params.h / 4.0
    spec = DenseCellSpec.for_domain((-1 - off,) * 3, (0.0,) * 3, params.h,
                                    capacity=16)
    cam = Camera.at((0.0, 0.6, -2.8), front=(0.0, -0.35, 1.0),
                    fov_deg=55.0, aspect=1920.0 / 1080.0)

    def render(pos):
        img = splat_particles_tiled(pos, dx * 0.7 * 0.6, cam, width=256,
                                    height=144, k=256)
        return jnp.sum(img.color ** 2), img

    with pltpu.force_tpu_interpret_mode():
        nxt = dense_wcsph_step(s, params, spec)[0].pos
        (_, a), ga = jax.value_and_grad(render, has_aux=True)(nxt)
        with jax.disable_jit():
            (_, b), gb = jax.value_and_grad(render, has_aux=True)(nxt)
    ga, gb = np.asarray(ga, np.float64), np.asarray(gb, np.float64)
    da = np.abs(np.asarray(a.alpha) - np.asarray(b.alpha))
    i = np.unravel_index(np.argmax(da), da.shape)
    # acc_a at that pixel, recovered from the op-by-op alpha in float64.
    acc_a = -np.log1p(-np.float64(np.asarray(b.alpha)[i]))
    return {"grad_rel": float(np.abs(ga - gb).max() / np.abs(gb).max()),
            "pixel": [int(x) for x in i],
            "alpha_compiled": float(np.asarray(a.alpha)[i]),
            "alpha_op_by_op": float(np.asarray(b.alpha)[i]),
            "alpha_float64": float(1.0 - np.exp(-acc_a))}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs=2, default=(3, 12))
    args = ap.parse_args()
    for seed in range(*args.seeds):
        print(json.dumps(tiled_vs_scatter(seed)), flush=True)
    print(json.dumps({"jax_jit_vs_op_by_op": jax_jit_vs_op_by_op()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
