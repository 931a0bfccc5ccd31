"""Step-by-step comparison of the plane-resident PCISPH dam break: the JAX
package (Pallas sweeps in TPU interpret mode) against the PyTorch port
(plain sweeps), both on the CPU, from the same initial state.

    python tools/torch_pcisph_vs_jax.py --n3 24 --steps 40

Uses bench.py's dam break and parameters (extent 0.5, capacity 16, skin
0.05, warm start). Prints one JSON line per step with each solver's
iterations, rebuilds, max|v|, mean y and mean vy, the largest position
difference between the two, and g*t, the speed a free fall would have
reached. Interpret mode is slow: about 25 s per JAX step at n3=16.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from dieselfluid_tpu.config import FluidParams  # noqa: E402
from dieselfluid_tpu.models.particles import dam_break_state  # noqa: E402
from dieselfluid_tpu.neighbors.calibrate import (  # noqa: E402
    lattice_rest_density)
from dieselfluid_tpu.ops.cellops import DenseCellSpec  # noqa: E402
from dieselfluid_tpu.solvers import dense_resident as jdr  # noqa: E402
from dieselfluid_tpu.solvers.pcisph import compute_pci_delta  # noqa: E402
from dieselfluid_tpu_torch import interop  # noqa: E402
from dieselfluid_tpu_torch.solvers import dense_resident as tdr  # noqa: E402


def stats(pos: np.ndarray, vel: np.ndarray) -> dict:
    return {"max_v": float(np.linalg.norm(vel, axis=-1).max()),
            "mean_y": float(pos[:, 1].mean()),
            "mean_vy": float(vel[:, 1].mean())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n3", type=int, default=16)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)

    dx = 1.0 / args.n3
    params = FluidParams.for_spacing(dx)
    state = dam_break_state(args.n3, params, extent=0.5)
    params = lattice_rest_density(dx, params)
    delta = compute_pci_delta(params, dx)
    off = params.h / 4.0
    jspec = DenseCellSpec.for_domain((-1 - off,) * 3, (1 + off,) * 3,
                                     params.h, capacity=16)
    spec = interop.cell_spec_from_jax(jspec)
    tparams = interop.fluid_params_from(params)
    n = int(state.pos.shape[0])
    ts = interop.fluid_state_from_numpy(
        np.asarray(state.pos), np.asarray(state.vel), np.asarray(state.force),
        np.asarray(state.density), np.asarray(state.pressure), device="cpu")
    ps = tdr.plane_state_from_fluid(ts, spec)
    print(json.dumps({"n3": args.n3, "n": n, "dt": params.dt,
                      "skin": 0.05, "warm_start": True}), flush=True)
    with pltpu.force_tpu_interpret_mode():
        jps = jax.jit(lambda s: jdr.plane_state_from_fluid(s, jspec))(state)
        jstep = jax.jit(lambda p: jdr.dense_pcisph_resident_step(
            p, params, jspec, delta, skin=0.05, warm_start=True))
        t0 = time.perf_counter()
        for i in range(1, args.steps + 1):
            jps, jit_ = jstep(jps)
            ps, tit = tdr.dense_pcisph_resident_step(
                ps, tparams, spec, delta, skin=0.05, warm_start=True)
            js = jdr.fluid_state_from_planes(jps, n, params, jspec)
            jpos, jvel = np.asarray(js.pos), np.asarray(js.vel)
            st = tdr.fluid_state_from_planes(ps, n, tparams, spec)
            tpos, tvel = st.pos.numpy(), st.vel.numpy()
            print(json.dumps({
                "step": i, "iters": [int(jit_), tit],
                "rebuilds": [int(jps.rebuilds), int(ps.rebuilds)],
                "jax": stats(jpos, jvel), "port": stats(tpos, tvel),
                "max_dpos": float(np.abs(jpos - tpos).max()),
                "max_dvel": float(np.abs(jvel - tvel).max()),
                "free_fall_v": 9.81 * params.dt * i,
                "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
