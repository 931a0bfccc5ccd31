#!/usr/bin/env python3
"""How far the dense steps' gradients move when every position moves by a
few float32 ulps, on the lattice dam break and off it (CPU, plain sweeps).

    python3 tools/torch_grad_kinks.py [--n3 16] [--eps 3e-7]

For each differentiable step (unrolled PCISPH, WCSPH with Materials) and each
start (the lattice of chip_smoke.py's gradient phase, and the same with every
position jittered by a seeded U(-0.2, 0.2) * dx), computes the gradients of
mu, d0, mass and the positions of the loss sum(next.pos * w) at the positions
p and at p * (1 + eps), and prints max |change| / max |gradient| of each. At
the lattice's rest density the Tait clamp max(rho, d0) and the pressure clamp
max(p + delta err, 0) sit at their kinks, so summation-order noise picks the
gradient there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from dieselfluid_tpu_torch.models.materials import Materials  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n3", type=int, default=16)
    ap.add_argument("--eps", type=float, default=3e-7)
    args = ap.parse_args()
    dev = torch.device("cpu")
    dx = (2.0 / args.n3) * chip_smoke.EXTENT
    for jitter in (0.0, 0.2):
        for solver in ("pcisph", "wcsph"):
            grads = []
            for eps in (0.0, args.eps):
                params, state, spec, delta, w = chip_smoke.grad_setup(
                    args.n3, dev)
                j = np.random.default_rng(3).uniform(
                    -jitter * dx, jitter * dx, size=tuple(state.pos.shape))
                pos = (state.pos + torch.from_numpy(j.astype(np.float32))) \
                    * (1.0 + eps)
                mats = Materials.from_params(params, dev, requires_grad=True)
                _, g, _ = chip_smoke.loss_and_grads(
                    solver, params, state._replace(pos=pos), spec, delta, w,
                    mats, standin=True)
                grads.append([x.detach().double() for x in g])
            rel = {name: float((a - b).abs().max() / b.abs().max())
                   for name, a, b in zip(("mu", "d0", "mass", "pos"),
                                         *grads)}
            print(json.dumps({"n3": args.n3, "solver": solver,
                              "jitter_dx": jitter, "eps": args.eps,
                              "rel_change": rel}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
