"""Differentiable simulation on the port: recover a viscosity from pixels.

    python -m dieselfluid_tpu_torch.examples.fit_material [--cpu]
        [--iters 40] [--seed 0]

Twin of examples/fit_material.py: render an 8-step PCISPH rollout of a
512-particle dam break (n3 = 8, seeded velocities, brute-force neighbors,
d0 calibrated on the state) with a "true" viscosity, then recover it by
sign descent on the pixel loss: torch autograd carries the gradient back
through the splat renderer and the unrolled correction loop
(`pcisph_step(unroll_for_grad=True, materials=)`) to the traced
Materials. The velocities are N(0, 0.3^2) from numpy's generator at
`--seed` (the JAX example's jax.random draw cannot be reproduced). Runs on
the CUDA card unless `--cpu` is given (no fallback).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

MU_TRUE, MU_START = 0.4, 0.05
N3, EXTENT, STEPS, SIZE = 8, 0.5, 8, 96


def setup(device, seed: int = 0):
    """(params, state0, delta, camera, neighbor_fn) of the fit."""
    from dieselfluid_tpu_torch.config import FluidParams
    from dieselfluid_tpu_torch.models.particles import dam_break_state
    from dieselfluid_tpu_torch.neighbors.bruteforce import (
        brute_force_neighborhood)
    from dieselfluid_tpu_torch.neighbors.calibrate import (
        calibrate_rest_density)
    from dieselfluid_tpu_torch.render.camera import Camera
    from dieselfluid_tpu_torch.solvers.pcisph import compute_pci_delta

    import torch

    dx = (2.0 / N3) * EXTENT
    params = FluidParams.for_spacing(dx)
    state0 = dam_break_state(N3, params, device, extent=EXTENT)
    vel = np.random.default_rng(seed).normal(size=(N3 ** 3, 3)) * 0.3
    state0 = state0._replace(vel=torch.as_tensor(vel.astype(np.float32),
                                                 device=device))
    params = calibrate_rest_density(state0.pos, params)
    delta = compute_pci_delta(params, dx)
    cam = Camera.at([0.0, 0.3, -2.2], front=[0.0, -0.15, 1.0],
                    fov_deg=55.0, aspect=1.0, device=device)

    def nfn(p):
        return brute_force_neighborhood(p, p, params.h, 64)

    return params, state0, delta, cam, nfn


def render_rollout(mats, params, state0, delta, cam, nfn, steps=STEPS):
    """The color image of the state after `steps` unrolled PCISPH frames
    under Materials `mats`."""
    from dieselfluid_tpu_torch.render.splat import splat_particles
    from dieselfluid_tpu_torch.solvers.pcisph import pcisph_step

    s = state0
    for _ in range(steps):
        s, _ = pcisph_step(s, params, delta, neighbor_fn=nfn,
                           unroll_for_grad=True, materials=mats)
    return splat_particles(s.pos, (2.0 / N3) * EXTENT * 0.7, cam, SIZE,
                           SIZE).color


def fit(device, iters: int = 40, seed: int = 0, log=print):
    """Sign descent on mu from MU_START: [(loss, mu before the update)] per
    iteration and the final mu."""
    import torch

    from dieselfluid_tpu_torch.models.materials import Materials

    params, state0, delta, cam, nfn = setup(device, seed)
    args = (params, state0, delta, cam, nfn)
    with torch.no_grad():
        target = render_rollout(Materials.from_params(
            params.replace(mu=MU_TRUE), device), *args)
    base = Materials.from_params(params, device)
    mu = MU_START
    history = []
    log(f"true viscosity mu = {MU_TRUE}; starting from {mu}")
    for it in range(iters):
        m = torch.tensor(mu, dtype=torch.float32, device=device,
                         requires_grad=True)
        img = render_rollout(base._replace(mu=m), *args)
        loss = torch.mean((img - target) ** 2)
        (g,) = torch.autograd.grad(loss, m)
        history.append((float(loss.detach()), mu))
        # Sign descent: robust to the loss's scale, converges in ~20 steps.
        mu = float(np.clip(np.float32(mu) - np.float32(0.02)
                           * np.sign(float(g)), 0.01, 2.0))
        if it % 5 == 0:
            log(f"iter {it:2d}: loss={history[-1][0]:.3e} mu={mu:.4f}")
    return history, mu


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    p.add_argument("--iters", type=int, default=40)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        raise RuntimeError("no CUDA device: pass --cpu to run on the CPU")
    _, mu = fit(device, args.iters, args.seed)
    print(f"recovered mu = {mu:.4f} (true {MU_TRUE})")
    if args.iters >= 20:       # 0.02 a step: ~18 steps to travel 0.35
        assert abs(mu - MU_TRUE) < 0.1, "did not converge"
    return 0


if __name__ == "__main__":
    sys.exit(main())
