"""Configuration 4's training step, the port's entry point
(`solvers.materials_grad.materials_grad_step`), against the benchmark's
plain reference (`benchmark/reference/grad.py`, loaded by path: plain
PyTorch in float64, no import of the program) on the CPU, from the
benchmark's own seeded starts (`benchmark/reference/sph.py` `dam_break`).

Cut from the cell's 1M particles at 1920x1080, k = 8192: n3 = 10 (1,000
particles) at 128x72 (one tile column, nine tile rows), the sky cube at
size 8, k = 256, where the busiest tiles overflow as the 1M frame does at
k = 8192. Both take the same sky cube (the program's bake, as the check
takes it). The positions' gradients are compared, as the check compares
them, over the particles off the disc's rim (reference/grad.py: there one
rounding of r2 is a large part of a gradient) and off a rounding tie, and
beyond the nearer side of the disc cutoff's ties. One more case holds the
reference's own gradients to its float64 central differences.
"""

import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.models.materials import Materials
from dieselfluid_tpu_torch.models.particles import FluidState, gravity_force
from dieselfluid_tpu_torch.neighbors.calibrate import lattice_rest_density
from dieselfluid_tpu_torch.ops.cellops import DenseCellSpec
from dieselfluid_tpu_torch.sky.bake import bake_sky_cubemap
from dieselfluid_tpu_torch.solvers import materials_grad as mg
from dieselfluid_tpu_torch.solvers.pcisph import compute_pci_delta

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
CPU = torch.device("cpu")
N3, W, H, K = 10, 128, 72, 256
SEEDS = (5300000011, 17, 2 ** 31 + 5)
FIELDS = ("mu", "d0", "mass")


def _load(name):
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, BENCH / "reference" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


sph = _load("sph")
ref = _load("grad")


def _config():
    cfg = json.loads((BENCH / "configs" / "dam1m_grad.json").read_text())
    cfg["n3"] = N3
    cfg["render"].update(width=W, height=H, tile_capacity=K)
    cfg["render"]["sky"]["cube_size"] = 8
    return cfg


CFG = _config()


@pytest.fixture(scope="module")
def cube():
    return bake_sky_cubemap(tuple(CFG["render"]["sky"]["sun"]), 8,
                            device=CPU)


def _program(cfg, start, cube):
    """The entry point's results at `start`, the configuration's own
    parameters, camera and frame."""
    f = cfg["fluid"]
    dx = 2.0 * cfg["extent"] / cfg["n3"]
    params = FluidParams.for_spacing(
        dx, h_factor=f["h_factor"], mass=f["mass"],
        sound_speed=f["sound_speed"], mu=f["mu"]).replace(
            gravity=tuple(f["gravity"]), tait_gamma=f["tait_gamma"],
            pci_max_iters=f["pcisph_max_iters"],
            pci_max_density_error_ratio=f[
                "pcisph_max_density_error_ratio"])
    params = lattice_rest_density(dx, params)
    off = cfg["cells"]["lo_offset_h"] * params.h
    lo = tuple(b - off for b in cfg["box"][0])
    hi = tuple(b + off for b in cfg["box"][1])
    spec = DenseCellSpec.for_domain(lo, hi, params.h,
                                    capacity=cfg["cells"]["capacity"])
    n = start["pos"].shape[0]
    state = FluidState(pos=start["pos"].clone(), vel=start["vel"].clone(),
                       force=gravity_force(params, n, CPU),
                       density=torch.zeros(n), pressure=start["press"])
    mats = Materials.from_params(params, CPU, requires_grad=True)
    r = cfg["render"]
    cam, _ = mg.config4_scene(CPU, position=tuple(r["camera"]["position"]),
                              front=tuple(r["camera"]["front"]),
                              fov_deg=r["camera"]["fov_deg"], width=W,
                              height=H, sun=tuple(r["sky"]["sun"]),
                              cube_size=8)
    box = tuple(tuple(b) for b in cfg["box"])
    return mg.materials_grad_step(
        state, params, spec, compute_pci_delta(params, dx), mats, cam, cube,
        r["radius_dx"] * dx, width=W, height=H, k=K,
        unroll_iters=cfg["layout"]["unroll_iters"], bounds=box)


@pytest.fixture(scope="module", params=SEEDS)
def pair(request, cube):
    """(the program's results, the reference's) from one seeded start."""
    start = sph.dam_break(CFG, request.param, CPU)
    got = _program(CFG, start, cube)
    want = ref.grad_step(start, CFG, sph.params_from_config(CFG), cube,
                         unroll=CFG["layout"]["unroll_iters"])
    return got, want


def test_frame_overflows_as_the_reference_counts(pair):
    """The same entries dropped past k (the stable within-tile rank): the
    counts equal, but for entries on a projection's rounding tie."""
    got, want = pair
    assert want.overflow > 0
    assert abs(int(got.overflow) - want.overflow) <= want.overflow_ties


def test_loss_matches_the_reference(pair):
    """float32 against float64 sums: measured at most 8.6e-8 (relative);
    the bound 1e-6."""
    got, want = pair
    assert abs(float(got.loss) - want.loss) <= 1e-6 * abs(want.loss)


@pytest.mark.parametrize("field", FIELDS)
def test_material_gradient_matches_the_reference(pair, field):
    """Relative to the reference's gradient: measured at most 3.2e-3 (mu:
    its gradient is a small sum of terms of both signs, so float32
    rounding weighs more in it) and 2.3e-4 (d0, mass); the bound 2e-2."""
    got, want = pair
    g, w = float(getattr(got, "grad_" + field)), getattr(want,
                                                          "grad_" + field)
    assert torch.isfinite(torch.tensor(g)) and w != 0.0
    assert abs(g - w) <= 2e-2 * abs(w), (field, g, w)


def test_position_gradient_matches_the_reference(pair):
    """As the check compares them: over the particles off the disc's rim
    and off a projection's or a wall's rounding tie, each entry's miss
    beyond the nearer of the two sides of the cutoff's ties
    (reference/grad.py). Measured norm gap at most 9.2e-5 of the norm
    and largest entry's gap at most 2.6e-4 of the largest entry; the
    bounds 1e-3."""
    got, want = pair
    on = ~((want.rim_gap < ref.RIM) | want.on_tie | want.wall_tie)
    assert on.double().mean() > 2.0 / 3.0
    wp, wa, gp = want.grad_pos[on], want.pos_alt[on], got.grad_pos.double()[on]
    miss = torch.maximum(torch.minimum(wp, wa) - gp,
                         gp - torch.maximum(wp, wa)).clamp(min=0.0)
    assert torch.isfinite(got.grad_pos).all()
    assert float(miss.norm()) <= 1e-3 * float(wp.norm())
    assert float(miss.max()) <= 1e-3 * float(wp.abs().max())


@pytest.mark.parametrize("what", FIELDS + ("pos",))
def test_reference_gradient_matches_central_differences(cube, what):
    """The reference's autograd gradient against float64 central
    differences of its own loss, off the lattice (the seeded jitter), with
    its state and frame in float64 too (in float32 a step of 1e-9 would
    round away): the
    derivative to mu, d0 and mass, and to the positions along a seeded
    direction. Steps of 1e-6 relative; along positions 1e-9: the loss
    steps by ~1e-3 of a pair's weight where a pair crosses the normal's
    cutoff (1 - r2 = 1e-6), and steps of 1e-7 already cross some (the
    difference quotient then misses by 16%). Measured at most 6.3e-6 (mu,
    whose gradient is the smallest) and 9.1e-6 (positions), relative; the
    bound 1e-4."""
    start = sph.dam_break(CFG, 7, CPU)
    pb = ref.Problem(start, CFG, sph.params_from_config(CFG), cube,
                     state_dtype=torch.float64)
    x, mu, d0, mass = pb.leaves()
    loss = pb.loss(x, mu, d0, mass)[0]
    g = dict(zip(("pos",) + FIELDS,
                 torch.autograd.grad(loss, [x, mu, d0, mass])))
    gen = torch.Generator().manual_seed(4)
    direction = torch.randn(x.shape, generator=gen, dtype=torch.float64)
    with torch.no_grad():
        args = {"pos": x, "mu": mu, "d0": d0, "mass": mass}
        if what == "pos":
            eps = 1e-9
            want = float((g["pos"] * direction).sum())
            step = {"pos": direction * eps}
        else:
            eps = 1e-6 * float(args[what][0])
            want = float(g[what].sum())
            step = {what: torch.tensor(eps, dtype=torch.float64)}

        def at(sign):
            a = {k: v + sign * step[k] if k in step else v
                 for k, v in args.items()}
            return float(pb.loss(a["pos"], a["mu"], a["d0"], a["mass"])[0])

        fd = (at(1.0) - at(-1.0)) / (2.0 * eps)
    assert abs(fd - want) <= 1e-4 * abs(want), (what, fd, want)
