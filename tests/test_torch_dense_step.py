"""The port's per-step dense solvers against the JAX package's.

dense_wcsph_step and dense_pcisph_step (plane-resident correction loop) take
the same numpy state (a 512-particle dam break with seeded velocities) for
three steps in both packages; the JAX sweeps run in Pallas interpret mode.
Tolerances are relative to each field's largest magnitude, about 10x the
measured drift (stated beside each).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dieselfluid_tpu.config import FluidParams, SimConfig
from dieselfluid_tpu.models.particles import dam_break_state
from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density
from dieselfluid_tpu.ops import cellops as jc
from dieselfluid_tpu.solvers import dense_step as jds
from dieselfluid_tpu.solvers.pcisph import compute_pci_delta
from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.models.sph import Simulation
from dieselfluid_tpu_torch.solvers import dense_step as tds

torch.set_num_threads(1)

N3 = 8
DX = (2.0 / N3) * 0.5
STEPS = 3
# field -> max |port - jax| / max |jax| after each step (measured: pos
# 1.2e-7, vel 5.2e-6, density 3.8e-7, PCISPH pressure 1.7e-5).
REL_TOL = {"pos": 1e-6, "vel": 5e-5, "density": 3e-6, "pressure": 2e-4}


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(got.numpy() - want).max() / max(np.abs(want).max(), 1e-30)


def _numpy_state(params, seed=1, vel_scale=1.0):
    s = dam_break_state(N3, params, extent=0.5)
    rng = np.random.default_rng(seed)
    vel = (rng.normal(size=s.vel.shape) * vel_scale).astype(np.float32)
    return {"pos": np.asarray(s.pos), "vel": vel, "force": np.asarray(s.force),
            "density": np.asarray(s.density),
            "pressure": np.asarray(s.pressure)}


@pytest.fixture(scope="module")
def setup():
    params = lattice_rest_density(DX, FluidParams.for_spacing(DX))
    jspec = jc.DenseCellSpec.for_domain((-1,) * 3, (1,) * 3, params.h,
                                        capacity=16)
    return params, jspec, interop.cell_spec_from_jax(jspec), \
        compute_pci_delta(params, DX)


def _pair_states(arrays, boundary=None):
    from dieselfluid_tpu.models.particles import FluidState

    js = FluidState(**{k: jnp.asarray(v) for k, v in arrays.items()},
                    boundary_pos=None if boundary is None
                    else jnp.asarray(boundary))
    ts = interop.fluid_state_from_numpy(**arrays, boundary_pos=boundary,
                                        device="cpu")
    return js, ts


def _run_both(setup, solver, arrays, steps, boundary=None):
    params, jspec, spec, delta = setup
    tparams = interop.fluid_params_from(params)
    js, ts = _pair_states(arrays, boundary)
    out = []
    with pltpu.force_tpu_interpret_mode():
        for _ in range(steps):
            if solver == "wcsph":
                js, jd = jds.dense_wcsph_step(js, params, jspec)
                ts, td = tds.dense_wcsph_step(ts, tparams, spec)
            else:
                js, jd = jds.dense_pcisph_step(js, params, jspec, delta,
                                               warm_start=True)
                ts, td = tds.dense_pcisph_step(ts, tparams, spec, delta,
                                               warm_start=True)
            out.append((js, jd, ts, td))
    return out


@pytest.fixture(scope="module")
def wcsph_run(setup):
    return _run_both(setup, "wcsph", _numpy_state(setup[0]), STEPS)


@pytest.fixture(scope="module")
def pcisph_run(setup):
    return _run_both(setup, "pcisph", _numpy_state(setup[0]), STEPS)


@pytest.mark.parametrize("field", ["pos", "vel", "density", "pressure"])
def test_wcsph_step_matches_jax(setup, wcsph_run, field):
    for js, jd, ts, td in wcsph_run:
        assert _rel(getattr(ts, field), getattr(js, field)) < REL_TOL[field]
        assert int(td.overflow) == int(jd.overflow)
    start = _numpy_state(setup[0])["pos"]
    assert float(np.abs(wcsph_run[-1][2].pos.numpy() - start).max()) > 0.0


@pytest.mark.parametrize("field", ["pos", "vel", "density", "pressure"])
def test_pcisph_step_matches_jax(pcisph_run, field):
    for js, jd, ts, td in pcisph_run:
        assert _rel(getattr(ts, field), getattr(js, field)) < REL_TOL[field]
        assert td.iters == int(jd.iters)
        assert int(td.overflow) == int(jd.overflow)
    assert max(td.iters for *_, td in pcisph_run) > 1   # the loop iterates


def test_pcisph_step_with_boundary_particles_matches_jax(setup):
    """A wall of frozen boundary particles at x = 0, one lattice spacing
    past the dam's face, so they enter the fluid's stencils. (Boundary
    particles placed INSIDE the fluid blow the step up past the sound
    speed, and the frozen-binning predictions then move pairs two cells
    apart, where the two packages' candidate sets differ: ROADMAP C.)"""
    yz = np.arange(-1.0, 0.0 + 1e-9, DX)
    gy, gz = np.meshgrid(yz, yz, indexing="ij")
    b = np.stack([np.zeros(gy.size), gy.ravel(), gz.ravel()], -1)
    (js, jd, ts, td), = _run_both(setup, "pcisph", _numpy_state(setup[0]), 1,
                                  boundary=b.astype(np.float32))
    for field in ("pos", "vel", "density", "pressure"):
        assert _rel(getattr(ts, field), getattr(js, field)) < REL_TOL[field]
    assert td.iters == int(jd.iters)
    np.testing.assert_array_equal(ts.boundary_pos.numpy(), b)
    assert float(np.abs(np.asarray(js.vel)).max()) < 25.0   # gentle step


def test_pcisph_overflowed_particles_get_gravity_only(setup):
    """An overflowed particle's clamped slot aliases a live one; every gather
    is masked so it falls back to rho = d0 and gravity-only force."""
    params, _, _, delta = setup
    tight = tds.DenseCellSpec.for_domain((-1,) * 3, (1,) * 3, params.h,
                                         capacity=2)
    ts = interop.fluid_state_from_numpy(**_numpy_state(params),
                                        device="cpu")
    _, valid, overflow = tds.dense_indices(ts.pos, tight)
    assert int(overflow) > 0
    nxt, diag = tds.dense_pcisph_step(ts, interop.fluid_params_from(params),
                                      tight, delta, bounds=None)
    assert int(diag.overflow) == int(overflow)
    inval = ~valid.numpy()
    np.testing.assert_allclose(nxt.density.numpy()[inval], params.d0,
                               rtol=1e-6)
    gravity = np.asarray(params.gravity, np.float32) * params.mass
    np.testing.assert_allclose(nxt.force.numpy()[inval],
                               np.broadcast_to(gravity, (inval.sum(), 3)),
                               atol=1e-6)
    assert torch.isfinite(nxt.pos).all()


def test_simulation_facade_matches_jax_setup():
    """Simulation.create(neighbors="dense") builds the same params, delta
    and initial state as the JAX facade (whose step the tests above hold
    the port's to), then steps and rolls out."""
    from dieselfluid_tpu.models.sph import Simulation as JSimulation

    cfg = SimConfig(n3=N3, neighbors="dense", solver="pcisph")
    sim = Simulation.create(cfg, device="cpu")
    jsim = JSimulation.create(cfg)
    assert sim.params == interop.fluid_params_from(jsim.params)
    assert sim.delta == jsim.delta
    np.testing.assert_array_equal(sim.state.pos.numpy(),
                                  np.asarray(jsim.state.pos))
    d = sim.step(1)
    assert 1 <= d.iters <= sim.params.pci_max_iters
    assert int(d.overflow) == 0
    traj, vmax = sim.rollout(2)
    assert tuple(traj.shape) == (2, N3 ** 3, 3) and vmax.shape == (2,)
    assert sim.step_count == 3 and torch.isfinite(traj).all()
