"""The convergence-gated PCISPH step (`column_skip=True`) of the port
against the JAX package's, and against the port's own ungated loop.

`dense_pcisph_step(column_skip=True, warm_start=True)` takes two steps of
the slammed 8^3 dam break of tests/test_pallas_dense.py:279-286 in both
packages (the JAX sweeps in Pallas interpret mode; the same iterations each
step), and three in the port beside its ungated loop. Also: the
`Simulation` facade with `column_skip=True`, `unroll_for_grad=True`
ignoring `column_skip`, and the gated sweeps' backward raising. The
kernels' own parity is tests/test_torch_column_skip.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dieselfluid_tpu.config import FluidParams
from dieselfluid_tpu.models.particles import dam_break_state
from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density
from dieselfluid_tpu.ops import cellops as jc
from dieselfluid_tpu.solvers import dense_step as jds
from dieselfluid_tpu.solvers.pcisph import compute_pci_delta
from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.config import SimConfig
from dieselfluid_tpu_torch.models.sph import Simulation
from dieselfluid_tpu_torch.ops import sph_sweep as sw
from dieselfluid_tpu_torch.ops.smoothing import KernelCoeffs
from dieselfluid_tpu_torch.solvers import dense_step as tds

torch.set_num_threads(1)

# Gated step vs JAX's, max |diff| / max |JAX| per field after each of two
# steps (measured: pos 6.0e-8, vel 1.2e-5, pressure 1.2e-5).
STEP_REL_TOL = {"pos": 1e-6, "vel": 1e-4, "pressure": 1e-4}
# Gated loop vs the port's own ungated loop over three slammed steps,
# absolute (the JAX test's bounds are dpos < 1e-4, dvel < 1e-3; measured
# here: dpos 0, dvel 0: at this size only patches without fluid
# freeze, so the gated loop computes what the ungated one does).
TRACK_DPOS, TRACK_DVEL = 1e-6, 1e-5
SWEEPS = ("density", "pressure", "pressure_pq")


def _gated_calls(mod, planes, spec, k, mass, active):
    return {
        "density": lambda: (mod.density_planes_active(planes, spec, k, mass,
                                                      active),),
        "pressure": lambda: tuple(mod.pressure_force_planes_active(
            planes, planes["rho"], planes["press"], spec, k, mass, active)),
        "pressure_pq": lambda: tuple(mod.pressure_force_pq_planes(
            planes, planes["pq"], spec, k, mass, active=active)),
    }


N3 = 8
DX = (2.0 / N3) * 0.5


def _slammed():
    """tests/test_pallas_dense.py:279-286: the 8^3 dam break thrown down at
    1 unit/s, so the loop iterates more than once."""
    params = lattice_rest_density(DX, FluidParams.for_spacing(DX))
    s = dam_break_state(N3, params, extent=0.5)
    s = s._replace(vel=s.vel + jnp.asarray([0.0, -1.0, 0.0]))
    arrays = {f: np.asarray(getattr(s, f)) for f in
              ("pos", "vel", "force", "density", "pressure")}
    jspec = jc.DenseCellSpec.for_domain((-1,) * 3, (1,) * 3, params.h,
                                        capacity=16)
    return params, jspec, arrays, compute_pci_delta(params, DX)


@pytest.fixture(scope="module")
def slammed_runs():
    """Two gated steps in both packages, three gated and ungated steps in
    the port."""
    params, jspec, arrays, delta = _slammed()
    from dieselfluid_tpu.models.particles import FluidState

    js = FluidState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jax_steps = []
    with pltpu.force_tpu_interpret_mode():
        for _ in range(2):
            js, jd = jds.dense_pcisph_step(js, params, jspec, delta,
                                           warm_start=True, column_skip=True)
            jax_steps.append(({f: np.asarray(getattr(js, f))
                               for f in ("pos", "vel", "pressure")},
                              int(jd.iters)))
    tparams = interop.fluid_params_from(params)
    spec = interop.cell_spec_from_jax(jspec)
    port = {}
    for skip in (True, False):
        ts = interop.fluid_state_from_numpy(**arrays, device="cpu")
        out = []
        for _ in range(3):
            ts, td = tds.dense_pcisph_step(ts, tparams, spec, delta,
                                           warm_start=True, column_skip=skip)
            out.append((ts, td.iters))
        port[skip] = out
    return jax_steps, port


@pytest.mark.parametrize("field", ["pos", "vel", "pressure"])
def test_gated_step_matches_jax(slammed_runs, field):
    """Each field relative to its largest JAX magnitude; the pressure at
    least to delta * pci_max_density_error_ratio * d0, the pressure one
    tolerance of density error adds: after the first step it is the gain
    times rounding noise of the lattice's rest density (0.49 here, on
    different slots in the two packages)."""
    jax_steps, port = slammed_runs
    params, _, _, delta = _slammed()
    floor = delta * params.pci_max_density_error_ratio * params.d0
    for (want, j_iters), (ts, t_iters) in zip(jax_steps, port[True]):
        assert t_iters == j_iters
        w = want[field].astype(np.float64)
        scale = np.abs(w).max()
        if field == "pressure":
            scale = max(scale, floor)
        err = np.abs(getattr(ts, field).numpy() - w).max()
        assert err / scale < STEP_REL_TOL[field]
    assert max(it for _, it in jax_steps) >= 2     # the loop iterates


def test_gated_loop_tracks_ungated_loop(slammed_runs):
    _, port = slammed_runs
    iters = []
    for (a, ia), (b, ib) in zip(port[False], port[True]):
        iters.append(ia)
        assert torch.isfinite(b.pos).all()
        assert float((a.pos - b.pos).abs().max()) < TRACK_DPOS
        assert float((a.vel - b.vel).abs().max()) < TRACK_DVEL
    assert max(iters) >= 2, iters


def test_unroll_for_grad_ignores_column_skip():
    params, jspec, arrays, delta = _slammed()
    tparams = interop.fluid_params_from(params)
    spec = interop.cell_spec_from_jax(jspec)
    outs = []
    for skip in (True, False):
        ts = interop.fluid_state_from_numpy(**arrays, device="cpu")
        nxt, d = tds.dense_pcisph_step(ts, tparams, spec, delta,
                                       unroll_for_grad=True, unroll_iters=2,
                                       column_skip=skip)
        assert d.iters == 2
        outs.append(nxt)
    for f in ("pos", "vel", "pressure"):
        assert torch.equal(getattr(outs[0], f), getattr(outs[1], f))


def test_simulation_with_column_skip():
    sim = Simulation.create(SimConfig(n3=6, neighbors="dense",
                                      solver="pcisph", column_skip=True),
                            device="cpu")
    y0 = float(sim.state.pos[:, 1].mean())
    d = sim.step(3)
    assert 1 <= d.iters <= sim.params.pci_max_iters
    assert int(d.overflow) == 0 and torch.isfinite(sim.state.pos).all()
    assert float(sim.state.pos[:, 1].mean()) < y0


@pytest.mark.parametrize("name", SWEEPS)
def test_backward_of_gated_sweep_raises(name):
    """The gated sweeps are forward only (no custom_vjp in JAX either,
    pallas_sph.py:851-852): a gradient through one raises rather than
    return one without the sweep's term."""
    _, params, spec, planes, _, _ = _small_planes()
    k = KernelCoeffs.build(params.h)
    x = planes["x"].clone().requires_grad_()
    rho = planes["rho"].clone().requires_grad_()
    ins = dict(planes, x=x, rho=rho)
    active = torch.ones(sw.active_patch_shape(spec), dtype=torch.int32)
    out = _gated_calls(sw, ins, spec, k, params.mass, active)[name]()
    with pytest.raises(NotImplementedError,
                       match="forward-only in the JAX package"):
        torch.autograd.grad(out[0].sum(), x, allow_unused=True)


def _small_planes():
    """The port's own planes of the 6^3 dam break with rho/press/pq."""
    from dieselfluid_tpu_torch.ops import cellops as tc

    dx = (2.0 / 6) * 0.5
    params = lattice_rest_density(dx, FluidParams.for_spacing(dx))
    tparams = interop.fluid_params_from(params)
    spec = tc.DenseCellSpec.for_domain((-1,) * 3, (1,) * 3, params.h,
                                       capacity=16)
    from dieselfluid_tpu_torch.models.particles import (
        dam_break_state as tdam)

    pos = tdam(6, tparams, "cpu").pos
    n = pos.shape[0]
    flat, valid, _ = tc.dense_indices(pos, spec)
    rho = torch.full((n,), params.d0)
    press = torch.full((n,), 10.0)
    planes = tc.build_planes({"x": pos[:, 0], "y": pos[:, 1],
                              "z": pos[:, 2], "rho": rho, "press": press,
                              "pq": press / rho ** 2}, flat, valid, spec)
    return None, params, spec, planes, None, None
