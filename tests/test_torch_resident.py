"""The port's plane-resident solvers.

* skin=0 rebuilds every frame, which is what the per-step solvers do: the
  port's resident WCSPH and PCISPH are bit-identical to its own per-step
  solvers (the way tests/test_dense_resident.py holds the JAX pair).
* skin=0.05 freezes the binning between rebuilds: the port, resumed from
  the JAX package's DensePlaneState (interop), follows the JAX resident
  solvers step for step. In those states no pair within h lies two or more
  binned z-cells apart, so the port's 27-cell candidate set and the Pallas
  kernel's in-row window see the same pairs and the comparison is exact up
  to float32 drift, not up to a missed-pair tolerance.
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
from dieselfluid_tpu.solvers import dense_resident as jdr
from dieselfluid_tpu.solvers.pcisph import compute_pci_delta
from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.ops.cellops import gather_plane, gather_planes
from dieselfluid_tpu_torch.solvers import dense_resident as tdr
from dieselfluid_tpu_torch.solvers import dense_step as tds

torch.set_num_threads(1)

N3 = 8
DX = (2.0 / N3) * 0.5
STEPS = 4
SKIN_STEPS = 3
# max |port - jax| / max |jax| per plane after each step (measured: positions
# 1.2e-7, velocities 4.9e-6).
REL_TOL = {"x": 1e-6, "y": 1e-6, "z": 1e-6, "vx": 5e-5, "vy": 5e-5,
           "vz": 5e-5}


@pytest.fixture(scope="module")
def setup():
    params = lattice_rest_density(DX, FluidParams.for_spacing(DX))
    s = dam_break_state(N3, params, extent=0.5)
    rng = np.random.default_rng(1)
    arrays = {"pos": np.asarray(s.pos),
              "vel": rng.normal(size=s.vel.shape).astype(np.float32),
              "force": np.asarray(s.force), "density": np.asarray(s.density),
              "pressure": np.asarray(s.pressure)}
    jspec = jc.DenseCellSpec.for_domain((-1,) * 3, (1,) * 3, params.h,
                                        capacity=16)
    # "params" is the port's FluidParams, "jparams" the JAX package's.
    return dict(params=interop.fluid_params_from(params), jparams=params,
                arrays=arrays, jspec=jspec,
                spec=interop.cell_spec_from_jax(jspec),
                delta=compute_pci_delta(params, DX))


def _port_state(setup, **over):
    arrays = dict(setup["arrays"], **over)
    return interop.fluid_state_from_numpy(**arrays, device="cpu")


# --------------------------------------------------------------------------
# skin = 0: resident == per-step, bit for bit
# --------------------------------------------------------------------------


def test_wcsph_skin_zero_equals_per_step(setup):
    params, spec = setup["params"], setup["spec"]
    s = _port_state(setup)
    ps = tdr.plane_state_from_fluid(s, spec)
    for _ in range(STEPS):
        s, _ = tds.dense_wcsph_step(s, params, spec)
        ps = tdr.dense_wcsph_resident_step(ps, params, spec, skin=0.0)
    out = tdr.fluid_state_from_planes(ps, s.n, params, spec)
    assert int(ps.rebuilds) == STEPS and int(ps.age_total) == STEPS
    assert torch.equal(out.pos, s.pos) and torch.equal(out.vel, s.vel)


def test_pcisph_skin_zero_equals_per_step(setup):
    params, spec, delta = setup["params"], setup["spec"], setup["delta"]
    s = _port_state(setup)
    ps = tdr.plane_state_from_fluid(s, spec)
    for _ in range(3):
        s, diag = tds.dense_pcisph_step(s, params, spec, delta,
                                        warm_start=True)
        ps, iters = tdr.dense_pcisph_resident_step(ps, params, spec, delta,
                                                   skin=0.0)
        assert iters == diag.iters
    out = tdr.fluid_state_from_planes(ps, s.n, params, spec)
    assert torch.equal(out.pos, s.pos) and torch.equal(out.vel, s.vel)
    # The warm-start pressure rode the rebuilds (particles that overflow
    # the new binning drop out of the planes, and their pressure with them).
    valid = ps.valid[:s.n]
    press = gather_plane(ps.planes["press"], ps.flat[:s.n])
    assert torch.equal(press[valid], s.pressure[valid])
    assert float(press.max()) > 0.0


# --------------------------------------------------------------------------
# skin = 0.05: the port resumed from the JAX state follows JAX
# --------------------------------------------------------------------------


def _assert_no_pair_two_z_cells_apart(ps, n, spec, h):
    """Every fluid pair within h is binned at most one z-cell apart."""
    flat, valid = ps.flat[:n], ps.valid[:n]
    pos = gather_planes([ps.planes[c] for c in ("x", "y", "z")],
                        flat).numpy()[valid.numpy()].astype(np.float64)
    cz = ((flat[valid] % spec.row_len) // spec.capacity).numpy()
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    close = d2 < h * h
    assert np.abs(cz[:, None] - cz[None, :])[close].max() <= 1


def _run_skin(setup, solver):
    params, jspec, spec = setup["params"], setup["jspec"], setup["spec"]
    jparams, delta = setup["jparams"], setup["delta"]
    from dieselfluid_tpu.models.particles import FluidState

    js = FluidState(**{k: jnp.asarray(v) for k, v in setup["arrays"].items()})
    jps = jdr.plane_state_from_fluid(js, jspec)
    # Resume the JAX state in the port (state carried across).
    ps = interop.plane_state_from_numpy(
        **{f: getattr(jps, f) if f != "planes" else
           {n: np.asarray(p) for n, p in jps.planes.items()}
           for f in jdr.DensePlaneState._fields}, device="cpu")
    steps = []
    with pltpu.force_tpu_interpret_mode():
        for _ in range(SKIN_STEPS):
            if solver == "wcsph":
                jps = jdr.dense_wcsph_resident_step(jps, jparams, jspec,
                                                    skin=0.05)
                ps = tdr.dense_wcsph_resident_step(ps, params, spec,
                                                   skin=0.05)
                ji = ti = None
            else:
                jps, ji = jdr.dense_pcisph_resident_step(jps, jparams, jspec,
                                                         delta, skin=0.05)
                ps, ti = tdr.dense_pcisph_resident_step(ps, params, spec,
                                                        delta, skin=0.05)
            steps.append((jps, ji, ps, ti))
    return steps


@pytest.fixture(scope="module")
def wcsph_skin(setup):
    return _run_skin(setup, "wcsph")


@pytest.fixture(scope="module")
def pcisph_skin(setup):
    return _run_skin(setup, "pcisph")


@pytest.mark.parametrize("solver", ["wcsph", "pcisph"])
def test_skin_resident_follows_jax(setup, wcsph_skin, pcisph_skin, solver):
    run = wcsph_skin if solver == "wcsph" else pcisph_skin
    n = setup["arrays"]["pos"].shape[0]
    for jps, ji, ps, ti in run:
        assert int(ps.rebuilds) == int(jps.rebuilds)
        assert int(ps.overflow) == int(jps.overflow)
        if solver == "pcisph":
            assert ti == int(ji)
        np.testing.assert_array_equal(ps.flat.numpy(), np.asarray(jps.flat))
        np.testing.assert_array_equal(ps.planes["mask"].numpy(),
                                      np.asarray(jps.planes["mask"]))
        for c, tol in REL_TOL.items():
            want = np.asarray(jps.planes[c], np.float64)
            err = np.abs(ps.planes[c].numpy() - want).max()
            assert err / np.abs(want).max() < tol, c
        _assert_no_pair_two_z_cells_apart(ps, n, setup["spec"],
                                          setup["params"].h)
    rebuilds = [int(ps.rebuilds) for *_, ps, _ in run]
    # Frozen steps AND rebuilds both happen in the window.
    assert 0 < rebuilds[-1] < SKIN_STEPS


# --------------------------------------------------------------------------
# Resident-only behaviour
# --------------------------------------------------------------------------


def test_plane_state_interop_round_trip(setup):
    ps = tdr.plane_state_from_fluid(_port_state(setup), setup["spec"])
    back = interop.plane_state_from_numpy(**interop.plane_state_to_numpy(ps),
                                          device="cpu")
    for f in tdr.DensePlaneState._fields:
        a, b = getattr(ps, f), getattr(back, f)
        if f == "planes":
            assert a.keys() == b.keys()
            assert all(torch.equal(a[k], b[k]) for k in a)
        elif a is None:
            assert b is None
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), f


def test_large_motion_triggers_rebuild(setup):
    params, spec = setup["params"], setup["spec"]
    # 10 * dt = 0.025 per step, past the skin's 0.05 h = 0.0125.
    fast = _port_state(setup, vel=np.full_like(setup["arrays"]["vel"], 10.0))
    ps = tdr.plane_state_from_fluid(fast, spec)
    ps = tdr.dense_wcsph_resident_step(ps, params, spec, skin=0.05)
    assert int(ps.rebuilds) == 1


def test_overflow_fallback_ballistic(setup):
    params = setup["params"]
    tight = tdr.DenseCellSpec.for_domain((-1,) * 3, (1,) * 3, params.h,
                                         capacity=1)
    s = _port_state(setup)
    ps = tdr.plane_state_from_fluid(s, tight)
    inv = ~ps.valid[:s.n]
    assert int(ps.overflow) > 0 and bool(inv.any())
    ps2 = tdr.dense_wcsph_resident_step(ps, params, tight, skin=1e9)
    out = tdr.fluid_state_from_planes(ps2, s.n, params, tight)
    g = torch.tensor(params.gravity)
    v_exp = s.vel + g * params.dt
    p_exp = torch.clamp(s.pos + v_exp * params.dt, -1.0, 1.0)
    torch.testing.assert_close(out.pos[inv], p_exp[inv], rtol=0, atol=1e-6)


def test_boundary_slots_frozen(setup):
    params, spec = setup["params"], setup["spec"]
    yz = np.arange(-1.0, 0.0 + 1e-9, DX)
    gy, gz = np.meshgrid(yz, yz, indexing="ij")
    b = np.stack([np.zeros(gy.size), gy.ravel(), gz.ravel()],
                 -1).astype(np.float32)
    s = interop.fluid_state_from_numpy(**setup["arrays"], boundary_pos=b,
                                       device="cpu")
    ps = tdr.plane_state_from_fluid(s, spec)
    for _ in range(2):
        ps, _ = tdr.dense_pcisph_resident_step(ps, params, spec,
                                               setup["delta"], skin=1e9)
    got = gather_planes([ps.planes[c] for c in ("x", "y", "z")],
                        ps.flat[s.n:])
    vb = ps.valid[s.n:]
    assert bool(vb.all())
    assert torch.equal(got[vb], torch.from_numpy(b)[vb])
    assert torch.equal(gather_plane(ps.bnd, ps.flat[s.n:]),
                       torch.ones(b.shape[0]))
