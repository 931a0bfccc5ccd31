"""The mask invariant the compacted sweep kernel (every sweep) relies on:
every mask plane a main path hands a sweep holds only 0 and 1, and in every
cell its occupied slots are ranks 0..n-1. The kernel counts a cell's
occupied slots and visits only that many of them. And, for K5 and the
backward sweeps K6, K7 (both forms), K8 and K9 on the training and sim ->
render paths (planes from _pos_vel_planes, rho from density_planes or
to_plane, press from a where or to_plane), the positions, velocities, rho
and press are 0 at every empty slot: there the old sweep_block body read
them (the adjoints' role swap), so the compacted body, which skips empty
slots, equals it only then.

Checked on the plane producers directly (build_planes after dense_indices,
on a dam break and with cells forced to overflow; the boundary-extended
binning) and, through a spy on the sweeps' dispatch, on every mask the
solvers pass to a compact sweep: the per-step WCSPH steps (static params
with and without mu, backward to the positions included, as the sim ->
render path runs them; and Materials, which runs the factored pressure
and viscosity, backward included) and PCISPH steps (the correction loop's
predicted planes, the column_skip loop's, the unrolled loop's scatter of
predicted positions, backward included), and the resident WCSPH and PCISPH
states over several skin > 0 steps between rebuilds.

And the rasterizer's invariant (K11 walks each tile's slots only up to the
first 128-slot chunk whose first slot is empty): in the slot planes
bin_tile_entries writes, each tile's occupied slots (r >= 0.5) are its first
ranks, with entries that overflow k and entries off the screen.
"""

import numpy as np
import pytest
import torch

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.models.materials import Materials
from dieselfluid_tpu_torch.models.particles import dam_break_state
from dieselfluid_tpu_torch.neighbors.calibrate import lattice_rest_density
from dieselfluid_tpu_torch.ops import cellops as tc
from dieselfluid_tpu_torch.ops import sph_sweep as sw
from dieselfluid_tpu_torch.solvers import dense_resident as tdr
from dieselfluid_tpu_torch.solvers import dense_step as tds
from dieselfluid_tpu_torch.solvers.pcisph import compute_pci_delta

torch.set_num_threads(1)

N3 = 8
DX = (2.0 / N3) * 0.5
CPU = torch.device("cpu")


def prefix_violations(mask: torch.Tensor, cap: int) -> int:
    """Slots that break the invariant: a value other than 0 or 1, or an
    occupancy that is not the first ranks of its cell."""
    m = mask.reshape(-1, cap)
    bad_values = int(((m != 0) & (m != 1)).sum())
    occ = m > 0
    n = occ.sum(-1, keepdim=True)
    ranks = torch.arange(cap).expand_as(occ)
    return bad_values + int((occ != (ranks < n)).sum())


def _setup(seed=1, jitter=0.3, speed=1.0):
    params = lattice_rest_density(DX, FluidParams.for_spacing(DX))
    s = dam_break_state(N3, params, CPU)
    rng = np.random.default_rng(seed)
    pos = s.pos + torch.from_numpy(rng.uniform(
        -jitter, jitter, tuple(s.pos.shape)).astype(np.float32)) * DX
    vel = torch.from_numpy((speed * rng.normal(
        size=tuple(s.vel.shape))).astype(np.float32))
    spec = tc.DenseCellSpec.for_domain((-1,) * 3, (1,) * 3, params.h,
                                       capacity=16)
    return params, s._replace(pos=pos, vel=vel), spec


def test_violations_are_counted():
    m = torch.zeros(2, 4)
    m[0, :2] = 1.0
    m[1, 1] = 1.0            # a hole at rank 0
    assert prefix_violations(m, 4) == 2
    m[1] = torch.tensor([0.5, 0.0, 0.0, 0.0])
    assert prefix_violations(m, 4) == 1


@pytest.mark.parametrize("cap", [16, 32, 4])
def test_build_planes_after_dense_indices(cap):
    """The dam break at capacities 16 and 32, and at 4, where most cells
    overflow (the overflowed particles park off the plane)."""
    params, s, _ = _setup()
    spec = tc.DenseCellSpec.for_domain((-1,) * 3, (1,) * 3, params.h,
                                       capacity=cap)
    flat, valid, overflow = tc.dense_indices(s.pos, spec)
    planes = tc.build_planes({"x": s.pos[:, 0]}, flat, valid, spec)
    if cap == 4:
        assert int(overflow) > 0
    assert int(planes["mask"].sum()) == int(valid.sum())
    assert prefix_violations(planes["mask"], cap) == 0


def test_forced_overflow_in_one_cell():
    """Many particles in one cell, in shuffled order: the first `cap` by
    particle order keep ranks 0..cap-1."""
    params, _, spec = _setup()
    rng = np.random.default_rng(3)
    pos = torch.from_numpy(rng.uniform(0.01, 0.2, (70, 3)).astype(
        np.float32))
    flat, valid, overflow = tc.dense_indices(pos, spec)
    planes = tc.build_planes({"x": pos[:, 0]}, flat, valid, spec)
    assert int(overflow) > 0
    assert prefix_violations(planes["mask"], spec.capacity) == 0


def test_boundary_extended_binning():
    params, s, spec = _setup()
    rng = np.random.default_rng(4)
    wall = torch.from_numpy(np.stack(
        [rng.uniform(-0.95, 0.95, 400), np.full(400, -0.97),
         rng.uniform(-0.95, 0.95, 400)], -1).astype(np.float32))
    pos, vel = tds._boundary_extended(s._replace(boundary_pos=wall))
    assert pos.shape[0] == s.pos.shape[0] + 400
    flat, valid, _ = tc.dense_indices(pos, spec)
    planes = tds._pos_vel_planes(pos, vel, flat, valid, spec)
    assert prefix_violations(planes["mask"], spec.capacity) == 0


@pytest.fixture
def spy(monkeypatch):
    """The input planes of every sweep call through the sweeps' dispatch
    (the backward sweeps' too: autograd keeps the forward's dispatch)."""
    calls = []
    real = sw._run

    def run(sweep, pair, ins, spec, consts, active=None):
        calls.append((sweep.name, dict(ins)))
        return real(sweep, pair, ins, spec, consts, active)

    monkeypatch.setattr(sw, "_run", run)
    return calls


# The sweeps whose old sweep_block body read these planes at an empty
# candidate, and the planes it read there.
EMPTY_READS = {
    "pressure": ("rho", "press"),
    "density_bwd": ("x", "y", "z"),
    "pressure_bwd": ("x", "y", "z", "rho", "press"),
    "viscosity_bwd": ("x", "y", "z", "vx", "vy", "vz", "rho"),
    "force_bwd": ("x", "y", "z", "vx", "vy", "vz", "rho", "press"),
    "force_p_bwd": ("x", "y", "z", "rho", "press"),
}


def _check(calls, spec, names):
    assert {n for n, _ in calls} == set(names)
    for name, ins in calls:
        m = ins["mask"]
        assert prefix_violations(m, spec.capacity) == 0, name
        for c in EMPTY_READS.get(name, ()):
            assert not bool(ins[c][m <= 0].any()), (name, c)


def test_per_step_solvers_hand_prefix_masks(spy):
    params, s, spec = _setup()
    delta = compute_pci_delta(params, DX)
    mats = Materials.from_params(params, CPU, requires_grad=True)
    for mu in (params.mu, 0.0):
        pos = s.pos.clone().requires_grad_()
        nxt, _ = tds.dense_wcsph_step(s._replace(pos=pos),
                                      params.replace(mu=mu), spec)
        torch.autograd.grad((nxt.pos ** 2).sum(), pos)
    nxt, _ = tds.dense_wcsph_step(s, params, spec, materials=mats)
    torch.autograd.grad((nxt.pos ** 2).sum(), mats.mass)
    tds.dense_pcisph_step(s, params, spec, delta, warm_start=True)
    tds.dense_pcisph_step(s, params, spec, delta, column_skip=True)
    nxt, _ = tds.dense_pcisph_step(s, params, spec, delta, materials=mats,
                                   unroll_for_grad=True, unroll_iters=2)
    n_wcsph = sum(n == "pressure_bwd" for n, _ in spy)
    torch.autograd.grad((nxt.pos ** 2).sum(), mats.mass)
    assert n_wcsph == 1 and sum(n == "pressure_bwd" for n, _ in spy) == 3
    assert [sum(n == b for n, _ in spy) for b in (
        "force_bwd", "force_p_bwd", "viscosity_bwd")] == [1, 1, 2]
    _check(spy, spec, ("density", "force", "force_p", "viscosity",
                       "pressure_pq", "pressure", "density_bwd",
                       "pressure_bwd", "viscosity_bwd", "force_bwd",
                       "force_p_bwd", "density_active", "pressure_pq_active"))


def test_resident_states_between_rebuilds_hand_prefix_masks(spy):
    """Resident WCSPH and PCISPH with a skin wide enough that several
    steps pass between rebuilds (the planes move, the mask stays frozen),
    and at least one rebuild."""
    params, s, spec = _setup(seed=2, jitter=0.1, speed=0.05)
    delta = compute_pci_delta(params, DX)
    for pcisph in (False, True):
        ps = tdr.plane_state_from_fluid(s, spec)
        ages = []
        for _ in range(6):
            if pcisph:
                ps, _ = tdr.dense_pcisph_resident_step(ps, params, spec,
                                                       delta, skin=0.02)
            else:
                ps = tdr.dense_wcsph_resident_step(ps, params, spec,
                                                   skin=0.02)
            ages.append(int(ps.rebuilds))
            assert prefix_violations(ps.planes["mask"], spec.capacity) == 0
        assert 0 < ages[-1] < 6, ages
    _check(spy, spec, ("density", "force", "viscosity", "pressure_pq"))


@pytest.mark.parametrize("case", ["overflow", "off_screen"])
def test_tile_planes_hold_occupied_slots_as_first_ranks(case):
    """bin_tile_entries on a 256x144 frame (k = 128): seeded splats packed
    into a few tiles so that some overflow k, or spread over and past the
    screen (off to every side and behind the camera). Every tile's occupied
    slots (r >= 0.5) are its first ranks, and live slots have r >= 0.75,
    empty ones r = 0."""
    from dieselfluid_tpu_torch.render import splat_tiled as st

    spec = st.TileSpec(256, 144, k=128)
    rng = np.random.default_rng(11)
    n = 3000
    if case == "overflow":
        u = rng.uniform(20.0, 70.0, n)
        v = rng.uniform(2.0, 30.0, n)
    else:
        u = rng.uniform(-60.0, 320.0, n)
        v = rng.uniform(-40.0, 190.0, n)
    t = {c: torch.from_numpy(a.astype(np.float32)) for c, a in (
        ("u", u), ("v", v), ("z", rng.uniform(0.0, 1.0, n)),
        ("r", rng.uniform(0.75, 4.5, n)))}
    in_front = torch.from_numpy(rng.uniform(size=n) < 0.9)
    planes, _, overflow = st.bin_tile_entries(t["u"], t["v"], t["z"],
                                              t["r"], in_front, spec)
    r = planes["r"].reshape(spec.n_tiles, spec.k)
    occ = r >= 0.5
    assert (int(overflow) > 0) == (case == "overflow")
    assert int(occ.sum()) > 0
    assert prefix_violations(occ.float(), spec.k) == 0
    assert bool((r[occ] >= 0.75).all()) and not bool(r[~occ].any())
