"""The port's sharded dense steps against its own unsharded ones.

The twins of the JAX package's single-chip parity oracles
(tests/test_dense_halo.py, its slow tier), on the port: the slab-decomposed
WCSPH and PCISPH steps (parallel/dense_halo.py, dense_halo2d.py) on a
LocalMesh of 4 shards on the CPU against dense_wcsph_step /
dense_pcisph_step on the matching global lattice, at n3 = 10 (1-D) and 8
(2-D) over 4 steps. The decomposition is cell-aligned, so the physics
agrees to float order; particles match nearest to nearest (a bijection).
Also a slam that migrates particles across faces, and the guards against
running anywhere but asked.
"""

import numpy as np
import pytest
import torch
from torch_parallel_cases import nearest_match

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.geometry.mesh import box
from dieselfluid_tpu_torch.models.particles import dam_break_state
from dieselfluid_tpu_torch.neighbors.calibrate import lattice_rest_density
from dieselfluid_tpu_torch.ops.cellops import DenseCellSpec
from dieselfluid_tpu_torch.parallel import dense_halo as tdh
from dieselfluid_tpu_torch.parallel import dense_halo2d as td2
from dieselfluid_tpu_torch.parallel.halo import collect
from dieselfluid_tpu_torch.parallel.mesh import LocalMesh
from dieselfluid_tpu_torch.solvers.dense_step import (
    dense_pcisph_step,
    dense_wcsph_step,
)
from dieselfluid_tpu_torch.solvers.pcisph import compute_pci_delta

torch.set_num_threads(1)
CPU = torch.device("cpu")
N_DEV = 4
STEPS = 4
# 16 slots a cell (JAX's oracles use 32): the plain sweeps' cost grows with
# its square, and no cell of these runs overflows 16 (asserted).
CELL_CAP = 32
# Largest nearest-match distance and velocity difference after 4 steps.
# Measured: WCSPH 6.0e-8 / 1.1e-6; PCISPH (warm) 1.4e-7 / 2.7e-5, (cold)
# 1.2e-7 / 2.5e-5; with boundary 2.5e-7 / 4.3e-5 (speeds up to ~3); 2-D
# WCSPH 1.5e-8 / 6.5e-7, 2-D PCISPH with boundary 2.4e-7 / 2.5e-5. Bounds
# 20x and ~10x the largest (JAX's own: 5e-4 / 5e-3 and 1e-3 / 1e-2).
POS_TOL, VEL_TOL = 5e-6, 5e-4


def _global_spec(spec, hi_y):
    gspec = DenseCellSpec.for_domain(
        (spec.lo,) * 3, (spec.hi_x, hi_y, spec.cell * 3.0 + (
            spec.hi_yz if hasattr(spec, "hi_yz") else spec.hi_z)),
        spec.cell, capacity=spec.cell_capacity)
    top = spec.hi_yz if hasattr(spec, "hi_yz") else spec.hi_z
    return gspec, ((spec.lo,) * 3, (spec.hi_x, hi_y, top))


def _assert_same_particles(ref_state, slabs):
    pos_sh, vel_sh = collect(slabs)
    ref = ref_state.pos.numpy()
    assert len(pos_sh) == len(ref)
    match, dist = nearest_match(ref, pos_sh)
    vdiff = np.abs(ref_state.vel.numpy() - vel_sh[match]).max()
    assert dist.max() < POS_TOL, dist.max()
    assert vdiff < VEL_TOL, vdiff


def _sim(n3, lattice: bool, slam=(0.0, 0.0, 0.0)):
    dx = (2.0 / n3) * 0.5
    params = FluidParams.for_spacing(dx)
    if lattice:
        params = lattice_rest_density(dx, params)
    s0 = dam_break_state(n3, params, CPU)
    if not lattice:
        params = params.replace(d0=float(1.1 * params.d0))
    s0 = s0._replace(vel=s0.vel + torch.tensor(slam))
    return params, s0, dx


@pytest.mark.parametrize("case", ["wcsph", "pcisph_warm", "pcisph_cold",
                                  "pcisph_boundary"])
def test_1d_matches_unsharded(case):
    if case == "wcsph":
        params, s0, dx = _sim(10, lattice=True)
        g = torch.Generator().manual_seed(7)
        s0 = s0._replace(vel=torch.randn(s0.vel.shape, generator=g) * 0.05)
    else:
        params, s0, dx = _sim(10, lattice=True, slam=(0.0, -1.0, 0.0))
        if case == "pcisph_boundary":
            s0 = s0._replace(boundary_pos=box(
                1.6, 1.6, 1.6, device=CPU).generate_boundary_particles(1.0))
    warm = case != "pcisph_cold"
    spec = tdh.DenseSlabSpec.build(N_DEV, params.h, capacity=1024,
                                   migrate_capacity=512, 
        cell_capacity=CELL_CAP)
    gspec, bounds = _global_spec(spec, spec.hi_yz)
    delta = compute_pci_delta(params, dx)
    s, iters = s0, []
    for _ in range(STEPS):
        if case == "wcsph":
            s, diag = dense_wcsph_step(s, params, gspec, bounds=bounds)
        else:
            s, diag = dense_pcisph_step(s, params, gspec, delta,
                                        bounds=bounds, warm_start=warm)
            iters.append(int(diag.iters))
    assert int(diag.overflow) == 0
    mesh = LocalMesh((N_DEV,), CPU)
    slabs = tdh.distribute_dense(s0, spec)
    if case == "wcsph":
        step = tdh.make_dense_halo_wcsph_step(mesh, spec, params)
    else:
        step = tdh.make_dense_halo_pcisph_step(
            mesh, spec, params, delta, boundary=case == "pcisph_boundary",
            warm_start=warm)
    for _ in range(STEPS):
        slabs, max_vel, n_live, ovf, per_slab = step(slabs)
    assert int(n_live) == s0.n and float(slabs.dropped) == 0.0
    assert int(ovf) == 0 and int(per_slab.sum()) == s0.n
    if iters:
        assert max(iters) >= 2, iters
    _assert_same_particles(s, slabs)


@pytest.mark.parametrize("solver", ["wcsph", "pcisph_boundary"])
def test_2d_matches_unsharded(solver):
    """2x2 mesh: a diagonal slam drives cross-face motion in x and y
    (PCISPH with the replicated boundary store)."""
    if solver == "wcsph":
        params, s0, dx = _sim(8, lattice=True)
    else:
        params, s0, dx = _sim(8, lattice=True, slam=(0.8, -1.0, 0.0))
        s0 = s0._replace(boundary_pos=box(
            1.6, 1.6, 1.6, device=CPU).generate_boundary_particles(
                dx / params.h))
    spec = td2.DenseSlab2DSpec.build(2, 2, params.h, capacity=1024,
                                     migrate_capacity=256, 
        cell_capacity=CELL_CAP)
    gspec, bounds = _global_spec(spec, spec.hi_y)
    delta = compute_pci_delta(params, dx)
    s = s0
    for _ in range(STEPS):
        if solver == "wcsph":
            s, _ = dense_wcsph_step(s, params, gspec, bounds=bounds)
        else:
            s, _ = dense_pcisph_step(s, params, gspec, delta, bounds=bounds,
                                     warm_start=True)
    mesh = td2.make_mesh_2d(2, 2, CPU)
    slabs = td2.distribute_2d(s0, spec)
    step = (td2.make_dense_halo_wcsph_step_2d(mesh, spec, params)
            if solver == "wcsph" else td2.make_dense_halo_pcisph_step_2d(
                mesh, spec, params, delta, boundary=True, warm_start=True))
    for _ in range(STEPS):
        slabs, max_vel, n_live, ovf, per_slab = step(slabs)
    assert int(n_live) == s0.n and per_slab.shape == (2, 2)
    assert int(per_slab.sum()) == s0.n and int(ovf) == 0
    _assert_same_particles(s, slabs)


def test_migration_across_faces():
    """A hard +x kick carries particles over slab faces: nothing is lost,
    every live particle sits inside its slab, and mass left shard 0."""
    params, s0, _ = _sim(10, lattice=False)
    s = s0._replace(vel=s0.vel + torch.tensor([20.0, 0.0, 0.0]))
    spec = tdh.DenseSlabSpec.build(N_DEV, params.h, capacity=1024,
                                   migrate_capacity=512, 
        cell_capacity=CELL_CAP)
    slabs = tdh.distribute_dense(s, spec)
    c = spec.capacity
    alive0 = slabs.alive.reshape(N_DEV, c).sum(1)
    step = tdh.make_dense_halo_wcsph_step(LocalMesh((N_DEV,), CPU), spec,
                                          params)
    for _ in range(5):
        slabs, max_vel, n_live, ovf, per_slab = step(slabs)
    assert int(n_live) == s.n and float(slabs.dropped) == 0.0
    pos, alive = slabs.pos.numpy(), slabs.alive.numpy() > 0
    for d in range(N_DEV):
        lo = spec.lo + spec.slab_width * d
        block = slice(d * c, (d + 1) * c)
        live_x = pos[block][alive[block]][:, 0]
        if len(live_x):
            assert live_x.min() >= lo - 1e-5
            assert live_x.max() <= lo + spec.slab_width + 1e-5
    alive1 = slabs.alive.reshape(N_DEV, c).sum(1)
    assert alive1[0] < alive0[0] and alive1[1:].sum() > alive0[1:].sum()
    np.testing.assert_array_equal(per_slab.numpy(), alive1.numpy())


def test_migrate_capacity_overflow_counts_dropped():
    """A migration buffer too small for the emigrants: the particles that
    do not fit are counted in `dropped` and n_live falls by as many."""
    params, s0, _ = _sim(10, lattice=False)
    s = s0._replace(vel=s0.vel + torch.tensor([20.0, 0.0, 0.0]))
    spec = tdh.DenseSlabSpec.build(N_DEV, params.h, capacity=1024,
                                   migrate_capacity=8, 
        cell_capacity=CELL_CAP)
    slabs = tdh.distribute_dense(s, spec)
    step = tdh.make_dense_halo_wcsph_step(LocalMesh((N_DEV,), CPU), spec,
                                          params)
    for _ in range(3):
        slabs, max_vel, n_live, ovf, per_slab = step(slabs)
    assert float(slabs.dropped) > 0
    assert int(n_live) + int(float(slabs.dropped)) == s.n


def test_no_card_means_no_mesh_on_the_card():
    """Entry points run on the card unless asked for the CPU: without
    one, a default LocalMesh raises (never carries on on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        LocalMesh((N_DEV,))
    with pytest.raises(RuntimeError, match="CUDA"):
        td2.make_mesh_2d(2, 2)
