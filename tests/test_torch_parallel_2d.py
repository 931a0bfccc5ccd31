"""The port's 2-D decomposition (parallel/dense_halo2d.py) and cell-grid
slab steps (parallel/halo.py) against the JAX package's, on the same numpy
slabs.

The JAX 2-D steps run on its 2x2 virtual CPU mesh with the sweeps in Pallas
interpret mode (its smoke size, n3 = 6); the port's on a 2x2 LocalMesh on
the CPU. The dam break is moved by +0.5 in x and y so that it straddles
both faces, and its column left of x = 0 crosses that face in the step.
The cell-grid steps (plain torch; XLA in JAX) run on 4 x-slabs with
boundary stores. Outputs compare slab by slab and slot by slot; tolerances
are relative to each field's largest magnitude, about 10x the drift
measured here (stated beside each).
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_parallel_cases import (
    N_DEV,
    assert_step_outputs_equal,
    jax_state,
    numpy_state,
    port_slabs,
    smoke_params,
    torch_state,
)

from dieselfluid_tpu.geometry.mesh import box
from dieselfluid_tpu.parallel import dense_halo2d as jd2
from dieselfluid_tpu.parallel import halo as jh
from dieselfluid_tpu.parallel.sharding import particle_mesh
from dieselfluid_tpu.solvers.pcisph import compute_pci_delta
from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.parallel import dense_halo2d as td2
from dieselfluid_tpu_torch.parallel import halo as th
from dieselfluid_tpu_torch.parallel.mesh import LocalMesh

torch.set_num_threads(1)

# Measured (2-D): WCSPH pos 6.0e-8, vel 1.0e-7, pressure 2.0e-6, max_vel 0;
# PCISPH with boundary pos 4.8e-7, vel 1.2e-6, pressure 3.5e-7, max_vel
# 1.1e-7.
TOL_2D = {"pos": 5e-6, "vel": 2e-5, "pressure": 2e-5}
# Measured (cell grid): WCSPH pos 3.6e-7, vel 4.6e-7, pressure 2.5e-6,
# max_vel 1.0e-6; PCISPH pos 2.4e-7, vel 7.7e-7, pressure 6.2e-7, max_vel
# 2.6e-7.
TOL_HALO = {"pos": 4e-6, "vel": 2e-5, "pressure": 3e-5}


def _straddling(params, dx, seed):
    arrays = numpy_state(params, dx, seed=seed, face=0.0 - 0.5)
    arrays["pos"] = arrays["pos"] + np.float32([0.5, 0.5, 0.0])
    return arrays


@pytest.fixture(scope="module")
def setup():
    params, tparams, dx = smoke_params()
    return params, tparams, dx, compute_pci_delta(params, dx)


def test_distribute_2d_equals_jax(setup):
    params, _, dx, _ = setup
    arrays = _straddling(params, dx, 0)
    bnd = np.asarray(box(1.6, 1.6, 1.6).generate_boundary_particles(1.0))
    js, ts = jax_state(arrays, bnd), torch_state(arrays, bnd)
    spec = jd2.DenseSlab2DSpec.build_for_state(js, 2, 2, params.h, 32)
    tspec = td2.DenseSlab2DSpec.build_for_state(ts, 2, 2, params.h, 32)
    assert tspec == interop.dense_slab2d_spec_from(spec)
    assert tspec.local_spec == interop.cell_spec_from_jax(spec.local_spec)
    jsl, tsl = jd2.distribute_2d(js, spec), td2.distribute_2d(ts, tspec)
    for f in ("pos", "vel", "alive", "dropped", "pressure", "boundary_pos",
              "boundary_mask"):
        np.testing.assert_array_equal(getattr(tsl, f).numpy(),
                                      np.asarray(getattr(jsl, f)), f)
    assert (np.asarray(jsl.alive).reshape(4, -1).sum(1) > 0).all()


@pytest.mark.parametrize("solver", ["wcsph", "pcisph"])
def test_2d_step_equals_jax(setup, solver):
    """One 2x2 step: WCSPH (K1 + K2), and warm-started PCISPH with the
    replicated boundary store (K1, K3, K4); migration in x and y."""
    params, tparams, dx, delta = setup
    arrays = _straddling(params, dx, 2)
    bnd = (np.asarray(box(1.6, 1.6, 1.6).generate_boundary_particles(1.0))
           if solver == "pcisph" else None)
    js = jax_state(arrays, bnd)
    spec = jd2.DenseSlab2DSpec.build_for_state(js, 2, 2, params.h,
                                               migrate_capacity=32)
    jslabs = jd2.distribute_2d(js, spec)
    tspec = interop.dense_slab2d_spec_from(spec)
    tmesh = td2.make_mesh_2d(2, 2, "cpu")
    if solver == "wcsph":
        jstep = jd2.make_dense_halo_wcsph_step_2d(jd2.make_mesh_2d(2, 2),
                                                  spec, params)
        tstep = td2.make_dense_halo_wcsph_step_2d(tmesh, tspec, tparams)
    else:
        jstep = jd2.make_dense_halo_pcisph_step_2d(
            jd2.make_mesh_2d(2, 2), spec, params, delta, boundary=True,
            warm_start=True)
        tstep = td2.make_dense_halo_pcisph_step_2d(
            tmesh, tspec, tparams, delta, boundary=True, warm_start=True)
    with pltpu.force_tpu_interpret_mode():
        jout = jax.block_until_ready(jstep(jslabs))
    tout = tstep(port_slabs(jslabs))
    assert tout[4].shape == (2, 2)
    before = np.asarray(jslabs.alive).reshape(2, 2, -1).sum(-1)
    assert not np.array_equal(np.asarray(jout[4]), before), "no migration"
    assert_step_outputs_equal(jout, tout, TOL_2D)


@pytest.mark.parametrize("solver", ["wcsph", "pcisph"])
def test_cell_grid_halo_step_equals_jax(setup, solver):
    """make_halo_step / make_halo_pcisph_step (warm start) with boundary
    stores, 4 slabs, a column migrating over the first face."""
    params, tparams, dx, delta = setup
    spec = jh.SlabSpec(n_dev=N_DEV, capacity=256, halo_capacity=96,
                       migrate_capacity=32, h=params.h)
    arrays = numpy_state(params, dx, seed=3, face=spec.lo + spec.slab_width)
    bnd = np.asarray(box(1.6, 1.6, 1.6).generate_boundary_particles(1.0))
    jslabs = jh.distribute(jax_state(arrays, bnd), spec)
    tslabs = th.distribute(torch_state(arrays, bnd),
                           interop.slab_spec_from(spec))
    for f in ("pos", "pressure", "boundary_pos", "boundary_mask"):
        np.testing.assert_array_equal(getattr(tslabs, f).numpy(),
                                      np.asarray(getattr(jslabs, f)), f)
    tmesh = LocalMesh((N_DEV,), "cpu")
    tspec = interop.slab_spec_from(spec)
    if solver == "wcsph":
        jstep = jh.make_halo_step(particle_mesh(N_DEV), spec, params, k=48,
                                  boundary=True)
        tstep = th.make_halo_step(tmesh, tspec, tparams, k=48,
                                  boundary=True)
    else:
        jstep = jh.make_halo_pcisph_step(particle_mesh(N_DEV), spec, params,
                                         delta, k=48, boundary=True,
                                         warm_start=True)
        tstep = th.make_halo_pcisph_step(tmesh, tspec, tparams, delta, k=48,
                                         boundary=True, warm_start=True)
    jout = jax.block_until_ready(jstep(jslabs))
    tout = tstep(port_slabs(jslabs))
    before = np.asarray(jslabs.alive).reshape(N_DEV, -1).sum(1)
    assert np.asarray(jout[3])[1] > before[1], "no migration"
    assert_step_outputs_equal(jout, tout, TOL_HALO)
    pos, vel = th.collect(tout[0])
    jpos, _ = jh.collect(jout[0])
    assert pos.shape == jpos.shape
