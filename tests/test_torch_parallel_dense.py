"""The port's slab-decomposed dense steps (parallel/dense_halo.py) against
the JAX package's, on the same numpy slabs.

JAX runs its sharded steps on the 4-device virtual CPU mesh with the
sweeps in Pallas interpret mode (its own smoke tests' size,
tests/test_dense_halo.py:489-567: n3 = 6, capacity 256, cell capacity 16),
synced after every step; the port runs them on a LocalMesh of 4 shards on
the CPU (the plain sweeps). Outputs compare slab by slab and slot by slot.
Tolerances are relative to each field's largest magnitude, about 10x the
drift measured here (stated beside each).
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

from dieselfluid_tpu.parallel import dense_halo as jdh
from dieselfluid_tpu.parallel.sharding import particle_mesh
from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.parallel import dense_halo as tdh
from dieselfluid_tpu_torch.parallel.mesh import LocalMesh

torch.set_num_threads(1)

# Measured: WCSPH pos 6.0e-8, vel 1.0e-7, pressure 2.1e-6, max_vel 0 (a
# column migrating); PCISPH with boundary pos 1.2e-7, vel 3.9e-7, pressure
# 4.3e-7, max_vel 2.2e-7.
TOL = {"pos": 1e-6, "vel": 1e-5, "pressure": 3e-5}


@pytest.fixture(scope="module")
def setup():
    params, tparams, dx = smoke_params()
    spec = jdh.DenseSlabSpec.build(N_DEV, params.h, capacity=256,
                                   migrate_capacity=64, cell_capacity=16)
    return params, tparams, dx, spec


def test_spec_and_distribute_dense_equal_jax(setup):
    """DenseSlabSpec (build, build_for_state, local_spec, park_z) and
    distribute_dense give JAX's fields and arrays."""
    params, _, dx, spec = setup
    arrays = numpy_state(params, dx)
    tspec = interop.dense_slab_spec_from(spec)
    assert tspec.local_spec == interop.cell_spec_from_jax(spec.local_spec)
    assert (tspec.slab_width, tspec.hi_x, tspec.park_z) == (
        spec.slab_width, spec.hi_x, spec.park_z)
    js, ts = jax_state(arrays), torch_state(arrays)
    jfs = jdh.DenseSlabSpec.build_for_state(js, N_DEV, params.h, 64)
    assert tdh.DenseSlabSpec.build_for_state(ts, N_DEV, params.h, 64) == \
        interop.dense_slab_spec_from(jfs)
    jsl, tsl = jdh.distribute_dense(js, spec), tdh.distribute_dense(ts,
                                                                   tspec)
    for f in ("pos", "vel", "alive", "dropped", "pressure"):
        np.testing.assert_array_equal(getattr(tsl, f).numpy(),
                                      np.asarray(getattr(jsl, f)), f)


def test_wcsph_step_equals_jax(setup):
    """One static-params step (K1 + K2) from a state whose column left of
    the first slab face crosses it: the migrants land slot for slot."""
    params, tparams, dx, spec = setup
    arrays = numpy_state(params, dx, face=spec.lo + spec.slab_width)
    jslabs = jdh.distribute_dense(jax_state(arrays), spec)
    step = jdh.make_dense_halo_wcsph_step(particle_mesh(N_DEV), spec, params)
    with pltpu.force_tpu_interpret_mode():
        jout = jax.block_until_ready(step(jslabs))
    tstep = tdh.make_dense_halo_wcsph_step(
        LocalMesh((N_DEV,), "cpu"), interop.dense_slab_spec_from(spec),
        tparams)
    tout = tstep(port_slabs(jslabs))
    before = jslabs.alive.reshape(N_DEV, -1).sum(1)
    assert np.asarray(jout[4])[1] > np.asarray(before)[1], "no migration"
    assert_step_outputs_equal(jout, tout, TOL)


def test_pcisph_boundary_step_equals_jax(setup):
    """One warm-started PCISPH step with per-slab boundary stores (K1,
    K3, K4; the JAX smoke test's box container)."""
    from dieselfluid_tpu.geometry.mesh import box
    from dieselfluid_tpu.solvers.pcisph import compute_pci_delta

    params, tparams, dx, spec = setup
    arrays = numpy_state(params, dx, seed=1)
    bnd = np.asarray(box(1.6, 1.6, 1.6).generate_boundary_particles(1.0))
    delta = compute_pci_delta(params, dx)
    jslabs = jdh.distribute_dense(jax_state(arrays, bnd), spec)
    step = jdh.make_dense_halo_pcisph_step(particle_mesh(N_DEV), spec,
                                           params, delta, boundary=True,
                                           warm_start=True)
    with pltpu.force_tpu_interpret_mode():
        jout = jax.block_until_ready(step(jslabs))
    tslabs = port_slabs(jslabs)
    tspec = interop.dense_slab_spec_from(spec)
    tout = tdh.make_dense_halo_pcisph_step(
        LocalMesh((N_DEV,), "cpu"), tspec, tparams, delta, boundary=True,
        warm_start=True)(tslabs)
    assert_step_outputs_equal(jout, tout, TOL)
    np.testing.assert_array_equal(tout[0].boundary_pos.numpy(),
                                  np.asarray(jout[0].boundary_pos))
    # The port's distribute of the same numpy state gives the same stores.
    own = tdh.distribute_dense(torch_state(arrays, bnd), tspec)
    for f in ("boundary_pos", "boundary_mask", "pos", "pressure"):
        np.testing.assert_array_equal(getattr(own, f).numpy(),
                                      getattr(tslabs, f).numpy(), f)
