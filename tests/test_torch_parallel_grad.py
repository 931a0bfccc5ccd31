"""Gradients through the sharded dense WCSPH step (parallel/dense_halo.py,
`materials_arg=True`): BASELINE configuration 5's "psum grads".

The loss is the JAX dryrun's, sum(alive * sin(3 pos)) over the next
slabs, differentiated to the Materials that every shard reads (autograd
sums the shards' shares on a LocalMesh, shard_map's transpose psum in
JAX). Held against:
  * the port's unsharded dense_wcsph_step(materials=) on the matching
    global lattice (n3 = 10, JAX's own oracle setup,
    tests/test_dense_halo.py:312-371), whose gradients
    test_torch_materials_grad.py holds against jax.grad;
  * JAX's sharded jax.grad at its smoke size (n3 = 6, 4 devices, sweeps in
    interpret mode; ~40 s, the bulk of this file).
And the ghost cotangent sync is shown to matter: without it the
cross-face source-role terms are lost and the gradients move by far more
than the tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_parallel_cases import N_DEV, jax_state, numpy_state, port_slabs
from torch_parallel_cases import smoke_params

from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.models.materials import Materials
from dieselfluid_tpu_torch.models.particles import dam_break_state
from dieselfluid_tpu_torch.ops.cellops import DenseCellSpec
from dieselfluid_tpu_torch.parallel import dense_halo as tdh
from dieselfluid_tpu_torch.parallel.mesh import LocalMesh
from dieselfluid_tpu_torch.solvers.dense_step import dense_wcsph_step

torch.set_num_threads(1)
CPU = torch.device("cpu")
FIELDS = ("mu", "d0", "tait_gamma", "tait_w", "mass")
# Relative difference per Materials field. Measured against the unsharded
# step at n3 = 10: at most 3.4e-6 (mu; 6.0% without the sync); against
# JAX's sharded jax.grad at n3 = 6: at most 6.0e-7 (mu). Bounds ~10x those.
# JAX holds its own sharded gradient to its single-chip one at rtol 2e-3.
REL_TOL_UNSHARDED = 3e-5
REL_TOL_JAX = 6e-6


def _loss(slabs):
    return ((slabs.alive > 0)[:, None] * torch.sin(3.0 * slabs.pos)).sum()


def _grads(loss, mats):
    return [float(g) for g in torch.autograd.grad(loss, list(mats))]


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.fixture(scope="module")
def oracle():
    n3, extent = 10, 0.5
    dx = (2.0 / n3) * extent
    params = FluidParams.for_spacing(dx)
    s0 = dam_break_state(n3, params, CPU, extent=extent)
    params = params.replace(d0=float(1.1 * params.d0))
    g = torch.Generator().manual_seed(7)
    s0 = s0._replace(vel=torch.randn(s0.vel.shape, generator=g) * 0.05)
    spec = tdh.DenseSlabSpec.build(N_DEV, params.h, capacity=1024,
                                   migrate_capacity=512, cell_capacity=32)
    gspec = DenseCellSpec.for_domain(
        (spec.lo,) * 3, (spec.hi_x, spec.hi_yz, spec.hi_yz + 3.0 * spec.cell),
        spec.cell, capacity=spec.cell_capacity)
    bounds = ((spec.lo,) * 3, (spec.hi_x, spec.hi_yz, spec.hi_yz))
    mats = Materials.from_params(params, CPU, requires_grad=True)
    nxt, _ = dense_wcsph_step(s0, params, gspec, bounds=bounds,
                              materials=mats)
    want = _grads(torch.sin(3.0 * nxt.pos).sum(), mats)
    return params, s0, spec, want


def _sharded_grads(params, s0, spec):
    mats = Materials.from_params(params, CPU, requires_grad=True)
    step = tdh.make_dense_halo_wcsph_step(LocalMesh((N_DEV,), CPU), spec,
                                          params, materials_arg=True)
    out, *_ = step(tdh.distribute_dense(s0, spec), mats)
    return _grads(_loss(out), mats)


def test_materials_grad_matches_unsharded(oracle):
    params, s0, spec, want = oracle
    got = _sharded_grads(params, s0, spec)
    for f, a, b in zip(FIELDS, got, want):
        assert np.isfinite(a) and b != 0.0, (f, a, b)
        assert _rel(a, b) <= REL_TOL_UNSHARDED, (f, a, b, _rel(a, b))


def test_ghost_cotangent_sync_carries_cross_face_terms(oracle,
                                                       monkeypatch):
    """With the sync replaced by the identity, the backward sweeps read
    zero cotangents in the ghost columns: the gradients move by far more
    than the tolerance (JAX measured ~6% at 4 slabs)."""
    params, s0, spec, want = oracle
    monkeypatch.setattr(tdh, "_ghost_ct_sync", lambda mesh, planes, spec:
                        planes)
    got = _sharded_grads(params, s0, spec)
    worst = max(_rel(a, b) for a, b in zip(got, want))
    assert worst > 100 * REL_TOL_UNSHARDED, worst


def test_materials_grad_matches_jax_sharded():
    from dieselfluid_tpu.models.materials import Materials as JMaterials
    from dieselfluid_tpu.ops.pallas_sph import sweep_vma
    from dieselfluid_tpu.parallel import dense_halo as jdh
    from dieselfluid_tpu.parallel.halo import AXIS
    from dieselfluid_tpu.parallel.sharding import particle_mesh

    params, tparams, dx = smoke_params()
    arrays = numpy_state(params, dx, seed=4)
    rng = np.random.default_rng(4)
    # Off the lattice: there the Tait clamp sits on its kink.
    arrays["pos"] = arrays["pos"] + rng.uniform(
        -0.2, 0.2, arrays["pos"].shape).astype(np.float32) * dx
    spec = jdh.DenseSlabSpec.build(N_DEV, params.h, capacity=256,
                                   migrate_capacity=64, cell_capacity=16)
    jslabs = jdh.distribute_dense(jax_state(arrays), spec)
    mesh = particle_mesh(N_DEV)
    jstep = jdh.make_dense_halo_wcsph_step(mesh, spec, params,
                                           materials_arg=True)

    def jloss(m):
        out, *_ = jstep(jslabs, m)
        return jnp.sum((out.alive > 0)[..., None] * jnp.sin(3.0 * out.pos))

    jm = JMaterials.from_params(params)
    with pltpu.force_tpu_interpret_mode(), jax.set_mesh(mesh), \
            sweep_vma(AXIS):
        jg = jax.block_until_ready(jax.grad(jloss)(jm))
    tm = interop.materials_from_numpy(
        *[np.asarray(getattr(jm, f)) for f in FIELDS], device=CPU,
        requires_grad=True)
    step = tdh.make_dense_halo_wcsph_step(
        LocalMesh((N_DEV,), CPU), interop.dense_slab_spec_from(spec),
        tparams, materials_arg=True)
    out, *_ = step(port_slabs(jslabs), tm)
    got = _grads(_loss(out), tm)
    for f, a in zip(FIELDS, got):
        b = float(getattr(jg, f))
        assert b != 0.0 and _rel(a, b) <= REL_TOL_JAX, (f, a, b, _rel(a, b))
