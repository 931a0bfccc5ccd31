"""The training path, whole: Materials gradients through the dense steps.

On the n3=8 dam break of tests/test_pallas_dense.py (seeded velocities,
d0 raised 10% so the fluid is under pressure), the loss sum(next.pos * w)
with a seeded w goes through

  * dense_wcsph_step(materials=m): gradients of mu, d0, tait_gamma, tait_w,
    mass and the pre-step positions;
  * dense_pcisph_step(materials=m, unroll_for_grad=True, unroll_iters=2):
    gradients of mu, d0, mass and the pre-step positions,

in the port (plain adjoint sweeps on the CPU) and in the JAX package
(`jax.grad`, Pallas in interpret mode), from the same numpy state. Each JAX
gradient is computed once per module. Tolerances are relative (the position
gradient to its largest entry) and stated beside each, with the drift
measured.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dieselfluid_tpu.config import FluidParams
from dieselfluid_tpu.models.materials import Materials as JMaterials
from dieselfluid_tpu.models.particles import FluidState as JFluidState
from dieselfluid_tpu.models.particles import dam_break_state
from dieselfluid_tpu.ops import cellops as jc
from dieselfluid_tpu.solvers import dense_step as jds
from dieselfluid_tpu.solvers.pcisph import compute_pci_delta
from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.models.materials import Materials
from dieselfluid_tpu_torch.solvers import dense_step as tds

torch.set_num_threads(1)

N3 = 8
DX = (2.0 / N3) * 0.5
UNROLL = 2
FIELDS = {"wcsph": ("mu", "d0", "tait_gamma", "tait_w", "mass"),
          "pcisph": ("mu", "d0", "mass")}
# |port - jax| / |jax| per Materials gradient, and max |port - jax| /
# max |jax| for the position gradient. Measured: WCSPH at most 3.2e-6
# (tait_gamma) and 1.8e-7 (pos); PCISPH at most 1.0e-6 (d0, mass) and
# 5.1e-7 (pos). Each bound is about 10x the largest.
MAT_REL_TOL = 3e-5
POS_REL_TOL = 5e-6


@pytest.fixture(scope="module")
def setup():
    params = FluidParams.for_spacing(DX)
    s = dam_break_state(N3, params, extent=0.5)
    params = params.replace(d0=float(1.1 * params.d0))
    rng = np.random.default_rng(12)
    arrays = {"pos": np.asarray(s.pos),
              "vel": (rng.normal(size=s.vel.shape) * 0.1).astype(np.float32),
              "force": np.asarray(s.force),
              "density": np.asarray(s.density),
              "pressure": np.asarray(s.pressure)}
    w = rng.normal(size=s.pos.shape).astype(np.float32)
    jspec = jc.DenseCellSpec.for_domain((-1,) * 3, (1,) * 3, params.h,
                                        capacity=16)
    return dict(params=params, arrays=arrays, w=w, jspec=jspec,
                delta=compute_pci_delta(params, DX))


def _jax_grads(setup, solver):
    params, jspec, delta = setup["params"], setup["jspec"], setup["delta"]
    a = setup["arrays"]
    js = JFluidState(**{k: jnp.asarray(v) for k, v in a.items()})
    w = jnp.asarray(setup["w"])

    def loss(m, pos):
        st = js._replace(pos=pos)
        if solver == "wcsph":
            nxt, _ = jds.dense_wcsph_step(st, params, jspec, materials=m)
        else:
            nxt, _ = jds.dense_pcisph_step(st, params, jspec, delta,
                                           materials=m, unroll_for_grad=True,
                                           unroll_iters=UNROLL)
        return jnp.sum(nxt.pos * w), nxt.pos

    with pltpu.force_tpu_interpret_mode():
        (value, nxt_pos), (gm, gp) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(
                JMaterials.from_params(params), js.pos)
    return dict(loss=float(value), next_pos=np.asarray(nxt_pos),
                mats={f: float(getattr(gm, f)) for f in FIELDS[solver]},
                pos=np.asarray(gp))


def _port_grads(setup, solver):
    params = interop.fluid_params_from(setup["params"])
    spec = interop.cell_spec_from_jax(setup["jspec"])
    s = interop.fluid_state_from_numpy(**setup["arrays"], device="cpu")
    pos = s.pos.clone().requires_grad_()
    m = Materials.from_params(params, torch.device("cpu"),
                               requires_grad=True)
    st = s._replace(pos=pos)
    if solver == "wcsph":
        nxt, _ = tds.dense_wcsph_step(st, params, spec, materials=m)
    else:
        nxt, diag = tds.dense_pcisph_step(st, params, spec, setup["delta"],
                                          materials=m, unroll_for_grad=True,
                                          unroll_iters=UNROLL)
        assert diag.iters == UNROLL
    value = (nxt.pos * torch.from_numpy(setup["w"])).sum()
    fields = FIELDS[solver]
    grads = torch.autograd.grad(value, [getattr(m, f) for f in fields]
                                + [pos])
    return dict(loss=value.item(), next_pos=nxt.pos.detach().numpy(),
                mats={f: float(g) for f, g in zip(fields, grads[:-1])},
                pos=grads[-1].numpy())


@pytest.fixture(scope="module")
def grads(setup):
    """{solver: (port, jax)}: each gradient computed once."""
    return {solver: (_port_grads(setup, solver), _jax_grads(setup, solver))
            for solver in FIELDS}


def _assert_no_pair_two_z_cells_apart(pos, spec, h):
    """Every pair within h of the moved positions was binned at most one
    z-cell apart, so the port's 27-cell stencil and the Pallas window see
    the same pairs under the frame's frozen binning (ROADMAP C)."""
    flat, _, _ = jc.dense_indices(jnp.asarray(pos), spec)
    zcell = (np.asarray(flat) % spec.row_len) // spec.capacity
    p = pos.astype(np.float64)
    d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    near = d2 < h * h
    assert not (near & (np.abs(zcell[:, None] - zcell[None, :]) >= 2)).any()


@pytest.mark.parametrize("solver", ["wcsph", "pcisph"])
def test_loss_and_next_state_match_jax(setup, grads, solver):
    port, want = grads[solver]
    # float32 steps, other summation order: measured 3.6e-7 (loss, relative)
    # and 6.0e-8 (positions, absolute).
    assert abs(port["loss"] - want["loss"]) <= 3e-6 * abs(want["loss"])
    np.testing.assert_allclose(port["next_pos"], want["next_pos"],
                               rtol=0, atol=1e-6)
    _assert_no_pair_two_z_cells_apart(want["next_pos"], setup["jspec"],
                                      setup["params"].h)


@pytest.mark.parametrize("solver,field", [
    ("wcsph", f) for f in FIELDS["wcsph"]] + [
    ("pcisph", f) for f in FIELDS["pcisph"]])
def test_materials_gradient_matches_jax(grads, solver, field):
    port, want = grads[solver]
    got, ref = port["mats"][field], want["mats"][field]
    assert np.isfinite(got) and ref != 0.0
    assert abs(got - ref) <= MAT_REL_TOL * abs(ref), (got, ref)


@pytest.mark.parametrize("solver", ["wcsph", "pcisph"])
def test_position_gradient_matches_jax(grads, solver):
    port, want = grads[solver]
    scale = np.abs(want["pos"]).max()
    assert np.isfinite(port["pos"]).all()
    assert np.abs(port["pos"] - want["pos"]).max() <= POS_REL_TOL * scale


def test_rematerialized_iterations_give_the_same_gradients(setup,
                                                           monkeypatch):
    """On CUDA each unrolled PCISPH iteration is recomputed in the backward
    pass (torch.utils.checkpoint). Forced on here, the gradients are bit for
    bit those of the stored iterations: the recomputed body must read the
    step's inputs, not whatever the step rebinds after the loop."""
    plain = _port_grads(setup, "pcisph")
    monkeypatch.setattr(tds, "_rematerialize", lambda device: True)
    remat = _port_grads(setup, "pcisph")
    assert remat["mats"] == plain["mats"]
    np.testing.assert_array_equal(remat["pos"], plain["pos"])


@pytest.mark.parametrize("solver", ["wcsph", "pcisph"])
def test_materials_forward_matches_static_params(setup, solver):
    """Materials holding the params' own values give the static step: the
    PCISPH correction loop bit for bit (the same float32 values), WCSPH up to
    the factored sweeps' float32 order against the fused one (measured
    4.5e-7 of the largest velocity and 6e-8 in position)."""
    params = interop.fluid_params_from(setup["params"])
    spec = interop.cell_spec_from_jax(setup["jspec"])
    s = interop.fluid_state_from_numpy(**setup["arrays"], device="cpu")
    m = Materials.from_params(params, torch.device("cpu"))
    if solver == "wcsph":
        a, _ = tds.dense_wcsph_step(s, params, spec)
        b, _ = tds.dense_wcsph_step(s, params, spec, materials=m)
        scale = float(a.vel.abs().max())
        assert float((a.vel - b.vel).abs().max()) <= 5e-6 * scale
        assert float((a.pos - b.pos).abs().max()) <= 1e-6
    else:
        a, da = tds.dense_pcisph_step(s, params, spec, setup["delta"])
        b, db = tds.dense_pcisph_step(s, params, spec, setup["delta"],
                                      materials=m)
        assert da.iters == db.iters
        assert torch.equal(a.pos, b.pos) and torch.equal(a.vel, b.vel)


@pytest.mark.parametrize("field", ["d0", "mass", "mu"])
def test_gradient_through_the_correction_loop_raises(setup, field):
    """Without unroll_for_grad the PCISPH correction loop is forward only
    (jax.grad cannot go through its while_loop either). A gradient to one
    Materials field alone must raise, not come back without the pressure
    term."""
    params = interop.fluid_params_from(setup["params"])
    spec = interop.cell_spec_from_jax(setup["jspec"])
    s = interop.fluid_state_from_numpy(**setup["arrays"], device="cpu")
    m = Materials.from_params(params, torch.device("cpu"))
    m = m._replace(**{field: getattr(m, field).clone().requires_grad_()})
    nxt, _ = tds.dense_pcisph_step(s, params, spec, setup["delta"],
                                   materials=m)
    loss = (nxt.pos * torch.from_numpy(setup["w"])).sum()
    with pytest.raises(NotImplementedError,
                       match="forward-only in the JAX package"):
        torch.autograd.grad(loss, getattr(m, field))
