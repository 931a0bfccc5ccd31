"""`bench.py` config 4's real loss against the JAX package, on the CPU: the
unrolled PCISPH step with traced Materials, then the sky-lit tiled render,
sum(color^2), with its gradients to mu, d0, mass and the pre-step
positions, from the same numpy state.

The JAX step's VJP runs compiled, its render's op by op (`jax.disable_jit`,
as tests/test_torch_sim_render_grad.py takes it), Pallas in interpret
mode. Both packages read the same sky cube (the JAX bake at size 8). Cut
from the bench's 1M particles at 1920x1080, k = 8192: n3 = 8 (512
particles) at 256x144, the cell domain the dam's corner of the box,
positions jittered off the lattice (at the lattice's rest density the Tait
and pressure clamps sit on their kinks). It runs at k = 256 and at k = 128,
where the tile planes overflow as the bench's 1M frame does at k = 8192:
the port must drop the same entries as JAX (the stable within-tile rank)
and count them alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dieselfluid_tpu.models.materials import Materials as JMaterials
from dieselfluid_tpu.models.particles import FluidState as JFluidState
from dieselfluid_tpu.render.splat_pallas import (
    splat_particles_tiled as j_tiled,
)
from dieselfluid_tpu.solvers import dense_step as jds
from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.models.materials import Materials
from dieselfluid_tpu_torch.render import splat_tiled as st
from dieselfluid_tpu_torch.solvers import dense_step as tds
from test_torch_composite import (CPU, H, RADIUS, W, _jcam, _t, _tcam,
                                  setup)  # noqa: F401

torch.set_num_threads(1)

UNROLL = 3                 # bench.py:438
FIELDS = ("mu", "d0", "mass")


@pytest.fixture(scope="module")
def step_jax(setup):
    """The JAX unrolled PCISPH step with traced Materials, compiled, and its
    VJP: (next positions, vjp)."""
    params, jspec = setup["params"], setup["jspec"]
    js = JFluidState(**{k: jnp.asarray(v) for k, v in
                        setup["arrays"].items()})

    def step(m, pos):
        nxt, _ = jds.dense_pcisph_step(js._replace(pos=pos), params, jspec,
                                       setup["delta"], materials=m,
                                       unroll_for_grad=True,
                                       unroll_iters=UNROLL)
        return nxt.pos

    with pltpu.force_tpu_interpret_mode():
        nxt, vjp = jax.vjp(step, JMaterials.from_params(params), js.pos)
    return np.asarray(nxt), vjp


def _config4_jax(setup, step_jax, k):
    nxt, vjp = step_jax
    jc = _jcam()

    def render(p):
        img, ovf = j_tiled(p, RADIUS, jc, width=W, height=H, k=k,
                           return_overflow=True,
                           env_cube=jnp.asarray(setup["env"]))
        return jnp.sum(img.color ** 2), ovf

    with pltpu.force_tpu_interpret_mode():
        with jax.disable_jit():
            (val, ovf), g_next = jax.value_and_grad(render, has_aux=True)(
                jnp.asarray(nxt))
        gm, gp = vjp(g_next)
    return dict(loss=float(val), overflow=int(ovf), next_pos=nxt,
                mats={f: float(getattr(gm, f)) for f in FIELDS},
                pos=np.asarray(gp))


def _config4_port(setup, k):
    params = interop.fluid_params_from(setup["params"])
    spec = interop.cell_spec_from_jax(setup["jspec"])
    s = interop.fluid_state_from_numpy(**setup["arrays"], device=CPU)
    pos = s.pos.clone().requires_grad_()
    m = Materials.from_params(params, CPU, requires_grad=True)
    nxt, diag = tds.dense_pcisph_step(s._replace(pos=pos), params, spec,
                                      setup["delta"], materials=m,
                                      unroll_for_grad=True,
                                      unroll_iters=UNROLL)
    assert diag.iters == UNROLL
    cam = _tcam(_jcam())
    img, ovf = st.splat_particles_tiled(nxt.pos, RADIUS, cam, width=W,
                                        height=H, k=k, return_overflow=True,
                                        env_cube=_t(setup["env"]))
    loss = (img.color ** 2).sum()
    grads = torch.autograd.grad(loss, [getattr(m, f) for f in FIELDS]
                                + [pos])
    spec_t = st.TileSpec(W, H, k=k)
    planes = st.tile_entries(nxt.pos.detach(), RADIUS, cam, spec_t)[0]
    return dict(loss=loss.item(), overflow=int(ovf),
                next_pos=nxt.pos.detach().numpy(),
                mats={f: float(g) for f, g in zip(FIELDS, grads[:-1])},
                pos=grads[-1].numpy(), rim_gap=st.rim_gap(planes, spec_t))


@pytest.mark.parametrize("k", [256, 128])
def test_config4_loss_and_gradients_match_jax(setup, step_jax, k):
    """Config 4's loss through both packages at k = 256 (no tile overflows;
    the peak tile holds 160 entries) and k = 128 (entries past each tile's
    128th dropped): the same overflow
    count, the loss, and the gradients to mu, d0, mass and the pre-step
    positions. The frame stays 1e-5 off the disc's rim, where one ulp of
    r2 becomes ~1% of a slot's gradient (measured 2.7e-5: at the bench's
    radius no jitter seed tried kept 1e-4). Measured: overflow 0 and 122
    entries in both; next positions 6.0e-8 (absolute), loss 5.6e-7
    (relative), Materials gradients at most 1.1e-5 (relative, d0 and mass
    at k = 128), position gradient 5.3e-6 of its largest entry."""
    want = _config4_jax(setup, step_jax, k)
    port = _config4_port(setup, k)
    assert port["overflow"] == want["overflow"]
    assert (port["overflow"] > 0) == (k == 128)
    assert port["rim_gap"] > 1e-5
    np.testing.assert_allclose(port["next_pos"], want["next_pos"], rtol=0,
                               atol=1e-6)
    assert abs(port["loss"] - want["loss"]) <= 5e-6 * abs(want["loss"])
    for f in FIELDS:
        got, ref = port["mats"][f], want["mats"][f]
        assert np.isfinite(got) and ref != 0.0
        assert abs(got - ref) <= 1e-4 * abs(ref), (f, got, ref)
    scale = np.abs(want["pos"]).max()
    assert np.isfinite(port["pos"]).all() and scale > 0
    assert np.abs(port["pos"] - want["pos"]).max() <= 5e-5 * scale


