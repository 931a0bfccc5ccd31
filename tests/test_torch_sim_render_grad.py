"""The sim -> render gradient path whole: `bench.py` config 3 cut to size.

One static-params `dense_wcsph_step` (the fused force sweep, whose backward
is K7) of a jittered dam break, `splat_particles_tiled` of the next
positions with the bench camera (K11 forward, K12 backward), the pixel loss
sum(color^2), and its gradient to the pre-step positions: in the port (plain
sweeps and plain rasterizer on the CPU) and in the JAX package (`jax.grad`,
Pallas in interpret mode), from the same numpy state. The JAX side is
computed once per module.

Cut from the bench's 512k particles at 1920x1080, k = 8192: n3 = 8 (512
particles) at 256x144, k = 256, and the cell domain is the dam's corner of
the box (5^3 cells instead of 9^3, a third of the interpret-mode time; the
step's positions stay inside it). The splat radius is 0.6 of the
bench's 0.7 dx, so that every projected radius lies strictly inside the
clip (0.75, 4.5) px, as the bench's ~3.6 px do at 1080p.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dieselfluid_tpu.config import FluidParams
from dieselfluid_tpu.models.particles import FluidState as JFluidState
from dieselfluid_tpu.models.particles import dam_break_state
from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density
from dieselfluid_tpu.ops.cellops import DenseCellSpec as JDenseCellSpec
from dieselfluid_tpu.render.camera import Camera as JCamera
from dieselfluid_tpu.render.splat_pallas import (
    splat_particles_tiled as j_tiled,
)
from dieselfluid_tpu.solvers.dense_step import dense_wcsph_step as j_step
from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.render import splat_tiled as st
from dieselfluid_tpu_torch.render.splat import _project, pixel_radius
from dieselfluid_tpu_torch.solvers.dense_step import dense_wcsph_step

torch.set_num_threads(1)

N3 = 8
DX = 2.0 / N3 * 0.5
W, H, K = 256, 144, 256
RADIUS = DX * 0.7 * 0.6


def _camera():
    """bench.py's camera (bench.py:345-346); 256x144 has its 16:9."""
    return JCamera.at((0.0, 0.6, -2.8), front=(0.0, -0.35, 1.0),
                      fov_deg=55.0, aspect=1920.0 / 1080.0)


@pytest.fixture(scope="module")
def setup():
    params = lattice_rest_density(DX, FluidParams.for_spacing(DX))
    s = dam_break_state(N3, params, extent=0.5)
    rng = np.random.default_rng(80)
    arrays = {"pos": np.asarray(s.pos) + rng.uniform(
                  -0.2 * DX, 0.2 * DX, s.pos.shape).astype(np.float32),
              "vel": np.asarray(s.vel), "force": np.asarray(s.force),
              "density": np.asarray(s.density),
              "pressure": np.asarray(s.pressure)}
    off = params.h / 4.0
    jspec = JDenseCellSpec.for_domain((-1 - off,) * 3, (0.0,) * 3, params.h,
                                      capacity=16)
    return params, arrays, jspec


@pytest.fixture(scope="module")
def jax_result(setup):
    """jax.grad of the loss, chained by hand through the two halves: the
    step's VJP as compiled, the render's op by op (`jax.disable_jit`). The
    compiled render gives one pixel's alpha 1.1e-5 off the op-by-op (and
    float64) value, and the pixel loss's gradient, a sum of large terms
    that cancel per slot, turns such differences into 3.0e-3 of the
    largest position gradient: the compiled JAX render differs from itself
    op by op by as much (tools/splat_rim_probe.py)."""
    params, arrays, jspec = setup
    js = JFluidState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    cam = _camera()

    def step(pos):
        nxt, _ = j_step(js._replace(pos=pos), params, jspec)
        return nxt.pos

    def render(pos):
        img, ovf = j_tiled(pos, RADIUS, cam, width=W, height=H, k=K,
                           return_overflow=True)
        return jnp.sum(img.color ** 2), (img.color, ovf)

    with pltpu.force_tpu_interpret_mode():
        nxt, step_vjp = jax.vjp(step, js.pos)
        with jax.disable_jit():
            (val, (color, ovf)), g_next = jax.value_and_grad(
                render, has_aux=True)(nxt)
        (grad,) = step_vjp(g_next)
    return dict(loss=float(val), color=np.asarray(color), overflow=int(ovf),
                grad=np.asarray(grad))


@pytest.fixture(scope="module")
def port_result(setup):
    params, arrays, jspec = setup
    jcam = _camera()
    cam = interop.camera_from_numpy(
        np.asarray(jcam.transform), jcam.fov_deg, jcam.aspect, jcam.near,
        jcam.far, jcam.exposure, device="cpu")
    s = interop.fluid_state_from_numpy(**arrays, device="cpu")
    pos = s.pos.clone().requires_grad_()
    nxt, _ = dense_wcsph_step(s._replace(pos=pos),
                              interop.fluid_params_from(params),
                              interop.cell_spec_from_jax(jspec))
    img, ovf = st.splat_particles_tiled(nxt.pos, RADIUS, cam, width=W,
                                        height=H, k=K, return_overflow=True)
    loss = (img.color ** 2).sum()
    (grad,) = torch.autograd.grad(loss, pos)
    return dict(loss=loss.item(), color=img.color.detach().numpy(),
                overflow=int(ovf), grad=grad.numpy(), cam=cam,
                next_pos=nxt.pos.detach())


def test_frame_is_inside_the_clip_and_off_the_rim(port_result):
    """Every projected radius strictly inside (0.75, 4.5) px (no clip
    bound, where torch.clamp's gradient would differ from jnp.clip's; the
    port's clip splits a tie as jnp.clip does anyway), the step inside the
    cut cell domain, and no live splat pair within 1e-4 of the disc's rim
    (tests/test_torch_render.py: there one ulp of r2 becomes ~1% of a
    slot's gradient)."""
    cam, pos = port_result["cam"], port_result["next_pos"]
    assert float(pos.max()) < 0.0
    _, _, depth, focal = _project(cam, pos, W, H)
    r = pixel_radius(torch.full_like(depth, RADIUS), focal, depth, 9)
    assert 0.75 < float(r.min()) and float(r.max()) < 4.5
    spec = st.TileSpec(W, H, k=K)
    planes, _, _, _ = st.tile_entries(pos, RADIUS, cam, spec)
    assert st.rim_gap(planes, spec) > 1e-4


def test_loss_and_image_match_jax(port_result, jax_result):
    assert port_result["overflow"] == jax_result["overflow"] == 0
    # float32 step and render in another summation order: measured 8.9e-8
    # (loss, relative) and 5.1e-7 (color, absolute).
    assert abs(port_result["loss"] - jax_result["loss"]) \
        <= 1e-6 * abs(jax_result["loss"])
    np.testing.assert_allclose(port_result["color"], jax_result["color"],
                               rtol=0, atol=5e-6)


def test_position_gradient_matches_jax(port_result, jax_result):
    g, want = port_result["grad"], jax_result["grad"]
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    # Relative to the largest entry: measured 1.1e-4. Each slot's gradient
    # sums large per-pixel terms that cancel, so float32 rounding shows at
    # this level (the plain rasterizer alone is within 6.9e-7 of JAX's on
    # shared slot planes and cotangents, tests/test_torch_render.py).
    assert np.abs(g - want).max() <= 1e-3 * np.abs(want).max()
