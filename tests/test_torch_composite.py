"""The composite renderer (A9b) as a whole against the JAX package, on the
CPU: `render_composite` on both of its splat paths, the tiled one with its
gradient to the positions, from the same numpy state and scene; and the
slice's modules importing with neither JAX nor imageio.

The JAX tiled render runs its Pallas kernels in interpret mode; its VJP is
taken op by op (`jax.disable_jit`), as tests/test_torch_sim_render_grad.py
takes it, because the compiled render differs from its own op-by-op
gradient by more than the port does (the disc's rim, PERF.md). Both
packages read the same sky cube (the JAX bake at size 8; the bakes agree
on their own in tests/test_torch_sky.py). Cut from `bench.py`'s
composite_1080p_fwd_bwd (512k particles at 1920x1080, k = 8192): the n3 = 8
dam break (512 particles), positions jittered off the lattice, at 256x144,
k = 256. Config 4's loss, the other whole path of the slice, is
tests/test_torch_config4_loss.py (each file stays near two minutes on one
worker).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dieselfluid_tpu.config import FluidParams
from dieselfluid_tpu.models.particles import dam_break_state
from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density
from dieselfluid_tpu.ops.cellops import DenseCellSpec as JDenseCellSpec
from dieselfluid_tpu.render import composite as jco
from dieselfluid_tpu.render import pbr as jpbr
from dieselfluid_tpu.render.camera import Camera as JCamera
from dieselfluid_tpu.sky.bake import bake_sky_cubemap as j_bake
from dieselfluid_tpu.solvers.pcisph import compute_pci_delta
from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.render import composite as tco

torch.set_num_threads(1)
CPU = torch.device("cpu")

N3 = 8
DX = 2.0 / N3 * 0.5
W, H = 256, 144
RADIUS = DX * 0.7          # bench.py:440
SUN = (0.3, 0.8, 0.5)      # bench.py:423


def _t(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _jcam():
    """bench.py's camera (bench.py:424-425); 256x144 keeps its 16:9."""
    return JCamera.at((0.0, 0.6, -2.8), front=(0.0, -0.35, 1.0),
                      fov_deg=55.0, aspect=1920.0 / 1080.0)


def _tcam(jc):
    return interop.camera_from_numpy(np.asarray(jc.transform), jc.fov_deg,
                                     jc.aspect, jc.near, jc.far,
                                     jc.exposure, device=CPU)


def _quad_scene():
    """bench.py's composite scene (bench.py:483-499): floor and back wall,
    two triangles each, one PBR material."""
    v = np.asarray([
        [-2, -1, -2], [2, -1, -2], [2, -1, 2],
        [-2, -1, -2], [2, -1, 2], [-2, -1, 2],
        [-2, -1, 1], [2, -1, 1], [2, 2, 1],
        [-2, -1, 1], [2, 2, 1], [-2, 2, 1],
    ], np.float32).reshape(4, 3, 3)
    norms = np.asarray([[0, 1, 0], [0, 1, 0], [0, 0, -1], [0, 0, -1]],
                       np.float32)
    jm = jax.tree.map(lambda leaf: leaf[None], jpbr.PBRMaterial.make(
        base_color=(0.55, 0.5, 0.45), metallic=0.05, roughness=0.7))
    return v, norms, np.zeros(4, np.int32), jm


@pytest.fixture(scope="module")
def setup():
    """Config 4's state at n3 = 8 (bench.py:404-421): the dam break with
    N(0, 0.05) velocities (numpy seed), lattice rest density, the PCISPH
    delta; positions jittered by up to 0.2 dx; the sky cube."""
    params = lattice_rest_density(DX, FluidParams.for_spacing(DX))
    s = dam_break_state(N3, params, extent=0.5)
    rng = np.random.default_rng(44)
    arrays = {"pos": np.asarray(s.pos) + rng.uniform(
                  -0.2 * DX, 0.2 * DX, s.pos.shape).astype(np.float32),
              "vel": (rng.normal(size=s.vel.shape) * 0.05).astype(
                  np.float32),
              "force": np.asarray(s.force),
              "density": np.asarray(s.density),
              "pressure": np.asarray(s.pressure)}
    off = params.h / 4.0
    jspec = JDenseCellSpec.for_domain((-1 - off,) * 3, (0.0,) * 3, params.h,
                                      capacity=16)
    env = np.array(j_bake(SUN, size=8))
    return dict(params=params, arrays=arrays, jspec=jspec, env=env,
                delta=compute_pci_delta(params, DX))


# --------------------------------------------------------------------------
# render_composite
# --------------------------------------------------------------------------


def _composite_args(setup):
    v, norms, mats, jm = _quad_scene()
    return v, norms, mats, jm, setup["arrays"]["pos"], setup["env"]


@pytest.fixture(scope="module")
def composite_jax(setup):
    """The JAX composite on the tiled path (deferred SH sky, SH scene pass),
    its value and its gradient to the positions op by op (the scene pass
    in one tile of rays: the tiling changes no value, and op by op each
    tile costs its own dispatches); and on the eager splat path with the
    cubemap scene pass, its value."""
    v, norms, mats, jm, pos, env = _composite_args(setup)
    jc = _jcam()

    def tiled(p):
        img = jco.render_composite(p, RADIUS, jc, jnp.asarray(v),
                                   jnp.asarray(norms), jnp.asarray(mats), jm,
                                   (2.0, 3.0, -2.0),
                                   env_cube=jnp.asarray(env), width=W,
                                   height=H, tiled_splats_k=256,
                                   tile=W * H)
        return jnp.sum(img.color ** 2), (img.color, img.fluid_alpha)

    with pltpu.force_tpu_interpret_mode(), jax.disable_jit():
        (val, (color, alpha)), g = jax.value_and_grad(tiled, has_aux=True)(
            jnp.asarray(pos))
    eager = jco.render_composite(jnp.asarray(pos), RADIUS, jc, jnp.asarray(v),
                                 jnp.asarray(norms), jnp.asarray(mats), jm,
                                 (2.0, 3.0, -2.0), env_cube=jnp.asarray(env),
                                 width=W, height=H,
                                 scene_env_mode="cubemap")
    return dict(loss=float(val), color=np.asarray(color),
                alpha=np.asarray(alpha), grad=np.asarray(g),
                eager_color=np.asarray(eager.color),
                eager_alpha=np.asarray(eager.fluid_alpha))


def _port_composite(setup, **kw):
    v, norms, mats, jm, pos, env = _composite_args(setup)
    sc = interop.scene_arrays_from_numpy(v, norms, mats, device=CPU)
    tm = interop.pbr_materials_from_numpy(*[np.asarray(a) for a in jm],
                                          device=CPU)
    p = _t(pos).requires_grad_()
    img = tco.render_composite(p, RADIUS, _tcam(_jcam()), sc["tris"],
                               sc["tri_normals"], sc["tri_materials"], tm,
                               (2.0, 3.0, -2.0), env_cube=_t(env), width=W,
                               height=H, **kw)
    return p, img


def test_tiled_composite_and_its_gradient_match_jax(setup, composite_jax):
    """render_composite(tiled_splats_k=256): colour, fluid coverage, the
    loss sum(color^2) and its gradient to the positions. Measured: colour
    3.2e-6 and coverage 4.1e-6 (absolute), loss 1.1e-7 (relative),
    gradient 2.3e-6 of its largest entry."""
    want = composite_jax
    p, img = _port_composite(setup, tiled_splats_k=256)
    loss = (img.color ** 2).sum()
    (g,) = torch.autograd.grad(loss, p)
    assert float(img.fluid_alpha.detach().max()) > 0.5
    assert bool(img.scene.hit.any())
    np.testing.assert_allclose(img.color.detach().numpy(), want["color"],
                               rtol=0, atol=3e-5)
    np.testing.assert_allclose(img.fluid_alpha.detach().numpy(),
                               want["alpha"], rtol=0, atol=3e-5)
    assert abs(loss.item() - want["loss"]) <= 1e-6 * abs(want["loss"])
    assert np.isfinite(g.numpy()).all()
    assert np.abs(g.numpy() - want["grad"]).max() \
        <= 2e-5 * np.abs(want["grad"]).max()


def test_eager_composite_matches_jax(setup, composite_jax):
    """render_composite on the eager splat path (per-sample sky shading)
    with the cubemap scene pass: colour and coverage. Measured 1.2e-5 and
    9.5e-6 (absolute: the scatter's index_add order differs)."""
    _, img = _port_composite(setup, scene_env_mode="cubemap")
    np.testing.assert_allclose(img.color.detach().numpy(),
                               composite_jax["eager_color"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(img.fluid_alpha.detach().numpy(),
                               composite_jax["eager_alpha"], rtol=0,
                               atol=1e-4)


# --------------------------------------------------------------------------
# Imports
# --------------------------------------------------------------------------

NEW_MODULES = [
    "dieselfluid_tpu_torch.mathx.polar", "dieselfluid_tpu_torch.render.light",
    "dieselfluid_tpu_torch.render.spectrum", "dieselfluid_tpu_torch.sky",
    "dieselfluid_tpu_torch.sky.earth", "dieselfluid_tpu_torch.sky.atmosphere",
    "dieselfluid_tpu_torch.sky.bake", "dieselfluid_tpu_torch.render.texture",
    "dieselfluid_tpu_torch.render.cubemap", "dieselfluid_tpu_torch.render.pbr",
    "dieselfluid_tpu_torch.render.raytrace",
    "dieselfluid_tpu_torch.render.gltf", "dieselfluid_tpu_torch.render.scene",
    "dieselfluid_tpu_torch.render.composite",
    "dieselfluid_tpu_torch.interop", "dieselfluid_tpu_torch.app.cli",
]


def test_new_modules_import_without_jax_or_imageio(tmp_path):
    """Every module of the slice imports in a fresh interpreter where
    imageio cannot be imported (the card's machine has none), and neither
    jax nor dieselfluid_tpu ends up loaded; an untextured scene loads and
    renders there too."""
    from dieselfluid_tpu_torch.render.gltf import make_gltf

    v, _, _, _ = _quad_scene()
    path = str(tmp_path / "s.gltf")
    make_gltf(v.reshape(-1, 3), np.arange(12, dtype=np.uint32)).save(path)
    code = f"""
import importlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("imageio", "jax", "dieselfluid_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
for m in {NEW_MODULES!r}:
    importlib.import_module(m)
import torch
from dieselfluid_tpu_torch.render.scene import Scene
from dieselfluid_tpu_torch.render.raytrace import render_scene
from dieselfluid_tpu_torch.render.camera import Camera
from dieselfluid_tpu_torch.sky.bake import bake_sky_cubemap
cpu = torch.device("cpu")
sc = Scene.load({path!r})
tris, norms, mats = sc.triangle_soup(device=cpu)
tex, base, nrm = sc.texture_stack(device=cpu)
img = render_scene(tris, norms, mats, sc.stacked_materials(device=cpu),
                   Camera.at((0, 0.6, -2.8), (0, -0.35, 1), device=cpu),
                   (2.0, 3.0, -2.0),
                   env_cube=bake_sky_cubemap((0.3, 0.8, 0.5), 4, device=cpu),
                   width=16, height=16, tri_uvs=sc.triangle_uvs(device=cpu),
                   textures=tex, mat_base_tex=base, mat_normal_tex=nrm)
assert bool(img.hit.any())
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "dieselfluid_tpu", "imageio"))
assert not bad, bad
print("clean")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")
