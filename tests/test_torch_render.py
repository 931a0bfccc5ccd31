"""The port's renderer against the JAX package: camera, projection, tile
binning, SH lighting, and the tile rasterizer K11/K12 (PERF.md) in its plain
form (the CPU path; the kernels are held to it on the card).

Inputs are made with numpy from seeds and handed to both packages; the JAX
rasterizer runs in Pallas interpret mode. Tolerances are stated beside each
assert with the drift measured.

The rim. The splat's normal has z = sqrt(1 - r2) inside the disc, whose
derivative 0.5 / sqrt(1 - r2) grows without bound at the rim, and the
where-trick switches it off at 1 - r2 = 1e-6. A pair within ~1e-5 of the
rim turns a one-ulp difference in r2 into a ~1% difference in its slot's
gradient: the tiled and scatter gradients of 300-splat frames differ by up
to 1.2e-2 of the largest entry (tools/splat_rim_probe.py). The frames
compared across formulas below assert that no live pair comes that close
(`_assert_off_the_rim`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dieselfluid_tpu.render import cubemap as jcube
from dieselfluid_tpu.render import sh as jsh
from dieselfluid_tpu.render import splat_pallas as jsp
from dieselfluid_tpu.render.camera import Camera as JCamera
from dieselfluid_tpu.render.splat import _project as j_project
from dieselfluid_tpu.render.splat import splat_particles as j_splat
from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.render import cubemap as tcube
from dieselfluid_tpu_torch.render import sh as tsh
from dieselfluid_tpu_torch.render import splat_tiled as st
from dieselfluid_tpu_torch.render.camera import Camera
from dieselfluid_tpu_torch.render.splat import _project, splat_particles

torch.set_num_threads(1)

SHARP, FALLOFF = 12.0, 2.0


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _port_camera(jcam):
    return interop.camera_from_numpy(
        np.asarray(jcam.transform), jcam.fov_deg, jcam.aspect, jcam.near,
        jcam.far, jcam.exposure, device="cpu")


def _t(a):
    """A torch copy of a numpy or JAX array (a JAX array's numpy view is
    read-only)."""
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# Camera
# --------------------------------------------------------------------------


def test_camera_matches_jax():
    """Camera.at, view, projection, mvp, rays, translate, rotate_axis and
    rotate_fps. Measured at most 2.4e-7 (absolute, unit-scale entries)."""
    args = ((0.3, 0.6, -2.8), (0.1, -0.35, 1.0))
    kw = dict(fov_deg=55.0, aspect=16 / 9)
    jc, tc = JCamera.at(*args, **kw), Camera.at(*args, **kw, device="cpu")
    pairs = [(jc.transform, tc.transform),
             (jc.view_matrix(), tc.view_matrix()),
             (jc.projection_matrix(), tc.projection_matrix()),
             (jc.mvp(), tc.mvp())]
    for jr, tr in zip(jc.pixel_rays(32, 18), tc.pixel_rays(32, 18)):
        pairs.append((jr, tr))
    for j2, t2 in ((jc.translate((0.5, -0.2, 0.1)),
                    tc.translate((0.5, -0.2, 0.1))),
                   (jc.rotate_axis((0.0, 1.0, 0.2), 25.0),
                    tc.rotate_axis((0.0, 1.0, 0.2), 25.0)),
                   (jc.rotate_fps(30.0, 10.0), tc.rotate_fps(30.0, 10.0))):
        pairs += [(j2.transform, t2.transform),
                  (j2.view_matrix(), t2.view_matrix())]
    for j, t in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=2e-6)
    r = tc.rotate_fps(30.0, 10.0).transform[:3, :3]
    np.testing.assert_allclose((r @ r.T).numpy(), np.eye(3), atol=1e-5)


# --------------------------------------------------------------------------
# Projection and binning
# --------------------------------------------------------------------------


def _frame(n=300, seed=0, lo=-0.5, hi=0.5):
    cam = JCamera.at((0.0, 0.0, -2.0), front=(0.0, 0.0, 1.0), fov_deg=60.0,
                     aspect=256 / 144)
    pos = np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(
        np.float32)
    return cam, pos


def _jax_entries(jcam, pos, spec, radius=0.05):
    """JAX's projection and binning of a frame: (u, v, z_norm, pix_r,
    in_front), planes, (flat, valid), overflow."""
    u, v, depth, focal = j_project(jcam, jnp.asarray(pos), spec.width,
                                   spec.height)
    in_front = depth > 1e-3
    pix_r = jnp.clip(radius * focal / jnp.maximum(depth, 1e-3), 0.75,
                     spec.patch / 2.0)
    z = depth - jnp.min(jnp.where(in_front, depth, jnp.inf))
    chans = (u, v, z, pix_r, in_front)
    planes, fv, ovf = jsp.bin_tile_entries(*chans, spec)
    return chans, planes, fv, ovf


def test_project_matches_jax():
    jcam, pos = _frame()
    ju, jv, jd, jf = j_project(jcam, jnp.asarray(pos), 256, 144)
    u, v, d, f = _project(_port_camera(jcam), _t(pos), 256, 144)
    # float32 view transform, other reduction order, and float32 tan of
    # another library: measured 1.2e-7 (focal length, relative), 1.5e-5 px
    # (u, v up to ~300) and 0 in depth.
    assert abs(float(f) - float(jf)) <= 1e-6 * float(jf)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=1e-4)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-4)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [256, 128])
def test_bin_tile_entries_matches_jax(k):
    """From the same (u, v, z, r, in_front): the same valid entries, the
    same slots and overflow, bitwise-equal planes (k = 128 overflows)."""
    jcam, pos = _frame(n=600, lo=-0.3, hi=0.3)
    spec = st.TileSpec(256, 144, k=k)
    jspec = jsp.TileSpec(256, 144, k=k)
    chans, jplanes, (jflat, jvalid), jovf = _jax_entries(jcam, pos, jspec)
    planes, (flat, valid), ovf = st.bin_tile_entries(
        *[_t(c) for c in chans], spec)
    assert (k == 128) == (int(jovf) > 0)
    assert int(ovf) == int(jovf)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    # Slots of the valid entries (the others park in trash slots; the port
    # clamps the tile id of entries in no tile).
    v = valid.numpy()
    np.testing.assert_array_equal(flat.numpy()[v], np.asarray(jflat)[v])
    for n in st.CHANNELS:
        np.testing.assert_array_equal(planes[n].numpy(),
                                      np.asarray(jplanes[n]))


def test_float_patch_box_is_the_integer_box():
    """The JAX kernel tests the patch box in float, |px + 0.5 - u - 0.5 + u
    - floor(u)| <= half (splat_pallas.py:224-226); the port tests the
    integers |px - floor(u)| <= half. On 2M random tile-local centers per
    axis, at pixels up to 5 from floor(u) inside the tile, both agree."""
    rng = np.random.default_rng(17)
    f32 = np.float32
    for hi, size in ((133.0, 128), (13.0, 8)):
        u = rng.uniform(-5.0, hi, 2_000_000).astype(f32)
        fu = np.floor(u)
        px = (fu + rng.integers(-5, 6, u.shape)).astype(f32)
        keep = (px >= 0) & (px < size)
        u, fu, px = u[keep], fu[keep], px[keep]
        dxp = (px + f32(0.5)) - u
        lit = np.abs(dxp - f32(0.5) + u - fu) <= 4
        np.testing.assert_array_equal(lit, np.abs(px - fu) <= 4)


def test_overflow_counted():
    """600 coincident particles at the image center (128, 72), a corner of
    four tiles: each tile gets 600 entries, 128 fit."""
    jcam, _ = _frame()
    pos = torch.zeros((600, 3))
    _, ovf = st.splat_particles_tiled(pos, 0.05, _port_camera(jcam), 256,
                                      144, k=128, return_overflow=True)
    assert int(ovf) == 4 * (600 - 128)


# --------------------------------------------------------------------------
# SH lighting
# --------------------------------------------------------------------------


def test_sh_and_cubemap_directions_match_jax():
    rng = np.random.default_rng(4)
    cube = rng.uniform(size=(6, 8, 8, 3)).astype(np.float32)
    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    # Measured: directions and basis equal, 3.5e-7 of the coefficients'
    # largest, 4.2e-7 (evaluation).
    np.testing.assert_allclose(
        tcube.cubemap_directions(8, device="cpu").numpy(),
        np.asarray(jcube.cubemap_directions(8)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tsh.sh9_basis(_t(dirs)).numpy(),
                               np.asarray(jsh.sh9_basis(jnp.asarray(dirs))),
                               rtol=0, atol=1e-6)
    jco = np.asarray(jsh.project_sh9(jnp.asarray(cube)))
    tco = tsh.project_sh9(_t(cube))
    assert _rel(tco.numpy(), jco) < 3e-6
    np.testing.assert_allclose(
        tsh.eval_sh9(tco, _t(dirs)).numpy(),
        np.asarray(jsh.eval_sh9(jnp.asarray(jco), jnp.asarray(dirs))),
        rtol=0, atol=3e-6)


# --------------------------------------------------------------------------
# The rasterizer: plain K11 / K12 against JAX's _rasterize and its VJP
# --------------------------------------------------------------------------


def _assert_off_the_rim(planes, spec, gap=3e-5):
    """No live pair within `gap` of the disc's rim (module docstring)."""
    assert st.rim_gap(planes, spec) > gap


@pytest.fixture(scope="module")
def raster_case():
    """A 256x16 frame (4 tiles, k = 256) of 120 splats, its slot planes
    (JAX's binning) and seeded cotangent planes; JAX's outputs and VJP per
    output width, once per module."""
    cam = JCamera.at((0.0, 0.0, -2.0), front=(0.0, 0.0, 1.0), fov_deg=20.0,
                     aspect=16.0)
    rng = np.random.default_rng(21)
    pos = rng.uniform(-0.45, 0.45, (120, 3)).astype(np.float32)
    pos[:, 1] *= 0.06
    jspec = jsp.TileSpec(256, 16, k=256)
    _, jplanes, _, ovf = _jax_entries(cam, pos, jspec, radius=0.02)
    assert int(ovf) == 0
    cts = rng.normal(size=(9,) + (jspec.n_tiles, 8, 128)).astype(np.float32)
    ref = {}
    with pltpu.force_tpu_interpret_mode():
        for n_out in (6, 9):
            emit = n_out == 9

            def f(p, emit=emit):
                return jsp._rasterize(p, jspec, SHARP, FALLOFF, emit)

            outs, vjp = jax.vjp(f, jplanes)
            (g,) = vjp(tuple(jnp.asarray(c) for c in cts[:n_out]))
            ref[n_out] = ([np.asarray(o) for o in outs],
                          [np.asarray(g[c]) for c in st.CHANNELS])
    planes = {n: _t(jplanes[n]) for n in st.CHANNELS}
    return st.TileSpec(256, 16, k=256), planes, cts, ref


@pytest.mark.parametrize("n_out", [6, 9])
def test_plain_rasterizer_matches_jax(raster_case, n_out):
    spec, planes, cts, ref = raster_case
    _assert_off_the_rim(planes, spec)
    outs = st.plain.rasterize_fwd(planes, spec, SHARP, FALLOFF, n_out == 9)
    want_o, want_g = ref[n_out]
    assert len(outs) == n_out
    # Forward: the same float32 pair, other summation order (measured at
    # most 1.6e-7 per output, relative to its largest).
    for o, w in zip(outs, want_o):
        assert _rel(o.numpy(), w) < 2e-6
    grads = st.plain.rasterize_bwd(planes, [_t(c) for c in cts[:n_out]],
                                   spec, SHARP, FALLOFF, n_out == 9)
    # Backward: the hand adjoint against jax.vjp's, per gradient (measured
    # at most 6.9e-7, d/du with 9 outputs).
    for name, g, w in zip(st.CHANNELS, grads, want_g):
        assert _rel(g.numpy(), w) < 4e-6, name
    dead = planes["r"] < 0.5
    assert all(bool((g[dead] == 0).all()) for g in grads)


def _literal_fwd(planes, spec, emit_normals):
    """The JAX kernel's literal form: every slot against every pixel of its
    tile, the patch box tested in float as splat_pallas.py:224-226 does,
    live = mask * in_patch multiplied in."""
    half = spec.patch // 2
    s = {n: planes[n].reshape(spec.n_tiles, spec.k, 1, 1) for n in
         st.CHANNELS}
    px = (torch.arange(spec.tw, dtype=torch.float32) + 0.5).view(1, 1, 1, -1)
    py = (torch.arange(spec.th, dtype=torch.float32) + 0.5).view(1, 1, -1, 1)
    mask = (s["r"] >= 0.5).float()
    dxp, dyp = px - s["u"], py - s["v"]
    in_patch = ((torch.abs(dxp - 0.5 + s["u"] - torch.floor(s["u"])) <= half)
                & (torch.abs(dyp - 0.5 + s["v"] - torch.floor(s["v"]))
                   <= half))
    live = mask * in_patch.float()
    terms = st._splat_pair(s["u"], s["v"], s["z"], s["r"], px, py, SHARP,
                           FALLOFF, emit_normals)
    # w and coverage carry live; every output is linear in one of them.
    return [(t * live).sum(dim=1) for t in terms]


@pytest.mark.parametrize("n_out", [6, 9])
def test_patch_box_rasterizer_matches_all_pixels_form(raster_case, n_out):
    """The plain K11 visits each slot's patch box only; the JAX kernel
    evaluates every (slot, pixel) pair of the tile with live = 0 outside
    the box. Same sums (measured 1.7e-7 of each output's largest)."""
    spec, planes, _, _ = raster_case
    got = st.plain.rasterize_fwd(planes, spec, SHARP, FALLOFF, n_out == 9)
    want = _literal_fwd(planes, spec, n_out == 9)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w.numpy()) < 2e-6


@pytest.mark.parametrize("emit_normals", [False, True])
def test_adjoint_pair_matches_func_vjp(emit_normals):
    """The hand-written splat adjoint against torch.func.vjp of the pair,
    per (slot, pixel) pair, on pairs inside and outside the disc (measured
    at most 1.5e-7)."""
    rng = np.random.default_rng(8)
    n = 4000

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    u, v = t(rng.uniform(0, 10, n)), t(rng.uniform(0, 8, n))
    z, r = t(rng.uniform(0, 1, n)), t(rng.uniform(0.75, 4.5, n))
    px = torch.floor(u) + t(rng.integers(-4, 5, n)) + 0.5
    py = torch.floor(v) + t(rng.integers(-4, 5, n)) + 0.5
    n_out = 9 if emit_normals else 6
    cts = [t(rng.normal(size=n)) for _ in range(n_out)]
    _, vjp = torch.func.vjp(
        lambda *a: st._splat_pair(*a, px, py, SHARP, FALLOFF, emit_normals),
        u, v, z, r)
    want = vjp(tuple(cts))
    got = st._splat_pair_bwd(u, v, z, r, px, py, cts, SHARP, FALLOFF,
                             emit_normals)
    for name, g, w in zip(st.CHANNELS, got, want):
        assert bool(torch.isfinite(g).all())
        assert _rel(g.numpy(), w.numpy()) < 1e-6, name


# --------------------------------------------------------------------------
# The tiled renderer against the eager scatter renderer (both the port's)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiled_frame():
    """200 splats whose live pairs all stay 3e-4 off the rim: the scatter
    path divides by r where the tiles multiply by 1/r, and near the rim
    that one ulp is amplified (module docstring)."""
    cam, pos = _frame(n=200, seed=32)
    tcam = _port_camera(cam)
    spec = st.TileSpec(256, 144, k=256)
    planes, _, ovf, _ = st.tile_entries(_t(pos), 0.05, tcam, spec)
    assert int(ovf) == 0
    _assert_off_the_rim(planes, spec, gap=3e-4)
    return tcam, pos


def test_tiled_image_matches_scatter(tiled_frame):
    cam, pos = tiled_frame
    a = splat_particles(_t(pos), 0.05, cam, 256, 144)
    b = st.splat_particles_tiled(_t(pos), 0.05, cam, 256, 144, k=256)
    # The same pairs; the scatter divides by r where the tiles multiply by
    # 1/r. Measured 6.6e-7 (color), 7.2e-7 (alpha), 1.2e-6 (depth).
    np.testing.assert_allclose(b.color.numpy(), a.color.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(b.alpha.numpy(), a.alpha.numpy(), rtol=0,
                               atol=1e-5)
    covered = a.alpha.numpy() > 1e-4
    np.testing.assert_allclose(b.depth.numpy()[covered],
                               a.depth.numpy()[covered], rtol=0, atol=1e-4)


@pytest.mark.parametrize("chunk", [None, 64])
def test_tiled_gradients_match_scatter(tiled_frame, chunk):
    """d sum(color^2) / d positions, tiled (plain K12) against the eager
    scatter renderer, whole and chunked (rematerialized blocks). Measured
    1.0e-5 of the largest gradient (the r vs 1/r rounding)."""
    cam, pos = tiled_frame
    grads = []
    for tiled in (False, True):
        p = _t(pos).clone().requires_grad_()
        img = (st.splat_particles_tiled(p, 0.05, cam, 256, 144, k=256)
               if tiled else splat_particles(p, 0.05, cam, 256, 144,
                                             chunk=chunk))
        (g,) = torch.autograd.grad((img.color ** 2).sum(), p)
        grads.append(g.numpy())
    assert _rel(grads[1], grads[0]) < 1e-4


@pytest.mark.parametrize("shading", ["normals", "colors", "env"])
def test_scatter_renderer_matches_jax(shading):
    """The eager scatter renderer against JAX's `splat_particles`, op by op
    (`jax.disable_jit`, as tests/test_torch_sim_render_grad.py does: XLA's
    compiled render rounds in another order), on 200 splats held 1e-4 off
    the rim with the bench's fov (55 degrees: the port's float32 focal
    length is JAX's there, so u and v agree bit for bit). The image, and
    the gradients of sum(color^2) to the positions and to the per-particle
    colors (`colors=`) or the cube's texels (`env_cube=`)."""
    _, pos = _frame(n=200, seed=32)
    jcam = JCamera.at((0.0, 0.0, -2.0), front=(0.0, 0.0, 1.0), fov_deg=55.0,
                      aspect=256 / 144)
    cam = _port_camera(jcam)
    spec = st.TileSpec(256, 144, k=256)
    _assert_off_the_rim(st.tile_entries(_t(pos), 0.05, cam, spec)[0], spec,
                        gap=1e-4)
    rng = np.random.default_rng(33)
    key, extra = {"normals": (None, None),
                  "colors": ("colors", rng.uniform(size=(200, 3))),
                  "env": ("env_cube", rng.uniform(size=(6, 4, 4, 3)))}[shading]
    extra = None if extra is None else extra.astype(np.float32)

    def kw(x):
        return {} if key is None else {key: x}

    def jloss(p, x):
        img = j_splat(p, 0.05, jcam, 256, 144, **kw(x))
        return jnp.sum(img.color ** 2), img.color

    with jax.disable_jit():
        (_, jcolor), jgrads = jax.value_and_grad(
            jloss, argnums=(0,) if key is None else (0, 1), has_aux=True)(
                jnp.asarray(pos), None if key is None else jnp.asarray(extra))
    args = [_t(pos).requires_grad_()]
    if key is not None:
        args.append(_t(extra).requires_grad_())
    img = splat_particles(args[0], 0.05, cam, 256, 144,
                          **kw(args[-1] if key else None))
    grads = torch.autograd.grad((img.color ** 2).sum(), args)
    # The same float32 formulas, another scatter order: measured at most
    # 3.6e-7 (color, absolute; env) and, per gradient, 5.6e-7 of its
    # largest entry (positions, env).
    np.testing.assert_allclose(img.color.detach().numpy(),
                               np.asarray(jcolor), rtol=0, atol=4e-6)
    assert len(grads) == len(jgrads)
    for g, w in zip(grads, jgrads):
        assert bool(torch.isfinite(g).all())
        assert _rel(g.numpy(), w) < 5e-6, _rel(g.numpy(), w)


def test_env_lit_tiled_matches_scatter_on_sparse_splats():
    """Deferred SH lighting equals the scatter path's per-sample shading
    where splats do not overlap (measured 2.4e-7), and the gradients reach
    positions and texels, finite and nonzero."""
    jcam = JCamera.at((0.0, 0.0, -2.0), front=(0.0, 0.0, 1.0), fov_deg=60.0,
                      aspect=1.0)
    cam = _port_camera(jcam)
    pos = torch.tensor([[-0.4, 0.0, 0.0], [0.4, 0.2, 0.1],
                        [0.0, -0.4, -0.2]])
    cube = _t(np.random.default_rng(1).uniform(size=(6, 4, 4, 3)).astype(
        np.float32))
    a = splat_particles(pos, 0.08, cam, 128, 128, env_cube=cube)
    b = st.splat_particles_tiled(pos, 0.08, cam, 128, 128, k=128,
                                 env_cube=cube)
    np.testing.assert_allclose(b.color.numpy(), a.color.numpy(), rtol=0,
                               atol=1e-5)
    p, c = pos.clone().requires_grad_(), cube.clone().requires_grad_()
    img = st.splat_particles_tiled(p, 0.08, cam, 128, 128, k=128, env_cube=c)
    gp, gc = torch.autograd.grad((img.color ** 2).sum(), (p, c))
    for g in (gp, gc):
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
