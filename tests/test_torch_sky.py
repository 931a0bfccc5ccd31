"""The port's sky (A9a) against the JAX package, on the CPU: mathx/polar,
render/light, render/spectrum, sky/earth, sky/atmosphere and sky/bake.

Inputs are made with numpy from seeds and handed to both packages. Every
module here is plain float32 arithmetic in both; the tolerances stated
beside each assert are about 10x the largest difference measured. The sky
bake is held at size 8, as its own tests run it: at larger sizes a few
texels, whose last view sample sits on the atmosphere's shell, take a light
path that one ulp of a vectorized exp flips (see PERF.md; chip_smoke.py
holds the card's 48^2 bake to the CPU's by the SH9 projection the renderers
read)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dieselfluid_tpu.mathx import polar as jpolar
from dieselfluid_tpu.render import light as jlight
from dieselfluid_tpu.render import spectrum as jspec
from dieselfluid_tpu.sky import atmosphere as jatm
from dieselfluid_tpu.sky import bake as jbake
from dieselfluid_tpu.sky import earth as jearth
from dieselfluid_tpu_torch.mathx import polar as tpolar
from dieselfluid_tpu_torch.render import light as tlight
from dieselfluid_tpu_torch.render import spectrum as tspec
from dieselfluid_tpu_torch.sky import atmosphere as tatm
from dieselfluid_tpu_torch.sky import bake as tbake
from dieselfluid_tpu_torch.sky import earth as tearth

torch.set_num_threads(1)
CPU = torch.device("cpu")
SUN = (0.3, 0.8, 0.5)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).detach(), np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _unit_dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


# --------------------------------------------------------------------------
# mathx/polar
# --------------------------------------------------------------------------


def test_polar_matches_jax():
    """Conversions both ways, the azimuth/polar shifts, ray-sphere roots at
    the sky's scale and min-|t| priority with ties (the first of equal
    |t|). Measured at most 9.8e-8 (relative); hits and ties exact."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(200, 3)).astype(np.float32) * 3.0
    s = np.stack([rng.uniform(0.1, 5, 200), rng.uniform(-3, 3, 200),
                  rng.uniform(0, 3, 200)], -1).astype(np.float32)
    pairs = [(jpolar.vec_to_sphere(v), tpolar.vec_to_sphere(_t(v))),
             (jpolar.sphere_to_vec(s), tpolar.sphere_to_vec(_t(s))),
             (jpolar.add_azimuth(jnp.asarray(s), 30.0, degrees=True),
              tpolar.add_azimuth(_t(s), 30.0, degrees=True)),
             (jpolar.add_polar(jnp.asarray(s), 0.2),
              tpolar.add_polar(_t(s), 0.2))]
    for want, got in pairs:
        assert _rel(got, want) <= 1e-6
    # Rays from the observer and from just inside the shell (the sky's
    # light paths), radius 14,370 km.
    d = _unit_dirs(300, 1)
    o = np.concatenate([np.tile([[0, 0, 6370.0]], (150, 1)),
                        _unit_dirs(150, 2) * 14369.0]).astype(np.float32)
    jt1, jt2, jhit = jpolar.ray_sphere_intersect(
        jnp.asarray(d), jnp.asarray(o), jnp.zeros(3), 14370.0)
    tt1, tt2, thit = tpolar.ray_sphere_intersect(_t(d), _t(o),
                                                 torch.zeros(3), 14370.0)
    assert np.array_equal(np.asarray(jhit), thit.numpy())
    assert _rel(tt1, jt1) <= 1e-6 and _rel(tt2, jt2) <= 1e-6
    ts = np.array([[1.0, -1.0], [2.0, 0.5], [-3.0, 3.0], [0.0, 0.0]],
                  np.float32)
    hits = np.array([[True, True], [False, True], [True, True],
                     [False, False]])
    want = jpolar.priority(jnp.asarray(ts), jnp.asarray(hits))
    got = tpolar.priority(_t(ts), torch.from_numpy(hits))
    assert np.array_equal(np.asarray(want), got.numpy())    # ties: first


def test_sqrt_rn_is_the_correctly_rounded_root():
    x = np.random.default_rng(3).uniform(1.0, 1e9, 100000).astype(np.float32)
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    assert np.array_equal(tpolar.sqrt_rn(_t(x)).numpy(), want)
    assert np.array_equal(np.asarray(jnp.sqrt(jnp.asarray(x))), want)


# --------------------------------------------------------------------------
# render/light, render/spectrum
# --------------------------------------------------------------------------


def test_lights_match_jax():
    """Irradiance and direction of each light at seeded points, and the
    RectLight grid. Measured exact (bound 1e-6 relative)."""
    pts = np.random.default_rng(4).normal(size=(64, 3)).astype(np.float32)
    js = jlight.Source.make((1.0, 0.9, 0.8), 40.0)
    ts = tlight.Source.make((1.0, 0.9, 0.8), 40.0, device=CPU)
    lights = [
        (jlight.Attenuated(jnp.asarray([0.5, 2.0, -1.0]), js),
         tlight.Attenuated(_t([0.5, 2.0, -1.0]), ts)),
        (jlight.Directional(jnp.zeros(3), jnp.asarray([0.2, -1.0, 0.3]), js),
         tlight.Directional(torch.zeros(3), _t([0.2, -1.0, 0.3]), ts)),
        (jlight.Area(jnp.asarray([0.0, 2.0, 0.0]),
                     jnp.asarray([0.0, -1.0, 0.0]), jnp.float32(0.6), js),
         tlight.Area(_t([0.0, 2.0, 0.0]), _t([0.0, -1.0, 0.0]), _t(0.6),
                     ts)),
    ]
    for jl, tl in lights:
        for want, got in zip(jl.irradiance(jnp.asarray(pts)),
                             tl.irradiance(_t(pts))):
            assert _rel(got, want) <= 1e-6
    jr = jlight.RectLight(jnp.asarray([0.0, 2.0, 0.0]),
                          jnp.asarray([0.0, -1.0, 0.2]), 2.0, 1.0, 4, 3, js)
    tr = tlight.RectLight(_t([0.0, 2.0, 0.0]), _t([0.0, -1.0, 0.2]), 2.0,
                          1.0, 4, 3, ts)
    ja, ta = jr.lights(), tr.lights()
    for f in ("pos", "normal", "cutoff"):
        assert _rel(getattr(ta, f), getattr(ja, f)) <= 1e-6
    assert _rel(ta.lum.flux, ja.lum.flux) <= 1e-6
    assert _rel(ta.lum.rgb, ja.lum.rgb) == 0
    for want, got in zip(ja.irradiance(jnp.asarray(pts[:12])),
                         ta.irradiance(_t(pts[:12]))):
        assert _rel(got, want) <= 1e-6


def test_spectrum_matches_jax():
    """Wavelength grid, the analytic CIE fits, SPD arithmetic and its XYZ,
    luminance and RGB, the window-averaged resampler, the colour matrices
    and the solar SPD. Measured at most 3.9e-7 (relative)."""
    rng = np.random.default_rng(5)
    lam = rng.uniform(360, 700, 500).astype(np.float32)
    for f in ("cie_x", "cie_y", "cie_z", "sunlight_spd"):
        assert _rel(getattr(tspec, f)(_t(lam)),
                    getattr(jspec, f)(jnp.asarray(lam))) <= 1e-6
    assert _rel(tspec.sunlight_spd_attenuated(_t(lam), 1.2),
                jspec.sunlight_spd_attenuated(jnp.asarray(lam), 1.2)) <= 1e-6
    assert _rel(tspec.wavelengths(20, device=CPU),
                jspec.wavelengths(20)) == 0
    js = jspec.init_sunlight(20)
    ts = tspec.init_sunlight(20, device=CPU)
    assert _rel(ts.values, js.values) <= 1e-6
    jc = jspec.SampledSpectrum.constant(20, 3.0)
    tc = tspec.SampledSpectrum.constant(20, 3.0, device=CPU)
    for jx, tx in ((js, ts), (js.mul(jc).add(jc).scale(0.5), ts.mul(tc)
                    .add(tc).scale(0.5)), (js.lerp(jc, 0.3).sqrt(),
                                           ts.lerp(tc, 0.3).sqrt())):
        assert _rel(tx.values, jx.values) <= 1e-6
        for m in ("to_xyz", "luminance", "to_rgb"):
            assert _rel(getattr(tx, m)(), getattr(jx, m)()) <= 1e-6
    assert bool(ts.is_black()) == bool(js.is_black()) is False
    xyz = rng.uniform(0, 1, (30, 3)).astype(np.float32)
    assert _rel(tspec.xyz_to_rgb(_t(xyz)),
                jspec.xyz_to_rgb(jnp.asarray(xyz))) <= 1e-6
    assert _rel(tspec.rgb_to_xyz(_t(xyz)),
                jspec.rgb_to_xyz(jnp.asarray(xyz))) <= 1e-6
    dom = np.sort(rng.uniform(350, 700, 40)).astype(np.float32)
    val = rng.uniform(0, 2, 40).astype(np.float32)
    want = jspec.spectrum_from_tabulated(dom, val, 16)
    got = tspec.spectrum_from_tabulated(dom, val, 16, device=CPU)
    assert _rel(got.values, want.values) <= 1e-6


# --------------------------------------------------------------------------
# sky/earth, sky/atmosphere, sky/bake
# --------------------------------------------------------------------------


def test_earth_and_sun_directions_match_jax():
    """The shell exit distance of seeded view rays, the reference's quirky
    initial sun direction, the clean one and the Atmosphere's light and
    polar update. Measured at most 3.6e-7 (relative); hits exact."""
    d = _unit_dirs(400, 6)
    o = np.tile([[0, 0, 6370.0]], (400, 1)).astype(np.float32)
    jt, jh = jearth.EarthCoords().shell_exit_distance(jnp.asarray(o),
                                                      jnp.asarray(d))
    tt, th = tearth.EarthCoords().shell_exit_distance(_t(o), _t(d))
    assert np.array_equal(np.asarray(jh), th.numpy())
    assert _rel(tt, jt) <= 1e-6
    assert _rel(tatm.reference_sun_direction(device=CPU),
                jatm.reference_sun_direction()) <= 1e-6
    assert _rel(tatm.sun_direction(0.7, 0.4, device=CPU),
                jatm.sun_direction(0.7, 0.4)) <= 1e-6
    sun = np.array(SUN, np.float32)
    jl, tl = jatm.Atmosphere().light(jnp.asarray(sun)), \
        tatm.Atmosphere().light(_t(sun))
    assert _rel(tl.irradiance(_t(d))[1], jl.irradiance(jnp.asarray(d))[1]) \
        <= 1e-6
    s = np.array([1.0, 0.3, 0.9], np.float32)
    for want, got in zip(jatm.Atmosphere().update_position(jnp.asarray(s),
                                                           10.0),
                         tatm.Atmosphere().update_position(_t(s), 10.0)):
        assert _rel(got, want) <= 1e-6
    assert _rel(tatm.Atmosphere().spd(device=CPU).values,
                jatm.Atmosphere().spd().values) <= 1e-6


def test_scatter_rgb_and_fisheye_bakes_match_jax():
    """scatter_rgb on seeded directions over the whole sphere (the lower
    hemisphere black): measured 6.7e-8 relative to the largest radiance.

    The fisheye bakes (texel_directions -> scatter_rgb) are held in two
    halves. Their directions come from atan2, arccos, sin and cos, whose
    float32 results differ by an ulp between XLA and torch (measured 2.4e-7
    absolute); and the reference's radiance jumps with one ulp of a
    direction at texels whose last view sample sits on the shell (a
    6e-8 move of a direction changes a texel by 1.1e-3 of itself). So:
    the directions within 1e-6 of JAX's, and compute_atmosphere (8 x 8,
    chunked) and compute_region equal to JAX's scatter_rgb on the port's
    own directions within 2e-6."""
    d = _unit_dirs(256, 7)
    sun = np.array(SUN, np.float32) / np.linalg.norm(SUN)
    want = np.asarray(jatm.scatter_rgb(jnp.asarray(d), jnp.asarray(sun)))
    got = tatm.scatter_rgb(_t(d), _t(sun))
    assert _rel(got, want) <= 1e-6
    assert np.array_equal(want[d[:, 2] < 0], np.zeros_like(want[d[:, 2] < 0]))
    dirs = tatm.texel_directions(8, 6, device=CPU)
    assert np.abs(dirs.numpy() - np.asarray(jatm.texel_directions(8, 6))) \
        .max() <= 1e-6

    def jax_sky(dirs_t):
        return jatm.scatter_rgb(jnp.asarray(dirs_t.numpy()),
                                jnp.asarray(sun))

    atm = tatm.compute_atmosphere(_t(sun), 8, 8, chunk=20)
    assert atm.shape == (8, 8, 3) and float(atm.max()) > 0
    assert _rel(atm, jax_sky(tatm.texel_directions(8, 8, device=CPU))) \
        <= 2e-6
    x = torch.arange(4, 8, dtype=torch.float32)
    y = torch.arange(0, 4, dtype=torch.float32)
    region = tatm.compute_region(_t(sun), 8, 8, 4, 0, 4, 4)
    assert _rel(region, jax_sky(tatm._fisheye_directions(x, y, 8, 8))) \
        <= 2e-6


def test_scatter_rgb_gradient_to_the_sun_matches_jax():
    """d sum(scatter_rgb) / d sun_dir over seeded upper-hemisphere
    directions, torch.autograd against jax.grad. Measured 1.2e-4
    (relative: the light paths' exp and pow round differently, and the
    sum over 64 texels of 625 samples each carries it)."""
    d = _unit_dirs(64, 8)
    d[:, 2] = np.abs(d[:, 2])
    sun = np.array(SUN, np.float32) / np.linalg.norm(SUN)
    want = jax.grad(lambda s: jnp.sum(jatm.scatter_rgb(jnp.asarray(d), s)))(
        jnp.asarray(sun))
    s = _t(sun).requires_grad_()
    (got,) = torch.autograd.grad(tatm.scatter_rgb(_t(d), s).sum(), s)
    assert np.isfinite(got.numpy()).all()
    assert _rel(got, want) <= 1e-3


def test_bake_sky_cubemap_and_tone_map_match_jax():
    """bake_sky_cubemap((0.3, 0.8, 0.5), size=8) and the tone curve on
    both of its branches. Measured at most 1.2e-7 (relative to the
    largest value)."""
    want = np.asarray(jbake.bake_sky_cubemap(SUN, size=8))
    got = tbake.bake_sky_cubemap(SUN, size=8, device=CPU)
    assert got.shape == (6, 8, 8, 3) and bool(torch.isfinite(got).all())
    assert float(got.max()) > 1.31           # both tone-curve branches
    assert _rel(got, want) <= 1e-6
    assert _rel(tbake.tone_map(got), jbake.tone_map(jnp.asarray(want))) \
        <= 1e-6


def test_create_env_box_and_texture_write_their_bakes(tmp_path):
    """create_env_box (16 x 16, tone-mapped) and create_texture into
    tmp_path: six faces, each compute_region of its quadrant (the last two
    the center) bit for bit, each written as its tone-mapped 8-bit image;
    the fisheye texture likewise. Against the JAX package's files (the
    fisheye directions differ by an ulp, see above): the same shapes, and
    measured 1 of the 6 x 64 face pixels more than one level apart (bound
    24)."""
    import imageio.v2 as imageio

    sun = np.array(SUN, np.float32)
    tfaces = tbake.create_env_box(sun, 16, 16, True,
                                  prefix=str(tmp_path / "T_"), device=CPU)
    jbake.create_env_box(jnp.asarray(sun), 16, 16, True,
                         prefix=str(tmp_path / "J_"))
    corners = [(0, 0), (8, 0), (8, 8), (0, 8), (4, 4), (4, 4)]
    far = 0
    for i, ((xc, yc), face) in enumerate(zip(corners, tfaces)):
        assert torch.equal(face, tatm.compute_region(_t(sun), 16, 16, xc,
                                                     yc, 8, 8))
        img = imageio.imread(tmp_path / f"T_{i}.png").astype(int)
        want = (np.clip(tbake.tone_map(face).numpy(), 0, 1) * 255).astype(
            np.uint8)
        assert np.array_equal(img, want)
        jimg = imageio.imread(tmp_path / f"J_{i}.png").astype(int)
        assert jimg.shape == img.shape == (8, 8, 3)
        far += int((np.abs(img - jimg).max(-1) > 1).sum())
    assert far <= 24
    tt = tbake.create_texture(sun, 8, 8, False, str(tmp_path / "t.png"),
                              device=CPU)
    assert torch.equal(tt, tatm.compute_atmosphere(_t(sun), 8, 8))
    img = imageio.imread(tmp_path / "t.png")
    assert np.array_equal(img, (np.clip(tt.numpy(), 0, 1) * 255).astype(
        np.uint8))
