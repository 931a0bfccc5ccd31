"""Rayleigh + Mie single-scattering sky, vectorized and differentiable.

Counterpart of dieselfluid_tpu/sky/atmosphere.py (ref: atmosphere/
atmosphere.go VolumetricScatterRay:243-357): 25 view-path samples x 25
light-path samples with exponential Ease spacing, beta_R/beta_M extinction,
Rayleigh + Henyey-Greenstein-like Mie phase (g = 0.76), sun-z asymptotic
scaling, and the reference's cumulative optical depth (tau at view sample i
uses the depth accumulated through i: a prefix sum).

The per-texel Go loop is one tensor program over (texel, VIEW, LIGHT)
sample axes, in float32 and in the JAX package's order of operations (the
shell radii make the light rays' intersection cancel heavily, so the
rounding is kept, not promoted to float64). Plain torch on any device: this
path has no Pallas kernel in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from dieselfluid_tpu_torch.mathx import polar as P
from dieselfluid_tpu_torch.render.light import Directional, Source
from dieselfluid_tpu_torch.render.spectrum import init_sunlight
from dieselfluid_tpu_torch.sky.earth import HM, HR, PI_REF, EarthCoords

RAYLEIGH_SAMPLES = 25      # ref: atmosphere.go:28
LIGHT_PATH_SAMPLES = 25    # ref: atmosphere.go:29
AU = 150000000.0
DEG2RAD = 0.01745329251994444444

BETA_R = (0.0000058, 0.0000135, 0.0000331)  # ref: atmosphere.go:267
BETA_M = (0.00210, 0.0021, 0.0021)          # ref: atmosphere.go:268


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _safe_norm(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Norm with the where-trick: grad-safe at exactly-zero vectors (the last
    view sample sits on the shell, making its light ray zero)."""
    d2 = torch.sum(v * v, dim=-1)
    ok = d2 > eps
    return torch.where(ok, P.sqrt_rn(torch.where(ok, d2, 1.0)), 0.0)


def ease(x: torch.Tensor, w: float = 1.0) -> torch.Tensor:
    """Exponential ease exp(w x - w) on [0, 1]. ref: sampler_utilities.go
    Ease:27-30 (jnp.clip's value and gradient: half at a bound)."""
    x = torch.minimum(torch.maximum(x, x.new_tensor(0.0)), x.new_tensor(1.0))
    return torch.exp(w * x - w)


def reference_sun_direction(abs_day: float = 1.5,
                            inclination_offset: float = 45.0 * DEG2RAD, *,
                            device) -> torch.Tensor:
    """Initial sun direction, reference semantics preserved.

    ref: atmosphere.go InitPosition:70-80: `theta := (1 / 2 * PI) * absDay`
    uses Go untyped-integer division, so theta == 0 for every absDay; the
    "position" is Vec2Sphere of the literal VECTOR (1, theta, pi - offset),
    treated as cartesian, then converted back. Quirk for quirk.
    """
    theta = 0.0 * abs_day
    vec = _f32([1.0, theta, PI_REF - inclination_offset], device)
    d = P.sphere_to_vec(P.vec_to_sphere(vec))
    return d / torch.linalg.vector_norm(d)


def sun_direction(azimuth: float, elevation: float, *,
                  device) -> torch.Tensor:
    """Clean z-up sun direction (beside the parity one)."""
    az, el = _f32(azimuth, device), _f32(elevation, device)
    return torch.stack([torch.cos(el) * torch.cos(az),
                        torch.cos(el) * torch.sin(az), torch.sin(el)])


@dataclasses.dataclass(frozen=True)
class Atmosphere:
    """Sky environment. ref: atmosphere.go Atmosphere:49-56."""

    earth: EarthCoords = EarthCoords()
    flux: float = 20.5                       # ref: NewAtmosphere light flux
    light_rgb: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    spd_samples: int = 20                    # ref: InitSunlight(20)

    def light(self, sun_dir: torch.Tensor) -> Directional:
        dev = sun_dir.device
        return Directional(torch.zeros(3, dtype=torch.float32, device=dev),
                           -sun_dir, Source.make(self.light_rgb, self.flux,
                                                 device=dev))

    def spd(self, *, device):
        return init_sunlight(self.spd_samples, device=device)

    def update_position(self, sun_sphere: torch.Tensor, delta_deg: float):
        """Rotate the sun's polar angle. ref: atmosphere.go
        UpdatePosition:82-92."""
        sph = P.add_polar(sun_sphere, delta_deg, degrees=True)
        d = P.sphere_to_vec(sph)
        return sph, d / torch.linalg.vector_norm(d)


def scatter_rgb(sample_dirs: torch.Tensor, sun_dir: torch.Tensor,
                earth: EarthCoords = EarthCoords(), flux: float = 20.5,
                light_rgb=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """RGB sky radiance for (..., 3) unit view directions (z-up hemisphere),
    on their device. Directions with z < 0 return black, as does a sun
    whose light path misses the shell. ref: VolumetricScatterRay:243-357."""
    shape = sample_dirs.shape[:-1]
    dev = sample_dirs.device
    d = sample_dirs.reshape(-1, 3)
    sun_dir = sun_dir.to(dev)
    beta_r = _f32(BETA_R, dev)
    beta_m = _f32(BETA_M, dev)

    origin = earth.position(device=dev)
    t_exit, hit = earth.shell_exit_distance(
        torch.broadcast_to(origin, d.shape), d)
    view_ray = d * t_exit[:, None]                            # (N, 3)
    view_mag = _safe_norm(view_ray)

    # Phase functions (ref:272-277)
    mu = torch.sum(d * sun_dir, dim=-1)
    phase_r = 3.0 / (16.0 * PI_REF) * (1.0 + mu * mu)
    g = 0.76
    hg = torch.maximum(1.0 + g * g - 2.0 * g * mu, mu.new_tensor(1e-6))
    phase_m = (3.0 / (8.0 * PI_REF) * ((1.0 - g * g) * (1.0 + mu * mu))
               / ((2.0 + g * g) * torch.pow(hg, 1.1)))

    # Sun-z asymptotic scaling (ref:283-293)
    scale_factor = 7.0
    sz = sun_dir[2]
    lfactor = torch.where(
        sz > 0, torch.minimum(1.0 / torch.maximum(torch.abs(sz),
                                                  sz.new_tensor(1e-6)),
                              sz.new_tensor(scale_factor)),
        sz.new_tensor(scale_factor))

    # View-path samples i = 1..S with Ease spacing (ref:296-303). The
    # reference feeds i * sampleStep (an absolute km distance) into Ease,
    # which clamps its input to [0, 1]: for rays longer than S km the
    # spacing saturates; kept.
    i = torch.arange(1, RAYLEIGH_SAMPLES + 1, dtype=torch.float32,
                     device=dev)
    sample_step = view_mag[:, None] / RAYLEIGH_SAMPLES        # (N, 1)
    sample_scale = ease(i[None, :] * sample_step)             # (N, S)
    view_samples = view_ray[:, None, :] * sample_scale[..., None]
    depth = view_samples[..., 2]                              # GetSampleDepth

    vmag = view_mag[:, None] * sample_scale
    vds = torch.diff(vmag, dim=1, prepend=torch.zeros_like(vmag[:, :1]))
    hr = torch.exp(-depth / HR) * vds                         # (N, S)
    hm = torch.exp(-depth / HM) * vds
    od_r = torch.cumsum(hr, dim=1)                            # running depth
    od_m = torch.cumsum(hm, dim=1)

    # Light paths from each view sample (ref:305-345). The reference scales
    # viRay = viewSampleOrigin - sunDir by the min-|t| intersection of
    # ray(-sunDir) from viewSampleOrigin with the shell.
    vso = view_samples + origin                               # (N, S, 3)
    lt1, lt2, lhit = P.ray_sphere_intersect(
        -sun_dir, vso, torch.zeros(3, dtype=torch.float32, device=dev),
        earth.shell_radius)
    lts = torch.stack([lt1, lt2], dim=-1)
    lpri = P.priority(lts, torch.stack([lhit, lhit], dim=-1))  # (N, S)
    vi_ray = vso - sun_dir                                    # ref viRay
    light_ray = vi_ray * lpri[..., None]
    light_mag = _safe_norm(light_ray)                         # (N, S)

    j = torch.arange(LIGHT_PATH_SAMPLES, dtype=torch.float32, device=dev)
    lstep = light_mag[..., None] / LIGHT_PATH_SAMPLES         # (N, S, 1)
    pscale = ease(lstep * j)                                  # (N, S, L)
    lmag = light_mag[..., None] * pscale
    lds = torch.diff(lmag, dim=-1, prepend=torch.zeros_like(lmag[..., :1]))
    # Only the z of each light sample is read (its depth).
    ldepth = view_samples[..., None, 2] + light_ray[..., None, 2] * pscale
    od_lr = torch.sum(torch.exp(-ldepth / HR) * lds, dim=-1)  # (N, S)
    od_lm = torch.sum(torch.exp(-ldepth / HM) * lds, dim=-1)

    # Attenuation + accumulation (ref:347-352)
    tau = (beta_r[None, None, :] * (lfactor * (od_r + od_lr))[..., None]
           + (beta_m * 1.25)[None, None, :] * (od_m + od_lm)[..., None])
    atten = torch.exp(-tau)                                   # (N, S, 3)
    sum_r = torch.sum(atten * hr[..., None], dim=1)           # (N, 3)
    sum_m = torch.sum(atten * hm[..., None], dim=1)

    rgb = (sum_r * beta_r * phase_r[:, None]
           + sum_m * beta_m * phase_m[:, None]) * flux * _f32(light_rgb, dev)
    keep = ((d[:, 2] >= 0.0)[:, None] & hit[:, None]
            & torch.all(torch.isfinite(rgb), dim=-1, keepdim=True))
    rgb = torch.where(keep, rgb, 0.0)
    return rgb.reshape(*shape, 3)


def _fisheye_directions(x: torch.Tensor, y: torch.Tensor, u_domain: int,
                        v_domain: int) -> torch.Tensor:
    u = 2.0 * (x + 0.5) / (u_domain - 1.0) - 1.0
    v = 2.0 * (y + 0.5) / (v_domain - 1.0) - 1.0
    uu, vv = torch.meshgrid(u, v, indexing="ij")              # x outer
    z2 = uu * uu + vv * vv
    phi = torch.atan2(vv, uu)
    c = 1.0 - z2
    theta = torch.arccos(torch.minimum(torch.maximum(c, c.new_tensor(-1.0)),
                                       c.new_tensor(1.0)))
    return torch.stack([torch.sin(theta) * torch.cos(phi),
                        torch.sin(theta) * torch.sin(phi),
                        torch.cos(theta)], dim=-1)


def texel_directions(width: int, height: int, *, device) -> torch.Tensor:
    """Fisheye texel -> hemisphere direction map (W, H, 3). ref:
    ComputeAtmosphere:197-217."""
    x = torch.arange(width, dtype=torch.float32, device=device)
    y = torch.arange(height, dtype=torch.float32, device=device)
    return _fisheye_directions(x, y, width, height)


def compute_atmosphere(sun_dir: torch.Tensor, width: int = 512,
                       height: int = 512, chunk: int = 65536,
                       flux: float = 20.5) -> torch.Tensor:
    """Bake the full-sky fisheye texture (W, H, 3) on sun_dir's device.
    ref: ComputeAtmosphere:197-217. Texels are marched `chunk` at a time to
    bound the (chunk, 25, 25) intermediates (each texel is independent, so
    the chunk changes no value)."""
    dirs = texel_directions(width, height,
                            device=sun_dir.device).reshape(-1, 3)
    rgb = torch.cat([scatter_rgb(dirs[s:s + chunk], sun_dir, flux=flux)
                     for s in range(0, dirs.shape[0], chunk)])
    return rgb.reshape(width, height, 3)


def compute_region(sun_dir: torch.Tensor, u_domain: int, v_domain: int,
                   x_corner: int, y_corner: int, width: int, height: int,
                   flux: float = 20.5) -> torch.Tensor:
    """Sub-region bake for env-box faces. ref: ComputeRegion:220-241."""
    dev = sun_dir.device
    x = torch.arange(x_corner, x_corner + width, dtype=torch.float32,
                     device=dev)
    y = torch.arange(y_corner, y_corner + height, dtype=torch.float32,
                     device=dev)
    return scatter_rgb(_fisheye_directions(x, y, u_domain, v_domain),
                       sun_dir, flux=flux)
