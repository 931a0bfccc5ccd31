"""Spectral power distributions, CIE XYZ color matching, solar SPD.

Counterpart of dieselfluid_tpu/render/spectrum.py (ref: render/light/
spectrum.go + sunlight.go). Spectra are (..., S) float32 tensors sampled
uniformly over [380, 625] nm (SP_VIOLET..SP_RED, spectrum.go:17-18). The CIE
x/y/z color-matching curves are the multi-lobe Gaussian analytic fit of
Wyman, Sloan & Shirley (JCGT 2013), as in the JAX package: no tables are
read, and the curves are differentiable in wavelength.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

SP_VIOLET = 380.0
SP_RED = 625.0
WATTS = 0
LUMENS = 1

# Burr solar SPD constants (ref: sunlight.go:6-11)
SPD_B = 9.6
SPD_C = 3.1
SPD_K = 1.68
SPD_G = 0.45

_XYZ_TO_RGB = ((3.240479, -1.537150, -0.498535),
               (-0.969256, 1.875991, 0.041556),
               (0.055648, -0.204043, 1.057311))
_RGB_TO_XYZ = ((0.412453, 0.357580, 0.180423),
               (0.212671, 0.715160, 0.072169),
               (0.019334, 0.119193, 0.950227))


def wavelengths(samples: int, *, device) -> torch.Tensor:
    """Uniform sample wavelengths. ref: spectrum.go Wavelength:96-99."""
    i = torch.arange(samples, dtype=torch.float32, device=device)
    return SP_VIOLET + (SP_RED - SP_VIOLET) / samples * i


def _gauss(x, alpha, mu, s1, s2):
    s = torch.where(x < mu, s1, s2)
    t = (x - mu) / s
    return alpha * torch.exp(-0.5 * t * t)


def cie_x(lam):
    """CIE 1931 x-bar analytic fit (Wyman-Sloan-Shirley 2013, eq. 1)."""
    return (_gauss(lam, 1.056, 599.8, 37.9, 31.0)
            + _gauss(lam, 0.362, 442.0, 16.0, 26.7)
            + _gauss(lam, -0.065, 501.1, 20.4, 26.2))


def cie_y(lam):
    return (_gauss(lam, 0.821, 568.8, 46.9, 40.5)
            + _gauss(lam, 0.286, 530.9, 16.3, 31.1))


def cie_z(lam):
    return (_gauss(lam, 1.217, 437.0, 11.8, 36.0)
            + _gauss(lam, 0.681, 459.0, 26.0, 13.8))


class SampledSpectrum(NamedTuple):
    """An SPD with its wavelength grid. ref: spectrum.go
    SampledSpectrum:56-64."""

    values: torch.Tensor     # (..., S)
    lam: torch.Tensor        # (S,)
    units: int = WATTS

    @staticmethod
    def constant(samples: int, total_power: float = 1.0, units: int = WATTS,
                 *, device) -> "SampledSpectrum":
        """Flat SPD splitting total_power evenly. ref: spectrum.go
        InitSpectrum."""
        lam = wavelengths(samples, device=device)
        return SampledSpectrum(
            torch.full((samples,), total_power / samples,
                       dtype=torch.float32, device=device), lam, units)

    @property
    def samples(self) -> int:
        return self.values.shape[-1]

    def is_black(self) -> torch.Tensor:
        return torch.all(self.values == 0.0, dim=-1)

    # Arithmetic (ref: spectrum.go Add/Mul/Div/Sub/Neg/Sqrt/Lerp/Pow/Clamp)
    def add(self, o): return self._replace(values=self.values + o.values)
    def sub(self, o): return self._replace(values=self.values - o.values)
    def mul(self, o): return self._replace(values=self.values * o.values)
    def div(self, o): return self._replace(values=self.values / o.values)
    def neg(self): return self._replace(values=-self.values)
    def sqrt(self): return self._replace(values=torch.sqrt(self.values))
    def pow(self, k): return self._replace(values=torch.pow(self.values, k))
    def scale(self, k): return self._replace(values=self.values * k)

    def lerp(self, o, t):
        return self._replace(values=self.values * (1 - t) + o.values * t)

    def clamp(self, lo, hi):
        return self._replace(values=torch.clamp(self.values, lo, hi))

    def to_xyz(self) -> torch.Tensor:
        """Riemann-sum projection onto CIE XYZ normalized by the Y integral.
        ref: spectrum.go ToXYZ:288-302 (sum over samples, / yint)."""
        x, y, z = cie_x(self.lam), cie_y(self.lam), cie_z(self.lam)
        yint = torch.sum(y)
        return torch.stack([
            torch.sum(x * self.values, dim=-1) / yint,
            torch.sum(y * self.values, dim=-1) / yint,
            torch.sum(z * self.values, dim=-1) / yint,
        ], dim=-1)

    def luminance(self) -> torch.Tensor:
        """Y channel only. ref: spectrum.go YY:304-310."""
        y = cie_y(self.lam)
        return torch.sum(y * self.values, dim=-1) / torch.sum(y)

    def to_rgb(self) -> torch.Tensor:
        return xyz_to_rgb(self.to_xyz())


def resample_average_1d(domain: torch.Tensor, values: torch.Tensor,
                        g0: torch.Tensor, g1: torch.Tensor) -> torch.Tensor:
    """Window-averaged resampling of a tabulated piecewise-linear function
    (ref: sampler/sampler_utilities.go:52 SampleAverage1D): the average of
    the tabulated curve over each window [g0, g1], with constant extension
    outside the knot range and the reference's midpoint rule per interior
    segment. Every window at once, by broadcasting segment/window overlaps.

    domain: (n,) sorted knots; values: (n,); g0/g1: (...,) window edges.
    """
    x0, x1 = domain[:-1], domain[1:]
    vmid = 0.5 * (values[:-1] + values[1:])
    g0b, g1b = g0[..., None], g1[..., None]
    overlap = torch.clamp(torch.minimum(g1b, x1) - torch.maximum(g0b, x0),
                          min=0.0)
    seg = torch.sum(vmid * overlap, dim=-1)
    left = values[0] * torch.clamp(torch.minimum(g1, domain[0]) - g0,
                                   min=0.0)
    right = values[-1] * torch.clamp(g1 - torch.maximum(g0, domain[-1]),
                                     min=0.0)
    return (seg + left + right) / (g1 - g0)


def spectrum_from_tabulated(domain, values, samples: int,
                            units: int = WATTS, *,
                            device) -> SampledSpectrum:
    """SampledSpectrum from tabulated (wavelength, value) data, bin-averaged
    onto the uniform sample grid (ref: spectrum.go FromSampled:241-260)."""
    edges = SP_VIOLET + (SP_RED - SP_VIOLET) / samples * torch.arange(
        samples + 1, dtype=torch.float32, device=device)
    vals = resample_average_1d(
        torch.as_tensor(domain, dtype=torch.float32, device=device),
        torch.as_tensor(values, dtype=torch.float32, device=device),
        edges[:-1], edges[1:])
    return SampledSpectrum(vals, wavelengths(samples, device=device), units)


def _mat_apply(m, v: torch.Tensor) -> torch.Tensor:
    mat = torch.tensor(m, dtype=torch.float32, device=v.device)
    return torch.einsum("ij,...j->...i", mat, v)


def xyz_to_rgb(xyz: torch.Tensor) -> torch.Tensor:
    """CIE XYZ -> linear sRGB. ref: spectrum.go XYZToRGB:317-323."""
    return _mat_apply(_XYZ_TO_RGB, xyz)


def rgb_to_xyz(rgb: torch.Tensor) -> torch.Tensor:
    """ref: spectrum.go RGBToXYZ:325-331."""
    return _mat_apply(_RGB_TO_XYZ, rgb)


def sunlight_spd(lam: torch.Tensor) -> torch.Tensor:
    """Burr-distribution solar SPD. ref: sunlight.go SunlightSpectrum:14-17."""
    x = lam / 100.0
    g = torch.pow(SPD_G * x, SPD_C - 1.0)
    return SPD_B * SPD_B * SPD_C * SPD_K * g / torch.pow(SPD_B + g,
                                                         SPD_K + 1.0)


def sunlight_spd_attenuated(lam: torch.Tensor, k_atten) -> torch.Tensor:
    """ref: sunlight.go SunlightSpectrumAttenuate:20-23."""
    x = lam / 100.0
    g = torch.pow(SPD_G * x, SPD_C - 1.0)
    return (SPD_B * SPD_B * SPD_C * SPD_K * k_atten * g
            / torch.pow(SPD_B + g, SPD_K * k_atten + 1.0))


def init_sunlight(samples: int = 20, k_atten: float = 1.086, *,
                  device) -> SampledSpectrum:
    """Solar SPD over the visible band. ref: sunlight.go InitSunlight:26-42."""
    lam = wavelengths(samples, device=device)
    return SampledSpectrum(sunlight_spd_attenuated(lam, k_atten), lam, WATTS)
