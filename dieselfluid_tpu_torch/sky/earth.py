"""Earth/atmosphere geometry for the sky model.

Counterpart of dieselfluid_tpu/sky/earth.py (ref: atmosphere/earth.go): an
observer on a z-up earth of radius 6370 (km), the atmosphere shell at
EARTH_RAD + HR, the sample "depth" approximated by the z-coordinate
(GetSampleDepth:59-62). The reference pairs km shell geometry with the
8000/1500 (meter-named) scale heights; the sky's look depends on that
pairing, so it is kept.
"""

from __future__ import annotations

import dataclasses

import torch

from dieselfluid_tpu_torch.mathx import polar as P

EARTH_RAD = 6370.0
HM = 1500.0     # aerosol (Mie) scale height (ref: atmosphere.go:31)
HR = 8000.0     # Rayleigh scale height (ref: atmosphere.go:32)
DEG2RAD = 0.01745329251994444444
PI_REF = 3.141529  # ref: atmosphere.go:26 (the reference's truncated pi)


@dataclasses.dataclass(frozen=True)
class EarthCoords:
    latitude: float = 65.0 * DEG2RAD
    longitude: float = 0.0

    @property
    def radius(self) -> float:
        return EARTH_RAD

    @property
    def shell_radius(self) -> float:
        """GreaterSphere radius. ref: earth.go NewEarth: EARTH_RAD + HR."""
        return EARTH_RAD + HR

    def position(self, *, device) -> torch.Tensor:
        """Observer position: Sphere2Vec((EARTH_RAD, 0, 0)) = (0, 0, R).
        ref: earth.go GetPosition: polar (r, az=0, incl=0) maps to +z."""
        return torch.tensor([0.0, 0.0, EARTH_RAD], dtype=torch.float32,
                            device=device)

    @staticmethod
    def sample_depth(sample: torch.Tensor) -> torch.Tensor:
        """Altitude approximation = z-coordinate. ref: earth.go
        GetSampleDepth."""
        return sample[..., 2]

    def shell_exit_distance(self, origins: torch.Tensor, dirs: torch.Tensor):
        """Min-|t| ray/shell intersection (the reference pairs
        RaySphereIntersect with polar.Priority). Returns (t, hit)."""
        t1, t2, hit = P.ray_sphere_intersect(
            dirs, origins, torch.zeros(3, dtype=torch.float32,
                                       device=dirs.device),
            self.shell_radius)
        ts = torch.stack([t1, t2], dim=-1)
        hits = torch.stack([hit, hit], dim=-1)
        return P.priority(ts, hits), hit
