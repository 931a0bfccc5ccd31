"""Physically based atmosphere / sky environment light (counterpart of
dieselfluid_tpu/sky): Rayleigh + Mie single scattering with the solar SPD,
every texel's 25 x 25 scatter march one tensor expression."""

from dieselfluid_tpu_torch.sky.earth import EarthCoords  # noqa: F401,E402
from dieselfluid_tpu_torch.sky.atmosphere import Atmosphere  # noqa: F401,E402
