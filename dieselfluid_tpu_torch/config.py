"""Configuration dataclasses of the simulator, the port's own copy.

Field for field, default for default and method for method the JAX package's
`FluidParams` and `SimConfig` (dieselfluid_tpu/config.py), kept here so that
the port imports nothing of the JAX package. `interop.fluid_params_from` and
`interop.sim_config_from` convert any object with the same fields. All fields
are static Python values: traced material parameters are
`models.materials.Materials`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

# Water model constants (ref: model/model.go:40-45)
FLUID_MASS = 0.1
FLUID_DENSITY = 87.0
FLUID_STIFF = 6.1
FLUID_KERN_RAD = 0.2
FLUID_SOS = 1480.0

# Tait EOS constants (ref: model/model.go TaitEos — g=7.16, w=2.15)
TAIT_GAMMA = 7.16
TAIT_W = 2.15

# Viscosity + NN cache constants (ref: model/sph/fluid.go:18-20)
VISCOSITY_WATER = 1.3059
CACHE_L = 0.8

GRAVITY = -9.81


@dataclasses.dataclass(frozen=True)
class FluidParams:
    """Physical + numerical parameters of one SPH fluid: h the kernel
    support radius, mass the per-particle mass, d0 the rest density, mu the
    dynamic viscosity, dt the fixed timestep (ref: model/sph/fluid.go:41-88,
    :111-114)."""

    h: float = 1.0
    mass: float = 1.0
    d0: float = 512.0
    mu: float = VISCOSITY_WATER
    dt: float = 0.01
    gravity: Tuple[float, float, float] = (0.0, GRAVITY, 0.0)
    # Tait EOS
    tait_gamma: float = TAIT_GAMMA
    tait_w: float = TAIT_W
    p0: float = 0.0
    # PCISPH policy (ref: solver/pcisph/pcisph_darwin.go:49-50)
    pci_max_iters: int = 5
    pci_max_density_error_ratio: float = 0.01

    def replace(self, **kw) -> "FluidParams":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def reference_lattice(n3: int, scale: float = 1.0) -> "FluidParams":
        """The reference's parameters for an n3**3 lattice in a [-1,1]^3 box
        (ref: model/sph/fluid.go:48-63): h=1, mass=1, d0 = N / volume.
        Parity parameters: with h=1 every particle neighbours thousands of
        others; physical runs use `for_spacing`."""
        num = n3 ** 3
        volume = (2.0 * scale) ** 3
        return FluidParams(h=1.0, mass=1.0, d0=float(num) / volume)

    @staticmethod
    def for_spacing(dx: float, h_factor: float = 2.0, mass: float = 1.0,
                    sound_speed: float = 25.0, mu: float = 0.05
                    ) -> "FluidParams":
        """Physically sane parameters for a lattice of spacing dx: h =
        h_factor*dx (~33 neighbours at 2), Tait stiffness w = d0*c^2 so that
        dp/drho at d0 is c^2, and the acoustic CFL dt = 0.25 h / c."""
        h = h_factor * dx
        d0 = mass / dx ** 3
        return FluidParams(
            h=h, mass=mass, d0=d0, mu=mu,
            tait_w=d0 * sound_speed ** 2,
            dt=0.25 * h / sound_speed,
        )


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Top-level simulation configuration (solver choice, sizes, neighbor
    policy)."""

    n3: int = 16                      # cube root of the particle count
    solver: str = "wcsph"             # "wcsph" | "pcisph"
    neighbors: str = "cellgrid"       # "bruteforce" | "cellgrid" | "dense"
    max_neighbors: int = 128          # fixed neighbor-list degree
    cell_capacity: int = 32           # particles per cell in the cell table
    steps_per_frame: int = 1
    seed: int = 0
    warm_start: bool = False          # PCISPH: carry pressure across frames
    column_skip: bool = False         # dense PCISPH: skip converged regions

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "SimConfig":
        return SimConfig(**json.loads(s))
