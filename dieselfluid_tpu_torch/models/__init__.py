"""Particle state, the SPH field operators and the simulation facade."""

from dieselfluid_tpu_torch.models.particles import (  # noqa: F401
    FluidState,
    init_lattice_state,
)
