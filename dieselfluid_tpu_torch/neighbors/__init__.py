"""Neighbor search: fixed-degree neighborhoods from brute force, cell grids
or LSH, and rest-density calibration."""

from dieselfluid_tpu_torch.neighbors.types import Neighborhood  # noqa: F401
from dieselfluid_tpu_torch.neighbors.bruteforce import (  # noqa: F401
    brute_force_neighborhood)
