"""The fixed-degree neighborhood every neighbor provider produces.

Counterpart of dieselfluid_tpu/neighbors/types.py: an (N, K) index table
plus a validity mask, the static-shape form of the reference's variable
sample lists.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Neighborhood(NamedTuple):
    """Fixed-degree neighbor lists for N query particles.

    idx:  (N, K) int64, indices into the source positions. Invalid slots
          hold an in-range index (0) and are masked out downstream.
    mask: (N, K) float32 {0, 1}, 1 where the slot holds a real neighbor
          (within the kernel radius, not the query particle itself).
    """

    idx: torch.Tensor
    mask: torch.Tensor

    @property
    def k(self) -> int:
        return self.idx.shape[-1]

    def gather(self, values: torch.Tensor) -> torch.Tensor:
        """Per-source values gathered to (N, K, ...) slots."""
        return values[self.idx]
