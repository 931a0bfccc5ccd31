"""The fixed-degree neighborhood every neighbor provider produces.

Counterpart of dieselfluid_tpu/neighbors/types.py: an (N, K) index table
plus a validity mask, the static-shape form of the reference's variable
sample lists.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dieselfluid_tpu_torch.ops.cellops import spread_masked


class Neighborhood(NamedTuple):
    """Fixed-degree neighbor lists for N query particles.

    idx:  (N, K) int64, indices into the source positions. Invalid slots
          hold an in-range index (0, as the builders give them) and are
          masked out downstream.
    mask: (N, K) float32 {0, 1}, 1 where the slot holds a real neighbor
          (within the kernel radius, not the query particle itself).

    A raw table handed to the field operators gives the right values and
    gradients, but its gradients are slow on the card: the backward of
    every gather `x[idx]` adds each masked slot's zero to row 0, and the
    card walks the adds to one row serially. The steps take `spread`
    tables, made once where they get a table.
    """

    idx: torch.Tensor
    mask: torch.Tensor

    @property
    def k(self) -> int:
        return self.idx.shape[-1]

    def spread(self, n_source: int) -> "Neighborhood":
        """The same table with each masked slot's index replaced by its
        own flat position modulo `n_source` (`cellops.spread_masked`): at
        most ceil(N K / n_source) masked slots read one source row. Every
        field operator multiplies a slot's term by the mask, so the row a
        masked slot reads changes no value, and its zero cotangent lands
        alone. The mask is unchanged."""
        idx = spread_masked(self.idx.reshape(-1), self.mask.reshape(-1) > 0,
                            n_source)
        return self._replace(idx=idx.view(self.idx.shape))

    def gather(self, values: torch.Tensor) -> torch.Tensor:
        """Per-source values gathered to (N, K, ...) slots."""
        return values[self.idx]
