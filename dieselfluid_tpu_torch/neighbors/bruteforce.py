"""Brute-force O(N^2) neighbor search: the exact oracle.

Counterpart of dieselfluid_tpu/neighbors/bruteforce.py. The (N, M) distance
matrix comes from direct differences (no expanded |q|^2 + |s|^2 - 2 q.s
form: its cancellation costs ~1e-1 near r ~ h), with the correctly rounded
root on every device (`mathx.polar.sqrt_cr`), so the r = h pairs of a
lattice fall on the same side of the radius test as in the JAX package.
The ranking is a stable ascending sort, which keeps the lower source index
first among equal distances, as `jax.lax.top_k` does; the tables carry no
gradient (built under `torch.no_grad()`).
"""

from __future__ import annotations

import torch

from dieselfluid_tpu_torch.mathx.polar import sqrt_cr
from dieselfluid_tpu_torch.neighbors.types import Neighborhood


def pairwise_distances(query: torch.Tensor,
                       source: torch.Tensor) -> torch.Tensor:
    """(N, M) Euclidean distances from direct component differences."""
    d2 = torch.zeros((query.shape[0], source.shape[0]), dtype=torch.float32,
                     device=query.device)
    for c in range(3):
        diff = query[:, c][:, None] - source[:, c][None, :]
        d2 = d2 + diff * diff
    return sqrt_cr(d2)


def rank_smallest(ranked: torch.Tensor, k: int):
    """(values, columns) of the k smallest entries of each row, ascending,
    the lower column first among ties (a stable sort): the order
    `jax.lax.top_k(-ranked, k)` gives."""
    vals, cols = torch.sort(ranked, dim=1, stable=True)
    return vals[:, :k], cols[:, :k]


@torch.no_grad()
def brute_force_neighborhood(query: torch.Tensor, source: torch.Tensor,
                             h: float, k: int, exclude_self: bool = True,
                             self_offset=None) -> Neighborhood:
    """The k nearest in-radius source particles of each query particle; the
    mask zeroes slots beyond the in-radius count. With k >= the largest
    true neighbor count this is exact.

    When `query` is a contiguous shard of `source`, `self_offset` is the
    source row of query[0]: the pairs (i, self_offset + i) are excluded."""
    query, source = query.detach(), source.detach()
    n, m = query.shape[0], source.shape[0]
    d = pairwise_distances(query, source)
    in_radius = d < h
    if self_offset is not None:
        rows = torch.arange(n, device=d.device)[:, None]
        cols = torch.arange(m, device=d.device)[None, :]
        in_radius &= cols != rows + self_offset
    elif exclude_self and query.shape == source.shape:
        in_radius &= ~torch.eye(n, m, dtype=torch.bool, device=d.device)
    ranked = torch.where(in_radius, d, torch.inf)
    del d, in_radius
    vals, idx = rank_smallest(ranked, k)
    valid = torch.isfinite(vals)
    return Neighborhood(idx=torch.where(valid, idx, 0),
                        mask=valid.to(torch.float32))
