"""Sorted cell-grid neighbor search.

Counterpart of dieselfluid_tpu/neighbors/cellgrid.py: hash particles to
cells of edge ~h, sort them by cell id, probe the 27-cell stencil and keep
the k nearest in-radius candidates. All shapes are static: cell capacity C
and degree K are config; a cell holding more than C particles drops the
overflow (`overflow_fraction` measures it).

Exactness against the JAX package: the cell sort is stable
(`torch.argsort(stable=True)`, as `jnp.argsort`), the candidate distances
take the correctly rounded root (`mathx.polar.sqrt_cr`) and the ranking is
a stable ascending sort, so the lower candidate slot comes first among
equal distances, as with `jax.lax.top_k`. Then `idx` and `mask` are JAX's,
slot for slot. The tables carry no gradient (`torch.no_grad()`); at 64k
particles and C = 32 each (N, 27 C) candidate plane is 221 MB (442 MB as
int64), freed before the ranking's output is formed.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from dieselfluid_tpu_torch.mathx.polar import sqrt_cr
from dieselfluid_tpu_torch.neighbors.bruteforce import rank_smallest
from dieselfluid_tpu_torch.neighbors.types import Neighborhood
from dieselfluid_tpu_torch.utils.profiling import count


@dataclasses.dataclass(frozen=True)
class CellGridSpec:
    """Static cell-grid configuration: domain bounds lo/hi, cell edge
    (>= the kernel radius h, so the 27-cell stencil covers the support) and
    the capacity of a cell."""

    lo: Tuple[float, float, float]
    hi: Tuple[float, float, float]
    cell: float
    capacity: int = 16

    @property
    def dims(self) -> Tuple[int, int, int]:
        lo = np.asarray(self.lo, np.float64)
        hi = np.asarray(self.hi, np.float64)
        return tuple(int(x) for x in
                     np.maximum(np.ceil((hi - lo) / self.cell), 1))

    @property
    def num_cells(self) -> int:
        nx, ny, nz = self.dims
        return nx * ny * nz

    @staticmethod
    def for_domain(lo, hi, h: float, capacity: int = 16) -> "CellGridSpec":
        return CellGridSpec(lo=tuple(lo), hi=tuple(hi), cell=float(h),
                            capacity=capacity)


def cell_coords(pos: torch.Tensor, spec: CellGridSpec) -> torch.Tensor:
    """(N, 3) int64 cell coordinates, clipped into the grid. The divisor is
    a device tensor: a CUDA divide by a Python number multiplies by its
    reciprocal, which is not the quotient the JAX package floors."""
    dev = pos.device
    count("host_sync.cellgrid.cell_coords")
    lo = torch.tensor(spec.lo, dtype=torch.float32, device=dev)
    count("host_sync.cellgrid.cell_coords")
    cell = torch.tensor(spec.cell, dtype=torch.float32, device=dev)
    ijk = torch.floor((pos - lo) / cell).to(torch.int32)
    count("host_sync.cellgrid.cell_coords")
    hi = torch.tensor(spec.dims, dtype=torch.int32, device=dev) - 1
    return torch.minimum(torch.clamp(ijk, min=0), hi).to(torch.int64)


def cell_id(pos: torch.Tensor, spec: CellGridSpec) -> torch.Tensor:
    """(N,) int64 linear cell ids (x-major, z fastest)."""
    _, ny, nz = spec.dims
    ijk = cell_coords(pos, spec)
    return (ijk[:, 0] * ny + ijk[:, 1]) * nz + ijk[:, 2]


def build_cell_table(pos: torch.Tensor, spec: CellGridSpec):
    """(order, starts): particle indices sorted by cell id (stable) and the
    (num_cells + 1,) prefix offsets of each cell into `order`."""
    cid = cell_id(pos, spec)
    order = torch.argsort(cid, stable=True)
    starts = torch.searchsorted(
        cid[order], torch.arange(spec.num_cells + 1, dtype=cid.dtype,
                                 device=cid.device))
    return order, starts


def overflow_fraction(pos: torch.Tensor, spec: CellGridSpec) -> torch.Tensor:
    """Fraction of particles beyond `capacity` in their cell (0-d float32;
    should be ~0)."""
    _, starts = build_cell_table(pos, spec)
    counts = starts[1:] - starts[:-1]
    dropped = torch.sum(torch.clamp(counts - spec.capacity, min=0))
    return (dropped / pos.shape[0]).to(torch.float32)


def _stencil_cells(ijk: torch.Tensor, spec: CellGridSpec):
    """(N, 27) linear ids of the 3x3x3 stencil and their validity (False
    for cells outside the grid, whose ids are clipped)."""
    _, ny, nz = spec.dims
    dev = ijk.device
    count("host_sync.cellgrid.stencil")
    offsets = torch.tensor(
        [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
         for dz in (-1, 0, 1)], dtype=ijk.dtype, device=dev)   # (27, 3)
    nbr = ijk[:, None, :] + offsets[None, :, :]                # (N, 27, 3)
    count("host_sync.cellgrid.stencil")
    dims = torch.tensor(spec.dims, dtype=ijk.dtype, device=dev)
    valid = torch.all((nbr >= 0) & (nbr < dims), dim=-1)
    nbr = torch.minimum(torch.clamp(nbr, min=0), dims - 1)
    lin = (nbr[..., 0] * ny + nbr[..., 1]) * nz + nbr[..., 2]
    return lin, valid


@torch.no_grad()
def cell_grid_neighborhood(query: torch.Tensor, source: torch.Tensor,
                           h: float, k: int, spec: CellGridSpec,
                           exclude_self: bool = True,
                           self_offset=None) -> Neighborhood:
    """Fixed-degree radius neighborhood through the 27-cell stencil.

    Exact (against brute force) whenever no cell overflows
    `spec.capacity` and no true neighborhood exceeds k. `self_offset` as in
    brute_force_neighborhood; `exclude_self` with query == source removes
    the identity pair by index. A k above 27 C is padded with masked
    slots."""
    query, source = query.detach(), source.detach()
    n = query.shape[0]
    c = spec.capacity
    dev = query.device
    order, starts = build_cell_table(source, spec)

    cells, cell_valid = _stencil_cells(cell_coords(query, spec), spec)
    start = starts[cells]                                       # (N, 27)
    end = starts[cells + 1]
    cand_rank = start[..., None] + torch.arange(c, device=dev)  # (N, 27, C)
    cand_valid = (cand_rank < end[..., None]) & cell_valid[..., None]
    cand_rank.clamp_(max=source.shape[0] - 1)
    cand_idx = order[cand_rank].reshape(n, 27 * c)
    del cand_rank, start, end, cells, cell_valid
    cand_valid = cand_valid.reshape(n, 27 * c)

    # Component planes: no (N, 27 C, 3) intermediate.
    dx = source[:, 0][cand_idx] - query[:, 0:1]
    dy = source[:, 1][cand_idx] - query[:, 1:2]
    dz = source[:, 2][cand_idx] - query[:, 2:3]
    dist = sqrt_cr(dx * dx + dy * dy + dz * dz)
    del dx, dy, dz
    in_radius = cand_valid & (dist < h)
    del cand_valid
    if self_offset is not None:
        rows = torch.arange(n, device=dev)[:, None]
        in_radius &= cand_idx != rows + self_offset
    elif exclude_self and query.shape == source.shape:
        in_radius &= cand_idx != torch.arange(n, device=dev)[:, None]

    ranked = torch.where(in_radius, dist, torch.inf)
    del dist, in_radius
    k_eff = min(k, 27 * c)
    vals, slot = rank_smallest(ranked, k_eff)
    del ranked
    valid = torch.isfinite(vals)
    idx = torch.where(valid, torch.gather(cand_idx, 1, slot), 0)
    mask = valid.to(torch.float32)
    if k_eff < k:
        idx = torch.nn.functional.pad(idx, (0, k - k_eff))
        mask = torch.nn.functional.pad(mask, (0, k - k_eff))
    return Neighborhood(idx=idx, mask=mask)
