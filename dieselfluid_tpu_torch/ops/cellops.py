"""Dense cell-grid layout for the stencil sweeps.

Counterpart of dieselfluid_tpu/ops/cellops.py, with the same plane layout, so
planes compare element by element across the two packages. Particles are
binned into a padded cell lattice stored as float32 planes (rows, sub, 128):

  * rows are the (x, y) cell columns with one ghost ring:
    row = (i+1)*py + (j+1);
  * each row is the z axis, `capacity` contiguous slots per cell,
    col = (k + z_block)*capacity + rank, so one ghost z-block of 128 slots
    sits at each end of the row.

A z-cell's slots are contiguous, and so are its z-neighbours', so the 27-cell
stencil of a slot is 9 rows x 3*capacity contiguous slots.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from dieselfluid_tpu_torch.utils.constants import device_constant


@dataclasses.dataclass(frozen=True)
class DenseCellSpec:
    """Static dense-layout config; field for field the JAX DenseCellSpec.
    The cell edge must be >= the kernel radius."""

    nx: int
    ny: int
    nz: int
    capacity: int
    cell: float
    lo: Tuple[float, float, float] = (-1.0, -1.0, -1.0)

    def __post_init__(self):
        if 128 % self.capacity != 0:
            raise ValueError(f"capacity must divide 128, got {self.capacity}")

    @staticmethod
    def for_domain(lo, hi, h: float, capacity: int = 16) -> "DenseCellSpec":
        lo_a = np.asarray(lo, np.float64)
        hi_a = np.asarray(hi, np.float64)
        dims = np.maximum(np.ceil((hi_a - lo_a) / h), 1).astype(int)
        return DenseCellSpec(nx=int(dims[0]), ny=int(dims[1]), nz=int(dims[2]),
                             capacity=capacity, cell=float(h), lo=tuple(lo))

    @property
    def z_block(self) -> int:
        """z cells per 128-slot block (capacity * z_block == 128)."""
        return 128 // self.capacity

    @property
    def nz_padded(self) -> int:
        zb = self.z_block
        return ((self.nz + zb - 1) // zb) * zb

    @property
    def px(self) -> int:
        return self.nx + 2

    @property
    def py(self) -> int:
        return self.ny + 2

    @property
    def rows(self) -> int:
        return self.px * self.py

    @property
    def sub(self) -> int:
        """128-slot blocks per (x, y) column: interior blocks + one ghost
        block at each end."""
        return self.nz_padded // self.z_block + 2

    @property
    def row_len(self) -> int:
        return self.sub * 128

    @property
    def plane_shape(self) -> Tuple[int, int, int]:
        return (self.rows, self.sub, 128)

    @property
    def size(self) -> int:
        return self.rows * self.row_len


def dense_indices(pos: torch.Tensor, spec: DenseCellSpec):
    """Per-particle dense slot: (flat int64, valid bool, overflow int64 0-d).

    `flat` indexes the flattened (rows * sub * 128) plane. Slot ranks come
    from one STABLE argsort over cell ids, so the within-cell rank (which
    decides who overflows) is the particle order, as in the JAX package.
    Particles past a cell's capacity are dropped and counted; their `flat`
    is clamped onto the cell's last slot, which it ALIASES — every gather
    through `flat` must be masked with `valid`, and a step spreads the
    masked entries (`spread_masked`) before its gathers. The grid's corner
    and last cell are device constants, made once per spec and device."""
    c = spec.capacity
    dev = pos.device
    lo = device_constant(spec.lo, dev, "cellops.dense_indices")
    ijk = torch.floor((pos - lo) / spec.cell).to(torch.int32)
    hi = device_constant((spec.nx - 1, spec.ny - 1, spec.nz - 1), dev,
                         "cellops.dense_indices", torch.int32)
    ijk = torch.minimum(torch.clamp(ijk, min=0), hi).to(torch.int64)
    cid = (ijk[:, 0] * spec.ny + ijk[:, 1]) * spec.nz + ijk[:, 2]

    order = torch.argsort(cid, stable=True)
    sorted_cid = cid[order]
    n = pos.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    # Each sorted entry's run start, by binary search: torch.cummax over
    # one long row runs as one serial scan on the card (192 of 325 ms of a
    # 16M sharded step).
    first_occ = torch.searchsorted(sorted_cid, sorted_cid)
    rank = torch.empty_like(idx)
    rank[order] = idx - first_occ

    valid = rank < c
    overflow = torch.sum(~valid)

    row = (ijk[:, 0] + 1) * spec.py + (ijk[:, 1] + 1)
    col = (ijk[:, 2] + spec.z_block) * c + torch.clamp(rank, max=c - 1)
    flat = row * spec.row_len + col
    return flat, valid, overflow


def build_planes(values: Dict[str, torch.Tensor], flat: torch.Tensor,
                 valid: torch.Tensor, spec: DenseCellSpec,
                 mask: torch.Tensor = None) -> Dict[str, torch.Tensor]:
    """Scatter per-particle channels into dense planes (plus a 'mask' plane).

    Slots are unique: each valid particle owns one slot, and each invalid one
    parks in its own trash slot past the plane (size + index), so a plain
    indexed store is exact. `mask`: a frozen mask plane from an earlier build
    over the SAME binning; passing it skips the mask scatter."""
    size = spec.size
    n = flat.shape[0]
    dev = flat.device
    idx = torch.arange(n, dtype=flat.dtype, device=dev)
    safe = torch.where(valid, flat, size + idx)
    out = {}
    if mask is None:
        m = torch.zeros(size + n, dtype=torch.float32, device=dev)
        m[safe] = valid.to(torch.float32)
        out["mask"] = m[:size].view(spec.plane_shape)
    else:
        out["mask"] = mask
    for name, v in values.items():
        plane = torch.zeros(size + n, dtype=torch.float32, device=dev)
        plane[safe] = v.to(torch.float32)
        out[name] = plane[:size].view(spec.plane_shape)
    return out


def slot_particle_map(flat: torch.Tensor, valid: torch.Tensor,
                      spec: DenseCellSpec) -> torch.Tensor:
    """Inverse binning: the particle index of each slot (int64, -1 = empty).
    Invalid particles park at slot 0, a ghost-ring slot, where the max can
    never shadow a real particle. For diagnostics and tests: building
    planes by gathering through this map is much slower than the scatter of
    `build_planes` (34x on the JAX package's TPU at 1M)."""
    safe = torch.where(valid, flat, 0)
    idx = torch.arange(flat.shape[0], dtype=torch.int64, device=flat.device)
    smap = torch.full((spec.size,), -1, dtype=torch.int64,
                      device=flat.device)
    return smap.scatter_reduce_(0, safe, torch.where(valid, idx, -1),
                                reduce="amax")


def build_planes_from_map(values: Dict[str, torch.Tensor],
                          smap: torch.Tensor,
                          spec: DenseCellSpec) -> Dict[str, torch.Tensor]:
    """Dense planes (plus 'mask') from per-particle channels through the
    slot map: `build_planes` by gathers."""
    occupied = smap >= 0
    src = torch.where(occupied, smap, 0)
    out = {"mask": occupied.to(torch.float32).view(spec.plane_shape)}
    for name, v in values.items():
        out[name] = torch.where(occupied, v[src].to(torch.float32),
                                0.0).view(spec.plane_shape)
    return out


def spread_masked(flat: torch.Tensor, valid: torch.Tensor,
                  size: int) -> torch.Tensor:
    """`flat` where `valid`, else the entry's own index modulo `size`: every
    masked entry gets an in-range address that no other masked entry shares
    (while there are at most `size` entries). For index ops that add: a
    clamped or parked index repeats at every masked entry, and on the card
    their zero adds queue on that one address. The caller's mask discards
    what a masked entry reads, and its zero cotangent lands alone.

    Laid out in rows of `size`, an entry's index modulo `size` is its
    column: the rows take one `where` against one arange and the last,
    shorter row another, with no division and no index-sized temporary."""
    m = flat.shape[0]
    cols = torch.arange(min(m, size), dtype=flat.dtype, device=flat.device)
    out = torch.empty_like(flat)
    full = m - m % size
    if full:
        torch.where(valid[:full].reshape(-1, size),
                    flat[:full].reshape(-1, size), cols,
                    out=out[:full].view(-1, size))
    torch.where(valid[full:], flat[full:], cols[:m - full], out=out[full:])
    return out


def gather_plane(plane: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """Per-particle values read back out of a dense plane. An index_select,
    whose backward adds into the plane's gradient with atomics: the
    backward of `plane[flat]` sorts the indices and walks each run of
    equal ones serially, so a step gathers through `spread_masked` indices
    (an overflowed or dead slot's `flat` repeats)."""
    return plane.reshape(-1).index_select(0, flat)


def gather_planes(planes: Sequence[torch.Tensor],
                  flat: torch.Tensor) -> torch.Tensor:
    """Per-particle values of C planes as one (N, C) tensor. One gather per
    plane (no stacked plane-size copy)."""
    return torch.stack([gather_plane(p, flat) for p in planes], dim=-1)
