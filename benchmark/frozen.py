"""The yardstick's arithmetic, frozen here so that a change to the program
cannot move it: the card's peaks, the kernel groups of the profile, and the
operations and bytes each hand-written kernel needs on given data.

Origins (copied, then made independent of the program's own tables):
  group()                      tools/torch_profile_training.py, group()
  candidate_pairs, _bound,     chip_smoke.py, candidate_pairs, _bound,
  kernel_bounds                kernel_bounds (the channel counts of each
                               sweep frozen in SWEEP_CHANNELS below instead
                               of read from the program's sweep table)
  OPS_PER_PAIR                 chip_smoke.py, OPS_PER_PAIR
  RASTER_OPS_PER_PAIR,         chip_smoke.py, RASTER_OPS_PER_PAIR,
  raster_bounds                raster_bounds
"""

from __future__ import annotations

import re

import torch

# H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM bytes per second and
# float32 operations per second outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# Operations per candidate pair of each sweep's pair functor, each add,
# multiply, compare, select, divide and rsqrt counted as one; work on the own
# slot alone is hoisted out of the pair loop and not counted. The fused
# force's adjoint runs the pressure and the viscosity adjoint terms, each
# output scaled (one multiply per output). The gated sweeps count as the
# sweep they gate.
OPS_PER_PAIR = {"density": 16, "force": 44, "force_p": 31,
                "viscosity": 31, "pressure_pq": 30, "pressure": 33,
                "density_bwd": 23,
                "pressure_bwd": 74, "viscosity_bwd": 73,
                "force_bwd": 74 + 5 + 73 + 7, "force_p_bwd": 74 + 5}

# (input planes, output planes) of each logical sweep: the mask and the
# channels its pair reads; the backward sweeps add their cotangents.
SWEEP_CHANNELS = {"density": (4, 1), "force": (9, 3), "force_p": (6, 3),
                  "viscosity": (8, 3), "pressure_pq": (5, 3),
                  "pressure": (6, 3), "density_bwd": (5, 3),
                  "pressure_bwd": (9, 5), "viscosity_bwd": (11, 7),
                  "force_bwd": (12, 8), "force_p_bwd": (9, 5)}

# Operations per live (slot, pixel) pair of the tile rasterizer, counted the
# same way, for its 6-output form: the forward's pair and its 6 sums; the
# backward's recomputed forward and adjoint chain.
RASTER_OPS_PER_PAIR = {"splat_fwd": 44, "splat_bwd": 104}

_SORT = ("sort", "Sort", "scan", "index", "gather", "scatter", "Radix", "cub")

#: Device kernels of the hand-written library, by the name the trace gives.
HANDWRITTEN = ("compact_sweep_kernel", "splat_fwd_kernel", "splat_bwd_kernel")


def group(key: str) -> str:
    """The profile's kernel group of a device kernel's name."""
    m = re.search(r"sweep_kernel<\(anonymous namespace\)::(\w+(<\w+>)?)", key)
    if m:
        return "sweep"
    if "splat_fwd_kernel" in key or "splat_bwd_kernel" in key:
        return "raster"
    if any(s in key for s in _SORT):
        return "sort/scan/index"
    if "Memset" in key or "Memcpy" in key or "fill" in key.lower() \
            or "copy" in key.lower():
        return "memset/copy"
    return "elementwise/reduce"


def candidate_pairs(mask, spec, rows=None) -> int:
    """Occupied (own, candidate) slot pairs of the 27-cell stencil: the
    pairs each sweep evaluates on this data (with `rows`, a (rows, 1, 1)
    bool, only those whose own slot lies in a selected row)."""
    occ = mask.view(spec.px, spec.py, spec.row_len // spec.capacity,
                    spec.capacity).sum(-1)
    nbr = torch.nn.functional.avg_pool3d(
        occ[None, None], 3, stride=1, padding=1,
        count_include_pad=True)[0, 0] * 27.0
    own = occ if rows is None else occ * rows.view(spec.px, spec.py, 1)
    return int(round(float((own.double() * nbr.double()).sum())))


def _bound(n_bytes: float, pairs: int, ops_per_pair: int) -> float:
    """Bound ms at the H100's peaks: the larger of bytes over the HBM rate
    and operations over the float32 peak."""
    return max(n_bytes / HBM_BYTES_PER_S,
               pairs * ops_per_pair / FP32_OPS_PER_S) * 1e3


def kernel_bounds(planes, spec) -> dict:
    """sweep name -> bound ms on these planes: the larger of the bytes each
    sweep must move over the HBM rate, and its pair operations on this data
    over the float32 peak. Bytes: the mask plane read and every output plane
    written in full; every other input channel read once over the 128-slot
    blocks that hold an occupied slot (an empty block's values are masked
    out, and the kernel skips such a block), as the operations count only
    occupied pairs."""
    mask = planes["mask"]
    pairs = candidate_pairs(mask, spec)
    plane_bytes = spec.size * 4
    blocks = int((mask.reshape(-1, 128).amax(-1) > 0).sum())
    block_bytes = blocks * 128 * 4
    return {name: _bound((1 + n_out) * plane_bytes
                         + (n_in - 1) * block_bytes, pairs,
                         OPS_PER_PAIR[name])
            for name, (n_in, n_out) in SWEEP_CHANNELS.items()}


def raster_bounds(planes, spec) -> dict:
    """name -> bound ms of the rasterizer's forward and backward (6
    outputs) on these slot planes. Bytes: the four slot planes read over the
    128-slot rows that hold an occupied slot, the tile planes (6 outputs, or
    6 cotangents) in full, and the backward's four gradient slot planes
    written in full. Operations: each live slot times the pixels of its
    patch box inside its tile, times RASTER_OPS_PER_PAIR."""
    r = planes["r"]
    occ_rows = int((r.reshape(-1, 128).amax(-1) >= 0.5).sum())
    live = r.reshape(-1) >= 0.5
    half = spec.patch // 2

    def extent(c, size):
        f = torch.floor(c.reshape(-1)[live])
        return torch.clamp(torch.clamp(f + half, max=size - 1)
                           - torch.clamp(f - half, min=0) + 1, min=0)

    pairs = int((extent(planes["u"], spec.tw).double()
                 * extent(planes["v"], spec.th).double()).sum())
    slot_in = 4 * occ_rows * 128 * 4
    tile = spec.n_tiles * spec.th * spec.tw * 4
    n_bytes = {"splat_fwd": slot_in + 6 * tile,
               "splat_bwd": slot_in + 6 * tile + 4 * spec.n_tiles * spec.k
               * 4}
    return {name: _bound(nb, pairs, RASTER_OPS_PER_PAIR[name])
            for name, nb in n_bytes.items()}
