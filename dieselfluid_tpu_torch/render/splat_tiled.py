"""Tile-based splat rasterizer: the card's particle renderer.

Counterpart of dieselfluid_tpu/render/splat_pallas.py. The image splits into
(8, 128)-pixel tiles (1080p: 135 x 15 = 2025). Each particle's patch meets at
most 2 x 2 tiles; its up to 4 (particle, tile) entries bin into a dense
(n_tiles, K) slot table with tile-local parameters (u, v, z, r), by a stable
argsort and a first-occurrence scan as in ops/cellops. The rasterizer owns
one tile at a time:

  * forward (K11 of PERF.md): per pixel, the sum over the tile's occupied
    slots of the splat pair inside the slot's patch box: w (n/2 + 1/2) RGB,
    w, coverage, w z, and w n with `emit_normals` (6 or 9 tile planes);
  * backward (K12): per slot, the sum over the pixels of its patch box of
    d(outputs)/d(u, v, z, r) against the pixels' cotangents, zero where
    r < 0.5.

There is no mask channel: live slots carry r >= 0.75 (the projection clip)
and empty or trash slots r = 0, so occupancy is r >= 0.5 everywhere. A
tile's occupied slots are its first ranks (bin_tile_entries writes each
valid entry at its rank in the tile): both kernels read a tile's slots only
up to the first 128-slot chunk whose first slot is empty (K11 stops there,
K12 writes zeros for that chunk and every one after it), so slot planes
from anywhere else must keep that order too. On a plane with a hole the
kernels agree with each other (the backward's gradients are those of the
splats the forward drew), not with the plain versions, which read every
occupied slot.

Dispatch is by the device of the slot planes, forward and backward alike:
  * CUDA tensors launch the hand-written sm_90a kernels in
    csrc/splat_raster.cu, built by nvcc at the first launch (ops/_build.py),
    and each launch adds one to its kernel's `launches` (`KERNELS`). A failed
    build or launch raises; nothing falls back to the plain version.
  * CPU tensors run the plain torch versions below: each occupied slot
    against the pixels of its patch box clipped to its tile, chunked over
    slots (forward: `index_add_` into the tile's pixels; backward: the
    hand-written adjoint per pair, gathered from the pixels' cotangents and
    summed over the box). The CPU tests thus check the hand derivation.

`plain` holds the plain rasterizer and its adjoint; they run on any device
(chip_smoke.py holds each kernel against them on the card).

The patch box. The JAX kernel tests |px + 0.5 - u - 0.5 + u - floor(u)| <=
half, in float; the pixels it means are |px - floor(u)| <= half, the XLA
path's box (splat_pallas.py:237-241). This module and the kernels test the
integers. The two agree on every in-tile pixel (tests/test_torch_render.py
checks 4M random pairs; they differ only for pixels left of the tile, which
no tile computes).
"""

from __future__ import annotations

import ctypes
import dataclasses
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from dieselfluid_tpu_torch.ops import _build
from dieselfluid_tpu_torch.render.camera import Camera
from dieselfluid_tpu_torch.render.sh import eval_sh9, project_sh9
from dieselfluid_tpu_torch.render.splat import (
    SplatImage,
    _maximum,
    _project,
    depth_min,
    pixel_radius,
)
from dieselfluid_tpu_torch.utils.constants import device_constant
from dieselfluid_tpu_torch.utils.profiling import span

SOURCE = "dieselfluid_tpu_torch/csrc/splat_raster.cu"
_PALLAS = "dieselfluid_tpu/render/splat_pallas.py"
CHANNELS = ("u", "v", "z", "r")

#: Kernel vs plain version, per output: max |kernel - plain| / max |plain|.
#: Both are float32 and round r2 alike; they differ in summation order (the
#: plain forward adds pairs by index_add_, in no fixed order on the card),
#: in FMA contraction elsewhere and in rsqrtf. Measured on an H100: forward
#: at most 1.3e-6 (the 1080p frame of 512k particles, up to ~8k entries a
#: tile; 7.2e-7 at 256x144), backward at most 3.0e-7 per gradient. The
#: bounds are about 8x and 10x that.
RASTER_REL_TOL = 1e-5
RASTER_BWD_REL_TOL = 3e-6

Planes = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """Static raster configuration. width % 128 == 0 and height % 8 == 0
    (1920x1080, 256x144, 256x256, ... qualify)."""

    width: int
    height: int
    k: int = 2048          # entry slots per tile (a multiple of 128)
    patch: int = 9

    def __post_init__(self):
        if self.width % self.tw or self.height % self.th or self.k % 128:
            raise ValueError(f"TileSpec needs width % 128 == 0, height % 8 "
                             f"== 0 and k % 128 == 0: {self}")

    @property
    def th(self) -> int:
        return 8

    @property
    def tw(self) -> int:
        return 128

    @property
    def ntx(self) -> int:
        return self.width // self.tw

    @property
    def nty(self) -> int:
        return self.height // self.th

    @property
    def n_tiles(self) -> int:
        return self.ntx * self.nty

    @property
    def k_sub(self) -> int:
        return self.k // 128

    @property
    def plane_shape(self) -> Tuple[int, int, int]:
        return (self.n_tiles, self.k_sub, 128)

    @property
    def tile_shape(self) -> Tuple[int, int, int]:
        return (self.n_tiles, self.th, self.tw)


@dataclasses.dataclass
class RasterKernel(_build.Kernel):
    """One rasterizer kernel: a kernel record (ops/_build.py) whose two
    forms are its 6- and 9-output launchers, the kernel body they run, and
    the 9-output (env-lit) form's share of its launches."""

    replaces: str
    body: str

    @property
    def launches9(self) -> int:
        return self.form_launches[1]


#: in, out, n_tiles, k, half, sharpness, falloff.
_ARGS = ((ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 3
         + (ctypes.c_float,) * 2)
SPLAT_FWD = RasterKernel("splat_fwd", ("dft_splat_fwd6", "dft_splat_fwd9"),
                         _ARGS, f"{_PALLAS}:348",
                         "splat_fwd_kernel<kNormals>: tiles split by pixel "
                         "column, per-warp slot lists")
SPLAT_BWD = RasterKernel("splat_bwd", ("dft_splat_bwd6", "dft_splat_bwd9"),
                         _ARGS, f"{_PALLAS}:372",
                         "splat_bwd_kernel<kNormals>: a CTA per 128-slot "
                         "chunk, zeros past the occupied prefix, slots "
                         "ranked onto lanes by box size")
KERNELS = (SPLAT_FWD, SPLAT_BWD)


def reset_launch_counts():
    for kern in KERNELS:
        kern.reset()


# ---------------------------------------------------------------------------
# Entry binning (torch ops)
# ---------------------------------------------------------------------------


def bin_tile_entries(u, v, z_norm, pix_r, in_front, spec: TileSpec):
    """(particle, tile) entries -> dense slot planes + overflow count.

    Returns (planes {u, v, z, r}, (flat, valid), overflow). Channels are
    tile-local: u/v are offset by the tile origin. The within-tile rank (who
    overflows past k) is the entry order, by a STABLE argsort as jnp.argsort
    is. Invalid entries (out of frame or overflowed) park in distinct trash
    slots past the plane, so every slot is written once and planes keep
    r = 0 unless a valid entry set them. Differentiable in u, v, z_norm and
    pix_r (the scatter's gradient is a gather)."""
    half = spec.patch // 2
    cx, cy = torch.floor(u), torch.floor(v)
    tx0 = torch.floor((cx - half) / spec.tw)
    ty0 = torch.floor((cy - half) / spec.th)

    ids, oks, uls, vls = [], [], [], []
    for dy in (0, 1):
        for dx in (0, 1):
            tx = tx0 + dx
            ty = ty0 + dy
            ok = (in_front
                  & (tx >= 0) & (tx < spec.ntx)
                  & (ty >= 0) & (ty < spec.nty)
                  & (tx * spec.tw <= cx + half)
                  & (tx * spec.tw + spec.tw - 1 >= cx - half)
                  & (ty * spec.th <= cy + half)
                  & (ty * spec.th + spec.th - 1 >= cy - half))
            # Ids of entries that are not ok never reach a plane; clamp
            # them so far-off-screen centers stay small integers.
            tid = torch.where(ok, ty * spec.ntx + tx, 0.0)
            ids.append(tid.to(torch.int64))
            oks.append(ok)
            uls.append(u - tx * spec.tw)
            vls.append(v - ty * spec.th)
    ids = torch.cat(ids)
    ok = torch.cat(oks)
    vals = {"u": torch.cat(uls), "v": torch.cat(vls),
            "z": torch.cat([z_norm] * 4), "r": torch.cat([pix_r] * 4)}

    n = ids.shape[0]
    dev = ids.device
    sort_key = torch.where(ok, ids, spec.n_tiles)
    order = torch.argsort(sort_key, stable=True)
    sorted_ids = sort_key[order]
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    # Run starts by binary search (cellops.dense_indices: a cummax over
    # one long row is one serial scan on the card).
    first_occ = torch.searchsorted(sorted_ids, sorted_ids)
    rank = torch.empty_like(idx)
    rank[order] = idx - first_occ

    valid = ok & (rank < spec.k)
    overflow = torch.sum(ok & ~(rank < spec.k))
    flat = ids * spec.k + torch.clamp(rank, max=spec.k - 1)
    size = spec.n_tiles * spec.k
    safe = torch.where(valid, flat, size + idx)
    planes = {}
    for name, val in vals.items():
        plane = torch.zeros(size + n, dtype=torch.float32, device=dev)
        plane[safe] = val.to(torch.float32)
        planes[name] = plane[:size].view(spec.plane_shape)
    return planes, (flat, valid), overflow


# ---------------------------------------------------------------------------
# The splat pair and its hand-written adjoint (plain torch, broadcasting)
# ---------------------------------------------------------------------------


def _splat_pair(u, v, z, r, px_c, py_c, sharpness: float,
                depth_falloff: float, emit_normals: bool):
    """The splat of slot (u, v, z, r) at the pixel center (px_c, py_c), for
    a live pair (occupied slot, pixel inside its patch box): JAX
    `_splat_pair` with live = 1, term for term. -> 6 (or 9) values."""
    dxp = px_c - u
    dyp = py_c - v
    # Empty slots carry r = 0: the floor keeps their reciprocal finite.
    inv_r = 1.0 / _maximum(r, 0.5)
    ez = torch.exp(-depth_falloff * z)
    ox = dxp * inv_r
    oy = dyp * inv_r
    r2 = ox * ox + oy * oy
    cov = torch.sigmoid(sharpness * (1.0 - r2))
    inside = (1.0 - r2) > 1e-6
    oz = torch.where(inside, torch.sqrt(torch.where(inside, 1.0 - r2, 1.0)),
                     0.0)
    inv_nlen = torch.rsqrt(_maximum(ox * ox + oy * oy + oz * oz, 1e-12))
    nx = ox * inv_nlen
    ny = -(oy * inv_nlen)
    nz = oz * inv_nlen
    w = cov * ez
    out = ((nx * 0.5 + 0.5) * w, (ny * 0.5 + 0.5) * w, (nz * 0.5 + 0.5) * w,
           w, cov, w * z)
    if emit_normals:
        out += (w * nx, w * ny, w * nz)
    return out


def _tie_grad(x, at: float, g):
    """g * d max(x, at)/dx, with jnp.maximum's half at the tie."""
    return torch.where(x > at, g, torch.where(x == at, 0.5 * g, 0.0))


def _splat_pair_bwd(u, v, z, r, px_c, py_c, cts: Sequence[torch.Tensor],
                    sharpness: float, depth_falloff: float,
                    emit_normals: bool):
    """The adjoint of `_splat_pair` against the pixel's cotangents (6 or
    9), written out term for term as JAX's jax.vjp derives it: through
    inv_r = 1/max(r, 0.5) (half at the tie), ez, ox, oy, r2, the sigmoid,
    the where-trick oz (derivative only inside), rsqrt(max(|n|^2, 1e-12))
    (zero through the clamp), n, the colors, w, coverage, w z and w n.
    Inside the disc the normal length's derivative is ~0 only up to
    rounding; it is kept. -> (d/du, d/dv, d/dz, d/dr) per pair."""
    dxp = px_c - u
    dyp = py_c - v
    inv_r = 1.0 / _maximum(r, 0.5)
    ez = torch.exp(-depth_falloff * z)
    ox = dxp * inv_r
    oy = dyp * inv_r
    r2 = ox * ox + oy * oy
    cov = torch.sigmoid(sharpness * (1.0 - r2))
    inside = (1.0 - r2) > 1e-6
    oz = torch.where(inside, torch.sqrt(torch.where(inside, 1.0 - r2, 1.0)),
                     0.0)
    nlen2 = ox * ox + oy * oy + oz * oz
    nlen2_c = _maximum(nlen2, 1e-12)
    inl = torch.rsqrt(nlen2_c)
    nx, ny, nz = ox * inl, -(oy * inl), oz * inl
    w = cov * ez
    c = cts
    # Outputs -> w, cov, z and the normal.
    g_w = (c[0] * (nx * 0.5 + 0.5) + c[1] * (ny * 0.5 + 0.5)
           + c[2] * (nz * 0.5 + 0.5) + c[3] + c[5] * z)
    g_nx, g_ny, g_nz = 0.5 * (c[0] * w), 0.5 * (c[1] * w), 0.5 * (c[2] * w)
    if emit_normals:
        g_w = g_w + c[6] * nx + c[7] * ny + c[8] * nz
        g_nx, g_ny, g_nz = g_nx + c[6] * w, g_ny + c[7] * w, g_nz + c[8] * w
    g_cov = g_w * ez + c[4]
    g_z = c[5] * w + (g_w * cov) * ez * (-depth_falloff)
    # n = (ox, -oy, oz) * rsqrt(max(|.|^2, 1e-12)).
    g_inl = g_nx * ox - g_ny * oy + g_nz * oz
    g_ox = g_nx * inl
    g_oy = -g_ny * inl
    g_oz = g_nz * inl
    g_len = _tie_grad(nlen2, 1e-12, g_inl * (-0.5 * inl / nlen2_c))
    g_ox = g_ox + 2.0 * ox * g_len
    g_oy = g_oy + 2.0 * oy * g_len
    g_oz = g_oz + 2.0 * oz * g_len
    # oz = sqrt(1 - r2) inside, 0 outside; cov = sigmoid(s (1 - r2)).
    g_r2 = torch.where(inside, -(g_oz * (0.5 / oz)), 0.0)
    g_r2 = g_r2 - sharpness * (g_cov * (cov * (1.0 - cov)))
    g_ox = g_ox + 2.0 * ox * g_r2
    g_oy = g_oy + 2.0 * oy * g_r2
    # o = (pixel - center) * inv_r.
    g_ir = g_ox * dxp + g_oy * dyp
    g_r = _tie_grad(r, 0.5, -g_ir * inv_r * inv_r)
    return -(g_ox * inv_r), -(g_oy * inv_r), g_z, g_r


# ---------------------------------------------------------------------------
# Plain rasterizer: occupied slot x clipped patch box, chunked over slots
# ---------------------------------------------------------------------------


def _check_planes(planes: Planes, spec: TileSpec) -> torch.device:
    return _build.check_planes([planes[n] for n in CHANNELS],
                               spec.plane_shape, "slot")


def _box_pairs(planes: Planes, slots: torch.Tensor, spec: TileSpec):
    """For occupied slots (flat indices): their values (E, 1) and their
    patch box's pixels (E, B) clipped to the tile: in-tile flag, flat pixel
    index into the (n_tiles * 1024) tile planes, pixel centers."""
    half = spec.patch // 2
    dev = slots.device
    vals = {n: planes[n].reshape(-1)[slots][:, None] for n in CHANNELS}
    offs = torch.arange(-half, half + 1, dtype=torch.float32, device=dev)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    px = torch.floor(vals["u"]) + ox.reshape(1, -1)
    py = torch.floor(vals["v"]) + oy.reshape(1, -1)
    in_tile = (px >= 0) & (px < spec.tw) & (py >= 0) & (py < spec.th)
    tile = (slots // spec.k)[:, None]
    pix = (tile * (spec.th * spec.tw) + torch.clamp(py, 0, spec.th - 1)
           .to(torch.int64) * spec.tw
           + torch.clamp(px, 0, spec.tw - 1).to(torch.int64))
    return vals, in_tile, pix, px + 0.5, py + 0.5


def _occupied_slots(planes: Planes) -> torch.Tensor:
    return torch.nonzero(planes["r"].reshape(-1) >= 0.5).squeeze(1)


def rim_gap(planes: Planes, spec: TileSpec) -> float:
    """min |1 - r2| over the live (slot, pixel) pairs, r2 in float64: how
    near the frame comes to the disc's rim. There the gradient of the
    normal's sqrt(1 - r2) is 0.5 / sqrt(1 - r2), cut off by the where-trick
    at 1 - r2 = 1e-6, so a pair within ~1e-5 of the rim turns one ulp of a
    position into a large part of its slot's gradient, and a pair at the
    cutoff can flip it. Comparisons of two float orderings check it."""
    vals, in_tile, _, px_c, py_c = _box_pairs(planes, _occupied_slots(planes),
                                              spec)
    r = vals["r"].double()
    r2 = (((px_c.double() - vals["u"].double()) / r) ** 2
          + ((py_c.double() - vals["v"].double()) / r) ** 2)
    return float((1.0 - r2[in_tile]).abs().min())


def _raster_fwd_plain(planes: Planes, spec: TileSpec, sharpness: float,
                      depth_falloff: float, emit_normals: bool,
                      chunk: int = 1 << 16) -> List[torch.Tensor]:
    """The plain K11: (n_tiles, 8, 128) accumulator planes num_r, num_g,
    num_b, den, acc_a, acc_z (+ wn_x, wn_y, wn_z)."""
    _check_planes(planes, spec)
    n_out = 9 if emit_normals else 6
    dev = planes["r"].device
    outs = [torch.zeros(spec.n_tiles * spec.th * spec.tw, dtype=torch.float32,
                        device=dev) for _ in range(n_out)]
    slots = _occupied_slots(planes)
    for s in range(0, slots.shape[0], chunk):
        vals, in_tile, pix, px_c, py_c = _box_pairs(
            planes, slots[s:s + chunk], spec)
        terms = _splat_pair(vals["u"], vals["v"], vals["z"], vals["r"],
                            px_c, py_c, sharpness, depth_falloff,
                            emit_normals)
        sel = pix[in_tile]
        for o, t in zip(outs, terms):
            o.index_add_(0, sel, t[in_tile])
    return [o.view(spec.tile_shape) for o in outs]


def _raster_bwd_plain(planes: Planes, cts: Sequence[torch.Tensor],
                      spec: TileSpec, sharpness: float, depth_falloff: float,
                      emit_normals: bool, chunk: int = 1 << 16
                      ) -> List[torch.Tensor]:
    """The plain K12: d/d(u, v, z, r) slot planes, zero where r < 0.5."""
    _check_planes(planes, spec)
    dev = planes["r"].device
    grads = [torch.zeros(spec.n_tiles * spec.k, dtype=torch.float32,
                         device=dev) for _ in CHANNELS]
    flat_cts = [c.reshape(-1) for c in cts]
    slots = _occupied_slots(planes)
    for s in range(0, slots.shape[0], chunk):
        sl = slots[s:s + chunk]
        vals, in_tile, pix, px_c, py_c = _box_pairs(planes, sl, spec)
        c = [torch.where(in_tile, fc[pix], 0.0) for fc in flat_cts]
        per_pair = _splat_pair_bwd(vals["u"], vals["v"], vals["z"],
                                   vals["r"], px_c, py_c, c, sharpness,
                                   depth_falloff, emit_normals)
        for g, t in zip(grads, per_pair):
            g[sl] = torch.where(in_tile, t, 0.0).sum(dim=1)
    return [g.view(spec.plane_shape) for g in grads]


# ---------------------------------------------------------------------------
# CUDA launch and dispatch
# ---------------------------------------------------------------------------


def _device_of(planes: Planes, spec: TileSpec) -> torch.device:
    dev = _check_planes(planes, spec)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no rasterizer kernel for device {dev}")
    return dev


def rasterize_fwd(planes: Planes, spec: TileSpec, sharpness: float,
                  depth_falloff: float, emit_normals: bool
                  ) -> List[torch.Tensor]:
    """K11 on CUDA slot planes, the plain version on CPU ones: the
    accumulator tile planes, untracked. One span `sweep.splat_fwd` a
    call."""
    with span("sweep." + SPLAT_FWD.name):
        dev = _device_of(planes, spec)
        if dev.type == "cpu":
            return _raster_fwd_plain(planes, spec, sharpness, depth_falloff,
                                     emit_normals)
        outs = [torch.empty(spec.tile_shape, dtype=torch.float32,
                            device=dev)
                for _ in range(9 if emit_normals else 6)]
        _build.launch(SPLAT_FWD, dev,
                      _build.pointers([planes[n] for n in CHANNELS]),
                      _build.pointers(outs), spec.n_tiles, spec.k,
                      spec.patch // 2, sharpness, depth_falloff,
                      form=int(emit_normals))
        return outs


def rasterize_bwd(planes: Planes, cts: Sequence[torch.Tensor],
                  spec: TileSpec, sharpness: float, depth_falloff: float,
                  emit_normals: bool) -> List[torch.Tensor]:
    """K12 on CUDA slot planes, the plain version on CPU ones: d/d(u, v, z,
    r) of the accumulators against the cotangent tile planes. One span
    `sweep.splat_bwd` a call."""
    with span("sweep." + SPLAT_BWD.name):
        dev = _device_of(planes, spec)
        if _build.check_planes(cts, spec.tile_shape, "cotangent",
                               dtype_error=ValueError) != dev:
            raise ValueError(f"rasterizer cotangents must be on {dev}")
        if dev.type == "cpu":
            return _raster_bwd_plain(planes, cts, spec, sharpness,
                                     depth_falloff, emit_normals)
        outs = [torch.empty(spec.plane_shape, dtype=torch.float32,
                            device=dev)
                for _ in CHANNELS]
        _build.launch(SPLAT_BWD, dev,
                      _build.pointers([planes[n] for n in CHANNELS]
                                      + list(cts)),
                      _build.pointers(outs), spec.n_tiles, spec.k,
                      spec.patch // 2, sharpness, depth_falloff,
                      form=int(emit_normals))
        return outs


class _Rasterize(torch.autograd.Function):
    """Slot planes -> accumulator tile planes (rasterize_fwd); the backward
    is rasterize_bwd."""

    @staticmethod
    def forward(ctx, spec, sharpness, depth_falloff, emit_normals, *arrs):
        ctx.set_materialize_grads(False)
        ctx.spec = spec
        ctx.consts = (sharpness, depth_falloff, emit_normals)
        ctx.save_for_backward(*arrs)
        return tuple(rasterize_fwd(dict(zip(CHANNELS, arrs)), spec,
                                   *ctx.consts))

    @staticmethod
    def backward(ctx, *cts):
        planes = dict(zip(CHANNELS, ctx.saved_tensors))
        cts = [torch.zeros(ctx.spec.tile_shape, dtype=torch.float32,
                           device=planes["r"].device) if c is None
               else c.contiguous() for c in cts]
        return (None,) * 4 + tuple(rasterize_bwd(planes, cts, ctx.spec,
                                                 *ctx.consts))


def rasterize(planes: Planes, spec: TileSpec, sharpness: float,
              depth_falloff: float, emit_normals: bool = False):
    """Slot planes -> accumulator planes (n_tiles, 8, 128): num_r, num_g,
    num_b, den, acc_a, acc_z (+ wn_x, wn_y, wn_z with emit_normals).
    Differentiable in the four slot planes (JAX `_rasterize`).

    The planes must hold each tile's occupied slots (r >= 0.5) as its first
    ranks, as bin_tile_entries writes them. The kernels read a tile's live
    slots as the prefix of 128-slot chunks up to the first chunk whose first
    slot is empty, forward and backward alike; the plain versions (CPU
    planes) read every occupied slot, so the two differ only on planes that
    break this."""
    return _Rasterize.apply(spec, sharpness, depth_falloff, emit_normals,
                            *[planes[n] for n in CHANNELS])


#: The plain rasterizer and its plain adjoint, on any device: the
#: references each kernel is held against on the card.
plain = SimpleNamespace(rasterize_fwd=_raster_fwd_plain,
                        rasterize_bwd=_raster_bwd_plain)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def tile_entries(pos: torch.Tensor, radius, cam: Camera, spec: TileSpec):
    """Project and bin: (slot planes, (flat, valid), overflow, zmin) of the
    frame `splat_particles_tiled` rasterizes. A Python `radius` is filled
    on the positions' device (no host sync)."""
    n = pos.shape[0]
    if not torch.is_tensor(radius):
        radius = pos.new_full((), radius)
    radius = torch.broadcast_to(
        radius.to(dtype=torch.float32, device=pos.device), (n,))
    u, v, depth, focal = _project(cam, pos, spec.width, spec.height)
    in_front = depth > 1e-3
    pix_r = pixel_radius(radius, focal, depth, spec.patch)
    zmin = depth_min(depth, in_front)
    planes, fv, overflow = bin_tile_entries(u, v, depth - zmin, pix_r,
                                            in_front, spec)
    return planes, fv, overflow, zmin


def shade_tiles(accs: Sequence[torch.Tensor], spec: TileSpec,
                zmin: torch.Tensor, cam: Camera, background=(0.1, 0.1, 0.1),
                env_cube: Optional[torch.Tensor] = None,
                env_diffuse: float = 0.75,
                env_specular: float = 0.35) -> SplatImage:
    """The image from the rasterizer's accumulator tile planes: the
    weighted-blended mean color over the coverage and the background, and
    the weighted mean depth (+ zmin). With `env_cube` (the 9-output
    accumulators) the blended normal is normalized per pixel and lit by the
    cube's SH9 projection. A Python `background` is a device constant,
    made once per color and device."""
    emit_normals = env_cube is not None

    def to_image(t):
        return t.reshape(spec.nty, spec.ntx, spec.th, spec.tw).permute(
            0, 2, 1, 3).reshape(spec.height, spec.width)

    den_i = to_image(accs[3])
    den_safe = _maximum(den_i, 1e-8)
    mean_col = torch.stack([to_image(a) for a in accs[:3]], dim=-1) \
        / den_safe[..., None]
    if emit_normals:
        mean_n = torch.stack([to_image(a) for a in accs[6:9]], dim=-1) \
            / den_safe[..., None]
        # where-trick on the normalization: empty pixels have a zero
        # blended normal, and d|x|/dx at 0 would poison the gradients.
        n2 = torch.sum(mean_n * mean_n, dim=-1, keepdim=True)
        has_n = n2 > 1e-12
        nrm = torch.where(has_n, mean_n * torch.rsqrt(
            torch.where(has_n, n2, 1.0)), 0.0)
        rot = cam.view_matrix()[:3, :3]
        nz = nrm[..., 2:3]
        r_view = torch.cat([-2.0 * nz * nrm[..., 0:1],
                            -2.0 * nz * nrm[..., 1:2],
                            1.0 - 2.0 * nz * nz], dim=-1)
        coeffs = project_sh9(env_cube)
        env_n = eval_sh9(coeffs, nrm @ rot)
        env_r = eval_sh9(coeffs, r_view @ rot)
        lit = (mean_col * ((1.0 - env_diffuse) + env_diffuse * env_n)
               + env_specular * env_r)
        # Only where there is fluid: empty pixels keep the background.
        mean_col = torch.where(den_i[..., None] > 1e-8, lit, mean_col)
    alpha = 1.0 - torch.exp(-to_image(accs[4]))
    bg = (background.to(dtype=torch.float32, device=accs[0].device)
          if torch.is_tensor(background)
          else device_constant(background, accs[0].device,
                               "splat_tiled.background"))
    color = mean_col * alpha[..., None] + bg * (1.0 - alpha[..., None])
    mean_z = to_image(accs[5]) / den_safe + zmin
    return SplatImage(color=color, alpha=alpha, depth=mean_z)


def splat_particles_tiled(
    pos: torch.Tensor,
    radius,
    cam: Camera,
    width: int = 256,
    height: int = 256,
    background=(0.1, 0.1, 0.1),
    patch: int = 9,
    sharpness: float = 12.0,
    depth_falloff: float = 2.0,
    k: int = 2048,
    return_overflow: bool = False,
    env_cube: Optional[torch.Tensor] = None,
    env_diffuse: float = 0.75,
    env_specular: float = 0.35,
):
    """render/splat.splat_particles (normal shading) rasterized by tiles:
    the same image and gradients to positions and radius. `k` is the
    per-tile entry capacity; entries past it are dropped and counted
    (`return_overflow=True` returns the count as a 0-d tensor, to size k).

    `env_cube` lights the splats deferred: the rasterizer also emits a
    weighted-normal buffer, normalized per pixel, and the SH9 sky shades the
    blended normal (identical to the scatter path for isolated splats, a
    smooth approximation where splats overlap). Gradients reach the cube's
    texels."""
    spec = TileSpec(width=width, height=height, k=k, patch=patch)
    planes, _, overflow, zmin = tile_entries(pos, radius, cam, spec)
    accs = rasterize(planes, spec, sharpness, depth_falloff,
                     env_cube is not None)
    img = shade_tiles(accs, spec, zmin, cam, background, env_cube,
                      env_diffuse, env_specular)
    if return_overflow:
        return img, overflow
    return img
