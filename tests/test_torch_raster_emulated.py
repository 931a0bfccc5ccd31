"""The tile rasterizer's forward kernel K11, csrc/splat_raster.cu, compiled
for the CPU by g++ against the CUDA emulation in tests/cuda_emu/ (as
tests/test_torch_sweep_emulated.py compiles the sweeps), with the old
forward body appended as the oracle (tests/cuda_emu/splat_fwd_tile.h:
splat_fwd_tile_kernel, one 1024-thread CTA per tile testing every slot of
every occupied chunk).

This runs K11's bookkeeping on the CPU: the strip split of each tile across
CTAs, the walk of the tile's occupied prefix that stops at the first chunk
whose first slot is empty, the per-warp slot lists built by ballots over a
chunk and walked in ascending slot order, and the per-lane box test. On an
empty frame, one tile filled to k, boxes that straddle strip and tile edges
(patch 3 and 9) and a seeded 256x144 frame binned by bin_tile_entries, in
both output forms (6 and 9), K11 must write every pixel, give the oracle's
sums bit for bit and stay within RASTER_REL_TOL of the plain torch version.
The arithmetic is the host's (rsqrtf is 1 / sqrtf here), so the rounding on
the card is the card-only tests' and chip_smoke.py's to check.
"""

import ctypes

import numpy as np
import pytest
import torch

from dieselfluid_tpu_torch.render import splat_tiled as st
from dieselfluid_tpu_torch.render.camera import Camera
from test_torch_sweep_emulated import ROOT, compile_emulated, emulated_source

torch.set_num_threads(1)

SHARPNESS, FALLOFF = 12.0, 2.0


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The rasterizer library with the oracle's launchers: K11, K12 and the
    oracle, one kernel launch each."""
    src = ROOT / "dieselfluid_tpu_torch" / "csrc" / "splat_raster.cu"
    shim = ROOT / "tests" / "cuda_emu" / "splat_fwd_tile.h"
    return compile_emulated(emulated_source(src.read_text(), shim.read_text(),
                                            3, smem=()),
                            tmp_path_factory.mktemp("raster_emu"),
                            "raster_emu")


def _fwd(lib, sym, planes, spec):
    """The 6 or 9 accumulator tile planes of launcher `sym`, allocated as
    NaN (every element must be written)."""
    fn = getattr(lib, sym)
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    n_out = 9 if sym.endswith("9") else 6
    outs = [torch.full(spec.tile_shape, float("nan")) for _ in range(n_out)]
    ins = [planes[c].contiguous() for c in st.CHANNELS]
    in_ptrs = (ctypes.c_void_p * 4)(*[p.data_ptr() for p in ins])
    out_ptrs = (ctypes.c_void_p * n_out)(*[o.data_ptr() for o in outs])
    assert fn(in_ptrs, out_ptrs, spec.n_tiles, spec.k, spec.patch // 2,
              SHARPNESS, FALLOFF, None) == 0
    return outs


def _tile_planes(spec, tiles, seed, u_of):
    """Slot planes with `tiles[t]` entries at the first ranks of tile t:
    u from u_of(rng, n), v in [-half, 8 + half), z in [0, 1), r in [0.75,
    patch / 2]; every other slot 0."""
    rng = np.random.default_rng(seed)
    half = spec.patch // 2
    planes = {c: np.zeros((spec.n_tiles, spec.k), np.float32)
              for c in st.CHANNELS}
    for t, n in tiles.items():
        planes["u"][t, :n] = u_of(rng, n)
        planes["v"][t, :n] = rng.uniform(-half, 8 + half, n)
        planes["z"][t, :n] = rng.uniform(0.0, 1.0, n)
        planes["r"][t, :n] = rng.uniform(0.75, max(0.75, spec.patch / 2), n)
    return {c: torch.from_numpy(p).view(spec.plane_shape)
            for c, p in planes.items()}


def _straddling(rng, n):
    """Centers within 1.5 pixels of a 32-column strip edge or of a tile
    edge (the box reaches over it), and past the tile's edges."""
    edges = np.array([0.0, 32.0, 64.0, 96.0, 128.0])
    return (rng.choice(edges, n) + rng.uniform(-1.5, 1.5, n)).astype(
        np.float32)


def _frame():
    """A 256x144 frame (k = 512) of 3000 seeded splats binned by
    bin_tile_entries through tile_entries."""
    rng = np.random.default_rng(12)
    pos = torch.from_numpy(rng.uniform(-0.6, 0.6, (3000, 3)).astype(
        np.float32))
    cam = Camera.at((0.0, 0.0, -2.0), front=(0.0, 0.0, 1.0), fov_deg=60.0,
                    aspect=256 / 144, device=torch.device("cpu"))
    spec = st.TileSpec(256, 144, k=512)
    planes, _, ovf, _ = st.tile_entries(pos, 0.02, cam, spec)
    assert int(ovf) == 0
    occ = (planes["r"] >= 0.5).view(spec.n_tiles, -1).sum(-1)
    assert int(occ.max()) > 128           # a tile spans several chunks
    return spec, planes


def _case(name, patch):
    if name == "frame":
        return _frame()
    spec = st.TileSpec(256, 16, k=256, patch=patch)
    if name == "empty":
        return spec, _tile_planes(spec, {}, 0, None)
    if name == "full_tile":
        return spec, _tile_planes(spec, {1: spec.k}, 1, lambda rng, n:
                                  rng.uniform(-4.5, 132.5, n))
    return spec, _tile_planes(spec, {0: 150, 2: 40, 3: 129}, 2, _straddling)


CASES = [("empty", 9), ("full_tile", 9), ("full_tile", 3),
         ("straddle", 9), ("straddle", 3), ("frame", 9)]


@pytest.mark.parametrize("n_out", [6, 9])
@pytest.mark.parametrize("name,patch", CASES)
def test_strip_split_k11_equals_tile_body_and_plain(lib, name, patch, n_out):
    spec, planes = _case(name, patch)
    got = _fwd(lib, f"dft_splat_fwd{n_out}", planes, spec)
    want = _fwd(lib, f"emu_tile_fwd{n_out}", planes, spec)
    plain = st.plain.rasterize_fwd(planes, spec, SHARPNESS, FALLOFF,
                                   n_out == 9)
    for o, (g, w, p) in enumerate(zip(got, want, plain)):
        assert bool(torch.isfinite(g).all()), o
        assert torch.equal(g, w), o
        scale = float(p.abs().max())
        assert float((g - p).abs().max()) <= st.RASTER_REL_TOL * max(
            scale, 1e-30), o
    assert bool(got[4].any()) == (name != "empty")
