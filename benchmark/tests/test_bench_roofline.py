"""The frozen operation and byte counts on a small plane against hand
counts."""

from types import SimpleNamespace

import pytest
import torch

import frozen


def spec(nx=3, ny=3, nz=8, cap=16):
    sub = (nz + 128 // cap - 1) // (128 // cap) + 2
    px, py = nx + 2, ny + 2
    return SimpleNamespace(nx=nx, ny=ny, nz=nz, capacity=cap, px=px, py=py,
                           row_len=sub * 128, size=px * py * sub * 128)


def plane(sp, occupied):
    """A mask plane with `n` slots filled in each listed cell (i, j, k) of
    the interior (ghost ring and ghost z-block skipped)."""
    m = torch.zeros(sp.px, sp.py, sp.row_len // sp.capacity, sp.capacity)
    zb = 128 // sp.capacity
    for (i, j, k), n in occupied.items():
        m[i + 1, j + 1, k + zb, :n] = 1.0
    return m.reshape(-1, sp.row_len // 128, 128)


def test_candidate_pairs_hand_count():
    sp = spec()
    # Cells a (0,0,0) with 2, b (0,0,1) with 1 (a's neighbour), c (2,2,5)
    # with 3 (nobody's neighbour): a sees 2+1, b sees 2+1, c sees 3.
    m = plane(sp, {(0, 0, 0): 2, (0, 0, 1): 1, (2, 2, 5): 3})
    assert frozen.candidate_pairs(m, sp) == 2 * 3 + 1 * 3 + 3 * 3


def test_candidate_pairs_brute_force():
    sp = spec(4, 3, 9)
    g = torch.Generator().manual_seed(3)
    occ = {(i, j, k): int(torch.randint(0, 4, (1,), generator=g))
           for i in range(4) for j in range(3) for k in range(9)}
    m = plane(sp, occ)
    want = sum(n * sum(occ.get((i + a, j + b, k + c), 0)
                       for a in (-1, 0, 1) for b in (-1, 0, 1)
                       for c in (-1, 0, 1))
               for (i, j, k), n in occ.items())
    assert frozen.candidate_pairs(m, sp) == want


def test_kernel_bounds_hand_count():
    sp = spec()
    m = plane(sp, {(0, 0, 0): 2, (0, 0, 1): 1, (2, 2, 5): 3})
    b = frozen.kernel_bounds({"mask": m}, sp)
    pairs, plane_b = 18, sp.size * 4
    blocks = 2                       # (0,0,*) and (2,2,*) rows, one block each
    by_bytes = (2 * plane_b + 3 * blocks * 512) / frozen.HBM_BYTES_PER_S
    by_ops = pairs * 16 / frozen.FP32_OPS_PER_S
    assert b["density"] == pytest.approx(max(by_bytes, by_ops) * 1e3)
    by_bytes = (4 * plane_b + 8 * blocks * 512) / frozen.HBM_BYTES_PER_S
    assert b["force"] == pytest.approx(
        max(by_bytes, pairs * 44 / frozen.FP32_OPS_PER_S) * 1e3)
    assert set(b) == set(frozen.SWEEP_CHANNELS)


def test_raster_bounds_hand_count():
    sp = SimpleNamespace(patch=3, tw=4, th=4, n_tiles=2, k=128)
    r = torch.zeros(2, 128)
    u = torch.zeros(2, 128)
    v = torch.zeros(2, 128)
    # Two live slots in tile row 0: one in the middle (3 x 3 pixels of its
    # patch inside the tile), one at the corner (2 x 2 inside).
    r[0, 0], u[0, 0], v[0, 0] = 1.0, 1.5, 2.2
    r[0, 1], u[0, 1], v[0, 1] = 0.8, 0.2, 0.4
    b = frozen.raster_bounds({"r": r, "u": u, "v": v}, sp)
    pairs = 9 + 4
    slot_in = 4 * 1 * 128 * 4
    tile = 2 * 4 * 4 * 4
    by_bytes = (slot_in + 6 * tile) / frozen.HBM_BYTES_PER_S
    assert b["splat_fwd"] == pytest.approx(
        max(by_bytes, pairs * 44 / frozen.FP32_OPS_PER_S) * 1e3)
    by_bytes = (slot_in + 6 * tile + 4 * 2 * 128 * 4) / frozen.HBM_BYTES_PER_S
    assert b["splat_bwd"] == pytest.approx(
        max(by_bytes, pairs * 104 / frozen.FP32_OPS_PER_S) * 1e3)
