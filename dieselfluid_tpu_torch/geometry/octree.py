"""Octal-tree point classifier: octant-path encoding.

Counterpart of dieselfluid_tpu/geometry/octree.py (ref: geom/octal.go): each
point becomes a (depth, 3) uint8 octant path, one x/y/z bit triplet per
level (bit 1 when the coordinate exceeds the running centroid, which moves
by +-bounds/2^(level+1) each level). `encode_points` runs on the points'
device, a Python loop over the levels in place of the JAX `lax.scan`; the
helpers and `OctalTree` (the reference's map API) are host-side numpy, the
port's own copy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch


def encode_points(points, bounds, origin=(0.0, 0.0, 0.0), depth: int = 6, *,
                  device=None) -> torch.Tensor:
    """(N, depth, 3) uint8 octant paths (ref: octal.go EncodePoint:82-113),
    on the points' device (or `device` for array input)."""
    points = torch.as_tensor(points, dtype=torch.float32, device=device)
    dev = points.device
    bounds = torch.as_tensor(bounds, dtype=torch.float32, device=dev)
    centroid = torch.as_tensor(origin, dtype=torch.float32,
                               device=dev).expand(points.shape)
    bits = []
    for i in range(depth):
        bit = points > centroid
        shift = (bounds / (2.0 ** (i + 1.0)))[None, :] * 2.0
        centroid = centroid + torch.where(bit, 0.5, -0.5) * shift
        bits.append(bit.to(torch.uint8))
    return torch.stack(bits, dim=1)


def depth_similarity(a, b) -> int:
    """Shared-prefix depth of two encodings (ref: octal.go
    DepthSimilarity:157-186)."""
    a = np.asarray(a).reshape(-1, 3)
    b = np.asarray(b).reshape(-1, 3)
    d = min(len(a), len(b))
    for i in range(d):
        if not np.array_equal(a[i], b[i]):
            return i
    return d


def group_encoding(encodings) -> np.ndarray:
    """Longest common octant prefix of a point group (ref: octal.go
    EncodePointGroup:115-155)."""
    enc = np.asarray(encodings)
    out_depth = 0
    for i in range(enc.shape[1]):
        if np.all(enc[:, i, :] == enc[0, i, :]):
            out_depth = i + 1
        else:
            break
    return enc[0, :out_depth, :]


def centroid_of(encoding, bounds, origin=(0.0, 0.0, 0.0)) -> np.ndarray:
    """The cell centroid of an octant path (ref: octal.go
    GetCentroid:24-40)."""
    c = np.asarray(origin, np.float64).copy()
    b = np.asarray(bounds, np.float64).copy()
    for bit in np.asarray(encoding).reshape(-1, 3):
        c += (bit.astype(np.float64) - 0.5) * b
        b /= 2.0
    return c.astype(np.float32)


@dataclasses.dataclass
class OctalTree:
    """Host-side classifier with the reference's map API (ref: octal.go
    OctalTree{Bounds, Origin, MaxDepth, Map}); keys are the bytes of the
    flattened path."""

    bounds: Tuple[float, float, float]
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    max_depth: int = 6

    def __post_init__(self):
        self.table: Dict[bytes, List[int]] = {}

    def _key(self, encoding) -> bytes:
        return bytes(np.asarray(encoding, np.uint8).ravel().tolist())

    def insert_points(self, points, ids=None):
        """Encode every point at once, bin on the host."""
        enc = encode_points(points, self.bounds, self.origin,
                            self.max_depth).cpu().numpy()
        ids = range(len(enc)) if ids is None else ids
        for e, i in zip(enc, ids):
            self.table.setdefault(self._key(e), []).append(int(i))

    def remove_point(self, encoding, unique_id: int):
        lst = self.table.get(self._key(encoding), [])
        if unique_id in lst:
            lst.remove(unique_id)

    def parent_key(self, encoding) -> bytes:
        e = np.asarray(encoding, np.uint8).reshape(-1, 3)
        return self._key(e[:-1]) if len(e) >= 1 else self._key(e)

    def neighbors(self, encoding) -> List[int]:
        """Cell-mates, then parent-cell-mates (ref: octal.go
        GetNeighbors:52-57)."""
        return (list(self.table.get(self._key(encoding), []))
                + list(self.table.get(self.parent_key(encoding), [])))
