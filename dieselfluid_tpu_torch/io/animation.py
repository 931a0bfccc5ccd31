"""Fluid animation export (counterpart of dieselfluid_tpu/io/animation.py).

Formats, byte for byte those of the JAX package, so one viewer and one
reader serve both:
  * .npz particle trajectories (positions over time + JSON metadata);
  * .ply per-frame point clouds (binary little-endian);
  * .mp4/.gif rendered frame sequences through imageio (when a renderer
    is given).

Tensors are copied to the host (`.cpu()`) before they become numpy arrays.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class AnimationWriter:
    """Accumulates frames and writes trajectory / point-cloud / video files."""

    def __init__(self, out_dir: str, name: str = "fluid"):
        self.out_dir = os.path.abspath(out_dir)
        self.name = name
        self.frames: List[np.ndarray] = []
        self.images: List[np.ndarray] = []
        os.makedirs(self.out_dir, exist_ok=True)

    def add_frame(self, positions, image=None):
        self.frames.append(np.asarray(_host(positions), np.float32))
        if image is not None:
            img = _host(image)
            self.images.append((np.clip(img, 0, 1) * 255).astype(np.uint8))

    def write_npz(self, metadata: Optional[dict] = None) -> str:
        path = os.path.join(self.out_dir, f"{self.name}.npz")
        np.savez_compressed(
            path,
            positions=np.stack(self.frames),
            metadata=json.dumps(metadata or {}),
        )
        return path

    def write_ply_sequence(self) -> List[str]:
        """Numbered PLY point clouds, through the native framepack library
        when it is available (identical output)."""
        from dieselfluid_tpu_torch.io import native

        if self.frames and all(f.shape == self.frames[0].shape
                               for f in self.frames):
            n = native.write_ply_sequence(self.out_dir, self.name,
                                          np.stack(self.frames))
            return [os.path.join(self.out_dir, f"{self.name}_{i:05d}.ply")
                    for i in range(n)]
        paths = []
        for i, frame in enumerate(self.frames):
            p = os.path.join(self.out_dir, f"{self.name}_{i:05d}.ply")
            write_ply(p, frame)
            paths.append(p)
        return paths

    def write_dfc(self) -> str:
        """Packed binary trajectory cache (the DFC format)."""
        from dieselfluid_tpu_torch.io import native

        path = os.path.join(self.out_dir, f"{self.name}.dfc")
        native.write_dfc(path, np.stack(self.frames))
        return path

    def write_video(self, fps: int = 30, fmt: str = "mp4") -> Optional[str]:
        if not self.images:
            return None
        import imageio.v2 as imageio

        path = os.path.join(self.out_dir, f"{self.name}.{fmt}")
        if fmt != "gif":
            try:
                imageio.mimwrite(path, self.images, fps=fps)
                return path
            except (ValueError, ImportError):
                # No ffmpeg/pyav backend installed: fall back to a GIF.
                path = os.path.join(self.out_dir, f"{self.name}.gif")
        imageio.mimwrite(path, self.images, duration=1000.0 / fps)
        return path


def write_ply(path: str, positions) -> None:
    """Binary little-endian PLY point cloud."""
    positions = np.asarray(_host(positions), np.float32)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(positions)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(positions.astype("<f4").tobytes())


def read_ply(path: str) -> np.ndarray:
    """Read back a PLY written by write_ply."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode("ascii")
    n = int([ln for ln in header.splitlines()
             if ln.startswith("element vertex")][0].split()[-1])
    return np.frombuffer(data[head_end:head_end + n * 12],
                         "<f4").reshape(n, 3).copy()
