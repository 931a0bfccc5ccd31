"""Tile-sharded differentiable rendering over the mesh.

Counterpart of dieselfluid_tpu/parallel/render_shard.py: the image's rows
are sharded over a mesh axis; every shard renders the whole (replicated or
all-gathered) particle set into its own row tile with render/splat.py's
eager `splat_particles` in tile mode. The weighted-blended composite is a
per-pixel function of per-tile scatters, so the tiled image IS the
one-device image, and the position gradients sum over the tiles (autograd
on a LocalMesh, the all_gather's transpose on a DistMesh).
"""

from __future__ import annotations

from typing import Optional

import torch

from dieselfluid_tpu_torch.parallel.mesh import AXIS
from dieselfluid_tpu_torch.render.camera import Camera
from dieselfluid_tpu_torch.render.splat import SplatImage, splat_particles


def make_tiled_splat(mesh, width: int, height: int, n_particles: int,
                     patch: int = 9, axis: str = AXIS,
                     gather_axis: bool = False, **splat_kw):
    """render(pos, radius, cam, colors=None) -> SplatImage of the process's
    row tiles, top to bottom (a LocalMesh's: the whole image). With
    gather_axis=True, `pos` (and `colors`) hold the process's particle
    rows, all-gathered over `axis` first (the slab-decomposed solver's
    output feeding the renderer); otherwise they are replicated."""
    n_dev = mesh.axis_size(axis)
    if height % n_dev:
        raise ValueError(f"height {height} does not divide over {n_dev} "
                         "tiles")
    tile_h = height // n_dev

    def render(pos: torch.Tensor, radius, cam: Camera,
               colors: Optional[torch.Tensor] = None) -> SplatImage:
        held = len(mesh.shards)
        if gather_axis:
            pos_l = mesh.all_gather(mesh.split(pos), axis)
            col_l = ([None] * held if colors is None
                     else mesh.all_gather(mesh.split(colors), axis))
        else:
            pos_l, col_l = [pos] * held, [colors] * held
        imgs = [splat_particles(p, radius, cam, width=width, height=tile_h,
                                colors=c, patch=patch, full_height=height,
                                y_offset=me * tile_h, **splat_kw)
                for p, c, me in zip(pos_l, col_l, mesh.axis_index(axis))]
        return SplatImage(*[mesh.join([getattr(i, f) for i in imgs])
                            for f in SplatImage._fields])

    return render
