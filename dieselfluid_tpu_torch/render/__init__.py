"""Rendering: camera, splat rasterizers (eager scatter and tiled kernels), SH
environment lighting."""

from dieselfluid_tpu_torch.render.camera import Camera  # noqa: F401
