"""Rendering: camera, splat rasterizers (eager scatter and tiled kernels), SH
environment lighting."""
