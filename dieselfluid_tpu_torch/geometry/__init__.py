"""Geometry: lattice grids, triangles, meshes and colliders, octree
encoding."""

from dieselfluid_tpu_torch.geometry.grid import Grid  # noqa: F401
