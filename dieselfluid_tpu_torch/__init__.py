"""dieselfluid_tpu_torch — the PyTorch/CUDA port of dieselfluid_tpu.

The JAX package `dieselfluid_tpu` stays the reference; this package keeps its
module paths so each counterpart is found by name:

  config.py               FluidParams / SimConfig (the port's own copy)
  ops/smoothing.py        kernel coefficients, smoothing kernels, Tait EOS
  ops/cellops.py          dense (rows, sub, 128) cell planes: binning, scatter, gather
  ops/sph_sweep.py        the stencil sweeps, their backward sweeps and the active-gated
                          sweeps as autograd Functions (CUDA kernels + plain torch)
  csrc/sph_sweep.cu       the hand-written sm_90a sweep kernel
  csrc/splat_raster.cu    the hand-written sm_90a tile rasterizer, forward and backward
  geometry/               lattice grids, triangles, meshes and the mesh collider, octree paths
  models/materials.py     Materials: traced material parameters (0-d tensors)
  models/particles.py     FluidState, the dam-break initial state, AoS views
  models/field.py         SPH field operators over fixed-degree neighborhoods
  models/sph.py           Simulation facade (neighbors "cellgrid", "bruteforce", "dense")
  neighbors/              brute force, the sorted cell grid, LSH, rest-density calibration
  solvers/                integrator, WCSPH and PCISPH on neighbor lists (with the
                          reference-parity steps), per-step and plane-resident dense solvers
  mathx/                  quaternions, 4x4 transforms, spherical coordinates, rays
  render/camera.py        pinhole Camera
  render/splat.py         eager scatter splat renderer (the tiled path's oracle)
  render/splat_tiled.py   tile binning and the tile rasterizer as an autograd Function
                          (CUDA kernels + plain torch); counterpart of splat_pallas.py
  render/sh.py, cubemap.py  SH9 environment lighting, cubemap sampling and directions
  render/light.py, spectrum.py  light sources, spectra and the solar SPD
  render/texture.py, pbr.py     bilinear textures, Cook-Torrance shading
  render/raytrace.py      ray-traced triangle scenes (plain torch, whole-frame)
  render/gltf.py, scene.py      glTF import/export (numpy), scene -> render tensors
  render/composite.py     fluid splats depth-composited over the ray-traced scene
  sky/                    the atmosphere's single-scattering sky and its cubemap bake
  interop.py              numpy <-> torch state, config, materials and scene arrays
  io/                     checkpoints (torch.save), npz/PLY/DFC export, the native framepack
                          writer, 1D sample-set JSON
  utils/                  health checks, rollback and dt backoff (GuardedRunner), step
                          timers and traces, the simulation logger
  app/cli.py, serve.py    the batch CLI (python -m dieselfluid_tpu_torch.app.cli) and the viewer server
  examples/               twins of examples/dam_break.py and examples/fit_material.py

Every tensor is float32 (slot indices int64) and every state constructor takes
an explicit `device=`. The package imports `torch` and never `jax`.
"""

__version__ = "0.1.0"

from dieselfluid_tpu_torch.config import FluidParams, SimConfig  # noqa: F401
