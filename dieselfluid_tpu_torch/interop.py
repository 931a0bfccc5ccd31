"""State carried across packages: numpy arrays <-> the port's tensors.

The "weights" of this system are its state and parameters. The JAX package
holds them as arrays that convert to numpy (`np.asarray`); these helpers take
such numpy arrays (float64 is cast to float32, slot indices to int64) and
give them back, so one numpy state feeds both packages and a JAX
DensePlaneState resumes in the port. Static configs (FluidParams, SimConfig,
DenseCellSpec) are rebuilt field for field from any object with the same
fields, a camera from its transform and scalars, PBR materials and a
scene's render arrays from numpy leaves, a neighbor table, a mesh and LSH
hyperplanes from theirs, a sharded SlabState and the slab specs (SlabSpec,
DenseSlabSpec, DenseSlab2DSpec) from theirs. Nothing here imports JAX: a JAX state is converted with `np.asarray`
on the caller's side.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from dieselfluid_tpu_torch.config import FluidParams, SimConfig
from dieselfluid_tpu_torch.geometry.mesh import Mesh
from dieselfluid_tpu_torch.models.materials import Materials
from dieselfluid_tpu_torch.models.particles import FluidState
from dieselfluid_tpu_torch.neighbors.types import Neighborhood
from dieselfluid_tpu_torch.ops.cellops import DenseCellSpec
from dieselfluid_tpu_torch.parallel.dense_halo import DenseSlabSpec
from dieselfluid_tpu_torch.parallel.dense_halo2d import DenseSlab2DSpec
from dieselfluid_tpu_torch.parallel.halo import SlabSpec, SlabState
from dieselfluid_tpu_torch.render.camera import Camera
from dieselfluid_tpu_torch.render.pbr import PBRMaterial
from dieselfluid_tpu_torch.solvers.dense_resident import DensePlaneState

_FLUID = ("pos", "vel", "force", "density", "pressure")


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def _opt_f32(a, device) -> Optional[torch.Tensor]:
    return None if a is None else _f32(a, device)


def _np(t: Optional[torch.Tensor]):
    return None if t is None else t.detach().cpu().numpy()


def fluid_state_from_numpy(pos, vel, force, density, pressure,
                           boundary_pos=None, *, device) -> FluidState:
    """FluidState on `device` from numpy-convertible arrays."""
    return FluidState(pos=_f32(pos, device), vel=_f32(vel, device),
                      force=_f32(force, device),
                      density=_f32(density, device),
                      pressure=_f32(pressure, device),
                      boundary_pos=_opt_f32(boundary_pos, device))


def fluid_state_to_numpy(state: FluidState) -> Dict[str, np.ndarray]:
    """{pos, vel, force, density, pressure, boundary_pos} as numpy."""
    out = {f: _np(getattr(state, f)) for f in _FLUID}
    out["boundary_pos"] = _np(state.boundary_pos)
    return out


def plane_state_from_numpy(planes: Dict[str, np.ndarray], bnd, ref_x, ref_y,
                           ref_z, flat, valid, fb_pos, fb_vel,
                           boundary_pos, overflow, rebuilds, age_total, *,
                           device) -> DensePlaneState:
    """DensePlaneState on `device` from numpy-convertible arrays (the JAX
    DensePlaneState's fields, in order)."""
    counters = [torch.from_numpy(np.array(c, dtype=np.int32)).to(device)
                for c in (overflow, rebuilds, age_total)]
    return DensePlaneState(
        planes={n: _f32(p, device) for n, p in planes.items()},
        bnd=_f32(bnd, device), ref_x=_f32(ref_x, device),
        ref_y=_f32(ref_y, device), ref_z=_f32(ref_z, device),
        flat=torch.from_numpy(np.array(flat, dtype=np.int64)).to(device),
        valid=torch.from_numpy(np.array(valid, dtype=bool)).to(device),
        fb_pos=_f32(fb_pos, device), fb_vel=_f32(fb_vel, device),
        boundary_pos=_opt_f32(boundary_pos, device),
        overflow=counters[0], rebuilds=counters[1], age_total=counters[2])


def plane_state_to_numpy(ps: DensePlaneState) -> Dict[str, object]:
    """The DensePlaneState's fields as numpy (planes as a dict), in the
    order plane_state_from_numpy takes them."""
    out = {f: _np(getattr(ps, f)) for f in DensePlaneState._fields
           if f != "planes"}
    out["planes"] = {n: _np(p) for n, p in ps.planes.items()}
    return out


def _same_fields(cls, obj):
    return cls(**{f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(cls)})


def cell_spec_from_jax(spec) -> DenseCellSpec:
    """The port's DenseCellSpec from any object with the JAX
    DenseCellSpec's fields (nx, ny, nz, capacity, cell, lo)."""
    return _same_fields(DenseCellSpec, spec)


def fluid_params_from(obj) -> FluidParams:
    """The port's FluidParams from any object with its fields (the JAX
    package's FluidParams, for one)."""
    return _same_fields(FluidParams, obj)


def sim_config_from(obj) -> SimConfig:
    """The port's SimConfig from any object with its fields."""
    return _same_fields(SimConfig, obj)


def materials_from_numpy(mu, d0, tait_gamma, tait_w, mass, *, device,
                         requires_grad: bool = False) -> Materials:
    """Materials of 0-d float32 tensors on `device` from numpy-convertible
    scalars (a JAX Materials' fields through `np.asarray`), each a leaf that
    requires grad when `requires_grad`."""
    def f(x):
        return torch.tensor(float(np.asarray(x, np.float32)),
                            dtype=torch.float32, device=device,
                            requires_grad=requires_grad)

    return Materials(mu=f(mu), d0=f(d0), tait_gamma=f(tait_gamma),
                     tait_w=f(tait_w), mass=f(mass))


def camera_from_numpy(transform, fov_deg, aspect, near, far, exposure, *,
                      device) -> Camera:
    """The port's Camera on `device` from a (4, 4) numpy-convertible
    camera-to-world transform (a JAX Camera's `np.asarray(cam.transform)`)
    and its static scalars."""
    return Camera(transform=_f32(transform, device), fov_deg=float(fov_deg),
                  aspect=float(aspect), near=float(near), far=float(far),
                  exposure=float(exposure))


def pbr_materials_from_numpy(base_color, metallic, roughness, fresnel_rim,
                             *, device,
                             requires_grad: bool = False) -> PBRMaterial:
    """A stacked PBRMaterial on `device` from numpy-convertible leaves
    (base_color (M, 3), the others (M,); a JAX PBRMaterial's fields through
    `np.asarray`), each a float32 leaf that requires grad when
    `requires_grad`."""
    def f(x):
        return _f32(x, device).requires_grad_(requires_grad)

    return PBRMaterial(base_color=f(base_color), metallic=f(metallic),
                       roughness=f(roughness), fresnel_rim=f(fresnel_rim))


def scene_arrays_from_numpy(tris, tri_normals, tri_materials, tri_uvs=None,
                            textures=None, mat_base_tex=None,
                            mat_normal_tex=None, *,
                            device) -> Dict[str, Optional[torch.Tensor]]:
    """A scene's render arrays on `device`, keyed as render_scene and
    render_composite take them: tris (T, 3, 3), tri_normals (T, 3) and
    tri_uvs (T, 3, 2), textures (K, S, S, 3) as float32; tri_materials and
    the per-material texture indices as int64. From numpy-convertible
    arrays (either package's Scene through `np.asarray`); None stays None."""
    def idx(a):
        return None if a is None else torch.from_numpy(
            np.array(a, dtype=np.int64)).to(device)

    return {"tris": _f32(tris, device),
            "tri_normals": _f32(tri_normals, device),
            "tri_materials": idx(tri_materials),
            "tri_uvs": _opt_f32(tri_uvs, device),
            "textures": _opt_f32(textures, device),
            "mat_base_tex": idx(mat_base_tex),
            "mat_normal_tex": idx(mat_normal_tex)}


def neighborhood_from_numpy(idx, mask, *, device) -> Neighborhood:
    """A Neighborhood on `device` from numpy-convertible (N, K) slot
    indices (int64) and mask (float32): a JAX Neighborhood's fields through
    `np.asarray`."""
    return Neighborhood(
        idx=torch.from_numpy(np.array(idx, dtype=np.int64)).to(device),
        mask=_f32(mask, device))


def mesh_from_numpy(tris, normals, *, device) -> Mesh:
    """A Mesh on `device` from numpy-convertible (T, 3, 3) triangles and
    (T, 3) normals (a JAX Mesh's fields through `np.asarray`), taken as
    they are (no re-orientation)."""
    return Mesh(tris=_f32(tris, device), normals=_f32(normals, device))


def lsh_vectors_from_numpy(vectors, *, device) -> torch.Tensor:
    """(hash_bits, 3) float32 LSH hyperplanes on `device` from numpy (the
    JAX package's `hash_vectors(key, spec)` through `np.asarray`, whose
    jax.random bits the port cannot draw)."""
    return _f32(vectors, device).reshape(-1, 3)


def slab_spec_from(obj) -> SlabSpec:
    """The port's SlabSpec from any object with its fields."""
    return _same_fields(SlabSpec, obj)


def dense_slab_spec_from(obj) -> DenseSlabSpec:
    """The port's DenseSlabSpec from any object with its fields."""
    return _same_fields(DenseSlabSpec, obj)


def dense_slab2d_spec_from(obj) -> DenseSlab2DSpec:
    """The port's DenseSlab2DSpec from any object with its fields."""
    return _same_fields(DenseSlab2DSpec, obj)


def slab_state_from_numpy(pos, vel, alive, dropped, pressure=None,
                          boundary_pos=None, boundary_mask=None, *,
                          device) -> SlabState:
    """A SlabState on `device` from numpy-convertible arrays (a JAX
    SlabState's fields through `np.asarray`, every shard's store)."""
    return SlabState(pos=_f32(pos, device), vel=_f32(vel, device),
                     alive=_f32(alive, device), dropped=_f32(dropped, device),
                     pressure=_opt_f32(pressure, device),
                     boundary_pos=_opt_f32(boundary_pos, device),
                     boundary_mask=_opt_f32(boundary_mask, device))
