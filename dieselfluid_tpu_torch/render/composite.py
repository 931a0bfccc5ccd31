"""Depth-composited frame: fluid splats over a ray-traced scene + sky.

Counterpart of dieselfluid_tpu/render/composite.py, the reference's canonical
output: one frame with the glTF meshes and the particle pass together (ref:
render/rendersystem_darwin.go Run:545-561 draws meshes, then the particle
program into the same framebuffer). Built from the two differentiable
renderers:

  * render/raytrace.py renders the scene (PBR + textures + the sky on a
    miss) with per-pixel ray depth;
  * render/splat_tiled.py (the card's tile rasterizer, K11/K12) or
    render/splat.py (the eager scatter form) renders the fluid, with
    weighted-blended coverage and a weighted mean depth;
  * composite_images merges them with a SOFT depth test (linear in
    view-z, clipped), so the frame stays differentiable in the particle
    positions, the materials, the lights and the camera.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dieselfluid_tpu_torch.render.camera import Camera
from dieselfluid_tpu_torch.render.raytrace import RayImage, render_scene
from dieselfluid_tpu_torch.render.splat import SplatImage, _clip, \
    splat_particles

_FAR = 1.0e6


class CompositeImage(NamedTuple):
    color: torch.Tensor        # (H, W, 3)
    fluid_alpha: torch.Tensor  # (H, W) fluid coverage after the depth test
    scene: RayImage
    fluid: SplatImage


def composite_images(fluid: SplatImage, scene: RayImage, cam: Camera,
                     dirs_z: torch.Tensor, softness: float = 0.05):
    """Merge a splat image over a ray image with a soft depth test.

    `dirs_z` is dot(ray_dir, camera_front) per pixel: it converts the ray
    renderer's along-ray t into the splat renderer's view-z metric."""
    z_scene = torch.where(scene.hit, scene.depth * dirs_z, _FAR)
    has_fluid = fluid.alpha > 1e-6
    z_fluid = torch.where(has_fluid, fluid.depth, _FAR)
    # Soft visibility: 1 where the fluid is clearly in front, 0 occluded.
    occl = torch.where(
        has_fluid, _clip((z_scene - z_fluid) / softness + 0.5, 0.0, 1.0),
        0.0)
    a = fluid.alpha * occl
    color = fluid.color * a[..., None] + scene.color * (1.0 - a[..., None])
    return color, a


def render_composite(
    pos: torch.Tensor,
    radius,
    cam: Camera,
    tris: torch.Tensor,
    tri_normals: torch.Tensor,
    tri_materials: torch.Tensor,
    materials,
    light_pos,
    light_color=(1.0, 1.0, 1.0),
    env_cube: Optional[torch.Tensor] = None,
    width: int = 256,
    height: int = 256,
    colors: Optional[torch.Tensor] = None,
    softness: float = 0.05,
    tri_uvs=None, textures=None, mat_base_tex=None, mat_normal_tex=None,
    tile: Optional[int] = None,
    splat_chunk: Optional[int] = None,
    tiled_splats_k: Optional[int] = None,
    scene_env_mode: str = "sh",
) -> CompositeImage:
    """One differentiable frame: fluid + glTF scene + sky environment.

    `tiled_splats_k` selects the tile rasterizer (K11/K12 on the card, with
    that per-tile capacity; entries past it are dropped, as in the JAX
    package), which shades the environment DEFERRED: the SH sky evaluated
    once on the blended per-pixel normal, whereas the eager path
    (`tiled_splats_k=None`) shades each splat sample and then blends. The
    two agree only where splats do not overlap.

    scene_env_mode="sh" (default): the scene pass evaluates the sky's SH9
    projection instead of per-pixel cubemap gathers; "cubemap" samples the
    texels."""
    scene = render_scene(
        tris, tri_normals, tri_materials, materials, cam,
        torch.as_tensor(light_pos, dtype=torch.float32, device=pos.device),
        light_color=light_color, env_cube=env_cube, width=width,
        height=height, tile=tile, tri_uvs=tri_uvs, textures=textures,
        mat_base_tex=mat_base_tex, mat_normal_tex=mat_normal_tex,
        env_mode=scene_env_mode)
    # The splat background is black with zero alpha: the composite
    # supplies the scene. The sky lights the fluid too.
    if tiled_splats_k is not None and colors is None:
        from dieselfluid_tpu_torch.render.splat_tiled import \
            splat_particles_tiled

        fluid = splat_particles_tiled(pos, radius, cam, width=width,
                                      height=height,
                                      background=(0.0, 0.0, 0.0),
                                      k=tiled_splats_k, env_cube=env_cube)
    else:
        fluid = splat_particles(pos, radius, cam, width=width, height=height,
                                colors=colors, background=(0.0, 0.0, 0.0),
                                env_cube=env_cube, chunk=splat_chunk)
    _, dirs = cam.pixel_rays(width, height)
    dirs_z = torch.sum(dirs * cam.front, dim=-1)
    color, a = composite_images(fluid, scene, cam, dirs_z, softness)
    return CompositeImage(color=color, fluid_alpha=a, scene=scene,
                          fluid=fluid)
