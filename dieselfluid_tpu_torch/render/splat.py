"""Differentiable sphere-splat renderer for particle fluids, the eager
scatter form.

Counterpart of dieselfluid_tpu/render/splat.py (ref: render/glr/
glr_darwin.go:481-491 DrawArrays(GL_POINTS) + the particle_fluid vert/frag
shaders):

  * particles project through the camera;
  * each splats a soft sphere footprint on the PATCH x PATCH pixels around
    its projected center;
  * per-pixel sphere normals come from the patch offset as in the fragment
    shader (z = sqrt(1 - x^2 - y^2), color = n * 0.5 + 0.5);
  * depth resolves by weighted-blended order-independent transparency
    (exp-falloff depth weights): no sort, no Z-buffer discontinuity.

Plain torch on any device (`index_add` scatters). It is the oracle the tiled
renderer (render/splat_tiled.py, the card's path) is tested against, as in
the JAX package. Gradients flow to positions, radii, colors and the
environment cubemap.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from dieselfluid_tpu_torch.render.camera import Camera
from dieselfluid_tpu_torch.render.sh import eval_sh9, project_sh9


class SplatImage(NamedTuple):
    color: torch.Tensor     # (H, W, 3) composited
    alpha: torch.Tensor     # (H, W) coverage
    depth: torch.Tensor     # (H, W) weighted mean depth


def _maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    """max(x, c) with jnp.maximum's half gradient at a tie. The bound is
    filled on x's device (a fill, not a copy from the host: no sync)."""
    return torch.maximum(x, x.new_full((), c))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip's value and gradient (half at a bound): torch.clamp's
    gradient at an exact bound differs."""
    return torch.minimum(_maximum(x, lo), x.new_full((), hi))


def focal_length(fov_deg: float, height: int) -> float:
    """(height / 2) / tan(fov / 2) in float32, the tangent correctly rounded
    (the JAX package's float32 value for the bench's fov)."""
    half = torch.deg2rad(torch.tensor(fov_deg, dtype=torch.float32)) / 2.0
    return float(np.float32(height / 2.0)
                 / np.float32(math.tan(float(half))))


def _project(cam: Camera, pos: torch.Tensor, width: int, height: int):
    """Particle positions -> pixel centers (u, v), view depth, and the focal
    length in pixels (a float32 0-d tensor, filled on the positions'
    device).

    The view transform sums its four products pairwise, (v0 x + v1 y) +
    (v2 z + v3), each rounded, as the JAX package's einsum does on the CPU:
    the pixel coordinates then agree bit for bit. (A matmul's other order
    moves u by ~2 ulps, which the splat gradient amplifies near the disc's
    rim; render/splat_tiled.py.)"""
    view = cam.view_matrix()
    p = [pos[:, c:c + 1] for c in range(3)]
    v = ((view[:3, 0] * p[0] + view[:3, 1] * p[1])
         + (view[:3, 2] * p[2] + view[:3, 3]))
    depth = v[:, 2]                                   # along +front
    fy = torch.full((), focal_length(cam.fov_deg, height),
                    dtype=torch.float32, device=pos.device)
    fx = fy
    safe_z = _maximum(depth, 1e-4)
    u = width / 2.0 + v[:, 0] / safe_z * fx
    vpix = height / 2.0 - v[:, 1] / safe_z * fy
    return u, vpix, depth, fy


def pixel_radius(radius: torch.Tensor, focal: torch.Tensor,
                 depth: torch.Tensor, patch: int) -> torch.Tensor:
    """Projected splat radius in pixels, clipped to [0.75, patch / 2]."""
    return _clip(radius * focal / _maximum(depth, 1e-3), 0.75, patch / 2.0)


def depth_min(depth: torch.Tensor, in_front: torch.Tensor) -> torch.Tensor:
    """Nearest in-front depth, the OIT weights' origin (torch.amin splits
    the gradient at a tie as jnp.min does)."""
    return torch.amin(torch.where(in_front, depth, torch.inf))


def _pixel_index(px: torch.Tensor, py: torch.Tensor, width: int,
                 height: int) -> torch.Tensor:
    """Each entry's flat pixel: its own inside the image (or tile), its
    unclamped flat index modulo the pixel count outside it. An outside
    entry adds exactly 0 wherever it lands (its w, a_src and w * cdepth are
    0, and shade * w is 0 because shade is finite), so it is spread over
    the pixels: clamped, the ~3/4 of a tile's entries that fall outside
    would pile their zero adds onto the tile's two border rows."""
    return (py.to(torch.int64) * width + px.to(torch.int64)) % (width
                                                                * height)


def splat_particles(
    pos: torch.Tensor,                     # (N, 3) world positions
    radius,                                # scalar or (N,) world radii
    cam: Camera,
    width: int = 256,
    height: int = 256,
    colors: Optional[torch.Tensor] = None,  # (N, 3); None: normal shading
    background=(0.1, 0.1, 0.1),
    patch: int = 9,
    sharpness: float = 12.0,
    depth_falloff: float = 2.0,
    env_cube: Optional[torch.Tensor] = None,  # (6, S, S, 3) environment
    env_diffuse: float = 0.75,
    env_specular: float = 0.35,
    chunk: Optional[int] = None,             # particles per scatter block
    full_height: Optional[int] = None,
    y_offset=0,
) -> SplatImage:
    """Rasterize particles as soft spheres. Fully differentiable.

    Tile mode (parallel/render_shard.py): `height` is the tile's height,
    `full_height` the whole image's and `y_offset` the tile's first row.
    The projection uses the whole image; the scatter lands in the tile.

    `env_cube` lights each sample: its fake sphere normal, rotated to world
    space, and the view reflection look up the cubemap's SH9 projection.
    `chunk` scatters the particles in blocks, each
    recomputed in the backward pass (torch.utils.checkpoint), so memory is
    O(chunk * patch^2) rather than O(N * patch^2)."""
    n = pos.shape[0]
    dev = pos.device
    radius = torch.broadcast_to(
        torch.as_tensor(radius, dtype=torch.float32, device=dev), (n,))
    u, v, depth, focal = _project(cam, pos, width, full_height or height)
    v = v - y_offset
    in_front = depth > 1e-3
    pix_r = pixel_radius(radius, focal, depth, patch)
    zmin = depth_min(depth, in_front)
    half = patch // 2
    offs = torch.arange(patch, dtype=torch.float32, device=dev) - half
    dy, dx = torch.meshgrid(offs, offs, indexing="ij")
    dx, dy = dx.reshape(1, -1), dy.reshape(1, -1)
    if env_cube is not None:
        sh_coeffs = project_sh9(env_cube)
        rot = cam.view_matrix()[:3, :3]

    def accumulate(num, den, acc_a, acc_z, cu, cv, cdepth, cr, col=None):
        """Scatter one block's splats into the image accumulators; the
        (B, P^2) intermediates live only in here."""
        px = torch.floor(cu)[:, None] + dx                    # (B, P^2)
        py = torch.floor(cv)[:, None] + dy
        ox = (px + 0.5 - cu[:, None]) / cr[:, None]
        oy = (py + 0.5 - cv[:, None]) / cr[:, None]
        r2 = ox * ox + oy * oy
        coverage = torch.sigmoid(sharpness * (1.0 - r2))       # soft disc
        # Sphere-normal shading; where-trick on the sqrt operand (sqrt'(0)
        # would leak NaN gradients at the edge).
        inside = (1.0 - r2) > 1e-6
        oz = torch.where(inside,
                         torch.sqrt(torch.where(inside, 1.0 - r2, 1.0)), 0.0)
        normal = torch.stack([ox, -oy, oz], dim=-1)
        norm_len = _maximum(torch.linalg.vector_norm(normal, dim=-1,
                                                     keepdim=True), 1e-6)
        normal_unit = normal / norm_len
        if col is not None:
            shade = col[:, None, :] * (0.35 + 0.65 * oz[..., None])
        else:
            shade = normal_unit * 0.5 + 0.5
        if env_cube is not None:
            # View space looks along +z; world = view row-vector times R.
            nz = normal_unit[..., 2:3]
            r_view = torch.cat([-2.0 * nz * normal_unit[..., 0:1],
                                -2.0 * nz * normal_unit[..., 1:2],
                                1.0 - 2.0 * nz * nz], dim=-1)
            env_n = eval_sh9(sh_coeffs, normal_unit @ rot)
            env_r = eval_sh9(sh_coeffs, r_view @ rot)
            shade = (shade * ((1.0 - env_diffuse) + env_diffuse * env_n)
                     + env_specular * env_r)
        w = coverage * torch.exp(-depth_falloff * (cdepth - zmin)[:, None])
        valid = ((cdepth > 1e-3)[:, None] & (px >= 0) & (px < width)
                 & (py >= 0) & (py < height))
        w = torch.where(valid, w, 0.0)
        a_src = torch.where(valid, coverage, 0.0)
        flat = _pixel_index(px, py, width, height).reshape(-1)
        wf = w.reshape(-1)
        num = num.index_add(0, flat, shade.reshape(-1, 3) * wf[:, None])
        den = den.index_add(0, flat, wf)
        acc_a = acc_a.index_add(0, flat, a_src.reshape(-1))
        acc_z = acc_z.index_add(0, flat, (w * cdepth[:, None]).reshape(-1))
        return num, den, acc_a, acc_z

    chans = [u, v, depth, pix_r]
    if colors is not None:
        chans.append(torch.broadcast_to(
            torch.as_tensor(colors, dtype=torch.float32, device=dev), (n, 3)))
    npix = height * width
    carry = (torch.zeros((npix, 3), dtype=torch.float32, device=dev),
             torch.zeros(npix, dtype=torch.float32, device=dev),
             torch.zeros(npix, dtype=torch.float32, device=dev),
             torch.zeros(npix, dtype=torch.float32, device=dev))
    if chunk is None or chunk >= n:
        carry = accumulate(*carry, *chans)
    else:
        for s in range(0, n, chunk):
            carry = checkpoint(accumulate, *carry,
                               *[c[s:s + chunk] for c in chans],
                               use_reentrant=False)

    num, den, acc_a, acc_z = carry
    den_safe = _maximum(den, 1e-8)
    mean_col = num / den_safe[:, None]
    alpha = 1.0 - torch.exp(-acc_a)                   # saturating coverage
    bg = torch.as_tensor(background, dtype=torch.float32, device=dev)
    color = mean_col * alpha[:, None] + bg * (1.0 - alpha[:, None])
    mean_z = acc_z / den_safe
    return SplatImage(color=color.reshape(height, width, 3),
                      alpha=alpha.reshape(height, width),
                      depth=mean_z.reshape(height, width))
