"""Ray-traced mesh renderer: glTF scenes with PBR shading + sky environment.

Counterpart of dieselfluid_tpu/render/raytrace.py, the replacement for the
reference's GL mesh pipeline (ref: render/glr/glr.go Draw + rendersystem.go
Run): each pixel ray intersects the scene's triangle soup (Moller-Trumbore
over pixels x triangles), shades with the Cook-Torrance model
(render/pbr.py) and falls back to the environment on a miss.
Differentiable in materials, lights and camera; triangle visibility is hard
(as in GL), so geometry gradients are at shading level.

Plain torch on any device, whole-tensor ops: the JAX package maps the frame
in tiles of 4096 rays (lax.map), which changes no value; here the frame is
one pass, or a few large chunks where pixels x triangles would not fit.
Dot and cross products are written out in the JAX package's order, so the
CPU and the card round them alike. `ray_triangle`'s edge slack lets a ray
on a shared edge hit both triangles, and argmin then takes the first: one
ulp between devices can flip such a pixel to the other triangle.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dieselfluid_tpu_torch.mathx.polar import norm_rn
from dieselfluid_tpu_torch.render.camera import Camera
from dieselfluid_tpu_torch.render.cubemap import sample_cubemap
from dieselfluid_tpu_torch.render.pbr import PBRMaterial, reflect, shade
from dieselfluid_tpu_torch.render.texture import bilerp

_EPS = 1e-7
#: Rays x triangles per chunk of render_scene's one-pass frame (the
#: (chunk, T, 3) intermediates stay ~100 MB).
_PAIRS_PER_CHUNK = 1 << 23


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b, -1) over 3 components, (x + y) + z: jnp.sum's order."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.cross, component by component (broadcasting)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _unit(x: torch.Tensor, floor: float) -> torch.Tensor:
    nrm = norm_rn(x, keepdim=True)
    return x / torch.maximum(nrm, nrm.new_tensor(floor))


def ray_triangle(origins, dirs, tris):
    """Moller-Trumbore: rays (R, 3) x triangles (T, 3, 3) -> (R, T) hits.

    Returns (t, hit, u, v) with t = +inf on a miss; (u, v) are the
    barycentric weights of vertices 1 and 2 (vertex 0 gets 1 - u - v), the
    interpolation coordinates for UVs/attributes (ref: geom/triangle/
    tri.go Barycentric:79)."""
    v0 = tris[:, 0, :]                                      # (T, 3)
    e1 = tris[:, 1, :] - v0
    e2 = tris[:, 2, :] - v0
    pvec = _cross(dirs[:, None, :], e2[None, :, :])         # (R, T, 3)
    det = _dot(pvec, e1[None, :, :])                        # (R, T)
    big = torch.abs(det) > _EPS
    inv_det = torch.where(big, 1.0 / torch.where(big, det, 1.0), 0.0)
    tvec = origins[:, None, :] - v0[None, :, :]
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1[None, :, :])
    v = _dot(dirs[:, None, :], qvec) * inv_det
    t = _dot(e2[None, :, :], qvec) * inv_det
    # Edge-tolerant bounds: without the slack, rays along a shared edge can
    # miss BOTH triangles by one ulp (seam cracks); with it they may hit
    # both, and argmin picks the first at the same t.
    tol = 1e-5
    hit = big & (u >= -tol) & (v >= -tol) & (u + v <= 1 + tol) & (t > 1e-4)
    return torch.where(hit, t, torch.inf), hit, u, v


def _sample_stack(textures: torch.Tensor, tex_idx: torch.Tensor,
                  uv: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup into a (K, S, S, 3) texture stack with a per-point
    texture index (clipped; callers mask idx < 0), wrapping by jnp.mod
    (torch.remainder: a negative index wraps from the far end).
    Differentiable in uv."""
    k, hgt, wid = textures.shape[:3]
    ti = torch.clamp(tex_idx, 0, k - 1)
    u = uv[..., 0] * wid - 0.5
    v = uv[..., 1] * hgt - 0.5
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    x0n = x0.to(torch.int64)
    y0n = y0.to(torch.int64)
    x0i = torch.remainder(x0n, wid)
    x1i = torch.remainder(x0n + 1, wid)
    y0i = torch.remainder(y0n, hgt)
    y1i = torch.remainder(y0n + 1, hgt)
    return bilerp(textures[ti, y0i, x0i], textures[ti, y0i, x1i],
                  textures[ti, y1i, x0i], textures[ti, y1i, x1i], fx, fy)


def tangent_frames(tris: torch.Tensor, tri_uvs: torch.Tensor):
    """Per-triangle (tangent, bitangent) from UV edge deltas: the
    mesh-analytic version of the reference's screen-space cotangent frame
    (ref: data/shaders/glsl/render/material/material.frag:152-177)."""
    e1 = tris[:, 1, :] - tris[:, 0, :]
    e2 = tris[:, 2, :] - tris[:, 0, :]
    duv1 = tri_uvs[:, 1, :] - tri_uvs[:, 0, :]
    duv2 = tri_uvs[:, 2, :] - tri_uvs[:, 0, :]
    det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    big = torch.abs(det) > 1e-12
    inv = torch.where(big, 1.0 / torch.where(big, det, 1.0), 0.0)
    tang = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv[:, None]
    bitang = (e2 * duv1[:, 0:1] - e1 * duv2[:, 0:1]) * inv[:, None]
    return _unit(tang, 1e-9), _unit(bitang, 1e-9)


class RayImage(NamedTuple):
    color: torch.Tensor     # (H, W, 3)
    depth: torch.Tensor     # (H, W) ray t at the hit, 0 on a miss
    hit: torch.Tensor       # (H, W) bool


def _env_sampler(env_cube, env_mode: str):
    if env_cube is None:
        return None
    if env_mode == "sh":
        from dieselfluid_tpu_torch.render.sh import eval_sh9, project_sh9

        coeffs = project_sh9(env_cube)
        return lambda d: eval_sh9(coeffs, d)
    if env_mode != "cubemap":
        raise ValueError(f"env_mode must be 'cubemap' or 'sh': {env_mode}")
    return lambda d: sample_cubemap(env_cube, d)


def render_scene(
    tris: torch.Tensor,                 # (T, 3, 3)
    tri_normals: torch.Tensor,          # (T, 3)
    tri_materials: torch.Tensor,        # (T,) int indices into materials
    materials: PBRMaterial,             # stacked, leaves (M, ...)
    cam: Camera,
    light_pos,
    light_color=(1.0, 1.0, 1.0),
    env_cube: Optional[torch.Tensor] = None,    # (6, S, S, 3)
    width: int = 256,
    height: int = 256,
    tile: Optional[int] = None,
    tri_uvs: Optional[torch.Tensor] = None,       # (T, 3, 2)
    textures: Optional[torch.Tensor] = None,      # (K, S, S, 3) stack
    mat_base_tex: Optional[torch.Tensor] = None,  # (M,) int, -1 = none
    mat_normal_tex: Optional[torch.Tensor] = None,
    env_mode: str = "cubemap",
) -> RayImage:
    """Primary-ray render with PBR shading and a cubemap environment, on the
    camera's device.

    With tri_uvs + textures, hit-point UVs interpolate barycentrically and
    base-color/normal maps sample per material (ref: material.frag colorTex
    at :186 and normTex via the cotangent frame at :152-177).

    env_mode="sh": the environment (the reflection term and the miss
    background) evaluates the cubemap's 9-coefficient SH projection instead
    of per-pixel texel gathers: band-limited but gather-free, the deferred-SH
    trade the tile rasterizer makes (render/sh.py).

    `tile` rays are shaded at a time (default: as many as keep rays x
    triangles under 2^23, the whole 1080p frame for a few triangles); the
    tiling changes no value."""
    dev = cam.transform.device
    light_pos = torch.as_tensor(light_pos, dtype=torch.float32, device=dev)
    origins, dirs = cam.pixel_rays(width, height)
    env_sample = _env_sampler(env_cube, env_mode)
    if tris.shape[0] == 0:
        # Empty scene: pure environment (or flat background).
        d = dirs.reshape(-1, 3)
        bg = (env_sample(d) if env_sample is not None
              else torch.full_like(d, 0.1))
        return RayImage(color=bg.reshape(height, width, 3),
                        depth=torch.zeros((height, width),
                                          dtype=torch.float32, device=dev),
                        hit=torch.zeros((height, width), dtype=torch.bool,
                                        device=dev))
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    npix = o.shape[0]
    if tile is None:
        tile = max(4096, _PAIRS_PER_CHUNK // tris.shape[0])
    textured = tri_uvs is not None and textures is not None
    if textured:
        tang, bitang = tangent_frames(tris, tri_uvs)

    def render_tile(ot, dt):
        t, _, bu, bv = ray_triangle(ot, dt, tris)
        best = torch.argmin(t, dim=1)           # the first of tied minima
        t_best = torch.gather(t, 1, best[:, None])[:, 0]
        any_hit = torch.isfinite(t_best)
        n = tri_normals[best]
        # Face normals toward the viewer (two-sided shading, GL default).
        facing = _dot(n, dt) < 0
        n = torch.where(facing[:, None], n, -n)
        p = ot + dt * torch.where(any_hit, t_best, 1.0)[:, None]

        m_idx = torch.clamp(tri_materials[best], min=0)
        mat = PBRMaterial(*[leaf[m_idx] for leaf in materials])
        if textured:
            u_b = torch.gather(bu, 1, best[:, None])[:, 0]
            v_b = torch.gather(bv, 1, best[:, None])[:, 0]
            uvs = tri_uvs[best]                              # (R, 3, 2)
            uv = ((1.0 - u_b - v_b)[:, None] * uvs[:, 0]
                  + u_b[:, None] * uvs[:, 1] + v_b[:, None] * uvs[:, 2])
            if mat_base_tex is not None:
                bt = mat_base_tex[m_idx]
                texel = _sample_stack(textures, bt, uv)
                base = torch.where((bt >= 0)[:, None],
                                   mat.base_color * texel, mat.base_color)
                mat = mat._replace(base_color=base)
            if mat_normal_tex is not None:
                nt = mat_normal_tex[m_idx]
                nm = _sample_stack(textures, nt, uv) * 2.0 - 1.0
                tb, bb = tang[best], bitang[best]
                n_pert = (nm[:, 0:1] * tb + nm[:, 1:2] * bb
                          + nm[:, 2:3] * n)
                n = torch.where((nt >= 0)[:, None], _unit(n_pert, 1e-8), n)
        v = -dt
        l = _unit(light_pos - p, 1e-8)
        env = None
        if env_sample is not None:
            env = env_sample(reflect(-v, n))
        col = shade(n, v, l, mat, light_color=light_color,
                    env_reflection=env)
        if env_sample is not None:
            bg = env_sample(dt)
        else:
            bg = torch.full_like(col, 0.1)
        col = torch.where(any_hit[:, None], col, bg)
        return col, torch.where(any_hit, t_best, 0.0), any_hit

    parts = [render_tile(o[s:s + tile], d[s:s + tile])
             for s in range(0, npix, tile)]
    col, dep, hit = (torch.cat(x) for x in zip(*parts))
    return RayImage(color=col.reshape(height, width, 3),
                    depth=dep.reshape(height, width),
                    hit=hit.reshape(height, width))


def stack_materials(mats) -> PBRMaterial:
    """Stack a list of PBRMaterial into one with leaves (M, ...)."""
    return PBRMaterial(*[torch.stack(leaves) for leaves in zip(*mats)])
