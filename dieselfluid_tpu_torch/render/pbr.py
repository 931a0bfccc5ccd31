"""Cook-Torrance PBR shading in torch: a differentiable material model.

Counterpart of dieselfluid_tpu/render/pbr.py, a formula-level
re-implementation of the reference's metallic-roughness fragment shader
(ref: data/shaders/glsl/render/material/material.frag): GGX distribution
(D_CGX, material.frag:77-83), the reference G term (G_term:98-104), Schlick
Fresnel (fresnel_factor:49-52), the gold-derived F0 constant, the
blinn/phong/beckmann alternates, phong diffuse + ambient, and the cubemap
reflection lookup. Everything broadcasts over (..., 3) shading points and
differentiates to the material parameters.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dieselfluid_tpu_torch.mathx.polar import norm_rn

PI = 3.1415926
# ref: material.frag FRESNEL_GOLD
FRESNEL_GOLD = (1.0002 - 0.273) / (1.0002 + 0.273)


def _max(x: torch.Tensor, c: float) -> torch.Tensor:
    """jnp.maximum(x, c): half the gradient to each side at a tie."""
    return torch.maximum(x, x.new_tensor(c))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip's value and gradient."""
    return torch.minimum(_max(x, lo), x.new_tensor(hi))


class PBRMaterial(NamedTuple):
    """Metallic-roughness material (ref: render/material/material.go:12-25
    and glTF pbrMetallicRoughness), float32 tensors that may require grad.
    A stacked material has leaves (M, ...) (stack_materials)."""

    base_color: torch.Tensor      # (..., 3)
    metallic: torch.Tensor
    roughness: torch.Tensor
    fresnel_rim: torch.Tensor

    @staticmethod
    def make(base_color=(0.8, 0.8, 0.8), metallic=0.0, roughness=0.5,
             fresnel_rim=0.0, *, device) -> "PBRMaterial":
        def f(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        return PBRMaterial(f(base_color), f(metallic), f(roughness),
                           f(fresnel_rim))


def fresnel_schlick(f0, ndv):
    """F = F0 + (1 - F0)(1 - NdV)^5. ref: material.frag fresnel_factor."""
    return f0 + (1.0 - f0) * torch.pow(_clip(1.0 - ndv, 0.0, 1.0), 5.0)


def d_ggx(roughness, ndh):
    """GGX/Trowbridge-Reitz NDF. ref: material.frag D_CGX:77-83."""
    m = roughness * roughness
    m2 = m * m
    d = (ndh * ndh) * (m2 - 1.0) + 1.0
    return m2 / (PI * d * d)


def d_blinn(roughness, ndh):
    """ref: material.frag D_blinn:57-63."""
    m2 = (roughness * roughness) ** 2
    n = 2.0 / m2 - 2.0
    return (n + 2.0) / (2.0 * PI) * torch.pow(_max(ndh, 1e-6), n)


def d_beckmann(roughness, ndh):
    """ref: material.frag D_beckmann:66-72."""
    m2 = (roughness * roughness) ** 2
    ndh2 = _max(ndh * ndh, 1e-6)
    return torch.exp((ndh2 - 1.0) / (m2 * ndh2)) / (PI * m2 * ndh2 * ndh2)


def g_schlick(roughness, ndv, ndl):
    """ref: material.frag G_schlick:88-94."""
    k = roughness * roughness * 0.5
    v = ndv * (1.0 - k) + k
    l = ndl * (1.0 - k) + k
    return 0.25 / _max(v * l, 1e-6)


def g_term(hdn, vdn, vdh, ldn, roughness):
    """Reference geometric attenuation. ref: material.frag G_term:98-104."""
    m3 = roughness * roughness
    a = 2.0 * hdn * vdn * m3
    b = 2.0 * hdn * ldn * m3
    vdh_s = _max(vdh, 1e-6)
    ratio = a / vdh_s
    return torch.minimum(torch.minimum(ratio.new_tensor(1.0), ratio),
                         b / vdh_s)


def cooktorrance_specular(hdn, vdn, vdh, ldn, ndh, ndv, ndl, roughness,
                          fresnel):
    """ref: material.frag cooktorrance_specular:121-127 (incl. the P rim
    term)."""
    d = d_ggx(roughness, ndh)
    g = g_term(hdn, vdn, vdh, ldn, roughness)
    p = 1.0 / ((1.0 - roughness * 0.9) * (1.0 - ndv) + ndv)
    return (d * fresnel * g * p) / (PI * _max(vdn * ndl, 1e-6))


def phong_diffuse():
    """ref: material.frag phong_diffuse: 1/pi."""
    return 1.0 / PI


def shade(normal: torch.Tensor, view_dir: torch.Tensor,
          light_dir: torch.Tensor, material: PBRMaterial,
          light_color=(1.0, 1.0, 1.0),
          env_reflection: Optional[torch.Tensor] = None,
          ambient: float = 0.1) -> torch.Tensor:
    """The reference material shader's main().

    ref: material.frag main:180-251: specular color mix(base * (1 - rough),
    white, metallic) * lightColor, gold F0 squared, cook-torrance power
    squared, phong = |lightColor| * NdL + ka, result = mix(0, base, phong) +
    specular. env_reflection, if given, is added like the cubemap
    reflection sample."""
    dev = normal.device
    light_color = torch.as_tensor(light_color, dtype=torch.float32,
                                  device=dev)
    n, v, l = normal, view_dir, light_dir
    h = l + v
    h = h / _max(norm_rn(h, keepdim=True), 1e-8)

    ndl = _max(torch.sum(n * l, dim=-1), 0.0)
    ndv = _max(torch.sum(n * v, dim=-1), 1e-3)
    ndh = _max(torch.sum(n * h, dim=-1), 1e-3)
    vdh = _max(torch.sum(v * h, dim=-1), 1e-6)

    rough = _clip(material.roughness, 0.01, 1.0)
    metal = _clip(material.metallic, 0.0, 1.0)

    sp_color = (material.base_color * (1.0 - rough[..., None])
                * (1.0 - metal[..., None]) + metal[..., None]) * light_color
    f0 = FRESNEL_GOLD ** 2
    fresnel = fresnel_schlick(f0, ndv)
    power = _max(cooktorrance_specular(ndh, ndv, vdh, ndl, ndh, ndv, ndl,
                                       rough, fresnel), 0.0)
    specular = (power[..., None] * sp_color) ** 2   # ref squares the product

    phong = norm_rn(light_color) * ndl + ambient
    color = material.base_color * phong[..., None] + specular
    if env_reflection is not None:
        # ref: material.frag:248 samples the cubemap along reflect(-V, N);
        # the sample modulates by metallic reflectivity here.
        color = color + env_reflection * metal[..., None] \
            * (1.0 - rough[..., None])
    return color


def reflect(incident: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """GLSL-style reflect(I, N) = I - 2 dot(N, I) N."""
    return incident - 2.0 * torch.sum(normal * incident, dim=-1,
                                      keepdim=True) * normal


def tonemap_exposure(hdr: torch.Tensor, exposure=1.0) -> torch.Tensor:
    """Simple exponential tone map (the sky baker uses a related curve,
    ref: atmosphere/atmosphere.go ImageFromPixels:142-193)."""
    return 1.0 - torch.exp(-hdr * exposure)


def gamma_encode(linear: torch.Tensor, gamma=2.2) -> torch.Tensor:
    return torch.pow(_clip(linear, 0.0, 1.0), 1.0 / gamma)
