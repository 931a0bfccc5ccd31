"""Cubemap texel directions (GL face layout +X -X +Y -Y +Z -Z).

Counterpart of dieselfluid_tpu/render/cubemap.py, reduced to
`cubemap_directions`, which the SH9 projection of the deferred environment
lighting needs. Cubemap sampling waits for the composite slice.
"""

from __future__ import annotations

import torch


def cubemap_directions(size: int, *, device) -> torch.Tensor:
    """(6, S, S, 3) unit world directions at each texel center (GL layout).
    ref: atmosphere/atmosphere.go CreateEnvBox:102 bakes 6 region
    textures."""
    t = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) \
        / size * 2.0 - 1.0
    s_grid, t_grid = torch.meshgrid(t, t, indexing="xy")
    one = torch.ones_like(s_grid)
    faces = [
        torch.stack([one, -t_grid, -s_grid], -1),    # +X
        torch.stack([-one, -t_grid, s_grid], -1),    # -X
        torch.stack([s_grid, one, t_grid], -1),      # +Y
        torch.stack([s_grid, -one, -t_grid], -1),    # -Y
        torch.stack([s_grid, -t_grid, one], -1),     # +Z
        torch.stack([-s_grid, -t_grid, -one], -1),   # -Z
    ]
    d = torch.stack(faces, dim=0)
    return d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
