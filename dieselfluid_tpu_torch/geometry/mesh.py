"""Triangle-soup meshes: inward normals, a procedural box, particle
collision and boundary-particle emission.

Counterpart of dieselfluid_tpu/geometry/mesh.py (ref: geom/mesh/mesh.go).
A Mesh holds a (T, 3, 3) float32 tensor of triangles and (T, 3) normals on
one device; collision is the particles-x-triangles narrow phase as one
masked reduction, on the particles' device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dieselfluid_tpu_torch.geometry import triangle as T
from dieselfluid_tpu_torch.mathx.polar import norm_cr


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A static triangle mesh on a device."""

    tris: torch.Tensor      # (T, 3, 3)
    normals: torch.Tensor   # (T, 3), pointing inward with respect to an origin

    @staticmethod
    def from_vertices(vertices, origin=(0.0, 0.0, 0.0), *, device) -> "Mesh":
        """From a flat (3T, 3) vertex list; each normal is flipped to point
        toward `origin` (ref: mesh.go InitMesh:17-38)."""
        v = torch.from_numpy(np.array(vertices, np.float32)).to(
            device).reshape(-1, 3, 3)
        n = T.normal(v)
        to_v0 = v[:, 0, :] - torch.tensor(origin, dtype=torch.float32,
                                          device=device)
        outward = torch.sum(n * to_v0, dim=-1) > 0
        return Mesh(tris=v, normals=torch.where(outward[:, None], -n, n))

    @property
    def num_triangles(self) -> int:
        return self.tris.shape[0]

    def generate_boundary_particles(self, density: float = 2.0
                                    ) -> torch.Tensor:
        """Boundary particles: one per vertex (ref: mesh.go
        GenerateBoundaryParticles:60-76), plus barycentric samples at
        `density` per edge when density > 1."""
        verts = self.tris.reshape(-1, 3)
        if density <= 1.0:
            return verts
        k = int(density)
        pts = [verts]
        for i in range(1, k):
            for j in range(0, k - i + 1):
                u, v = i / k, j / k
                w = 1.0 - u - v
                pts.append(u * self.tris[:, 0, :] + v * self.tris[:, 1, :]
                           + w * self.tris[:, 2, :])
        return torch.cat(pts, dim=0)

    def collide_swept(self, pos, vel, dt: float, radius: float):
        """The reference's narrow phase (plane projection + barycentric
        test; ref: mesh.go Collision:41-57): (hit, normal, depth). It
        misses edge and corner contacts, so it cannot seal a container:
        `collide` is the robust response."""
        hit, dist, _ = T.swept_collision(self.tris[None], self.normals[None],
                                         pos[:, None, :], vel[:, None, :],
                                         dt, radius)           # (N, T)
        ranked = torch.where(hit, dist, torch.inf)
        best = torch.argmin(ranked, dim=1)
        any_hit = torch.any(hit, dim=1)
        d_best = torch.gather(ranked, 1, best[:, None])[:, 0]
        depth = torch.where(any_hit, radius - d_best, 0.0)
        return any_hit, self.normals[best], depth

    def collide(self, pos: torch.Tensor, radius: float):
        """Closest point on the mesh and the signed distance along its
        inward normal (positive inside, negative when a particle crossed a
        face): (hit, inward normal, depth)."""
        cp = T.closest_point(self.tris[None], pos[:, None, :])  # (N, T, 3)
        d = norm_cr(pos[:, None, :] - cp)                       # (N, T)
        best = torch.argmin(d, dim=1)
        n = self.normals[best]
        cp_best = cp[torch.arange(pos.shape[0], device=pos.device), best]
        signed = torch.sum((pos - cp_best) * n, dim=-1)
        hit = signed < radius
        return hit, n, torch.where(hit, radius - signed, 0.0)


def mesh_collide(state, mesh: Mesh, dt: float, radius: float,
                 restitution: float = 0.3, friction: float = 0.1):
    """Collision response against a mesh: push out along the inward
    normal, reflect the approaching normal velocity, damp the velocity of
    a contact that is not approaching (ref: model/sph/fluid.go:70, the
    reference's commented-out collider wiring)."""
    hit, n, depth = mesh.collide(state.pos, radius)
    pos = state.pos + n * depth[:, None]
    vn = torch.sum(state.vel * n, dim=-1, keepdim=True)
    approaching = hit & (vn[..., 0] < 0)
    reflected = state.vel - (1.0 + restitution) * vn * n
    vel = torch.where(approaching[:, None], reflected, state.vel)
    vel = torch.where((hit & ~approaching)[:, None], vel * (1.0 - friction),
                      vel)
    return state._replace(pos=pos, vel=vel)


def box(w: float, h: float, d: float, origin=(0.0, 0.0, 0.0), *,
        device) -> Mesh:
    """A procedural 12-triangle box, the reference's winding (ref: mesh.go
    Box:88-157)."""
    x, y, z = origin
    p, q, s = w / 2.0, h / 2.0, d / 2.0
    lfb = [x - p, y - q, z + s]; lft = [x - p, y + q, z + s]  # noqa: E702
    rft = [x + p, y + q, z + s]; rfb = [x + p, y - q, z + s]  # noqa: E702
    lbb = [x - p, y - q, z - s]; lbt = [x - p, y + q, z - s]  # noqa: E702
    rbt = [x + p, y + q, z - s]; rbb = [x + p, y - q, z - s]  # noqa: E702
    verts = np.asarray([
        lfb, lft, rft, rft, rfb, lfb,            # front +z
        lbb, lbt, rbb, lbt, rbt, rbb,            # back -z
        lfb, lbb, rbb, lfb, rbb, rfb,            # bottom -y
        lft, lbt, rbt, rbt, rft, lft,            # top +y
        lfb, lbb, lft, lbb, lbt, lft,            # left -x
        rft, rfb, rbb, rft, rbt, rbb,            # right +x
    ], np.float32)
    return Mesh.from_vertices(verts, origin, device=device)
