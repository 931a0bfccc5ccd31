"""Scene graph: glTF document -> flattened, device-ready render arrays.

Counterpart of dieselfluid_tpu/render/scene.py (ref: render/scene/scene.go,
Scene = parsed glTF + loaded buffers, and render/rendersystem.go
Init/RegisterMesh:73-257: accessor walk, PBR material construction, world
transforms). The scene flattens into one triangle soup + per-triangle
material indices for the renderers, as tensors on the device the caller
names. Texture images are read (with imageio, imported there) only for a
scene that has them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from dieselfluid_tpu_torch.render.gltf import GLTF
from dieselfluid_tpu_torch.render.pbr import PBRMaterial
from dieselfluid_tpu_torch.render.raytrace import stack_materials


@dataclasses.dataclass
class SceneMesh:
    """One primitive instance with its world transform applied."""

    positions: np.ndarray          # (V, 3) world space
    normals: Optional[np.ndarray]  # (V, 3)
    uvs: Optional[np.ndarray]      # (V, 2)
    indices: np.ndarray            # (I,) uint32
    material_index: Optional[int]
    name: str = ""


def _on(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclasses.dataclass
class Scene:
    """Loaded scene: meshes in world space + materials + texture paths."""

    gltf: GLTF
    meshes: List[SceneMesh]
    materials: List[Dict]
    texture_paths: List[Optional[str]]

    @staticmethod
    def load(path: str, at_time: Optional[float] = None,
             animation: int = 0) -> "Scene":
        """ref: scene.go InitScene:26 + the rendersystem walk.

        `at_time`: evaluate animation channel `animation` at that time and
        flatten with the animated node transforms (gltf.sample_animation)."""
        g = GLTF.load(path)
        meshes: List[SceneMesh] = []
        animated = at_time is not None and len(g.animations) > animation

        def visit(node_idx: int, parent: np.ndarray):
            node = g.nodes[node_idx]
            local = (g.node_local_matrix_at(node_idx, animation, at_time)
                     if animated else g.node_local_matrix(node))
            world = parent @ local
            if "mesh" in node:
                mi = node["mesh"]
                for pi, _ in enumerate(g.meshes[mi].get("primitives", [])):
                    arrays = g.primitive_arrays(mi, pi)
                    pos = arrays.get("POSITION")
                    if pos is None:
                        continue
                    posh = np.concatenate(
                        [pos, np.ones((len(pos), 1), np.float32)], 1)
                    wpos = (posh @ world.T)[:, :3]
                    nrm = arrays.get("NORMAL")
                    if nrm is not None:
                        nrm = nrm @ np.linalg.inv(world[:3, :3]).T.astype(
                            np.float32)
                        nl = np.linalg.norm(nrm, axis=-1, keepdims=True)
                        nrm = nrm / np.maximum(nl, 1e-9)
                    idx = arrays.get("indices")
                    if idx is None:
                        idx = np.arange(len(pos), dtype=np.uint32)
                    meshes.append(SceneMesh(
                        positions=wpos.astype(np.float32),
                        normals=None if nrm is None else nrm.astype(
                            np.float32),
                        uvs=arrays.get("TEXCOORD_0"),
                        indices=idx,
                        material_index=arrays.get("material"),
                        name=g.meshes[mi].get("name", f"mesh{mi}"),
                    ))
            for child in node.get("children", []):
                visit(child, world)

        for root in g.default_scene_nodes():
            visit(root, np.eye(4, dtype=np.float32))

        tex_paths = [g.image_path(t.get("source", 0)) if g.images else None
                     for t in g.textures]
        return Scene(gltf=g, meshes=meshes, materials=list(g.materials),
                     texture_paths=tex_paths)

    def material(self, index: Optional[int], *, device) -> PBRMaterial:
        """PBR metallic-roughness factors -> PBRMaterial on `device`.
        ref: rendersystem.go:135-162 builds materials from
        pbrMetallicRoughness {baseColorFactor, metallicFactor,
        roughnessFactor}."""
        if index is None or index >= len(self.materials):
            return PBRMaterial.make(device=device)
        m = self.materials[index].get("pbrMetallicRoughness", {})
        base = m.get("baseColorFactor", [0.8, 0.8, 0.8, 1.0])[:3]
        return PBRMaterial.make(
            base_color=base, metallic=m.get("metallicFactor", 1.0),
            roughness=m.get("roughnessFactor", 1.0), device=device)

    def _triangle_soup_np(self):
        """triangle_soup's arrays in numpy (material ids int32)."""
        tris, norms, mats = [], [], []
        for mesh in self.meshes:
            p = mesh.positions[mesh.indices.reshape(-1, 3)]
            tris.append(p)
            if mesh.normals is not None:
                n = mesh.normals[mesh.indices.reshape(-1, 3)].mean(axis=1)
            else:
                n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
            n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                               1e-9)
            norms.append(n)
            mi = mesh.material_index if mesh.material_index is not None \
                else -1
            mats.append(np.full(len(p), mi, np.int32))
        if not tris:
            z = np.zeros((0, 3, 3), np.float32)
            return z, z[:, 0], np.zeros((0,), np.int32)
        return (np.concatenate(tris).astype(np.float32),
                np.concatenate(norms).astype(np.float32),
                np.concatenate(mats))

    def triangle_soup(self, *, device):
        """All meshes flattened to ((T, 3, 3) tris, (T, 3) normals, (T,)
        material ids) on `device` (ids int64), for the ray renderer."""
        tris, norms, mats = self._triangle_soup_np()
        return (_on(tris, device), _on(norms, device),
                _on(mats.astype(np.int64), device))

    def _triangle_uvs_np(self) -> np.ndarray:
        """(T, 3, 2) per-corner UVs aligned with triangle_soup (zeros where a
        mesh has no TEXCOORD_0). ref: rendersystem.go RegisterMesh reads
        the TEXCOORD_0 accessor at :171-257."""
        uvs = []
        for mesh in self.meshes:
            tri_idx = mesh.indices.reshape(-1, 3)
            if mesh.uvs is not None:
                uvs.append(mesh.uvs[tri_idx].astype(np.float32))
            else:
                uvs.append(np.zeros((len(tri_idx), 3, 2), np.float32))
        if not uvs:
            return np.zeros((0, 3, 2), np.float32)
        return np.concatenate(uvs)

    def triangle_uvs(self, *, device) -> torch.Tensor:
        """(T, 3, 2) per-corner UVs on `device` (see _triangle_uvs_np)."""
        return _on(self._triangle_uvs_np(), device)

    def _texture_stack_np(self, res: int = 256):
        """((K, res, res, 3) stack, (M,) base-color texture index, (M,)
        normal texture index) numpy arrays, -1 = untextured. Images
        resample to one resolution so one gather serves every material
        (ref: render/texture/texture.go CommitTexLibGL:82 +
        rendersystem.go texture-unit binding). An image that does not
        decode counts as untextured."""

        def resize(img):
            h, w = img.shape[:2]
            yi = (np.linspace(0, h - 1, res)).astype(int)
            xi = (np.linspace(0, w - 1, res)).astype(int)
            return img[yi][:, xi]

        stack, loaded = [], {}
        for k, path in enumerate(self.texture_paths):
            if path is None:
                loaded[k] = -1
                continue
            from dieselfluid_tpu_torch.render.texture import read_image

            try:
                img = read_image(path)
            except (OSError, ValueError):
                loaded[k] = -1
                continue
            loaded[k] = len(stack)
            stack.append(resize(img))

        def tex_index(m, key):
            if key == "baseColorTexture":
                t = m.get("pbrMetallicRoughness", {}).get("baseColorTexture")
            else:
                t = m.get(key)
            if t is None:
                return -1
            return loaded.get(t.get("index", -1), -1)

        base_idx = np.asarray(
            [tex_index(m, "baseColorTexture") for m in self.materials]
            or [-1], np.int32)
        norm_idx = np.asarray(
            [tex_index(m, "normalTexture") for m in self.materials]
            or [-1], np.int32)
        tex = (np.zeros((1, res, res, 3), np.float32) if not stack
               else np.stack(stack).astype(np.float32))
        return tex, base_idx, norm_idx

    def texture_stack(self, res: int = 256, *, device):
        """The texture stack and the per-material texture indices on
        `device` (indices int64); see _texture_stack_np."""
        tex, base_idx, norm_idx = self._texture_stack_np(res)
        return (_on(tex, device), _on(base_idx.astype(np.int64), device),
                _on(norm_idx.astype(np.int64), device))

    def stacked_materials(self, *, device) -> PBRMaterial:
        """All materials as one PBRMaterial with leaves (M, ...)."""
        return stack_materials(
            [self.material(i, device=device)
             for i in range(max(len(self.materials), 1))])

    def export(self, path: str):
        """Write the (possibly modified) document back. ref: scene.go
        ExportGLTF."""
        self.gltf.save(path)
