"""glTF 2.0 import/export: compact, dict-driven, numpy-backed.

The port's own copy of dieselfluid_tpu/render/gltf.py (numpy only; the port
imports nothing of the JAX package). It replaces the reference's generated
schema bindings + scene importer (ref: gltf/gltf.go:258-3083, render/scene/
scene.go ImportGLTF:26-76, ExportGLTF:98-108). The full JSON document is
kept as-is (every glTF property stays accessible); typed helpers decode
buffers, buffer views and accessors into numpy arrays and re-encode on
export.

Supports: external .bin buffer URIs, data: base64 URIs, GLB container files,
sparse-free accessors of all standard component types, mesh primitives,
node TRS/matrix transforms, PBR metallic-roughness materials, cameras,
images (file or embedded), samplers, skins/animations (raw access and
`sample_animation` playback).
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import Dict, List, Optional

import numpy as np

COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
TYPE_SIZES = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
              "MAT2": 4, "MAT3": 9, "MAT4": 16}

GLB_MAGIC = 0x46546C67
GLB_JSON = 0x4E4F534A
GLB_BIN = 0x004E4942


class GLTF:
    """A parsed GLTF document: raw JSON dict + decoded binary buffers."""

    def __init__(self, doc: Dict, buffers: List[bytes], base_dir: str = "."):
        self.doc = doc
        self.buffers = buffers
        self.base_dir = base_dir

    # ------------------------------------------------------------------ load
    @staticmethod
    def load(path: str) -> "GLTF":
        """Load a .gltf (JSON + URIs) or .glb (binary container) file.

        ref: scene.go InitScene/ImportGLTF — JSON parse + buffer URI reads.
        """
        base_dir = os.path.dirname(os.path.abspath(path))
        if path.endswith(".glb"):
            return GLTF._load_glb(path, base_dir)
        with open(path, "r") as f:
            doc = json.load(f)
        buffers = [GLTF._decode_uri(b.get("uri", ""), base_dir, b["byteLength"])
                   for b in doc.get("buffers", [])]
        return GLTF(doc, buffers, base_dir)

    @staticmethod
    def _load_glb(path: str, base_dir: str) -> "GLTF":
        with open(path, "rb") as f:
            magic, version, _length = struct.unpack("<III", f.read(12))
            if magic != GLB_MAGIC:
                raise ValueError(f"not a GLB file: {path}")
            doc = None
            bin_chunk = b""
            while True:
                head = f.read(8)
                if len(head) < 8:
                    break
                clen, ctype = struct.unpack("<II", head)
                data = f.read(clen)
                if ctype == GLB_JSON:
                    doc = json.loads(data.decode("utf-8"))
                elif ctype == GLB_BIN:
                    bin_chunk = data
        if doc is None:
            raise ValueError("GLB missing JSON chunk")
        buffers = []
        for b in doc.get("buffers", []):
            uri = b.get("uri")
            buffers.append(bin_chunk if uri is None
                           else GLTF._decode_uri(uri, base_dir, b["byteLength"]))
        return GLTF(doc, buffers, base_dir)

    @staticmethod
    def _decode_uri(uri: str, base_dir: str, byte_length: int) -> bytes:
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])[:byte_length]
        with open(os.path.join(base_dir, uri), "rb") as f:
            return f.read()[:byte_length]

    # ------------------------------------------------------------- accessors
    def buffer_view_bytes(self, view_index: int) -> bytes:
        """ref: scene.go GetAccessorBufferView pairing."""
        v = self.doc["bufferViews"][view_index]
        buf = self.buffers[v.get("buffer", 0)]
        off = v.get("byteOffset", 0)
        return buf[off:off + v["byteLength"]]

    def accessor_array(self, accessor_index: int) -> np.ndarray:
        """Decode an accessor to (count, components) numpy (handles strides)."""
        a = self.doc["accessors"][accessor_index]
        dtype = COMPONENT_DTYPES[a["componentType"]]
        ncomp = TYPE_SIZES[a["type"]]
        count = a["count"]
        if "bufferView" not in a:
            return np.zeros((count, ncomp), dtype)
        view = self.doc["bufferViews"][a["bufferView"]]
        raw = self.buffer_view_bytes(a["bufferView"])
        item = np.dtype(dtype).itemsize * ncomp
        stride = view.get("byteStride") or item
        off = a.get("byteOffset", 0)
        out = np.empty((count, ncomp), dtype)
        if stride == item:
            flat = np.frombuffer(raw, dtype, count * ncomp, offset=off)
            out[:] = flat.reshape(count, ncomp)
        else:
            for i in range(count):
                out[i] = np.frombuffer(raw, dtype, ncomp, offset=off + i * stride)
        return out if ncomp > 1 else out[:, 0]

    # ------------------------------------------------------------- structure
    def _items(self, key: str) -> List[Dict]:
        return self.doc.get(key, [])

    @property
    def meshes(self): return self._items("meshes")
    @property
    def nodes(self): return self._items("nodes")
    @property
    def materials(self): return self._items("materials")
    @property
    def images(self): return self._items("images")
    @property
    def textures(self): return self._items("textures")
    @property
    def samplers(self): return self._items("samplers")
    @property
    def cameras(self): return self._items("cameras")
    @property
    def skins(self): return self._items("skins")
    @property
    def animations(self): return self._items("animations")
    @property
    def scenes(self): return self._items("scenes")

    def default_scene_nodes(self) -> List[int]:
        s = self.doc.get("scene", 0)
        scenes = self.scenes
        return scenes[s].get("nodes", []) if scenes else []

    def node_local_matrix(self, node: Dict) -> np.ndarray:
        """Node transform: explicit matrix (column-major per spec) or TRS."""
        if "matrix" in node:
            return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
        m = np.eye(4, dtype=np.float32)
        if "scale" in node:
            m = m @ np.diag(np.asarray(list(node["scale"]) + [1.0], np.float32))
        if "rotation" in node:  # GLTF quaternion is [x, y, z, w]
            x, y, z, w = node["rotation"]
            r = np.asarray([
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (w * y + x * z)],
                [2 * (w * z + y * x), 1 - 2 * (z * z + x * x), 2 * (y * z - w * x)],
                [2 * (z * x - w * y), 2 * (w * x + z * y), 1 - 2 * (x * x + y * y)],
            ], np.float32)
            m4 = np.eye(4, dtype=np.float32)
            m4[:3, :3] = r
            m = m4 @ m
        if "translation" in node:
            t = np.eye(4, dtype=np.float32)
            t[:3, 3] = node["translation"]
            m = t @ m
        return m

    # ----------------------------------------------------------- animations
    def sample_animation(self, anim_index: int, t: float) -> Dict[int, Dict[str, np.ndarray]]:
        """Evaluate one animation's channels at time t.

        Returns {node_index: {"translation"/"rotation"/"scale"/"weights":
        value}} with STEP, LINEAR (slerp for rotations, per spec) and
        CUBICSPLINE (Hermite) sampler interpolation; t clamps to each
        sampler's input range. The reference carries the full typed
        Animation/Channel/Sampler schema but never plays it
        (ref: gltf/gltf.go:258-312; render/scene/scene_test.go:173-219
        placeholders) — this is the playback it was missing.
        """
        anim = self.animations[anim_index]
        out: Dict[int, Dict[str, np.ndarray]] = {}
        for ch in anim.get("channels", []):
            target = ch.get("target", {})
            node = target.get("node")
            path = target.get("path")
            if node is None or path is None:
                continue
            smp = anim["samplers"][ch["sampler"]]
            times = np.atleast_1d(self.accessor_array(smp["input"])).astype(
                np.float64)
            vals = np.atleast_2d(self.accessor_array(smp["output"]))
            mode = smp.get("interpolation", "LINEAR")
            if mode == "CUBICSPLINE":
                # Output is (in-tangent, value, out-tangent) per keyframe.
                vals = vals.reshape(len(times), 3, -1)
            elif path == "weights":
                vals = vals.reshape(len(times), -1)
            tc = float(np.clip(t, times[0], times[-1]))
            i1 = int(np.searchsorted(times, tc, side="right"))
            i1 = min(max(i1, 1), len(times) - 1)
            i0 = i1 - 1
            dt = float(times[i1] - times[i0])
            a = 0.0 if dt <= 0 else (tc - times[i0]) / dt
            if mode == "STEP" or len(times) == 1:
                ik = i1 if a >= 1.0 else i0   # t at/after the last key
                v = (vals[ik, 1] if mode == "CUBICSPLINE" else vals[ik])
            elif mode == "CUBICSPLINE":
                p0, m0 = vals[i0, 1], vals[i0, 2] * dt
                p1, m1 = vals[i1, 1], vals[i1, 0] * dt
                a2, a3 = a * a, a * a * a
                v = ((2 * a3 - 3 * a2 + 1) * p0 + (a3 - 2 * a2 + a) * m0
                     + (-2 * a3 + 3 * a2) * p1 + (a3 - a2) * m1)
            elif path == "rotation":
                v = _slerp(vals[i0], vals[i1], a)
            else:
                v = (1.0 - a) * vals[i0] + a * vals[i1]
            if path == "rotation":
                v = v / max(float(np.linalg.norm(v)), 1e-12)
            out.setdefault(int(node), {})[path] = np.asarray(v, np.float32)
        return out

    def node_local_matrix_at(self, node_index: int, anim_index: int,
                             t: float) -> np.ndarray:
        """node_local_matrix with the animation's TRS overrides applied at
        time t (an explicit `matrix` node is replaced by the animated TRS
        for animated paths, per the GLTF spec's target semantics)."""
        node = dict(self.nodes[node_index])
        anim = self.sample_animation(anim_index, t).get(node_index, {})
        if anim:
            node.pop("matrix", None)
            for path in ("translation", "rotation", "scale"):
                if path in anim:
                    node[path] = [float(x) for x in np.ravel(anim[path])]
        return self.node_local_matrix(node)

    def primitive_arrays(self, mesh_index: int, prim_index: int = 0) -> Dict[str, np.ndarray]:
        """POSITION/NORMAL/TEXCOORD_0/indices arrays for one primitive.

        ref: render/rendersystem.go RegisterMesh:171-257 pulls exactly these.
        """
        prim = self.meshes[mesh_index]["primitives"][prim_index]
        out = {}
        for name, acc in prim.get("attributes", {}).items():
            out[name] = self.accessor_array(acc)
        if "indices" in prim:
            out["indices"] = self.accessor_array(prim["indices"]).astype(np.uint32)
        out["material"] = prim.get("material")
        return out

    def image_path(self, image_index: int) -> Optional[str]:
        img = self.images[image_index]
        uri = img.get("uri")
        if uri and not uri.startswith("data:"):
            return os.path.join(self.base_dir, uri)
        return None

    # ------------------------------------------------------------------ save
    def save(self, path: str):
        """Export: JSON + one .bin sidecar. ref: scene.go ExportGLTF:98-108."""
        doc = dict(self.doc)
        if self.buffers:
            bin_path = os.path.splitext(path)[0] + ".bin"
            blob = b"".join(self.buffers)
            with open(bin_path, "wb") as f:
                f.write(blob)
            doc["buffers"] = [{"uri": os.path.basename(bin_path),
                               "byteLength": len(blob)}]
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)


def _slerp(q0: np.ndarray, q1: np.ndarray, a: float) -> np.ndarray:
    """Quaternion slerp ([x, y, z, w] per GLTF), shortest arc; falls back to
    nlerp when the quaternions are nearly parallel."""
    q0 = q0 / max(float(np.linalg.norm(q0)), 1e-12)
    q1 = q1 / max(float(np.linalg.norm(q1)), 1e-12)
    d = float(np.dot(q0, q1))
    if d < 0.0:
        q1, d = -q1, -d
    if d > 0.9995:
        v = (1.0 - a) * q0 + a * q1
        return v / max(float(np.linalg.norm(v)), 1e-12)
    th = np.arccos(np.clip(d, -1.0, 1.0))
    s = np.sin(th)
    return (np.sin((1.0 - a) * th) / s) * q0 + (np.sin(a * th) / s) * q1


def make_gltf(positions: np.ndarray, indices: np.ndarray,
              normals: Optional[np.ndarray] = None,
              material: Optional[Dict] = None) -> GLTF:
    """Build a minimal single-mesh GLTF document from arrays (export path)."""
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.uint32)
    chunks = [positions.tobytes(), indices.tobytes()]
    if normals is not None:
        normals = np.asarray(normals, np.float32)
        chunks.append(normals.tobytes())
    offsets = np.cumsum([0] + [len(c) for c in chunks])[:-1]
    views = [
        {"buffer": 0, "byteOffset": int(offsets[0]), "byteLength": len(chunks[0]),
         "target": 34962},
        {"buffer": 0, "byteOffset": int(offsets[1]), "byteLength": len(chunks[1]),
         "target": 34963},
    ]
    accessors = [
        {"bufferView": 0, "componentType": 5126, "count": len(positions),
         "type": "VEC3",
         "min": positions.min(0).tolist(), "max": positions.max(0).tolist()},
        {"bufferView": 1, "componentType": 5125, "count": indices.size,
         "type": "SCALAR"},
    ]
    attributes = {"POSITION": 0}
    if normals is not None:
        views.append({"buffer": 0, "byteOffset": int(offsets[2]),
                      "byteLength": len(chunks[2]), "target": 34962})
        accessors.append({"bufferView": 2, "componentType": 5126,
                          "count": len(normals), "type": "VEC3"})
        attributes["NORMAL"] = 2
    doc = {
        "asset": {"version": "2.0", "generator": "dieselfluid_tpu_torch"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": attributes, "indices": 1,
            **({"material": 0} if material else {}),
        }]}],
        **({"materials": [material]} if material else {}),
        "bufferViews": views,
        "accessors": accessors,
        "buffers": [{"byteLength": int(sum(len(c) for c in chunks))}],
    }
    return GLTF(doc, [b"".join(chunks)])
