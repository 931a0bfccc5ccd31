"""The port's scene path (A9b) against the JAX package, on the CPU:
render/texture, render/cubemap.sample_cubemap, render/pbr,
render/raytrace, render/gltf and render/scene.

Inputs are made with numpy from seeds, and every glTF file and texture
image is written by the test itself (tmp_path), then read by both packages.
The JAX `render_scene` is jitted (XLA may contract its products into FMAs);
the port's runs op by op. Tolerances are stated beside each assert with the
drift measured. `ray_triangle`'s edge slack lets a ray on an edge shared by
two triangles hit both, and argmin then picks either: one ulp can move such
a pixel to the other triangle, so the renders count pixels whose triangle
differs and bound that count instead of loosening the colour tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dieselfluid_tpu.render import cubemap as jcube
from dieselfluid_tpu.render import gltf as jgltf
from dieselfluid_tpu.render import pbr as jpbr
from dieselfluid_tpu.render import raytrace as jrt
from dieselfluid_tpu.render import scene as jscene
from dieselfluid_tpu.render import texture as jtex
from dieselfluid_tpu.render.camera import Camera as JCamera
from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.render import cubemap as tcube
from dieselfluid_tpu_torch.render import gltf as tgltf
from dieselfluid_tpu_torch.render import pbr as tpbr
from dieselfluid_tpu_torch.render import raytrace as trt
from dieselfluid_tpu_torch.render import scene as tscene
from dieselfluid_tpu_torch.render import texture as ttex

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 64, 36


def _t(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).detach(), np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _cams():
    jc = JCamera.at((0.0, 0.6, -2.8), front=(0.0, -0.35, 1.0),
                    fov_deg=55.0, aspect=W / H)
    tc = interop.camera_from_numpy(np.asarray(jc.transform), jc.fov_deg,
                                   jc.aspect, jc.near, jc.far, jc.exposure,
                                   device=CPU)
    return jc, tc


def _cube(seed=3, size=8):
    return np.random.default_rng(seed).uniform(
        0.0, 2.0, (6, size, size, 3)).astype(np.float32)


# --------------------------------------------------------------------------
# texture, cubemap
# --------------------------------------------------------------------------


@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
def test_sample_bilinear_matches_jax(wrap):
    """UVs well outside [0, 1] (negative texel indices wrap from the far
    end, torch.remainder as jnp.mod), values and gradients to the UVs and
    the texels. Measured exact (bounds 1e-6 and 2e-6, relative)."""
    rng = np.random.default_rng(0)
    tex = rng.uniform(size=(5, 7, 3)).astype(np.float32)
    uv = rng.uniform(-1.7, 2.3, (300, 2)).astype(np.float32)
    ct = rng.normal(size=(300, 3)).astype(np.float32)

    def jf(t, u):
        return jnp.sum(jtex.sample_bilinear(t, u, wrap) * ct)

    want = jtex.sample_bilinear(jnp.asarray(tex), jnp.asarray(uv), wrap)
    jg = jax.grad(jf, argnums=(0, 1))(jnp.asarray(tex), jnp.asarray(uv))
    t, u = _t(tex).requires_grad_(), _t(uv).requires_grad_()
    got = ttex.sample_bilinear(t, u, wrap)
    tg = torch.autograd.grad((got * _t(ct)).sum(), [t, u])
    assert _rel(got, want) <= 1e-6
    for a, b in zip(tg, jg):
        assert _rel(a, b) <= 2e-6


def test_tex_library_and_write_image(tmp_path):
    """TexLibrary.load of a PNG and a gray image the test writes, add,
    remove; write_image with gamma: the same arrays and files as the JAX
    package's."""
    import imageio.v2 as imageio

    rng = np.random.default_rng(1)
    rgb = (rng.uniform(size=(6, 5, 3)) * 255).astype(np.uint8)
    gray = (rng.uniform(size=(4, 4)) * 255).astype(np.uint8)
    imageio.imwrite(tmp_path / "rgb.png", rgb)
    imageio.imwrite(tmp_path / "gray.png", gray)
    jl, tl = jtex.TexLibrary(), ttex.TexLibrary()
    for name in ("rgb", "gray"):
        path = str(tmp_path / f"{name}.png")
        want = jl.load(path, name)
        got = tl.load(path, name, device=CPU)
        assert got.shape == want.shape and _rel(got, want) == 0
    tl.add("x", rgb[..., 0] / 255.0, device=CPU)
    assert tl.get("x").dtype == torch.float32
    tl.remove("x")
    assert sorted(tl.textures) == ["gray", "rgb"]
    img = rng.uniform(-0.2, 1.2, (8, 6, 3)).astype(np.float32)
    jtex.write_image(str(tmp_path / "j.png"), jnp.asarray(img), gamma=2.2)
    ttex.write_image(str(tmp_path / "t.png"), _t(img), gamma=2.2)
    assert np.array_equal(imageio.imread(tmp_path / "t.png"),
                          imageio.imread(tmp_path / "j.png"))


def test_sample_cubemap_matches_jax():
    """Seeded directions plus the axes and cube corners (face ties), values
    and gradients to the directions and the texels. Measured at most
    3.1e-7, relative (bounds 1e-6 and 5e-6)."""
    rng = np.random.default_rng(2)
    d = rng.normal(size=(400, 3)).astype(np.float32)
    d = np.concatenate([d, np.eye(3), -np.eye(3), [[1, 1, 1], [-1, 1, -1],
                                                    [0.5, -0.5, 0.5]]]) \
        .astype(np.float32)
    cube = _cube()
    ct = rng.normal(size=(len(d), 3)).astype(np.float32)
    jg = jax.grad(lambda c, x: jnp.sum(jcube.sample_cubemap(c, x) * ct),
                  argnums=(0, 1))(jnp.asarray(cube), jnp.asarray(d))
    want = jcube.sample_cubemap(jnp.asarray(cube), jnp.asarray(d))
    c, x = _t(cube).requires_grad_(), _t(d).requires_grad_()
    got = tcube.sample_cubemap(c, x)
    tg = torch.autograd.grad((got * _t(ct)).sum(), [c, x])
    assert _rel(got, want) <= 1e-6
    for a, b in zip(tg, jg):
        assert _rel(a, b) <= 5e-6
    # jnp.linalg.norm is jitted inside (XLA may fuse its products):
    # measured 6.1e-8.
    assert _rel(tcube.cubemap_directions(6, device=CPU),
                jcube.cubemap_directions(6)) <= 1e-6


# --------------------------------------------------------------------------
# pbr
# --------------------------------------------------------------------------


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("env", [False, True])
def test_shade_and_terms_match_jax(env):
    """shade over seeded normals, view and light directions with a stacked
    material per point (with and without an environment sample), its
    gradients to the material leaves, and each term alone. Measured at most
    4.6e-6, relative (bounds 1e-6 for values, 1e-5 for gradients)."""
    rng = np.random.default_rng(4)
    n = 200
    nrm, v, l = (_unit(rng.normal(size=(n, 3))) for _ in range(3))
    v = np.where(np.sum(nrm * v, -1, keepdims=True) < 0, -v, v)
    leaves = [rng.uniform(0, 1, (n, 3)), rng.uniform(-0.1, 1.1, n),
              rng.uniform(0.0, 1.1, n), rng.uniform(0, 1, n)]
    leaves = [a.astype(np.float32) for a in leaves]
    envs = rng.uniform(0, 2, (n, 3)).astype(np.float32) if env else None

    def jloss(m):
        col = jpbr.shade(jnp.asarray(nrm), jnp.asarray(v), jnp.asarray(l), m,
                         light_color=(1.0, 0.9, 0.8),
                         env_reflection=None if envs is None
                         else jnp.asarray(envs))
        return jnp.sum(col * col), col

    jm = jpbr.PBRMaterial(*[jnp.asarray(a) for a in leaves])
    (_, want), jg = jax.value_and_grad(jloss, has_aux=True)(jm)
    tm = interop.pbr_materials_from_numpy(*leaves, device=CPU,
                                          requires_grad=True)
    got = tpbr.shade(_t(nrm), _t(v), _t(l), tm, light_color=(1.0, 0.9, 0.8),
                     env_reflection=None if envs is None else _t(envs))
    tg = torch.autograd.grad((got * got).sum(), list(tm)[:3])
    assert _rel(got, want) <= 1e-6
    for a, b in zip(tg, jg[:3]):
        assert _rel(a, b) <= 1e-5
    r = _t(leaves[2])
    x = _t(rng.uniform(0.05, 1.0, n))
    y = _t(rng.uniform(0.05, 1.0, n))
    for name, args in (("d_ggx", (r, x)), ("d_blinn", (r, x)),
                       ("d_beckmann", (r, x)), ("g_schlick", (r, x, y)),
                       ("fresnel_schlick", (0.3, x)),
                       ("g_term", (x, y, x, y, r))):
        want = getattr(jpbr, name)(*[jnp.asarray(a.numpy()) if
                                     torch.is_tensor(a) else a for a in args])
        assert _rel(getattr(tpbr, name)(*args), want) <= 1e-6, name
    assert _rel(tpbr.reflect(_t(v), _t(nrm)),
                jpbr.reflect(jnp.asarray(v), jnp.asarray(nrm))) <= 1e-6
    hdr = rng.uniform(0, 4, (n, 3)).astype(np.float32)
    assert _rel(tpbr.tonemap_exposure(_t(hdr), 0.7),
                jpbr.tonemap_exposure(jnp.asarray(hdr), 0.7)) <= 1e-6
    assert _rel(tpbr.gamma_encode(_t(hdr / 3)),
                jpbr.gamma_encode(jnp.asarray(hdr / 3))) <= 1e-6
    assert tpbr.phong_diffuse() == jpbr.phong_diffuse()


# --------------------------------------------------------------------------
# raytrace
# --------------------------------------------------------------------------


def _quad_scene():
    """bench.py's composite scene (bench.py:483-494): a floor (y = -1) and a
    back wall (z = 1), two triangles each, and one PBR material."""
    v = np.asarray([
        [-2, -1, -2], [2, -1, -2], [2, -1, 2],
        [-2, -1, -2], [2, -1, 2], [-2, -1, 2],
        [-2, -1, 1], [2, -1, 1], [2, 2, 1],
        [-2, -1, 1], [2, 2, 1], [-2, 2, 1],
    ], np.float32).reshape(4, 3, 3)
    norms = np.asarray([[0, 1, 0], [0, 1, 0], [0, 0, -1], [0, 0, -1]],
                       np.float32)
    leaves = [np.asarray([[0.55, 0.5, 0.45]], np.float32),
              np.asarray([0.05], np.float32), np.asarray([0.7], np.float32),
              np.asarray([0.0], np.float32)]
    return v, norms, np.zeros(4, np.int32), leaves


def test_ray_triangle_matches_jax():
    """Seeded rays against the quad scene and seeded triangles: t, hit and
    the barycentrics. Measured hits exact, t and (u, v) at most 1.1e-6
    (relative, over hits: jnp.cross is jitted inside, and XLA may contract
    its products into FMAs)."""
    rng = np.random.default_rng(5)
    tris = np.concatenate([_quad_scene()[0], rng.normal(
        size=(6, 3, 3)).astype(np.float32)])
    o = rng.normal(size=(500, 3)).astype(np.float32) * 0.3 \
        + np.float32([0, 0.5, -2.5])
    d = _unit(rng.normal(size=(500, 3)) * 0.4 + [0, -0.2, 1])
    jt, jh, ju, jv = jrt.ray_triangle(jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(tris))
    tt, th, tu, tv = trt.ray_triangle(_t(o), _t(d), _t(tris))
    jh = np.asarray(jh)
    assert np.array_equal(jh, th.numpy()) and jh.sum() > 50
    assert _rel(tt.numpy()[jh], np.asarray(jt)[jh]) <= 1e-5
    for a, b in ((tu, ju), (tv, jv)):
        assert _rel(a.numpy()[jh], np.asarray(b)[jh]) <= 1e-5


def _flipped(jimg, timg):
    """Pixels whose hit differs, or whose colour differs by more than 1e-4
    (another triangle at an edge the slack lets both triangles claim)."""
    return int((np.asarray(jimg.hit) != timg.hit.numpy()).sum()
               + (np.abs(np.asarray(jimg.color) - timg.color.numpy())
                  .max(-1) > 1e-4).sum())


@pytest.mark.parametrize("env_mode", ["cubemap", "sh"])
def test_render_scene_matches_jax(env_mode):
    """The quad scene at 64x36 with a seeded cubemap in both environment
    modes (the reflection term and the miss background), and without one:
    colour, depth and hit. Measured: no pixel flipped, colour and depth at
    most 6.1e-7 (relative); the bound is 2 flipped pixels and 5e-6 for the
    others."""
    v, norms, mats, leaves = _quad_scene()
    jc, tc = _cams()
    sc = interop.scene_arrays_from_numpy(v, norms, mats, device=CPU)
    tm = interop.pbr_materials_from_numpy(*leaves, device=CPU)
    jm = jpbr.PBRMaterial(*[jnp.asarray(a) for a in leaves])
    for cube in (_cube(), None):
        want = jrt.render_scene(
            jnp.asarray(v), jnp.asarray(norms), jnp.asarray(mats), jm, jc,
            jnp.asarray([2.0, 3.0, -2.0]), env_cube=None if cube is None
            else jnp.asarray(cube), width=W, height=H, env_mode=env_mode)
        got = trt.render_scene(
            sc["tris"], sc["tri_normals"], sc["tri_materials"], tm, tc,
            (2.0, 3.0, -2.0), env_cube=None if cube is None else _t(cube),
            width=W, height=H, env_mode=env_mode)
        assert _flipped(want, got) <= 2
        ok = (np.asarray(want.hit) == got.hit.numpy()) & (np.abs(
            np.asarray(want.color) - got.color.numpy()).max(-1) <= 1e-4)
        assert _rel(got.color.numpy()[ok], np.asarray(want.color)[ok]) \
            <= 5e-6
        assert _rel(got.depth.numpy()[ok], np.asarray(want.depth)[ok]) \
            <= 5e-6
        assert 0 < int(got.hit.sum()) < W * H


def test_render_scene_gradients_and_tiles_match_jax():
    """Gradients of sum(color^2) to the material leaves and the light
    position through render_scene (cubemap mode), against jax.grad; and a
    tiled render (tile=500) equal to the one-pass render bit for bit.
    Measured at most 1.4e-7 (relative; bound 2e-5)."""
    v, norms, mats, leaves = _quad_scene()
    jc, tc = _cams()
    cube = _cube()
    sc = interop.scene_arrays_from_numpy(v, norms, mats, device=CPU)

    def jloss(m, lp):
        img = jrt.render_scene(jnp.asarray(v), jnp.asarray(norms),
                               jnp.asarray(mats), m, jc, lp,
                               env_cube=jnp.asarray(cube), width=W,
                               height=H)
        return jnp.sum(img.color ** 2)

    jg = jax.grad(jloss, argnums=(0, 1))(
        jpbr.PBRMaterial(*[jnp.asarray(a) for a in leaves]),
        jnp.asarray([2.0, 3.0, -2.0]))
    tm = interop.pbr_materials_from_numpy(*leaves, device=CPU,
                                          requires_grad=True)
    lp = _t([2.0, 3.0, -2.0]).requires_grad_()
    img = trt.render_scene(sc["tris"], sc["tri_normals"], sc["tri_materials"],
                           tm, tc, lp, env_cube=_t(cube), width=W, height=H)
    tg = torch.autograd.grad((img.color ** 2).sum(), list(tm)[:3] + [lp])
    for a, b in zip(tg[:3], jg[0][:3]):
        assert _rel(a, b) <= 2e-5
    assert _rel(tg[3], jg[1]) <= 2e-5
    tiled = trt.render_scene(sc["tris"], sc["tri_normals"],
                             sc["tri_materials"], tm, tc, lp,
                             env_cube=_t(cube), width=W, height=H, tile=500)
    for a, b in zip(tiled, img):
        assert torch.equal(a, b)


def test_stack_materials_matches_jax():
    mats = [((0.1, 0.2, 0.3), 0.1, 0.4), ((0.9, 0.8, 0.7), 0.9, 0.2)]
    want = jrt.stack_materials([jpbr.PBRMaterial.make(*m) for m in mats])
    got = trt.stack_materials([tpbr.PBRMaterial.make(*m, device=CPU)
                               for m in mats])
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape and _rel(a, b) == 0


# --------------------------------------------------------------------------
# glTF and the scene graph, on files written here
# --------------------------------------------------------------------------


def _write_scene(tmp_path, textured: bool) -> str:
    """A glTF file (+ .bin, + PNGs when textured) the test writes: a node
    tree of two meshes (the floor under a translated, scaled, rotated
    parent; the wall as its child) with normals and UVs, two materials
    (the floor's with a base-color and a normal texture when textured), and
    an animation of the parent's translation (LINEAR) and rotation (slerp)
    over t in [0, 1]."""
    import imageio.v2 as imageio

    v, _, _, _ = _quad_scene()
    floor, wall = v[:2].reshape(-1, 3), v[2:].reshape(-1, 3)
    uv = np.tile(np.float32([[0, 0], [1.3, 0], [1.3, 1.2]]), (2, 1))
    nrm_f = np.tile(np.float32([[0, 1, 0]]), (6, 1))
    nrm_w = np.tile(np.float32([[0, 0, -1]]), (6, 1))
    idx = np.arange(6, dtype=np.uint32)
    times = np.float32([0.0, 1.0])
    trans = np.float32([[0, 0, 0], [0.2, -0.1, 0.3]])
    rots = np.float32([[0, 0, 0, 1], [0, 0.0998, 0, 0.995]])
    chunks = [floor, nrm_f, uv, idx, wall, nrm_w, uv, idx, times, trans,
              rots]
    blobs = [np.ascontiguousarray(c).tobytes() for c in chunks]
    offs = np.cumsum([0] + [len(b) for b in blobs])[:-1]
    kinds = [("VEC3", 5126), ("VEC3", 5126), ("VEC2", 5126),
             ("SCALAR", 5125)] * 2 + [("SCALAR", 5126), ("VEC3", 5126),
                                      ("VEC4", 5126)]
    views = [{"buffer": 0, "byteOffset": int(o), "byteLength": len(b)}
             for o, b in zip(offs, blobs)]
    accessors = [{"bufferView": i, "componentType": ct, "count": len(c),
                  "type": ty} for i, (c, (ty, ct)) in enumerate(zip(chunks,
                                                                   kinds))]

    def prim(base, mat):
        return {"primitives": [{"attributes": {
            "POSITION": base, "NORMAL": base + 1, "TEXCOORD_0": base + 2},
            "indices": base + 3, "material": mat}]}

    floor_mat = {"pbrMetallicRoughness": {
        "baseColorFactor": [0.55, 0.5, 0.45, 1.0], "metallicFactor": 0.05,
        "roughnessFactor": 0.7}}
    doc = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "children": [1], "translation": [0, 0.1, 0],
                   "scale": [1.0, 1.0, 0.9],
                   "rotation": [0, 0.0499792, 0, 0.9987503]},
                  {"mesh": 1}],
        "meshes": [prim(0, 0), prim(4, 1)],
        "materials": [floor_mat, {"pbrMetallicRoughness": {
            "baseColorFactor": [0.3, 0.4, 0.8, 1.0], "metallicFactor": 0.6,
            "roughnessFactor": 0.3}}],
        "animations": [{"samplers": [
            {"input": 8, "output": 9, "interpolation": "LINEAR"},
            {"input": 8, "output": 10, "interpolation": "LINEAR"}],
            "channels": [
                {"sampler": 0, "target": {"node": 0, "path": "translation"}},
                {"sampler": 1, "target": {"node": 0, "path": "rotation"}}]}],
        "bufferViews": views, "accessors": accessors,
        "buffers": [{"byteLength": int(sum(len(b) for b in blobs))}],
    }
    if textured:
        rng = np.random.default_rng(9)
        imageio.imwrite(tmp_path / "base.png", (rng.uniform(
            size=(12, 10, 3)) * 255).astype(np.uint8))
        nm = np.concatenate([rng.uniform(0.3, 0.7, (8, 8, 2)),
                             np.ones((8, 8, 1))], -1)
        imageio.imwrite(tmp_path / "normal.png", (nm * 255).astype(np.uint8))
        doc["images"] = [{"uri": "base.png"}, {"uri": "normal.png"}]
        doc["textures"] = [{"source": 0}, {"source": 1}]
        floor_mat["pbrMetallicRoughness"]["baseColorTexture"] = {"index": 0}
        floor_mat["normalTexture"] = {"index": 1}
    path = str(tmp_path / "scene.gltf")
    tgltf.GLTF(doc, [b"".join(blobs)]).save(path)
    return path


def test_gltf_round_trip_matches_jax(tmp_path):
    """make_gltf -> save (.gltf + .bin) -> load, and a GLB container the
    test packs: the port reads what it writes and what the JAX package
    reads, accessor for accessor; its documents differ from the JAX
    package's only in the generator's name; the animation samples alike."""
    import json
    import struct

    rng = np.random.default_rng(6)
    pos = rng.normal(size=(9, 3)).astype(np.float32)
    idx = np.arange(9, dtype=np.uint32)[::-1].copy()
    nrm = _unit(rng.normal(size=(9, 3)))
    mat = {"pbrMetallicRoughness": {"metallicFactor": 0.2}}
    tdoc = tgltf.make_gltf(pos, idx, nrm, material=mat)
    jdoc = jgltf.make_gltf(pos, idx, nrm, material=mat)
    tdoc.doc["asset"]["generator"] = jdoc.doc["asset"]["generator"]
    assert tdoc.doc == jdoc.doc and tdoc.buffers == jdoc.buffers
    path = str(tmp_path / "m.gltf")
    tdoc.save(path)
    for g in (tgltf.GLTF.load(path), jgltf.GLTF.load(path)):
        arr = g.primitive_arrays(0)
        assert np.array_equal(arr["POSITION"], pos)
        assert np.array_equal(arr["NORMAL"], nrm)
        assert np.array_equal(arr["indices"], idx)
    js = json.dumps(tdoc.doc).encode()
    js += b" " * (-len(js) % 4)
    binc = tdoc.buffers[0] + b"\0" * (-len(tdoc.buffers[0]) % 4)
    glb = (struct.pack("<III", tgltf.GLB_MAGIC, 2, 12 + 8 + len(js) + 8
                       + len(binc)) + struct.pack("<II", len(js),
                                                  tgltf.GLB_JSON) + js
           + struct.pack("<II", len(binc), tgltf.GLB_BIN) + binc)
    (tmp_path / "m.glb").write_bytes(glb)
    tg, jg = (tgltf.GLTF.load(str(tmp_path / "m.glb")),
              jgltf.GLTF.load(str(tmp_path / "m.glb")))
    assert np.array_equal(tg.primitive_arrays(0)["POSITION"], pos)
    assert tg.doc == jg.doc
    sp = _write_scene(tmp_path, textured=False)
    tg, jg = tgltf.GLTF.load(sp), jgltf.GLTF.load(sp)
    for t in (-0.5, 0.0, 0.37, 1.0, 2.0):
        ta, ja = tg.sample_animation(0, t), jg.sample_animation(0, t)
        assert ta.keys() == ja.keys()
        for node in ta:
            for key in ta[node]:
                assert np.array_equal(ta[node][key], ja[node][key])
        assert np.array_equal(tg.node_local_matrix_at(0, 0, t),
                              jg.node_local_matrix_at(0, 0, t))


@pytest.mark.parametrize("at_time", [None, 0.4])
def test_scene_load_matches_jax(tmp_path, at_time):
    """Scene.load (static and at_time=) of the textured scene: the triangle
    soup, the UVs, the texture stack with its indices and the stacked
    materials equal the JAX package's (the same numpy code); then export
    and load again."""
    path = _write_scene(tmp_path, textured=True)
    js, ts = (jscene.Scene.load(path, at_time=at_time),
              tscene.Scene.load(path, at_time=at_time))
    for a, b in zip(ts.triangle_soup(device=CPU), js.triangle_soup()):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(ts.triangle_uvs(device=CPU).numpy(),
                          np.asarray(js.triangle_uvs()))
    for a, b in zip(ts.texture_stack(res=16, device=CPU),
                    js.texture_stack(res=16)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(ts.stacked_materials(device=CPU), js.stacked_materials()):
        assert np.array_equal(a.numpy(), np.asarray(b))
    ts.export(str(tmp_path / "again.gltf"))
    back = tscene.Scene.load(str(tmp_path / "again.gltf"), at_time=at_time)
    tris = ts.triangle_soup(device=CPU)[0]
    assert torch.equal(back.triangle_soup(device=CPU)[0], tris)
    moved = tscene.Scene.load(path, at_time=0.9).triangle_soup(device=CPU)[0]
    assert not torch.equal(moved, tris)


@pytest.mark.parametrize("env_mode", ["cubemap", "sh"])
def test_textured_render_scene_matches_jax(tmp_path, env_mode):
    """render_scene of the loaded textured scene (base-color and normal
    maps through the barycentric UVs, the tangent frames and the
    wrap-around stack gather) against the JAX package's on the same
    arrays, with a seeded cubemap. Measured: no pixel flipped, colour at
    most 1.8e-6 (relative); bounds 2 flipped pixels and 2e-5."""
    path = _write_scene(tmp_path, textured=True)
    js = jscene.Scene.load(path, at_time=0.4)
    tris, norms, mats = js.triangle_soup()
    tex, base, nrm = js.texture_stack(res=16)
    sc = interop.scene_arrays_from_numpy(tris, norms, mats,
                                         js.triangle_uvs(), tex, base, nrm,
                                         device=CPU)
    jm = js.stacked_materials()
    tm = interop.pbr_materials_from_numpy(*[np.asarray(a) for a in jm],
                                          device=CPU)
    jc, tc = _cams()
    cube = _cube(5)
    want = jrt.render_scene(tris, norms, mats, jm, jc,
                            jnp.asarray([2.0, 3.0, -2.0]),
                            env_cube=jnp.asarray(cube), width=W, height=H,
                            tri_uvs=js.triangle_uvs(), textures=tex,
                            mat_base_tex=base, mat_normal_tex=nrm,
                            env_mode=env_mode)
    got = trt.render_scene(
        sc["tris"], sc["tri_normals"], sc["tri_materials"], tm, tc,
        (2.0, 3.0, -2.0), env_cube=_t(cube), width=W, height=H,
        tri_uvs=sc["tri_uvs"], textures=sc["textures"],
        mat_base_tex=sc["mat_base_tex"], mat_normal_tex=sc["mat_normal_tex"],
        env_mode=env_mode)
    assert _flipped(want, got) <= 2
    ok = (np.asarray(want.hit) == got.hit.numpy()) & (np.abs(
        np.asarray(want.color) - got.color.numpy()).max(-1) <= 1e-4)
    assert _rel(got.color.numpy()[ok], np.asarray(want.color)[ok]) <= 2e-5
    # The textures show: the same render without them differs.
    plain = trt.render_scene(sc["tris"], sc["tri_normals"],
                             sc["tri_materials"], tm, tc, (2.0, 3.0, -2.0),
                             env_cube=_t(cube), width=W, height=H,
                             env_mode=env_mode)
    assert float((plain.color - got.color).abs().max()) > 1e-2


def test_tangent_frames_and_sample_stack_match_jax():
    """tangent_frames of seeded triangles and UVs (degenerate UVs give 0),
    and _sample_stack with negative and out-of-range UVs and texture
    indices. Measured at most 1.3e-7 (relative)."""
    rng = np.random.default_rng(8)
    tris = rng.normal(size=(20, 3, 3)).astype(np.float32)
    uvs = rng.uniform(-1, 2, (20, 3, 2)).astype(np.float32)
    uvs[3] = uvs[3, :1]                                  # degenerate
    for a, b in zip(trt.tangent_frames(_t(tris), _t(uvs)),
                    jrt.tangent_frames(jnp.asarray(tris), jnp.asarray(uvs))):
        assert _rel(a, b) <= 1e-6
    stack = rng.uniform(size=(3, 5, 5, 3)).astype(np.float32)
    idx = rng.integers(-2, 5, 100).astype(np.int32)
    uv = rng.uniform(-2.5, 2.5, (100, 2)).astype(np.float32)
    want = jrt._sample_stack(jnp.asarray(stack), jnp.asarray(idx),
                             jnp.asarray(uv))
    got = trt._sample_stack(_t(stack), _t(idx, np.int64), _t(uv))
    assert _rel(got, want) <= 1e-6
