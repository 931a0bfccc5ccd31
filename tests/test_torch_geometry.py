"""The port's geometry (triangle, mesh, octree) and mathx/ray against the
JAX package's, on the CPU, and one dense WCSPH step with `collider=`
against the JAX dense step (Pallas in interpret mode).

Inputs are seeded numpy arrays fed to both packages. Tolerances are
absolute on O(1) values, about 10x the drift measured (beside each); the
discrete outputs (hit masks, chosen triangles, octant paths) are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dieselfluid_tpu.geometry import mesh as jmesh
from dieselfluid_tpu.geometry import octree as joct
from dieselfluid_tpu.geometry import triangle as jtri
from dieselfluid_tpu.mathx import ray as jray
from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.geometry import mesh as tmesh
from dieselfluid_tpu_torch.geometry import octree as toct
from dieselfluid_tpu_torch.geometry import triangle as ttri
from dieselfluid_tpu_torch.mathx import ray as tray

torch.set_num_threads(1)

# max |port - jax| over the O(1) outputs (measured at most 1.2e-7)
ATOL = 2e-6


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


@pytest.fixture(scope="module")
def tris_points():
    rng = np.random.default_rng(21)
    tris = rng.uniform(-1, 1, size=(40, 3, 3)).astype(np.float32)
    pts = rng.uniform(-1.5, 1.5, size=(40, 3)).astype(np.float32)
    # Points on the triangles' planes, inside them (barycentric), so the
    # inside tests and the face region of closest_point are exercised.
    w = rng.dirichlet((1, 1, 1), size=20).astype(np.float32)
    pts[:20] = np.einsum("tk,tkd->td", w, tris[:20])
    return tris, pts


def test_triangle_functions_match_jax(tris_points):
    tris, pts = tris_points
    jt, jp, tt, tp = jnp.asarray(tris), jnp.asarray(pts), _t(tris), _t(pts)
    _close(ttri.normal(tt), jtri.normal(jt))
    tc, ti = ttri.barycentric(tt, tp)
    jc, ji = jtri.barycentric(jt, jp)
    _close(tc, jc)                      # coordinates up to ~10 (measured 0)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert bool(ti[:20].all())
    _close(ttri.closest_point(tt, tp), jtri.closest_point(jt, jp))
    vel = np.random.default_rng(2).normal(size=pts.shape).astype(np.float32)
    n = jtri.normal(jt)
    jh, jd, _ = jtri.swept_collision(jt, n, jp, jnp.asarray(vel), 0.01, 0.2)
    th, td, _ = ttri.swept_collision(tt, ttri.normal(tt), tp, _t(vel), 0.01,
                                     0.2)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert bool(th.any())
    _close(td, jd, atol=6e-5)           # distances up to ~1e3 (measured 5.7e-6)


def test_closest_point_covers_every_region():
    """Points around one triangle fall in all seven Voronoi regions; the
    port's closest points equal JAX's."""
    tri = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    g = np.linspace(-0.5, 1.5, 9, dtype=np.float32)
    gx, gy = np.meshgrid(g, g, indexing="ij")
    pts = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, 0.3)],
                   -1).astype(np.float32)
    want = np.asarray(jtri.closest_point(jnp.asarray(tri)[None],
                                         jnp.asarray(pts)))
    got = ttri.closest_point(_t(tri)[None], _t(pts))
    _close(got, want)
    assert len(np.unique(np.round(want, 5), axis=0)) > 7


@pytest.fixture(scope="module")
def container():
    j = jmesh.box(1.8, 1.6, 1.4, origin=(-0.1, 0.05, 0.1))
    return j, tmesh.box(1.8, 1.6, 1.4, origin=(-0.1, 0.05, 0.1),
                        device="cpu")


def test_box_and_boundary_particles_match_jax(container):
    j, t = container
    np.testing.assert_array_equal(t.tris.numpy(), np.asarray(j.tris))
    _close(t.normals, j.normals, atol=1e-7)
    assert t.num_triangles == j.num_triangles == 12
    for density in (1.0, 3.0):
        _close(t.generate_boundary_particles(density),
               j.generate_boundary_particles(density))
    verts = np.asarray(j.tris).reshape(-1, 3)
    m = tmesh.Mesh.from_vertices(verts, (-0.1, 0.05, 0.1), device="cpu")
    np.testing.assert_array_equal(m.normals.numpy(), t.normals.numpy())


def test_mesh_collision_matches_jax(container):
    j, t = container
    rng = np.random.default_rng(5)
    pos = rng.uniform(-1.1, 1.0, size=(300, 3)).astype(np.float32)
    vel = rng.normal(size=pos.shape).astype(np.float32)
    jh, jn, jd = j.collide(jnp.asarray(pos), 0.1)
    th, tn, td = t.collide(_t(pos), 0.1)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert 10 < int(th.sum()) < 300
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _close(td, jd)
    jh, jn, jd = j.collide_swept(jnp.asarray(pos), jnp.asarray(vel), 0.01,
                                 0.1)
    th, tn, td = t.collide_swept(_t(pos), _t(vel), 0.01, 0.1)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert bool(th.any())
    _close(tn, jn, atol=1e-7)
    _close(td, jd)

    from dieselfluid_tpu.models.particles import FluidState as JState
    from dieselfluid_tpu_torch.models.particles import zero_state

    ts = zero_state(300, device="cpu")._replace(pos=_t(pos), vel=_t(vel))
    js = JState(*(jnp.asarray(x.numpy()) for x in ts[:5]))
    jo = jmesh.mesh_collide(js, j, 0.01, 0.1)
    to = tmesh.mesh_collide(ts, t, 0.01, 0.1)
    _close(to.pos, jo.pos)
    _close(to.vel, jo.vel)              # |v| up to ~4 (measured 0)


def test_mesh_from_numpy_keeps_the_jax_mesh(container):
    j, _ = container
    m = interop.mesh_from_numpy(np.asarray(j.tris), np.asarray(j.normals),
                                device="cpu")
    np.testing.assert_array_equal(m.tris.numpy(), np.asarray(j.tris))
    np.testing.assert_array_equal(m.normals.numpy(), np.asarray(j.normals))


def test_octree_matches_jax():
    rng = np.random.default_rng(8)
    pts = rng.uniform(-1, 1, size=(200, 3)).astype(np.float32)
    bounds, origin = (2.0, 2.0, 2.0), (0.0, 0.0, 0.0)
    want = np.asarray(joct.encode_points(pts, bounds, origin, depth=6))
    got = toct.encode_points(_t(pts), bounds, origin, depth=6)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        toct.encode_points(pts, bounds, origin, 4, device="cpu").numpy(),
        want[:, :4])
    assert toct.depth_similarity(want[0], want[1]) == \
        joct.depth_similarity(want[0], want[1])
    assert toct.depth_similarity(want[3], want[3]) == 6
    near = np.asarray(joct.encode_points(pts[:1] + 1e-3 * np.arange(
        5, dtype=np.float32)[:, None], bounds, origin, 6))
    np.testing.assert_array_equal(toct.group_encoding(near),
                                  joct.group_encoding(near))
    np.testing.assert_array_equal(toct.centroid_of(want[7], bounds, origin),
                                  joct.centroid_of(want[7], bounds, origin))
    jt, tt = joct.OctalTree(bounds), toct.OctalTree(bounds)
    jt.insert_points(pts)
    tt.insert_points(_t(pts))
    assert jt.table == tt.table
    assert tt.neighbors(want[0]) == jt.neighbors(want[0])
    tt.remove_point(want[0], 0)
    jt.remove_point(want[0], 0)
    assert jt.table == tt.table


def test_ray_sphere_intersection_matches_jax():
    rng = np.random.default_rng(4)
    r0 = rng.uniform(-3, 3, size=(500, 3)).astype(np.float32)
    d0 = rng.normal(size=(500, 3)).astype(np.float32)
    c = np.asarray([0.2, -0.1, 0.3], np.float32)
    jp, jh = jray.ray_sphere_intersection(jnp.asarray(r0), jnp.asarray(d0),
                                          jnp.asarray(c), 1.5)
    tp, th = tray.ray_sphere_intersection(_t(r0), _t(d0), _t(c), 1.5)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert 20 < int(th.sum()) < 480
    _close(tp, jp, atol=3e-6)           # |point| up to ~5 (measured 2.4e-7)
    _close(tray._proj(_t(r0), _t(d0)), jray._proj(jnp.asarray(r0),
                                                  jnp.asarray(d0)),
           atol=3e-6)
    ray = tray.Ray(_t(r0), _t(d0))
    assert ray.origin.shape == (500, 3)


# One dense WCSPH step with the collider: max |port - jax| / max |jax| per
# field (measured pos 6.2e-8, vel 1.1e-6, density 1.7e-7).
DENSE_TOL = {"pos": 1e-6, "vel": 2e-5, "density": 2e-6}


def test_dense_wcsph_step_with_collider_matches_jax():
    """The JAX boundary test's container (box 1.8 at -0.1) as boundary
    particles and collider around a 216-particle jittered dam break with
    seeded velocities, moved 0.055 off its walls (inside the contact
    radius h / 2), one dense_wcsph_step in both packages, no box clamp:
    the smallest dense step that has contacts (a JAX interpret-mode
    PCISPH step takes a minute)."""
    from dieselfluid_tpu.config import FluidParams
    from dieselfluid_tpu.models.particles import FluidState as JState
    from dieselfluid_tpu.models.particles import dam_break_state
    from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density
    from dieselfluid_tpu.ops.cellops import DenseCellSpec
    from dieselfluid_tpu.solvers import dense_step as jds
    from dieselfluid_tpu_torch.solvers import dense_step as tds

    n3 = 6
    dx = (2.0 / n3) * 0.5
    params = lattice_rest_density(dx, FluidParams.for_spacing(dx))
    off = params.h / 4.0
    jspec = DenseCellSpec.for_domain((-1 - off,) * 3, (1 + off,) * 3,
                                     params.h, capacity=16)
    s = dam_break_state(n3, params, extent=0.5)
    rng = np.random.default_rng(6)
    arrays = {k: np.asarray(getattr(s, k)) for k in
              ("pos", "vel", "force", "density", "pressure")}
    arrays["pos"] = (arrays["pos"] + rng.normal(size=s.pos.shape) * 0.1 * dx
                     + 0.055).astype(np.float32)
    arrays["vel"] = (rng.normal(size=s.vel.shape) * 0.5).astype(np.float32)
    container = jmesh.box(1.8, 1.8, 1.8, origin=(-0.1, -0.1, -0.1))
    mesh = interop.mesh_from_numpy(np.asarray(container.tris),
                                   np.asarray(container.normals),
                                   device="cpu")
    bnd = np.asarray(container.generate_boundary_particles(1.0))
    js = JState(**{k: jnp.asarray(v) for k, v in arrays.items()},
                boundary_pos=jnp.asarray(bnd))
    ts = interop.fluid_state_from_numpy(**arrays, boundary_pos=bnd,
                                        device="cpu")
    with pltpu.force_tpu_interpret_mode():
        jo, jd = jds.dense_wcsph_step(js, params, jspec, bounds=None,
                                      collider=container)
    to, td = tds.dense_wcsph_step(ts, interop.fluid_params_from(params),
                                  interop.cell_spec_from_jax(jspec),
                                  bounds=None, collider=mesh)
    hit, _, _ = container.collide(jnp.asarray(arrays["pos"]),
                                  0.5 * params.h)
    assert int(np.asarray(hit).sum()) > 20
    assert int(td.overflow) == int(jd.overflow) == 0
    for f, tol in DENSE_TOL.items():
        want = np.asarray(getattr(jo, f), np.float64)
        got = getattr(to, f).numpy()
        assert np.abs(got - want).max() / np.abs(want).max() < tol, f
