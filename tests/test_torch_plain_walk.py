"""The plain sweep's walk over the occupied cells' bounding box against the
walk over every interior cell that it replaced.

`ops/sph_sweep._sweep_plain` is the reference every kernel and every CPU
test of the port is held against. It evaluates own cells only inside the
bounding box of the occupied interior cells: every other own cell's
outputs are 0 once masked. This file keeps the full-range walk and holds
each plain sweep and adjoint sweep, both walks on the same planes, to bit
equality (measured: 0 difference on every output): the halo-filled slab
planes of the sharded steps (occupied ghost columns, zero edge ghosts) and
the planes of a dam break that fills part of its domain.
"""

import numpy as np
import pytest
import torch

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.models.particles import dam_break_state
from dieselfluid_tpu_torch.neighbors.calibrate import lattice_rest_density
from dieselfluid_tpu_torch.ops import cellops as tc
from dieselfluid_tpu_torch.ops import sph_sweep as sw
from dieselfluid_tpu_torch.ops.smoothing import KernelCoeffs
from dieselfluid_tpu_torch.parallel import dense_halo as pdh
from dieselfluid_tpu_torch.parallel.mesh import LocalMesh

N3 = 12
DX = 2.0 / N3 * 0.5


def _sweep_full_range(pair, ins, n_out, spec, chunk_elems=1 << 25):
    """The walk over every interior own cell, chunked over x."""
    px, py, cap = spec.px, spec.py, spec.capacity
    nx, ny = spec.nx, spec.ny
    ncz = spec.row_len // cap
    cells = {n: p.view(px, py, ncz, cap) for n, p in ins.items()}
    outs = [torch.zeros((px, py, ncz, cap), dtype=torch.float32)
            for _ in range(n_out)]
    step = max(1, chunk_elems // (ny * (ncz - 2) * cap * cap))
    for x0 in range(1, nx + 1, step):
        x1 = min(x0 + step, nx + 1)
        own = {n: c[x0:x1, 1:ny + 1, 1:ncz - 1, :, None]
               for n, c in cells.items()}
        acc = [None] * n_out
        for ox in (-1, 0, 1):
            for oy in (-1, 0, 1):
                for oz in (-1, 0, 1):
                    cand = {n: c[x0 + ox:x1 + ox, 1 + oy:ny + 1 + oy,
                                 1 + oz:ncz - 1 + oz, None, :]
                            for n, c in cells.items()}
                    contrib = pair(own, cand)
                    for o in range(n_out):
                        s = contrib[o].sum(dim=-1)
                        acc[o] = s if acc[o] is None else acc[o] + s
        own_m = own["mask"][..., 0]
        for o in range(n_out):
            outs[o][x0:x1, 1:ny + 1, 1:ncz - 1, :] = acc[o] * own_m
    return [o.view(spec.plane_shape) for o in outs]


def _channels(n, d0, rng):
    vals = {c: rng.normal(size=n).astype(np.float32)
            for c in ("vx", "vy", "vz", "ct_0", "ct_1", "ct_2")}
    vals["rho"] = (rng.uniform(0.9, 1.2, n) * d0).astype(np.float32)
    vals["press"] = rng.uniform(0.0, 50.0, n).astype(np.float32)
    vals["pq"] = vals["press"] / vals["rho"] ** 2
    return {c: torch.from_numpy(v) for c, v in vals.items()}


@pytest.fixture(scope="module")
def cases():
    """(params, [(spec, planes)]): one slab's halo-filled planes (slab 1 of
    4, ghost columns occupied on its low side) and a dam break's planes on
    a domain twice its width, with seeded velocities, rho, pressure, pq and
    cotangents."""
    params = lattice_rest_density(DX, FluidParams.for_spacing(DX))
    rng = np.random.default_rng(23)
    pos = dam_break_state(N3, params, "cpu", extent=0.75).pos.numpy()
    pos = pos + rng.uniform(-0.3, 0.3, pos.shape).astype(np.float32) * DX
    ch = _channels(pos.shape[0], params.d0, rng)
    spec = pdh.DenseSlabSpec.build(4, params.h, capacity=pos.shape[0],
                                   migrate_capacity=64, cell_capacity=16)
    lspec = spec.local_spec
    mesh = LocalMesh((4,), "cpu")
    x = torch.from_numpy(pos[:, 0])
    shard = torch.clamp(((x - spec.lo) / spec.slab_width).long(), 0, 3)
    slab = []
    for s, me in enumerate(mesh.axis_index("sp")):
        sel = shard == s
        p = torch.from_numpy(pos)[sel]
        entries, flat, valid, _, _, _ = pdh._local_layout(
            p, torch.ones(p.shape[0]), spec, lspec, me)
        vals = {c: v[sel] for c, v in ch.items()}
        vals.update(x=entries[:, 0], y=entries[:, 1], z=entries[:, 2])
        slab.append(tc.build_planes(vals, flat, valid, lspec))
    slab = pdh._exchange_all(mesh, slab, lspec, list(slab[0]))
    slab = [pdh._shift_ghost_x(p, lspec, spec.slab_width) for p in slab]
    assert float(slab[1]["mask"][:lspec.py].sum()) > 0

    dam = dam_break_state(N3, params, "cpu", extent=0.5).pos
    gspec = tc.DenseCellSpec.for_domain((-1.0,) * 3, (1.0,) * 3, params.h,
                                        capacity=16)
    flat, valid, _ = tc.dense_indices(dam, gspec)
    vals = _channels(dam.shape[0], params.d0, rng)
    vals.update(x=dam[:, 0], y=dam[:, 1], z=dam[:, 2])
    whole = tc.build_planes(vals, flat, valid, gspec)
    return params, [(lspec, slab[1]), (gspec, whole)]


def _call(name, params, spec, p):
    k = KernelCoeffs.build(params.h)
    m, mu = params.mass, 0.3
    cts = (p["ct_0"], p["ct_1"], p["ct_2"])
    f = sw.plain
    return {
        "density": lambda: (f.density_planes(p, spec, k, m),),
        "force": lambda: f.force_planes(p, p["rho"], p["press"], spec, k,
                                        m, mu),
        "force_p": lambda: f.force_planes(p, p["rho"], p["press"], spec, k,
                                          m, 0.0),
        "viscosity": lambda: f.viscosity_force_planes(p, p["rho"], spec, k,
                                                      m, mu),
        "pressure_pq": lambda: f.pressure_force_pq_planes(p, p["pq"], spec,
                                                          k, m),
        "pressure": lambda: f.pressure_force_planes(p, p["rho"], p["press"],
                                                    spec, k, m),
        "density_bwd": lambda: f.density_sum_bwd(p, cts[0], spec, k),
        "pressure_bwd": lambda: f.press_sum_bwd(p, p["rho"], p["press"], cts,
                                                spec, k),
        "viscosity_bwd": lambda: f.visc_sum_bwd(p, p["rho"], cts, spec, k),
        "force_bwd": lambda: f.force_sum_bwd(p, p["rho"], p["press"], cts,
                                             spec, k, m, mu),
    }[name]()


NAMES = ["density", "force", "force_p", "viscosity", "pressure_pq",
         "pressure", "density_bwd", "pressure_bwd", "viscosity_bwd",
         "force_bwd"]


@pytest.mark.parametrize("case", [0, 1], ids=["slab", "dam"])
@pytest.mark.parametrize("name", NAMES)
def test_bounding_box_walk_equals_full_range_walk(cases, monkeypatch, name,
                                                  case):
    params, planes = cases
    spec, p = planes[case]
    got = _call(name, params, spec, p)
    monkeypatch.setattr(sw, "_sweep_plain", _sweep_full_range)
    want = _call(name, params, spec, p)
    assert max(float(w.abs().max()) for w in want) > 0.0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0.0, atol=0.0)
