"""Plain SPH reference for the benchmark's correctness check.

Plain PyTorch, written from the equations and the configuration files. It
imports nothing of the program and takes nothing the program has made: the
parameters (rest density, stiffness, time step, the PCISPH factor) are worked
out here from the configuration, and the neighbour candidates are binned here.

One step, for every particle i (sums over the candidates j: the particles
binned, from the binning positions, in the 27 cells of edge `cell` around
i's cell; cells clamped to the grid):

    rho_i  = m sum_{|r_ij| < h} A (1 - r^2 / h^2)^2            (self included)
    p_i    = (w / gamma) ((max(rho_i, d0) / d0)^gamma - 1)
    f_i    = m^2 sum (p_i / rho_i^2 + p_j / rho_j^2) B (1 - r/h)^2 r_ij / r
           + mu m sum C (1 - r/h) (v_j - v_i) / rho_j             (0 < r < h)
    v' = v + (f / m + g) dt,  x' = x + v' dt,  then the box: clamp, reflect
    the velocity component that hit by -restitution, damp the others by
    (1 - friction).

with A = 315 / (64 pi h^3), B = -45 / (pi h^4), C = 90 / (pi h^5) and
r_ij = x_j - x_i. PCISPH (Solenthaler and Pajarola 2009) replaces the
pressure force by its correction loop: predict x* from the external force
(viscosity and gravity) and the pressure force so far, sum rho* at x*,
p <- max(p + delta (rho* - d0), 0), pressure force from p / max(rho*, d0/2)^2
at the current positions; until max(rho* - d0, 0) / d0 <= the error ratio or
the iteration limit.

Sums run in `dtype` (float64 for the reference); the state is rounded to
`state_dtype` where the configuration keeps it (float32), with the
integration in that precision. The control runs both in bfloat16. A
particle that lands within a rounding tie of a wall gets both outcomes of
the wall test (`integrate`).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

_EPS = 1e-12


class Params(NamedTuple):
    dx: float
    h: float
    mass: float
    d0: float
    mu: float
    dt: float
    gravity: tuple
    tait_gamma: float
    tait_w: float
    max_iters: int
    max_error_ratio: float
    delta: float


def _lattice_offsets(dx: float, h: float):
    r = int(math.ceil(h / dx))
    ax = torch.arange(-r, r + 1, dtype=torch.float64) * dx
    g = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1)
    return g.reshape(-1, 3)


def params_from_config(cfg: dict) -> Params:
    """The fluid parameters the configuration states, worked out from its
    sizes: h = h_factor dx, the time step 0.25 h / c, the rest density of
    the lattice interior (self included), w = d0 c^2, and the PCISPH factor
    delta = -1 / (beta (-|sum grad W|^2 - sum |grad W|^2)), beta =
    dt^2 m^2 2 / d0^2, over the filled lattice neighbourhood."""
    f = cfg["fluid"]
    n3 = int(cfg["n3"])
    dx = 2.0 * float(cfg["extent"]) / n3
    h = float(f["h_factor"]) * dx
    c = float(f["sound_speed"])
    m = float(f["mass"])
    dt = 0.25 * h / c
    a = 315.0 / (64.0 * math.pi * h ** 3)
    b = -45.0 / (math.pi * h ** 4)
    off = _lattice_offsets(dx, h)
    d2 = (off * off).sum(-1)
    q = 1.0 - d2 / (h * h)
    d0 = float(m * torch.where(d2 < h * h, a * q * q, 0.0).sum())
    d = d2.sqrt()
    sel = (d > 0) & (d < h)
    grad = off[sel] / d[sel, None] * (-(b * (1.0 - d[sel] / h) ** 2))[:, None]
    denom = -float((grad.sum(0) ** 2).sum()) - float((grad * grad).sum())
    beta = dt * dt * m * m * 2.0 / (d0 * d0)
    return Params(dx=dx, h=h, mass=m, d0=d0, mu=float(f["mu"]),
                  dt=dt, gravity=tuple(float(g) for g in f["gravity"]),
                  tait_gamma=float(f["tait_gamma"]), tait_w=d0 * c * c,
                  max_iters=int(f["pcisph_max_iters"]),
                  max_error_ratio=float(f["pcisph_max_density_error_ratio"]),
                  delta=-1.0 / (beta * denom))


def dam_break(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's start state from `seed`: the n3^3 lattice of
    spacing dx from the corner `lo`, each position moved by U(-j, j) dx per
    axis, velocities N(0, speed^2), made on `device` by one generator.
    float32, as the program keeps its state."""
    n3 = int(cfg["n3"])
    s = cfg["start"]
    dx = 2.0 * float(cfg["extent"]) / n3
    ax = torch.arange(n3, dtype=torch.float32, device=device)
    ijk = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1)
    lo = torch.tensor(s["corner"], dtype=torch.float32, device=device)
    pos = lo + ijk.reshape(-1, 3) * torch.tensor(dx, dtype=torch.float32)
    del ijk
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    jit = torch.rand(pos.shape, generator=g, device=device)
    pos += (jit * 2.0 - 1.0) * (float(s["jitter"]) * dx)
    del jit
    vel = torch.randn(pos.shape, generator=g, device=device) * float(
        s["speed"])
    return {"pos": pos, "vel": vel,
            "press": torch.zeros(pos.shape[0], dtype=torch.float32,
                                 device=device)}


def cell_coords(pos: torch.Tensor, lo, cell: float, dims) -> torch.Tensor:
    """Integer cell coordinates of `pos`, clamped to the grid: float32
    (pos - lo) times the float32 reciprocal of the edge, floored (the
    binning rule of the configuration: a position within an ulp of a face
    falls on the side this rounding gives, so it is part of the rule)."""
    dev = pos.device
    lo_t = torch.tensor(lo, dtype=torch.float32, device=dev)
    inv = (torch.tensor(1.0, dtype=torch.float32)
           / torch.tensor(cell, dtype=torch.float32)).to(dev)
    ijk = torch.floor((pos.to(torch.float32) - lo_t) * inv).to(torch.int64)
    hi = torch.tensor(dims, dtype=torch.int64, device=dev) - 1
    return torch.minimum(ijk.clamp(min=0), hi)


class Cells:
    """The candidate structure: particles by their integer cell coordinates
    `ijk` on a grid of `dims` cells, sorted by cell."""

    OFFSETS = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
               for c in (-1, 0, 1)]

    def __init__(self, ijk: torch.Tensor, dims):
        dev = ijk.device
        self.dims = torch.tensor(dims, dtype=torch.int64, device=dev)
        self.ijk = ijk
        cid = self._cid(self.ijk)
        self.order = torch.argsort(cid, stable=True)
        self.sorted = cid[self.order].contiguous()
        self.max_count = int(torch.bincount(cid).max())
        self.offsets = torch.tensor(self.OFFSETS, dtype=torch.int64,
                                    device=dev)

    def _cid(self, ijk):
        ny, nz = self.dims[1], self.dims[2]
        return (ijk[..., 0] * ny + ijk[..., 1]) * nz + ijk[..., 2]

    def candidates(self, rows: slice):
        """(j, ok): for the particles `rows`, the indices of the particles
        in the 27 cells around theirs, (rows, 27 * max_count), and which
        entries are real."""
        nb = self.ijk[rows, None, :] + self.offsets
        inside = ((nb >= 0) & (nb < self.dims)).all(-1)
        cid = self._cid(nb)
        start = torch.searchsorted(self.sorted, cid)
        end = torch.searchsorted(self.sorted, cid, right=True)
        k = torch.arange(self.max_count, device=nb.device)
        slot = start[..., None] + k
        ok = inside[..., None] & (slot < end[..., None])
        slot = torch.where(ok, slot, 0)
        j = self.order[slot]
        n = j.shape[0]
        return j.reshape(n, -1), ok.reshape(n, -1)


def _chunks(n: int, size: int):
    for a in range(0, n, size):
        yield slice(a, min(a + size, n))


def _geometry(cells, rows, pos):
    j, ok = cells.candidates(rows)
    r = pos[j] - pos[rows, None, :]
    return j, ok, r, (r * r).sum(-1)


def density(cells: Cells, pos: torch.Tensor, prm: Params, chunk: int):
    """rho at `pos` (sums in pos.dtype) over the candidates of `cells`."""
    a = 315.0 / (64.0 * math.pi * prm.h ** 3)
    h2 = prm.h * prm.h
    out = torch.empty(pos.shape[0], dtype=pos.dtype, device=pos.device)
    for rows in _chunks(pos.shape[0], chunk):
        _, ok, _, d2 = _geometry(cells, rows, pos)
        q = 1.0 - d2 / h2
        out[rows] = prm.mass * torch.where(ok & (d2 < h2), a * q * q,
                                           0.0).sum(-1)
    return out


def tait(rho: torch.Tensor, prm: Params):
    x = torch.clamp(rho, min=prm.d0)
    return (prm.tait_w / prm.tait_gamma) * (
        torch.pow(x / prm.d0, prm.tait_gamma) - 1.0)


def pair_forces(cells: Cells, pos, vel, pq, iv, prm: Params, chunk: int,
                mu: float):
    """sum_j m^2 (pq_i + pq_j) B (1 - r/h)^2 r_ij / r, plus (mu != 0)
    mu m sum_j C (1 - r/h) iv_j (v_j - v_i), over 0 < r < h."""
    b = -45.0 / (math.pi * prm.h ** 4)
    c = 90.0 / (math.pi * prm.h ** 5)
    h2 = prm.h * prm.h
    m = prm.mass
    out = torch.empty_like(pos)
    for rows in _chunks(pos.shape[0], chunk):
        j, ok, r, d2 = _geometry(cells, rows, pos)
        live = ok & (d2 > _EPS) & (d2 < h2)
        dist = torch.sqrt(torch.where(live, d2, 1.0))
        q1 = 1.0 - dist / prm.h
        s_p = torch.where(live, (m * m) * (pq[rows, None] + pq[j]) * b
                          * q1 * q1 / dist, 0.0)
        f = (s_p[..., None] * r).sum(1)
        if mu != 0.0:
            s_v = torch.where(live, (mu * m) * c * q1 * iv[j], 0.0)
            f = f + (s_v[..., None] * (vel[j] - vel[rows, None, :])).sum(1)
        out[rows] = f
    return out


def integrate(pos, vel, accel, prm: Params, box, restitution: float,
              friction: float):
    """Semi-implicit Euler and the box, in the state's precision: (x, v)
    and the other side of every tie (x_alt, v_alt). A particle whose new
    coordinate lies within TIE of a wall sits on a rounding tie of the
    wall test: float32 work of another order may put it on either side, so
    either outcome is the step's (the alternative flips the test of each
    tied axis; elsewhere it equals x, v)."""
    dt = torch.tensor(prm.dt, dtype=pos.dtype, device=pos.device)
    v = vel + accel.to(pos.dtype) * dt
    x = pos + v * dt
    lo = torch.tensor(box[0], dtype=pos.dtype, device=pos.device)
    hi = torch.tensor(box[1], dtype=pos.dtype, device=pos.device)
    hit = (x < lo) | (x > hi)
    tol = TIE * torch.clamp(torch.maximum(lo.abs(), hi.abs()), min=1.0)
    tie = ((x - lo).abs() <= tol) | ((x - hi).abs() <= tol)

    def collide(h):
        xc = torch.minimum(torch.maximum(x, lo), hi)
        vc = torch.where(h, -restitution * v, v)
        vc = torch.where(h.any(-1, keepdim=True) & ~h,
                         (1.0 - friction) * vc, vc)
        return xc, vc

    xc, vc = collide(hit)
    xa, va = collide(hit ^ tie)
    return xc, vc, xa, va


#: Half-width of a wall test's rounding tie, relative to the wall's
#: coordinate (at least 1): 4 float32 ulps at 1.
TIE = 2.0 ** -21


class Step(NamedTuple):
    pos: torch.Tensor
    vel: torch.Tensor
    press: torch.Tensor
    iters: int
    max_count: int
    pos_alt: torch.Tensor      # the other side of the wall tests' ties
    vel_alt: torch.Tensor


def step(state: Dict[str, torch.Tensor], prm: Params, ijk: torch.Tensor,
         dims, solver: str, box, *,
         warm_start: bool = False, dtype=torch.float64,
         state_dtype=torch.float32, chunk: int = 65536,
         restitution: float = 0.3, friction: float = 0.1) -> Step:
    """One WCSPH or PCISPH step of every particle of `state` (pos, vel and,
    for a warm-started PCISPH, the carried press). `ijk`: each particle's
    cell on a grid of `dims` (`cell_coords` of the positions it was binned
    from). Returns the new state in `state_dtype`, the PCISPH
    iteration count (0 for WCSPH) and the fullest cell's count."""
    pos = state["pos"].to(dtype)
    vel = state["vel"].to(dtype)
    cells = Cells(ijk, dims)
    g = torch.tensor(prm.gravity, dtype=dtype, device=pos.device)
    rho = density(cells, pos, prm, chunk)
    rho_c = torch.clamp(rho, min=_EPS)
    iv = 1.0 / rho_c
    iters = 0
    if solver == "wcsph":
        press = tait(rho, prm)
        f = pair_forces(cells, pos, vel, press / (rho_c * rho_c), iv, prm,
                        chunk, prm.mu)
        accel = f / prm.mass + g
    else:
        zero = torch.zeros_like(rho)
        extf = pair_forces(cells, pos, vel, zero, iv, prm, chunk,
                           prm.mu) + g * prm.mass
        press = state["press"].to(dtype) if warm_start else zero
        fps = torch.zeros_like(pos)
        err = None
        while iters < prm.max_iters and (
                err is None or err > prm.max_error_ratio):
            acc = (extf + fps) / prm.mass
            star = pos + (vel + acc * prm.dt) * prm.dt
            rho_star = density(cells, star, prm, chunk)
            err_p = rho_star - prm.d0
            press = torch.clamp(press + prm.delta * err_p, min=0.0)
            rff = torch.clamp(rho_star, min=0.5 * prm.d0)
            fps = pair_forces(cells, pos, vel, press / (rff * rff), iv, prm,
                              chunk, 0.0)
            err = max(float(err_p.max()), 0.0) / prm.d0
            iters += 1
        accel = (extf + fps) / prm.mass
    x, v, xa, va = integrate(state["pos"].to(state_dtype), state["vel"].to(
        state_dtype), accel, prm, box, restitution, friction)
    if solver != "wcsph" and not warm_start:
        press = torch.zeros_like(press)
    return Step(pos=x, vel=v, press=press.to(state_dtype), iters=iters,
                max_count=cells.max_count, pos_alt=xa, vel_alt=va)
