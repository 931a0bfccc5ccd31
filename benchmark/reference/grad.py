"""Plain reference of configuration 4's training step, for the check of the
materials-gradient cell.

Plain PyTorch, written from the equations (reference/sph.py's,
here with mu, d0 and mass as traced scalars) and from the tiled splat's
rules as the configuration states them. It imports nothing of the program.
One departure: the sky cube, which the program bakes from the
configuration's sun, is taken as input data (`cube`, (6, S, S, 3)); its SH9
projection is made here.

The step, for every particle i (sums over the candidates of reference/
sph.py's binning, from the pre-step positions x):

    rho_i  = m sum W(|x_j - x_i|)                          (self included)
    visc_i = mu m sum C (1 - r/h) (v_j - v_i) / rho_j      (0 < r < h)
    ext_i  = m g + visc_i;  p_i = the start's pressure;  fp_i = 0
    `unroll` times, every particle at once:
        x*_i   = x_i + (v_i + (ext_i + fp_i) / m dt) dt
        rho*_i = m sum W(|x*_j - x*_i|)                   (the same candidates)
        p_i    = max(p_i + delta (rho*_i - d0), 0)
        fp_i   = m^2 sum (p_i / f_i^2 + p_j / f_j^2) B (1 - r/h)^2 r_ij / r
                 at x, f = max(rho*, d0 / 2)               (0 < r < h)
    x'_i = x_i + (v_i + (ext_i + fp_i) / m dt) dt, clamped into the box.

The render of x', by the tiled splat's rules:

  * camera: at `position` looking along `front` (normalized); right =
    cross((0, 1, 0), front) normalized, up = cross(front, right); the view
    is the rigid inverse; depth d is the view z; focal f = (H / 2) /
    tan(fov / 2); u = W / 2 + f vx / max(d, 1e-4), v = H / 2 - f vy /
    max(d, 1e-4); in front where d > 1e-3; radius in pixels r = clip(
    radius f / max(d, 1e-3), 0.75, patch / 2); z = d - the nearest in-front
    d.
  * entries: the image is cut into tiles of 8 rows and 128 columns; each
    particle's patch box (patch x patch pixels around (floor u, floor v))
    meets at most 2 x 2 tiles, its entries in the order (row 0, col 0),
    (0, 1), (1, 0), (1, 1) over all particles each; an entry exists where
    the particle is in front, the tile is in the image and the box meets
    it. Each tile keeps its first k entries in that order (a stable sort
    by tile) and drops the rest: the overflow.
  * each kept entry adds, at every pixel of its box inside its tile (pixel
    centers c), with o = (c - (u, v)) / max(r, 0.5), r2 = |o|^2: cov =
    sigmoid(s (1 - r2)), oz = sqrt(1 - r2) where 1 - r2 > 1e-6 (else 0),
    n = (ox, -oy, oz) / max(|(ox, oy, oz)|, 1e-6), w = cov exp(-falloff z):
    (n / 2 + 1/2) w to the color sums, w to the weight, cov to the
    coverage, w n to the normal sums.
  * shading: mean color = color sums / max(weight, 1e-8), normal = normal
    sums / max(weight, 1e-8) normalized where its square exceeds 1e-12;
    where the weight exceeds 1e-8 the color becomes mean (1 - diffuse +
    diffuse E(R n)) + specular E(R r_v), r_v = (-2 nz nx, -2 nz ny, 1 -
    2 nz^2) the view reflection, R the view's rotation back to the world,
    E the sky's SH9 radiance clamped at 0 (the cube's texels weighted by
    their solid angle, 4 / S^2 times the cube of the direction's largest
    component, GL face layout); alpha = 1 - exp(-coverage); color = mean
    alpha + background (1 - alpha).

Precision. The sums (the pair sums, the splat sums, the shading, the
loss) run in `dtype`, float64. The state is rounded to `state_dtype`,
float32, where the configuration keeps it, as reference/sph.py rounds it:
the integration, the box, and the frame made from the state (the camera,
the projection, each splat's u, v, z, r and each pair's offset o and r2,
which decides the side of the disc's cutoff). At the disc's rim the
gradient's 0.5 / sqrt(1 - r2) turns a rounding of r2 into a large part of
a particle's gradient, and the step spreads it to the particle's
neighbours: a frame in float64 moved r2 by ~1e-4 from the program's
float32 frame and the positions' gradients apart by up to 9% (norm) at 1M
particles. A float32 state still differs from the program's by an ulp in
some particles, which moves r2 by up to ~1.5e-5: the pairs that near the
disc's cutoff fall on either side (`FLIP`, `grad_step`). The control runs
the whole in bfloat16.

The loss is sum(color^2). Its gradients to mu, d0, mass and x come from
torch.autograd through the forward (each material a vector of one entry a
particle, all equal: its sums and its own update scale by its entry, so
that central differences can move one material everywhere). Each block of
particles (the sweeps) and of entries (the raster) runs under
torch.utils.checkpoint, so that 1M particles at 1080p fit in memory. TF32
is off. Gathers are index_select, whose backward adds with atomics (the
backward of t[j] sorts the 1M x 216 indices of a sweep).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

import sph

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_EPS = 1e-12
#: Half-width, in pixels, of a projection's rounding tie: an entry whose
#: box's tile test flips within it is counted as either outcome's. A
#: float32 rounding of a position (6e-8 at 1) moves a splat ~2e-5 pixels.
TIE_PX = 1e-4
#: Half-width, in r2, of the disc cutoff's rounding tie (1 - r2 = 1e-6,
#: where the normal's oz = sqrt(1 - r2) drops to 0): such a rounding of a
#: position moves r2 by up to ~1.5e-5; a pair this near the cutoff falls
#: on either side, and each is the step's.
FLIP = 3e-5
#: |1 - r2| under which a (slot, pixel) pair lies on the disc's rim, where
#: the normal's sqrt(1 - r2) turns a rounding of r2 into a large part of
#: its particle's gradient: the check compares the positions' gradients
#: of the other particles.
RIM = 1e-3


class Frame(NamedTuple):
    """The render's constants, from the configuration's `render` group."""

    width: int
    height: int
    k: int
    radius: float
    position: tuple
    front: tuple
    fov_deg: float
    patch: int = 9
    sharpness: float = 12.0
    falloff: float = 2.0
    background: tuple = (0.1, 0.1, 0.1)
    diffuse: float = 0.75
    specular: float = 0.35


def frame_from_config(cfg: dict) -> Frame:
    r = cfg["render"]
    dx = 2.0 * float(cfg["extent"]) / int(cfg["n3"])
    cam = r["camera"]
    return Frame(width=int(r["width"]), height=int(r["height"]),
                 k=int(r["tile_capacity"]),
                 radius=float(r["radius_dx"]) * dx,
                 position=tuple(cam["position"]), front=tuple(cam["front"]),
                 fov_deg=float(cam["fov_deg"]))


class Result(NamedTuple):
    loss: float
    grad_mu: float
    grad_d0: float
    grad_mass: float
    grad_pos: torch.Tensor     # (N, 3) in `dtype`
    overflow: int
    overflow_ties: int         # entries whose tile test sits on a tie
    pos_alt: torch.Tensor      # (N, 3) grad_pos, the cutoff's ties flipped
    rim_gap: torch.Tensor      # (N,) min |1 - r2| over a particle's pairs
    on_tie: torch.Tensor       # (N,) bool: its splats on a projection tie
    wall_tie: torch.Tensor     # (N,) bool: x' on a wall's rounding tie
    max_count: int             # the fullest cell of the binning
    scale_mu: float            # sum of |a particle's share| of grad_mu
    scale_d0: float
    scale_mass: float
    range_mu: tuple            # (low, high) room of grad_mu, the ties'
    range_d0: tuple
    range_mass: tuple
    finite: bool


# ---------------------------------------------------------------------------
# The unrolled PCISPH step
# ---------------------------------------------------------------------------


def _blocks(n: int, size: int):
    return [(a, min(a + size, n)) for a in range(0, n, size)]


def _take(t, j):
    """t[j] by index_select (its backward adds with atomics, where the
    backward of t[j] sorts the indices)."""
    return t.index_select(0, j.reshape(-1)).reshape(j.shape + t.shape[1:])


class _Sweeps:
    """The pair sums over precomputed candidates (j, ok): (N, M) each.
    Each material is a (N,) vector, all entries equal: particle i's sums
    scale by its own entry, so that the gradient to the vector holds each
    particle's share of the gradient to the scalar."""

    def __init__(self, j, ok, prm: sph.Params, block: int):
        self.j, self.ok, self.prm = j, ok, prm
        self.blocks = _blocks(j.shape[0], block)
        h = prm.h
        self.h, self.h2 = h, h * h
        self.a = 315.0 / (64.0 * math.pi * h ** 3)
        self.b = -45.0 / (math.pi * h ** 4)
        self.c = 90.0 / (math.pi * h ** 5)

    def _run(self, fn, *args):
        return torch.cat([checkpoint(fn, a, b, *args, use_reentrant=False)
                          for a, b in self.blocks])

    def _geom(self, a, b, x):
        j, ok = self.j[a:b].long(), self.ok[a:b]
        r = _take(x, j) - x[a:b, None, :]
        return j, ok, r, (r * r).sum(-1)

    def _density(self, a, b, x, mass):
        _, ok, _, d2 = self._geom(a, b, x)
        q = 1.0 - d2 / self.h2
        return mass[a:b] * torch.where(ok & (d2 < self.h2), self.a * q * q,
                                       0.0).sum(-1)

    def density(self, x, mass):
        return self._run(self._density, x, mass)

    def _live(self, ok, d2):
        live = ok & (d2 > _EPS) & (d2 < self.h2)
        return live, torch.sqrt(torch.where(live, d2, 1.0))

    def _visc(self, a, b, x, v, rho, mu, mass):
        j, ok, _, d2 = self._geom(a, b, x)
        live, dist = self._live(ok, d2)
        s = torch.where(live, self.c * (1.0 - dist / self.h)
                        / _take(rho, j), 0.0)
        f = (s[..., None] * (_take(v, j) - v[a:b, None, :])).sum(1)
        return (mu[a:b] * mass[a:b])[:, None] * f

    def viscosity(self, x, v, rho, mu, mass):
        return self._run(self._visc, x, v, rho, mu, mass)

    def _press(self, a, b, x, pq, mass):
        j, ok, r, d2 = self._geom(a, b, x)
        live, dist = self._live(ok, d2)
        q1 = 1.0 - dist / self.h
        s = torch.where(live, (pq[a:b, None] + _take(pq, j)) * self.b
                        * q1 * q1 / dist, 0.0)
        return (mass[a:b] * mass[a:b])[:, None] * (s[..., None] * r).sum(1)

    def pressure(self, x, pq, mass):
        return self._run(self._press, x, pq, mass)


def candidates(cells: sph.Cells, n: int, block: int):
    """(j, ok) of every particle, (N, 27 * max_count); the indices kept as
    int32."""
    js, oks = [], []
    for a, b in _blocks(n, block):
        j, ok = cells.candidates(slice(a, b))
        js.append(j.to(torch.int32))
        oks.append(ok)
    return torch.cat(js), torch.cat(oks)


def pcisph_unrolled(x, v, p0, mats, prm: sph.Params, sweeps: _Sweeps,
                    unroll: int, box, state_dtype):
    """(x', x' before the box) of the unrolled step (module docstring),
    differentiable in x and the materials (mu, d0, mass: (N,) vectors).
    The sums run in x's dtype; the integration, x' = x + (v + a dt) dt,
    and the box in `state_dtype`, the precision of the state."""
    mu, d0, mass = mats
    dt = prm.dt
    m = mass[:, None]
    g = torch.tensor(prm.gravity, dtype=x.dtype, device=x.device)
    rho = sweeps.density(x, mass)
    ext = g * m + sweeps.viscosity(x, v, rho, mu, mass)
    press = p0
    fp = torch.zeros_like(x)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    for _ in range(unroll):
        xs = x + (v + (ext + fp) / m * dt) * dt
        rho_s = sweeps.density(xs, mass)
        press = torch.maximum(press + prm.delta * (rho_s - d0), zero)
        f = torch.maximum(rho_s, 0.5 * d0)
        fp = sweeps.pressure(x, press / (f * f), mass)
    a = ((ext + fp) / m).to(state_dtype)
    x1 = x.to(state_dtype) + (v.to(state_dtype) + a * dt) * dt
    lo = torch.tensor(box[0], dtype=state_dtype, device=x.device)
    hi = torch.tensor(box[1], dtype=state_dtype, device=x.device)
    return torch.minimum(torch.maximum(x1, lo), hi), x1


# ---------------------------------------------------------------------------
# The render
# ---------------------------------------------------------------------------


def _norm(t):
    return torch.sqrt((t * t).sum(-1, keepdim=True))


def view_matrix(fr: Frame, dtype, device):
    """(4, 4) world-to-view of the frame's camera, made in `dtype` on
    `device`: the front normalized, right = cross((0, 1, 0), front)
    normalized, up = cross(front, right), the basis as the columns of the
    camera-to-world rotation R at `position` t; the view [R^T | -R^T t]."""
    f = torch.tensor(fr.front, dtype=dtype, device=device)
    f = f / _norm(f)
    right = torch.linalg.cross(
        torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=device), f)
    right = right / torch.clamp(_norm(right), min=1e-6)
    up = torch.linalg.cross(f, right)
    rt = torch.stack([right, up, f], 0)           # R^T: the basis as rows
    t = torch.tensor(fr.position, dtype=dtype, device=device)
    view = torch.eye(4, dtype=dtype, device=device)
    view[:3, :3] = rt
    view[:3, 3] = -rt @ t
    return view


def project(x, fr: Frame, view):
    """(u, v, depth, r_px) of positions x, in x's dtype: the view's rows
    against x summed pairwise, (r0 x + r1 y) + (r2 z + t); the focal
    length (H / 2) / tan(fov / 2), the half angle rounded to x's dtype and
    its tangent to the nearest."""
    p = ((view[:3, 0] * x[:, 0:1] + view[:3, 1] * x[:, 1:2])
         + (view[:3, 2] * x[:, 2:3] + view[:3, 3]))
    depth = p[:, 2]
    half = torch.deg2rad(torch.tensor(fr.fov_deg, dtype=x.dtype)) / 2.0
    focal = (torch.tensor(fr.height / 2.0, dtype=x.dtype)
             / torch.tan(half.double()).to(x.dtype)).to(x.device)
    z = torch.clamp(depth, min=1e-4)
    u = fr.width / 2.0 + p[:, 0] / z * focal
    v = fr.height / 2.0 - p[:, 1] / z * focal
    radius = torch.tensor(fr.radius, dtype=x.dtype, device=x.device)
    r = torch.clamp(radius * focal / torch.clamp(depth, min=1e-3), 0.75,
                    fr.patch / 2.0)
    return u, v, depth, r


def _tile_of(u, v, in_front, fr: Frame):
    """(tile ids (N, 4), ok (N, 4), tile columns, tile rows) of each
    particle's up to 2 x 2 entries, in the rule's order."""
    half = fr.patch // 2
    ntx, nty = fr.width // 128, fr.height // 8
    cx, cy = torch.floor(u), torch.floor(v)
    tx0 = torch.floor((cx - half) / 128)
    ty0 = torch.floor((cy - half) / 8)
    ids, oks, txs, tys = [], [], [], []
    for dy in (0, 1):
        for dx in (0, 1):
            tx, ty = tx0 + dx, ty0 + dy
            ok = (in_front & (tx >= 0) & (tx < ntx) & (ty >= 0) & (ty < nty)
                  & (tx * 128 <= cx + half) & (tx * 128 + 127 >= cx - half)
                  & (ty * 8 <= cy + half) & (ty * 8 + 7 >= cy - half))
            ids.append(torch.where(ok, ty * ntx + tx, -1.0).long())
            oks.append(ok)
            txs.append(tx)
            tys.append(ty)
    return (torch.stack(ids, 1), torch.stack(oks, 1), torch.stack(txs, 1),
            torch.stack(tys, 1))


def entries(u, v, in_front, fr: Frame):
    """The kept entries, (particle, tile column, tile row) each; the
    overflow; the entries whose existence flips within TIE_PX of u or v
    (ties); and, (N,) bool, the particles such a flip may change: those
    with a tie entry, and those with an entry within as many ranks of its
    tile's capacity as the tile has tie entries (a tie ahead of it moves
    which entries the tile keeps)."""
    n = u.shape[0]
    ids, ok, txs, tys = _tile_of(u, v, in_front, fr)
    # The rule's order: entry block (dy, dx) major, particle minor.
    ids_o, ok_o = ids.T.reshape(-1), ok.T.reshape(-1)
    n_tiles = (fr.width // 128) * (fr.height // 8)
    key = torch.where(ok_o, ids_o, n_tiles)
    order = torch.argsort(key, stable=True)
    sk = key[order]
    first = torch.searchsorted(sk, sk)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(key.shape[0], device=u.device) - first
    kept = ok_o & (rank < fr.k)
    overflow = int((ok_o & (rank >= fr.k)).sum())
    e = torch.nonzero(kept).squeeze(1)
    part = e % n
    tx = txs.T.reshape(-1)[e]
    ty = tys.T.reshape(-1)[e]
    # Ties: the entry sets under u, v moved by +-TIE_PX.
    sets = []
    for su in (-TIE_PX, TIE_PX):
        for sv in (-TIE_PX, TIE_PX):
            i2, _, _, _ = _tile_of(u + su, v + sv, in_front, fr)
            keys = (torch.arange(n, device=u.device)[:, None] * (n_tiles + 1)
                    + i2)[i2 >= 0]
            sets.append(torch.unique(keys))
    union = torch.unique(torch.cat(sets))
    common = sets[0]
    for s in sets[1:]:
        common = common[torch.isin(common, s)]
    tie_keys = union[~torch.isin(union, common)]
    per_tile = torch.bincount(tie_keys % (n_tiles + 1), minlength=n_tiles)
    t = per_tile[ids_o.clamp(min=0)]
    near = ok_o & (t > 0) & ((rank - fr.k).abs() <= t)
    moved = torch.zeros(n, dtype=torch.bool, device=u.device)
    moved[torch.arange(key.shape[0], device=u.device)[near] % n] = True
    moved[tie_keys // (n_tiles + 1)] = True
    return part, tx, ty, overflow, int(tie_keys.shape[0]), moved


def _box(fr: Frame, device):
    """The pixel offsets of a patch box, (1, patch^2) each."""
    half = fr.patch // 2
    o = torch.arange(-half, half + 1, dtype=torch.float64, device=device)
    oy, ox = torch.meshgrid(o, o, indexing="ij")
    return ox.reshape(1, -1), oy.reshape(1, -1)


def _pairs(ul, vl, tx, ty, fr: Frame):
    """The (entry, pixel) pairs of entries with tile-local centers (ul,
    vl), (E, patch^2) each: inside the tile, the image pixel, the offsets
    of the pixel center from the splat's center."""
    ox, oy = _box(fr, ul.device)
    px = torch.floor(ul.detach()).to(torch.float64) + ox
    py = torch.floor(vl.detach()).to(torch.float64) + oy
    inside = (px >= 0) & (px < 128) & (py >= 0) & (py < 8)
    pix = ((ty[:, None] * 8 + py.clamp(0, 7)).long() * fr.width
           + (tx[:, None] * 128 + px.clamp(0, 127)).long())
    return (inside, pix, (px + 0.5).to(ul.dtype) - ul,
            (py + 0.5).to(ul.dtype) - vl)


def _raster(a, b, ul, vl, z, r, tx, ty, fr: Frame, dtype, flip: bool):
    """The sums of entries [a, b) over the image's pixels, (8, H * W) in
    `dtype`: color (3), weight, coverage, normal (3). Each pair's offset o
    and r2 (and so which side of the disc's cutoff it falls) in the
    frame's precision, that of (ul, vl, z, r); the rest in `dtype`. With
    `flip`, each pair within FLIP of the cutoff takes its other side."""
    inside, pix, dxp, dyp = _pairs(ul[a:b, None], vl[a:b, None], tx[a:b],
                                   ty[a:b], fr)
    z, r = z[a:b, None], r[a:b, None]
    inv_r = 1.0 / torch.clamp(r, min=0.5)
    ox_f, oy_f = dxp * inv_r, dyp * inv_r
    r2_f = ox_f * ox_f + oy_f * oy_f
    ins = (1.0 - r2_f) > 1e-6
    ox, oy, r2 = ox_f.to(dtype), oy_f.to(dtype), r2_f.to(dtype)
    q = 1.0 - r2
    if flip:
        ins = ins ^ ((q.detach() - 1e-6).abs() < FLIP)
        # A pair flipped inside is taken at the cutoff or above, with the
        # derivative of 1 - r2.
        q = q + (torch.clamp(q, min=2e-6) - q).detach()
    ez = torch.exp(-fr.falloff * z.to(dtype))
    cov = torch.sigmoid(fr.sharpness * (1.0 - r2))
    oz = torch.where(ins, torch.sqrt(torch.where(ins, q, 1.0)), 0.0)
    inl = torch.rsqrt(torch.clamp(ox * ox + oy * oy + oz * oz, min=1e-12))
    nx, ny, nz = ox * inl, -(oy * inl), oz * inl
    w = cov * ez
    vals = torch.stack([(nx * 0.5 + 0.5) * w, (ny * 0.5 + 0.5) * w,
                        (nz * 0.5 + 0.5) * w, w, cov, w * nx, w * ny,
                        w * nz])
    out = torch.zeros(8, fr.width * fr.height, dtype=dtype, device=ul.device)
    return out.index_add(1, pix[inside], vals[:, inside])


@torch.no_grad()
def _rim_gap(ul, vl, r, tx, ty, fr: Frame, block: int):
    """(E,) min |1 - r2| over each entry's pairs inside its tile (inf where
    none)."""
    out = []
    for a, b in _blocks(ul.shape[0], block):
        inside, _, dxp, dyp = _pairs(ul[a:b, None], vl[a:b, None], tx[a:b],
                                     ty[a:b], fr)
        inv_r = 1.0 / torch.clamp(r[a:b, None].double(), min=0.5)
        r2 = (dxp.double() * inv_r) ** 2 + (dyp.double() * inv_r) ** 2
        out.append(torch.where(inside, (1.0 - r2).abs(),
                               math.inf).amin(-1))
    return torch.cat(out)


def sh9_basis(d):
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    c0 = 0.5 / math.sqrt(math.pi)
    c1 = math.sqrt(3.0 / (4.0 * math.pi))
    c2 = 0.5 * math.sqrt(15.0 / math.pi)
    c3 = 0.25 * math.sqrt(5.0 / math.pi)
    c4 = 0.25 * math.sqrt(15.0 / math.pi)
    return torch.stack([torch.full_like(x, c0), c1 * y, c1 * z, c1 * x,
                        c2 * x * y, c2 * y * z, c3 * (3.0 * z * z - 1.0),
                        c2 * x * z, c4 * (x * x - y * y)], -1)


def sh9_of_cube(cube, dtype):
    """(9, 3) SH9 coefficients of a (6, S, S, 3) cube, GL face layout."""
    s = cube.shape[1]
    t = (torch.arange(s, dtype=dtype, device=cube.device) + 0.5) / s * 2 - 1
    sg, tg = torch.meshgrid(t, t, indexing="xy")
    one = torch.ones_like(sg)
    d = torch.stack([torch.stack(f, -1) for f in (
        (one, -tg, -sg), (-one, -tg, sg), (sg, one, tg), (sg, -one, -tg),
        (sg, -tg, one), (-sg, -tg, -one))])
    d = d / d.norm(dim=-1, keepdim=True)
    d_omega = (4.0 / (s * s)) * d.abs().amax(-1) ** 3
    return torch.einsum("fhwn,fhwc,fhw->nc", sh9_basis(d), cube.to(dtype),
                        d_omega)


def shade(acc, fr: Frame, view, coeffs):
    """color (H * W, 3) from the sums."""
    col, den, cov, wn = acc[0:3].T, acc[3], acc[4], acc[5:8].T
    den_s = torch.clamp(den, min=1e-8)[:, None]
    mean = col / den_s
    mn = wn / den_s
    n2 = (mn * mn).sum(-1, keepdim=True)
    has = n2 > 1e-12
    nrm = torch.where(has, mn * torch.rsqrt(torch.where(has, n2, 1.0)), 0.0)
    rot = view[:3, :3]
    nz = nrm[:, 2:3]
    rv = torch.cat([-2.0 * nz * nrm[:, 0:1], -2.0 * nz * nrm[:, 1:2],
                    1.0 - 2.0 * nz * nz], -1)
    env_n = torch.clamp(sh9_basis(nrm @ rot) @ coeffs, min=0.0)
    env_r = torch.clamp(sh9_basis(rv @ rot) @ coeffs, min=0.0)
    lit = mean * ((1.0 - fr.diffuse) + fr.diffuse * env_n) \
        + fr.specular * env_r
    mean = torch.where(den[:, None] > 1e-8, lit, mean)
    alpha = (1.0 - torch.exp(-cov))[:, None]
    bg = torch.tensor(fr.background, dtype=acc.dtype, device=acc.device)
    return mean * alpha + bg * (1.0 - alpha)


def render_loss(x1, fr: Frame, cube, block: int, dtype,
                flip: bool = False):
    """(loss, overflow, ties, rim gap, on a tie) of the frame of x1: the
    rim gap, (N,) float64, is each particle's min |1 - r2| over its kept
    entries' pairs (inf where it has none); on a tie, (N,) bool, marks the
    particles whose splats a projection's rounding may change: a center
    within TIE_PX of a pixel boundary (its patch box is either box), or
    kept or dropped by a tie of the tile overflow (`entries`). The frame
    (the camera, the projection, each pair's offset) in x1's precision, the
    sums, the shading and the loss in `dtype`; `flip` as `_raster`'s."""
    view = view_matrix(fr, x1.dtype, x1.device)
    u, v, depth, r = project(x1, fr, view)
    in_front = depth.detach() > 1e-3
    zmin = torch.amin(torch.where(in_front, depth,
                                  torch.full_like(depth, math.inf)))
    part, tx, ty, overflow, ties, moved = entries(u.detach(), v.detach(),
                                                  in_front, fr)
    txf, tyf = tx.to(x1.dtype), ty.to(x1.dtype)
    ul = u.index_select(0, part) - txf * 128
    vl = v.index_select(0, part) - tyf * 8
    z = (depth - zmin).index_select(0, part)
    rr = r.index_select(0, part)
    acc = None
    for a, b in _blocks(part.shape[0], block):
        out = checkpoint(_raster, a, b, ul, vl, z, rr, tx, ty, fr, dtype,
                         flip, use_reentrant=False)
        acc = out if acc is None else acc + out
    color = shade(acc, fr, view.to(dtype), sh9_of_cube(cube, dtype))
    gap = torch.full((x1.shape[0],), math.inf, dtype=torch.float64,
                     device=x1.device)
    gap = gap.scatter_reduce(0, part, _rim_gap(
        ul.detach(), vl.detach(), rr.detach(), tx, ty, fr, block), "amin")
    # A center within TIE_PX of the pixel lattice: its patch box (floor u,
    # floor v) is either box's.
    uv = torch.stack([u.detach(), v.detach()], -1).double()
    frac = uv - torch.floor(uv)
    on_lattice = (torch.minimum(frac, 1.0 - frac) <= TIE_PX).any(-1)
    return (color * color).sum(), overflow, ties, gap, on_lattice | moved


# ---------------------------------------------------------------------------
# The whole step and its gradients
# ---------------------------------------------------------------------------


class Problem:
    """Configuration 4's loss at one start (pos, vel, press as the
    benchmark draws them): the binning of its positions and the render's
    constants, made once; `loss(x, mu, d0, mass)` evaluates it."""

    def __init__(self, start: dict, cfg: dict, prm: sph.Params, cube, *,
                 unroll: int = 3, dtype=torch.float64, block: int = 65536,
                 box=None, state_dtype=torch.float32):
        self.fr = frame_from_config(cfg)
        self.box = cfg["box"] if box is None else box
        self.prm, self.cube, self.unroll = prm, cube, unroll
        self.dtype, self.block = dtype, block
        if torch.finfo(dtype).bits < torch.finfo(state_dtype).bits:
            state_dtype = dtype
        self.state_dtype = state_dtype
        lo, _, dims = _domain(cfg, prm.h)
        self.pos32 = start["pos"]
        self.vel = start["vel"].to(dtype)
        self.press = start["press"].to(dtype)
        self.cells = sph.Cells(sph.cell_coords(self.pos32, lo, prm.h, dims),
                               dims)
        j, ok = candidates(self.cells, self.pos32.shape[0], block)
        self.sweeps = _Sweeps(j, ok, prm, block)

    def leaves(self):
        """(x, mu, d0, mass): the start's positions and the configuration's
        materials, each material a (N,) vector of its value (one entry a
        particle), in `dtype`, each a leaf that requires grad."""
        dev, n = self.pos32.device, self.pos32.shape[0]

        def leaf(val):
            return torch.full((n,), val, dtype=self.dtype, device=dev,
                              requires_grad=True)

        return (self.pos32.to(self.dtype).requires_grad_(),
                leaf(self.prm.mu), leaf(self.prm.d0), leaf(self.prm.mass))

    def step(self, x, mu, d0, mass, state_dtype=None):
        """(x', x' before the box), the state in `state_dtype` (default
        the problem's)."""
        return pcisph_unrolled(x, self.vel, self.press, (mu, d0, mass),
                               self.prm, self.sweeps, self.unroll, self.box,
                               state_dtype or self.state_dtype)

    def loss(self, x, mu, d0, mass):
        """(loss, overflow, ties, rim gap, on a tie, x', x' before
        the box)."""
        x1, x1u = self.step(x, mu, d0, mass)
        return render_loss(x1, self.fr, self.cube, self.block,
                           self.dtype) + (x1, x1u)


def grad_step(start: dict, cfg: dict, prm: sph.Params, cube, *,
              unroll: int = 3, dtype=torch.float64, block: int = 65536,
              box=None, eps: float = 1e-6) -> Result:
    """Configuration 4's loss at the start `start` (pos, vel, press as
    the benchmark draws them), its gradients to mu, d0, mass and pos, and
    how far the disc cutoff's rounding ties may move them.

    The frame's pairs within FLIP of the cutoff fall on either side: the
    loss is taken again with each of them on its other side (`alt`), and
    its gradient at x', g1_alt, carried back through the step. Each
    material's gradient is the sum over the particles of c_p = g1_p .
    dx'_p/dtheta (dx'/dtheta by central differences of the step in
    float64, steps of `eps` relative): `range_*` is the sum of the
    particles' negative and of their positive c_alt_p - c_p, the room
    either side of the gradient; `scale_*` the sum of |c_p|. `pos_alt` is
    the positions' gradient of the alternative."""
    pb = Problem(start, cfg, prm, cube, unroll=unroll, dtype=dtype,
                 block=block, box=box)
    x, mu, d0, mass = pb.leaves()
    loss, overflow, ties, rim, on_tie, x1, x1u = pb.loss(x, mu, d0, mass)
    leaves = [mu, d0, mass, x]
    g1 = torch.autograd.grad(loss, [x1], retain_graph=True)[0]
    x1a = x1.detach().requires_grad_()
    g1_alt = torch.autograd.grad(render_loss(
        x1a, pb.fr, cube, block, dtype, flip=True)[0], [x1a])[0]
    grads = torch.autograd.grad(x1, leaves, grad_outputs=g1,
                                retain_graph=True)
    pos_alt = torch.autograd.grad(x1, [x], grad_outputs=g1_alt)[0]
    g1d, g1a = g1.detach().double(), g1_alt.double()
    scale, room = [], []
    with torch.no_grad():
        mats = [mu.detach(), d0.detach(), mass.detach()]
        for i, m in enumerate(mats):
            e = eps * float(m[0])
            ends = []
            for sign in (1.0, -1.0):
                moved = list(mats)
                moved[i] = m + sign * e
                ends.append(pb.step(x.detach(), *moved,
                                    state_dtype=dtype)[0].double())
            dx1 = (ends[0] - ends[1]) / (2.0 * e)
            c = (g1d * dx1).sum(-1)
            delta = ((g1a - g1d) * dx1).sum(-1)
            scale.append(float(c.abs().sum()))
            room.append((float(delta.clamp(max=0.0).sum()),
                         float(delta.clamp(min=0.0).sum())))
    dev = x.device
    lo_b = torch.tensor(pb.box[0], dtype=torch.float64, device=dev)
    hi_b = torch.tensor(pb.box[1], dtype=torch.float64, device=dev)
    x1d = x1u.detach().double()
    tol = sph.TIE * torch.clamp(torch.maximum(lo_b.abs(), hi_b.abs()),
                                min=1.0)
    wall = (((x1d - lo_b).abs() <= tol) | ((x1d - hi_b).abs() <= tol)).any(-1)
    vals = torch.stack([loss.detach().double()]
                       + [g.double().sum() for g in grads[:3]])
    finite = bool(torch.isfinite(vals).all()
                  and torch.isfinite(grads[3]).all())
    return Result(loss=float(vals[0]), grad_mu=float(vals[1]),
                  grad_d0=float(vals[2]), grad_mass=float(vals[3]),
                  grad_pos=grads[3].detach(), pos_alt=pos_alt.detach(),
                  overflow=overflow, overflow_ties=ties, rim_gap=rim,
                  on_tie=on_tie, wall_tie=wall,
                  max_count=pb.cells.max_count,
                  scale_mu=scale[0], scale_d0=scale[1], scale_mass=scale[2],
                  range_mu=room[0], range_d0=room[1], range_mass=room[2],
                  finite=finite)


def _domain(cfg: dict, h: float):
    off = float(cfg["cells"]["lo_offset_h"]) * h
    lo = [float(b) - off for b in cfg["box"][0]]
    hi = [float(b) + off for b in cfg["box"][1]]
    dims = [max(1, int(math.ceil((b - a) / h))) for a, b in zip(lo, hi)]
    return lo, hi, dims
