"""Masked entries of the port's index ops get addresses of their own.

On the card an index op that adds (`index_add`, the backward of
`index_select` and of `a[idx]`, `index_put_(accumulate=True)`) queues the
adds to one address behind each other. A masked entry's index used to be
clamped or parked, so thousands of them shared one address: a sharded
store's dead slots (and every overflowed particle) in
`cellops.gather_plane(s)`, every overflowed particle at slot 0 in
`dense_step`'s pressure planes, the slots that take no immigrant in
`halo._migrate`, and the entries outside a tile of the eager splat. On the
CPU, at a few thousand particles over 4 slabs (two of them empty at the
start):

  * the indices that masked entries feed to those ops are pairwise
    distinct while they fit the indexed tensor (past that, as few to an
    address as fit: the migration's immigrant buffer is smaller than a
    store): the helper itself, and spies on every index op of a sharded
    WCSPH step, a sharded PCISPH step, a sharded Materials gradient (1-D
    and 2x2) and the unsharded steps with overflowing cells;
  * every such path gives bit for bit what it gave with the clamped
    indices, which are kept here (`_clamped_*`) and patched in;
  * `mathx` has the JAX package's constants and `clamp1f`.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.geometry.mesh import box
from dieselfluid_tpu_torch.models.materials import Materials
from dieselfluid_tpu_torch.models.particles import dam_break_state
from dieselfluid_tpu_torch.ops import cellops as tc
from dieselfluid_tpu_torch.parallel import dense_halo as tdh
from dieselfluid_tpu_torch.parallel import dense_halo2d as td2
from dieselfluid_tpu_torch.parallel import halo as th
from dieselfluid_tpu_torch.parallel.mesh import LocalMesh
from dieselfluid_tpu_torch.render import splat as ts
from dieselfluid_tpu_torch.render.camera import Camera
from dieselfluid_tpu_torch.solvers import dense_step as tds
from dieselfluid_tpu_torch.solvers.pcisph import compute_pci_delta

torch.set_num_threads(1)
CPU = torch.device("cpu")
N_DEV = 4
N3 = 12                 # 1,728 particles, in the first two of 4 slabs


# ---------------------------------------------------------------------------
# The clamped forms, as they were, patched in as the reference
# ---------------------------------------------------------------------------


def _clamped_spread(flat, valid, size):
    """Every entry's index clamped into the indexed tensor: the steps
    gathered through `flat` as dense_indices gives it (a dead or overflowed
    slot's index aliases the cell's last slot), and _migrate clamped the
    slots that take no immigrant onto the buffer's first or last row."""
    return torch.clamp(flat, 0, size - 1)


def _slot0_to_plane(values_f, boundary_value, flat, valid, spec, mask):
    """dense_step's to_plane: every invalid entry adds its zero at slot
    0."""
    n = values_f.shape[0]
    out = torch.zeros(spec.size, dtype=torch.float32, device=values_f.device)
    out.index_put_((torch.where(valid[:n], flat[:n], 0),),
                   torch.where(valid[:n], values_f, 0.0), accumulate=True)
    if flat.shape[0] > n:
        bv = torch.as_tensor(boundary_value, dtype=torch.float32,
                             device=values_f.device)
        out.index_put_((torch.where(valid[n:], flat[n:], 0),),
                       torch.where(valid[n:], bv, 0.0), accumulate=True)
    return out.view(spec.plane_shape)


def _clamped_pixel_index(px, py, width, height):
    """The eager splat's pixel: clamped onto the image's (tile's) border."""
    ix = torch.clamp(px.to(torch.int64), 0, width - 1)
    iy = torch.clamp(py.to(torch.int64), 0, height - 1)
    return iy * width + ix


@pytest.fixture
def clamped(monkeypatch):
    """Patch the clamped forms in (the steps look them up as module
    globals)."""
    def apply():
        for mod in (tdh, td2, tds, th):
            monkeypatch.setattr(mod, "spread_masked", _clamped_spread)
        monkeypatch.setattr(tds, "_to_plane", _slot0_to_plane)
        monkeypatch.setattr(ts, "_pixel_index", _clamped_pixel_index)
    return apply


def _bits(x) -> bytes:
    """Every float and integer of a nested output, as bytes."""
    if x is None:
        return b""
    if torch.is_tensor(x):
        return x.detach().contiguous().numpy().tobytes()
    if isinstance(x, (tuple, list)):
        return b"".join(_bits(v) for v in x)
    return np.asarray(x).tobytes()


# ---------------------------------------------------------------------------
# The paths: each returns its outputs (and gradients) as a tuple
# ---------------------------------------------------------------------------


def _dam(n3=N3, jitter=0.0, seed=0):
    dx = (2.0 / n3) * 0.5
    params = FluidParams.for_spacing(dx)
    s0 = dam_break_state(n3, params, CPU)
    params = params.replace(d0=float(1.1 * params.d0))
    rng = np.random.default_rng(seed)
    pos = s0.pos + torch.from_numpy(rng.uniform(
        -jitter, jitter, tuple(s0.pos.shape)).astype(np.float32)) * dx
    vel = torch.from_numpy(rng.normal(size=tuple(s0.pos.shape)).astype(
        np.float32) * 0.5)
    press = torch.from_numpy(rng.uniform(0.0, 100.0, s0.n).astype(
        np.float32))
    return params, s0._replace(pos=pos, vel=vel, pressure=press), dx


def _slab_spec(params, s0):
    return tdh.DenseSlabSpec.build_for_state(s0, N_DEV, params.h, 256,
                                             cell_capacity=32)


def _sharded_1d(solver):
    params, s0, dx = _dam(jitter=0.2)
    spec = _slab_spec(params, s0)
    mesh = LocalMesh((N_DEV,), CPU)
    if solver == "wcsph":
        step = tdh.make_dense_halo_wcsph_step(mesh, spec, params)
        slabs = tdh.distribute_dense(s0, spec)
    else:
        bnd = box(1.6, 1.6, 1.6, device=CPU).generate_boundary_particles(
            dx / params.h)
        step = tdh.make_dense_halo_pcisph_step(
            mesh, spec, params, compute_pci_delta(params, dx),
            boundary=True, warm_start=True)
        slabs = tdh.distribute_dense(s0._replace(boundary_pos=bnd), spec)
    per_slab = slabs.alive.reshape(N_DEV, -1).sum(1)
    assert int((per_slab == 0).sum()) == 2, per_slab
    out = []
    for _ in range(2):
        res = step(slabs)
        slabs = res[0]
        out.append(res)
    return tuple(out)


def _sharded_2d(solver):
    params, s0, dx = _dam(n3=10, jitter=0.2)
    spec = td2.DenseSlab2DSpec.build(2, 2, params.h, capacity=1024,
                                     migrate_capacity=256, cell_capacity=32)
    mesh = td2.make_mesh_2d(2, 2, CPU)
    if solver == "wcsph":
        step = td2.make_dense_halo_wcsph_step_2d(mesh, spec, params)
        slabs = td2.distribute_2d(s0, spec)
    else:
        bnd = box(1.6, 1.6, 1.6, device=CPU).generate_boundary_particles(
            dx / params.h)
        step = td2.make_dense_halo_pcisph_step_2d(
            mesh, spec, params, compute_pci_delta(params, dx), boundary=True,
            warm_start=True)
        slabs = td2.distribute_2d(s0._replace(boundary_pos=bnd), spec)
    return step(slabs)


def _sharded_grad():
    params, s0, _ = _dam(jitter=0.1)
    spec = _slab_spec(params, s0)
    mats = Materials.from_params(params, CPU, requires_grad=True)
    slabs = tdh.distribute_dense(s0, spec)
    pos = slabs.pos.clone().requires_grad_()
    step = tdh.make_dense_halo_wcsph_step(LocalMesh((N_DEV,), CPU), spec,
                                          params, materials_arg=True)
    out, *diag = step(slabs._replace(pos=pos), mats)
    loss = ((out.alive > 0)[:, None] * torch.sin(3.0 * out.pos)).sum()
    return (out, diag, torch.autograd.grad(loss, [*mats, pos]))


def _crowded_spec(params, capacity=4):
    """A global lattice whose cells overflow at `capacity`."""
    off = params.h / 4.0
    return tc.DenseCellSpec.for_domain((-1 - off,) * 3, (1 + off,) * 3,
                                       params.h, capacity=capacity)


def _unsharded_grad(solver):
    """The unsharded Materials gradient with overflowing cells (and, for
    the unrolled PCISPH, a boundary store): masked entries in every
    gather and in to_plane."""
    params, s0, dx = _dam(n3=10, jitter=0.45)
    spec = _crowded_spec(params)
    mats = Materials.from_params(params, CPU, requires_grad=True)
    pos = s0.pos.clone().requires_grad_()
    state = s0._replace(pos=pos)
    if solver == "wcsph":
        nxt, diag = tds.dense_wcsph_step(state, params, spec, materials=mats)
    else:
        state = state._replace(boundary_pos=box(
            1.6, 1.6, 1.6, device=CPU).generate_boundary_particles(
                dx / params.h))
        nxt, diag = tds.dense_pcisph_step(
            state, params, spec, compute_pci_delta(params, dx),
            materials=mats, unroll_for_grad=True, unroll_iters=2,
            warm_start=True)
    assert int(diag.overflow) > 0, "the cells must overflow"
    loss = (torch.sin(3.0 * nxt.pos) * nxt.pressure[:, None]).sum()
    return (nxt, diag, torch.autograd.grad(loss, [*mats, pos],
                                           allow_unused=True))


def _unsharded_pcisph_loop():
    """The plane-resident PCISPH loop (to_plane of the carried pressure and
    of the boundary's marker) with overflowing cells."""
    params, s0, dx = _dam(n3=10, jitter=0.45)
    state = s0._replace(boundary_pos=box(
        1.6, 1.6, 1.6, device=CPU).generate_boundary_particles(dx / params.h))
    out = tds.dense_pcisph_step(state, params, _crowded_spec(params),
                                compute_pci_delta(params, dx),
                                warm_start=True)
    assert int(out[1].overflow) > 0
    return out


def _migrate():
    """_migrate alone: particles across both faces of shard 1, with
    gradients to the positions, velocities and pressures."""
    params, s0, _ = _dam(jitter=0.1)
    spec = _slab_spec(params, s0)
    slabs = tdh.distribute_dense(s0, spec)
    mesh = LocalMesh((N_DEV,), CPU)
    sw = spec.slab_width
    pos = slabs.pos.clone()
    x = pos[:, 0]
    # Shard 0's particles near its right face cross it; shard 1's near its
    # left face cross back.
    pos[:, 0] = torch.where(
        (x > spec.lo + 0.8 * sw) & (x < spec.lo + sw), x + 0.3 * sw,
        torch.where((x >= spec.lo + sw) & (x < spec.lo + 1.2 * sw),
                    x - 0.3 * sw, x))
    leaves = [t.requires_grad_() for t in
              (pos, slabs.vel.clone(), slabs.pressure.clone())]
    split = [mesh.split(t) for t in leaves]
    out = th._migrate(mesh, *split, mesh.split(slabs.alive),
                      [slabs.dropped / N_DEV] * N_DEV, spec.view())
    moved = [torch.cat(o) for o in out[:4]] + [torch.stack(out[4])]
    assert float(moved[3].sum()) == float(slabs.alive.sum())
    w = [torch.from_numpy(np.random.default_rng(i).normal(
        size=tuple(t.shape)).astype(np.float32)) for i, t in
         enumerate(moved[:3])]
    loss = sum((a * b).sum() for a, b in zip(moved[:3], w))
    return (moved, torch.autograd.grad(loss, leaves))


def _splat(tiles):
    """The eager splat of 2,000 seeded particles at 96x64, in `tiles` row
    tiles (1: one device), with colors: the image and the gradient of
    sum(color^2) to the positions."""
    from dieselfluid_tpu_torch.parallel.render_shard import make_tiled_splat

    rng = np.random.default_rng(3)
    pos = torch.from_numpy(rng.uniform(-0.8, 0.8, (2000, 3)).astype(
        np.float32)).requires_grad_()
    cols = torch.from_numpy(rng.uniform(0.0, 1.0, (2000, 3)).astype(
        np.float32))
    cam = Camera.at((0.0, 0.0, -2.0), front=(0.0, 0.0, 1.0), fov_deg=60.0,
                    aspect=96 / 64, device=CPU)
    if tiles == 1:
        img = ts.splat_particles(pos, 0.04, cam, width=96, height=64,
                                 colors=cols)
    else:
        img = make_tiled_splat(LocalMesh((tiles,), CPU), 96, 64, 2000)(
            pos, 0.04, cam, cols)
    (g,) = torch.autograd.grad((img.color ** 2).sum(), pos)
    return (img, g)


PATHS = {
    "sharded_wcsph_1d": lambda: _sharded_1d("wcsph"),
    "sharded_pcisph_1d": lambda: _sharded_1d("pcisph"),
    "sharded_wcsph_2x2": lambda: _sharded_2d("wcsph"),
    "sharded_pcisph_2x2": lambda: _sharded_2d("pcisph"),
    "sharded_materials_grad": _sharded_grad,
    "unsharded_wcsph_grad": lambda: _unsharded_grad("wcsph"),
    "unsharded_pcisph_unrolled_grad": lambda: _unsharded_grad("pcisph"),
    "unsharded_pcisph_plane_loop": _unsharded_pcisph_loop,
    "migrate": _migrate,
    "splat_4_tiles": lambda: _splat(4),
    "splat_one_device": lambda: _splat(1),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_bit_for_bit_the_clamped_form(path, clamped):
    """Masked entries read and add only what the caller's mask discards:
    moving their addresses changes no bit of any output or gradient."""
    got = _bits(PATHS[path]())
    clamped()
    want = _bits(PATHS[path]())
    assert len(got) == len(want) and got == want


# ---------------------------------------------------------------------------
# Distinct addresses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [6000, 2000])
def test_spread_masked_gives_each_masked_entry_its_own_address(size):
    """Pairwise distinct while the entries fit the indexed tensor; past
    that, as few to an address as the pigeonholes allow."""
    rng = np.random.default_rng(11)
    n = 5000
    flat = torch.from_numpy(rng.integers(0, 40, n))   # heavy repeats
    valid = torch.from_numpy(rng.uniform(size=n) < 0.3)
    got = tc.spread_masked(flat, valid, size)
    assert torch.equal(got[valid], flat[valid])
    masked = got[~valid]
    assert masked.numel() > 3000
    assert int(masked.min()) >= 0 and int(masked.max()) < size
    assert _max_share(masked) == (1 if n <= size else -(-n // size))


#: Index ops whose forward or backward adds into the indexed tensor.
_ADDING = {torch.Tensor.index_select, torch.index_select,
           torch.Tensor.index_add, torch.Tensor.index_add_, torch.index_add,
           torch.Tensor.index_put_, torch.Tensor.index_put, torch.index_put,
           torch.Tensor.__getitem__}


def _int_index(func, args, kwargs):
    """(the integer index an adding op was given, the length of the axis
    it indexes), or None. A 2-D index of `__getitem__` is flattened."""
    dim = 0
    if func in (torch.Tensor.index_put_, torch.Tensor.index_put,
                torch.index_put):
        accumulate = (args[3] if len(args) > 3
                      else kwargs.get("accumulate", False))
        if not accumulate:
            return None
        idx = args[1]
        idx = idx[0] if isinstance(idx, (tuple, list)) and len(idx) == 1 \
            else None
    elif func is torch.Tensor.__getitem__:
        idx = args[1]
        if torch.is_tensor(idx) and idx.dim() == 2:
            idx = idx.reshape(-1)     # a neighbor table's (N, K) slots
    else:
        dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
        idx = args[2] if len(args) > 2 else kwargs.get("index")
    if (torch.is_tensor(idx) and idx.dim() == 1
            and not idx.dtype.is_floating_point and idx.dtype != torch.bool):
        return idx, args[0].shape[dim]
    return None


class _IndexSpy(TorchFunctionMode):
    """Records (op, index, indexed length) of every adding index op run
    inside."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _ADDING:
            got = _int_index(func, args, kwargs)
            if got is not None:
                self.seen.append((getattr(func, "__name__", str(func)),
                                  got[0].detach().clone(), got[1]))
        return func(*args, **kwargs)


def _max_share(idx: torch.Tensor) -> int:
    return int(torch.unique(idx, return_counts=True)[1].max()) \
        if idx.numel() else 0


def _excess(seen) -> int:
    """How far the worst op's most shared address exceeds what the spread
    allows it: one live entry plus ceil(n / length) masked ones."""
    return max(_max_share(idx) - 1 - -(-idx.numel() // size)
               for _, idx, size in seen)


SIM_PATHS = [p for p in PATHS if not p.startswith("splat")]


@pytest.mark.parametrize("path", SIM_PATHS)
def test_no_two_masked_entries_share_an_address(path, clamped):
    """Every adding index op of the simulation paths: each live entry owns
    its address, so an address is shared by at most one live entry and as
    few masked ones as fit (one, where the entries fit the indexed axis).
    The clamped forms, patched in, break that bound (the spy sees what it
    is meant to see)."""
    with _IndexSpy() as spy:
        PATHS[path]()
    assert spy.seen
    assert _excess(spy.seen) <= 0, max(
        ((name, _max_share(idx), idx.numel(), size)
         for name, idx, size in spy.seen), key=lambda t: t[1])
    clamped()
    with _IndexSpy() as spy:
        PATHS[path]()
    assert _excess(spy.seen) > 0


SPY_PATHS = ["sharded_wcsph_1d", "sharded_pcisph_1d",
             "sharded_materials_grad", "sharded_wcsph_2x2",
             "sharded_pcisph_2x2", "unsharded_pcisph_unrolled_grad"]


@pytest.mark.parametrize("path", SPY_PATHS)
def test_gather_planes_read_spread_indices(path, monkeypatch):
    """A spy on gather_plane(s) as each step module calls them: every
    index they read through is in range, and no address holds more than
    one live and one masked entry, so the masked entries are pairwise
    distinct. Under the clamped forms the same gathers see masked entries
    pile onto shared addresses (the masked entries exist and repeat)."""
    def run():
        calls = []

        def spy(fn):
            def wrapped(planes, flat):
                size = (planes if torch.is_tensor(planes)
                        else planes[0]).numel()
                calls.append((flat.clone(), size))
                return fn(planes, flat)
            return wrapped

        with monkeypatch.context() as m:
            for mod in (tdh, td2, tds):
                for name in ("gather_plane", "gather_planes"):
                    if hasattr(mod, name):
                        m.setattr(mod, name, spy(getattr(tc, name)))
            PATHS[path]()
        assert calls
        for flat, size in calls:
            assert int(flat.min()) >= 0 and int(flat.max()) < size
        return max(_max_share(flat) for flat, _ in calls)

    assert run() <= 2
    for mod in (tdh, td2, tds, th):
        monkeypatch.setattr(mod, "spread_masked", _clamped_spread)
    assert run() > 2, "no masked entries repeat: nothing was tested"


def test_splat_masked_entries_leave_the_border():
    """A tile's outside entries no longer pile onto its two border rows:
    each lands at its own flat index modulo the tile's pixels, and an
    inside entry at its own pixel."""
    width, height = 16, 4
    py, px = torch.meshgrid(torch.arange(-8.0, 12.0), torch.arange(-3.0,
                                                                   19.0),
                            indexing="ij")
    got = ts._pixel_index(px, py, width, height)
    inside = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    assert torch.equal(got[inside], (py * width + px)[inside].long())
    assert int(got.min()) >= 0 and int(got.max()) < width * height
    border = _clamped_pixel_index(px, py, width, height)[~inside]
    outside = got[~inside]
    # Clamped: the outside entries share the border's 2 * 16 + 4 pixels;
    # spread: every pixel of the tile gets about as many.
    assert len(torch.unique(border)) <= 2 * width + 2 * (height - 2)
    counts = torch.bincount(outside, minlength=width * height)
    assert int(counts.min()) >= 1
    assert int(counts.max()) <= 2 * outside.numel() // (width * height)


# ---------------------------------------------------------------------------
# mathx
# ---------------------------------------------------------------------------


def test_mathx_has_the_jax_packages_names():
    import dieselfluid_tpu.mathx as jm
    import jax.numpy as jnp

    import dieselfluid_tpu_torch.mathx as tm

    public = {n for n in vars(jm) if not n.startswith("_")
              and n not in ("jax", "jnp")}
    assert public <= set(vars(tm)), public - set(vars(tm))
    for name in ("DEG2RAD", "RAD2DEG", "PI", "EPSILON"):
        assert getattr(tm, name) == getattr(jm, name), name
    x = np.random.default_rng(2).normal(size=64).astype(np.float32) * 3
    for lo, hi in ((-1.0, 1.0), (0.0, 0.5), (2.0, 1.0)):
        want = np.asarray(jm.clamp1f(jnp.asarray(x), lo, hi))
        got = tm.clamp1f(torch.from_numpy(x), lo, hi).numpy()
        assert got.tobytes() == want.tobytes(), (lo, hi)
    assert float(tm.clamp1f(3.5, 0.0, 1.0)) == float(jm.clamp1f(3.5, 0.0,
                                                                 1.0))
