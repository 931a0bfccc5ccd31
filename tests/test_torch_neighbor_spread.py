"""The fixed-degree neighbor path reads spread tables, and the port's
packages carry the JAX package's package-level names.

The table builders give every masked slot index 0, as JAX's do. The
backward of each field operator's gather `x[nb.idx]` adds a slot's
cotangent to its row, and on the card the adds to one row run serially,
so every masked slot of a table queued its zero on row 0. Each step now
takes its table through `Neighborhood.spread` once: a masked slot reads
the row of its own flat position modulo the source count. On the CPU, at
a few hundred to a thousand particles:

  (a) the tables the steps gather through hold at most ceil(N K /
      n_source) masked slots to a source row; the clamped form (index 0
      at every masked slot) patched back in breaks that bound;
  (b) every output and every gradient of the SPMD rollout (4 shards), the
      cell-grid halo steps and the `materials=` gradients through
      wcsph_step and the unrolled pcisph_step on both builders equal,
      bit for bit, what the clamped form gives;
  (c) each field operator gives the same bits with the spread table as
      with the raw one, forward and backward, and both stay within
      tests/test_torch_field.py's tolerances of the JAX operator on JAX's
      table.

Then every public name a JAX subpackage defines at package level exists
in the port's package of the same path, as its submodule's own object,
and the port's packages import in fresh interpreters without a cycle,
without JAX and without building the CUDA library.
"""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_field import (  # noqa: F401  (`case` is a fixture)
    GRAD_REL_TOL,
    OPS,
    PARAMS as FIELD_PARAMS,
    REL_TOL,
    TPARAMS as FIELD_TPARAMS,
    _ops,
    _rel,
    case,
)
from test_torch_masked_index import _bits, _int_index, _IndexSpy, _max_share

import dieselfluid_tpu
from dieselfluid_tpu.models import field as JF
from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.geometry.mesh import box
from dieselfluid_tpu_torch.models import field as TF
from dieselfluid_tpu_torch.models.materials import Materials
from dieselfluid_tpu_torch.models.particles import dam_break_state
from dieselfluid_tpu_torch.neighbors import types as ntypes
from dieselfluid_tpu_torch.neighbors.bruteforce import (
    brute_force_neighborhood)
from dieselfluid_tpu_torch.neighbors.cellgrid import (
    CellGridSpec, cell_grid_neighborhood)
from dieselfluid_tpu_torch.parallel import halo as th
from dieselfluid_tpu_torch.parallel.mesh import LocalMesh
from dieselfluid_tpu_torch.parallel.sharding import (
    particle_mesh, shard_state)
from dieselfluid_tpu_torch.parallel.spmd import make_spmd_rollout
from dieselfluid_tpu_torch.solvers import pcisph as tpc
from dieselfluid_tpu_torch.solvers import wcsph as twc

torch.set_num_threads(1)
CPU = torch.device("cpu")
N_DEV = 4
K = 64


def _zero_spread(flat, valid, size):
    """The clamped form: every masked slot keeps index 0, as the builders
    give it (the table the steps gathered through before)."""
    return torch.where(valid, flat, 0)


@pytest.fixture
def clamped(monkeypatch):
    """Patch the clamped form into Neighborhood.spread (which looks
    `spread_masked` up as a module global)."""
    return lambda: monkeypatch.setattr(ntypes, "spread_masked", _zero_spread)


# ---------------------------------------------------------------------------
# The paths: each returns its outputs and gradients
# ---------------------------------------------------------------------------


def _dam(n3, seed=0):
    """A dam break jittered by 0.2 dx with N(0, 0.5^2) velocities; d0
    raised 10% so the pressure is live."""
    dx = (2.0 / n3) * 0.5
    params = FluidParams.for_spacing(dx)
    s0 = dam_break_state(n3, params, CPU)
    params = params.replace(d0=float(1.1 * params.d0))
    rng = np.random.default_rng(seed)
    pos = s0.pos + torch.from_numpy(rng.uniform(
        -0.2, 0.2, tuple(s0.pos.shape)).astype(np.float32)) * dx
    vel = torch.from_numpy(rng.normal(size=tuple(s0.pos.shape)).astype(
        np.float32) * 0.5)
    return params, s0._replace(pos=pos, vel=vel), dx


def _spmd_rollout():
    """The SPMD rollout's 2 frames over 4 shards (sharded_train_step's
    loss), with its gradients to the velocities and every Materials
    field."""
    params, s0, _ = _dam(10)
    mesh = particle_mesh(N_DEV, CPU)
    st = shard_state(s0, mesh)
    vel = st.vel.clone().requires_grad_()
    mats = Materials.from_params(params, CPU, requires_grad=True)
    final, max_vel = make_spmd_rollout(mesh, params, 2, k=K)(
        st._replace(vel=vel), mats)
    loss = (((final.pos[:, 1] + 0.9) ** 2).mean()
            + 1e-4 * (final.vel ** 2).mean())
    return (final, max_vel, loss,
            torch.autograd.grad(loss, [vel, *mats], allow_unused=True))


def _halo(solver):
    """One cell-grid halo step with boundary stores over 4 slabs (the
    fluid in the first two), with the gradients of a loss on its result
    to the stores' positions and velocities."""
    params, s0, dx = _dam(10)
    bnd = box(1.6, 1.6, 1.6, device=CPU).generate_boundary_particles(
        dx / params.h)
    spec = th.SlabSpec(n_dev=N_DEV, capacity=1024, halo_capacity=256,
                       migrate_capacity=64, h=params.h)
    slabs = th.distribute(s0._replace(boundary_pos=bnd), spec)
    mesh = LocalMesh((N_DEV,), CPU)
    if solver == "wcsph":
        step = th.make_halo_step(mesh, spec, params, k=K, boundary=True)
    else:
        step = th.make_halo_pcisph_step(
            mesh, spec, params, tpc.compute_pci_delta(params, dx), k=K,
            boundary=True, warm_start=True)
    pos = slabs.pos.clone().requires_grad_()
    vel = slabs.vel.clone().requires_grad_()
    out = step(slabs._replace(pos=pos, vel=vel))
    nxt = out[0]
    live = (nxt.alive > 0)[:, None]
    loss = (live * (torch.sin(3.0 * nxt.pos) + nxt.vel)).sum()
    return (out, getattr(step, "iters", None),
            torch.autograd.grad(loss, [pos, vel]))


def _builder(name, params):
    if name == "cellgrid":
        spec = CellGridSpec.for_domain((-1.0,) * 3, (1.0,) * 3, params.h,
                                       capacity=16)
        return lambda p: cell_grid_neighborhood(p, p, params.h, K, spec)
    return lambda p: brute_force_neighborhood(p, p, params.h, K)


def _materials_grad(solver, builder):
    """d loss / d (Materials, positions, velocities) through one
    wcsph_step(materials=) or pcisph_step(unroll_for_grad=True,
    materials=)."""
    params, s0, dx = _dam(8)
    nfn = _builder(builder, params)
    mats = Materials.from_params(params, CPU, requires_grad=True)
    pos = s0.pos.clone().requires_grad_()
    vel = s0.vel.clone().requires_grad_()
    st = s0._replace(pos=pos, vel=vel)
    if solver == "wcsph":
        nxt, diag = twc.wcsph_step(st, params, neighbor_fn=nfn,
                                   materials=mats)
    else:
        nxt, diag = tpc.pcisph_step(st, params,
                                    tpc.compute_pci_delta(params, dx),
                                    neighbor_fn=nfn, unroll_for_grad=True,
                                    materials=mats)
    w = torch.from_numpy(np.random.default_rng(4).normal(
        size=tuple(nxt.pos.shape)).astype(np.float32))
    loss = (nxt.pos * w).sum() + 1e-3 * nxt.pressure.sum()
    return (nxt, diag, torch.autograd.grad(loss, [*mats, pos, vel],
                                           allow_unused=True))


PATHS = {
    "spmd_rollout_4_shards": _spmd_rollout,
    "halo_wcsph_step": lambda: _halo("wcsph"),
    "halo_pcisph_step": lambda: _halo("pcisph"),
    "wcsph_materials_cellgrid": lambda: _materials_grad("wcsph",
                                                        "cellgrid"),
    "wcsph_materials_bruteforce": lambda: _materials_grad("wcsph",
                                                          "bruteforce"),
    "pcisph_unrolled_materials_cellgrid": lambda: _materials_grad(
        "pcisph", "cellgrid"),
    "pcisph_unrolled_materials_bruteforce": lambda: _materials_grad(
        "pcisph", "bruteforce"),
}


# ---------------------------------------------------------------------------
# (a) masked slots spread over the source rows
# ---------------------------------------------------------------------------


class _TableGatherSpy(_IndexSpy):
    """Records (index, indexed length) of every gather through a 2-D
    integer index of a tensor that requires grad: the gathers whose
    backward adds into a source's gradient."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func is torch.Tensor.__getitem__ and torch.is_tensor(args[0])
                and args[0].requires_grad and torch.is_tensor(args[1])
                and args[1].dim() == 2):
            got = _int_index(func, args, kwargs)
            if got is not None:
                self.seen.append((got[0].detach().clone(), got[1]))
        return func(*args, **kwargs)


def _run_recording_tables(path, monkeypatch):
    """Run a path under the spy, recording every table Neighborhood.spread
    returns (with its source count)."""
    tables = []
    spread = ntypes.Neighborhood.spread

    def recording(self, n_source):
        nb = spread(self, n_source)
        tables.append((nb, n_source))
        return nb

    with monkeypatch.context() as m:
        m.setattr(ntypes.Neighborhood, "spread", recording)
        with _TableGatherSpy() as spy:
            PATHS[path]()
    return tables, spy.seen


def _masked_excess(tables, seen) -> int:
    """How far the most shared source row's masked slots exceed ceil(N K /
    n_source), over the tables and over every gather through them (each
    gather must read a recorded table)."""
    excess = []
    for nb, n_source in tables:
        masked = nb.idx[nb.mask == 0]
        assert int(masked.min()) >= 0 and int(nb.idx.max()) < n_source
        excess.append(_max_share(masked) - -(-nb.idx.numel() // n_source))
    for idx, size in seen:
        nb = next((nb for nb, _ in tables if nb.idx.numel() == idx.numel()
                   and torch.equal(nb.idx.reshape(-1), idx)), None)
        assert nb is not None, "a gather read a table that was not spread"
        masked = idx[nb.mask.reshape(-1) == 0]
        excess.append(_max_share(masked) - -(-idx.numel() // size))
    return max(excess)


@pytest.mark.parametrize("path", list(PATHS))
def test_masked_slots_spread_over_the_source_rows(path, monkeypatch,
                                                  clamped):
    """Every table a step takes is spread once, every field operator's
    gather reads one, and no source row holds more than ceil(N K /
    n_source) of its masked slots. The clamped form patched in piles them
    onto row 0."""
    tables, seen = _run_recording_tables(path, monkeypatch)
    assert tables and seen
    assert sum(int((nb.mask == 0).sum()) for nb, _ in tables) > 0
    assert _masked_excess(tables, seen) <= 0
    clamped()
    tables, seen = _run_recording_tables(path, monkeypatch)
    assert _masked_excess(tables, seen) > 0


@pytest.mark.parametrize("m,size", [(0, 5), (3, 100), (5, 5), (7, 5),
                                    (6400, 100), (6401, 100),
                                    (128_000, 8_000)])
def test_spread_masked_equals_its_modulo_form(m, size):
    """The division-free spread is the masked entry's own index modulo
    `size`, bit for bit: whole rows of `size`, a shorter last row, fewer
    entries than `size`, none."""
    rng = np.random.default_rng(m)
    flat = torch.from_numpy(rng.integers(0, 40, m))
    valid = torch.from_numpy(rng.uniform(size=m) < 0.3)
    want = torch.where(valid, flat, torch.arange(m) % size)
    got = ntypes.spread_masked(flat, valid, size)
    assert got.dtype == want.dtype and torch.equal(got, want)


# ---------------------------------------------------------------------------
# (b) bit for bit the clamped form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", list(PATHS))
def test_bit_for_bit_the_clamped_table(path, clamped):
    """The row a masked slot reads is multiplied by its zero mask: moving
    it changes no bit of any output or gradient."""
    got = _bits(PATHS[path]())
    clamped()
    want = _bits(PATHS[path]())
    assert len(got) == len(want) and got == want


# ---------------------------------------------------------------------------
# (c) the field operators on the spread table, against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("full", [True, False], ids=["pool", "shard"])
@pytest.mark.parametrize("op", OPS)
def test_operator_on_the_spread_table_matches_the_raw_one_and_jax(
        case, op, full):  # noqa: F811
    arrays, jnb, jnb_shard = case
    nb_j = jnb if full else jnb_shard
    raw = interop.neighborhood_from_numpy(np.asarray(nb_j.idx),
                                          np.asarray(nb_j.mask),
                                          device="cpu")
    n_source = arrays["pos"].shape[0]
    spread = raw.spread(n_source)
    assert torch.equal(spread.mask, raw.mask)
    assert not torch.equal(spread.idx, raw.idx), "no masked slot moved"
    fj = _ops(JF, FIELD_PARAMS)[op]
    ft = _ops(TF, FIELD_TPARAMS)[op]
    names = ("pos", "rho", "f", "v")
    jin = [jnp.asarray(arrays[k]) for k in names]
    want = fj(*jin, nb_j, full)
    w = np.random.default_rng(3).normal(size=want.shape).astype(np.float32)
    jgrads = jax.grad(lambda *xs: jnp.sum(fj(*xs, nb_j, full) * w),
                      argnums=(0, 1, 2, 3))(*jin)

    results = []
    for nb in (raw, spread):
        tin = [torch.from_numpy(arrays[k].copy()).requires_grad_(True)
               for k in names]
        got = ft(*tin, nb, full)
        grads = torch.autograd.grad(torch.sum(got * torch.from_numpy(w)),
                                    tin, allow_unused=True)
        assert _rel(got.detach().numpy(), want) < REL_TOL
        for name, jg, tg in zip(names, jgrads, grads):
            jg = np.asarray(jg)
            tg = np.zeros_like(jg) if tg is None else tg.numpy()
            assert np.isfinite(tg).all(), name
            if np.abs(jg).max() > 0:
                assert _rel(tg, jg) < GRAD_REL_TOL, name
            else:
                assert not np.abs(tg).any(), name
        results.append(_bits((got, grads)))
    assert results[0] == results[1]


# ---------------------------------------------------------------------------
# A13: the package-level names
# ---------------------------------------------------------------------------

JAX_ROOT = Path(dieselfluid_tpu.__file__).resolve().parent
SUBPACKAGES = sorted(p.parent.name for p in JAX_ROOT.glob("*/__init__.py"))


def _package_names(init: Path):
    """name -> (the module it is imported from, or None where the package
    defines it itself) for every public name of a package __init__."""
    names = {}
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                names[a.asname or a.name] = node.module
        elif isinstance(node, ast.Import):
            for a in node.names:
                names[a.asname or a.name.split(".")[0]] = None
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names[t.id] = None
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names[node.name] = None
    return {n: m for n, m in names.items() if not n.startswith("_")}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_package_has_the_jax_packages_names(sub):
    """Each public name the JAX subpackage defines at package level is in
    the port's package of the same path: the very object of the port's
    submodule it comes from (a submodule itself where JAX imports one)."""
    names = _package_names(JAX_ROOT / sub / "__init__.py")
    port = importlib.import_module(f"dieselfluid_tpu_torch.{sub}")
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, missing
    for name, module in names.items():
        if module is None:
            continue
        assert module.startswith(f"dieselfluid_tpu.{sub}"), module
        twin = importlib.import_module(
            module.replace("dieselfluid_tpu", "dieselfluid_tpu_torch", 1))
        want = getattr(twin, name, None)
        if want is None:        # `from pkg import submodule`
            want = importlib.import_module(f"{twin.__name__}.{name}")
        assert getattr(port, name) is want, name


PORT_PACKAGES = ["ops", "solvers", "models", "io", "utils", "render",
                 "models.sph", "parallel", "sky", "app.cli"]


def test_packages_import_fresh_without_a_cycle_or_a_build():
    """Each package imports first in a fresh interpreter where JAX and the
    JAX package cannot be imported; none builds or loads the CUDA
    library or the framepack library."""
    code = """
import importlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "dieselfluid_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
importlib.import_module("dieselfluid_tpu_torch." + sys.argv[1])
from dieselfluid_tpu_torch.io import native
from dieselfluid_tpu_torch.ops import _build
assert _build._lib is None and _build.build_log == ""
assert native._lib is None and not native._tried
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "dieselfluid_tpu"))
assert not bad, bad
print("clean")
"""
    for pkg in PORT_PACKAGES:
        out = subprocess.run([sys.executable, "-c", code, pkg],
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, (pkg, out.stderr)
        assert out.stdout.strip().endswith("clean"), pkg
