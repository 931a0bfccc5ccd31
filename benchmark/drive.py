"""The general traffic generator: it finds the driver of a cell by name,
sets the program up from the configuration file and the seed, and holds
what every driver shares (the start copies, the check's captures and its
numbers).

A traffic mix (traffic/<mix>.json) is data only: the solver, how many
seeded starts the window cycles through, the segment's length, the warm-up
and how many steps the check follows. A
configuration (configs/<config>.json) names its layout. The driver of a
cell is the file drivers/<layout>.<solver>.py, found by those two names:
its class `Driver` builds on a layout (layouts/<layout>.py: set-up,
snapshots, the check) and gives the program's step entry. A new layout, or
a new solver on one, is a new file; no file here names either.

The program is imported only inside the layouts and drivers; the reference
(reference/) imports nothing of it.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path
from typing import Dict, List, NamedTuple

import torch

import sph

HERE = Path(__file__).resolve().parent


class Capture(NamedTuple):
    """One step the check follows: snapshots of the program's state before
    it (None: this benchmark's own start) and after it, and what the step
    returned besides (the PCISPH iteration count)."""

    before: object
    after: object
    extra: dict


def clone(obj, memo=None):
    """A device copy of a state: every tensor cloned once (aliases stay
    aliases), containers rebuilt, everything else shared."""
    memo = {} if memo is None else memo
    if isinstance(obj, torch.Tensor):
        if id(obj) not in memo:
            memo[id(obj)] = obj.clone()
        return memo[id(obj)]
    if isinstance(obj, dict):
        return {k: clone(v, memo) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[clone(v, memo) for v in obj])
    return obj


def domain(cfg: dict, h: float):
    """(lo, hi, dims) of the configuration's cell grid: the box widened by
    `lo_offset_h` kernel radii on each side, cells of edge h."""
    off = float(cfg["cells"]["lo_offset_h"]) * h
    lo = [float(b) - off for b in cfg["box"][0]]
    hi = [float(b) + off for b in cfg["box"][1]]
    dims = [max(1, int(math.ceil((b - a) / h))) for a, b in zip(lo, hi)]
    return lo, hi, dims


def _gap(got, want, scale, alt=None) -> float:
    """Largest |got - want| over the rows (the row's largest entry; with
    `alt`, the nearer of want and alt for each row), over `scale` (0 when
    there are no rows)."""
    if got.numel() == 0:
        return 0.0

    def rows(w):
        d = (got.double() - w.double()).abs()
        return d.reshape(d.shape[0], -1).max(-1).values

    d = rows(want)
    if alt is not None:
        d = torch.minimum(d, rows(alt))
    d = float(d.max())
    return d / scale if scale > 0 else (0.0 if d == 0 else math.inf)


def compare_step(got: Dict[str, torch.Tensor], want: sph.Step,
                 prm: sph.Params, with_press: bool) -> Dict[str, float]:
    """The numbers the check holds to its limits, for one step of the live
    particles: positions in lattice spacings, velocities against the
    largest velocity, pressures against the largest pressure. A particle
    on a wall test's rounding tie is held to the nearer of its two
    outcomes."""
    out = {"pos_gap_dx": _gap(got["pos"], want.pos, prm.dx, want.pos_alt),
           "vel_gap": _gap(got["vel"], want.vel,
                           float(want.vel.double().abs().max()),
                           want.vel_alt)}
    if with_press:
        out["press_gap"] = _gap(got["press"], want.press,
                                float(want.press.double().abs().max()))
    return out


def outside(pos, box) -> float:
    """Rows of `pos` outside the box ((lo, hi) corners)."""
    lo = torch.tensor(box[0], dtype=pos.dtype, device=pos.device)
    hi = torch.tensor(box[1], dtype=pos.dtype, device=pos.device)
    return float(((pos < lo) | (pos > hi)).any(-1).sum())


def fluid_params(cfg: dict):
    """The program's FluidParams for the configuration, made by the
    program's own constructors."""
    from dieselfluid_tpu_torch.config import FluidParams
    from dieselfluid_tpu_torch.neighbors.calibrate import (
        lattice_rest_density)

    f = cfg["fluid"]
    dx = 2.0 * float(cfg["extent"]) / int(cfg["n3"])
    params = FluidParams.for_spacing(dx, h_factor=float(f["h_factor"]),
                                     mass=float(f["mass"]),
                                     sound_speed=float(f["sound_speed"]),
                                     mu=float(f["mu"]))
    params = params.replace(
        gravity=tuple(float(g) for g in f["gravity"]),
        tait_gamma=float(f["tait_gamma"]),
        pci_max_iters=int(f["pcisph_max_iters"]),
        pci_max_density_error_ratio=float(
            f["pcisph_max_density_error_ratio"]))
    return lattice_rest_density(dx, params), dx


def fluid_state(particles, params):
    from dieselfluid_tpu_torch.models.particles import (
        FluidState, gravity_force)

    n = particles["pos"].shape[0]
    dev = particles["pos"].device
    return FluidState(pos=particles["pos"].clone(),
                      vel=particles["vel"].clone(),
                      force=gravity_force(params, n, dev),
                      density=torch.zeros(n, device=dev),
                      pressure=particles["press"].clone())


def reset_launch_counts():
    from dieselfluid_tpu_torch.ops import sph_sweep
    from dieselfluid_tpu_torch.render import splat_tiled

    sph_sweep.reset_launch_counts()
    splat_tiled.reset_launch_counts()


def launch_counts() -> Dict[str, int]:
    """Launches of each hand-written kernel since the last reset, by the
    program's counters."""
    from dieselfluid_tpu_torch.ops import sph_sweep
    from dieselfluid_tpu_torch.render import splat_tiled

    return {k.name: k.launches for k in sph_sweep.SWEEPS
            + splat_tiled.KERNELS}


def start_seed(seed: int, k: int) -> int:
    """The seed of the window's k-th start: the run's own for the first
    (the one the check follows), the others a golden-ratio stride apart,
    which moves the low 32 bits (all that the CPU generator reads)."""
    return (int(seed) + int(k) * 0x9E3779B9) % 2 ** 63


class Driver:
    """What every layout shares. A layout (layouts/<layout>.py) gives
    `setup`, the snapshots and the check; a driver
    (drivers/<layout>.<solver>.py) gives `step`.

    Class attributes a driver may set: `counts_iters` (the step returns a
    PCISPH iteration count the check holds to the reference's),
    `compares_press` (the check compares pressures)."""

    counts_iters = False
    compares_press = False

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.solver = mix["solver"]
        self.warm = bool(mix.get("warm_start", False))
        self.prm = sph.params_from_config(cfg)
        self.n = int(cfg["n3"]) ** 3
        self.iters: List[int] = []
        self.guards: List[torch.Tensor] = []
        self.snaps: List[dict] = []
        self.starts: List[object] = []
        self.own = None
        self.wall = {"restitution": float(cfg["box_restitution"]),
                     "friction": float(cfg["box_friction"])}

    def draw(self, k: int) -> Dict[str, torch.Tensor]:
        """This benchmark's particles of the k-th start, from the seed."""
        return sph.dam_break(self.cfg, start_seed(self.seed, k), self.device)

    def copy_start(self, k: int = 0):
        return clone(self.starts[k % len(self.starts)])

    def warmed(self, state) -> bool:
        """Whether the warm-up has reached every shape the steps take."""
        return True

    def reference(self, before, ijk, dims, **kw) -> sph.Step:
        """The plain reference's step of the mix's solver."""
        return sph.step(before, self.prm, ijk, dims, self.solver, self.box,
                        warm_start=self.warm, **self.wall, **kw)

    def low(self, before, ijk, dims) -> sph.Step:
        """The control: the reference step computed in bfloat16, sums and
        state alike, its results as float32."""
        st = self.reference(before, ijk, dims, dtype=torch.bfloat16,
                            state_dtype=torch.bfloat16)
        return st._replace(pos=st.pos.float(), vel=st.vel.float(),
                           press=st.press.float(),
                           pos_alt=st.pos_alt.float(),
                           vel_alt=st.vel_alt.float())

    def release(self):
        """Drop the program's start states, so that the reference runs in
        the memory they held."""
        self.starts = []
        self.own = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def snapshot_points(self, check_at: List[int]) -> List[int]:
        """The steps after which the window copies the program's state:
        every checked step and the one before it (step 0 is this
        benchmark's own start)."""
        return sorted({k for j in check_at for k in (j - 1, j)} - {0})

    def check_steps(self, segment_steps: int) -> List[int]:
        """Step 1 and `check_steps` more drawn from the seed (1-based, in
        the first segment of the window)."""
        g = torch.Generator()
        g.manual_seed(int(self.seed) + 1)
        k = int(self.mix["check_steps"])
        rest = (torch.randperm(segment_steps - 1, generator=g)[:k] + 2)
        return [1] + sorted(int(j) for j in rest)


def _identity(make):
    return make()


def set_up(drv: Driver, hold=_identity):
    """The program's set-up from the seed. `hold(make)` runs an allocation
    of this benchmark's own (its particles, the start copies) and counts
    it as such. The program sets up the first start from this benchmark's
    particles (its peak is the program's); the window's copy of it and the
    further starts the mix asks for are this benchmark's. The program's own
    first state is left in `drv.own` for the warm-up to consume."""
    drv.particles = hold(lambda: drv.draw(0))
    own = drv.setup(drv.particles)
    drv.starts = [hold(lambda: clone(own))]
    for k in range(1, int(drv.mix.get("starts", 1))):
        drv.starts.append(hold(lambda k=k: drv.setup(drv.draw(k))))
    drv.own = own


def driver_file(cfg: dict, mix: dict) -> Path:
    return HERE / "drivers" / f"{cfg['layout']['kind']}.{mix['solver']}.py"


def driver_class(cfg: dict, mix: dict):
    """The class `Driver` of drivers/<layout>.<solver>.py."""
    path = driver_file(cfg, mix)
    spec = importlib.util.spec_from_file_location(
        "driver_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Driver


def make(cfg: dict, mix: dict, seed: int, device) -> Driver:
    return driver_class(cfg, mix)(cfg, mix, seed, device)
