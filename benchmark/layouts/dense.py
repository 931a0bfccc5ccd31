"""The dense layout (solvers.dense_step): a state of particles, binned into
the cell planes anew at every step from its own positions. A driver on it
gives `grad(start)`, the program's step from one start state; `step` takes
the starts in turn.

The window's state is a `Cursor`: the index of the next start and the last
step's results (the program's device tensors, read only after the window).
Each segment goes once over the starts from the first. The check follows a
captured step's results against the plain reference (reference/grad.py)
from the same start, drawn again from the seed."""

from __future__ import annotations

import math
import sys
from typing import Dict, List, NamedTuple, Optional

import torch

import drive
import grad as ref

#: The frame of the first start's step, for the raster readers:
#: {"pairs", "occupied_rows", "n_tiles", "k", "th", "tw"} (set by
#: `Layout.setup`, before the warm-up and the launch counts).
FRAME: Dict[str, int] = {}


#: A material's gradient is compared relative to itself (`grad_*_rel`), or
#: to this share of its scale where it is smaller: a sum of shares of both
#: signs, it changes sign from seed to seed and can pass near 0 (at 1M, on
#: an H100 over 24 starts, a d0 or mass gradient read 4.3e-5 to 1.2e-2 of
#: its scale, mu's 4.0e-4 to 9.0e-3). The disc cutoff's tie room is 3.6e-3
#: to 8.9e-3 of the scale on each side there, so a gradient moved less
#: than that is not told from the reference's at that size.
REL_FLOOR = 1e-4


class Cursor(NamedTuple):
    turn: int
    out: Optional[tuple]


class Layout(drive.Driver):
    def __init__(self, cfg, mix, seed, device):
        super().__init__(cfg, mix, seed, device)
        from dieselfluid_tpu_torch.models.materials import Materials
        from dieselfluid_tpu_torch.ops.cellops import DenseCellSpec
        from dieselfluid_tpu_torch.solvers import materials_grad as mg
        from dieselfluid_tpu_torch.solvers.pcisph import compute_pci_delta

        self.params, dx = drive.fluid_params(cfg)
        lo, hi, _ = drive.domain(cfg, self.params.h)
        self.spec = DenseCellSpec.for_domain(
            tuple(lo), tuple(hi), self.params.h,
            capacity=int(cfg["cells"]["capacity"]))
        self.box = tuple(tuple(float(v) for v in b) for b in cfg["box"])
        self.delta = compute_pci_delta(self.params, dx)
        self.unroll = int(cfg["layout"]["unroll_iters"])
        self.frame = ref.frame_from_config(cfg)
        r = cfg["render"]
        self._mg = mg
        self.mats = Materials.from_params(self.params, device,
                                          requires_grad=True)
        self.cam, self.cube = mg.config4_scene(
            device, position=tuple(r["camera"]["position"]),
            front=tuple(r["camera"]["front"]),
            fov_deg=float(r["camera"]["fov_deg"]), width=self.frame.width,
            height=self.frame.height, sun=tuple(r["sky"]["sun"]),
            cube_size=int(r["sky"]["cube_size"]))

    def setup(self, particles):
        """The program's state of `particles`; the first (start 0, made
        before the others) also measures the frame of its step (FRAME), so
        that no launch of that measure falls among the counted ones."""
        state = drive.fluid_state(particles, self.params)
        if not self.starts:
            FRAME.clear()
            FRAME.update(self._frame_stats(state))
        return state

    def copy_start(self, k: int = 0):
        """A segment's first cursor: the starts in turn from the first (the
        starts are read, never written, so none is copied)."""
        return Cursor(0, None)

    def step(self, st):
        if not isinstance(st, Cursor):
            st = Cursor(0, None)
        out = self.grad(self.starts[st.turn % len(self.starts)])
        return Cursor(st.turn + 1, out)

    def end_segment(self, st):
        pass

    def rebuilds(self, st):
        return None

    def snapshot_points(self, check_at: List[int]) -> List[int]:
        """Only the checked steps: each starts from a start of its own."""
        return sorted(set(check_at))

    def empty_snapshot(self):
        def z(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device=self.device)

        return {"loss": z(), "grad_mu": z(), "grad_d0": z(),
                "grad_mass": z(), "grad_pos": z(self.n, 3),
                "overflow": z(dtype=torch.int64), "start": -1}

    def snapshot(self, st, buf):
        """Copy the results of the step that made `st` into `buf`."""
        for k, v in zip(("loss", "grad_mu", "grad_d0", "grad_mass",
                         "grad_pos", "overflow"), st.out):
            buf[k].copy_(v)
        buf["start"] = (st.turn - 1) % len(self.starts)
        return buf

    def planes(self, st):
        """[(planes, spec)] the sweeps read (the binning of the first
        start: every step's planes share its occupancy). Launches no
        sweep."""
        from dieselfluid_tpu_torch.ops.cellops import (
            build_planes, dense_indices, spread_masked)

        pos = self.starts[0].pos
        flat, valid, _ = dense_indices(pos, self.spec)
        flat = spread_masked(flat, valid, self.spec.size)
        planes = build_planes({"x": pos[:, 0], "y": pos[:, 1],
                               "z": pos[:, 2]}, flat, valid, self.spec)
        return [(planes, self.spec)]

    @torch.no_grad()
    def _frame_stats(self, start) -> Dict[str, int]:
        from dieselfluid_tpu_torch.render.splat_tiled import (
            TileSpec, tile_entries)
        from dieselfluid_tpu_torch.solvers.dense_step import (
            dense_pcisph_step)

        nxt, _ = dense_pcisph_step(start, self.params, self.spec,
                                   self.delta, bounds=self.box,
                                   materials=self.mats, unroll_for_grad=True,
                                   unroll_iters=self.unroll)
        ts = TileSpec(self.frame.width, self.frame.height, k=self.frame.k)
        planes = tile_entries(nxt.pos, self.frame.radius, self.cam, ts)[0]
        r = planes["r"]
        live = r.reshape(-1) >= 0.5
        half = ts.patch // 2

        def extent(c, size):
            f = torch.floor(c.reshape(-1)[live])
            return torch.clamp(torch.clamp(f + half, max=size - 1)
                               - torch.clamp(f - half, min=0) + 1, min=0)

        return {"pairs": int((extent(planes["u"], ts.tw).double()
                              * extent(planes["v"], ts.th).double()).sum()),
                "occupied_rows": int((r.reshape(-1, 128).amax(-1)
                                      >= 0.5).sum()),
                "n_tiles": ts.n_tiles, "k": ts.k, "th": ts.th, "tw": ts.tw}

    def check(self, caps: List[drive.Capture],
              control: bool = False) -> Dict[str, float]:
        """Each captured step's results against the reference's from the
        same start (drawn again from the seed), and the guarantees.
        `control`: the reference in bfloat16 stands in the program's
        place. The loss is compared relative to the reference's; each
        material's gradient, beyond the room the disc cutoff's rounding
        ties give it (grad.py's `grad_step`), relative to the sum of the
        magnitudes of the particles' shares of it (`_gap`: the gradient is
        a sum of terms of both signs that nearly cancel) and relative to
        the reference's gradient itself (`_rel`, at least REL_FLOOR of the
        scale); the positions' gradients, by their norm and their largest
        entry, beyond the nearer of the two sides of those ties, over the
        particles off the disc's rim and off a projection's or a wall's
        rounding tie. Each start's material numbers go to stderr."""
        cube = self.cube
        self.release()
        self.mats = None
        res: Dict[str, float] = {}

        def keep(name, v):
            """The largest reading of `name`; not a number stays so."""
            v, was = float(v), res.get(name, 0.0)
            res[name] = v if math.isnan(v) or v > was else was

        for cap in caps:
            buf = cap.after
            k = int(buf["start"])
            start = self.particles if k == 0 else self.draw(k)
            want = ref.grad_step(start, self.cfg, self.prm, cube,
                                 unroll=self.unroll, box=self.box)
            if control:
                low = ref.grad_step(start, self.cfg, self.prm, cube,
                                    unroll=self.unroll, box=self.box,
                                    dtype=torch.bfloat16)
                got = {"loss": low.loss, "grad_mu": low.grad_mu,
                       "grad_d0": low.grad_d0, "grad_mass": low.grad_mass,
                       "grad_pos": low.grad_pos.double(),
                       "overflow": low.overflow}
            else:
                got = {n: float(buf[n]) for n in ("loss", "grad_mu",
                                                  "grad_d0", "grad_mass")}
                got["grad_pos"] = buf["grad_pos"].double()
                got["overflow"] = int(buf["overflow"])
            vals = torch.tensor([got[n] for n in ("loss", "grad_mu",
                                                  "grad_d0", "grad_mass")],
                                dtype=torch.float64)
            keep("not_finite", (~torch.isfinite(vals)).sum()
                 + (~torch.isfinite(got["grad_pos"])).sum())
            keep("reference_not_finite", 0 if want.finite else 1)
            keep("loss_gap", abs(got["loss"] - want.loss) / abs(want.loss))
            for n in ("mu", "d0", "mass"):
                below, above = getattr(want, "range_" + n)
                w, scale = getattr(want, "grad_" + n), getattr(
                    want, "scale_" + n)
                miss = max(w + below - got["grad_" + n],
                           got["grad_" + n] - (w + above), 0.0)
                keep(f"grad_{n}_gap", miss / scale)
                keep(f"grad_{n}_rel", miss / max(abs(w), REL_FLOOR * scale))
                print(f"check: start {k}: grad_{n} {got['grad_' + n]!r}, "
                      f"reference {w!r}, |reference|/scale "
                      f"{abs(w) / scale!r}, room {below / scale!r} "
                      f"{above / scale!r} of the scale", file=sys.stderr)
            on = ~((want.rim_gap < ref.RIM) | want.on_tie | want.wall_tie)
            wp, wa = want.grad_pos.double()[on], want.pos_alt.double()[on]
            gp = got["grad_pos"][on]
            miss = torch.maximum(torch.minimum(wp, wa) - gp,
                                 gp - torch.maximum(wp, wa)).clamp(min=0.0)
            keep("pos_grad_norm_gap", float(miss.norm())
                 / max(float(wp.norm()), 1e-300))
            keep("pos_grad_max_gap", float(miss.max())
                 / max(float(wp.abs().max()), 1e-300))
            print(f"check: start {k}: positions' gradients compared over "
                  f"{float(on.double().mean())!r} of the particles",
                  file=sys.stderr)
            keep("overflow_mismatch", max(
                0, abs(got["overflow"] - want.overflow) - want.overflow_ties))
            keep("cell_overflow", max(
                0, want.max_count - int(self.cfg["cells"]["capacity"])))
            del want, start
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        return res
