"""The plane-resident layout (solvers.dense_resident): the state lives in
the cell planes of one device; the binning is rebuilt when a particle has
moved `skin` h since the last rebuild. A driver on it gives `step`."""

from __future__ import annotations

from typing import Dict, List

import torch

import drive
import sph


class Layout(drive.Driver):
    def __init__(self, cfg, mix, seed, device):
        super().__init__(cfg, mix, seed, device)
        from dieselfluid_tpu_torch.ops.cellops import DenseCellSpec
        from dieselfluid_tpu_torch.solvers import dense_resident as dr
        from dieselfluid_tpu_torch.solvers.pcisph import compute_pci_delta

        self.params, dx = drive.fluid_params(cfg)
        lo, hi, _ = drive.domain(cfg, self.params.h)
        self.spec = DenseCellSpec.for_domain(
            tuple(lo), tuple(hi), self.params.h,
            capacity=int(cfg["cells"]["capacity"]))
        self.box = tuple(tuple(float(v) for v in b) for b in cfg["box"])
        self.skin = float(cfg["layout"]["skin"])
        self.delta = compute_pci_delta(self.params, dx)
        self._dr = dr

    def setup(self, particles):
        """The program's plane state of `particles`."""
        return self._dr.plane_state_from_fluid(
            drive.fluid_state(particles, self.params), self.spec)

    def warmed(self, ps) -> bool:
        """A rebuild's shapes are reached once the program has rebuilt."""
        return int(ps.rebuilds) > 0

    def end_segment(self, ps):
        self.guards.append(ps.overflow)

    def planes(self, ps):
        """[(planes, spec)] the sweeps read at `ps` (the roofline's
        counts)."""
        return [(ps.planes, self.spec)]

    def rebuilds(self, ps):
        return int(ps.rebuilds)

    #: Per-particle channels of a snapshot: the state planes, then the
    #: binning positions (ref_x, ref_y, ref_z as rx, ry, rz).
    _COLS = ("x", "y", "z", "vx", "vy", "vz", "press", "rx", "ry", "rz")

    def empty_snapshot(self):
        z = {k: torch.empty(self.n, device=self.device) for k in self._COLS}
        z.update(valid=torch.empty(self.n, dtype=torch.bool,
                                   device=self.device),
                 fb_pos=torch.empty(self.n, 3, device=self.device),
                 fb_vel=torch.empty(self.n, 3, device=self.device),
                 rebuilds=torch.empty((), dtype=torch.int32,
                                      device=self.device),
                 overflow=torch.empty((), dtype=torch.int32,
                                      device=self.device))
        return z

    def snapshot(self, ps, buf):
        """Copy the per-particle state of `ps` (read through its slot map)
        and its counters into `buf`, allocating nothing."""
        flat = ps.flat[:self.n]
        planes = dict(ps.planes, rx=ps.ref_x, ry=ps.ref_y, rz=ps.ref_z)
        for k in self._COLS:
            torch.index_select(planes[k].reshape(-1), 0, flat, out=buf[k])
        buf["valid"].copy_(ps.valid[:self.n])
        buf["fb_pos"].copy_(ps.fb_pos)
        buf["fb_vel"].copy_(ps.fb_vel)
        buf["rebuilds"].copy_(ps.rebuilds)
        buf["overflow"].copy_(ps.overflow)
        return buf

    @staticmethod
    def read(buf) -> Dict[str, torch.Tensor]:
        """Per-particle state of a snapshot in particle order (an
        overflowed particle from its fallback rows)."""
        valid = buf["valid"]

        def cols(names, fb):
            return torch.where(valid[:, None],
                               torch.stack([buf[c] for c in names], -1), fb)

        return {"pos": cols(("x", "y", "z"), buf["fb_pos"]),
                "vel": cols(("vx", "vy", "vz"), buf["fb_vel"]),
                "press": torch.where(valid, buf["press"], 0.0),
                "ref": cols(("rx", "ry", "rz"), buf["fb_pos"]),
                "rebuilds": int(buf["rebuilds"]),
                "overflow": int(buf["overflow"])}

    def check(self, caps: List[drive.Capture],
              control: bool = False) -> Dict[str, float]:
        """Each captured step against the reference from the program's
        state before it (step 1: from this benchmark's own particles), and
        the guarantees: finite, inside the box, no cell overflow, the
        rebuild taken exactly when the reference's displacement says.
        `control`: the reference in bfloat16 stands in the program's place
        (its positions, velocities, pressures and iterations)."""
        self.release()
        lo, _, dims = drive.domain(self.cfg, self.prm.h)
        res: Dict[str, float] = {}
        bad_rebuild = bad_iters = 0
        for cap in caps:
            if cap.before is None:
                before = dict(self.particles, ref=self.particles["pos"],
                              rebuilds=0, overflow=0)
            else:
                before = self.read(cap.before)
            after = self.read(cap.after)
            ijk = sph.cell_coords(before["ref"], lo, self.prm.h, dims)
            want = self.reference(before, ijk, dims)
            iters = cap.extra["iters"]
            if control:
                low = self.low(before, ijk, dims)
                after.update(pos=low.pos, vel=low.vel, press=low.press)
                iters = low.iters
            nums = drive.compare_step(after, want, self.prm,
                                      self.compares_press)
            for k, v in nums.items():
                res[k] = max(res.get(k, 0.0), v)
            disp = float((want.pos.float() - before["ref"]).abs().max())
            thr = float(torch.tensor(self.skin * self.prm.h,
                                     dtype=torch.float32))
            rebuilt = after["rebuilds"] - before["rebuilds"]
            bad_rebuild += int(rebuilt != int(disp >= thr))
            if self.counts_iters:
                bad_iters += int(iters != want.iters)
            res["cell_overflow"] = max(res.get("cell_overflow", 0.0), float(
                max(after["overflow"],
                    want.max_count - int(self.cfg["cells"]["capacity"]), 0)))
            res["outside_box"] = max(res.get("outside_box", 0.0),
                                     drive.outside(after["pos"], self.box))
            res["not_finite"] = max(res.get("not_finite", 0.0), float(
                (~torch.isfinite(after["pos"])).sum()
                + (~torch.isfinite(after["vel"])).sum()))
        res["rebuild_mismatch"] = float(bad_rebuild)
        if self.counts_iters:
            res["iters_mismatch"] = float(bad_iters)
        res["segment_overflow"] = float(max((int(g) for g in self.guards),
                                            default=0))
        return res
