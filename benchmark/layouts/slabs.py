"""The slab layout (parallel.dense_halo): x-slabs of whole cell columns,
each shard's planes with ghost columns exchanged, migration over the faces,
all shards on one device (a LocalMesh). A driver on it gives `make_step`,
the program's step function on the layout's mesh, spec and parameters."""

from __future__ import annotations

from typing import Dict, List

import torch

import drive
import slabs as ref_slabs
import sph


class Layout(drive.Driver):
    def __init__(self, cfg, mix, seed, device):
        super().__init__(cfg, mix, seed, device)
        from dieselfluid_tpu_torch.parallel import dense_halo as dh
        from dieselfluid_tpu_torch.parallel.mesh import LocalMesh

        self.params, _ = drive.fluid_params(cfg)
        self.mesh = LocalMesh((int(cfg["layout"]["shards"]),), device)
        self.spec = None
        self._dh = dh
        self.start_mismatch = 0.0

    def _build(self, st):
        """The slab spec, sized by the first start, and the step."""
        lay = self.cfg["layout"]
        h = self.params.h
        lo, hi, dims = drive.domain(self.cfg, h)
        self.spec = self._dh.DenseSlabSpec.build_for_state(
            st, int(lay["shards"]), h, int(lay["migrate_capacity"]),
            lo=lo[0], hi=hi[0], cell_capacity=int(self.cfg["cells"]["capacity"]))
        self._step = self.make_step()
        sp = self.spec
        self.lay = {"n_dev": sp.n_dev, "capacity": sp.capacity,
                    "migrate": sp.migrate_capacity, "lo": sp.lo,
                    "width": sp.slab_width, "cell": sp.cell, "nxd": sp.nxd,
                    "dims": [sp.n_dev * sp.nxd, dims[1], dims[2]]}
        self.box = ((sp.lo,) * 3, (sp.hi_x, sp.hi_yz, sp.hi_yz))

    def setup(self, particles):
        """The program's slab stores of `particles` (the first call sizes
        the slabs)."""
        st = drive.fluid_state(particles, self.params)
        if self.spec is None:
            self._build(st)
        return self._dh.distribute_dense(st, self.spec)

    def step(self, slabs):
        slabs, _, n_live, ovf, _ = self._step(slabs)
        self._last = (n_live, ovf)
        return slabs

    def end_segment(self, slabs):
        n_live, ovf = self._last
        self.guards.append(torch.stack([
            (n_live.double() - self.n).abs(), slabs.dropped.double(),
            ovf.double()]).max())

    def planes(self, slabs):
        lspec = self.spec.local_spec
        return [(p, lspec) for p in self._dh.frame_planes(self.mesh,
                                                          self.spec, slabs)]

    def rebuilds(self, slabs):
        return None

    def migrated(self, before, stepped: sph.Step):
        """The stores the migration rule makes of a step's results."""
        return ref_slabs.migrate(
            before, {"pos": stepped.pos, "vel": stepped.vel,
                     "press": stepped.press,
                     "pos_alt": stepped.pos_alt,
                     "vel_alt": stepped.vel_alt}, self.lay)

    def empty_snapshot(self):
        rows = self.starts[0].pos.shape[0]
        return {"pos": torch.empty(rows, 3, device=self.device),
                "vel": torch.empty(rows, 3, device=self.device),
                "alive": torch.empty(rows, device=self.device),
                "press": torch.empty(rows, device=self.device)}

    def snapshot(self, slabs, buf):
        """Copy the stores of `slabs` into `buf`, allocating nothing."""
        for k, v in self.read(slabs).items():
            buf[k].copy_(v)
        return buf

    @staticmethod
    def read(slabs) -> Dict[str, torch.Tensor]:
        """The stores of a SlabState or a snapshot."""
        if isinstance(slabs, dict):
            return slabs
        return {"pos": slabs.pos, "vel": slabs.vel, "alive": slabs.alive,
                "press": (slabs.pressure if slabs.pressure is not None
                          else torch.zeros_like(slabs.alive))}

    def check(self, caps: List[drive.Capture],
              control: bool = False) -> Dict[str, float]:
        """The start's distribution against this benchmark's own, then
        each captured step against the reference from the stores before it:
        the step of every live particle, then where the migration puts it;
        and the guarantees: every particle alive, none dropped, no cell
        overflow, finite, inside the box. `control`: the reference in
        bfloat16, migrated, stands in the program's place."""
        want0 = ref_slabs.distribute(self.particles, self.lay)
        if self.starts:
            got0 = self.read(self.starts[0])
            self.start_mismatch = float(
                (got0["alive"] != want0["alive"]).sum()
                + ((got0["pos"] != want0["pos"]).any(-1)
                   & (want0["alive"] > 0)).sum()
                + ((got0["vel"] != want0["vel"]).any(-1)
                   & (want0["alive"] > 0)).sum())
            del got0
            self.release()
        res: Dict[str, float] = {"start_mismatch": self.start_mismatch}
        for cap in caps:
            before = want0 if cap.before is None else self.read(cap.before)
            after = self.read(cap.after)
            rows = torch.nonzero(before["alive"] > 0)[:, 0]
            slab = torch.div(rows, self.lay["capacity"],
                             rounding_mode="floor")
            live = {k: before[k][rows] for k in ("pos", "vel", "press")}
            ijk = ref_slabs.slab_cells(live["pos"], slab, self.lay)
            want = self.reference(live, ijk, self.lay["dims"])
            exp, lost = self.migrated(before, want)
            if control:
                after = self.migrated(before,
                                      self.low(live, ijk, self.lay["dims"]))[0]
            res["alive_mismatch"] = max(res.get("alive_mismatch", 0.0), float(
                (after["alive"] != exp["alive"]).sum()))
            keep = (exp["alive"] > 0) & (after["alive"] > 0)
            got = {k: after[k][keep] for k in ("pos", "vel", "press")}
            stepped = sph.Step(pos=exp["pos"][keep], vel=exp["vel"][keep],
                               press=exp["press"][keep], iters=want.iters,
                               max_count=want.max_count,
                               pos_alt=exp["pos_alt"][keep],
                               vel_alt=exp["vel_alt"][keep])
            nums = drive.compare_step(got, stepped, self.prm, True)
            for k, v in nums.items():
                res[k] = max(res.get(k, 0.0), v)
            res["lost"] = max(res.get("lost", 0.0), float(lost))
            res["cell_overflow"] = max(res.get("cell_overflow", 0.0), float(
                max(want.max_count - int(self.cfg["cells"]["capacity"]), 0)))
            live_after = after["pos"][after["alive"] > 0]
            res["outside_box"] = max(res.get("outside_box", 0.0),
                                     drive.outside(live_after, self.box))
            res["not_finite"] = max(res.get("not_finite", 0.0), float(
                (~torch.isfinite(live_after)).sum()))
        res["segment_guard"] = float(max((float(g) for g in self.guards),
                                         default=0.0))
        return res
