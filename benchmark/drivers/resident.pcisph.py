"""PCISPH on the plane-resident layout: one call of
solvers.dense_resident.dense_pcisph_resident_step per step; the check holds
the returned iteration count to the reference's, and the pressures too
where the mix warm-starts them."""

from layouts.resident import Layout


class Driver(Layout):
    counts_iters = True

    @property
    def compares_press(self):
        return self.warm

    def step(self, ps):
        ps, it = self._dr.dense_pcisph_resident_step(
            ps, self.params, self.spec, self.delta, skin=self.skin,
            bounds=self.box, warm_start=self.warm, **self.wall)
        self.iters.append(it)
        return ps
