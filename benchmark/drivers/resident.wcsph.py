"""WCSPH on the plane-resident layout: one call of
solvers.dense_resident.dense_wcsph_resident_step per step."""

from layouts.resident import Layout


class Driver(Layout):
    def step(self, ps):
        return self._dr.dense_wcsph_resident_step(
            ps, self.params, self.spec, skin=self.skin, bounds=self.box,
            **self.wall)
