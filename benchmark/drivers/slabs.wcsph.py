"""WCSPH on the slab layout: parallel.dense_halo.make_dense_halo_wcsph_step
on the layout's mesh, called once per step."""

from layouts.slabs import Layout


class Driver(Layout):
    def make_step(self):
        return self._dh.make_dense_halo_wcsph_step(
            self.mesh, self.spec, self.params)
