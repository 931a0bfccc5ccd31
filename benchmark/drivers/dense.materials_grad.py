"""Configuration 4's training step on the dense layout: one call of
solvers.materials_grad's step per step, from the next start in turn,
replayed as a CUDA graph (`MaterialsGradGraph`: captured at the first
step, in the warm-up; the step itself while the traced segment's profiler
runs); the check follows the loss, the gradients and the tile overflow."""

from layouts.dense import Layout


class Driver(Layout):
    def __init__(self, cfg, mix, seed, device):
        super().__init__(cfg, mix, seed, device)
        self.graph = self._mg.MaterialsGradGraph(
            self.params, self.spec, self.delta, self.mats, self.cam,
            self.cube, self.frame.radius, width=self.frame.width,
            height=self.frame.height, k=self.frame.k,
            unroll_iters=self.unroll, bounds=self.box)

    def grad(self, start):
        return self.graph(start)

    def release(self):
        """Also drop the graph and the memory it holds."""
        self.graph = None
        super().release()
