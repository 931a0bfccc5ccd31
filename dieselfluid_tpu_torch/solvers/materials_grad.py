"""Configuration 4's training step: the gradient of a rendered frame's loss
to the fluid's material parameters and to its pre-step positions.

Counterpart of the JAX bench's configuration 4 (`bench.py:386-457`,
`bench_pcisph_materials_grad_1m`): one PCISPH step of the dense pipeline
unrolled to a fixed number of correction iterations so that reverse mode
passes through it, the sky-lit tiled splat render of the next positions,
the loss sum(color^2), and its gradients to the traced `Materials` (mu, d0,
mass) and to the positions before the step.

`materials_grad_step` is the step; `config4_scene` makes the render's
camera and sky cube, once per configuration. The step reads nothing back
to the host: the loss, the four gradients and the render's tile overflow
come back as device tensors, so a loop of steps queues ahead of the card.
Its constants are device constants (utils/constants.py) and the render's
scalar bounds are fills on the card, so a step makes no host sync once the
first has run. `MaterialsGradGraph` replays the step as one CUDA graph, so
that the host's ~1,500 launches and ~7,000 operators a step leave the
loop: the card alone paces it.

Spans (utils/profiling.py): `materials_grad.forward` (the unrolled step),
`materials_grad.render` (the render and the loss) and
`materials_grad.backward` (the gradients); counter `materials_grad.steps`,
one a call. On a CUDA loss the autograd engine runs the backward on its
own device thread, so `materials_grad.backward` is also entered there,
from the graph's first node to its last gradient, so that the trace holds
the backward's device work under that name (a CPU loss's backward runs on
the calling thread, inside the span).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.models.particles import FluidState
from dieselfluid_tpu_torch.ops.cellops import DenseCellSpec
from dieselfluid_tpu_torch.render.camera import Camera
from dieselfluid_tpu_torch.render.splat_tiled import splat_particles_tiled
from dieselfluid_tpu_torch.solvers.dense_step import _BOX, dense_pcisph_step
from dieselfluid_tpu_torch.utils.profiling import _tracing, count, span


class MaterialsGrad(NamedTuple):
    """One step's results, each a device tensor: the loss, its gradients
    to mu, d0 and mass (0-d) and to the pre-step positions (N, 3), and the
    render's tile overflow (entries dropped past a tile's capacity, 0-d
    int64)."""

    loss: torch.Tensor
    grad_mu: torch.Tensor
    grad_d0: torch.Tensor
    grad_mass: torch.Tensor
    grad_pos: torch.Tensor
    overflow: torch.Tensor


def config4_scene(device, *, position, front, fov_deg: float, width: int,
                  height: int, sun, cube_size: int
                  ) -> Tuple[Camera, torch.Tensor]:
    """(camera, sky cube) of configuration 4's render on `device`: the
    camera at `position` looking along `front` at the frame's aspect, and
    the baked sky cube (bake_sky_cubemap(sun, cube_size)). Made once per
    configuration; each makes host copies."""
    from dieselfluid_tpu_torch.sky.bake import bake_sky_cubemap

    cam = Camera.at(position, front=front, fov_deg=fov_deg,
                    aspect=float(width) / float(height), device=device)
    return cam, bake_sky_cubemap(sun, cube_size, device=device)


class _EngineRange:
    """The range `name` on the autograd engine's thread: entered by a
    pre-hook on the loss's node (the graph's first), left by a hook that
    fires once every input's gradient is made (its last). Left on the
    calling thread after the backward if that hook never fired."""

    def __init__(self, name: str, loss: torch.Tensor, inputs):
        self.name, self.rf, self.left = name, None, len(inputs)
        self.handles = [loss.grad_fn.register_prehook(self._enter)]
        self.handles += [t.register_hook(self._made) for t in inputs]

    def _enter(self, grad_outputs):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()

    def _made(self, grad):
        self.left -= 1
        if self.left == 0:
            self._leave()

    def _leave(self):
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None

    def close(self):
        self._leave()
        for h in self.handles:
            h.remove()


def _grad(loss: torch.Tensor, inputs):
    """torch.autograd.grad(loss, inputs) under `materials_grad.backward`,
    on the calling thread and, while tracing, on the engine's."""
    with span("materials_grad.backward"):
        if not _tracing() or loss.device.type != "cuda":
            return torch.autograd.grad(loss, inputs)
        rng = _EngineRange("materials_grad.backward", loss, inputs)
        try:
            return torch.autograd.grad(loss, inputs)
        finally:
            rng.close()


def materials_grad_step(state: FluidState, params: FluidParams,
                        spec: DenseCellSpec, delta: float, materials,
                        cam: Camera, env_cube: torch.Tensor, radius, *,
                        width: int, height: int, k: int, unroll_iters: int,
                        bounds: Optional[Tuple] = _BOX) -> MaterialsGrad:
    """One training step of configuration 4 from `state`: the PCISPH step
    with `materials` (Materials whose mu, d0 and mass require grad),
    unrolled to `unroll_iters` correction iterations; the tiled splat of
    the next positions at `radius`, lit by `env_cube` through `cam`,
    `width` x `height` at `k` entries a tile; loss = sum(color^2); its
    gradients to mu, d0, mass and state.pos. Reads nothing back to the
    host."""
    count("materials_grad.steps")
    pos = state.pos.detach().requires_grad_()
    with span("materials_grad.forward"):
        nxt, _ = dense_pcisph_step(state._replace(pos=pos), params, spec,
                                   delta, bounds=bounds, materials=materials,
                                   unroll_for_grad=True,
                                   unroll_iters=unroll_iters)
    with span("materials_grad.render"):
        img, overflow = splat_particles_tiled(
            nxt.pos, radius, cam, width=width, height=height, k=k,
            return_overflow=True, env_cube=env_cube)
        loss = (img.color ** 2).sum()
    g_mu, g_d0, g_mass, g_pos = _grad(
        loss, [materials.mu, materials.d0, materials.mass, pos])
    return MaterialsGrad(loss.detach(), g_mu, g_d0, g_mass, g_pos, overflow)


class MaterialsGradGraph:
    """`materials_grad_step` with every argument but the state fixed,
    captured on its first CUDA call as one CUDA graph and replayed: a call
    copies its state into the graph's input and launches the graph. The
    results are the graph's own output tensors, overwritten by the next
    call; the materials are read in place, so a change of their values
    shows in the next call. The step's shapes are the first state's. On
    the CPU, and while a profiler runs (so that the spans hold their
    kernels), a call runs the step itself."""

    def __init__(self, params: FluidParams, spec: DenseCellSpec,
                 delta: float, materials, cam: Camera,
                 env_cube: torch.Tensor, radius, *, width: int, height: int,
                 k: int, unroll_iters: int,
                 bounds: Optional[Tuple] = _BOX):
        self.args = (params, spec, delta, materials, cam, env_cube, radius)
        self.kw = dict(width=width, height=height, k=k,
                       unroll_iters=unroll_iters, bounds=bounds)
        self.graph = None
        self.input: Optional[FluidState] = None
        self.out: Optional[MaterialsGrad] = None

    def _step(self, state: FluidState) -> MaterialsGrad:
        return materials_grad_step(state, *self.args, **self.kw)

    def _capture(self, state: FluidState):
        """Two steps on a side stream (the device constants, the
        allocator's blocks), then the capture of one on the graph's input,
        a copy of `state`."""
        self.input = FluidState(*(None if t is None else t.clone()
                                  for t in state))
        side = torch.cuda.Stream(device=state.pos.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                self._step(self.input)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = self._step(self.input)

    def __call__(self, state: FluidState) -> MaterialsGrad:
        if state.pos.device.type != "cuda" or _tracing():
            return self._step(state)
        if self.graph is None:
            self._capture(state)
        for dst, src in zip(self.input, state):
            if dst is not None:
                dst.copy_(src)
        self.graph.replay()
        return self.out
