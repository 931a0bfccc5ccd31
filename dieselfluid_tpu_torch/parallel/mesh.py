"""Device meshes for the sharded steps: what `jax.make_mesh`, `shard_map`
and the `lax` collectives give the JAX package's parallel/.

A step is written once, over the shards this process holds. Every per-shard
value is a list with one entry per held shard, in mesh order (x-major, then
y), and the collectives map such lists to lists:

  * `axis_index(axis)`: each held shard's coordinate along `axis`;
  * `ppermute(xs, axis, shift)`: each shard receives the value of the shard
    `shift` places before it along `axis` (shift = +1: data flows to the
    next shard), without wrap; a shard that nobody addresses gets zeros,
    as `lax.ppermute` leaves it;
  * `psum`, `pmax` over the whole mesh, `all_gather(xs, axis)` tiled along
    dim 0 (1-D meshes, the only ones that gather), and `stack` (every shard's value in one tensor of the mesh's
    shape, as a per-shard out_spec stacks it);
  * `ct_sync(xs, exchange)`: identity forward, `exchange` of the cotangents
    backward (JAX's custom_vjp `_ghost_ct_sync`).

Two implementations:
  * `LocalMesh(shape, device)`: every shard in this process, each shard's
    tensors on `device`. The collectives are tensor references, copies and
    reductions over the list, so autograd flows through them as through any
    op, and a replicated input that every shard reads (the Materials) gets
    its gradients summed by autograd: shard_map's transpose psum. One card
    runs every shard this way (NCCL takes one rank per card).
  * `DistMesh(shape)`: one shard per rank of an initialised
    torch.distributed group (gloo on the CPU, nccl with one card per rank).
    The collectives are `batch_isend_irecv` and `all_reduce`; those on a
    differentiated path are autograd Functions whose backward is their
    transpose (ppermute's is the reverse ppermute, all_gather's the sum of
    every rank's slice), and `sync_grads` all-reduces a replicated input's
    gradients.

Process-local tensors hold the held shards' rows concatenated along dim 0
(`split` and `join`): a LocalMesh's are the JAX package's global arrays.
"""

from __future__ import annotations

import math
import socket
from typing import Callable, List, Optional, Sequence, Tuple

import torch

AXIS = "sp"
AXIS_Y = "spy"


def _names_for(shape) -> Tuple[str, ...]:
    return (AXIS,) if len(shape) == 1 else (AXIS, AXIS_Y)


def default_device() -> torch.device:
    """The CUDA card; raises where there is none (no fallback)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "false): pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


class _Mesh:
    """What both meshes share: the shape, shard coordinates, split/join."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    shards: List[int]           # global shard ids held, ascending
    device: torch.device

    def _init_shape(self, shape, axis_names):
        self.shape = tuple(int(s) for s in shape)
        if len(self.shape) not in (1, 2):
            raise ValueError(f"a mesh has 1 or 2 axes, got {self.shape}")
        self.axis_names = tuple(axis_names or _names_for(self.shape))
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axis names {self.axis_names} for shape "
                             f"{self.shape}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def _axis(self, axis: str) -> int:
        return self.axis_names.index(axis)

    def axis_size(self, axis: str) -> int:
        return self.shape[self._axis(axis)]

    def coords(self, shard: int) -> Tuple[int, ...]:
        if len(self.shape) == 1:
            return (shard,)
        return divmod(shard, self.shape[1])

    def shard_at(self, coords) -> int:
        if len(self.shape) == 1:
            return coords[0]
        return coords[0] * self.shape[1] + coords[1]

    def axis_index(self, axis: str) -> List[int]:
        a = self._axis(axis)
        return [self.coords(s)[a] for s in self.shards]

    def _source(self, shard: int, axis: str, shift: int) -> Optional[int]:
        """The shard whose value `shard` receives in a ppermute, or None."""
        a = self._axis(axis)
        c = list(self.coords(shard))
        c[a] -= shift
        if 0 <= c[a] < self.shape[a]:
            return self.shard_at(c)
        return None

    def split(self, t: Optional[torch.Tensor]) -> List[Optional[torch.Tensor]]:
        """A process-local tensor's rows, one block per held shard."""
        if t is None:
            return [None] * len(self.shards)
        return list(torch.chunk(t, len(self.shards), dim=0))

    def join(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return xs[0] if len(xs) == 1 else torch.cat(list(xs), dim=0)

    def ct_sync(self, xs: List[torch.Tensor],
                exchange: Callable[[List[torch.Tensor]], List[torch.Tensor]]
                ) -> List[torch.Tensor]:
        """Identity forward; backward, the cotangents through `exchange`.
        Nothing is recorded where no input requires a gradient."""
        if not (torch.is_grad_enabled() and any(x.requires_grad for x in xs)):
            return xs
        return list(_CtSync.apply(exchange, *xs))


class _CtSync(torch.autograd.Function):
    @staticmethod
    def forward(ctx, exchange, *xs):
        ctx.exchange = exchange
        ctx.set_materialize_grads(True)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *cts):
        return (None,) + tuple(ctx.exchange([c.contiguous() for c in cts]))


class LocalMesh(_Mesh):
    """Every shard of `shape` in this process, on `device` (default: the
    CUDA card, which must exist)."""

    def __init__(self, shape, device=None, axis_names=None):
        self._init_shape(shape, axis_names)
        self.device = (default_device() if device is None
                       else torch.device(device))
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LocalMesh on cuda: no CUDA device")
        self.shards = list(range(self.size))

    def ppermute(self, xs: List[torch.Tensor], axis: str, shift: int
                 ) -> List[torch.Tensor]:
        out = []
        for i, s in enumerate(self.shards):
            src = self._source(s, axis, shift)
            out.append(torch.zeros_like(xs[i]) if src is None else xs[src])
        return out

    def psum(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        total = xs[0]
        for x in xs[1:]:
            total = total + x
        return [total] * len(xs)

    def pmax(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        m = xs[0]
        for x in xs[1:]:
            m = torch.maximum(m, x)
        return [m] * len(xs)

    def all_gather(self, xs: List[torch.Tensor], axis: str = AXIS
                   ) -> List[torch.Tensor]:
        if len(self.shape) != 1:
            raise NotImplementedError("all_gather: 1-D meshes")
        return [torch.cat(list(xs), dim=0)] * len(xs)

    def stack(self, xs: List[torch.Tensor]) -> torch.Tensor:
        return torch.stack(list(xs)).reshape(self.shape + xs[0].shape)

    def sync_grads(self, tensors):
        """Nothing to do: autograd already summed every shard's share."""


class DistMesh(_Mesh):
    """One shard per rank of the initialised torch.distributed group,
    laid out x-major. `device`: the rank's card for nccl (default
    cuda:rank), the CPU for gloo. nccl with two ranks on one card raises."""

    def __init__(self, shape, device=None, axis_names=None):
        import torch.distributed as dist

        self._init_shape(shape, axis_names)
        if not dist.is_initialized():
            raise RuntimeError("DistMesh needs torch.distributed."
                               "init_process_group first")
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks, "
                             f"the group has {world}")
        self.rank = dist.get_rank()
        self.shards = [self.rank]
        self.backend = dist.get_backend()
        if self.backend == "nccl":
            self.device = torch.device(
                "cuda", self.rank if device is None
                else torch.device(device).index)
            torch.cuda.set_device(self.device)
            where = [None] * world
            dist.all_gather_object(where, (socket.gethostname(),
                                           self.device.index))
            if len(set(where)) != world:
                raise RuntimeError(f"nccl needs one card per rank, got "
                                   f"{where}: run the shards of one card "
                                   "in a LocalMesh")
        else:
            self.device = torch.device("cpu" if device is None else device)

    def _raw_ppermute(self, x: torch.Tensor, axis: str, shift: int
                      ) -> torch.Tensor:
        import torch.distributed as dist

        x = x.contiguous()
        src = self._source(self.rank, axis, shift)
        dst = self._source(self.rank, axis, -shift)
        ops, buf = [], None
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, x, dst))
        if src is not None:
            buf = torch.empty_like(x)
            ops.append(dist.P2POp(dist.irecv, buf, src))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return torch.zeros_like(x) if buf is None else buf

    def ppermute(self, xs, axis, shift):
        return [_PPermute.apply(self, axis, shift, xs[0])]

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        import torch.distributed as dist

        y = x.detach().clone()
        dist.all_reduce(y, op=op)
        return y

    def psum(self, xs):
        return [_PSum.apply(self, xs[0])]

    def pmax(self, xs):
        import torch.distributed as dist

        return [self._all_reduce(xs[0], dist.ReduceOp.MAX)]

    def _raw_all_gather(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts, dim=0)

    def all_gather(self, xs, axis=AXIS):
        if len(self.shape) != 1:
            raise NotImplementedError("DistMesh.all_gather: 1-D meshes")
        return [_AllGather.apply(self, xs[0])]

    def stack(self, xs):
        import torch.distributed as dist

        parts = [torch.empty_like(xs[0]) for _ in range(self.size)]
        dist.all_gather(parts, xs[0].detach().contiguous())
        return torch.stack(parts).reshape(self.shape + xs[0].shape)

    def sync_grads(self, tensors):
        """All-reduce the gradients of a replicated input: each rank holds
        only its own shard's share."""
        import torch.distributed as dist

        for t in tensors:
            if t is not None:
                dist.all_reduce(t)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, shift, x):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return mesh._raw_ppermute(x, axis, shift)

    @staticmethod
    def backward(ctx, ct):
        return None, None, None, ctx.mesh._raw_ppermute(ct, ctx.axis,
                                                        -ctx.shift)


class _PSum(torch.autograd.Function):
    """The replicated sum; its transpose hands each rank's cotangent to
    its own term (every rank differentiates the same replicated value)."""

    @staticmethod
    def forward(ctx, mesh, x):
        import torch.distributed as dist

        return mesh._all_reduce(x, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, ct):
        return None, ct


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh, ctx.n = mesh, x.shape[0]
        return mesh._raw_all_gather(x)

    @staticmethod
    def backward(ctx, ct):
        import torch.distributed as dist

        mesh, n = ctx.mesh, ctx.n
        total = mesh._all_reduce(ct, dist.ReduceOp.SUM)
        return None, total[mesh.rank * n:(mesh.rank + 1) * n]
