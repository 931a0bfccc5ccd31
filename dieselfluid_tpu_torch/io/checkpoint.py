"""Simulation checkpoint and resume (counterpart of
dieselfluid_tpu/io/checkpoint.py).

A checkpoint is a directory: `state.pt`, the FluidState's tensors copied to
the host and written with `torch.save`, and `meta.json`, the JAX package's
schema (step, params, config, has_boundary). The port does not read the JAX
package's orbax checkpoints (their `state/` directory), nor does the JAX
package read these. A slab checkpoint (`save_slab_checkpoint`) holds a
sharded SlabState (parallel/halo.py) gathered into every shard's store,
`slabs.pt` beside `meta.json` with `"kind": "slab"`; it loads onto any mesh
of the same shard count.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Optional, Tuple

import torch

from dieselfluid_tpu_torch.config import FluidParams, SimConfig
from dieselfluid_tpu_torch.models.particles import FluidState

STATE_FILE = "state.pt"
SLAB_FILE = "slabs.pt"


def save_checkpoint(path: str, state: FluidState, step: int,
                    params: Optional[FluidParams] = None,
                    config: Optional[SimConfig] = None):
    """Write state + metadata to the directory `path` (replaced if it
    exists)."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    tensors = {k: v.detach().cpu() for k, v in state._asdict().items()
               if v is not None}
    torch.save(tensors, os.path.join(path, STATE_FILE))
    meta = {
        "step": int(step),
        "params": dataclasses.asdict(params) if params else None,
        "config": dataclasses.asdict(config) if config else None,
        "has_boundary": state.boundary_pos is not None,
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)


def load_checkpoint(path: str, device
                    ) -> Tuple[FluidState, int, Optional[FluidParams],
                               Optional[SimConfig]]:
    """Restore (state on `device`, step, params, config) from a checkpoint
    directory written by save_checkpoint."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    tensors = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                         weights_only=True)
    t = {k: v.to(device) for k, v in tensors.items()}
    state = FluidState(pos=t["pos"], vel=t["vel"], force=t["force"],
                       density=t["density"], pressure=t["pressure"],
                       boundary_pos=t.get("boundary_pos"))
    params = _params_from(meta)
    config = SimConfig(**meta["config"]) if meta.get("config") else None
    return state, meta["step"], params, config


def _params_from(meta) -> Optional[FluidParams]:
    if not meta.get("params"):
        return None
    return FluidParams(**{**meta["params"],
                          "gravity": tuple(meta["params"]["gravity"])})


def save_slab_checkpoint(path: str, slabs, step: int,
                         params: Optional[FluidParams] = None, mesh=None,
                         replicated_boundary: bool = False):
    """Checkpoint a sharded SlabState. With `mesh` the process's slabs are
    gathered first (a DistMesh's from every rank; its rank 0 writes);
    without it `slabs` holds every shard's store, as a LocalMesh's does.
    `replicated_boundary`: the 2-D mesh's whole boundary set."""
    from dieselfluid_tpu_torch.parallel.halo import global_slabs

    if mesh is not None:
        slabs = global_slabs(mesh, slabs, replicated_boundary)
        if mesh.shards[0] != 0:
            return
    path = os.path.abspath(path)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    tensors = {k: v.detach().cpu() for k, v in slabs._asdict().items()
               if v is not None}
    torch.save(tensors, os.path.join(path, SLAB_FILE))
    meta = {
        "step": int(step),
        "params": dataclasses.asdict(params) if params else None,
        "kind": "slab",
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)


def load_slab_checkpoint(path: str, device=None, mesh=None,
                         replicated_boundary: bool = False):
    """Restore (SlabState, step, params) saved by save_slab_checkpoint:
    every shard's store on `device`, or with `mesh` the process's part on
    the mesh's device (any mesh of the saved shard count)."""
    from dieselfluid_tpu_torch.parallel.halo import SlabState, local_slabs

    if device is None and mesh is None:
        raise ValueError("load_slab_checkpoint needs a device or a mesh")
    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("kind") != "slab":
        raise ValueError(f"{path} is not a slab checkpoint")
    t = torch.load(os.path.join(path, SLAB_FILE), map_location="cpu",
                   weights_only=True)
    slabs = SlabState(**t)
    if mesh is not None:
        slabs = local_slabs(mesh, slabs, replicated_boundary)
    else:
        slabs = SlabState(*[None if v is None else v.to(device)
                            for v in slabs])
    return slabs, meta["step"], _params_from(meta)


class Checkpointer:
    """Rolling checkpoint manager: keeps the latest `keep` checkpoints,
    `step_<9 digits>/` under `root`."""

    def __init__(self, root: str, keep: int = 3, interval: int = 100):
        self.root = os.path.abspath(root)
        self.keep = keep
        self.interval = interval
        os.makedirs(self.root, exist_ok=True)

    def maybe_save(self, state: FluidState, step: int,
                   params: Optional[FluidParams] = None,
                   config: Optional[SimConfig] = None) -> bool:
        if step % self.interval != 0:
            return False
        return self.save(state, step, params, config)

    def save(self, state: FluidState, step: int,
             params: Optional[FluidParams] = None,
             config: Optional[SimConfig] = None) -> bool:
        """Unconditional save (callers that step in chunks, utils.guard,
        cannot rely on landing on interval multiples)."""
        save_checkpoint(os.path.join(self.root, f"step_{step:09d}"), state,
                        step, params, config)
        self._prune()
        return True

    def _steps(self):
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.root)
                      if name.startswith("step_"))

    def _prune(self):
        steps = self._steps()
        for s in steps[:max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:09d}"))

    def latest(self, device):
        """The newest checkpoint loaded onto `device`, or None."""
        steps = self._steps()
        if not steps:
            return None
        return load_checkpoint(os.path.join(self.root,
                                            f"step_{steps[-1]:09d}"), device)
