"""Plain reference of the slab decomposition: which cell a stored particle
bins into, and where each particle lives after a step.

The configuration splits x into `n_dev` slabs of `nxd` whole cells from
`lo`; a slab's origin is width * slab + lo in float32. Each slab stores up to
`capacity` particles. A particle is binned in its own slab's frame (x taken
from the slab's origin, cells clamped to the slab's columns). After a step,
every slab keeps, in order: the particles that stayed in its x-range, in
their stored order; then the particles that crossed into it from the slab
below (those that left that slab upward, in their stored order, at most
`migrate` of them), then those from the slab above (likewise). The rest of
the store is dead. Crossing out of the first slab downward or the last
upward is not possible: the box holds the particles. Plain PyTorch.
"""

from __future__ import annotations

from typing import Dict

import torch

from sph import cell_coords


def origins(n_dev: int, width: float, lo: float, device) -> torch.Tensor:
    w = torch.tensor(width, dtype=torch.float32, device=device)
    return torch.stack([w * d + lo for d in range(n_dev)])


def distribute(particles: Dict[str, torch.Tensor], lay: dict):
    """The slabs' stores at the start: each particle in the slab its x
    falls in ((x - lo) / width in float32, truncated, clamped to the
    slabs), in particle order, up to the capacity (the rest dropped)."""
    pos = particles["pos"]
    dev = pos.device
    n_dev, cap = lay["n_dev"], lay["capacity"]
    t = ((pos[:, 0] - torch.tensor(lay["lo"], dtype=torch.float32,
                                   device=dev))
         / torch.tensor(lay["width"], dtype=torch.float32, device=dev))
    slab = torch.trunc(t).to(torch.int64).clamp(0, n_dev - 1)
    out = {"pos": torch.zeros(n_dev * cap, 3, device=dev),
           "vel": torch.zeros(n_dev * cap, 3, device=dev),
           "press": torch.zeros(n_dev * cap, device=dev),
           "alive": torch.zeros(n_dev * cap, device=dev)}
    for d in range(n_dev):
        rows = torch.nonzero(slab == d)[:, 0][:cap]
        for k in ("pos", "vel", "press"):
            out[k][d * cap:d * cap + len(rows)] = particles[k][rows]
        out["alive"][d * cap:d * cap + len(rows)] = 1.0
    return out


def slab_cells(pos: torch.Tensor, slab: torch.Tensor, lay: dict):
    """Global cell coordinates of stored particles, binned in their slab's
    frame: x cells from the slab's origin, clamped to its nxd columns."""
    dev = pos.device
    x0 = origins(lay["n_dev"], lay["width"], lay["lo"], dev)[slab]
    local = torch.cat([(pos[:, :1] - x0[:, None]), pos[:, 1:]], dim=1)
    ijk = cell_coords(local, (0.0, lay["lo"], lay["lo"]), lay["cell"],
                      (lay["nxd"],) + tuple(lay["dims"][1:]))
    ijk[:, 0] += slab * lay["nxd"]
    return ijk


def migrate(stores: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
            lay: dict) -> Dict[str, torch.Tensor]:
    """The stores after a step: `stores` the slabs' stores before it (pos,
    vel, press, alive; n_dev * capacity rows), `new` the live rows' new
    pos, vel and press in store order. Returns the expected stores (dead
    rows zero) and the number of particles lost."""
    n_dev, cap, mc = lay["n_dev"], lay["capacity"], lay["migrate"]
    dev = stores["pos"].device
    live_rows = torch.nonzero(stores["alive"] > 0)[:, 0]
    slab = torch.div(live_rows, cap, rounding_mode="floor")
    x0 = origins(n_dev, lay["width"], lay["lo"], dev)
    x1 = x0 + torch.tensor(lay["width"], dtype=torch.float32, device=dev)
    x = new["pos"][:, 0]
    down = (x < x0[slab]) & (slab > 0)
    up = (x >= x1[slab]) & (slab < n_dev - 1)
    out = {k: torch.zeros((n_dev * cap,) + new[k].shape[1:],
                          dtype=new[k].dtype, device=dev) for k in new}
    out["alive"] = torch.zeros(n_dev * cap, dtype=torch.float32, device=dev)
    lost = 0
    for d in range(n_dev):
        stay = torch.nonzero((slab == d) & ~down & ~up)[:, 0]
        from_below = torch.nonzero((slab == d - 1) & up)[:, 0]
        from_above = torch.nonzero((slab == d + 1) & down)[:, 0]
        lost += max(0, len(from_below) - mc) + max(0, len(from_above) - mc)
        rows = torch.cat([stay, from_below[:mc], from_above[:mc]])
        lost += max(0, len(rows) - cap)
        rows = rows[:cap]
        for k in new:
            out[k][d * cap:d * cap + len(rows)] = new[k][rows]
        out["alive"][d * cap:d * cap + len(rows)] = 1.0
    return out, lost
