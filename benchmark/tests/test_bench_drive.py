"""The general generator on the CPU at a tiny lattice: the starts drawn
from the seed (the first one the check follows is the seed's own), and the
warm-up of the resident layout through its first rebuild."""

import torch

import drive
import harness
import sph
from conftest import tiny

CPU = torch.device("cpu")


def test_starts_from_the_seed():
    loaded = tiny("dam1m.wcsph", n3=8)
    seed = 2 ** 31 + 3
    drv = drive.make(loaded["config"], loaded["mix"], seed, CPU)
    drive.set_up(drv)
    assert len(drv.starts) == int(loaded["mix"]["starts"]) > 1
    own = sph.dam_break(loaded["config"], seed, CPU)
    assert torch.equal(drv.particles["pos"], own["pos"])
    x = [s.planes["x"] for s in drv.starts]
    assert torch.equal(x[0], drv.own.planes["x"])
    assert x[0] is not drv.own.planes["x"]
    assert not any(torch.equal(x[0], o) for o in x[1:])


def test_warm_up_reaches_the_first_rebuild():
    loaded = tiny("dam1m.wcsph", n3=8, steps=60)
    loaded["mix"]["warmup_steps"] = 1
    drv = drive.make(loaded["config"], loaded["mix"], 11, CPU)
    drive.set_up(drv)
    k = harness.warm_up(drv, loaded["mix"])
    assert drv.own is None and 1 <= k < 60
    st = drv.copy_start()
    for j in range(1, k + 1):
        st = drv.step(st)
        assert (int(st.rebuilds) > 0) == (j == k), (j, k)
