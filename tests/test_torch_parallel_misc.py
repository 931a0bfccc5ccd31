"""The rest of the port's parallel/: the SPMD training step
(parallel/sharding.py + spmd.py) and the tile-sharded render
(parallel/render_shard.py) against the JAX package's on the same numpy
inputs; GuardedSlabRunner (utils/guard.py) and the slab checkpoint
(io/checkpoint.py) as tests/test_guard.py:118-200 holds the JAX ones; the
distributed_slab example twin on the CPU.

JAX runs on its virtual CPU mesh (4 devices for the training step, 8 row
tiles for the render, as its own tests); the port on LocalMeshes of the
same shapes on the CPU. Tolerances are relative to each quantity's largest
magnitude, about 10x the drift measured here (stated beside each).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.io.checkpoint import (
    Checkpointer,
    load_slab_checkpoint,
    save_slab_checkpoint,
)
from dieselfluid_tpu_torch.models.materials import Materials
from dieselfluid_tpu_torch.models.particles import dam_break_state
from dieselfluid_tpu_torch.neighbors.calibrate import calibrate_rest_density
from dieselfluid_tpu_torch.parallel.halo import (
    SlabSpec,
    distribute,
    make_halo_step,
)
from dieselfluid_tpu_torch.parallel.mesh import LocalMesh
from dieselfluid_tpu_torch.utils.guard import (
    GuardedSlabRunner,
    SimulationDiverged,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
FIELDS = ("mu", "d0", "tait_gamma", "tait_w", "mass")
# Measured: the loss, the updated vel0 and Materials all 0 (relative to
# each; the updates are lr = 1e-3 times the gradients).
TRAIN_REL_TOL = 2e-6
# Measured: the rollout's gradients, vel0 1.2e-7, mu 1.3e-6, d0 7.3e-8,
# tait_gamma 3.7e-5, tait_w 2.0e-6 (mass: 0 in both, it is params.mass).
GRAD_REL_TOL = 4e-4
# Measured: color 1.03e-5, alpha 1.05e-5, the position gradient 6.8e-5 (of
# each one's largest). JAX's shard_map'd render is compiled (XLA contracts
# FMAs): it is 1.2e-5 off JAX's own eager splat of this scene, as the port's
# eager splat is; the port's tiles equal its one-device image bit for bit.
RENDER_REL_TOL = {"color": 1e-4, "alpha": 1e-4, "grad": 7e-4}


def _rel(a, b):
    a = np.asarray(a.detach() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_sharded_train_step_equals_jax():
    """The JAX dryrun's training step (n3 = 8, d0 calibrated, 2 sim steps,
    k = 32) on 4 shards: the same loss and SGD updates."""
    from dieselfluid_tpu.config import FluidParams as JParams
    from dieselfluid_tpu.models.materials import Materials as JMaterials
    from dieselfluid_tpu.models.particles import dam_break_state as jdam
    from dieselfluid_tpu.neighbors.calibrate import (
        calibrate_rest_density as jcal)
    from dieselfluid_tpu.parallel import sharding as js

    from dieselfluid_tpu_torch.parallel import sharding as ts

    n3, extent = 8, 0.5
    params = JParams.for_spacing((2.0 / n3) * extent)
    state = jdam(n3, params, extent=extent)
    params = jcal(state.pos, params)
    rng = np.random.default_rng(5)
    vel = (rng.normal(size=state.vel.shape) * 0.1).astype(np.float32)
    state = state._replace(vel=jnp.asarray(vel))
    mesh = js.particle_mesh(4)
    jstep = js.sharded_train_step(mesh, params, n_sim_steps=2, neighbor_k=32)
    sstate = js.shard_state(state, mesh)
    jm = JMaterials.from_params(params)
    jloss, jvel, jmats = jax.block_until_ready(
        jstep(sstate.vel, jm, sstate))

    tparams = interop.fluid_params_from(params)
    tmesh = ts.particle_mesh(4, CPU)
    tstate = ts.shard_state(interop.fluid_state_from_numpy(
        np.asarray(state.pos), vel, np.asarray(state.force),
        np.asarray(state.density), np.asarray(state.pressure), device=CPU),
        tmesh)
    tm = interop.materials_from_numpy(
        *[np.asarray(getattr(jm, f)) for f in FIELDS], device=CPU)
    tloss, tvel, tmats = ts.sharded_train_step(
        tmesh, tparams, n_sim_steps=2, neighbor_k=32)(tstate.vel, tm, tstate)
    assert np.isfinite(float(tloss))
    assert _rel(tloss, jloss) <= TRAIN_REL_TOL
    assert _rel(tvel, jvel) <= TRAIN_REL_TOL
    for f in FIELDS:
        assert _rel(getattr(tmats, f), getattr(jmats, f)) <= TRAIN_REL_TOL, f
    assert ts.state_sharding(tmesh).pos == ("sp", None)

    # The gradients the step takes (lr = 1e-3 hides them in the updates):
    # the same loss through each package's SPMD rollout, differentiated.
    from dieselfluid_tpu.parallel.spmd import make_spmd_rollout as jroll

    from dieselfluid_tpu_torch.parallel.spmd import make_spmd_rollout

    jr = jroll(mesh, params, 2, k=32)

    def jloss(v, m):
        final, _ = jr(sstate._replace(vel=v), m)
        return (jnp.mean((final.pos[:, 1] + 0.9) ** 2)
                + 1e-4 * jnp.mean(final.vel ** 2))

    jg_vel, jg_mat = jax.jit(jax.grad(jloss, argnums=(0, 1)))(sstate.vel,
                                                              jm)
    v = tstate.vel.clone().requires_grad_()
    mats = Materials(*[m.clone().requires_grad_() for m in tm])
    final, _ = make_spmd_rollout(tmesh, tparams, 2, k=32)(
        tstate._replace(vel=v), mats)
    loss = (((final.pos[:, 1] + 0.9) ** 2).mean()
            + 1e-4 * (final.vel ** 2).mean())
    g = torch.autograd.grad(loss, [v, *mats], allow_unused=True)
    assert _rel(g[0], jg_vel) <= GRAD_REL_TOL
    for f, gm in zip(FIELDS, g[1:]):
        want = float(getattr(jg_mat, f))
        got = 0.0 if gm is None else float(gm)
        assert (got == want == 0.0) or _rel(got, want) <= GRAD_REL_TOL, f


W, H, RADIUS = 96, 64, 0.05


@pytest.mark.parametrize("gather_axis", [False, True])
def test_tiled_splat_equals_jax(gather_axis):
    """8 row tiles of a 96x64 frame of 256 seeded particles (JAX's own
    test's scene): the image and the gradient of sum(color^2) to the
    positions; with gather_axis the positions (and colors) are
    particle-sharded and all-gathered in the mesh."""
    from dieselfluid_tpu.parallel.render_shard import make_tiled_splat as jts
    from dieselfluid_tpu.parallel.sharding import particle_mesh as jmesh
    from dieselfluid_tpu.render.camera import Camera as JCamera

    from dieselfluid_tpu_torch.parallel.render_shard import make_tiled_splat
    from dieselfluid_tpu_torch.render.splat import splat_particles

    rng = np.random.default_rng(3)
    pos = rng.uniform(-0.6, 0.6, (256, 3)).astype(np.float32)
    cols = rng.uniform(0.0, 1.0, (256, 3)).astype(np.float32)
    jcam = JCamera.at((0.0, 0.0, -2.5), front=(0.0, 0.0, 1.0), fov_deg=60.0,
                      aspect=W / H)
    jrender = jts(jmesh(8), W, H, 256, gather_axis=gather_axis)
    colors = cols if gather_axis else None

    def jloss(p):
        return jnp.sum(jrender(p, RADIUS, jcam, colors).color ** 2)

    jimg = jrender(jnp.asarray(pos), RADIUS, jcam, colors)
    jgrad = jax.jit(jax.grad(jloss))(jnp.asarray(pos))

    cam = interop.camera_from_numpy(
        np.asarray(jcam.transform), jcam.fov_deg, jcam.aspect, jcam.near,
        jcam.far, jcam.exposure, device=CPU)
    render = make_tiled_splat(LocalMesh((8,), CPU), W, H, 256,
                              gather_axis=gather_axis)
    tpos = torch.from_numpy(pos).requires_grad_()
    tcol = None if colors is None else torch.from_numpy(colors)
    img = render(tpos, RADIUS, cam, tcol)
    (grad,) = torch.autograd.grad((img.color ** 2).sum(), tpos)
    assert img.color.shape == (H, W, 3)
    assert _rel(img.color, jimg.color) <= RENDER_REL_TOL["color"]
    assert _rel(img.alpha, jimg.alpha) <= RENDER_REL_TOL["alpha"]
    assert _rel(grad, jgrad) <= RENDER_REL_TOL["grad"]
    # The tiles are the one-device image.
    whole = splat_particles(tpos.detach(), RADIUS, cam, width=W, height=H,
                            colors=tcol)
    assert torch.equal(img.color.detach(), whole.color)


def _slab_sim(dt_scale=1.0, migrate_capacity=64):
    """The JAX guard test's slab simulation (n3 = 8, 4 slabs, k = 48)."""
    n3, extent, n_dev = 8, 0.5, 4
    dx = (2.0 / n3) * extent
    params = FluidParams.for_spacing(dx)
    s0 = dam_break_state(n3, params, CPU, extent=extent)
    params = calibrate_rest_density(s0.pos, params)
    params = params.replace(dt=float(params.dt * dt_scale))
    spec = SlabSpec(n_dev=n_dev, capacity=256, halo_capacity=128,
                    migrate_capacity=migrate_capacity, h=params.h)
    mesh = LocalMesh((n_dev,), CPU)
    slabs = distribute(s0, spec)

    def make_step(p):
        return make_halo_step(mesh, spec, p, k=48)

    return slabs, params, make_step


class TestGuardedSlabRunner:
    def test_healthy_slab_run_advances(self):
        slabs, params, make_step = _slab_sim()
        r = GuardedSlabRunner(slabs, params, make_step, check_every=5)
        max_vel, n_live = r.run(10)
        assert r.step_count == 10 and r.recoveries == 0
        assert n_live == r.n0 == 512 and np.isfinite(max_vel)

    def test_slab_recovery_from_dt_blowup(self):
        slabs, params, make_step = _slab_sim(dt_scale=60.0)
        r = GuardedSlabRunner(slabs, params, make_step, check_every=5,
                              max_retries=3)
        try:
            r.run(10)
        except SimulationDiverged:
            pass
        assert r.recoveries >= 1
        assert r.params.dt < params.dt

    def test_drop_budget(self):
        """Particles lost (migration buffers of 1 slot under a +x kick)
        fail the check, unless the drop budget allows them."""
        slabs, params, make_step = _slab_sim(migrate_capacity=1)
        slabs = slabs._replace(vel=slabs.vel + torch.tensor([20.0, 0, 0]))
        strict = GuardedSlabRunner(slabs, params, make_step, check_every=10,
                                   max_retries=0)
        with pytest.raises(SimulationDiverged, match="particles lost"):
            strict.run(10)
        loose = GuardedSlabRunner(slabs, params, make_step, check_every=10,
                                  drop_budget=512)
        _, n_live = loose.run(10)
        assert loose.recoveries == 0 and n_live < 512
        assert loose.dropped == 512 - n_live

    def test_slab_checkpoint_kill_and_resume(self, tmp_path):
        slabs, params, make_step = _slab_sim()
        ck = Checkpointer(str(tmp_path / "ck"), interval=5)
        r = GuardedSlabRunner(slabs, params, make_step, check_every=5,
                              checkpointer=ck)
        r.run(10)
        ref = r.slabs
        steps_dirs = sorted(os.listdir(ck.root))
        assert steps_dirs, "no slab checkpoint written"
        loaded, step, lparams = load_slab_checkpoint(
            os.path.join(ck.root, steps_dirs[-1]), CPU)
        assert step == 10
        assert lparams.dt == pytest.approx(params.dt)
        for f in ("pos", "vel", "alive", "pressure", "dropped"):
            assert torch.equal(getattr(loaded, f), getattr(ref, f)), f
        r2 = GuardedSlabRunner(loaded, lparams, make_step, check_every=5)
        r2.run(5)
        assert r2.step_count == 5 and r2.recoveries == 0


def test_slab_checkpoint_onto_a_mesh(tmp_path):
    """A slab checkpoint holds every shard's store and loads onto a mesh
    of the same shard count; a plain checkpoint is refused."""
    from dieselfluid_tpu_torch.io.checkpoint import save_checkpoint

    slabs, params, _ = _slab_sim()
    save_slab_checkpoint(str(tmp_path / "s"), slabs, 3, params)
    mesh = LocalMesh((4,), CPU)
    loaded, step, lp = load_slab_checkpoint(str(tmp_path / "s"), mesh=mesh)
    assert step == 3 and lp == params
    assert torch.equal(loaded.pos, slabs.pos)
    with pytest.raises(ValueError):
        load_slab_checkpoint(str(tmp_path / "s"))
    state = dam_break_state(4, params, CPU)
    save_checkpoint(str(tmp_path / "p"), state, 1, params)
    with pytest.raises(ValueError, match="not a slab checkpoint"):
        load_slab_checkpoint(str(tmp_path / "p"), CPU)


def test_distributed_slab_example_twin(tmp_path, capsys):
    from dieselfluid_tpu_torch.examples import distributed_slab

    assert distributed_slab.main(
        ["--cpu", "--out", str(tmp_path / "slab_ckpt")]) == 0
    out = capsys.readouterr().out
    assert "frame 0: n_live=512" in out and "frame 2: n_live=512" in out
    assert "overflow=0" in out and "round-trip OK" in out
    assert os.path.exists(tmp_path / "slab_ckpt" / "meta.json")
