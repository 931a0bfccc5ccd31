"""Shared inputs and comparisons of the port's parallel/ tests
(tests/test_torch_parallel_*.py): the JAX package's smoke-size dam break
(tests/test_dense_halo.py:_smoke_state, n3 = 6, d0 x 1.1) made from a seed
with numpy, with seeded velocities and warm pressures, and a column of
particles pushed across the first slab face so that one step migrates."""

import numpy as np
import torch

N_DEV = 4
SLAB_FIELDS = ("pos", "vel", "alive", "dropped", "pressure", "boundary_pos",
               "boundary_mask")


def smoke_params(n3=6, extent=0.5, d0_scale=1.1):
    """(JAX FluidParams, the port's, dx)."""
    from dieselfluid_tpu.config import FluidParams

    from dieselfluid_tpu_torch import interop

    dx = (2.0 / n3) * extent
    params = FluidParams.for_spacing(dx)
    params = params.replace(d0=float(d0_scale * params.d0))
    return params, interop.fluid_params_from(params), dx


def numpy_state(params, dx, n3=6, extent=0.5, seed=0, face=None,
                vel_scale=0.5):
    """The dam break as numpy fields: N(0, vel_scale) velocities, warm
    pressures in [0, 100), and, with `face`, the lattice column left of
    x = face moving across it in one step."""
    from dieselfluid_tpu.models.particles import dam_break_state

    s = dam_break_state(n3, params, extent=extent)
    rng = np.random.default_rng(seed)
    pos = np.asarray(s.pos).copy()
    vel = (rng.normal(size=pos.shape) * vel_scale).astype(np.float32)
    if face is not None:
        near = (pos[:, 0] < face) & (pos[:, 0] > face - 1.5 * dx)
        vel[near, 0] = (1.5 * (face - pos[near, 0])
                        / params.dt).astype(np.float32)
    return {"pos": pos, "vel": vel, "force": np.asarray(s.force),
            "density": np.asarray(s.density),
            "pressure": rng.uniform(0.0, 100.0, len(pos)).astype(np.float32)}


def jax_state(arrays, boundary=None):
    import jax.numpy as jnp

    from dieselfluid_tpu.models.particles import FluidState

    return FluidState(**{k: jnp.asarray(v) for k, v in arrays.items()},
                      boundary_pos=None if boundary is None
                      else jnp.asarray(boundary))


def torch_state(arrays, boundary=None, device="cpu"):
    from dieselfluid_tpu_torch import interop

    return interop.fluid_state_from_numpy(**arrays, boundary_pos=boundary,
                                          device=device)


def port_slabs(jslabs, device="cpu"):
    """The port's SlabState from a JAX SlabState (numpy in between)."""
    from dieselfluid_tpu_torch import interop

    return interop.slab_state_from_numpy(
        *[None if getattr(jslabs, f) is None else np.asarray(getattr(
            jslabs, f)) for f in SLAB_FIELDS], device=device)


def rel(got, want) -> float:
    """max |got - want| / max |want|."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def assert_step_outputs_equal(jout, tout, tol):
    """One sharded step's outputs, slab by slab and slot by slot: pos, vel
    and pressure within `tol` (relative to each field's largest
    magnitude), alive, dropped, n_live, cell overflow and per-slab live
    counts equal, max_vel within tol["vel"]."""
    js, ts = jout[0], tout[0]
    for f, t in tol.items():
        assert rel(getattr(ts, f), getattr(js, f)) <= t, (
            f, rel(getattr(ts, f), getattr(js, f)))
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    assert float(ts.dropped) == float(js.dropped)
    assert rel(tout[1], jout[1]) <= tol["vel"]
    for j, t in zip(jout[2:], tout[2:]):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def nearest_match(ref: np.ndarray, got: np.ndarray):
    """Match each reference particle to its nearest in `got`; asserts the
    matching is a bijection; returns (match indices, distances)."""
    d2 = ((ref[:, None, :] - got[None, :, :]) ** 2).sum(-1)
    match = d2.argmin(axis=1)
    assert len(np.unique(match)) == len(ref), "matching is not a bijection"
    return match, np.sqrt(d2[np.arange(len(ref)), match])
