"""The port's SPH field operators (models/field.py) against the JAX
package's, on the CPU.

All ten operators take the same numpy inputs in both packages: a
512-particle dam break jittered by 0.2 dx, with seeded scalar and vector
values, one particle moved onto another (a real slot at distance 0, where
the where-trick guards the root), and the JAX brute-force table carried
across (`interop.neighborhood_from_numpy`). Each runs once on the full pool
and once on a query shard against the pool (`source_*` arguments), and
the gradients of a seeded linear loss of every operator's output, to the
positions and the values, are compared with `jax.grad` and must be finite.
Tolerances are relative to the output's largest magnitude, about 10x the
drift measured (beside each): the sums over the 48 slots add in another
order in XLA's reductions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dieselfluid_tpu.config import FluidParams
from dieselfluid_tpu.models import field as JF
from dieselfluid_tpu.models.particles import dam_break_state
from dieselfluid_tpu.neighbors.bruteforce import brute_force_neighborhood
from dieselfluid_tpu.neighbors.types import Neighborhood as JNb
from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.models import field as TF

torch.set_num_threads(1)

N3 = 8
DX = (2.0 / N3) * 0.5
PARAMS = FluidParams.for_spacing(DX)
TPARAMS = interop.fluid_params_from(PARAMS)
K = 48
SHARD = slice(100, 300)
# max |port - jax| / max |jax| per operator, forward (measured at most
# 3.1e-7 over the ten operators and both forms)
REL_TOL = 3e-6
# the same for the gradients (measured at most 2.9e-7)
GRAD_REL_TOL = 3e-6


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    pos = np.asarray(dam_break_state(N3, PARAMS, extent=0.5).pos)
    pos = pos + rng.normal(size=pos.shape) * 0.2 * DX
    pos[5] = pos[6]                      # a real slot at distance 0
    pos = pos.astype(np.float32)
    nb = brute_force_neighborhood(jnp.asarray(pos), jnp.asarray(pos),
                                  PARAMS.h, K)
    nb_shard = brute_force_neighborhood(jnp.asarray(pos[SHARD]),
                                        jnp.asarray(pos), PARAMS.h, K,
                                        self_offset=SHARD.start)
    n = pos.shape[0]
    arrays = {
        "pos": pos,
        "rho": (PARAMS.d0 * (1 + 0.05 * rng.normal(size=n))).astype(
            np.float32),
        "f": rng.normal(size=n).astype(np.float32) * 1e3,
        "v": rng.normal(size=(n, 3)).astype(np.float32),
    }
    return arrays, nb, nb_shard


def _ops(F, P):
    """name -> fn(pos, rho, f, v, nb, shard) over one package's field."""
    s = SHARD

    def src(full, x):
        return {} if full else x

    return {
        "density": lambda p, r, f, v, nb, full: F.density(
            p if full else p[s], nb, P, **src(full, {"source_pos": p})),
        "density_with_self": lambda p, r, f, v, nb, full: F.density_with_self(
            p if full else p[s], nb, P, **src(full, {"source_pos": p})),
        "density_at": lambda p, r, f, v, nb, full: F.density_at(
            p if full else p[s], p, nb, P),
        "interpolate": lambda p, r, f, v, nb, full: F.interpolate(
            p if full else p[s], p, r, f, nb, P),
        "gradient": lambda p, r, f, v, nb, full: F.gradient(
            *((p, r, f) if full else (p[s], r[s], f[s])), nb, P,
            **src(full, {"source_pos": p, "source_rho": r,
                         "source_values": f})),
        "pressure_force": lambda p, r, f, v, nb, full: F.pressure_force(
            *((p, r, f) if full else (p[s], r[s], f[s])), nb, P,
            **src(full, {"source_pos": p, "source_rho": r,
                         "source_pressure": f})),
        "divergence": lambda p, r, f, v, nb, full: F.divergence(
            *((p, r, v) if full else (p[s], r[s], v[s])), nb, P,
            **src(full, {"source_pos": p, "source_rho": r,
                         "source_values": v})),
        "laplacian": lambda p, r, f, v, nb, full: F.laplacian(
            *((p, r, f) if full else (p[s], r[s], f[s])), nb, P,
            **src(full, {"source_pos": p, "source_rho": r,
                         "source_values": f})),
        "laplacian_force": lambda p, r, f, v, nb, full: F.laplacian_force(
            *((p, v, r) if full else (p[s], v[s], r[s])), nb, P,
            **src(full, {"source_pos": p, "source_vel": v,
                         "source_rho": r})),
        "curl": lambda p, r, f, v, nb, full: F.curl(
            *((p, r, v) if full else (p[s], r[s], v[s])), nb, P,
            **src(full, {"source_pos": p, "source_rho": r,
                         "source_values": v})),
    }


OPS = list(_ops(JF, PARAMS))


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("full", [True, False], ids=["pool", "shard"])
@pytest.mark.parametrize("op", OPS)
def test_operator_and_its_gradient_match_jax(case, op, full):
    arrays, jnb, jnb_shard = case
    nb_j = jnb if full else jnb_shard
    nb_t = interop.neighborhood_from_numpy(np.asarray(nb_j.idx),
                                           np.asarray(nb_j.mask),
                                           device="cpu")
    fj = _ops(JF, PARAMS)[op]
    ft = _ops(TF, TPARAMS)[op]
    names = ("pos", "rho", "f", "v")
    jin = [jnp.asarray(arrays[k]) for k in names]
    tin = [torch.from_numpy(arrays[k].copy()).requires_grad_(True)
           for k in names]

    want = fj(*jin, nb_j, full)
    got = ft(*tin, nb_t, full)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert _rel(got.detach().numpy(), want) < REL_TOL

    w = np.random.default_rng(3).normal(size=want.shape).astype(np.float32)

    def jloss(*xs):
        return jnp.sum(fj(*xs, nb_j, full) * w)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*jin)
    tgrads = torch.autograd.grad(torch.sum(got * torch.from_numpy(w)), tin,
                                 allow_unused=True)
    for name, jg, tg in zip(names, jgrads, tgrads):
        jg = np.asarray(jg)
        tg = np.zeros_like(jg) if tg is None else tg.numpy()
        assert np.isfinite(tg).all(), name
        if np.abs(jg).max() > 0:
            assert _rel(tg, jg) < GRAD_REL_TOL, name
        else:
            assert not np.abs(tg).any(), name


def test_masked_slots_do_not_contribute(case):
    """A table whose every slot is masked gives zero density and force,
    and finite zero gradients (the where-trick at d = 0 on slot 0)."""
    arrays, _, _ = case
    n = arrays["pos"].shape[0]
    nb = interop.neighborhood_from_numpy(np.zeros((n, 4), np.int64),
                                         np.zeros((n, 4), np.float32),
                                         device="cpu")
    pos = torch.from_numpy(arrays["pos"].copy()).requires_grad_(True)
    rho = TF.density(pos, nb, TPARAMS)
    f = TF.pressure_force(pos, torch.from_numpy(arrays["rho"]),
                          torch.from_numpy(arrays["f"]), nb, TPARAMS)
    assert not rho.detach().any() and not f.detach().any()
    (g,) = torch.autograd.grad(rho.sum() + f.sum(), pos)
    assert torch.isfinite(g).all() and not g.any()
    jnb = JNb(jnp.zeros((n, 4), jnp.int32), jnp.zeros((n, 4), jnp.float32))
    assert not np.asarray(JF.density(jnp.asarray(arrays["pos"]), jnb,
                                     PARAMS)).any()
