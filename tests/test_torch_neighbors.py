"""The port's neighbor providers against the JAX package's, on the CPU.

Brute force, the cell grid and LSH (the JAX hyperplanes carried across as
numpy) take the same numpy positions in both packages: a 1,728-particle dam
break on its lattice (pairs at exactly r = 2 dx = h, which the radius test
keeps or drops on the root's last bit) and the same state jittered by 0.1
dx. The tables must be equal slot for slot: `idx` and `mask` exactly (the
stable sorts keep JAX's order among equal distances), also with
`self_offset`, `exclude_self=False`, an overflowing capacity and the
k > 27 * capacity padding. `overflow_fraction` and
`calibrate_rest_density` agree exactly too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dieselfluid_tpu.config import FluidParams
from dieselfluid_tpu.models.particles import dam_break_state
from dieselfluid_tpu.neighbors import bruteforce as jbf
from dieselfluid_tpu.neighbors import calibrate as jcal
from dieselfluid_tpu.neighbors import cellgrid as jcg
from dieselfluid_tpu.neighbors import lsh as jlsh
from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.neighbors import bruteforce as tbf
from dieselfluid_tpu_torch.neighbors import calibrate as tcal
from dieselfluid_tpu_torch.neighbors import cellgrid as tcg
from dieselfluid_tpu_torch.neighbors import lsh as tlsh

torch.set_num_threads(1)

N3 = 12
DX = (2.0 / N3) * 0.5
PARAMS = FluidParams.for_spacing(DX)
H = PARAMS.h


def _positions(kind: str) -> np.ndarray:
    pos = np.asarray(dam_break_state(N3, PARAMS, extent=0.5).pos)
    if kind == "jitter":
        rng = np.random.default_rng(7)
        pos = pos + rng.normal(size=pos.shape) * 0.1 * DX
    return np.array(pos, np.float32)


@pytest.fixture(scope="module", params=["lattice", "jitter"])
def positions(request):
    p = _positions(request.param)
    return request.param, jnp.asarray(p), torch.from_numpy(p.copy())


def _assert_same(jnb, tnb):
    np.testing.assert_array_equal(tnb.idx.numpy(), np.asarray(jnb.idx))
    np.testing.assert_array_equal(tnb.mask.numpy(), np.asarray(jnb.mask))
    assert tnb.idx.dtype == torch.int64 and tnb.mask.dtype == torch.float32


def _specs(capacity):
    lo, hi = (-1.0,) * 3, (1.0,) * 3
    return (jcg.CellGridSpec.for_domain(lo, hi, H, capacity),
            tcg.CellGridSpec.for_domain(lo, hi, H, capacity))


def test_the_lattice_has_pairs_on_the_radius():
    """The lattice state exercises the r = h pairs: pairs 2 dx apart (h in
    exact arithmetic) land a few position ulps on either side of h."""
    p = torch.from_numpy(_positions("lattice"))
    d = tbf.pairwise_distances(p, p)
    near = (d - H).abs() <= 1e-6
    assert bool((d[near] < H).any()) and bool((d[near] >= H).any())


@pytest.mark.parametrize("k", [32, 64])
def test_brute_force_matches_jax(positions, k):
    _, jp, tp = positions
    _assert_same(jbf.brute_force_neighborhood(jp, jp, H, k),
                 tbf.brute_force_neighborhood(tp, tp, H, k))


def test_pairwise_distances_match_jax(positions):
    _, jp, tp = positions
    np.testing.assert_array_equal(
        tbf.pairwise_distances(tp, tp).numpy(),
        np.asarray(jbf.pairwise_distances(jp, jp)))


@pytest.mark.parametrize("capacity,k", [(32, 128), (32, 24), (2, 64)])
def test_cell_grid_matches_jax(positions, capacity, k):
    """(32, 128): the facade's defaults; (32, 24): k below the in-radius
    count, so the ranking cuts inside a shell of equal distances; (2, 64):
    cells overflow and k > 27 * 2, so the tail is padding."""
    _, jp, tp = positions
    js, ts = _specs(capacity)
    jnb = jcg.cell_grid_neighborhood(jp, jp, H, k, js)
    tnb = tcg.cell_grid_neighborhood(tp, tp, H, k, ts)
    _assert_same(jnb, tnb)
    if capacity == 2:
        assert tnb.k == k and not bool(tnb.mask[:, 54:].any())


def test_cell_grid_equals_brute_force_without_overflow(positions):
    _, _, tp = positions
    _, ts = _specs(32)
    assert float(tcg.overflow_fraction(tp, ts)) == 0.0
    a = tcg.cell_grid_neighborhood(tp, tp, H, 64, ts)
    b = tbf.brute_force_neighborhood(tp, tp, H, 64)
    # The same neighbor sets (the order among equal distances differs:
    # candidate slots against source indices).
    sa = torch.where(a.mask > 0, a.idx, -1).sort(dim=1).values
    sb = torch.where(b.mask > 0, b.idx, -1).sort(dim=1).values
    assert torch.equal(sa, sb)


def test_cell_table_pieces_match_jax(positions):
    _, jp, tp = positions
    js, ts = _specs(16)
    assert ts.dims == js.dims and ts.num_cells == js.num_cells
    np.testing.assert_array_equal(tcg.cell_coords(tp, ts).numpy(),
                                  np.asarray(jcg.cell_coords(jp, js)))
    np.testing.assert_array_equal(tcg.cell_id(tp, ts).numpy(),
                                  np.asarray(jcg.cell_id(jp, js)))
    jo, jst = jcg.build_cell_table(jp, js)
    to, tst = tcg.build_cell_table(tp, ts)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    ijk = jcg.cell_coords(jp, js)
    jl, jv = jcg._stencil_cells(ijk, js)
    tl, tv = tcg._stencil_cells(tcg.cell_coords(tp, ts), ts)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("capacity", [2, 4, 32])
def test_overflow_fraction_matches_jax(capacity):
    p = _positions("jitter")
    js, ts = _specs(capacity)
    want = float(jcg.overflow_fraction(jnp.asarray(p), js))
    got = tcg.overflow_fraction(torch.from_numpy(p), ts)
    assert got.dtype == torch.float32 and float(got) == want
    assert (want > 0) == (capacity < 32)


@pytest.mark.parametrize("provider", ["bruteforce", "cellgrid"])
def test_self_offset_and_exclude_self_match_jax(provider):
    """A contiguous query shard of the source pool, self pairs excluded by
    `self_offset`; and the full pool with exclude_self=False (the self pair
    at distance 0 ranks first)."""
    p = _positions("jitter")
    jp, tp = jnp.asarray(p), torch.from_numpy(p)
    js, ts = _specs(32)
    lo, hi = 300, 700

    def both(fn_j, fn_t, **kw):
        _assert_same(fn_j(jp[lo:hi], jp, H, 48, **kw),
                     fn_t(tp[lo:hi], tp, H, 48, **kw))

    if provider == "bruteforce":
        fj, ft = jbf.brute_force_neighborhood, tbf.brute_force_neighborhood
    else:
        def fj(q, s, h, k, **kw):
            return jcg.cell_grid_neighborhood(q, s, h, k, js, **kw)

        def ft(q, s, h, k, **kw):
            return tcg.cell_grid_neighborhood(q, s, h, k, ts, **kw)
    both(fj, ft, self_offset=lo)
    nb = ft(tp, tp, H, 48, exclude_self=False)
    _assert_same(fj(jp, jp, H, 48, exclude_self=False), nb)
    assert torch.equal(nb.idx[:, 0], torch.arange(p.shape[0]))


def test_neighbor_tables_carry_no_gradient():
    p = torch.from_numpy(_positions("jitter")).requires_grad_(True)
    _, ts = _specs(32)
    for nb in (tcg.cell_grid_neighborhood(p, p, H, 64, ts),
               tbf.brute_force_neighborhood(p, p, H, 64)):
        assert not nb.idx.requires_grad and not nb.mask.requires_grad
        assert nb.idx.grad_fn is None and nb.mask.grad_fn is None


@pytest.mark.parametrize("include_self", [True, False])
def test_calibrate_rest_density_matches_jax(include_self):
    p = _positions("jitter")
    want = jcal.calibrate_rest_density(jnp.asarray(p), PARAMS,
                                       include_self=include_self)
    got = tcal.calibrate_rest_density(torch.from_numpy(p),
                                      interop.fluid_params_from(PARAMS),
                                      include_self=include_self)
    # The largest summed density (64 terms in XLA's order against torch's):
    # equal on this state.
    assert got.d0 == want.d0 and got.tait_w == want.tait_w
    assert got.h == want.h and got.mass == want.mass


@pytest.fixture(scope="module")
def lsh_case():
    spec = jlsh.LSHSpec()
    vecs = np.asarray(jlsh.hash_vectors(jax.random.PRNGKey(3), spec))
    p = _positions("jitter")
    tv = interop.lsh_vectors_from_numpy(vecs, device="cpu")
    return (spec, tlsh.LSHSpec(), jnp.asarray(p), torch.from_numpy(p),
            jnp.asarray(vecs), tv)


def test_lsh_matches_jax(lsh_case):
    js, ts, jp, tp, jv, tv = lsh_case
    assert ts == tlsh.LSHSpec(**vars(js))
    np.testing.assert_array_equal(tlsh.lsh_hash(tp, tv, ts.buckets).numpy(),
                                  np.asarray(jlsh.lsh_hash(jp, jv,
                                                           js.buckets)))
    jo, jst, jh = jlsh.build_table(jp, jv, js)
    to, tst, th = tlsh.build_table(tp, tv, ts)
    for got, want in ((to, jo), (tst, jst), (th, jh)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_same(jlsh.get_samples(jp, jv, js), tlsh.get_samples(tp, tv, ts))
    _assert_same(jlsh.get_samples(jp, jv, js, query_pos=jp[:50]),
                 tlsh.get_samples(tp, tv, ts, query_pos=tp[:50]))
    np.testing.assert_array_equal(tlsh.get_data_1d(tp, tv, ts).numpy(),
                                  np.asarray(jlsh.get_data_1d(jp, jv, js)))
    np.testing.assert_array_equal(tlsh.get_vectors(tv).numpy(),
                                  np.asarray(jlsh.get_vectors(jv)))
    assert ts.bucket_size(1728) == js.bucket_size(1728)


def test_lsh_hash_vectors_from_a_generator():
    spec = tlsh.LSHSpec()
    g = torch.Generator().manual_seed(5)
    v = tlsh.hash_vectors(g, spec)
    assert v.shape == (8, 3) and v.dtype == torch.float32
    assert float(v.min()) >= -0.5 and float(v.max()) < 0.5
    again = tlsh.hash_vectors(torch.Generator().manual_seed(5), spec)
    assert torch.equal(v, again)
