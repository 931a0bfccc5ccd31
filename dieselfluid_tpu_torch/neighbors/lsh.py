"""Random-hyperplane LSH sampler: the reference-parity neighbor provider.

Counterpart of dieselfluid_tpu/neighbors/lsh.py (ref: sampler/lsh/lsh.go):
8 random hyperplanes give an 8-bit sign hash mod `buckets`; a particle's
samples are the first `samples` entries scanning forward (cyclically) from
its own bucket over the bucket-sorted order. An approximate sampler, kept
for parity and for the flat table exports (GetData1D / GetVectors).

The hyperplanes come from an explicit `torch.Generator`: JAX's
`jax.random` bits cannot be reproduced, so tests carry the JAX vectors
across as numpy (`interop.lsh_vectors_from_numpy`).
"""

from __future__ import annotations

import dataclasses

import torch

from dieselfluid_tpu_torch.neighbors.types import Neighborhood

LOAD_FACTOR = 1.5     # ref: lsh.go:14
SAMPLES = 100         # ref: lsh.go:17


@dataclasses.dataclass(frozen=True)
class LSHSpec:
    """Static sampler config (ref: lsh.go Allocate:30-52)."""

    buckets: int = 255
    hash_bits: int = 8
    samples: int = SAMPLES

    def bucket_size(self, num_particles: int) -> int:
        """Load-factor-scaled table row length (ref: lsh.go:34)."""
        return int((num_particles / self.buckets) * LOAD_FACTOR)


def hash_vectors(generator: torch.Generator, spec: LSHSpec) -> torch.Tensor:
    """(hash_bits, 3) random hyperplanes in [-0.5, 0.5), on the generator's
    device (ref: lsh.go:40-43)."""
    return torch.rand((spec.hash_bits, 3), generator=generator,
                      dtype=torch.float32, device=generator.device) - 0.5


def lsh_hash(pos: torch.Tensor, vectors: torch.Tensor,
             buckets: int) -> torch.Tensor:
    """Sign-bit hash mod buckets, the first hyperplane the most significant
    bit (ref: lsh.go Hash:102-111)."""
    bits = (torch.einsum("nd,hd->nh", pos, vectors) > 0).to(torch.int64)
    nbits = vectors.shape[0]
    weights = 2 ** torch.arange(nbits - 1, -1, -1, device=pos.device)
    return torch.sum(bits * weights, dim=-1) % buckets


def build_table(pos: torch.Tensor, vectors: torch.Tensor, spec: LSHSpec):
    """(order, starts, hashes): particles stably sorted by bucket and the
    (buckets + 1,) prefix offsets (ref: lsh.go UpdateSampler:126-133)."""
    h = lsh_hash(pos, vectors, spec.buckets)
    order = torch.argsort(h, stable=True)
    starts = torch.searchsorted(
        h[order], torch.arange(spec.buckets + 1, dtype=h.dtype,
                               device=h.device))
    return order, starts, h


@torch.no_grad()
def get_samples(pos: torch.Tensor, vectors: torch.Tensor, spec: LSHSpec,
                query_pos=None) -> Neighborhood:
    """Per-query sample lists: the first `samples` particles scanning
    forward from the query's bucket, cyclically; every slot valid (ref:
    lsh.go GetSamples:136-158, GetSamplesFromPosition:160-181)."""
    q = pos if query_pos is None else query_pos
    order, starts, _ = build_table(pos, vectors, spec)
    start = starts[lsh_hash(q, vectors, spec.buckets)]
    window = (start[:, None] + torch.arange(spec.samples, device=pos.device)
              ) % pos.shape[0]
    idx = order[window]
    return Neighborhood(idx=idx, mask=torch.ones(idx.shape,
                                                 dtype=torch.float32,
                                                 device=pos.device))


def get_data_1d(pos: torch.Tensor, vectors: torch.Tensor,
                spec: LSHSpec) -> torch.Tensor:
    """The flattened (buckets * bucket_size,) bucket table, row-major and
    zero-padded (ref: lsh.go GetData1D:70-80)."""
    n = pos.shape[0]
    size = max(spec.bucket_size(n), 1)
    order, starts, _ = build_table(pos, vectors, spec)
    rank = starts[:-1, None] + torch.arange(size, device=pos.device)
    valid = rank < starts[1:, None]
    table = torch.where(valid, order[torch.clamp(rank, max=n - 1)], 0)
    return table.reshape(-1)


def get_vectors(vectors: torch.Tensor) -> torch.Tensor:
    """The flattened (hash_bits * 3,) hyperplanes (ref: lsh.go
    GetVectors:82-90)."""
    return vectors.reshape(-1)
