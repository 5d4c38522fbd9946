"""Mesh sharding for the downstream algorithms: query-batch matching and
site-parallel painting.

The reference has no parallelism to port (SURVEY.md section 2); these are
the mesh distributions of its two production consumers:

* **Matching** (matchSequencesSweep/Indexed): queries are independent
  given the panel state, so the query batch shards over the mesh while
  every shard advances the (replicated) panel chain - the data-parallel
  axis of this domain.  Collective traffic: none per site; results come
  back query-sharded.

* **Painting** (paintAncestryMatrix): per-site weight accumulation is
  independent across site chunks given the (replicated) segment list, so
  the site axis shards over the mesh and each shard evaluates its chunk
  subset; the host combines per-chunk partial sums in a fixed order, so
  the result is bitwise identical to the single-device pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


def match_scan_sharded(W, qcols, xq_bits, xp_bits, xq_words, xp_words,
                       a0, mesh: Mesh, axis: str = "s"):
    """ops/match_jax.match_scan with the query batch sharded over ``axis``.

    W (Ng, M) packed panel words, xp_* panel bits/words, a0: replicated.
    qcols (Ns, Q), xq_bits/xq_words (Q, .): sharded over queries.
    Returns match_scan's outputs with the per-query axes sharded.
    """
    from ..ops.match_jax import match_scan

    def shard_fn(qc, qb, qw):
        return match_scan(W, qc, qb, xp_bits, qw, xp_words, a0)

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(None, axis), P(axis, None), P(axis, None)),
        out_specs=(P(None, axis), P(None, axis), P(None, axis),
                   P(None, axis), (P(axis), P(axis), P(axis)), P(None)))
    return fn(qcols, xq_bits, xq_words)


def paint_chunks_sharded(segments: np.ndarray, n_recipients: int, N: int,
                         map_ih: np.ndarray, mesh: Mesh, axis: str = "s",
                         chunk: int = 256):
    """paint_totals_device with the site-chunk axis sharded over the mesh.

    Each shard evaluates _paint_chunk for its chunk subset (segments
    replicated); per-chunk float32 partials are combined on the host in
    chunk order, making the totals bitwise identical to the single-device
    pass.  Returns (counts, lengths) as paint_totals_device does.
    """
    from ..ops.paint_jax import _paint_chunk

    nseg = len(segments)
    order = np.argsort(segments[:, 0], kind="stable")
    segs = segments[order]
    T = n_recipients
    cnt = np.bincount(segs[:, 0], minlength=T)
    off = np.zeros(T + 1, np.int32)
    np.cumsum(cnt, out=off[1:])
    first = np.zeros(nseg, bool)
    first[off[:-1][cnt > 0]] = True
    last = np.zeros(nseg, bool)
    last[off[1:][cnt > 0] - 1] = True
    seg_self = map_ih[segs[:, 0]] == map_ih[segs[:, 1]]

    n_shards = mesh.shape[axis]
    nchunks = -(-N // chunk)
    nchunks_pad = -(-nchunks // n_shards) * n_shards
    k0s = np.full(nchunks_pad, N + chunk, np.int32)     # pad chunks: no-ops
    k0s[:nchunks] = np.arange(nchunks, dtype=np.int32) * chunk

    seg_ids = jnp.asarray(segs[:, 0].astype(np.int32))
    s_d = jnp.asarray(segs[:, 2].astype(np.int32))
    e_d = jnp.asarray(segs[:, 3].astype(np.int32))
    self_d = jnp.asarray(seg_self)
    first_d = jnp.asarray(first)
    last_d = jnp.asarray(last)
    pair_seg = jnp.zeros(1, jnp.int32)
    pair_idx = jnp.full(1, -1, jnp.int32)

    def shard_fn(k0_local):
        def one(k0):
            lengths, _ = _paint_chunk(seg_ids, s_d, e_d, self_d, first_d,
                                      last_d, k0, pair_seg, pair_idx,
                                      chunk, N, T)
            return lengths
        return jax.lax.map(one, k0_local)

    fn = jax.shard_map(shard_fn, mesh=mesh, in_specs=P(axis),
                       out_specs=P(axis))
    partials = np.asarray(fn(jnp.asarray(k0s)), np.float64)   # (nc, nseg, .)

    inv_len64 = 1.0 / np.maximum(segs[:, 3] - segs[:, 2], 1).astype(np.float64)
    tot_lengths = np.zeros(nseg, np.float64)
    for ci in range(nchunks):
        tot_lengths += partials[ci].sum(axis=1)
    tot_counts = tot_lengths * inv_len64

    n_inds = int(map_ih.max()) + 1
    counts = np.zeros((T, n_inds))
    lengths = np.zeros((T, n_inds))
    np.add.at(counts, (segs[:, 0], map_ih[segs[:, 1]]), tot_counts)
    np.add.at(lengths, (segs[:, 0], map_ih[segs[:, 1]]), tot_lengths)
    return counts, lengths
