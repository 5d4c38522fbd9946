"""Device engine: ChromoPainter co-ancestry accumulation.

paintAncestryMatrix's hot loop (pbwtPaint.c:112-137) is, per recipient
haplotype and per site, a normalised (k-start)*(end-k) weighted vote over
covering match segments.  On device this is the same dense pass as
imputation (ops/impute_jax.py): per site-chunk, weights are closed-form
elementwise over the (segment, site) grid, the per-recipient normaliser is
a cumsum difference over the segment axis, and each segment's total
chunkcount / chunklength contributions reduce over the chunk axis.  The
region bookkeeping (chunksperregion boundaries) stays on the host where it
is a cheap per-segment walk.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("chunk", "N", "T"))
def _paint_chunk(seg_ids, seg_s, seg_e, seg_self, seg_first, seg_last, k0,
                 pair_seg, pair_idx, chunk: int, N: int, T: int):
    """Per-segment chunkcount and chunklength contributions for sites
    [k0, k0+chunk).  seg_self masks self-matches (same individual) out of
    both the normaliser and the contributions.

    Segments are in the reference's report order (ascending end).  The
    reference scan stops at the first live segment whose start >= k
    (pbwtPaint.c:126: ``m->start < k`` over end-sorted segments), so a
    segment participates iff the running max of starts over live
    (end > k) predecessors within its recipient is < k - a segmented
    running max over the segment axis.

    Returns (lengths, pc): (nseg, chunk//64) float32 site-subblock partial
    sums of normalised weights, and the requested chunkcount prefixes.
    """
    k = (k0 + jnp.arange(chunk, dtype=jnp.int32))[None, :].astype(jnp.float32)
    valid = (k >= 1) & (k < N)                   # reference loops k = 1..N-1
    s = seg_s[:, None].astype(jnp.float32)
    e = seg_e[:, None].astype(jnp.float32)

    live_start = jnp.where(e > k, s, -jnp.inf)   # (nseg, chunk)

    def combine(x, y):
        xv, xr = x
        yv, yr = y
        return jnp.where(yr, yv, jnp.maximum(xv, yv)), xr | yr

    resets = seg_first[:, None] & jnp.ones_like(valid)
    run_max, _ = jax.lax.associative_scan(combine, (live_start, resets),
                                          axis=0)
    included = run_max < k
    raw_w = (k - s) * (e - k)
    live = (s < k) & (e > k) & included
    # tail case: when every segment of a recipient has expired, the
    # reference's window pointer rests on the LAST segment and still adds
    # its (now negative) weight (pbwtPaint.c:114 m1 < mStop bound)
    tail = seg_last[:, None] & (e <= k) & (s < k)
    w = jnp.where((live | tail) & valid & ~seg_self[:, None], raw_w, 0.0)
    # per-recipient normaliser via segment_sum: weights are exact integers
    # in f32 (products < 2^24 for N <= 8192), and per-recipient sums avoid
    # the cancellation error of a global cumsum-difference
    ssum = jax.ops.segment_sum(w, seg_ids, num_segments=T)   # (T, chunk)
    rec_sum = ssum[seg_ids]
    wn = jnp.where(rec_sum != 0, w / rec_sum, 0.0)
    # site-axis partial sums over 64-site sub-blocks: the host combines
    # them in float64, keeping the f32 error at the few-ulp level so the
    # reference's %.4f output rounding is preserved in practice
    sb = 64 if chunk % 64 == 0 else chunk
    lengths = jnp.sum(wn.reshape(wn.shape[0], chunk // sb, sb), axis=2)
    inv_len = 1.0 / jnp.maximum((e - s)[:, 0], 1.0)
    # chunkcount prefix values at requested (segment, in-chunk site) pairs
    # (region-boundary bookkeeping for counts2/counts3/nregions)
    ccum = jnp.cumsum(wn * inv_len[:, None], axis=1)
    pvalid = (pair_idx >= 0) & (pair_idx < chunk)
    pc = jnp.where(pvalid,
                   ccum[pair_seg, jnp.clip(pair_idx, 0, chunk - 1)], 0.0)
    return lengths, pc


def paint_totals_device(segments: np.ndarray, n_recipients: int, N: int,
                        map_ih: np.ndarray, chunk: int = 1024,
                        pairs: np.ndarray | None = None):
    """Total chunkcounts/chunklengths per (recipient hap, donor individual).

    segments: (nseg, 4) rows (recipient hap i, donor hap j, start, end).
    pairs: optional (B, 2) rows (input segment row, boundary site b)
           requesting the chunkcount prefix sum over sites k < b of that
           segment (region-boundary bookkeeping).

    Returns (counts, lengths) - (n_recipient_haps, n_inds) float64 matrices
    equal to the reference's per-site accumulation up to float ordering -
    plus (seg_counts, pair_prefix): per-input-row chunkcount totals (nseg,)
    and the requested prefixes (B,).
    """
    nseg = len(segments)
    # preserve the report order (ascending end) within each recipient - the
    # reference's scan-stop rule depends on it
    order = np.argsort(segments[:, 0], kind="stable")
    segs = segments[order]
    inv_order = np.empty(nseg, np.int64)
    inv_order[order] = np.arange(nseg)
    T = n_recipients
    cnt = np.bincount(segs[:, 0], minlength=T)
    off = np.zeros(T + 1, np.int32)
    np.cumsum(cnt, out=off[1:])
    seg_self = map_ih[segs[:, 0]] == map_ih[segs[:, 1]]
    first = np.zeros(nseg, bool)
    first[off[:-1][cnt > 0]] = True
    last = np.zeros(nseg, bool)
    last[off[1:][cnt > 0] - 1] = True
    seg_ids = jnp.asarray(segs[:, 0].astype(np.int32))
    s_d = jnp.asarray(segs[:, 2].astype(np.int32))
    e_d = jnp.asarray(segs[:, 3].astype(np.int32))
    self_d = jnp.asarray(seg_self)
    first_d = jnp.asarray(first)
    last_d = jnp.asarray(last)

    # distribute prefix requests to the chunk holding site b-1; pad each
    # chunk's request list to one fixed width (single compiled program)
    nchunks = -(-N // chunk)
    if pairs is not None and len(pairs):
        prow = inv_order[pairs[:, 0]]
        pb = pairs[:, 1]
        pchunk = np.maximum(pb - 1, 0) // chunk
        per = np.bincount(pchunk, minlength=nchunks)
        P = 1 << int(np.max(per) - 1).bit_length() if per.max() else 1
        pair_seg = np.zeros((nchunks, P), np.int32)
        pair_idx = np.full((nchunks, P), -1, np.int32)
        slot = np.zeros(nchunks, np.int64)
        porder = np.argsort(pchunk, kind="stable")
        for t in porder:
            c = pchunk[t]
            pair_seg[c, slot[c]] = prow[t]
            pair_idx[c, slot[c]] = pb[t] - 1 - c * chunk
            slot[c] += 1
    else:
        P = 1
        pair_seg = np.zeros((nchunks, P), np.int32)
        pair_idx = np.full((nchunks, P), -1, np.int32)

    inv_len64 = 1.0 / np.maximum(segs[:, 3] - segs[:, 2], 1).astype(np.float64)
    tot_lengths = np.zeros(nseg, np.float64)
    pc_chunks = []
    for ci, k0 in enumerate(range(0, N, chunk)):
        l, pc = _paint_chunk(seg_ids, s_d, e_d, self_d, first_d, last_d,
                             k0, jnp.asarray(pair_seg[ci]),
                             jnp.asarray(pair_idx[ci]), chunk, N, T)
        # prefix at b = chunkcount carry before this chunk + in-chunk cum
        pc_chunks.append(np.asarray(pc, np.float64)
                         + tot_lengths[pair_seg[ci]]
                         * inv_len64[pair_seg[ci]])
        tot_lengths += np.asarray(l, np.float64).sum(axis=1)
    tot_counts = tot_lengths * inv_len64

    pair_prefix = np.zeros(len(pairs) if pairs is not None else 0)
    if pairs is not None and len(pairs):
        slot = np.zeros(nchunks, np.int64)
        for t in porder:
            c = pchunk[t]
            pair_prefix[t] = pc_chunks[c][slot[c]]
            slot[c] += 1

    n_inds = int(map_ih.max()) + 1
    counts = np.zeros((T, n_inds))
    lengths = np.zeros((T, n_inds))
    np.add.at(counts, (segs[:, 0], map_ih[segs[:, 1]]), tot_counts)
    np.add.at(lengths, (segs[:, 0], map_ih[segs[:, 1]]), tot_lengths)
    return counts, lengths, tot_counts[inv_order], pair_prefix
