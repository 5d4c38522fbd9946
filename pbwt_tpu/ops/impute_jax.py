"""Device engine: reference imputation as a batched forward pass.

The reference's imputation inner loop (referenceImpute3,
pbwtImpute.c:1184-1251) walks, per reference site and per target haplotype,
the maximal-match segments covering that site and takes a positionally
weighted vote w = (k-start)*(end-k) over the donors' alleles.

Device formulation: segments (one row per maximal match, sorted by target
haplotype) become dense arrays; per site-chunk the donor alleles are a row
gather, activity masks and weights are closed-form elementwise in k, and
the per-target reduction is a cumsum-difference over the sorted segment
axis - no ragged loops, no scatter.  The site dimension is chunked to bound
the (nseg, chunk) intermediate.

Float accumulation order differs from the serial C sum, so dosages can
drift by ulps; the quantised dosage codec (6 levels) and the imputed
alleles are insensitive to this in practice and are compared exactly in
tests.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("chunk",))
def _impute_chunk_scores(seg_j_off, seg_jref, seg_s, seg_e, Xref_chunk,
                         kold_chunk, chunk: int):
    """Scores for one chunk of reference sites.

    seg_j_off: (T+1,) int32 - segment ranges per target (segments sorted by
               target haplotype)
    seg_jref/seg_s/seg_e: (nseg,) int32
    Xref_chunk: (Mref, C) uint8 donor alleles, natural order
    kold_chunk: (C,) int32 frame coordinate of each site in the chunk
    Returns (sum, score): (T, C) float32 each.
    """
    x = Xref_chunk[seg_jref]                             # (nseg, C) donor alleles
    k = kold_chunk[None, :].astype(jnp.float32)          # frame coordinate
    s = seg_s[:, None].astype(jnp.float32)
    e = seg_e[:, None].astype(jnp.float32)
    w = (k - s) * (e - k)
    w = jnp.where((s < k) & (w > 0), w, 0.0)
    contrib = jnp.concatenate(
        [jnp.zeros((1, w.shape[1]), jnp.float32), jnp.cumsum(w, axis=0)])
    ssum = contrib[seg_j_off[1:]] - contrib[seg_j_off[:-1]]
    wx = w * x.astype(jnp.float32)
    contrib_x = jnp.concatenate(
        [jnp.zeros((1, w.shape[1]), jnp.float32), jnp.cumsum(wx, axis=0)])
    score = contrib_x[seg_j_off[1:]] - contrib_x[seg_j_off[:-1]]
    return ssum, score


def impute_dosages_device(segments: np.ndarray, n_targets: int,
                          Xref_nat: np.ndarray, kold_of_kref: np.ndarray,
                          ref_freq: np.ndarray, chunk: int = 512):
    """Device-weighted-vote imputation.

    segments: (nseg, 4) int32 rows (target j, donor jref, start, end) in
              frame coordinates, sorted by j
    Xref_nat: (Mref, Nref) uint8 reference alleles in natural order
    kold_of_kref: (Nref,) frame coordinate of each reference site (the kOld
                  the serial loop would hold at that site)
    ref_freq:  (Nref,) fallback allele frequency per site

    Returns (x, dosage, voted): (T, Nref) imputed alleles uint8, posterior
    f64, and the covered-by-any-match mask.
    """
    nseg = len(segments)
    T = n_targets
    Mref, Nref = Xref_nat.shape
    order = np.lexsort((segments[:, 2], segments[:, 0]))
    segs = segments[order]
    counts = np.bincount(segs[:, 0], minlength=T)
    off = np.zeros(T + 1, np.int32)
    np.cumsum(counts, out=off[1:])
    seg_jref = jnp.asarray(segs[:, 1].astype(np.int32))
    seg_s = jnp.asarray(segs[:, 2].astype(np.int32))
    seg_e = jnp.asarray(segs[:, 3].astype(np.int32))
    seg_off = jnp.asarray(off)
    Xd = jnp.asarray(np.ascontiguousarray(Xref_nat, np.uint8))
    kold = np.asarray(kold_of_kref, np.int32)

    dosage = np.empty((T, Nref), np.float64)
    voted = np.empty((T, Nref), bool)
    for c0 in range(0, Nref, chunk):
        c1 = min(c0 + chunk, Nref)
        width = c1 - c0
        pad = chunk - width
        kc = np.pad(kold[c0:c1], (0, pad))
        ssum, score = _impute_chunk_scores(
            seg_off, seg_jref, seg_s, seg_e,
            jnp.pad(Xd[:, c0:c1], ((0, 0), (0, pad))),
            jnp.asarray(kc), chunk)
        ssum = np.asarray(ssum[:, :width], np.float64)
        score = np.asarray(score[:, :width], np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            pj = score / ssum
        fallback = np.broadcast_to(ref_freq[c0:c1], (T, width))
        v = ssum > 0
        dosage[:, c0:c1] = np.where(v, pj, fallback)
        voted[:, c0:c1] = v
    x = (dosage > 0.5).astype(np.uint8)
    return x, dosage, voted
