"""Device engine: batched set-maximal query-vs-panel matching.

Algorithm 5 of Durbin (2014) restructured for a batched device scan: queries
become a batch dimension over vectorised FM-interval updates inside one
lax.scan over 32-site groups; the panel advances one ops/build.site_step per
site.  Interval collapses (rare) are compacted into fixed-width chunks and
re-anchored with fixed windows of gathered values; a single cond-gated
fallback of while_loops covers window overruns.

Reporting is transfer-minimal: per-site prefix-array snapshots stay in
device memory, collapse records are compacted on-device and fetched in one
transfer, and match ids come back through one device gather
(DeviceMatcher).  The portable path (match_scan) emits sorted columns and
expands ids on the host via the native C runtime instead.

Equivalent output to matchSequencesIndexed (pbwtMatch.c:255-340) and hence
the set of all set-maximal matches; algos/match.py re-orders it into the
sweep's exact report sequence for -matchDynamic stdout parity.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from .build import GROUP, gather_words, pack_group_words, site_step


def bitpack_rows(X: np.ndarray) -> np.ndarray:
    """(R, N) 0/1 -> (R, ceil(N/8)) uint8, bit 7 first."""
    return np.packbits(np.ascontiguousarray(X, np.uint8), axis=1)


def _getbit(packed: jnp.ndarray, row, col):
    """Read bit (row, col) from a row-bitpacked uint8 matrix."""
    byte = packed[row, col >> 3]
    return (byte >> (7 - (col & 7))) & 1


def pack_row_words(bits: np.ndarray) -> np.ndarray:
    """Row-bitpacked bytes (R, ceil(N/8)) -> little-endian uint32 words
    (R, ceil(N/32)) viewed as int32 (site j of a row lives in word j>>5,
    byte (j>>3)&3, bit 7-(j&7))."""
    R, nb = bits.shape
    pad = (-nb) % 4
    if pad:
        bits = np.concatenate([bits, np.zeros((R, pad), np.uint8)], axis=1)
    return np.ascontiguousarray(bits).view(np.int32)


def _last_mismatch_in_word(v):
    """Largest site index j' (0..31) within a xor word v with a set bit;
    undefined when v == 0."""
    hsb = 31 - jax.lax.clz(v)
    b = hsb >> 3                                   # highest nonzero byte
    bytev = (jax.lax.shift_right_logical(v, 8 * b)) & 0xFF
    ctz = 31 - jax.lax.clz(bytev & -bytev)
    return 8 * b + 7 - ctz


def _word_mask_below(r):
    """int32 mask of the bits of sites j' < r (r in 0..32) within a word."""
    full = (jnp.int32(1) << (8 * (r >> 3))) - 1
    part = jnp.where((r & 7) > 0,
                     (0xFF << (8 - (r & 7))) & 0xFF, 0)
    mask = full | (part << (8 * (r >> 3)))
    return jnp.where(r >= 32, jnp.int32(-1), mask)


@jax.jit
def match_scan(W: jnp.ndarray, query_cols: jnp.ndarray,
               xq_bits: jnp.ndarray, xp_bits: jnp.ndarray,
               xq_words: jnp.ndarray, xp_words: jnp.ndarray,
               a0: jnp.ndarray):
    """Scan over 32-site groups; returns per-site collapse records.

    W          (Ng, M) int32 packed panel group words (pack_group_words;
               pad sites beyond N are all-ones, which leave the panel state
               unchanged and never collapse queries padded with ones)
    query_cols (Ng*32, Q) uint8 query values per site (1 at pad sites)
    xq_bits    (Q, ceil(N/8)) query haplotypes, bit-packed
    xp_bits    (M, ceil(N/8)) panel haplotypes, bit-packed

    Returns (mask, e, f, g) all (Ng*32, Q) - collapse records holding the
    OLD interval - plus the final (e, f, g) carry for the k = N flush and
    the per-site sorted panel columns, bit-packed (Ng*32, ceil8(M)/8).
    """
    Ng, M = W.shape
    Q = query_cols.shape[1]
    M8 = ((M + 7) // 8) * 8
    shifts = jnp.array([7, 6, 5, 4, 3, 2, 1, 0], dtype=jnp.uint8)
    qpad = jnp.zeros(M8 - M, dtype=jnp.uint8)

    def reset_one(collapsed, xq_row, e, f1, g1, d_next, a_next, k):
        """Post-collapse (e, f, g) reset (pbwtMatch.c:309-320), one query."""
        e1 = d_next[jnp.minimum(f1, M)] - 1
        xe1 = _getbit(xq_bits, xq_row,
                      jnp.clip(e1, 0, xq_bits.shape[1] * 8 - 1))
        branch_a = (f1 == M) | ((f1 > 0) & (xe1 == 0))
        fsel = jnp.where(branch_a, g1 - 1, f1)
        ref_hap = a_next[jnp.clip(fsel, 0, M - 1)]

        # backward match extension: find the largest mismatch site j < e1
        # between query and ref_hap, 32 sites per step on packed words
        # (the reference walks one site per iteration, pbwtMatch.c:300-303)
        w0 = jnp.maximum(e1 - 1, 0) >> 5
        r0 = (jnp.maximum(e1 - 1, 0) & 31) + 1

        def wcond(state):
            widx, found, _ = state
            return collapsed & (e1 > 0) & (~found) & (widx >= 0)

        def wbody(state):
            widx, found, j = state
            v = xq_words[xq_row, widx] ^ xp_words[ref_hap, widx]
            v = jnp.where(widx == w0, v & _word_mask_below(r0), v)
            hit = v != 0
            j_new = jnp.where(hit, 32 * widx + _last_mismatch_in_word(v), j)
            return widx - 1, hit, j_new

        # carry init derives from varying inputs so the loop stays
        # well-typed under shard_map's manual-axes tracking
        _, found, j = jax.lax.while_loop(
            wcond, wbody, (w0, collapsed & False, jnp.full_like(w0, -1)))
        e1 = jnp.where(collapsed & (e1 > 0),
                       jnp.where(found, j + 1, 0), e1)

        def down_cond(fc):
            # fc >= 0 bound: unconditional termination (see _reset_windowed)
            return (collapsed & branch_a & (fc >= 0)
                    & (d_next[jnp.clip(fc, 0, M)] <= e1))

        def up_cond(gc):
            return (collapsed & (~branch_a) & (gc < M)
                    & (d_next[jnp.clip(gc, 0, M)] <= e1))

        f_new = jax.lax.while_loop(down_cond, lambda fc: fc - 1, fsel)
        g_new = jnp.where(branch_a, g1,
                          jax.lax.while_loop(up_cond, lambda gc: gc + 1,
                                             f1 + 1))
        f_new = jnp.where(branch_a, f_new, f1)
        return e1, f_new, g_new

    reset_batch = jax.vmap(reset_one, in_axes=(0, 0, 0, 0, 0, None, None,
                                               None))
    qrows = jnp.arange(Q, dtype=jnp.int32)

    def group_step(carry, xs):
        a, d, e, f, g, k = carry
        w_nat, qgrp = xs                       # (M,), (GROUP, Q)
        w = gather_words(w_nat, a)
        recs, ybits = [], []
        for s in range(GROUP):
            key = ((w >> s) & 1).astype(jnp.uint8)
            xk = qgrp[s]
            kk = jnp.asarray(k + s, d.dtype)
            a, d_core, w, u, c = site_step(a, d[:M], w, s, kk)
            u = jnp.concatenate([u, c[None]])    # u[M] = c
            f1 = jnp.where(xk != 0, c + f - u[f], u[f])
            g1 = jnp.where(xk != 0, c + g - u[g], u[g])
            collapsed = g1 <= f1
            recs.append((collapsed, e, f, g))
            ybits.append((jnp.concatenate([key, qpad]).reshape(M8 // 8, 8)
                          << shifts).sum(axis=1).astype(jnp.uint8))
            d = jnp.concatenate([d_core, (kk + 2)[None]])

            e_r, f_r, g_r = reset_batch(collapsed, qrows, e, f1, g1, d, a, kk)
            e = jnp.where(collapsed, e_r, e)
            f = jnp.where(collapsed, f_r, f1)
            g = jnp.where(collapsed, g_r, g1)
        mask_g, e_g, f_g, g_g = (jnp.stack([r[i] for r in recs])
                                 for i in range(4))
        return ((a, d, e, f, g, k + GROUP),
                (mask_g, e_g, f_g, g_g, jnp.stack(ybits)))

    a = a0
    d = jnp.zeros(M + 1, dtype=jnp.int32).at[0].set(1).at[M].set(1)
    # derive the per-query carries from query_cols so their varying manual
    # axes match the loop body under shard_map (no-op otherwise)
    e = (query_cols[0] * 0).astype(jnp.int32)
    f = e
    g = e + M
    qgrps = query_cols.reshape(Ng, GROUP, Q)
    (_, _, e_end, f_end, g_end, _), (mask, es, fs, gs, ybits) = jax.lax.scan(
        group_step, (a, d, e, f, g, jnp.int32(0)), (W, qgrps))
    flatten = lambda x: x.reshape((Ng * GROUP,) + x.shape[2:])
    return (flatten(mask), flatten(es), flatten(fs), flatten(gs),
            (e_end, f_end, g_end), flatten(ybits))


_WB = 4    # backward-extension window, 32-site words
_WW = 113  # interval-widening window, rows (two-row guaranteed span)
_RC = 128  # reset chunk width (see _site_reset)


def _u8_digit_planes(plane_i32):
    """(R, 128) int32 in [0, 2^24) -> (R, 384) uint8 base-256 digit planes:
    digit j of row-lane (r, l) lives at [r, 128*j + l]."""
    return jnp.concatenate([
        (plane_i32 & 0xFF).astype(jnp.uint8),
        ((plane_i32 >> 8) & 0xFF).astype(jnp.uint8),
        ((plane_i32 >> 16) & 0xFF).astype(jnp.uint8)], axis=1)


def _mxu_gather_u8planes(planes, idx):
    """planes (R, 384) uint8 digit planes; idx (K,) in [0, R*128).

    Single 1-pass bf16 one-hot matmul -> exact int32 values < 2^24.  The
    one-hot entries (0/1) and every base-256 digit (<= 255) are exactly
    representable in bf16, and each f32 accumulator sees exactly one
    nonzero product, so default matmul precision is exact here (an f32
    table through a lower-precision matmul would round values >= 2^8).
    """
    K = idx.shape[0]
    R = planes.shape[0]
    r = idx >> 7
    l = idx & 127
    oh = (r[:, None] == jax.lax.broadcasted_iota(jnp.int32, (K, R), 1)
          ).astype(jnp.bfloat16)
    rows = jax.lax.dot_general(oh, planes.astype(jnp.bfloat16),
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32)  # (K,384)
    li = jax.lax.broadcasted_iota(jnp.int32, (K, 384), 1)
    sel = (li & 127) == l[:, None]
    w = (jnp.int32(1) << (8 * (li >> 7))).astype(jnp.float32)
    return jnp.sum(jnp.where(sel, rows * w, 0.0), axis=1).astype(jnp.int32)


def _combine_digit_cols(rows_f32, c):
    """(n, 3c) f32 digit columns [low | mid | high] -> (n, c) int32."""
    n = rows_f32.shape[0]
    r3 = rows_f32.reshape(n, 3, c)
    return (r3[:, 0] + 256.0 * r3[:, 1] + 65536.0 * r3[:, 2]
            ).astype(jnp.int32)


def _digit_cols(vals_i32):
    """(n, c) int32 in [0, 2^24) -> (n, 3c) uint8 [low | mid | high]."""
    return jnp.concatenate([
        (vals_i32 & 0xFF).astype(jnp.uint8),
        ((vals_i32 >> 8) & 0xFF).astype(jnp.uint8),
        ((vals_i32 >> 16) & 0xFF).astype(jnp.uint8)], axis=1)


def _mxu_window_rows(planes, start):
    """Two-row contiguous window: two[k, l0[k] + t] = table[start[k] + t]
    for t >= 0 while start[k] + t stays inside the two fetched rows (span
    of at least _WW + 15 lanes).  planes (R, 384) uint8 digit planes of
    the table.  start may stick out of [0, R*128): under-range lanes read
    row 0 and over-range lanes read the last row - callers mask both with
    their own sentinels.  Returns (two (K, 256) int32, l0 (K,)).  One
    1-pass bf16 (2K, R) one-hot matmul (exact: see _mxu_gather_u8planes);
    no per-lane extraction loop (callers reduce the 256 lanes directly).
    """
    K = start.shape[0]
    R = planes.shape[0]
    start_eff = jnp.maximum(start, 0)
    under_off = start_eff - start            # >0 iff start < 0
    r0 = jnp.minimum(start_eff >> 7, R - 1)
    l0 = (start_eff & 127) - under_off       # lane offset, may be < 0
    rr = jnp.concatenate([r0, jnp.minimum(r0 + 1, R - 1)])
    oh = (rr[:, None] == jax.lax.broadcasted_iota(jnp.int32, (2 * K, R), 1)
          ).astype(jnp.bfloat16)
    rows = jax.lax.dot_general(oh, planes.astype(jnp.bfloat16),
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32)
    vals = _combine_digit_cols(rows, 128)                     # (2K, 128)
    two = jnp.concatenate([vals[:K], vals[K:]], axis=1)
    return two, l0


def _reset_windowed(op, xqf, xpf, NW, Mp):
    """Vectorised post-collapse (e, f, g) reset (pbwtMatch.c:309-320).

    Same semantics as the reference's three scalar scans, restructured as
    batched array code: d/a lookups ride 1-pass bf16 digit-plane one-hot
    matmuls (_mxu_gather_u8planes); the interval-widening walks are
    answered LOOP-FREE as range queries - the stop row comes from one
    masked max/argmax over the per-site d row maxima (drow), then one row
    fetch pins the lane - so a short new match whose interval spans
    thousands of panel rows costs the same as a width-1 interval.  Only the
    backward match extension keeps a cond-gated fallback loop, for
    (rare) extensions beyond the _WB-word window.
    """
    collapsed, e, f1, g1, d8, a8, drow, kk, qrows = op
    K = f1.shape[0]
    R = d8.shape[0]

    def dval_mxu(idx):
        v = _mxu_gather_u8planes(d8, jnp.clip(idx, 0, Mp - 1))
        return jnp.where(idx >= Mp, kk + 2, v)

    e1 = dval_mxu(f1) - 1
    jbit = jnp.clip(e1, 0, NW * 32 - 1)
    wq = xqf[qrows * NW + (jbit >> 5)]
    xe1 = (wq >> (8 * ((jbit >> 3) & 3) + 7 - (jbit & 7))) & 1
    branch_a = (f1 == Mp) | ((f1 > 0) & (xe1 == 0))
    fsel = jnp.where(branch_a, g1 - 1, f1)
    ref_hap = _mxu_gather_u8planes(a8, jnp.clip(fsel, 0, Mp - 1))

    # backward match extension on packed words, windowed
    base = jnp.maximum(e1 - 1, 0)
    w0 = base >> 5
    r0 = (base & 31) + 1
    jj = jnp.arange(_WB, dtype=jnp.int32)
    widx = w0[:, None] - jj[None, :]
    wi = jnp.maximum(widx, 0)
    v = xqf[qrows[:, None] * NW + wi] ^ xpf[ref_hap[:, None] * NW + wi]
    v = jnp.where(widx == w0[:, None], v & _word_mask_below(r0)[:, None], v)
    v = jnp.where(widx >= 0, v, 0)
    hit = v != 0
    found_w = jnp.any(hit, axis=1)
    firstj = jnp.argmax(hit, axis=1)
    vsel = jnp.take_along_axis(v, firstj[:, None], axis=1)[:, 0]
    j_w = 32 * (w0 - firstj) + _last_mismatch_in_word(vsel)
    active = collapsed & (e1 > 0)
    pend_bw = active & ~found_w & (w0 - _WB >= 0)
    e1_win = jnp.where(active, jnp.where(found_w, j_w + 1, 0), e1)

    def bw_fallback(_):
        def wcond(st):
            wx, found, _ = st
            return jnp.any(pend_bw & ~found & (wx >= 0))

        def wbody(st):
            wx, found, j = st
            wc = jnp.maximum(wx, 0)
            vv = xqf[qrows * NW + wc] ^ xpf[ref_hap * NW + wc]
            vv = jnp.where(wx >= 0, vv, 0)
            h = pend_bw & ~found & (vv != 0)
            j = jnp.where(h, 32 * wx + _last_mismatch_in_word(vv), j)
            return wx - 1, found | h, j

        _, fnd, j2 = jax.lax.while_loop(
            wcond, wbody,
            (w0 - _WB, jnp.zeros_like(pend_bw), jnp.zeros_like(w0)))
        return jnp.where(pend_bw, jnp.where(fnd, j2 + 1, 0), e1_win)

    e1 = jax.lax.cond(jnp.any(pend_bw), bw_fallback, lambda _: e1_win, 0)

    # loop-free widening (down: largest p <= fsel with d[p] > e1; up:
    # smallest p >= f1+1 with p == Mp or d[p] > e1).  In-window part: a
    # row-ALIGNED two-row d window around the walk start; beyond it, the
    # stop row is the nearest row whose max d exceeds e1 (drow broadcast +
    # masked max/argmax), and one fetch of that row pins the exact lane.
    # Down always terminates inside this (d[0] is the kk+2 sentinel and
    # e1 <= kk+1 ⇒ row 0 always qualifies); up defaults to Mp.
    li = jax.lax.broadcasted_iota(jnp.int32, (K, 256), 1)
    ri = jax.lax.broadcasted_iota(jnp.int32, (K, R), 1)
    drow_b = jnp.broadcast_to(drow[None, :], (K, R))
    r_f = jnp.clip(fsel, 0, Mp - 1) >> 7
    r_u = jnp.minimum(f1 + 1, Mp - 1) >> 7
    # nearest qualifying row below r_f-1 / above r_u+1
    maskrd = (ri <= r_f[:, None] - 2) & (drow_b > e1[:, None])
    found_rd = jnp.any(maskrd, axis=1)
    r_dsel = jnp.maximum(jnp.max(jnp.where(maskrd, ri, -1), axis=1), 0)
    maskru = (ri >= r_u[:, None] + 2) & (drow_b > e1[:, None])
    found_ru = jnp.any(maskru, axis=1)
    r_usel = jnp.argmax(maskru, axis=1)
    # one fused fetch: the two aligned in-windows + the two stop rows
    startd = (r_f - 1) * 128
    startu = r_u * 128
    twod, l0d = _mxu_window_rows(d8, startd)
    twou, l0u = _mxu_window_rows(d8, startu)
    tworr, _ = _mxu_window_rows(d8, jnp.concatenate([r_dsel, r_usel]) * 128)
    vrow_d, vrow_u = tworr[:K, :128], tworr[K:, :128]
    # down in-window: rows r_f-1, r_f (aligned ⇒ posd = startd + li - l0d)
    posd = startd[:, None] + li - l0d[:, None]
    vald = jnp.where(posd <= 0, kk + 2, twod)
    maskd = (posd >= 0) & (posd <= fsel[:, None]) & (vald > e1[:, None])
    found_in_d = jnp.any(maskd, axis=1)
    f_in = startd + jnp.max(jnp.where(maskd, li, -1), axis=1) - l0d
    lrow = li[:, :128]
    mrow_d = vrow_d > e1[:, None]
    f_row = r_dsel * 128 + jnp.max(jnp.where(mrow_d, lrow, 0), axis=1)
    f_down = jnp.where(found_in_d, f_in, f_row)
    # up in-window: rows r_u, r_u+1; p >= Mp reads the sentinel ⇒ halts
    # at Mp itself
    posu = startu[:, None] + li - l0u[:, None]
    valu = jnp.where(posu >= Mp, kk + 2, twou)
    masku = (posu >= f1[:, None] + 1) & (valu > e1[:, None])
    found_in_u = jnp.any(masku, axis=1)
    g_in = startu + jnp.argmax(masku, axis=1) - l0u
    mrow_u = vrow_u > e1[:, None]
    g_row = jnp.where(jnp.any(mrow_u, axis=1),
                      r_usel * 128 + jnp.argmax(mrow_u, axis=1),
                      Mp)
    g_up = jnp.where(found_in_u, g_in,
                     jnp.where(found_ru, g_row, Mp))

    f_new = jnp.where(branch_a, f_down, f1)
    g_new = jnp.where(branch_a, g1, g_up)
    return (jnp.where(collapsed, e1, e),
            jnp.where(collapsed, f_new, f1),
            jnp.where(collapsed, g_new, g1))


def _site_reset(op, xqf, xpf, NW, Mp, recbuf, rcount):
    """Reset dispatcher + in-scan record emitter: compact the collapsed
    lanes into fixed _RC-wide chunks and run the windowed reset once per
    chunk inside a while_loop, so every reset - whatever the per-site
    collapse count - executes at the same narrow width, with one traced
    copy of _reset_windowed (a full-width branch would be a second,
    much larger copy to compile and to run on bursty sites).  The typical
    site needs exactly one chunk.

    Each chunk also appends its compacted collapse records
    (si = kk*Q + q, e_old, f_old, g_old) to ``recbuf`` at ``rcount`` -
    site-major, query order - so nothing sorts the full (Ns, Q) grid to
    find them.
    Overflow clamps the write inside the buffer and is detected by the
    caller as final rcount > cap - _RC.

    Compaction and write-back are 1-pass bf16 (Q, _RC) one-hot matmuls
    over base-256 digit columns (exact: see _mxu_gather_u8planes).

    Returns (e, f, g, recbuf, rcount')."""
    collapsed, e, f1, g1, fold, gold, d8, a8, drow, kk, qrows = op
    Q = collapsed.shape[0]
    CAP = recbuf.shape[0]
    pos = jnp.cumsum(collapsed.astype(jnp.int32)) - 1
    ncol = pos[-1] + 1
    nchunk = (ncol + _RC - 1) // _RC
    rc_iota = jax.lax.broadcasted_iota(jnp.int32, (Q, _RC), 1)
    cpos = jnp.where(collapsed, pos, -1)
    ones = jnp.ones_like(qrows)

    def body(st):
        t, e, f, g, recbuf = st
        base = t * _RC
        # one-hot (Q, _RC): query q owns compact lane pos[q] - base
        ohc = ((cpos - base)[:, None] == rc_iota).astype(jnp.bfloat16)
        # one stacked digit-column matmul compacts all seven vectors
        vs = _digit_cols(jnp.stack([ones, qrows, e, f, g, fold, gold],
                                   axis=1))
        comp = _combine_digit_cols(jax.lax.dot_general(
            ohc, vs.astype(jnp.bfloat16), (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32), 7)           # (_RC, 7)
        valid = comp[:, 0] > 0
        lane, e_c, f_c, g_c = comp[:, 1], comp[:, 2], comp[:, 3], comp[:, 4]
        rec_rows = jnp.stack([jnp.where(valid, kk * Q + lane, -1),
                              e_c, comp[:, 5], comp[:, 6]], axis=1)
        recbuf = jax.lax.dynamic_update_slice(
            recbuf, rec_rows,
            (jnp.minimum(rcount + base, CAP - _RC), jnp.int32(0)))
        e2, f2, g2 = _reset_windowed(
            (valid, e_c, f_c, g_c, d8, a8, drow, kk, lane), xqf, xpf,
            NW, Mp)
        upd = _combine_digit_cols(jax.lax.dot_general(
            ohc, _digit_cols(jnp.stack([e2, f2, g2], axis=1)
                             ).astype(jnp.bfloat16),
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32), 3)           # (Q, 3)
        sel = (cpos >= base) & (cpos < base + _RC)
        return (t + 1, jnp.where(sel, upd[:, 0], e),
                jnp.where(sel, upd[:, 1], f), jnp.where(sel, upd[:, 2], g),
                recbuf)

    _, e, f, g, recbuf = jax.lax.while_loop(
        lambda st: st[0] < nchunk, body, (jnp.int32(0), e, f1, g1, recbuf))
    return e, f, g, recbuf, rcount + ncol


@jax.jit
def match_scan_segment(W: jnp.ndarray, qcols: jnp.ndarray,
                       xq_words: jnp.ndarray, xp_words: jnp.ndarray,
                       carry):
    """One segment of the device sweep (algorithm-5 interval machinery).

    The panel advances one ops/build.site_step per site; queries ride as a
    batch with pure FM interval maps per site and windowed resets on the
    (rare) collapses.  Emits the pre-site prefix arrays to device memory so
    match ids are expanded on-device afterwards - nothing large ever
    crosses to the host.

    W (Ngs, Mp) packed group words (pad sites all-zero = identity steps);
    qcols (Ngs*32, Q) query alleles (0 at pad sites);
    xq_words (Q, NW) / xp_words (Mp, NW) row-packed haplotype words;
    carry = (a, d, e, f, g, k, recbuf, rcount) with k the global site
    index and recbuf/rcount the cross-segment record buffer (records are
    (si = k*Q + q global, e_old, f_old, g_old), emitted compacted during
    the scan - see _site_reset).
    Returns (carry', asnaps (Ns, Mp)).
    """
    Ngs, Mp = W.shape
    Q = qcols.shape[1]
    R = Mp // 128
    NW = xq_words.shape[1]
    xqf = xq_words.reshape(-1)
    xpf = xp_words.reshape(-1)
    qrows = jnp.arange(Q, dtype=jnp.int32)
    s_iota = jnp.arange(GROUP, dtype=jnp.int32)

    def do_reset(op):
        collapsed, e, f1, g1, fold, gold, d2, a2, kk, recbuf, rcount = op
        dR = d2.reshape(R, 128)
        return _site_reset((collapsed, e, f1, g1, fold, gold,
                            _u8_digit_planes(dR),
                            _u8_digit_planes(a2.reshape(R, 128)),
                            jnp.max(dR, axis=1), kk, qrows),
                           xqf, xpf, NW, Mp, recbuf, rcount)

    def group_step(carry, xs):
        a, d, e, f, g, k, recbuf, rcount = carry
        w_nat, qgrp = xs

        def site(st, sxs):
            a, d, w, e, f, g, recbuf, rcount = st
            s, xk = sxs
            kk = k + s
            a2, d2, w2, u, c = site_step(a, d, w, s, kk)
            fg = jnp.concatenate([f, g])
            # FM interval step: 2Q rank lookups per site
            ufg = jnp.where(fg == Mp, c,
                            _mxu_gather_u8planes(
                                _u8_digit_planes(u.reshape(R, 128)),
                                jnp.minimum(fg, Mp - 1)))
            fg1 = jnp.where(jnp.concatenate([xk, xk]) != 0,
                            c + fg - ufg, ufg)
            f1, g1 = fg1[:Q], fg1[Q:]
            collapsed = g1 <= f1
            e, f, g, recbuf, rcount = jax.lax.cond(
                jnp.any(collapsed), do_reset,
                lambda op: (op[1], op[2], op[3], op[-2], op[-1]),
                (collapsed, e, f1, g1, f, g, d2, a2, kk, recbuf, rcount))
            return (a2, d2, w2, e, f, g, recbuf, rcount), a

        st0 = (a, d, gather_words(w_nat, a), e, f, g, recbuf, rcount)
        (a, d, _, e, f, g, recbuf, rcount), snaps_g = \
            jax.lax.scan(site, st0, (s_iota, qgrp))
        return (a, d, e, f, g, k + GROUP, recbuf, rcount), snaps_g

    qgrps = qcols.reshape(Ngs, GROUP, Q)
    carry, snaps = jax.lax.scan(group_step, carry, (W, qgrps))
    flatten = lambda x: x.reshape((Ngs * GROUP,) + x.shape[2:])
    return carry, flatten(snaps)


@jax.jit
def panel_trajectory(W: jnp.ndarray, a0: jnp.ndarray, d0: jnp.ndarray):
    """Precompute the per-site panel tables the query machinery consumes.

    The panel state evolution (prefix array, divergence array, FM rank
    table) depends only on the panel, so a standing DeviceMatcher computes
    it ONCE at panel-upload time and leaves the per-site tables in device
    memory; every subsequent query batch replays a pure query-machinery
    scan against the stored tables (match_scan_indexed) instead of
    re-running the panel advance per call.  This is the device analogue of
    the reference's index-once/query-many structure (matchSequencesIndexed,
    pbwtMatch.c:255-340, whose per-query loop reads the prebuilt u/a/d
    cursors of one forward pass).

    W (Ng, Mp) packed group words; a0/d0 the initial prefix/divergence
    arrays.  Returns (a_end, A_pre (Ns, Mp), D8 (Ns, R, 384),
    DR (Ns, R), U8 (Ns, R, 384), C (Ns,)) with Ns = Ng*32: per site, the
    pre-site prefix array (the id snapshot), the post-site divergence
    array and rank table as base-256 uint8 digit planes (the layout the
    1-pass bf16 one-hot gathers consume, 3 bytes/hap-site each), the
    per-row d maxima (the loop-free widening queries in _reset_windowed)
    and the zero count.
    """
    Ng, Mp = W.shape
    R = Mp // 128
    s_iota = jnp.arange(GROUP, dtype=jnp.int32)

    def group_step(carry, w_nat):
        a, d, k = carry

        def site(st, s):
            a, d, w = st
            a2, d2, w2, u, c = site_step(a, d, w, s, k + s)
            dR = d2.reshape(R, 128)
            return ((a2, d2, w2),
                    (a, _u8_digit_planes(dR), jnp.max(dR, axis=1),
                     _u8_digit_planes(u.reshape(R, 128)), c))

        (a, d, _), (snaps, d8, dr, u8, c) = jax.lax.scan(
            site, (a, d, gather_words(w_nat, a)), s_iota)
        return (a, d, k + GROUP), (snaps, d8, dr, u8, c)

    (a, _, _), (A, D8, DR, U8, C) = jax.lax.scan(
        group_step, (a0, d0, jnp.int32(0)), W)
    flat = lambda x: x.reshape((Ng * GROUP,) + x.shape[2:])
    return a, flat(A), flat(D8), flat(DR), flat(U8), flat(C)


@functools.partial(jax.jit, static_argnames=("cap",))
def match_scan_indexed(U8, D8, DR, A_all, C, qcols, xq_words, xp_words,
                       e, f, g, cap=1 << 17):
    """Query-only sweep against a precomputed panel trajectory.

    The panel advance is gone (panel_trajectory ran it once); per site the
    scan streams one rank-table digit-plane row from device memory for the
    1-pass bf16 one-hot interval update, and the divergence/rowmax/prefix
    rows are dynamically sliced ONLY inside the collapse branch, so the
    (rare) resets are the only reads of D8/DR/A.

    Collapse records (si = k*Q + q, e_old, f_old, g_old) are emitted
    compacted into a (cap, 4) buffer DURING the scan (see _site_reset) -
    no per-site (Ns, Q) outputs, no post-hoc sort.

    U8/D8 (Ns, R, 384) uint8 digit planes; DR (Ns, R) per-site d row
    maxima; A_all (Ns+1, Mp) with A_all[k] the pre-site-k prefix array
    and A_all[Ns] the final one; C (Ns,); qcols (Ns, Q).
    Returns ((e, f, g) flush carry, recbuf (cap, 4), nrec); the record
    buffer overflowed iff nrec > cap - _RC (caller re-runs with a larger
    cap).
    """
    Ns, Mp = A_all.shape[0] - 1, A_all.shape[1]
    Q = qcols.shape[1]
    NW = xq_words.shape[1]
    xqf = xq_words.reshape(-1)
    xpf = xp_words.reshape(-1)
    qrows = jnp.arange(Q, dtype=jnp.int32)
    kks = jnp.arange(Ns, dtype=jnp.int32)
    recbuf0 = jnp.full((cap, 4), -1, jnp.int32)

    def query_step(carry, u8, c, xk, kk):
        e, f, g, recbuf, rcount = carry
        fg = jnp.concatenate([f, g])
        ufg = jnp.where(fg == Mp, c,
                        _mxu_gather_u8planes(u8, jnp.minimum(fg, Mp - 1)))
        fg1 = jnp.where(jnp.concatenate([xk, xk]) != 0, c + fg - ufg, ufg)
        f1, g1 = fg1[:Q], fg1[Q:]
        collapsed = g1 <= f1

        def do_reset(op):
            collapsed, e, f1, g1, fold, gold, recbuf, rcount, kk = op
            d8 = jax.lax.dynamic_slice_in_dim(D8, kk, 1)[0]
            drow = jax.lax.dynamic_slice_in_dim(DR, kk, 1)[0]
            aflat = jax.lax.dynamic_slice_in_dim(A_all, kk + 1, 1)[0]
            a8 = _u8_digit_planes(aflat.reshape(-1, 128))
            return _site_reset((collapsed, e, f1, g1, fold, gold, d8, a8,
                                drow, kk, qrows), xqf, xpf, NW, Mp,
                               recbuf, rcount)

        e, f, g, recbuf, rcount = jax.lax.cond(
            jnp.any(collapsed), do_reset,
            lambda op: (op[1], op[2], op[3], op[6], op[7]),
            (collapsed, e, f1, g1, f, g, recbuf, rcount, kk))
        return (e, f, g, recbuf, rcount)

    # UNROLL sites per scan step: a loop iteration whose body holds dynamic
    # slices + a cond has a fixed overhead far above one site's work at
    # small Q; UNROLL must divide GROUP (Ns is always Ng*GROUP)
    UNROLL = 8
    assert Ns % UNROLL == 0, Ns
    Ng2 = Ns // UNROLL

    def group_step(carry, xs):
        u8g, cg, xkg, kkg = xs
        for s in range(UNROLL):
            carry = query_step(carry, u8g[s], cg[s], xkg[s], kkg[s])
        return carry, None

    (e, f, g, recbuf, nrec), _ = jax.lax.scan(
        group_step, (e, f, g, recbuf0, jnp.int32(0)),
        (U8.reshape((Ng2, UNROLL) + U8.shape[1:]),
         C.reshape(Ng2, UNROLL), qcols.reshape(Ng2, UNROLL, Q),
         kks.reshape(Ng2, UNROLL)))
    return (e, f, g), recbuf, nrec


_REC_CAP = 1 << 17   # default collapse-record buffer rows (2 MB)


@jax.jit
def _pack_flush(e, f, g, nrec):
    """One-transfer scan tail: [nrec, e|f|g flush carry]."""
    return jnp.concatenate([jnp.atleast_1d(nrec), e, f, g])


@functools.partial(jax.jit, static_argnames=("ns",))
def _qcols_from_words(xq_words, ns):
    """Derive the (Ns, Q) per-site query allele columns ON DEVICE from the
    row-packed words (pack_row_words layout: site j lives in word j>>5 at
    bit 8*((j>>3)&3) + 7-(j&7)).  Site k of every query reads the same
    word/bit, so the word index is the static pattern repeat(arange(NW),
    32) — a reshape, not a gather.  The packed words are 1/8 the bytes of
    dense qcols and are uploaded anyway for the resets."""
    NW = xq_words.shape[1]
    Q = xq_words.shape[0]
    take = min(ns, NW * 32)
    wt = jnp.repeat(xq_words.T, 32, axis=0)[:take]        # (take, Q)
    j = jnp.arange(take, dtype=jnp.int32)
    shift = (8 * ((j >> 3) & 3) + 7 - (j & 7))[:, None]
    out = ((wt >> shift) & 1).astype(jnp.uint8)
    if ns > take:                       # segment padding beyond the words
        out = jnp.concatenate([out, jnp.zeros((ns - take, Q), jnp.uint8)])
    return out


@jax.jit
def _pack_flush_total(e, f, g, nrec, recbuf):
    """Tiny scan tail: [nrec, total expanded rows].  total counts every
    record's interval width plus the k=N flush widths, so the caller can
    size the device expansion bucket with one small fetch."""
    cap = recbuf.shape[0]
    ridx = jnp.arange(cap, dtype=jnp.int32)
    w = jnp.where(ridx < nrec,
                  jnp.clip(recbuf[:, 3] - recbuf[:, 2], 0, None), 0)
    total = w.sum() + jnp.clip(g - f, 0, None).sum()
    return jnp.stack([nrec, total])


@functools.partial(jax.jit, static_argnames=("n_sites", "tpad"))
def _expand_rows_device(A_all, recbuf, nrec, e, f, g, n_sites, tpad):
    """Expand collapse records + the k=N flush into output rows ON DEVICE.

    Returns (tpad, 4) int32 rows (q, panel_hap, e, k) in record order
    (site-major records, then flush rows), with q = -1 on padding beyond
    the true total.  One fetch of the final rows replaces three host round
    trips (fetch records, upload gather indices, fetch ids).

    The flush is appended as Q virtual records with si = Ns*Q + q, whose
    k = si // Q = Ns indexes A_all's final row; the emitted k column
    reports n_sites (= N) for them — the k = N semantics of the sweep's
    end flush (pbwtMatch.c:430-436)."""
    Q = e.shape[0]
    Ns, Mp = A_all.shape[0] - 1, A_all.shape[1]
    cap = recbuf.shape[0]
    si_fl = Ns * Q + jnp.arange(Q, dtype=jnp.int32)
    fl = jnp.stack([si_fl, e, f, g], axis=1)
    allrec = jnp.concatenate([recbuf, fl])               # (cap + Q, 4)
    ridx = jnp.arange(cap + Q, dtype=jnp.int32)
    active = (ridx < nrec) | (ridx >= cap)
    w = jnp.where(active,
                  jnp.clip(allrec[:, 3] - allrec[:, 2], 0, None), 0)
    incl = jnp.cumsum(w)
    offs = incl - w                                      # exclusive
    total = incl[-1]
    # row -> record map: scatter each nonempty record's allrec INDEX at
    # its start offset, cumulative max (record starts are strictly
    # increasing in both offset and index, so the running max at row t is
    # exactly the record covering t); rows before the first record stay
    # -1, rows past `total` inherit the last record — both masked below
    nz = (w > 0) & (offs < tpad)
    marks = jnp.full(tpad, -1, jnp.int32).at[
        jnp.where(nz, offs, tpad - 1)].max(jnp.where(nz, ridx, -1))
    r = jax.lax.associative_scan(jnp.maximum, marks)
    rows_t = jnp.arange(tpad, dtype=jnp.int32)
    rc = jnp.clip(r, 0, cap + Q - 1)
    rec = allrec[rc]                                     # (tpad, 4)
    off_in = rows_t - offs[rc]
    k = rec[:, 0] // Q
    q = rec[:, 0] - k * Q
    # 2-D index: a flat one overflows int32 once (Ns+1)*Mp >= 2^31
    ids = A_all[jnp.clip(k, 0, Ns), jnp.clip(rec[:, 2] + off_in, 0, Mp - 1)]
    valid = (rows_t < total) & (r >= 0)
    k_out = jnp.where(rc >= cap, n_sites, k)
    return jnp.stack([jnp.where(valid, q, -1), ids, rec[:, 1], k_out],
                     axis=1)


@jax.jit
def _gather_two(t1, idx1, t2, idx2):
    """Two flat gathers fetched as one transfer."""
    return jnp.concatenate([t1.reshape(-1)[idx1], t2.reshape(-1)[idx2]])


@jax.jit
def _panel_words_from_bits(xp_bits_padded: jnp.ndarray):
    """(Mp, 4*Ng) bit-packed rows -> (Ng, Mp) int32 group words on device.

    Bytes pack sites MSB-first (numpy packbits); the group word wants site
    32t+s at bit s, so each byte is bit-reversed with three SWAR rounds.
    Pad sites beyond N are 0 bits = all-zero columns (identity partitions).
    """
    Mp, nb = xp_bits_padded.shape
    v = jax.lax.bitcast_convert_type(
        xp_bits_padded.reshape(Mp, nb // 4, 4), jnp.int32)   # (Mp, Ng)
    c = lambda x: jnp.asarray(np.int32(np.uint32(x)))
    sr = jax.lax.shift_right_logical
    v = sr(v & c(0xF0F0F0F0), 4) | ((v & c(0x0F0F0F0F)) << 4)
    v = sr(v & c(0xCCCCCCCC), 2) | ((v & c(0x33333333)) << 2)
    v = sr(v & c(0xAAAAAAAA), 1) | ((v & c(0x55555555)) << 1)
    return v.T                                               # (Ng, Mp)


def match_queries_device(Xp: np.ndarray, Xq: np.ndarray):
    """Set-maximal matches of queries Xq (Q, N) against panel Xp (M, N).

    Returns rows (q, panel_hap, start, end) in (site, query) report order -
    the same set as matchSequencesIndexed. Device does the O(N(M+Q)) state
    evolution; the host expands intervals to ids with one native C pass
    over the device-emitted sorted columns.

    Panels of more than 512 haplotypes go to a one-shot DeviceMatcher when
    the device engine is requested (ops.device_requested): its ids are
    expanded on device and its per-site tables stay there.
    """
    from .. import ops
    if Xp.shape[0] > 512 and ops.device_requested():
        return DeviceMatcher(Xp).match(Xq)
    from ..core import engine, native
    M, N = Xp.shape
    Q = Xq.shape[0]
    # NB no haplotype padding: pad rows would join match intervals and leak
    # phantom ids into reports. Pad sites (all-ones words + all-ones query
    # values) are no-ops: f/g/e are unchanged and nothing collapses.
    cols = native.transpose_u8(np.ascontiguousarray(Xp, np.uint8))
    if cols is None:
        cols = np.ascontiguousarray(Xp.T, dtype=np.uint8)
    W = pack_group_words(cols)
    Np = W.shape[0] * GROUP
    qcols = np.ones((Np, Q), dtype=np.uint8)
    qcols[:N] = Xq.T
    xp_bits = bitpack_rows(Xp)
    xq_bits = bitpack_rows(Xq)
    a0 = jnp.arange(M, dtype=jnp.int32)
    mask, es, fs, gs, flush, ybits = match_scan(
        jnp.asarray(W), jnp.asarray(qcols), jnp.asarray(xq_bits),
        jnp.asarray(xp_bits), jnp.asarray(pack_row_words(xq_bits)),
        jnp.asarray(pack_row_words(xp_bits)), a0)
    mask = np.asarray(mask)[:N]
    es = np.asarray(es)[:N]
    fs = np.asarray(fs)[:N]
    gs = np.asarray(gs)[:N]
    ybits_h = np.ascontiguousarray(np.asarray(ybits)[:N])
    e_end, f_end, g_end = (np.asarray(x) for x in flush)

    # flatten records in (site, query) order; append the k = N flush row
    ks, qs = np.nonzero(mask)
    rec_q = np.concatenate([qs, np.arange(Q)]).astype(np.int32)
    rec_e = np.concatenate([es[ks, qs], e_end]).astype(np.int32)
    rec_f = np.concatenate([fs[ks, qs], f_end]).astype(np.int32)
    rec_g = np.concatenate([gs[ks, qs], g_end]).astype(np.int32)
    rec_k = np.concatenate([ks, np.full(Q, N)])
    rec_off = np.zeros(N + 2, dtype=np.int64)
    np.add.at(rec_off, rec_k + 1, 1)
    rec_off = np.cumsum(rec_off)
    total = int((rec_g.astype(np.int64) - rec_f).clip(min=0).sum())

    lib = native.get_lib()
    if lib is not None:
        out = np.empty((max(total, 1), 4), dtype=np.int32)
        n = lib.expand_records(ybits_h.reshape(-1), ybits_h.shape[1], M, N,
                               rec_off, rec_q, rec_e, rec_f, rec_g,
                               out.reshape(-1), total)
        assert n == total
        return out[:total].copy()

    Ysort = np.unpackbits(ybits_h, axis=1)[:, :M]
    rows: list[tuple[int, int, int, int]] = []
    a = np.arange(M, dtype=np.int32)
    for k in range(N + 1):
        for r in range(int(rec_off[k]), int(rec_off[k + 1])):
            for i in range(int(rec_f[r]), int(rec_g[r])):
                rows.append((int(rec_q[r]), int(a[i]), int(rec_e[r]), k))
        if k < N:
            a = engine.forwards_a(a, Ysort[k])
    return np.asarray(rows, np.int32).reshape(-1, 4)


def _pow2_pad(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def device_bytes_limit() -> int:
    """Bytes the default device lets this process allocate: the allocator's
    ``bytes_limit``, or the host's physical memory for a CPU device (which
    reports no memory stats)."""
    stats = jax.devices()[0].memory_stats()
    if stats and "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def memory_budgets(bytes_limit: int) -> tuple[int, int]:
    """(trajectory, snapshot) byte budgets for a device of ``bytes_limit``.

    Half of the device holds a standing panel's trajectory: its three
    per-site tables (prefix i32, divergence and rank as u8 digit planes:
    11 bytes per hap-site) plus headroom for the trajectory build's copy
    of the prefix table and the per-call query scan.  A sixteenth holds
    one segment's prefix-array snapshots on the segment path, capped so
    that flat int32 indices into the snapshots cannot overflow.
    """
    return bytes_limit // 2, min(bytes_limit // 16, 4 << 31)


class DeviceMatcher:
    """Standing-panel device matcher.

    Uploads the bit-packed panel once (the panel payload is the only large
    host->device transfer; group words and row words are derived on device)
    and then serves query batches.  When the panel's trajectory fits the
    trajectory budget (memory_budgets), the per-site panel tables are
    computed once and every batch is one query scan against them;
    otherwise each call runs the panel advance in fixed-size site segments
    leaving the per-site prefix arrays on device.  Either way collapse
    records are compacted on device and match ids come back through one
    device gather - only O(records) bytes cross to the host.

    ``traj_bytes`` overrides the derived trajectory budget (0 forces the
    segment path).
    """

    def __init__(self, Xp: np.ndarray, traj_bytes: int | None = None):
        from ..core import native
        M, N = Xp.shape
        self._shape_init(M, N, traj_bytes)
        xp_bits = bitpack_rows(Xp)
        nb = 4 * self.Ng
        # pad rows with duplicates of row 0 (invisible to set-maximal
        # structure; ids >= M filtered from reports); pad site bytes zero
        xp_pad = native.pooled_view((self.Mp, nb), np.uint8, "match:xp_pad")
        xp_pad[:] = 0
        xp_pad[:M, :xp_bits.shape[1]] = xp_bits
        xp_pad[M:] = xp_pad[0]
        self._finish_init(jnp.asarray(xp_pad))

    @classmethod
    def from_pbwt(cls, p, chunk_sites: int = 512,
                  traj_bytes: int | None = None):
        """Build the matcher straight from a packed PBWT, streaming the
        pack3 stream in site chunks — peak host memory O(M * chunk), the
        reference's own cursor memory model (pbwtCore.c:527-585) — instead
        of materialising the (M, N) haplotype matrix (2 GB dense on the
        README's 100k x 20k panel).  The device payload (bit-packed rows)
        is assembled chunk-by-chunk on device."""
        from ..core import native
        self = cls.__new__(cls)
        M, N = p.M, p.N
        self._shape_init(M, N, traj_bytes)
        Mp, nb = self.Mp, 4 * self.Ng
        a = np.ascontiguousarray(
            p.aFstart if p.aFstart is not None
            else np.arange(M, dtype=np.int32), np.int32)
        chunk_sites = max(8 * ((chunk_sites + 7) // 8), 8)  # byte-aligned
        pos = 0
        parts = []
        for k0 in range(0, N, chunk_sites):
            nc = min(chunk_sites, N - k0)
            out = native.natural_cols(p.yz, nc, M, a, start=pos,
                                      with_pos=True)
            if out is None:               # no native lib: dense fallback
                return cls(p.haplotypes(), traj_bytes)
            Xc, a, _, pos = out
            bits = np.packbits(native.transpose_u8(Xc), axis=1)  # (M, nc/8)
            pad = np.empty((Mp, bits.shape[1]), np.uint8)
            pad[:M] = bits
            pad[M:] = bits[0]
            parts.append(jnp.asarray(pad))
        nb_have = sum(int(x.shape[1]) for x in parts)
        if nb_have < nb:
            parts.append(jnp.zeros((Mp, nb - nb_have), jnp.uint8))
        self._finish_init(jnp.concatenate(parts, axis=1))
        return self

    def _shape_init(self, M: int, N: int, traj_bytes: int | None) -> None:
        from .build import pad_to
        self.M, self.N = M, N
        # the (R, 128) digit planes of the one-hot gathers need Mp % 128 == 0
        self.Mp = Mp = pad_to(M, 128)
        self.Ng = Ng = (N + GROUP - 1) // GROUP
        traj_budget, snap_bytes = memory_budgets(device_bytes_limit())
        self.traj_bytes = traj_budget if traj_bytes is None else traj_bytes
        self.gseg = min(max(snap_bytes // (4 * Mp * GROUP), 1), Ng)
        self.nseg = -(-Ng // self.gseg)
        # per-query-width record-buffer sizing learned across calls:
        # {Q: (cap, fetch-head hint)}
        self._qstate: dict = {}

    def _finish_init(self, xp_pad_d) -> None:
        """Derive the device panel state from the (Mp, nb) bit-packed
        rows: group words, row words and (budget permitting) the standing
        trajectory."""
        Mp, Ng = self.Mp, self.Ng
        nb = 4 * Ng
        self.xp_words = jax.lax.bitcast_convert_type(
            xp_pad_d.reshape(Mp, nb // 4, 4), jnp.int32)
        self.W_all = _panel_words_from_bits(xp_pad_d)
        self.nw = nb // 4

        # standing-panel trajectory: 11 bytes/hap-site of device tables
        # buys query batches that never re-run the panel advance
        self.traj = None
        if 11 * Mp * (Ng * GROUP + 1) <= self.traj_bytes:
            a0 = jnp.arange(Mp, dtype=jnp.int32)
            d0 = jnp.zeros(Mp, dtype=jnp.int32).at[0].set(1)
            a_end, A_pre, D8, DR, U8, C = panel_trajectory(self.W_all,
                                                           a0, d0)
            self.traj = (jnp.concatenate([A_pre, a_end[None]]), D8, DR,
                         U8, C)
        elif self.nseg * self.gseg > Ng:
            self.W_all = jnp.concatenate(
                [self.W_all,
                 jnp.zeros((self.nseg * self.gseg - Ng, Mp), jnp.int32)])

    def _match_indexed(self, Xq: np.ndarray):
        """Query batch against the precomputed trajectory (one device scan
        + the same one-transfer record fetch as the segment path)."""
        from ..core import native
        M, N, Mp, Q = self.M, self.N, self.Mp, Xq.shape[0]
        A_all, D8, DR, U8, C = self.traj
        Ns = U8.shape[0]
        xq_bits = bitpack_rows(Xq)
        # pooled buffer: a fresh per-call np.zeros pays its page faults
        xq_words_np = native.pooled_view((Q, self.nw), np.int32,
                                         "match:xq_words")
        xq_words_np[:] = 0
        w = pack_row_words(xq_bits)
        xq_words_np[:, :min(w.shape[1], self.nw)] = w[:, :self.nw]
        xq_words_d = jnp.asarray(xq_words_np)
        # qcols derive on device from the packed words (1/8 the upload)
        qcols_d = _qcols_from_words(xq_words_d, ns=Ns)

        # cap per query width: deterministic first guess sized to the
        # domain (~50 collapse records per query on mosaic queries),
        # grown only upward so the scan never recompiles twice for the
        # same Q; a first call that still overflows re-runs once
        cap, _ = self._qstate.get(
            Q, (_pow2_pad(max(_REC_CAP, 128 * Q)), 0))
        while True:
            (e, f, g), recbuf, nrec_d = match_scan_indexed(
                U8, D8, DR, A_all, C, qcols_d, xq_words_d, self.xp_words,
                jnp.zeros(Q, jnp.int32), jnp.zeros(Q, jnp.int32),
                jnp.full(Q, Mp, jnp.int32), cap=cap)
            packed = np.asarray(_pack_flush_total(e, f, g, nrec_d, recbuf))
            nrec, total = int(packed[0]), int(packed[1])
            if nrec <= cap - _RC:
                break
            cap = _pow2_pad(nrec + _RC)       # overflow: re-run larger
        self._qstate[Q] = (cap, 0)

        # expand records + flush to (q, hap, e, k) rows ON DEVICE and
        # fetch them once
        rows = np.asarray(_expand_rows_device(
            A_all, recbuf, nrec_d, e, f, g, n_sites=N,
            tpad=_pow2_pad(max(total, 1))))
        return rows[(rows[:, 0] >= 0) & (rows[:, 1] < M)]

    def match(self, Xq: np.ndarray):
        if self.traj is not None:
            return self._match_indexed(Xq)
        cap, _ = self._qstate.get(("seg", Xq.shape[0]), (_REC_CAP, 0))
        while True:
            rows = self._match_segmented(Xq, cap)
            if rows is not None:
                self._qstate[("seg", Xq.shape[0])] = (cap, 0)
                return rows
            cap *= 2                          # record buffer overflowed

    def _match_segmented(self, Xq: np.ndarray, cap: int):
        """Interleaved panel-advance path (panels whose trajectory exceeds
        the trajectory budget).  Returns rows, or None when the collapse-record
        buffer overflowed (caller re-runs with a larger cap)."""
        M, N, Mp, Q = self.M, self.N, self.Mp, Xq.shape[0]
        xq_bits = bitpack_rows(Xq)
        xq_words_np = np.zeros((Q, self.nw), np.int32)
        w = pack_row_words(xq_bits)
        xq_words_np[:, :min(w.shape[1], self.nw)] = w[:, :self.nw]
        xq_words = jnp.asarray(xq_words_np)

        nsites = self.nseg * self.gseg * GROUP
        qcols = _qcols_from_words(xq_words, ns=nsites)   # on device

        carry = (jnp.arange(Mp, dtype=jnp.int32),
                 jnp.zeros(Mp, dtype=jnp.int32).at[0].set(1),
                 jnp.zeros(Q, dtype=jnp.int32),
                 jnp.zeros(Q, dtype=jnp.int32),
                 jnp.full(Q, Mp, dtype=jnp.int32),
                 jnp.int32(0),
                 jnp.full((cap, 4), -1, jnp.int32),
                 jnp.int32(0))

        out_rows: list[np.ndarray] = []
        prev = 0
        for seg in range(self.nseg):
            base = seg * self.gseg * GROUP
            last = seg == self.nseg - 1
            Wd = self.W_all[seg * self.gseg:(seg + 1) * self.gseg]
            qd = qcols[base:base + self.gseg * GROUP]
            carry, snaps = match_scan_segment(
                Wd, qd, xq_words, self.xp_words, carry)
            # one small transfer: record count + flush carry
            packed = np.asarray(_pack_flush(carry[2], carry[3], carry[4],
                                            carry[7]))
            ncum = int(packed[0])
            if ncum > cap - _RC:
                return None                   # overflowed mid-scan
            e_h, f_h, g_h = packed[1:].reshape(3, Q)
            # fetch only THIS segment's records (a pow2-bucketed dynamic
            # slice, clamp-adjusted): refetching the cumulative prefix
            # per segment cost ~3x the record bytes at M=1M
            delta = ncum - prev
            if delta > 0:
                dpad = min(_pow2_pad(delta), cap)
                start = min(prev, cap - dpad)
                rec_d = jax.lax.dynamic_slice_in_dim(carry[6], start, dpad)
                off = prev - start
                rec = np.asarray(rec_d)[off:off + delta]
            else:
                rec = np.zeros((0, 4), np.int32)
            # records store si = k_global*Q + q; _record_indices wants
            # the segment-relative flat index
            si_h = rec[:, 0] - base * Q
            se_h, sf_h, sg_h = rec[:, 1], rec[:, 2], rec[:, 3]
            prev = ncum

            # build both gather index sets, run them in one device call
            rec_idx, rec_meta = self._record_indices(si_h, se_h, sf_h, sg_h,
                                                     base, Q, Mp)
            if last:
                fl_idx, fl_meta = self._flush_indices(e_h, f_h, g_h, N, Q)
            else:
                fl_idx = np.empty(0, np.int64)
                fl_meta = None
            n1, n2 = len(rec_idx), len(fl_idx)
            if n1 + n2:
                p1 = _pow2_pad(max(n1, 1))
                p2 = _pow2_pad(max(n2, 1)) if n2 else 1
                i1 = np.zeros(p1, np.int32)
                i1[:n1] = rec_idx
                i2 = np.zeros(p2, np.int32)
                i2[:n2] = fl_idx
                ids = np.asarray(_gather_two(snaps, jnp.asarray(i1),
                                             carry[0], jnp.asarray(i2)))
                if n1:
                    rows = rec_meta
                    rows[:, 1] = ids[:p1][:n1]
                    out_rows.append(rows)
                if n2:
                    rows = fl_meta
                    rows[:, 1] = ids[p1:][:n2]
                    out_rows.append(rows)
        if not out_rows:
            return np.zeros((0, 4), np.int32)
        allrows = np.concatenate(out_rows)
        return allrows[allrows[:, 1] < M]

    @staticmethod
    def _record_indices(si, se, sf, sg, base, Q, Mp):
        """Flat snapshot indices + (q, ., e, k) row skeleton for records."""
        nrec = si.shape[0]
        k_loc = (si // Q).astype(np.int64)
        q = (si % Q).astype(np.int32)
        widths = (sg.astype(np.int64) - sf).clip(min=0)
        total = int(widths.sum())
        if total == 0:
            return np.empty(0, np.int64), None
        rec_of_row = np.repeat(np.arange(nrec), widths)
        offs = np.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(widths)[:-1]]), widths)
        flat = k_loc[rec_of_row] * Mp + sf[rec_of_row] + offs
        rows = np.empty((total, 4), np.int32)
        rows[:, 0] = q[rec_of_row]
        rows[:, 2] = se[rec_of_row]
        rows[:, 3] = base + k_loc[rec_of_row]
        return flat, rows

    @staticmethod
    def _flush_indices(e_h, f_h, g_h, N, Q):
        """Indices into the final prefix array for the k = N flush."""
        widths = (g_h.astype(np.int64) - f_h).clip(min=0)
        total = int(widths.sum())
        if total == 0:
            return np.empty(0, np.int64), None
        offs = np.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(widths)[:-1]]), widths)
        idx = np.repeat(f_h, widths) + offs
        rows = np.empty((total, 4), np.int32)
        rows[:, 0] = np.repeat(np.arange(Q), widths)
        rows[:, 2] = np.repeat(e_h, widths)
        rows[:, 3] = N
        return idx, rows
