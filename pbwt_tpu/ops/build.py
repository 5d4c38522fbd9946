"""Device engine: PBWT construction as a jitted lax.scan.

The reference hot loop (pbwtCursorForwardsAD, pbwtCore.c:485-508 - an O(M)
stable two-bucket counting sort per site plus a divergence running-max) maps
onto XLA as one site step (:func:`site_step`):

  * stable partition  = exclusive prefix sum of the zero mask + one scatter,
  * divergence update = segmented running maxima with resets after each
    emitted symbol, computed with an associative scan over (value, reset)
    pairs,
  * site recurrence   = jax.lax.scan (the k-recurrence is inherently
    sequential in a; throughput comes from the M haplotypes).

Sites are processed in groups of 32: the group's alleles ride each
haplotype as one packed int32 word, gathered into the current sort order
once per group and then carried through the 32 partitions as payload, so
the per-site allele lookup x[a[j]] (pbwtHtslib.c:134) is one bit shift.

Outputs: per-site sorted columns (bit-packed on device to cut the download
8x), per-site zero-counts (c), and the final prefix/divergence arrays.  The
host pack3 encoder turns sorted columns into the byte-exact .pbwt stream.

Padding: M is padded to a multiple of 128 with all-ones haplotypes.  Ones
pad rows start at the end of the sort order and remain there under every
stable partition (zeros first; pads follow all real ones because they
follow them in the current order), so real rows' a/d/y values are
unaffected and the first M entries of every output column are the
unpadded result.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

GROUP = 32  # sites per packed word in the grouped scans


def pad_to(M: int, multiple: int = 128) -> int:
    return ((M + multiple - 1) // multiple) * multiple


def _segmented_running_max(vals: jnp.ndarray, resets: jnp.ndarray) -> jnp.ndarray:
    """Inclusive running max of ``vals`` that restarts after each position
    where ``resets`` is True (reset applies to the element itself: segment =
    (last_reset, i]).  Associative-scan formulation, O(M log M)."""

    def combine(a, b):
        av, ar = a
        bv, br = b
        return jnp.where(br, bv, jnp.maximum(av, bv)), ar | br

    out, _ = jax.lax.associative_scan(combine, (vals, resets))
    return out


def gather_words(w_nat: jnp.ndarray, a: jnp.ndarray) -> jnp.ndarray:
    """w_nat[a]: a group's natural-order packed words in sort order ``a``
    (a permutation)."""
    return jnp.take(w_nat, a, unique_indices=True)


def site_step(a, d, w, s, k):
    """One site of the panel advance on (Mp,) arrays in current sort order.

    Stable partition of (a, d, w) by the key bit s of the packed words w,
    with the reference's divergence update (pbwtCursorForwardsAD,
    pbwtCore.c:485-508) for global site index k.  ``d`` may be None when
    the caller needs no divergence array.

    Returns (a', d', w', u, c): u (Mp,) the exclusive zero ranks of the
    pre-site order (the FM rank table, pbwtCursorCalculateU) and c the
    zero count.  d'[0] carries the k+2 sentinel.
    """
    Mp = a.shape[0]
    mask0 = (jax.lax.shift_right_logical(w, s) & 1) == 0
    r0 = jnp.cumsum(mask0, dtype=jnp.int32)
    c = r0[-1]
    u = r0 - mask0
    # zeros go to their zero rank; ones to c + their one rank (i - u)
    pos = jnp.where(mask0, u, c + jnp.arange(Mp, dtype=jnp.int32) - u)

    def scatter(x):
        return jnp.zeros_like(x).at[pos].set(x, unique_indices=True)

    a2, w2 = scatter(a), scatter(w)
    if d is None:
        return a2, None, w2, u, c
    kk = jnp.asarray(k, d.dtype)
    # p-scan resets after each zero, q-scan after each one; both are seeded
    # with k+1 once at the start (pbwtCore.c:489-503)
    prev0 = jnp.concatenate([jnp.zeros(1, bool), mask0[:-1]])
    prev1 = jnp.concatenate([jnp.zeros(1, bool), ~mask0[:-1]])
    seed = d.at[0].max(kk + 1)
    pq = jnp.where(mask0, _segmented_running_max(seed, prev0),
                   _segmented_running_max(seed, prev1))
    return a2, scatter(pq).at[0].set(kk + 2), w2, u, c


def bitpack_column(y: jnp.ndarray) -> jnp.ndarray:
    """Pack a 0/1 uint8 column (len multiple of 8) into bytes, bit 7 first
    (numpy packbits order)."""
    M = y.shape[0]
    shifts = jnp.array([7, 6, 5, 4, 3, 2, 1, 0], dtype=jnp.uint8)
    return (y.reshape(M // 8, 8) << shifts).sum(axis=1).astype(jnp.uint8)


def pack_group_words(X_cols: np.ndarray) -> np.ndarray:
    """(N, Mp) uint8 site-major columns -> (ceil(N/32), Mp) int32 words.

    Word t, row i holds sites 32t..32t+31 of haplotype i, site 32t at bit 0.
    Sites beyond N are padded with 1-bits: an all-ones column leaves the
    sort order unchanged, so trailing pad sites are harmless no-ops.
    """
    N, Mp = X_cols.shape
    Ng = (N + GROUP - 1) // GROUP
    full = (N // GROUP) * GROUP
    parts = []
    if full:
        # little-endian bit pack along the site axis: byte j of the group
        # word = sites 8j..8j+7, so the (.., 4, Mp) byte planes laid out
        # (.., Mp, 4) view directly as little-endian int32 words with site
        # 32t+s at bit s
        b = np.packbits(X_cols[:full].reshape(full // GROUP, GROUP, Mp),
                        axis=1, bitorder="little")
        parts.append(np.ascontiguousarray(b.transpose(0, 2, 1))
                     .view(np.int32).reshape(full // GROUP, Mp))
    if N > full:
        tail = np.ones((1, GROUP, Mp), dtype=np.uint8)
        tail[0, :N - full] = X_cols[full:]
        b = np.packbits(tail, axis=1, bitorder="little")
        parts.append(np.ascontiguousarray(b.transpose(0, 2, 1))
                     .view(np.int32).reshape(1, Mp))
    if not parts:
        return np.zeros((0, Mp), dtype=np.int32)
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


@partial(jax.jit, static_argnames=("with_divergence", "n_sites"))
def build_scan_grouped(W: jnp.ndarray, a0: jnp.ndarray,
                       with_divergence: bool = False,
                       n_sites: int | None = None):
    """Grouped-packed PBWT construction.

    ``W`` is (Ng, Mp) int32 from :func:`pack_group_words`; the panel
    advances one :func:`site_step` per site.

    Returns (ybits (Ng*32, Mp//8), counts (Ng*32,), a_end, d_end); d_end
    holds entries 0..Mp-1 of the divergence array (the initial d when
    with_divergence=False).
    """
    Ng, Mp = W.shape
    d0 = jnp.zeros(Mp, dtype=jnp.int32).at[0].set(1)
    s_iota = jnp.arange(GROUP, dtype=jnp.int32)

    def group_step(carry, w_nat):
        a, d, k = carry

        def site(st, s):
            a, d, w = st
            ybits = bitpack_column(
                (jax.lax.shift_right_logical(w, s) & 1).astype(jnp.uint8))
            a, d2, w, _, c = site_step(a, d if with_divergence else None,
                                       w, s, k + s)
            return (a, d2 if with_divergence else d, w), (ybits, c)

        (a, d, _), (ybits, counts) = jax.lax.scan(
            site, (a, d, gather_words(w_nat, a)), s_iota)
        return (a, d, k + GROUP), (ybits, counts)

    (a_end, d_end, _), (ybits, counts) = jax.lax.scan(
        group_step, (a0, d0, jnp.int32(0)), W)
    if with_divergence and n_sites is not None and n_sites % GROUP:
        # trailing all-ones pad sites only advance the d[0] = k+2 sentinel;
        # restore the value it had after the last real site
        d_end = d_end.at[0].set(n_sites + 1)
    return (ybits.reshape(Ng * GROUP, Mp // 8),
            counts.reshape(Ng * GROUP), a_end, d_end)


def prepare_columns(X: np.ndarray, multiple: int = 128) -> tuple[np.ndarray, int]:
    """(M, N) natural-order haplotypes -> (N, Mp) site-major padded columns."""
    M, N = X.shape
    Mp = pad_to(M, multiple)
    cols = np.ones((N, Mp), dtype=np.uint8)
    cols[:, :M] = X.T
    return cols, Mp


def unpack_bits_host(ybits: np.ndarray, M: int) -> np.ndarray:
    """(N, Mp//8) packed device output -> (N, M) uint8 sorted columns."""
    return np.unpackbits(np.asarray(ybits), axis=1)[:, :M]


def build_pbwt_device(X: np.ndarray, multiple: int = 128):
    """Full device-accelerated construction from an (M, N) haplotype matrix.

    Device does the O(NM) partition work; the host pack3-encodes the
    sorted columns into the byte-exact .pbwt stream (the C encoder when
    the native runtime is available).
    Returns (yz bytes, aFend int32[M], counts int32[N]).
    """
    from ..core import native, pack3 as p3
    M, N = X.shape
    cols, Mp = prepare_columns(X, multiple)
    a0 = jnp.arange(Mp, dtype=jnp.int32)
    ybits, counts, a_end, _ = build_scan_grouped(
        jnp.asarray(pack_group_words(cols)), a0)
    Ysort = unpack_bits_host(np.asarray(ybits[:N]), M)
    yz, _ = native.encode_cols(Ysort) or p3.pack_columns(Ysort)
    a_end_host = np.asarray(a_end)[:M].astype(np.int32)
    return yz, a_end_host, np.asarray(counts[:N])
