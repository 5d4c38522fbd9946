"""Sample-sharded PBWT construction over a jax.sharding Mesh.

The reference is single-threaded (SURVEY.md section 2: no parallelism of
any kind); this module *introduces* the scale-out path.

Design: **natural ownership + FM position chase** (round-2 rework).  Each
shard permanently owns a contiguous block of haplotypes in natural order -
haplotype payloads (the packed group words) NEVER move between shards.
What evolves is each owned haplotype's global *position* in the PBWT sort
order, advanced per site with the FM map

    pos' = u[pos]            if y == 0
    pos' = c + pos - u[pos]  if y == 1

where u[pos] (zeros before pos) and c (total zeros) come from the one
piece of global state exchanged per site: the **bit-packed sorted column**
(Mp/32 int32 words), assembled by a single psum of each shard's scattered
bits.  Per-site collective traffic is therefore Mp/8 bytes + a scalar -
the packed column IS the build's output, so this is within 8x of the
information-theoretic floor of emitting the result at all - versus the
round-1 radix design's two full-Mp int32 one-hot psums plus column
all_gathers (~20x Mp bytes/site, measured in ARCHITECTURE.md).

Divergence arrays are position-indexed global state; they are updated
replicated from the (replicated) packed column with the same segmented-max
scan as the single-chip path - zero extra communication.

The final prefix array a[pos] = haplotype id is assembled with one psum at
the end (not per site).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.build import GROUP, _segmented_running_max


def make_mesh(n_devices: int | None = None, axis: str = "s") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def _unpack_colw(colw: jnp.ndarray, Mp: int) -> jnp.ndarray:
    """(Mp/32,) int32 packed column -> (Mp,) uint8 bits (bit b of word w is
    position 32*w + b)."""
    shifts = jnp.arange(32, dtype=jnp.int32)[None, :]
    return ((colw[:, None] >> shifts) & 1).astype(jnp.uint8).reshape(Mp)


def _fm_group_step(pos, w_own, d, k0, *, axis, Mp, with_divergence):
    """One 32-site packed-word group under natural ownership.

    pos   (B,) this shard's haplotypes' global sorted positions
    w_own (B,) their packed group words (natural order - never moves)
    d     (Mp,) replicated divergence (position-indexed)
    Returns (pos', d', sitewords (32, Mp/32) int32, counts (32,)).
    """
    W32 = Mp // 32
    out_words, out_counts = [], []
    for s in range(GROUP):
        y = (w_own >> s) & 1                                  # (B,) int32
        contrib = jnp.zeros(W32, jnp.int32).at[pos >> 5].add(y << (pos & 31))
        colw = jax.lax.psum(contrib, axis)        # packed sorted column
        pc = jax.lax.population_count(colw)
        ones_excl = jnp.cumsum(pc) - pc
        c = Mp - ones_excl[-1] - pc[-1]                       # total zeros
        within = jax.lax.population_count(
            colw[pos >> 5] & ((jnp.int32(1) << (pos & 31)) - 1))
        u_pos = pos - (ones_excl[pos >> 5] + within)          # zeros < pos
        pos = jnp.where(y != 0, c + pos - u_pos, u_pos)
        out_words.append(colw)
        out_counts.append(c.astype(jnp.int32))
        if with_divergence:
            kk = jnp.asarray(k0 + s, d.dtype)
            m0 = _unpack_colw(colw, Mp) == 0
            prev0 = jnp.concatenate([jnp.zeros(1, bool), m0[:-1]])
            prev1 = jnp.concatenate([jnp.zeros(1, bool), (~m0)[:-1]])
            seed = d.at[0].max(kk + 1)
            p = _segmented_running_max(seed, prev0)
            q = _segmented_running_max(seed, prev1)
            r0 = jnp.cumsum(m0)
            idx = jnp.arange(Mp, dtype=r0.dtype)
            pos_all = jnp.where(m0, r0 - 1, c + (idx + 1 - r0) - 1)
            d = jnp.zeros_like(d).at[pos_all].set(jnp.where(m0, p, q))
            d = d.at[0].set(kk + 2)
    return pos, d, jnp.stack(out_words), jnp.stack(out_counts)


def build_scan_sharded_grouped(W, mesh: Mesh, axis: str = "s",
                               with_divergence: bool = True,
                               n_sites: int | None = None):
    """Sharded construction over 32-site packed-word groups.

    W: (Ng, Mp) int32 natural-order group words (ops/build.pack_group_words)
    sharded over the haplotype axis; pad haplotypes beyond M and pad sites
    beyond n_sites must be all-ones (identity FM steps).

    Returns (sitewords (Ng*32, Mp//32) int32 bit-packed sorted columns,
    counts (Ng*32,), a_end (Mp,), d_end (Mp,)), all replicated.
    """
    Ng, Mp = W.shape
    n_shards = mesh.shape[axis]
    assert Mp % (32 * n_shards) == 0

    def shard_fn(Wl):            # (Ng, B) natural-order words, this shard
        B = Mp // n_shards
        r = jax.lax.axis_index(axis)
        ids = r * B + jnp.arange(B, dtype=jnp.int32)
        d0 = jnp.zeros(Mp, dtype=jnp.int32).at[0].set(1)

        def step(carry, w_own):
            pos, d, k = carry
            pos, d, sw, cnts = _fm_group_step(
                pos, w_own, d, k, axis=axis, Mp=Mp,
                with_divergence=with_divergence)
            return (pos, d, k + GROUP), (sw, cnts)

        (pos, d_end, _), (sitewords, counts) = jax.lax.scan(
            step, (ids, d0, jnp.int32(0)), Wl)
        a_end = jax.lax.psum(
            jnp.zeros(Mp, jnp.int32).at[pos].set(ids), axis)
        return (sitewords.reshape(Ng * GROUP, Mp // 32),
                counts.reshape(Ng * GROUP), a_end, d_end)

    fn = jax.shard_map(shard_fn, mesh=mesh,
                       in_specs=P(None, axis),
                       out_specs=(P(), P(), P(), P()))
    sitewords, counts, a_end, d_end = fn(W)
    if with_divergence and n_sites is not None and n_sites % GROUP:
        # trailing all-ones pad sites only advance the d[0] = k+2 sentinel
        d_end = jnp.asarray(d_end).at[0].set(n_sites + 1)
    return sitewords, counts, a_end, d_end


def unpack_words32_host(sitewords: np.ndarray, M: int) -> np.ndarray:
    """(Ns, Mp//32) int32 packed columns -> (Ns, M) uint8 sorted columns."""
    w = np.asarray(sitewords).view(np.uint32)
    bits = (w[:, :, None] >> np.arange(32, dtype=np.uint32)[None, None, :]) & 1
    return bits.reshape(w.shape[0], -1)[:, :M].astype(np.uint8)


def build_pbwt_sharded(X: np.ndarray, mesh: Mesh | None = None,
                       axis: str = "s"):
    """End-to-end sharded build from an (M, N) haplotype matrix; returns
    (yz bytes, aFend, counts) byte-identical to the host engine."""
    from ..core import pack3 as p3
    from ..ops.build import pack_group_words, prepare_columns
    if mesh is None:
        mesh = make_mesh()
    n = mesh.shape[axis]
    M, N = X.shape
    cols, Mp = prepare_columns(X, multiple=32 * n)
    sharding = NamedSharding(mesh, P(None, axis))
    W_dev = jax.device_put(jnp.asarray(pack_group_words(cols)), sharding)
    sitewords, counts, a_end, _ = build_scan_sharded_grouped(
        W_dev, mesh, axis, with_divergence=False)
    Ysort = unpack_words32_host(np.asarray(sitewords[:N]), M)
    yz, _ = p3.pack_columns(Ysort)
    return yz, np.asarray(a_end)[:M].astype(np.int32), \
        np.asarray(counts)[:N]
