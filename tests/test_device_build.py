import numpy as np
import pytest

from pbwt_tpu.core import engine
from pbwt_tpu.core.pbwt import PBWT


def rand_haps(seed, M, N, maf=0.3):
    rng = np.random.RandomState(seed)
    return (rng.random_sample((M, N)) < maf).astype(np.uint8)


@pytest.mark.parametrize("seed,M,N", [(0, 24, 40), (1, 24, 40)])
def test_device_build_matches_host(seed, M, N):
    from pbwt_tpu.ops import build as dbuild
    X = rand_haps(seed, M, N)
    yz_host, a_host = engine.build_from_haplotypes(X)
    yz_dev, a_dev, counts = dbuild.build_pbwt_device(X, multiple=8)
    assert yz_dev == yz_host
    assert (a_dev == a_host).all()
    Y = PBWT.from_haplotypes(X).decoded(True)
    assert (counts[: N] == (Y == 0).sum(axis=1)).all()


def _host_build(X):
    """Per-site host engine: sorted columns, final a and d (M+1 entries)."""
    M, N = X.shape
    a = np.arange(M, dtype=np.int32)
    d = np.zeros(M + 1, dtype=np.int32)
    d[0] = d[M] = 1
    Ysort = np.empty((N, M), np.uint8)
    for k in range(N):
        y = X[a, k]
        Ysort[k] = y
        a, d = engine.forwards_ad(a, d, y, k)
    return Ysort, a, d


def test_device_divergence_matches_host():
    from pbwt_tpu.ops import build as dbuild
    import jax.numpy as jnp
    X = rand_haps(3, 40, 30)
    M, N = X.shape
    cols, Mp = dbuild.prepare_columns(X, multiple=8)
    W = jnp.asarray(dbuild.pack_group_words(cols))
    ybits, counts, a_end, d_end = dbuild.build_scan_grouped(
        W, jnp.arange(Mp, dtype=jnp.int32), with_divergence=True, n_sites=N)
    _, a, d = _host_build(X)
    assert (np.asarray(a_end)[:M] == a).all()
    # device d has no d[M] sentinel; compare entries 0..M-1
    assert (np.asarray(d_end)[:M] == d[:M]).all()


@pytest.mark.parametrize("seed,M,N", [(5, 24, 40), (6, 16, 70), (7, 32, 32)])
def test_grouped_build_matches_ungrouped(seed, M, N):
    """Grouped packed-word build == the per-site host engine, incl.
    non-multiple-of-32 site counts, with and without the divergence
    payload."""
    from pbwt_tpu.ops import build as dbuild
    import jax.numpy as jnp
    X = rand_haps(seed, M, N)
    cols, Mp = dbuild.prepare_columns(X, multiple=8)
    a0 = jnp.arange(Mp, dtype=jnp.int32)
    Ysort, a, d = _host_build(X)
    W = jnp.asarray(dbuild.pack_group_words(cols))
    got = dbuild.build_scan_grouped(W, a0, with_divergence=True, n_sites=N)
    assert (dbuild.unpack_bits_host(np.asarray(got[0])[:N], M)
            == Ysort).all()                                        # ybits
    assert (np.asarray(got[1])[:N] == (Ysort == 0).sum(axis=1)).all()
    assert (np.asarray(got[2])[:M] == a).all()                    # a_end
    assert (np.asarray(got[3])[:M] == d[:M]).all()                # d_end

    got_nd = dbuild.build_scan_grouped(W, a0, with_divergence=False)
    assert (np.asarray(got_nd[0]) == np.asarray(got[0])).all()
    assert (np.asarray(got_nd[2]) == np.asarray(got[2])).all()


def _partition_reference(a, w, s):
    key = ((w.view(np.uint32) >> s) & 1).astype(np.uint8)
    order = np.concatenate([np.nonzero(key == 0)[0], np.nonzero(key == 1)[0]])
    return key, a[order], w[order]


def test_site_step_partition_matches_reference():
    """Plain site step (no divergence) == the host stable two-bucket
    partition over a whole 32-site group: permutation, carried words,
    FM rank table and zero counts."""
    from pbwt_tpu.ops import build as dbuild
    import jax.numpy as jnp
    M = 4096
    rng = np.random.RandomState(11)
    w = rng.randint(0, 2**32, size=M, dtype=np.uint32).astype(np.int32)
    a = np.arange(M, dtype=np.int32)
    aj, wj = jnp.asarray(a), jnp.asarray(w)
    for s in range(32):
        aj, dj, wj, u, c = dbuild.site_step(aj, None, wj, s, s)
        key, a, w = _partition_reference(a, w, s)
        assert dj is None
        assert int(c) == int((key == 0).sum()), f"site {s}"
        assert np.array_equal(np.asarray(u),
                              np.concatenate([[0], np.cumsum(key == 0)])[:M])
        assert np.array_equal(np.asarray(aj), a)
        assert np.array_equal(np.asarray(wj), w)


def test_site_step_edge_columns():
    """All-zero / all-one / alternating key columns through the grouped
    build (every site of a group) and the site step."""
    from pbwt_tpu.ops import build as dbuild
    import jax.numpy as jnp
    M = 4096
    a0 = np.arange(M, dtype=np.int32)
    for w0 in [np.zeros(M, np.int32), np.full(M, -1, np.int32),
               np.tile(np.array([0x55555555, 0], np.int32), M // 2)[:M]]:
        ybits, counts, a_o, _ = dbuild.build_scan_grouped(
            jnp.asarray(w0[None]), jnp.asarray(a0))
        a = a0.copy(); w = w0.copy()
        for s in range(32):
            key, a, w = _partition_reference(a, w, s)
            assert int(counts[s]) == int((key == 0).sum())
            assert np.array_equal(np.unpackbits(np.asarray(ybits[s])), key)
        assert np.array_equal(np.asarray(a_o), a)


def test_site_step_ad_matches_engine():
    """Divergence-carrying site step == host forwards_ad, including the FM
    rank table and zero counts."""
    from pbwt_tpu.ops import build as dbuild
    import jax.numpy as jnp
    M = 4096
    rng = np.random.RandomState(5)
    w = rng.randint(0, 2**32, size=M, dtype=np.uint32).astype(np.int32)
    a = np.arange(M, dtype=np.int32)
    d = np.zeros(M + 1, dtype=np.int32)
    d[0] = d[M] = 1
    aj, dj, wj = jnp.asarray(a), jnp.asarray(d[:M]), jnp.asarray(w)
    for k in range(4):
        a2, d2, w2, u, cnt = dbuild.site_step(aj, dj, wj, k, k)
        key, _, w = _partition_reference(a, w, k)
        exp_u = np.concatenate([[0], np.cumsum(key == 0)])[:M]
        assert np.array_equal(np.asarray(u), exp_u)
        assert int(cnt) == int((key == 0).sum())
        a, d = engine.forwards_ad(a, d, key, k)
        assert np.array_equal(np.asarray(a2), a)
        assert np.array_equal(np.asarray(d2), d[:M])
        assert np.array_equal(np.asarray(w2), w)
        aj, dj, wj = a2, d2, w2


def test_panel_words_from_bits_roundtrip():
    """Device word derivation from bit-packed rows == host pack_group_words."""
    from pbwt_tpu.ops import build as dbuild
    from pbwt_tpu.ops import match_jax as mj
    import jax.numpy as jnp
    rng = np.random.RandomState(9)
    M, N = 256, 70
    X = (rng.random_sample((M, N)) < 0.4).astype(np.uint8)
    Ng = (N + 31) // 32
    bits = mj.bitpack_rows(X)
    pad = np.zeros((M, 4 * Ng), np.uint8)
    pad[:, :bits.shape[1]] = bits
    W_dev = np.asarray(mj._panel_words_from_bits(jnp.asarray(pad)))
    # host: pad sites with ZEROS to match the device convention
    cols = np.zeros((Ng * 32, M), np.uint8)
    cols[:N] = X.T
    W_host = dbuild.pack_group_words(cols[:N])
    # pack_group_words pads with ones; rebuild zero-padded words directly
    Wz = np.zeros((Ng, M), np.uint32)
    for t in range(Ng):
        for s in range(32):
            k = 32 * t + s
            if k < N:
                Wz[t] |= X[:, k].astype(np.uint32) << np.uint32(s)
    assert np.array_equal(W_dev.astype(np.uint32), Wz)


def test_padding_rows_stay_at_end():
    from pbwt_tpu.ops import build as dbuild
    import jax.numpy as jnp
    X = rand_haps(4, 10, 25)
    cols, Mp = dbuild.prepare_columns(X, multiple=16)
    assert Mp == 16
    _, _, a_end, _ = dbuild.build_scan_grouped(
        jnp.asarray(dbuild.pack_group_words(cols)),
        jnp.arange(Mp, dtype=jnp.int32), with_divergence=True)
    assert set(np.asarray(a_end)[10:].tolist()) == set(range(10, 16))
