import numpy as np
import pytest

from pbwt_tpu.core.pbwt import PBWT


def mosaic(seed, M, N, founders=5, switch=0.04):
    rng = np.random.RandomState(seed)
    F = (rng.random_sample((founders, N)) < 0.4).astype(np.uint8)
    X = np.empty((M, N), np.uint8)
    for i in range(M):
        f = rng.randint(founders)
        for k in range(N):
            if rng.random_sample() < switch:
                f = rng.randint(founders)
            X[i, k] = F[f, k]
    return X


def test_segment_matcher_equals_portable():
    """DeviceMatcher == the portable match_scan path: same rows, same
    report order.

    Exercises the production device machinery end-to-end: the site-step
    chain, the one-hot FM rank lookups, the compacted matmul reset path
    and the windowed reset."""
    from pbwt_tpu.ops import match_jax
    rng = np.random.RandomState(42)
    M, N, Q = 300, 96, 20
    Xp = mosaic(3, M, N)
    Xp[37] = Xp[5]                     # duplicate rows: wide intervals
    Xq = np.empty((Q, N), np.uint8)
    for q in range(Q):
        pos = 0
        while pos < N:
            seg = rng.randint(10, 40)
            src = rng.randint(0, M)
            Xq[q, pos:pos + seg] = Xp[src, pos:pos + seg]
            pos += seg
    rows_seg = np.asarray(match_jax.DeviceMatcher(Xp).match(Xq))
    rows_port = np.asarray(match_jax.match_queries_device(Xp, Xq))
    assert np.array_equal(rows_seg, rows_port)


def test_trajectory_matcher_equals_interleaved():
    """The standing-panel trajectory path (panel tables precomputed once,
    match_scan_indexed per query batch) == the interleaved per-segment
    panel advance: same rows, same order, including reuse of one matcher
    across several query batches of different Q."""
    from pbwt_tpu.ops import match_jax
    rng = np.random.RandomState(9)
    M, N = 300, 96
    Xp = mosaic(5, M, N)
    Xp[11] = Xp[200]
    def queries(Q, seed):
        r = np.random.RandomState(seed)
        Xq = np.empty((Q, N), np.uint8)
        for q in range(Q):
            pos = 0
            while pos < N:
                seg = r.randint(10, 40)
                Xq[q, pos:pos + seg] = Xp[r.randint(0, M), pos:pos + seg]
                pos += seg
        return Xq
    m_traj = match_jax.DeviceMatcher(Xp)
    assert m_traj.traj is not None
    m_seg = match_jax.DeviceMatcher(Xp, traj_bytes=0)
    assert m_seg.traj is None
    for Q, seed in [(20, 1), (7, 2), (20, 3)]:
        Xq = queries(Q, seed)
        assert np.array_equal(np.asarray(m_traj.match(Xq)),
                              np.asarray(m_seg.match(Xq)))


def test_segment_matcher_multi_segment(monkeypatch):
    """The segment path (forced through the constructor argument) split
    into one 32-site group per segment == the trajectory path: the carry,
    record buffer and per-segment id fetch cross segment boundaries."""
    from pbwt_tpu.ops import match_jax
    rng = np.random.RandomState(7)
    M, N, Q = 300, 100, 8
    Xp = mosaic(11, M, N)
    Xq = np.empty((Q, N), np.uint8)
    for q in range(Q):
        pos = 0
        while pos < N:
            seg = rng.randint(10, 40)
            Xq[q, pos:pos + seg] = Xp[rng.randint(0, M), pos:pos + seg]
            pos += seg
    rows_traj = np.asarray(match_jax.DeviceMatcher(Xp).match(Xq))
    Mp = 384
    # a device whose snapshot budget holds exactly one group's snapshots
    monkeypatch.setattr(match_jax, "device_bytes_limit",
                        lambda: 16 * 4 * Mp * 32)
    m_seg = match_jax.DeviceMatcher(Xp, traj_bytes=0)
    assert (m_seg.Mp, m_seg.gseg, m_seg.nseg) == (Mp, 1, 4)
    assert np.array_equal(np.asarray(m_seg.match(Xq)), rows_traj)


def test_from_pbwt_equals_dense():
    """DeviceMatcher.from_pbwt (pack3-streamed panel upload, O(M*chunk)
    host bytes) builds the exact same device state as the dense
    constructor: identical rows, including a ragged (non-multiple-of-
    chunk) site count and a non-identity aFstart."""
    from pbwt_tpu.ops import match_jax
    rng = np.random.RandomState(13)
    M, N, Q = 300, 100, 12            # N=100: ragged vs chunk_sites=32
    Xp = mosaic(17, M, N)
    Xq = np.empty((Q, N), np.uint8)
    for q in range(Q):
        pos = 0
        while pos < N:
            seg = rng.randint(10, 40)
            Xq[q, pos:pos + seg] = Xp[rng.randint(0, M), pos:pos + seg]
            pos += seg
    p = PBWT.from_haplotypes(Xp)
    m_stream = match_jax.DeviceMatcher.from_pbwt(p, chunk_sites=32)
    m_dense = match_jax.DeviceMatcher(Xp)
    assert np.array_equal(np.asarray(m_stream.match(Xq)),
                          np.asarray(m_dense.match(Xq)))


def test_site_step_skewed_key_columns():
    """The site step on a scrambled order and arbitrary divergence values
    == the host forwards_ad, for random, all-zero and all-one key columns
    at both ends of the packed word."""
    import jax.numpy as jnp
    from pbwt_tpu.core import engine
    from pbwt_tpu.ops.build import site_step
    rng = np.random.RandomState(0)
    Mp = 96 * 128
    a = rng.permutation(Mp).astype(np.int32)
    d = np.zeros(Mp + 1, np.int32)
    d[:Mp] = rng.randint(0, 50, size=Mp)
    for w in [rng.randint(-2 ** 31, 2 ** 31 - 1, size=Mp,
                          dtype=np.int64).astype(np.int32),
              np.zeros(Mp, np.int32), np.full(Mp, -1, np.int32)]:
        for s, kk in [(0, 7), (31, 60)]:
            key = ((w.view(np.uint32) >> s) & 1).astype(np.uint8)
            a2, d2, w2, u, c = site_step(jnp.asarray(a), jnp.asarray(d[:Mp]),
                                         jnp.asarray(w), s, kk)
            a_ref, d_ref = engine.forwards_ad(a, d, key, kk)
            order = np.concatenate([np.nonzero(key == 0)[0],
                                    np.nonzero(key == 1)[0]])
            assert int(c) == int((key == 0).sum())
            assert np.array_equal(np.asarray(u), np.concatenate(
                [[0], np.cumsum(key == 0)])[:Mp])
            assert np.array_equal(np.asarray(a2), a_ref)
            assert np.array_equal(np.asarray(d2), d_ref[:Mp])
            assert np.array_equal(np.asarray(w2), w[order])


@pytest.mark.parametrize("seed,M", [(0, 24), (1, 30)])  # M=30: not lane-aligned
def test_device_match_equals_indexed(seed, M):
    from pbwt_tpu.algos import match as matchmod
    from pbwt_tpu.ops import match_jax
    Xp = mosaic(seed, M, 64)
    Xq = mosaic(seed + 10, 5, 64)
    rows_dev = match_jax.match_queries_device(Xp, Xq)
    p = PBWT.from_haplotypes(Xp)
    q = PBWT.from_haplotypes(Xq)
    rows_host = []
    matchmod.match_sequences_indexed(p, q,
                                     lambda a, b, s, e: rows_host.append((a, b, s, e)))
    dev = sorted(tuple(r) for r in np.asarray(rows_dev).tolist()
                 if r[2] != r[3])
    host = sorted(r for r in rows_host if r[2] != r[3])
    assert dev == host
