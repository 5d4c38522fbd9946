"""Exact host engine: vectorised prefix/divergence-array updates and cursors.

This is the bit-exact counterpart of the reference cursor engine
(pbwtCore.c:399-619).  All per-site inner loops over the M haplotypes are
vectorised numpy; semantics (including sentinel values and update order)
follow the reference exactly so that packed output is byte-identical.

The device engine (pbwt_tpu.ops) implements the same update as a
jit/scan program for throughput; this module is the reference-parity path
used by file I/O, the CLI and the golden tests.
"""

from __future__ import annotations

import os

import numpy as np

from . import pack3 as p3


# --------------------------------------------------------------------------
# core column updates (algorithms 1 and 2 of Durbin 2014)
# --------------------------------------------------------------------------

def forwards_a(a: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Algorithm 1 (pbwtCursorForwardsA, pbwtCore.c:458-470): stable
    partition of the prefix array by the binary allele column."""
    mask0 = y == 0
    return np.concatenate((a[mask0], a[~mask0]))


def backwards_a(a: np.ndarray, y: np.ndarray, c: int) -> np.ndarray:
    """Undo algorithm 1 (pbwtCursorBackwardsA, pbwtCore.c:472-483)."""
    M = a.shape[0]
    out = np.empty_like(a)
    mask0 = y == 0
    idx = np.empty(M, np.int64)
    idx[mask0] = np.arange(np.count_nonzero(mask0))
    idx[~mask0] = c + np.arange(M - np.count_nonzero(mask0))
    return a[idx]


def _segment_max(d: np.ndarray, positions: np.ndarray, init: int) -> np.ndarray:
    """For emission positions z_0<z_1<..., return for each j
    max(d[z_{j-1}+1 .. z_j]) with the first segment starting at 0 and
    seeded with ``init`` (the reference scans p=max(p,d[i]) for all i,
    resetting p to 0 after each emission - pbwtCursorForwardsAD)."""
    if positions.size == 0:
        return positions.astype(d.dtype)
    dd = np.concatenate((d, [0]))
    starts = np.concatenate(([0], positions[:-1] + 1, [positions[-1] + 1])).astype(np.int64)
    seg = np.maximum.reduceat(dd, starts)[:-1]
    seg[0] = max(seg[0], init)
    return seg


def forwards_ad(a: np.ndarray, d: np.ndarray, y: np.ndarray, k: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """Algorithm 2 (pbwtCursorForwardsAD, pbwtCore.c:485-508).

    ``d`` has M+1 entries; entries 0..M-1 participate in the scan, and the
    returned array carries the sentinels d[0]=d[M]=k+2 exactly as the
    reference sets them after the update.
    """
    M = a.shape[0]
    mask0 = y == 0
    z = np.flatnonzero(mask0)
    o = np.flatnonzero(~mask0)
    dd = d[:M]
    p = _segment_max(dd, z, k + 1)
    q = _segment_max(dd, o, k + 1)
    a_new = np.concatenate((a[z], a[o]))
    d_new = np.empty(M + 1, dtype=d.dtype)
    d_new[:z.size] = p
    d_new[z.size:M] = q
    d_new[0] = k + 2
    d_new[M] = k + 2
    return a_new, d_new


def calculate_u(y: np.ndarray) -> tuple[np.ndarray, int]:
    """Rank table (pbwtCursorCalculateU, pbwtCore.c:510-519):
    u[i] = number of zeros in y[0..i-1]; u[M] = c = total zeros."""
    M = y.shape[0]
    u = np.zeros(M + 1, dtype=np.int32)
    np.cumsum(y == 0, out=u[1:])
    return u, int(u[M])


def cursor_map(u: np.ndarray, c: int, x, i):
    """pbwtCursorMap (pbwt.h:130-131), vectorised over x and i:
    maps sorted position(s) i at site k to position(s) at site k+1 given
    allele value(s) x."""
    x = np.asarray(x)
    i = np.asarray(i)
    return np.where(x != 0, c + i - u[i], u[i])


def map_dplus(y: np.ndarray, d: np.ndarray, x, i, dplus):
    """pbwtCursorMapDplus (pbwt.h:132-135) for scalar args."""
    M = y.shape[0]
    i = int(i)
    dp = int(dplus)
    while i < M and y[i] != x:
        if d[i] > dp:
            dp = int(d[i])
        i += 1
    return dp


def map_dminus(y: np.ndarray, d: np.ndarray, x, i, dminus):
    """pbwtCursorMapDminus (pbwt.h:136-139) for scalar args."""
    i = int(i) - 1
    dm = int(dminus)
    while i >= 0 and y[i] != x:
        if d[i] > dm:
            dm = int(d[i])
        i -= 1
    return dm


# --------------------------------------------------------------------------
# cursors
# --------------------------------------------------------------------------

class ReadCursor:
    """Streaming read cursor over a packed PBWT (forward or reverse).

    Logical state: ``pos`` is the column whose sorted values are currently
    in ``y``; ``a`` is the prefix array entering that column.  This matches
    the reference PbwtCursor after pbwtCursorCreate(isStart=TRUE)
    (pbwtCore.c:420-445): column 0 pre-read, a = start index.
    """

    def __init__(self, Y: np.ndarray, a_init: np.ndarray):
        self.Y = Y                      # (N, M) uint8, sorted-order values
        self.N, self.M = Y.shape
        self.a = np.asarray(a_init, dtype=np.int32).copy()
        self.d = np.zeros(self.M + 1, dtype=np.int32)
        self.d[0] = 1
        self.d[self.M] = 1              # sentinels (pbwtNakedCursorCreate :414)
        self.pos = 0
        self.u: np.ndarray | None = None
        self.c = 0
        if self.N:
            self._load()

    def _load(self):
        self.y = self.Y[self.pos]
        self.c = int(np.count_nonzero(self.y == 0))
        self.u = None

    @classmethod
    def create(cls, p, forwards: bool = True, start: bool = True) -> "ReadCursor":
        """Mirror pbwtCursorCreate: pick decode buffer and anchor array."""
        Y = p.decoded(forwards)
        if forwards:
            a = p.aFstart if start else p.aFend
        else:
            a = p.aRstart if start else p.aRend
        if a is None:
            a = np.arange(p.M, dtype=np.int32)
        cur = cls(Y, a)
        if not start:               # cursor at end: nothing pre-read
            cur.pos = cur.N
        return cur

    def calculate_u(self):
        self.u, self.c = calculate_u(self.y)

    def forwards_read(self):
        """pbwtCursorForwardsRead (pbwtCore.c:527-541)."""
        self.a = forwards_a(self.a, self.y)
        self.pos += 1
        if self.pos < self.N:
            self._load()

    def forwards_read_ad(self, k: int):
        """pbwtCursorForwardsReadAD (pbwtCore.c:543-557)."""
        self.a, self.d = forwards_ad(self.a, self.d, self.y, k)
        self.pos += 1
        if self.pos < self.N:
            self._load()

    def read_backwards(self):
        """pbwtCursorReadBackwards (pbwtCore.c:559-571)."""
        if self.pos == 0:
            return
        self.pos -= 1
        self.y = self.Y[self.pos]
        self.c = int(np.count_nonzero(self.y == 0))
        self.u = None
        self.a = backwards_a(self.a, self.y, self.c)

    def x_natural(self) -> np.ndarray:
        """Current column in natural (original haplotype) order."""
        x = np.empty(self.M, dtype=np.uint8)
        x[self.a] = self.y
        return x


_WC_CHUNK_BYTES = 1 << 23       # natural-column buffer before a native flush


class WriteCursor:
    """Streaming write cursor: pack columns and advance the prefix array.

    Mirrors pbwtCursorWriteForwards[AD] (pbwtCore.c:573-585).

    Natural-order writes (``write_natural``, the hot loop of every text /
    VCF importer — pbwtIO.c:477-482) are buffered and flushed through the
    native chunk builder (native/pbwt_native.c build_pbwt) ~8 MB of columns
    at a time; reading ``a``/``n``/``packed()`` flushes first, so the
    buffering is invisible to callers.  ``y`` is only maintained by the
    ``write_forwards*`` paths.
    """

    def __init__(self, M: int, a_init: np.ndarray | None = None):
        self.M = M
        self._a = (np.arange(M, dtype=np.int32) if a_init is None
                   else np.ascontiguousarray(a_init, dtype=np.int32).copy())
        self.d = np.zeros(M + 1, dtype=np.int32)
        self.d[0] = 1
        self.d[M] = 1
        self.chunks: list[bytes] = []
        self.y = np.zeros(M, dtype=np.uint8)
        self._n = 0                     # bytes written so far
        self._nat_buf: np.ndarray | None = None
        self._nat_fill = 0
        self._nat_cols = max(1, _WC_CHUNK_BYTES // max(M, 1))
        self._use_native: bool | None = None

    # --- buffered-write bookkeeping ------------------------------------

    @property
    def a(self) -> np.ndarray:
        self.flush()
        return self._a

    @a.setter
    def a(self, value):
        self.flush()
        self._a = np.ascontiguousarray(value, dtype=np.int32)

    @property
    def n(self) -> int:
        self.flush()
        return self._n

    def flush(self) -> None:
        """Run any buffered natural-order columns through the native
        chunk builder, advancing the prefix array in place."""
        if not self._nat_fill:
            return
        cols = self._nat_buf[:self._nat_fill]
        self._nat_fill = 0
        from . import native
        chunk = native.build_pbwt_chunk(cols, self._a)
        if chunk is None:               # toolchain lost mid-stream: slow path
            for x in cols:
                self.write_forwards(x[self._a])
            return
        self.chunks.append(chunk)
        self._n += len(chunk)

    # --- writes ----------------------------------------------------------

    def write_forwards(self, y: np.ndarray | None = None):
        self.flush()
        if y is not None:
            self.y = np.asarray(y, dtype=np.uint8)
        if self._use_native is None:
            from . import native
            self._use_native = native.get_lib() is not None
        if self._use_native:
            from . import native
            chunk = native.pack_advance(self.y, self._a)   # advances _a
            if chunk is not None:
                self.chunks.append(chunk)
                self._n += len(chunk)
                return
        chunk = p3.pack3(self.y)
        self.chunks.append(chunk)
        self._n += len(chunk)
        self._a = forwards_a(self._a, self.y)

    def write_forwards_ad(self, k: int, y: np.ndarray | None = None):
        self.flush()
        if y is not None:
            self.y = np.asarray(y, dtype=np.uint8)
        chunk = p3.pack3(self.y)
        self.chunks.append(chunk)
        self._n += len(chunk)
        self._a, self.d = forwards_ad(self._a, self.d, self.y, k)

    def write_natural(self, x: np.ndarray):
        """Write a column given in natural order: y[j] = x[a[j]]."""
        if self._use_native is None:
            from . import native
            self._use_native = native.get_lib() is not None
        if not self._use_native:
            self.write_forwards(np.asarray(x, dtype=np.uint8)[self._a])
            return
        if self._nat_buf is None:
            self._nat_buf = np.empty((self._nat_cols, self.M), np.uint8)
        self._nat_buf[self._nat_fill] = x       # copy: callers may reuse x
        self._nat_fill += 1
        if self._nat_fill == self._nat_cols:
            self.flush()

    def packed(self) -> bytes:
        self.flush()
        return b"".join(self.chunks)


# --------------------------------------------------------------------------
# whole-matrix construction (vectorised over sites on the host)
# --------------------------------------------------------------------------

def build_from_haplotypes(X: np.ndarray, a_init: np.ndarray | None = None
                          ) -> tuple[bytes, np.ndarray]:
    """Build packed PBWT from an (M, N) haplotype matrix.

    Equivalent to streaming every column through a WriteCursor
    (the hot loop of every reference importer, e.g. pbwtIO.c:477-482).
    Returns (yz bytes, aFend).  Uses the native C runtime when available.
    """
    X = np.ascontiguousarray(X, dtype=np.uint8)
    M, N = X.shape
    a = np.arange(M, dtype=np.int32) if a_init is None else np.asarray(a_init, np.int32).copy()

    from ..ops import device_requested
    if device_requested() and a_init is None and M * N > 1 << 20:
        # route large builds through the device engine (byte-identical; see
        # tests/test_device_build.py)
        from ..ops.build import build_pbwt_device
        yz, a_end, _ = build_pbwt_device(X)
        return yz, a_end

    from . import native
    cols = native.transpose_u8(X)
    if cols is None:
        cols = np.ascontiguousarray(X.T)
    res = native.build_pbwt(cols, a)
    if res is not None:
        return res

    Ysort = np.empty((N, M), dtype=np.uint8)
    for k in range(N):
        y = X[a, k]
        Ysort[k] = y
        a = forwards_a(a, y)
    yz, _ = p3.pack_columns(Ysort)
    return yz, a


def haplotypes_from_packed(Y: np.ndarray, a_init: np.ndarray) -> np.ndarray:
    """Decompress sorted columns back to natural-order haplotypes
    (pbwtHaplotypes, pbwtCore.c:195-211).  Returns (M, N) uint8."""
    N, M = Y.shape
    X = np.empty((M, N), dtype=np.uint8)
    a = np.asarray(a_init, dtype=np.int32).copy()
    for k in range(N):
        X[a, k] = Y[k]
        a = forwards_a(a, Y[k])
    return X
