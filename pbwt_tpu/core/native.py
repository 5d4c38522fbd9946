"""ctypes bindings to the native host runtime (native/pbwt_native.c).

Compiled on first use with the system C compiler and cached next to the
package (a build product, never committed); every caller falls back to the
numpy implementations when the toolchain or the cached library is
unavailable, so the native layer is a pure accelerator, never a
correctness dependency.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native",
                    "pbwt_native.c")
_SO = os.path.join(_HERE, "_pbwt_native.so")

_lib = None
_tried = False


def _compile() -> bool:
    # build under a private name and rename into place, so processes that
    # build concurrently never load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cc = os.environ.get("CC", "cc")
    cmd = [cc, "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
           "-o", tmp, _SRC, "-lz"]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
        if res.returncode == 0:
            os.replace(tmp, _SO)
            return True
    except (OSError, subprocess.TimeoutExpired):
        pass
    if os.path.exists(tmp):
        os.unlink(tmp)
    return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("PBWT_TPU_NO_NATIVE"):
        return None
    try:
        if (not os.path.exists(_SO)
                or (os.path.exists(_SRC)
                    and os.path.getmtime(_SRC) > os.path.getmtime(_SO))):
            if not os.path.exists(_SRC) or not _compile():
                return None
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None

    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    L = ctypes.c_long
    lib.p3_encode.restype = L
    lib.p3_encode.argtypes = [u8p, L, u8p]
    lib.p3_encode_cols.restype = L
    lib.p3_encode_cols.argtypes = [u8p, L, L, u8p, i64p]
    lib.p3_decode_cols.restype = L
    lib.p3_decode_cols.argtypes = [u8p, L, L, L, u8p]
    lib.fwd_a.restype = L
    lib.fwd_a.argtypes = [i32p, u8p, i32p, L]
    lib.fwd_ad.restype = L
    lib.fwd_ad.argtypes = [i32p, i32p, u8p, i32p, i32p, L, ctypes.c_int32]
    lib.build_pbwt.restype = L
    lib.build_pbwt.argtypes = [u8p, L, L, i32p, u8p, L]
    lib.max_within.restype = L
    lib.max_within.argtypes = [u8p, L, L, i32p, i64p, L]
    lib.long_within.restype = L
    lib.long_within.argtypes = [u8p, L, L, L, i32p, i64p, L]
    lib.sweep_match.restype = L
    lib.sweep_match.argtypes = [u8p, L, u8p, L, L, i32p, i32p, i64p, L]
    lib.max_within_packed.restype = L
    lib.max_within_packed.argtypes = [u8p, L, L, L, i32p, i64p, L]
    lib.long_within_packed.restype = L
    lib.long_within_packed.argtypes = [u8p, L, L, L, L, i32p, i64p, L]
    lib.sweep_match_packed.restype = L
    lib.sweep_match_packed.argtypes = [u8p, L, L, u8p, L, L, L, i32p, i32p,
                                       i64p, L]
    lib.select_repack.restype = L
    lib.select_repack.argtypes = [u8p, L, L, L, u8p, i32p, u8p, L, i32p]
    lib.col_counts.restype = L
    lib.col_counts.argtypes = [u8p, L, L, L, i64p]
    lib.format_match_rows.restype = L
    lib.format_match_rows.argtypes = [i64p, L, u8p, L]
    lib.max_within_print.restype = L
    lib.max_within_print.argtypes = [u8p, L, L, L, i32p, ctypes.c_int]
    lib.max_within_bucket_count.restype = L
    lib.max_within_bucket_count.argtypes = [u8p, L, L, L, i32p, i64p]
    lib.max_within_bucket_fill.restype = L
    lib.max_within_bucket_fill.argtypes = [u8p, L, L, L, i32p, i32p, i32p,
                                           i32p, i64p]
    lib.long_within_print.restype = L
    lib.long_within_print.argtypes = [u8p, L, L, L, L, i32p, ctypes.c_int]
    lib.sweep_match_print.restype = L
    lib.sweep_match_print.argtypes = [u8p, L, L, u8p, L, L, L, i32p, i32p,
                                      ctypes.c_int, i64p]
    lib.subsample_repack.restype = L
    lib.subsample_repack.argtypes = [u8p, L, L, L, i64p, L, i32p, u8p, L,
                                     i32p]
    lib.transpose_u8.restype = None
    lib.transpose_u8.argtypes = [u8p, L, L, u8p]
    lib.expand_records.restype = L
    lib.expand_records.argtypes = [u8p, L, L, L, i64p, i32p, i32p, i32p,
                                   i32p, i32p, L]
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    lib.vcf_parse_gt.restype = L
    lib.vcf_parse_gt.argtypes = [ctypes.c_char_p, L, L, L, i8p]
    lib.phase_resolve.restype = None
    lib.phase_resolve.argtypes = [f64p, L, L, L, i32p, i32p, f64p, f64p,
                                  ctypes.c_double]
    lib.paint_accumulate.restype = None
    lib.paint_accumulate.argtypes = [i32p, i32p, i32p, i64p, L, L, L, L, L,
                                     ctypes.c_double, f64p, f64p, f64p,
                                     f64p, f64p, f64p]
    lib.paint_sparse_ind.restype = None
    lib.paint_sparse_ind.argtypes = [i32p, i32p, i32p, i64p, L, L, L, L, L,
                                     L, ctypes.c_double, f64p, f64p, f64p,
                                     f64p, f64p, f64p, f64p]
    lib.bucket_rows.restype = None
    lib.bucket_rows.argtypes = [i64p, L, L, i32p, i32p, i32p, i64p]
    lib.paint_sparse_all.restype = L
    lib.paint_sparse_all.argtypes = [i32p, i32p, i32p, i64p, L, L, L, L, L,
                                     ctypes.c_double, ctypes.c_char_p]
    lib.impute_vote.restype = None
    lib.impute_vote.argtypes = [i32p, i32p, i32p, i64p, i32p, L, L, u8p, L,
                                i64p, f64p, u8p, f64p, u8p, f64p, f64p,
                                f64p, i64p]
    lib.phase_stop_max.restype = None
    lib.phase_stop_max.argtypes = [i32p, u8p, ctypes.c_int, L, i64p, i64p]
    lib.expand_records_mt.restype = L
    lib.expand_records_mt.argtypes = [u8p, L, L, L, L, i64p, i32p, i64p,
                                      i32p, i32p, i32p, i32p, i64p, i32p]
    lib.natural_cols.restype = L
    lib.natural_cols.argtypes = [u8p, L, L, L, i32p, u8p, i64p]
    lib.impute_emit.restype = L
    lib.impute_emit.argtypes = [u8p, f64p, L, L, i32p, u8p, L, u8p, L,
                                i64p, i64p]
    lib.impute_vote_emit.restype = L
    lib.impute_vote_emit.argtypes = [u8p, L, L, L, i32p, i32p, i32p, i32p,
                                     i64p, i32p, L, i32p, i64p,
                                     L, u8p, L, i64p,
                                     u8p, L, u8p, L, i64p, f64p,
                                     f64p, f64p, f64p, i64p, i64p]
    lib.ref_phase4_core.restype = L
    lib.ref_phase4_core.argtypes = [u8p, L, L, u8p, L, L, L, i32p, i32p,
                                    i64p]
    lib.ref_phase4_heap.restype = None
    lib.ref_phase4_heap.argtypes = [i32p, u8p]
    lib.phase_sweep_core.restype = L
    lib.phase_sweep_core.argtypes = [u8p, L, L, L, i32p, L, u8p, L, i32p,
                                     i32p, L, i32p, L, f64p,
                                     ctypes.c_double, u8p, L, i32p, i32p]
    lib.crand_srand.restype = None
    lib.crand_srand.argtypes = [ctypes.c_uint32]
    lib.crand_next.restype = L
    lib.crand_next.argtypes = []
    lib.corrupt_sites_core.restype = L
    lib.corrupt_sites_core.argtypes = [u8p, L, L, L, i32p, L, L,
                                       ctypes.c_double, u8p, L, i32p, i64p]
    lib.corrupt_samples_core.restype = L
    lib.corrupt_samples_core.argtypes = [u8p, L, L, L, i32p, L, L,
                                         ctypes.c_double, u8p, L, i32p,
                                         i64p]
    lib.copy_samples_core.restype = L
    lib.copy_samples_core.argtypes = [u8p, L, L, L, i32p, L, L, u8p, L,
                                      i32p, i64p]
    lib.format_f4_row.restype = L
    lib.format_f4_row.argtypes = [f64p, L, ctypes.c_char_p]
    lib.format_f4_rows.restype = L
    lib.format_f4_rows.argtypes = [f64p, L, L, ctypes.c_char_p, i64p]
    lib.merge_core.restype = L
    lib.merge_core.argtypes = [L, ctypes.POINTER(ctypes.c_void_p), i64p,
                               i64p, i64p, u8p, i64p, i32p, L, i32p, u8p, L]
    lib.segs_sort.restype = L
    lib.segs_sort.argtypes = [i64p, L, L, i32p, i32p, i32p, i64p]
    lib.buckets_sort_start.restype = L
    lib.buckets_sort_start.argtypes = [i32p, i32p, i32p, i64p, L]
    lib.build_reverse_core.restype = L
    lib.build_reverse_core.argtypes = [u8p, L, L, L, i32p, u8p, L, i32p]
    lib.gtcompare_core.restype = L
    lib.gtcompare_core.argtypes = [u8p, L, u8p, L, L, L, i32p, i32p,
                                   f64p, f64p, f64p, L, i64p, i64p,
                                   f64p, i64p, f64p, i64p]
    lib.phase_compare_core.restype = L
    lib.phase_compare_core.argtypes = [u8p, L, u8p, L, L, L, i32p, i32p,
                                       i64p, i64p, i64p]
    _lib = lib
    return _lib


# --------------------------------------------------------------------------
# high-level wrappers (None return = use the numpy fallback)
# --------------------------------------------------------------------------

_transpose_pool: dict[tuple, np.ndarray] = {}
_buffer_pool: dict[str, np.ndarray] = {}


def pooled(nbytes: int, tag: str) -> np.ndarray:
    """Process-lifetime scratch buffer of >= nbytes uint8, keyed by tag.

    Sandboxed containers fault fresh pages in at ~15-80 MB/s, an order of
    magnitude slower than the compute that fills them; reusing one buffer
    per call-site keeps large temporaries warm. Callers must not hold the
    result across calls with the same tag."""
    buf = _buffer_pool.get(tag)
    if buf is None or buf.nbytes < nbytes:
        buf = np.empty(nbytes, np.uint8)
        buf.fill(0)                      # fault pages in once
        _buffer_pool[tag] = buf
    return buf


def pooled_view(shape, dtype, tag: str) -> np.ndarray:
    n = int(np.prod(shape)) * np.dtype(dtype).itemsize
    return pooled(n, tag)[:n].view(dtype).reshape(shape)


def transpose_u8(X: np.ndarray):
    """Cache-blocked (R, C) -> (C, R) uint8 transpose, or None.

    The output buffer is pooled per shape: fresh multi-MB allocations fault
    in at ~80 MB/s in sandboxed containers, an order of magnitude slower
    than the transpose itself.  Callers must treat the result as scratch
    (engine.build_from_haplotypes consumes and discards it)."""
    lib = get_lib()
    if lib is None:
        return None
    X = np.ascontiguousarray(X, np.uint8)
    R, C = X.shape
    out = _transpose_pool.get((C, R))
    if out is None:
        out = np.empty((C, R), np.uint8)
        _transpose_pool.clear()
        _transpose_pool[(C, R)] = out
    lib.transpose_u8(X, R, C, out)
    return out


def build_pbwt(cols: np.ndarray, a0: np.ndarray):
    """cols (N, M) site-major natural-order -> (yz bytes, aFend) or None."""
    lib = get_lib()
    if lib is None:
        return None
    N, M = cols.shape
    cols = np.ascontiguousarray(cols, np.uint8)
    a = np.ascontiguousarray(a0, np.int32).copy()
    cap = max(1024, N * (M // 32 + 8))
    while True:
        yz = np.empty(cap, np.uint8)
        a_try = a.copy()
        n = lib.build_pbwt(cols, M, N, a_try, yz, cap)
        if n <= cap:
            return yz[:n].tobytes(), a_try
        cap = n


def build_pbwt_chunk(cols: np.ndarray, a: np.ndarray):
    """Advance ``a`` IN PLACE through ``cols`` ((ncols, M) natural-order
    values), returning the pack3 bytes for those columns, or None when the
    native library is unavailable.

    This is the streaming-cursor fast path (engine.WriteCursor buffers
    natural-order columns and flushes them here): one C call per ~8 MB of
    buffered columns replaces the per-site python permute + pack3 +
    partition that mirrors pbwtCursorWriteForwards (pbwtCore.c:573-585).
    ``a`` must be int32 and C-contiguous."""
    lib = get_lib()
    if lib is None:
        return None
    ncols, M = cols.shape
    cols = np.ascontiguousarray(cols, np.uint8)
    # pack3 never emits more than one byte per encoded symbol, so
    # ncols * (M + 8) bounds the output (run buffer sizing in the C side)
    cap = ncols * (M + 8) + 16
    yz = pooled(cap, "build_chunk")
    n = lib.build_pbwt(cols, M, ncols, a, yz, cap)
    if n > cap:
        raise AssertionError("pack3 chunk overflowed its worst-case bound")
    return yz[:n].tobytes()


def _corrupt_call(fn_name, yzold: bytes, M: int, N: int, a0: np.ndarray,
                  args: tuple, M_new: int | None = None):
    lib = get_lib()
    if lib is None:
        return None
    z = np.frombuffer(bytes(yzold), np.uint8)
    Mout = M_new if M_new is not None else M
    cap = N * (Mout + 8) + 16
    yz = pooled(cap, "corrupt_yz")
    a_end = np.empty(Mout, np.int32)
    lens = np.empty(1, np.int64)
    rc = getattr(lib, fn_name)(z, len(z), M, N,
                               np.ascontiguousarray(a0, np.int32),
                               *args, yz, cap, a_end, lens)
    if rc < 0:
        raise ValueError(f"{fn_name}: corrupt stream or overflow")
    return yz[:lens[0]].tobytes(), a_end, int(rc)


def corrupt_sites_core(yzold, M, N, a0, r_site, r_change, r_fac):
    """pbwtCorruptSites streaming core; (yz, a_end, n_change) or None."""
    return _corrupt_call("corrupt_sites_core", yzold, M, N, a0,
                         (r_site, r_change, float(r_fac)))


def corrupt_samples_core(yzold, M, N, a0, r_sample, r_change, r_fac):
    """pbwtCorruptSamples streaming core; (yz, a_end, n_change) or None."""
    return _corrupt_call("corrupt_samples_core", yzold, M, N, a0,
                         (r_sample, r_change, float(r_fac)))


def copy_samples_core(yzold, M_old, N, a0, m_new, r_switch):
    """pbwtCopySamples streaming core; (yz, a_end, 0) or None."""
    return _corrupt_call("copy_samples_core", yzold, M_old, N, a0,
                         (m_new, r_switch), M_new=m_new)


def phase_sweep_core(yzp: bytes, M: int, N: int, ap0: np.ndarray,
                     is_start: bool, r_yz: bytes | None, ar0, rbinv0,
                     aq0, n_sparse: int, score_bit: np.ndarray,
                     thresh: float):
    """One whole phaseSweep pass (pbwtImpute.c:288-372) in C.

    Returns (yz bytes, aq_end, bq_end) or None when the native library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    zp = np.frombuffer(bytes(yzp), np.uint8)
    zr = np.frombuffer(bytes(r_yz) if r_yz else b"\x00", np.uint8)
    dummy = np.zeros(1, np.int32)
    ap0 = np.ascontiguousarray(ap0, np.int32)
    ar0 = (np.ascontiguousarray(ar0, np.int32) if ar0 is not None
           else dummy)
    rbinv0 = (np.ascontiguousarray(rbinv0, np.int32) if rbinv0 is not None
              else dummy)
    aq0 = (np.ascontiguousarray(aq0, np.int32) if aq0 is not None
           else np.arange(M, dtype=np.int32))
    cap = N * (M + 8) + 16
    yz = pooled(cap, "phase_sweep_yz")
    aq_end = np.empty(M, np.int32)
    bq_end = np.empty(M, np.int32)
    n = lib.phase_sweep_core(
        zp, len(zp), M, N, ap0, 1 if is_start else 0,
        zr, len(zr), ar0, rbinv0, 1 if r_yz else 0,
        aq0, n_sparse, np.ascontiguousarray(score_bit, np.float64),
        float(thresh), yz, cap, aq_end, bq_end)
    if n < 0:
        raise ValueError("phase_sweep_core: corrupt stream or overflow")
    return yz[:n].tobytes(), aq_end, bq_end


def ref_phase4_core(yzold: bytes, Mold: int, yzref: bytes, Mref: int,
                    N: int, aold0: np.ndarray, aref0: np.ndarray):
    """The referencePhase4 forward lattice (pbwtImpute.c:905-1005) as one
    streaming C pass.  Returns (tb int64[n_pairs] — the traceback root of
    each diploid's best final cell — tb_parent int32[n], tb_value uint8[n])
    or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    bo = np.frombuffer(bytes(yzold), np.uint8)
    br = np.frombuffer(bytes(yzref), np.uint8)
    n_pairs = Mold // 2
    tb = np.empty(n_pairs, np.int64)
    n = lib.ref_phase4_core(bo, len(bo), Mold, br, len(br), Mref, N,
                            np.ascontiguousarray(aold0, np.int32),
                            np.ascontiguousarray(aref0, np.int32), tb)
    if n < 0:
        raise ValueError("ref_phase4_core: corrupt pack3 stream")
    parent = np.empty(n, np.int32)
    value = np.empty(n, np.uint8)
    lib.ref_phase4_heap(parent, value)
    return tb, parent, value


def format_f4_row(vals: np.ndarray):
    """One table row as ' %.4f' per value (glibc printf semantics, like
    the reference's fprintf loops), or None."""
    lib = get_lib()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, np.float64)
    buf = ctypes.create_string_buffer(16 * len(vals) + 16)
    n = lib.format_f4_row(vals, len(vals), buf)
    return buf.raw[:n].decode()


def format_f4_rows(table: np.ndarray):
    """Whole (R, C) table as per-row ' %.4f' strings in ONE native call
    (the per-row ctypes overhead dominated -paint's emitters).  Returns a
    list of R strings, or None."""
    lib = get_lib()
    if lib is None:
        return None
    table = np.ascontiguousarray(table, np.float64)
    R, C = table.shape
    buf = pooled(16 * R * C + 16, "fmt_f4_rows")
    offs = np.empty(R + 1, np.int64)
    lib.format_f4_rows(table.reshape(-1), R, C,
                       buf.ctypes.data_as(ctypes.c_char_p), offs)
    raw = bytes(buf[:offs[R]])
    return [raw[offs[r]:offs[r + 1]].decode() for r in range(R)]


def pack_advance(y: np.ndarray, a: np.ndarray):
    """One write-cursor step (pbwtCursorWriteForwards, pbwtCore.c:573-578):
    pack3-encode the sorted column and advance ``a`` IN PLACE.  Returns the
    packed bytes, or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    y = np.ascontiguousarray(y, np.uint8)
    M = y.shape[0]
    out = pooled(M + 8, "pack_adv_out")
    nb = lib.p3_encode(y, M, out)
    ones = pooled_view(M, np.int32, "pack_adv_ones")
    lib.fwd_a(a, y, ones, M)
    return out[:nb].tobytes()


def merge_core(yzs: list[bytes], Ms: list[int], a0s: list[np.ndarray],
               acts: list[np.ndarray], n_emit: int):
    """Multi-PBWT merge (pbwtMerge.c:129-208) as one streaming C pass.

    yzs/Ms/a0s: per input file, the pack3 stream, haplotype count and
    starting prefix array; acts[f] is the file's action stream over its
    consumed columns in order (1 = column of an emitted shared site,
    0 = discard) with exactly n_emit ones.  Returns (yz, a_end) for the
    merged PBWT, or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    nf = len(yzs)
    Mtot = int(sum(Ms))
    # zero-copy input streams: per-file pointers into the caller's own
    # bytes objects (kept alive by `views` for the duration of the call)
    views = [np.frombuffer(z, np.uint8) for z in yzs]
    ptrs = (ctypes.c_void_p * nf)(*[v.ctypes.data for v in views])
    nzs = np.asarray([len(v) for v in views], np.int64)
    Ms_arr = np.asarray(Ms, np.int64)
    a_off = np.zeros(nf + 1, np.int64)
    np.cumsum(Ms_arr, out=a_off[1:])
    a_all = np.concatenate([np.ascontiguousarray(a, np.int32)
                            for a in a0s])
    act_all = np.concatenate([np.ascontiguousarray(a, np.uint8)
                              for a in acts]) if acts else np.zeros(0, np.uint8)
    act_off = np.zeros(nf + 1, np.int64)
    np.cumsum([len(a) for a in acts], out=act_off[1:])
    a_out = np.arange(Mtot, dtype=np.int32)
    # shared emitted sites re-encode to about their input footprint; the
    # retry loop covers the pathological case
    cap = int(nzs.sum() + 32 * n_emit + 65536)
    while True:
        yz_out = np.empty(cap, np.uint8)
        n = lib.merge_core(nf, ptrs, nzs, Ms_arr, a_off, act_all,
                           act_off, a_all.copy(), n_emit, a_out, yz_out, cap)
        if n < 0:
            raise ValueError("merge_core: corrupt pack3 stream")
        if n <= cap:
            return yz_out[:n].tobytes(), a_out
        cap = int(n)
        a_out = np.arange(Mtot, dtype=np.int32)


def natural_cols(yz: bytes, ncols: int, M: int, a0: np.ndarray,
                 start: int = 0, with_pos: bool = False):
    """Stream a packed PBWT into site-major NATURAL-order columns.

    Returns (X (ncols, M) uint8, a_end, ones_per_col int64) or None — or,
    with ``with_pos``, (X, a_end, counts, next_start) so a caller can
    stream the panel in site chunks with O(M * chunk) live bytes (pass the
    advanced ``a_end`` back as ``a0`` and ``next_start`` as ``start``).
    One C pass (decode + scatter + prefix advance) replaces
    decode-everything + a python a-chase + a transpose."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(bytes(yz), np.uint8)[start:]
    a = np.ascontiguousarray(a0, np.int32).copy()
    X = np.empty((ncols, M), np.uint8)
    counts = np.empty(ncols, np.int64)
    used = lib.natural_cols(buf, len(buf), ncols, M, a, X.reshape(-1), counts)
    if used < 0:
        raise ValueError("corrupt pack3 stream")
    if with_pos:
        return X, a, counts, start + int(used)
    return X, a, counts


def segs_sort(rows: np.ndarray, T: int):
    """Match rows (n, 4) int64 [j, jr, s, e] -> per-target start-sorted
    i32 columns (jr, s, e) + seg_off (T+1,) int64, in one C pass.
    Returns None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int64)
    n = len(rows)
    jr = np.empty(n, np.int32)
    s = np.empty(n, np.int32)
    e = np.empty(n, np.int32)
    seg_off = np.empty(T + 1, np.int64)
    if lib.segs_sort(rows.reshape(-1), n, T, jr, s, e, seg_off) < 0:
        raise MemoryError("segs_sort")
    return jr, s, e, seg_off


def phase_compare_core(yzp: bytes, yzq: bytes, M: int, N: int,
                       ap0: np.ndarray, aq0: np.ndarray):
    """phaseCompare's per-pair switch scan as one streaming C pass.
    Returns (n_switch, n_het, n_switch1, n_switch5, n_switch_sample,
    n_switch_site) or None."""
    lib = get_lib()
    if lib is None:
        return None
    bp = np.frombuffer(bytes(yzp), np.uint8)
    bq = np.frombuffer(bytes(yzq), np.uint8)
    out4 = np.zeros(4, np.int64)
    nss = np.zeros(M // 2, np.int64)
    nsk = np.zeros(N, np.int64)
    if lib.phase_compare_core(bp, len(bp), bq, len(bq), M, N,
                              np.ascontiguousarray(ap0, np.int32),
                              np.ascontiguousarray(aq0, np.int32),
                              out4, nss, nsk) < 0:
        raise ValueError("phase_compare_core: corrupt pack3 stream")
    return (int(out4[0]), int(out4[1]), int(out4[2]), int(out4[3]),
            nss, nsk)


def gtcompare_core(yzp: bytes, yzq: bytes, M: int, N: int,
                   ap0: np.ndarray, aq0: np.ndarray, rf: np.ndarray,
                   ii: np.ndarray, fbound: np.ndarray):
    """genotypeCompare counting (pbwtImpute.c:1398-1438) as one streaming
    C pass over both packed panels.  Returns (n (17, 9), ns9 (M//2, 9),
    fsum, nsum, isum, ni) or None."""
    lib = get_lib()
    if lib is None:
        return None
    bp = np.frombuffer(bytes(yzp), np.uint8)
    bq = np.frombuffer(bytes(yzq), np.uint8)
    nb = len(fbound)
    n = np.zeros(nb * 9, np.int64)
    ns9 = np.zeros((M // 2) * 9, np.int64)
    fsum = np.zeros(nb)
    nsum = np.zeros(nb, np.int64)
    isum = np.zeros(nb)
    ni = np.zeros(nb, np.int64)
    rc = lib.gtcompare_core(bp, len(bp), bq, len(bq), M, N,
                            np.ascontiguousarray(ap0, np.int32),
                            np.ascontiguousarray(aq0, np.int32),
                            np.ascontiguousarray(rf, np.float64),
                            np.ascontiguousarray(ii, np.float64),
                            np.ascontiguousarray(fbound, np.float64), nb,
                            n, ns9, fsum, nsum, isum, ni)
    if rc < 0:
        raise ValueError("gtcompare_core: corrupt pack3 stream")
    return (n.reshape(nb, 9), ns9.reshape(M // 2, 9), fsum, nsum, isum,
            ni)


def build_reverse_core(yz: bytes, M: int, N: int, aFend: np.ndarray):
    """pbwtBuildReverse as one C pass (offsets skim + backward stream +
    fused gather/encode/partition emit).  Returns (zz bytes, aRend) or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(bytes(yz), np.uint8)
    a_end = np.ascontiguousarray(aFend, np.int32)
    cap = len(buf) + 16 * N + 65536
    while True:
        zz = np.empty(cap, np.uint8)
        arend = a_end.copy()
        n = lib.build_reverse_core(buf, len(buf), M, N, a_end, zz, cap,
                                   arend)
        if n < 0:
            raise ValueError("build_reverse_core: corrupt pack3 stream")
        if n <= cap:
            return zz[:n].tobytes(), arend
        cap = int(n)


def buckets_sort_start(sj: np.ndarray, ss: np.ndarray, se: np.ndarray,
                       seg_off: np.ndarray) -> bool:
    """Sort already-bucketed (donor, start, end) runs by start, in place
    (one C pass).  Returns False when the native library is missing."""
    lib = get_lib()
    if lib is None:
        return False
    T = len(seg_off) - 1
    if lib.buckets_sort_start(sj, ss, se,
                              np.ascontiguousarray(seg_off, np.int64),
                              T) < 0:
        raise MemoryError("buckets_sort_start")
    return True


def impute_vote_emit(yzref: bytes, Mref: int, Nref: int, a_ref0: np.ndarray,
                     segments: np.ndarray, seg_off: np.ndarray, T: int,
                     kold: np.ndarray, zmiss: bytes | None = None,
                     miss_off: np.ndarray | None = None,
                     seg_cols=None):
    """The whole referenceImpute3 core (pbwtImpute.c:1184-1251) as one
    streaming C pass with O(Mref + T) live memory: decode panel column →
    natural scatter → weighted vote per target → pack3 + dosage-RLE emit →
    advance both prefix arrays.  segments (n, 4) [j, j_ref, start, end]
    must be sorted by (j, start).

    Self-impute mode (imputeMissing, pbwtImpute.c:1323-1371): pass the
    panel's missing stream (zmiss + per-site offsets, offset 0 = none);
    complete entries copy straight through and only missing entries vote.

    Returns (yz, zdosage, dos_off, ref_freq, psums, xsums, pxsums, nvote,
    n_conflicts, a_tgt_end) or None when the native library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(bytes(yzref), np.uint8)
    a_ref = np.ascontiguousarray(a_ref0, np.int32).copy()
    a_tgt = np.arange(T, dtype=np.int32)
    first = seg_off[:-1].astype(np.int32)
    self_mode = 1 if miss_off is not None else 0
    zm = np.frombuffer(zmiss if zmiss else b"\x00", np.uint8)
    mo = (np.ascontiguousarray(miss_off, np.int64) if miss_off is not None
          else np.zeros(Nref, np.int64))
    yz_cap = Nref * (T + 8) + 16
    zdos_cap = Nref * (T + T // 4 + 16) + 16
    yz = pooled(yz_cap, "impute_emit_yz")
    zdos = pooled(zdos_cap, "impute_emit_zdos")
    dos_off = np.empty(Nref, np.int64)
    ref_freq = np.empty(Nref, np.float64)
    psums = np.empty(Nref, np.float64)
    xsums = np.empty(Nref, np.float64)
    pxsums = np.empty(Nref, np.float64)
    nvote = np.empty(Nref, np.int64)
    lens = np.empty(2, np.int64)
    if seg_cols is not None:
        jr_c, s_c, e_c = seg_cols
    else:
        jr_c = np.ascontiguousarray(segments[:, 1], np.int32)
        s_c = np.ascontiguousarray(segments[:, 2], np.int32)
        e_c = np.ascontiguousarray(segments[:, 3], np.int32)
    conflicts = lib.impute_vote_emit(
        buf, len(buf), Mref, Nref, a_ref, jr_c, s_c, e_c,
        np.ascontiguousarray(seg_off, np.int64), first, T, a_tgt, kold,
        self_mode, zm, len(zm), mo,
        yz, yz_cap, zdos, zdos_cap, dos_off, ref_freq,
        psums, xsums, pxsums, nvote, lens)
    if conflicts < 0:
        raise ValueError("impute_vote_emit: corrupt stream or overflow")
    return (yz[:lens[0]].tobytes(), zdos[:lens[1]].tobytes(), dos_off,
            ref_freq, psums, xsums, pxsums, nvote, int(conflicts), a_tgt)


def impute_emit(x_all: np.ndarray, dos_all: np.ndarray, a0: np.ndarray):
    """referenceImpute3 output stage (pbwtImpute.c:1235-1249): per site,
    gather to sort order, pack3 the alleles, RLE the quantised dosages,
    advance the prefix array.  x_all/dos_all are site-major (Nref, T).

    Returns (yz bytes, zdosage bytes, dosage_offsets int64, a_end) or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    Nref, T = x_all.shape
    x_all = np.ascontiguousarray(x_all, np.uint8)
    dos_all = np.ascontiguousarray(dos_all, np.float64)
    a = np.ascontiguousarray(a0, np.int32).copy()
    yz_cap = Nref * (T + 8) + 16
    # dosage worst case: <=1 byte/element for short runs; long zero runs
    # add <=3 escape bytes each and there are <= T/32 of those per site
    zdos_cap = Nref * (T + T // 4 + 16) + 16
    yz = pooled(yz_cap, "impute_emit_yz")
    zdos = pooled(zdos_cap, "impute_emit_zdos")
    dos_off = np.empty(Nref, np.int64)
    lens = np.empty(2, np.int64)
    rc = lib.impute_emit(x_all.reshape(-1), dos_all.reshape(-1), T, Nref, a,
                         yz, yz_cap, zdos, zdos_cap, dos_off, lens)
    if rc < 0:
        raise AssertionError("impute_emit overflowed its worst-case bound")
    return yz[:lens[0]].tobytes(), zdos[:lens[1]].tobytes(), dos_off, a


def decode_cols(yz: bytes, ncols: int, M: int):
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(bytes(yz), np.uint8)
    # decoded() caches the result on the PBWT, so this buffer must be owned
    # by the caller: pool only the page-fault cost via a warm template when
    # the same shape repeats (pooled buffers themselves can't be handed out)
    Y = np.empty((ncols, M), np.uint8)
    used = lib.p3_decode_cols(buf, len(buf), ncols, M, Y.reshape(-1))
    if used < 0:
        raise ValueError("corrupt pack3 stream")
    return Y


def encode_cols(Y: np.ndarray):
    lib = get_lib()
    if lib is None:
        return None
    Y = np.ascontiguousarray(Y, np.uint8)
    ncols, M = Y.shape
    out = np.empty(ncols * (M + 8) + 16, np.uint8)
    offsets = np.empty(ncols + 1, np.int64)
    n = lib.p3_encode_cols(Y.reshape(-1), ncols, M, out, offsets)
    return out[:n].tobytes(), offsets


def max_within(Ysort: np.ndarray, a0: np.ndarray):
    """All set-maximal within-panel match reports as an (n, 4) int64 array
    in reference scan order, or None."""
    lib = get_lib()
    if lib is None:
        return None
    N, M = Ysort.shape
    Ysort = np.ascontiguousarray(Ysort, np.uint8)
    a0 = np.ascontiguousarray(a0, np.int32)
    cap = max(4096, 8 * M)
    while True:
        out = np.empty((cap, 4), np.int64)
        n = lib.max_within(Ysort.reshape(-1), M, N, a0, out.reshape(-1), cap)
        if n <= cap:
            return out[:n]
        cap = n


def long_within(Ysort: np.ndarray, T: int, a0: np.ndarray):
    """Long-match (> T) reports as an (n, 4) int64 array in reference scan
    order, or None."""
    lib = get_lib()
    if lib is None:
        return None
    N, M = Ysort.shape
    Ysort = np.ascontiguousarray(Ysort, np.uint8)
    a0 = np.ascontiguousarray(a0, np.int32)
    cap = max(4096, 8 * M)
    while True:
        out = np.empty((cap, 4), np.int64)
        n = lib.long_within(Ysort.reshape(-1), M, N, T, a0,
                            out.reshape(-1), cap)
        if n <= cap:
            return out[:n]
        cap = n


def max_within_bucketed(yz: bytes, M: int, N: int, a0: np.ndarray):
    """Two-pass maxWithin straight into per-recipient buckets: returns
    (seg_j, seg_s, seg_e, seg_off) in the reference's per-recipient report
    order without ever holding the (n, 4) int64 row set - peak memory is
    3n int32 (the painting consumers' own layout) at the cost of a second
    streaming pass over the pack3 bytes.  None when the library is
    unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "max_within_bucket_count"):
        return None
    z = np.frombuffer(yz, np.uint8)
    a0 = np.ascontiguousarray(a0, np.int32)
    off = np.zeros(M + 1, np.int64)
    n = lib.max_within_bucket_count(z, len(z), M, N, a0, off)
    if n < 0:
        return None
    sj = pooled_view((max(n, 1),), np.int32, "paint:sj")
    ss = pooled_view((max(n, 1),), np.int32, "paint:ss")
    se = pooled_view((max(n, 1),), np.int32, "paint:se")
    n2 = lib.max_within_bucket_fill(z, len(z), M, N, a0, sj, ss, se, off)
    if n2 != n:
        return None
    return sj[:n], ss[:n], se[:n], off


def max_within_packed(yz: bytes, M: int, N: int, a0: np.ndarray):
    """max_within streaming the pack3 bytes directly (O(M) live memory,
    like the reference cursor model); (n, 4) int64 rows or None."""
    lib = get_lib()
    if lib is None:
        return None
    z = np.frombuffer(yz, np.uint8)
    a0 = np.ascontiguousarray(a0, np.int32)
    cap = max(4096, 8 * M)
    while True:
        out = pooled_view((cap, 4), np.int64, "rows:max_within")
        n = lib.max_within_packed(z, len(z), M, N, a0, out.reshape(-1), cap)
        if n < 0:
            return None
        if n <= cap:
            return out[:n]
        cap = n


def long_within_packed(yz: bytes, T: int, M: int, N: int, a0: np.ndarray):
    """long_within streaming the pack3 bytes; (n, 4) int64 rows or None."""
    lib = get_lib()
    if lib is None:
        return None
    z = np.frombuffer(yz, np.uint8)
    a0 = np.ascontiguousarray(a0, np.int32)
    cap = max(4096, 8 * M)
    while True:
        out = pooled_view((cap, 4), np.int64, "rows:long_within")
        n = lib.long_within_packed(z, len(z), M, N, T, a0,
                                   out.reshape(-1), cap)
        if n < 0:
            return None
        if n <= cap:
            return out[:n]
        cap = n


def sweep_match_packed(yzp: bytes, M: int, yzq: bytes, Q: int, N: int,
                       ap0: np.ndarray, aq0: np.ndarray):
    """Dynamic sweep matcher streaming both pack3 streams; rows or None."""
    lib = get_lib()
    if lib is None:
        return None
    zp = np.frombuffer(yzp, np.uint8)
    zq = np.frombuffer(yzq, np.uint8)
    ap0 = np.ascontiguousarray(ap0, np.int32)
    aq0 = np.ascontiguousarray(aq0, np.int32)
    cap = max(4096, 8 * Q + N)
    while True:
        out = pooled_view((cap, 4), np.int64, "rows:sweep")
        n = lib.sweep_match_packed(zp, len(zp), M, zq, len(zq), Q, N,
                                   ap0, aq0, out.reshape(-1), cap)
        if n < 0:
            return None
        if n <= cap:
            return out[:n]
        cap = n


def select_repack(yz: bytes, M: int, N: int, keep: np.ndarray,
                  a0: np.ndarray):
    """Stream-select sites keep[k] != 0 and re-PBWT; (yz', a_end) or None."""
    lib = get_lib()
    if lib is None:
        return None
    z = np.frombuffer(yz, np.uint8)
    keep = np.ascontiguousarray(keep, np.uint8)
    a0 = np.ascontiguousarray(a0, np.int32)
    a_end = np.empty(M, np.int32)
    cap = max(len(z) + 16, 4096)
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.select_repack(z, len(z), M, N, keep, a0, out, cap, a_end)
        if n < 0:
            return None
        if n <= cap:
            return out[:n].tobytes(), a_end
        cap = n


def _stdout_fd(stream) -> int:
    """File descriptor of a real stdout, or -1 when redirected in-process."""
    try:
        return stream.fileno()
    except (OSError, AttributeError, ValueError):
        return -1


def max_within_print(yz: bytes, M: int, N: int, a0: np.ndarray, fd: int):
    """Stream MATCH lines for all set-maximal matches straight to fd
    (never materialising the row set); returns report count or None."""
    lib = get_lib()
    if lib is None:
        return None
    z = np.frombuffer(yz, np.uint8)
    a0 = np.ascontiguousarray(a0, np.int32)
    n = lib.max_within_print(z, len(z), M, N, a0, fd)
    return None if n < 0 else n


def long_within_print(yz: bytes, T: int, M: int, N: int, a0: np.ndarray,
                      fd: int):
    lib = get_lib()
    if lib is None:
        return None
    z = np.frombuffer(yz, np.uint8)
    a0 = np.ascontiguousarray(a0, np.int32)
    n = lib.long_within_print(z, len(z), M, N, T, a0, fd)
    return None if n < 0 else n


def sweep_match_print(yzp: bytes, M: int, yzq: bytes, Q: int, N: int,
                      ap0: np.ndarray, aq0: np.ndarray, fd: int):
    """Stream sweep MATCH lines to fd; returns (n_reports, tot_len,
    n_nonzero) or None."""
    lib = get_lib()
    if lib is None:
        return None
    zp = np.frombuffer(yzp, np.uint8)
    zq = np.frombuffer(yzq, np.uint8)
    stats = np.zeros(3, np.int64)
    n = lib.sweep_match_print(zp, len(zp), M, zq, len(zq), Q, N,
                              np.ascontiguousarray(ap0, np.int32),
                              np.ascontiguousarray(aq0, np.int32), fd, stats)
    if n < 0:
        return None
    return int(stats[0]), int(stats[1]), int(stats[2])


def write_match_rows(rows: np.ndarray, out) -> bool:
    """Bulk-format (n, 4) match rows as MATCH lines into the binary stream
    ``out`` (chunked); returns False when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    rows = np.ascontiguousarray(rows, np.int64)
    CHUNK = 1 << 21
    for i0 in range(0, len(rows), CHUNK):
        part = rows[i0:i0 + CHUNK]
        cap = 144 * len(part)
        buf = pooled_view((cap,), np.uint8, "rows:fmt")
        n = lib.format_match_rows(part.reshape(-1), len(part), buf, cap)
        out.write(buf[:n].tobytes())
    return True


def col_counts(yz: bytes, M: int, N: int):
    """Per-site zero counts straight off the run-length bytes, or None."""
    lib = get_lib()
    if lib is None:
        return None
    z = np.frombuffer(yz, np.uint8)
    c0 = np.empty(N, np.int64)
    if lib.col_counts(z, len(z), M, N, c0) < 0:
        return None
    return c0


def subsample_repack(yz: bytes, M: int, N: int, select: np.ndarray,
                     a0: np.ndarray):
    """Stream-re-PBWT a haplotype selection; (yz', a_end) or None."""
    lib = get_lib()
    if lib is None:
        return None
    z = np.frombuffer(yz, np.uint8)
    select = np.ascontiguousarray(select, np.int64)
    a0 = np.ascontiguousarray(a0, np.int32)
    Mnew = len(select)
    a_end = np.empty(Mnew, np.int32)
    cap = max(len(z) + 16, 4096)
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.subsample_repack(z, len(z), M, N, select, Mnew, a0, out,
                                 cap, a_end)
        if n < 0:
            return None
        if n <= cap:
            return out[:n].tobytes(), a_end
        cap = n


def sweep_match(Ysp: np.ndarray, ap0: np.ndarray, Ysq: np.ndarray,
                aq0: np.ndarray):
    """Dynamic sweep query-vs-panel match reports (n, 4) int64, or None."""
    lib = get_lib()
    if lib is None:
        return None
    N, M = Ysp.shape
    Nq, Q = Ysq.shape
    assert N == Nq
    cap = max(4096, 8 * Q + N)
    while True:
        out = np.empty((cap, 4), np.int64)
        n = lib.sweep_match(np.ascontiguousarray(Ysp, np.uint8).reshape(-1), M,
                            np.ascontiguousarray(Ysq, np.uint8).reshape(-1), Q,
                            N, np.ascontiguousarray(ap0, np.int32),
                            np.ascontiguousarray(aq0, np.int32),
                            out.reshape(-1), cap)
        if n <= cap:
            return out[:n]
        cap = n
