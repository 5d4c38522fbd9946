"""Imputation: dosage codec, reference imputation by weighted maximal-match
voting, missing-data imputation and genotype comparison (pbwtImpute.c)."""

from __future__ import annotations

import math
import sys

import numpy as np

from ..core import crand, engine, native, pack3 as p3, registry
from ..core.pbwt import PBWT
from ..utils import log, time_update
from . import match as matchmod

F_BOUND = [0.1, 0.2, 0.3, 0.5, 0.7, 1, 2, 3, 5, 7, 10, 20, 30, 50, 70, 90, 100.01]


# --------------------------------------------------------------------------
# dosage codec (pbwtImpute.c:1631-1700)
# --------------------------------------------------------------------------

_DOSAGE_VALUE = np.array([0.0, 0.05, 0.15, 0.25, 0.35, 0.45, 0.0, 0.0,
                          1.0, 0.95, 0.85, 0.75, 0.65, 0.55, 1.0, 1.0])


def dosage_encode(d: np.ndarray) -> np.ndarray:
    """Quantise posterior probs to 6 levels relative to the allele value."""
    d = np.asarray(d, dtype=np.float64)
    dd = np.where(d > 0.5, 1.0 - d, d)
    enc = np.where(dd == 0.0, 0, (10.0 * (dd + 0.0999999)).astype(np.int64))
    return enc.astype(np.uint8)


def _dosage_emit(out: bytearray, d: int, count: int) -> None:
    """dosageStore (pbwtImpute.c:1643-1657)."""
    if d == 0:
        while count >= (1 << 15):
            out.append(0xFF)
            count -= 31 << 10
        if count >= (1 << 10):
            out.append((7 << 5) | (count >> 10))
            count &= 1023
        if count >= (1 << 5):
            out.append((6 << 5) | (count >> 5))
            count &= 31
        out.append(count)
    else:
        while count >= (1 << 5):
            out.append((d << 5) | 31)
            count -= 31
        out.append((d << 5) | count)


def dosage_store(p: PBWT, dosage: np.ndarray, k: int,
                 zbuf: bytearray, offsets: list[int]) -> None:
    """pbwtDosageStore: append RLE-coded quantised dosages for site k."""
    while len(offsets) <= k:
        offsets.append(0)
    offsets[k] = len(zbuf)
    enc = dosage_encode(dosage)
    syms, lens = p3._runs(enc)
    for s, n in zip(syms.tolist(), lens.tolist()):
        _dosage_emit(zbuf, int(s), int(n))


def dosage_retrieve(p: PBWT, y: np.ndarray, k: int) -> np.ndarray:
    """pbwtDosageRetrieve: decode site k's dosages (sorted order, needs y)."""
    if p.dosageOffset is None:
        raise ValueError("dosageRetrieve called without p->dosageOffset")
    z = p.zDosage
    off = int(p.dosageOffset[k])
    out = np.empty(p.M, dtype=np.float64)
    i = 0
    while i < p.M:
        b = z[off]
        off += 1
        x = b >> 5
        count = b & 0x1F
        if x == 6:
            count <<= 5
        elif x == 7:
            count <<= 10
        idx = x + (y[i:i + count].astype(np.int64) << 3)
        out[i:i + count] = _DOSAGE_VALUE[idx]
        i += count
    return out


# --------------------------------------------------------------------------
# reference imputation (referenceImpute3, pbwtImpute.c:1126-1261)
# --------------------------------------------------------------------------

def _collect_matches(p_frame: PBWT, p_old: PBWT, self_impute: bool):
    """Collect maximal matches per target haplotype as (jRef, start, end)."""
    max_match: list[list[tuple[int, int, int]]] = [[] for _ in range(p_old.M)]

    def report(iq, j_ref, start, end):
        max_match[iq].append((j_ref, start, end))

    if self_impute:
        matchmod.match_maximal_within(p_frame, lambda ai, bi, s, e:
                                      max_match[ai].append((bi, s, e)))
    else:
        matchmod.match_sequences_sweep(p_frame, p_old, report)
    return max_match


def _vote_all_sites(max_match, T: int, Xref_nat: np.ndarray,
                    kold_of_kref: np.ndarray, ref_freq: np.ndarray,
                    chunk: int = 512):
    """Vectorised weighted vote over all reference sites (the inner loops of
    referenceImpute3, pbwtImpute.c:1204-1232): per target and site,
    sum w = (kOld-start)*(end-kOld) over covering segments (weights > 0 and
    start < kOld) and the allele-weighted score, via a float64
    cumsum-difference over the per-target segment ranges.

    Returns (x (T, Nref) uint8, dosage (T, Nref) float64, voted bool)."""
    segs = []
    for j in range(T):
        for j_ref, s_, e_ in max_match[j][:-1]:     # drop the end marker
            segs.append((j, j_ref, s_, e_))
    Nref = Xref_nat.shape[1]
    if not segs:
        dosage = np.broadcast_to(ref_freq, (T, Nref)).copy()
        return (dosage > 0.5).astype(np.uint8), dosage, np.zeros(
            (T, Nref), bool)
    segs = np.asarray(segs, np.int64)
    counts = np.bincount(segs[:, 0], minlength=T)
    off = np.zeros(T + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    jref = segs[:, 1]
    s0 = segs[:, 2][:, None].astype(np.float64)
    e0 = segs[:, 3][:, None].astype(np.float64)
    x = np.empty((T, Nref), np.uint8)
    dosage = np.empty((T, Nref), np.float64)
    voted = np.empty((T, Nref), bool)
    ns = len(segs)
    # preallocated chunk workspaces: fresh multi-MB temporaries per chunk
    # would page-fault at sandbox speeds (see core.native.pooled)
    w = np.empty((ns, chunk))
    t1 = np.empty((ns, chunk))
    cw = np.zeros((ns + 1, chunk))
    for c0 in range(0, Nref, chunk):
        c1 = min(c0 + chunk, Nref)
        cc = c1 - c0
        k = kold_of_kref[c0:c1][None, :].astype(np.float64)
        wv, tv = w[:, :cc], t1[:, :cc]
        np.subtract(k, s0, out=wv)
        np.subtract(e0, k, out=tv)
        wv *= tv
        wv[~((s0 < k) & (wv > 0))] = 0.0
        np.cumsum(wv, axis=0, out=cw[1:, :cc])
        ssum = cw[off[1:], :cc] - cw[off[:-1], :cc]
        np.multiply(wv, Xref_nat[jref, c0:c1], out=tv)
        np.cumsum(tv, axis=0, out=cw[1:, :cc])
        score = cw[off[1:], :cc] - cw[off[:-1], :cc]
        v = ssum > 0
        with np.errstate(invalid="ignore", divide="ignore"):
            pj = score / ssum
        dj = np.where(v, pj, ref_freq[c0:c1][None, :])
        dosage[:, c0:c1] = dj
        x[:, c0:c1] = dj > 0.5
        voted[:, c0:c1] = v
    return x, dosage, voted


def reference_impute3(p_old: PBWT, p_ref: PBWT, p_frame: PBWT,
                      n_sparse: int = 1, f_sparse: float = 1.0) -> PBWT:
    msg = "Reference impute using maximal matches: "
    if n_sparse > 1:   # pbwtImpute.c:1136
        msg += f"(nSparse = {n_sparse}, fSparse = {f_sparse:.2f}) "
    log(msg)
    self_impute = p_old is p_frame
    from ..core import native
    lib = native.get_lib()
    rows = None
    seg_bundle = None      # (jr, s, e, seg_off) already target-sorted
    if lib is not None:
        # the whole match set as one ndarray: skips 400k+ python report
        # callbacks, list building and per-query sorting at scale
        if self_impute:
            if p_ref.yz and p_frame.N == 0 and not registry.is_check:
                # empty frame: every within-panel match is the degenerate
                # (s=0, e=0) report whose vote weight (ko-s)(e-ko) can
                # never be positive — an empty segment set is equivalent
                # (the -check path keeps them for count-log parity)
                rows = np.zeros((0, 4), np.int64)
            elif p_frame.yz and p_ref.yz:
                a0f = (p_frame.aFstart if p_frame.aFstart is not None
                       else np.arange(p_frame.M, dtype=np.int32))
                # two-pass bucketed collection straight into per-target
                # runs + in-place start sort: never materialises the
                # (n, 4) int64 row set (58 MB at 1.8 M rows)
                bk = native.max_within_bucketed(
                    p_frame.yz, p_frame.M, p_frame.N, a0f)
                if bk is not None:
                    sj, ss, se, off_b = bk
                    native.buckets_sort_start(sj, ss, se, off_b)
                    seg_bundle = (sj, ss, se, off_b)
                    rows = True          # sentinel: match set collected
                else:
                    rows = native.max_within_packed(
                        p_frame.yz, p_frame.M, p_frame.N, a0f)
        else:
            rows = matchmod.match_sequences_sweep_rows(p_frame, p_old)
    if rows is not None:
        max_match = None
        if registry.is_check:
            if seg_bundle is not None:
                cnts = np.diff(seg_bundle[3]) + 1
            else:
                cnts = np.bincount(rows[:, 0], minlength=p_old.M) + 1
            for j in range(p_old.M):
                log(f"{int(cnts[j])} matches found to query {j}")
    else:
        max_match = _collect_matches(p_frame, p_old, self_impute)
        N_old = p_old.N
        for j in range(p_old.M):
            max_match[j].sort(key=lambda m: m[1])
            last_ref = max_match[j][-1][0] if max_match[j] else 0
            max_match[j].append((last_ref, N_old, N_old + 1))   # end marker
            if registry.is_check:
                log(f"{len(max_match[j])} matches found to query {j}")

    p_new = PBWT(p_old.M, p_ref.N)
    p_new.isRefFreq = True
    u_new = engine.WriteCursor(p_old.M)
    zdosage = bytearray()
    dosage_offsets: list[int] = [0] * p_ref.N
    n_conflicts = 0
    vd = registry.variation_dict
    frame_keys = [(s.x, s.varD) for s in p_frame.sites]
    ref_sites = p_ref.sites

    if not self_impute:
        # frame coordinate per reference site (the kOld the serial loop
        # would hold at that site, pbwtImpute.c:1185-1190)
        kold_of_kref = np.zeros(p_ref.N, np.int64)
        k_old = 0
        for k_ref in range(p_ref.N):
            rs = ref_sites[k_ref]
            if (k_old < len(frame_keys) and rs.x == frame_keys[k_old][0]
                    and rs.varD == frame_keys[k_old][1]):
                k_old += 1
            kold_of_kref[k_ref] = k_old
        T, Nref = p_old.M, p_ref.N

        from ..ops import device_requested
        use_device = device_requested()

        # segments must be sorted by (target, start) as the per-target
        # scans require (the reference qsorts each target's list by
        # start, pbwtImpute.c:1150-1159; the weighted sums are order-
        # independent within equal starts).  The streaming-C route sorts
        # in C (segs_sort, bucket scatter + per-bucket qsort); the other
        # routes materialise a sorted (n, 4) array
        if rows is None:
            segs = [(j, jr, s_, e_) for j in range(T)
                    for jr, s_, e_ in max_match[j][:-1]]
            segments = (np.asarray(segs, np.int64) if segs
                        else np.zeros((0, 4), np.int64))
        elif use_device or lib is None or not p_ref.yz:
            segments = rows[np.lexsort((rows[:, 2], rows[:, 0]))]
        else:
            segments = None                   # C route: sorted columns

        if not use_device and lib is not None and p_ref.yz:
            # the whole core as ONE streaming C pass with O(Mref + T) live
            # memory (the reference's cursor memory model): materialising
            # (Nref x T) / (Nref x Mref) intermediates costs more in page
            # faults than the votes cost in arithmetic on this host
            if segments is None:
                jr_c, s_c, e_c, seg_off = native.segs_sort(rows, T)
                seg_cols = (jr_c, s_c, e_c)
            else:
                counts = np.bincount(segments[:, 0], minlength=T) \
                    if len(segments) else np.zeros(T, np.int64)
                seg_off = np.zeros(T + 1, np.int64)
                np.cumsum(counts, out=seg_off[1:])
                seg_cols = None
            a_ref0 = (p_ref.aFstart if p_ref.aFstart is not None
                      else np.arange(p_ref.M, dtype=np.int32))
            (p_new.yz, p_new.zDosage, dos_off, ref_freq, psums, xsums,
             pxsums, nvote, n_conflicts, a_end) = native.impute_vote_emit(
                p_ref.yz, p_ref.M, Nref, a_ref0, segments, seg_off, T,
                kold_of_kref, seg_cols=seg_cols)
            p_new.aFend = a_end
            p_new.N = Nref
            p_new.dosageOffset = dos_off
            p_new.invalidate()
            for k_ref in range(Nref):
                ref_sites[k_ref].refFreq = float(ref_freq[k_ref])
            with np.errstate(invalid="ignore", divide="ignore"):
                psn = psums / nvote
                xsn = xsums / nvote
                pxn = pxsums / nvote
            for k_ref in range(Nref):
                if nvote[k_ref]:
                    var_prod = (psn[k_ref] * (1 - psn[k_ref])
                                * xsn[k_ref] * (1 - xsn[k_ref]))
                    ref_sites[k_ref].imputeInfo = (
                        (pxn[k_ref] - psn[k_ref] * psn[k_ref])
                        / math.sqrt(var_prod) if var_prod else 1.0)
            if n_conflicts:
                log(f"{n_conflicts} times where no overlapping matches "
                    "because query does not match any reference - set "
                    "imputed value to 0")
            return p_new

        # materialised paths: device engine, or no native runtime
        Xcols = Xref_nat = None
        if lib is not None and p_ref.yz:
            a_ref0 = (p_ref.aFstart if p_ref.aFstart is not None
                      else np.arange(p_ref.M, dtype=np.int32))
            Xcols, _, onec = native.natural_cols(
                p_ref.yz, Nref, p_ref.M, a_ref0)
            ref_freq = onec / float(p_ref.M)
        else:
            Xref_nat = p_ref.haplotypes()
            YRef = p_ref.decoded(True)
            ref_freq = ((YRef != 0).sum(axis=1)
                        / float(p_ref.M)).astype(np.float64)
        for k_ref in range(Nref):
            ref_sites[k_ref].refFreq = float(ref_freq[k_ref])

        site_major = False              # x_all/dos_all orientation
        if use_device:
            from ..ops.impute_jax import impute_dosages_device
            if Xref_nat is None:
                Xref_nat = p_ref.haplotypes()
            x_all, dos_all, voted = impute_dosages_device(
                segments, T, Xref_nat, kold_of_kref, ref_freq)
            n_conflicts = int((~voted).sum())
            nvote = voted.sum(axis=0)
            psums = np.where(voted, dos_all, 0.0).sum(axis=0)
            xsums = np.where(voted, x_all, 0).sum(axis=0).astype(np.float64)
            pxsums = np.where(voted, dos_all * x_all, 0.0).sum(axis=0)
        elif lib is not None:
            counts = np.bincount(segments[:, 0], minlength=T) \
                if len(segments) else np.zeros(T, np.int64)
            seg_off = np.zeros(T + 1, np.int64)
            np.cumsum(counts, out=seg_off[1:])
            if Xcols is None:
                Xcols = np.ascontiguousarray(Xref_nat.T)
            x_all = np.empty((Nref, T), np.uint8)
            dos_all = np.empty((Nref, T), np.float64)
            voted = np.empty((Nref, T), np.uint8)
            psums = np.empty(Nref); xsums = np.empty(Nref)
            pxsums = np.empty(Nref); nvote = np.empty(Nref, np.int64)
            lib.impute_vote(
                np.ascontiguousarray(segments[:, 1], np.int32),
                np.ascontiguousarray(segments[:, 2], np.int32),
                np.ascontiguousarray(segments[:, 3], np.int32),
                seg_off, seg_off[:-1].astype(np.int32), T, Nref,
                Xcols.reshape(-1), p_ref.M, kold_of_kref, ref_freq,
                x_all.reshape(-1), dos_all.reshape(-1), voted.reshape(-1),
                psums, xsums, pxsums, nvote)
            site_major = True
            n_conflicts = int((voted == 0).sum())
        else:
            if Xref_nat is None:
                Xref_nat = p_ref.haplotypes()
            x_all, dos_all, voted = _vote_all_sites(
                max_match, T, Xref_nat, kold_of_kref, ref_freq)
            n_conflicts = int((~voted).sum())
            nvote = voted.sum(axis=0)
            psums = np.where(voted, dos_all, 0.0).sum(axis=0)
            xsums = np.where(voted, x_all, 0).sum(axis=0).astype(np.float64)
            pxsums = np.where(voted, dos_all * x_all, 0.0).sum(axis=0)
        with np.errstate(invalid="ignore", divide="ignore"):
            psn = psums / nvote
            xsn = xsums / nvote
            pxn = pxsums / nvote

        if lib is not None:
            # whole output stage in one C pass (gather + pack3 + dosage
            # RLE + prefix advance per site)
            xa = x_all if site_major else np.ascontiguousarray(x_all.T)
            da = dos_all if site_major else np.ascontiguousarray(dos_all.T)
            p_new.yz, p_new.zDosage, dos_off, p_new.aFend = \
                native.impute_emit(xa, da, u_new.a)
            p_new.N = Nref
            p_new.dosageOffset = dos_off
            p_new.invalidate()
        else:
            xa = x_all.T if site_major else x_all
            da = dos_all.T if site_major else dos_all
            for k_ref in range(Nref):
                y_new = xa[u_new.a, k_ref]
                y_dosage = da[u_new.a, k_ref]
                u_new.write_forwards(y_new)
                dosage_offsets[k_ref] = len(zdosage)
                enc = dosage_encode(y_dosage)
                syms, lens = p3._runs(enc)
                for s_, n_ in zip(syms.tolist(), lens.tolist()):
                    _dosage_emit(zdosage, int(s_), int(n_))
            p_new.set_from_write_cursor(u_new, Nref)
            p_new.zDosage = bytes(zdosage)
            p_new.dosageOffset = np.array(dosage_offsets, dtype=np.int64)
        for k_ref in range(Nref):
            if nvote[k_ref]:
                var_prod = (psn[k_ref] * (1 - psn[k_ref])
                            * xsn[k_ref] * (1 - xsn[k_ref]))
                ref_sites[k_ref].imputeInfo = (
                    (pxn[k_ref] - psn[k_ref] * psn[k_ref])
                    / math.sqrt(var_prod) if var_prod else 1.0)
        if n_conflicts:
            log(f"{n_conflicts} times where no overlapping matches because "
                "query does not match any reference - set imputed value to 0")
        return p_new

    if rows is not None and p_ref.yz:
        # self-impute (imputeMissing) through the same fused streaming C
        # core: complete entries copy straight through via the missing
        # stream, only missing entries vote (pbwtImpute.c:1341-1358)
        T, Nref = p_old.M, p_ref.N
        kold_of_kref = np.zeros(Nref, np.int64)
        k_old = 0
        for k_ref in range(Nref):
            rs = ref_sites[k_ref]
            if (k_old < len(frame_keys) and rs.x == frame_keys[k_old][0]
                    and rs.varD == frame_keys[k_old][1]):
                k_old += 1
            kold_of_kref[k_ref] = k_old
        if seg_bundle is not None:
            jr_c, s_c, e_c, seg_off = seg_bundle
        else:
            jr_c, s_c, e_c, seg_off = native.segs_sort(rows, T)
        a_ref0 = (p_ref.aFstart if p_ref.aFstart is not None
                  else np.arange(p_ref.M, dtype=np.int32))
        moff = (p_ref.missingOffset if p_ref.missingOffset is not None
                else np.zeros(Nref, np.int64))
        (p_new.yz, p_new.zDosage, dos_off, ref_freq, psums, xsums,
         pxsums, nvote, n_conflicts, a_end) = native.impute_vote_emit(
            p_ref.yz, p_ref.M, Nref, a_ref0, None, seg_off, T,
            kold_of_kref, p_ref.zMissing, moff,
            seg_cols=(jr_c, s_c, e_c))
        p_new.aFend = a_end
        p_new.N = Nref
        p_new.dosageOffset = dos_off
        p_new.invalidate()
        for k_ref in range(Nref):
            ref_sites[k_ref].refFreq = float(ref_freq[k_ref])
        with np.errstate(invalid="ignore", divide="ignore"):
            psn = psums / nvote
            xsn = xsums / nvote
            pxn = pxsums / nvote
        for k_ref in range(Nref):
            if nvote[k_ref]:
                var_prod = (psn[k_ref] * (1 - psn[k_ref])
                            * xsn[k_ref] * (1 - xsn[k_ref]))
                ref_sites[k_ref].imputeInfo = (
                    (pxn[k_ref] - psn[k_ref] * psn[k_ref])
                    / math.sqrt(var_prod) if var_prod else 1.0)
        if n_conflicts:
            log(f"{n_conflicts} times where no overlapping matches "
                "because query does not match any reference - set "
                "imputed value to 0")
        return p_new

    YOld = p_old.decoded(True)
    YRef = p_ref.decoded(True)
    a_old = p_old.aFstart.copy()
    a_ref = p_ref.aFstart.copy()
    first_seg = [0] * p_old.M
    k_old = 0
    for k_ref in range(p_ref.N):
        rs = ref_sites[k_ref]
        if (k_old < len(frame_keys) and rs.x == frame_keys[k_old][0]
                and rs.varD == frame_keys[k_old][1]):
            a_old = engine.forwards_a(a_old, YOld[k_old])
            k_old += 1
            for j in range(p_old.M):
                mm = max_match[j]
                while k_old >= mm[first_seg[j]][2]:
                    first_seg[j] += 1
        y_ref = YRef[k_ref]
        a_ref_inv = np.empty(p_ref.M, dtype=np.int64)
        a_ref_inv[a_ref] = np.arange(p_ref.M)
        rs.refFreq = float(np.count_nonzero(y_ref)) / p_ref.M
        missing = None
        if self_impute:
            if p_ref.missingOffset is None or not p_ref.missingOffset[k_ref]:
                missing = np.zeros(p_ref.M, dtype=np.uint8)
            else:
                off = int(p_ref.missingOffset[k_ref])
                runs_sym, runs_len = _unpack_one(p_ref.zMissing, off, p_ref.M)
                missing = np.repeat(runs_sym, runs_len)
        x = np.zeros(p_old.M, dtype=np.uint8)
        x_dosage = np.zeros(p_old.M, dtype=np.float64)
        psum = xsum = pxsum = 0.0
        n = 0
        y_ref_nat = y_ref[a_ref_inv]       # reference alleles in natural order
        for j in range(p_old.M):
            if self_impute and not missing[j]:
                x[j] = y_ref_nat[j]
                x_dosage[j] = float(x[j])
                continue
            mm = max_match[j]
            mi = first_seg[j]
            ssum = 0.0
            score = 0.0
            while mi < len(mm) and mm[mi][1] < k_old:
                j_ref, start, end = mm[mi]
                bit = (k_old - start) * (end - k_old)
                if bit > 0:
                    ssum += bit
                    if y_ref_nat[j_ref]:
                        score += bit
                mi += 1
            if ssum == 0:
                x[j] = 1 if rs.refFreq > 0.5 else 0
                x_dosage[j] = rs.refFreq
                n_conflicts += 1
            else:
                pj = score / ssum
                x[j] = 1 if pj > 0.5 else 0
                x_dosage[j] = pj
                psum += pj
                xsum += x[j]
                pxsum += pj * x[j]
                n += 1
        y_new = x[u_new.a]
        y_dosage = x_dosage[u_new.a]
        u_new.write_forwards(y_new)
        dosage_offsets[k_ref] = len(zdosage)
        enc = dosage_encode(y_dosage)
        syms, lens = p3._runs(enc)
        for s_, n_ in zip(syms.tolist(), lens.tolist()):
            _dosage_emit(zdosage, int(s_), int(n_))
        if n:
            psum /= n
            xsum /= n
            pxsum /= n
            var_prod = psum * (1 - psum) * xsum * (1 - xsum)
            rs.imputeInfo = ((pxsum - psum * psum) / math.sqrt(var_prod)
                             if var_prod else 1.0)
        a_ref = engine.forwards_a(a_ref, y_ref)

    p_new.set_from_write_cursor(u_new, p_ref.N)
    p_new.zDosage = bytes(zdosage)
    p_new.dosageOffset = np.array(dosage_offsets, dtype=np.int64)
    if n_conflicts:
        log(f"{n_conflicts} times where no overlapping matches because query "
            "does not match any reference - set imputed value to 0")
    return p_new


def _unpack_one(z: bytes, off: int, M: int):
    """Decode one pack3 column starting at byte offset off."""
    syms = []
    lens = []
    m = 0
    while m < M:
        b = z[off]
        off += 1
        n = int(p3.P3DECODE[b & 0x7F])
        syms.append(b >> 7)
        lens.append(n)
        m += n
    return np.array(syms, np.uint8), np.array(lens, np.int64)


def reference_impute(p_old: PBWT, root: str, n_sparse: int = 1,
                     f_sparse: float = 1.0) -> PBWT:
    """referenceImpute (pbwtImpute.c:1265-1319)."""
    from ..io import pbwtfile
    log(f"impute against reference {root}")
    if p_old is None or not p_old.yz or p_old.sites is None:
        raise ValueError("referenceImpute called without existing pbwt with sites")
    p_ref = pbwtfile.read_all(root)
    if p_ref.sites is None:
        raise ValueError(f"new pbwt {root} in referencePhase has no sites")
    if p_old.chrom != p_ref.chrom:
        raise ValueError(f"mismatching chrom in referenceImpute: old "
                         f"{p_ref.chrom}, new {p_old.chrom}")
    p_frame = p_ref.select_sites(p_old.sites, keep_old=True)
    if p_frame.N == p_ref.N:
        log("No additional sites to impute in referenceImpute")
        return p_old
    p_frame.build_reverse()
    p_old = p_old.select_sites_fill_missing(p_ref.sites, keep_old=False)
    if not p_old.N:
        raise ValueError("no overlapping sites in referenceImpute")
    log("Imputation preliminaries: ")
    time_update()
    p_new = reference_impute3(p_old, p_ref, p_frame, n_sparse, f_sparse)
    p_new.sites = p_ref.sites
    p_new.chrom = p_ref.chrom
    p_new.samples = p_old.samples
    return p_new


def impute_missing(p_old: PBWT) -> PBWT:
    """imputeMissing (pbwtImpute.c:1323-1371): frame = complete-data sites."""
    if p_old.missingOffset is None:
        log("imputeMissing called but can't find missing data")
        return p_old
    complete = [p_old.sites[k] for k in range(p_old.N) if not p_old.missingOffset[k]]
    p_frame = p_old.select_sites(complete, keep_old=True)
    p_frame.missingOffset = p_old.missingOffset  # unused for frame matching
    # special mode of impute3: pOld == pFrame, pRef = the original panel
    p_new = reference_impute3(p_frame, p_old, p_frame, 1, 0)
    p_new.sites = p_old.sites
    p_new.samples = p_old.samples
    p_new.chrom = p_old.chrom
    return p_new


# --------------------------------------------------------------------------
# genotype comparison (genotypeCompare, pbwtImpute.c:1375-1488)
# --------------------------------------------------------------------------

def genotype_compare(p: PBWT, root: str) -> None:
    from ..io import pbwtfile
    log(f"compare genotypes to reference {root}")
    if p is None or not p.yz or p.sites is None:
        raise ValueError("genotypeCompare called without existing pbwt with sites")
    p_ref = pbwtfile.read_all(root)
    if p.chrom != p_ref.chrom:
        raise ValueError(f"mismatch chrom {p.chrom} to ref {p_ref.chrom}")
    if p_ref.sites is None:
        raise ValueError(f"new pbwt {root} in genotypeCompare has no sites")
    if p.M != p_ref.M:
        raise ValueError(f"mismatch of old M {p.M} to ref M {p_ref.M}")
    if p.N == p_ref.N:
        _genotype_compare_pbwt(p, p_ref)
    else:
        log(f"mismatch of old N {p.N} to ref N {p_ref.N}")
        p_frame = p.select_sites(p_ref.sites, keep_old=True)
        p_ref = p_ref.select_sites(p.sites, keep_old=False)
        if not p_frame.N:
            raise ValueError("no overlapping sites in genotypeCompare")
        _genotype_compare_pbwt(p_frame, p_ref)


def _genotype_compare_pbwt(p: PBWT, q: PBWT) -> None:
    out = sys.stdout
    is_dosage = p.dosageOffset is not None
    nd = np.zeros(12, dtype=np.int64)
    nd1 = np.zeros(12, dtype=np.int64)

    # vectorised accumulation streamed in site chunks (the per-site
    # counting loops of pbwtImpute.c:1398-1438 become bincounts over
    # (bin, genotype-pair) keys; O(M * chunk) live bytes — the dense
    # (M, N) matrices cost more in page faults than the counting at
    # 16k x 16k).  Only the dosage tallies still walk sites, to stream
    # the RLE.
    from ..core import native
    M, N = p.M, p.N
    rf = np.array([s.refFreq for s in p.sites], dtype=np.float64)
    is_ref_freq = bool((rf != 0.0).any())
    ii = np.array([s.imputeInfo for s in p.sites], dtype=np.float64)
    fbound = np.asarray(F_BOUND)

    chunk = 1024
    stream = native.get_lib() is not None and bool(p.yz) and bool(q.yz)
    if stream and not is_dosage:
        # the whole counting pass in C at the reference's own loop cost
        ap0 = (p.aFstart if p.aFstart is not None
               else np.arange(M, dtype=np.int32))
        aq0 = (q.aFstart if q.aFstart is not None
               else np.arange(M, dtype=np.int32))
        res = native.gtcompare_core(p.yz, q.yz, M, N, ap0, aq0, rf, ii,
                                    fbound)
        if res is not None:
            n, ns9c, fsum, nsum, isum, ni = res
            ns = np.zeros((p.M, 9), dtype=np.int64)
            ns[0::2] = ns9c
            _genotype_compare_report(p, is_ref_freq, is_dosage, n, ns,
                                     fsum, nsum, isum, ni, nd, nd1)
            return
    Xp_d = None if stream else p.haplotypes()
    Xq_d = None if stream else q.haplotypes()
    ap = (p.aFstart if p.aFstart is not None
          else np.arange(M, dtype=np.int32))
    aq = (q.aFstart if q.aFstart is not None
          else np.arange(M, dtype=np.int32))
    posp = posq = 0
    n = np.zeros(17 * 9, dtype=np.int64)
    ns9 = np.zeros((9, M // 2), dtype=np.int64)
    fsum = np.zeros(17)
    nsum = np.zeros(17, np.int64)
    isum = np.zeros(17)
    ni = np.zeros(17, np.int64)
    Xp_cols = [] if is_dosage else None
    for k0 in range(0, N, chunk):
        nc = min(chunk, N - k0)
        if stream:
            Xpc, ap, onesc, posp = native.natural_cols(p.yz, nc, M, ap,
                                                       start=posp,
                                                       with_pos=True)
            Xqc, aq, _, posq = native.natural_cols(q.yz, nc, M, aq,
                                                   start=posq,
                                                   with_pos=True)
        else:
            Xpc = np.ascontiguousarray(Xp_d[:, k0:k0 + nc].T)
            Xqc = np.ascontiguousarray(Xq_d[:, k0:k0 + nc].T)
            onesc = Xpc.sum(axis=1, dtype=np.int64)
        f_arr = np.where(rf[k0:k0 + nc] != 0.0, rf[k0:k0 + nc],
                         onesc / float(M))
        # first ff with f*100 <= F_BOUND[ff] == the reference's walk
        ff = np.searchsorted(fbound, f_arr * 100.0, side="left")
        fsum += np.bincount(ff, weights=f_arr * 100.0, minlength=17)
        nsum += np.bincount(ff, minlength=17)
        im = ii[k0:k0 + nc] < 1.0
        isum += np.bincount(ff[im], weights=ii[k0:k0 + nc][im],
                            minlength=17)
        ni += np.bincount(ff[im], minlength=17)
        i9 = 3 * (Xpc[:, 0::2] + Xpc[:, 1::2]) \
            + (Xqc[:, 0::2] + Xqc[:, 1::2])           # (nc, M/2) uint8
        key = ff.astype(np.uint8)[:, None] * 9 + i9   # ff*9+i9 <= 152
        n += np.bincount(key.ravel(), minlength=17 * 9)
        for v in range(9):
            ns9[v] += (i9 == v).sum(axis=0)
        if is_dosage:
            Xp_cols.append(Xpc.copy())
    n = n.reshape(17, 9)
    ns = np.zeros((p.M, 9), dtype=np.int64)
    ns[0::2] = ns9.T

    if is_dosage:
        Xp_nat = np.concatenate(Xp_cols)              # (N, M) site-major
        Yp = p.decoded(True)
        a = p.aFstart.copy()
        for k in range(p.N):
            dos = dosage_retrieve(p, Yp[k], k)
            dos_nat = np.empty(p.M)
            dos_nat[a] = dos
            ids = np.where(dos_nat == 0.0, 0,
                           np.where(dos_nat == 1.0, 11,
                                    1 + (dos_nat * 10.0).astype(np.int64)))
            np.add.at(nd, ids, 1)
            np.add.at(nd1, ids[Xp_nat[k] == 1], 1)
            a = engine.forwards_a(a, Yp[k])

    _genotype_compare_report(p, is_ref_freq, is_dosage, n, ns, fsum,
                             nsum, isum, ni, nd, nd1)


def _genotype_compare_report(p, is_ref_freq, is_dosage, n, ns, fsum,
                             nsum, isum, ni, nd, nd1) -> None:
    """The r2 tables + per-sample accuracy distribution + dosage table
    (pbwtImpute.c:1441-1487)."""
    out = sys.stdout
    if is_ref_freq:
        out.write("Genotype comparison results split on reference frequencies\n")
    else:
        out.write("Genotype comparison results split on sample frequencies\n")
    for ff in range(17):
        row = n[ff]
        tot = row.sum()
        out.write(f"{F_BOUND[ff]:<5.1f}\t"
                  f"{(fsum[ff] / nsum[ff]) if nsum[ff] else 0.0:<7.3f}")
        for i in range(9):
            out.write(f"\t{row[i]} ")
        if tot:
            xbar = (row[3] + row[4] + row[5] + 2 * (row[6] + row[7] + row[8])) / tot
            x2 = (row[3] + row[4] + row[5] + 4 * (row[6] + row[7] + row[8])) / tot
            ybar = (row[1] + row[4] + row[7] + 2 * (row[2] + row[5] + row[8])) / tot
            y2 = (row[1] + row[4] + row[7] + 4 * (row[2] + row[5] + row[8])) / tot
            from ..utils import c_f
            r2 = (row[4] + 2 * (row[5] + row[7]) + 4 * row[8]) / tot
            denom = math.sqrt((x2 - xbar * xbar) * (y2 - ybar * ybar))
            r2 = (r2 - xbar * ybar) / denom if denom else float("nan")
            out.write(f"\tx,y,r2\t{xbar:.4f}\t{ybar:.4f}\t{c_f(r2)}")
            if ni[ff]:
                out.write(f"\t info {isum[ff] / ni[ff]:.4f}")
        out.write("\n")

    hist = np.zeros(101, dtype=np.int64)
    for j in range(0, p.M, 2):
        row = ns[j]
        tot = row.sum()
        if tot:
            xbar = (row[3] + row[4] + row[5] + 2 * (row[6] + row[7] + row[8])) / tot
            x2 = (row[3] + row[4] + row[5] + 4 * (row[6] + row[7] + row[8])) / tot
            ybar = (row[1] + row[4] + row[7] + 2 * (row[2] + row[5] + row[8])) / tot
            y2 = (row[1] + row[4] + row[7] + 4 * (row[2] + row[5] + row[8])) / tot
            r2 = (row[4] + 2 * (row[5] + row[7]) + 4 * row[8]) / tot
            denom = math.sqrt((x2 - xbar * xbar) * (y2 - ybar * ybar))
            r2 = (r2 - xbar * ybar) / denom if denom else 0.0
            if r2 < 0:
                r2 = 0
            hist[int(100 * r2)] += 1
    out.write("Genotype accuracy distribution across samples\n")
    if hist[100]:
        out.write(f"{hist[100]} samples with r2 == 1.0\n")
    for i in range(99, -1, -1):
        if hist[i]:
            out.write(f"{hist[i]} samples with {(i - 1) * 0.01:.2f} <= r2 < "
                      f"{i * 0.01:.2f}\n")
    if is_dosage:
        out.write("Dosage accuracy (currently at haplotype level)\n")
        out.write(f"0.00  {nd1[0] / nd[0] if nd[0] else 0.0:.3f}  {nd[0]}\n")
        for i in range(1, 11):
            out.write(f"{0.1 * (i - 0.5):.2f}  "
                      f"{nd1[i] / nd[i] if nd[i] else 0.0:.3f}  {nd[i]}\n")
        out.write(f"1.00  {nd1[11] / nd[11] if nd[11] else 0.0:.3f}  {nd[11]}\n")


# --------------------------------------------------------------------------
# data corruption / simulation (pbwtImpute.c:1492-1619)
# --------------------------------------------------------------------------

def _corrupt_finish(p_new: PBWT, p_old: PBWT, u_new: engine.WriteCursor) -> PBWT:
    """Adopt sites/chrom/samples from pOld exactly as the reference transfers
    them (pbwtImpute.c:1530-1533)."""
    p_new.yz = u_new.packed()
    p_new.aFend = u_new.a.copy()
    p_new.sites = p_old.sites
    p_new.chrom = p_old.chrom
    return p_new


def corrupt_sites(p_old: PBWT, p_site: float, p_change: float) -> PBWT:
    """pbwtCorruptSites (pbwtImpute.c:1492-1537).

    Bit-reproducible vs the reference binary: draws come from the glibc
    rand() stream (unseeded == srand(1)) and corruption is applied at
    positions in the NEW cursor's sort order, exactly as the reference's
    ``uNew->y[i]`` loop does.
    """
    if not p_old.yz:
        raise ValueError("corruptSites without an existing pbwt")
    if not (0 < p_site <= 1) or not (0 < p_change <= 1):
        raise ValueError(f"pSite {p_site}, pChange {p_change} out of range")
    M, N = p_old.M, p_old.N
    rnd = crand.rand
    r_site = int(p_site * crand.RAND_MAX)
    r_change = int(p_change * crand.RAND_MAX)
    r_fac = crand.RAND_MAX / M
    a0 = (p_old.aFstart if p_old.aFstart is not None
          else np.arange(M, dtype=np.int32))
    res = native.corrupt_sites_core(p_old.yz, M, N, a0,
                                    r_site, r_change, r_fac)
    if res is not None:
        p_new = PBWT(M, N)
        p_new.yz, p_new.aFend, n_change = res
        p_new.sites = p_old.sites
        p_new.chrom = p_old.chrom
        p_new.samples = p_old.samples
        log(f"corruptSites with pSite {p_site:f}, pChange {p_change:f} "
            f"changes {n_change / (N * M):.4f} of values")
        return p_new
    u_old = engine.ReadCursor.create(p_old, True, True)
    u_new = engine.WriteCursor(M)
    n_change = 0
    for k in range(N):
        x = u_old.x_natural()
        y = x[u_new.a]
        if rnd() < r_site:
            thresh = u_old.c * r_fac
            for i in range(M):
                if rnd() < r_change:
                    old = y[i]
                    y[i] = 0 if rnd() < thresh else 1
                    if y[i] != old:
                        n_change += 1
        u_new.write_forwards(y)
        u_old.forwards_read()
    p_new = _corrupt_finish(PBWT(M, N), p_old, u_new)
    p_new.samples = p_old.samples
    log(f"corruptSites with pSite {p_site:f}, pChange {p_change:f} changes "
        f"{n_change / (N * M):.4f} of values")
    return p_new


def corrupt_samples(p_old: PBWT, p_sample: float, p_change: float) -> PBWT:
    """pbwtCorruptSamples (pbwtImpute.c:1539-1584).  Note the reference's
    isCorrupt[] is indexed by position in the new cursor's sort order, not
    by haplotype id — reproduced as-is for bit parity."""
    if not p_old.yz:
        raise ValueError("corruptSites without an existing pbwt")
    if not (0 < p_sample <= 1) or not (0 < p_change <= 1):
        raise ValueError(f"pSample {p_sample}, pChange {p_change} out of range")
    M, N = p_old.M, p_old.N
    rnd = crand.rand
    r_sample = int(p_sample * crand.RAND_MAX)
    r_change = int(p_change * crand.RAND_MAX)
    r_fac = crand.RAND_MAX / M
    a0 = (p_old.aFstart if p_old.aFstart is not None
          else np.arange(M, dtype=np.int32))
    res = native.corrupt_samples_core(p_old.yz, M, N, a0,
                                      r_sample, r_change, r_fac)
    if res is not None:
        p_new = PBWT(M, N)
        p_new.yz, p_new.aFend, n_change = res
        p_new.sites = p_old.sites
        p_new.chrom = p_old.chrom
        p_new.samples = p_old.samples
        log(f"corruptSamples with pSample {p_sample:f}, pChange "
            f"{p_change:f} changes {n_change / (N * M):.4f} of values")
        return p_new
    u_old = engine.ReadCursor.create(p_old, True, True)
    u_new = engine.WriteCursor(M)
    is_corrupt = [rnd() < r_sample for _ in range(M)]
    n_change = 0
    for k in range(N):
        x = u_old.x_natural()
        y = x[u_new.a]
        thresh = u_old.c * r_fac
        for i in range(M):
            if is_corrupt[i] and rnd() < r_change:
                v = 0 if rnd() < thresh else 1
                if v != y[i]:
                    n_change += 1
                y[i] = v
        u_new.write_forwards(y)
        u_old.forwards_read()
    p_new = _corrupt_finish(PBWT(M, N), p_old, u_new)
    p_new.samples = p_old.samples
    log(f"corruptSamples with pSample {p_sample:f}, pChange {p_change:f} changes "
        f"{n_change / (N * M):.4f} of values")
    return p_new


def copy_samples(p_old: PBWT, m_new: int, mean_length: float) -> PBWT:
    """Li-Stephens mosaic simulator (pbwtCopySamples, pbwtImpute.c:1586-1619).

    The reference switches copy[j] indexed by sort-order position j but reads
    through copy[uNew->a[j]] (natural id) — an inconsistency we reproduce for
    bit parity.  The reference also moves the old samples array across even
    though its length no longer matches Mnew; reproduced as-is."""
    if not p_old.yz:
        raise ValueError("copySamples called without an existing pbwt")
    if mean_length < 1.0:
        raise ValueError(f"meanLength {mean_length} must be > 1 in pbwtCopySamples")
    M_old, N = p_old.M, p_old.N
    rnd = crand.rand
    r_switch = int(crand.RAND_MAX / mean_length)
    a0 = (p_old.aFstart if p_old.aFstart is not None
          else np.arange(M_old, dtype=np.int32))
    res = native.copy_samples_core(p_old.yz, M_old, N, a0, m_new, r_switch)
    if res is not None:
        p_new = PBWT(m_new, N)
        p_new.yz, p_new.aFend, _ = res
        p_new.sites = p_old.sites
        p_new.chrom = p_old.chrom
        p_new.samples = p_old.samples
        log(f"copySamples made {m_new} samples with mean switch length "
            f"{mean_length:.1f}")
        return p_new
    u_old = engine.ReadCursor.create(p_old, True, True)
    u_new = engine.WriteCursor(m_new)
    copy = np.array([rnd() % M_old for _ in range(m_new)], dtype=np.int64)
    y = np.empty(m_new, dtype=np.uint8)
    for k in range(N):
        x_old = u_old.x_natural()
        for j in range(m_new):
            if rnd() < r_switch:
                copy[j] = rnd() % M_old
        y[:] = x_old[copy[u_new.a]]
        u_new.write_forwards(y)
        u_old.forwards_read()
    p_new = _corrupt_finish(PBWT(m_new, N), p_old, u_new)
    p_new.samples = p_old.samples
    log(f"copySamples made {m_new} samples with mean switch length {mean_length:.1f}")
    return p_new
