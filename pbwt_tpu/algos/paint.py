"""ChromoPainter-style local-ancestry painting (pbwtPaint.c).

Co-ancestry chunk counts/lengths from maximal within-panel matches with
(k-start)*(end-k) positional weighting, region-binned squared counts, and
the SparsePainter streaming variant (Yang et al., Nat Comms 16:2742, 2025).
"""

from __future__ import annotations

import gzip

import numpy as np

from ..core.pbwt import PBWT
from ..utils import time_update, fopen_tag
from . import match as matchmod


def _collect_matches(p: PBWT):
    max_match: list[list[tuple[int, int, int]]] = [[] for _ in range(p.M)]
    matchmod.match_maximal_within(
        p, lambda ai, bi, s, e: max_match[ai].append((bi, s, e)))
    return max_match


def _collect_match_arrays(p: PBWT):
    """Flattened per-hap match segments (seg_j, seg_s, seg_e, seg_off) in
    the reference's per-recipient report order, without Python lists."""
    from ..core import native
    a0 = (p.aFstart if p.aFstart is not None
          else np.arange(p.M, dtype=np.int32))
    if p.yz:
        bucketed = native.max_within_bucketed(p.yz, p.M, p.N, a0)
        if bucketed is not None:
            return bucketed
    rows = (native.max_within_packed(p.yz, p.M, p.N, a0) if p.yz
            else native.max_within(p.decoded(True), a0))
    if rows is None:
        mm = _collect_matches(p)
        segs = [(j, jr, s, e) for j, lst in enumerate(mm)
                for (jr, s, e) in lst]
        rows = (np.asarray(segs, np.int64) if segs
                else np.zeros((0, 4), np.int64))
    else:
        lib = native.get_lib()
        if lib is not None and len(rows):
            # C counting sort by recipient: one pass over the int64 rows
            # instead of argsort + fancy-gather (8.6 GB of traffic at the
            # 100k-panel scale, dominated by this sandbox's page faults)
            n = len(rows)
            sj = native.pooled_view((n,), np.int32, "paint:sj")
            ss = native.pooled_view((n,), np.int32, "paint:ss")
            se = native.pooled_view((n,), np.int32, "paint:se")
            seg_off = np.zeros(p.M + 1, np.int64)
            lib.bucket_rows(np.ascontiguousarray(rows.reshape(-1)), n, p.M,
                            sj, ss, se, seg_off)
            return sj, ss, se, seg_off
        rows = rows[:, [0, 1, 2, 3]]
    order = np.argsort(rows[:, 0], kind="stable")
    rows = rows[order]
    counts = np.bincount(rows[:, 0], minlength=p.M) if len(rows) \
        else np.zeros(p.M, np.int64)
    seg_off = np.zeros(p.M + 1, np.int64)
    np.cumsum(counts, out=seg_off[1:])
    return (np.ascontiguousarray(rows[:, 1], np.int32),
            np.ascontiguousarray(rows[:, 2], np.int32),
            np.ascontiguousarray(rows[:, 3], np.int32),
            seg_off)


def _paint_device(p: PBWT, cpr: int, map_ih: np.ndarray, n_inds: int):
    """Device route for paintAncestryMatrix: chunkcount/chunklength totals
    from the dense site pass (ops/paint_jax), with the reference's region
    bookkeeping (pbwtPaint.c:95-108) reconstructed exactly from per-segment
    chunkcount prefixes at the region-boundary sites.

    A region closes at the while-loop advance of segment t when
    (1+t) % chunksperregion == 0, at site b = max(end_t, 1) (<= N-1);
    part_counts over a region are per-segment prefix differences, with
    closed forms for segments fully before/after the window.
    """
    from ..ops.paint_jax import paint_totals_device
    sj, ss, se, seg_off = _collect_match_arrays(p)
    M, N = p.M, p.N
    seg_rec = np.repeat(np.arange(M), np.diff(seg_off))
    segments = np.stack([seg_rec, sj, ss, se], axis=1).astype(np.int64)

    # region-close boundaries per recipient + needed prefix requests
    closes: list[list[int]] = [[] for _ in range(M)]
    requests: list[tuple[int, int]] = []
    req_pos: dict[tuple[int, int], int] = {}
    for i in range(M):
        lo, hi = int(seg_off[i]), int(seg_off[i + 1])
        if hi - lo <= 1:
            continue
        ends = se[lo:hi]
        for t in range(hi - lo - 1):
            b = max(int(ends[t]), 1)
            if b > N - 1:
                break
            if (1 + t) % cpr == 0:
                closes[i].append(b)
                for r in range(lo, hi):
                    s_, e_ = int(ss[r]), int(se[r])
                    is_last = r == hi - 1
                    if s_ + 1 < b and (b < e_ or is_last) \
                            and map_ih[sj[r]] != map_ih[i]:
                        if (r, b) not in req_pos:
                            req_pos[(r, b)] = len(requests)
                            requests.append((r, b))
    pairs = (np.asarray(requests, np.int64) if requests
             else np.zeros((0, 2), np.int64))
    c_hap, l_hap, seg_tot, pref = paint_totals_device(
        segments, M, N, map_ih, pairs=pairs)

    counts = np.zeros((n_inds, n_inds))
    totlengths = np.zeros((n_inds, n_inds))
    np.add.at(counts, map_ih, c_hap)
    np.add.at(totlengths, map_ih, l_hap)

    counts2 = np.zeros((n_inds, n_inds))
    counts3 = np.zeros((n_inds, n_inds))
    nregions = np.zeros(n_inds)

    def prefix_at(r, b):
        s_, e_ = int(ss[r]), int(se[r])
        is_last = r == int(seg_off[seg_rec[r] + 1]) - 1
        if b <= s_ + 1:
            return 0.0
        if b >= e_ and not is_last:
            return seg_tot[r]
        return pref[req_pos[(r, b)]]

    for i in range(M):
        if not closes[i]:
            continue
        lo, hi = int(seg_off[i]), int(seg_off[i + 1])
        me = int(map_ih[i])
        prev = np.zeros(hi - lo)
        part = np.zeros(n_inds)
        for b in closes[i]:
            cur = np.array([prefix_at(r, b) if map_ih[sj[r]] != me else 0.0
                            for r in range(lo, hi)])
            part[:] = 0.0
            np.add.at(part, map_ih[sj[lo:hi]], cur - prev)
            mask = np.arange(n_inds) != me
            counts2[me][mask] += part[mask] ** 2
            counts3[me][mask] += part[mask]
            nregions[me] += 1.0
            prev = cur
    return counts, totlengths, counts2, counts3, nregions


def paint_ancestry_matrix(p: PBWT, file_root: str, chunksperregion: int = 100,
                          ploidy: int = 2, outputlocal: int = 0) -> None:
    """paintAncestryMatrix (pbwtPaint.c:56-209)."""
    n_inds = p.M // ploidy
    map_ih = np.arange(p.M) // ploidy
    counts = np.zeros((n_inds, n_inds))
    counts2 = np.zeros((n_inds, n_inds))
    counts3 = np.zeros((n_inds, n_inds))
    totlengths = np.zeros((n_inds, n_inds))
    nregions = np.zeros(n_inds)
    tot_counts = np.zeros(n_inds)
    part_counts = np.zeros(n_inds)

    flp = None
    localsum = None
    if outputlocal:
        flp = fopen_tag(file_root, "localancestry.out", "w")
        flp.write("pos" + "".join(f" IND{i + 1}" for i in range(n_inds)) + "\n")

    from ..ops import device_requested
    # exact=False: device paint matrices are f32-close, not byte-identical
    # (PARITY.md), so painting routes to the device only on explicit request
    use_device = not outputlocal and device_requested(exact=False)

    from ..core import native
    lib = native.get_lib()
    if use_device:
        counts, totlengths, counts2, counts3, nregions = _paint_device(
            p, chunksperregion, map_ih, n_inds)
    elif lib is not None and not outputlocal:
        sj, ss, se, seg_off = _collect_match_arrays(p)
        lib.paint_accumulate(
            sj, ss, se,
            seg_off, p.M, p.N, n_inds, ploidy, chunksperregion, -1.0,
            counts.reshape(-1), counts2.reshape(-1), counts3.reshape(-1),
            totlengths.reshape(-1), nregions, part_counts)
    else:
        max_match = _collect_matches(p)
        for i in range(p.M):
            if outputlocal:
                localsum = np.zeros((n_inds, p.N))
            mm = max_match[i]
            if not mm:
                mm = [(i, 0, 0)]
            m1 = 0
            n1 = 1
            m_stop = len(mm) - 1
            part_counts[:] = 0.0
            me = map_ih[i]
            for k in range(1, p.N):
                while mm[m1][2] <= k and m1 < m_stop:
                    if n1 % chunksperregion == 0:
                        mask = np.arange(n_inds) != me
                        counts2[me][mask] += part_counts[mask] ** 2
                        counts3[me][mask] += part_counts[mask]
                        part_counts[:] = 0.0
                        nregions[me] += 1.0
                    m1 += 1
                    n1 += 1
                ssum = 0.0
                mlist = []
                m = m1
                while m <= m_stop and mm[m][1] < k:
                    jm, sm, em = mm[m]
                    if map_ih[jm] != me:
                        mlist.append((jm, sm, em))
                        ssum += (k - sm) * (em - k)
                    m += 1
                if ssum:
                    for jm, sm, em in mlist:
                        w = (k - sm) * (em - k) / ssum
                        if outputlocal:
                            localsum[map_ih[jm]][k] += w
                        totlengths[me][map_ih[jm]] += w
                        thiscount = w / (em - sm)
                        counts[me][map_ih[jm]] += thiscount
                        part_counts[map_ih[jm]] += thiscount
            if outputlocal:
                flp.write(f"HAP {i + 1} IND{me + 1}\n")
                for k in range(p.N - 1, -1, -1):
                    flp.write(str(p.sites[k].x))
                    for j in range(n_inds):
                        flp.write(f" {localsum[j][k]:0.3f}")
                    flp.write("\n")
    if outputlocal:
        flp.close()

    # normalise chunk lengths per recipient
    for i in range(n_inds):
        indsum = totlengths[i].sum()
        if indsum:
            totlengths[i] = totlengths[i] / indsum * p.N * ploidy

    fc = fopen_tag(file_root, "chunkcounts.out", "w")
    fl = fopen_tag(file_root, "chunklengths.out", "w")
    fc2 = fopen_tag(file_root, "regionsquaredchunkcounts.out", "w")
    fc3 = fopen_tag(file_root, "regionchunkcounts.out", "w")
    fc.write("RECIPIENT")
    fl.write("RECIPIENT")
    fc2.write("RECIPIENT nregions")
    fc3.write("RECIPIENT nregions")
    for i in range(n_inds):
        for f in (fc, fl, fc2, fc3):
            f.write(f" IND{i + 1}")
    for f in (fc, fl, fc2, fc3):
        f.write("\n")
    fmt = native.format_f4_row if lib is not None else None
    # all four tables formatted in four native calls (per-row ctypes
    # overhead dominated the dense emitters)
    rows_c = native.format_f4_rows(counts) if lib is not None else None
    rows_l = native.format_f4_rows(totlengths) if rows_c else None
    rows_2 = native.format_f4_rows(counts2) if rows_c else None
    rows_3 = native.format_f4_rows(counts3) if rows_c else None
    for i in range(n_inds):
        fc3.write(f"IND{i + 1} {nregions[i]:.2f}")
        fc2.write(f"IND{i + 1} {nregions[i]:.2f}")
        fl.write(f"IND{i + 1}")
        fc.write(f"IND{i + 1}")
        if rows_c is not None:
            fc.write(rows_c[i])
            fl.write(rows_l[i])
            fc2.write(rows_2[i])
            fc3.write(rows_3[i])
            tot_counts[i] += counts[i].sum()
        elif fmt is not None:
            fc.write(fmt(counts[i]))
            fl.write(fmt(totlengths[i]))
            fc2.write(fmt(counts2[i]))
            fc3.write(fmt(counts3[i]))
            tot_counts[i] += counts[i].sum()
        else:
            for j in range(n_inds):
                fc.write(f" {counts[i][j]:.4f}")
                fl.write(f" {totlengths[i][j]:.4f}")
                fc2.write(f" {counts2[i][j]:.4f}")
                fc3.write(f" {counts3[i][j]:.4f}")
                tot_counts[i] += counts[i][j]
        for f in (fc, fl, fc2, fc3):
            f.write("\n")
    for f in (fc, fl, fc2, fc3):
        f.close()
    time_update()


def paint_ancestry_matrix_sparse(p: PBWT, file_root: str,
                                 chunksperregion: int = 100, ploidy: int = 2,
                                 cutoff: float = 0) -> None:
    """paintAncestryMatrixSparse (pbwtPaint.c:211-328): streams per-individual
    sparse rows to gzipped .s.out.gz files with a match-length cutoff."""
    n_inds = p.M // ploidy
    map_ih = np.arange(p.M) // ploidy
    nregions = np.zeros(n_inds)

    from ..core import native
    lib = native.get_lib()
    if lib is not None and hasattr(lib, "paint_sparse_all"):
        # whole-run native path: C accumulation (incremental integer
        # weight sums, touched-donor region flushes) streaming gzipped
        # tables via zlib; ~3x the per-individual ctypes path
        sj, ss, se, seg_off = _collect_match_arrays(p)
        rc = lib.paint_sparse_all(sj, ss, se, seg_off, p.M, p.N, n_inds,
                                  ploidy, chunksperregion, float(cutoff),
                                  file_root.encode())
        if rc == 0:
            return
        # fall through to the per-individual path on file-open failure

    # compresslevel 6 = zlib default, matching the reference's gzopen "w"
    # (python's default level 9 is ~5x slower for these numeric tables)
    fr = gzip.open(f"{file_root}.nregions.s.out.gz", "wt", compresslevel=6)
    fc = gzip.open(f"{file_root}.chunkcounts.s.out.gz", "wt", compresslevel=6)
    fl = gzip.open(f"{file_root}.chunklengths.s.out.gz", "wt",
                   compresslevel=6)
    fc2 = gzip.open(f"{file_root}.regionsquaredchunkcounts.s.out.gz", "wt",
                    compresslevel=6)
    fc3 = gzip.open(f"{file_root}.regionchunkcounts.s.out.gz", "wt",
                    compresslevel=6)

    def print_all(ii, t_counts, t_counts2, t_counts3, t_totlengths, nreg):
        nz = np.flatnonzero(t_counts)
        if len(nz):
            i1 = ii + 1
            fc.write("".join(f"{i1} {j + 1} {t_counts[j]:.4f}\n"
                             for j in nz))
            fl.write("".join(f"{i1} {j + 1} {t_totlengths[j]:.4f}\n"
                             for j in nz))
            fc2.write("".join(f"{i1} {j + 1} {t_counts2[j]:.4f}\n"
                              for j in nz))
            fc3.write("".join(f"{i1} {j + 1} {t_counts3[j]:.4f}\n"
                              for j in nz))
        fr.write(f"{ii + 1} {nreg:.2f}\n")

    part_counts = np.zeros(n_inds)
    t_counts = np.zeros(n_inds)
    t_counts2 = np.zeros(n_inds)
    t_counts3 = np.zeros(n_inds)
    t_totlengths = np.zeros(n_inds)
    indsum = 0.0

    from ..core import native
    lib = native.get_lib()
    if lib is not None:
        sj, ss, se, seg_off = _collect_match_arrays(p)
        nreg1 = np.zeros(1)
        ind1 = np.zeros(1)
        for ii in range(n_inds):
            part_counts[:] = 0.0
            t_counts[:] = 0.0
            t_counts2[:] = 0.0
            t_counts3[:] = 0.0
            t_totlengths[:] = 0.0
            nreg1[0] = 0.0
            ind1[0] = 0.0
            lib.paint_sparse_ind(sj, ss, se, seg_off, ii * ploidy,
                                 (ii + 1) * ploidy, p.N, n_inds, ploidy,
                                 chunksperregion, float(cutoff),
                                 t_counts, t_counts2, t_counts3,
                                 t_totlengths, nreg1, part_counts, ind1)
            nregions[ii] = nreg1[0]
            nz = t_totlengths != 0
            if ind1[0]:
                t_totlengths[nz] = (t_totlengths[nz] / ind1[0]
                                    * p.N * ploidy)
            print_all(ii, t_counts, t_counts2, t_counts3, t_totlengths,
                      nregions[ii])
        for f in (fc, fl, fc2, fc3, fr):
            f.close()
        return

    max_match = _collect_matches(p)
    for i in range(p.M):
        mm = max_match[i]
        if not mm:
            mm = [(i, 0, 0)]
        m1 = 0
        n1 = 1
        m_stop = len(mm) - 1
        me = map_ih[i]
        if i == 0 or map_ih[i] != map_ih[i - 1]:
            if i > 0:
                print_all(map_ih[i - 1], t_counts, t_counts2, t_counts3,
                          t_totlengths, nregions[map_ih[i - 1]])
            part_counts[:] = 0.0
            t_counts[:] = 0.0
            t_counts2[:] = 0.0
            t_counts3[:] = 0.0
            t_totlengths[:] = 0.0
        for k in range(1, p.N):
            while mm[m1][2] <= k and m1 < m_stop:
                if n1 % chunksperregion == 0:
                    nz = part_counts != 0
                    nz[me] = False
                    t_counts2[nz] += part_counts[nz] ** 2
                    t_counts3[nz] += part_counts[nz]
                    part_counts[:] = 0.0
                    nregions[me] += 1.0
                m1 += 1
                n1 += 1
            ssum = 0.0
            mlist = []
            m = m1
            while m <= m_stop and mm[m][1] < k:
                jm, sm, em = mm[m]
                if map_ih[jm] != me and (em - sm) > cutoff:
                    mlist.append((jm, sm, em))
                    ssum += (k - sm) * (em - k)
                m += 1
            if ssum:
                for jm, sm, em in mlist:
                    w = (k - sm) * (em - k) / ssum
                    t_totlengths[map_ih[jm]] += w
                    thiscount = w / (em - sm)
                    t_counts[map_ih[jm]] += thiscount
                    part_counts[map_ih[jm]] += thiscount
                indsum += 1.0
        if i % ploidy == ploidy - 1:
            nz = t_totlengths != 0
            if indsum:
                t_totlengths[nz] = t_totlengths[nz] / indsum * p.N * ploidy
            indsum = 0.0

    print_all(map_ih[p.M - 1], t_counts, t_counts2, t_counts3, t_totlengths,
              nregions[map_ih[p.M - 1]])
    for f in (fc, fl, fc2, fc3, fr):
        f.close()
