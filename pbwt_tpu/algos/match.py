"""Matching algorithms 3-5 of Durbin (2014) plus the production sweep
matcher (pbwtMatch.c).

Report rows are printed as "MATCH\\tai\\tbi\\tstart\\tend\\tlen" exactly as
reportMatch (pbwtMatch.c:46-58)."""

from __future__ import annotations

import sys

import numpy as np

from ..core import engine, registry
from ..core.pbwt import PBWT
from ..utils import log


def report_match_stdout(ai: int, bi: int, start: int, end: int) -> None:
    if start == end:
        return
    sys.stdout.write(f"MATCH\t{ai}\t{bi}\t{start}\t{end}\t{end - start}\n")


def check_match_maximal(x: np.ndarray, y: np.ndarray, start: int, end: int, N: int):
    """checkMatchMaximal (pbwtMatch.c:33-44)."""
    if start and x[start - 1] == y[start - 1]:
        raise AssertionError("match not maximal - can extend backwards")
    if end < N and x[end] == y[end]:
        raise AssertionError("match not maximal - can extend forwards")
    if (x[start:end] != y[start:end]).any():
        raise AssertionError("match not a match")


# --------------------------------------------------------------------------
# within-panel matching
# --------------------------------------------------------------------------

def _prev_greater(d: np.ndarray, M: int) -> np.ndarray:
    """g[i] = max j <= i-1 with d[j] > d[i] (scan floor of the up-scan in
    algorithm 4).  Only used for i >= 1; g[0] is set to 0 and never consulted
    because d[0] is the strict-max sentinel so the up-scan never applies at
    i == 0.  O(M) monotonic stack."""
    g = np.zeros(M, dtype=np.int64)
    dl = d.tolist()
    stack = [0]
    for i in range(1, M):
        di = dl[i]
        while dl[stack[-1]] <= di:
            stack.pop()
        g[i] = stack[-1]
        stack.append(i)
    return g


def _next_greater(d: np.ndarray, M: int) -> np.ndarray:
    """h[i] = min j > i+1 with d[j] > d[i+1] (scan ceiling of the down-scan
    in algorithm 4; d[M] is the strict-max sentinel).  h[M-1] unused."""
    h = np.empty(M, dtype=np.int64)
    if M == 0:
        return h
    h[M - 1] = M
    dl = d.tolist()
    stack = [M]
    for t in range(M - 1, 0, -1):
        while dl[stack[-1]] <= dl[t]:
            stack.pop()
        h[t - 1] = stack[-1]
        stack.append(t)
    return h


def match_maximal_within(p: PBWT, report) -> None:
    """Algorithm 4 (matchMaximalWithin, pbwtMatch.c:115-142).

    Native C fast path when available; otherwise per site the up/down
    neighbour scans are resolved with vectorised previous/next-greater
    bounds plus prefix allele counts.
    """
    from ..core import native
    a0 = p.aFstart if p.aFstart is not None else np.arange(p.M, dtype=np.int32)
    # stream the pack3 bytes directly (O(M) live memory); fall back to the
    # decoded matrix only when the packed stream is absent
    rows = (native.max_within_packed(p.yz, p.M, p.N, a0) if p.yz
            else native.max_within(p.decoded(True), a0))
    if rows is not None:
        for ai, bi, s, e in rows.tolist():
            report(ai, bi, s, e)
        return
    Y = p.decoded(True)
    M, N = p.M, p.N
    a = (p.aFstart if p.aFstart is not None else np.arange(M, dtype=np.int32)).copy()
    d = np.zeros(M + 1, dtype=np.int32)
    d[0] = 1
    d[M] = 1
    y_end = np.zeros(M, dtype=np.uint8)   # y at k == N is undefined; block rule k<N applies
    for k in range(N + 1):
        y = Y[k] if k < N else y_end
        dm = d
        # bounds
        g = _prev_greater(dm, M)           # scan range up: [g[i], i-1]
        h = _next_greater(dm, M)           # scan range down: [i+1, h[i]-1]
        # prefix counts of alleles for block-allele tests
        c1 = np.zeros(M + 1, dtype=np.int64)
        np.cumsum(y != 0, out=c1[1:])
        c0 = np.arange(M + 1) - c1
        up_applicable = dm[:M] <= dm[1:M + 1]
        down_applicable = dm[:M] >= dm[1:M + 1]
        for i in range(M):
            lo = g[i]
            hi = h[i]
            yi = y[i]
            if k < N:
                if up_applicable[i] and i > lo:
                    cnt = (c1[i] - c1[lo]) if yi else (c0[i] - c0[lo])
                    if cnt > 0:
                        continue
                if down_applicable[i] and hi > i + 1:
                    cnt = (c1[hi] - c1[i + 1]) if yi else (c0[hi] - c0[i + 1])
                    if cnt > 0:
                        continue
            if up_applicable[i]:
                for j in range(lo, i):
                    report(int(a[i]), int(a[j]), int(dm[i]), k)
            if down_applicable[i]:
                for j in range(i + 1, hi):
                    report(int(a[i]), int(a[j]), int(dm[i + 1]), k)
        if k < N:
            a, d = engine.forwards_ad(a, d, y, k)


def match_long_within1(p: PBWT, T: int, report) -> None:
    """Start-less long-match scan — paper algorithm 3 (matchLongWithin1,
    pbwtMatch.c:60-83).

    The reference function is dead code (pbwtLongMatches calls only variant
    2) and as written is broken: its k-loop never advances the cursor, and
    the report indexes ``u->a`` with indices into the local allele lists.
    This implements what the function is annotated as — Durbin 2014
    algorithm 3: per site k, split rows into blocks at divergence breaks
    d[i] > k - T and report every cross-allele pair inside a block with
    end=k and start=0 ("0 is wrong! - can't get start", pbwtMatch.c:73).
    Per end position k, the unordered {ai, bi} pair set reported equals
    matchLongWithin2's (variant 2 orders pairs by row, this one reports
    (0-allele row, 1-allele row)).
    """
    Y = p.decoded(True)
    M, N = p.M, p.N
    a = (p.aFstart if p.aFstart is not None else np.arange(M, dtype=np.int32)).copy()
    d = np.zeros(M + 1, dtype=np.int32)
    d[0] = 1
    d[M] = 1
    for k in range(N + 1):
        y = Y[min(k, N - 1)]
        alist: list[int] = []
        blist: list[int] = []
        for i in range(M):
            if d[i] > k - T:
                for ai in alist:
                    for bi in blist:
                        report(ai, bi, 0, k)
                alist = []
                blist = []
            (alist if y[i] == 0 else blist).append(int(a[i]))
        if k < N:
            a, d = engine.forwards_ad(a, d, y, k)


def match_long_within(p: PBWT, T: int, report) -> None:
    """Algorithm 3 variant with starts (matchLongWithin2, pbwtMatch.c:85-113)."""
    from ..core import native
    a0 = p.aFstart if p.aFstart is not None else np.arange(p.M, dtype=np.int32)
    rows = (native.long_within_packed(p.yz, T, p.M, p.N, a0) if p.yz
            else native.long_within(p.decoded(True), T, a0))
    if rows is not None:
        for ai, bi, s, e in rows.tolist():
            report(ai, bi, s, e)
        return
    Y = p.decoded(True)
    M, N = p.M, p.N
    a = (p.aFstart if p.aFstart is not None else np.arange(M, dtype=np.int32)).copy()
    d = np.zeros(M + 1, dtype=np.int32)
    d[0] = 1
    d[M] = 1
    for k in range(N + 1):
        # at k == N the reference cursor still holds the LAST column's values
        # (the read past the end leaves y stale), and the final flush compares
        # alleles against it (matchLongWithin2 has no k<N guard on y)
        y = Y[min(k, N - 1)]
        i0, na, nb = 0, 0, 0
        for i in range(M):
            if d[i] > k - T:
                if na and nb:
                    for ia in range(i0, i):
                        dmin = 0
                        for ib in range(ia + 1, i):
                            if d[ib] > dmin:
                                dmin = int(d[ib])
                            if y[ib] != y[ia]:
                                report(int(a[ia]), int(a[ib]), dmin, k)
                na = nb = 0
                i0 = i
            if y[i] == 0:
                na += 1
            else:
                nb += 1
        if k < N:
            a, d = engine.forwards_ad(a, d, y, k)


def max_within_length_hist(p: PBWT) -> dict[int, int]:
    """-stats mode of matchMaximalWithin (pbwtMatch.c:130-131): per unblocked
    row one histogram entry of length k - d[i] (d[i] < d[i+1]) else
    k - d[i+1]; reports are suppressed."""
    Y = p.decoded(True)
    M, N = p.M, p.N
    a = (p.aFstart if p.aFstart is not None else np.arange(M, dtype=np.int32)).copy()
    d = np.zeros(M + 1, dtype=np.int32)
    d[0] = 1
    d[M] = 1
    hist: dict[int, int] = {}
    for k in range(N + 1):
        y = Y[k] if k < N else Y[N - 1]
        dm = d
        g = _prev_greater(dm, M)
        h = _next_greater(dm, M)
        c1 = np.zeros(M + 1, dtype=np.int64)
        np.cumsum(y != 0, out=c1[1:])
        c0 = np.arange(M + 1) - c1
        up_applicable = dm[:M] <= dm[1:M + 1]
        down_applicable = dm[:M] >= dm[1:M + 1]
        for i in range(M):
            yi = y[i]
            if k < N:
                if up_applicable[i] and i > g[i]:
                    cnt = (c1[i] - c1[g[i]]) if yi else (c0[i] - c0[g[i]])
                    if cnt > 0:
                        continue
                if down_applicable[i] and h[i] > i + 1:
                    cnt = (c1[h[i]] - c1[i + 1]) if yi else (c0[h[i]] - c0[i + 1])
                    if cnt > 0:
                        continue
            ln = k - int(dm[i]) if dm[i] < dm[i + 1] else k - int(dm[i + 1])
            hist[ln] = hist.get(ln, 0) + 1
        if k < N:
            a, d = engine.forwards_ad(a, d, y, k)
    return hist


def long_matches(p: PBWT, L: int) -> None:
    """pbwtLongMatches (pbwtMatch.c:148-183): CLI driver for -maxWithin /
    -longWithin."""
    if p is None or not p.yz:
        raise ValueError("option -longWithin called without a PBWT")
    if L < 0:
        raise ValueError(f"L {L} for longWithin must be >= 0")

    haps = p.haplotypes() if registry.is_check else None

    def report(ai, bi, start, end):
        if start == end:
            return
        sys.stdout.write(f"MATCH\t{ai}\t{bi}\t{start}\t{end}\t{end - start}\n")
        if haps is not None:
            check_match_maximal(haps[ai], haps[bi], start, end, p.N)

    if registry.is_stats and not L:
        hist = max_within_length_hist(p)
        n_tot = sum(hist.values())
        h_tot = sum(l * c for l, c in hist.items())
        for l in sorted(hist):
            if hist[l]:
                sys.stdout.write(f"{l}\t{hist[l]}\n")
        log(f"Average {n_tot / p.M:.1f} matches per sample")
        log(f"Average length {h_tot / n_tot:.1f}")
        return

    if haps is None and p.yz:
        # stream MATCH lines straight from the C scan to the stdout fd -
        # no row materialisation (13M-row outputs take seconds, not
        # minutes on slow-page-fault hosts)
        from ..core import native
        a0 = (p.aFstart if p.aFstart is not None
              else np.arange(p.M, dtype=np.int32))
        sys.stdout.flush()
        fd = native._stdout_fd(sys.stdout)
        if fd >= 0:
            n = (native.long_within_print(p.yz, L, p.M, p.N, a0, fd) if L
                 else native.max_within_print(p.yz, p.M, p.N, a0, fd))
            if n is not None:
                return
        binout = getattr(sys.stdout, "buffer", None)
        if binout is not None:
            rows = (native.long_within_packed(p.yz, L, p.M, p.N, a0) if L
                    else native.max_within_packed(p.yz, p.M, p.N, a0))
            if rows is not None and native.write_match_rows(rows, binout):
                binout.flush()
                return

    if L:
        match_long_within(p, L, report)
    else:
        match_maximal_within(p, report)


# --------------------------------------------------------------------------
# query-vs-panel matching
# --------------------------------------------------------------------------

def match_sequences_naive(p: PBWT, q: PBWT, report=report_match_stdout) -> None:
    """O(NMQ) haplotype-space matcher (matchSequencesNaive, pbwtMatch.c:194-248).
    Reports one representative maximal match (lowest reference index)."""
    if q.N != p.N:
        raise ValueError(f"query length {q.N} != PBWT length {p.N}")
    query = q.haplotypes()
    reference = p.haplotypes()
    N = p.N
    n_tot, tot_len = 0, 0
    for j in range(q.M):
        x = query[j]
        # for each reference, mismatch positions give maximal match intervals
        best_end = np.zeros(N + 1, dtype=np.int64)
        best_seq = np.zeros(N + 1, dtype=np.int64)
        best_end[N] = N + 1
        for i in range(p.M):
            neq = np.flatnonzero(x != reference[i])
            k_last = N
            # process mismatches from the right
            for kk in range(len(neq) - 1, -1, -1):
                k = int(neq[kk])
                if k_last > best_end[k + 1]:
                    m = k + 1
                    while best_end[m] <= k_last:
                        best_end[m] = k_last
                        best_seq[m] = i
                        m += 1
                k_last = k
            if k_last > best_end[0]:
                m = 0
                while best_end[m] <= k_last:
                    best_end[m] = k_last
                    best_seq[m] = i
                    m += 1
        i_best = p.M
        for k in range(N):
            if best_seq[k] != i_best:
                i_best = int(best_seq[k])
                report(j, i_best, k, int(best_end[k]))
                n_tot += 1
                tot_len += int(best_end[k]) - k
    log(f"Average number of best matches {n_tot / q.M:.1f}, "
        f"Average length {tot_len / n_tot:.1f}")


def match_sequences_indexed(p: PBWT, q: PBWT, report=report_match_stdout) -> None:
    """Algorithm 5 with materialised a/d/u indexes (matchSequencesIndexed,
    pbwtMatch.c:255-340).  O(N(M+Q)) time, ~13NM bytes memory.

    When the device engine is requested (ops.device_requested), the state
    evolution runs on the device (ops/match_jax.DeviceMatcher); reports are
    re-sorted into this function's (query, site) order, so output is
    identical."""
    if q.N != p.N:
        raise ValueError(f"query length {q.N} != PBWT length {p.N}")
    from ..ops import device_requested
    if p.M > 512 and device_requested():
        from ..ops import match_jax
        # stream the pack3 panel into the matcher (O(M*chunk) host
        # bytes, pbwtCore.c:527-585's cursor memory model) instead of
        # materialising the dense (M, N) haplotype matrix
        matcher = (match_jax.DeviceMatcher.from_pbwt(p) if p.yz
                   else match_jax.DeviceMatcher(p.haplotypes()))
        rows = np.asarray(matcher.match(q.haplotypes())).reshape(-1, 4)
        order = np.lexsort((np.arange(len(rows)), rows[:, 3],
                            rows[:, 0]))
        rows = rows[order]
        events = np.unique(rows[:, [0, 2, 3]], axis=0)
        from ..core import native
        binout = getattr(sys.stdout, "buffer", None)
        if report is report_match_stdout and binout is not None:
            sys.stdout.flush()
            if not native.write_match_rows(rows, binout):
                for jq, hap, e, k in rows.tolist():
                    report(jq, hap, e, k)
            else:
                binout.flush()
        else:
            for jq, hap, e, k in rows.tolist():
                report(jq, hap, e, k)
        n_tot = max(len(events), 1)
        tot_len = int((events[:, 2].astype(np.int64)
                       - events[:, 1]).sum())
        log(f"Average number of best matches {n_tot / q.M:.1f}, "
            f"Average length {tot_len / n_tot:.1f}")
        return
    query = q.haplotypes()
    reference = p.haplotypes()
    N, M = p.N, p.M
    Y = p.decoded(True)
    # build indexes
    A = np.empty((N + 1, M), dtype=np.int32)
    D = np.empty((N + 1, M + 1), dtype=np.int32)
    U = np.empty((N, M + 1), dtype=np.int32)
    CC = np.empty(N, dtype=np.int32)
    a = p.aFstart.copy()
    d = np.zeros(M + 1, dtype=np.int32)
    d[0] = 1
    d[M] = 1
    for k in range(N):
        A[k] = a
        D[k] = d
        u, c = engine.calculate_u(Y[k])
        U[k] = u
        CC[k] = c
        a, d = engine.forwards_ad(a, d, Y[k], k)
    A[N] = a
    D[N] = d

    n_tot, tot_len = 0, 0
    for j in range(q.M):
        x = query[j]
        e, f, g = 0, 0, M
        for k in range(N):
            if x[k]:
                f1 = CC[k] + (f - U[k][f])
                g1 = CC[k] + (g - U[k][g])
            else:
                f1 = int(U[k][f])
                g1 = int(U[k][g])
            if g1 > f1:
                f, g = f1, g1
                continue
            # reached a maximum - report and reset e, f, g
            for i in range(f, g):
                report(j, int(A[k][i]), e, k)
            n_tot += 1
            tot_len += k - e
            e1 = int(D[k + 1][f1]) - 1
            # NB when f1 is 0 or M, e1 may be k+1 (sentinel d) and x[e1] can
            # be out of range, but the branch taken doesn't depend on it:
            # f1==M forces the first branch and f1==0 the second
            if f1 == M or (f1 > 0 and x[e1] == 0):
                f1 = g1 - 1
                y = reference[A[k + 1][f1]]
                while e1 > 0 and x[e1 - 1] == y[e1 - 1]:
                    e1 -= 1
                while D[k + 1][f1] <= e1:
                    f1 -= 1
            elif f1 < M:
                g1 = f1 + 1
                y = reference[A[k + 1][f1]]
                while e1 > 0 and x[e1 - 1] == y[e1 - 1]:
                    e1 -= 1
                while g1 < M and D[k + 1][g1] <= e1:
                    g1 += 1
            e, f, g = e1, f1, g1
        for i in range(f, g):
            report(j, int(A[N][i]), e, N)
        n_tot += 1
        tot_len += N - e
    log(f"Average number of best matches {n_tot / q.M:.1f}, "
        f"Average length {tot_len / n_tot:.1f}")


def match_sequences_sweep_rows(p: PBWT, q: PBWT):
    """The native sweep's match set as an (n, 4) int64 ndarray
    [iq, j_panel, start, end] in report order, or None when the native
    engine is unavailable (callers fall back to the callback sweep).

    Logs the same summary line as match_sequences_sweep
    (pbwtMatch.c:443-445) so pipeline stderr is unchanged."""
    if q.N != p.N:
        raise ValueError(f"query length {q.N} != PBWT length {p.N}")
    from ..core import native
    M, N, QM = p.M, p.N, q.M
    ap0 = p.aFstart if p.aFstart is not None else np.arange(M, dtype=np.int32)
    aq0 = q.aFstart if q.aFstart is not None else np.arange(QM, dtype=np.int32)
    if p.yz and q.yz:
        rows = native.sweep_match_packed(p.yz, M, q.yz, QM, N, ap0, aq0)
    else:
        rows = native.sweep_match(p.decoded(True), ap0, q.decoded(True), aq0)
    if rows is None:
        return None
    nz = rows[rows[:, 2] != rows[:, 3]]
    tot_len = int((nz[:, 3] - nz[:, 2]).sum())
    log(f"Average number of best matches including alternates "
        f"{len(rows) / QM:.1f}, Average length "
        f"{tot_len / max(len(nz), 1):.1f}, Av number per position "
        f"{tot_len / (QM * N):.1f}")
    return rows


def match_sequences_sweep(p: PBWT, q: PBWT, report) -> None:
    """The production dynamic matcher (matchSequencesSweep,
    pbwtMatch.c:363-443): joint sweep of panel and query cursors keeping per
    query the best-match pointer f and its start d.

    When the device engine is requested (ops.device_requested) the match
    set is computed by ops/match_jax.DeviceMatcher and re-ordered into the
    sweep's exact report sequence (per end site, queries in query-PBWT sort
    order), so stdout is byte-identical to the host sweep."""
    if q.N != p.N:
        raise ValueError(f"query length {q.N} != PBWT length {p.N}")
    M, N, QM = p.M, p.N, q.M

    from ..ops import device_requested
    if M > 512 and device_requested():
        from ..ops import match_jax
        # stream the pack3 panel into the matcher (O(M*chunk) host
        # bytes) rather than decoding the dense haplotype matrix
        matcher = (match_jax.DeviceMatcher.from_pbwt(p) if p.yz
                   else match_jax.DeviceMatcher(p.haplotypes()))
        rows = matcher.match(q.haplotypes())
        # query sort position per site: within an end site the sweep
        # reports queries in q's PBWT order (pbwtMatch.c:376)
        Yq_ = q.decoded(True)
        aq_ = (q.aFstart if q.aFstart is not None
               else np.arange(QM, dtype=np.int32)).copy()
        qpos = np.empty((N + 1, QM), np.int32)
        for k in range(N):
            qpos[k, aq_] = np.arange(QM)
            aq_ = engine.forwards_a(aq_, Yq_[k])
        qpos[N, aq_] = np.arange(QM)
        rows = np.asarray(rows).reshape(-1, 4)
        order = np.lexsort((np.arange(len(rows)),
                            qpos[rows[:, 3], rows[:, 0]], rows[:, 3]))
        rows = rows[order]
        n_tot = len(rows)
        tot_len = int((rows[:, 3].astype(np.int64) - rows[:, 2]).sum())
        from ..core import native
        binout = getattr(sys.stdout, "buffer", None)
        if report is report_match_stdout and binout is not None:
            sys.stdout.flush()
            if not native.write_match_rows(rows, binout):
                for jq, hap, s_, e_ in rows.tolist():
                    report(jq, hap, s_, e_)
            else:
                binout.flush()
        else:
            for jq, hap, s_, e_ in rows.tolist():
                report(jq, hap, s_, e_)
        log(f"Average number of best matches including alternates "
            f"{n_tot / QM:.1f}, Average length "
            f"{tot_len / max(n_tot, 1):.1f}, Av number per position "
            f"{tot_len / (QM * N):.1f}")
        return

    from ..core import native
    ap0 = p.aFstart if p.aFstart is not None else np.arange(M, dtype=np.int32)
    aq0 = q.aFstart if q.aFstart is not None else np.arange(QM, dtype=np.int32)
    if p.yz and q.yz and report is report_match_stdout:
        # stream MATCH lines straight from the C sweep to the stdout fd
        sys.stdout.flush()
        fd = native._stdout_fd(sys.stdout)
        if fd >= 0:
            st = native.sweep_match_print(p.yz, M, q.yz, QM, N, ap0, aq0, fd)
            if st is not None:
                n_rep, tot_len, nz = st
                log(f"Average number of best matches including alternates "
                    f"{n_rep / QM:.1f}, Average length "
                    f"{tot_len / max(nz, 1):.1f}, Av number per position "
                    f"{tot_len / (QM * N):.1f}")
                return
    if p.yz and q.yz:
        rows = native.sweep_match_packed(p.yz, M, q.yz, QM, N, ap0, aq0)
    else:
        rows = native.sweep_match(p.decoded(True), ap0, q.decoded(True), aq0)
    if rows is not None:
        binout = getattr(sys.stdout, "buffer", None)
        if report is report_match_stdout and binout is not None:
            sys.stdout.flush()
            if not native.write_match_rows(rows, binout):
                for ai, bi, s, e in rows.tolist():
                    report(ai, bi, s, e)
            else:
                binout.flush()
        else:
            for ai, bi, s, e in rows.tolist():
                report(ai, bi, s, e)
        nz = rows[rows[:, 2] != rows[:, 3]]
        tot_len = int((nz[:, 3] - nz[:, 2]).sum())
        log(f"Average number of best matches including alternates "
            f"{len(rows) / QM:.1f}, Average length "
            f"{tot_len / max(len(nz), 1):.1f}, Av number per position "
            f"{tot_len / (QM * N):.1f}")
        return

    Yp = p.decoded(True)
    Yq = q.decoded(True)
    up_a = ap0.copy()
    up_d = np.zeros(M + 1, dtype=np.int32)
    up_d[0] = 1
    up_d[M] = 1
    uq_a = (q.aFstart if q.aFstart is not None else np.arange(QM, dtype=np.int32)).copy()
    f = np.zeros(QM, dtype=np.int64)
    d = np.zeros(QM, dtype=np.int64)
    n_tot, tot_len = 0, 0

    for k in range(N):
        yp = Yp[k]
        yq = Yq[k]
        dm = up_d
        for j in range(QM):
            jj = int(uq_a[j])
            x = int(yq[j])
            fj = int(f[jj])
            if yp[fj] == x:
                continue
            # the current match ends here: try same-length extension first
            i_plus = fj
            extended = False
            while True:
                i_plus += 1
                if i_plus >= M or dm[i_plus] > d[jj]:
                    break
                if yp[i_plus] == x:
                    f[jj] = i_plus
                    extended = True
                    break
            if extended:
                continue
            # report matches [f[jj], i_plus)
            for i in range(fj, i_plus):
                report(jj, int(up_a[i]), int(d[jj]), k)
            n_tot += i_plus - fj
            tot_len += (k - int(d[jj])) * (i_plus - fj)
            # find new best match by widening [i_minus, i_plus]
            i_minus = fj
            d_plus = int(dm[i_plus]) if i_plus < M else k
            d_minus = int(dm[i_minus])
            while True:
                if d_minus <= d_plus:
                    i = -1
                    while dm[i_minus] <= d_minus:   # d[0] = k+1 prevents underflow
                        i_minus -= 1
                        if yp[i_minus] == x:
                            i = i_minus
                    if i >= 0:
                        f[jj] = i
                        d[jj] = d_minus
                        break
                    d_minus = int(dm[i_minus])
                else:
                    found = False
                    while i_plus < M and dm[i_plus] <= d_plus:
                        if yp[i_plus] == x:
                            f[jj] = i_plus
                            d[jj] = d_plus
                            found = True
                            break
                        i_plus += 1
                    if found:
                        break
                    d_plus = k if i_plus == M else int(dm[i_plus])
                    if i_minus == 0 and i_plus == M:
                        log(f"no match to query {jj} value {x} at site {k}")
                        d[jj] = k + 1
                        break
        # vectorised FM-step of all query pointers
        u, c = engine.calculate_u(yp)
        xq = np.zeros(QM, dtype=np.uint8)
        xq[uq_a] = yq                     # query values in natural order? no:
        # mirror reference exactly: f[jj] updated using uq order
        jjs = uq_a.astype(np.int64)
        fs = f[jjs]
        xs = yq.astype(np.int64)
        newf = np.where(xs != 0, c + fs - u[fs], u[fs])
        newf = np.where(newf == M, 0, newf)   # trap (pbwtMatch.c:421-422)
        f[jjs] = newf
        up_a, up_d = engine.forwards_ad(up_a, up_d, yp, k)
        uq_a = engine.forwards_a(uq_a, yq)

    # record matches ending at N (pbwtMatch.c:430-436)
    for j in range(QM):
        jj = int(uq_a[j])
        report(jj, int(up_a[f[jj]]), int(d[jj]), N)
        i = int(f[jj]) + 1
        while i < M and up_d[i] <= d[jj]:
            report(jj, int(up_a[i]), int(d[jj]), N)
            i += 1
        n_tot += i - int(f[jj])
        tot_len += (N - int(d[jj])) * (i - int(f[jj]))

    log(f"Average number of best matches including alternates {n_tot / QM:.1f}, "
        f"Average length {tot_len / n_tot:.1f}, "
        f"Av number per position {tot_len / (QM * N):.1f}")


def match_sequences_dynamic(p: PBWT, fp) -> None:
    from ..io import pbwtfile
    q = pbwtfile.read_pbwt(fp)
    match_sequences_sweep(p, q, report_match_stdout)


def match_sequences_sweep_sparse(p: PBWT, q: PBWT, n_sparse: int, report) -> None:
    """matchSequencesSweepSparse (pbwtMatch.c:501-602): additionally runs
    n_sparse interleaved sub-PBWTs over every n_sparse'th site so matches can
    jump isolated mismatches."""
    if q.N != p.N:
        raise ValueError(f"query length {q.N} != PBWT length {p.N}")
    M, N, QM = p.M, p.N, q.M

    state = {"nTot": 0, "totLen": 0}

    def report_and_update(j, k, x, yp, dm, a, f, d, is_sparse):
        """reportAndUpdate (pbwtMatch.c:452-499)."""
        i_plus = f[j]
        while True:
            i_plus += 1
            if i_plus >= M or dm[i_plus] > d[j]:
                break
            if yp[i_plus] == x:
                f[j] = i_plus
                return
        dj = n_sparse * d[j] + k % n_sparse if is_sparse else d[j]
        for i in range(f[j], i_plus):
            report(j, int(a[i]), int(dj), k, is_sparse)
        state["nTot"] += i_plus - f[j]
        state["totLen"] += (k - dj) * (i_plus - f[j])
        i_minus = f[j]
        d_plus = int(dm[i_plus]) if i_plus < M else (k // n_sparse if is_sparse else k)
        d_minus = int(dm[i_minus])
        while True:
            if d_minus <= d_plus:
                i = -1
                while dm[i_minus] <= d_minus:
                    i_minus -= 1
                    if yp[i_minus] == x:
                        i = i_minus
                if i >= 0:
                    f[j] = i
                    d[j] = d_minus
                    return
                d_minus = int(dm[i_minus])
            else:
                while i_plus < M and dm[i_plus] <= d_plus:
                    if yp[i_plus] == x:
                        f[j] = i_plus
                        d[j] = d_plus
                        return
                    i_plus += 1
                d_plus = int(dm[i_plus]) if i_plus < M else (k // n_sparse if is_sparse else k)
                if i_minus == 0 and i_plus == M:
                    log(f"no match to query {j} value {x} at site {k}")
                    d[j] = 1 + (k // n_sparse if is_sparse else k)
                    return

    Yp = p.decoded(True)
    Yq = q.decoded(True)
    up_a = p.aFstart.copy() if p.aFstart is not None else np.arange(M, dtype=np.int32)
    up_d = np.zeros(M + 1, dtype=np.int32)
    up_d[0] = 1
    up_d[M] = 1
    uq_a = q.aFstart.copy() if q.aFstart is not None else np.arange(QM, dtype=np.int32)
    f = [0] * QM
    d = [0] * QM
    upp_a = [np.arange(M, dtype=np.int32) for _ in range(n_sparse)]
    upp_d = [np.zeros(M + 1, dtype=np.int32) for _ in range(n_sparse)]
    upp_y = [np.zeros(M, dtype=np.uint8) for _ in range(n_sparse)]
    for dd in upp_d:
        dd[0] = 1
        dd[M] = 1
    ff = [[0] * QM for _ in range(n_sparse)]
    ddk = [[0] * QM for _ in range(n_sparse)]

    for k in range(N):
        yp = Yp[k]
        yq = Yq[k]
        kk = k % n_sparse
        if n_sparse > 1:
            xp = np.empty(M, dtype=np.uint8)
            xp[up_a] = yp
            upp_y[kk] = xp[upp_a[kk]]
        for j in range(QM):
            jj = int(uq_a[j])
            xq = int(yq[j])
            if yp[f[jj]] != xq:
                report_and_update(jj, k, xq, yp, up_d, up_a, f, d, False)
            if n_sparse > 1 and upp_y[kk][ff[kk][jj]] != xq:
                report_and_update(jj, k, xq, upp_y[kk], upp_d[kk], upp_a[kk],
                                  ff[kk], ddk[kk], True)
        u, c = engine.calculate_u(yp)
        for j in range(QM):
            jj = int(uq_a[j])
            x = int(yq[j])
            fj = f[jj]
            f[jj] = int(c + fj - u[fj]) if x else int(u[fj])
            if f[jj] == M:
                f[jj] = 0
        if n_sparse > 1:
            us, cs = engine.calculate_u(upp_y[kk])
            for j in range(QM):
                jj = int(uq_a[j])
                x = int(yq[j])
                fj = ff[kk][jj]
                ff[kk][jj] = int(cs + fj - us[fj]) if x else int(us[fj])
                if ff[kk][jj] == M:
                    ff[kk][jj] = 0
            upp_a[kk], upp_d[kk] = engine.forwards_ad(upp_a[kk], upp_d[kk],
                                                      upp_y[kk], k // n_sparse)
        up_a, up_d = engine.forwards_ad(up_a, up_d, yp, k)
        uq_a = engine.forwards_a(uq_a, yq)

    for j in range(QM):
        jj = int(uq_a[j])
        report(jj, int(up_a[f[jj]]), d[jj], N, False)
        i = f[jj] + 1
        while i < M and up_d[i] <= d[jj]:
            report(jj, int(up_a[i]), d[jj], N, False)
            i += 1
        state["nTot"] += i - f[jj]
        state["totLen"] += (N - d[jj]) * (i - f[jj])
    if n_sparse > 1:
        for kk in range(n_sparse):
            for j in range(QM):
                jj = int(uq_a[j])
                dj = n_sparse * ddk[kk][jj] + kk
                report(jj, int(upp_a[kk][ff[kk][jj]]), dj, N, True)
                i = ff[kk][jj] + 1
                while i < M and upp_d[kk][i] <= ddk[kk][jj]:
                    report(jj, int(upp_a[kk][i]), dj, N, True)
                    i += 1
                state["nTot"] += i - ff[kk][jj]
                state["totLen"] += (N - ddk[kk][jj]) * (i - ff[kk][jj])

    log(f"Average number of best matches including alternates "
        f"{state['nTot'] / QM:.1f}, Average length "
        f"{state['totLen'] / state['nTot']:.1f}, Av number per position "
        f"{state['totLen'] / (QM * N):.1f}")
