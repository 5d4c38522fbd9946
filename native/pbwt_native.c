/* pbwt-tpu native host runtime: hot inner loops for the exact engine.
 *
 * These are fresh implementations of the PBWT primitives (Durbin,
 * Bioinformatics 30:1266-72, 2014) in C for host-side throughput; the
 * device path lives in pbwt_tpu/ops.  Exposed through ctypes
 * (pbwt_tpu/core/native.py); every entry point has a numpy fallback with
 * identical semantics.
 *
 * Conventions: columns are site-major uint8 arrays of M values in current
 * sort order; prefix arrays are int32; report buffers are int64 quadruples.
 */

#include <stdint.h>
#include <stdio.h>
#include <string.h>
#include <stdlib.h>
#include <unistd.h>
#include <zlib.h>

#define EXPORT __attribute__((visibility("default")))

/* ------------------------------------------------------------------ */
/* pack3 codec                                                         */
/* ------------------------------------------------------------------ */

#define T1 64
#define T2 (32 << 6)
#define T3 (31 << 11)

static inline long emit_run(uint8_t sym, long n, uint8_t *out)
{
    uint8_t top = (uint8_t)(sym << 7);
    uint8_t *o = out;
    while (n >= T3) { *o++ = top | 0x7f; n -= T3; }
    if (n >= T2) { *o++ = top | 0x60 | (uint8_t)(n >> 11); n &= 0x7ff; }
    if (n >= T1) { *o++ = top | 0x40 | (uint8_t)(n >> 6); n &= 0x3f; }
    if (n) *o++ = top | (uint8_t)n;
    return o - out;
}

EXPORT long p3_encode(const uint8_t *y, long M, uint8_t *out)
{
    long m = 0, nout = 0;
    while (m < M) {
        uint8_t sym = y[m];
        long start = m;
        while (m < M && y[m] == sym) ++m;
        nout += emit_run(sym, m - start, out + nout);
    }
    return nout;
}

/* encode many columns; offsets[ncols+1] filled with byte offsets */
EXPORT long p3_encode_cols(const uint8_t *Y, long ncols, long M,
                           uint8_t *out, int64_t *offsets)
{
    long nout = 0;
    for (long c = 0; c < ncols; ++c) {
        offsets[c] = nout;
        nout += p3_encode(Y + c * M, M, out + nout);
    }
    offsets[ncols] = nout;
    return nout;
}

static int32_t p3dec[128];
static int p3dec_ready = 0;
static void p3dec_init(void)
{
    for (int n = 0; n < 64; ++n) p3dec[n] = n;
    for (int n = 64; n < 96; ++n) p3dec[n] = (n - 64) << 6;
    for (int n = 96; n < 128; ++n) p3dec[n] = (n - 96) << 11;
    p3dec_ready = 1;
}

/* decode ncols columns of M values; returns bytes consumed or -1 on error */
EXPORT long p3_decode_cols(const uint8_t *yz, long nz, long ncols, long M,
                           uint8_t *Y)
{
    if (!p3dec_ready) p3dec_init();
    long pos = 0;
    for (long c = 0; c < ncols; ++c) {
        long m = 0;
        uint8_t *col = Y + c * M;
        while (m < M) {
            if (pos >= nz) return -1;
            uint8_t b = yz[pos++];
            long n = p3dec[b & 0x7f];
            if (m + n > M) return -1;
            memset(col + m, b >> 7, n);
            m += n;
        }
    }
    return pos;
}

/* streaming column source: either a dense (N, M) sorted-column matrix or
   a pack3 stream decoded one column at a time into a reusable buffer
   (the reference's cursor memory model, pbwtCore.c:527-585: O(M) live
   bytes regardless of N) */
typedef struct {
    const uint8_t *dense;   /* (N, M) site-major, or NULL */
    const uint8_t *yz;      /* pack3 stream, or NULL */
    long pos, nz, M;
    uint8_t *buf;           /* M bytes scratch for packed decode */
} colsrc;

static const uint8_t *cs_next(colsrc *cs, long k)
{
    if (cs->dense) return cs->dense + k * cs->M;
    if (!p3dec_ready) p3dec_init();
    long m = 0;
    while (m < cs->M) {
        if (cs->pos >= cs->nz) return NULL;
        uint8_t b = cs->yz[cs->pos++];
        long n = p3dec[b & 0x7f];
        if (m + n > cs->M) return NULL;
        memset(cs->buf + m, b >> 7, n);
        m += n;
    }
    return cs->buf;
}

static void cs_dense(colsrc *cs, const uint8_t *Y, long M)
{ cs->dense = Y; cs->yz = NULL; cs->pos = 0; cs->nz = 0; cs->M = M; cs->buf = NULL; }

static int cs_packed(colsrc *cs, const uint8_t *yz, long nz, long M)
{
    cs->dense = NULL; cs->yz = yz; cs->pos = 0; cs->nz = nz; cs->M = M;
    cs->buf = (uint8_t *)malloc(M);
    return cs->buf != NULL;
}

static void cs_free(colsrc *cs) { free(cs->buf); }

static inline uint8_t *put_dec(uint8_t *p, long v)
{
    char tmp[24];
    int n = 0;
    if (v == 0) { *p++ = '0'; return p; }
    while (v) { tmp[n++] = (char)('0' + v % 10); v /= 10; }
    while (n) *p++ = (uint8_t)tmp[--n];
    return p;
}

static long fmt_f4_one(double v, char *out);   /* ' %.4f', defined below */
/* fused run-level cursor steps, defined with the merge core below */
static long p3_scatter_fwd(const uint8_t *yz, long nz, long *pos_io,
                           int32_t *a, int32_t *ones, long M,
                           uint8_t *xnat);
static long gather_encode_fwd(int32_t *a, long M, const uint8_t *xnat,
                              int32_t *ones, uint8_t *runbuf);

/* match-row sink: either collect (ai, bi, s, e) int64 rows (cap-bounded,
   zero-length rows kept for collector semantics) or stream formatted
   MATCH lines straight to a file descriptor (zero-length rows skipped,
   like the reference's reportMatch printf) - the fd path never
   materialises the row set, which matters on slow-page-fault hosts. */
typedef struct {
    int64_t *rows;
    long cap, n, totlen, nz;
    int fd;
    uint8_t *buf;
    long blen;
    /* bucket mode (boff != NULL): two-pass per-recipient placement that
       never materialises the (n, 4) int64 row set - pass 0 (bsj == NULL)
       counts into boff[ai + 1], pass 1 places (bi, s, e) at boff[ai]++ */
    int32_t *bsj, *bss, *bse;
    int64_t *boff;
} rowsink;

#define SINK_BUF (1L << 20)

static int sink_flush(rowsink *rs)
{
    long off = 0;
    while (off < rs->blen) {
        long w = write(rs->fd, rs->buf + off, rs->blen - off);
        if (w < 0) return -1;
        off += w;
    }
    rs->blen = 0;
    return 0;
}

static inline void sink_row(rowsink *rs, long ai, long bi, long s, long e)
{
    rs->n++;
    if (s != e) { rs->nz++; rs->totlen += e - s; }
    if (rs->boff) {
        if (!rs->bsj) { rs->boff[ai + 1]++; return; }
        int64_t p = rs->boff[ai]++;
        rs->bsj[p] = (int32_t)bi;
        rs->bss[p] = (int32_t)s;
        rs->bse[p] = (int32_t)e;
        return;
    }
    if (rs->fd >= 0) {
        if (s == e) return;
        if (rs->blen + 144 > SINK_BUF) sink_flush(rs);
        uint8_t *p = rs->buf + rs->blen;
        memcpy(p, "MATCH\t", 6); p += 6;
        p = put_dec(p, ai); *p++ = '\t';
        p = put_dec(p, bi); *p++ = '\t';
        p = put_dec(p, s); *p++ = '\t';
        p = put_dec(p, e); *p++ = '\t';
        p = put_dec(p, e - s); *p++ = '\n';
        rs->blen = p - rs->buf;
    } else if (rs->n <= rs->cap) {
        int64_t *r = rs->rows + 4 * (rs->n - 1);
        r[0] = ai; r[1] = bi; r[2] = s; r[3] = e;
    }
}


/* ------------------------------------------------------------------ */
/* column updates (algorithms 1 and 2)                                 */
/* ------------------------------------------------------------------ */

EXPORT long fwd_a(int32_t *a, const uint8_t *y, int32_t *ones, long M)
{
    long u = 0, v = 0;
    for (long i = 0; i < M; ++i) {
        if (y[i] == 0) a[u++] = a[i];
        else ones[v++] = a[i];
    }
    memcpy(a + u, ones, v * sizeof(int32_t));
    return u; /* = c, number of zeros */
}

EXPORT long fwd_ad(int32_t *a, int32_t *d, const uint8_t *y,
                   int32_t *ones, int32_t *dones, long M, int32_t k)
{
    long u = 0, v = 0;
    int32_t p = k + 1, q = k + 1;
    for (long i = 0; i < M; ++i) {
        int32_t di = d[i];
        if (di > p) p = di;
        if (di > q) q = di;
        if (y[i] == 0) { a[u] = a[i]; d[u] = p; ++u; p = 0; }
        else { ones[v] = a[i]; dones[v] = q; ++v; q = 0; }
    }
    memcpy(a + u, ones, v * sizeof(int32_t));
    memcpy(d + u, dones, v * sizeof(int32_t));
    d[0] = k + 2;
    d[M] = k + 2;
    return u;
}

/* full construction: cols is (N, M) site-major natural-order values;
   fills yz (caller-sized; returns needed bytes, writing at most cap),
   leaves the final prefix array in a. */
EXPORT long build_pbwt(const uint8_t *cols, long M, long N, int32_t *a,
                       uint8_t *yz, long cap)
{
    uint8_t *ybuf = (uint8_t *)malloc(M);
    int32_t *ones = (int32_t *)malloc(M * sizeof(int32_t));
    uint8_t *runbuf = (uint8_t *)malloc(M + 8);
    long nout = 0;
    for (long kk = 0; kk < N; ++kk) {
        const uint8_t *x = cols + kk * M;
        for (long i = 0; i < M; ++i) ybuf[i] = x[a[i]];
        long nb = p3_encode(ybuf, M, runbuf);
        if (nout + nb <= cap) memcpy(yz + nout, runbuf, nb);
        nout += nb;
        fwd_a(a, ybuf, ones, M);
    }
    free(ybuf); free(ones); free(runbuf);
    return nout;
}

/* cache-blocked uint8 transpose: (R, C) row-major -> (C, R) row-major.
   numpy's strided byte transpose is ~10x slower than the build itself. */
EXPORT void transpose_u8(const uint8_t *src, long R, long C, uint8_t *dst)
{
    const long B = 64;
    for (long r0 = 0; r0 < R; r0 += B) {
        long r1 = r0 + B < R ? r0 + B : R;
        for (long c0 = 0; c0 < C; c0 += B) {
            long c1 = c0 + B < C ? c0 + B : C;
            for (long r = r0; r < r1; ++r)
                for (long c = c0; c < c1; ++c)
                    dst[c * R + r] = src[r * C + c];
        }
    }
}

/* expand device-emitted match records into (q, hap, start, end) rows.
   Ysort is the (N, M) sorted-column stream from the device matcher; the
   prefix array is replayed with the stable partition only (no gather).
   rec_off[k]..rec_off[k+1] index the records reported at site k (k = N is
   the final flush); each record contributes rows for panel positions
   [f, g).  Returns the number of rows written (caller pre-sizes out). */
EXPORT long expand_records(const uint8_t *Ybits, long stride, long M, long N,
                           const int64_t *rec_off,
                           const int32_t *rec_q, const int32_t *rec_e,
                           const int32_t *rec_f, const int32_t *rec_g,
                           int32_t *out, long cap)
{
    int32_t *a = (int32_t *)malloc(M * sizeof(int32_t));
    int32_t *ones = (int32_t *)malloc(M * sizeof(int32_t));
    long nrows = 0;
    for (long i = 0; i < M; ++i) a[i] = (int32_t)i;
    for (long k = 0; k <= N; ++k) {
        for (long r = rec_off[k]; r < rec_off[k + 1]; ++r) {
            for (long i = rec_f[r]; i < rec_g[r]; ++i) {
                if (nrows < cap) {
                    int32_t *row = out + 4 * nrows;
                    row[0] = rec_q[r]; row[1] = a[i];
                    row[2] = rec_e[r]; row[3] = (int32_t)k;
                }
                ++nrows;
            }
        }
        if (k < N) {
            /* stable partition of a by the bit-packed sorted column
               (bit 7 first within each byte, numpy packbits order) */
            const uint8_t *yb = Ybits + k * stride;
            long u = 0, v = 0, i = 0;
            for (long B = 0; B < stride && i < M; ++B) {
                uint8_t byte = yb[B];
                long hi = M - i < 8 ? M - i : 8;
                for (long t = 0; t < hi; ++t, ++i) {
                    if (byte & (0x80u >> t)) ones[v++] = a[i];
                    else a[u++] = a[i];
                }
            }
            memcpy(a + u, ones, v * sizeof(int32_t));
        }
    }
    free(a); free(ones);
    return nrows;
}

/* VCF sample-column parser: scan the tab-separated sample fields of one
   record, extracting up to two GT alleles per sample from subfield gti.
   out (2*nsamp int8): allele index, -1 = missing ('.'), second = -2 when
   the sample is haploid. Returns samples parsed, or -1 on malformed
   input. */
EXPORT long vcf_parse_gt(const char *s, long len, long gti, long nsamp,
                         int8_t *out)
{
    const char *p = s, *end = s + len;
    long ns = 0;
    while (ns < nsamp) {
        /* skip to subfield gti within this sample field */
        long sub = 0;
        while (sub < gti) {
            while (p < end && *p != ':' && *p != '\t') ++p;
            if (p >= end || *p == '\t') return -1;
            ++p; ++sub;
        }
        int8_t *o = out + 2 * ns;
        o[0] = -1; o[1] = -2;
        for (int h = 0; h < 2; ++h) {
            if (p < end && *p == '.') {
                o[h] = -1; ++p;
            } else {
                long v = -1;
                while (p < end && *p >= '0' && *p <= '9') {
                    if (v < 0) v = 0;
                    v = v * 10 + (*p - '0');
                    ++p;
                }
                if (v >= 0) o[h] = (int8_t)(v > 127 ? 127 : v);
                else if (h == 0) o[0] = -1;   /* empty GT == missing */
            }
            if (p < end && (*p == '|' || *p == '/')) {
                if (h == 0) { o[1] = -1; ++p; }   /* diploid: parse 2nd */
            } else break;
        }
        /* skip trailing alleles (>2) and remaining subfields */
        while (p < end && *p != '\t') ++p;
        ++ns;
        if (p < end) ++p;              /* consume the tab */
        else break;
    }
    return ns;
}

/* phaseSweep het resolution (pbwtImpute.c:288-372): iterative
   Gauss-Seidel passes over sample pairs scoring sort-order neighbours
   in ncur cursors (score0), threshold decay, then the length-weighted
   score1 fallback over the first n1cur cursors. aL/aR[-1] = absent.
   xp is mutated in place. */
EXPORT void phase_resolve(double *xp, long M, long ncur, long n1cur,
                          const int32_t *aL, const int32_t *aR,
                          const double *wL, const double *wR,
                          double thresh)
{
    long n2 = 0;
    for (long i = 0; i < M; i += 2) if (xp[i] == 0.0) ++n2;
    while (n2 && thresh > 1.0) {
        long n2_old = n2;
        n2 = 0;
        for (long i = 0; i < M; i += 2) {
            if (xp[i] != 0.0) continue;
            double s = 0.0;
            for (long c = 0; c < ncur; ++c) {
                const int32_t *l = aL + c * M, *r = aR + c * M;
                double si = 0.0, sj = 0.0;
                int32_t v;
                if ((v = l[i]) >= 0) si += xp[v];
                if ((v = r[i]) >= 0) si += xp[v];
                if ((v = l[i + 1]) >= 0) sj += xp[v];
                if ((v = r[i + 1]) >= 0) sj += xp[v];
                s += si - sj;
            }
            if (s > thresh) { xp[i] = 1.0; xp[i + 1] = -1.0; }
            else if (s < -thresh) { xp[i] = -1.0; xp[i + 1] = 1.0; }
            else ++n2;
        }
        if (n2 == n2_old) thresh -= 1.0;
    }
    if (n2) {
        for (long i = 0; i < M; i += 2) {
            if (xp[i] != 0.0) continue;
            double s = 0.0;
            for (long c = 0; c < n1cur; ++c) {
                const int32_t *l = aL + c * M, *r = aR + c * M;
                const double *lw = wL + c * M, *rw = wR + c * M;
                double si = 0.0, sj = 0.0;
                int32_t v;
                if ((v = l[i]) >= 0) si += xp[v] * lw[i];
                if ((v = r[i]) >= 0) si += xp[v] * rw[i];
                if ((v = l[i + 1]) >= 0) sj += xp[v] * lw[i + 1];
                if ((v = r[i + 1]) >= 0) sj += xp[v] * rw[i + 1];
                s += si - sj;
            }
            if (s > 0) { xp[i] = 1.0; xp[i + 1] = -1.0; }
            else { xp[i] = -1.0; xp[i + 1] = 1.0; }
        }
    }
}

/* paintAncestryMatrix accumulation (pbwtPaint.c:56-209, dense variant):
   per recipient haplotype, walk sites distributing the positional weight
   (k-start)*(end-k)/sum over donor individuals, with chunksperregion
   region flushes. Segments per hap are in report order (end ascending).
   cutoff < 0 disables the sparse length cutoff. */
EXPORT void paint_accumulate(const int32_t *seg_j, const int32_t *seg_s,
                             const int32_t *seg_e, const int64_t *seg_off,
                             long M, long N, long n_inds, long ploidy,
                             long chunksperregion, double cutoff,
                             double *counts, double *counts2,
                             double *counts3, double *totlengths,
                             double *nregions, double *part)
{
    long n_all = seg_off[M];
    /* per-match invariants hoisted out of the per-site window scans:
       individual id (integer division) and match length as double */
    int32_t *mind = (int32_t *)malloc((n_all ? n_all : 1)
                                      * sizeof(int32_t));
    double *mlen = (double *)malloc((n_all ? n_all : 1) * sizeof(double));
    if (!mind || !mlen) { free(mind); free(mlen); return; }
    for (long m = 0; m < n_all; ++m) {
        mind[m] = (int32_t)(seg_j[m] / ploidy);
        mlen[m] = (double)(seg_e[m] - seg_s[m]);
    }
    for (long i = 0; i < M; ++i) {
        long lo = seg_off[i], hi = seg_off[i + 1];
        if (lo >= hi) continue;
        long me = i / ploidy;
        long m1 = lo, n1 = 1, m_stop = hi - 1;
        for (long j = 0; j < n_inds; ++j) part[j] = 0.0;
        double *cnt = counts + me * n_inds;
        double *cnt2 = counts2 + me * n_inds;
        double *cnt3 = counts3 + me * n_inds;
        double *tl = totlengths + me * n_inds;
        for (long k = 1; k < N; ++k) {
            while (seg_e[m1] <= k && m1 < m_stop) {
                if (n1 % chunksperregion == 0) {
                    for (long j = 0; j < n_inds; ++j) {
                        if (j == me) continue;
                        cnt2[j] += part[j] * part[j];
                        cnt3[j] += part[j];
                        part[j] = 0.0;
                    }
                    /* the reference zeroes every entry, recipient too */
                    part[me] = 0.0;
                    nregions[me] += 1.0;
                }
                ++m1; ++n1;
            }
            double ssum = 0.0;
            for (long m = m1; m <= m_stop && seg_s[m] < k; ++m) {
                if (mind[m] != me && mlen[m] > cutoff)
                    ssum += (double)(k - seg_s[m])
                            * (double)(seg_e[m] - k);
            }
            if (ssum == 0.0) continue;
            for (long m = m1; m <= m_stop && seg_s[m] < k; ++m) {
                long ind = mind[m];
                if (ind == me) continue;
                if (mlen[m] <= cutoff) continue;
                double w = (double)(k - seg_s[m])
                           * (double)(seg_e[m] - k) / ssum;
                tl[ind] += w;
                double thiscount = w / mlen[m];
                cnt[ind] += thiscount;
                part[ind] += thiscount;
            }
        }
    }
    free(mind); free(mlen);
}

/* paintAncestryMatrixSparse per-individual accumulation
   (pbwtPaint.c:211-328): like paint_accumulate but over one recipient
   individual's haplotypes [i0, i1) with a match-length cutoff, nonzero-
   entry region flushes and the per-site indsum counter used for the
   SparsePainter length normalisation. */
EXPORT void paint_sparse_ind(const int32_t *seg_j, const int32_t *seg_s,
                             const int32_t *seg_e, const int64_t *seg_off,
                             long i0, long i1, long N, long n_inds,
                             long ploidy, long chunksperregion,
                             double cutoff,
                             double *t_counts, double *t_counts2,
                             double *t_counts3, double *t_totlengths,
                             double *nregions_me, double *part,
                             double *indsum)
{
    long me = i0 / ploidy;
    for (long i = i0; i < i1; ++i) {
        long lo = seg_off[i], hi = seg_off[i + 1];
        if (lo >= hi) continue;
        long m1 = lo, n1 = 1, m_stop = hi - 1;
        for (long k = 1; k < N; ++k) {
            while (seg_e[m1] <= k && m1 < m_stop) {
                if (n1 % chunksperregion == 0) {
                    for (long j = 0; j < n_inds; ++j) {
                        if (j == me || part[j] == 0.0) continue;
                        t_counts2[j] += part[j] * part[j];
                        t_counts3[j] += part[j];
                    }
                    for (long j = 0; j < n_inds; ++j) part[j] = 0.0;
                    *nregions_me += 1.0;
                }
                ++m1; ++n1;
            }
            double ssum = 0.0;
            for (long m = m1; m <= m_stop && seg_s[m] < k; ++m) {
                if (seg_j[m] / ploidy != me
                        && (double)(seg_e[m] - seg_s[m]) > cutoff) {
                    ssum += (double)(k - seg_s[m])
                            * (double)(seg_e[m] - k);
                }
            }
            if (ssum == 0.0) continue;
            for (long m = m1; m <= m_stop && seg_s[m] < k; ++m) {
                long ind = seg_j[m] / ploidy;
                if (ind == me) continue;
                if ((double)(seg_e[m] - seg_s[m]) <= cutoff) continue;
                double w = (double)(k - seg_s[m])
                           * (double)(seg_e[m] - k) / ssum;
                t_totlengths[ind] += w;
                double thiscount = w / (double)(seg_e[m] - seg_s[m]);
                t_counts[ind] += thiscount;
                part[ind] += thiscount;
            }
            *indsum += 1.0;
        }
    }
}

/* Bucket (ai, bi, s, e) int64 match rows by recipient ai: stable counting
   sort into int32 column arrays + CSR offsets, replacing the numpy
   argsort/gather path (8.6 GB of int64 traffic at 270M rows). */
EXPORT void bucket_rows(const int64_t *rows, long n, long M,
                        int32_t *sj, int32_t *ss, int32_t *se,
                        int64_t *seg_off)
{
    memset(seg_off, 0, (M + 1) * sizeof(int64_t));
    for (long m = 0; m < n; ++m) ++seg_off[rows[4 * m] + 1];
    for (long i = 0; i < M; ++i) seg_off[i + 1] += seg_off[i];
    int64_t *cur = (int64_t *)malloc(M * sizeof(int64_t));
    memcpy(cur, seg_off, M * sizeof(int64_t));
    for (long m = 0; m < n; ++m) {
        const int64_t *r = rows + 4 * m;
        long p = cur[r[0]]++;
        sj[p] = (int32_t)r[1];
        ss[p] = (int32_t)r[2];
        se[p] = (int32_t)r[3];
    }
    free(cur);
}

/* paintAncestryMatrixSparse, whole-run native path (pbwtPaint.c:211-328):
   per-individual accumulation with
     * O(1)-per-site incremental weight normalisation: ssum_k over the
       active window is the quadratic -A k^2 + B k - C with integer
       A/B/C updated at window enter/exit (every partial double sum of
       the reference's per-site loop is an exact integer < 2^53, so the
       incremental value is bit-identical),
     * touched-donor lists instead of O(n_inds) region flushes/zeroing,
     * gzip-streamed output written here (zlib level 6, same bytes'
       content as the reference's gzprintf tables).
   Returns 0 on success, -1 on file-open failure. */
static int cmp_i32(const void *x, const void *y)
{
    return *(const int32_t *)x - *(const int32_t *)y;
}

EXPORT long paint_sparse_all(const int32_t *seg_j, const int32_t *seg_s,
                             const int32_t *seg_e, const int64_t *seg_off,
                             long M, long N, long n_inds, long ploidy,
                             long chunksperregion, double cutoff,
                             const char *root)
{
    static const char *sfx[5] = {
        "nregions", "chunkcounts", "chunklengths",
        "regionsquaredchunkcounts", "regionchunkcounts" };
    gzFile fz[5];
    char path[4096];
    for (int f = 0; f < 5; ++f) {
        snprintf(path, sizeof path, "%s.%s.s.out.gz", root, sfx[f]);
        fz[f] = gzopen(path, "w6");
        if (!fz[f]) {
            for (int g = 0; g < f; ++g) gzclose(fz[g]);
            return -1;
        }
    }
    gzbuffer(fz[1], 1 << 20); gzbuffer(fz[2], 1 << 20);
    gzbuffer(fz[3], 1 << 20); gzbuffer(fz[4], 1 << 20);

    /* batch the data rows through text buffers: gzprintf pays a
       vsnprintf + zlib call per LINE, which dominates at hundreds of
       millions of sparse entries; identical bytes (put_dec + the exact
       fixed-point ' %.4f' path), identical deflate framing (one gzwrite
       stream per file, no extra flushes) */
    enum { OCAP = 1 << 20 };
    char *obuf[5] = {0};
    long olen[5] = {0};
    for (int f = 1; f < 5; ++f) obuf[f] = (char *)malloc(OCAP);
#define SPARSE_ROW(f, ival, jval, v) do { \
        if (olen[f] + 64 > OCAP) { \
            gzwrite(fz[f], obuf[f], (unsigned)olen[f]); olen[f] = 0; } \
        char *p_ = obuf[f] + olen[f]; \
        p_ = (char *)put_dec((uint8_t *)p_, (ival)); *p_++ = ' '; \
        p_ = (char *)put_dec((uint8_t *)p_, (jval)); \
        p_ += fmt_f4_one((v), p_); \
        *p_++ = '\n'; \
        olen[f] = p_ - obuf[f]; \
    } while (0)

    double *t_counts = (double *)calloc(n_inds, sizeof(double));
    double *t_counts2 = (double *)calloc(n_inds, sizeof(double));
    double *t_counts3 = (double *)calloc(n_inds, sizeof(double));
    double *tl = (double *)calloc(n_inds, sizeof(double));
    double *part = (double *)calloc(n_inds, sizeof(double));
    uint8_t *seen = (uint8_t *)calloc(n_inds, 1);      /* t_counts touched */
    uint8_t *seenp = (uint8_t *)calloc(n_inds, 1);     /* part touched */
    int32_t *touch = (int32_t *)malloc(n_inds * sizeof(int32_t));
    int32_t *touchp = (int32_t *)malloc(n_inds * sizeof(int32_t));
    long scap = 4096;
    int32_t *find_ = (int32_t *)malloc(scap * sizeof(int32_t));
    int32_t *fs = (int32_t *)malloc(scap * sizeof(int32_t));
    int32_t *fe = (int32_t *)malloc(scap * sizeof(int32_t));

    for (long ii = 0; ii < n_inds; ++ii) {
        long me = ii;
        long ntouch = 0, ntouchp = 0;
        double nreg = 0.0, indsum = 0.0;
        for (long i = ii * ploidy; i < (ii + 1) * ploidy; ++i) {
            long lo = seg_off[i], hi = seg_off[i + 1];
            if (lo >= hi) continue;
            long nseg = hi - lo;
            if (nseg > scap) {
                while (scap < nseg) scap *= 2;
                find_ = (int32_t *)realloc(find_, scap * sizeof(int32_t));
                fs = (int32_t *)realloc(fs, scap * sizeof(int32_t));
                fe = (int32_t *)realloc(fe, scap * sizeof(int32_t));
            }
            /* prefilter: donor individual per segment; -1 = excluded from
               weighting (self individual or below the length cutoff) */
            for (long m = 0; m < nseg; ++m) {
                long ind = seg_j[lo + m] / ploidy;
                int32_t s = seg_s[lo + m], e = seg_e[lo + m];
                find_[m] = (ind == me
                            || (double)(e - s) <= cutoff) ? -1 : (int32_t)ind;
                fs[m] = s; fe[m] = e;
            }
            long m1 = 0, n1 = 1, m_stop = nseg - 1, mend = 0;
            /* active-window integer sums over valid segments:
               ssum_k = -A k^2 + B k - C, A = count, B = sum(s+e),
               C = sum(s*e) */
            long A = 0; int64_t Bs = 0, Cs = 0;
            for (long k = 1; k < N; ++k) {
                while (fe[m1] <= k && m1 < m_stop) {
                    if (n1 % chunksperregion == 0) {
                        for (long t = 0; t < ntouchp; ++t) {
                            long j = touchp[t];
                            double pj = part[j];
                            if (pj != 0.0) {
                                t_counts2[j] += pj * pj;
                                t_counts3[j] += pj;
                            }
                            part[j] = 0.0;
                            seenp[j] = 0;
                        }
                        ntouchp = 0;
                        nreg += 1.0;
                    }
                    if (m1 < mend && find_[m1] >= 0) {  /* leaves window */
                        --A;
                        Bs -= (int64_t)fs[m1] + fe[m1];
                        Cs -= (int64_t)fs[m1] * fe[m1];
                    }
                    ++m1; ++n1;
                }
                while (mend <= m_stop && fs[mend] < k) {
                    if (mend >= m1 && find_[mend] >= 0) {
                        ++A;
                        Bs += (int64_t)fs[mend] + fe[mend];
                        Cs += (int64_t)fs[mend] * fe[mend];
                    }
                    ++mend;
                }
                double ssum = (double)(-(int64_t)A * k * k + Bs * k - Cs);
                if (ssum == 0.0) continue;
                for (long m = m1; m < mend; ++m) {
                    long ind = find_[m];
                    if (ind < 0) continue;
                    double w = (double)(k - fs[m])
                               * (double)(fe[m] - k) / ssum;
                    tl[ind] += w;
                    double thiscount = w / (double)(fe[m] - fs[m]);
                    if (!seen[ind]) { seen[ind] = 1; touch[ntouch++] = ind; }
                    t_counts[ind] += thiscount;
                    if (!seenp[ind]) {
                        seenp[ind] = 1;
                        touchp[ntouchp++] = ind;
                    }
                    part[ind] += thiscount;
                }
                indsum += 1.0;
            }
        }
        /* part carries across the individual's haplotypes (the reference
           resets it only at individual boundaries); the final incomplete
           region is dropped, matching pbwtPaint.c */
        for (long t = 0; t < ntouchp; ++t) {
            part[touchp[t]] = 0.0;
            seenp[touchp[t]] = 0;
        }
        ntouchp = 0;
        if (indsum != 0.0) {
            for (long t = 0; t < ntouch; ++t) {
                long j = touch[t];
                if (tl[j] != 0.0)
                    tl[j] = tl[j] / indsum * (double)N * (double)ploidy;
            }
        }
        /* ascending-donor output, skipping entries that cancelled to 0 */
        if (ntouch) {
            qsort(touch, ntouch, sizeof(int32_t), cmp_i32);
            for (long t = 0; t < ntouch; ++t) {
                long j = touch[t];
                if (t_counts[j] != 0.0) {
                    SPARSE_ROW(1, ii + 1, j + 1, t_counts[j]);
                    SPARSE_ROW(2, ii + 1, j + 1, tl[j]);
                    SPARSE_ROW(3, ii + 1, j + 1, t_counts2[j]);
                    SPARSE_ROW(4, ii + 1, j + 1, t_counts3[j]);
                }
                t_counts[j] = 0.0; t_counts2[j] = 0.0; t_counts3[j] = 0.0;
                tl[j] = 0.0; seen[j] = 0;
            }
        }
        gzprintf(fz[0], "%ld %.2f\n", ii + 1, nreg);
    }
    for (int f = 1; f < 5; ++f)
        if (olen[f]) gzwrite(fz[f], obuf[f], (unsigned)olen[f]);
    for (int f = 1; f < 5; ++f) free(obuf[f]);
#undef SPARSE_ROW
    for (int f = 0; f < 5; ++f) gzclose(fz[f]);
    free(t_counts); free(t_counts2); free(t_counts3); free(tl); free(part);
    free(seen); free(seenp); free(touch); free(touchp);
    free(find_); free(fs); free(fe);
    return 0;
}

/* referenceImpute3 weighted vote (pbwtImpute.c:1204-1232): per reference
   site and target haplotype, the positionally weighted allele vote over
   covering maximal-match segments, with the reference's segment-window
   advance and sequential float accumulation (bit-exact dosages).
   Xcols is (Nref, Mref) natural-order alleles, one contiguous row per
   site. Also fills the per-site info inputs psum/xsum/pxsum/nvote. */
EXPORT void impute_vote(const int32_t *seg_jref, const int32_t *seg_s,
                        const int32_t *seg_e, const int64_t *seg_off,
                        int32_t *first, long T, long Nref,
                        const uint8_t *Xcols, long Mref,
                        const int64_t *kold, const double *ref_freq,
                        uint8_t *x_out, double *dos_out, uint8_t *voted_out,
                        double *psum_out, double *xsum_out,
                        double *pxsum_out, int64_t *nvote_out)
{
    for (long k = 0; k < Nref; ++k) {
        long ko = kold[k];
        const uint8_t *col = Xcols + k * Mref;
        double rf = ref_freq[k];
        double psum = 0, xsum = 0, pxsum = 0;
        long n = 0;
        uint8_t *xr = x_out + k * T;
        double *dr = dos_out + k * T;
        uint8_t *vr = voted_out + k * T;
        for (long j = 0; j < T; ++j) {
            long mi = first[j], end = seg_off[j + 1];
            while (mi < end && seg_e[mi] <= ko) ++mi;
            first[j] = (int32_t)mi;
            double ssum = 0, score = 0;
            for (; mi < end && seg_s[mi] < ko; ++mi) {
                double bit = (double)(ko - seg_s[mi])
                             * (double)(seg_e[mi] - ko);
                if (bit > 0) {
                    ssum += bit;
                    if (col[seg_jref[mi]]) score += bit;
                }
            }
            if (ssum == 0) {
                xr[j] = rf > 0.5;
                dr[j] = rf;
                vr[j] = 0;
            } else {
                double pj = score / ssum;
                xr[j] = pj > 0.5;
                dr[j] = pj;
                vr[j] = 1;
                psum += pj; xsum += xr[j]; pxsum += pj * xr[j];
                ++n;
            }
        }
        psum_out[k] = psum; xsum_out[k] = xsum; pxsum_out[k] = pxsum;
        nvote_out[k] = n;
    }
}

/* EXTEND4 reference-phasing helpers (pbwtImpute.c:848-901): segmented
   running maxima of the divergence array that stop at the nearest
   position with allele x (the values pbwtCursorMapDplus/Dminus would
   accumulate). -1 marks "no accumulation". */
EXPORT void phase_stop_max(const int32_t *d, const uint8_t *y, int x, long M,
                           int64_t *bp, int64_t *bm)
{
    bp[M] = -1;
    for (long i = M - 1; i >= 0; --i) {
        if (y[i] != x) {
            int64_t prev = bp[i + 1];
            int64_t di = d[i];
            bp[i] = (prev >= 0 && prev > di) ? prev : di;
        } else bp[i] = -1;
    }
    bm[0] = -1;
    for (long i = 1; i <= M; ++i) {
        if (y[i - 1] != x) {
            int64_t prev = bm[i - 1];
            int64_t di = d[i - 1];
            bm[i] = (prev >= 0 && prev > di) ? prev : di;
        } else bm[i] = -1;
    }
}

/* threaded variant: replay chunks of sites in parallel from device
   prefix-array snapshots, reading allele bits straight from the
   natural-order bit-packed panel rows (no sorted-column stream, no
   transpose). Padded duplicate rows (id >= M) read row id % M's bits
   (duplicates are copies of row 0 => id-M maps to 0) and are emitted
   like any other id; the caller filters them. */
#include <pthread.h>

typedef struct {
    const uint8_t *ybits; long stride, Mp, N;
    long k0, k1;
    const int32_t *snap;
    const int64_t *rec_off;
    const int32_t *rec_q, *rec_e, *rec_f, *rec_g;
    int32_t *out; long out_start;
} ExpandChunk;

static void *expand_chunk(void *argp)
{
    ExpandChunk *c = (ExpandChunk *)argp;
    long Mp = c->Mp;
    int32_t *a = (int32_t *)malloc(Mp * sizeof(int32_t));
    int32_t *ones = (int32_t *)malloc(Mp * sizeof(int32_t));
    memcpy(a, c->snap, Mp * sizeof(int32_t));
    long nrows = c->out_start;
    for (long k = c->k0; k < c->k1; ++k) {
        for (long r = c->rec_off[k]; r < c->rec_off[k + 1]; ++r) {
            for (long i = c->rec_f[r]; i < c->rec_g[r]; ++i) {
                int32_t *row = c->out + 4 * nrows++;
                row[0] = c->rec_q[r]; row[1] = a[i];
                row[2] = c->rec_e[r]; row[3] = (int32_t)k;
            }
        }
        if (k < c->N) {
            /* stable partition by the bit-packed sorted column */
            const uint8_t *yb = c->ybits + k * c->stride;
            long u = 0, v = 0, i = 0;
            for (long B = 0; i < Mp; ++B) {
                uint8_t byte = yb[B];
                long hi = Mp - i < 8 ? Mp - i : 8;
                for (long t = 0; t < hi; ++t, ++i) {
                    if (byte & (0x80u >> t)) ones[v++] = a[i];
                    else a[u++] = a[i];
                }
            }
            memcpy(a + u, ones, v * sizeof(int32_t));
        }
    }
    free(a); free(ones);
    return NULL;
}

EXPORT long expand_records_mt(const uint8_t *ybits, long stride,
                              long Mp, long N, long nchunks,
                              const int64_t *chunk_k0,   /* (nchunks+1,) */
                              const int32_t *snaps,      /* (nchunks, Mp) */
                              const int64_t *rec_off,    /* (N+2,) */
                              const int32_t *rec_q, const int32_t *rec_e,
                              const int32_t *rec_f, const int32_t *rec_g,
                              const int64_t *row_start,  /* (nchunks,) */
                              int32_t *out)
{
    pthread_t tid[64];
    ExpandChunk args[64];
    if (nchunks > 64) nchunks = 64;
    for (long c = 0; c < nchunks; ++c) {
        args[c] = (ExpandChunk){ybits, stride, Mp, N,
                                chunk_k0[c], chunk_k0[c + 1],
                                snaps + c * Mp, rec_off,
                                rec_q, rec_e, rec_f, rec_g,
                                out, row_start[c]};
        pthread_create(&tid[c], NULL, expand_chunk, &args[c]);
    }
    for (long c = 0; c < nchunks; ++c) pthread_join(tid[c], NULL);
    return 0;
}

/* ------------------------------------------------------------------ */
/* matching                                                            */
/* ------------------------------------------------------------------ */

/* set-maximal matches within a panel (algorithm 4), streaming over packed
   sorted columns Ysort (N, M).  Reports (ai, bi, start, end) quadruples in
   the same order as the reference scan; returns count (writes at most cap
   rows so callers can size-and-retry). */
static long max_within_impl(colsrc *cs, long M, long N,
                            const int32_t *a0, rowsink *rs)
{
    int32_t *a = (int32_t *)malloc(M * sizeof(int32_t));
    int32_t *d = (int32_t *)calloc(M + 1, sizeof(int32_t));
    int32_t *ones = (int32_t *)malloc(M * sizeof(int32_t));
    int32_t *dones = (int32_t *)malloc((M + 1) * sizeof(int32_t));
    memcpy(a, a0, M * sizeof(int32_t));
    d[0] = 1; d[M] = 1;
    long nrep = 0;
    static const uint8_t yz_zero = 0;
    for (long kk = 0; kk <= N; ++kk) {
        const uint8_t *y = kk < N ? cs_next(cs, kk) : &yz_zero; /* unused at N */
        if (!y) { nrep = -1; break; }
        for (long i = 0; i < M; ++i) {
            long m = i - 1, n = i + 1;
            if (d[i] <= d[i + 1]) {          /* scan up */
                while (d[m + 1] <= d[i]) {
                    if (kk < N && y[m] == y[i]) goto next_i;
                    --m;
                }
            }
            if (d[i] >= d[i + 1]) {          /* scan down */
                while (d[n] <= d[i + 1]) {
                    if (kk < N && y[n] == y[i]) goto next_i;
                    ++n;
                }
            }
            /* zero-length rows are kept: collector callbacks in the
               reference (impute/paint) record them; printers filter */
            for (long j = m + 1; j < i; ++j)
                sink_row(rs, a[i], a[j], d[i], kk);
            for (long j = i + 1; j < n; ++j)
                sink_row(rs, a[i], a[j], d[i + 1], kk);
        next_i:;
        }
        if (kk < N) fwd_ad(a, d, y, ones, dones, M, (int32_t)kk);
    }
    free(a); free(d); free(ones); free(dones);
    return nrep < 0 ? -1 : rs->n;
}

EXPORT long max_within(const uint8_t *Ysort, long M, long N,
                       const int32_t *a0, int64_t *out, long cap)
{
    colsrc cs;
    cs_dense(&cs, Ysort, M);
    rowsink rs = { out, cap, 0, 0, 0, -1, NULL, 0 };
    return max_within_impl(&cs, M, N, a0, &rs);
}

/* streaming variant: one column of the pack3 stream live at a time */
EXPORT long max_within_packed(const uint8_t *yz, long nz, long M, long N,
                              const int32_t *a0, int64_t *out, long cap)
{
    colsrc cs;
    if (!cs_packed(&cs, yz, nz, M)) return -1;
    rowsink rs = { out, cap, 0, 0, 0, -1, NULL, 0 };
    long n = max_within_impl(&cs, M, N, a0, &rs);
    cs_free(&cs);
    return n;
}

/* Two-pass bucketed collection for painting (pbwtPaint.c feeds per-
   recipient match lists): pass 0 counts matches per recipient into
   off[1..M] (caller zeroes off) and leaves off holding the exclusive
   prefix starts (off[0] = 0, off[M] = n); pass 1 - after the caller
   allocates sj/ss/se of length n - places (bi, s, e) in the scan's
   report order per recipient and repairs off to the final seg_off.
   Peak memory is 3n int32 instead of the 4n int64 row set + copies. */
EXPORT long max_within_bucket_count(const uint8_t *yz, long nz, long M,
                                    long N, const int32_t *a0, int64_t *off)
{
    colsrc cs;
    if (!cs_packed(&cs, yz, nz, M)) return -1;
    rowsink rs = { NULL, 0, 0, 0, 0, -1, NULL, 0, NULL, NULL, NULL, off };
    long n = max_within_impl(&cs, M, N, a0, &rs);
    cs_free(&cs);
    if (n < 0) return -1;
    for (long i = 0; i < M; ++i) off[i + 1] += off[i];
    return n;
}

EXPORT long max_within_bucket_fill(const uint8_t *yz, long nz, long M,
                                   long N, const int32_t *a0, int32_t *sj,
                                   int32_t *ss, int32_t *se, int64_t *off)
{
    colsrc cs;
    if (!cs_packed(&cs, yz, nz, M)) return -1;
    rowsink rs = { NULL, 0, 0, 0, 0, -1, NULL, 0, sj, ss, se, off };
    long n = max_within_impl(&cs, M, N, a0, &rs);
    cs_free(&cs);
    if (n < 0) return -1;
    memmove(off + 1, off, M * sizeof(int64_t));
    off[0] = 0;
    return n;
}

/* stream MATCH lines straight to fd; returns report count (zero-length
   included) or -1 */
EXPORT long max_within_print(const uint8_t *yz, long nz, long M, long N,
                             const int32_t *a0, int fd)
{
    colsrc cs;
    if (!cs_packed(&cs, yz, nz, M)) return -1;
    uint8_t *buf = (uint8_t *)malloc(SINK_BUF + 256);
    rowsink rs = { NULL, 0, 0, 0, 0, fd, buf, 0 };
    long n = max_within_impl(&cs, M, N, a0, &rs);
    sink_flush(&rs);
    cs_free(&cs); free(buf);
    return n;
}

/* long matches > T within a panel (matchLongWithin2, pbwtMatch.c:85-113):
   block scan over divergence runs; at k == N the last column's values
   stay in y (the reference reads past the end and compares stale
   alleles). Reports (ai, bi, start, end); returns count. */
static long long_within_impl(colsrc *cs, long M, long N, long T,
                             const int32_t *a0, rowsink *rs)
{
    int32_t *a = (int32_t *)malloc(M * sizeof(int32_t));
    int32_t *d = (int32_t *)calloc(M + 1, sizeof(int32_t));
    int32_t *ones = (int32_t *)malloc(M * sizeof(int32_t));
    int32_t *dones = (int32_t *)malloc((M + 1) * sizeof(int32_t));
    memcpy(a, a0, M * sizeof(int32_t));
    d[0] = 1; d[M] = 1;
    long nrep = 0;
    const uint8_t *y = NULL;
    for (long kk = 0; kk <= N; ++kk) {
        if (kk < N) y = cs_next(cs, kk);   /* at N the last column persists */
        if (!y) { nrep = -1; break; }
        long i0 = 0, na = 0, nb = 0;
        for (long i = 0; i < M; ++i) {
            if (d[i] > kk - T) {
                if (na && nb) {
                    for (long ia = i0; ia < i; ++ia) {
                        long dmin = 0;
                        for (long ib = ia + 1; ib < i; ++ib) {
                            if (d[ib] > dmin) dmin = d[ib];
                            if (y[ib] != y[ia])
                                sink_row(rs, a[ia], a[ib], dmin, kk);
                        }
                    }
                }
                na = 0; nb = 0; i0 = i;
            }
            if (y[i] == 0) ++na; else ++nb;
        }
        if (kk < N) fwd_ad(a, d, y, ones, dones, M, (int32_t)kk);
    }
    free(a); free(d); free(ones); free(dones);
    return nrep < 0 ? -1 : rs->n;
}

EXPORT long long_within(const uint8_t *Ysort, long M, long N, long T,
                        const int32_t *a0, int64_t *out, long cap)
{
    colsrc cs;
    cs_dense(&cs, Ysort, M);
    rowsink rs = { out, cap, 0, 0, 0, -1, NULL, 0 };
    return long_within_impl(&cs, M, N, T, a0, &rs);
}

EXPORT long long_within_packed(const uint8_t *yz, long nz, long M, long N,
                               long T, const int32_t *a0, int64_t *out,
                               long cap)
{
    colsrc cs;
    if (!cs_packed(&cs, yz, nz, M)) return -1;
    rowsink rs = { out, cap, 0, 0, 0, -1, NULL, 0 };
    long n = long_within_impl(&cs, M, N, T, a0, &rs);
    cs_free(&cs);
    return n;
}

EXPORT long long_within_print(const uint8_t *yz, long nz, long M, long N,
                              long T, const int32_t *a0, int fd)
{
    colsrc cs;
    if (!cs_packed(&cs, yz, nz, M)) return -1;
    uint8_t *buf = (uint8_t *)malloc(SINK_BUF + 256);
    rowsink rs = { NULL, 0, 0, 0, 0, fd, buf, 0 };
    long n = long_within_impl(&cs, M, N, T, a0, &rs);
    sink_flush(&rs);
    cs_free(&cs); free(buf);
    return n;
}

/* dynamic sweep matching of queries against a panel (the production
   matcher).  Ysp/Ysq are sorted-order columns of panel and query pbwts.
   Reports (query, panel_hap, start, end) rows; returns count. */
static long sweep_match_impl(colsrc *csp, long M, colsrc *csq,
                             long Q, long N, const int32_t *ap0,
                             const int32_t *aq0, rowsink *rs)
{
    int32_t *ap = (int32_t *)malloc(M * sizeof(int32_t));
    int32_t *dp = (int32_t *)calloc(M + 1, sizeof(int32_t));
    int32_t *ap2 = (int32_t *)malloc(M * sizeof(int32_t));
    int32_t *dp2 = (int32_t *)calloc(M + 1, sizeof(int32_t));
    int32_t *aq = (int32_t *)malloc(Q * sizeof(int32_t));
    int32_t *ones = (int32_t *)malloc((M > Q ? M : Q) * sizeof(int32_t));
    int32_t *dones = (int32_t *)malloc((M + 1) * sizeof(int32_t));
    int32_t *u = (int32_t *)malloc((M + 1) * sizeof(int32_t));
    int64_t *f = (int64_t *)calloc(Q, sizeof(int64_t));
    int64_t *dq = (int64_t *)calloc(Q, sizeof(int64_t));
    memcpy(ap, ap0, M * sizeof(int32_t));
    memcpy(aq, aq0, Q * sizeof(int32_t));
    dp[0] = 1; dp[M] = 1;
    long nrep = 0;

#define REPORT(ai, bi, s, e) sink_row(rs, (ai), (bi), (s), (e))

    for (long kk = 0; kk < N; ++kk) {
        const uint8_t *yp = cs_next(csp, kk);
        const uint8_t *yq = cs_next(csq, kk);
        if (!yp || !yq) { nrep = -1; break; }
        for (long j = 0; j < Q; ++j) {
            long jj = aq[j];
            uint8_t x = yq[j];
            if (yp[f[jj]] == x) continue;
            /* same-length extension */
            long iplus = f[jj];
            int extended = 0;
            while (++iplus < M && dp[iplus] <= dq[jj]) {
                if (yp[iplus] == x) { f[jj] = iplus; extended = 1; break; }
            }
            if (extended) continue;
            for (long i = f[jj]; i < iplus; ++i)
                REPORT(jj, ap[i], dq[jj], kk);
            /* widen [iminus, iplus] for the new best match */
            long iminus = f[jj];
            long dplus = iplus < M ? dp[iplus] : kk;
            long dminus = dp[iminus];
            for (;;) {
                if (dminus <= dplus) {
                    long i = -1;
                    while (dp[iminus] <= dminus) {
                        --iminus;
                        if (yp[iminus] == x) i = iminus;
                    }
                    if (i >= 0) { f[jj] = i; dq[jj] = dminus; break; }
                    dminus = dp[iminus];
                } else {
                    int found = 0;
                    while (iplus < M && dp[iplus] <= dplus) {
                        if (yp[iplus] == x) {
                            f[jj] = iplus; dq[jj] = dplus; found = 1; break;
                        }
                        ++iplus;
                    }
                    if (found) break;
                    dplus = iplus == M ? kk : dp[iplus];
                    if (iminus == 0 && iplus == M) { dq[jj] = kk + 1; break; }
                }
            }
        }
        /* fused pass: FM rank table + panel a/d partition (ping-pong
           buffers; one read of yp, no copy-back) */
        {
            long c0 = 0, v = 0;
            int32_t pmax = (int32_t)kk + 1, qmax = (int32_t)kk + 1;
            for (long i = 0; i < M; ++i) {
                u[i] = (int32_t)c0;
                int32_t di = dp[i];
                if (di > pmax) pmax = di;
                if (di > qmax) qmax = di;
                if (yp[i] == 0) {
                    ap2[c0] = ap[i]; dp2[c0] = pmax; ++c0; pmax = 0;
                } else {
                    ones[v] = ap[i]; dones[v] = qmax; ++v; qmax = 0;
                }
            }
            u[M] = (int32_t)c0;
            memcpy(ap2 + c0, ones, v * sizeof(int32_t));
            memcpy(dp2 + c0, dones, v * sizeof(int32_t));
            dp2[0] = (int32_t)kk + 2;
            dp2[M] = (int32_t)kk + 2;
            { int32_t *t = ap; ap = ap2; ap2 = t; }
            { int32_t *t = dp; dp = dp2; dp2 = t; }
            for (long j = 0; j < Q; ++j) {
                long jj = aq[j];
                long fj = f[jj];
                f[jj] = yq[j] ? c0 + fj - u[fj] : u[fj];
                if (f[jj] == M) f[jj] = 0;
            }
        }
        fwd_a(aq, yq, ones, Q);
    }
    if (nrep >= 0)
        for (long j = 0; j < Q; ++j) {
            long jj = aq[j];
            REPORT(jj, ap[f[jj]], dq[jj], N);
            for (long i = f[jj] + 1; i < M && dp[i] <= dq[jj]; ++i)
                REPORT(jj, ap[i], dq[jj], N);
        }
#undef REPORT
    free(ap); free(dp); free(ap2); free(dp2);
    free(aq); free(ones); free(dones); free(u);
    free(f); free(dq);
    return nrep < 0 ? -1 : rs->n;
}

EXPORT long sweep_match(const uint8_t *Ysp, long M, const uint8_t *Ysq,
                        long Q, long N, const int32_t *ap0,
                        const int32_t *aq0, int64_t *out, long cap)
{
    colsrc cp, cq;
    cs_dense(&cp, Ysp, M);
    cs_dense(&cq, Ysq, Q);
    rowsink rs = { out, cap, 0, 0, 0, -1, NULL, 0 };
    return sweep_match_impl(&cp, M, &cq, Q, N, ap0, aq0, &rs);
}

EXPORT long sweep_match_packed(const uint8_t *yzp, long nzp, long M,
                               const uint8_t *yzq, long nzq, long Q, long N,
                               const int32_t *ap0, const int32_t *aq0,
                               int64_t *out, long cap)
{
    colsrc cp, cq;
    if (!cs_packed(&cp, yzp, nzp, M)) return -1;
    if (!cs_packed(&cq, yzq, nzq, Q)) { cs_free(&cp); return -1; }
    rowsink rs = { out, cap, 0, 0, 0, -1, NULL, 0 };
    long n = sweep_match_impl(&cp, M, &cq, Q, N, ap0, aq0, &rs);
    cs_free(&cp); cs_free(&cq);
    return n;
}

/* stream MATCH lines straight to fd; fills stats[0] = total reports
   (zero-length included), stats[1] = sum of nonzero lengths */
EXPORT long sweep_match_print(const uint8_t *yzp, long nzp, long M,
                              const uint8_t *yzq, long nzq, long Q, long N,
                              const int32_t *ap0, const int32_t *aq0,
                              int fd, int64_t *stats)
{
    colsrc cp, cq;
    if (!cs_packed(&cp, yzp, nzp, M)) return -1;
    if (!cs_packed(&cq, yzq, nzq, Q)) { cs_free(&cp); return -1; }
    uint8_t *buf = (uint8_t *)malloc(SINK_BUF + 256);
    rowsink rs = { NULL, 0, 0, 0, 0, fd, buf, 0 };
    long n = sweep_match_impl(&cp, M, &cq, Q, N, ap0, aq0, &rs);
    sink_flush(&rs);
    stats[0] = rs.n; stats[1] = rs.totlen; stats[2] = rs.nz;
    cs_free(&cp); cs_free(&cq); free(buf);
    return n;
}

/* bulk "MATCH\tai\tbi\tstart\tend\tlen\n" formatting of (n, 4) match rows
   (reportMatch, pbwtMatch.c:46-58; zero-length rows skipped).  Returns
   bytes needed, writing at most cap. */
EXPORT long format_match_rows(const int64_t *rows, long n, uint8_t *out,
                              long cap)
{
    long total = 0;
    uint8_t tmp[144];
    for (long i = 0; i < n; ++i) {
        const int64_t *r = rows + 4 * i;
        if (r[2] == r[3]) continue;
        uint8_t *p = tmp;
        memcpy(p, "MATCH\t", 6); p += 6;
        p = put_dec(p, r[0]); *p++ = '\t';
        p = put_dec(p, r[1]); *p++ = '\t';
        p = put_dec(p, r[2]); *p++ = '\t';
        p = put_dec(p, r[3]); *p++ = '\t';
        p = put_dec(p, r[3] - r[2]); *p++ = '\n';
        long len = p - tmp;
        if (total + len <= cap) memcpy(out + total, tmp, len);
        total += len;
    }
    return total;
}

/* per-column zero counts straight off the run-length bytes (no decode) */
EXPORT long col_counts(const uint8_t *yz, long nz, long M, long N,
                       int64_t *c0out)
{
    if (!p3dec_ready) p3dec_init();
    long pos = 0;
    for (long k = 0; k < N; ++k) {
        long m = 0, c0 = 0;
        while (m < M) {
            if (pos >= nz) return -1;
            uint8_t b = yz[pos++];
            long n = p3dec[b & 0x7f];
            if (!(b >> 7)) c0 += n;
            m += n;
        }
        if (m != M) return -1;
        c0out[k] = c0;
    }
    return pos;
}

/* stream a packed pbwt re-PBWTing a row (haplotype) selection: new column
   i copies old haplotype select[i] (pbwtSubSample, pbwtSample.c:59-93).
   Same cap/return convention as select_repack. */
EXPORT long subsample_repack(const uint8_t *yz, long nz, long M, long N,
                             const int64_t *select, long Mnew,
                             const int32_t *a0, uint8_t *out, long cap,
                             int32_t *a_end)
{
    colsrc cs;
    if (!cs_packed(&cs, yz, nz, M)) return -1;
    long Mx = M > Mnew ? M : Mnew;
    int32_t *a_src = (int32_t *)malloc(M * sizeof(int32_t));
    int32_t *a_dst = (int32_t *)malloc(Mnew * sizeof(int32_t));
    int32_t *ones = (int32_t *)malloc(Mx * sizeof(int32_t));
    uint8_t *x = (uint8_t *)malloc(M);
    uint8_t *y2 = (uint8_t *)malloc(Mnew);
    uint8_t *enc = (uint8_t *)malloc(Mnew + 8);
    memcpy(a_src, a0, M * sizeof(int32_t));
    for (long i = 0; i < Mnew; ++i) a_dst[i] = (int32_t)i;
    long total = 0;
    for (long k = 0; k < N; ++k) {
        const uint8_t *y = cs_next(&cs, k);
        if (!y) { total = -1; break; }
        for (long i = 0; i < M; ++i) x[a_src[i]] = y[i];
        for (long i = 0; i < Mnew; ++i) y2[i] = x[select[a_dst[i]]];
        long nb = p3_encode(y2, Mnew, enc);
        if (total + nb <= cap) memcpy(out + total, enc, nb);
        total += nb;
        fwd_a(a_dst, y2, ones, Mnew);
        fwd_a(a_src, y, ones, M);
    }
    if (total >= 0 && a_end) memcpy(a_end, a_dst, Mnew * sizeof(int32_t));
    cs_free(&cs);
    free(a_src); free(a_dst); free(ones); free(x); free(y2); free(enc);
    return total;
}

/* stream a packed pbwt selecting sites keep[k] != 0 and re-PBWT the kept
   columns under a fresh identity cursor (the streaming core of
   pbwtSubSites/SelectSites/SubRange/RemoveSites, pbwtCore.c:71-147):
   O(M) live memory.  Writes at most cap bytes of the new pack3 stream,
   returns the full needed length (caller retries with a bigger buffer if
   the return exceeds cap), and fills a_end with the final prefix array. */
EXPORT long select_repack(const uint8_t *yz, long nz, long M, long N,
                          const uint8_t *keep, const int32_t *a0,
                          uint8_t *out, long cap, int32_t *a_end)
{
    int32_t *a_src = (int32_t *)malloc(M * sizeof(int32_t));
    int32_t *a_dst = (int32_t *)malloc(M * sizeof(int32_t));
    int32_t *ones = (int32_t *)malloc(M * sizeof(int32_t));
    uint8_t *x = (uint8_t *)malloc(M);
    uint8_t *enc = (uint8_t *)malloc(M + 8);
    memcpy(a_src, a0, M * sizeof(int32_t));
    for (long i = 0; i < M; ++i) a_dst[i] = (int32_t)i;
    long pos = 0, total = 0;
    for (long k = 0; k < N; ++k) {
        /* fused run-level cursor steps (decode/scatter/partition, then
           gather/encode/partition) — two passes per kept site instead of
           the old decode + scatter + gather + encode + 2x fwd_a */
        if (keep[k]) {
            if (p3_scatter_fwd(yz, nz, &pos, a_src, ones, M, x) < 0) {
                total = -1;
                break;
            }
            long nb = gather_encode_fwd(a_dst, M, x, ones, enc);
            if (total + nb <= cap) memcpy(out + total, enc, nb);
            total += nb;
        } else if (p3_scatter_fwd(yz, nz, &pos, a_src, ones, M,
                                  NULL) < 0) {
            total = -1;
            break;
        }
    }
    if (total >= 0 && a_end) memcpy(a_end, a_dst, M * sizeof(int32_t));
    free(a_src); free(a_dst); free(ones); free(x); free(enc);
    return total;
}

/* ------------------------------------------------------------------ */
/* referenceImpute3 host fast paths (pbwtImpute.c:1126-1261)           */
/* ------------------------------------------------------------------ */

/* Stream-decode a packed PBWT and emit every column in NATURAL order
   (site-major X[(col, hap)]), advancing the prefix array in place and
   counting ones per column.  One pass replaces decode-all + a python
   a-chase + a transpose (the reference streams the same way through
   its read cursor, pbwtCore.c:527-541).  Returns bytes consumed, -1
   on a corrupt stream. */
EXPORT long natural_cols(const uint8_t *yz, long nz, long ncols, long M,
                         int32_t *a, uint8_t *X, int64_t *ones_count)
{
    if (!p3dec_ready) p3dec_init();
    uint8_t *y = (uint8_t *)malloc(M);
    int32_t *ones = (int32_t *)malloc(M * sizeof(int32_t));
    long pos = 0;
    for (long c = 0; c < ncols; ++c) {
        long m = 0;
        while (m < M) {
            if (pos >= nz) { free(y); free(ones); return -1; }
            uint8_t b = yz[pos++];
            long n = p3dec[b & 0x7f];
            if (m + n > M) { free(y); free(ones); return -1; }
            memset(y + m, b >> 7, n);
            m += n;
        }
        uint8_t *row = X + c * M;
        for (long i = 0; i < M; ++i) row[a[i]] = y[i];
        long c0 = fwd_a(a, y, ones, M);
        ones_count[c] = M - c0;
    }
    free(y); free(ones);
    return pos;
}

/* dosage quantisation (dosageEncode, pbwtImpute.c:1631-1641): 6 levels
   relative to the allele value */
static inline int dos_sym(double d)
{
    double dd = d > 0.5 ? 1.0 - d : d;
    return dd == 0.0 ? 0 : (int)(10.0 * (dd + 0.0999999));
}

/* dosage RLE byte emission (dosageStore, pbwtImpute.c:1643-1657) */
static inline long dos_emit(uint8_t *out, int d, long count)
{
    uint8_t *o = out;
    if (d == 0) {
        while (count >= (1L << 15)) { *o++ = 0xFF; count -= 31L << 10; }
        if (count >= (1L << 10)) {
            *o++ = (uint8_t)((7 << 5) | (count >> 10)); count &= 1023;
        }
        if (count >= (1L << 5)) {
            *o++ = (uint8_t)((6 << 5) | (count >> 5)); count &= 31;
        }
        *o++ = (uint8_t)count;
    } else {
        while (count >= (1L << 5)) { *o++ = (uint8_t)((d << 5) | 31); count -= 31; }
        *o++ = (uint8_t)((d << 5) | count);
    }
    return o - out;
}

/* The whole per-site output stage of referenceImpute3
   (pbwtImpute.c:1235-1239 + pbwtDosageStore): per reference site, gather
   the imputed alleles/dosages into current sort order, pack3-encode the
   allele column into yz, RLE-encode the quantised dosages into zdos
   (recording per-site offsets), and advance the prefix array.
   x_all/dos_all are site-major (Nref, T).  Returns 0, or -1 when a
   capacity bound would be exceeded (callers size caps to worst case so
   this indicates a bug). */
EXPORT long impute_emit(const uint8_t *x_all, const double *dos_all,
                        long T, long Nref, int32_t *a,
                        uint8_t *yz, long yz_cap,
                        uint8_t *zdos, long zdos_cap,
                        int64_t *dos_off, int64_t *lens_out)
{
    uint8_t *y = (uint8_t *)malloc(T);
    int32_t *ones = (int32_t *)malloc(T * sizeof(int32_t));
    uint8_t *runbuf = (uint8_t *)malloc(T + 8);
    long ny = 0, nd = 0;
    for (long k = 0; k < Nref; ++k) {
        const uint8_t *xr = x_all + k * T;
        const double *dr = dos_all + k * T;
        for (long i = 0; i < T; ++i) y[i] = xr[a[i]];
        long nb = p3_encode(y, T, runbuf);
        if (ny + nb > yz_cap) goto overflow;
        memcpy(yz + ny, runbuf, nb);
        ny += nb;
        dos_off[k] = nd;
        long i = 0;
        while (i < T) {
            int sym = dos_sym(dr[a[i]]);
            long cnt = 1;
            while (i + cnt < T && dos_sym(dr[a[i + cnt]]) == sym) ++cnt;
            if (nd + cnt + 8 > zdos_cap) goto overflow;
            nd += dos_emit(zdos + nd, sym, cnt);
            i += cnt;
        }
        fwd_a(a, y, ones, T);
    }
    lens_out[0] = ny;
    lens_out[1] = nd;
    free(y); free(ones); free(runbuf);
    return 0;
overflow:
    free(y); free(ones); free(runbuf);
    return -1;
}

/* One streaming pass for the whole referenceImpute3 core
   (pbwtImpute.c:1184-1251): per reference site, decode the panel column
   from the pack3 stream, scatter it to natural order, weighted-vote every
   target over its covering match segments, pack3-encode the imputed
   column, RLE-encode the quantised dosages, and advance both prefix
   arrays.  Live memory is O(Mref + T) — the reference's cursor memory
   model — so none of the (Nref x T) / (Nref x Mref) intermediates of the
   split vote/emit pipeline are ever materialised (their page-fault cost
   dominates wall time in this sandbox).
   segments must be sorted by (target, start); first[] = seg_off[:-1].
   Returns total no-vote conflicts, or -1 on corrupt stream / overflow. */
EXPORT long impute_vote_emit(
    const uint8_t *yzref, long nzref, long Mref, long Nref, int32_t *a_ref,
    const int32_t *seg_jref, const int32_t *seg_s, const int32_t *seg_e,
    const int64_t *seg_off, int32_t *first, long T, int32_t *a_tgt,
    const int64_t *kold,
    long self_mode, const uint8_t *zmiss, long nzmiss,
    const int64_t *miss_off,
    uint8_t *yz, long yz_cap, uint8_t *zdos, long zdos_cap,
    int64_t *dos_off, double *ref_freq_out,
    double *psum_out, double *xsum_out, double *pxsum_out,
    int64_t *nvote_out, int64_t *lens_out)
{
    if (!p3dec_ready) p3dec_init();
    uint8_t *ys = (uint8_t *)malloc(Mref);
    uint8_t *xnat = (uint8_t *)malloc(Mref);
    int32_t *ones_r = (int32_t *)malloc(Mref * sizeof(int32_t));
    uint8_t *xr = (uint8_t *)malloc(T);
    double *dr = (double *)malloc(T * sizeof(double));
    uint8_t *ynew = (uint8_t *)malloc(T);
    int32_t *ones_t = (int32_t *)malloc(T * sizeof(int32_t));
    uint8_t *runbuf = (uint8_t *)malloc(T + 8);
    uint8_t *miss = self_mode ? (uint8_t *)malloc(Mref) : NULL;
    long pos = 0, ny = 0, nd = 0, conflicts = 0;
    long rc = -1;
    for (long k = 0; k < Nref; ++k) {
        long m = 0, onec = 0;
        while (m < Mref) {
            if (pos >= nzref) goto done;
            uint8_t b = yzref[pos++];
            long n = p3dec[b & 0x7f];
            if (m + n > Mref) goto done;
            memset(ys + m, b >> 7, n);
            if (b >> 7) onec += n;
            m += n;
        }
        ref_freq_out[k] = (double)onec / (double)Mref;
        for (long i = 0; i < Mref; ++i) xnat[a_ref[i]] = ys[i];
        if (self_mode) {
            /* missing mask for this site, natural order (imputeMissing
               self-impute: complete entries copy straight through,
               pbwtImpute.c:1341-1358) */
            long moff = miss_off[k];
            if (moff > 0) {
                long mm = 0;
                while (mm < Mref) {
                    if (moff >= nzmiss) goto done;
                    uint8_t b = zmiss[moff++];
                    long n = p3dec[b & 0x7f];
                    if (mm + n > Mref) goto done;
                    memset(miss + mm, b >> 7, n);
                    mm += n;
                }
            } else
                memset(miss, 0, Mref);
        }

        long ko = kold[k];
        double rf = ref_freq_out[k];
        double psum = 0, xsum = 0, pxsum = 0;
        long n = 0;
        for (long j = 0; j < T; ++j) {
            if (self_mode && !miss[j]) {
                xr[j] = xnat[j];
                dr[j] = (double)xnat[j];
                continue;
            }
            long mi = first[j], end = seg_off[j + 1];
            while (mi < end && seg_e[mi] <= ko) ++mi;
            first[j] = (int32_t)mi;
            double ssum = 0, score = 0;
            for (; mi < end && seg_s[mi] < ko; ++mi) {
                double bit = (double)(ko - seg_s[mi])
                             * (double)(seg_e[mi] - ko);
                if (bit > 0) {
                    ssum += bit;
                    if (xnat[seg_jref[mi]]) score += bit;
                }
            }
            if (ssum == 0) {
                xr[j] = rf > 0.5;
                dr[j] = rf;
                ++conflicts;
            } else {
                double pj = score / ssum;
                xr[j] = pj > 0.5;
                dr[j] = pj;
                psum += pj; xsum += xr[j]; pxsum += pj * xr[j];
                ++n;
            }
        }
        psum_out[k] = psum; xsum_out[k] = xsum; pxsum_out[k] = pxsum;
        nvote_out[k] = n;

        for (long i = 0; i < T; ++i) ynew[i] = xr[a_tgt[i]];
        long nb = p3_encode(ynew, T, runbuf);
        if (ny + nb > yz_cap) goto done;
        memcpy(yz + ny, runbuf, nb);
        ny += nb;
        dos_off[k] = nd;
        long i = 0;
        while (i < T) {
            int sym = dos_sym(dr[a_tgt[i]]);
            long cnt = 1;
            while (i + cnt < T && dos_sym(dr[a_tgt[i + cnt]]) == sym) ++cnt;
            if (nd + cnt + 8 > zdos_cap) goto done;
            nd += dos_emit(zdos + nd, sym, cnt);
            i += cnt;
        }
        fwd_a(a_ref, ys, ones_r, Mref);
        fwd_a(a_tgt, ynew, ones_t, T);
    }
    lens_out[0] = ny;
    lens_out[1] = nd;
    rc = conflicts;
done:
    free(ys); free(xnat); free(ones_r); free(xr); free(dr);
    free(ynew); free(ones_t); free(runbuf); free(miss);
    return rc;
}

/* ------------------------------------------------------------------ */
/* referencePhase4 lattice core (pbwtImpute.c:905-1005)                 */
/* ------------------------------------------------------------------ */

/* The whole forward lattice pass as one streaming C loop, matching the
   batched-numpy implementation in algos/phase.py:reference_phase4 cell
   for cell (which is itself crosschecked byte-identical against the
   reference binary).  Per site: decode both pack3 columns, build the
   rank table and the EXTEND4 stop-max arrays, extend every live cell of
   every target diploid under both phase orders, keep the best arrival
   per (pair, target) with first-arrival tie-breaking (j ascending,
   phase 0 first), allocate traceback nodes for het winners in (pair,
   target) order, then advance both cursors.  Live memory is O(Mref + T)
   plus the lattice state; the traceback heap grows by realloc and is
   fetched via ref_phase4_heap(). */

static int32_t *rp4_parent = NULL;
static uint8_t *rp4_value = NULL;
static long rp4_n = 0, rp4_cap = 0;

static long rp4_node(int32_t parent, uint8_t value)
{
    if (rp4_n == rp4_cap) {
        rp4_cap = rp4_cap ? rp4_cap * 2 : (1 << 16);
        rp4_parent = (int32_t *)realloc(rp4_parent, rp4_cap * sizeof(int32_t));
        rp4_value = (uint8_t *)realloc(rp4_value, rp4_cap);
    }
    rp4_parent[rp4_n] = parent;
    rp4_value[rp4_n] = value;
    return rp4_n++;
}

static int rp4_cmp_i32(const void *a, const void *b)
{
    int32_t x = *(const int32_t *)a, y = *(const int32_t *)b;
    return x < y ? -1 : x > y;
}

typedef struct {                 /* one lattice cell (PhaseCell analogue) */
    float s;
    int32_t j1, dp0, dm0, dp1, dm1, back;
    uint8_t xa;                  /* winning first-hap allele (het nodes) */
} RP4Cell;

EXPORT long ref_phase4_core(const uint8_t *yzold, long nzold, long Mold,
                            const uint8_t *yzref, long nzref, long Mref,
                            long N, const int32_t *aold0,
                            const int32_t *aref0, int64_t *tb_out)
{
    if (!p3dec_ready) p3dec_init();
    long n_pairs = Mold / 2, Mc = Mref + 1, rc = -1;
    long pos_old = 0, pos_ref = 0;

    uint8_t *ys_old = (uint8_t *)malloc(Mold);
    uint8_t *x_old = (uint8_t *)malloc(Mold);
    uint8_t *ys = (uint8_t *)malloc(Mref);
    int32_t *a_old = (int32_t *)malloc(Mold * sizeof(int32_t));
    int32_t *a_ref = (int32_t *)malloc(Mref * sizeof(int32_t));
    int32_t *d = (int32_t *)calloc(Mc, sizeof(int32_t));
    int32_t *ones = (int32_t *)malloc(Mref * sizeof(int32_t));
    int32_t *dones = (int32_t *)malloc(Mref * sizeof(int32_t));
    int32_t *u = (int32_t *)malloc(Mc * sizeof(int32_t));
    int64_t *bp0 = (int64_t *)malloc(Mc * sizeof(int64_t));
    int64_t *bm0 = (int64_t *)malloc(Mc * sizeof(int64_t));
    int64_t *bp1 = (int64_t *)malloc(Mc * sizeof(int64_t));
    int64_t *bm1 = (int64_t *)malloc(Mc * sizeof(int64_t));
    RP4Cell *src = (RP4Cell *)calloc(n_pairs * Mc, sizeof(RP4Cell));
    RP4Cell *dst = (RP4Cell *)calloc(n_pairs * Mc, sizeof(RP4Cell));
    int32_t *stamp = (int32_t *)malloc(n_pairs * Mc * sizeof(int32_t));
    int32_t *live = (int32_t *)malloc(n_pairs * Mc * sizeof(int32_t));
    int32_t *newlv = (int32_t *)malloc(Mc * sizeof(int32_t));
    int32_t *nlive = (int32_t *)calloc(n_pairs, sizeof(int32_t));
    int32_t *nlive2 = (int32_t *)calloc(n_pairs, sizeof(int32_t));
    if (!src || !dst || !stamp || !live || !newlv) goto done;

    memcpy(a_old, aold0, Mold * sizeof(int32_t));
    memcpy(a_ref, aref0, Mref * sizeof(int32_t));
    d[0] = 1; d[Mref] = 1;
    for (long i = 0; i < n_pairs * Mc; ++i) stamp[i] = -1;
    rp4_n = 0;
    rp4_node(0, 0);                       /* root */
    for (long pr = 0; pr < n_pairs; ++pr) {
        src[pr * Mc].s = -1.0f;           /* cell j = 0 */
        live[pr * Mc] = 0;
        nlive[pr] = 1;
    }

    for (long k = 0; k < N; ++k) {
        /* --- decode one column of each pbwt --- */
        long m = 0;
        while (m < Mold) {
            if (pos_old >= nzold) goto done;
            uint8_t b = yzold[pos_old++];
            long n = p3dec[b & 0x7f];
            if (m + n > Mold) goto done;
            memset(ys_old + m, b >> 7, n);
            m += n;
        }
        for (long i = 0; i < Mold; ++i) x_old[a_old[i]] = ys_old[i];
        m = 0;
        while (m < Mref) {
            if (pos_ref >= nzref) goto done;
            uint8_t b = yzref[pos_ref++];
            long n = p3dec[b & 0x7f];
            if (m + n > Mref) goto done;
            memset(ys + m, b >> 7, n);
            m += n;
        }
        /* rank table u[i] = zeros in ys[0..i) ; c = u[Mref] */
        u[0] = 0;
        for (long i = 0; i < Mref; ++i) u[i + 1] = u[i] + (ys[i] == 0);
        long c = u[Mref];
        phase_stop_max(d, ys, 0, Mref, bp0, bm0);
        phase_stop_max(d, ys, 1, Mref, bp1, bm1);

        for (long pr = 0; pr < n_pairs; ++pr) {
            uint8_t x0 = x_old[2 * pr], x1 = x_old[2 * pr + 1];
            int het = x0 != x1;
            RP4Cell *srow = src + pr * Mc;
            RP4Cell *drow = dst + pr * Mc;
            int32_t *st = stamp + pr * Mc;
            int32_t *lv = live + pr * Mc;
            long nl = nlive[pr], nnew = 0;
            for (long li = 0; li < nl; ++li) {
                long j = lv[li];
                RP4Cell *cell = srow + j;
                for (int ph = 0; ph <= het; ++ph) {
                    uint8_t xa = ph ? x1 : x0, xb = ph ? x0 : x1;
                    long oj1 = cell->j1;
                    int64_t bpa = xa ? bp1[j] : bp0[j];
                    int64_t bma = xa ? bm1[j] : bm0[j];
                    int64_t bpb = xb ? bp1[oj1] : bp0[oj1];
                    int64_t bmb = xb ? bm1[oj1] : bm0[oj1];
                    int32_t tdp0 = (bpa >= 0 && bpa > cell->dp0)
                                   ? (int32_t)bpa : cell->dp0;
                    int32_t tdm0 = (bma >= 0 && bma > cell->dm0)
                                   ? (int32_t)bma : cell->dm0;
                    int32_t tdp1 = (bpb >= 0 && bpb > cell->dp1)
                                   ? (int32_t)bpb : cell->dp1;
                    int32_t tdm1 = (bmb >= 0 && bmb > cell->dm1)
                                   ? (int32_t)bmb : cell->dm1;
                    double ds0 = 0.0, ds1 = 0.0;
                    if (j > 0)
                        ds0 += (ys[j - 1] == xa ? 1.0 : -1.0)
                               * (double)(k - cell->dm0);
                    if (j < Mref)
                        ds0 += (ys[j] == xa ? 1.0 : -1.0)
                               * (double)(k - cell->dp0);
                    if (oj1 > 0)
                        ds1 += (ys[oj1 - 1] == xb ? 1.0 : -1.0)
                               * (double)(k - cell->dm1);
                    if (oj1 < Mref)
                        ds1 += (ys[oj1] == xb ? 1.0 : -1.0)
                               * (double)(k - cell->dp1);
                    float ts = cell->s;
                    ts += (float)(ds0 < 0.0 ? ds0 : 0.0);
                    ts += (float)(ds1 < 0.0 ? ds1 : 0.0);
                    long tgt = xa ? c + j - u[j] : u[j];
                    long nj1 = xb ? c + oj1 - u[oj1] : u[oj1];
                    if (st[tgt] != (int32_t)k) {
                        st[tgt] = (int32_t)k;
                        newlv[nnew++] = (int32_t)tgt;
                    } else if (!(ts > drow[tgt].s)) {
                        continue;        /* first arrival wins ties */
                    }
                    drow[tgt].s = ts;
                    drow[tgt].j1 = (int32_t)nj1;
                    drow[tgt].dp0 = tdp0; drow[tgt].dm0 = tdm0;
                    drow[tgt].dp1 = tdp1; drow[tgt].dm1 = tdm1;
                    drow[tgt].back = cell->back;
                    drow[tgt].xa = xa;
                }
            }
            /* new live set, ascending (pass 2: traceback allocation in
               (pair, target) order exactly like the batched update) */
            qsort(newlv, nnew, sizeof(int32_t), rp4_cmp_i32);
            if (het)
                for (long li = 0; li < nnew; ++li) {
                    long tgt = newlv[li];
                    drow[tgt].back =
                        (int32_t)rp4_node(drow[tgt].back, drow[tgt].xa);
                }
            memcpy(lv, newlv, nnew * sizeof(int32_t));
            nlive2[pr] = (int32_t)nnew;
        }
        { RP4Cell *t = src; src = dst; dst = t; }
        { int32_t *t = nlive; nlive = nlive2; nlive2 = t; }

        /* advance both cursors */
        fwd_a(a_old, ys_old, ones, Mold);
        fwd_ad(a_ref, d, ys, ones, dones, Mref, (int32_t)k);
    }

    /* best final cell per pair: max s, first (smallest j) on ties */
    for (long pr = 0; pr < n_pairs; ++pr) {
        RP4Cell *srow = src + pr * Mc;
        int32_t *lv = live + pr * Mc;
        qsort(lv, nlive[pr], sizeof(int32_t), rp4_cmp_i32);
        long best = -1;
        float bs = 0.0f;
        for (long li = 0; li < nlive[pr]; ++li) {
            long j = lv[li];
            if (best < 0 || srow[j].s > bs) { best = j; bs = srow[j].s; }
        }
        tb_out[pr] = best >= 0 ? srow[best].back : 0;
    }
    rc = rp4_n;
done:
    free(ys_old); free(x_old); free(ys); free(a_old); free(a_ref);
    free(d); free(ones); free(dones); free(u);
    free(bp0); free(bm0); free(bp1); free(bm1);
    free(src); free(dst); free(stamp); free(live); free(newlv);
    free(nlive); free(nlive2);
    return rc;
}

EXPORT void ref_phase4_heap(int32_t *parent_out, uint8_t *value_out)
{
    memcpy(parent_out, rp4_parent, rp4_n * sizeof(int32_t));
    memcpy(value_out, rp4_value, rp4_n);
    free(rp4_parent); free(rp4_value);
    rp4_parent = NULL; rp4_value = NULL;
    rp4_n = rp4_cap = 0;
}

/* ------------------------------------------------------------------ */
/* phaseSweep core (pbwtImpute.c:288-372)                              */
/* ------------------------------------------------------------------ */

/* byte offset of every pack3 column (one forward scan) */
static long p3_col_offsets(const uint8_t *yz, long nz, long N, long M,
                           int64_t *off)
{
    if (!p3dec_ready) p3dec_init();
    long pos = 0;
    for (long k = 0; k < N; ++k) {
        off[k] = pos;
        long m = 0;
        while (m < M) {
            if (pos >= nz) return -1;
            long n = p3dec[yz[pos++] & 0x7f];
            if (m + n > M) return -1;
            m += n;
        }
    }
    off[N] = pos;
    return pos;
}

static long p3_col_at(const uint8_t *yz, long nz, long off, long M,
                      uint8_t *y)
{
    long m = 0;
    while (m < M) {
        if (off >= nz) return -1;
        uint8_t b = yz[off++];
        long n = p3dec[b & 0x7f];
        if (m + n > M) return -1;
        memset(y + m, b >> 7, n);
        m += n;
    }
    return off;
}

/* inverse of the stable partition (pbwtCursorReadBackwards,
   pbwtCore.c:559-571): given the sorted column y at the earlier site,
   recover the prefix array entering it */
static void bwd_a(int32_t *a, const uint8_t *y, int32_t *tmp, long M)
{
    long c = 0;
    for (long i = 0; i < M; ++i) c += (y[i] == 0);
    long zr = 0, orr = 0;
    for (long i = 0; i < M; ++i)
        tmp[i] = y[i] == 0 ? a[zr++] : a[c + orr++];
    memcpy(a, tmp, M * sizeof(int32_t));
}

typedef struct { int32_t *a, *d, *b; } SweepCur;

static void sweep_cur_init(SweepCur *c, long M, const int32_t *a0)
{
    c->a = (int32_t *)malloc(M * sizeof(int32_t));
    c->d = (int32_t *)calloc(M + 1, sizeof(int32_t));
    c->b = (int32_t *)malloc(M * sizeof(int32_t));
    if (a0) memcpy(c->a, a0, M * sizeof(int32_t));
    else for (long i = 0; i < M; ++i) c->a[i] = (int32_t)i;
    c->d[0] = 1; c->d[M] = 1;
    for (long i = 0; i < M; ++i) c->b[c->a[i]] = (int32_t)i;
}

static void sweep_cur_free(SweepCur *c)
{
    free(c->a); free(c->d); free(c->b);
}

/* neighbour tables for phase_resolve: sort-order neighbours of each hap
   and (for weighted cursors) the score1 log-length weights */
static void sweep_tables(const int32_t *a, const int32_t *b,
                         const int32_t *d, long M,
                         const double *score_bit, long nsb, long kc,
                         int32_t *al, int32_t *ar, double *wl, double *wr)
{
    for (long i = 0; i < M; ++i) {
        long pos = b[i];
        al[i] = pos > 0 ? a[pos - 1] : -1;
        ar[i] = pos < M - 1 ? a[pos + 1] : -1;
        if (wl) {
            long li = kc + 1 - d[pos];
            long ri = kc + 1 - d[pos + 1];
            if (li < 0) li += nsb;      /* numpy negative-index wrap; the */
            if (ri < 0) ri += nsb;      /* entry is unused when al/ar < 0 */
            wl[i] = score_bit[li];
            wr[i] = score_bit[ri];
        }
    }
}

/* One whole phaseSweep pass (pbwtImpute.c:288-372) as a streaming C
   loop, matching algos/phase.py:phase_sweep exactly: read panel columns
   (forwards, or backwards via column offsets), build neighbour tables
   for the main + nSparse interleaved cursors (+ the reverse-pass pbwt on
   the forward sweep), resolve hets with phase_resolve, write the phased
   pbwt through an AD write cursor.  Returns packed length or -1. */
EXPORT long phase_sweep_core(
    const uint8_t *yzp, long nzp, long M, long N,
    const int32_t *ap0, long is_start,
    const uint8_t *yzr, long nzr, const int32_t *ar0,
    const int32_t *rbinv0, long has_r,
    const int32_t *aq0, long n_sparse, const double *score_bit,
    double thresh, uint8_t *yz_out, long cap,
    int32_t *aq_end, int32_t *bq_end)
{
    if (!p3dec_ready) p3dec_init();
    long rc = -1, nout = 0;
    long ncur = 1 + n_sparse + (has_r ? 1 : 0);
    long n1cur = 1 + n_sparse;
    long nsb = N + 2;

    int64_t *offp = NULL, *offr = NULL;
    uint8_t *yp = (uint8_t *)malloc(M);
    uint8_t *x = (uint8_t *)malloc(M);
    uint8_t *yq = (uint8_t *)malloc(M);
    uint8_t *runbuf = (uint8_t *)malloc(M + 8);
    int32_t *ap = (int32_t *)malloc(M * sizeof(int32_t));
    int32_t *tmp = (int32_t *)malloc(M * sizeof(int32_t));
    int32_t *ones = (int32_t *)malloc(M * sizeof(int32_t));
    int32_t *dones = (int32_t *)malloc(M * sizeof(int32_t));
    double *xp = (double *)malloc(M * sizeof(double));
    int32_t *aL = (int32_t *)malloc(ncur * M * sizeof(int32_t));
    int32_t *aR = (int32_t *)malloc(ncur * M * sizeof(int32_t));
    double *wL = (double *)malloc(n1cur * M * sizeof(double));
    double *wR = (double *)malloc(n1cur * M * sizeof(double));
    int32_t *ar = NULL, *rbinv = NULL;
    uint8_t *yr = NULL;
    SweepCur uq;
    SweepCur *uqq = (SweepCur *)malloc(n_sparse * sizeof(SweepCur));
    sweep_cur_init(&uq, M, aq0);
    for (long j = 0; j < n_sparse; ++j) sweep_cur_init(&uqq[j], M, NULL);
    memcpy(ap, ap0, M * sizeof(int32_t));
    long pos_p = 0;

    if (!is_start) {
        offp = (int64_t *)malloc((N + 1) * sizeof(int64_t));
        if (p3_col_offsets(yzp, nzp, N, M, offp) < 0) goto done;
    }
    if (has_r) {
        offr = (int64_t *)malloc((N + 1) * sizeof(int64_t));
        if (p3_col_offsets(yzr, nzr, N, M, offr) < 0) goto done;
        ar = (int32_t *)malloc(M * sizeof(int32_t));
        rbinv = (int32_t *)malloc(M * sizeof(int32_t));
        yr = (uint8_t *)malloc(M);
        memcpy(ar, ar0, M * sizeof(int32_t));
        memcpy(rbinv, rbinv0, M * sizeof(int32_t));
    }

    for (long k = 0; k < N; ++k) {
        /* panel column -> natural order x */
        if (is_start) {
            pos_p = p3_col_at(yzp, nzp, pos_p, M, yp);
            if (pos_p < 0) goto done;
            for (long i = 0; i < M; ++i) x[ap[i]] = yp[i];
            fwd_a(ap, yp, ones, M);
        } else {
            if (p3_col_at(yzp, nzp, offp[N - 1 - k], M, yp) < 0) goto done;
            bwd_a(ap, yp, tmp, M);
            for (long i = 0; i < M; ++i) x[ap[i]] = yp[i];
        }
        long n2 = 0;
        for (long i = 0; i < M; i += 2) {
            if (x[i] != x[i + 1]) {
                xp[i] = 0.0; xp[i + 1] = 0.0; ++n2;
            } else {
                xp[i] = x[i] ? 1.0 : -1.0;
                xp[i + 1] = x[i + 1] ? 1.0 : -1.0;
            }
        }
        if (n2) {
            sweep_tables(uq.a, uq.b, uq.d, M, score_bit, nsb, k,
                         aL, aR, wL, wR);
            for (long j = 0; j < n_sparse; ++j)
                sweep_tables(uqq[j].a, uqq[j].b, uqq[j].d, M, score_bit,
                             nsb, k / n_sparse, aL + (1 + j) * M,
                             aR + (1 + j) * M, wL + (1 + j) * M,
                             wR + (1 + j) * M);
            if (has_r)
                sweep_tables(ar, rbinv, NULL, M, NULL, 0, 0,
                             aL + (1 + n_sparse) * M,
                             aR + (1 + n_sparse) * M, NULL, NULL);
            phase_resolve(xp, M, ncur, n1cur, aL, aR, wL, wR, thresh);
        }
        for (long i = 0; i < M; ++i) x[i] = xp[i] > 0.0;
        /* uq.write_ad(x, k) */
        for (long i = 0; i < M; ++i) yq[i] = x[uq.a[i]];
        long nb = p3_encode(yq, M, runbuf);
        if (nout + nb > cap) goto done;
        memcpy(yz_out + nout, runbuf, nb);
        nout += nb;
        fwd_ad(uq.a, uq.d, yq, ones, dones, M, (int32_t)k);
        for (long i = 0; i < M; ++i) uq.b[uq.a[i]] = (int32_t)i;
        /* sparse cursor k % n_sparse advances with k2 = k / n_sparse */
        {
            SweepCur *c = &uqq[k % n_sparse];
            for (long i = 0; i < M; ++i) yq[i] = x[c->a[i]];
            fwd_ad(c->a, c->d, yq, ones, dones, M, (int32_t)(k / n_sparse));
            for (long i = 0; i < M; ++i) c->b[c->a[i]] = (int32_t)i;
        }
        if (has_r) {
            if (p3_col_at(yzr, nzr, offr[N - 1 - k], M, yr) < 0) goto done;
            bwd_a(ar, yr, tmp, M);
            for (long i = 0; i < M; ++i) rbinv[ar[i]] = (int32_t)i;
        }
    }
    memcpy(aq_end, uq.a, M * sizeof(int32_t));
    memcpy(bq_end, uq.b, M * sizeof(int32_t));
    rc = nout;
done:
    free(offp); free(offr); free(yp); free(x); free(yq); free(runbuf);
    free(ap); free(tmp); free(ones); free(dones); free(xp);
    free(aL); free(aR); free(wL); free(wR);
    free(ar); free(rbinv); free(yr);
    sweep_cur_free(&uq);
    for (long j = 0; j < n_sparse; ++j) sweep_cur_free(&uqq[j]);
    free(uqq);
    return rc;
}

/* ------------------------------------------------------------------ */
/* corruption / simulation (pbwtImpute.c:1492-1619)                     */
/* ------------------------------------------------------------------ */

/* glibc rand() TYPE_3 stream (unseeded == srand(1)); one process-global
   state shared by the corruption cores and python's crand module so the
   draw sequence matches the reference binary exactly across a pipeline */
static uint32_t cr_t[31];
static int cr_f = 3, cr_r = 0, cr_ready = 0;

EXPORT void crand_srand(uint32_t seed)
{
    if (seed == 0) seed = 1;
    cr_t[0] = seed;
    int32_t word = (int32_t)seed;
    for (int i = 1; i < 31; ++i) {
        int32_t hi = word / 127773, lo = word % 127773;
        word = 16807 * lo - 2836 * hi;
        if (word < 0) word += 2147483647;
        cr_t[i] = (uint32_t)word;
    }
    cr_f = 3; cr_r = 0; cr_ready = 1;
    for (int i = 0; i < 310; ++i) {
        uint32_t v = cr_t[cr_f] += cr_t[cr_r];
        (void)v;
        if (++cr_f == 31) cr_f = 0;
        if (++cr_r == 31) cr_r = 0;
    }
}

EXPORT long crand_next(void)
{
    if (!cr_ready) crand_srand(1);
    uint32_t v = cr_t[cr_f] += cr_t[cr_r];
    if (++cr_f == 31) cr_f = 0;
    if (++cr_r == 31) cr_r = 0;
    return (long)(v >> 1);
}

/* pbwtCorruptSites (pbwtImpute.c:1492-1537): corruption applied at
   positions in the NEW cursor's sort order. Returns n_change or -1. */
EXPORT long corrupt_sites_core(const uint8_t *yzold, long nzold,
                               long M, long N, const int32_t *aold0,
                               long r_site, long r_change, double r_fac,
                               uint8_t *yz, long cap,
                               int32_t *anew_end, int64_t *lens)
{
    if (!p3dec_ready) p3dec_init();
    uint8_t *ys = (uint8_t *)malloc(M), *x = (uint8_t *)malloc(M);
    uint8_t *y = (uint8_t *)malloc(M), *runbuf = (uint8_t *)malloc(M + 8);
    int32_t *ao = (int32_t *)malloc(M * sizeof(int32_t));
    int32_t *an = (int32_t *)malloc(M * sizeof(int32_t));
    int32_t *ones = (int32_t *)malloc(M * sizeof(int32_t));
    memcpy(ao, aold0, M * sizeof(int32_t));
    for (long i = 0; i < M; ++i) an[i] = (int32_t)i;
    long pos = 0, nout = 0, n_change = 0, rc = -1;
    for (long k = 0; k < N; ++k) {
        pos = p3_col_at(yzold, nzold, pos, M, ys);
        if (pos < 0) goto done;
        long c = 0;
        for (long i = 0; i < M; ++i) c += (ys[i] == 0);
        for (long i = 0; i < M; ++i) x[ao[i]] = ys[i];
        for (long i = 0; i < M; ++i) y[i] = x[an[i]];
        if (crand_next() < r_site) {
            double thresh = c * r_fac;
            for (long i = 0; i < M; ++i)
                if (crand_next() < r_change) {
                    uint8_t old = y[i];
                    y[i] = crand_next() < thresh ? 0 : 1;
                    if (y[i] != old) ++n_change;
                }
        }
        long nb = p3_encode(y, M, runbuf);
        if (nout + nb > cap) goto done;
        memcpy(yz + nout, runbuf, nb);
        nout += nb;
        fwd_a(an, y, ones, M);
        fwd_a(ao, ys, ones, M);
    }
    memcpy(anew_end, an, M * sizeof(int32_t));
    lens[0] = nout;
    rc = n_change;
done:
    free(ys); free(x); free(y); free(runbuf);
    free(ao); free(an); free(ones);
    return rc;
}

/* pbwtCorruptSamples (pbwtImpute.c:1539-1584): isCorrupt[] indexed by
   sort-order position, as the reference does. */
EXPORT long corrupt_samples_core(const uint8_t *yzold, long nzold,
                                 long M, long N, const int32_t *aold0,
                                 long r_sample, long r_change, double r_fac,
                                 uint8_t *yz, long cap,
                                 int32_t *anew_end, int64_t *lens)
{
    if (!p3dec_ready) p3dec_init();
    uint8_t *ys = (uint8_t *)malloc(M), *x = (uint8_t *)malloc(M);
    uint8_t *y = (uint8_t *)malloc(M), *runbuf = (uint8_t *)malloc(M + 8);
    uint8_t *isc = (uint8_t *)malloc(M);
    int32_t *ao = (int32_t *)malloc(M * sizeof(int32_t));
    int32_t *an = (int32_t *)malloc(M * sizeof(int32_t));
    int32_t *ones = (int32_t *)malloc(M * sizeof(int32_t));
    memcpy(ao, aold0, M * sizeof(int32_t));
    for (long i = 0; i < M; ++i) an[i] = (int32_t)i;
    for (long i = 0; i < M; ++i) isc[i] = crand_next() < r_sample;
    long pos = 0, nout = 0, n_change = 0, rc = -1;
    for (long k = 0; k < N; ++k) {
        pos = p3_col_at(yzold, nzold, pos, M, ys);
        if (pos < 0) goto done;
        long c = 0;
        for (long i = 0; i < M; ++i) c += (ys[i] == 0);
        for (long i = 0; i < M; ++i) x[ao[i]] = ys[i];
        for (long i = 0; i < M; ++i) y[i] = x[an[i]];
        double thresh = c * r_fac;
        for (long i = 0; i < M; ++i)
            if (isc[i] && crand_next() < r_change) {
                uint8_t v = crand_next() < thresh ? 0 : 1;
                if (v != y[i]) ++n_change;
                y[i] = v;
            }
        long nb = p3_encode(y, M, runbuf);
        if (nout + nb > cap) goto done;
        memcpy(yz + nout, runbuf, nb);
        nout += nb;
        fwd_a(an, y, ones, M);
        fwd_a(ao, ys, ones, M);
    }
    memcpy(anew_end, an, M * sizeof(int32_t));
    lens[0] = nout;
    rc = n_change;
done:
    free(ys); free(x); free(y); free(runbuf); free(isc);
    free(ao); free(an); free(ones);
    return rc;
}

/* pbwtCopySamples (pbwtImpute.c:1586-1619): Li-Stephens mosaic
   simulator; copy[] switched by sort-order position but read through
   copy[aNew[j]], reproducing the reference's own inconsistency. */
EXPORT long copy_samples_core(const uint8_t *yzold, long nzold,
                              long Mold, long N, const int32_t *aold0,
                              long Mnew, long r_switch,
                              uint8_t *yz, long cap,
                              int32_t *anew_end, int64_t *lens)
{
    if (!p3dec_ready) p3dec_init();
    uint8_t *ys = (uint8_t *)malloc(Mold), *x = (uint8_t *)malloc(Mold);
    uint8_t *y = (uint8_t *)malloc(Mnew);
    uint8_t *runbuf = (uint8_t *)malloc(Mnew + 8);
    int32_t *ao = (int32_t *)malloc(Mold * sizeof(int32_t));
    int32_t *an = (int32_t *)malloc(Mnew * sizeof(int32_t));
    int32_t *ones = (int32_t *)malloc((Mold > Mnew ? Mold : Mnew)
                                      * sizeof(int32_t));
    int64_t *copy = (int64_t *)malloc(Mnew * sizeof(int64_t));
    memcpy(ao, aold0, Mold * sizeof(int32_t));
    for (long i = 0; i < Mnew; ++i) an[i] = (int32_t)i;
    for (long i = 0; i < Mnew; ++i) copy[i] = crand_next() % Mold;
    long pos = 0, nout = 0, rc = -1;
    for (long k = 0; k < N; ++k) {
        pos = p3_col_at(yzold, nzold, pos, Mold, ys);
        if (pos < 0) goto done;
        for (long i = 0; i < Mold; ++i) x[ao[i]] = ys[i];
        for (long j = 0; j < Mnew; ++j)
            if (crand_next() < r_switch) copy[j] = crand_next() % Mold;
        for (long j = 0; j < Mnew; ++j) y[j] = x[copy[an[j]]];
        long nb = p3_encode(y, Mnew, runbuf);
        if (nout + nb > cap) goto done;
        memcpy(yz + nout, runbuf, nb);
        nout += nb;
        fwd_a(an, y, ones, Mnew);
        fwd_a(ao, ys, ones, Mold);
    }
    memcpy(anew_end, an, Mnew * sizeof(int32_t));
    lens[0] = nout;
    rc = 0;
done:
    free(ys); free(x); free(y); free(runbuf);
    free(ao); free(an); free(ones); free(copy);
    return rc;
}

/* one ' %.4f' value: fixed-point fast path (~7x sprintf) with a sprintf
   fallback for negatives, huge values and near-tie fractions — within
   the fast range, |v*1e4 - nearest| < 0.4999 pins the correctly-rounded
   decimal to the same side sprintf's exact conversion lands on. */
static long fmt_f4_one(double v, char *out)
{
    if (!(v >= 0.0) || v >= 4.5e14) return sprintf(out, " %.4f", v);
    double x = v * 10000.0;
    uint64_t n = (uint64_t)(x + 0.5);
    double d = x - (double)n;
    if (d < 0) d = -d;
    if (d > 0.49990) return sprintf(out, " %.4f", v);
    uint64_t ip = n / 10000, fp = n % 10000;
    char *p = out;
    *p++ = ' ';
    p = (char *)put_dec((uint8_t *)p, (long)ip);
    *p++ = '.';
    p[0] = (char)('0' + fp / 1000);
    p[1] = (char)('0' + (fp / 100) % 10);
    p[2] = (char)('0' + (fp / 10) % 10);
    p[3] = (char)('0' + fp % 10);
    return p + 4 - out;
}

/* format a row of doubles as " %.4f"... (the paint table emitters,
   pbwtPaint.c:164-204 fprintf loop); returns bytes written */
EXPORT long format_f4_row(const double *v, long n, char *out)
{
    long p = 0;
    for (long i = 0; i < n; ++i)
        p += fmt_f4_one(v[i], out + p);
    return p;
}

/* whole (R, C) table at once with per-row byte offsets — one ctypes
   call instead of R (the per-row python/ctypes overhead dominated the
   dense -paint emitters). */
EXPORT long format_f4_rows(const double *v, long R, long C,
                           char *out, int64_t *offs)
{
    long p = 0;
    for (long r = 0; r < R; ++r) {
        offs[r] = p;
        const double *row = v + r * C;
        for (long i = 0; i < C; ++i)
            p += fmt_f4_one(row[i], out + p);
    }
    offs[R] = p;
    return p;
}

/* ------------------------------------------------------------------ */
/* multi-PBWT merge core (pbwtMerge.c:129-208)                          */
/* ------------------------------------------------------------------ */

static int cmp_u64(const void *a, const void *b)
{
    uint64_t x = *(const uint64_t *)a, y = *(const uint64_t *)b;
    return x < y ? -1 : x > y;
}

static void bucket_sort_runs(int32_t *jr, int32_t *s, int32_t *e,
                             const int64_t *seg_off, long T,
                             uint64_t *tmp, int32_t *scr);
static long gather_encode_fwd(int32_t *a, long M, const uint8_t *xnat,
                              int32_t *ones, uint8_t *runbuf);

/* pbwtBuildReverse (pbwtCore.c:151-191) as one C pass: column byte
   offsets from a forward run-length skim, then the backward stream —
   per site, decode the column, invert the prefix-array step
   (pbwtCursorBackwardsA, pbwtCore.c:472-483), scatter to natural, and
   emit the reverse column through the fused gather/encode/partition
   step.  aFend seeds both the backward chase and the reverse write
   cursor (aRstart = aFend).  Returns zz bytes (cap-bounded; returns
   needed size), leaves aRend in arend (in: seeded with aFend). */
EXPORT long build_reverse_core(const uint8_t *yz, long nz, long M, long N,
                               const int32_t *aFend, uint8_t *zz_out,
                               long cap, int32_t *arend)
{
    if (!p3dec_ready) p3dec_init();
    int64_t *off = (int64_t *)malloc((N + 1) * sizeof(int64_t));
    int32_t *af = (int32_t *)malloc(M * sizeof(int32_t));
    int32_t *tmp = (int32_t *)malloc(M * sizeof(int32_t));
    int32_t *ones = (int32_t *)malloc(M * sizeof(int32_t));
    uint8_t *y = (uint8_t *)malloc(M);
    uint8_t *x = (uint8_t *)malloc(M);
    uint8_t *runbuf = (uint8_t *)malloc(M + 8);
    long rc = -1, pos = 0, nout = 0;
    if (!off || !af || !tmp || !ones || !y || !x || !runbuf) goto done;
    for (long k = 0; k < N; ++k) {
        off[k] = pos;
        long m = 0;
        while (m < M) {
            if (pos >= nz) goto done;
            m += p3dec[yz[pos++] & 0x7f];
        }
        if (m != M) goto done;
    }
    memcpy(af, aFend, M * sizeof(int32_t));
    for (long k = N - 1; k >= 0; --k) {
        if (p3_col_at(yz, nz, off[k], M, y) < 0) goto done;
        long c = 0;
        for (long i = 0; i < M; ++i) c += (y[i] == 0);
        long u = 0, v = 0;
        for (long i = 0; i < M; ++i)
            tmp[i] = y[i] == 0 ? af[u++] : af[c + v++];
        for (long i = 0; i < M; ++i) x[tmp[i]] = y[i];
        memcpy(af, tmp, M * sizeof(int32_t));
        long nb = gather_encode_fwd(arend, M, x, ones, runbuf);
        if (nout + nb <= cap) memcpy(zz_out + nout, runbuf, nb);
        nout += nb;
    }
    rc = nout;
done:
    free(off); free(af); free(tmp); free(ones);
    free(y); free(x); free(runbuf);
    return rc;
}

/* Bucket-scatter match rows (n, 4) int64 [j, jr, s, e] by target j and
   sort each target's run by start — the order referenceImpute3's
   per-target segment scan consumes (the reference qsorts each target's
   list, pbwtImpute.c:1150-1159).  Emits the three i32 columns + the
   per-target offsets directly (replaces a full numpy lexsort + take +
   three strided column conversions, ~0.7 s at 1.8 M rows).  Stable on
   equal starts (original = report order).  Returns 0 / -1 on malloc. */
EXPORT long segs_sort(const int64_t *rows, long n, long T,
                      int32_t *jr, int32_t *s, int32_t *e,
                      int64_t *seg_off)
{
    long *pos = (long *)calloc(T + 1, sizeof(long));
    uint64_t *tmp = (uint64_t *)malloc((n ? n : 1) * sizeof(uint64_t));
    int32_t *scr = (int32_t *)malloc((n ? n : 1) * sizeof(int32_t));
    if (!pos || !tmp || !scr) { free(pos); free(tmp); free(scr); return -1; }
    for (long i = 0; i < n; ++i) pos[rows[4 * i] + 1]++;
    for (long t = 0; t < T; ++t) pos[t + 1] += pos[t];
    memcpy(seg_off, pos, (T + 1) * sizeof(int64_t));
    for (long i = 0; i < n; ++i) {
        long p = pos[rows[4 * i]]++;
        jr[p] = (int32_t)rows[4 * i + 1];
        s[p] = (int32_t)rows[4 * i + 2];
        e[p] = (int32_t)rows[4 * i + 3];
    }
    bucket_sort_runs(jr, s, e, seg_off, T, tmp, scr);
    free(pos); free(tmp); free(scr);
    return 0;
}

/* per-bucket stable sort of contiguous (jr, s, e) runs by s, already
   grouped by target (buckets_sort_start / segs_sort share this). */
static void bucket_sort_runs(int32_t *jr, int32_t *s, int32_t *e,
                             const int64_t *seg_off, long T,
                             uint64_t *tmp, int32_t *scr)
{
    for (long t = 0; t < T; ++t) {
        long b0 = seg_off[t], m = seg_off[t + 1] - b0;
        if (m <= 1) continue;
        int sorted = 1;
        for (long i = 1; i < m; ++i)
            if (s[b0 + i] < s[b0 + i - 1]) { sorted = 0; break; }
        if (sorted) continue;
        for (long i = 0; i < m; ++i)
            tmp[i] = ((uint64_t)(uint32_t)s[b0 + i] << 32) | (uint32_t)i;
        qsort(tmp, m, sizeof(uint64_t), cmp_u64);
        for (long i = 0; i < m; ++i) scr[i] = jr[b0 + (uint32_t)tmp[i]];
        memcpy(jr + b0, scr, m * sizeof(int32_t));
        for (long i = 0; i < m; ++i) scr[i] = e[b0 + (uint32_t)tmp[i]];
        memcpy(e + b0, scr, m * sizeof(int32_t));
        for (long i = 0; i < m; ++i) s[b0 + i] = (int32_t)(tmp[i] >> 32);
    }
}

/* sort already-bucketed (jr, s, e) runs by start in place. */
EXPORT long buckets_sort_start(int32_t *jr, int32_t *s, int32_t *e,
                               const int64_t *seg_off, long T)
{
    long n = seg_off[T];
    uint64_t *tmp = (uint64_t *)malloc((n ? n : 1) * sizeof(uint64_t));
    int32_t *scr = (int32_t *)malloc((n ? n : 1) * sizeof(int32_t));
    if (!tmp || !scr) { free(tmp); free(scr); return -1; }
    bucket_sort_runs(jr, s, e, seg_off, T, tmp, scr);
    free(tmp); free(scr);
    return 0;
}

/* fused cursor step for merge readers: decode one pack3 column run by
   run, scatter its values into the natural segment (xnat, or NULL to
   discard) and stable-partition the prefix array in the same pass — no
   intermediate y buffer, value known per run so the inner loops are
   branch-free.  Returns 0, -1 on a corrupt stream. */
static long p3_scatter_fwd(const uint8_t *yz, long nz, long *pos_io,
                           int32_t *a, int32_t *ones, long M,
                           uint8_t *xnat)   /* returns zeros count, or -1 */
{
    if (!p3dec_ready) p3dec_init();
    long pos = *pos_io, m = 0, u = 0, v = 0;
    while (m < M) {
        if (pos >= nz) return -1;
        uint8_t b = yz[pos++];
        long n = p3dec[b & 0x7f];
        if (m + n > M) return -1;
        long e = m + n;
        if (b >> 7) {
            if (xnat) for (; m < e; ++m) { int32_t ai = a[m]; xnat[ai] = 1; ones[v++] = ai; }
            else      for (; m < e; ++m) ones[v++] = a[m];
        } else {
            if (xnat) for (; m < e; ++m) { int32_t ai = a[m]; xnat[ai] = 0; a[u++] = ai; }
            else      for (; m < e; ++m) a[u++] = a[m];
        }
    }
    memcpy(a + u, ones, v * sizeof(int32_t));
    *pos_io = pos;
    return u;
}

/* fused output step: gather the merged column through a_out, run-length
   encode it (exactly p3_encode's greedy emission) and stable-partition
   a_out, all in one pass.  Returns bytes written to runbuf. */
static long gather_encode_fwd(int32_t *a, long M, const uint8_t *xnat,
                              int32_t *ones, uint8_t *runbuf)
{
    long u = 0, v = 0, nb = 0, run = 0;
    uint8_t cur = 0;
    for (long j = 0; j < M; ++j) {
        int32_t aj = a[j];
        uint8_t yv = xnat[aj];
        if (run && yv == cur) ++run;
        else {
            if (run) nb += emit_run(cur, run, runbuf + nb);
            cur = yv;
            run = 1;
        }
        if (yv == 0) a[u++] = aj; else ones[v++] = aj;
    }
    if (run) nb += emit_run(cur, run, runbuf + nb);
    memcpy(a + u, ones, v * sizeof(int32_t));
    return nb;
}

/* One streaming pass over nf pack3 inputs.  The site-level key walk
   (duplicate collapse, intersection — pbwt_reader_next,
   pbwtMerge.c:78-127) runs in Python over the sites lists; this core
   receives, per file, the action stream over its CONSUMED columns in
   order: 1 = the column belongs to an emitted shared site, 0 = discard
   (cursor advance only).  Every file has exactly n_emit action-1
   entries, in the same order as the output sites.  a_all holds each
   file's starting prefix array (aFstart or identity), consumed/updated
   in place; a_out is the output prefix array (identity-seeded by the
   caller), left at aFend.  Emits pack3 bytes of the merged PBWT
   (cap-bounded; returns needed bytes, or -1 on malloc/stream failure).

   Unlike the reference's cursor pipeline (unpack + forwardsA + scatter,
   then gather + pack3 + forwardsA — pbwtMerge.c:176-201), each side here
   is ONE fused pass: decode/scatter/partition per reader and
   gather/encode/partition on the output. */
EXPORT long merge_core(long nf,
                       const uint8_t **yzs, const int64_t *nzs,
                       const int64_t *Ms, const int64_t *a_off,
                       const uint8_t *act_all, const int64_t *act_off,
                       int32_t *a_all, long n_emit,
                       int32_t *a_out, uint8_t *yz_out, long cap)
{
    long Mtot = 0;
    for (long f = 0; f < nf; ++f) Mtot += Ms[f];
    long *cpos = (long *)calloc(nf, sizeof(long));
    long *bpos = (long *)calloc(nf, sizeof(long));
    uint8_t *ynat = (uint8_t *)malloc(Mtot);
    int32_t *ones = (int32_t *)malloc(Mtot * sizeof(int32_t));
    uint8_t *runbuf = (uint8_t *)malloc(Mtot + 8);
    long nout = 0, rc = -1;
    if (!cpos || !bpos || !ynat || !ones || !runbuf) goto done;
    for (long e = 0; e < n_emit; ++e) {
        long off = 0;
        for (long f = 0; f < nf; ++f) {
            int32_t *af = a_all + a_off[f];
            const uint8_t *acts = act_all + act_off[f];
            while (!acts[cpos[f]]) {            /* discarded keys: advance */
                if (p3_scatter_fwd(yzs[f], nzs[f], &bpos[f], af, ones,
                                   Ms[f], NULL) < 0) goto done;
                cpos[f]++;
            }
            if (p3_scatter_fwd(yzs[f], nzs[f], &bpos[f], af, ones,
                               Ms[f], ynat + off) < 0) goto done;
            cpos[f]++;
            off += Ms[f];
        }
        long nb = gather_encode_fwd(a_out, Mtot, ynat, ones, runbuf);
        if (nout + nb <= cap) memcpy(yz_out + nout, runbuf, nb);
        nout += nb;
    }
    rc = nout;
done:
    free(cpos); free(bpos); free(ynat); free(ones); free(runbuf);
    return rc;
}

/* ------------------------------------------------------------------ */
/* genotypeCompare counting core (pbwtImpute.c:1375-1488)              */
/* ------------------------------------------------------------------ */

/* One streaming pass over both packed panels: per site, decode + natural
   scatter both columns (fused run-level cursor step), bin the site by
   frequency (refFreq override, else allele-1 fraction), and count the
   9-cell genotype-pair tables globally per bin (n_out) and per diploid
   sample (ns_out).  fsum/nsum/isum/ni mirror the reference's per-bin
   frequency / imputeInfo accumulators.  Returns 0, -1 on error. */
EXPORT long gtcompare_core(const uint8_t *yzp, long nzp,
                           const uint8_t *yzq, long nzq,
                           long M, long N,
                           const int32_t *ap0, const int32_t *aq0,
                           const double *rf, const double *ii,
                           const double *fbound, long nbound,
                           int64_t *n_out, int64_t *ns_out,
                           double *fsum, int64_t *nsum,
                           double *isum, int64_t *ni)
{
    int32_t *ap = (int32_t *)malloc(M * sizeof(int32_t));
    int32_t *aq = (int32_t *)malloc(M * sizeof(int32_t));
    int32_t *ones = (int32_t *)malloc(M * sizeof(int32_t));
    uint8_t *xp = (uint8_t *)malloc(M);
    uint8_t *xq = (uint8_t *)malloc(M);
    long posp = 0, posq = 0, rc = -1;
    if (!ap || !aq || !ones || !xp || !xq) goto done;
    memcpy(ap, ap0, M * sizeof(int32_t));
    memcpy(aq, aq0, M * sizeof(int32_t));
    for (long k = 0; k < N; ++k) {
        long zp = p3_scatter_fwd(yzp, nzp, &posp, ap, ones, M, xp);
        if (zp < 0) goto done;
        if (p3_scatter_fwd(yzq, nzq, &posq, aq, ones, M, xq) < 0)
            goto done;
        double f = rf[k] != 0.0 ? rf[k] : (double)(M - zp) / (double)M;
        long ff = 0;
        while (ff < nbound - 1 && f * 100.0 > fbound[ff]) ++ff;
        fsum[ff] += f * 100.0;
        nsum[ff]++;
        if (ii[k] < 1.0) { isum[ff] += ii[k]; ni[ff]++; }
        int64_t *nrow = n_out + ff * 9;
        for (long j = 0; j + 1 < M; j += 2) {
            long i9 = 3 * (xp[j] + xp[j + 1]) + xq[j] + xq[j + 1];
            nrow[i9]++;
            ns_out[(j >> 1) * 9 + i9]++;
        }
    }
    rc = 0;
done:
    free(ap); free(aq); free(ones); free(xp); free(xq);
    return rc;
}

/* phaseCompare (pbwtImpute.c:165-243) as one streaming pass over both
   packed panels: per-pair flip-state machine over het sites.
   out4 = {nSwitch, nHet, nSwitch1, nSwitch5}.  Returns 0 / -1. */
EXPORT long phase_compare_core(const uint8_t *yzp, long nzp,
                               const uint8_t *yzq, long nzq,
                               long M, long N,
                               const int32_t *ap0, const int32_t *aq0,
                               int64_t *out4, int64_t *n_switch_sample,
                               int64_t *n_switch_site)
{
    long P = M / 2, rc = -1, posp = 0, posq = 0;
    int32_t *ap = (int32_t *)malloc(M * sizeof(int32_t));
    int32_t *aq = (int32_t *)malloc(M * sizeof(int32_t));
    int32_t *ones = (int32_t *)malloc(M * sizeof(int32_t));
    uint8_t *xp = (uint8_t *)malloc(M);
    uint8_t *xq = (uint8_t *)malloc(M);
    uint8_t *isfirst = (uint8_t *)malloc(P);
    uint8_t *flip = (uint8_t *)calloc(P, 1);
    int64_t *lastflip = (int64_t *)calloc(P, sizeof(int64_t));
    int64_t *khet = (int64_t *)calloc(P, sizeof(int64_t));
    if (!ap || !aq || !ones || !xp || !xq || !isfirst || !flip
        || !lastflip || !khet) goto done;
    memcpy(ap, ap0, M * sizeof(int32_t));
    memcpy(aq, aq0, M * sizeof(int32_t));
    memset(isfirst, 1, P);
    long nswitch = 0, nhet = 0, nsw1 = 0, nsw5 = 0;
    for (long k = 0; k < N; ++k) {
        if (p3_scatter_fwd(yzp, nzp, &posp, ap, ones, M, xp) < 0)
            goto done;
        if (p3_scatter_fwd(yzq, nzq, &posq, aq, ones, M, xq) < 0)
            goto done;
        long nsw_k = 0;
        for (long j = 0; j < P; ++j) {
            int a0 = xp[2 * j], a1 = xp[2 * j + 1];
            if (a0 + a1 != 1) continue;
            ++nhet; ++khet[j];
            if (isfirst[j]) {
                isfirst[j] = 0;
                flip[j] = (uint8_t)(a0 == xq[2 * j + 1]);
                continue;
            }
            int sel = flip[j] ? xq[2 * j + 1] : xq[2 * j];
            if (a0 != sel) {
                ++nswitch; ++n_switch_sample[j]; ++nsw_k;
                long gap = khet[j] - lastflip[j];
                if (gap > 1) ++nsw1;
                if (gap > 5) ++nsw5;
                flip[j] ^= 1;
                lastflip[j] = khet[j];
            }
        }
        n_switch_site[k] = nsw_k;
    }
    out4[0] = nswitch; out4[1] = nhet; out4[2] = nsw1; out4[3] = nsw5;
    rc = 0;
done:
    free(ap); free(aq); free(ones); free(xp); free(xq);
    free(isfirst); free(flip); free(lastflip); free(khet);
    return rc;
}
