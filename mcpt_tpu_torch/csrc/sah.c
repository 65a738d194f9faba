/* Top-down binned-SAH chunk partition: host C, built by gcc at first use
 * (mcpt_tpu_torch/native.py) and bound by ctypes.
 *
 * A copy of the reference's mcpt_tpu/native/sah.c, its C mirror of
 * scene/geometry.py::_sah_chunks_py: the same float32 binning, the same
 * first-min tie-breaking, the same stable partition and the same stack
 * order, so the chunks are the Python version's element for element.  The
 * chunks come out by their offset in the partitioned order, left child
 * first: the reverse of the Python version's list, which pops the right
 * child first (ROADMAP section 3, R3).  It runs on the host at scene
 * commit, in a tenth of the Python version's time on large meshes; it is
 * not a device kernel.
 */
#include <math.h>
#include <stdlib.h>
#include <string.h>

#define NBINS_MAX 64

typedef struct {
    long start, len;
} Seg;

static void seg_bounds(const float *cent, const long *ix, long n, long start,
                       long len, float lo[3], float hi[3]) {
    for (int k = 0; k < 3; k++) {
        lo[k] = INFINITY;
        hi[k] = -INFINITY;
    }
    for (long i = start; i < start + len; i++) {
        const float *c = cent + 3 * ix[i];
        for (int k = 0; k < 3; k++) {
            if (c[k] < lo[k]) lo[k] = c[k];
            if (c[k] > hi[k]) hi[k] = c[k];
        }
    }
    (void)n;
}

static double sa(const float mn[3], const float mx[3]) {
    /* float32 arithmetic throughout, then promote — matches numpy's
     * float32 sa() being promoted to float64 by the int64 count */
    float d0 = mx[0] - mn[0], d1 = mx[1] - mn[1], d2 = mx[2] - mn[2];
    if (d0 < 0) d0 = 0;
    if (d1 < 0) d1 = 0;
    if (d2 < 0) d2 = 0;
    float r = 2.0f * (d0 * d1 + d1 * d2 + d0 * d2);
    return (double)r;
}

/* Returns chunk count (>=0) or -1 on allocation failure / bad args.
 * order[n]: prim indices chunk-major; chunk_off[count+1]: offsets. */
long sah_chunks(const float *cent, const float *tmin, const float *tmax,
                long n, long leaf, int nbins, long *order, long *chunk_off,
                long max_chunks) {
    if (nbins < 2 || nbins > NBINS_MAX || leaf < 1 || n < 0) return -1;
    long *ix = order; /* work in place: order starts as identity */
    for (long i = 0; i < n; i++) ix[i] = i;
    long *tmp = (long *)malloc((size_t)(n > 0 ? n : 1) * sizeof(long));
    Seg *stack = (Seg *)malloc((size_t)(2 * n + 8) * sizeof(Seg));
    if (!tmp || !stack) {
        free(tmp);
        free(stack);
        return -1;
    }
    long sp = 0, n_chunks = 0, out_ok = 1;
    stack[sp++] = (Seg){0, n};

    while (sp > 0) {
        Seg s = stack[--sp];
        if (s.len <= leaf) {
            /* emit: segment already sits contiguously in `order` */
            if (n_chunks >= max_chunks) {
                out_ok = 0;
                break;
            }
            chunk_off[n_chunks++] = s.start;
            continue;
        }
        float lo[3], hi[3];
        seg_bounds(cent, ix, n, s.start, s.len, lo, hi);
        int ax = 0;
        float ext = hi[0] - lo[0];
        for (int k = 1; k < 3; k++) /* first max wins (np.argmax) */
            if (hi[k] - lo[k] > ext) {
                ext = hi[k] - lo[k];
                ax = k;
            }
        long half = s.len / 2;
        if (ext < 1e-12f) { /* all centroids coincide: middle split */
            /* python pushes [first, second]; pop order: second first */
            stack[sp++] = (Seg){s.start, half};
            stack[sp++] = (Seg){s.start + half, s.len - half};
            continue;
        }

        long cnt[NBINS_MAX];
        float bmin[NBINS_MAX][3], bmax[NBINS_MAX][3];
        for (int b = 0; b < nbins; b++) {
            cnt[b] = 0;
            for (int k = 0; k < 3; k++) {
                bmin[b][k] = INFINITY;
                bmax[b][k] = -INFINITY;
            }
        }
        for (long i = s.start; i < s.start + s.len; i++) {
            long p = ix[i];
            /* float32 (c-lo)/ext*nbins in numpy's operation order */
            float f = (cent[3 * p + ax] - lo[ax]) / ext * (float)nbins;
            int b = (int)f; /* trunc toward zero, f >= 0 */
            if (b > nbins - 1) b = nbins - 1;
            cnt[b]++;
            for (int k = 0; k < 3; k++) {
                float a = tmin[3 * p + k], z = tmax[3 * p + k];
                if (a < bmin[b][k]) bmin[b][k] = a;
                if (z > bmax[b][k]) bmax[b][k] = z;
            }
        }

        /* prefix/suffix accumulated AABBs + counts */
        float pmin[NBINS_MAX][3], pmax[NBINS_MAX][3];
        float smin[NBINS_MAX][3], smax[NBINS_MAX][3];
        for (int k = 0; k < 3; k++) {
            pmin[0][k] = bmin[0][k];
            pmax[0][k] = bmax[0][k];
            smin[nbins - 1][k] = bmin[nbins - 1][k];
            smax[nbins - 1][k] = bmax[nbins - 1][k];
        }
        for (int b = 1; b < nbins; b++)
            for (int k = 0; k < 3; k++) {
                pmin[b][k] = bmin[b][k] < pmin[b - 1][k] ? bmin[b][k]
                                                         : pmin[b - 1][k];
                pmax[b][k] = bmax[b][k] > pmax[b - 1][k] ? bmax[b][k]
                                                         : pmax[b - 1][k];
            }
        for (int b = nbins - 2; b >= 0; b--)
            for (int k = 0; k < 3; k++) {
                smin[b][k] = bmin[b][k] < smin[b + 1][k] ? bmin[b][k]
                                                         : smin[b + 1][k];
                smax[b][k] = bmax[b][k] > smax[b + 1][k] ? bmax[b][k]
                                                         : smax[b + 1][k];
            }

        int best = -1;
        double best_cost = INFINITY;
        long cl = 0;
        for (int b = 0; b < nbins - 1; b++) {
            cl += cnt[b];
            long cr = s.len - cl;
            if (cl > 0 && cr > 0) {
                /* numpy: float32 SA promoted to float64 by int64 count */
                double cost = sa(pmin[b], pmax[b]) * (double)cl +
                              sa(smin[b + 1], smax[b + 1]) * (double)cr;
                if (cost < best_cost) { /* first min wins (np.argmin) */
                    best_cost = cost;
                    best = b;
                }
            }
        }
        if (best < 0) { /* every split degenerate: middle split */
            stack[sp++] = (Seg){s.start, half};
            stack[sp++] = (Seg){s.start + half, s.len - half};
            continue;
        }

        /* stable partition: left = bin <= best (order preserved) */
        long nl = 0, nr = 0;
        for (long i = s.start; i < s.start + s.len; i++) {
            long p = ix[i];
            float f = (cent[3 * p + ax] - lo[ax]) / ext * (float)nbins;
            int b = (int)f;
            if (b > nbins - 1) b = nbins - 1;
            if (b <= best)
                ix[s.start + nl++] = p;
            else
                tmp[nr++] = p;
        }
        memcpy(ix + s.start + nl, tmp, (size_t)nr * sizeof(long));
        /* python pushes [left, right]; pop order: right first */
        stack[sp++] = (Seg){s.start, nl};
        stack[sp++] = (Seg){s.start + nl, nr};
    }

    free(tmp);
    free(stack);
    if (!out_ok) return -1;
    chunk_off[n_chunks] = n;
    /* chunk_off currently holds start offsets in emit order; emit order
     * walks `order` left to right EXCEPT middle splits/partitions reuse
     * segments — starts are contiguous but not sorted.  Sort them so
     * chunk k = order[chunk_off[k] : chunk_off[k+1]]. */
    for (long i = 1; i < n_chunks; i++) { /* insertion sort (small) */
        long v = chunk_off[i];
        long j = i - 1;
        while (j >= 0 && chunk_off[j] > v) {
            chunk_off[j + 1] = chunk_off[j];
            j--;
        }
        chunk_off[j + 1] = v;
    }
    return n_chunks;
}
