// aggregate: the sums and the affine conversion between the scaling and
// the Miller loop.
//   lh_g1_segment_sum: per-message pubkey sums (replaces lighthouse_tpu/
//       ops/bls12_381.py:527 g1_segment_sum, a log-depth segmented
//       associative_scan gathered at ends). Output g is the sum of range g,
//       the lanes from the first lane of the segment that holds ends[g]
//       (the last lane at or before it with starts[] == 1, else lane 0) up
//       to ends[g]; ranges may overlap. Each range is cut into pieces of at
//       most T lanes from its first lane (T = 32 where the ranges average
//       at most 32 lanes, else 128: seg_piece_lanes), and each sum is a
//       pairwise tree (slot i takes slot i + ceil(w / 2) at each level), so
//       a range of L lanes is ceil(log2 L) additions deep up to T lanes.
//       One cooperative launch of G = min(ceil(n / T), the co-resident
//       blocks) blocks of 2 T threads, sized by nothing on the card (so
//       nothing is read back), its phases behind grid barriers:
//       1. each thread's chunk of lanes: its last segment start, a max
//          scan over the block's chunks, each block's maximum;
//       2. each block's prefix maxima over the blocks, so each range's
//          first lane (its chunk's flags back from ends[g], else the
//          chunks and blocks before); each thread's ranges' lengths,
//          scanned over the block;
//       3. the blocks' sums before each block: each range's first work
//          lane and the list of the ranges of more than one piece;
//       4. the tiles of the work lanes, grid-striding: tile k takes the
//          pieces whose first work lane is in [k T, (k + 1) T), at most T
//          pieces and 2 T lanes, each slot's row loaded by its own thread
//          in 16-byte words, and runs the trees of all of them level by
//          level; a level's additions (each piece its own count) are
//          packed over the block's groups of four threads, each addition
//          on a group (coop.cuh w_jac_add on GroupFp: its 16 products in 5
//          steps of up to four at once). A range of one piece writes its
//          output, a long range's pieces partials;
//       5. (only with long ranges) over the long ranges: slot t folds the
//          partials t, t + T, ... in series (past T^2 lanes), then a tree
//          over the slots.
//       Short ranges share a tile, so a batch of one-lane ranges costs a
//       load and a store a lane beside the phases' scans and barriers.
//       The order is fixed by (starts, ends, n)
//       alone (no atomics), so every call gives the same limbs; the JAX
//       scan adds in another order, so its outputs are other
//       representatives of the same points;
//   lh_g2_sum: the sum of n G2 points (:571 _g2_sum_rows, :589 g2_sum) as
//       a pairwise tree in two launches of one kernel: G = min(ceil(n /
//       128), 128) blocks of 128 threads, thread g = 128 b + t holding
//       point g (and folding g + 128 G, g + 256 G, ... in series past
//       128^2 points), a tree over the block's threads in shared memory
//       (each level slot i takes slot i + ceil(w / 2)), one partial a
//       block; then one block's tree over the G partials. A level of many
//       additions gives each a thread; the top levels, of at most 16,
//       give each a warp (coop.cuh w_jac_add, the same values). The order
//       is fixed by n alone (no atomics, nothing scheduling-dependent),
//       so every call on the same points gives the same limbs; it is not
//       the JAX order (rows, then the 128 column partials), so the
//       Jacobian representative differs from the JAX one by (l^2, l^3,
//       l): the same point, held projectively. jac_add takes infinity,
//       equal and opposite points, so any order gives the same point;
//   lh_affine: (X/Z^2, Y/Z^3) over G1 (field 1) or G2 (field 2), Z = 0
//       inverting to 0 (:557 jacobian_to_affine_fp2, :564 _fp), one thread
//       a point. The inverse is fp.cuh's binary extended Euclid (one
//       multiply and ~270 steps of word subtractions and shifts, where the
//       JAX package's Fermat power runs 608 multiplies in series: the same
//       values, variable-time on public inputs). A lane's chain of
//       dependent word operations bounds a launch; a warp runs its longest
//       lane, and small blocks (LH_AFFINE_THREADS, the best of 32 / 64 /
//       128 on the card) spread a call's few warps over more SMs.
// Bound: integer multiply-adds (the affine conversion: what the function
// needs at least, one inverse a call by batch inversion, 3 (n - 1)
// products for it and four a lane, bls_cost.affine_least; this kernel
// inverts a lane at a time, bls_cost.affine_int_ops). A range's segment
// sum is L - 1 additions; its latency is its tree's depth (~7 levels for
// the ~79 lanes of a message of the 10k batch, 14 for one 10,000-lane
// segment: 7 in its pieces, 7 over their partials; bls_cost.
// g1_segment_sum_depth). The G2 sum is n - 1 additions; its
// latency is the tree's depth, 14 levels at 10,240 points (7 in a block,
// 7 over the 80 partials): four of 48 dependent field multiplies on one
// thread, the rest 5 warp steps an addition in one to four rounds (277 in
// all, bls_cost.g2_sum_depth).
#include <cooperative_groups.h>

#include "coop.cuh"

// threads a block of the affine conversion
#define LH_AFFINE_THREADS 32

#ifndef LH_G2_SUM_T
#define LH_G2_SUM_T 128        // threads (tree slots) a block; most blocks
#endif
// a level of at most this many additions a warp gives each a warp
#define LH_G2_SUM_WARP_ROUNDS 4
// the slots, then each warp's 32 Fp of w_step scratch
#define LH_G2_SUM_SMEM (LH_G2_SUM_T * (int)sizeof(Jac<Fp2>) \
                        + LH_G2_SUM_T * (int)sizeof(Fp))

// slot[0] = the sum of slot[0..w), w <= blockDim.x, in a fixed order: each
// level slot i takes slot i + h, h = ceil(w / 2); every thread calls it.
// A level of many additions gives each a thread (jac_add: 48 dependent
// multiplies); one of few gives each a warp in turn (w_jac_add: its 16
// Fp2 products in 5 warp steps), the same values. sc: the warps' scratch
LH_DEV void g2_tree(Jac<Fp2>* slot, int w, Fp* sc) {
    const int t = threadIdx.x, warp = t >> 5, warps = blockDim.x >> 5;
    for (; w > 1; w = (w + 1) / 2) {
        const int h = (w + 1) / 2, m = w - h;
        if (m > LH_G2_SUM_WARP_ROUNDS * warps) {
            if (t < m) {
                Jac<Fp2> a = slot[t];
                const Jac<Fp2> b = slot[t + h];
                jac_add(a, a, b);
                slot[t] = a;
            }
        } else {
            for (int q = warp; q < m; q += warps) {
                Jac<Fp2> a = slot[q];
                const Jac<Fp2> b = slot[q + h];
                w_jac_add(sc + 32 * warp, a, a, b);
                if ((t & 31) == 0) slot[q] = a;
            }
        }
        __syncthreads();
    }
}

template <class F>
LH_DEV void affine_lane(const int32_t* x, const int32_t* y, const int32_t* z,
                        int32_t* ox, int32_t* oy, long long i) {
    Jac<F> p;
    F ax, ay;
    jac_load(p, x, y, z, i);
    jac_to_affine(ax, ay, p);
    f_store(ox + i * Limbs<F>::n, ax);
    f_store(oy + i * Limbs<F>::n, ay);
}

// block b writes the sum of points g, g + S, g + 2S, ... (S = gridDim.x *
// blockDim.x) over its threads g = b * blockDim.x + t to (ox, oy, oz)[b]
__global__ void __launch_bounds__(LH_G2_SUM_T)
g2_sum_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
              const int32_t* __restrict__ z, long long n,
              int32_t* __restrict__ ox, int32_t* __restrict__ oy,
              int32_t* __restrict__ oz) {
    extern __shared__ uint4 lh_smem[];
    Jac<Fp2>* slot = reinterpret_cast<Jac<Fp2>*>(lh_smem);
    Fp* sc = reinterpret_cast<Fp*>(slot + LH_G2_SUM_T);
    const long long first = (long long)blockIdx.x * blockDim.x;
    const long long g = first + threadIdx.x;
    const long long stride = (long long)gridDim.x * blockDim.x;
    if (g < n) {
        Jac<Fp2> acc, p;
        jac_load(acc, x, y, z, g);
        for (long long i = g + stride; i < n; i += stride) {
            jac_load(p, x, y, z, i);
            jac_add(acc, acc, p);
        }
        slot[threadIdx.x] = acc;
    }
    __syncthreads();
    const long long left = n - first;
    g2_tree(slot, left < blockDim.x ? (int)left : (int)blockDim.x, sc);
    if (threadIdx.x == 0) {
        const Jac<Fp2> s = slot[0];
        jac_store(ox, oy, oz, blockIdx.x, s);
    }
}

// blocks of the first launch of g2_sum_kernel (the partials' count)
static long long g2_sum_blocks(long long n) {
    const long long b = (n + LH_G2_SUM_T - 1) / LH_G2_SUM_T;
    return b < LH_G2_SUM_T ? b : LH_G2_SUM_T;
}

// ------------------------------------------------------- g1_segment_sum

// lanes a piece: LH_SEG_T_SHORT where the ranges average at most that
// many lanes (n <= LH_SEG_T_SHORT g: more, smaller tiles on more SMs),
// else LH_SEG_T_LONG (a range of ~80 lanes in one piece); a block has 2 T
// threads. ops/bls12_381.py g1_segment_t mirrors seg_piece_lanes.
#define LH_SEG_T_SHORT 32
#define LH_SEG_T_LONG 128
// the grid's blocks at most (the length of the per-block tables)
#define LH_SEG_MAX_GRID 512

static int seg_piece_lanes(long long n, long long g) {
    return n <= (long long)LH_SEG_T_SHORT * g ? LH_SEG_T_SHORT
                                              : LH_SEG_T_LONG;
}

// the grid: a block a tile of the lanes, at most the co-resident blocks
// and LH_SEG_MAX_GRID (0: no block fits, and the launch refuses it)
static long long seg_grid(long long n, int t, long long resident) {
    long long g = (n + t - 1) / t;
    if (g > resident) g = resident;
    if (g > LH_SEG_MAX_GRID) g = LH_SEG_MAX_GRID;
    return g;
}

// the C entry's workspace, carved from one int32 buffer of
// seg_work_words(n, g) words
struct SegWork {
    long long* bsum;    // [LH_SEG_MAX_GRID] a block's ranges' lanes
    long long* woff;    // [g] a range's first work lane
    int* bmax;          // [LH_SEG_MAX_GRID] a block's last segment start
    int* blong;         // [LH_SEG_MAX_GRID] a block's long ranges
    int* first;         // [g] a range's first lane
    int* longs;         // [g] the ranges of more than one piece, in order
    int* cmax;          // [n] the last start up to each thread's chunk of
                        // lanes, from its block's first chunk
    Jac<Fp>* full;      // [n] a long range's full piece, at its first lane
    Jac<Fp>* last;      // [g] a long range's last piece
};

static long long seg_work_words(long long n, long long g) {
    return 4LL * LH_SEG_MAX_GRID + 40 * g + 37 * n;
}

static SegWork seg_work(int32_t* w, long long n, long long g) {
    SegWork s;
    s.bsum = reinterpret_cast<long long*>(w);
    s.woff = s.bsum + LH_SEG_MAX_GRID;
    s.bmax = reinterpret_cast<int*>(s.woff + g);
    s.blong = s.bmax + LH_SEG_MAX_GRID;
    s.first = s.blong + LH_SEG_MAX_GRID;
    s.longs = s.first + g;
    s.cmax = s.longs + g;
    s.full = reinterpret_cast<Jac<Fp>*>(s.cmax + n);
    s.last = s.full + n;
    return s;
}

// a Jacobian G1 point's int32 limbs [n, 32] at row i, in 16-byte loads and
// stores (rows of 128 bytes; the wrapper checks the bases' alignment)
LH_DEV void fp_load_v(Fp& a, const int32_t* limbs) {
    int32_t l[LH_LIMBS];
    const uint4* q = reinterpret_cast<const uint4*>(limbs);
#pragma unroll
    for (int k = 0; k < LH_LIMBS / 4; ++k) {
        const uint4 v = q[k];
        l[4 * k] = (int32_t)v.x;
        l[4 * k + 1] = (int32_t)v.y;
        l[4 * k + 2] = (int32_t)v.z;
        l[4 * k + 3] = (int32_t)v.w;
    }
    fp_load(a, l);
}

LH_DEV void fp_store_v(int32_t* limbs, const Fp& a) {
    int32_t l[LH_LIMBS];
    fp_store(l, a);
    uint4* q = reinterpret_cast<uint4*>(limbs);
#pragma unroll
    for (int k = 0; k < LH_LIMBS / 4; ++k)
        q[k] = make_uint4((unsigned)l[4 * k], (unsigned)l[4 * k + 1],
                          (unsigned)l[4 * k + 2], (unsigned)l[4 * k + 3]);
}

LH_DEV void jac_load_v(Jac<Fp>& p, const int32_t* x, const int32_t* y,
                       const int32_t* z, long long i) {
    fp_load_v(p.x, x + i * LH_LIMBS);
    fp_load_v(p.y, y + i * LH_LIMBS);
    fp_load_v(p.z, z + i * LH_LIMBS);
}

LH_DEV void jac_store_v(int32_t* x, int32_t* y, int32_t* z, long long i,
                        const Jac<Fp>& p) {
    fp_store_v(x + i * LH_LIMBS, p.x);
    fp_store_v(y + i * LH_LIMBS, p.y);
    fp_store_v(z + i * LH_LIMBS, p.z);
}

// two counts scanned together
struct SegPair {
    long long s, c;
};
struct SegSum {
    LH_DEV SegPair operator()(SegPair a, SegPair b) const {
        return SegPair{a.s + b.s, a.c + b.c};
    }
};
struct SegMax {
    LH_DEV int operator()(int a, int b) const { return a > b ? a : b; }
};

// the inclusive scan of v over the block's threads in shared memory (sc:
// blockDim.x entries; afterwards sc[blockDim.x - 1] is the block's total
// until the next call). Every thread calls it.
template <class V, class Op>
LH_DEV V block_scan(V v, V* sc, Op op) {
    const int t = threadIdx.x;
    __syncthreads();                        // sc free
    sc[t] = v;
    __syncthreads();
    for (int d = 1; d < (int)blockDim.x; d <<= 1) {
        const V u = t >= d ? sc[t - d] : v;
        __syncthreads();
        if (t >= d) {
            v = op(v, u);
            sc[t] = v;
        }
        __syncthreads();
    }
    return v;
}

// the last i in [lo, hi) with v[i] <= x (v non-decreasing, v[lo] <= x),
// the block's threads testing evenly spaced entries each round; sh: two
// long long of shared memory. Every thread calls it.
LH_DEV long long block_last_le(const long long* v, long long lo,
                               long long hi, long long x, long long* sh) {
    const int t = threadIdx.x;
    while (hi - lo > 1) {
        const long long step = (hi - lo + blockDim.x - 1) / blockDim.x;
        const long long i = lo + t * step, nx = i + step;
        if (i < hi && v[i] <= x && !(nx < hi && v[nx] <= x)) {
            sh[0] = i;
            sh[1] = nx < hi ? nx : hi;
        }
        __syncthreads();
        lo = sh[0];
        hi = sh[1];
        __syncthreads();
    }
    return lo;
}

// the threads of thread t's group of LH_GROUP_FP in its warp
LH_DEV unsigned group_mask(int t) {
    return ((1u << LH_GROUP_FP) - 1u) << ((t & 31) & ~(LH_GROUP_FP - 1));
}

// the block's dynamic shared memory (the host stand-ins give each block
// of a cooperative launch its own, LH_BLOCK_SMEM)
LH_DEV uint4* block_smem() {
#ifdef LH_BLOCK_SMEM
    return LH_BLOCK_SMEM;
#else
    extern __shared__ uint4 lh_smem[];
    return lh_smem;
#endif
}

// a block's shared memory at T lanes a piece: the tiles' slots, the
// groups' scratch, the scalars, the pieces' arrays (at most T a tile);
// the ranges' phases use the slots' room for their scans and the blocks'
// prefix maxima
template <int T>
struct SegShape {
    static const int threads = 2 * T, slots = 2 * T;
    static const int groups = threads / LH_GROUP_FP;
    static const int tile_bytes = slots * (int)sizeof(Jac<Fp>)
                                  + threads * (int)sizeof(Fp) + 40 * 8
                                  + 7 * T * 4;
    static const int prep_bytes = threads * (int)sizeof(SegPair)
                                  + threads * 4 + LH_SEG_MAX_GRID * 4;
    static const int smem = tile_bytes > prep_bytes ? tile_bytes
                                                    : prep_bytes;
};

// the pieces of a block, in shared memory
struct SegPieces {
    int *base, *w, *h, *pre, *lane, *g;
    int* kind;          // 0: a range's one piece, 1: a long range's full
                        // piece, 2: its last
    long long* sh;      // the scalars the threads share [8], then the
                        // warp scan's 32 partial sums
};

template <int T>
LH_DEV SegPieces seg_pieces(Jac<Fp>*& slot, Fp*& sc) {
    slot = reinterpret_cast<Jac<Fp>*>(block_smem());
    sc = reinterpret_cast<Fp*>(slot + SegShape<T>::slots);
    long long* sh = reinterpret_cast<long long*>(sc + SegShape<T>::threads);
    int* a = reinterpret_cast<int*>(sh + 40);
    return SegPieces{a, a + T, a + 2 * T, a + 3 * T, a + 4 * T, a + 5 * T,
                     a + 6 * T, sh};
}

// The trees of pieces p < np at once (piece p: slots base[p] ..
// base[p] + w[p]): each level slot i of a piece takes slot i + ceil(w /
// 2); the level's additions, each piece's in turn, are packed over the
// block's groups of four threads. Leaves each sum in the piece's first
// slot. Every thread calls it.
LH_DEV void seg_trees(Jac<Fp>* slot, Fp* sc, const SegPieces& P, int np) {
    const int t = threadIdx.x, q = t / LH_GROUP_FP, r = t % LH_GROUP_FP;
    const int groups = blockDim.x / LH_GROUP_FP;
    const GroupFp st{sc + q * LH_GROUP_FP, group_mask(t), r};
    for (;;) {
        if (t < np) {
            P.h[t] = (P.w[t] + 1) / 2;
            P.pre[t] = P.w[t] - P.h[t];
        }
        __syncthreads();
        const int lanes = blockDim.x < 32 ? blockDim.x : 32;
        if (t < lanes) {        // exclusive scan of the counts, one warp
            const int chunk = (np + lanes - 1) / lanes, lo = t * chunk;
            const int hi = lo + chunk < np ? lo + chunk : np;
            long long* tmp = P.sh + 8;
            long long sum = 0;
            for (int i = lo; i < hi; ++i) sum += P.pre[i];
            tmp[t] = sum;
            __syncwarp();
            for (int d = 1; d < lanes; d <<= 1) {
                const long long u = t >= d ? tmp[t - d] : 0;
                __syncwarp();
                tmp[t] += u;
                __syncwarp();
            }
            long long run = tmp[t] - sum;
            for (int i = lo; i < hi; ++i) {
                const int m = P.pre[i];
                P.pre[i] = (int)run;
                run += m;
            }
            if (t == lanes - 1) P.sh[2] = tmp[t];
        }
        __syncthreads();
        const long long M = P.sh[2];
        if (M == 0) break;
        for (long long a = q; a < M; a += groups) {
            int lo = 0, hi = np;            // the last piece with pre <= a
            while (hi - lo > 1) {
                const int mid = (lo + hi) / 2;
                if (P.pre[mid] <= a) lo = mid; else hi = mid;
            }
            const int dst = P.base[lo] + (int)(a - P.pre[lo]);
            Jac<Fp> u = slot[dst];
            const Jac<Fp> v = slot[dst + P.h[lo]];
            w_jac_add(st, u, u, v);
            if (r == 0) slot[dst] = u;
        }
        __syncthreads();
        if (t < np) P.w[t] = P.h[t];
        __syncthreads();
    }
}

// One cooperative launch of G blocks of 2 T threads (see the file's
// head); every thread reaches every grid barrier.
template <int T>
__global__ void __launch_bounds__(2 * T)
seg_sum_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
               const int32_t* __restrict__ z,
               const int32_t* __restrict__ starts, long long n,
               const int32_t* __restrict__ ends, long long g_count,
               SegWork w, int32_t* __restrict__ ox,
               int32_t* __restrict__ oy, int32_t* __restrict__ oz) {
    Jac<Fp>* slot;
    Fp* sc;
    const SegPieces P = seg_pieces<T>(slot, sc);
    SegPair* scp = reinterpret_cast<SegPair*>(slot);     // the scans'
    int* sci = reinterpret_cast<int*>(scp + blockDim.x);  // room, then the
    int* pmax = sci + blockDim.x;                         // blocks' maxima
    const int t = threadIdx.x, B = blockDim.x, G = gridDim.x;
    const long long gt = (long long)blockIdx.x * B + t, all = (long long)G * B;
    auto grid = cooperative_groups::this_grid();

    // 1. each thread's chunk of C lanes: its last segment start, scanned
    // (max) over the block's chunks
    const long long C = (n + all - 1) / all, chunks = (n + C - 1) / C;
    int last = -1;
    for (long long i = gt * C; i < n && i < gt * C + C; ++i)
        if (__ldg(starts + i)) last = (int)i;
    last = block_scan(last, sci, SegMax());
    if (gt < chunks) w.cmax[gt] = last;
    if (t == B - 1) w.bmax[blockIdx.x] = last;
    grid.sync();

    // 2. the blocks' exclusive prefix maxima (each block its own copy);
    // then each thread's D ranges: first lane, length, local work offset
    {
        const int E = (G + B - 1) / B, lo = t * E;
        const int hi = lo + E < G ? lo + E : G;
        int m = -1;
        for (int i = lo; i < hi; ++i) m = w.bmax[i] > m ? w.bmax[i] : m;
        block_scan(m, sci, SegMax());
        int run = t > 0 ? sci[t - 1] : -1;
        for (int i = lo; i < hi; ++i) {
            pmax[i] = run;
            run = w.bmax[i] > run ? w.bmax[i] : run;
        }
        __syncthreads();
    }
    const long long D = (g_count + all - 1) / all;
    const long long r0 = gt * D, r1 = r0 + D < g_count ? r0 + D : g_count;
    SegPair mine{0, 0};
    for (long long g = r0; g < r1; ++g) {
        const long long e = __ldg(ends + g), c = e / C;
        long long f = -1;
        for (long long i = e; i >= c * C; --i)
            if (__ldg(starts + i)) {
                f = i;
                break;
            }
        if (f < 0) {
            const long long before = c % B ? w.cmax[c - 1] : -1;
            const long long blocks = pmax[c / B];
            f = before > blocks ? before : blocks;
            if (f < 0) f = 0;
        }
        const long long r = e - f + 1;
        w.first[g] = (int)f;
        w.woff[g] = mine.s;
        mine.s += r;
        mine.c += r > T;
    }
    const SegPair incl = block_scan(mine, scp, SegSum());
    const SegPair ahead{incl.s - mine.s, incl.c - mine.c};
    if (t == B - 1) {
        w.bsum[blockIdx.x] = incl.s;
        w.blong[blockIdx.x] = (int)incl.c;
    }
    grid.sync();

    // 3. the blocks before this one and all of them: the ranges' work
    // offsets and the long ranges' list
    SegPair before{0, 0}, total{0, 0};
    for (int i = t; i < G; i += B) {
        const SegPair v{w.bsum[i], w.blong[i]};
        total = SegSum()(total, v);
        if (i < (int)blockIdx.x) before = SegSum()(before, v);
    }
    block_scan(before, scp, SegSum());
    before = scp[B - 1];
    block_scan(total, scp, SegSum());
    total = scp[B - 1];
    long long nl = before.c + ahead.c;
    for (long long g = r0; g < r1; ++g) {
        w.woff[g] += before.s + ahead.s;
        if (__ldg(ends + g) - w.first[g] + 1 > T) w.longs[nl++] = (int)g;
    }
    grid.sync();

    // 4. the tiles: tile k takes the pieces whose first work lane is in
    // [k T, (k + 1) T)
    const long long tiles = (total.s + T - 1) / T;
    for (long long k = blockIdx.x; k < tiles; k += G) {
        // the ranges whose pieces start in the tile: the last starting at
        // or before k T, then at most T after it
        const long long ga = block_last_le(w.woff, 0, g_count, k * T, P.sh);
        const long long lim = ga + T + 1 < g_count ? ga + T + 1 : g_count;
        const long long gb = block_last_le(w.woff, ga, lim, k * T + T - 1,
                                           P.sh);
        // range ga's piece in the tile, if it has one
        const long long La = __ldg(ends + ga) - w.first[ga] + 1;
        const long long ja = (k * T - w.woff[ga] + T - 1) / T;
        const long long g0 = ja * T < La ? ga : ga + 1;
        const long long j0 = g0 == ga ? ja : 0;
        const int np = g0 <= gb ? (int)(gb - g0 + 1) : 0;
        if (t < np) {
            const long long g = g0 + t, j = t == 0 ? j0 : 0;
            const long long f = w.first[g], L = __ldg(ends + g) - f + 1;
            const long long pieces = (L + T - 1) / T;
            P.base[t] = (int)(w.woff[g] + j * T - (w.woff[g0] + j0 * T));
            P.w[t] = (int)(L - j * T < T ? L - j * T : T);
            P.lane[t] = (int)(f + j * T);
            P.g[t] = (int)g;
            P.kind[t] = pieces == 1 ? 0 : (j < pieces - 1 ? 1 : 2);
            if (t == np - 1) P.sh[3] = P.base[t] + P.w[t];
        }
        __syncthreads();
        if (np > 0) {
            // each slot's lane, its row loaded by its own thread
            const int S = (int)P.sh[3];
            for (int s = t; s < S; s += B) {
                int lo = 0, hi = np;        // the piece of slot s
                while (hi - lo > 1) {
                    const int mid = (lo + hi) / 2;
                    if (P.base[mid] <= s) lo = mid; else hi = mid;
                }
                Jac<Fp> v;
                jac_load_v(v, x, y, z, P.lane[lo] + (s - P.base[lo]));
                slot[s] = v;
            }
            __syncthreads();
            seg_trees(slot, sc, P, np);
            if (t < np) {
                const Jac<Fp> v = slot[P.base[t]];
                if (P.kind[t] == 0) jac_store_v(ox, oy, oz, P.g[t], v);
                else if (P.kind[t] == 1) w.full[P.lane[t]] = v;
                else w.last[P.g[t]] = v;
            }
        }
        __syncthreads();        // before the next tile's pieces
    }
    if (total.c == 0) return;   // the same on every block
    grid.sync();

    // 5. the long ranges: slot s < S = min(pieces, T) folds the partials
    // s, s + S, ... in series, then the tree over the S slots
    const int q = t / LH_GROUP_FP, r = t % LH_GROUP_FP;
    const GroupFp st{sc + q * LH_GROUP_FP, group_mask(t), r};
    for (long long i = blockIdx.x; i < total.c; i += G) {
        const int g = w.longs[i], f = w.first[g];
        const long long pieces = (__ldg(ends + g) - f + 1 + T - 1) / T;
        const int S = (int)(pieces < T ? pieces : T);
        for (int s = q; s < S; s += SegShape<T>::groups) {
            Jac<Fp> acc = pieces - 1 == s ? w.last[g] : w.full[f + s * T];
            for (long long j = s + S; j < pieces; j += S) {
                const Jac<Fp> v = j == pieces - 1 ? w.last[g]
                                                  : w.full[f + j * T];
                w_jac_add(st, acc, acc, v);
            }
            if (r == 0) slot[s] = acc;
        }
        if (t == 0) {
            P.base[0] = 0;
            P.w[0] = S;
        }
        __syncthreads();
        seg_trees(slot, sc, P, 1);
        if (t == 0) {
            const Jac<Fp> v = slot[0];
            jac_store_v(ox, oy, oz, g, v);
        }
        __syncthreads();
    }
}

template <class F>
__global__ void affine_kernel(const int32_t* __restrict__ x,
                              const int32_t* __restrict__ y,
                              const int32_t* __restrict__ z,
                              int32_t* __restrict__ ox,
                              int32_t* __restrict__ oy, long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) affine_lane<F>(x, y, z, ox, oy, i);
}

// part: the first launch's partials, 3 x blocks x 2 x LH_LIMBS words (the
// caller allocates them; unread up to LH_G2_SUM_T points)
extern "C" int lh_g2_sum(const void* x, const void* y, const void* z,
                         long long n, void* part, void* ox, void* oy,
                         void* oz, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const long long blocks = g2_sum_blocks(n);
    if (blocks == 1) {
        g2_sum_kernel<<<1, LH_G2_SUM_T, LH_G2_SUM_SMEM, s>>>(
            (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, n,
            (int32_t*)ox, (int32_t*)oy, (int32_t*)oz);
        return (int)cudaGetLastError();
    }
    int32_t* px = (int32_t*)part;
    const long long words = blocks * 2 * LH_LIMBS;
    g2_sum_kernel<<<(unsigned)blocks, LH_G2_SUM_T, LH_G2_SUM_SMEM, s>>>(
        (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, n, px,
        px + words, px + 2 * words);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    g2_sum_kernel<<<1, LH_G2_SUM_T, LH_G2_SUM_SMEM, s>>>(
        px, px + words, px + 2 * words, blocks, (int32_t*)ox, (int32_t*)oy,
        (int32_t*)oz);
    return (int)cudaGetLastError();
}

extern "C" int lh_affine(int field, const void* x, const void* y,
                         const void* z, void* ox, void* oy, long long n,
                         void* stream) {
    const int threads = LH_AFFINE_THREADS;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    cudaStream_t s = (cudaStream_t)stream;
    if (field == 1)
        affine_kernel<Fp><<<blocks, threads, 0, s>>>(
            (const int32_t*)x, (const int32_t*)y, (const int32_t*)z,
            (int32_t*)ox, (int32_t*)oy, n);
    else
        affine_kernel<Fp2><<<blocks, threads, 0, s>>>(
            (const int32_t*)x, (const int32_t*)y, (const int32_t*)z,
            (int32_t*)ox, (int32_t*)oy, n);
    return (int)cudaGetLastError();
}

// the co-resident blocks of seg_sum_kernel<T> on each card, asked once (0:
// not yet); its shared memory allowed past 48 KB on first use
template <int T>
static long long seg_resident(cudaError_t& rc) {
    static long long resident_of[64];
    int dev = 0;
    rc = cudaGetDevice(&dev);
    if (rc != cudaSuccess) return 0;
    long long resident = dev < 64 ? resident_of[dev] : 0;
    if (resident == 0) {
        int sms = 0, per_sm = 0;
        rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
        if (rc == cudaSuccess)
            rc = cudaFuncSetAttribute(
                (const void*)seg_sum_kernel<T>,
                cudaFuncAttributeMaxDynamicSharedMemorySize,
                SegShape<T>::smem);
        if (rc == cudaSuccess)
            rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, seg_sum_kernel<T>, SegShape<T>::threads,
                SegShape<T>::smem);
        if (rc != cudaSuccess) return 0;
        resident = (long long)sms * per_sm;
        if (dev < 64) resident_of[dev] = resident;
    }
    return resident;
}

template <int T>
static int seg_launch(const void* x, const void* y, const void* z,
                      const void* starts, long long n, const void* ends,
                      long long g_count, void* work, void* ox, void* oy,
                      void* oz, cudaStream_t s) {
    cudaError_t rc;
    const long long resident = seg_resident<T>(rc);
    if (rc != cudaSuccess) return (int)rc;
    const long long grid = seg_grid(n, T, resident);
    SegWork w = seg_work((int32_t*)work, n, g_count);
    void* args[] = {(void*)&x, (void*)&y, (void*)&z, (void*)&starts, &n,
                    (void*)&ends, &g_count, &w, &ox, &oy, &oz};
    rc = cudaLaunchCooperativeKernel(
        (const void*)seg_sum_kernel<T>, dim3((unsigned)(grid > 0 ? grid : 1)),
        dim3(SegShape<T>::threads), args, SegShape<T>::smem, s);
    if (rc != cudaSuccess) return (int)rc;
    return (int)cudaGetLastError();
}

// starts [n], ends [g_count] (0 <= ends < n: the caller checks), work: an
// int32 scratch of work_words >= seg_work_words(n, g_count) words. One
// cooperative launch; returns its error (cudaErrorCooperativeLaunchTooLarge
// included).
extern "C" int lh_g1_segment_sum(const void* x, const void* y,
                                 const void* z, const void* starts,
                                 long long n, const void* ends,
                                 long long g_count, void* work,
                                 long long work_words, void* ox, void* oy,
                                 void* oz, void* stream) {
    if (n < 1 || g_count < 1 || work_words < seg_work_words(n, g_count))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (seg_piece_lanes(n, g_count) == LH_SEG_T_SHORT)
        return seg_launch<LH_SEG_T_SHORT>(x, y, z, starts, n, ends, g_count,
                                          work, ox, oy, oz, s);
    return seg_launch<LH_SEG_T_LONG>(x, y, z, starts, n, ends, g_count, work,
                                     ox, oy, oz, s);
}
