// fp_ops: elementwise Montgomery arithmetic over [n, 32] limbs, one
// element per thread: op 0 multiply, 1 add, 2 subtract (a, b [n, 32]);
// op 3 into the Montgomery domain, x R = mont(x, R^2 mod p) (a [n, 32]);
// op 4 the wide reduction, mont(lo, R^2) + mont(hi, R^3) (a [n, 64]:
// lo, then hi).
//
// Replaces lighthouse_tpu/ops/bigint.py:319 mont_mul (with :124
// normalize, :207 _mul_columns), :377 add_mod, :382 sub_mod, :359
// mont_from_int_limbs and :410 reduce_wide_mod_p: the card check of the
// field layer every other BLS kernel is built on, and the main path's
// entry of its lane inputs into the Montgomery domain (one op-3 launch
// a batch). Ops 3 and 4 read R^2 and R^3 mod p from tables built into
// the library (consts.cuh), so no call copies a constant to the card,
// and op 4 is one launch where JAX composes three jitted programs. Built
// once for each multiply lowering (LH_FP_MODE, fp.cuh): the mode-1 and
// mode-2 variants replace :319 in those modes. Bound: bytes, one read
// of the inputs and one write of the output (a multiply's integer ops,
// 288 32x32->64-bit multiply-adds, ops/bls_cost.py FP_MUL_INT_OPS, are
// below the bytes' time at these shapes). An element is 128 B: a thread
// reading its own rows made each load of a warp touch 32 lines (34 us on
// an H100 for the batch's 40,960 elements, 8 us staged: compare_kernels),
// so a
// block's rows go through shared memory, consecutive threads on
// consecutive words, a row w + 1 words apart (no bank conflicts).
#include "fp.cuh"

#define FP_OP_TO_MONT 3
#define FP_OP_WIDE 4
#define FP_OPS_THREADS 128

// op on rows a (w 32, or 64 for the wide op) and b; the result into r
LH_DEV void fp_ops_row(int op, const int32_t* a, const int32_t* b, Fp& r) {
    Fp x, y;
    if (op == FP_OP_WIDE) {
        Fp u, c;
        fp_load(x, a);
        fp_load(y, a + LH_LIMBS);
        fp_set_const(c, LH_R2_MOD_P);
        fp_mul(u, x, c);
        fp_set_const(c, LH_R2);             // R^3 mod p as an integer
        fp_mul(r, y, c);
        fp_add(r, u, r);
        return;
    }
    fp_load(x, a);
    if (op == FP_OP_TO_MONT) fp_set_const(y, LH_R2_MOD_P);
    else fp_load(y, b);
    if (op == 0 || op == FP_OP_TO_MONT) fp_mul(r, x, y);
    else if (op == 1) fp_add(r, x, y);
    else fp_sub(r, x, y);
}

// the block's rows row0.. of a [n, w] array to shared memory (w + 1 apart)
LH_DEV void fp_ops_stage_in(int32_t* sm, const int32_t* g, long long row0,
                            long long n, int w) {
    const long long left = n - row0;
    const int rows = left < FP_OPS_THREADS ? (int)left : FP_OPS_THREADS;
    for (int k = threadIdx.x; k < rows * w; k += FP_OPS_THREADS) {
        const int r = k / w;
        sm[k + r] = g[row0 * w + k];
    }
}

__global__ void __launch_bounds__(FP_OPS_THREADS)
fp_ops_kernel(int op, const int32_t* __restrict__ a,
              const int32_t* __restrict__ b, int32_t* __restrict__ out,
              long long n) {
    const long long row0 = (long long)blockIdx.x * FP_OPS_THREADS;
    const long long i = row0 + threadIdx.x;
    const int wa = op == FP_OP_WIDE ? 2 * LH_LIMBS : LH_LIMBS;
    Fp r;
    extern __shared__ uint4 lh_smem[];
    int32_t* sa = reinterpret_cast<int32_t*>(lh_smem);
    int32_t* sb = sa + FP_OPS_THREADS * (wa + 1);
    fp_ops_stage_in(sa, a, row0, n, wa);
    if (op < FP_OP_TO_MONT) fp_ops_stage_in(sb, b, row0, n, LH_LIMBS);
    __syncthreads();
    const int t = threadIdx.x;
    if (i < n) fp_ops_row(op, sa + t * (wa + 1), sb + t * (LH_LIMBS + 1), r);
    __syncthreads();
    if (i < n) fp_store(sa + t * (LH_LIMBS + 1), r);
    __syncthreads();
    const long long left = n - row0;
    const int rows = left < FP_OPS_THREADS ? (int)left : FP_OPS_THREADS;
    for (int k = t; k < rows * LH_LIMBS; k += FP_OPS_THREADS)
        out[row0 * LH_LIMBS + k] = sa[k + k / LH_LIMBS];
}

extern "C" int lh_fp_ops(int op, const void* a, const void* b, void* out,
                         long long n, void* stream) {
    const long long blocks = (n + FP_OPS_THREADS - 1) / FP_OPS_THREADS;
    const int wa = op == FP_OP_WIDE ? 2 * LH_LIMBS : LH_LIMBS;
    const size_t smem = FP_OPS_THREADS * 4 *
        ((wa + 1) + (op < FP_OP_TO_MONT ? LH_LIMBS + 1 : 0));
    fp_ops_kernel<<<(unsigned)blocks, FP_OPS_THREADS, smem,
                    (cudaStream_t)stream>>>(
        op, (const int32_t*)a, (const int32_t*)b, (int32_t*)out, n);
    return (int)cudaGetLastError();
}
