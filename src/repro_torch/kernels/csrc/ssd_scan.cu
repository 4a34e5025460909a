// Mamba2 SSD chunked scan for NVIDIA Hopper (sm_90a): kernel B2.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` of
// src/repro/kernels/ssd_scan.py:49 (launched by `ssd_scan`, `pallas_call`
// at :97).  Per (batch, head), over chunks of Q steps of the recurrence
//     h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,    y_t = C_t . h_t
// with the (N, P) state h resident on chip for the whole sequence (the
// paper's temporal-blocking schedule on a 1-D linear recurrence: only the
// state crosses chunk boundaries, and it reaches device memory once, as
// h_final).  Per chunk, in float32:
//     Lc = cumsum(dt A)                         (Q)     inclusive, in order
//     M  = (C B^T) o exp(Lc_i - Lc_j) o dt_j    (Q, Q)  causal, 0 above
//     y  = M x + exp(Lc) o (C h)                (Q, P)  written as TO
//     h  = exp(Lc_Q) h + B^T (exp(Lc_Q - Lc) dt o x)   (N, P)
// x, B and C are float32 or bf16 (TI); dt, A, h0 and h_final are float32;
// y is float32 or bf16 (TO).  h0 may be null (zeros).  B and C are those
// of the head's group, h / (H / G).  One thread block per (batch, head), as
// the TPU grid; blocks run in no order, so the chunk loop runs inside the
// block.  Two schedules, one picked a launch on the host
// (`ssd_scan.schedule_of`, from the input dtype and (N, P, Q)); the C
// entry only checks that the shape is one the schedule takes.
//
// Schedule 1, tensor cores (`ssd_scan_tc_kernel`): bf16 x, B and C at
// (N, P, Q) = (128, 64, 64), mamba2-130m's heads (the serving path's
// call).  The four products run as mma.sync m16n8k16 bf16 with float32
// accumulation.  x, B and C are exact in bf16.  The float32 operand of
// the other three (M, h, and dt-decay o x: the update reads B^T (sd o x),
// the same three factors as the plain version's (B o sd)^T x, rounded at
// another place) is split into three bf16 pieces, hi + mid + lo, each the
// bf16 rounding of what the pieces before it left: 24 significant bits,
// float32's own, so the pieces' three products (summed in float32, the
// smallest first) carry no error a float32 product would not.  bf16 and
// not TF32: m16n8k16's accumulator fragment is, two n8 tiles side by side,
// the A fragment of the next product (M never leaves registers), and three
// bf16 passes cost 1.5 TF32 passes where TF32's own split needs two.  One
// unsplit pass would round M, h or sd o x to 8 bits (~2^-9) and miss the
// kernel-vs-plain bound (max|diff| <= 1e-5 max|plain|) by two orders
// (tests/test_torch_ssd.py replays both on the CPU).  Summation order
// differs from the plain version's, so the two are close, not bit-equal.
// Warps: each of the 8 owns 8 columns p of the state, all N rows, in
// registers (32 float32 accumulators: the state never goes to shared
// memory), and computes C h and the update for its columns; the B operand
// of C h comes from those registers, split and transposed per 8x8 with
// movmatrix.  Six warps also compute the intra-chunk term: C B^T for the
// 16x16 blocks on and below the diagonal only (blocks above it are
// neither computed nor multiplied), the mask, decay and dt_j applied to
// the accumulator fragments, split in registers and fed straight back as
// the A operand of M x.  Row block r has r + 1 such blocks, 10 in all;
// `intra_job` gives at most 2 to a warp and 3 to a warp scheduler, and a
// row block split over two warps meets in shared memory in a fixed order
// (the first stores its part, a named barrier of the two, the second
// adds).  Each warp then adds the y there to exp(Lc) o (C h) for its
// columns and stores y.  Warp 5, which has no intra-chunk work, computes
// the next chunk's cumulative log-decay (one lane, in order, as the plain
// version: exp(Lc) at |Lc| ~ 30 moves 4e-6 a last-place change) while
// the others finish this chunk.  The next chunk's x, B and C
// load as bf16 with cp.async into a second buffer while this one computes.
// Shared memory: two buffers of x (64 x 72), B and C (64 x 136 each; rows
// padded 16 B so ldmatrix's eight rows fall in distinct banks), the
// intra-chunk y (64 x 72 float32) and four scalars a step twice: 108,544
// bytes, so two blocks fit an SM (<= 113 KB each) and all 192 blocks of
// the serve call (8 x 24) run at once on 132 SMs, where one block an SM
// took ~1.45 waves; __launch_bounds__(256, 2) holds registers to 128.
// Two blocks an SM was kept over a chunk-parallel first pass (3,072
// items), which would move ~100 MB of chunk states through device memory
// and back, ~0.06 ms at 3.35 TB/s beside the whole call's bound.  C B^T
// is the same for all heads of a group (G = 1 here) but each block
// computes its own: sharing it means a pass over (b, g, chunk) first, or
// blocks of several heads; not tried.
//
// Schedule 0, float32 cores (`ssd_scan_kernel`, this kernel's first
// design, kept as it was): every other shape and the float32 inputs.
// Shared memory holds the state, one chunk of x, B, C (widened to float32)
// and M: at Q = 64, N = 128, P = 64 that is 132,608 bytes, one block an
// SM.  B and C rows have an odd stride, so a warp reading a column of them
// hits 32 banks.  The four products are one block-wide routine: a warp
// owns 8 rows (a broadcast read each) and its lanes 2 columns 32 apart,
// 16 fused multiply-adds per 10 shared loads; the causal zeros of M are
// computed and discarded.  It is bit-equal to the plain version.
//
// What bounds it on this card: at the serve phase's shapes (B 8, S 1024,
// H 24, G 1, N 128, P 64, Q 64, bf16 inputs, float32 y) the function
// needs 8.93 GFLOP (`kernel_cost`'s needed_flops: the causal halves of
// C B^T and M x), 0.009 ms at the tensor cores' 989 TFLOP/s bf16 (0.133
// ms at 67 TFLOP/s on the float32 cores, schedule 0's yardstick), and
// moves 86.8 MB of inputs and outputs, 0.026 ms at 3.35 TB/s: bytes bound
// schedule 1.  Its split passes issue 24.4 GFLOP of mma (1,936 m16n8k16
// a chunk a block).  Measured (PERF.md, tools/ssd_ab.py,
// tools/ssd_attribution.py): 0.16 ms a launch, 1.86 on schedule 0; what
// holds it there is issue and latency, not one unit: each of the
// intra-chunk term, C h, the update and the split's extra passes costs
// ~0.03-0.04 ms, and one block an SM instead of two costs 0.06.
//
// Flags: no fast math and -fmad=false (kernels/_build.py); expf in IEEE
// form.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define SSD_THREADS 256
#define SSD_TM 8            // rows a thread owns: a warp's, 8 apart
#define SSD_TN 2            // columns a thread owns: 32 apart

__device__ __forceinline__ float ld_f(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ld_f(const __nv_bfloat16* p, long long i)
{
    return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st_f(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void st_f(__nv_bfloat16* p, long long i, float v)
{
    p[i] = __float2bfloat16(v);
}

// acc[i][j] += sum over k < K of a(r_i, k) b(k, c_j), rows r_i = r0 + i * rt
// and columns c_j = c0 + j * 32 of this thread; a row >= R or a column >= C
// contributes 0
template <class A, class B>
__device__ __forceinline__ void mac(float (&acc)[SSD_TM][SSD_TN], int r0,
                                    int rt, int c0, int R, int C, int K, A a,
                                    B b)
{
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
        float av[SSD_TM], bv[SSD_TN];
#pragma unroll
        for (int i = 0; i < SSD_TM; ++i) {
            const int r = r0 + i * rt;
            av[i] = r < R ? a(r, k) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < SSD_TN; ++j) {
            const int c = c0 + j * 32;
            bv[j] = c < C ? b(k, c) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < SSD_TM; ++i)
#pragma unroll
            for (int j = 0; j < SSD_TN; ++j)
                acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
}

// body(r0, rt, c0) for every (rows, columns) tile of an R x C output this
// thread owns: warp w takes rows w + i * rt, lane l columns l + j * 32
template <class F>
__device__ __forceinline__ void for_tiles(int R, int C, F body)
{
    const int lane = threadIdx.x & 31, rt = blockDim.x >> 5;
    for (int r0 = threadIdx.x >> 5; r0 < R; r0 += rt * SSD_TM)
        for (int c0 = lane; c0 < C; c0 += 32 * SSD_TN) body(r0, rt, c0);
}

// out(r, c, acc[i][j]) for each in-range element of a tile
template <class O>
__device__ __forceinline__ void store_tile(const float (&acc)[SSD_TM][SSD_TN],
                                           int r0, int rt, int c0, int R,
                                           int C, O out)
{
#pragma unroll
    for (int i = 0; i < SSD_TM; ++i)
#pragma unroll
        for (int j = 0; j < SSD_TN; ++j) {
            const int r = r0 + i * rt, c = c0 + j * 32;
            if (r < R && c < C) out(r, c, acc[i][j]);
        }
}

struct ScanArgs {
    const float* dt;        // (B, S, H)
    const float* A;         // (H,)
    const float* h0;        // (B, H, N, P) or nullptr
    float* h_final;         // (B, H, N, P)
    int S, H, G, N, P, Q;
};

// the row stride of B and C in shared memory: odd, so a warp reading one
// column of 32 rows touches 32 banks
__host__ __device__ inline int bc_stride(int N) { return N | 1; }

__host__ __device__ inline long long smem_floats(int N, int P, int Q)
{
    return (long long)N * P + (long long)Q * P + 2LL * Q * bc_stride(N)
        + (long long)Q * Q + 4LL * Q;
}

template <class TI, class TO>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_scan_kernel(const TI* __restrict__ x, const TI* __restrict__ Bm,
                const TI* __restrict__ Cm, TO* __restrict__ y,
                const ScanArgs a)
{
    extern __shared__ float sm[];
    const int h = blockIdx.x, b = blockIdx.y;
    const int S = a.S, H = a.H, G = a.G, N = a.N, P = a.P, Q = a.Q;
    const int ld = bc_stride(N), g = h / (H / G);
    float* hs = sm;                        // (N, P) the state
    float* xs = hs + N * P;                // (Q, P)
    float* Bs = xs + Q * P;                // (Q, ld)
    float* Cs = Bs + Q * ld;               // (Q, ld)
    float* Ms = Cs + Q * ld;               // (Q, Q)
    float* dts = Ms + Q * Q;               // (Q) dt
    float* Lc = dts + Q;                   // (Q) cumsum(dt A)
    float* eLc = Lc + Q;                   // (Q) exp(Lc)
    float* sd = eLc + Q;                   // (Q) exp(Lc_Q - Lc) dt
    const float A = a.A[h];
    const long long hbase = ((long long)b * H + h) * N * P;

    for (int i = threadIdx.x; i < N * P; i += blockDim.x)
        hs[i] = a.h0 ? a.h0[hbase + i] : 0.f;

    for (int s0 = 0; s0 < S; s0 += Q) {
        // this chunk's x (Q, P), B and C of group g (Q, N), dt (Q)
#pragma unroll 4
        for (int i = threadIdx.x; i < Q * P; i += blockDim.x) {
            const int q = i / P, p = i - q * P;
            xs[i] = ld_f(x, (((long long)b * S + s0 + q) * H + h) * P + p);
        }
#pragma unroll 4
        for (int i = threadIdx.x; i < Q * N; i += blockDim.x) {
            const int q = i / N, n = i - q * N;
            const long long gi = (((long long)b * S + s0 + q) * G + g) * N + n;
            Bs[q * ld + n] = ld_f(Bm, gi);
            Cs[q * ld + n] = ld_f(Cm, gi);
        }
        for (int q = threadIdx.x; q < Q; q += blockDim.x)
            dts[q] = a.dt[((long long)b * S + s0 + q) * H + h];
        __syncthreads();
        if (threadIdx.x == 0) {
            float run = 0.f;
            for (int q = 0; q < Q; ++q) {
                run += dts[q] * A;
                Lc[q] = run;
            }
        }
        __syncthreads();
        for (int q = threadIdx.x; q < Q; q += blockDim.x) {
            eLc[q] = expf(Lc[q]);
            sd[q] = expf(Lc[Q - 1] - Lc[q]) * dts[q];
        }
        // M = (C B^T) o exp(Lc_i - Lc_j) o dt_j below the diagonal
        for_tiles(Q, Q, [&](int r0, int rt, int c0) {
            float acc[SSD_TM][SSD_TN] = {};
            mac(acc, r0, rt, c0, Q, Q, N,
                [&](int i, int n) { return Cs[i * ld + n]; },
                [&](int n, int j) { return Bs[j * ld + n]; });
            store_tile(acc, r0, rt, c0, Q, Q, [&](int i, int j, float v) {
                Ms[i * Q + j] = j <= i ? v * expf(Lc[i] - Lc[j]) * dts[j] : 0.f;
            });
        });
        __syncthreads();
        // y = M x + exp(Lc) o (C h), with h the state before this chunk
        for_tiles(Q, P, [&](int r0, int rt, int c0) {
            float intra[SSD_TM][SSD_TN] = {}, inter[SSD_TM][SSD_TN] = {};
            mac(intra, r0, rt, c0, Q, P, Q,
                [&](int i, int j) { return Ms[i * Q + j]; },
                [&](int j, int p) { return xs[j * P + p]; });
            mac(inter, r0, rt, c0, Q, P, N,
                [&](int i, int n) { return Cs[i * ld + n]; },
                [&](int n, int p) { return hs[n * P + p]; });
#pragma unroll
            for (int i = 0; i < SSD_TM; ++i)
#pragma unroll
                for (int j = 0; j < SSD_TN; ++j) {
                    const int q = r0 + i * rt, p = c0 + j * 32;
                    if (q < Q && p < P)
                        st_f(y, (((long long)b * S + s0 + q) * H + h) * P + p,
                             intra[i][j] + eLc[q] * inter[i][j]);
                }
        });
        __syncthreads();
        // h = exp(Lc_Q) h + (B o sd)^T x: each element read and written by
        // the one thread that owns it
        const float eLQ = expf(Lc[Q - 1]);
        for_tiles(N, P, [&](int r0, int rt, int c0) {
            float acc[SSD_TM][SSD_TN] = {};
            mac(acc, r0, rt, c0, N, P, Q,
                [&](int n, int q) { return Bs[q * ld + n] * sd[q]; },
                [&](int q, int p) { return xs[q * P + p]; });
            store_tile(acc, r0, rt, c0, N, P, [&](int n, int p, float v) {
                hs[n * P + p] = eLQ * hs[n * P + p] + v;
            });
        });
        __syncthreads();
    }
    for (int i = threadIdx.x; i < N * P; i += blockDim.x)
        a.h_final[hbase + i] = hs[i];
}

// ---------------------------------------------------------------------------
// Schedule 1: tensor cores (bf16 x, B and C at (N, P, Q) = (128, 64, 64))
// ---------------------------------------------------------------------------

namespace tc {

constexpr int N = 128, P = 64, Q = 64;
constexpr int THREADS = 256;            // 8 warps, 8 state columns each
constexpr int XLD = P + 8;              // bf16 row stride of x: 144 B
constexpr int BLD = N + 8;              // of B and C: 272 B
constexpr int YLD = P + 8;              // float row stride of the intra y
constexpr int DECAY_WARP = 5;           // computes the next chunk's decay

struct Smem {
    __nv_bfloat16 x[2][Q * XLD];
    __nv_bfloat16 B[2][Q * BLD];
    __nv_bfloat16 C[2][Q * BLD];
    float y[Q * YLD];                   // M x of this chunk
    float dt[2][Q], Lc[2][Q], eLc[2][Q], sd[2][Q];
};

// a warp's part of the intra-chunk term: row block r (r < 0: none),
// column blocks kb0..kb1 - 1 of it, and how its partial y meets the other
// part of the same rows: mode 0 alone, 1 stored first (then it arrives at
// named barrier `bar`), 2 added to the first (after waiting there).  The
// 10 blocks on and below the diagonal, at most 2 a warp, 3 a warp
// scheduler (warp w runs on scheduler w % 4; DECAY_WARP has none)
struct IntraJob {
    int r, kb0, kb1, mode, bar;
};

__device__ __forceinline__ IntraJob intra_job(int warp)
{
    switch (warp) {
    case 0: return {3, 0, 2, 1, 1};
    case 1: return {3, 2, 4, 2, 1};
    case 2: return {2, 0, 2, 1, 2};
    case 7: return {2, 2, 3, 2, 2};
    case 3: return {1, 0, 2, 0, 0};
    case 4: return {0, 0, 1, 0, 0};
    default: return {-1, 0, 0, 0, 0};
    }
}

__host__ __device__ constexpr bool shape_ok(int n, int p, int q)
{
    return n == N && p == P && q == Q;
}

__device__ __forceinline__ unsigned saddr(const void* p)
{
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(saddr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and r[i] holds matrix i's row l / 4, columns 2 (l % 4) + {0, 1}
// (with .trans: its column l / 4, rows 2 (l % 4) + {0, 1})
__device__ __forceinline__ void ldsm(unsigned (&r)[4], const void* p)
{
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(saddr(p)) : "memory");
}

__device__ __forceinline__ void ldsm_t(unsigned (&r)[4], const void* p)
{
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(saddr(p)) : "memory");
}

// named barrier `id` of the two warps (64 threads) that share a row block
__device__ __forceinline__ void pair_arrive(int id)
{
    asm volatile("bar.arrive %0, 64;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void pair_sync(int id)
{
    asm volatile("bar.sync %0, 64;\n" :: "r"(id) : "memory");
}

// the transpose of an 8x8 b16 matrix held one row-pair fragment a lane
__device__ __forceinline__ unsigned movtrans(unsigned a)
{
    unsigned d;
    asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
        : "=r"(d) : "r"(a));
    return d;
}

// d += a b: A 16x16 row-major (a[0] rows g, a[1] rows g + 8, columns
// 2t..; a[2], a[3] columns 2t + 8..), B 16x8 (b0 rows 2t.., b1 rows
// 2t + 8.., column g), D 16x8 (d[0..1] row g, d[2..3] row g + 8, columns
// 2t, 2t + 1); g = lane / 4, t = lane % 4
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1)
{
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v)
{
    return *reinterpret_cast<unsigned*>(&v);
}

// (u, v) as three bf16x2 pieces, hi + mid + lo: each the bf16 rounding of
// what the pieces before it left (the differences are exact in float32)
struct Split {
    unsigned hi, mid, lo;
};

__device__ __forceinline__ Split split(float u, float v)
{
    const __nv_bfloat162 hi = __floats2bfloat162_rn(u, v);
    const float2 fh = __bfloat1622float2(hi);
    const float ru = u - fh.x, rv = v - fh.y;
    const __nv_bfloat162 mid = __floats2bfloat162_rn(ru, rv);
    const float2 fm = __bfloat1622float2(mid);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(ru - fm.x, rv - fm.y);
    return {bits(hi), bits(mid), bits(lo)};
}

// d += a b for a split A operand, the smallest piece first
__device__ __forceinline__ void mma3(float (&d)[4], const Split (&a)[4],
                                     unsigned b0, unsigned b1)
{
    const unsigned lo[4] = {a[0].lo, a[1].lo, a[2].lo, a[3].lo};
    const unsigned mid[4] = {a[0].mid, a[1].mid, a[2].mid, a[3].mid};
    const unsigned hi[4] = {a[0].hi, a[1].hi, a[2].hi, a[3].hi};
    mma(d, lo, b0, b1);
    mma(d, mid, b0, b1);
    mma(d, hi, b0, b1);
}

// d += a b for a split B operand, the smallest piece first
__device__ __forceinline__ void mma3(float (&d)[4], const unsigned (&a)[4],
                                     const Split& b0, const Split& b1)
{
    mma(d, a, b0.lo, b1.lo);
    mma(d, a, b0.mid, b1.mid);
    mma(d, a, b0.hi, b1.hi);
}

__device__ __forceinline__ void store2(float* p, float u, float v)
{
    *reinterpret_cast<float2*>(p) = make_float2(u, v);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float u, float v)
{
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(u, v);
}

}  // namespace tc

template <class TO>
__global__ void __launch_bounds__(tc::THREADS, 2)
ssd_scan_tc_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ Bm,
                   const __nv_bfloat16* __restrict__ Cm, TO* __restrict__ y,
                   const ScanArgs a)
{
    using namespace tc;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
    const int h = blockIdx.x, b = blockIdx.y;
    const int S = a.S, H = a.H, G = a.G, grp = h / (H / G);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int fg = lane >> 2, ft = lane & 3;     // fragment row, column pair
    const int p0 = 8 * warp;                     // this warp's columns
    const int nc = S / Q;
    const float A = a.A[h];
    const long long hbase = ((long long)b * H + h) * N * P;

    // chunk c's x, B and C into buffer c & 1, 16 bytes a copy
    auto load_chunk = [&](int c) {
        const int buf = c & 1;
        const long long s0 = (long long)b * S + (long long)c * Q;
        for (int i = threadIdx.x; i < Q * (P / 8); i += THREADS) {
            const int q = i / (P / 8), k = 8 * (i % (P / 8));
            cp_async16(&sm.x[buf][q * XLD + k],
                       x + ((s0 + q) * H + h) * P + k);
        }
        for (int i = threadIdx.x; i < Q * (N / 8); i += THREADS) {
            const int q = i / (N / 8), k = 8 * (i % (N / 8));
            const long long gi = ((s0 + q) * G + grp) * N + k;
            cp_async16(&sm.B[buf][q * BLD + k], Bm + gi);
            cp_async16(&sm.C[buf][q * BLD + k], Cm + gi);
        }
        cp_async_commit();
    };
    // the decay warp: dt of chunk c's steps lane and lane + 32
    auto load_dt = [&](int c, float (&d)[2]) {
        const long long s0 = (long long)b * S + (long long)c * Q;
        d[0] = a.dt[(s0 + lane) * H + h];
        d[1] = a.dt[(s0 + lane + 32) * H + h];
    };
    // ... and chunk c's scalars into buffer c & 1: the log-decay summed in
    // order by one lane, exp(Lc) and exp(Lc_Q - Lc) dt
    auto decay = [&](int c, const float (&d)[2]) {
        const int buf = c & 1;
        float* dts = sm.dt[buf];
        float* Lc = sm.Lc[buf];
        dts[lane] = d[0];
        dts[lane + 32] = d[1];
        __syncwarp();
        if (lane == 0) {
            float run = 0.f;
            for (int q = 0; q < Q; ++q) {
                run += dts[q] * A;
                Lc[q] = run;
            }
        }
        __syncwarp();
        for (int q = lane; q < Q; q += 32) {
            sm.eLc[buf][q] = expf(Lc[q]);
            sm.sd[buf][q] = expf(Lc[Q - 1] - Lc[q]) * dts[q];
        }
    };

    // the state's columns p0..p0 + 7, all N rows: st[i] is rows 16 i..16 i
    // + 15 as a 16x8 accumulator fragment
    float st[N / 16][4];
#pragma unroll
    for (int i = 0; i < N / 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int n = 16 * i + fg + 8 * (e >> 1), p = p0 + 2 * ft + (e & 1);
            st[i][e] = a.h0 ? a.h0[hbase + n * P + p] : 0.f;
        }

    load_chunk(0);
    float dnext[2];
    if (warp == DECAY_WARP) {
        float d0[2];
        load_dt(0, d0);
        decay(0, d0);
        if (nc > 1) load_dt(1, dnext);
    }

    for (int c = 0; c < nc; ++c) {
        const int buf = c & 1;
        cp_async_wait_all();
        // chunk c's operands and scalars are in; chunk c - 1 is done with
        // the other buffers and with y
        __syncthreads();
        if (c + 1 < nc) load_chunk(c + 1);
        const __nv_bfloat16* xs = sm.x[buf];
        const __nv_bfloat16* Bs = sm.B[buf];
        const __nv_bfloat16* Cs = sm.C[buf];
        const float* dts = sm.dt[buf];
        const float* Lc = sm.Lc[buf];
        const float* eLc = sm.eLc[buf];
        const float* sd = sm.sd[buf];

        // the intra-chunk term of row block r: y_r = sum over column
        // blocks kb <= r of M[r, kb] x[kb], this warp's kb0..kb1 - 1
        const IntraJob job = intra_job(warp);
        if (job.r >= 0) {
            const int r = job.r;
            float yi[P / 8][4] = {};
            for (int kb = job.kb0; kb < job.kb1; ++kb) {
                float gacc[2][4] = {};       // C B^T, columns 16 kb..
#pragma unroll
                for (int kk = 0; kk < N / 16; ++kk) {
                    unsigned af[4], bf[4];
                    ldsm(af, Cs + (16 * r + (lane & 7) + ((lane >> 3) & 1) * 8)
                                 * BLD + 16 * kk + (lane >> 4) * 8);
                    ldsm(bf, Bs + (16 * kb + (lane & 7) + (lane >> 4) * 8)
                                 * BLD + 16 * kk + ((lane >> 3) & 1) * 8);
                    mma(gacc[0], af, bf[0], bf[1]);
                    mma(gacc[1], af, bf[2], bf[3]);
                }
                // M = (C B^T) o exp(Lc_i - Lc_j) o dt_j for j <= i, 0
                // above, split: the two 16x8 accumulators are the A
                // fragment of M x (a[0], a[1] the first, a[2], a[3] the
                // second)
                Split am[4];
#pragma unroll
                for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const int i = 16 * r + fg + 8 * hh;
                        const int j = 16 * kb + 8 * nt + 2 * ft;
                        const float m0 = j <= i
                            ? gacc[nt][2 * hh] * expf(Lc[i] - Lc[j]) * dts[j]
                            : 0.f;
                        const float m1 = j + 1 <= i
                            ? gacc[nt][2 * hh + 1] * expf(Lc[i] - Lc[j + 1])
                                * dts[j + 1]
                            : 0.f;
                        am[2 * nt + hh] = split(m0, m1);
                    }
#pragma unroll
                for (int np = 0; np < P / 16; ++np) {
                    unsigned bf[4];
                    ldsm_t(bf, xs + (16 * kb + (lane & 7)
                                     + ((lane >> 3) & 1) * 8) * XLD
                                   + 16 * np + (lane >> 4) * 8);
                    mma3(yi[2 * np], am, bf[0], bf[1]);
                    mma3(yi[2 * np + 1], am, bf[2], bf[3]);
                }
            }
            float* yr = sm.y + (16 * r + fg) * YLD + 2 * ft;
            if (job.mode == 2) {            // the first part is stored
                pair_sync(job.bar);
#pragma unroll
                for (int n = 0; n < P / 8; ++n)
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const float2 v = *reinterpret_cast<const float2*>(
                            yr + hh * 8 * YLD + 8 * n);
                        yi[n][2 * hh] = v.x + yi[n][2 * hh];
                        yi[n][2 * hh + 1] = v.y + yi[n][2 * hh + 1];
                    }
            }
#pragma unroll
            for (int n = 0; n < P / 8; ++n) {
                store2(yr + 8 * n, yi[n][0], yi[n][1]);
                store2(yr + 8 * YLD + 8 * n, yi[n][2], yi[n][3]);
            }
            if (job.mode == 1) pair_arrive(job.bar);
        }

        // C h for this warp's columns, with h the state before this chunk:
        // its 8x8 pieces transposed into B fragments
        float inter[Q / 16][4] = {};
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
            const Split u0 = split(st[kk][0], st[kk][1]);
            const Split u1 = split(st[kk][2], st[kk][3]);
            const Split b0 = {movtrans(u0.hi), movtrans(u0.mid),
                              movtrans(u0.lo)};
            const Split b1 = {movtrans(u1.hi), movtrans(u1.mid),
                              movtrans(u1.lo)};
#pragma unroll
            for (int r = 0; r < Q / 16; ++r) {
                unsigned af[4];
                ldsm(af, Cs + (16 * r + (lane & 7) + ((lane >> 3) & 1) * 8)
                             * BLD + 16 * kk + (lane >> 4) * 8);
                mma3(inter[r], af, b0, b1);
            }
        }

        // h = exp(Lc_Q) h + B^T (sd o x): the B operand sd o x of this
        // warp's columns, split; A = B^T from B's rows, transposed
        Split xb[Q / 16][2];
#pragma unroll
        for (int k2 = 0; k2 < Q / 32; ++k2) {
            unsigned r4[4];
            ldsm_t(r4, xs + (32 * k2 + lane) * XLD + p0);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int q = 32 * k2 + 8 * j + 2 * ft;
                const float2 v = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(&r4[j]));
                xb[2 * k2 + (j >> 1)][j & 1] = split(sd[q] * v.x,
                                                     sd[q + 1] * v.y);
            }
        }
        // four row blocks of the state at a time: four independent
        // accumulator chains in flight
        const float eLQ = eLc[Q - 1];
#pragma unroll
        for (int i0 = 0; i0 < N / 16; i0 += 4) {
            float acc[4][4] = {};
#pragma unroll
            for (int kq = 0; kq < Q / 16; ++kq)
#pragma unroll
                for (int ii = 0; ii < 4; ++ii) {
                    unsigned af[4];
                    ldsm_t(af, Bs + (16 * kq + (lane & 7) + (lane >> 4) * 8)
                                    * BLD + 16 * (i0 + ii)
                                    + ((lane >> 3) & 1) * 8);
                    mma3(acc[ii], af, xb[kq][0], xb[kq][1]);
                }
#pragma unroll
            for (int ii = 0; ii < 4; ++ii)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    st[i0 + ii][e] = eLQ * st[i0 + ii][e] + acc[ii][e];
        }

        if (warp == DECAY_WARP && c + 1 < nc) {
            decay(c + 1, dnext);
            if (c + 2 < nc) load_dt(c + 2, dnext);
        }
        __syncthreads();              // the intra-chunk y is in

        // y = M x + exp(Lc) o (C h), this warp's columns
#pragma unroll
        for (int r = 0; r < Q / 16; ++r)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int q = 16 * r + fg + 8 * hh;
                const float2 yv = *reinterpret_cast<const float2*>(
                    sm.y + q * YLD + p0 + 2 * ft);
                const float e = eLc[q];
                store2(y + (((long long)b * S + (long long)c * Q + q) * H + h)
                               * P + p0 + 2 * ft,
                       yv.x + e * inter[r][2 * hh],
                       yv.y + e * inter[r][2 * hh + 1]);
            }
    }
#pragma unroll
    for (int i = 0; i < N / 16; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int n = 16 * i + fg + 8 * hh;
            tc::store2(a.h_final + hbase + n * P + p0 + 2 * ft,
                       st[i][2 * hh], st[i][2 * hh + 1]);
        }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

enum Schedule { FLOAT32_CORES = 0, TENSOR_CORES = 1 };

static long long smem_bytes(int N, int P, int Q, int schedule)
{
    return schedule == TENSOR_CORES
        ? (long long)sizeof(tc::Smem)
        : smem_floats(N, P, Q) * (long long)sizeof(float);
}

template <class K>
static cudaError_t set_smem(int device, K kernel, long long bytes)
{
    int optin = 0;
    cudaError_t e = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e != cudaSuccess) return e;
    if (bytes > optin) return cudaErrorInvalidValue;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

template <class TI, class TO>
static int launch(int device, const void* x, const void* Bm, const void* Cm,
                  void* y, const ScanArgs& a, int batch, void* stream)
{
    cudaError_t e = set_smem(device, ssd_scan_kernel<TI, TO>,
                             smem_bytes(a.N, a.P, a.Q, FLOAT32_CORES));
    if (e != cudaSuccess) return (int)e;
    ssd_scan_kernel<TI, TO><<<dim3(a.H, batch), SSD_THREADS,
                              (size_t)smem_bytes(a.N, a.P, a.Q, FLOAT32_CORES),
                              (cudaStream_t)stream>>>(
        (const TI*)x, (const TI*)Bm, (const TI*)Cm, (TO*)y, a);
    return (int)cudaGetLastError();
}

template <class TO>
static int launch_tc(int device, const void* x, const void* Bm,
                     const void* Cm, void* y, const ScanArgs& a, int batch,
                     void* stream)
{
    const long long bytes = smem_bytes(a.N, a.P, a.Q, TENSOR_CORES);
    cudaError_t e = set_smem(device, ssd_scan_tc_kernel<TO>, bytes);
    if (e != cudaSuccess) return (int)e;
    // all of the SM's shared memory, so two blocks fit
    e = cudaFuncSetAttribute(ssd_scan_tc_kernel<TO>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    typedef __nv_bfloat16 bf;
    ssd_scan_tc_kernel<TO><<<dim3(a.H, batch), tc::THREADS, (size_t)bytes,
                             (cudaStream_t)stream>>>(
        (const bf*)x, (const bf*)Bm, (const bf*)Cm, (TO*)y, a);
    return (int)cudaGetLastError();
}

static bool schedule_ok(int schedule, int in_bf16, int N, int P, int Q)
{
    if (schedule == TENSOR_CORES) return in_bf16 && tc::shape_ok(N, P, Q);
    return schedule == FLOAT32_CORES;
}

// Returns 0, or the cudaError_t value of what went wrong (a refused launch
// included).  in_bf16 / out_bf16 select the types of x, B, C and of y;
// schedule is 0 (float32 cores, any shape) or 1 (tensor cores: bf16
// inputs at (N, P, Q) = (128, 64, 64) only), as the host picks it.
extern "C" int repro_ssd_scan(int device, const void* x, const float* dt,
                              const void* Bm, const void* Cm, const float* A,
                              const float* h0, void* y, float* h_final,
                              int in_bf16, int out_bf16, int batch, int S,
                              int H, int G, int N, int P, int Q, int schedule,
                              void* stream)
{
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (batch < 1 || batch > 65535 || H < 1 || G < 1 || H % G || N < 1
        || P < 1 || Q < 1 || S < Q || S % Q
        || !schedule_ok(schedule, in_bf16, N, P, Q))
        return (int)cudaErrorInvalidValue;
    const ScanArgs a{dt, A, h0, h_final, S, H, G, N, P, Q};
    typedef __nv_bfloat16 bf;
    if (schedule == TENSOR_CORES)
        return out_bf16 ? launch_tc<bf>(device, x, Bm, Cm, y, a, batch, stream)
                        : launch_tc<float>(device, x, Bm, Cm, y, a, batch,
                                           stream);
    if (in_bf16)
        return out_bf16 ? launch<bf, bf>(device, x, Bm, Cm, y, a, batch, stream)
                        : launch<bf, float>(device, x, Bm, Cm, y, a, batch, stream);
    return out_bf16 ? launch<float, bf>(device, x, Bm, Cm, y, a, batch, stream)
                    : launch<float, float>(device, x, Bm, Cm, y, a, batch, stream);
}

// dynamic shared memory one block of `schedule` needs, in bytes
extern "C" long long repro_ssd_smem_bytes(int N, int P, int Q, int schedule)
{
    return smem_bytes(N, P, Q, schedule);
}

// blocks of `schedule` (float32 y) an SM holds at once, or -(cudaError_t)
extern "C" int repro_ssd_blocks_per_sm(int device, int N, int P, int Q,
                                       int schedule)
{
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return -(int)e;
    const long long bytes = smem_bytes(N, P, Q, schedule);
    int blocks = 0;
    if (schedule == TENSOR_CORES) {
        e = set_smem(device, ssd_scan_tc_kernel<float>, bytes);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                ssd_scan_tc_kernel<float>,
                cudaFuncAttributePreferredSharedMemoryCarveout,
                (int)cudaSharedmemCarveoutMaxShared);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, ssd_scan_tc_kernel<float>, tc::THREADS,
                (size_t)bytes);
    } else {
        typedef __nv_bfloat16 bf;
        e = set_smem(device, ssd_scan_kernel<bf, float>, bytes);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, ssd_scan_kernel<bf, float>, SSD_THREADS,
                (size_t)bytes);
    }
    return e == cudaSuccess ? blocks : -(int)e;
}

extern "C" const char* repro_cuda_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}
