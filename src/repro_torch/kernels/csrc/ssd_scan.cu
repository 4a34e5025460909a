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
// Schedule 1, tensor cores (`ssd_scan_tc_kernel<N, P, Q>`): bf16 x, B
// and C at (N, P, Q) = (128, 64, 64), mamba2-130m's heads (B4), and (64,
// 64, 128), zamba2-2.7b's (B7): the serving path's calls; one template,
// instantiated at the shapes of `with_tc_shape`.  The four products run
// as mma.sync m16n8k16 bf16 with float32 accumulation.  x, B and C are
// exact in bf16.  The float32 operand of the other three (M, h, and
// dt-decay o x: the update reads B^T (sd o x), the same three factors as
// the plain version's (B o sd)^T x, rounded at another place) is split
// into three bf16 pieces, hi + mid + lo, each the bf16 rounding of what
// the pieces before it left: 24 significant bits, float32's own, so the
// pieces' three products (summed in float32, the smallest first) carry no
// error a float32 product would not.  bf16 and not TF32: m16n8k16's
// accumulator fragment is, two n8 tiles side by side, the A fragment of
// the next product (M never leaves registers), and three bf16 passes cost
// 1.5 TF32 passes where TF32's own split needs two.  One unsplit pass
// would round M, h or sd o x to 8 bits (~2^-9) and miss the
// kernel-vs-plain bound (max|diff| <= 1e-5 max|plain|) by two orders, at
// Q = 128 as at 64 (tests/test_torch_ssd.py replays both at both shapes
// on the CPU).  Summation order differs from the plain version's, so the
// two are close, not bit-equal.  Warps: each of the 8 owns 8 columns p of
// the state, all N rows, in registers (the state never goes to shared
// memory), and computes C h and the update for its columns; the B operand
// of C h comes from those registers, split and transposed per 8x8 with
// movmatrix.  The update takes the Q steps in two halves at Q = 128, so
// one half's split sd o x is in registers at a time.  The intra-chunk
// term: C B^T for the 16x16 blocks on and below the diagonal only (blocks
// above it are neither computed nor multiplied), the mask, decay and dt_j
// applied to the accumulator fragments, split in registers and fed
// straight back as the A operand of M x.  Row block r has r + 1 such
// blocks, 10 at Q = 64 and 36 at Q = 128; `intra_jobs` cuts each row
// block into at most two parts and spreads the parts over the warps, at
// most one a warp, balanced over the four warp schedulers (Q = 64: six
// parts of 1-2 blocks, two row blocks split; Q = 128: the 8 row blocks
// whole, 9 blocks a scheduler).  A row block split over two warps meets
// in shared memory in a fixed order (the first stores its part, a named
// barrier of the two, the second adds).  Each warp then adds the y there
// to exp(Lc) o (C h) for its columns and stores y.  DECAY_WARP, with the
// smallest part or none, computes the next chunk's cumulative log-decay
// (one lane, in order, as the plain version: exp(Lc) at |Lc| ~ 30 moves
// 4e-6 a last-place change) while the others finish this chunk.  The next
// chunk's x, B and C load as bf16 with cp.async into a second buffer while
// this one computes.  Shared memory (`Smem`): two buffers of x, B and C
// (rows padded 16 B so ldmatrix's eight rows fall in distinct banks), four
// scalars a step twice, and the intra-chunk y (float32).  At (128, 64, 64)
// that is 108,544 bytes with the y in room of its own, so two blocks fit
// an SM (<= 113 KB each) and all 192 blocks of the serve call (8 x 24) run
// at once on 132 SMs, where one block an SM took ~1.45 waves; at (64, 64,
// 128) the y's own room (36,864 B) would make it 151,552, one block an SM,
// so there the y takes the chunk's own x/B/C buffer once every warp is
// done reading it: 114,688 bytes, two blocks an SM, 640 blocks (8 x 80) in
// 2.42 waves; the intra-chunk parts then run after C h and the update and
// hold their partial y in registers across the barrier.
// __launch_bounds__(256, 2) holds registers to 128.  Two blocks an SM was
// kept over a chunk-parallel first pass (3,072 items at the serve shape),
// which would move ~100 MB of chunk states through device memory and
// back, ~0.06 ms at 3.35 TB/s beside the whole call's bound.  C B^T is the
// same for all heads of a group (G = 1 here) but each block computes its
// own: sharing it means a pass over (b, g, chunk) first, or blocks of
// several heads; not tried.
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
// ~0.03-0.04 ms, and one block an SM instead of two costs 0.06.  At
// zamba2-2.7b's (B 8, S 1024, H 80, N 64, P 64, Q 128) it needs 21.8
// GFLOP (0.022 ms on the tensor cores) and moves 267 MB, 0.080 ms: bytes
// bound again.  It issues 2,688 mma a chunk a block (C B^T 288, M x 864,
// C h 768, the update 768), 13.8 M a launch.  Measured: 0.40 ms a launch,
// 3.50 on schedule 0; taken out one at a time, the intra-chunk term costs
// 0.19 ms (36 blocks over 8 warps, the row block of 8 on one warp), C h
// 0.065, the update 0.05, the split's extra passes 0.07, M's exp 0.03;
// one block an SM costs 0.155, the y in room of its own (one block an SM)
// 0.07.
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
// Schedule 1: tensor cores (bf16 x, B and C at the shapes of
// `with_tc_shape`)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int THREADS = 256;            // 8 warps, 8 state columns each
constexpr int WARPS = THREADS / 32;
constexpr int DECAY_WARP = 4;           // computes the next chunk's decay:
                                        // the job table's last slot
// shared memory a block may take for two to fit an SM: the SM's 228 KB
// less the 1 KB the system keeps for each block, halved
constexpr int TWO_A_SM = (228 * 1024 - 2 * 1024) / 2;

// Shared memory at (N, P, Q): two buffers of x (Q x XLD), B and C (Q x BLD
// each; rows padded 16 B so ldmatrix's eight rows fall in distinct banks),
// four scalars a step twice, and the intra-chunk y (Q x YLD float32).  The
// y has room of its own where that still lets two blocks fit an SM;
// otherwise it takes the buffer of the chunk it belongs to once every warp
// is done reading that chunk's x, B and C.
template <int N, int P, int Q>
struct Smem {
    static constexpr int XLD = P + 8;   // bf16 row stride of x
    static constexpr int BLD = N + 8;   // of B and C
    static constexpr int YLD = P + 8;   // float row stride of the intra y
    struct Ops {
        __nv_bfloat16 x[Q * XLD], B[Q * BLD], C[Q * BLD];
    };
    Ops ops[2];
    float dt[2][Q], Lc[2][Q], eLc[2][Q], sd[2][Q];

    static constexpr int Y_BYTES = Q * YLD * (int)sizeof(float);
    static constexpr int BASE_BYTES = 2 * (int)sizeof(Ops)
                                      + 8 * Q * (int)sizeof(float);
    static constexpr bool OWN_Y = BASE_BYTES + Y_BYTES <= TWO_A_SM;
    static constexpr int BYTES = BASE_BYTES + (OWN_Y ? Y_BYTES : 0);
    static_assert(OWN_Y || Y_BYTES <= (int)sizeof(Ops),
                  "the intra y must fit in a chunk's buffer");
    static_assert(sizeof(Ops) % 16 == 0 && (Q * XLD) % 8 == 0
                  && (Q * BLD) % 8 == 0, "cp.async needs 16-byte rows");

    __device__ float* y(int buf)
    {
        return OWN_Y ? reinterpret_cast<float*>(this + 1)
                     : reinterpret_cast<float*>(&ops[buf]);
    }
};

// a warp's part of the intra-chunk term: row block r (r < 0: none),
// column blocks kb0..kb1 - 1 of it, and how its partial y meets the other
// part of the same rows: mode 0 alone, 1 stored first (then it arrives at
// named barrier `bar`), 2 added to the first (after waiting there)
struct IntraJob {
    int r, kb0, kb1, mode, bar;
};

struct IntraJobs {
    IntraJob job[WARPS];
};

// the largest part, in 16x16 blocks: the least m for which the R row
// blocks (row block r has the r + 1 blocks on and below the diagonal),
// each cut into at most two parts of at most m blocks, make at most WARPS
// parts.  R <= WARPS.
__host__ __device__ constexpr int part_blocks(int R)
{
    for (int m = (R + 1) / 2;; ++m) {
        int parts = 0;
        for (int r = 0; r < R; ++r) parts += r + 1 > m ? 2 : 1;
        if (parts <= WARPS) return m;
    }
}

// The warps' parts for R row blocks.  Each row block is cut into at most
// two parts of at most part_blocks(R) blocks (the first part the larger);
// the parts, largest first (ties in order of row block, the last first),
// go to warp schedulers (warp w runs on scheduler w % 4) one round of
// four at a time, every other round in reverse, so each scheduler's two
// parts add up to about the same.  A warp has at most one part, whose
// partial y it can hold in registers.  The last slot, DECAY_WARP's, gets
// the smallest part or none.  At R = 4 (mamba2-130m): 6 parts of 2, 2, 2,
// 2, 1, 1 blocks, two split row blocks, DECAY_WARP and warp 5 without a
// part; at R = 8 (zamba2-2.7b): the 8 row blocks whole, 9 blocks a
// scheduler.
__host__ __device__ constexpr IntraJobs intra_jobs(int R)
{
    const int m = part_blocks(R);
    IntraJob part[WARPS] = {};
    int n = 0, bar = 0;
    for (int r = R - 1; r >= 0; --r) {
        if (r + 1 > m) {
            ++bar;
            part[n++] = {r, 0, m, 1, bar};
            part[n++] = {r, m, r + 1, 2, bar};
        } else {
            part[n++] = {r, 0, r + 1, 0, 0};
        }
    }
    for (int i = 1; i < n; ++i) {           // stable, largest first
        const IntraJob t = part[i];
        int j = i;
        for (; j > 0 && part[j - 1].kb1 - part[j - 1].kb0 < t.kb1 - t.kb0;
             --j)
            part[j] = part[j - 1];
        part[j] = t;
    }
    IntraJobs out = {};
    for (int w = 0; w < WARPS; ++w) out.job[w] = {-1, 0, 0, 0, 0};
    for (int i = 0; i < n; ++i) {
        const int round = i / 4, k = i % 4;
        out.job[(round % 2 ? 3 - k : k) + 4 * round] = part[i];
    }
    return out;
}

// every block on and below the diagonal in exactly one part, none above,
// no named barrier past 15
__host__ __device__ constexpr bool jobs_cover(int R)
{
    const IntraJobs t = intra_jobs(R);
    for (int r = 0; r < R; ++r)
        for (int kb = 0; kb < R; ++kb) {
            int times = 0;
            for (int w = 0; w < WARPS; ++w)
                times += t.job[w].r == r && t.job[w].kb0 <= kb
                         && kb < t.job[w].kb1;
            if (times != (kb <= r ? 1 : 0)) return false;
        }
    for (int w = 0; w < WARPS; ++w)
        if (t.job[w].bar > 15) return false;
    return true;
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

template <int N, int P, int Q, class TO>
__global__ void __launch_bounds__(tc::THREADS, 2)
ssd_scan_tc_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ Bm,
                   const __nv_bfloat16* __restrict__ Cm, TO* __restrict__ y,
                   const ScanArgs a)
{
    using namespace tc;
    using Sm = Smem<N, P, Q>;
    constexpr int XLD = Sm::XLD, BLD = Sm::BLD, YLD = Sm::YLD;
    constexpr int R = Q / 16;                    // row blocks of a chunk
    // the update's k in KH parts: the split sd o x of one part in registers
    constexpr int KH = R > 4 ? 2 : 1, KQ = R / KH;
    static_assert(P == 8 * WARPS, "a warp owns 8 columns of the state");
    static_assert(N % 64 == 0, "the update takes 4 row blocks at a time");
    static_assert(Q % 32 == 0 && KQ % 2 == 0 && R <= WARPS,
                  "32 steps a decay lane's turn and an ldmatrix of x");
    static_assert(jobs_cover(R), "the intra-chunk parts cover the blocks");
    constexpr IntraJobs jobs = intra_jobs(R);

    extern __shared__ __align__(16) unsigned char smem_raw[];
    Sm& sm = *reinterpret_cast<Sm*>(smem_raw);
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
        typename Sm::Ops& o = sm.ops[c & 1];
        const long long s0 = (long long)b * S + (long long)c * Q;
        for (int i = threadIdx.x; i < Q * (P / 8); i += THREADS) {
            const int q = i / (P / 8), k = 8 * (i % (P / 8));
            cp_async16(&o.x[q * XLD + k], x + ((s0 + q) * H + h) * P + k);
        }
        for (int i = threadIdx.x; i < Q * (N / 8); i += THREADS) {
            const int q = i / (N / 8), k = 8 * (i % (N / 8));
            const long long gi = ((s0 + q) * G + grp) * N + k;
            cp_async16(&o.B[q * BLD + k], Bm + gi);
            cp_async16(&o.C[q * BLD + k], Cm + gi);
        }
        cp_async_commit();
    };
    // the decay warp: dt of chunk c's steps lane + 32 j
    auto load_dt = [&](int c, float (&d)[Q / 32]) {
        const long long s0 = (long long)b * S + (long long)c * Q;
#pragma unroll
        for (int j = 0; j < Q / 32; ++j)
            d[j] = a.dt[(s0 + lane + 32 * j) * H + h];
    };
    // ... and chunk c's scalars into buffer c & 1: the log-decay summed in
    // order by one lane, exp(Lc) and exp(Lc_Q - Lc) dt
    auto decay = [&](int c, const float (&d)[Q / 32]) {
        const int buf = c & 1;
        float* dts = sm.dt[buf];
        float* Lc = sm.Lc[buf];
#pragma unroll
        for (int j = 0; j < Q / 32; ++j) dts[lane + 32 * j] = d[j];
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
    float dnext[Q / 32];
    if (warp == DECAY_WARP) {
        float d0[Q / 32];
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
        const __nv_bfloat16* xs = sm.ops[buf].x;
        const __nv_bfloat16* Bs = sm.ops[buf].B;
        const __nv_bfloat16* Cs = sm.ops[buf].C;
        const float* dts = sm.dt[buf];
        const float* Lc = sm.Lc[buf];
        const float* eLc = sm.eLc[buf];
        const float* sd = sm.sd[buf];
        float* ys = sm.y(buf);
        // this warp's part of the intra-chunk term (picked here, not held
        // in registers across the chunk loop)
        IntraJob job = {-1, 0, 0, 0, 0};
#pragma unroll
        for (int w = 0; w < WARPS; ++w)
            if (w == warp) job = jobs.job[w];

        // the intra-chunk term of row block r: y_r = sum over column
        // blocks kb <= r of M[r, kb] x[kb], this warp's kb0..kb1 - 1
        float yi[P / 8][4];
        auto intra = [&]() {
            const int r = job.r;
#pragma unroll
            for (int n = 0; n < P / 8; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) yi[n][e] = 0.f;
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
        };
        // ... into the shared y, the parts of a split row block in order
        auto put_intra = [&]() {
            float* yr = ys + (16 * job.r + fg) * YLD + 2 * ft;
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
        };
        const bool has_part = job.r >= 0;
        if constexpr (Sm::OWN_Y) {
            if (has_part) {
                intra();
                put_intra();
            }
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

        // h = exp(Lc_Q) h + B^T (sd o x), the k (steps) in KH parts: the B
        // operand sd o x of this warp's columns, split; A = B^T from B's
        // rows, transposed
        const float eLQ = eLc[Q - 1];
#pragma unroll
        for (int kh = 0; kh < KH; ++kh) {
            Split xb[KQ][2];
#pragma unroll
            for (int k2 = 0; k2 < KQ / 2; ++k2) {
                const int q0 = 16 * KQ * kh + 32 * k2;
                unsigned r4[4];
                ldsm_t(r4, xs + (q0 + lane) * XLD + p0);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int q = q0 + 8 * j + 2 * ft;
                    const float2 v = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(&r4[j]));
                    xb[2 * k2 + (j >> 1)][j & 1] = split(sd[q] * v.x,
                                                         sd[q + 1] * v.y);
                }
            }
            // four row blocks of the state at a time: four independent
            // accumulator chains in flight
#pragma unroll
            for (int i0 = 0; i0 < N / 16; i0 += 4) {
                float acc[4][4] = {};
#pragma unroll
                for (int kq = 0; kq < KQ; ++kq)
#pragma unroll
                    for (int ii = 0; ii < 4; ++ii) {
                        unsigned af[4];
                        ldsm_t(af, Bs + (16 * (KQ * kh + kq) + (lane & 7)
                                         + (lane >> 4) * 8) * BLD
                                        + 16 * (i0 + ii)
                                        + ((lane >> 3) & 1) * 8);
                        mma3(acc[ii], af, xb[kq][0], xb[kq][1]);
                    }
#pragma unroll
                for (int ii = 0; ii < 4; ++ii)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        st[i0 + ii][e] = (kh == 0 ? eLQ * st[i0 + ii][e]
                                                  : st[i0 + ii][e])
                                         + acc[ii][e];
            }
        }

        if constexpr (!Sm::OWN_Y) {
            if (has_part) intra();
        }
        if (warp == DECAY_WARP && c + 1 < nc) {
            decay(c + 1, dnext);
            if (c + 2 < nc) load_dt(c + 2, dnext);
        }
        __syncthreads();              // OWN_Y: the intra-chunk y is in;
                                      // else this chunk's x, B, C are read
        if constexpr (!Sm::OWN_Y) {
            if (has_part) put_intra();
            __syncthreads();          // the intra-chunk y is in
        }

        // y = M x + exp(Lc) o (C h), this warp's columns
#pragma unroll
        for (int r = 0; r < Q / 16; ++r)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int q = 16 * r + fg + 8 * hh;
                const float2 yv = *reinterpret_cast<const float2*>(
                    ys + q * YLD + p0 + 2 * ft);
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

template <int N_, int P_, int Q_>
struct TcShape {
    static constexpr int N = N_, P = P_, Q = Q_;
};

// f(TcShape<N, P, Q>{}) at a shape the tensor-core schedule is
// instantiated at, mamba2-130m's heads and zamba2-2.7b's; false, f not
// called, at any other shape
template <class F>
static bool with_tc_shape(int n, int p, int q, F f)
{
    if (n == 128 && p == 64 && q == 64) f(TcShape<128, 64, 64>{});
    else if (n == 64 && p == 64 && q == 128) f(TcShape<64, 64, 128>{});
    else return false;
    return true;
}

// bytes of dynamic shared memory a block of `schedule` takes; 0 for the
// tensor cores at a shape they do not take
static long long smem_bytes(int N, int P, int Q, int schedule)
{
    if (schedule != TENSOR_CORES)
        return smem_floats(N, P, Q) * (long long)sizeof(float);
    long long bytes = 0;
    with_tc_shape(N, P, Q, [&](auto s) {
        using Sh = decltype(s);
        bytes = tc::Smem<Sh::N, Sh::P, Sh::Q>::BYTES;
    });
    return bytes;
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

// the shared memory a tensor-core kernel takes, and all of the SM's as
// shared memory, so two blocks fit
template <class K>
static cudaError_t set_smem_tc(int device, K kernel, long long bytes)
{
    cudaError_t e = set_smem(device, kernel, bytes);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
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
    typedef __nv_bfloat16 bf;
    cudaError_t e = cudaErrorInvalidValue;
    with_tc_shape(a.N, a.P, a.Q, [&](auto s) {
        using Sh = decltype(s);
        auto kernel = ssd_scan_tc_kernel<Sh::N, Sh::P, Sh::Q, TO>;
        const int bytes = tc::Smem<Sh::N, Sh::P, Sh::Q>::BYTES;
        e = set_smem_tc(device, kernel, bytes);
        if (e != cudaSuccess) return;
        kernel<<<dim3(a.H, batch), tc::THREADS, (size_t)bytes,
                 (cudaStream_t)stream>>>(
            (const bf*)x, (const bf*)Bm, (const bf*)Cm, (TO*)y, a);
        e = cudaGetLastError();
    });
    return (int)e;
}

static bool schedule_ok(int schedule, int in_bf16, int N, int P, int Q)
{
    if (schedule == TENSOR_CORES)
        return in_bf16 && with_tc_shape(N, P, Q, [](auto) {});
    return schedule == FLOAT32_CORES;
}

// Returns 0, or the cudaError_t value of what went wrong (a refused launch
// included).  in_bf16 / out_bf16 select the types of x, B, C and of y;
// schedule is 0 (float32 cores, any shape) or 1 (tensor cores: bf16
// inputs at (N, P, Q) = (128, 64, 64) or (64, 64, 128) only), as the host
// picks it.
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

// dynamic shared memory one block of `schedule` needs, in bytes (0: the
// tensor cores do not take this shape)
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
        e = cudaErrorInvalidValue;
        with_tc_shape(N, P, Q, [&](auto s) {
            using Sh = decltype(s);
            auto kernel = ssd_scan_tc_kernel<Sh::N, Sh::P, Sh::Q, float>;
            e = set_smem_tc(device, kernel, bytes);
            if (e == cudaSuccess)
                e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, kernel, tc::THREADS, (size_t)bytes);
        });
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

// the tensor-core schedule's intra-chunk parts at chunk Q: five ints a
// warp (r, kb0, kb1, mode, bar) into out[5 * WARPS]; returns the number of
// warps, or -1 where Q / 16 row blocks are more than the warps
extern "C" int repro_ssd_intra_jobs(int Q, int* out)
{
    if (Q < 16 || Q % 16 || Q / 16 > tc::WARPS) return -1;
    const tc::IntraJobs t = tc::intra_jobs(Q / 16);
    for (int w = 0; w < tc::WARPS; ++w) {
        const tc::IntraJob& j = t.job[w];
        const int v[5] = {j.r, j.kb0, j.kb1, j.mode, j.bar};
        for (int i = 0; i < 5; ++i) out[5 * w + i] = v[i];
    }
    return tc::WARPS;
}

extern "C" const char* repro_cuda_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}
