// Mamba2 SSD chunked scan for NVIDIA Hopper (sm_90a): kernel B2.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` of
// src/repro/kernels/ssd_scan.py:49 (launched by `ssd_scan`).  Per (batch,
// head), over chunks of Q steps of the recurrence
//     h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,    y_t = C_t . h_t
// with the (N, P) state h resident in shared memory for the whole sequence
// (the paper's temporal-blocking schedule on a 1-D linear recurrence: only
// the state crosses chunk boundaries, and it reaches device memory once, as
// h_final).  Per chunk, in float32:
//     Lc = cumsum(dt A)                         (Q)     inclusive
//     M  = (C B^T) o exp(Lc_i - Lc_j) o dt_j    (Q, Q)  causal, 0 above
//     y  = M x + exp(Lc) o (C h)                (Q, P)  written as TO
//     h  = exp(Lc_Q) h + (B o exp(Lc_Q - Lc) dt)^T x   (N, P)
// x, B and C are float32 or bf16 (TI), loaded with __bfloat162float; dt, A,
// h0 and h_final are float32; y is float32 or bf16 (TO).  h0 may be null
// (zeros).  B and C are those of the head's group, h / (H / G).
//
// Layout: one thread block per (batch, head), as the TPU grid; blocks run
// in no order, so the chunk loop runs inside the block.  Shared memory
// holds the state, one chunk of x, B, C, M and the per-step scalars: at
// mamba2-130m's Q = 64, N = 128, P = 64 that is 132,608 bytes (dynamic
// shared memory above 48 KB, set with cudaFuncSetAttribute), so one block
// an SM.  B and C rows have an odd stride, so a warp reading a column of
// them hits 32 banks.  The four products are one block-wide routine: a
// warp owns 8 rows (a broadcast read each) and its lanes 2 columns 32
// apart (consecutive addresses), 16 fused multiply-adds per 10 shared
// loads; the causal zeros of M are computed and discarded (work the bound
// below does not count).
//
// What bounds it on this card: operations.  At the serve phase's shapes
// (B 8, S 1024, H 24, G 1, N 128, P 64, Q 64) the reference's count is
// 11.3 GFLOP with the full Q x Q products; the function needs 8.93 GFLOP
// (`kernel_cost`'s needed_flops: the causal halves of C B^T and M x):
// 0.133 ms at 67 TFLOP/s float32 outside the tensor cores (0.018 ms at
// TF32's 495), against ~0.03 ms for its ~90 MB of inputs and outputs at
// 3.35 TB/s.  This first design is simple, not fast: it runs on the
// float32 cores, its shared-memory loads outnumber the multiply-adds'
// share of issue slots, and 192 blocks of one per SM make 1.5 waves on 132
// SMs.  Later work: tensor cores (mma.sync / wgmma on bf16 or TF32
// operands), TMA loads of the next chunk while this one computes, and more
// than one block per (b, h) — a chunk-parallel first pass for the chunk
// states and an inter-chunk scan — so short batches fill the card.

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

template <class TI, class TO>
static int launch(int device, const void* x, const void* Bm, const void* Cm,
                  void* y, const ScanArgs& a, int batch, void* stream)
{
    const long long bytes = smem_floats(a.N, a.P, a.Q) * (long long)sizeof(float);
    int optin = 0;
    cudaError_t e = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e != cudaSuccess) return (int)e;
    if (bytes > optin) return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(ssd_scan_kernel<TI, TO>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    ssd_scan_kernel<TI, TO><<<dim3(a.H, batch), SSD_THREADS, (size_t)bytes,
                              (cudaStream_t)stream>>>(
        (const TI*)x, (const TI*)Bm, (const TI*)Cm, (TO*)y, a);
    return (int)cudaGetLastError();
}

// Returns 0, or the cudaError_t value of what went wrong (a refused launch
// included).  in_bf16 / out_bf16 select the types of x, B, C and of y.
extern "C" int repro_ssd_scan(int device, const void* x, const float* dt,
                              const void* Bm, const void* Cm, const float* A,
                              const float* h0, void* y, float* h_final,
                              int in_bf16, int out_bf16, int batch, int S,
                              int H, int G, int N, int P, int Q, void* stream)
{
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (batch < 1 || batch > 65535 || H < 1 || G < 1 || H % G || N < 1
        || P < 1 || Q < 1 || S < Q || S % Q)
        return (int)cudaErrorInvalidValue;
    const ScanArgs a{dt, A, h0, h_final, S, H, G, N, P, Q};
    typedef __nv_bfloat16 bf;
    if (in_bf16)
        return out_bf16 ? launch<bf, bf>(device, x, Bm, Cm, y, a, batch, stream)
                        : launch<bf, float>(device, x, Bm, Cm, y, a, batch, stream);
    return out_bf16 ? launch<float, bf>(device, x, Bm, Cm, y, a, batch, stream)
                    : launch<float, float>(device, x, Bm, Cm, y, a, batch, stream);
}

// dynamic shared memory one block needs, in bytes
extern "C" long long repro_ssd_smem_bytes(int N, int P, int Q)
{
    return smem_floats(N, P, Q) * (long long)sizeof(float);
}

extern "C" const char* repro_cuda_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}
