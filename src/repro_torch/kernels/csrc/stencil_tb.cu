// Temporally-blocked acoustic time tile for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_tb_kernel` of
// src/repro/kernels/stencil_tb.py (launched by `tb_time_tile`), for the
// acoustic physics in float32.  One launch advances the whole grid by one
// depth-T time tile:
//
//   for each (x, y) tile — one thread block, z kept whole:
//     T times:  u_next = (dt^2 lap(u) + m (2u - u_prev) + damp dt u)
//                        / (m + damp dt)           over the whole window,
//               u_next = 0 outside the physical x/y domain,
//               u_next[src slot] += src value      (grid-aligned injection),
//               rec[tile, k, slot] = w * u_next[rec slot],
//               (u_prev, u) <- (u, u_next)
//     write back the tile's centre of u_prev and u.
//
// The window is the tile plus a halo of H = T * order/2 points in x and y;
// reads beyond the window in x/y and beyond [0, nz) in z are zero, as in
// the reference's zero-padded `apply_axis_stencil`.  FD coefficients come
// from the host, computed in float64 and rounded to float32, and the
// Laplacian sums x taps, then y, then z, each in tap order, as the
// reference does (a zero weight would add an exact zero; the central
// second-derivative weights have none).
//
// What bounds it: bytes.  The least traffic for one call is each padded
// input read once and each output written once (4 fields in, 2 out); the
// arithmetic is ~36 flops per point-step, far under the card's float32
// rate.  This first design is right and simple, not fast: a 48x48x512
// float32 window (tile 32, T=4, order 4) is 4.7 MB per field, twenty times
// a block's shared memory, so the in-window steps ping-pong through a
// per-block scratch in device memory (two window buffers, the step's
// u_next overwriting u_prev in place, which it reads only pointwise) and
// every step re-reads u, u_prev, m and damp from device memory.  So a step
// moves the bytes of a spatially-blocked step times the window's overhang
// ((tile + 2H)^2 / tile^2), not a T-th of them: temporal blocking saves no
// traffic in this design.  Two cheap measures keep the loads flowing: the
// radius is a template parameter, so the tap loops unroll and a point's
// loads are all in flight at once, and each warp takes a 32-deep z chunk
// of one column, all columns of a chunk before the next, so the window
// rows the x taps read stay in L1.  Left on the table for later work:
// streaming z through shared memory (a few planes per field resident), TMA
// loads, and shrinking the computed region by order/2 per step (the
// trapezoid) — see PERF.md for what each version measured.
//
// The sparse terms are indexed adds and reads driven by the per-tile
// tables: the TPU's one-hot point masks exist only for its vector unit.
// Within one tile the source slots are distinct grid points, so one thread
// per slot needs no atomics; padding slots (value 0) are skipped, and a
// slot outside the window matches no point, as the one-hot mask does.

#include <cuda_runtime.h>

#define MAX_RADIUS 8       // space orders 2..16
#define THREADS 512

struct Coefs {
    // w_q * h**-2 per axis (x, y, z), taps q = 0..2R at offsets q - R,
    // rounded to float32 on the host
    float c[3][2 * MAX_RADIUS + 1];
};

struct TileArgs {
    const float* u0_pad;      // u_prev, (nx + 2H, ny + 2H, nz), zero-padded
    const float* u1_pad;      // u
    const float* m_pad;       // edge-padded params
    const float* damp_pad;
    const int* src_coords;    // (ntiles, src_cap, 3) window-local
    const float* src_vals;    // (ntiles, T, src_cap)
    const int* rec_coords;    // (ntiles, rec_cap, 3)
    const float* rec_w;       // (ntiles, rec_cap)
    float* out_u0;            // (nx, ny, nz)
    float* out_u1;
    float* rec_out;           // (ntiles, T, rec_cap), zeroed by the caller
    float* scratch;           // (ntiles, 2, wx * wy * nz)
    int nx, ny, nz, tx, ty, T, H, src_cap, rec_cap;
    float dt, dt2;
};

// R = order / 2 is a compile-time constant so the tap loops unroll and
// all 3 (2R + 1) loads of a point can be in flight at once.
template <int R>
__global__ void __launch_bounds__(THREADS)
tb_acoustic_kernel(const TileArgs a, const Coefs cf)
{
    const int ti = blockIdx.x, tj = blockIdx.y;
    const int tile = ti * gridDim.y + tj;
    const int nz = a.nz, H = a.H;
    const int wx = a.tx + 2 * H, wy = a.ty + 2 * H;
    const int ncol = wx * wy, nzc = (nz + 31) / 32;
    const long long npts = (long long)ncol * nz;
    const long long pad_sx = (long long)(a.ny + 2 * H) * nz;
    const long long win_sx = (long long)wy * nz;
    const long long org = (long long)ti * a.tx * pad_sx + (long long)tj * a.ty * nz;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;

    float* buf[2] = {a.scratch + (long long)tile * 2 * npts,
                     a.scratch + ((long long)tile * 2 + 1) * npts};
    const float* m = a.m_pad + org;
    const float* damp = a.damp_pad + org;
    // (pointer, x-stride) views; the y-stride is nz and the z-stride 1 in
    // both the padded inputs and the scratch windows
    const float* prev = a.u0_pad + org;
    long long prev_sx = pad_sx;
    const float* cur = a.u1_pad + org;
    long long cur_sx = pad_sx;

    for (int k = 0; k < a.T; ++k) {
        float* nxt = buf[k & 1];
        // one warp per (32-deep z chunk, (x, y) column) item, lanes along
        // z, all columns of a chunk before the next chunk: the window rows
        // the x taps read (5 x wy x 128 B at order 4) then stay in L1
        for (int item = warp; item < ncol * nzc; item += nwarps) {
            const int zc = item / ncol, col = item - zc * ncol;
            const int iz = zc * 32 + lane;
            if (iz >= nz) continue;
            const int ix = col / wy, iy = col - ix * wy;
            const int gx = ti * a.tx - H + ix, gy = tj * a.ty - H + iy;
            float* out = nxt + (long long)ix * win_sx + (long long)iy * nz;
            if (gx < 0 || gx >= a.nx || gy < 0 || gy >= a.ny) {
                out[iz] = 0.f;
                continue;
            }
            const float* c0 = cur + (long long)ix * cur_sx + (long long)iy * nz;
            const float u = c0[iz];
            float lx = 0.f, ly = 0.f, lz = 0.f;
#pragma unroll
            for (int q = 0; q <= 2 * R; ++q) {
                const int xx = ix + q - R;
                const float v = (xx >= 0 && xx < wx)
                    ? c0[(q - R) * cur_sx + iz] : 0.f;
                lx += v * cf.c[0][q];
            }
#pragma unroll
            for (int q = 0; q <= 2 * R; ++q) {
                const int yy = iy + q - R;
                const float v = (yy >= 0 && yy < wy)
                    ? c0[(long long)(q - R) * nz + iz] : 0.f;
                ly += v * cf.c[1][q];
            }
#pragma unroll
            for (int q = 0; q <= 2 * R; ++q) {
                const int zz = iz + q - R;
                const float v = (zz >= 0 && zz < nz) ? c0[zz] : 0.f;
                lz += v * cf.c[2][q];
            }
            const float lap = (lx + ly) + lz;
            const long long pi = (long long)ix * pad_sx + (long long)iy * nz + iz;
            const float mm = __ldg(m + pi), dd = __ldg(damp + pi);
            const float up = prev[(long long)ix * prev_sx + (long long)iy * nz + iz];
            const float num = a.dt2 * lap + mm * (2.f * u - up) + dd * a.dt * u;
            out[iz] = num / (mm + dd * a.dt);
        }
        __syncthreads();

        for (int p = threadIdx.x; p < a.src_cap; p += blockDim.x) {
            const float v = a.src_vals[((long long)tile * a.T + k) * a.src_cap + p];
            const int* c = a.src_coords + ((long long)tile * a.src_cap + p) * 3;
            if (v != 0.f && c[0] >= 0 && c[0] < wx && c[1] >= 0 && c[1] < wy
                && c[2] >= 0 && c[2] < nz)
                nxt[(long long)c[0] * win_sx + (long long)c[1] * nz + c[2]] += v;
        }
        __syncthreads();

        for (int p = threadIdx.x; p < a.rec_cap; p += blockDim.x) {
            const int* c = a.rec_coords + ((long long)tile * a.rec_cap + p) * 3;
            float s = 0.f;
            if (c[0] >= 0 && c[0] < wx && c[1] >= 0 && c[1] < wy
                && c[2] >= 0 && c[2] < nz)
                s = a.rec_w[(long long)tile * a.rec_cap + p]
                    * nxt[(long long)c[0] * win_sx + (long long)c[1] * nz + c[2]];
            a.rec_out[((long long)tile * a.T + k) * a.rec_cap + p] = s;
        }
        // step k+1 writes buf[(k+1) & 1], which holds this step's u (its
        // u_prev): read pointwise only, by the thread that overwrites it
        prev = cur;
        prev_sx = cur_sx;
        cur = nxt;
        cur_sx = win_sx;
    }

    // write back the valid centre of both state fields
    const int ccol = a.tx * a.ty;
    for (int col = warp; col < ccol; col += nwarps) {
        const int lx = col / a.ty, ly = col - (col / a.ty) * a.ty;
        const long long dst = ((long long)(ti * a.tx + lx) * a.ny
                               + (tj * a.ty + ly)) * nz;
        const long long sp = (long long)(lx + H) * prev_sx + (long long)(ly + H) * nz;
        const long long sc = (long long)(lx + H) * cur_sx + (long long)(ly + H) * nz;
        for (int iz = lane; iz < nz; iz += 32) {
            a.out_u0[dst + iz] = prev[sp + iz];
            a.out_u1[dst + iz] = cur[sc + iz];
        }
    }
}

template <int R>
static void launch(dim3 grid, cudaStream_t stream, const TileArgs& a,
                   const Coefs& cf)
{
    tb_acoustic_kernel<R><<<grid, THREADS, 0, stream>>>(a, cf);
}

extern "C" int repro_tb_acoustic_tile(
    int device,
    const float* u0_pad, const float* u1_pad, const float* m_pad,
    const float* damp_pad, const int* src_coords, const float* src_vals,
    const int* rec_coords, const float* rec_w, float* out_u0, float* out_u1,
    float* rec_out, float* scratch,
    int nx, int ny, int nz, int tx, int ty, int T, int H, int src_cap,
    int rec_cap, int radius, const float* coefs, float dt, float dt2,
    void* stream)
{
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (tx <= 0 || ty <= 0 || nx % tx || ny % ty || T < 1 || nz < 1
        || radius < 1 || radius > MAX_RADIUS)
        return (int)cudaErrorInvalidValue;
    Coefs cf = {};
    for (int ax = 0; ax < 3; ++ax)
        for (int q = 0; q <= 2 * radius; ++q)
            cf.c[ax][q] = coefs[ax * (2 * radius + 1) + q];
    TileArgs args = {u0_pad, u1_pad, m_pad, damp_pad, src_coords, src_vals,
                     rec_coords, rec_w, out_u0, out_u1, rec_out, scratch,
                     nx, ny, nz, tx, ty, T, H, src_cap, rec_cap, dt, dt2};
    dim3 grid(nx / tx, ny / ty);
    cudaStream_t s = (cudaStream_t)stream;
    switch (radius) {
        case 1: launch<1>(grid, s, args, cf); break;
        case 2: launch<2>(grid, s, args, cf); break;
        case 3: launch<3>(grid, s, args, cf); break;
        case 4: launch<4>(grid, s, args, cf); break;
        case 5: launch<5>(grid, s, args, cf); break;
        case 6: launch<6>(grid, s, args, cf); break;
        case 7: launch<7>(grid, s, args, cf); break;
        case 8: launch<8>(grid, s, args, cf); break;
    }
    return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}

extern "C" int repro_max_radius(void) { return MAX_RADIUS; }
