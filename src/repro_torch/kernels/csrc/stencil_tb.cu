// Temporally-blocked acoustic time tile for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_tb_kernel` of
// src/repro/kernels/stencil_tb.py (launched by `tb_time_tile`), for the
// acoustic physics in float32 and, as B1a-bf16, in bf16: the kernel is a
// template on the storage type S of fields, tables, partials and scratch
// (bf16 values read with __bfloat162float, each step computed in float32
// and stored with __float2bfloat16), with a C entry point per type.  The
// bf16 entry takes no domain mask: the sharded path (B1c) stays float32.  The schedule shared with the TTI and
// elastic kernels is described in tb_common.cuh.  Per (x, y) tile:
//
//   T times:  u_next = (dt^2 lap(u) + m (2u - u_prev) + damp dt u)
//                      / (m + damp dt)           over the whole window,
//             u_next = 0 outside the physical x/y domain,
//             u_next[src slot] += src value      (grid-aligned injection),
//             rec[tile, k, slot] = w * u_next[rec slot],
//             (u_prev, u) <- (u, u_next)
//   write back the tile's centre of u_prev and u.
//
// The Laplacian sums x taps, then y, then z, each in tap order, as the
// reference does (the central second-derivative weights have no zero).
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
// loads are all in flight at once, and the z-chunked work order keeps the
// rows the x taps read in L1.  Left on the table for later work: streaming
// z through shared memory (a few planes per field resident), TMA loads,
// and shrinking the computed region by order/2 per step (the trapezoid) —
// see PERF.md for what each version measured.

#include "tb_common.cuh"

template <int R, bool DOM, class S>
__global__ void __launch_bounds__(THREADS)
tb_acoustic_kernel(const TileArgsT<S> a, const Coefs cf)
{
    const TileT<S> t(a);
    S* buf[2] = {t.scratch(a, 0, 2), t.scratch(a, 1, 2)};
    const S* m = t.input(a, 2).p;
    const S* damp = t.input(a, 3).p;
    ViewT<S> prev = t.input(a, 0), cur = t.input(a, 1);
    const int nz = a.nz, wx = t.wx, wy = t.wy;
    const int ncol = wx * wy, nzc = (nz + 31) / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;

    for (int k = 0; k < a.T; ++k) {
        S* nxt = buf[k & 1];
        // Tile::for_each_point's work order, written out with the taps
        // addressed from the column start: on the 512^3 case this loop
        // measured 16.2 ms a depth-4 launch, the same body through the
        // shared Tile::for_each_point / Tile::taps helpers 18.4 ms (PERF.md)
        for (int item = warp; item < ncol * nzc; item += nwarps) {
            const int zc = item / ncol, col = item - zc * ncol;
            const int iz = zc * 32 + lane;
            if (iz >= nz) continue;
            const int ix = col / wy, iy = col - ix * wy;
            S* out = nxt + (long long)ix * t.win_sx + (long long)iy * nz;
            if (!t.template in_domain<DOM>({ix, iy, iz})) {
                out[iz] = from_f<S>(0.f);
                continue;
            }
            const S* c0 = cur.p + (long long)ix * cur.sx + (long long)iy * nz;
            const float u = to_f(c0[iz]);
            float lx = 0.f, ly = 0.f, lz = 0.f;
#pragma unroll
            for (int q = 0; q <= 2 * R; ++q) {
                const int xx = ix + q - R;
                const float v = (xx >= 0 && xx < wx) ? to_f(c0[(q - R) * cur.sx + iz]) : 0.f;
                lx += v * cf.c[0][q];
            }
#pragma unroll
            for (int q = 0; q <= 2 * R; ++q) {
                const int yy = iy + q - R;
                const float v = (yy >= 0 && yy < wy) ? to_f(c0[(long long)(q - R) * nz + iz]) : 0.f;
                ly += v * cf.c[1][q];
            }
#pragma unroll
            for (int q = 0; q <= 2 * R; ++q) {
                const int zz = iz + q - R;
                const float v = (zz >= 0 && zz < nz) ? to_f(c0[zz]) : 0.f;
                lz += v * cf.c[2][q];
            }
            const float lap = (lx + ly) + lz;
            const long long pi = (long long)ix * t.pad_sx + (long long)iy * nz + iz;
            const float mm = to_f(__ldg(m + pi)), dd = to_f(__ldg(damp + pi));
            const float up = to_f(prev.p[(long long)ix * prev.sx + (long long)iy * nz + iz]);
            const float num = a.dt2 * lap + mm * (2.f * u - up) + dd * a.dt * u;
            out[iz] = from_f<S>(num / (mm + dd * a.dt));
        }
        __syncthreads();
        S* const inj[1] = {nxt};
        t.inject(a, k, inj);
        __syncthreads();
        t.template record<1>(a, k, [&](long long w, float* s) { s[0] = to_f(nxt[w]); });
        // step k+1 writes buf[(k+1) & 1], which holds this step's u (its
        // u_prev): read pointwise only, by the thread that overwrites it
        prev = cur;
        cur = t.window(nxt);
    }
    const ViewT<S> fin[2] = {prev, cur};
    t.template write_back<2>(a, fin);
}

// fills the arguments and launches the instantiation of `radius` (and of
// whether `dom` is given, where DOM_OK)
template <class S, bool DOM_OK>
static int launch(int device, const S* const* in, const int* src_coords,
                  const S* src_vals, const int* rec_coords, const S* rec_w,
                  S* const* out, S* rec_out, S* scratch, const float* dom,
                  int param_rows, int nshots, int nx, int ny, int nz, int tx,
                  int ty, int T, int H, int src_cap, int rec_cap, int radius,
                  const float* coefs, float dt, float dt2, void* stream)
{
    TileArgsT<S> a;
    Coefs cf;
    const int e = tile_args(&a, &cf, device, 4, 2, in, src_coords,
                            src_vals, rec_coords, rec_w, out, rec_out,
                            scratch, dom, param_rows, nshots, nx, ny, nz,
                            tx, ty, T, H, src_cap, rec_cap, radius, coefs,
                            2 * radius + 1, dt, dt2);
    if (e) return e;
    with_radius(radius, dom != nullptr, [&](auto r, auto d) {
        if constexpr (DOM_OK || !decltype(d)::value)
            tb_acoustic_kernel<decltype(r)::value, decltype(d)::value, S>
                <<<tile_grid(a), THREADS, 0, (cudaStream_t)stream>>>(a, cf);
    });
    return (int)cudaGetLastError();
}

extern "C" int repro_tb_tile(
    int device, const float* const* in, const int* src_coords,
    const float* src_vals, const int* rec_coords, const float* rec_w,
    float* const* out, float* rec_out, float* scratch, const float* dom,
    int param_rows, int nshots, int nx, int ny, int nz, int tx, int ty, int T,
    int H, int src_cap, int rec_cap, int radius, const float* coefs, float dt,
    float dt2, void* stream)
{
    return launch<float, true>(device, in, src_coords, src_vals, rec_coords,
                               rec_w, out, rec_out, scratch, dom, param_rows,
                               nshots, nx, ny, nz, tx, ty, T, H, src_cap,
                               rec_cap, radius, coefs, dt, dt2, stream);
}

// B1a-bf16: fields, params, source values, receiver weights, partials and
// scratch in bf16; no domain mask (a non-null `dom` is refused)
extern "C" int repro_tb_tile_bf16(
    int device, const __nv_bfloat16* const* in, const int* src_coords,
    const __nv_bfloat16* src_vals, const int* rec_coords,
    const __nv_bfloat16* rec_w, __nv_bfloat16* const* out,
    __nv_bfloat16* rec_out, __nv_bfloat16* scratch, const float* dom,
    int param_rows, int nshots, int nx, int ny, int nz, int tx, int ty, int T,
    int H, int src_cap, int rec_cap, int radius, const float* coefs, float dt,
    float dt2, void* stream)
{
    if (dom != nullptr) return (int)cudaErrorInvalidValue;
    return launch<__nv_bfloat16, false>(
        device, in, src_coords, src_vals, rec_coords, rec_w, out, rec_out,
        scratch, dom, param_rows, nshots, nx, ny, nz, tx, ty, T, H, src_cap,
        rec_cap, radius, coefs, dt, dt2, stream);
}
