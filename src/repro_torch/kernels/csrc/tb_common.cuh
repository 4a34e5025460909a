// Pieces shared by the temporally-blocked time-tile kernels for Hopper
// (stencil_tb.cu: acoustic, stencil_tb_tti.cu: TTI, stencil_tb_elastic.cu:
// elastic), which replace the Pallas TPU kernel `_tb_kernel` of
// src/repro/kernels/stencil_tb.py for each physics it runs.
//
// One launch advances the whole grid of each of B shots by one depth-T
// time tile: the reference's `vmap` of `pallas_call` over the shot axis
// becomes the grid's z dimension.  One thread block takes one (x, y) tile
// of one shot with z kept whole; its window is the tile plus a halo of
// H = T * step_radius points in x and y, held in a per-block scratch in
// device memory that the wrapper allocates (a window is megabytes, far
// beyond a block's shared memory).  Each shot has its own state, tables,
// partials and scratch; the param fields are one copy, shared by all shots
// (a survey is one model).  A shot's tables and partials are `ntiles` rows
// of the (B, ntiles, ...) arrays, so they are indexed by the flat
// (shot, tile) index, as the scratch is.
//
// Reads beyond the window in x/y and beyond [0, nz) in z are zero, as in
// the reference's zero-padded stencils on window-shaped arrays; points
// outside the physical x/y domain are re-zeroed wherever the reference
// applies its domain mask.
//
// Kernel B1c (the sharded layer, src/repro/distributed/halo.py, which runs
// `_tb_kernel` with `external_dom`): a row of the z grid axis is then one
// shard's pass over its exchanged block, not a shot.  The shards sharing a
// card go in one launch, as the reference's shard_map'd `pallas_call` is
// one launch per pass: each row has its own params (a per-row stride
// instead of 0) and its own domain mask `dom`, a z-invariant
// (nx + 2H, ny + 2H) plane — 1/nz of the reference's 3-D `dom_pad`, small
// enough for L1 — read at the window's origin in place of the "inside the
// grid" predicate.  The mask zeroes by predicate (dom != 0), as the
// predicate does; for finite values that equals the reference's multiply
// by dom.  Whether a launch reads `dom` is a template parameter (DOM) of
// every kernel, so the single-device instantiations are the code they
// were before it.  In a pass's round-up band the params carry the physics'
// `param_fills`, so the update stays finite there and nothing here
// assumes edge padding.  Bound: bytes, as B1a/B1b (each row's padded
// fields and its plane read once); it inherits their re-read-every-step
// traffic.  FD coefficients come from the host, computed in float64
// and rounded to float32 as the reference rounds them, every stencil sums
// its taps in the reference's order, and the build (kernels/_build.py)
// keeps IEEE division and turns multiply-add contraction off, so a kernel
// rounds as the reference's separate operations do.
//
// The sparse terms are indexed adds and reads driven by the per-tile
// tables: the TPU's one-hot point masks exist only for its vector unit.
// Within one tile the source slots are distinct grid points, so one thread
// per slot needs no atomics; padding slots (value 0) are skipped, and a
// slot outside the window matches no point, as the one-hot mask does.
//
// Storage type (B1a-bf16 acoustic, B1b-bf16 TTI and elastic, B1c-bf16 with
// `dom`): the pieces below are templates on the type S the fields, tables,
// partials and the first schedule's state windows are stored in; TileArgs,
// View and Tile name their float32 instances.  A value is read as float
// (to_f: __bfloat162float for bf16) and stored with from_f
// (__float2bfloat16), so a bf16 kernel computes in float32 and rounds once
// a store of a step's state field (again after the injection, and each
// receiver sample), as `stencil_tb.window_tile_plain` rounds; a value a
// step only passes on to its own later phase (TTI's inner derivatives,
// elastic's new velocities before the stresses read them) stays float32,
// unrounded, as the plain version keeps it.  For float32 both are the
// identity and the code is the float32 kernels' own.  The domain mask
// `dom` stays float32.  bf16 builds only the radii its paths launch
// (`radius_built`).
#pragma once

// The build (kernels/_build.py) compiles each time-tile source as two
// objects at once and links them into one library: REPRO_TB_PART 1 holds
// the float32 entries and the shared C helpers, 2 the bf16 entries, so the
// bf16 instantiations add nothing to the build's wall time.  A source
// compiled whole (the tools' own builds) holds both.
#ifndef REPRO_TB_PART
#define REPRO_TB_PART 3
#endif
#define TB_F32_PART (REPRO_TB_PART & 1)
#define TB_BF16_PART (REPRO_TB_PART & 2)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#define MAX_RADIUS 8       // space orders 2..16
#define MAX_FIELDS 13      // elastic: 9 state + 4 param fields
#define MAX_STATE 9
#define THREADS 512

struct Coefs {
    // one axis stencil per axis (x, y, z), taps in order, rounded to
    // float32 on the host; a zero weight of the reference's is a 0 here
    float c[3][2 * MAX_RADIUS + 1];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v)
{
    return __bfloat162float(v);
}

template <class S>
__device__ __forceinline__ S from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v)
{
    return __float2bfloat16(v);
}

template <class S>
struct TileArgsT {
    const S* in[MAX_FIELDS];     // state fields, each (B, nx + 2H, ny + 2H,
                                 // nz), zero-padded; then param fields, each
                                 // (nx + 2H, ny + 2H, nz), edge-padded, or
                                 // (B, nx + 2H, ny + 2H, nz): one a row
    long long in_shot[MAX_FIELDS]; // elements from one row's input to the
                                 // next: a padded volume for a state field
                                 // and a per-row param, 0 for a shared one
    S* out[MAX_STATE];           // state fields, each (B, nx, ny, nz)
    long long out_shot;          // nx * ny * nz
    const int* src_coords;       // (B, ntiles, src_cap, 3) window-local
    const S* src_vals;           // (B, ntiles, T, src_cap)
    const int* rec_coords;       // (B, ntiles, rec_cap, 3)
    const S* rec_w;              // (B, ntiles, rec_cap)
    S* rec_out;                  // (B, ntiles, T, rec_cap, channels)
    S* scratch;                  // (B, ntiles, windows, wx * wy * nz)
    const float* dom;            // nullptr, or (B, nx + 2H, ny + 2H): each
                                 // row's domain mask (nonzero = inside)
    long long dom_row;           // (nx + 2H) * (ny + 2H)
    int nshots, nx, ny, nz, tx, ty, T, H, src_cap, rec_cap;
    float dt, dt2;
};
using TileArgs = TileArgsT<float>;

// A field's window: element (x, y, z) at p[x * sx + y * nz + z].  The
// padded inputs and the scratch windows differ only in the x-stride.
template <class S>
struct ViewT {
    const S* p;
    long long sx;
};
using View = ViewT<float>;

struct Pt {
    int x, y, z;
};

template <class S>
struct TileT {
    int shot, ti, tj, nx, ny, nz, tx, ty, H, wx, wy;
    long long tile;              // flat (shot, tile) index
    long long pad_sx, win_sx, org, npts;
    const float* dom;            // this row's domain mask, or nullptr

    __device__ explicit TileT(const TileArgsT<S>& a)
        : shot(blockIdx.z), ti(blockIdx.x), tj(blockIdx.y), nx(a.nx), ny(a.ny),
          nz(a.nz), tx(a.tx), ty(a.ty), H(a.H), wx(a.tx + 2 * a.H),
          wy(a.ty + 2 * a.H),
          tile(((long long)blockIdx.z * gridDim.x + blockIdx.x) * gridDim.y
               + blockIdx.y),
          pad_sx((long long)(a.ny + 2 * a.H) * a.nz),
          win_sx((long long)wy * a.nz),
          org((long long)ti * a.tx * pad_sx + (long long)tj * a.ty * a.nz),
          npts((long long)wx * wy * a.nz),
          dom(a.dom ? a.dom + blockIdx.z * a.dom_row : nullptr) {}

    // this tile's window of padded input field i, in this shot's copy
    __device__ ViewT<S> input(const TileArgsT<S>& a, int i) const {
        return {a.in[i] + shot * a.in_shot[i] + org, pad_sx};
    }

    // scratch window w of this tile's `nwin`
    __device__ S* scratch(const TileArgsT<S>& a, int w, int nwin) const {
        return a.scratch + (tile * nwin + w) * npts;
    }

    __device__ ViewT<S> window(const S* buf) const { return {buf, win_sx}; }

    __device__ long long at(Pt q) const {
        return q.x * win_sx + (long long)q.y * nz + q.z;
    }

    template <class E>
    __device__ float ld(const ViewT<E>& v, Pt q) const {
        return to_f(v.p[q.x * v.sx + (long long)q.y * nz + q.z]);
    }

    // a read-only input (a param field), through the read-only cache
    __device__ float ro(const ViewT<S>& v, Pt q) const {
        return to_f(__ldg(v.p + q.x * v.sx + (long long)q.y * nz + q.z));
    }

    // inside the physical domain: the row's mask at the window point
    // (DOM), or the grid predicate
    template <bool DOM>
    __device__ bool in_domain(Pt q) const {
        if constexpr (DOM) {
            return __ldg(dom + (long long)(ti * tx + q.x) * (ny + 2 * H)
                         + (tj * ty + q.y)) != 0.f;
        } else {
            const int gx = ti * tx - H + q.x, gy = tj * ty - H + q.y;
            return gx >= 0 && gx < nx && gy >= 0 && gy < ny;
        }
    }

    __device__ bool in_window(const int* c) const {
        return c[0] >= 0 && c[0] < wx && c[1] >= 0 && c[1] < wy && c[2] >= 0
            && c[2] < nz;
    }

    // sum over k < NT of c[k] * v at q + (OFF0 + k) along `axis` (0 x, 1 y,
    // 2 z), zero beyond the window.  NT and OFF0 are compile-time, so the
    // loop unrolls and all loads of a point can be in flight at once.  The
    // addresses are the column's (x, y) start plus z: the column is the
    // same for all lanes of a warp (they run along z), which keeps the tap
    // offsets warp-uniform
    template <int NT, int OFF0, class E>
    __device__ __forceinline__ float taps(const ViewT<E>& v, int axis, Pt q,
                                          const float* c) const {
        const E* col = v.p + (long long)q.x * v.sx + (long long)q.y * nz;
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < NT; ++k) {
            const int d = OFF0 + k;
            float x;
            if (axis == 0)
                x = (q.x + d >= 0 && q.x + d < wx) ? to_f(col[d * v.sx + q.z]) : 0.f;
            else if (axis == 1)
                x = (q.y + d >= 0 && q.y + d < wy)
                    ? to_f(col[(long long)d * nz + q.z]) : 0.f;
            else
                x = (q.z + d >= 0 && q.z + d < nz) ? to_f(col[q.z + d]) : 0.f;
            acc += x * c[k];
        }
        return acc;
    }

    // f(point, inside the domain) for every window point: one warp per
    // (32-deep z chunk, (x, y) column) item, lanes along z, all columns of
    // a chunk before the next chunk, so the window rows the x taps read
    // stay in L1
    template <bool DOM, class F>
    __device__ __forceinline__ void for_each_point(F f) const {
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        const int nwarps = blockDim.x >> 5;
        const int ncol = wx * wy, nzc = (nz + 31) / 32;
        for (int item = warp; item < ncol * nzc; item += nwarps) {
            const int zc = item / ncol, col = item - zc * ncol;
            const int iz = zc * 32 + lane;
            if (iz >= nz) continue;
            const int ix = col / wy;
            const Pt q = {ix, col - ix * wy, iz};
            f(q, in_domain<DOM>(q));
        }
    }

    // fused grid-aligned injection of step k into the N window buffers
    template <int N>
    __device__ void inject(const TileArgsT<S>& a, int k, S* const (&f)[N]) const {
        for (int p = threadIdx.x; p < a.src_cap; p += blockDim.x) {
            const float v = to_f(a.src_vals[(tile * a.T + k) * a.src_cap + p]);
            const int* c = a.src_coords + (tile * a.src_cap + p) * 3;
            if (v == 0.f || !in_window(c)) continue;
            const long long w = at({c[0], c[1], c[2]});
#pragma unroll
            for (int i = 0; i < N; ++i) f[i][w] = from_f<S>(to_f(f[i][w]) + v);
        }
    }

    // receiver partials of step k: rec_out[tile, k, slot, :] = rec_w[slot]
    // * sample(window index), sample writing NCHAN channels
    template <int NCHAN, class F>
    __device__ void record(const TileArgsT<S>& a, int k, F sample) const {
        for (int p = threadIdx.x; p < a.rec_cap; p += blockDim.x) {
            const int* c = a.rec_coords + (tile * a.rec_cap + p) * 3;
            S* o = a.rec_out + ((tile * a.T + k) * a.rec_cap + p) * NCHAN;
            float s[NCHAN];
            const bool in = in_window(c);
            if (in) sample(at({c[0], c[1], c[2]}), s);
            const float w = to_f(a.rec_w[tile * a.rec_cap + p]);
#pragma unroll
            for (int ch = 0; ch < NCHAN; ++ch)
                o[ch] = from_f<S>(in ? w * s[ch] : 0.f);
        }
    }

    // write the valid centre of the N state views to this shot's a.out[0..N)
    template <int N>
    __device__ void write_back(const TileArgsT<S>& a, const ViewT<S>* v) const {
        const long long base = shot * a.out_shot;
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        const int nwarps = blockDim.x >> 5;
        for (int col = warp; col < tx * ty; col += nwarps) {
            const int lx = col / ty, ly = col - (col / ty) * ty;
            const long long dst =
                base + ((long long)(ti * tx + lx) * ny + (tj * ty + ly)) * nz;
#pragma unroll
            for (int f = 0; f < N; ++f) {
                const S* src = v[f].p + (lx + H) * v[f].sx + (long long)(ly + H) * nz;
                for (int iz = lane; iz < nz; iz += 32) a.out[f][dst + iz] = src[iz];
            }
        }
    }
};
using Tile = TileT<float>;

// Fills the launch arguments from the C entry point's; returns 0 or the
// cudaError_t value of what is wrong.  The first `nout` of the `nin` inputs
// are the state fields (one copy a row), the rest the params (shared, or
// one copy a row when `param_rows`).  `dom` is nullptr or the rows' domain
// masks.  `ntaps` coefficients per axis.
template <class S>
static int tile_args(TileArgsT<S>* a, Coefs* cf, int device, int nin, int nout,
                     const S* const* in, const int* src_coords,
                     const S* src_vals, const int* rec_coords,
                     const S* rec_w, S* const* out, S* rec_out,
                     S* scratch, const float* dom, int param_rows,
                     int nshots, int nx, int ny, int nz,
                     int tx, int ty, int T, int H, int src_cap, int rec_cap,
                     int radius, const float* coefs, int ntaps, float dt,
                     float dt2)
{
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (tx <= 0 || ty <= 0 || nx % tx || ny % ty || T < 1 || nz < 1
        || nshots < 1 || nshots > 65535 || radius < 1 || radius > MAX_RADIUS
        || nin > MAX_FIELDS || nout > MAX_STATE
        || ntaps > 2 * MAX_RADIUS + 1)
        return (int)cudaErrorInvalidValue;
    *a = TileArgsT<S>{};
    const long long padded = (long long)(nx + 2 * H) * (ny + 2 * H) * nz;
    for (int i = 0; i < nin; ++i) {
        a->in[i] = in[i];
        a->in_shot[i] = (i < nout || param_rows) ? padded : 0;
    }
    for (int i = 0; i < nout; ++i) a->out[i] = out[i];
    a->out_shot = (long long)nx * ny * nz;
    a->src_coords = src_coords;
    a->src_vals = src_vals;
    a->rec_coords = rec_coords;
    a->rec_w = rec_w;
    a->rec_out = rec_out;
    a->scratch = scratch;
    a->dom = dom;
    a->dom_row = (long long)(nx + 2 * H) * (ny + 2 * H);
    a->nshots = nshots;
    a->nx = nx; a->ny = ny; a->nz = nz; a->tx = tx; a->ty = ty;
    a->T = T; a->H = H; a->src_cap = src_cap; a->rec_cap = rec_cap;
    a->dt = dt; a->dt2 = dt2;
    *cf = Coefs{};
    for (int ax = 0; ax < 3; ++ax)
        for (int q = 0; q < ntaps; ++q) cf->c[ax][q] = coefs[ax * ntaps + q];
    return 0;
}

// one block per (x tile, y tile, shot)
template <class S>
static dim3 tile_grid(const TileArgsT<S>& a)
{
    return dim3(a.nx / a.tx, a.ny / a.ty, a.nshots);
}

// float32 elements as storage elements: the first schedule keeps a
// kernel's float32 windows (TTI's inner derivatives, elastic's unrounded
// velocities in bf16) in the scratch beside its storage-type windows, each
// `f32_words<S>()` storage windows long
template <class S>
__host__ __device__ constexpr int f32_words()
{
    return (int)(sizeof(float) / sizeof(S));
}

// whether the kernels of storage type S are built at radius r: every
// radius in float32; in bf16 the radii of space orders 4 and 8, the ones
// its paths launch (the acoustic kernel without a domain mask, B1a-bf16,
// takes every radius).  A launch at another is refused; the wrapper asks
// each library's `repro_bf16_built` before it launches.
template <class S>
__host__ __device__ constexpr bool radius_built(int r)
{
    return std::is_same<S, float>::value || r == 2 || r == 4;
}

// f(std::integral_constant<int, radius>{}, std::bool_constant<dom>{}): one
// kernel instantiation per radius, so the tap loops unroll, and per
// whether the launch reads a domain mask
template <class F>
static void with_radius(int radius, bool dom, F f)
{
    const auto d = [&](auto r) {
        if (dom)
            f(r, std::true_type{});
        else
            f(r, std::false_type{});
    };
    switch (radius) {
        case 1: d(std::integral_constant<int, 1>{}); break;
        case 2: d(std::integral_constant<int, 2>{}); break;
        case 3: d(std::integral_constant<int, 3>{}); break;
        case 4: d(std::integral_constant<int, 4>{}); break;
        case 5: d(std::integral_constant<int, 5>{}); break;
        case 6: d(std::integral_constant<int, 6>{}); break;
        case 7: d(std::integral_constant<int, 7>{}); break;
        case 8: d(std::integral_constant<int, 8>{}); break;
    }
}

#if TB_F32_PART
extern "C" const char* repro_cuda_error_string(int e)
{
    return cudaGetErrorString((cudaError_t)e);
}

extern "C" int repro_max_radius(void) { return MAX_RADIUS; }
#endif
