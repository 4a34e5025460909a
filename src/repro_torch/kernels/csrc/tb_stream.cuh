// The z-streamed trapezoid schedule for Hopper, shared by the acoustic
// (stencil_tb.cu), TTI (stencil_tb_tti.cu) and elastic
// (stencil_tb_elastic.cu) time-tile kernels, which replace the Pallas TPU
// kernel `_tb_kernel` of src/repro/kernels/stencil_tb.py.  Each of them
// also keeps tb_common.cuh's first schedule (a whole window per step,
// re-read from device memory): the wrapper (`stencil_tb.launch_plan`)
// takes this schedule only where its working set fits a block and it is
// measured faster (PERF.md).
//
// What held the first schedule back: bytes (PERF.md).  The TPU kernel
// holds a (tx + 2H, ty + 2H, nz) window of every field in VMEM, 4.7 MB a
// field at tile 32, T = 4, order 4; a Hopper block has at most 227 KB of
// shared memory.  The first design put the windows in device-memory
// scratch and re-read every field at every tap of every in-window step,
// over the whole window: ~25 GB a depth-4 acoustic launch at 512^3 against
// 3.2 GB at the bound, ~85 loads a point-step for TTI.  This schedule does
// three things about that:
//
// 1. Trapezoid.  Step k (phase k for TTI and elastic, two a step)
//    computes only the points within (T - k) r of the tile's centre (r the
//    step's radius).  Those are exactly the window points whose value
//    does not depend on the zero padding beyond the window, so they equal
//    the first design's values bit for bit, and the centre after T steps is unchanged.  A
//    source injected outside that region cannot reach the centre within
//    the tile, so it is skipped; receivers are binned to the centre, which
//    every level covers.  The domain mask is applied where it always was.
//    No x/y tap of a region point leaves the previous level's region, so
//    no x/y tap needs a window check.
// 2. z streamed through the block.  A block walks z plane by plane and
//    holds the x/y region of a plane in shared memory; the next plane is
//    loaded with cp.async while the current one is computed.
// 3. A z-major copy of every input.  The port's fields are (x, y, z) with
//    z contiguous, so one z plane of a window is a gather with a stride of
//    nz elements: every 4-byte element would cost a 32-byte sector.  A
//    launch first transposes each padded input it reads (state per row,
//    params shared or per row) into a float32 (z, x, y) copy in the
//    wrapper's scratch (`to_zmajor`, 32 x 32 tiles through shared memory,
//    both sides coalesced): plane loads, pointwise reads (params, u_prev)
//    and z taps then read whole rows.  The copy costs one read and one
//    write of each padded state field a launch; the params do not change
//    over a propagation, so the wrapper makes their copies once and
//    passes them in (PARAMS_COPIED below).
//    A bf16 launch (B1a-bf16) copies its bf16 inputs to float32 exactly,
//    computes in float32 as before and rounds at the same stores
//    (`rnd<S>`), so it keeps its bit-equality with the plain version.
//
// A block takes one (bx, by) sub-tile of a spec tile: the whole tile when
// its working set fits the shared memory (the main plan, tile 32, T = 4,
// order 4, does), else the largest sub-tile of the tile's divisors that
// fits.  The wrapper picks it (`stencil_tb.stream_plan`), sizes the
// scratch for it and passes it; a launch refuses a sub-tile that does not
// divide the tile or does not fit (`subtile_ok`).  A sub-tile's window is
// the sub-tile plus the spec's halo H, inside the spec tile's window; its trapezoid values are the spec's, so
// the result does not depend on the choice.  Receiver partials go to the
// spec tile's slots: a slot belongs to the sub-tile whose centre holds its
// point, so each slot has one writer and no atomics are needed (a slot
// outside the spec tile's centre is left at the wrapper's zero; the
// tables bin receivers to centres).
#pragma once

#include "tb_common.cuh"

#include <climits>

#define STREAM_THREADS 512
// shared memory a block may take on sm_90 (232,448 bytes), less 8 KB for
// the kernels' static arrays
#define STREAM_SMEM (232448 - 8192)
#define MAX_T 32            // depths the static level tables hold

// a value stored in the storage type S and read back: the identity for
// float32, the bf16 rounding of a store for bf16
template <class S>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<S>(v)); }

// Launch geometry and scratch of the schedule.  The scratch is float32:
// first the z-major copies of the state (field i of row b at copy index
// i * nshots + b, each X * Y * nz with X = nx + 2H, Y = ny + 2H), then
// those of the params (param i of row p at i * prow + p), unless the
// caller made them already (`PARAMS_COPIED`: the params do not change over
// a propagation, so the wrapper keeps their copies and passes them as the
// param inputs), then `blk_floats` a block for the kernels that keep
// per-block windows (TTI, elastic).
struct StreamArgs {
    float* copy;
    const float* pcopy;         // the params' copies
    long long vol;              // X * Y * nz
    int nstate, prow;           // state fields; param rows (1 or nshots)
    int bx, by, nsx, nsy;       // block sub-tile; sub-tiles per spec tile
    float* blk;                 // per-block scratch, or nullptr
    long long blk_floats;
};

// bits of the C entry points' `param_rows`: params one a row; params given
// as their z-major float32 copies, (nparam, prow, X * Y * nz) contiguous
#define PARAM_ROWS 1
#define PARAMS_COPIED 2

// a z-major field seen from a block: element (x, y, z) of the block's
// window at p[z * sz + x * sx + y]
struct ZView {
    const float* p;
    long long sx, sz;

    __device__ long long idx(int x, int y, int z) const {
        return z * sz + x * sx + y;
    }
    // coherent load: the field may be this block's scratch
    __device__ float at(int x, int y, int z) const { return p[idx(x, y, z)]; }
    // read-only load: a copy the launch's transpose wrote
    __device__ float ro(int x, int y, int z) const {
        return __ldg(p + idx(x, y, z));
    }
};

// One block: spec tile (ti, tj) of row `shot`, sub-tile (sx, sy) of it.
// Coordinates below are block-window-local: (x, y) is spec-window point
// (wox + x, woy + y) and padded-grid point (ox + x, oy + y).
struct Blk {
    int shot, ti, tj, sx, sy, bx, by, bwx, bwy, H, nx, ny, nz, tx, ty, X, Y;
    int wox, woy, ox, oy;
    long long tile;             // flat (row, spec tile) index of the tables
    long long blin;             // flat block index
    const float* dom;           // this row's domain mask, or nullptr

    template <class S>
    __device__ Blk(const TileArgsT<S>& a, const StreamArgs& s)
        : shot(blockIdx.z), ti(blockIdx.x / s.nsx), tj(blockIdx.y / s.nsy),
          sx(blockIdx.x % s.nsx), sy(blockIdx.y % s.nsy), bx(s.bx),
          by(s.by), bwx(s.bx + 2 * a.H), bwy(s.by + 2 * a.H), H(a.H),
          nx(a.nx), ny(a.ny), nz(a.nz), tx(a.tx), ty(a.ty),
          X(a.nx + 2 * a.H), Y(a.ny + 2 * a.H),
          wox((blockIdx.x % s.nsx) * s.bx), woy((blockIdx.y % s.nsy) * s.by),
          ox((blockIdx.x / s.nsx) * a.tx + (blockIdx.x % s.nsx) * s.bx),
          oy((blockIdx.y / s.nsy) * a.ty + (blockIdx.y % s.nsy) * s.by),
          tile(((long long)blockIdx.z * (a.nx / a.tx) + blockIdx.x / s.nsx)
                   * (a.ny / a.ty) + blockIdx.y / s.nsy),
          blin(((long long)blockIdx.z * gridDim.x + blockIdx.x) * gridDim.y
               + blockIdx.y),
          dom(a.dom ? a.dom + blockIdx.z * a.dom_row : nullptr) {}

    // input i's z-major copy (state i < s.nstate of this row, else param
    // i - nstate, shared or this row's)
    __device__ ZView copy(const StreamArgs& s, int nshots, int i) const {
        const float* base = i < s.nstate
            ? s.copy + ((long long)i * nshots + shot) * s.vol
            : s.pcopy + ((long long)(i - s.nstate) * s.prow
                         + (s.prow > 1 ? shot : 0)) * s.vol;
        return {base + (long long)ox * Y + oy, (long long)Y, (long long)X * Y};
    }

    // window w of this block's scratch, z-major over the block window
    __device__ float* scratch(const StreamArgs& s, int w) const {
        return s.blk + blin * s.blk_floats + (long long)w * nz * bwx * bwy;
    }
    __device__ ZView scratch_view(const float* p) const {
        return {p, (long long)bwy, (long long)bwx * bwy};
    }

    // inside the physical domain: the row's mask (DOM) or the grid
    // predicate, as tb_common.cuh's Tile::in_domain
    template <bool DOM>
    __device__ bool in_domain(int x, int y) const {
        if constexpr (DOM) {
            return __ldg(dom + (long long)(ox + x) * Y + (oy + y)) != 0.f;
        } else {
            const int gx = ox - H + x, gy = oy - H + y;
            return gx >= 0 && gx < nx && gy >= 0 && gy < ny;
        }
    }

    // a table point (spec-window-local) in this block's region of margin m
    // (points [m, bwx - m) x [m, bwy - m)), as block-local (x, y)
    __device__ bool in_region(const int* c, int m, int* x, int* y) const {
        *x = c[0] - wox;
        *y = c[1] - woy;
        return *x >= m && *x < bwx - m && *y >= m && *y < bwy - m
            && c[2] >= 0 && c[2] < nz;
    }

    // whether receiver point c is recorded by this block: in the spec
    // tile's centre, in this block's sub-tile of it
    __device__ bool owns(const int* c) const {
        const int cx = c[0] - H, cy = c[1] - H;
        return cx >= 0 && cx < tx && cy >= 0 && cy < ty && c[2] >= 0
            && c[2] < nz && cx / bx == sx && cy / by == sy;
    }
};

// a region of h x w points walked by one block: point idx = tid + i * nt is
// (idx / w, idx % w), stepped without a division per point
struct Walk {
    int x, y, dx, dy, w;
    __device__ Walk(int w_) : w(w_) {
        x = threadIdx.x / w;
        y = threadIdx.x - x * w;
        dx = blockDim.x / w;
        dy = blockDim.x - dx * w;
    }
    __device__ void next() {
        x += dx;
        y += dy;
        if (y >= w) {
            y -= w;
            ++x;
        }
    }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}
__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
}

// copy the h x w region at (x0, y0) of plane z of `v` into `dst` (row-major,
// width w), asynchronously: 16 bytes a copy where every row is 16-byte
// aligned on both sides, else 4
__device__ __forceinline__ void load_plane(float* dst, const ZView& v,
                                           int z, int x0, int y0, int h,
                                           int w)
{
    const float* src = v.p + z * v.sz + x0 * v.sx + y0;
    if (((reinterpret_cast<unsigned long long>(src)
          | reinterpret_cast<unsigned long long>(dst)) & 15) == 0
        && (w & 3) == 0 && (v.sx & 3) == 0) {
        const int w4 = w >> 2;
        Walk p(w4);
        for (int i = threadIdx.x; i < h * w4; i += blockDim.x, p.next())
            cp_async16(dst + 4 * i, src + p.x * v.sx + 4 * p.y);
        return;
    }
    Walk p(w);
    for (int i = threadIdx.x; i < h * w; i += blockDim.x, p.next())
        cp_async4(dst + i, src + p.x * v.sx + p.y);
}

// The z-major copies: each input (X, Y, nz) of storage type S becomes a
// float32 (nz, X, Y).  One warp a 32 x 32 (y, z) tile of one x row: read
// with lanes along z, written with lanes along y, both coalesced.
template <class S>
__global__ void __launch_bounds__(256)
to_zmajor(const TileArgsT<S> a, const StreamArgs s, int nparam)
{
    __shared__ float tile[8][32][33];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int X = a.nx + 2 * a.H, Y = a.ny + 2 * a.H, Z = a.nz;
    const int nyt = (Y + 31) / 32, nzt = (Z + 31) / 32;
    const long long nstate = (long long)s.nstate * a.nshots;
    const long long nf = nstate + (long long)nparam * s.prow;
    const long long items = nf * X * nyt * nzt;
    for (long long it = (long long)blockIdx.x * 8 + w; it < items;
         it += (long long)gridDim.x * 8) {
        long long r = it;
        const int zt = (int)(r % nzt);
        r /= nzt;
        const int yt = (int)(r % nyt);
        r /= nyt;
        const int x = (int)(r % X);
        const long long f = r / X;
        int i;
        long long row;
        if (f < nstate) {
            i = (int)(f / a.nshots);
            row = f % a.nshots;
        } else {
            i = s.nstate + (int)((f - nstate) / s.prow);
            row = (f - nstate) % s.prow;
        }
        const S* src = a.in[i] + row * a.in_shot[i] + (long long)x * Y * Z;
        float* dst = s.copy + f * s.vol + (long long)x * Y;
        const int y0 = yt * 32, z0 = zt * 32;
        // unrolled, so a warp has its 32 row loads in flight at once
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int y = y0 + j, z = z0 + lane;
            tile[w][j][lane] =
                (y < Y && z < Z) ? to_f(src[(long long)y * Z + z]) : 0.f;
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int z = z0 + j, y = y0 + lane;
            if (z < Z && y < Y) dst[(long long)z * X * Y + y] = tile[w][lane][j];
        }
        __syncwarp();
    }
}

// whether sub-tile (bx, by), whose block takes `smem` bytes of shared
// memory, is one the schedule can run for tile (tx, ty)
static bool subtile_ok(int tx, int ty, int bx, int by, long long smem)
{
    return bx >= 1 && by >= 1 && tx % bx == 0 && ty % by == 0
        && smem <= STREAM_SMEM;
}

// Fills the schedule's arguments for sub-tile (bx, by): copies at the
// scratch's start (the params' unless PARAMS_COPIED: then a.in[nstate] is
// theirs), then `windows` whole block windows a block (elastic; TTI sets
// its own `blk_floats`)
template <class S>
static StreamArgs stream_args(const TileArgsT<S>& a, float* scratch,
                              int nstate, int nparam, int param_rows, int bx,
                              int by, int windows)
{
    StreamArgs s{};
    s.copy = scratch;
    s.vol = (long long)(a.nx + 2 * a.H) * (a.ny + 2 * a.H) * a.nz;
    s.nstate = nstate;
    s.prow = (param_rows & PARAM_ROWS) ? a.nshots : 1;
    s.bx = bx;
    s.by = by;
    s.nsx = a.tx / bx;
    s.nsy = a.ty / by;
    long long ncopy = (long long)nstate * a.nshots;
    if (param_rows & PARAMS_COPIED) {
        s.pcopy = reinterpret_cast<const float*>(a.in[nstate]);
    } else {
        s.pcopy = scratch + ncopy * s.vol;
        ncopy += (long long)nparam * s.prow;
    }
    s.blk = windows ? scratch + ncopy * s.vol : nullptr;
    s.blk_floats = (long long)windows * a.nz * (bx + 2 * a.H) * (by + 2 * a.H);
    return s;
}

// one block per (spec tile, sub-tile) and row
static dim3 stream_grid(int nx, int ny, int tx, int ty, const StreamArgs& s,
                        int nshots)
{
    return dim3((nx / tx) * s.nsx, (ny / ty) * s.nsy, nshots);
}

// the copies a launch makes: its state's, and its params' unless the
// caller made them
template <class S>
static void launch_to_zmajor(const TileArgsT<S>& a, const StreamArgs& s,
                             int nparam, int param_rows, cudaStream_t stream)
{
    to_zmajor<S><<<4 * 132 * 2, 256, 0, stream>>>(
        a, s, (param_rows & PARAMS_COPIED) ? 0 : nparam);
}

// The params' z-major copies alone, into `out` ((nparam, prow, X * Y * nz)
// float32), for a caller that keeps them across launches
template <class S>
static int param_copies(int device, const S* const* in, int nparam,
                        int param_rows, int nshots, int nx, int ny, int nz,
                        int H, float* out, void* stream)
{
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (nparam < 1 || nparam > MAX_FIELDS || nshots < 1) return (int)cudaErrorInvalidValue;
    TileArgsT<S> a{};
    StreamArgs s{};
    s.vol = (long long)(nx + 2 * H) * (ny + 2 * H) * nz;
    s.copy = out;
    s.prow = param_rows ? nshots : 1;
    for (int i = 0; i < nparam; ++i) {
        a.in[i] = in[i];
        a.in_shot[i] = param_rows ? s.vol : 0;
    }
    a.nshots = nshots;
    a.nx = nx;
    a.ny = ny;
    a.nz = nz;
    a.H = H;
    to_zmajor<S><<<4 * 132 * 2, 256, 0, (cudaStream_t)stream>>>(a, s, nparam);
    return (int)cudaGetLastError();
}
