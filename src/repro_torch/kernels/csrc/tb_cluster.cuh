// The cluster-shared z-streamed trapezoid (B5) for Hopper, the third
// schedule of the TTI (stencil_tb_tti.cu) and elastic
// (stencil_tb_elastic.cu) time-tile kernels, which replace the Pallas TPU
// kernel `_tb_kernel` of src/repro/kernels/stencil_tb.py.  The wrapper
// (`stencil_tb.launch_plan`) takes it at the deep halos of space orders 8
// and 12 (from halo 16), where tb_stream.cuh's z-streamed schedule finds
// no sub-tile whose region fits a block, or one so small that its window
// overhangs it many times.
//
// What held those halos back: recomputed halo.  The first schedule
// updates the whole (tx + 2H)^2 window every step, 9x a 32^2 tile's points
// at halo 32 and 16x at halo 48, and the trapezoid on one block's sub-tile
// still recomputes its overhang once a sub-tile.  Only a large tile whose
// every level is computed once brings the factor down (1.51x at tile 128,
// T = 4, order 8; `stencil_tb.redundancy`), and a 128^2 tile's trapezoid
// is far beyond a block.  Hopper's thread block clusters give it: the
// blocks of a cluster are co-resident and synchronise with each other, so
// a cluster of C blocks shares one spec tile's trapezoid.  On the H100 the
// fastest measured (PERF.md) is tile 64 with 2 blocks a cluster: its 64
// clusters all run at once, where 16 clusters of 8 blocks on 128^2 tiles
// find 15 places (a cluster's blocks share a GPC) and take two waves
// (`stencil_tb.cluster_size`).
//
// The schedule, per launch: the z-major copies of tb_stream.cuh; then one
// cluster a spec tile (grid (C, spec tiles, rows), cluster (C, 1, 1)).
// Each phase (two a step, as the z-streamed schedule) is one pass over
// the spec window's region of margin n R (phase n of 2T, R = order / 2);
// its output goes to the spec tile's windows in device-memory scratch
// (`scratch_windows` whole spec windows a tile, float32, z-major), as the
// z-streamed schedule's block windows do.  A pass's region is cut into
// chunks (`stencil_tb.pass_chunks`, handed in as a small int table): C
// near-equal parts, one a block, each cut into the fewest chunks whose
// working set fits shared memory, so every point of a level is computed
// once a spec tile and the blocks finish a pass together.  A chunk is
// z-streamed as the z-streamed schedule streams a sub-tile's region: its
// seam (R points of the previous pass's output around it) plane by plane
// through shared memory with cp.async, the next plane loading meanwhile.
// Between passes the cluster waits on `barrier.cluster.arrive.release` /
// `wait.acquire`, so a pass reads what every block of the cluster wrote in
// the previous one.  Those reads are coherent: plane loads are cp.async.cg
// (16-byte copies through L2, not L1; the launch checks the rows are
// whole 16-byte groups) and pointwise and z-tap reads of the scratch are
// plain loads, never the read-only path (__ldg), which may hold stale
// lines of another block's output.  Sources are injected, and receiver
// slots written, by the block whose chunk of that step's last pass holds
// the point, so each (slot, step) has one writer and needs no atomics;
// each block writes back its chunks of the last pass, whose region is the
// tile's centre.
//
// Every point runs the z-streamed schedule's expressions in its tap order,
// and the build turns multiply-add contraction off, so the state is bit-
// equal to the first schedule's (tb_stream.cuh's trapezoid argument: a
// region point's value does not depend on the window's zero padding).
#pragma once

#include "tb_stream.cuh"

#define CLUSTER_MAX 16

// planes a z ring holds: the 2R + 1 taps of the current plane and the plane
// loading meanwhile
static __host__ __device__ constexpr int ring_planes(int r) { return 2 * r + 2; }

// The z taps of plane z in a ring: the offsets of planes z - R .. z + R
// from plane z's slot (floats), and a bit each for those in [0, nz)
template <int R>
struct ZTaps {
    int d[2 * R + 1];
    unsigned mask;

    __device__ ZTaps(int z, int nz, int cap) : mask(0) {
        constexpr int S = ring_planes(R);
#pragma unroll
        for (int q = 0; q <= 2 * R; ++q) {
            const int zz = z + q - R;
            const bool ok = zz >= 0 && zz < nz;
            mask |= (unsigned)ok << q;
            d[q] = ok ? (zz % S - z % S) * cap : 0;
        }
    }
};

// the B5 launch's own arguments: the chunk table (`stencil_tb.chunk_table`:
// npass * C + 1 starts, then the chunks' (x0, y0, h, w)) and its shape
struct ClusterArgs {
    const int* table;
    int C, npass;
};

// every thread of the cluster arrives, then waits for all: the writes
// before the barrier (to shared or device memory) are seen after it
__device__ __forceinline__ void cluster_barrier()
{
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the two halves of cluster_barrier, for work between them
__device__ __forceinline__ void cluster_arrive()
{
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait()
{
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the load rectangle (x, y, h, w) of a chunk's pass (`stencil_tb.
// chunk_load`): the chunk and R points around it, widened in y to whole
// 16-byte groups of the window's rows
__host__ __device__ __forceinline__ void chunk_load(int R, int x0, int y0,
                                                    int h, int w, int* lx,
                                                    int* ly, int* lh, int* lw)
{
    *lx = x0 - R;
    *ly = (y0 - R) >> 2 << 2;
    *lh = h + 2 * R;
    *lw = ((y0 + w + R + 3) >> 2 << 2) - *ly;
}

__device__ __forceinline__ void cp_async16_cg(float* dst, const float* src)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
}

// copy the h x w rectangle at (x0, y0) of plane z of `v` into `dst` (row-
// major, width w) in 16-byte copies through L2: y0, w and v's strides are
// multiples of 4 floats and v's origin is 16-byte aligned (the launch
// checks the shapes that make them so)
__device__ __forceinline__ void load_rect(float* dst, const ZView& v, int z,
                                          int x0, int y0, int h, int w)
{
    const float* src = v.p + z * v.sz + x0 * v.sx + y0;
    const int w4 = w >> 2;
    Walk p(w4);
    for (int i = threadIdx.x; i < h * w4; i += blockDim.x, p.next())
        cp_async16_cg(dst + 4 * i, src + p.x * v.sx + 4 * p.y);
}

// One block of a B5 launch: block `rank` of the cluster on spec tile
// (ti, tj) of row `shot`.  Coordinates are spec-window-local: (x, y) is
// padded-grid point (ox + x, oy + y).
struct CBlk {
    int shot, rank, ti, tj, H, nx, ny, nz, tx, ty, wx, wy, X, Y, ox, oy;
    long long tile;             // flat (row, spec tile) index
    const float* dom;           // this row's domain mask, or nullptr
    const int* table;           // the chunk table's starts
    const int* ch0;             // its chunks
    int C;

    template <class S>
    __device__ CBlk(const TileArgsT<S>& a, const ClusterArgs& c)
        : shot(blockIdx.z), rank(blockIdx.x),
          ti(blockIdx.y / (a.ny / a.ty)), tj(blockIdx.y % (a.ny / a.ty)),
          H(a.H), nx(a.nx), ny(a.ny), nz(a.nz), tx(a.tx), ty(a.ty),
          wx(a.tx + 2 * a.H), wy(a.ty + 2 * a.H), X(a.nx + 2 * a.H),
          Y(a.ny + 2 * a.H), ox(ti * a.tx), oy(tj * a.ty),
          tile((long long)blockIdx.z * gridDim.y + blockIdx.y),
          dom(a.dom ? a.dom + blockIdx.z * a.dom_row : nullptr),
          table(c.table),
          ch0(c.table ? c.table + c.npass * c.C + 1 : nullptr), C(c.C) {}
    // a block of a launch without a chunk table (B6, stencil_tb.cu)
    template <class S>
    __device__ explicit CBlk(const TileArgsT<S>& a)
        : CBlk(a, ClusterArgs{nullptr, (int)gridDim.x, 0}) {}

    // input i's z-major copy (state i < s.nstate of this row, else param
    // i - nstate, shared or this row's), from the spec window's origin
    __device__ ZView copy(const StreamArgs& s, int nshots, int i) const {
        const float* base = i < s.nstate
            ? s.copy + ((long long)i * nshots + shot) * s.vol
            : s.pcopy + ((long long)(i - s.nstate) * s.prow
                         + (s.prow > 1 ? shot : 0)) * s.vol;
        return {base + (long long)ox * Y + oy, (long long)Y, (long long)X * Y};
    }

    // window w of this spec tile's scratch, z-major over the spec window
    __device__ float* window(const StreamArgs& s, int w) const {
        return s.blk + tile * s.blk_floats + (long long)w * nz * wx * wy;
    }
    __device__ ZView view(const float* p) const {
        return {p, (long long)wy, (long long)wx * wy};
    }

    template <bool DOM>
    __device__ bool in_domain(int x, int y) const {
        if constexpr (DOM) {
            return __ldg(dom + (long long)(ox + x) * Y + (oy + y)) != 0.f;
        } else {
            const int gx = ox - H + x, gy = oy - H + y;
            return gx >= 0 && gx < nx && gy >= 0 && gy < ny;
        }
    }

    // this block's chunks of pass n (1-based): [*b, *e), chunk i at
    // chunk(i)
    __device__ void chunks(int n, int* b, int* e) const {
        *b = __ldg(table + (n - 1) * C + rank);
        *e = __ldg(table + (n - 1) * C + rank + 1);
    }
    __device__ const int* chunk(int i) const { return ch0 + 4 * i; }

    // whether this block's chunks of pass n hold window point (x, y)
    __device__ bool holds(int n, int x, int y) const {
        int b, e;
        chunks(n, &b, &e);
        for (int i = b; i < e; ++i) {
            const int* c = chunk(i);
            const int x0 = __ldg(c), y0 = __ldg(c + 1);
            if (x >= x0 && x < x0 + __ldg(c + 2) && y >= y0
                && y < y0 + __ldg(c + 3))
                return true;
        }
        return false;
    }

    // whether receiver point c (window-local) is in the tile's centre
    __device__ bool in_centre(const int* c) const {
        const int cx = c[0] - H, cy = c[1] - H;
        return cx >= 0 && cx < tx && cy >= 0 && cy < ty && c[2] >= 0
            && c[2] < nz;
    }
};

// One z-streamed pass of phase n over one chunk (x0, y0, h, w): NRING
// fields stream through rings of ring_planes(R) planes of the chunk's load
// rectangle (`chunk_load`), NPLANE fields (x/y taps only) through two
// planes of it; for each plane z, once its taps are resident, every point
// (x, y) of the chunk (window-local) runs load(x, y, z), its pointwise
// reads, then f(those, ring centre, plane centre, ring stride, plane
// stride, row width, z taps, x, y, z): ring i's value at the point is ring
// centre[i * ring stride], plane j's plane centre[j * plane stride].
template <int R, int NRING, int NPLANE, class L, class F>
__device__ __forceinline__ void chunk_pass(float* sm, const ZView* ring,
                                           const ZView* plane, int nz,
                                           const int* ch, L load, F f)
{
    constexpr int S = ring_planes(R);
    const int x0 = __ldg(ch), y0 = __ldg(ch + 1);
    const int h = __ldg(ch + 2), w = __ldg(ch + 3);
    int lx, ly, lh, lw;
    chunk_load(R, x0, y0, h, w, &lx, &ly, &lh, &lw);
    const int cap = lh * lw;
    float* const pl = sm + NRING * S * cap;
    const auto load_ring = [&](int z) {
#pragma unroll
        for (int i = 0; i < NRING; ++i)
            load_rect(sm + (i * S + z % S) * cap, ring[i], z, lx, ly, lh, lw);
    };
    const auto load_planes = [&](int z) {
#pragma unroll
        for (int j = 0; j < NPLANE; ++j)
            load_rect(pl + (2 * j + (z & 1)) * cap, plane[j], z, lx, ly, lh,
                      lw);
    };
    if (NRING)
        for (int z = 0; z <= R && z < nz; ++z) load_ring(z);
    load_planes(0);
    cp_async_commit();
    // point (0, 0) of the chunk in a load plane
    const int off = R * lw + (y0 - ly);
    for (int z = 0; z < nz; ++z) {
        cp_async_wait_all();
        __syncthreads();
        // the slot of plane z + R + 1 held plane z - R - 1 and the plane
        // buffer of z + 1 held plane z - 1, both last read at plane z - 1
        if (NRING && z + R + 1 < nz) load_ring(z + R + 1);
        if (z + 1 < nz) load_planes(z + 1);
        cp_async_commit();
        const ZTaps<R> zt(z, nz, cap);
        const float* rc = sm + (z % S) * cap + off;
        const float* pc = pl + (z & 1) * cap + off;
        Walk p(w);
        for (int i = threadIdx.x; i < h * w; i += blockDim.x, p.next()) {
            const int ci = p.x * lw + p.y;
            f(load(x0 + p.x, y0 + p.y, z), rc + ci, pc + ci, S * cap,
              2 * cap, lw, zt, x0 + p.x, y0 + p.y, z);
        }
    }
    __syncthreads();
}

// write back chunk (x0, y0, h, w) of the last pass (the tile's centre) of
// the N fields `fin` to this row's outputs: one warp a 32 x 32 (y, z) tile
// of one x row, read along y from a z-major field, written along z (a store
// in the storage type S)
template <int N, class S>
__device__ void write_back_chunk(const TileArgsT<S>& a, const CBlk& b,
                                 float* sm, const ZView* fin, const int* ch)
{
    const int x0 = __ldg(ch), y0 = __ldg(ch + 1);
    const int h = __ldg(ch + 2), w = __ldg(ch + 3);
    const int nz = a.nz, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    float* tile = sm + warp * 32 * 33;
    const int nyt = (w + 31) / 32, nzt = (nz + 31) / 32;
    const long long base = b.shot * a.out_shot;
    for (int it = warp; it < N * h * nyt * nzt; it += nwarps) {
        int q = it;
        const int z0 = (q % nzt) * 32;
        q /= nzt;
        const int yt = (q % nyt) * 32;
        q /= nyt;
        const int x = q % h, f = q / h;
        const ZView v = fin[f];
        const float* src = v.p + (long long)(x0 + x) * v.sx + y0;
        for (int j = 0; j < 32; ++j) {
            const int z = z0 + j, y = yt + lane;
            tile[j * 33 + lane] = (z < nz && y < w) ? src[z * v.sz + y] : 0.f;
        }
        __syncwarp();
        const long long gx = (long long)b.ti * b.tx + x0 - b.H + x;
        const long long gy = (long long)b.tj * b.ty + y0 - b.H;
        for (int j = 0; j < 32; ++j) {
            const int y = yt + j, z = z0 + lane;
            if (y < w && z < nz)
                a.out[f][base + (gx * b.ny + gy + y) * nz + z] =
                    from_f<S>(tile[lane * 33 + j]);
        }
        __syncwarp();
    }
}

// Checks a B5 launch's chunk table (host copy, `len` ints) before the
// launch: npass * C + 1 non-decreasing starts from 0, then the chunks;
// pass n's chunks lie in the spec window's region of margin n R, do not
// overlap, cover it, and each needs need(n, lh, lw) <= smem bytes of
// shared memory.  Returns 0 or cudaErrorInvalidValue.
template <class Need>
static int check_chunks(const int* t, int len, int npass, int C, int wx,
                        int wy, int R, long long smem, Need need)
{
    const int ns = npass * C + 1;
    if (!t || len < ns || t[0] != 0) return (int)cudaErrorInvalidValue;
    for (int i = 0; i + 1 < ns; ++i)
        if (t[i + 1] < t[i]) return (int)cudaErrorInvalidValue;
    if (len != ns + 4 * t[ns - 1]) return (int)cudaErrorInvalidValue;
    const int* ch = t + ns;
    for (int n = 1; n <= npass; ++n) {
        const int m = n * R;
        long long area = 0;
        const int b = t[(n - 1) * C], e = t[n * C];
        for (int i = b; i < e; ++i) {
            const int* c = ch + 4 * i;
            if (c[2] < 1 || c[3] < 1 || c[0] < m || c[1] < m
                || c[0] + c[2] > wx - m || c[1] + c[3] > wy - m)
                return (int)cudaErrorInvalidValue;
            int lx, ly, lh, lw;
            chunk_load(R, c[0], c[1], c[2], c[3], &lx, &ly, &lh, &lw);
            if (need(n, lh, lw) > smem) return (int)cudaErrorInvalidValue;
            area += (long long)c[2] * c[3];
            for (int j = i + 1; j < e; ++j) {
                const int* d = ch + 4 * j;
                if (c[0] < d[0] + d[2] && d[0] < c[0] + c[2]
                    && c[1] < d[1] + d[3] && d[1] < c[1] + c[3])
                    return (int)cudaErrorInvalidValue;
            }
        }
        if (area != (long long)(wx - 2 * m) * (wy - 2 * m))
            return (int)cudaErrorInvalidValue;
    }
    return 0;
}

// Whether a B5 launch's shapes keep every plane load whole 16-byte groups:
// the tile and padded widths multiples of 4 floats, the scratch and the
// params' copies 16-byte aligned
template <class S>
static bool cluster_aligned(const TileArgsT<S>& a, const StreamArgs& s)
{
    return a.ty % 4 == 0 && (a.ny + 2 * a.H) % 4 == 0
        && (reinterpret_cast<unsigned long long>(s.copy) & 15) == 0
        && (reinterpret_cast<unsigned long long>(s.pcopy) & 15) == 0
        && (reinterpret_cast<unsigned long long>(s.blk) & 15) == 0;
}

// The launch configuration of B5: grid (C, spec tiles, rows) in clusters
// of (C, 1, 1), `smem` bytes of dynamic shared memory a block (the
// kernel's attributes set for them), and how many such clusters the card
// holds at once (`active`, cudaOccupancyMaxActiveClusters)
template <class... Args>
static int cluster_config(void (*kern)(Args...), int C, dim3 grid,
                          int threads, long long smem, cudaStream_t st,
                          cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg,
                          int* active)
{
    int rc = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc == 0 && C > 8)
        rc = (int)cudaFuncSetAttribute(
            kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (rc) return rc;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = C;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = grid;
    cfg->blockDim = dim3(threads);
    cfg->dynamicSmemBytes = (size_t)smem;
    cfg->stream = st;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    *active = 0;
    return (int)cudaOccupancyMaxActiveClusters(active, kern, cfg);
}

// Launches `kern` as B5 (`cluster_config`).  Raises (returns the error)
// where the card cannot hold one such cluster at once: no other schedule
// stands in.
template <class... Args>
static int cluster_launch(void (*kern)(Args...), int C, dim3 grid,
                          int threads, long long smem, cudaStream_t st,
                          Args... args)
{
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    int active;
    const int rc = cluster_config(kern, C, grid, threads, smem, st, &attr,
                                  &cfg, &active);
    if (rc) return rc;
    if (active < 1) return (int)cudaErrorLaunchOutOfResources;
    return (int)cudaLaunchKernelEx(&cfg, kern, args...);
}
