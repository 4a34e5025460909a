// Temporally-blocked TTI (tilted transversely isotropic pseudo-acoustic)
// time tile for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_tb_kernel` of
// src/repro/kernels/stencil_tb.py (launched by `tb_time_tile`) with
// `tb_physics.TTI`, in float32 and, as B1b-bf16, in bf16 (the kernels'
// storage type S: fields, params, source values, receiver weights, outputs
// and partials in bf16, computed in float32 and rounded at each store of
// p and r, tb_common.cuh; the inner derivatives stay float32): state p,
// p_prev, r, r_prev; params m, damp, epsilon, delta, theta, phi.  Per
// (x, y) tile, T times
// (src/repro/core/propagators/tti.py:57-116):
//
//   phase A: the inner rotated first derivatives the update uses, Dx~p,
//     Dy~p and Dz~r, times the domain mask (the reference's `mask_fn`);
//   phase B: the outer rotated derivatives h0_p = Dx~(Dx~p) + Dy~(Dy~p)
//     and hz_r = Dz~(Dz~r), then
//       p_next = (dt^2 ((1 + 2 eps) h0_p + sqrt(1 + 2 dlt) hz_r)
//                 + m (2p - p_prev) + damp dt p) / (m + damp dt)
//       r_next = (dt^2 (sqrt(1 + 2 dlt) h0_p + hz_r)
//                 + m (2r - r_prev) + damp dt r) / (m + damp dt),
//     zero outside the physical x/y domain;
//   inject the source values into p and r; record w * p at the receivers.
//
// The reference also computes hz_p = Dz~(Dz~p) and h0_r and discards them
// (only h0_p and hz_r enter the update), so skipping them changes no bit
// of the result.  Dy~ has no z term: the reference adds 0 * dz, which can
// change at most the sign of a zero, so it is skipped too.  The direction
// cosines are computed at each point from theta and phi with `sincosf`
// (the accurate function, not the __sinf/__cosf intrinsics), in both
// phases, instead of four more fields of traffic.  The terms of every
// directional derivative are summed x, y, z, and every expression and tap
// order is the same in both schedules below; the build turns multiply-add
// contraction off, so each point rounds the same in both.
//
// What bounds it: on the roofline, operations — the reference prices a
// point-step at 508 flops at order 4, so a depth-4 tile of the 512^3 case
// needs 4.07 ms at 67 TFLOP/s against 2.24 ms for its 7.5 GB of least
// traffic.  Three schedules compute the same function; the wrapper picks
// one a launch from its shape (`stencil_tb.launch_plan`) and passes the
// z-streamed schedule's sub-tile, or (0, 0) for the first schedule, to
// `repro_tb_tile`, or B5's chunk table to `repro_tb_tile_cluster`:
//
// The first schedule (the port's first design, kept as it was; 137.7 ms a
// depth-4 launch at 512^3) is bound by bytes in practice: it keeps seven
// whole windows a tile in device-memory scratch (p and r ping-pong, the
// step's output overwriting the previous time level, which is read only
// pointwise; plus the three inner windows) and re-reads every field at
// every tap of every in-window step, ~85 loads a point-step over the whole
// window.  It runs the shapes whose z rings fit no sub-tile (deep stencils
// at depth) and those where it measured faster (PERF.md).
//
// The z-streamed schedule (tb_stream.cuh: trapezoid, z-major copies,
// sub-tiles) makes each phase one z-streamed pass over its trapezoid
// region (phase n of 2T computes the points within (2T - n) R of the
// centre, R the first derivative's radius, order / 2).  TTI taps few
// fields a pass, so unlike elastic its z taps come from shared memory too:
//
//   phase A streams p and r through rings of 2R + 2 planes of their region
//   of margin (n - 1) R (the 2R + 1 z taps of the current plane, and the
//   next plane, loaded by cp.async meanwhile), reads theta and phi
//   pointwise from their copies and writes the masked Dx~p, Dy~p, Dz~r to
//   the block's z-major scratch windows;
//   phase B streams Dx~p and Dz~r through rings the same way and Dy~p (no
//   z term) through two planes, reads the params, p, p_prev, r and r_prev
//   pointwise (whole rows of z-major fields) and writes p_next and r_next
//   over p_prev and r_prev, which it reads only at the point it
//   overwrites.  The first step reads the copies of the inputs; the
//   tile's centre is written back through 32 x 32 shared-memory tiles.
//   The block windows cover only what is written to them: p and r the
//   region of margin 2R (the first step's), the three derivatives that of
//   margin R (the first phase A's), 19% less scratch than whole windows
//   at the main plan.
//
// So a point of a pass reads its taps from shared memory and waits only on
// its pointwise operands (2 in phase A, 10 in phase B).  A thread reads
// the operands of TTI_POINTS points before it computes the first, so
// their reads are in flight together.  Shared memory at the main plan
// (tile 32, T = 4, order 4, R = 2, halo 16): phase A's rings of two 64^2
// fields, 196,608 B; phase B's rings and planes over 60^2, 201,600 B; one
// block an SM, 256 blocks.  By design a depth-4 launch moves ~107 GB over
// its 8 passes plus ~12 GB of copies (`stencil_tb.design_bytes`).
//
// Measured (PERF.md): 63-65 ms a depth-4 launch at 512^3 on a random
// state against 137.7 ms for the first schedule, and faster at every
// configuration where a sub-tile fits, depth 1 included.  Neither bytes
// nor operations hold it (~1.9 TB/s of its design bytes, 3.6% of its
// roofline bound).  Its param reads cost ~15 ms, one barrier a plane
// waits on the last of a thread's points (a plane's region seldom divides
// the block), and the IEEE division's slow path makes the time depend on
// the values: with the `/` operator a field of zeros cost +4 ms and one
// whose updates fall below float32's normal range +10 ms.  `qdiv` keeps
// zeros and tiny normal numerators off that path: the live 512^3
// wavefield's launch 69.0 → 66.3-66.8 ms, 1.2 ms more on a dense random
// field.
//
// The cluster-shared trapezoid (B5, tb_cluster.cuh) runs the z-streamed
// schedule's two phases point for point on a whole spec tile's trapezoid,
// a thread block cluster a tile and each pass's chunks spread over its
// blocks, for the deep halos of orders 8 and 12 (from halo 16), where a
// sub-tile's rings fit no block or overhang it many times and the first
// schedule recomputes 4-16x the tile's points a pass.  Measured (PERF.md),
// 512^3, tile 64, 2 blocks a cluster: order 8 at T = 2 ~33 ms a launch
// against 113.5 (first) and 73.7 (z-streamed), at T = 4 87 against 515.

#include "tb_cluster.cuh"

// ---------------------------------------------------------------------------
// The first schedule (sub-tile (0, 0)): the first design's kernel; in bf16
// the windows of p and r in the storage type, those of the inner
// derivatives float32 (`f32_words`)
// ---------------------------------------------------------------------------

// direction cosines of the rotated derivatives at one point (tti.py:57-63)
struct Dirs {
    float x0, x1, x2, y0, y1, z0, z1, z2;

    __device__ Dirs(float theta, float phi) {
        float sth, ct, sph, cp;
        sincosf(theta, &sth, &ct);
        sincosf(phi, &sph, &cp);
        x0 = ct * cp; x1 = ct * sph; x2 = -sth;     // Dx~
        y0 = -sph; y1 = cp;                         // Dy~
        z0 = sth * cp; z1 = sth * sph; z2 = ct;     // Dz~
    }
};

// two blocks an SM up to radius 4 (at most 64 registers a thread), as
// ptxas chose for the single-shot kernel; with the shot index it takes
// 128 and one block an SM, 12% slower at radius 2 (PERF.md)
template <int R, bool DOM, class S>
__global__ void __launch_bounds__(THREADS, R <= 4 ? 2 : 1)
tb_tti_kernel(const TileArgsT<S> a, const Coefs cf)
{
    constexpr int NT = 2 * R + 1;          // central first derivative taps
    // a tile's scratch in storage windows: p and r twice, then the three
    // float32 derivative windows
    constexpr int FW = f32_words<S>(), NW = 4 + 3 * FW;
    const TileT<S> t(a);
    S* pbuf[2] = {t.scratch(a, 0, NW), t.scratch(a, 1, NW)};
    S* rbuf[2] = {t.scratch(a, 2, NW), t.scratch(a, 3, NW)};
    float* gx = reinterpret_cast<float*>(t.scratch(a, 4, NW));  // Dx~p
    float* gy = reinterpret_cast<float*>(t.scratch(a, 4 + FW, NW));  // Dy~p
    float* gz = reinterpret_cast<float*>(t.scratch(a, 4 + 2 * FW, NW));
    const View vgx{gx, t.win_sx}, vgy{gy, t.win_sx}, vgz{gz, t.win_sx};
    const ViewT<S> m = t.input(a, 4), damp = t.input(a, 5);
    const ViewT<S> eps = t.input(a, 6), dlt = t.input(a, 7);
    const ViewT<S> theta = t.input(a, 8), phi = t.input(a, 9);
    ViewT<S> p = t.input(a, 0), p_prev = t.input(a, 1);
    ViewT<S> r = t.input(a, 2), r_prev = t.input(a, 3);

    for (int k = 0; k < a.T; ++k) {
        // phase A: the inner first-derivative fields, masked
        t.template for_each_point<DOM>([&](Pt q, bool inside) {
            const long long w = t.at(q);
            if (!inside) {
                gx[w] = 0.f;
                gy[w] = 0.f;
                gz[w] = 0.f;
                return;
            }
            const Dirs d(t.ro(theta, q), t.ro(phi, q));
            const float dxp = t.template taps<NT, -R>(p, 0, q, cf.c[0]);
            const float dyp = t.template taps<NT, -R>(p, 1, q, cf.c[1]);
            const float dzp = t.template taps<NT, -R>(p, 2, q, cf.c[2]);
            const float dxr = t.template taps<NT, -R>(r, 0, q, cf.c[0]);
            const float dyr = t.template taps<NT, -R>(r, 1, q, cf.c[1]);
            const float dzr = t.template taps<NT, -R>(r, 2, q, cf.c[2]);
            gx[w] = (d.x0 * dxp + d.x1 * dyp) + d.x2 * dzp;
            gy[w] = d.y0 * dxp + d.y1 * dyp;
            gz[w] = (d.z0 * dxr + d.z1 * dyr) + d.z2 * dzr;
        });
        __syncthreads();

        // phase B: the outer derivatives and the update; the new p and r
        // overwrite p_prev and r_prev, read only pointwise by this thread
        S* pn = pbuf[k & 1];
        S* rn = rbuf[k & 1];
        t.template for_each_point<DOM>([&](Pt q, bool inside) {
            const long long w = t.at(q);
            if (!inside) {
                pn[w] = from_f<S>(0.f);
                rn[w] = from_f<S>(0.f);
                return;
            }
            const Dirs d(t.ro(theta, q), t.ro(phi, q));
            const float gxx =
                (d.x0 * t.template taps<NT, -R>(vgx, 0, q, cf.c[0])
                 + d.x1 * t.template taps<NT, -R>(vgx, 1, q, cf.c[1]))
                + d.x2 * t.template taps<NT, -R>(vgx, 2, q, cf.c[2]);
            const float gyy =
                d.y0 * t.template taps<NT, -R>(vgy, 0, q, cf.c[0])
                + d.y1 * t.template taps<NT, -R>(vgy, 1, q, cf.c[1]);
            const float hz_r =
                (d.z0 * t.template taps<NT, -R>(vgz, 0, q, cf.c[0])
                 + d.z1 * t.template taps<NT, -R>(vgz, 1, q, cf.c[1]))
                + d.z2 * t.template taps<NT, -R>(vgz, 2, q, cf.c[2]);
            const float h0_p = gxx + gyy;
            const float e_fac = 1.f + 2.f * t.ro(eps, q);
            const float d_fac = sqrtf(1.f + 2.f * t.ro(dlt, q));
            const float mm = t.ro(m, q), dd = t.ro(damp, q);
            const float den = mm + dd * a.dt;
            const float rhs_p = e_fac * h0_p + d_fac * hz_r;
            const float rhs_r = d_fac * h0_p + hz_r;
            const float pc = t.ld(p, q), pp = t.ld(p_prev, q);
            const float rc = t.ld(r, q), rp = t.ld(r_prev, q);
            pn[w] = from_f<S>(
                (a.dt2 * rhs_p + mm * (2.f * pc - pp) + dd * a.dt * pc) / den);
            rn[w] = from_f<S>(
                (a.dt2 * rhs_r + mm * (2.f * rc - rp) + dd * a.dt * rc) / den);
        });
        __syncthreads();

        S* const inj[2] = {pn, rn};
        t.inject(a, k, inj);
        __syncthreads();
        t.template record<1>(a, k,
                             [&](long long w, float* s) { s[0] = to_f(pn[w]); });
        // the next phase A writes only the inner windows; the next phase B
        // (after a barrier) writes the buffers of this step's p and r
        p_prev = p;
        p = t.window(pn);
        r_prev = r;
        r = t.window(rn);
    }
    const ViewT<S> fin[4] = {p, p_prev, r, r_prev};
    t.template write_back<4>(a, fin);
}

// ---------------------------------------------------------------------------
// The z-streamed schedule (sub-tile (bx, by))
// ---------------------------------------------------------------------------

// shared memory of sub-tile (bx, by) at halo H and radius r: the larger of
// the first phase A pass (rings of p and r over the block window) and the
// first phase B pass (rings of Dx~p and Dz~r and two planes of Dy~p over
// the window less r), and at least the write-back's warp tiles
static long long tti_smem(int H, int r, int bx, int by)
{
    const long long ring = ring_planes(r);
    const long long a = 4LL * 2 * ring * (bx + 2 * H) * (by + 2 * H);
    const long long b =
        4LL * (2 * ring + 2) * (bx + 2 * H - 2 * r) * (by + 2 * H - 2 * r);
    const long long tiles = 4LL * (STREAM_THREADS / 32) * 32 * 33;
    const long long ab = a > b ? a : b;
    return ab > tiles ? ab : tiles;
}

// floats of one block's scratch windows (z-major, nz planes each): p and r
// twice over the region of margin 2r, where the first step's output
// starts, and Dx~p, Dy~p, Dz~r over the region of margin r, phase A's
// first
static long long tti_blk_floats(int nz, int H, int r, int bx, int by)
{
    return (long long)nz
        * (4LL * (bx + 2 * H - 4 * r) * (by + 2 * H - 4 * r)
           + 3LL * (bx + 2 * H - 2 * r) * (by + 2 * H - 2 * r));
}

// threads of a z-streamed block, and the points each takes at a time in
// a pass: the pointwise reads of all of them are issued before the first
// is computed
#define TTI_THREADS 512
#define TTI_POINTS 2

// One z-streamed pass of phase n.  NRING fields stream through rings of
// ring_planes(R) planes of their region of margin (n - 1) R, NPLANE fields
// (x/y taps only) through two planes of it; for each plane z, once its
// taps are resident, every point (x, y) of the region of margin n R
// (block-local coordinates) runs load(x, y, z), its pointwise reads, then
// f(those, ring centre, plane centre, ring stride, plane stride, row
// width, z taps, x, y, z): ring i's value at the point is ring centre[i *
// ring stride], plane j's plane centre[j * plane stride].
template <int R, int NRING, int NPLANE, class L, class F>
__device__ __forceinline__ void ring_pass(const Blk& b, float* sm,
                                          const ZView* ring,
                                          const ZView* plane, int n, L load,
                                          F f)
{
    constexpr int S = ring_planes(R);
    const int m0 = (n - 1) * R;
    const int h0 = b.bwx - 2 * m0, w0 = b.bwy - 2 * m0;
    const int h = h0 - 2 * R, w = w0 - 2 * R;
    const int cap = h0 * w0;
    float* const pl = sm + NRING * S * cap;
    const auto load_ring = [&](int z) {
#pragma unroll
        for (int i = 0; i < NRING; ++i)
            load_plane(sm + (i * S + z % S) * cap, ring[i], z, m0, m0, h0, w0);
    };
    const auto load_planes = [&](int z) {
#pragma unroll
        for (int j = 0; j < NPLANE; ++j)
            load_plane(pl + (2 * j + (z & 1)) * cap, plane[j], z, m0, m0, h0,
                       w0);
    };
    for (int z = 0; z <= R && z < b.nz; ++z) load_ring(z);
    load_planes(0);
    cp_async_commit();
    for (int z = 0; z < b.nz; ++z) {
        cp_async_wait_all();
        __syncthreads();
        // the slot of plane z + R + 1 held plane z - R - 1 and the plane
        // buffer of z + 1 held plane z - 1, both last read at plane z - 1
        if (z + R + 1 < b.nz) load_ring(z + R + 1);
        if (z + 1 < b.nz) load_planes(z + 1);
        cp_async_commit();
        const ZTaps<R> zt(z, b.nz, cap);
        const float* rc = sm + (z % S) * cap + R * w0 + R;
        const float* pc = pl + (z & 1) * cap + R * w0 + R;
        Walk p(w);
        for (int i = threadIdx.x; i < h * w;
             i += TTI_POINTS * blockDim.x) {
            int px[TTI_POINTS], py[TTI_POINTS];
            decltype(load(0, 0, 0)) op[TTI_POINTS];
#pragma unroll
            for (int j = 0; j < TTI_POINTS; ++j) {
                px[j] = p.x;
                py[j] = p.y;
                if (i + j * (int)blockDim.x < h * w)
                    op[j] = load(p.x + n * R, p.y + n * R, z);
                p.next();
            }
#pragma unroll
            for (int j = 0; j < TTI_POINTS; ++j) {
                if (i + j * (int)blockDim.x >= h * w) break;
                const int ci = px[j] * w0 + py[j];
                f(op[j], rc + ci, pc + ci, S * cap, 2 * cap, w0, zt,
                  px[j] + n * R, py[j] + n * R, z);
            }
        }
    }
    __syncthreads();
}

// n / d as the `/` operator rounds it, without its slow path where the
// live wavefield sends it most: a zero over a positive finite d is that
// zero, and a numerator below 2^-100 whose quotient may be normal is
// scaled by 2^64 (exactly), divided and scaled back (exactly, when the
// quotient is normal: rounding then commutes with the scaling)
__device__ __forceinline__ float qdiv(float n, float d)
{
    const float an = fabsf(n);
    if (an < 0x1p-100f) {
        if (n == 0.f && d > 0.f && d <= 0x1.fffffep127f) return n;
        if (an >= 0x1p-124f * fabsf(d)) {
            const float q = (n * 0x1p64f) / d;
            if (fabsf(q) >= 0x1p-61f) return q * 0x1p-64f;
        }
    }
    return n / d;
}

// a point's pointwise reads in phase A (inside the domain, theta, phi)
// and in phase B (and epsilon, delta, m, damp, p, p_prev, r, r_prev)
struct OpsA {
    bool in;
    float th, ph;
};
struct OpsB {
    bool in;
    float th, ph, eps, dlt, m, damp, p, pp, r, rp;
};

template <int R, bool DOM, class S>
__global__ void __launch_bounds__(TTI_THREADS, 1)
tb_tti_kernel(const TileArgsT<S> a, const Coefs cf, const StreamArgs s)
{
    constexpr int NT = 2 * R + 1;          // central first derivative taps
    extern __shared__ __align__(16) float sm[];
    const Blk b(a, s);
    const int nz = a.nz, tid = threadIdx.x, nt = blockDim.x;
    ZView p = b.copy(s, a.nshots, 0), p_prev = b.copy(s, a.nshots, 1);
    ZView r = b.copy(s, a.nshots, 2), r_prev = b.copy(s, a.nshots, 3);
    // the params' copies: m, damp, epsilon, delta, theta, phi, all with
    // the strides of m's (`par`)
    const ZView par = b.copy(s, a.nshots, 4);
    const float* const m = par.p;
    const float* const damp = b.copy(s, a.nshots, 5).p;
    const float* const eps = b.copy(s, a.nshots, 6).p;
    const float* const dlt = b.copy(s, a.nshots, 7).p;
    const float* const theta = b.copy(s, a.nshots, 8).p;
    const float* const phi = b.copy(s, a.nshots, 9).p;
    // the block's windows (`tti_blk_floats`), each addressed from the
    // block window's origin: element (x, y, z) of a window over the region
    // of margin m R at [z * plane + x * row + y], row = bwy - 2 m R
    const int row2 = b.bwy - 4 * R, row1 = b.bwy - 2 * R;
    const int pl2 = (b.bwx - 4 * R) * row2, pl1 = (b.bwx - 2 * R) * row1;
    float* const blk = s.blk + b.blin * s.blk_floats - 2 * R * row2 - 2 * R;
    const long long v2 = (long long)nz * pl2, v1 = (long long)nz * pl1;
    float* const pbuf[2] = {blk, blk + v2};
    float* const rbuf[2] = {blk + 2 * v2, blk + 3 * v2};
    float* const gx = blk + 4 * v2 + 2 * R * row2 + 2 * R
        - R * row1 - R;                    // Dx~p
    float* const gy = gx + v1;             // Dy~p
    float* const gz = gy + v1;             // Dz~r
    const auto view2 = [&](const float* q) { return ZView{q, row2, pl2}; };
    const auto view1 = [&](const float* q) { return ZView{q, row1, pl1}; };

    // first derivative taps along x, y (a region point's taps stay in the
    // previous region: no window check) and z (zero beyond [0, nz), as the
    // first schedule), from the centre c of a plane of rows w0 wide; each
    // sum starts from 0 and adds its taps in order, as Tile::taps does
    const auto tap_x = [&](const float* c, int w0) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < NT; ++k) acc += c[(k - R) * w0] * cf.c[0][k];
        return acc;
    };
    const auto tap_y = [&](const float* c) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < NT; ++k) acc += c[k - R] * cf.c[1][k];
        return acc;
    };
    const auto tap_z = [&](const float* c, const ZTaps<R>& zt) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < NT; ++k) {
            const float v = (zt.mask >> k) & 1 ? c[zt.d[k]] : 0.f;
            acc += v * cf.c[2][k];
        }
        return acc;
    };

    for (int k = 0; k < a.T; ++k) {
        // phase A: the inner first-derivative fields, masked
        {
            const ZView ring[2] = {p, r};
            ring_pass<R, 2, 0>(b, sm, ring, nullptr, 2 * k + 1,
                [&](int x, int y, int z) {
                OpsA o;
                o.in = b.template in_domain<DOM>(x, y);
                if (o.in) {
                    const long long pi = par.idx(x, y, z);
                    o.th = __ldg(theta + pi);
                    o.ph = __ldg(phi + pi);
                }
                return o;
            },
                [&](const OpsA& o, const float* rc, const float*, int rs,
                    int, int w0, const ZTaps<R>& zt, int x, int y, int z) {
                const int wi = z * pl1 + x * row1 + y;
                if (!o.in) {
                    gx[wi] = 0.f;
                    gy[wi] = 0.f;
                    gz[wi] = 0.f;
                    return;
                }
                const Dirs d(o.th, o.ph);
                const float* pc = rc;
                const float* rcc = rc + rs;
                const float dxp = tap_x(pc, w0);
                const float dyp = tap_y(pc);
                const float dzp = tap_z(pc, zt);
                const float dxr = tap_x(rcc, w0);
                const float dyr = tap_y(rcc);
                const float dzr = tap_z(rcc, zt);
                gx[wi] = (d.x0 * dxp + d.x1 * dyp) + d.x2 * dzp;
                gy[wi] = d.y0 * dxp + d.y1 * dyp;
                gz[wi] = (d.z0 * dxr + d.z1 * dyr) + d.z2 * dzr;
            });
        }

        // phase B: the outer derivatives and the update; the new p and r
        // overwrite p_prev and r_prev (or, at the first step, fill the
        // buffers), read only pointwise by the thread that overwrites them
        float* const pn = pbuf[k & 1];
        float* const rn = rbuf[k & 1];
        {
            const ZView ring[2] = {view1(gx), view1(gz)};
            const ZView plane[1] = {view1(gy)};
            ring_pass<R, 2, 1>(b, sm, ring, plane, 2 * k + 2,
                [&](int x, int y, int z) {
                OpsB o;
                o.in = b.template in_domain<DOM>(x, y);
                if (o.in) {
                    const long long pi = par.idx(x, y, z);
                    o.th = __ldg(theta + pi);
                    o.ph = __ldg(phi + pi);
                    o.eps = __ldg(eps + pi);
                    o.dlt = __ldg(dlt + pi);
                    o.m = __ldg(m + pi);
                    o.damp = __ldg(damp + pi);
                    o.p = p.at(x, y, z);
                    o.pp = p_prev.at(x, y, z);
                    o.r = r.at(x, y, z);
                    o.rp = r_prev.at(x, y, z);
                }
                return o;
            },
                [&](const OpsB& o, const float* rc, const float* pc, int rs,
                    int, int w0, const ZTaps<R>& zt, int x, int y, int z) {
                const int wi = z * pl2 + x * row2 + y;
                if (!o.in) {
                    pn[wi] = 0.f;
                    rn[wi] = 0.f;
                    return;
                }
                const Dirs d(o.th, o.ph);
                const float* vgx = rc;
                const float* vgz = rc + rs;
                const float gxx = (d.x0 * tap_x(vgx, w0) + d.x1 * tap_y(vgx))
                    + d.x2 * tap_z(vgx, zt);
                const float gyy = d.y0 * tap_x(pc, w0) + d.y1 * tap_y(pc);
                const float hz_r = (d.z0 * tap_x(vgz, w0)
                                    + d.z1 * tap_y(vgz))
                    + d.z2 * tap_z(vgz, zt);
                const float h0_p = gxx + gyy;
                const float e_fac = 1.f + 2.f * o.eps;
                const float d_fac = sqrtf(1.f + 2.f * o.dlt);
                const float mm = o.m, dd = o.damp;
                const float den = mm + dd * a.dt;
                const float rhs_p = e_fac * h0_p + d_fac * hz_r;
                const float rhs_r = d_fac * h0_p + hz_r;
                pn[wi] = rnd<S>(qdiv(a.dt2 * rhs_p + mm * (2.f * o.p - o.pp)
                                     + dd * a.dt * o.p, den));
                rn[wi] = rnd<S>(qdiv(a.dt2 * rhs_r + mm * (2.f * o.r - o.rp)
                                     + dd * a.dt * o.r, den));
            });
        }

        // inject the source values into p and r inside phase B's region,
        // then record p at the owned receivers
        const int mB = (2 * k + 2) * R;
        for (int q = tid; q < a.src_cap; q += nt) {
            const int* c = a.src_coords + (b.tile * a.src_cap + q) * 3;
            const float v =
                to_f(a.src_vals[(b.tile * a.T + k) * a.src_cap + q]);
            int x, y;
            if (v == 0.f || !b.in_region(c, mB, &x, &y)) continue;
            const int wi = c[2] * pl2 + x * row2 + y;
            pn[wi] = rnd<S>(pn[wi] + v);
            rn[wi] = rnd<S>(rn[wi] + v);
        }
        __syncthreads();
        for (int q = tid; q < a.rec_cap; q += nt) {
            const int* c = a.rec_coords + (b.tile * a.rec_cap + q) * 3;
            if (!b.owns(c)) continue;
            const int wi =
                c[2] * pl2 + (c[0] - b.wox) * row2 + (c[1] - b.woy);
            a.rec_out[(b.tile * a.T + k) * a.rec_cap + q] = from_f<S>(
                to_f(a.rec_w[b.tile * a.rec_cap + q]) * pn[wi]);
        }
        // the next phase A only reads p and r; the next phase B writes the
        // buffers of this step's p_prev and r_prev, after a barrier
        p_prev = p;
        p = view2(pn);
        r_prev = r;
        r = view2(rn);
    }

    // write back the centre: one warp a 32 x 32 (y, z) tile of one x row,
    // read along y from a z-major field, written along z
    const ZView fin[4] = {p, p_prev, r, r_prev};
    const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
    float* tile = sm + warp * 32 * 33;
    const int nyt = (b.by + 31) / 32, nzt = (nz + 31) / 32;
    const long long base = b.shot * a.out_shot;
    for (int it = warp; it < 4 * b.bx * nyt * nzt; it += nwarps) {
        int q = it;
        const int z0 = (q % nzt) * 32;
        q /= nzt;
        const int y0 = (q % nyt) * 32;
        q /= nyt;
        const int x = q % b.bx, f = q / b.bx;
        const ZView v = fin[f];
        const float* src = v.p + (long long)(b.H + x) * v.sx + b.H;
        for (int j = 0; j < 32; ++j) {
            const int z = z0 + j, y = y0 + lane;
            tile[j * 33 + lane] = (z < nz && y < b.by) ? src[z * v.sz + y] : 0.f;
        }
        __syncwarp();
        const long long gxo = (long long)b.ti * b.tx + b.wox + x;
        for (int j = 0; j < 32; ++j) {
            const int y = y0 + j, z = z0 + lane;
            if (y < b.by && z < nz)
                a.out[f][base + (gxo * b.ny + b.tj * b.ty + b.woy + y) * nz + z]
                    = from_f<S>(tile[lane * 33 + j]);
        }
        __syncwarp();
    }
}

// ---------------------------------------------------------------------------
// The cluster-shared trapezoid (B5, tb_cluster.cuh)
// ---------------------------------------------------------------------------

// shared memory of a B5 chunk of pass n whose load rectangle is lh x lw:
// phase A's rings of p and r, or phase B's rings of Dx~p and Dz~r and two
// planes of Dy~p; at least the write-back's warp tiles
// (`stencil_tb.chunk_smem`)
static long long tti_chunk_smem(int R, int n, int lh, int lw)
{
    const long long ring = ring_planes(R);
    const long long planes = n % 2 ? 2 * ring : 2 * ring + 2;
    const long long need = 4LL * planes * lh * lw;
    const long long tiles = 4LL * (STREAM_THREADS / 32) * 32 * 33;
    return need > tiles ? need : tiles;
}

// The same phases as the z-streamed kernel above, point for point, on the
// spec tile's trapezoid: each pass over this block's chunks, the cluster's
// blocks meeting at a barrier between passes, one point of a thread at a
// time (TTI_POINTS points spilled registers at radius 6 and were 4-7%
// slower; PERF.md).  The spec tile's windows (7, z-major over the spec
// window): p and r twice, Dx~p, Dy~p, Dz~r.
template <int R, bool DOM, class S>
__global__ void __launch_bounds__(TTI_THREADS, 1)
tb_tti_kernel(const TileArgsT<S> a, const Coefs cf, const StreamArgs s,
              const ClusterArgs c)
{
    constexpr int NT = 2 * R + 1;          // central first derivative taps
    extern __shared__ __align__(16) float sm[];
    const CBlk b(a, c);
    const int nz = a.nz, tid = threadIdx.x, nt = blockDim.x;
    ZView p = b.copy(s, a.nshots, 0), p_prev = b.copy(s, a.nshots, 1);
    ZView r = b.copy(s, a.nshots, 2), r_prev = b.copy(s, a.nshots, 3);
    const ZView par = b.copy(s, a.nshots, 4);
    const float* const m = par.p;
    const float* const damp = b.copy(s, a.nshots, 5).p;
    const float* const eps = b.copy(s, a.nshots, 6).p;
    const float* const dlt = b.copy(s, a.nshots, 7).p;
    const float* const theta = b.copy(s, a.nshots, 8).p;
    const float* const phi = b.copy(s, a.nshots, 9).p;
    float* const pbuf[2] = {b.window(s, 0), b.window(s, 1)};
    float* const rbuf[2] = {b.window(s, 2), b.window(s, 3)};
    float* const gx = b.window(s, 4);      // Dx~p
    float* const gy = b.window(s, 5);      // Dy~p
    float* const gz = b.window(s, 6);      // Dz~r
    const long long row = b.wy, plane = (long long)b.wx * b.wy;

    const auto tap_x = [&](const float* q, int w0) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < NT; ++k) acc += q[(k - R) * w0] * cf.c[0][k];
        return acc;
    };
    const auto tap_y = [&](const float* q) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < NT; ++k) acc += q[k - R] * cf.c[1][k];
        return acc;
    };
    const auto tap_z = [&](const float* q, const ZTaps<R>& zt) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < NT; ++k) {
            const float v = (zt.mask >> k) & 1 ? q[zt.d[k]] : 0.f;
            acc += v * cf.c[2][k];
        }
        return acc;
    };

    int cb, ce;
    for (int k = 0; k < a.T; ++k) {
        // phase A: the inner first-derivative fields, masked
        {
            const ZView ring[2] = {p, r};
            b.chunks(2 * k + 1, &cb, &ce);
            for (int i = cb; i < ce; ++i)
                chunk_pass<R, 2, 0>(sm, ring, nullptr, nz, b.chunk(i),
                    [&](int x, int y, int z) {
                    OpsA o;
                    o.in = b.template in_domain<DOM>(x, y);
                    if (o.in) {
                        const long long pi = par.idx(x, y, z);
                        o.th = __ldg(theta + pi);
                        o.ph = __ldg(phi + pi);
                    }
                    return o;
                },
                    [&](const OpsA& o, const float* rc, const float*, int rs,
                        int, int w0, const ZTaps<R>& zt, int x, int y,
                        int z) {
                    const long long wi = z * plane + x * row + y;
                    if (!o.in) {
                        gx[wi] = 0.f;
                        gy[wi] = 0.f;
                        gz[wi] = 0.f;
                        return;
                    }
                    const Dirs d(o.th, o.ph);
                    const float* pc = rc;
                    const float* rcc = rc + rs;
                    const float dxp = tap_x(pc, w0);
                    const float dyp = tap_y(pc);
                    const float dzp = tap_z(pc, zt);
                    const float dxr = tap_x(rcc, w0);
                    const float dyr = tap_y(rcc);
                    const float dzr = tap_z(rcc, zt);
                    gx[wi] = (d.x0 * dxp + d.x1 * dyp) + d.x2 * dzp;
                    gy[wi] = d.y0 * dxp + d.y1 * dyp;
                    gz[wi] = (d.z0 * dxr + d.z1 * dyr) + d.z2 * dzr;
                });
        }
        cluster_barrier();

        // phase B: the outer derivatives and the update; the new p and r
        // overwrite p_prev and r_prev (or, at the first step, fill the
        // windows), read only pointwise at the point overwritten
        const int n = 2 * k + 2;
        float* const pn = pbuf[k & 1];
        float* const rn = rbuf[k & 1];
        {
            const ZView ring[2] = {b.view(gx), b.view(gz)};
            const ZView pln[1] = {b.view(gy)};
            b.chunks(n, &cb, &ce);
            for (int i = cb; i < ce; ++i)
                chunk_pass<R, 2, 1>(sm, ring, pln, nz, b.chunk(i),
                    [&](int x, int y, int z) {
                    OpsB o;
                    o.in = b.template in_domain<DOM>(x, y);
                    if (o.in) {
                        const long long pi = par.idx(x, y, z);
                        o.th = __ldg(theta + pi);
                        o.ph = __ldg(phi + pi);
                        o.eps = __ldg(eps + pi);
                        o.dlt = __ldg(dlt + pi);
                        o.m = __ldg(m + pi);
                        o.damp = __ldg(damp + pi);
                        o.p = p.at(x, y, z);
                        o.pp = p_prev.at(x, y, z);
                        o.r = r.at(x, y, z);
                        o.rp = r_prev.at(x, y, z);
                    }
                    return o;
                },
                    [&](const OpsB& o, const float* rc, const float* pc,
                        int rs, int, int w0, const ZTaps<R>& zt, int x, int y,
                        int z) {
                    const long long wi = z * plane + x * row + y;
                    if (!o.in) {
                        pn[wi] = 0.f;
                        rn[wi] = 0.f;
                        return;
                    }
                    const Dirs d(o.th, o.ph);
                    const float* vgx = rc;
                    const float* vgz = rc + rs;
                    const float gxx = (d.x0 * tap_x(vgx, w0)
                                       + d.x1 * tap_y(vgx))
                        + d.x2 * tap_z(vgx, zt);
                    const float gyy = d.y0 * tap_x(pc, w0) + d.y1 * tap_y(pc);
                    const float hz_r = (d.z0 * tap_x(vgz, w0)
                                        + d.z1 * tap_y(vgz))
                        + d.z2 * tap_z(vgz, zt);
                    const float h0_p = gxx + gyy;
                    const float e_fac = 1.f + 2.f * o.eps;
                    const float d_fac = sqrtf(1.f + 2.f * o.dlt);
                    const float mm = o.m, dd = o.damp;
                    const float den = mm + dd * a.dt;
                    const float rhs_p = e_fac * h0_p + d_fac * hz_r;
                    const float rhs_r = d_fac * h0_p + hz_r;
                    pn[wi] = rnd<S>(qdiv(a.dt2 * rhs_p
                                         + mm * (2.f * o.p - o.pp)
                                         + dd * a.dt * o.p, den));
                    rn[wi] = rnd<S>(qdiv(a.dt2 * rhs_r
                                         + mm * (2.f * o.r - o.rp)
                                         + dd * a.dt * o.r, den));
                });
        }

        // inject the source values into p and r at the points this block's
        // chunks of phase B hold, then record p at those of the receivers
        for (int q = tid; q < a.src_cap; q += nt) {
            const int* cc = a.src_coords + (b.tile * a.src_cap + q) * 3;
            const float v =
                to_f(a.src_vals[(b.tile * a.T + k) * a.src_cap + q]);
            if (v == 0.f || cc[2] < 0 || cc[2] >= nz
                || !b.holds(n, cc[0], cc[1]))
                continue;
            const long long wi = cc[2] * plane + cc[0] * row + cc[1];
            pn[wi] = rnd<S>(pn[wi] + v);
            rn[wi] = rnd<S>(rn[wi] + v);
        }
        __syncthreads();
        for (int q = tid; q < a.rec_cap; q += nt) {
            const int* cc = a.rec_coords + (b.tile * a.rec_cap + q) * 3;
            if (!b.in_centre(cc) || !b.holds(n, cc[0], cc[1])) continue;
            const long long wi = cc[2] * plane + cc[0] * row + cc[1];
            a.rec_out[(b.tile * a.T + k) * a.rec_cap + q] = from_f<S>(
                to_f(a.rec_w[b.tile * a.rec_cap + q]) * pn[wi]);
        }
        // the next phase A reads this step's p and r from every block's
        // chunks; the next phase B overwrites this step's p_prev and r_prev
        cluster_barrier();
        p_prev = p;
        p = b.view(pn);
        r_prev = r;
        r = b.view(rn);
    }

    // write back this block's chunks of the last pass: the tile's centre
    const ZView fin[4] = {p, p_prev, r, r_prev};
    b.chunks(2 * a.T, &cb, &ce);
    for (int i = cb; i < ce; ++i)
        write_back_chunk<4>(a, b, sm, fin, b.chunk(i));
}

#if TB_F32_PART
// the params' z-major copies for `repro_tb_tile(_bf16)` and
// `repro_tb_tile_cluster(_bf16)` with PARAMS_COPIED (see tb_stream.cuh)
extern "C" int repro_tb_param_copies(int device, const float* const* in,
                                     int nparam, int param_rows, int nshots,
                                     int nx, int ny, int nz, int H,
                                     float* out, void* stream)
{
    return param_copies(device, in, nparam, param_rows, nshots, nx, ny, nz,
                        H, out, stream);
}
#endif

#if TB_BF16_PART
extern "C" int repro_tb_param_copies_bf16(
    int device, const __nv_bfloat16* const* in, int nparam, int param_rows,
    int nshots, int nx, int ny, int nz, int H, float* out, void* stream)
{
    return param_copies(device, in, nparam, param_rows, nshots, nx, ny, nz,
                        H, out, stream);
}
#endif

// fills the arguments and launches, on sub-tile (bx, by), the copies and
// the z-streamed instantiation of `radius` (and of whether `dom` is
// given), or with bx = 0 the first schedule's; a radius S is not built at
// (`radius_built`) is refused
template <class S>
static int launch(int device, const S* const* in, const int* src_coords,
                  const S* src_vals, const int* rec_coords, const S* rec_w,
                  S* const* out, S* rec_out, S* scratch, const float* dom,
                  int param_rows, int nshots, int nx, int ny, int nz, int tx,
                  int ty, int T, int H, int src_cap, int rec_cap, int radius,
                  const float* coefs, float dt, float dt2, int bx, int by,
                  void* stream)
{
    TileArgsT<S> a;
    Coefs cf;
    const int e = tile_args(&a, &cf, device, 10, 4, in, src_coords,
                            src_vals, rec_coords, rec_w, out, rec_out,
                            scratch, dom, param_rows & PARAM_ROWS, nshots,
                            nx, ny, nz, tx, ty, T, H, src_cap, rec_cap,
                            radius, coefs, 2 * radius + 1, dt, dt2);
    if (e) return e;
    if (!radius_built<S>(radius)) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    if (bx == 0) {
        with_radius(radius, dom != nullptr, [&](auto r, auto d) {
            if constexpr (radius_built<S>(decltype(r)::value))
                tb_tti_kernel<decltype(r)::value, decltype(d)::value, S>
                    <<<tile_grid(a), THREADS, 0, st>>>(a, cf);
        });
        return (int)cudaGetLastError();
    }
    const long long smem = tti_smem(H, radius, bx, by);
    if (H != 2 * T * radius || !subtile_ok(tx, ty, bx, by, smem))
        return (int)cudaErrorInvalidValue;
    StreamArgs s = stream_args(a, reinterpret_cast<float*>(scratch), 4, 6,
                               param_rows, bx, by, 7);
    s.blk_floats = tti_blk_floats(nz, H, radius, bx, by);
    launch_to_zmajor(a, s, 6, param_rows, st);
    int rc = 0;
    with_radius(radius, dom != nullptr, [&](auto r, auto d) {
        constexpr int KR = decltype(r)::value;
        constexpr bool KD = decltype(d)::value;
        if constexpr (radius_built<S>(KR)) {
            void (*kern)(const TileArgsT<S>, const Coefs, const StreamArgs) =
                tb_tti_kernel<KR, KD, S>;
            rc = (int)cudaFuncSetAttribute(
                kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (rc == 0)
                kern<<<stream_grid(nx, ny, tx, ty, s, nshots), TTI_THREADS,
                       smem, st>>>(a, cf, s);
        }
    });
    return rc ? rc : (int)cudaGetLastError();
}

#if TB_F32_PART
// (bx, by): the z-streamed schedule's sub-tile, or (0, 0) for the first
// schedule, whose scratch is then seven windows a tile (float32; in bf16
// the four of p and r in bf16)
extern "C" int repro_tb_tile(
    int device, const float* const* in, const int* src_coords,
    const float* src_vals, const int* rec_coords, const float* rec_w,
    float* const* out, float* rec_out, float* scratch, const float* dom,
    int param_rows, int nshots, int nx, int ny, int nz, int tx, int ty, int T,
    int H, int src_cap, int rec_cap, int radius, const float* coefs, float dt,
    float dt2, int bx, int by, void* stream)
{
    return launch<float>(device, in, src_coords, src_vals, rec_coords, rec_w,
                         out, rec_out, scratch, dom, param_rows, nshots, nx,
                         ny, nz, tx, ty, T, H, src_cap, rec_cap, radius, coefs,
                         dt, dt2, bx, by, stream);
}
#endif

#if TB_BF16_PART
// B1b-bf16 (B1c-bf16 with `dom`): fields, params, source values, receiver
// weights and partials in bf16; the z-streamed schedule's scratch (float32
// copies and windows) is passed as it is
extern "C" int repro_tb_tile_bf16(
    int device, const __nv_bfloat16* const* in, const int* src_coords,
    const __nv_bfloat16* src_vals, const int* rec_coords,
    const __nv_bfloat16* rec_w, __nv_bfloat16* const* out,
    __nv_bfloat16* rec_out, __nv_bfloat16* scratch, const float* dom,
    int param_rows, int nshots, int nx, int ny, int nz, int tx, int ty, int T,
    int H, int src_cap, int rec_cap, int radius, const float* coefs, float dt,
    float dt2, int bx, int by, void* stream)
{
    return launch<__nv_bfloat16>(
        device, in, src_coords, src_vals, rec_coords, rec_w, out, rec_out,
        scratch, dom, param_rows, nshots, nx, ny, nz, tx, ty, T, H, src_cap,
        rec_cap, radius, coefs, dt, dt2, bx, by, stream);
}

// whether the bf16 kernel is built at `radius` (`radius_built`, with or
// without a domain mask): what the wrapper asks before a bf16 launch
extern "C" int repro_bf16_built(int radius, int dom)
{
    (void)dom;
    return radius >= 1 && radius <= MAX_RADIUS
        && radius_built<__nv_bfloat16>(radius);
}
#endif

// B5 (tb_cluster.cuh): `cluster` blocks a spec tile, `table` the chunk
// table (`stencil_tb.chunk_table`, `len` ints) on the host, checked here,
// and `table_dev` its copy on the device, `smem` the shared bytes a block;
// the scratch is the z-major copies and seven spec windows a tile, float32
template <class S>
static int launch_cluster(
    int device, const S* const* in, const int* src_coords, const S* src_vals,
    const int* rec_coords, const S* rec_w, S* const* out, S* rec_out,
    float* scratch, const float* dom, int param_rows, int nshots, int nx,
    int ny, int nz, int tx, int ty, int T, int H, int src_cap, int rec_cap,
    int radius, const float* coefs, float dt, float dt2, int cluster,
    const int* table, const int* table_dev, int len, int smem, void* stream)
{
    TileArgsT<S> a;
    Coefs cf;
    const int e = tile_args(&a, &cf, device, 10, 4, in, src_coords,
                            src_vals, rec_coords, rec_w, out, rec_out,
                            reinterpret_cast<S*>(scratch), dom,
                            param_rows & PARAM_ROWS, nshots, nx, ny, nz, tx,
                            ty, T, H, src_cap, rec_cap, radius, coefs,
                            2 * radius + 1, dt, dt2);
    if (e) return e;
    if (H != 2 * T * radius || cluster < 1 || cluster > CLUSTER_MAX
        || smem > STREAM_SMEM || (long long)(nx / tx) * (ny / ty) > 65535
        || !radius_built<S>(radius))
        return (int)cudaErrorInvalidValue;
    const int rc0 = check_chunks(
        table, len, 2 * T, cluster, tx + 2 * H, ty + 2 * H, radius, smem,
        [&](int n, int lh, int lw) {
            return tti_chunk_smem(radius, n, lh, lw);
        });
    if (rc0) return rc0;
    const StreamArgs s = stream_args(a, scratch, 4, 6, param_rows, tx, ty, 7);
    if (!cluster_aligned(a, s)) return (int)cudaErrorInvalidValue;
    const ClusterArgs c{table_dev, cluster, 2 * T};
    const cudaStream_t st = (cudaStream_t)stream;
    launch_to_zmajor(a, s, 6, param_rows, st);
    const dim3 grid(cluster, (nx / tx) * (ny / ty), nshots);
    int rc = 0;
    with_radius(radius, dom != nullptr, [&](auto r, auto d) {
        if constexpr (radius_built<S>(decltype(r)::value)) {
            void (*kern)(const TileArgsT<S>, const Coefs, const StreamArgs,
                         const ClusterArgs) =
                tb_tti_kernel<decltype(r)::value, decltype(d)::value, S>;
            rc = cluster_launch(kern, cluster, grid, TTI_THREADS, smem, st,
                                a, cf, s, c);
        }
    });
    return rc;
}

#if TB_F32_PART
extern "C" int repro_tb_tile_cluster(
    int device, const float* const* in, const int* src_coords,
    const float* src_vals, const int* rec_coords, const float* rec_w,
    float* const* out, float* rec_out, float* scratch, const float* dom,
    int param_rows, int nshots, int nx, int ny, int nz, int tx, int ty, int T,
    int H, int src_cap, int rec_cap, int radius, const float* coefs, float dt,
    float dt2, int cluster, const int* table, const int* table_dev, int len,
    int smem, void* stream)
{
    return launch_cluster<float>(
        device, in, src_coords, src_vals, rec_coords, rec_w, out, rec_out,
        scratch, dom, param_rows, nshots, nx, ny, nz, tx, ty, T, H, src_cap,
        rec_cap, radius, coefs, dt, dt2, cluster, table, table_dev, len, smem,
        stream);
}
#endif

#if TB_BF16_PART
// B5 in bf16 (B1b-bf16), as `repro_tb_tile_bf16`: the float32 scratch is
// passed as it is
extern "C" int repro_tb_tile_cluster_bf16(
    int device, const __nv_bfloat16* const* in, const int* src_coords,
    const __nv_bfloat16* src_vals, const int* rec_coords,
    const __nv_bfloat16* rec_w, __nv_bfloat16* const* out,
    __nv_bfloat16* rec_out, float* scratch, const float* dom,
    int param_rows, int nshots, int nx, int ny, int nz, int tx, int ty, int T,
    int H, int src_cap, int rec_cap, int radius, const float* coefs, float dt,
    float dt2, int cluster, const int* table, const int* table_dev, int len,
    int smem, void* stream)
{
    return launch_cluster<__nv_bfloat16>(
        device, in, src_coords, src_vals, rec_coords, rec_w, out, rec_out,
        scratch, dom, param_rows, nshots, nx, ny, nz, tx, ty, T, H, src_cap,
        rec_cap, radius, coefs, dt, dt2, cluster, table, table_dev, len, smem,
        stream);
}
#endif

// the clusters of B5 blocks of storage type S (`cluster` a cluster,
// `smem` shared bytes a block) the card holds at once, into *active (0:
// none; a launch raises)
template <class S>
static int cluster_occupancy(int radius, int dom, int cluster, int smem,
                             int* active)
{
    if (radius < 1 || radius > MAX_RADIUS || cluster < 1
        || cluster > CLUSTER_MAX || smem > STREAM_SMEM
        || !radius_built<S>(radius))
        return (int)cudaErrorInvalidValue;
    int rc = 0;
    with_radius(radius, dom != 0, [&](auto r, auto d) {
        if constexpr (radius_built<S>(decltype(r)::value)) {
            void (*kern)(const TileArgsT<S>, const Coefs, const StreamArgs,
                         const ClusterArgs) =
                tb_tti_kernel<decltype(r)::value, decltype(d)::value, S>;
            cudaLaunchAttribute attr;
            cudaLaunchConfig_t cfg;
            rc = cluster_config(kern, cluster, dim3(cluster), TTI_THREADS,
                                smem, nullptr, &attr, &cfg, active);
        }
    });
    return rc;
}

#if TB_F32_PART
extern "C" int repro_tb_cluster_occupancy(int radius, int dom, int cluster,
                                          int smem, int* active)
{
    return cluster_occupancy<float>(radius, dom, cluster, smem, active);
}
#endif

#if TB_BF16_PART
extern "C" int repro_tb_cluster_occupancy_bf16(int radius, int dom,
                                               int cluster, int smem,
                                               int* active)
{
    return cluster_occupancy<__nv_bfloat16>(radius, dom, cluster, smem,
                                            active);
}
#endif
