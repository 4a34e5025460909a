// Temporally-blocked isotropic elastic (velocity-stress) time tile for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_tb_kernel` of
// src/repro/kernels/stencil_tb.py (launched by `tb_time_tile`) with
// `tb_physics.ELASTIC`, in float32: state vx, vy, vz, txx, tyy, tzz, txy,
// txz, tyz; params lam, mu, b, damp.  Per (x, y) tile, T times
// (src/repro/core/propagators/elastic.py:64-111):
//
//   phase V: the three velocities from the old stresses,
//     v = dmp (v + (dt b) (d1 + d2 + d3)) with dmp = 1 / (1 + damp dt),
//     then zero outside the physical x/y domain (the reference's
//     `mask_fn`);
//   phase S: the six stresses from the new velocities, e.g.
//     txx = dmp (txx + dt (lam div v + (2 mu) dvx/dx)),
//     txy = dmp (txy + (dt mu) (dvx/dy + dvy/dx)), then the domain mask;
//   inject the source values into txx, tyy and tzz; record w * vz and
//   w * (-(txx + tyy + tzz) / 3) at the receivers.
//
// Staggered derivatives have `order` taps: forward (offsets 1-R..R) when
// the operand's staggering bit on that axis is 0, backward (-R..R-1) when
// it is 1, as `_d` chooses; the host passes the one set of weights both
// use.  Every expression and tap order is the first design's, and the
// build turns multiply-add contraction off, so each point rounds as
// before.
//
// What bounds it: bytes — 13 fields in and 9 out, 11.8 GB at 512^3, 3.53
// ms at 3.35 TB/s, against 165 flops a point-step.
//
// Three schedules compute the same function; the wrapper picks one a
// launch from its shape (`stencil_tb.launch_plan`) and passes the
// z-streamed schedule's sub-tile, or (0, 0) for the first schedule, to
// `repro_tb_tile`, or B5's chunk table to `repro_tb_tile_cluster`:
//
// The first schedule (the port's first design, kept as it was) re-reads
// every field from device memory at every tap of every in-window step,
// over the whole window, one block a tile with nine scratch windows
// (167.8 ms a depth-4 launch).  It runs the launches of small halos
// (depth 1 among them), where it is the faster, and the shapes whose
// z-streamed sub-tile is small: the per-block windows then overhang the
// sub-tile so far that the scratch outgrows the card.
//
// The z-streamed schedule (tb_stream.cuh: trapezoid, z-major copies,
// sub-tiles):
//
//   each phase is one z-streamed pass over its trapezoid region (phase n
//   of 2T computes the points within (2T - n) R of the centre).  A pass
//   holds, for the current plane, the x/y-tap fields' region of margin
//   (n - 1) R in shared memory — phase V: txx, tyy, txy, txz, tyz;
//   phase S: vx, vy, vz — loaded by cp.async one plane ahead (two buffers).
//   The z taps and the pointwise operands (old values, params) are whole
//   rows of z-major fields, read through L1/L2.  A pass writes its fields
//   to the block's scratch windows (z-major), in place: each phase reads
//   its own fields only at the point it overwrites, and the other phase's
//   fields only through taps.  The first step reads the copies of the
//   inputs; the tile's centre is written back through 32 x 32 shared-
//   memory tiles (lanes along z on the output side).
//
// Why not all T steps on chip, as the acoustic kernel does: at tile 32 and
// T = 4 the window is 64^2 points, 16 KiB a plane; one plane of each of
// the 9 state fields is already 144 KiB, and a five-plane ring of the six
// stresses 480 KiB.  So the fields go through the scratch once a phase
// (read once, not once a tap, over a shrinking region): at tile 32, T = 4
// the mean region over the 8 phases is ~2.15x the tile, ~100 GB a launch
// with the z taps' L1/L2 traffic on top.  Shared memory: two buffers of
// five 64^2 planes, 163,840 B, one block an SM, 256 blocks.
//
// Measured (PERF.md): ~130-145 ms a depth-4 launch at 512^3 against 168 ms
// for the first design; ~200 GB requested from L2 at ~1.4 TB/s.  Each
// point of a pass waits on ~17 global reads (its 12 z taps and its
// pointwise operands), seven points a thread in turn, at 16 warps an SM.
// Two points at a time (their reads in flight together) was slower at the
// 128-register cap.  Next: a fused V+S pass keeping the velocities on
// chip, and the z taps from shared memory at a smaller block tile.
//
// The cluster-shared trapezoid (B5, tb_cluster.cuh) runs the z-streamed
// schedule's two phases point for point on a whole spec tile's trapezoid,
// a thread block cluster a tile and each pass's chunks spread over its
// blocks, for the deep halos of orders 8 and 12 (from halo 16), where a
// sub-tile's window overhangs it so far that the block windows outgrow the
// card, and the first schedule recomputes 4-16x the tile's points a pass.
// Unlike the z-streamed kernel it takes its z taps from shared-memory
// rings too (as TTI does), and its pointwise operands are coherent loads
// of the spec tile's windows, which other blocks of the cluster wrote
// before the barrier.
// Measured (PERF.md), 512^3, tile 64, 2 blocks a cluster: order 8 at T = 2
// ~50 ms a launch against 121.2 (first) and 99.6 (z-streamed).

#include "tb_cluster.cuh"

// ---------------------------------------------------------------------------
// The first schedule (sub-tile (0, 0)): the first design's kernel, unchanged
// ---------------------------------------------------------------------------

template <int R, bool DOM>
__global__ void __launch_bounds__(THREADS)
tb_elastic_kernel(const TileArgs a, const Coefs cf)
{
    constexpr int NT = 2 * R;              // staggered taps
    const Tile t(a);
    float* buf[9];
    View s[9];                             // the inputs, then the scratch
#pragma unroll
    for (int f = 0; f < 9; ++f) {
        buf[f] = t.scratch(a, f, 9);
        s[f] = t.input(a, f);
    }
    const View lam = t.input(a, 9), mu = t.input(a, 10);
    const View b = t.input(a, 11), damp = t.input(a, 12);
    const float dt = a.dt;

    for (int k = 0; k < a.T; ++k) {
        // phase V: velocities (vx, vy, vz = s[0..2]) from the stresses
        // (txx, tyy, tzz, txy, txz, tyz = s[3..8])
        t.for_each_point<DOM>([&](Pt q, bool inside) {
            const long long w = t.at(q);
            if (!inside) {
                buf[0][w] = 0.f;
                buf[1][w] = 0.f;
                buf[2][w] = 0.f;
                return;
            }
            const auto fw = [&](int f, int ax) {
                return t.taps<NT, 1 - R>(s[f], ax, q, cf.c[ax]);
            };
            const auto bw = [&](int f, int ax) {
                return t.taps<NT, -R>(s[f], ax, q, cf.c[ax]);
            };
            const float dmp = 1.f / (1.f + t.ro(damp, q) * dt);
            const float bdt = dt * t.ro(b, q);
            const float vx = dmp * (t.ld(s[0], q)
                                    + bdt * ((fw(3, 0) + bw(6, 1)) + bw(7, 2)));
            const float vy = dmp * (t.ld(s[1], q)
                                    + bdt * ((bw(6, 0) + fw(4, 1)) + bw(8, 2)));
            const float vz = dmp * (t.ld(s[2], q)
                                    + bdt * ((bw(7, 0) + bw(8, 1)) + fw(5, 2)));
            buf[0][w] = vx;
            buf[1][w] = vy;
            buf[2][w] = vz;
        });
#pragma unroll
        for (int f = 0; f < 3; ++f) s[f] = t.window(buf[f]);
        __syncthreads();

        // phase S: stresses from the new velocities
        t.for_each_point<DOM>([&](Pt q, bool inside) {
            const long long w = t.at(q);
            if (!inside) {
#pragma unroll
                for (int f = 3; f < 9; ++f) buf[f][w] = 0.f;
                return;
            }
            const auto fw = [&](int f, int ax) {
                return t.taps<NT, 1 - R>(s[f], ax, q, cf.c[ax]);
            };
            const auto bw = [&](int f, int ax) {
                return t.taps<NT, -R>(s[f], ax, q, cf.c[ax]);
            };
            const float dmp = 1.f / (1.f + t.ro(damp, q) * dt);
            const float l = t.ro(lam, q), mu_q = t.ro(mu, q);
            const float dvx_dx = bw(0, 0), dvy_dy = bw(1, 1), dvz_dz = bw(2, 2);
            const float div_v = (dvx_dx + dvy_dy) + dvz_dz;
            const float mu2 = 2.f * mu_q, dtmu = dt * mu_q;
            const float txx = dmp * (t.ld(s[3], q) + dt * (l * div_v + mu2 * dvx_dx));
            const float tyy = dmp * (t.ld(s[4], q) + dt * (l * div_v + mu2 * dvy_dy));
            const float tzz = dmp * (t.ld(s[5], q) + dt * (l * div_v + mu2 * dvz_dz));
            const float txy = dmp * (t.ld(s[6], q) + dtmu * (fw(0, 1) + fw(1, 0)));
            const float txz = dmp * (t.ld(s[7], q) + dtmu * (fw(0, 2) + fw(2, 0)));
            const float tyz = dmp * (t.ld(s[8], q) + dtmu * (fw(1, 2) + fw(2, 1)));
            buf[3][w] = txx;
            buf[4][w] = tyy;
            buf[5][w] = tzz;
            buf[6][w] = txy;
            buf[7][w] = txz;
            buf[8][w] = tyz;
        });
#pragma unroll
        for (int f = 3; f < 9; ++f) s[f] = t.window(buf[f]);
        __syncthreads();

        float* const inj[3] = {buf[3], buf[4], buf[5]};
        t.inject(a, k, inj);
        __syncthreads();
        t.record<2>(a, k, [&](long long w, float* o) {
            o[0] = buf[2][w];
            o[1] = -((buf[3][w] + buf[4][w]) + buf[5][w]) / 3.f;
        });
        // the next phase V overwrites vz, which the record just read
        __syncthreads();
    }
    t.write_back<9>(a, s);
}

// ---------------------------------------------------------------------------
// The z-streamed schedule (sub-tile (bx, by))
// ---------------------------------------------------------------------------

// shared memory of sub-tile (bx, by) at halo H: two buffers of five planes
// of the block window, and at least the write-back's warp tiles
static long long elastic_smem(int H, int bx, int by)
{
    const long long planes = 4LL * 2 * 5 * (bx + 2 * H) * (by + 2 * H);
    const long long tiles = 4LL * (STREAM_THREADS / 32) * 32 * 33;
    return planes > tiles ? planes : tiles;
}

// One z-streamed pass of phase n: for each plane z, the NF tap fields'
// region of margin (n - 1) R loads into shared memory (buffer z & 1, the
// next plane's loading meanwhile), then f(buffer, plane stride, centre
// index in it, its row width, x, y, z) runs for every point (x, y) of the
// region of margin n R (block-local coordinates).
template <int R, int NF, class F>
__device__ __forceinline__ void stream_pass(const Blk& b, float* sm,
                                            const ZView* tap, int n, F f)
{
    const int m0 = (n - 1) * R;
    const int h0 = b.bwx - 2 * m0, w0 = b.bwy - 2 * m0;
    const int h = h0 - 2 * R, w = w0 - 2 * R;
    const int cap = b.bwx * b.bwy;
    const auto load = [&](int z) {
        float* buf = sm + (z & 1) * NF * cap;
#pragma unroll
        for (int i = 0; i < NF; ++i)
            load_plane(buf + i * cap, tap[i], z, m0, m0, h0, w0);
        cp_async_commit();
    };
    load(0);
    for (int z = 0; z < b.nz; ++z) {
        cp_async_wait_all();
        __syncthreads();
        // buffer (z + 1) & 1 was last read at plane z - 1
        if (z + 1 < b.nz) load(z + 1);
        const float* buf = sm + (z & 1) * NF * cap;
        Walk p(w);
        for (int i = threadIdx.x; i < h * w; i += blockDim.x, p.next())
            f(buf, cap, (p.x + R) * w0 + (p.y + R), w0, p.x + n * R,
              p.y + n * R, z);
    }
    __syncthreads();
}

template <int R, bool DOM>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
tb_elastic_kernel(const TileArgs a, const Coefs cf, const StreamArgs s)
{
    constexpr int NT = 2 * R;              // staggered taps
    extern __shared__ float sm[];
    const Blk b(a, s);
    const int nz = a.nz, tid = threadIdx.x, nt = blockDim.x;
    const float dt = a.dt;
    ZView st[9];                           // the copies, then the scratch
    float* scr[9];
#pragma unroll
    for (int f = 0; f < 9; ++f) {
        st[f] = b.copy(s, a.nshots, f);
        scr[f] = b.scratch(s, f);
    }
    const ZView lam = b.copy(s, a.nshots, 9), mu = b.copy(s, a.nshots, 10);
    const ZView bb = b.copy(s, a.nshots, 11), damp = b.copy(s, a.nshots, 12);
    const long long bsx = b.bwy, bsz = (long long)b.bwx * b.bwy;

    // staggered derivative along x or y from a shared plane (no window
    // check: a region point's taps stay in the previous region), along z
    // from a z-major field (zero beyond [0, nz), as the first design)
    const auto tap_x = [&](const float* P, int ci, int w0, int off0) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < NT; ++k) acc += P[ci + (off0 + k) * w0] * cf.c[0][k];
        return acc;
    };
    const auto tap_y = [&](const float* P, int ci, int off0) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < NT; ++k) acc += P[ci + off0 + k] * cf.c[1][k];
        return acc;
    };
    const auto tap_z = [&](const ZView& v, int x, int y, int z, int off0) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < NT; ++k) {
            const int zz = z + off0 + k;
            const float q = (zz >= 0 && zz < nz) ? v.at(x, y, zz) : 0.f;
            acc += q * cf.c[2][k];
        }
        return acc;
    };

    for (int k = 0; k < a.T; ++k) {
        // phase V: velocities (vx, vy, vz = st[0..2]) from the stresses
        // (txx, tyy, tzz, txy, txz, tyz = st[3..8])
        {
            const ZView tap[5] = {st[3], st[4], st[6], st[7], st[8]};
            stream_pass<R, 5>(b, sm, tap, 2 * k + 1,
                [&](const float* buf, int cap, int ci, int w0, int x, int y,
                    int z) {
                const long long wi = z * bsz + x * bsx + y;
                if (!b.template in_domain<DOM>(x, y)) {
                    scr[0][wi] = 0.f;
                    scr[1][wi] = 0.f;
                    scr[2][wi] = 0.f;
                    return;
                }
                const float* txx = buf;
                const float* tyy = buf + cap;
                const float* txy = buf + 2 * cap;
                const float* txz = buf + 3 * cap;
                const float* tyz = buf + 4 * cap;
                const float dmp = 1.f / (1.f + damp.ro(x, y, z) * dt);
                const float bdt = dt * bb.ro(x, y, z);
                const float vx = dmp * (st[0].at(x, y, z)
                    + bdt * ((tap_x(txx, ci, w0, 1 - R) + tap_y(txy, ci, -R))
                             + tap_z(st[7], x, y, z, -R)));
                const float vy = dmp * (st[1].at(x, y, z)
                    + bdt * ((tap_x(txy, ci, w0, -R) + tap_y(tyy, ci, 1 - R))
                             + tap_z(st[8], x, y, z, -R)));
                const float vz = dmp * (st[2].at(x, y, z)
                    + bdt * ((tap_x(txz, ci, w0, -R) + tap_y(tyz, ci, -R))
                             + tap_z(st[5], x, y, z, 1 - R)));
                scr[0][wi] = vx;
                scr[1][wi] = vy;
                scr[2][wi] = vz;
            });
#pragma unroll
            for (int f = 0; f < 3; ++f) st[f] = b.scratch_view(scr[f]);
        }

        // phase S: stresses from the new velocities
        {
            const ZView tap[3] = {st[0], st[1], st[2]};
            stream_pass<R, 3>(b, sm, tap, 2 * k + 2,
                [&](const float* buf, int cap, int ci, int w0, int x, int y,
                    int z) {
                const long long wi = z * bsz + x * bsx + y;
                if (!b.template in_domain<DOM>(x, y)) {
#pragma unroll
                    for (int f = 3; f < 9; ++f) scr[f][wi] = 0.f;
                    return;
                }
                const float* vxp = buf;
                const float* vyp = buf + cap;
                const float* vzp = buf + 2 * cap;
                const float dmp = 1.f / (1.f + damp.ro(x, y, z) * dt);
                const float l = lam.ro(x, y, z), mu_q = mu.ro(x, y, z);
                const float dvx_dx = tap_x(vxp, ci, w0, -R);
                const float dvy_dy = tap_y(vyp, ci, -R);
                const float dvz_dz = tap_z(st[2], x, y, z, -R);
                const float div_v = (dvx_dx + dvy_dy) + dvz_dz;
                const float mu2 = 2.f * mu_q, dtmu = dt * mu_q;
                const float txx = dmp * (st[3].at(x, y, z)
                                         + dt * (l * div_v + mu2 * dvx_dx));
                const float tyy = dmp * (st[4].at(x, y, z)
                                         + dt * (l * div_v + mu2 * dvy_dy));
                const float tzz = dmp * (st[5].at(x, y, z)
                                         + dt * (l * div_v + mu2 * dvz_dz));
                const float txy = dmp * (st[6].at(x, y, z) + dtmu
                    * (tap_y(vxp, ci, 1 - R) + tap_x(vyp, ci, w0, 1 - R)));
                const float txz = dmp * (st[7].at(x, y, z) + dtmu
                    * (tap_z(st[0], x, y, z, 1 - R) + tap_x(vzp, ci, w0, 1 - R)));
                const float tyz = dmp * (st[8].at(x, y, z) + dtmu
                    * (tap_z(st[1], x, y, z, 1 - R) + tap_y(vzp, ci, 1 - R)));
                scr[3][wi] = txx;
                scr[4][wi] = tyy;
                scr[5][wi] = tzz;
                scr[6][wi] = txy;
                scr[7][wi] = txz;
                scr[8][wi] = tyz;
            });
#pragma unroll
            for (int f = 3; f < 9; ++f) st[f] = b.scratch_view(scr[f]);
        }

        // inject the source values into txx, tyy, tzz inside phase S's
        // region, then record vz and the pressure at the owned receivers
        const int mS = (2 * k + 2) * R;
        for (int p = tid; p < a.src_cap; p += nt) {
            const int* c = a.src_coords + (b.tile * a.src_cap + p) * 3;
            const float v = a.src_vals[(b.tile * a.T + k) * a.src_cap + p];
            int x, y;
            if (v == 0.f || !b.in_region(c, mS, &x, &y)) continue;
            const long long wi = c[2] * bsz + x * bsx + y;
#pragma unroll
            for (int f = 3; f < 6; ++f) scr[f][wi] = scr[f][wi] + v;
        }
        __syncthreads();
        for (int p = tid; p < a.rec_cap; p += nt) {
            const int* c = a.rec_coords + (b.tile * a.rec_cap + p) * 3;
            if (!b.owns(c)) continue;
            const long long wi =
                c[2] * bsz + (c[0] - b.wox) * bsx + (c[1] - b.woy);
            const float w = a.rec_w[b.tile * a.rec_cap + p];
            float* o = a.rec_out + ((b.tile * a.T + k) * a.rec_cap + p) * 2;
            o[0] = w * scr[2][wi];
            o[1] = w * (-((scr[3][wi] + scr[4][wi]) + scr[5][wi]) / 3.f);
        }
        // the next phase V overwrites vz, which the record just read
        __syncthreads();
    }

    // write back the centre: one warp a 32 x 32 (y, z) tile of one x row,
    // read along y from the z-major scratch, written along z
    const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
    float* tile = sm + warp * 32 * 33;
    const int nyt = (b.by + 31) / 32, nzt = (nz + 31) / 32;
    const long long base = b.shot * a.out_shot;
    for (int it = warp; it < 9 * b.bx * nyt * nzt; it += nwarps) {
        int r = it;
        const int z0 = (r % nzt) * 32;
        r /= nzt;
        const int y0 = (r % nyt) * 32;
        r /= nyt;
        const int x = r % b.bx, f = r / b.bx;
        const float* src = scr[f] + (long long)(b.H + x) * bsx + b.H;
        for (int j = 0; j < 32; ++j) {
            const int z = z0 + j, y = y0 + lane;
            tile[j * 33 + lane] = (z < nz && y < b.by) ? src[z * bsz + y] : 0.f;
        }
        __syncwarp();
        const long long gx = (long long)b.ti * b.tx + b.wox + x;
        for (int j = 0; j < 32; ++j) {
            const int y = y0 + j, z = z0 + lane;
            if (y < b.by && z < nz)
                a.out[f][base + (gx * b.ny + b.tj * b.ty + b.woy + y) * nz + z]
                    = tile[lane * 33 + j];
        }
        __syncwarp();
    }
}

// ---------------------------------------------------------------------------
// The cluster-shared trapezoid (B5, tb_cluster.cuh)
// ---------------------------------------------------------------------------

// shared memory of a B5 chunk of pass n whose load rectangle is lh x lw:
// phase V's rings of 2R + 2 planes of the three stresses with z taps
// (txz, tyz, tzz) and two planes of the other three, or phase S's rings
// of the three velocities; at least the write-back's warp tiles
// (`stencil_tb.chunk_smem`)
static long long elastic_chunk_smem(int R, int n, int lh, int lw)
{
    const long long ring = ring_planes(R);
    const long long planes = n % 2 ? 3 * ring + 6 : 3 * ring;
    const long long need = 4LL * planes * lh * lw;
    const long long tiles = 4LL * (STREAM_THREADS / 32) * 32 * 33;
    return need > tiles ? need : tiles;
}

// a point's pointwise reads in phase V (inside the domain, damp, b, vx,
// vy, vz) and in phase S (inside, damp, lam, mu, the six stresses)
struct OpsV {
    bool in;
    float damp, b, v[3];
};
struct OpsS {
    bool in;
    float damp, lam, mu, t[6];
};

// The same phases as the z-streamed kernel above, point for point, on the
// spec tile's trapezoid: each pass over this block's chunks, the cluster's
// blocks meeting at a barrier between passes.  Unlike the z-streamed
// kernel, every tap comes from shared memory: the fields a phase takes z
// taps of stream through rings of 2R + 2 planes (phase V: txz, tyz, tzz;
// phase S: vx, vy, vz), the others through two planes, and only the
// pointwise operands (the params, the phase's own old values) are
// coherent loads of the z-major fields, one point of a thread at a time
// (two, with their reads in flight together, spilled registers at radius
// 6 and were 25% slower; PERF.md).  The spec tile's 9 windows hold the
// state, z-major over the spec window, each phase writing its fields in
// place.

template <int R, bool DOM>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
tb_elastic_kernel(const TileArgs a, const Coefs cf, const StreamArgs s,
                  const ClusterArgs c)
{
    constexpr int NT = 2 * R;              // staggered taps
    extern __shared__ __align__(16) float smc[];
    const CBlk b(a, c);
    const int nz = a.nz, tid = threadIdx.x, nt = blockDim.x;
    const float dt = a.dt;
    ZView st[9];                           // the copies, then the scratch
    float* scr[9];
#pragma unroll
    for (int f = 0; f < 9; ++f) {
        st[f] = b.copy(s, a.nshots, f);
        scr[f] = b.window(s, f);
    }
    const ZView lam = b.copy(s, a.nshots, 9), mu = b.copy(s, a.nshots, 10);
    const ZView bb = b.copy(s, a.nshots, 11), damp = b.copy(s, a.nshots, 12);
    const long long bsx = b.wy, bsz = (long long)b.wx * b.wy;

    // staggered derivative along x or y from a shared plane centred at q
    // (rows w0 wide), along z from a ring (zero beyond [0, nz)); taps from
    // offset off0, summed in order as the z-streamed kernel sums them
    const auto tap_x = [&](const float* q, int w0, int off0) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < NT; ++k) acc += q[(off0 + k) * w0] * cf.c[0][k];
        return acc;
    };
    const auto tap_y = [&](const float* q, int off0) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < NT; ++k) acc += q[off0 + k] * cf.c[1][k];
        return acc;
    };
    const auto tap_z = [&](const float* q, const ZTaps<R>& zt, int off0) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < NT; ++k) {
            const int j = off0 + k + R;
            const float v = (zt.mask >> j) & 1 ? q[zt.d[j]] : 0.f;
            acc += v * cf.c[2][k];
        }
        return acc;
    };

    int cb, ce;
    for (int k = 0; k < a.T; ++k) {
        // phase V: velocities (vx, vy, vz = st[0..2]) from the stresses
        // (txx, tyy, tzz, txy, txz, tyz = st[3..8])
        {
            const ZView ring[3] = {st[7], st[8], st[5]};
            const ZView pln[3] = {st[3], st[4], st[6]};
            b.chunks(2 * k + 1, &cb, &ce);
            for (int i = cb; i < ce; ++i)
                chunk_pass<R, 3, 3>(smc, ring, pln, nz, b.chunk(i),
                    [&](int x, int y, int z) {
                    OpsV o;
                    o.in = b.template in_domain<DOM>(x, y);
                    if (o.in) {
                        o.damp = damp.ro(x, y, z);
                        o.b = bb.ro(x, y, z);
#pragma unroll
                        for (int f = 0; f < 3; ++f) o.v[f] = st[f].at(x, y, z);
                    }
                    return o;
                },
                    [&](const OpsV& o, const float* rc, const float* pc,
                        int rs, int ps, int w0, const ZTaps<R>& zt, int x,
                        int y, int z) {
                    const long long wi = z * bsz + x * bsx + y;
                    if (!o.in) {
                        scr[0][wi] = 0.f;
                        scr[1][wi] = 0.f;
                        scr[2][wi] = 0.f;
                        return;
                    }
                    const float* txz = rc;
                    const float* tyz = rc + rs;
                    const float* tzz = rc + 2 * rs;
                    const float* txx = pc;
                    const float* tyy = pc + ps;
                    const float* txy = pc + 2 * ps;
                    const float dmp = 1.f / (1.f + o.damp * dt);
                    const float bdt = dt * o.b;
                    const float vx = dmp * (o.v[0]
                        + bdt * ((tap_x(txx, w0, 1 - R) + tap_y(txy, -R))
                                 + tap_z(txz, zt, -R)));
                    const float vy = dmp * (o.v[1]
                        + bdt * ((tap_x(txy, w0, -R) + tap_y(tyy, 1 - R))
                                 + tap_z(tyz, zt, -R)));
                    const float vz = dmp * (o.v[2]
                        + bdt * ((tap_x(txz, w0, -R) + tap_y(tyz, -R))
                                 + tap_z(tzz, zt, 1 - R)));
                    scr[0][wi] = vx;
                    scr[1][wi] = vy;
                    scr[2][wi] = vz;
                });
#pragma unroll
            for (int f = 0; f < 3; ++f) st[f] = b.view(scr[f]);
        }
        cluster_barrier();

        // phase S: stresses from the new velocities
        const int n = 2 * k + 2;
        {
            const ZView ring[3] = {st[0], st[1], st[2]};
            b.chunks(n, &cb, &ce);
            for (int i = cb; i < ce; ++i)
                chunk_pass<R, 3, 0>(smc, ring, nullptr, nz, b.chunk(i),
                    [&](int x, int y, int z) {
                    OpsS o;
                    o.in = b.template in_domain<DOM>(x, y);
                    if (o.in) {
                        o.damp = damp.ro(x, y, z);
                        o.lam = lam.ro(x, y, z);
                        o.mu = mu.ro(x, y, z);
#pragma unroll
                        for (int f = 0; f < 6; ++f)
                            o.t[f] = st[3 + f].at(x, y, z);
                    }
                    return o;
                },
                    [&](const OpsS& o, const float* rc, const float*, int rs,
                        int, int w0, const ZTaps<R>& zt, int x, int y,
                        int z) {
                    const long long wi = z * bsz + x * bsx + y;
                    if (!o.in) {
#pragma unroll
                        for (int f = 3; f < 9; ++f) scr[f][wi] = 0.f;
                        return;
                    }
                    const float* vxp = rc;
                    const float* vyp = rc + rs;
                    const float* vzp = rc + 2 * rs;
                    const float dmp = 1.f / (1.f + o.damp * dt);
                    const float l = o.lam, mu_q = o.mu;
                    const float dvx_dx = tap_x(vxp, w0, -R);
                    const float dvy_dy = tap_y(vyp, -R);
                    const float dvz_dz = tap_z(vzp, zt, -R);
                    const float div_v = (dvx_dx + dvy_dy) + dvz_dz;
                    const float mu2 = 2.f * mu_q, dtmu = dt * mu_q;
                    const float txx = dmp * (o.t[0]
                                             + dt * (l * div_v + mu2 * dvx_dx));
                    const float tyy = dmp * (o.t[1]
                                             + dt * (l * div_v + mu2 * dvy_dy));
                    const float tzz = dmp * (o.t[2]
                                             + dt * (l * div_v + mu2 * dvz_dz));
                    const float txy = dmp * (o.t[3] + dtmu
                        * (tap_y(vxp, 1 - R) + tap_x(vyp, w0, 1 - R)));
                    const float txz = dmp * (o.t[4] + dtmu
                        * (tap_z(vxp, zt, 1 - R) + tap_x(vzp, w0, 1 - R)));
                    const float tyz = dmp * (o.t[5] + dtmu
                        * (tap_z(vyp, zt, 1 - R) + tap_y(vzp, 1 - R)));
                    scr[3][wi] = txx;
                    scr[4][wi] = tyy;
                    scr[5][wi] = tzz;
                    scr[6][wi] = txy;
                    scr[7][wi] = txz;
                    scr[8][wi] = tyz;
                });
#pragma unroll
            for (int f = 3; f < 9; ++f) st[f] = b.view(scr[f]);
        }

        // inject the source values into txx, tyy, tzz at the points this
        // block's chunks of phase S hold, then record vz and the pressure
        // at those of the receivers
        for (int p = tid; p < a.src_cap; p += nt) {
            const int* cc = a.src_coords + (b.tile * a.src_cap + p) * 3;
            const float v = a.src_vals[(b.tile * a.T + k) * a.src_cap + p];
            if (v == 0.f || cc[2] < 0 || cc[2] >= nz
                || !b.holds(n, cc[0], cc[1]))
                continue;
            const long long wi = cc[2] * bsz + cc[0] * bsx + cc[1];
#pragma unroll
            for (int f = 3; f < 6; ++f) scr[f][wi] = scr[f][wi] + v;
        }
        __syncthreads();
        for (int p = tid; p < a.rec_cap; p += nt) {
            const int* cc = a.rec_coords + (b.tile * a.rec_cap + p) * 3;
            if (!b.in_centre(cc) || !b.holds(n, cc[0], cc[1])) continue;
            const long long wi = cc[2] * bsz + cc[0] * bsx + cc[1];
            const float w = a.rec_w[b.tile * a.rec_cap + p];
            float* o = a.rec_out + ((b.tile * a.T + k) * a.rec_cap + p) * 2;
            o[0] = w * scr[2][wi];
            o[1] = w * (-((scr[3][wi] + scr[4][wi]) + scr[5][wi]) / 3.f);
        }
        // the next phase V reads the stresses from every block's chunks
        // and overwrites vz, which the record just read
        cluster_barrier();
    }

    // write back this block's chunks of the last pass: the tile's centre
    b.chunks(2 * a.T, &cb, &ce);
    for (int i = cb; i < ce; ++i)
        write_back_chunk<9>(a, b, smc, st, b.chunk(i));
}

// the params' z-major copies for `repro_tb_tile` with PARAMS_COPIED (see
// tb_stream.cuh)
extern "C" int repro_tb_param_copies(int device, const float* const* in,
                                     int nparam, int param_rows, int nshots,
                                     int nx, int ny, int nz, int H,
                                     float* out, void* stream)
{
    return param_copies(device, in, nparam, param_rows, nshots, nx, ny, nz,
                        H, out, stream);
}

// (bx, by): the z-streamed schedule's sub-tile, or (0, 0) for the first
// schedule, whose scratch is then nine windows a tile
extern "C" int repro_tb_tile(
    int device, const float* const* in, const int* src_coords,
    const float* src_vals, const int* rec_coords, const float* rec_w,
    float* const* out, float* rec_out, float* scratch, const float* dom,
    int param_rows, int nshots, int nx, int ny, int nz, int tx, int ty, int T,
    int H, int src_cap, int rec_cap, int radius, const float* coefs, float dt,
    float dt2, int bx, int by, void* stream)
{
    TileArgs a;
    Coefs cf;
    const int e = tile_args(&a, &cf, device, 13, 9, in, src_coords,
                            src_vals, rec_coords, rec_w, out, rec_out,
                            scratch, dom, param_rows & PARAM_ROWS, nshots,
                            nx, ny, nz,
                            tx, ty, T, H, src_cap, rec_cap, radius, coefs,
                            2 * radius, dt, dt2);
    if (e) return e;
    const cudaStream_t st = (cudaStream_t)stream;
    if (bx == 0) {
        with_radius(radius, dom != nullptr, [&](auto r, auto d) {
            tb_elastic_kernel<decltype(r)::value, decltype(d)::value>
                <<<tile_grid(a), THREADS, 0, st>>>(a, cf);
        });
        return (int)cudaGetLastError();
    }
    const long long smem = elastic_smem(H, bx, by);
    if (H != 2 * T * radius || !subtile_ok(tx, ty, bx, by, smem))
        return (int)cudaErrorInvalidValue;
    const StreamArgs s = stream_args(a, scratch, 9, 4, param_rows, bx, by, 9);
    launch_to_zmajor(a, s, 4, param_rows, st);
    int rc = 0;
    with_radius(radius, dom != nullptr, [&](auto r, auto d) {
        constexpr int KR = decltype(r)::value;
        constexpr bool KD = decltype(d)::value;
        void (*kern)(const TileArgs, const Coefs, const StreamArgs) =
            tb_elastic_kernel<KR, KD>;
        rc = (int)cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (rc == 0)
            kern<<<stream_grid(nx, ny, tx, ty, s, nshots), STREAM_THREADS,
                   smem, st>>>(a, cf, s);
    });
    return rc ? rc : (int)cudaGetLastError();
}

// B5 (tb_cluster.cuh): `cluster` blocks a spec tile, `table` the chunk
// table (`stencil_tb.chunk_table`, `len` ints) on the host, checked here,
// and `table_dev` its copy on the device, `smem` the shared bytes a block;
// the scratch is the z-major copies and nine spec windows a tile
extern "C" int repro_tb_tile_cluster(
    int device, const float* const* in, const int* src_coords,
    const float* src_vals, const int* rec_coords, const float* rec_w,
    float* const* out, float* rec_out, float* scratch, const float* dom,
    int param_rows, int nshots, int nx, int ny, int nz, int tx, int ty, int T,
    int H, int src_cap, int rec_cap, int radius, const float* coefs, float dt,
    float dt2, int cluster, const int* table, const int* table_dev, int len,
    int smem, void* stream)
{
    TileArgs a;
    Coefs cf;
    const int e = tile_args(&a, &cf, device, 13, 9, in, src_coords,
                            src_vals, rec_coords, rec_w, out, rec_out,
                            scratch, dom, param_rows & PARAM_ROWS, nshots,
                            nx, ny, nz, tx, ty, T, H, src_cap, rec_cap,
                            radius, coefs, 2 * radius, dt, dt2);
    if (e) return e;
    if (H != 2 * T * radius || cluster < 1 || cluster > CLUSTER_MAX
        || smem > STREAM_SMEM || (long long)(nx / tx) * (ny / ty) > 65535)
        return (int)cudaErrorInvalidValue;
    const int rc0 = check_chunks(
        table, len, 2 * T, cluster, tx + 2 * H, ty + 2 * H, radius, smem,
        [&](int n, int lh, int lw) {
            return elastic_chunk_smem(radius, n, lh, lw);
        });
    if (rc0) return rc0;
    const StreamArgs s = stream_args(a, scratch, 9, 4, param_rows, tx, ty, 9);
    if (!cluster_aligned(a, s)) return (int)cudaErrorInvalidValue;
    const ClusterArgs c{table_dev, cluster, 2 * T};
    const cudaStream_t st = (cudaStream_t)stream;
    launch_to_zmajor(a, s, 4, param_rows, st);
    const dim3 grid(cluster, (nx / tx) * (ny / ty), nshots);
    int rc = 0;
    with_radius(radius, dom != nullptr, [&](auto r, auto d) {
        void (*kern)(const TileArgs, const Coefs, const StreamArgs,
                     const ClusterArgs) =
            tb_elastic_kernel<decltype(r)::value, decltype(d)::value>;
        rc = cluster_launch(kern, cluster, grid, STREAM_THREADS, smem, st,
                            a, cf, s, c);
    });
    return rc;
}

// the clusters of B5 blocks (`cluster` a cluster, `smem` shared bytes a
// block) the card holds at once, into *active (0: none; a launch raises)
extern "C" int repro_tb_cluster_occupancy(int radius, int dom, int cluster,
                                          int smem, int* active)
{
    if (radius < 1 || radius > MAX_RADIUS || cluster < 1
        || cluster > CLUSTER_MAX || smem > STREAM_SMEM)
        return (int)cudaErrorInvalidValue;
    int rc = 0;
    with_radius(radius, dom != 0, [&](auto r, auto d) {
        void (*kern)(const TileArgs, const Coefs, const StreamArgs,
                     const ClusterArgs) =
            tb_elastic_kernel<decltype(r)::value, decltype(d)::value>;
        cudaLaunchAttribute attr;
        cudaLaunchConfig_t cfg;
        rc = cluster_config(kern, cluster, dim3(cluster), STREAM_THREADS, smem,
                            nullptr, &attr, &cfg, active);
    });
    return rc;
}
