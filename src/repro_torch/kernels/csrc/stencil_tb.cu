// Temporally-blocked acoustic time tile for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_tb_kernel` of
// src/repro/kernels/stencil_tb.py (launched by `tb_time_tile`), for the
// acoustic physics in float32 and, as B1a-bf16, in bf16 (the template's
// storage type S; fields, params, tables and partials in bf16, computed in
// float32 and rounded at each store), with a C entry point per type.  The
// bf16 entry takes no domain mask: the sharded path (B1c) stays float32.
// Per (x, y) tile of each row (shot, or shard pass with `dom`):
//
//   T times:  u_next = (dt^2 lap(u) + m (2u - u_prev) + damp dt u)
//                      / (m + damp dt),
//             u_next = 0 outside the physical x/y domain,
//             u_next[src slot] += src value      (grid-aligned injection),
//             rec[tile, k, slot] = w * u_next[rec slot],
//             (u_prev, u) <- (u, u_next)
//   write back the tile's centre of u_prev and u.
//
// The Laplacian sums x taps, then y, then z, each in tap order, as the
// reference does; every expression is the first design's, and the build
// turns multiply-add contraction off, so each point rounds as before.
//
// What bounds it: bytes.  The least traffic for one call is each input
// read once and each output written once (4 fields in, 2 out: 3.2 GB at
// 512^3, 0.96 ms at 3.35 TB/s); the arithmetic is ~36 flops a point-step,
// far under the card's float32 rate.
//
// Three schedules compute the same function; the wrapper picks one a
// launch from its shape (`stencil_tb.launch_plan`) and passes the
// z-streamed schedule's sub-tile, or (0, 0) for the first schedule, to
// `repro_tb_tile`, or the third's parts table to `repro_tb_tile_wave`:
//
// The first schedule (the port's first design, kept as it was): one block
// a tile, the whole window computed at every step and ping-ponged through
// a per-block scratch in device memory, every field re-read at every step
// (~25 GB a depth-4 launch at 512^3).  It runs what the z-streamed
// schedule cannot hold on chip (deep or wide stencils) and the depth-1
// launches, where one level has no later level to hide its plane-steps
// behind.
//
// The z-streamed schedule keeps all T levels on chip, as a wavefront in z
// (tb_stream.cuh describes the trapezoid, the z-major copies and the
// sub-tiles):
//
//   step t computes plane t - (k - 1) r of level k for k = 1..T, so level
//   k + 1 runs r planes behind level k.  Level j < T keeps a ring of 2r + 1
//   planes of its region (margin j r from the block window's edge); the
//   ring of u_0 (the input u) has one more slot, for the plane cp.async
//   loads while the current step computes.  Level k reads its x, y and z
//   taps from ring k - 1 and its u_prev from ring k - 2 (the oldest
//   plane), or, for level 1, from the copy of the input u_prev.  m and
//   damp are read pointwise from their copies: whole rows, through L2.
//   Level T writes the centre of u_T and of u_{T-1} (its centre tap) to a
//   staging buffer of OUT_CHUNK planes, written out every OUT_CHUNK planes
//   with lanes along z (32-byte runs a column).  A step's plane offsets
//   are a table in shared memory that T threads fill; a thread computes 4
//   points of one column a level (they share their x-tap loads).
//
// Shared memory at the main plan (tile 32, T = 4, order 4, r = 2, H = 8):
// rings of 48^2 (6 slots), 44^2, 40^2, 36^2 (5 slots) floats, 151,936 B,
// plus the staging, 2 x 8 x (1024 + 4) floats, 65,792 B: 217,728 B, one
// block an SM, 256 blocks, two waves.  A launch reads the four padded
// inputs once to copy them (2.3 GB), the copies once over each block's
// window (~2.25x overhang in x/y) and writes u_{T-1} and u_T once: ~9-10
// GB against ~25 GB.  Configurations whose rings do not fit take a
// sub-tile of the tile; where none fits, or the sub-tile's overhang costs
// more than the first schedule, the launch takes the first schedule.
//
// Measured (PERF.md): 9.3-9.4 ms a depth-4 launch at the main plan and
// 0.93 ms of state copies, against 15.1 ms for the first design in the
// same call: bytes no longer hold it back (~14 GB requested from L2, ~280
// GB/s of least bytes).  A block's 518 plane-steps of 5 barriers run one
// after another, and a level-phase costs ~3,400 cycles for one 4-point
// item a thread: ~520-770 instructions a thread (~190 floating-point:
// no multiply-add contraction), at under one instruction a cycle a
// scheduler with 16 warps an SM.  8-point items on 384 threads, 2-point
// items on 1,024, a second unclamped item path and 4-point row items read
// with 16-byte loads were all slower; 13% fewer instructions an item did
// not move the time.  A depth-1 launch
// (the spatially-blocked baseline) was slower than the first design's
// (5.28 against 3.76 ms): one level cannot hide a plane-step's latency.
//
// The cluster-shared z-wavefront (B6, float32, from order 8 at T >= 2) is
// the z-streamed wavefront for the deep halos, where one block cannot hold
// the rings (order 12: 14 planes of (bx + 48)^2 for the first alone) or
// holds them only for a sub-tile whose window is many times its area
// (order 8: 16 x 16, 9x).  A thread block cluster of C blocks shares one
// spec tile (grid (C, spec tiles, rows), as B5 in tb_cluster.cuh): the
// spec window is cut into C parts by cut lines fixed in window
// coordinates, so a point belongs to the same block at every level, and
// each block keeps its part of every level's ring plus the seam, r points
// of the parts around.  Level j runs r + 1 planes behind level j - 1, so a
// step reads only planes written in earlier steps; each block writes the
// seams its neighbours need of its new planes into their rings
// (distributed shared memory), where they are read r + 1 steps later, and
// one cluster barrier a step, waited a step late, orders it all without
// holding a step up.  Every level is then
// computed once a spec tile, as in B5, and stays on chip, as in the
// z-streamed schedule; the scratch holds only the z-major copies.  The
// block that owns a point injects its sources and writes its receiver
// slots; each block stages and writes back its part of the centre.

#include "tb_cluster.cuh"

#include <cooperative_groups.h>

// ---------------------------------------------------------------------------
// The first schedule (sub-tile (0, 0)): the first design's kernel, unchanged
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// The z-streamed schedule (sub-tile (bx, by))
// ---------------------------------------------------------------------------

#define OUT_CHUNK 8
// points a thread computes at a time (one item): at the main plan a level
// has at most 11 x 44 = 484 items, one a thread of the block's 512
static constexpr int G = 4;

// floats of one plane of the output staging: the sub-tile, padded so the
// flush's lanes (4 columns x 8 planes) fall on distinct banks
static __host__ __device__ int stage_pitch(int bx, int by)
{
    return (bx * by + 31) / 32 * 32 + 4;
}

// shared memory of sub-tile (bx, by): the rings of levels 0..T-1 and the
// staging
static long long acoustic_smem(int T, int r, int bx, int by)
{
    const int H = T * r;
    long long f = (long long)(2 * r + 2) * (bx + 2 * H) * (by + 2 * H);
    for (int j = 1; j < T; ++j)
        f += (long long)(2 * r + 1) * (bx + 2 * (H - j * r))
             * (by + 2 * (H - j * r));
    f += 2LL * OUT_CHUNK * stage_pitch(bx, by);
    return 4 * f;
}

template <int R, bool DOM, class S>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
tb_acoustic_kernel(const TileArgsT<S> a, const Coefs cf, const StreamArgs s)
{
    // a step's plane offsets in sm, per level j (1..T): its plane z (-1
    // when idle), the plane of ring j - 1 it taps (SRC), the z taps'
    // planes relative to it (ZD + q, 0 beyond [0, nz)) and their mask, its
    // u_prev plane in ring j - 2, its output plane (ring j or level T's
    // staging) and level T's u_{T-1} staging plane.  Filled by T threads
    // at the start of each step, double-buffered by the step's parity, so
    // every thread reads its offsets with broadcast loads
    enum { Z, SRC, PRV, DST, DPREV, ZMASK, ZD, TW = ZD + 2 * R + 1 };
    extern __shared__ __align__(16) float sm[];
    __shared__ int ring[MAX_T + 1];       // float offset of ring j; [T]: staging
    __shared__ int zr[4];                 // sources' and receivers' z ranges
    __shared__ int tab[2][MAX_T + 1][TW];
    const Blk b(a, s);
    const int T = a.T, nz = a.nz, tid = threadIdx.x, nt = blockDim.x;
    const int pitch = stage_pitch(b.bx, b.by);
    const ZView u0 = b.copy(s, a.nshots, 0), u1 = b.copy(s, a.nshots, 1);
    const ZView m = b.copy(s, a.nshots, 2), damp = b.copy(s, a.nshots, 3);
    // level j's region: margin j R, (bwx - 2 j R) x (bwy - 2 j R)
    const auto h_of = [&](int j) { return b.bwx - 2 * j * R; };
    const auto w_of = [&](int j) { return b.bwy - 2 * j * R; };
    if (tid == 0) {
        int o = 0;
        for (int j = 0; j < T; ++j) {
            ring[j] = o;
            o += (j ? 2 * R + 1 : 2 * R + 2) * h_of(j) * w_of(j);
        }
        ring[T] = o;
        zr[0] = zr[2] = INT_MAX;
        zr[1] = zr[3] = -1;
    }
    __syncthreads();
    for (int p = tid; p < a.src_cap; p += nt) {
        const int* c = a.src_coords + (b.tile * a.src_cap + p) * 3;
        int x, y;
        if (b.in_region(c, 0, &x, &y)) {
            atomicMin(&zr[0], c[2]);
            atomicMax(&zr[1], c[2]);
        }
    }
    for (int p = tid; p < a.rec_cap; p += nt) {
        const int* c = a.rec_coords + (b.tile * a.rec_cap + p) * 3;
        if (b.owns(c)) {
            atomicMin(&zr[2], c[2]);
            atomicMax(&zr[3], c[2]);
        }
    }
    // float offset in sm of plane z of level j's ring (j < T) or of its
    // staging slot (j == T); the ring sizes are compile-time, so the
    // modulo is a multiply
    const auto poff = [&](int j, int z) {
        if (j == T) return ring[T] + (z % OUT_CHUNK) * pitch;
        const int slot = j ? z % (2 * R + 1) : z % (2 * R + 2);
        return ring[j] + slot * h_of(j) * w_of(j);
    };
    const auto load_u = [&](int z) {
        load_plane(sm + poff(0, z), u1, z, 0, 0, h_of(0), w_of(0));
    };
    // the output flush: lanes along z (OUT_CHUNK a column), each thread
    // keeps its plane dz and walks its columns without a division
    const int fdz = tid % OUT_CHUNK, fstep = nt / OUT_CHUNK;
    const int fx0 = (tid / OUT_CHUNK) / b.by, fy0 = (tid / OUT_CHUNK) % b.by;
    const int fdx = fstep / b.by, fdy = fstep % b.by;

    for (int z = 0; z <= R && z < nz; ++z) load_u(z);
    cp_async_commit();
    const int steps = nz + (T - 1) * R;
    for (int t = 0; t < steps; ++t) {
        if (tid >= 1 && tid <= T) {
            const int j = tid, z = t - (j - 1) * R;
            int* e = tab[t & 1][j];
            if (z < 0 || z >= nz) {
                e[Z] = -1;
            } else {
                e[Z] = z;
                e[SRC] = poff(j - 1, z);
                e[PRV] = j >= 2 ? poff(j - 2, z) : 0;
                e[DST] = poff(j, z);
                e[DPREV] = ring[T] + OUT_CHUNK * pitch + (z % OUT_CHUNK) * pitch;
                int mask = 0;
#pragma unroll
                for (int q = 0; q <= 2 * R; ++q) {
                    const int zz = z + q - R;
                    const bool ok = zz >= 0 && zz < nz;
                    mask |= ok << q;
                    e[ZD + q] = ok ? poff(j - 1, zz) - e[SRC] : 0;
                }
                e[ZMASK] = mask;
            }
        }
        cp_async_wait_all();
        __syncthreads();
        // the slot of plane t + R + 1 held plane t - R - 1, last read by
        // step t - 1 (level 1's taps, level 2's u_prev)
        if (t + R + 1 < nz) load_u(t + R + 1);
        cp_async_commit();

        for (int j = 1; j <= T; ++j) {
            const int* e = tab[t & 1][j];
            const int z = e[Z];
            if (z < 0) continue;
            const int hj = h_of(j), wj = w_of(j), pw = w_of(j - 1);
            const int qw = w_of(j - 2);
            const int src = e[SRC], prv = e[PRV], dst = e[DST];
            const int dprev = e[DPREV], zmask = e[ZMASK];
            int zdb[2 * R + 1];        // z tap planes, in bytes from SRC
#pragma unroll
            for (int q = 0; q <= 2 * R; ++q) zdb[q] = 4 * e[ZD + q];
            const float* mp = m.p + z * m.sz;
            const float* dp = damp.p + z * damp.sz;
            const float* up0 = u0.p + z * u0.sz;
            const int sx = (int)m.sx;
            const int items = (hj + G - 1) / G * wj;
            // it / wj by a float reciprocal (exact after the correction:
            // it < 2^24)
            const float rw = 1.f / (float)wj;
            // An item is G points, rows x0..x0+G-1 of one column y (lanes
            // along y: conflict-free, and the G points share their G + 2R
            // x-tap loads).  Its global reads are issued first and used
            // last.  Branch-free: rows past the region are read clamped
            // and not stored, points outside the domain are computed and
            // stored as 0 (what the first design stores there), and the G
            // divisions come last, so the points' work overlaps.  Tap sums
            // start from their first product: a leading 0 + changes only
            // the sign of an exact zero, which compares equal.
            for (int it = tid; it < items; it += nt) {
                int gx = (int)((float)it * rw);
                gx -= gx * wj > it;
                gx += (gx + 1) * wj <= it;
                const int y = it - gx * wj;
                const int x0 = gx * G;
                const int kmax = hj - 1 - x0;      // last point of the item
                float gm[G], gd[G], gu[G];
                const int go0 = (x0 + j * R) * sx + y + j * R;
                const float* mk = mp + go0;
                const float* dk = dp + go0;
                const float* uk = up0 + go0;
#pragma unroll
                for (int k = 0; k < G; ++k) {
                    const int go = min(k, kmax) * sx;
                    gm[k] = __ldg(mk + go);
                    gd[k] = __ldg(dk + go);
                    gu[k] = j == 1 ? __ldg(uk + go) : 0.f;
                }
                // ring j - 1 rows x0 .. x0 + G - 1 + 2R of column y + R
                const float* c0 = sm + src + x0 * pw + y + R;
                float col[G + 2 * R];
#pragma unroll
                for (int d = 0; d < G + 2 * R; ++d)
                    col[d] = c0[min(d, kmax + 2 * R) * pw];
                const float* pv = sm + prv + (x0 + 2 * R) * qw + y + 2 * R;
                float num[G], den[G];
#pragma unroll
                for (int k = 0; k < G; ++k) {
                    const int kr = min(k, kmax);
                    const float* pc = c0 + (kr + R) * pw;     // centre
                    const char* pcb = reinterpret_cast<const char*>(pc);
                    const float u = col[k + R];
                    float lx = col[k] * cf.c[0][0];
#pragma unroll
                    for (int q = 1; q <= 2 * R; ++q) lx += col[k + q] * cf.c[0][q];
                    float ly = pc[-R] * cf.c[1][0];
#pragma unroll
                    for (int q = 1; q <= 2 * R; ++q)
                        ly += (q == R ? u : pc[q - R]) * cf.c[1][q];
                    float lz = (zmask & 1 ? *reinterpret_cast<const float*>(
                                                pcb + zdb[0]) : 0.f) * cf.c[2][0];
#pragma unroll
                    for (int q = 1; q <= 2 * R; ++q) {
                        const float v = q == R ? u
                            : ((zmask >> q) & 1
                               ? *reinterpret_cast<const float*>(pcb + zdb[q])
                               : 0.f);
                        lz += v * cf.c[2][q];
                    }
                    const float lap = (lx + ly) + lz;
                    const float mm = gm[k], dd = gd[k];
                    const float up = j >= 2 ? pv[kr * qw] : gu[k];
                    num[k] = a.dt2 * lap + mm * (2.f * u - up) + dd * a.dt * u;
                    den[k] = mm + dd * a.dt;
                }
#pragma unroll
                for (int k = 0; k < G; ++k) num[k] = num[k] / den[k];
                // domain: the column's test once, each row's below
                const bool col_in = DOM || (b.oy - b.H + y + j * R >= 0
                                            && b.oy - b.H + y + j * R < b.ny);
                float* po = sm + dst + x0 * wj + y;
                float* pp = sm + dprev + x0 * wj + y;
#pragma unroll
                for (int k = 0; k < G; ++k) {
                    if (k > kmax) break;
                    if (j == T) pp[k * wj] = col[k + R];
                    const int gxr = b.ox - b.H + x0 + k + j * R;
                    const bool in = DOM
                        ? b.template in_domain<DOM>(x0 + k + j * R, y + j * R)
                        : col_in && gxr >= 0 && gxr < b.nx;
                    po[k * wj] = in ? rnd<S>(num[k]) : 0.f;
                }
            }
            __syncthreads();
            if (z < zr[0] || z > zr[1]) continue;
            // grid-aligned injection of step j into this plane's region
            for (int q = tid; q < a.src_cap; q += nt) {
                const int* c = a.src_coords + (b.tile * a.src_cap + q) * 3;
                const float v =
                    to_f(a.src_vals[(b.tile * T + j - 1) * a.src_cap + q]);
                int x, y;
                if (v == 0.f || c[2] != z || !b.in_region(c, j * R, &x, &y))
                    continue;
                float* d = sm + dst + (x - j * R) * wj + (y - j * R);
                *d = rnd<S>(*d + v);
            }
            __syncthreads();
        }

        // receiver partials of every level's plane of this step
        for (int j = 1; j <= T; ++j) {
            const int z = tab[t & 1][j][Z];
            if (z < 0 || z < zr[2] || z > zr[3]) continue;
            const float* v = sm + tab[t & 1][j][DST];
            for (int q = tid; q < a.rec_cap; q += nt) {
                const int* c = a.rec_coords + (b.tile * a.rec_cap + q) * 3;
                if (c[2] != z || !b.owns(c)) continue;
                const int x = c[0] - b.wox - j * R, y = c[1] - b.woy - j * R;
                const float w = to_f(a.rec_w[b.tile * a.rec_cap + q]);
                a.rec_out[(b.tile * T + j - 1) * a.rec_cap + q] =
                    from_f<S>(w * v[x * w_of(j) + y]);
            }
        }
        // write out the staged planes of u_{T-1} and u_T
        const int zT = t - (T - 1) * R;
        if (zT >= 0 && (zT % OUT_CHUNK == OUT_CHUNK - 1 || zT == nz - 1)) {
            const int z0 = zT - zT % OUT_CHUNK;
            if (fdz <= zT - z0) {
                const long long base = b.shot * a.out_shot + z0 + fdz;
                const int cols = b.bx * b.by;
                int cx = fx0, cy = fy0;
                for (int col = tid / OUT_CHUNK; col < cols; col += fstep) {
                    const long long gx = (long long)b.ti * b.tx + b.wox + cx;
                    const long long g =
                        base + (gx * b.ny + b.tj * b.ty + b.woy + cy) * nz;
                    // staging: [u_T planes][u_{T-1} planes]
                    const float* st = sm + ring[T] + fdz * pitch + col;
                    a.out[0][g] = from_f<S>(st[OUT_CHUNK * pitch]);
                    a.out[1][g] = from_f<S>(st[0]);
                    cx += fdx;
                    cy += fdy;
                    if (cy >= b.by) {
                        cy -= b.by;
                        ++cx;
                    }
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// The cluster-shared z-wavefront (B6)
// ---------------------------------------------------------------------------

#define WAVE_MAX_T 8                        // depths B6 takes
#define WAVE_MAX_K 2                        // planes a step it takes
#define WAVE_MIN_R 4                        // radii it takes: orders 8..16
#define WAVE_SEAMS (8 * (WAVE_MAX_T - 1))   // (level, neighbour) seams

// B6's parts table: the spec window cut into px x py parts by cut lines
// fixed in window coordinates, 0 = xc[0] < ... < xc[px] = wx and the same
// in y; block rank a * py + b of a cluster keeps part (a, b) at every
// level; `planes` (K) planes of every level a step
struct WaveArgs {
    int px, py, planes;
    int xc[CLUSTER_MAX + 1];
    int yc[CLUSTER_MAX + 1];
};

struct Rect {
    int x0, y0, h, w;
};

static __host__ __device__ inline int imax(int a, int b)
{
    return a > b ? a : b;
}
static __host__ __device__ inline int imin(int a, int b)
{
    return a < b ? a : b;
}

// planes of level j's ring (j < T) at K planes a step: the 2r + K planes
// level j + 1 taps, the K planes level j writes meanwhile and, where level
// j + 2 reads it as its u_prev r + K planes later, the K planes it reads
// (`stencil_tb.wave_slots`)
static __host__ __device__ inline int wave_slots(int r, int j, int T, int K)
{
    return j + 2 <= T ? 2 * r + 3 * K : 2 * r + 2 * K;
}

// part (a, b) at level j: its own points (the part within the region of
// margin j r), or with `ring` the rectangle its ring holds: those widened
// by r, within the region (`stencil_tb.wave_rect`)
static __host__ __device__ inline Rect wave_rect(const WaveArgs& w, int a,
                                                 int b, int j, int r, int wx,
                                                 int wy, bool ring)
{
    const int s = ring ? r : 0, m = j * r;
    const int x0 = imax(w.xc[a] - s, m), x1 = imin(w.xc[a + 1] + s, wx - m);
    const int y0 = imax(w.yc[b] - s, m), y1 = imin(w.yc[b + 1] + s, wy - m);
    return {x0, y0, x1 - x0, y1 - y0};
}

// floats of part (a, b)'s block: the rings of levels 0..T-1 and the
// staging of its part of the centre, u_T and u_{T-1}
static __host__ __device__ inline long long wave_floats(const WaveArgs& w,
                                                        int a, int b, int T,
                                                        int r, int wx, int wy)
{
    long long f = 0;
    for (int j = 0; j < T; ++j) {
        const Rect q = wave_rect(w, a, b, j, r, wx, wy, true);
        f += (long long)wave_slots(r, j, T, w.planes) * q.h * q.w;
    }
    const Rect c = wave_rect(w, a, b, T, r, wx, wy, false);
    return f + 2LL * OUT_CHUNK * stage_pitch(c.h, c.w);
}

// shared bytes of a B6 block: the largest part's (`stencil_tb.wave_smem`)
static long long wave_smem(const WaveArgs& w, int T, int r, int wx, int wy)
{
    long long most = 0;
    for (int a = 0; a < w.px; ++a)
        for (int b = 0; b < w.py; ++b) {
            const long long f = 4 * wave_floats(w, a, b, T, r, wx, wy);
            if (f > most) most = f;
        }
    return most;
}

// whether a parts table is one B6 runs: C = px * py parts, cut lines from 0
// to the window's width, every part at least r wide (a seam then lies in
// the eight parts around) and every cut inside the tile (each part holds
// points of every level); K = 1, or 2 where r is even and at least 4 (a
// step's planes then start at multiples of K, and a seam is read two or
// more steps after it is written)
static bool wave_ok(const WaveArgs& w, int C, int r, int H, int wx, int wy)
{
    if (w.px < 1 || w.py < 1 || w.px > CLUSTER_MAX || w.py > CLUSTER_MAX
        || w.px * w.py != C || w.planes < 1 || w.planes > WAVE_MAX_K
        || (w.planes == 2 && (r % 2 || r < 4)) || r < WAVE_MIN_R)
        return false;
    const int* cut[2] = {w.xc, w.yc};
    const int n[2] = {w.px, w.py}, len[2] = {wx, wy};
    for (int d = 0; d < 2; ++d) {
        if (cut[d][0] != 0 || cut[d][n[d]] != len[d]) return false;
        for (int k = 0; k < n[d]; ++k)
            if (cut[d][k + 1] - cut[d][k] < r) return false;
        for (int k = 1; k < n[d]; ++k)
            if (cut[d][k] <= H || cut[d][k] >= len[d] - H) return false;
    }
    return true;
}

// Where a B6 step's time goes (tools/wave_attribution.py builds a copy with
// WAVE_PROFILE defined): thread 0 of every block adds the cycles between
// the step's phase boundaries to wave_prof[phase], and the launch's steps
// to wave_prof[WAVE_PHASES]; none of this is compiled otherwise.
#define WAVE_PHASES 8
#ifdef WAVE_PROFILE
__device__ unsigned long long wave_prof[WAVE_PHASES + 1];
#define WPROF_INIT                                                        \
    __shared__ long long wp_acc[WAVE_PHASES];                             \
    if (tid < WAVE_PHASES) wp_acc[tid] = 0;                               \
    long long wp_last = clock64();
#define WPROF(i)                                                          \
    if (tid == 0) {                                                       \
        const long long c = clock64();                                    \
        wp_acc[i] += c - wp_last;                                         \
        wp_last = c;                                                      \
    }
#define WPROF_DONE                                                        \
    if (tid == 0) {                                                       \
        for (int i = 0; i < WAVE_PHASES; ++i)                             \
            atomicAdd(&wave_prof[i], (unsigned long long)wp_acc[i]);      \
        atomicAdd(&wave_prof[WAVE_PHASES], (unsigned long long)steps);    \
    }
extern "C" int repro_tb_wave_profile(unsigned long long* out, int reset)
{
    cudaError_t e = cudaMemcpyFromSymbol(out, wave_prof, sizeof(wave_prof));
    if (e == cudaSuccess && reset) {
        unsigned long long z[WAVE_PHASES + 1] = {};
        e = cudaMemcpyToSymbol(wave_prof, z, sizeof(z));
    }
    return (int)e;
}
#else
#define WPROF_INIT
#define WPROF(i)
#define WPROF_DONE
#endif

// The acoustic time tile as a wavefront in z shared by a cluster (B6).
// Block rank (a, b) keeps part (a, b) of every level: a ring of
// `wave_slots` planes of its ring rectangle (`wave_rect`), the part's own
// points and the seam, r points of its neighbours' parts around them.
// Step t computes the K planes from K t - (j - 1)(r + K) of level j =
// 1..T (K = `planes`, 1 or 2), so every plane a step reads was written in
// an earlier step and the K planes and T levels of a step are computed
// with no barrier between them.  After a step a block writes the seams of
// its planes into its neighbours' rings (distributed shared memory), which
// read them two or more steps later, and one cluster barrier a step,
// waited one step late, orders those writes and the reads and keeps the
// blocks within two steps of each other; level 0 comes from the z-major
// copy of u with cp.async, seam and all.  A step's items, G points of a
// column of one level's plane, are spread over the block's threads.  Each
// point runs the z-streamed schedule's expressions in its tap order.
template <int R, bool DOM>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
tb_acoustic_kernel(const TileArgs a, const Coefs cf, const StreamArgs s,
                   const WaveArgs wv)
{
    // a step's entries per level j (1..T) and plane k (< K): its plane z
    // (-1 when idle) and its slot in ring j, the own rect's point (0, 0) in
    // ring j - 1's plane z (SRC), in ring j - 2's (PRV, j >= 2), in its
    // output (DST: ring j, or level T's staging; DPREV: level T's u_{T-1}
    // staging), the z taps' planes relative to SRC (ZD + q, 0 beyond [0,
    // nz)) and their mask
    enum { Z, SLOT, SRC, PRV, DST, DPREV, ZMASK, ZD, TW = ZD + 2 * R + 1 };
    // per level j (0..T): its ring's offset in sm (level T: the staging)
    // and ring rect (j < T; level T: the staging's pitch in RW), its own
    // rect, its items a plane, its output row width
    enum { RING, RX, RY, RH, RW, OX, OY, OH, OW, NITEM, DW, GW };
    // a seam (level j of 1..T-1, neighbour n of 8): the points of this
    // block's part of level j that the neighbour's ring j holds: its
    // level, its first point in this block's ring j (slot 0), that ring's
    // row and slot stride, the neighbour's row and slot stride, the seam's
    // width and points (0: none)
    enum { SL, SLB, SLR, SLS, SRR, SRS, SW, SN, SEW };
    extern __shared__ __align__(16) float sm[];
    __shared__ int geo[WAVE_MAX_T + 1][GW];
    __shared__ int seam[WAVE_SEAMS][SEW];
    __shared__ float* seam_dst[WAVE_SEAMS];   // its first point there
    __shared__ int zr[4];                 // sources' and receivers' z ranges
    // the z-major copies u_prev, u, m, damp from the spec window's origin,
    // read where they are used (volatile: kept out of the registers the
    // items need)
    __shared__ const float* volatile zv[4];
    __shared__ int tab[2][WAVE_MAX_T + 1][WAVE_MAX_K][TW];
    __shared__ int flags[2];              // a step's: 1 sources, 2 receivers
    __shared__ int seam_on[WAVE_SEAMS], nseam_on;   // the seams with points
    namespace cg = cooperative_groups;
    const CBlk b(a);
    const int T = a.T, K = wv.planes, nz = a.nz, tid = threadIdx.x;
    const int nt = blockDim.x, wx = b.wx, wy = b.wy;
    const int pa = b.rank / wv.py, pb = b.rank % wv.py;
    const ZView u1 = b.copy(s, a.nshots, 1);
    const int zsx = (int)u1.sx;             // the copies' strides
    const long long zsz = u1.sz;
    if (tid < 4) zv[tid] = b.copy(s, a.nshots, tid).p;
    if (tid == 0) {
        int o = 0;
        for (int j = 0; j <= T; ++j) {
            int* g = geo[j];
            const Rect own = wave_rect(wv, pa, pb, j, R, wx, wy, false);
            g[OX] = own.x0;
            g[OY] = own.y0;
            g[OH] = own.h;
            g[OW] = own.w;
            g[NITEM] = (own.h + G - 1) / G * own.w;
            g[RING] = o;
            if (j < T) {
                const Rect q = wave_rect(wv, pa, pb, j, R, wx, wy, true);
                g[RX] = q.x0;
                g[RY] = q.y0;
                g[RH] = q.h;
                g[RW] = q.w;
                g[DW] = q.w;
                o += wave_slots(R, j, T, K) * q.h * q.w;
            } else {
                g[RX] = g[RY] = 0;
                g[RH] = 2 * OUT_CHUNK;
                g[RW] = stage_pitch(own.h, own.w);     // staging pitch
                g[DW] = own.w;
            }
        }
        zr[0] = zr[2] = INT_MAX;
        zr[1] = zr[3] = -1;
    }
    __syncthreads();
    if (tid < 8 * (T - 1)) {
        // seam of level j for neighbour (pa + da, pb + db)
        const int j = 1 + tid / 8, n = tid % 8;
        const int k = n < 4 ? n : n + 1;          // skip (0, 0)
        const int na = pa + k / 3 - 1, nb = pb + k % 3 - 1;
        int* e = seam[tid];
        e[SN] = 0;
        if (na >= 0 && na < wv.px && nb >= 0 && nb < wv.py) {
            const int* g = geo[j];
            const Rect q = wave_rect(wv, na, nb, j, R, wx, wy, true);
            const int x0 = imax(g[OX], q.x0), y0 = imax(g[OY], q.y0);
            const int x1 = imin(g[OX] + g[OH], q.x0 + q.h);
            const int y1 = imin(g[OY] + g[OW], q.y0 + q.w);
            if (x1 > x0 && y1 > y0) {
                int o = 0;                // the neighbour's ring j
                for (int i = 0; i < j; ++i) {
                    const Rect p = wave_rect(wv, na, nb, i, R, wx, wy, true);
                    o += wave_slots(R, i, T, K) * p.h * p.w;
                }
                e[SL] = j;
                e[SLB] = g[RING] + (x0 - g[RX]) * g[RW] + (y0 - g[RY]);
                e[SLR] = g[RW];
                e[SLS] = g[RH] * g[RW];
                e[SRR] = q.w;
                e[SRS] = q.h * q.w;
                e[SW] = y1 - y0;
                e[SN] = (x1 - x0) * (y1 - y0);
                seam_dst[tid] = cg::this_cluster().map_shared_rank(
                    sm + o + (x0 - q.x0) * q.w + (y0 - q.y0),
                    (unsigned)(na * wv.py + nb));
            }
        }
    }
    const int* g1 = geo[1];
    for (int p = tid; p < a.src_cap; p += nt) {
        const int* c = a.src_coords + (b.tile * a.src_cap + p) * 3;
        if (c[0] >= g1[OX] && c[0] < g1[OX] + g1[OH] && c[1] >= g1[OY]
            && c[1] < g1[OY] + g1[OW] && c[2] >= 0 && c[2] < nz) {
            atomicMin(&zr[0], c[2]);
            atomicMax(&zr[1], c[2]);
        }
    }
    const auto own_T = [&](const int* c) {
        const int* g = geo[T];
        return c[0] >= g[OX] && c[0] < g[OX] + g[OH] && c[1] >= g[OY]
            && c[1] < g[OY] + g[OW] && c[2] >= 0 && c[2] < nz;
    };
    for (int p = tid; p < a.rec_cap; p += nt) {
        const int* c = a.rec_coords + (b.tile * a.rec_cap + p) * 3;
        if (own_T(c)) {
            atomicMin(&zr[2], c[2]);
            atomicMax(&zr[3], c[2]);
        }
    }
    __syncthreads();
    if (tid == 0) {
        int n = 0;
        for (int e = 0; e < 8 * (T - 1); ++e)
            if (seam[e][SN]) seam_on[n++] = e;
        nseam_on = n;
    }
    // float offset in sm of plane z of level j's ring (j < T) or of its
    // staging slot (j == T)
    const auto poff = [&](int j, int z) {
        if (j == T) return geo[T][RING] + (z % OUT_CHUNK) * geo[T][RW];
        return geo[j][RING] + (z % wave_slots(R, j, T, K)) * geo[j][RH]
            * geo[j][RW];
    };
    // cp.async of level 0's plane z, seam and all, by threads t0..nt-1:
    // 16-byte copies where the rows are whole 16-byte groups, else 4-byte
    const auto load_u = [&](int z, int t0) {
        float* dst = sm + poff(0, z);
        const float* src = zv[1] + z * zsz + geo[0][RX] * zsx + geo[0][RY];
        const int h = geo[0][RH], w = geo[0][RW], n = nt - t0;
        if (((reinterpret_cast<unsigned long long>(src)
              | reinterpret_cast<unsigned long long>(dst)) & 15) == 0
            && (w & 3) == 0 && (zsx & 3) == 0) {
            const int w4 = w >> 2;
            for (int i = tid - t0; i < h * w4; i += n) {
                const int x = i / w4;
                cp_async16(dst + 4 * i, src + x * zsx + 4 * (i - x * w4));
            }
            return;
        }
        for (int i = tid - t0; i < h * w; i += n) {
            const int x = i / w;
            cp_async4(dst + i, src + x * zsx + (i - x * w));
        }
    };
    const int lag = R + K;                  // planes level j trails j - 1
    const int steps = (nz + (T - 1) * lag + K - 1) / K;
    // the step table of step t: entry (j, kz) by lane 0 of warp w0 + ((j
    // - 1) K + kz) mod (warps - w0), so the entries are filled side by
    // side, by warps w0.. (the block's warps with the fewest items of step
    // t - 1, which fill it meanwhile).  Each finds its rings' slots by one
    // division and the z taps' by wrapping around the ring.  Lane 0 of
    // warp w0 also sets the step's flags: whether a plane of it holds
    // sources or receivers of this block
    const auto fill = [&](int t, int w0) {
        const int warp = tid >> 5, nwarps = nt >> 5;
        if (tid == w0 * 32) {
            int f = 0;
            for (int j = 1; j <= T; ++j)
                for (int kz = 0; kz < K; ++kz) {
                    const int z = K * t - (j - 1) * lag + kz;
                    if (z >= 0 && z < nz && z >= zr[0] && z <= zr[1])
                        f |= 1;
                    if (z >= 0 && z < nz && z >= zr[2] && z <= zr[3])
                        f |= 2;
                }
            flags[t & 1] = f;
        }
        if ((tid & 31) || warp < w0) return;
        for (int i = warp - w0; i < T * K; i += nwarps - w0) {
            const int j = 1 + i / K, kz = i - (j - 1) * K;
            const int z = K * t - (j - 1) * lag + kz;
            int* e = tab[t & 1][j][kz];
            if (z < 0 || z >= nz) {
                e[Z] = -1;
                continue;
            }
            const int* g = geo[j];
            const int* gs = geo[j - 1];
            // plane z's slot in ring r (< T) and its offset there
            const auto at = [&](int r, int* slot) {
                *slot = z % wave_slots(R, r, T, K);
                return geo[r][RING] + *slot * geo[r][RH] * geo[r][RW];
            };
            int sl, ss;
            e[Z] = z;
            e[SLOT] = j < T ? (at(j, &sl), sl) : 0;
            e[SRC] = at(j - 1, &ss) + (g[OX] - gs[RX]) * gs[RW]
                + (g[OY] - gs[RY]);
            e[PRV] = 0;
            if (j >= 2) {
                const int* gp = geo[j - 2];
                e[PRV] = at(j - 2, &sl) + (g[OX] - gp[RX]) * gp[RW]
                    + (g[OY] - gp[RY]);
            }
            e[DST] = j < T ? at(j, &sl) + (g[OX] - g[RX]) * g[RW]
                                 + (g[OY] - g[RY])
                           : geo[T][RING] + z % OUT_CHUNK * geo[T][RW];
            e[DPREV] = geo[T][RING] + (OUT_CHUNK + z % OUT_CHUNK)
                * geo[T][RW];
            // tap plane z + q - R of ring j - 1, from plane z (slot ss)
            const int S = wave_slots(R, j - 1, T, K);
            const int area = gs[RH] * gs[RW];
            int mask = 0;
#pragma unroll
            for (int q = 0; q <= 2 * R; ++q) {
                const int zz = z + q - R;
                const bool ok = zz >= 0 && zz < nz;
                int d = ss + q - R;
                d += d < 0 ? S : 0;
                d -= d >= S ? S : 0;
                mask |= ok << q;
                e[ZD + q] = ok ? (d - ss) * area : 0;
            }
            e[ZMASK] = mask;
        }
    };

    // level 0's planes of step 0 (level 1's taps of planes 0..K-1)
    for (int z = 0; z < R + K && z < nz; ++z) load_u(z, 0);
    cp_async_commit();
    fill(0, 0);
    // every block of the cluster runs before any writes into its rings
    cluster_barrier();
    WPROF_INIT
    for (int t = 0; t < steps; ++t) {
        const int par = t & 1;
        cp_async_wait_all();
        WPROF(0)
        __syncthreads();
        WPROF(1)

        int s0 = 0;
        for (int j = 1; j <= T; ++j) {
            const int* g = geo[j];
            const int items = g[NITEM];
            const int hj = g[OH], wj = g[OW], gox = g[OX], goy = g[OY];
            const int pw = geo[j - 1][RW], qw = j >= 2 ? geo[j - 2][RW] : 0;
            const int dw = g[DW];
            const float rw = 1.f / (float)wj;
            for (int kz = 0; kz < K; ++kz) {
                const int* e = tab[par][j][kz];
                const int z = e[Z];
                if (z < 0) continue;
                // the block's items of the step run over the levels and
                // planes in turn: this thread's of this plane are those
                // congruent to tid
                int it = (tid - s0) & (nt - 1);    // nt: a power of 2
                s0 += items;
                if (it >= items) continue;
                const int src = e[SRC], prv = e[PRV], dst = e[DST];
                const int dprev = e[DPREV], zmask = e[ZMASK];
                int zdb[2 * R + 1];        // z tap planes, in bytes from SRC
#pragma unroll
                for (int q = 0; q <= 2 * R; ++q) zdb[q] = 4 * e[ZD + q];
                const float* mp = zv[2] + z * zsz;
                const float* dp = zv[3] + z * zsz;
                const float* up0 = zv[0] + z * zsz;
                const int sx = zsx;
                for (; it < items; it += nt) {
                    int gx = (int)((float)it * rw);
                    gx -= gx * wj > it;
                    gx += (gx + 1) * wj <= it;
                    const int y = it - gx * wj;
                    const int x0 = gx * G;
                    const int kmax = hj - 1 - x0;      // last point of the item
                    float gm[G], gd[G], gu[G];
                    const int go0 = (gox + x0) * sx + goy + y;
                    const float* mk = mp + go0;
                    const float* dk = dp + go0;
                    const float* uk = up0 + go0;
#pragma unroll
                    for (int k = 0; k < G; ++k) {
                        const int go = min(k, kmax) * sx;
                        gm[k] = __ldg(mk + go);
                        gd[k] = __ldg(dk + go);
                        gu[k] = j == 1 ? __ldg(uk + go) : 0.f;
                    }
                    // ring j - 1 rows x0 - R .. x0 + G - 1 + R of column y
                    const float* c0 = sm + src + (x0 - R) * pw + y;
                    float col[G + 2 * R];
#pragma unroll
                    for (int d = 0; d < G + 2 * R; ++d)
                        col[d] = c0[min(d, kmax + 2 * R) * pw];
                    const float* pv = sm + prv + x0 * qw + y;
                    float num[G], den[G];
#pragma unroll
                    for (int k = 0; k < G; ++k) {
                        const int kr = min(k, kmax);
                        const float* pc = c0 + (kr + R) * pw;     // centre
                        const char* pcb = reinterpret_cast<const char*>(pc);
                        const float u = col[k + R];
                        float lx = col[k] * cf.c[0][0];
#pragma unroll
                        for (int q = 1; q <= 2 * R; ++q) lx += col[k + q] * cf.c[0][q];
                        float ly = pc[-R] * cf.c[1][0];
#pragma unroll
                        for (int q = 1; q <= 2 * R; ++q)
                            ly += (q == R ? u : pc[q - R]) * cf.c[1][q];
                        float lz = (zmask & 1 ? *reinterpret_cast<const float*>(
                                                    pcb + zdb[0]) : 0.f) * cf.c[2][0];
#pragma unroll
                        for (int q = 1; q <= 2 * R; ++q) {
                            const float v = q == R ? u
                                : ((zmask >> q) & 1
                                   ? *reinterpret_cast<const float*>(pcb + zdb[q])
                                   : 0.f);
                            lz += v * cf.c[2][q];
                        }
                        const float lap = (lx + ly) + lz;
                        const float mm = gm[k], dd = gd[k];
                        const float up = j >= 2 ? pv[kr * qw] : gu[k];
                        num[k] = a.dt2 * lap + mm * (2.f * u - up) + dd * a.dt * u;
                        den[k] = mm + dd * a.dt;
                    }
#pragma unroll
                    for (int k = 0; k < G; ++k) num[k] = num[k] / den[k];
                    // domain: the column's test once, each row's below
                    const bool col_in = DOM || (b.oy - b.H + goy + y >= 0
                                                && b.oy - b.H + goy + y < b.ny);
                    float* po = sm + dst + x0 * dw + y;
                    float* pp = sm + dprev + x0 * dw + y;
#pragma unroll
                    for (int k = 0; k < G; ++k) {
                        if (k > kmax) break;
                        if (j == T) pp[k * dw] = col[k + R];
                        const int gxr = b.ox - b.H + gox + x0 + k;
                        const bool in = DOM
                            ? b.template in_domain<DOM>(gox + x0 + k, goy + y)
                            : col_in && gxr >= 0 && gxr < b.nx;
                        po[k * dw] = in ? num[k] : 0.f;
                    }
                }
            }
        }
        WPROF(2)
        // the warps with the fewest items this step (those past the
        // items' count mod the threads; all where it is a multiple) load
        // level 0's planes of the next step and fill its table meanwhile.
        // The planes' slots held planes 2R + 3K back, last read at step t -
        // 1 (level 2's u_prev); the table's, step t - 1's
        int w0 = ((s0 & (nt - 1)) + 31) >> 5;
        w0 = w0 < (nt >> 5) ? w0 : 0;
        if (tid >= w0 * 32) {
            for (int kz = 0; kz < K; ++kz)
                if (K * (t + 1) + R + kz < nz)
                    load_u(K * (t + 1) + R + kz, w0 * 32);
            if (t + 1 < steps) fill(t + 1, w0);
        }
        cp_async_commit();
        WPROF(3)
        __syncthreads();
        WPROF(4)

        // grid-aligned injection of step j into level j's planes, at the
        // points of this block's part: one writer a slot
        if (flags[par] & 1) {
            for (int j = 1; j <= T; ++j) {
                const int* g = geo[j];
                for (int kz = 0; kz < K; ++kz) {
                    const int z = tab[par][j][kz][Z];
                    if (z < 0 || z < zr[0] || z > zr[1]) continue;
                    for (int q = tid; q < a.src_cap; q += nt) {
                        const int* c =
                            a.src_coords + (b.tile * a.src_cap + q) * 3;
                        const float v =
                            a.src_vals[(b.tile * T + j - 1) * a.src_cap + q];
                        const int x = c[0] - g[OX], y = c[1] - g[OY];
                        if (v == 0.f || c[2] != z || x < 0 || x >= g[OH]
                            || y < 0 || y >= g[OW])
                            continue;
                        float* d = sm + tab[par][j][kz][DST] + x * g[DW] + y;
                        *d = *d + v;
                    }
                }
            }
            __syncthreads();
        }
        WPROF(5)
        // the seams of this step's planes into the neighbours' rings
        // (distributed shared memory), one point a thread at a time over
        // all seams and planes.  A neighbour reads a seam as the centre
        // plane of the next level, two or more steps later; the slot it
        // overwrites was last read three or more steps before, so a block
        // at most two steps ahead of another (the lagged wait below)
        // writes nothing early
        {
            int e = -1, s1 = 0, n = 0, lb = 0, lr = 0, rr = 0, w = 1;
            float* rp = nullptr;
            const int ne = nseam_on * K;
            for (int gi = tid;; gi += nt) {
                while (gi >= s1 + n) {
                    s1 += n;
                    n = 0;
                    if (++e >= ne) break;
                    // seam e >> (K - 1) with points, at plane e & (K - 1)
                    // (K is 1 or 2)
                    const int si = seam_on[e >> (K - 1)];
                    const int* se = seam[si];
                    const int* te = tab[par][se[SL]][e & (K - 1)];
                    if (te[Z] < 0) continue;
                    n = se[SN];
                    lb = se[SLB] + te[SLOT] * se[SLS];
                    rp = seam_dst[si] + te[SLOT] * se[SRS];
                    lr = se[SLR];
                    rr = se[SRR];
                    w = se[SW];
                }
                if (e >= ne) break;
                const int k = gi - s1, x = k / w, y = k - x * w;
                rp[x * rr + y] = sm[lb + x * lr + y];
            }
        }
        WPROF(6)
        // receiver partials of every level's planes of this step, at the
        // points of this block's part of the centre
        for (int j = 1; j <= T && (flags[par] & 2); ++j) {
            const int* g = geo[j];
            for (int kz = 0; kz < K; ++kz) {
                const int z = tab[par][j][kz][Z];
                if (z < 0 || z < zr[2] || z > zr[3]) continue;
                const float* v = sm + tab[par][j][kz][DST];
                for (int q = tid; q < a.rec_cap; q += nt) {
                    const int* c = a.rec_coords + (b.tile * a.rec_cap + q) * 3;
                    if (c[2] != z || !own_T(c)) continue;
                    a.rec_out[(b.tile * T + j - 1) * a.rec_cap + q] =
                        a.rec_w[b.tile * a.rec_cap + q]
                        * v[(c[0] - g[OX]) * g[DW] + (c[1] - g[OY])];
                }
            }
        }
        // write out the staged planes of u_{T-1} and u_T, as the z-streamed
        // schedule does, over the part's centre (hT x wT), once a step
        // completes a chunk (K divides OUT_CHUNK and level T's first plane
        // of a step is a multiple of K)
        const int zf = K * t - (T - 1) * lag;     // level T's first plane
        const int zT = imin(zf + K - 1, nz - 1);  // and its last
        if (zT >= 0 && zT >= zf
            && (zT % OUT_CHUNK == OUT_CHUNK - 1 || zT == nz - 1)) {
            const int* gT = geo[T];
            const int hT = gT[OH], wT = gT[OW], pitch = gT[RW];
            const int fdz = tid % OUT_CHUNK, fstep = nt / OUT_CHUNK;
            const int fx0 = (tid / OUT_CHUNK) / wT;
            const int fy0 = (tid / OUT_CHUNK) % wT;
            const int fdx = fstep / wT, fdy = fstep % wT;
            const int z0 = zT - zT % OUT_CHUNK;
            if (fdz <= zT - z0) {
                const long long base = b.shot * a.out_shot + z0 + fdz;
                int cx = fx0, cy = fy0;
                for (int col = tid / OUT_CHUNK; col < hT * wT; col += fstep) {
                    const long long gx =
                        (long long)b.ti * b.tx + gT[OX] - b.H + cx;
                    const long long gi = base
                        + (gx * b.ny + (long long)b.tj * b.ty + gT[OY] - b.H
                           + cy) * nz;
                    // staging: [u_T planes][u_{T-1} planes]
                    const float* st = sm + gT[RING] + fdz * pitch + col;
                    a.out[0][gi] = st[OUT_CHUNK * pitch];
                    a.out[1][gi] = st[0];
                    cx += fdx;
                    cy += fdy;
                    if (cy >= wT) {
                        cy -= wT;
                        ++cx;
                    }
                }
            }
        }
        // this step's seams are sent; the previous step's of every block
        // have arrived (the wait lags one step, so the barrier's latency
        // hides behind a step's work)
        WPROF(7)
        if (t > 0) cluster_wait();
        cluster_arrive();
    }
    WPROF_DONE
    // no block leaves while another may still write into its rings
    cluster_wait();
}

// fills the arguments and launches, on sub-tile (bx, by), the copies and
// the z-streamed instantiation of `radius` (and of whether `dom` is given,
// where DOM_OK), or with bx = 0 the first schedule's
template <class S, bool DOM_OK>
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
    const int e = tile_args(&a, &cf, device, 4, 2, in, src_coords,
                            src_vals, rec_coords, rec_w, out, rec_out,
                            scratch, dom, param_rows & PARAM_ROWS, nshots,
                            nx, ny, nz,
                            tx, ty, T, H, src_cap, rec_cap, radius, coefs,
                            2 * radius + 1, dt, dt2);
    if (e) return e;
    const cudaStream_t st = (cudaStream_t)stream;
    if (bx == 0) {
        with_radius(radius, dom != nullptr, [&](auto r, auto d) {
            if constexpr (DOM_OK || !decltype(d)::value)
                tb_acoustic_kernel<decltype(r)::value, decltype(d)::value, S>
                    <<<tile_grid(a), THREADS, 0, st>>>(a, cf);
        });
        return (int)cudaGetLastError();
    }
    const long long smem = acoustic_smem(T, radius, bx, by);
    if (T > MAX_T || H != T * radius || !subtile_ok(tx, ty, bx, by, smem))
        return (int)cudaErrorInvalidValue;
    const StreamArgs s = stream_args(a, reinterpret_cast<float*>(scratch),
                                     2, 2, param_rows, bx, by, 0);
    launch_to_zmajor(a, s, 2, param_rows, st);
    int rc = 0;
    with_radius(radius, dom != nullptr, [&](auto r, auto d) {
        constexpr int KR = decltype(r)::value;
        constexpr bool KD = decltype(d)::value;
        if constexpr (DOM_OK || !KD) {
            void (*kern)(const TileArgsT<S>, const Coefs, const StreamArgs) =
                tb_acoustic_kernel<KR, KD, S>;
            rc = (int)cudaFuncSetAttribute(
                kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (rc == 0)
                kern<<<stream_grid(nx, ny, tx, ty, s, nshots), STREAM_THREADS,
                       smem, st>>>(a, cf, s);
        }
    });
    return rc ? rc : (int)cudaGetLastError();
}

// the params' z-major copies for `repro_tb_tile(_bf16)` with
// PARAMS_COPIED (see tb_stream.cuh)
extern "C" int repro_tb_param_copies(int device, const float* const* in,
                                     int nparam, int param_rows, int nshots,
                                     int nx, int ny, int nz, int H,
                                     float* out, void* stream)
{
    return param_copies(device, in, nparam, param_rows, nshots, nx, ny, nz,
                        H, out, stream);
}

extern "C" int repro_tb_param_copies_bf16(
    int device, const __nv_bfloat16* const* in, int nparam, int param_rows,
    int nshots, int nx, int ny, int nz, int H, float* out, void* stream)
{
    return param_copies(device, in, nparam, param_rows, nshots, nx, ny, nz,
                        H, out, stream);
}

// (bx, by): the z-streamed schedule's sub-tile, or (0, 0) for the first
// schedule, whose scratch is then two windows a tile in the storage type
extern "C" int repro_tb_tile(
    int device, const float* const* in, const int* src_coords,
    const float* src_vals, const int* rec_coords, const float* rec_w,
    float* const* out, float* rec_out, float* scratch, const float* dom,
    int param_rows, int nshots, int nx, int ny, int nz, int tx, int ty, int T,
    int H, int src_cap, int rec_cap, int radius, const float* coefs, float dt,
    float dt2, int bx, int by, void* stream)
{
    return launch<float, true>(device, in, src_coords, src_vals, rec_coords,
                               rec_w, out, rec_out, scratch, dom, param_rows,
                               nshots, nx, ny, nz, tx, ty, T, H, src_cap,
                               rec_cap, radius, coefs, dt, dt2, bx, by,
                               stream);
}

// B1a-bf16: fields, params, source values, receiver weights and partials
// in bf16 (the z-streamed schedule's scratch, the float32 copies, is
// passed as it is); no domain mask (a non-null `dom` is refused)
extern "C" int repro_tb_tile_bf16(
    int device, const __nv_bfloat16* const* in, const int* src_coords,
    const __nv_bfloat16* src_vals, const int* rec_coords,
    const __nv_bfloat16* rec_w, __nv_bfloat16* const* out,
    __nv_bfloat16* rec_out, __nv_bfloat16* scratch, const float* dom,
    int param_rows, int nshots, int nx, int ny, int nz, int tx, int ty, int T,
    int H, int src_cap, int rec_cap, int radius, const float* coefs, float dt,
    float dt2, int bx, int by, void* stream)
{
    if (dom != nullptr) return (int)cudaErrorInvalidValue;
    return launch<__nv_bfloat16, false>(
        device, in, src_coords, src_vals, rec_coords, rec_w, out, rec_out,
        scratch, dom, param_rows, nshots, nx, ny, nz, tx, ty, T, H, src_cap,
        rec_cap, radius, coefs, dt, dt2, bx, by, stream);
}

// f(kernel): B6's instantiation of `radius` (WAVE_MIN_R and up) and of
// whether `dom` is given
template <class F>
static void with_wave(int radius, bool dom, F f)
{
    with_radius(radius, dom, [&](auto r, auto d) {
        constexpr int KR = decltype(r)::value;
        if constexpr (KR >= WAVE_MIN_R) {
            void (*k)(const TileArgs, const Coefs, const StreamArgs,
                      const WaveArgs) =
                tb_acoustic_kernel<KR, decltype(d)::value>;
            f(k);
        }
    });
}

// B6 (the cluster-shared z-wavefront): `cluster` blocks a spec tile, the
// parts table (px x py parts, cut lines xc[0..px] and yc[0..py] in window
// coordinates; `planes` planes a step), checked here, `smem` the shared
// bytes a block (at least `wave_smem` of the table); float32, T =
// 2..WAVE_MAX_T.  The scratch is
// the z-major copies alone.  A table, cluster or shared size the card
// cannot take is refused: no other schedule stands in.
extern "C" int repro_tb_tile_wave(
    int device, const float* const* in, const int* src_coords,
    const float* src_vals, const int* rec_coords, const float* rec_w,
    float* const* out, float* rec_out, float* scratch, const float* dom,
    int param_rows, int nshots, int nx, int ny, int nz, int tx, int ty, int T,
    int H, int src_cap, int rec_cap, int radius, const float* coefs, float dt,
    float dt2, int cluster, int px, int py, int planes, const int* xc,
    const int* yc, int smem, void* stream)
{
    TileArgs a;
    Coefs cf;
    const int e = tile_args(&a, &cf, device, 4, 2, in, src_coords, src_vals,
                            rec_coords, rec_w, out, rec_out, scratch, dom,
                            param_rows & PARAM_ROWS, nshots, nx, ny, nz, tx,
                            ty, T, H, src_cap, rec_cap, radius, coefs,
                            2 * radius + 1, dt, dt2);
    if (e) return e;
    if (T < 2 || T > WAVE_MAX_T || H != T * radius || cluster < 1
        || cluster > CLUSTER_MAX || px < 1 || py < 1 || px > CLUSTER_MAX
        || py > CLUSTER_MAX || smem > STREAM_SMEM || !xc || !yc
        || (long long)(nx / tx) * (ny / ty) > 65535)
        return (int)cudaErrorInvalidValue;
    WaveArgs w{};
    w.px = px;
    w.py = py;
    w.planes = planes;
    for (int k = 0; k <= px; ++k) w.xc[k] = xc[k];
    for (int k = 0; k <= py; ++k) w.yc[k] = yc[k];
    const int wx = tx + 2 * H, wy = ty + 2 * H;
    if (!wave_ok(w, cluster, radius, H, wx, wy)
        || wave_smem(w, T, radius, wx, wy) > smem)
        return (int)cudaErrorInvalidValue;
    const StreamArgs s = stream_args(a, scratch, 2, 2, param_rows, tx, ty, 0);
    const cudaStream_t st = (cudaStream_t)stream;
    launch_to_zmajor(a, s, 2, param_rows, st);
    const dim3 grid(cluster, (nx / tx) * (ny / ty), nshots);
    int rc = 0;
    with_wave(radius, dom != nullptr, [&](auto kern) {
        rc = cluster_launch(kern, cluster, grid, STREAM_THREADS, smem, st, a,
                            cf, s, w);
    });
    return rc;
}

// the clusters of B6 blocks (`cluster` a cluster, `smem` shared bytes a
// block) the card holds at once, into *active (0: none; a launch raises)
extern "C" int repro_tb_wave_occupancy(int radius, int dom, int cluster,
                                       int smem, int* active)
{
    if (radius < WAVE_MIN_R || radius > MAX_RADIUS || cluster < 1
        || cluster > CLUSTER_MAX || smem > STREAM_SMEM)
        return (int)cudaErrorInvalidValue;
    int rc = 0;
    with_wave(radius, dom != 0, [&](auto kern) {
        cudaLaunchAttribute attr;
        cudaLaunchConfig_t cfg;
        rc = cluster_config(kern, cluster, dim3(cluster), STREAM_THREADS,
                            smem, nullptr, &attr, &cfg, active);
    });
    return rc;
}
