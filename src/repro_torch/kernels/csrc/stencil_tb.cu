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
// Two schedules compute the same function; the wrapper picks one a launch
// from its shape (`stencil_tb.launch_plan`) and passes the z-streamed
// schedule's sub-tile, or (0, 0) for the first schedule:
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

#include "tb_stream.cuh"

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
