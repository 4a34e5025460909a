// Temporally-blocked TTI (tilted transversely isotropic pseudo-acoustic)
// time tile for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_tb_kernel` of
// src/repro/kernels/stencil_tb.py (launched by `tb_time_tile`) with
// `tb_physics.TTI`, in float32: state p, p_prev, r, r_prev; params m,
// damp, epsilon, delta, theta, phi.  The schedule shared with the acoustic
// and elastic kernels is described in tb_common.cuh.  Per (x, y) tile,
// T times (src/repro/core/propagators/tti.py:57-116):
//
//   phase A, over the whole window: the inner rotated first derivatives
//     the update uses, Dx~p, Dy~p and Dz~r, times the domain mask
//     (the reference's `mask_fn`);
//   phase B, over the whole window: the outer rotated derivatives
//     h0_p = Dx~(Dx~p) + Dy~(Dy~p) and hz_r = Dz~(Dz~r), then
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
// phases; that costs arithmetic, which this kernel has to spare, instead
// of four more window-sized fields of traffic.  The terms of every
// directional derivative are summed x, y, z, as in `_dir_derivative`.
//
// What bounds it: on the roofline, operations — the reference prices a
// point-step at 508 flops at order 4, so a depth-4 tile of the 512^3 case
// needs 4.07 ms at 67 TFLOP/s against 2.24 ms for its 7.5 GB of least
// traffic.  In this first design bytes bound it in practice: like the
// acoustic kernel it keeps every window in a per-block scratch in device
// memory (p and r ping-pong, the step's output overwriting the previous
// time level, which is read only pointwise; plus the three inner windows:
// seven windows a tile) and re-reads every field at every in-window step.

#include "tb_common.cuh"

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
template <int R, bool DOM>
__global__ void __launch_bounds__(THREADS, R <= 4 ? 2 : 1)
tb_tti_kernel(const TileArgs a, const Coefs cf)
{
    constexpr int NT = 2 * R + 1;          // central first derivative taps
    const Tile t(a);
    float* pbuf[2] = {t.scratch(a, 0, 7), t.scratch(a, 1, 7)};
    float* rbuf[2] = {t.scratch(a, 2, 7), t.scratch(a, 3, 7)};
    float* gx = t.scratch(a, 4, 7);        // Dx~p
    float* gy = t.scratch(a, 5, 7);        // Dy~p
    float* gz = t.scratch(a, 6, 7);        // Dz~r
    const View vgx = t.window(gx), vgy = t.window(gy), vgz = t.window(gz);
    const View m = t.input(a, 4), damp = t.input(a, 5);
    const View eps = t.input(a, 6), dlt = t.input(a, 7);
    const View theta = t.input(a, 8), phi = t.input(a, 9);
    View p = t.input(a, 0), p_prev = t.input(a, 1);
    View r = t.input(a, 2), r_prev = t.input(a, 3);

    for (int k = 0; k < a.T; ++k) {
        // phase A: the inner first-derivative fields, masked
        t.for_each_point<DOM>([&](Pt q, bool inside) {
            const long long w = t.at(q);
            if (!inside) {
                gx[w] = 0.f;
                gy[w] = 0.f;
                gz[w] = 0.f;
                return;
            }
            const Dirs d(t.ro(theta, q), t.ro(phi, q));
            const float dxp = t.taps<NT, -R>(p, 0, q, cf.c[0]);
            const float dyp = t.taps<NT, -R>(p, 1, q, cf.c[1]);
            const float dzp = t.taps<NT, -R>(p, 2, q, cf.c[2]);
            const float dxr = t.taps<NT, -R>(r, 0, q, cf.c[0]);
            const float dyr = t.taps<NT, -R>(r, 1, q, cf.c[1]);
            const float dzr = t.taps<NT, -R>(r, 2, q, cf.c[2]);
            gx[w] = (d.x0 * dxp + d.x1 * dyp) + d.x2 * dzp;
            gy[w] = d.y0 * dxp + d.y1 * dyp;
            gz[w] = (d.z0 * dxr + d.z1 * dyr) + d.z2 * dzr;
        });
        __syncthreads();

        // phase B: the outer derivatives and the update; the new p and r
        // overwrite p_prev and r_prev, read only pointwise by this thread
        float* pn = pbuf[k & 1];
        float* rn = rbuf[k & 1];
        t.for_each_point<DOM>([&](Pt q, bool inside) {
            const long long w = t.at(q);
            if (!inside) {
                pn[w] = 0.f;
                rn[w] = 0.f;
                return;
            }
            const Dirs d(t.ro(theta, q), t.ro(phi, q));
            const float gxx = (d.x0 * t.taps<NT, -R>(vgx, 0, q, cf.c[0])
                               + d.x1 * t.taps<NT, -R>(vgx, 1, q, cf.c[1]))
                + d.x2 * t.taps<NT, -R>(vgx, 2, q, cf.c[2]);
            const float gyy = d.y0 * t.taps<NT, -R>(vgy, 0, q, cf.c[0])
                + d.y1 * t.taps<NT, -R>(vgy, 1, q, cf.c[1]);
            const float hz_r = (d.z0 * t.taps<NT, -R>(vgz, 0, q, cf.c[0])
                                + d.z1 * t.taps<NT, -R>(vgz, 1, q, cf.c[1]))
                + d.z2 * t.taps<NT, -R>(vgz, 2, q, cf.c[2]);
            const float h0_p = gxx + gyy;
            const float e_fac = 1.f + 2.f * t.ro(eps, q);
            const float d_fac = sqrtf(1.f + 2.f * t.ro(dlt, q));
            const float mm = t.ro(m, q), dd = t.ro(damp, q);
            const float den = mm + dd * a.dt;
            const float rhs_p = e_fac * h0_p + d_fac * hz_r;
            const float rhs_r = d_fac * h0_p + hz_r;
            const float pc = t.ld(p, q), pp = t.ld(p_prev, q);
            const float rc = t.ld(r, q), rp = t.ld(r_prev, q);
            pn[w] = (a.dt2 * rhs_p + mm * (2.f * pc - pp) + dd * a.dt * pc) / den;
            rn[w] = (a.dt2 * rhs_r + mm * (2.f * rc - rp) + dd * a.dt * rc) / den;
        });
        __syncthreads();

        float* const inj[2] = {pn, rn};
        t.inject(a, k, inj);
        __syncthreads();
        t.record<1>(a, k, [&](long long w, float* s) { s[0] = pn[w]; });
        // the next phase A writes only the inner windows; the next phase B
        // (after a barrier) writes the buffers of this step's p and r
        p_prev = p;
        p = t.window(pn);
        r_prev = r;
        r = t.window(rn);
    }
    const View fin[4] = {p, p_prev, r, r_prev};
    t.write_back<4>(a, fin);
}

extern "C" int repro_tb_tile(
    int device, const float* const* in, const int* src_coords,
    const float* src_vals, const int* rec_coords, const float* rec_w,
    float* const* out, float* rec_out, float* scratch, const float* dom,
    int param_rows, int nshots, int nx, int ny, int nz, int tx, int ty, int T,
    int H, int src_cap, int rec_cap, int radius, const float* coefs, float dt,
    float dt2, void* stream)
{
    TileArgs a;
    Coefs cf;
    const int e = tile_args(&a, &cf, device, 10, 4, in, src_coords,
                            src_vals, rec_coords, rec_w, out, rec_out,
                            scratch, dom, param_rows, nshots, nx, ny, nz,
                            tx, ty, T, H, src_cap, rec_cap, radius, coefs,
                            2 * radius + 1, dt, dt2);
    if (e) return e;
    with_radius(radius, dom != nullptr, [&](auto r, auto d) {
        tb_tti_kernel<decltype(r)::value, decltype(d)::value>
            <<<tile_grid(a), THREADS, 0, (cudaStream_t)stream>>>(a, cf);
    });
    return (int)cudaGetLastError();
}
