// Temporally-blocked isotropic elastic (velocity-stress) time tile for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_tb_kernel` of
// src/repro/kernels/stencil_tb.py (launched by `tb_time_tile`) with
// `tb_physics.ELASTIC`, in float32: state vx, vy, vz, txx, tyy, tzz, txy,
// txz, tyz; params lam, mu, b, damp.  The schedule shared with the
// acoustic and TTI kernels is described in tb_common.cuh.  Per (x, y)
// tile, T times (src/repro/core/propagators/elastic.py:64-111):
//
//   phase V, over the whole window: the three velocities from the old
//     stresses, v = dmp (v + (dt b) (d1 + d2 + d3)) with
//     dmp = 1 / (1 + damp dt), then zero outside the physical x/y domain
//     (the reference's `mask_fn`);
//   phase S, over the whole window: the six stresses from the new
//     velocities, e.g. txx = dmp (txx + dt (lam div v + (2 mu) dvx/dx)),
//     txy = dmp (txy + (dt mu) (dvx/dy + dvy/dx)), then the domain mask;
//   inject the source values into txx, tyy and tzz; record w * vz and
//   w * (-(txx + tyy + tzz) / 3) at the receivers.
//
// Staggered derivatives have `order` taps: forward (offsets 1-R..R) when
// the operand's staggering bit on that axis is 0, backward (-R..R-1) when
// it is 1, as `_d` chooses; the host passes the one set of weights both
// use.  Every field is read at other points only by the other phase, so
// each phase updates its fields in place (a thread reads the old value at
// the point it overwrites): nine scratch windows a tile, the first step
// reading the padded inputs and writing the scratch.
//
// What bounds it: bytes — 13 fields in and 9 out, 11.8 GB at 512^3, 3.53
// ms at 3.35 TB/s, against 165 flops per point-step (1.32 ms of a depth-4
// tile at 67 TFLOP/s).  Like the acoustic kernel this first design
// re-reads every field from device memory at every in-window step.

#include "tb_common.cuh"

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
    const int e = tile_args(&a, &cf, device, 13, 9, in, src_coords,
                            src_vals, rec_coords, rec_w, out, rec_out,
                            scratch, dom, param_rows, nshots, nx, ny, nz,
                            tx, ty, T, H, src_cap, rec_cap, radius, coefs,
                            2 * radius, dt, dt2);
    if (e) return e;
    with_radius(radius, dom != nullptr, [&](auto r, auto d) {
        tb_elastic_kernel<decltype(r)::value, decltype(d)::value>
            <<<tile_grid(a), THREADS, 0, (cudaStream_t)stream>>>(a, cf);
    });
    return (int)cudaGetLastError();
}
