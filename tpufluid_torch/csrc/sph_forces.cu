// Dense-grid forces: the symmetrised spiky pressure force f and the
// viscosity force g (times mu) over the 3x3 cell stencil
// (compute.wgsl:160-299), on the slot grid that
// ops.dense.build_grid_cols rebuilds every step, with the variants
// surface_tension (the colour-field force folded into f,
// compute.wgsl:303-498) and adaptive (pressure candidates strided by
// 1/5/13 as the target's density crosses 150/200,
// shaders/compute.wgsl:170-174,195).
//
// Replaces tpufluid/ops/pallas/sph.py:forces (_forces_kernel), which on the
// TPU ran one program per grid row over rows y-1, y, y+1 (clamped block
// index maps) with lane rolls by dx, all slots of a row as one vector.
//
// Bound: memory traffic through L1/L2. Each live target reads up to six
// fields (px, py, valid, then vx, vy, dens within range) of up to 9 * K
// candidate slots and does ~40 flops, a sqrt and two divisions per
// in-range candidate.
//
// Design: one thread per output slot (y, k, x); a block covers 128
// consecutive columns of one (row, slot), so candidate loads of a warp are
// coalesced. Candidates run in the TPU kernel's order (row y-1, y, y+1
// clamped; dx -1, 0, +1 wrapping modulo Gxp; slot kp ascending), each
// added to the running sums on its own. A cell's particles fill a prefix
// of its K slots, so a candidate column ends at its first empty slot;
// a candidate beyond h adds exactly +0.0 in the TPU kernel and is skipped.
// An empty target adds nothing in the TPU kernel (its validity masks every
// pair), so it skips the candidates and writes the epilogue's zeros.
// Coincident pairs take one of four tie-break directions computed once
// per target: pair-order salt x draw ordinal clamped at 1 (ops/pairs.py).
// The variants are template parameters, so the base kernel carries none
// of their code or registers.
#include "common.cuh"

// The unit direction of the first two xorshift32 draws after ``seed``.
__device__ __forceinline__ void unit_draw(uint32_t seed, float* ux,
                                          float* uy) {
    const uint32_t s1 = tf_xorshift32(seed);
    const uint32_t s2 = tf_xorshift32(s1);
    const float rx = tf_u01(s1);
    const float ry = tf_u01(s2);
    float rn = sqrtf(rx * rx + ry * ry);
    if (rn == 0.0f) rn = 1.0f;
    *ux = rx / rn;
    *uy = ry / rn;
}

template <bool ST, bool ADAPTIVE>
__global__ void __launch_bounds__(TF_BLOCK)
sph_forces_kernel(const float* __restrict__ px, const float* __restrict__ py,
                  const float* __restrict__ vx, const float* __restrict__ vy,
                  const uint8_t* __restrict__ valid,
                  const float* __restrict__ dens,
                  const float* __restrict__ sc,
                  const long long* __restrict__ frame_p,
                  float* __restrict__ fx_o, float* __restrict__ fy_o,
                  float* __restrict__ gx_o, float* __restrict__ gy_o,
                  int gy, int K, int gx, float h, float h2, float sqr_radius,
                  float spiky_norm, float visc_norm, float c_r3, float c_r2,
                  float c_half_h, float st_grad_norm, float st_lap_norm,
                  float c_3h2) {
    const int x = blockIdx.x * TF_BLOCK + threadIdx.x;
    const int k = blockIdx.y;
    const int y = blockIdx.z;
    // sc = [pressure_constant, rest_density, mu, mass, st_threshold,
    //       st_coefficient]
    const float k_pressure = sc[0];
    const float rest_density = sc[1];
    const float mu = sc[2];
    const size_t ti = tf_index(y, k, x, K, gx);
    const float px0 = px[ti];
    const float py0 = py[ti];
    const uint32_t frame = (uint32_t)frame_p[0];

    float fx = 0.0f, fy = 0.0f, gxs = 0.0f, gys = 0.0f;
    float cgx = 0.0f, cgy = 0.0f, clap = 0.0f;
    if (valid[ti]) {
        const float vx0 = vx[ti];
        const float vy0 = vy[ti];
        const float d0 = dens[ti];
        const float p_self = k_pressure * (d0 - rest_density);

        // tie-break directions t<pair-order salt * 2 + draw ordinal>
        uint32_t seed = (__float_as_uint(px0) * 0x9E3779B1u) ^
                        (__float_as_uint(py0) * 0x85EBCA6Bu);
        seed = seed + frame * 69u;
        float t0x, t0y, t1x, t1y, t2x, t2y, t3x, t3y;
        unit_draw(seed, &t0x, &t0y);
        unit_draw(seed + 2654435761u, &t1x, &t1y);
        unit_draw(seed + 0x27220A95u, &t2x, &t2y);
        unit_draw(seed + 2654435761u + 0x27220A95u, &t3x, &t3y);
        float st_dx = 0.0f, st_dy = 0.0f;
        if (ST) {  // one draw per target, compute.wgsl:406
            const uint32_t st_i = (uint32_t)(int)fmaxf(px0, 0.0f);
            unit_draw(st_i * 324u + frame * 5632u, &st_dx, &st_dy);
        }
        const int stride = ADAPTIVE ? (d0 >= 200.0f ? 13 : d0 >= 150.0f ? 5 : 1)
                                    : 1;
        const float mass = sc[3];

        uint32_t coinc = 0;  // coincident draws so far
        for (int r = -1; r <= 1; ++r) {
            const int sy = min(max(y + r, 0), gy - 1);
            for (int dx = -1; dx <= 1; ++dx) {
                const int sx = (x + dx + gx) % gx;
                const bool center = r == 0 && dx == 0;
                const bool before = r < 0 || (r == 0 && dx < 0);
                for (int kp = 0; kp < K; ++kp) {
                    const size_t ci = tf_index(sy, kp, sx, K, gx);
                    if (!valid[ci]) break;
                    const float ddx = px[ci] - px0;
                    const float ddy = py[ci] - py0;
                    const float r2 = ddx * ddx + ddy * ddy;
                    if (r2 > sqr_radius) continue;
                    const float dst = sqrtf(r2);
                    const bool in_range = !(center && kp == k);
                    const float safe = dst == 0.0f ? 1.0f : dst;
                    const float inv_dst = 1.0f / safe;
                    float dirx = ddx * inv_dst;
                    float diry = ddy * inv_dst;
                    if (in_range && dst == 0.0f) {
                        const bool salted = center ? kp < k : before;
                        const bool prior = coinc >= 1u;
                        dirx = salted ? (prior ? t3x : t2x)
                                      : (prior ? t1x : t0x);
                        diry = salted ? (prior ? t3y : t2y)
                                      : (prior ? t1y : t0y);
                        ++coinc;
                    }
                    const float ndk = dens[ci];
                    const float p_nb = k_pressure * (ndk - rest_density);
                    const float shared_p = (p_self + p_nb) * 0.5f;
                    const float kern_p =
                        dst <= h ? -(h - dst) * spiky_norm : 0.0f;
                    const float inv_rho = 1.0f / (ndk == 0.0f ? 1.0f : ndk);
                    const bool in_range_p =
                        in_range && (!ADAPTIVE || kp % stride == 0);
                    const float wp =
                        in_range_p ? kern_p * shared_p * inv_rho : 0.0f;
                    fx = fx + dirx * wp;
                    fy = fy + diry * wp;

                    // viscosity kernel, division-free (sph.py:303-307)
                    float kv = visc_norm * (r2 * safe * c_r3 + r2 * c_r2 +
                                            inv_dst * c_half_h - 1.0f);
                    if (dst == 0.0f) kv = visc_norm;
                    if (!(dst <= h)) kv = 0.0f;
                    const float wv = in_range ? kv * inv_rho : 0.0f;
                    gxs = gxs + (vx[ci] - vx0) * wv;
                    gys = gys + (vy[ci] - vy0) * wv;

                    if (ST) {  // self pair included
                        const bool co_st = dst == 0.0f;
                        const float sdx = co_st ? st_dx : dirx;
                        const float sdy = co_st ? st_dy : diry;
                        const float rlen2 = sdx * sdx + sdy * sdy;
                        const float rlen = sqrtf(rlen2);
                        const float gdiff = h2 - rlen2;
                        const float gsc = (rlen >= h || rlen == 0.0f)
                                              ? 0.0f
                                              : st_grad_norm * gdiff * gdiff;
                        const float m_rho = mass * inv_rho;
                        cgx = cgx + m_rho * gsc * sdx;
                        cgy = cgy + m_rho * gsc * sdy;
                        const float lap =
                            dst > h ? 0.0f
                                    : st_lap_norm * (h2 - r2) *
                                          (c_3h2 - 4.0f * r2);
                        clap = clap + m_rho * lap;
                    }
                }
            }
        }
    }
    if (ST) {  // pairs.surface_tension composition (compute.wgsl:303-315)
        const float n_len = sqrtf(cgx * cgx + cgy * cgy);
        const float safe_len = n_len == 0.0f ? 1.0f : n_len;
        const float k_st = (-clap) / (n_len + 1e-6f);
        if (n_len > sc[4]) {
            const float coef = sc[5];
            fx = fx + -coef * k_st * (cgx / safe_len);
            fy = fy + -coef * k_st * (cgy / safe_len);
        }
    }
    fx_o[ti] = fx;
    fy_o[ti] = fy;
    gx_o[ti] = gxs * mu;
    gy_o[ti] = gys * mu;
}

template <bool ST, bool ADAPTIVE>
static void launch(dim3 grid, cudaStream_t stream, const float* px,
                   const float* py, const float* vx, const float* vy,
                   const uint8_t* valid, const float* dens, const float* sc,
                   const long long* frame, float* fx, float* fy, float* gxo,
                   float* gyo, int gy, int K, int gx, const float* c) {
    sph_forces_kernel<ST, ADAPTIVE><<<grid, TF_BLOCK, 0, stream>>>(
        px, py, vx, vy, valid, dens, sc, frame, fx, fy, gxo, gyo, gy, K, gx,
        c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], c[9], c[10]);
}

extern "C" int tf_sph_forces(const float* px, const float* py,
                             const float* vx, const float* vy,
                             const uint8_t* valid, const float* dens,
                             const float* sc, const long long* frame,
                             float* fx, float* fy, float* gxo, float* gyo,
                             int gy, int K, int gx, int surface_tension,
                             int adaptive, float h, float h2,
                             float sqr_radius, float spiky_norm,
                             float visc_norm, float c_r3, float c_r2,
                             float c_half_h, float st_grad_norm,
                             float st_lap_norm, float c_3h2,
                             cudaStream_t stream) {
    if (gx % TF_BLOCK != 0 || gy <= 0 || K <= 0 || gy > 65535 || K > 65535)
        return (int)cudaErrorInvalidValue;
    dim3 grid(gx / TF_BLOCK, K, gy);
    const float c[11] = {h,        h2,   sqr_radius,   spiky_norm,
                         visc_norm, c_r3, c_r2,         c_half_h,
                         st_grad_norm, st_lap_norm, c_3h2};
    auto fn = surface_tension ? (adaptive ? launch<true, true>
                                          : launch<true, false>)
                              : (adaptive ? launch<false, true>
                                          : launch<false, false>);
    fn(grid, stream, px, py, vx, vy, valid, dens, sc, frame, fx, fy, gxo, gyo,
       gy, K, gx, c);
    return (int)cudaGetLastError();
}
