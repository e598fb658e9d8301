// The resident engine's pair math, shared by density.cu, forces.cu and
// physics.cu: the per-target density sum over the 3x3 cell stencil and
// the per-target force loop fused with the integration.
//
// Each function takes a candidate source: an object whose pred() (density)
// or cand() (forces) returns a candidate slot's predicted position (and
// velocity, pressure, 1/rho) or false for an empty slot. density.cu and
// forces.cu read global memory and predict there; physics.cu reads the
// predictions, velocities and (pres, 1/rho) it staged in shared memory.
// The arithmetic is the same code in all three kernels, and every f32
// operation rounds on its own (-fmad=false), so the fused physics kernel
// is bitwise equal to the split density + forces pair.
#pragma once

#include <string.h>

#include "common.cuh"

// Per-world scalar columns, in the order of the JAX package's sc stacks
// (tpufluid/ops/pallas/fused.py: forces_integrate 17, physics 19; density
// the first 4 of its 6, its half extents being arguments here). A world's
// row is sc + wid[y] * n_columns.
#define TF_DSC_MASS 0
#define TF_DSC_DT 1
#define TF_DSC_KP 2
#define TF_DSC_RHO0 3
#define TF_DSC_N 4

#define TF_SC_DT 0
#define TF_SC_MU 1
#define TF_SC_GRAV_X 2
#define TF_SC_GRAV_Y 3
#define TF_SC_DAMPING 4
#define TF_SC_MOUSE_X 5
#define TF_SC_MOUSE_Y 6
#define TF_SC_MOUSE_R 7
#define TF_SC_MOUSE_P 8
#define TF_SC_MOUSE_S 9
#define TF_SC_HALF_X 10
#define TF_SC_HALF_Y 11
#define TF_SC_FF_SX 12
#define TF_SC_FF_SY 13
#define TF_SC_MASS 14
#define TF_SC_ST_THRESHOLD 15
#define TF_SC_ST_COEFFICIENT 16
#define TF_SC_N 17
// physics only: the density's pressure constant and rest density
#define TF_SC_KP 17
#define TF_SC_RHO0 18
#define TF_PSC_N 19

// variant flags of forces_integrate and physics (template parameters)
#define TF_WRAP 1
#define TF_HAS_FF 2
#define TF_ST 4
#define TF_ADAPT 8

// Settings constants of the force loop, each rounded once to f32 from
// double as the JAX kernels' Python constants are.
struct TfForceConsts {
    float h, h2, sqr_radius, c_spiky, visc_norm, c_r3, c_r2, c_inv;
    float st_grad, st_lap, c3h2;
};

__device__ __forceinline__ int tf_world(const int* wid, int y) {
    return wid != nullptr ? wid[y] : 0;
}

// occupancy of rows y-1, y, y+1 (0 outside the grid)
__device__ __forceinline__ void tf_occ_nb(const int* occ_row, int y, int gy,
                                          int occ_nb[3]) {
    for (int r = -1; r <= 1; ++r) {
        const int sy = y + r;
        occ_nb[r + 1] = (sy >= 0 && sy < gy) ? occ_row[sy] : 0;
    }
}

// Poly6 sum of target (y, x) at predicted (tx, ty): candidate slot kp
// below occ3, and for each the nine (row, dx) blocks summed into a
// partial that is then added to the total (the TPU kernel's order).
template <class Src>
__device__ __forceinline__ float tf_density_sum(const Src& src, int y, int x,
                                                int gx, const int occ_nb[3],
                                                int occ3, float tx, float ty,
                                                float h2) {
    float acc = 0.0f;
    for (int kp = 0; kp < occ3; ++kp) {
        float part = 0.0f;
        for (int r = -1; r <= 1; ++r) {
            if (kp >= occ_nb[r + 1]) continue;
            const int sy = y + r;
            for (int dx = -1; dx <= 1; ++dx) {
                const int sx = x + dx;
                if (sx < 0 || sx >= gx) continue;
                float nx, ny;
                if (!src.pred(sy, kp, sx, nx, ny)) continue;
                const float ddx = nx - tx;
                const float ddy = ny - ty;
                const float r2 = ddx * ddx + ddy * ddy;
                const float diff = fmaxf(h2 - r2, 0.0f);
                part = part + diff * diff * diff;
            }
        }
        acc = acc + part;
    }
    return acc;
}

// rho after the EPSILON and 0.1 floors -> (pressure, 1/rho)
__device__ __forceinline__ void tf_density_out(float acc, float mass,
                                               float norm, float kp_c,
                                               float rho0, float& pres,
                                               float& invr) {
    float rho = mass * (norm * acc);
    rho = fmaxf(fmaxf(rho, TF_EPSILON), 0.1f);
    pres = kp_c * (rho - rho0);
    invr = 1.0f / rho;
}

// The empty target's floor-density defaults.
__device__ __forceinline__ void tf_density_empty(float kp_c, float rho0,
                                                 float& pres, float& invr) {
    pres = kp_c * (0.1f - rho0);
    invr = 10.0f;
}

// Forces on one live target slot (y, k, x) over the 3x3 stencil, then
// the integration. Off-centre blocks use the TPU kernel's clamp form
// (min(dst - h, 0) and max(kv, 0) are the range gates); the centre block
// tests r^2 <= h^2, excludes the target itself and gives coincident pairs
// the xorshift tie-break direction (compute.wgsl:211-215).
// WRAP: x walls teleport with the velocity kept (shaders/compute.wgsl:
// 145-146). ST: the colour-field gradient and Laplacian sums, self pair
// included, coincident pairs along the target's own seeded direction
// (compute.wgsl:303-498), composed as in fused.py:951-965. ADAPT: the
// pressure term of candidate slot kp is kept only for kp % 5 == 0 above
// self density 150, kp % 13 == 0 above 200, the self density recovered
// as 1/invr (shaders/compute.wgsl:170-174,195). HAS_FF: the cell's
// pixel-space obstacle push-out (ffx, ffy) after the move.
template <bool WRAP, bool HAS_FF, bool ST, bool ADAPT, class Src>
__device__ __forceinline__ void tf_forces_target(
        const Src& src, const float* __restrict__ scw, uint32_t frame, int k,
        int y, int x, int gx, const int occ_nb[3], int occ3, float pos_x0,
        float pos_y0, float vx0, float vy0, float p_self, float invr0,
        float ffx, float ffy, const TfForceConsts& c, float& out_px,
        float& out_py, float& out_vx, float& out_vy) {
    const float dt = scw[TF_SC_DT];
    const float half_x = scw[TF_SC_HALF_X];
    const float half_y = scw[TF_SC_HALF_Y];
    const float h = c.h;
    const float px0 = tf_pred(pos_x0, vx0, dt, half_x);
    const float py0 = tf_pred(pos_y0, vy0, dt, half_y);

    // tie-break base direction from the predicted position's bits
    uint32_t seed = (__float_as_uint(px0) * 0x9E3779B1u) ^
                    (__float_as_uint(py0) * 0x85EBCA6Bu);
    seed = seed + frame * 69u;
    const uint32_t s1 = tf_xorshift32(seed);
    const uint32_t s2 = tf_xorshift32(s1);
    const float rx = tf_u01(s1);
    const float ry = tf_u01(s2);
    const float inv_n = rsqrtf(fmaxf(rx * rx + ry * ry, 1e-30f));
    const float d0x = rx * inv_n;
    const float d0y = ry * inv_n;

    float st_dx = 0.0f, st_dy = 0.0f;
    if (ST) {  // seeded from the predicted x (compute.wgsl:406)
        const int st_i = (int)fmaxf(px0, 0.0f);
        const uint32_t st_seed = (uint32_t)st_i * 324u + frame * 5632u;
        const uint32_t t1 = tf_xorshift32(st_seed);
        const uint32_t t2 = tf_xorshift32(t1);
        const float strx = tf_u01(t1);
        const float stry = tf_u01(t2);
        float strn = sqrtf(strx * strx + stry * stry);
        if (strn == 0.0f) strn = 1.0f;
        st_dx = strx / strn;
        st_dy = stry / strn;
    }
    const float rho_self = ADAPT ? 1.0f / invr0 : 0.0f;
    const float mass = scw[TF_SC_MASS];

    float sfx = 0.0f, sfy = 0.0f, sgx = 0.0f, sgy = 0.0f;
    float scgx = 0.0f, scgy = 0.0f, sclap = 0.0f;
    uint32_t scc = 0;  // coincident draws so far
    for (int kp = 0; kp < occ3; ++kp) {
        float fac = 1.0f;
        if (ADAPT) {
            if (rho_self >= 200.0f)
                fac = kp % 13 == 0 ? 1.0f : 0.0f;
            else if (rho_self >= 150.0f)
                fac = kp % 5 == 0 ? 1.0f : 0.0f;
        }
        float fx = 0.0f, fy = 0.0f, gx_ = 0.0f, gy_ = 0.0f;
        float cgx = 0.0f, cgy = 0.0f, cl = 0.0f;
        for (int r = -1; r <= 1; ++r) {
            if (kp >= occ_nb[r + 1]) continue;
            const int sy = y + r;
            for (int dx = -1; dx <= 1; ++dx) {
                const int sx = x + dx;
                if (sx < 0 || sx >= gx) continue;
                float nx, ny, nvx_c, nvy_c, p_nb, inv_rho;
                if (!src.cand(sy, kp, sx, nx, ny, nvx_c, nvy_c, p_nb,
                              inv_rho))
                    continue;
                const float ddx = nx - px0;
                const float ddy = ny - py0;
                const float r2 = ddx * ddx + ddy * ddy;
                const float inv_dst = rsqrtf(fmaxf(r2, 1e-35f));
                const float dst = r2 * inv_dst;
                const bool centre = r == 0 && dx == 0;
                float dirx = ddx * inv_dst;
                float diry = ddy * inv_dst;
                bool in_range = true;
                if (!centre) {
                    const float kern_p = fminf(dst - h, 0.0f) * c.c_spiky;
                    float wp = kern_p * (p_self + p_nb) * inv_rho;
                    if (ADAPT) wp = wp * fac;
                    const float s = wp * inv_dst;
                    fx = fx + ddx * s;
                    fy = fy + ddy * s;
                } else {
                    in_range = (r2 <= c.sqr_radius) && (k != kp);
                    if (in_range && dst == 0.0f) {
                        const bool has_prior = scc >= 1u;
                        const bool salted = kp < k;
                        dirx = salted ? (has_prior ? d0y : -d0x)
                                      : (has_prior ? -d0y : d0x);
                        diry = salted ? (has_prior ? -d0x : -d0y)
                                      : (has_prior ? d0x : d0y);
                        ++scc;
                    }
                    const float kern_p = (dst - h) * c.c_spiky;
                    const bool in_range_p = ADAPT ? in_range && fac > 0.0f
                                                  : in_range;
                    const float wp =
                        in_range_p ? kern_p * (p_self + p_nb) * inv_rho
                                   : 0.0f;
                    fx = fx + dirx * wp;
                    fy = fy + diry * wp;
                }
                if (ST) {
                    const bool ok_st = r2 <= c.sqr_radius;
                    float sdx = dirx, sdy = diry;
                    if (centre && ok_st && dst == 0.0f) {
                        sdx = st_dx;
                        sdy = st_dy;
                    }
                    const float rlen2 = sdx * sdx + sdy * sdy;
                    const float rlen = sqrtf(rlen2);
                    const float gdiff = c.h2 - rlen2;
                    const float gsc = (rlen >= h || rlen == 0.0f)
                                          ? 0.0f
                                          : c.st_grad * gdiff * gdiff;
                    const float m_rho = mass * inv_rho;
                    cgx = cgx + (ok_st ? m_rho * gsc * sdx : 0.0f);
                    cgy = cgy + (ok_st ? m_rho * gsc * sdy : 0.0f);
                    const float lap =
                        dst > h ? 0.0f
                                : c.st_lap * (c.h2 - r2) *
                                      (c.c3h2 - 4.0f * r2);
                    cl = cl + (ok_st ? m_rho * lap : 0.0f);
                }
                float kv = r2 * dst * c.c_r3 + r2 * c.c_r2 +
                           inv_dst * c.c_inv - 1.0f;
                float wv;
                if (!centre) {
                    wv = fmaxf(kv, 0.0f) * inv_rho;
                } else {
                    if (dst == 0.0f) kv = 1.0f;
                    wv = in_range ? kv * inv_rho : 0.0f;
                }
                gx_ = gx_ + (nvx_c - vx0) * wv;
                gy_ = gy_ + (nvy_c - vy0) * wv;
            }
        }
        sfx = sfx + fx;
        sfy = sfy + fy;
        sgx = sgx + gx_;
        sgy = sgy + gy_;
        if (ST) {
            scgx = scgx + cgx;
            scgy = scgy + cgy;
            sclap = sclap + cl;
        }
    }

    // integration (compute.wgsl:95-155)
    const float visc_mu = c.visc_norm * scw[TF_SC_MU];
    float accel_x = sfx + sgx * visc_mu;
    float accel_y = sfy + sgy * visc_mu;
    if (ST) {  // pairs.surface_tension composition (compute.wgsl:303-315)
        const float n_len = sqrtf(scgx * scgx + scgy * scgy);
        const float safe_len = n_len == 0.0f ? 1.0f : n_len;
        const float k_st = (-sclap) / (n_len + 1e-6f);
        const bool apply_st = n_len > scw[TF_SC_ST_THRESHOLD];
        const float coef = scw[TF_SC_ST_COEFFICIENT];
        accel_x = accel_x +
                  (apply_st ? -coef * k_st * (scgx / safe_len) : 0.0f);
        accel_y = accel_y +
                  (apply_st ? -coef * k_st * (scgy / safe_len) : 0.0f);
    }
    float vxn = vx0 + accel_x * invr0 * dt + scw[TF_SC_GRAV_X] * dt;
    float vyn = vy0 + accel_y * invr0 * dt + scw[TF_SC_GRAV_Y] * dt;

    // mouse impulse (compute.wgsl:99-108): at dist 0 under a press the
    // reference computes 0/0 = NaN, which the NaN reset then zeroes
    const float mouse_state = scw[TF_SC_MOUSE_S];
    const float mouse_radius = scw[TF_SC_MOUSE_R];
    const float diffx = scw[TF_SC_MOUSE_X] - px0;
    const float diffy = scw[TF_SC_MOUSE_Y] - py0;
    const float dist = sqrtf(diffx * diffx + diffy * diffy);
    if (mouse_state != 0.0f && dist <= mouse_radius) {
        const float msafe = dist == 0.0f ? 1.0f : dist;
        float iscale = scw[TF_SC_MOUSE_P] * mouse_state *
                       (dist / mouse_radius) / (msafe * msafe);
        if (dist == 0.0f) iscale = __int_as_float(0x7fc00000);  // NaN
        vxn = vxn + diffx * iscale;
        vyn = vyn + diffy * iscale;
    }

    if (isnan(vxn) || isnan(vyn)) {  // NaN reset (compute.wgsl:113-116)
        vxn = 0.0f;
        vyn = 0.0f;
    }

    const float sp = sqrtf(vxn * vxn + vyn * vyn);  // compute.wgsl:118-122
    if (sp > TF_MAX_SPEED) {
        const float scl = TF_MAX_SPEED / sp;
        vxn = vxn * scl;
        vyn = vyn * scl;
    }

    const float damping = scw[TF_SC_DAMPING];
    float pxn = pos_x0 + vxn * dt;
    float pyn = pos_y0 + vyn * dt;
    if (HAS_FF && (ffx != 0.0f || ffy != 0.0f)) {  // fused.py:1000-1023
        const float fn = sqrtf(ffx * ffx + ffy * ffy);
        const float fsafe = fn == 0.0f ? 1.0f : fn;
        const float nhx = ffx / fsafe;
        const float nhy = ffy / fsafe;
        pxn = pxn + ffx * scw[TF_SC_FF_SX];
        pyn = pyn + ffy * scw[TF_SC_FF_SY];
        const float vn = vxn * nhx + vyn * nhy;
        const float refl = 1.0f - damping;
        vxn = vxn - refl * vn * nhx;
        vyn = vyn - refl * vn * nhy;
    }
    if (fabsf(pxn) > half_x) {  // bounce / x-wrap (compute.wgsl:143-153)
        if (WRAP) {
            pxn = -copysignf(half_x, pxn);
        } else {
            pxn = copysignf(half_x, pxn);
            vxn = vxn * -damping;
        }
    }
    if (fabsf(pyn) > half_y) {
        pyn = copysignf(half_y, pyn);
        vyn = vyn * -damping;
    }
    out_px = pxn;
    out_py = pyn;
    out_vx = vxn;
    out_vy = vyn;
}
