// Forces + integrate: symmetrised spiky pressure and viscosity over the
// 3x3 cell stencil, fused with the full integration step.
//
// Replaces tpufluid/ops/pallas/fused.py:forces_integrate with its base
// flags and has_ff (_forces_kernel -> _forces_one_row, _forces_cand_block,
// _forces_one_cand, _forces_integrate_sub). The TPU kernel folded the
// slot axis into 8-slot sublane sub-blocks, lane-rolled six candidate
// fields per (row, dx) block and carried per-target sums in VMEM scratch.
//
// Bound: memory traffic through L1/L2. At scene_1m each live target reads
// six fields (predicted position from pos/vel, pres, 1/rho) of about
// 9 * occ3 candidate slots and does ~40 flops and one rsqrt per candidate;
// the grid's own reads and the four output fields cross DRAM about once.
//
// Design: one thread per target slot (y, k, x), 128 consecutive columns
// of one (row, slot) per block, so candidate loads of a warp are
// coalesced. Per-target sums live in registers. Candidate slot kp runs
// below occ3[y]; per candidate the nine (row, dx) blocks go into a
// partial that is then added to the running sums, the TPU kernel's order.
// Off-centre blocks use the TPU kernel's clamp form (min(dst - h, 0) and
// max(kv, 0) are the range gates); the centre block tests r^2 <= h^2,
// excludes the target itself, and gives exactly coincident pairs the
// xorshift tie-break direction, rotated by pair order and prior draws
// (compute.wgsl:211-215). Empty candidates contribute nothing and are
// skipped; empty targets write SENTINEL / 0, so every output is written.
// has_ff (ffx/ffy not null): after the move, a target whose cell holds a
// nonzero pixel-space push-out vector is pushed by it (scaled to world
// units per axis) and has its normal velocity reflected with
// (1 - damping), fused.py:1000-1023. The flag is a template parameter, so
// the base instantiation carries none of the epilogue's code or registers
// (a runtime branch cost the base launch ~12% on the H100).
#include "common.cuh"

template <bool HAS_FF>
__global__ void __launch_bounds__(TF_BLOCK)
forces_kernel(const float* __restrict__ px, const float* __restrict__ py,
              const float* __restrict__ vx, const float* __restrict__ vy,
              const float* __restrict__ pres, const float* __restrict__ invr,
              const int* __restrict__ occ_row, const float* __restrict__ sc,
              const long long* __restrict__ frame_p,
              const float* __restrict__ ffx, const float* __restrict__ ffy,
              float* __restrict__ npx, float* __restrict__ npy,
              float* __restrict__ nvx, float* __restrict__ nvy, int gy, int K,
              int gx, float h, float sqr_radius, float c_spiky,
              float visc_norm, float c_r3, float c_r2, float c_inv,
              float half_x, float half_y, float ff_sx, float ff_sy) {
    const int x = blockIdx.x * TF_BLOCK + threadIdx.x;
    const int k = blockIdx.y;
    const int y = blockIdx.z;
    // sc = [dt, mu, grav_x, grav_y, damping, mouse_x, mouse_y,
    //       mouse_radius, mouse_power, mouse_state]
    const float dt = sc[0];
    const float mu = sc[1];
    const float grav_x = sc[2];
    const float grav_y = sc[3];
    const float damping = sc[4];
    const float mouse_x = sc[5];
    const float mouse_y = sc[6];
    const float mouse_radius = sc[7];
    const float mouse_power = sc[8];
    const float mouse_state = sc[9];
    const size_t ti = tf_index(y, k, x, K, gx);
    const float pos_x0 = px[ti];
    if (k >= occ_row[y] || !tf_live(pos_x0)) {
        npx[ti] = TF_SENTINEL;
        npy[ti] = TF_SENTINEL;
        nvx[ti] = 0.0f;
        nvy[ti] = 0.0f;
        return;
    }
    const float pos_y0 = py[ti];
    const float vx0 = vx[ti];
    const float vy0 = vy[ti];
    const float p_self = pres[ti];
    const float invr0 = invr[ti];
    const float px0 = tf_pred(pos_x0, vx0, dt, half_x);
    const float py0 = tf_pred(pos_y0, vy0, dt, half_y);

    // tie-break base direction from the predicted position's bits
    const uint32_t frame = (uint32_t)frame_p[0];
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

    int occ_nb[3];
    for (int r = -1; r <= 1; ++r) {
        const int sy = y + r;
        occ_nb[r + 1] = (sy >= 0 && sy < gy) ? occ_row[sy] : 0;
    }
    const int occ3 = tf_occ3(occ_row, y, gy);
    float sfx = 0.0f, sfy = 0.0f, sgx = 0.0f, sgy = 0.0f;
    uint32_t scc = 0;  // coincident draws so far
    for (int kp = 0; kp < occ3; ++kp) {
        float fx = 0.0f, fy = 0.0f, gx_ = 0.0f, gy_ = 0.0f;
        for (int r = -1; r <= 1; ++r) {
            if (kp >= occ_nb[r + 1]) continue;
            const int sy = y + r;
            for (int dx = -1; dx <= 1; ++dx) {
                const int sx = x + dx;
                if (sx < 0 || sx >= gx) continue;
                const size_t ci = tf_index(sy, kp, sx, K, gx);
                const float cpx = px[ci];
                if (!tf_live(cpx)) continue;
                const float nvx_c = vx[ci];
                const float nvy_c = vy[ci];
                const float nx = tf_pred(cpx, nvx_c, dt, half_x);
                const float ny = tf_pred(py[ci], nvy_c, dt, half_y);
                const float p_nb = pres[ci];
                const float inv_rho = invr[ci];
                const float ddx = nx - px0;
                const float ddy = ny - py0;
                const float r2 = ddx * ddx + ddy * ddy;
                const float inv_dst = rsqrtf(fmaxf(r2, 1e-35f));
                const float dst = r2 * inv_dst;
                if (r != 0 || dx != 0) {
                    const float kern_p = fminf(dst - h, 0.0f) * c_spiky;
                    const float wp = kern_p * (p_self + p_nb) * inv_rho;
                    const float s = wp * inv_dst;
                    fx = fx + ddx * s;
                    fy = fy + ddy * s;
                    const float kv = fmaxf(r2 * dst * c_r3 + r2 * c_r2 +
                                               inv_dst * c_inv - 1.0f,
                                           0.0f);
                    const float wv = kv * inv_rho;
                    gx_ = gx_ + (nvx_c - vx0) * wv;
                    gy_ = gy_ + (nvy_c - vy0) * wv;
                    continue;
                }
                const bool in_range = (r2 <= sqr_radius) && (k != kp);
                float dirx = ddx * inv_dst;
                float diry = ddy * inv_dst;
                if (in_range && dst == 0.0f) {
                    const bool has_prior = scc >= 1u;
                    const bool salted = kp < k;
                    dirx = salted ? (has_prior ? d0y : -d0x)
                                  : (has_prior ? -d0y : d0x);
                    diry = salted ? (has_prior ? -d0x : -d0y)
                                  : (has_prior ? d0x : d0y);
                    ++scc;
                }
                const float kern_p = (dst - h) * c_spiky;
                const float wp =
                    in_range ? kern_p * (p_self + p_nb) * inv_rho : 0.0f;
                fx = fx + dirx * wp;
                fy = fy + diry * wp;
                float kv = r2 * dst * c_r3 + r2 * c_r2 + inv_dst * c_inv - 1.0f;
                if (dst == 0.0f) kv = 1.0f;
                const float wv = in_range ? kv * inv_rho : 0.0f;
                gx_ = gx_ + (nvx_c - vx0) * wv;
                gy_ = gy_ + (nvy_c - vy0) * wv;
            }
        }
        sfx = sfx + fx;
        sfy = sfy + fy;
        sgx = sgx + gx_;
        sgy = sgy + gy_;
    }

    // integration (compute.wgsl:95-155)
    const float visc_mu = visc_norm * mu;
    const float accel_x = sfx + sgx * visc_mu;
    const float accel_y = sfy + sgy * visc_mu;
    float vxn = vx0 + accel_x * invr0 * dt + grav_x * dt;
    float vyn = vy0 + accel_y * invr0 * dt + grav_y * dt;

    // mouse impulse (compute.wgsl:99-108): at dist 0 under a press the
    // reference computes 0/0 = NaN, which the NaN reset then zeroes
    const float diffx = mouse_x - px0;
    const float diffy = mouse_y - py0;
    const float dist = sqrtf(diffx * diffx + diffy * diffy);
    if (mouse_state != 0.0f && dist <= mouse_radius) {
        const float msafe = dist == 0.0f ? 1.0f : dist;
        float iscale =
            mouse_power * mouse_state * (dist / mouse_radius) / (msafe * msafe);
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

    float pxn = pos_x0 + vxn * dt;
    float pyn = pos_y0 + vyn * dt;
    if (HAS_FF) {  // obstacle push-out (fused.py:1000-1023)
        const size_t fi = (size_t)y * gx + x;
        const float fx = ffx[fi];
        const float fy = ffy[fi];
        if (fx != 0.0f || fy != 0.0f) {
            const float fn = sqrtf(fx * fx + fy * fy);
            const float fsafe = fn == 0.0f ? 1.0f : fn;
            const float nhx = fx / fsafe;
            const float nhy = fy / fsafe;
            pxn = pxn + fx * ff_sx;
            pyn = pyn + fy * ff_sy;
            const float vn = vxn * nhx + vyn * nhy;
            const float refl = 1.0f - damping;
            vxn = vxn - refl * vn * nhx;
            vyn = vyn - refl * vn * nhy;
        }
    }
    if (fabsf(pxn) > half_x) {  // bounce (compute.wgsl:143-153)
        pxn = copysignf(half_x, pxn);
        vxn = vxn * -damping;
    }
    if (fabsf(pyn) > half_y) {
        pyn = copysignf(half_y, pyn);
        vyn = vyn * -damping;
    }
    npx[ti] = pxn;
    npy[ti] = pyn;
    nvx[ti] = vxn;
    nvy[ti] = vyn;
}

extern "C" int tf_forces(const float* px, const float* py, const float* vx,
                         const float* vy, const float* pres, const float* invr,
                         const int* occ_row, const float* sc,
                         const long long* frame, const float* ffx,
                         const float* ffy, float* npx, float* npy,
                         float* nvx, float* nvy, int gy, int K, int gx,
                         float h, float sqr_radius, float c_spiky,
                         float visc_norm, float c_r3, float c_r2, float c_inv,
                         float half_x, float half_y, float ff_sx, float ff_sy,
                         cudaStream_t stream) {
    if (gx % TF_BLOCK != 0 || gy <= 0 || K <= 0 || gy > 65535 || K > 65535 ||
        (ffx == nullptr) != (ffy == nullptr))
        return (int)cudaErrorInvalidValue;
    dim3 grid(gx / TF_BLOCK, K, gy);
    auto kernel = ffx != nullptr ? forces_kernel<true> : forces_kernel<false>;
    kernel<<<grid, TF_BLOCK, 0, stream>>>(
        px, py, vx, vy, pres, invr, occ_row, sc, frame, ffx, ffy, npx, npy,
        nvx, nvy, gy, K, gx, h, sqr_radius, c_spiky, visc_norm, c_r3, c_r2,
        c_inv, half_x, half_y, ff_sx, ff_sy);
    return (int)cudaGetLastError();
}
