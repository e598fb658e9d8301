// The resident engine's pair math, shared by density.cu, forces.cu and
// physics.cu: the per-target density sum over the 3x3 cell stencil, the
// per-target force loop fused with the integration, the candidate sources
// they read, and the tile helpers of the resident kernels (density.cu,
// forces.cu, physics.cu, rebin.cu, rebin_valid.cu).
//
// Each pair function takes a candidate source: an object whose pred()
// (density) or cand() (forces) returns a candidate slot's predicted
// position (and velocity, pressure, 1/rho). The kernels stage the
// candidates of a tile in shared memory, each slot predicted once, and
// read them through TfSharedPred (density), TfTileCand (forces.cu) or
// TfHaloCand (physics.cu).
// A candidate block (row r, column dx) is walked below its own bound
// occ_c[(r + 1) * 3 + dx + 1]: the cell's occupancy (last live slot + 1),
// 0 for a block outside the grid. Slots beyond a bound are empty and
// contribute nothing, and an empty slot below it is staged as SENTINEL
// (and zeros) and adds +-0, so the bound changes no bit of a sum. The
// arithmetic is the same code in all three kernels, and every f32
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

// Candidate predictions from a shared tile of float2 (x, y) per slot,
// laid out [row][slot][column] with pitch pw, grid row and column of
// [0][.][0] at (oy, ox). An empty slot holds SENTINEL, which puts it
// beyond every radius: it adds exactly 0 to every sum, so the walk needs
// no liveness test (the tile kernels' walks reach only staged slots).
struct TfSharedPred {
    const float2* sp;
    int oy, ox;
    int K, pw;

    __device__ __forceinline__ void pred(int sy, int kp, int sx, float& nx,
                                         float& ny) const {
        const float2 q = sp[((sy - oy) * K + kp) * pw + (sx - ox)];
        nx = q.x;
        ny = q.y;
    }
};

// forces.cu's candidate fields from one +-1 tile, laid out as
// TfSharedPred: the prediction sp and (velocity, pressure, 1/rho) sq per
// slot. An empty slot holds a SENTINEL prediction and zeros in sq and is
// visited like a particle: every term it yields is +-0 and leaves each
// sum's bits unchanged (no sum is ever -0), as skipping it would.
struct TfTileCand {
    const float2* sp;
    const float4* sq;
    int oy, ox;
    int K, pw;

    __device__ __forceinline__ void cand(int sy, int kp, int sx, float& nx,
                                         float& ny, float& nvx, float& nvy,
                                         float& p, float& ir) const {
        const int i = ((sy - oy) * K + kp) * pw + (sx - ox);
        const float2 q = sp[i];
        const float4 u = sq[i];
        nx = q.x;
        ny = q.y;
        nvx = u.x;
        nvy = u.y;
        p = u.z;
        ir = u.w;
    }
};

// physics.cu's candidate fields: the predictions sp of its +-2 halo
// (pitch pw, [0][.][0] at grid (oy, ox)) and (velocity, pressure, 1/rho)
// sq of its +-1 halo (pitch qw, [0][.][0] one row and column inside
// sp's), empty slots staged as in TfTileCand.
struct TfHaloCand {
    const float2* sp;
    const float4* sq;
    int oy, ox;
    int K, pw, qw;

    __device__ __forceinline__ void cand(int sy, int kp, int sx, float& nx,
                                         float& ny, float& nvx, float& nvy,
                                         float& p, float& ir) const {
        const int lr = sy - oy;
        const int lc = sx - ox;
        const float2 q = sp[(lr * K + kp) * pw + lc];
        const float4 u = sq[((lr - 1) * K + kp) * qw + lc - 1];
        nx = q.x;
        ny = q.y;
        nvx = u.x;
        nvy = u.y;
        p = u.z;
        ir = u.w;
    }
};

// Poly6 sum of target (y, x) at predicted (tx, ty): candidate slot kp
// below occ_max, and for each the nine (row, dx) blocks (each below its
// bound occ_c) summed into a partial that is then added to the total (the
// TPU kernel's order).
template <class Src>
__device__ __forceinline__ float tf_density_sum(const Src& src, int y, int x,
                                                const int occ_c[9],
                                                int occ_max, float tx,
                                                float ty, float h2) {
    float acc = 0.0f;
    for (int kp = 0; kp < occ_max; ++kp) {
        float part = 0.0f;
        for (int r = -1; r <= 1; ++r) {
            const int sy = y + r;
            for (int dx = -1; dx <= 1; ++dx) {
                if (kp >= occ_c[(r + 1) * 3 + dx + 1]) continue;
                const int sx = x + dx;
                float nx, ny;
                src.pred(sy, kp, sx, nx, ny);
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

// Forces on one live target slot (y, k, x) over the 3x3 stencil (slot
// kp outer, below occ_max; each (row, dx) block below its bound occ_c),
// then
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
        int y, int x, const int occ_c[9], int occ_max, float pos_x0,
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
    for (int kp = 0; kp < occ_max; ++kp) {
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
            const int sy = y + r;
            for (int dx = -1; dx <= 1; ++dx) {
                if (kp >= occ_c[(r + 1) * 3 + dx + 1]) continue;
                const int sx = x + dx;
                float nx, ny, nvx_c, nvy_c, p_nb, inv_rho;
                src.cand(sy, kp, sx, nx, ny, nvx_c, nvy_c, p_nb, inv_rho);
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

// ------------------------------------------------------------ tiles
// The tile kernels run one block of TF_TILE_THREADS threads (physics.cu:
// TF_PHYSICS_THREADS; the helpers take the count as a template parameter
// NT) per tile of R x C cells (R and C powers of two, C dividing the grid width, picked from K
// by tf_pick_tile) with all K slots, and stage the tile's halo, `halo`
// cells a side: (R + 2 halo) x (C + 2 halo) cells in shared memory
// (tf_stage_halo). density.cu, forces.cu, rebin.cu and rebin_valid.cu
// stage a halo of 1, physics.cu one of 2 (it computes the density of the
// +-1 ring that its forces read). Per slot slot_bytes (density: a float2;
// forces: a float4 and a float2; rebin, rebin_valid: a packed cell;
// physics: a float2, beside a float4 per slot of its +-1 ring),
// [row][slot][column], pitch C + 2 halo; then socc, the occupancy (last
// live slot + 1) of each halo cell, then a list of K entries per cell
// whose 3 x 3 stencil lies in the halo, (R + 2 halo - 2) x
// (C + 2 halo - 2) cells (density and forces: the tile's live targets;
// physics: the ring's live slots, then the centre's; rebin: each target
// cell's arrivals), then two per-warp count rows, then the halo rows'
// occupancies and world dt.
#define TF_TILE_THREADS 256
#define TF_PHYSICS_THREADS 512
#define TF_TILE_WARPS (TF_TILE_THREADS / 32)
// halo slots each thread loads before it stores any (memory parallelism)
#define TF_STAGE_BATCH 4
// shared memory a block may use on the H100 (232,448 bytes)
#define TF_SMEM_MAX 232448

__host__ __device__ __forceinline__ long long tf_tile_smem_bytes(
        int slot_bytes, int K, int R, int C, int halo = 1,
        int nt = TF_TILE_THREADS) {
    const long long cells = (long long)(R + 2 * halo) * (C + 2 * halo);
    const long long listed =
        (long long)(R + 2 * halo - 2) * (C + 2 * halo - 2);
    return (long long)slot_bytes * K * cells + 4LL * cells +
           4LL * listed * K + 8LL * (nt / 32) + 8LL * (R + 2 * halo);
}

// The tiles as (log2 rows, log2 columns), by cells and then by halo
// share (the columns divide the 128-aligned grid width), and each
// kernel's cap on a tile's target slots (rows x columns x K). The caps
// come from a sweep of every tile at K=8, 32 and 192 on the H100
// (PERF.md): the fastest tile had 1,536-2,048 slots for density and
// 1,024-1,536 for forces; past that the few blocks over a dense region
// run long, below it the halo is re-read too often. rebin's,
// rebin_valid's and physics' caps are their own sweeps' (PERF.md).
static const int kTfTiles[][2] = {{3, 5}, {2, 5}, {1, 5}, {1, 4}, {0, 5},
                                  {0, 4}, {0, 3}, {0, 2}, {0, 1}, {0, 0}};
#define TF_DENSITY_SLOTS 2048
#define TF_FORCES_SLOTS 1536
#define TF_REBIN_SLOTS 4096
#define TF_REBIN_VALID_SLOTS 2048
#define TF_PHYSICS_SLOTS 4096

// The tile of a kernel whose block needs smem_bytes(R, C) of shared
// memory at capacity K: the first of kTfTiles within max_slots target
// slots whose shared memory fits, else the smallest that fits. False when
// none fits.
template <class SmemBytes>
static inline bool tf_pick_tile(int max_slots, int K, int& lgR, int& lgC,
                                SmemBytes smem_bytes) {
    bool fits = false;
    for (const auto& t : kTfTiles) {
        const int R = 1 << t[0], C = 1 << t[1];
        if (smem_bytes(R, C) > TF_SMEM_MAX) continue;
        lgR = t[0];
        lgC = t[1];
        fits = true;
        if ((long long)R * C * K <= max_slots) break;
    }
    return fits;
}

// The tile of a resident kernel that stages slot_bytes per slot at
// capacity K (tf_tile_smem_bytes). False when none fits (K above ~1,000
// for forces).
static inline bool tf_resident_tile(int slot_bytes, int max_slots, int K,
                                    int& lgR, int& lgC) {
    return tf_pick_tile(max_slots, K, lgR, lgC, [&](int R, int C) {
        return tf_tile_smem_bytes(slot_bytes, K, R, C);
    });
}

// The shared arrays behind a tile's staged fields.
struct TfTileSmem {
    int* socc;   // [(R + 2 halo) (C + 2 halo)] halo cells' occupancies
    int* list;   // [(R + 2 halo - 2) (C + 2 halo - 2) K] listed slots
    int* wsum;   // [2][NT / 32] per-warp counts
    int* srow;   // [R + 2 halo] halo rows' occupancies (0 outside the grid)
    float* sdt;  // [R + 2 halo] halo rows' world dt
    int halo;    // halo cells a side
};

__device__ __forceinline__ TfTileSmem tf_tile_smem(void* fields_end, int K,
                                                   int R, int C, int halo = 1,
                                                   int nt = TF_TILE_THREADS) {
    TfTileSmem t;
    t.socc = reinterpret_cast<int*>(fields_end);
    t.list = t.socc + (R + 2 * halo) * (C + 2 * halo);
    t.wsum = t.list + (R + 2 * halo - 2) * (C + 2 * halo - 2) * K;
    t.srow = t.wsum + 2 * (nt / 32);
    t.sdt = reinterpret_cast<float*>(t.srow + R + 2 * halo);
    t.halo = halo;
    return t;
}

// Zero the halo cells' occupancies and read the halo rows' occupancy
// (capped at K; K in every row inside the grid without occ_row) and world
// dt (column dt_col of the per-world table sc, n_col columns). Ends with
// __syncthreads().
template <int NT = TF_TILE_THREADS>
__device__ __forceinline__ void tf_tile_begin(const TfTileSmem& t,
                                              const int* occ_row,
                                              const int* wid, const float* sc,
                                              int n_col, int dt_col, int R,
                                              int C, int K, int y0, int gy) {
    const int HR = R + 2 * t.halo, HC = C + 2 * t.halo;
    for (int i = threadIdx.x; i < HR * HC; i += NT) t.socc[i] = 0;
    for (int lr = threadIdx.x; lr < HR; lr += NT) {
        const int sy = y0 + lr - t.halo;
        const bool in = sy >= 0 && sy < gy;
        t.srow[lr] = in ? (occ_row != nullptr ? min(occ_row[sy], K) : K) : 0;
        t.sdt[lr] = in ? sc[tf_world(wid, sy) * n_col + dt_col] : 0.0f;
    }
    __syncthreads();
}

// The largest of n row occupancies from srow.
__device__ __forceinline__ int tf_max_rows(const int* srow, int n) {
    int m = 0;
    for (int i = 0; i < n; ++i) m = max(m, srow[i]);
    return m;
}

// Halo slot i of the flat (row, slot below kh, column) walk of the
// staging, at grid column sx; false when i is past the walk, the slot at
// or beyond its row's occupancy or the column outside the grid.
__device__ __forceinline__ bool tf_halo_slot(int i, int n, int kh, int HC,
                                             const int* srow, int x0, int gx,
                                             int halo, int& lr, int& kk,
                                             int& lc, int& sx) {
    if (i >= n) return false;
    const int t = i / HC;
    lc = i - t * HC;
    lr = t / kh;
    kk = t - lr * kh;
    sx = x0 + lc - halo;
    return kk < srow[lr] && sx >= 0 && sx < gx;
}

// Stage the tile's halo: the flat (row, slot below the halo rows' largest
// occupancy, column) walk of tf_halo_slot, TF_STAGE_BATCH slots' loads in
// flight per thread. load(u, gi) reads grid slot gi into batch entry u;
// store(u, lr, kk, lc) stages entry u at halo row lr, slot kk, column lc.
// Slots at or beyond their row's occupancy and columns outside the grid
// are not visited. Ends with __syncthreads().
template <int NT = TF_TILE_THREADS, class Load, class Store>
__device__ __forceinline__ void tf_stage_halo(const TfTileSmem& t, int R,
                                              int C, int K, int y0, int x0,
                                              int gx, Load load,
                                              Store store) {
    const int HR = R + 2 * t.halo, HC = C + 2 * t.halo;
    const int kh = tf_max_rows(t.srow, HR);
    const int n = HR * kh * HC;
    for (int i0 = threadIdx.x; i0 < n;
         i0 += TF_STAGE_BATCH * NT) {
        int lr[TF_STAGE_BATCH], kk[TF_STAGE_BATCH], lc[TF_STAGE_BATCH];
        bool ok[TF_STAGE_BATCH];
#pragma unroll
        for (int u = 0; u < TF_STAGE_BATCH; ++u) {
            int sx;
            ok[u] = tf_halo_slot(i0 + u * NT, n, kh, HC, t.srow, x0, gx,
                                 t.halo, lr[u], kk[u], lc[u], sx);
            if (ok[u])
                load(u, tf_index(y0 + lr[u] - t.halo, kk[u], sx, K, gx));
        }
#pragma unroll
        for (int u = 0; u < TF_STAGE_BATCH; ++u)
            if (ok[u]) store(u, lr[u], kk[u], lc[u]);
    }
    __syncthreads();
}

// The indices i < n for which pick(i, e) holds, each listed as the entry
// e that pick sets, in order of i (block-wide compaction: a whole-warp
// ballot and per-warp counts). pick() runs once for every i < n (it may
// also write the outputs of an index it rejects); wsum holds two rows of
// NT / 32 counts. Returns the count, the same in every thread; the list is
// complete when it returns.
template <int NT = TF_TILE_THREADS, class Pick>
__device__ __forceinline__ int tf_tile_compact(int* list, int* wsum, int n,
                                               Pick pick) {
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    int base = 0;
    int buf = 0;
    constexpr int W = NT / 32;
    for (int i0 = 0; i0 < n; i0 += NT, buf ^= 1) {
        const int i = i0 + threadIdx.x;
        int e = 0;
        const bool ok = i < n && pick(i, e);
        const unsigned b = __ballot_sync(0xffffffffu, ok);
        // two count rows: a warp may fill this chunk's row while a slower
        // one still reads the previous chunk's
        if (lane == 0) wsum[buf * W + w] = __popc(b);
        __syncthreads();
        int off = base, tot = 0;
        for (int j = 0; j < W; ++j) {
            const int c = wsum[buf * W + j];
            off += j < w ? c : 0;
            tot += c;
        }
        if (ok) list[off + __popc(b & ((1u << lane) - 1u))] = e;
        base += tot;
    }
    __syncthreads();
    return base;
}

// The slots (kk, lr, lc) of the tile's centre cells below slot kc for
// which live(lr, kk, lc) holds, listed in (slot, row, column) order as
// kk << 16 | lr << 8 | lc into list, so that the lanes of a warp take
// neighbouring columns of one slot row: their global loads and stores are
// coalesced and their shared reads hit distinct banks. live() runs once
// for every slot below kc (it may also write the outputs of a slot it
// rejects). Returns the count (tf_tile_compact).
template <int NT = TF_TILE_THREADS, class Live>
__device__ __forceinline__ int tf_tile_list(int* list, int* wsum, int kc,
                                            int lgR, int lgC, Live live) {
    const int R = 1 << lgR, C = 1 << lgC;
    return tf_tile_compact<NT>(list, wsum, (kc * R) << lgC,
                               [&](int i, int& e) {
        const int lc = i & (C - 1);
        const int lr = (i >> lgC) & (R - 1);
        const int kk = i >> (lgC + lgR);
        e = (kk << 16) | (lr << 8) | lc;
        return live(lr, kk, lc);
    });
}

// The live targets of the tile's centre cells, listed by tf_tile_list.
// The walk covers the slots below kc, the centre rows' largest occupancy;
// a centre slot there is live below its cell's socc with a live staged
// prediction (sp: the staged predictions, pitch C + 2 halo). Every other
// centre slot in the grid gets empty(y, kk, x).
template <int NT = TF_TILE_THREADS, class Empty>
__device__ __forceinline__ int tf_tile_targets(const float2* sp,
                                               const TfTileSmem& t, int kc,
                                               int lgR, int lgC, int K,
                                               int y0, int x0, int gy,
                                               Empty empty) {
    const int R = 1 << lgR, C = 1 << lgC;
    const int h = t.halo, HC = C + 2 * h;
    // slots at or beyond kc: empty in every centre cell
    const int n_all = (K * R) << lgC;
    for (int i = ((kc * R) << lgC) + threadIdx.x; i < n_all;
         i += NT) {
        const int lr = (i >> lgC) & (R - 1);
        if (y0 + lr < gy) empty(y0 + lr, i >> (lgC + lgR), x0 + (i & (C - 1)));
    }
    return tf_tile_list<NT>(t.list, t.wsum, kc, lgR, lgC,
                            [&](int lr, int kk, int lc) {
        if (y0 + lr >= gy) return false;
        const bool live = kk < t.socc[(lr + h) * HC + lc + h] &&
                          tf_live(sp[((lr + h) * K + kk) * HC + lc + h].x);
        if (!live) empty(y0 + lr, kk, x0 + lc);
        return live;
    });
}

// Candidate bounds of a target from the halo cells' occupancies (0 for a
// cell outside the grid), its stencil's top-left halo cell at (lr, lc)
// (a centre cell's (lr, lc) with a halo of 1). Returns their max.
__device__ __forceinline__ int tf_occ_tile(const int* socc, int lr, int lc,
                                           int HC, int occ_c[9]) {
    int m = 0;
    for (int r = 0; r < 3; ++r)
        for (int dx = 0; dx < 3; ++dx) {
            const int o = socc[(lr + r) * HC + lc + dx];
            occ_c[r * 3 + dx] = o;
            m = max(m, o);
        }
    return m;
}
