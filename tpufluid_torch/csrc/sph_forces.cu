// Slot-grid forces: the symmetrised spiky pressure force f and the
// viscosity force g (times mu) over the 3x3 cell stencil
// (compute.wgsl:160-299), on the slot grid that
// ops.dense.build_grid_cols rebuilds every step, with the variants
// surface_tension (the colour-field force folded into f,
// compute.wgsl:303-498) and adaptive (pressure candidates strided by
// 1/5/13 as the target's density crosses 150/200,
// shaders/compute.wgsl:170-174,195). Two kernels, one tile body with the
// template parameter ROLL:
//
// sph_forces_kernel (the pallas engine, ops/sph.py) replaces
// tpufluid/ops/pallas/sph.py:forces (_forces_kernel), which on the TPU ran
// one program per grid row over rows y-1, y, y+1 (clamped block index
// maps) with lane rolls by dx, all slots of a row as one vector. Its pair
// terms are the TPU kernel's: 1/dst and 1/rho multiplied in, a
// division-free viscosity kernel.
//
// dense_forces_kernel (the dense engine, ops/dense.py:forces) replaces no
// Pallas kernel: it is XLA's roll formulation of
// tpufluid/ops/dense.py:force_pass, some 60 elementwise operations per
// candidate slot over the whole grid. It computes exactly what
// ops/dense.py:force_pass does: rows wrap modulo Gy (torch.roll), and each
// pair term takes the forms of ops/kernels.py: ddx / dst,
// kern_p * shared_p / rho, the viscosity kernel with its three divisions
// then / rho, poly6_gradient over the recomputed length and mass / rho.
// The sum order, the tie-break draws and the rest of the design are
// shared.
//
// Bound on the H100: the pair loop's instructions (36 f32 operations, a
// sqrt and a division per pair in range, no FMA), then the four output
// fields, written whole (at K=32 137 MB of the 165 MB the kernel must
// move). One thread per output slot, the design this replaces, spent most
// of its threads on empty slots, reloaded six candidate fields from L1/L2
// for every pair, recomputed each candidate's pressure and 1/rho (an IEEE
// division) for every pair, and drew four tie-break directions (8
// xorshifts, 4 sqrts, 8 divisions) per target up front. The roll form
// has three IEEE divisions a pair in range in place of one (five with
// surface tension); the roll it replaces ran ~60 torch kernels per
// candidate slot over the whole grid (~18,000 a step at 100k, K 16: 94.5
// device ms a dense step, PERF.md), each reading and writing whole grids.
//
// Design: one block of 256 threads per tile of R x C cells with all K
// slots (tf_sph_tile picks the tile from K so that it fits shared memory;
// sph_tile.cuh has the layout and the rows and columns each form visits).
//   O: each halo cell's occupancy, the length of its valid prefix;
//   S: the halo's slots below each cell's occupancy go to shared memory:
//      the position (a float2) and (velocity, pressure k (rho - rho0),
//      1/rho) as a float4 (ROLL: rho, 1 where it is 0, in place of
//      1/rho), the last two computed once per candidate with the f32
//      operations the pair loop did, so their bits are unchanged;
//   L: the tile's live slots are listed in (slot, row, column) order;
//   F: the threads take the listed targets, each walking its 3 x 3 cells
//      below each cell's own occupancy in the TPU kernel's order (row -1,
//      0, +1; then dx -1, 0, +1; then kp ascending), every term added on
//      its own as the plain version adds it (a candidate beyond h adds
//      exactly +0: no sum is ever -0), so the sums are bitwise the plain
//      version's. A coincident pair draws its tie-break direction when it
//      is met: pair-order salt x draw ordinal clamped at 1
//      (ops/pairs.py), the same draw as the table of four;
//   W: every empty slot gets the epilogue of zero sums (gxs * mu of a
//      zero sum, not a literal 0).
// The variants are template parameters, so the base kernel carries none
// of their code or registers.
#include "sph_tile.cuh"

// 24 B a staged slot: a float2 position, a float4 (vx, vy, p, 1/rho; ROLL:
// the division-safe rho)
#define SPH_FORCES_SLOT_BYTES 24

// The f32 constants of the two forms, each rounded once on the host
// (ops/sph.py:_forces_consts, ops/dense.py:forces); the forms
// differ in h2 (the TPU kernel's is h * h rounded once from the double h,
// the roll's the f32 square of f32 h) and the viscosity's constants.
struct SphForcesConsts {
    float h, h2, sqr_radius, spiky_norm, visc_norm;
    float c_r3, c_r2, c_half_h;  // TPU form: -1/(2 h^3), 1/h^2, h/2
    float c_2h3;                 // roll form: the divisor 2 h^3
    float st_grad_norm, st_lap_norm, c_3h2;
};

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

// The outputs of a target from its sums: the surface-tension composition
// (pairs.surface_tension, compute.wgsl:303-315) and the viscosity times
// mu. sc = [pressure_constant, rest_density, mu, mass, st_threshold,
// st_coefficient].
template <bool ST>
__device__ __forceinline__ void sph_forces_out(
        float fx, float fy, float gxs, float gys, float cgx, float cgy,
        float clap, const float* __restrict__ sc, float* __restrict__ fx_o,
        float* __restrict__ fy_o, float* __restrict__ gx_o,
        float* __restrict__ gy_o, size_t ti) {
    if (ST) {
        const float n_len = sqrtf(cgx * cgx + cgy * cgy);
        const float safe_len = n_len == 0.0f ? 1.0f : n_len;
        const float k_st = (-clap) / (n_len + 1e-6f);
        if (n_len > sc[4]) {
            const float coef = sc[5];
            fx = fx + -coef * k_st * (cgx / safe_len);
            fy = fy + -coef * k_st * (cgy / safe_len);
        }
    }
    const float mu = sc[2];
    fx_o[ti] = fx;
    fy_o[ti] = fy;
    gx_o[ti] = gxs * mu;
    gy_o[ti] = gys * mu;
}

// The kernel arguments of both forms.
#define SPH_FORCES_PARAMS                                                \
    const float* __restrict__ px, const float* __restrict__ py,          \
    const float* __restrict__ vx, const float* __restrict__ vy,          \
    const uint8_t* __restrict__ valid, const float* __restrict__ dens,   \
    const float* __restrict__ sc, const long long* __restrict__ frame_p, \
    float* __restrict__ fx_o, float* __restrict__ fy_o,                  \
    float* __restrict__ gx_o, float* __restrict__ gy_o, int gy, int K,   \
    int gx, int lgR, int lgC, SphForcesConsts cs
#define SPH_FORCES_ARGS                                                \
    px, py, vx, vy, valid, dens, sc, frame_p, fx_o, fy_o, gx_o, gy_o, gy, \
    K, gx, lgR, lgC, cs

// The tile of either kernel (ROLL: the dense engine's).
template <bool ROLL, bool ST, bool ADAPTIVE>
__device__ __forceinline__ void forces_tile_body(SPH_FORCES_PARAMS) {
    extern __shared__ float4 smem4[];
    const float h = cs.h, h2 = cs.h2, sqr_radius = cs.sqr_radius;
    const float spiky_norm = cs.spiky_norm, visc_norm = cs.visc_norm;
    const float st_grad_norm = cs.st_grad_norm, st_lap_norm = cs.st_lap_norm;
    const float c_3h2 = cs.c_3h2;
    const int R = 1 << lgR, C = 1 << lgC;
    const int HR = R + 2, HC = C + 2;
    const int n_h = HR * K * HC;
    float4* sq = smem4;
    float2* sp = reinterpret_cast<float2*>(sq + n_h);
    const TfSphSmem t = tf_sph_smem(sp + n_h, K, R, C, false);
    const int y0 = blockIdx.y * R;
    const int x0 = blockIdx.x * C;
    const float k_pressure = sc[0];
    const float rest_density = sc[1];

    // O: occupancies
    tf_sph_occupancy<ROLL>(t, valid, R, C, K, y0, x0, gy, gx);

    // S: positions, velocities, pressure and 1/rho (ROLL: rho) of the halo
    float ax[TF_STAGE_BATCH], ay[TF_STAGE_BATCH];
    float ux[TF_STAGE_BATCH], uy[TF_STAGE_BATCH], ud[TF_STAGE_BATCH];
    tf_sph_stage<ROLL>(
        t, R, C, K, y0, x0, gy, gx,
        [&](int u, size_t gi) {
            ax[u] = px[gi];
            ay[u] = py[gi];
            ux[u] = vx[gi];
            uy[u] = vy[gi];
            ud[u] = dens[gi];
        },
        [&](int u, int lr, int kk, int lc) {
            const int s = (lr * K + kk) * HC + lc;
            const float ndk = ud[u];
            const float safe_rho = ndk == 0.0f ? 1.0f : ndk;
            sp[s] = make_float2(ax[u], ay[u]);
            sq[s] = make_float4(ux[u], uy[u],
                                k_pressure * (ndk - rest_density),
                                ROLL ? safe_rho : 1.0f / safe_rho);
        });

    // L: the live slots
    const int n = tf_tile_list(t.list, t.wsum, t.kmax[1], lgR, lgC,
                               [&](int lr, int kk, int lc) {
        return y0 + lr < gy && kk < t.socc[(lr + 1) * HC + lc + 1];
    });

    // F: the sums of each live target
    const uint32_t frame = (uint32_t)frame_p[0];
    const float mass = sc[3];
    for (int j = threadIdx.x; j < n; j += TF_TILE_THREADS) {
        int k, lr, lc;
        tf_sph_entry(t.list[j], k, lr, lc);
        const int s0 = ((lr + 1) * K + k) * HC + lc + 1;
        const float2 p0 = sp[s0];
        const float4 u0 = sq[s0];
        const float px0 = p0.x, py0 = p0.y;
        const float vx0 = u0.x, vy0 = u0.y;
        const float p_self = u0.z;  // k (rho - rho0) of the target's slot
        const size_t ti = tf_index(y0 + lr, k, x0 + lc, K, gx);

        // the base of the tie-break seeds: the position's bits and frame
        const uint32_t seed = ((__float_as_uint(px0) * 0x9E3779B1u) ^
                               (__float_as_uint(py0) * 0x85EBCA6Bu)) +
                              frame * 69u;
        float st_dx = 0.0f, st_dy = 0.0f;
        if (ST) {  // one draw per target, compute.wgsl:406
            const uint32_t st_i = (uint32_t)(int)fmaxf(px0, 0.0f);
            unit_draw(st_i * 324u + frame * 5632u, &st_dx, &st_dy);
        }
        int stride = 1;
        if (ADAPTIVE) {
            const float d0 = dens[ti];
            stride = d0 >= 200.0f ? 13 : d0 >= 150.0f ? 5 : 1;
        }

        float fx = 0.0f, fy = 0.0f, gxs = 0.0f, gys = 0.0f;
        float cgx = 0.0f, cgy = 0.0f, clap = 0.0f;
        uint32_t coinc = 0;  // coincident draws so far
        for (int r = 0; r < 3; ++r) {
            for (int dx = 0; dx < 3; ++dx) {
                const bool center = r == 1 && dx == 1;
                const bool before = r == 0 || (r == 1 && dx == 0);
                const int c = (lr + r) * HC + lc + dx;
                const int o = t.socc[c];
                const int base = (lr + r) * K * HC + lc + dx;
                for (int kp = 0; kp < o; ++kp) {
                    const int ci = base + kp * HC;
                    const float2 q = sp[ci];
                    const float ddx = q.x - px0;
                    const float ddy = q.y - py0;
                    const float r2 = ddx * ddx + ddy * ddy;
                    if (ROLL ? !(r2 <= sqr_radius) : r2 > sqr_radius)
                        continue;
                    const float4 u = sq[ci];
                    const float dst = sqrtf(r2);
                    const bool in_range = !(center && kp == k);
                    const float safe = dst == 0.0f ? 1.0f : dst;
                    const float inv_dst = ROLL ? 0.0f : 1.0f / safe;
                    float dirx = ROLL ? ddx / safe : ddx * inv_dst;
                    float diry = ROLL ? ddy / safe : ddy * inv_dst;
                    if (in_range && dst == 0.0f) {
                        const bool salted = center ? kp < k : before;
                        unit_draw(seed + (coinc >= 1u ? 2654435761u : 0u) +
                                      (salted ? 0x27220A95u : 0u),
                                  &dirx, &diry);
                        ++coinc;
                    }
                    const float shared_p = (p_self + u.z) * 0.5f;
                    const float kern_p =
                        dst <= h ? -(h - dst) * spiky_norm : 0.0f;
                    const bool in_range_p =
                        in_range && (!ADAPTIVE || kp % stride == 0);
                    if (ROLL) {
                        // force_pass: each term added where it is masked
                        // in, as torch.where adds +0 elsewhere
                        const float safe_rho = u.w;
                        if (in_range_p) {
                            const float scale_p =
                                kern_p * shared_p / safe_rho;
                            fx = fx + dirx * scale_p;
                            fy = fy + diry * scale_p;
                        }
                        if (in_range) {  // ops.kernels.viscosity / rho
                            const float sr2 = safe * safe;
                            float kv = visc_norm *
                                       (-(sr2 * safe) / cs.c_2h3 + sr2 / h2 +
                                        h / (2.0f * safe) - 1.0f);
                            if (dst == 0.0f) kv = visc_norm;
                            if (!(dst <= h)) kv = 0.0f;
                            const float scale_v = kv / safe_rho;
                            gxs = gxs + (u.x - vx0) * scale_v;
                            gys = gys + (u.y - vy0) * scale_v;
                        }
                    } else {
                        const float inv_rho = u.w;
                        const float wp =
                            in_range_p ? kern_p * shared_p * inv_rho : 0.0f;
                        fx = fx + dirx * wp;
                        fy = fy + diry * wp;

                        // viscosity kernel, division-free (sph.py:303-307)
                        float kv = visc_norm * (r2 * safe * cs.c_r3 +
                                                r2 * cs.c_r2 +
                                                inv_dst * cs.c_half_h - 1.0f);
                        if (dst == 0.0f) kv = visc_norm;
                        if (!(dst <= h)) kv = 0.0f;
                        const float wv = in_range ? kv * inv_rho : 0.0f;
                        gxs = gxs + (u.x - vx0) * wv;
                        gys = gys + (u.y - vy0) * wv;
                    }

                    if (ST) {  // self pair included
                        const bool co_st = dst == 0.0f;
                        const float sdx = co_st ? st_dx : dirx;
                        const float sdy = co_st ? st_dy : diry;
                        if (ROLL) {
                            // ops.kernels.poly6_gradient, poly6_laplacian
                            const float rlen = sqrtf(sdx * sdx + sdy * sdy);
                            const float gdiff = h2 - rlen * rlen;
                            const float gsc = st_grad_norm * gdiff * gdiff;
                            const bool bad = rlen >= h || rlen == 0.0f;
                            const float gxc = bad ? 0.0f : gsc * sdx;
                            const float gyc = bad ? 0.0f : gsc * sdy;
                            const float m_rho = mass / u.w;
                            cgx = cgx + m_rho * gxc;
                            cgy = cgy + m_rho * gyc;
                            const float d2 = dst * dst;
                            const float lap =
                                dst > h ? 0.0f
                                        : st_lap_norm * (h2 - d2) *
                                              (c_3h2 - 4.0f * d2);
                            clap = clap + m_rho * lap;
                        } else {
                            const float rlen2 = sdx * sdx + sdy * sdy;
                            const float rlen = sqrtf(rlen2);
                            const float gdiff = h2 - rlen2;
                            const float gsc =
                                (rlen >= h || rlen == 0.0f)
                                    ? 0.0f
                                    : st_grad_norm * gdiff * gdiff;
                            const float m_rho = mass * u.w;
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
        sph_forces_out<ST>(fx, fy, gxs, gys, cgx, cgy, clap, sc, fx_o, fy_o,
                           gx_o, gy_o, ti);
    }

    // W: the empty slots
    for (int i = threadIdx.x; i < (K * R) << lgC; i += TF_TILE_THREADS) {
        const int lc = i & (C - 1);
        const int lr = (i >> lgC) & (R - 1);
        const int kk = i >> (lgC + lgR);
        if (y0 + lr >= gy || kk < t.socc[(lr + 1) * HC + lc + 1]) continue;
        sph_forces_out<ST>(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, sc,
                           fx_o, fy_o, gx_o, gy_o,
                           tf_index(y0 + lr, kk, x0 + lc, K, gx));
    }
}

template <bool ST, bool ADAPTIVE>
__global__ void __launch_bounds__(TF_TILE_THREADS, 4)
sph_forces_kernel(SPH_FORCES_PARAMS) {
    forces_tile_body<false, ST, ADAPTIVE>(SPH_FORCES_ARGS);
}

template <bool ST, bool ADAPTIVE>
__global__ void __launch_bounds__(TF_TILE_THREADS, 4)
dense_forces_kernel(SPH_FORCES_PARAMS) {
    forces_tile_body<true, ST, ADAPTIVE>(SPH_FORCES_ARGS);
}

typedef void (*SphForcesKernel)(SPH_FORCES_PARAMS);

// [surface_tension * 2 + adaptive]
static const SphForcesKernel kSphForces[4] = {
    sph_forces_kernel<false, false>, sph_forces_kernel<false, true>,
    sph_forces_kernel<true, false>, sph_forces_kernel<true, true>};
static const SphForcesKernel kDenseForces[4] = {
    dense_forces_kernel<false, false>, dense_forces_kernel<false, true>,
    dense_forces_kernel<true, false>, dense_forces_kernel<true, true>};
// dynamic shared memory limit set so far, per kernel
static int kSphForcesSmem[4], kDenseForcesSmem[4];

static bool sph_forces_tile(int K, int& lgR, int& lgC) {
    return tf_sph_tile(SPH_FORCES_SLOT_BYTES, 0, TF_FORCES_SLOTS, K, lgR,
                       lgC);
}

// The tile both kernels run at capacity K as rows << 8 | columns; 0 when
// none fits shared memory.
extern "C" int tf_sph_forces_tile(int K) {
    int lgR, lgC;
    if (!sph_forces_tile(K, lgR, lgC)) return 0;
    return (1 << lgR) << 8 | (1 << lgC);
}

// The largest K tf_sph_forces and tf_dense_forces take.
extern "C" int tf_sph_forces_max_k(void) {
    return tf_sph_max_k(SPH_FORCES_SLOT_BYTES, 0);
}

// Launch variant v of ``kernels``; smem_set: the dynamic shared memory
// limits set so far.
static int launch_forces(const SphForcesKernel* kernels, int* smem_set,
                         int v, const float* px, const float* py,
                         const float* vx, const float* vy,
                         const uint8_t* valid, const float* dens,
                         const float* sc, const long long* frame, float* fx,
                         float* fy, float* gxo, float* gyo, int gy, int K,
                         int gx, const SphForcesConsts& cs,
                         cudaStream_t stream) {
    int lgR = 0, lgC = 0;
    if (gy <= 0 || gx <= 0 || !sph_forces_tile(K, lgR, lgC) ||
        gx % (1 << lgC) != 0 || (gy + (1 << lgR) - 1) >> lgR > 65535)
        return (int)cudaErrorInvalidValue;
    const long long smem = tf_sph_smem_bytes(SPH_FORCES_SLOT_BYTES, 0, K,
                                             1 << lgR, 1 << lgC);
    if (smem > smem_set[v] && smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernels[v], cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        smem_set[v] = (int)smem;
    }
    dim3 grid(gx >> lgC, (gy + (1 << lgR) - 1) >> lgR);
    kernels[v]<<<grid, TF_TILE_THREADS, (size_t)smem, stream>>>(
        px, py, vx, vy, valid, dens, sc, frame, fx, fy, gxo, gyo, gy, K, gx,
        lgR, lgC, cs);
    return (int)cudaGetLastError();
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
    SphForcesConsts cs = {};
    cs.h = h, cs.h2 = h2, cs.sqr_radius = sqr_radius;
    cs.spiky_norm = spiky_norm, cs.visc_norm = visc_norm;
    cs.c_r3 = c_r3, cs.c_r2 = c_r2, cs.c_half_h = c_half_h;
    cs.st_grad_norm = st_grad_norm, cs.st_lap_norm = st_lap_norm;
    cs.c_3h2 = c_3h2;
    return launch_forces(kSphForces, kSphForcesSmem,
                         (surface_tension ? 2 : 0) + (adaptive ? 1 : 0), px,
                         py, vx, vy, valid, dens, sc, frame, fx, fy, gxo, gyo,
                         gy, K, gx, cs, stream);
}

extern "C" int tf_dense_forces(const float* px, const float* py,
                               const float* vx, const float* vy,
                               const uint8_t* valid, const float* dens,
                               const float* sc, const long long* frame,
                               float* fx, float* fy, float* gxo, float* gyo,
                               int gy, int K, int gx, int surface_tension,
                               int adaptive, float h, float h2,
                               float sqr_radius, float spiky_norm,
                               float visc_norm, float c_2h3,
                               float st_grad_norm, float st_lap_norm,
                               float c_3h2, cudaStream_t stream) {
    SphForcesConsts cs = {};
    cs.h = h, cs.h2 = h2, cs.sqr_radius = sqr_radius;
    cs.spiky_norm = spiky_norm, cs.visc_norm = visc_norm;
    cs.c_2h3 = c_2h3;
    cs.st_grad_norm = st_grad_norm, cs.st_lap_norm = st_lap_norm;
    cs.c_3h2 = c_3h2;
    return launch_forces(kDenseForces, kDenseForcesSmem,
                         (surface_tension ? 2 : 0) + (adaptive ? 1 : 0), px,
                         py, vx, vy, valid, dens, sc, frame, fx, fy, gxo, gyo,
                         gy, K, gx, cs, stream);
}
