// Forces + integrate: symmetrised spiky pressure and viscosity over the
// 3x3 cell stencil, fused with the full integration step.
//
// Replaces tpufluid/ops/pallas/fused.py:forces_integrate with every flag
// (_forces_kernel -> _forces_one_row, _forces_cand_block, _forces_one_cand,
// _adaptive_factor, _forces_integrate_sub). The TPU kernel folded the
// slot axis into 8-slot sublane sub-blocks, lane-rolled six candidate
// fields per (row, dx) block and carried per-target sums in VMEM scratch.
//
// Bound: the instruction throughput of the pair loop. At scene_1m (~3.95
// particles a cell) each live target meets ~36 candidates at ~43 flops
// and one rsqrt (surface tension: ~27 more and a sqrt); the grid's own
// reads and the four output fields cross DRAM about once.
//
// Design: one block of 256 threads per tile of R x C cells with all K
// slots (tf_resident_tile picks the tile from K so that it fits shared
// memory).
//   S: the tile's +-1 halo goes to shared memory, per slot the
//      prediction (each slot predicted once, with its row's dt) and
//      (velocity, pressure, 1/rho) as a float4; only slots below their
//      row's occupancy are read, empty ones staged as SENTINEL and zeros,
//      and each halo cell's occupancy (last live slot + 1) is kept beside
//      them;
//   L: the tile's live targets are listed in (slot, row, column) order
//      (tf_tile_targets); every other centre slot gets SENTINEL / 0
//      there, so every output element is written once;
//   F: the threads take the listed targets: tf_forces_target walks each
//      target's 3 x 3 candidate cells below each cell's own occupancy over
//      the shared fields (slot kp outer, (row, dx) inner, per-kp partials
//      added to the totals: the TPU kernel's order) and integrates. An
//      empty slot below a cell's occupancy is visited as SENTINEL and
//      zeros, whose terms are +-0 (TfTileCand): the walk has no liveness
//      test.
// So no lane idles on an empty target, no candidate loop runs past its
// cell's last particle, and a candidate's six fields are read and
// predicted once per block rather than once per reader. The four variant
// flags (wrap_x, has_ff, surface_tension, adaptive) are template
// parameters, so each instantiation carries only its own code and
// registers (a runtime has_ff branch cost the base launch ~12% on the
// H100); all 16 are built.
// Batched world stacks: wid[y] (null for one world) picks row y's world
// in the per-world scalar table sc[W][17] (TF_SC_* columns).
#include "resident_math.cuh"

template <bool WRAP, bool HAS_FF, bool ST, bool ADAPT>
__global__ void __launch_bounds__(TF_TILE_THREADS, 4)
forces_kernel(const float* __restrict__ px, const float* __restrict__ py,
              const float* __restrict__ vx, const float* __restrict__ vy,
              const float* __restrict__ pres, const float* __restrict__ invr,
              const int* __restrict__ occ_row, const int* __restrict__ wid,
              const float* __restrict__ sc,
              const long long* __restrict__ frame_p,
              const float* __restrict__ ffx, const float* __restrict__ ffy,
              float* __restrict__ npx, float* __restrict__ npy,
              float* __restrict__ nvx, float* __restrict__ nvy, int gy, int K,
              int gx, int lgR, int lgC, TfForceConsts c) {
    extern __shared__ float4 smem4[];
    const int R = 1 << lgR, C = 1 << lgC;
    const int HR = R + 2, HC = C + 2;
    const int n_h = HR * K * HC;
    float4* sq = smem4;
    float2* sp = reinterpret_cast<float2*>(sq + n_h);
    const TfTileSmem t = tf_tile_smem(sp + n_h, K, R, C);
    const int y0 = blockIdx.y * R;
    const int x0 = blockIdx.x * C;
    tf_tile_begin(t, occ_row, wid, sc, TF_SC_N, TF_SC_DT, R, C, K, y0, gy);
    // the half extents are the same in every world
    const float hx = sc[TF_SC_HALF_X];
    const float hy = sc[TF_SC_HALF_Y];

    // S: predictions, velocities, (pressure, 1/rho) of the +-1 halo
    float ax[TF_STAGE_BATCH], ay[TF_STAGE_BATCH];
    float ux[TF_STAGE_BATCH], uy[TF_STAGE_BATCH];
    float ap[TF_STAGE_BATCH], ai[TF_STAGE_BATCH];
    tf_stage_halo(
        t, R, C, K, y0, x0, gx,
        [&](int u, size_t gi) {
            ax[u] = px[gi];
            ay[u] = py[gi];
            ux[u] = vx[gi];
            uy[u] = vy[gi];
            ap[u] = pres[gi];
            ai[u] = invr[gi];
        },
        [&](int u, int lr, int kk, int lc) {
            const int s = (lr * K + kk) * HC + lc;
            if (!tf_live(ax[u])) {
                sp[s] = make_float2(TF_SENTINEL, TF_SENTINEL);
                sq[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                return;
            }
            const float dt = t.sdt[lr];
            sp[s] = make_float2(tf_pred(ax[u], ux[u], dt, hx),
                                tf_pred(ay[u], uy[u], dt, hy));
            sq[s] = make_float4(ux[u], uy[u], ap[u], ai[u]);
            atomicMax(&t.socc[lr * HC + lc], kk + 1);
        });

    // L: the live targets; empty slots get SENTINEL / 0
    const int n_live = tf_tile_targets(
        sp, t, tf_max_rows(t.srow + 1, R), lgR, lgC, K, y0, x0, gy,
        [&](int y, int kk, int x) {
            const size_t ti = tf_index(y, kk, x, K, gx);
            npx[ti] = TF_SENTINEL;
            npy[ti] = TF_SENTINEL;
            nvx[ti] = 0.0f;
            nvy[ti] = 0.0f;
        });

    // F: forces and integration of each live target
    const TfTileCand src{sp, sq, y0 - 1, x0 - 1, K, HC};
    const uint32_t frame = (uint32_t)frame_p[0];
    for (int j = threadIdx.x; j < n_live; j += TF_TILE_THREADS) {
        const int e = t.list[j];
        const int kk = e >> 16;
        const int lr = (e >> 8) & 255;
        const int lc = e & 255;
        const int y = y0 + lr;
        const int x = x0 + lc;
        const int s = ((lr + 1) * K + kk) * HC + lc + 1;
        const float4 u0 = sq[s];
        const size_t ti = tf_index(y, kk, x, K, gx);
        int occ_c[9];
        const int occ_max = tf_occ_tile(t.socc, lr, lc, HC, occ_c);
        float fx = 0.0f, fy = 0.0f;
        if (HAS_FF) {
            const size_t fi = (size_t)y * gx + x;
            fx = ffx[fi];
            fy = ffy[fi];
        }
        const float* scw = sc + tf_world(wid, y) * TF_SC_N;
        float ox, oy, ovx, ovy;
        tf_forces_target<WRAP, HAS_FF, ST, ADAPT>(
            src, scw, frame, kk, y, x, occ_c, occ_max, px[ti], py[ti], u0.x,
            u0.y, u0.z, u0.w, fx, fy, c, ox, oy, ovx, ovy);
        npx[ti] = ox;
        npy[ti] = oy;
        nvx[ti] = ovx;
        nvy[ti] = ovy;
    }
}

typedef void (*ForcesKernel)(const float*, const float*, const float*,
                             const float*, const float*, const float*,
                             const int*, const int*, const float*,
                             const long long*, const float*, const float*,
                             float*, float*, float*, float*, int, int, int,
                             int, int, TfForceConsts);

template <int F>
static ForcesKernel forces_variant() {
    return forces_kernel<(F & TF_WRAP) != 0, (F & TF_HAS_FF) != 0,
                         (F & TF_ST) != 0, (F & TF_ADAPT) != 0>;
}

static const ForcesKernel kForces[16] = {
    forces_variant<0>(),  forces_variant<1>(),  forces_variant<2>(),
    forces_variant<3>(),  forces_variant<4>(),  forces_variant<5>(),
    forces_variant<6>(),  forces_variant<7>(),  forces_variant<8>(),
    forces_variant<9>(),  forces_variant<10>(), forces_variant<11>(),
    forces_variant<12>(), forces_variant<13>(), forces_variant<14>(),
    forces_variant<15>()};
// dynamic shared memory limit set so far, per variant
static int kForcesSmem[16];

// The tile tf_forces runs at capacity K as rows << 8 | columns; 0 when
// none fits shared memory.
extern "C" int tf_forces_tile(int K) {
    int lgR, lgC;
    if (K <= 0 || !tf_resident_tile(24, TF_FORCES_SLOTS, K, lgR, lgC))
        return 0;
    return (1 << lgR) << 8 | (1 << lgC);
}

extern "C" int tf_forces(const float* px, const float* py, const float* vx,
                         const float* vy, const float* pres, const float* invr,
                         const int* occ_row, const int* wid, const float* sc,
                         const long long* frame, const float* ffx,
                         const float* ffy, float* npx, float* npy,
                         float* nvx, float* nvy, int gy, int K, int gx,
                         int flags, const float* consts,
                         cudaStream_t stream) {
    const bool has_ff = (flags & TF_HAS_FF) != 0;
    int lgR = 0, lgC = 0;
    if (gy <= 0 || K <= 0 || K > 32767 ||
        !tf_resident_tile(24, TF_FORCES_SLOTS, K, lgR, lgC) ||
        gx % (1 << lgC) != 0 || (gy + (1 << lgR) - 1) >> lgR > 65535 ||
        flags < 0 || flags > 15 || has_ff != (ffx != nullptr) ||
        (ffx == nullptr) != (ffy == nullptr))
        return (int)cudaErrorInvalidValue;
    const long long smem = tf_tile_smem_bytes(24, K, 1 << lgR, 1 << lgC);
    if (smem > kForcesSmem[flags] && smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kForces[flags], cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        kForcesSmem[flags] = (int)smem;
    }
    TfForceConsts c;
    memcpy(&c, consts, sizeof(c));
    dim3 grid(gx >> lgC, (gy + (1 << lgR) - 1) >> lgR);
    kForces[flags]<<<grid, TF_TILE_THREADS, (size_t)smem, stream>>>(
        px, py, vx, vy, pres, invr, occ_row, wid, sc, frame, ffx, ffy, npx,
        npy, nvx, nvy, gy, K, gx, lgR, lgC, c);
    return (int)cudaGetLastError();
}
