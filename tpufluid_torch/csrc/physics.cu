// Physics: density, forces and integration in one pass, bitwise equal to
// density.cu followed by forces.cu.
//
// Replaces tpufluid/ops/pallas/fused.py:physics (_physics_kernel). On the
// TPU each program ran three phases over rblk + 4 whole rows in VMEM:
// predictions (P), density for rblk + 2 rows (D), forces and integration
// for the rblk centre rows (F).
//
// Bound: memory traffic through L1/L2, as for the split pair. Against the
// pair it saves the pres and 1/rho fields' round trip through device
// memory (2 x 8.6 MB written and read back at scene_1m) and one launch,
// and it predicts each slot once instead of once per reader; it pays the
// density of its halo again, (R + 2)(C + 2) / (R C) of the density work.
//
// Design: one block per tile of R rows x C columns x all K slots (the
// wrapper picks R and C from K so that the tile fits shared memory).
//   P: predicted positions of the (R + 4) x (C + 4) cells around the tile
//      (a +-2 halo; empty slots and cells outside the grid hold
//      SENTINEL), and velocities of the +-1 halo, into shared memory;
//   D: pressure and 1/rho of the (R + 2) x (C + 2) cells of the +-1 halo,
//      each by tf_density_sum over the shared predictions;
//   F: forces and integration of the R x C centre cells by
//      tf_forces_target over the shared fields, written out.
// The density sum and the force loop are the same device functions that
// density.cu and forces.cu call (resident_math.cuh), read from shared
// memory (TfSharedPred, TfSharedCand) over the same values in the same
// order, so every output is bitwise the split pair's. Its candidate
// bounds are the rows' occupancies (tf_occ_rows): the split kernels'
// tighter per-cell bounds skip only empty slots.
// Shared memory: 4 K (2 (R + 4)(C + 4) + 4 (R + 2)(C + 2)) bytes, ~44 KB
// at K = 8 with a 4 x 32 tile; above 48 KB the launch first raises the
// kernel's dynamic shared memory limit (cudaFuncSetAttribute).
// Batched world stacks: wid[y] (null for one world) picks row y's world
// in the per-world scalar table sc[W][19] (TF_SC_* columns).
#include "resident_math.cuh"

#define TF_PHYS_THREADS 256

template <bool WRAP, bool HAS_FF, bool ST, bool ADAPT>
__global__ void __launch_bounds__(TF_PHYS_THREADS)
physics_kernel(const float* __restrict__ px, const float* __restrict__ py,
               const float* __restrict__ vx, const float* __restrict__ vy,
               const int* __restrict__ occ_row, const int* __restrict__ wid,
               const float* __restrict__ sc,
               const long long* __restrict__ frame_p,
               const float* __restrict__ ffx, const float* __restrict__ ffy,
               float* __restrict__ npx, float* __restrict__ npy,
               float* __restrict__ nvx, float* __restrict__ nvy, int gy,
               int K, int gx, int R, int C, float dens_h2, float dens_norm,
               TfForceConsts c) {
    extern __shared__ float2 smem2[];
    const int pw = C + 4, ph = R + 4;  // +-2 tile
    const int hw = C + 2, hh = R + 2;  // +-1 tile
    const int n_p = ph * K * pw;
    const int n_h = hh * K * hw;
    float2* sp = smem2;  // predictions
    float2* sv = sp + n_p;  // velocities
    float2* sr = sv + n_h;  // (pressure, 1/rho)
    const int y0 = blockIdx.y * R;
    const int x0 = blockIdx.x * C;

    // P: predictions of the +-2 tile, velocities of the +-1 tile
    for (int i = threadIdx.x; i < n_p; i += blockDim.x) {
        const int lc = i % pw;
        const int kk = (i / pw) % K;
        const int lr = i / (pw * K);
        const int sy = y0 + lr - 2;
        const int sx = x0 + lc - 2;
        float qx = TF_SENTINEL, qy = TF_SENTINEL, ux = 0.0f, uy = 0.0f;
        if (sy >= 0 && sy < gy && sx >= 0 && sx < gx && kk < occ_row[sy]) {
            const size_t gi = tf_index(sy, kk, sx, K, gx);
            const float p = px[gi];
            if (tf_live(p)) {
                const float* scw = sc + tf_world(wid, sy) * TF_PSC_N;
                const float dt = scw[TF_SC_DT];
                ux = vx[gi];
                uy = vy[gi];
                qx = tf_pred(p, ux, dt, scw[TF_SC_HALF_X]);
                qy = tf_pred(py[gi], uy, dt, scw[TF_SC_HALF_Y]);
            }
        }
        sp[i] = make_float2(qx, qy);
        if (lr >= 1 && lr <= hh && lc >= 1 && lc <= hw) {
            const int j = ((lr - 1) * K + kk) * hw + (lc - 1);
            sv[j] = make_float2(ux, uy);
        }
    }
    __syncthreads();

    // D: pressure and 1/rho of the +-1 tile
    const TfSharedPred<true> dsrc{sp, y0 - 2, x0 - 2, K, pw};
    for (int j = threadIdx.x; j < n_h; j += blockDim.x) {
        const int lc = j % hw;
        const int kk = (j / hw) % K;
        const int lr = j / (hw * K);
        const int sy = y0 + lr - 1;
        const int sx = x0 + lc - 1;
        float pres = 0.0f, invr = 10.0f;
        if (sy >= 0 && sy < gy && sx >= 0 && sx < gx) {
            const float* scw = sc + tf_world(wid, sy) * TF_PSC_N;
            const float kp_c = scw[TF_SC_KP];
            const float rho0 = scw[TF_SC_RHO0];
            const int i = ((lr + 1) * K + kk) * pw + (lc + 1);
            const float2 tq = sp[i];
            if (kk >= occ_row[sy] || !tf_live(tq.x)) {
                tf_density_empty(kp_c, rho0, pres, invr);
            } else {
                int occ_c[9];
                const int occ_max = tf_occ_rows(occ_row, sy, gy, sx, gx,
                                                occ_c);
                const float acc = tf_density_sum(dsrc, sy, sx, occ_c,
                                                 occ_max, tq.x, tq.y,
                                                 dens_h2);
                tf_density_out(acc, scw[TF_SC_MASS], dens_norm, kp_c, rho0,
                               pres, invr);
            }
        }
        sr[j] = make_float2(pres, invr);
    }
    __syncthreads();

    // F: forces and integration of the centre cells
    const TfSharedCand fsrc{sp, sv, sr, y0 - 2, x0 - 2, K, pw, hw};
    const uint32_t frame = (uint32_t)frame_p[0];
    const int n_c = R * K * C;
    for (int t = threadIdx.x; t < n_c; t += blockDim.x) {
        const int lc = t % C;
        const int kk = (t / C) % K;
        const int lr = t / (C * K);
        const int y = y0 + lr;
        const int x = x0 + lc;
        if (y >= gy || x >= gx) continue;
        const size_t ti = tf_index(y, kk, x, K, gx);
        const float pos_x0 = px[ti];
        if (kk >= occ_row[y] || !tf_live(pos_x0)) {
            npx[ti] = TF_SENTINEL;
            npy[ti] = TF_SENTINEL;
            nvx[ti] = 0.0f;
            nvy[ti] = 0.0f;
            continue;
        }
        const float* scw = sc + tf_world(wid, y) * TF_PSC_N;
        int occ_c[9];
        const int occ_max = tf_occ_rows(occ_row, y, gy, x, gx, occ_c);
        const int j = ((lr + 1) * K + kk) * hw + (lc + 1);
        float fx = 0.0f, fy = 0.0f;
        if (HAS_FF) {
            const size_t fi = (size_t)y * gx + x;
            fx = ffx[fi];
            fy = ffy[fi];
        }
        float ox, oy, ovx, ovy;
        tf_forces_target<WRAP, HAS_FF, ST, ADAPT>(
            fsrc, scw, frame, kk, y, x, occ_c, occ_max, pos_x0, py[ti],
            sv[j].x, sv[j].y, sr[j].x, sr[j].y, fx, fy, c, ox, oy, ovx, ovy);
        npx[ti] = ox;
        npy[ti] = oy;
        nvx[ti] = ovx;
        nvy[ti] = ovy;
    }
}

typedef void (*PhysicsKernel)(const float*, const float*, const float*,
                              const float*, const int*, const int*,
                              const float*, const long long*, const float*,
                              const float*, float*, float*, float*, float*,
                              int, int, int, int, int, float, float,
                              TfForceConsts);

template <int F>
static PhysicsKernel physics_variant() {
    return physics_kernel<(F & TF_WRAP) != 0, (F & TF_HAS_FF) != 0,
                          (F & TF_ST) != 0, (F & TF_ADAPT) != 0>;
}

static const PhysicsKernel kPhysics[16] = {
    physics_variant<0>(),  physics_variant<1>(),  physics_variant<2>(),
    physics_variant<3>(),  physics_variant<4>(),  physics_variant<5>(),
    physics_variant<6>(),  physics_variant<7>(),  physics_variant<8>(),
    physics_variant<9>(),  physics_variant<10>(), physics_variant<11>(),
    physics_variant<12>(), physics_variant<13>(), physics_variant<14>(),
    physics_variant<15>()};
// dynamic shared memory limit set so far, per variant
static int kPhysicsSmem[16];

static long long physics_smem_bytes(int K, int R, int C) {
    return 4LL * K * (2LL * (R + 4) * (C + 4) + 4LL * (R + 2) * (C + 2));
}

extern "C" int tf_physics(const float* px, const float* py, const float* vx,
                          const float* vy, const int* occ_row, const int* wid,
                          const float* sc, const long long* frame,
                          const float* ffx, const float* ffy, float* npx,
                          float* npy, float* nvx, float* nvy, int gy, int K,
                          int gx, int R, int C, int flags, float dens_h2,
                          float dens_norm, const float* consts,
                          cudaStream_t stream) {
    const bool has_ff = (flags & TF_HAS_FF) != 0;
    const long long smem = physics_smem_bytes(K, R, C);
    if (gy <= 0 || K <= 0 || R <= 0 || C <= 0 || gx % C != 0 ||
        (gy + R - 1) / R > 65535 || smem > TF_SMEM_MAX || flags < 0 ||
        flags > 15 || has_ff != (ffx != nullptr) ||
        (ffx == nullptr) != (ffy == nullptr))
        return (int)cudaErrorInvalidValue;
    if (smem > kPhysicsSmem[flags] && smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kPhysics[flags], cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        kPhysicsSmem[flags] = (int)smem;
    }
    TfForceConsts c;
    memcpy(&c, consts, sizeof(c));
    dim3 grid(gx / C, (gy + R - 1) / R);
    kPhysics[flags]<<<grid, TF_PHYS_THREADS, (size_t)smem, stream>>>(
        px, py, vx, vy, occ_row, wid, sc, frame, ffx, ffy, npx, npy, nvx, nvy,
        gy, K, gx, R, C, dens_h2, dens_norm, c);
    return (int)cudaGetLastError();
}
