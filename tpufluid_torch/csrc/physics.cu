// Physics: density, forces and integration in one pass, bitwise equal to
// density.cu followed by forces.cu.
//
// Replaces tpufluid/ops/pallas/fused.py:physics (_physics_kernel). On the
// TPU each program ran three phases over rblk + 4 whole rows in VMEM:
// predictions (P), density for rblk + 2 rows (D), forces and integration
// for the rblk centre rows (F).
//
// Bound: the instruction throughput of the pair loops, as for the split
// pair. Against the pair it saves the pres and 1/rho fields' round trip
// through device memory (2 x 8.6 MB written and read back at scene_1m)
// and one launch, and predicts each slot once instead of once per
// kernel; it pays the density of its +-1 ring again, (R + 2)(C + 2) /
// (R C) of the density work (1.33 with an 8 x 32 tile).
//
// Design: one block of 512 threads per tile of R x C cells with all K
// slots (tf_pick_tile picks the tile from K, capped at TF_PHYSICS_SLOTS
// target slots; tf_physics_tile reports it), on the tile helpers of
// density.cu and forces.cu with a halo of 2. Its shared memory (82 KB for
// the 8 x 32 tile at K=8) leaves room for two blocks an SM, so a block
// takes 512 threads to keep as many warps in flight as forces.cu's four
// blocks of 256 (the 4 x 32 tile at 256 threads, its ring 1.59x the
// tile, ran 5% slower at K=8 and 40% at K=32 on the H100: PERF.md):
//   S: the tile's +-2 halo is staged once (tf_stage_halo): per slot below
//      its row's occupancy the prediction (with its row's dt; SENTINEL for
//      an empty slot), and on the +-1 ring (velocity, 0, 0) (zeros for an
//      empty slot); each halo cell's occupancy (last live slot + 1) is
//      kept beside them;
//   D: the ring's live slots are listed (tf_tile_compact, (slot, row,
//      column) order) and each one's density sum walks its 3 x 3
//      candidate cells below each cell's own occupancy (tf_density_sum);
//      its pressure and 1/rho complete the ring's staged record;
//   F: the centre's live targets are listed (tf_tile_targets; every other
//      centre slot gets SENTINEL / 0 there), and tf_forces_target walks
//      each one's 3 x 3 candidate cells below each cell's own occupancy
//      over the shared fields (TfHaloCand) and integrates.
// So no lane idles on an empty slot, no walk runs past its cell's last
// particle, and each slot is read and predicted once per block. The
// density sum and the force loop are the device functions density.cu and
// forces.cu call, over the same values in the same order, so every
// output is bitwise the split pair's. The four variant flags are template
// parameters, as in forces.cu; all 16 are built.
// Batched world stacks: wid[y] (null for one world) picks row y's world
// in the per-world scalar table sc[W][19] (TF_SC_* columns).
#include "resident_math.cuh"

template <bool WRAP, bool HAS_FF, bool ST, bool ADAPT>
__global__ void __launch_bounds__(TF_PHYSICS_THREADS, 2)
physics_kernel(const float* __restrict__ px, const float* __restrict__ py,
               const float* __restrict__ vx, const float* __restrict__ vy,
               const int* __restrict__ occ_row, const int* __restrict__ wid,
               const float* __restrict__ sc,
               const long long* __restrict__ frame_p,
               const float* __restrict__ ffx, const float* __restrict__ ffy,
               float* __restrict__ npx, float* __restrict__ npy,
               float* __restrict__ nvx, float* __restrict__ nvy, int gy,
               int K, int gx, int lgR, int lgC, float dens_h2,
               float dens_norm, TfForceConsts c) {
    extern __shared__ float4 smem4[];
    const int R = 1 << lgR, C = 1 << lgC;
    const int HC = C + 4;              // +-2 halo
    const int QR = R + 2, QC = C + 2;  // +-1 ring
    float4* sq = smem4;
    float2* sp = reinterpret_cast<float2*>(sq + QR * K * QC);
    const TfTileSmem t =
        tf_tile_smem(sp + (R + 4) * K * HC, K, R, C, 2, TF_PHYSICS_THREADS);
    const int y0 = blockIdx.y * R;
    const int x0 = blockIdx.x * C;
    tf_tile_begin<TF_PHYSICS_THREADS>(t, occ_row, wid, sc, TF_PSC_N,
                                      TF_SC_DT, R, C, K, y0, gy);
    // the half extents are the same in every world
    const float hx = sc[TF_SC_HALF_X];
    const float hy = sc[TF_SC_HALF_Y];

    // S: predictions of the +-2 halo, velocities of the +-1 ring
    float ax[TF_STAGE_BATCH], ay[TF_STAGE_BATCH];
    float ux[TF_STAGE_BATCH], uy[TF_STAGE_BATCH];
    tf_stage_halo<TF_PHYSICS_THREADS>(
        t, R, C, K, y0, x0, gx,
        [&](int u, size_t gi) {
            ax[u] = px[gi];
            ay[u] = py[gi];
            ux[u] = vx[gi];
            uy[u] = vy[gi];
        },
        [&](int u, int lr, int kk, int lc) {
            const bool live = tf_live(ax[u]);
            float2 q = make_float2(TF_SENTINEL, TF_SENTINEL);
            if (live) {
                const float dt = t.sdt[lr];
                q = make_float2(tf_pred(ax[u], ux[u], dt, hx),
                                tf_pred(ay[u], uy[u], dt, hy));
                atomicMax(&t.socc[lr * HC + lc], kk + 1);
            }
            sp[(lr * K + kk) * HC + lc] = q;
            if (lr >= 1 && lr <= QR && lc >= 1 && lc <= QC)
                sq[((lr - 1) * K + kk) * QC + lc - 1] =
                    live ? make_float4(ux[u], uy[u], 0.0f, 0.0f)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        });

    // D: the density of each live slot of the +-1 ring (ring coordinates
    // (lr, lc): halo cell (lr + 1, lc + 1))
    const int n_ring = tf_tile_compact<TF_PHYSICS_THREADS>(
        t.list, t.wsum, tf_max_rows(t.srow + 1, QR) * QR * QC,
        [&](int i, int& e) {
            const int q = i / QC;
            const int lc = i - q * QC;
            const int kk = q / QR;
            const int lr = q - kk * QR;
            e = (kk << 16) | (lr << 8) | lc;
            return kk < t.socc[(lr + 1) * HC + lc + 1] &&
                   tf_live(sp[((lr + 1) * K + kk) * HC + lc + 1].x);
        });
    const TfSharedPred dsrc{sp, y0 - 2, x0 - 2, K, HC};
    for (int j = threadIdx.x; j < n_ring; j += TF_PHYSICS_THREADS) {
        const int e = t.list[j];
        const int kk = e >> 16;
        const int lr = (e >> 8) & 255;
        const int lc = e & 255;
        const int y = y0 + lr - 1;
        const int x = x0 + lc - 1;
        const float2 tq = sp[((lr + 1) * K + kk) * HC + lc + 1];
        int occ_c[9];
        const int occ_max = tf_occ_tile(t.socc, lr, lc, HC, occ_c);
        const float acc = tf_density_sum(dsrc, y, x, occ_c, occ_max, tq.x,
                                         tq.y, dens_h2);
        const float* scw = sc + tf_world(wid, y) * TF_PSC_N;
        float pres, invr;
        tf_density_out(acc, scw[TF_SC_MASS], dens_norm, scw[TF_SC_KP],
                       scw[TF_SC_RHO0], pres, invr);
        float4* s = &sq[(lr * K + kk) * QC + lc];
        s->z = pres;
        s->w = invr;
    }
    __syncthreads();

    // F: forces and integration of each live centre target; empty slots
    // get SENTINEL / 0
    const int n_live = tf_tile_targets<TF_PHYSICS_THREADS>(
        sp, t, tf_max_rows(t.srow + 2, R), lgR, lgC, K, y0, x0, gy,
        [&](int y, int kk, int x) {
            const size_t ti = tf_index(y, kk, x, K, gx);
            npx[ti] = TF_SENTINEL;
            npy[ti] = TF_SENTINEL;
            nvx[ti] = 0.0f;
            nvy[ti] = 0.0f;
        });
    const TfHaloCand src{sp, sq, y0 - 2, x0 - 2, K, HC, QC};
    const uint32_t frame = (uint32_t)frame_p[0];
    for (int j = threadIdx.x; j < n_live; j += TF_PHYSICS_THREADS) {
        const int e = t.list[j];
        const int kk = e >> 16;
        const int lr = (e >> 8) & 255;
        const int lc = e & 255;
        const int y = y0 + lr;
        const int x = x0 + lc;
        const float4 u0 = sq[((lr + 1) * K + kk) * QC + lc + 1];
        const size_t ti = tf_index(y, kk, x, K, gx);
        int occ_c[9];
        const int occ_max = tf_occ_tile(t.socc, lr + 1, lc + 1, HC, occ_c);
        float fx = 0.0f, fy = 0.0f;
        if (HAS_FF) {
            const size_t fi = (size_t)y * gx + x;
            fx = ffx[fi];
            fy = ffy[fi];
        }
        const float* scw = sc + tf_world(wid, y) * TF_PSC_N;
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

// Shared memory of a block: the +-2 halo's predictions and the tile
// arrays (tf_tile_smem_bytes with a halo of 2), and the ring's float4s.
static long long physics_smem_bytes(int K, int R, int C) {
    return tf_tile_smem_bytes(8, K, R, C, 2, TF_PHYSICS_THREADS) +
           16LL * K * (R + 2) * (C + 2);
}

static bool physics_tile(int K, int& lgR, int& lgC) {
    return K > 0 && K <= 32767 &&
           tf_pick_tile(TF_PHYSICS_SLOTS, K, lgR, lgC, [&](int R, int C) {
               return physics_smem_bytes(K, R, C);
           });
}

// The tile tf_physics runs at capacity K as rows << 8 | columns; 0 when
// none fits shared memory (K above ~600).
extern "C" int tf_physics_tile(int K) {
    int lgR, lgC;
    if (!physics_tile(K, lgR, lgC)) return 0;
    return (1 << lgR) << 8 | (1 << lgC);
}

// The largest K tf_physics takes: the largest whose 1 x 1 tile fits
// shared memory.
extern "C" int tf_physics_max_k(void) {
    int K = 1;
    while (K < 32767 && physics_smem_bytes(K + 1, 1, 1) <= TF_SMEM_MAX) ++K;
    return K;
}

extern "C" int tf_physics(const float* px, const float* py, const float* vx,
                          const float* vy, const int* occ_row, const int* wid,
                          const float* sc, const long long* frame,
                          const float* ffx, const float* ffy, float* npx,
                          float* npy, float* nvx, float* nvy, int gy, int K,
                          int gx, int flags, float dens_h2, float dens_norm,
                          const float* consts, cudaStream_t stream) {
    const bool has_ff = (flags & TF_HAS_FF) != 0;
    int lgR = 0, lgC = 0;
    if (gy <= 0 || !physics_tile(K, lgR, lgC) || gx % (1 << lgC) != 0 ||
        (gy + (1 << lgR) - 1) >> lgR > 65535 || flags < 0 || flags > 15 ||
        has_ff != (ffx != nullptr) || (ffx == nullptr) != (ffy == nullptr))
        return (int)cudaErrorInvalidValue;
    const long long smem = physics_smem_bytes(K, 1 << lgR, 1 << lgC);
    if (smem > kPhysicsSmem[flags] && smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kPhysics[flags], cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        kPhysicsSmem[flags] = (int)smem;
    }
    TfForceConsts c;
    memcpy(&c, consts, sizeof(c));
    dim3 grid(gx >> lgC, (gy + (1 << lgR) - 1) >> lgR);
    kPhysics[flags]<<<grid, TF_PHYSICS_THREADS, (size_t)smem, stream>>>(
        px, py, vx, vy, occ_row, wid, sc, frame, ffx, ffy, npx, npy, nvx, nvy,
        gy, K, gx, lgR, lgC, dens_h2, dens_norm, c);
    return (int)cudaGetLastError();
}
