// Density: poly6 density over the 3x3 cell stencil, emitted as pressure
// k (rho - rho0) and 1/rho.
//
// Replaces tpufluid/ops/pallas/fused.py:density (_density_kernel), which
// on the TPU folded the slot axis into 8-slot sublane sub-blocks and
// lane-rolled whole candidate rows against whole target rows.
//
// Bound: the instruction throughput of the pair loop, then memory. At
// scene_1m (Gy 524, K 8, Gxp 512, ~3.95 particles a cell) each live
// target meets ~36 candidates at ~18 flops; DRAM sees each field about
// once.
//
// Design: one block of 256 threads per tile of R x C cells with all K
// slots (tf_resident_tile picks the tile from K so that it fits shared
// memory).
//   S: the predictions of the tile's +-1 halo, each slot predicted once
//      with its row's dt, go to shared memory (float2 per slot); only
//      slots below their row's occupancy are read, and each halo cell's
//      occupancy (last live slot + 1) is kept beside them;
//   L: the tile's live targets are listed in (slot, row, column) order
//      (tf_tile_targets); every other centre slot gets the floor-density
//      defaults there, so every output element is written once;
//   D: the threads take the listed targets, each walking its 3 x 3
//      candidate cells below each cell's own occupancy (tf_density_sum
//      over the shared predictions, slot kp outer and (row, dx) inner,
//      per-kp partials added to the total: the TPU kernel's order).
// So no lane idles on an empty target, no candidate loop runs past its
// cell's last particle, each candidate is predicted once per block
// rather than once per reader, and each row crosses L2 (R + 2) / R times
// instead of once per slot row of every reader.
// Batched world stacks: wid[y] (null for one world) picks row y's world
// in the per-world scalar table sc[W][4] = (mass, dt, pressure constant,
// rest density); the half extents are the same in every world and come
// as arguments.
#include "resident_math.cuh"

__global__ void __launch_bounds__(TF_TILE_THREADS, 4)
density_kernel(const float* __restrict__ px, const float* __restrict__ py,
               const float* __restrict__ vx, const float* __restrict__ vy,
               const int* __restrict__ occ_row, const int* __restrict__ wid,
               const float* __restrict__ sc, float* __restrict__ pres,
               float* __restrict__ invr, int gy, int K, int gx, int lgR,
               int lgC, float h2, float norm, float half_x, float half_y) {
    extern __shared__ float2 smem2[];
    const int R = 1 << lgR, C = 1 << lgC;
    const int HR = R + 2, HC = C + 2;
    float2* sp = smem2;
    const TfTileSmem t = tf_tile_smem(sp + HR * K * HC, K, R, C);
    const int y0 = blockIdx.y * R;
    const int x0 = blockIdx.x * C;
    tf_tile_begin(t, occ_row, wid, sc, TF_DSC_N, TF_DSC_DT, R, C, K, y0, gy);

    // S: predictions of the +-1 halo
    float ax[TF_STAGE_BATCH], ay[TF_STAGE_BATCH];
    float ux[TF_STAGE_BATCH], uy[TF_STAGE_BATCH];
    tf_stage_halo(
        t, R, C, K, y0, x0, gx,
        [&](int u, size_t gi) {
            ax[u] = px[gi];
            ay[u] = py[gi];
            ux[u] = vx[gi];
            uy[u] = vy[gi];
        },
        [&](int u, int lr, int kk, int lc) {
            float2 q = make_float2(TF_SENTINEL, TF_SENTINEL);
            if (tf_live(ax[u])) {
                const float dt = t.sdt[lr];
                q = make_float2(tf_pred(ax[u], ux[u], dt, half_x),
                                tf_pred(ay[u], uy[u], dt, half_y));
                atomicMax(&t.socc[lr * HC + lc], kk + 1);
            }
            sp[(lr * K + kk) * HC + lc] = q;
        });

    // L: the live targets; empty slots get the floor-density defaults
    const int n_live = tf_tile_targets(
        sp, t, tf_max_rows(t.srow + 1, R), lgR, lgC, K, y0, x0, gy,
        [&](int y, int kk, int x) {
            const float* scw = sc + tf_world(wid, y) * TF_DSC_N;
            const size_t ti = tf_index(y, kk, x, K, gx);
            tf_density_empty(scw[TF_DSC_KP], scw[TF_DSC_RHO0], pres[ti],
                             invr[ti]);
        });

    // D: the density sum of each live target
    const TfSharedPred src{sp, y0 - 1, x0 - 1, K, HC};
    for (int j = threadIdx.x; j < n_live; j += TF_TILE_THREADS) {
        const int e = t.list[j];
        const int kk = e >> 16;
        const int lr = (e >> 8) & 255;
        const int lc = e & 255;
        const int y = y0 + lr;
        const int x = x0 + lc;
        const float2 tq = sp[((lr + 1) * K + kk) * HC + lc + 1];
        int occ_c[9];
        const int occ_max = tf_occ_tile(t.socc, lr, lc, HC, occ_c);
        const float acc =
            tf_density_sum(src, y, x, occ_c, occ_max, tq.x, tq.y, h2);
        const float* scw = sc + tf_world(wid, y) * TF_DSC_N;
        const size_t ti = tf_index(y, kk, x, K, gx);
        tf_density_out(acc, scw[TF_DSC_MASS], norm, scw[TF_DSC_KP],
                       scw[TF_DSC_RHO0], pres[ti], invr[ti]);
    }
}

// dynamic shared memory limit set so far
static int kDensitySmem;

// The tile tf_density runs at capacity K as rows << 8 | columns; 0 when
// none fits shared memory.
extern "C" int tf_density_tile(int K) {
    int lgR, lgC;
    if (K <= 0 || !tf_resident_tile(8, TF_DENSITY_SLOTS, K, lgR, lgC))
        return 0;
    return (1 << lgR) << 8 | (1 << lgC);
}

extern "C" int tf_density(const float* px, const float* py, const float* vx,
                          const float* vy, const int* occ_row, const int* wid,
                          const float* sc, float* pres, float* invr, int gy,
                          int K, int gx, float h2, float norm, float half_x,
                          float half_y, cudaStream_t stream) {
    int lgR = 0, lgC = 0;
    if (gy <= 0 || K <= 0 || K > 32767 ||
        !tf_resident_tile(8, TF_DENSITY_SLOTS, K, lgR, lgC) ||
        gx % (1 << lgC) != 0 || (gy + (1 << lgR) - 1) >> lgR > 65535)
        return (int)cudaErrorInvalidValue;
    const long long smem = tf_tile_smem_bytes(8, K, 1 << lgR, 1 << lgC);
    if (smem > kDensitySmem && smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            density_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        kDensitySmem = (int)smem;
    }
    dim3 grid(gx >> lgC, (gy + (1 << lgR) - 1) >> lgR);
    density_kernel<<<grid, TF_TILE_THREADS, (size_t)smem, stream>>>(
        px, py, vx, vy, occ_row, wid, sc, pres, invr, gy, K, gx, lgR, lgC, h2,
        norm, half_x, half_y);
    return (int)cudaGetLastError();
}
