// Density: poly6 density over the 3x3 cell stencil, emitted as pressure
// k (rho - rho0) and 1/rho.
//
// Replaces tpufluid/ops/pallas/fused.py:density (_density_kernel), which
// on the TPU folded the slot axis into 8-slot sublane sub-blocks and
// lane-rolled whole candidate rows against whole target rows.
//
// Bound: memory traffic through L1/L2. At scene_1m (Gy 524, K 8,
// Gxp 512, occupancy ~4) each live target reads four fields of about
// 9 * occ3 candidate slots to recompute their predicted positions; the
// pair math is ~10 flops per candidate. DRAM sees each field about once,
// since the blocks of neighbouring rows share the candidate rows in L2.
//
// Design: one thread per target slot (y, k, x); a block covers 128
// consecutive columns of one (row, slot). The candidate sum is
// tf_density_sum (resident_math.cuh), shared with physics.cu: candidate
// slot kp below occ3[y], and for each the nine (row, dx) blocks summed
// into a partial that is added to the running total, the TPU kernel's
// reduction order. Empty candidates (sentinel, or a slot at or beyond
// their row's occupancy) contribute exactly zero in the TPU kernel and
// are skipped here. Empty targets write the floor-density defaults, so
// every output element is written.
// Batched world stacks: wid[y] (null for one world) picks row y's world
// in the per-world scalar table sc[W][4] = (mass, dt, pressure constant,
// rest density). The half extents are the same in every world and come as
// arguments: read from the constant bank they hold no registers, and with
// plain loads and at most 40 registers (12 blocks of 128 on an SM) the
// kernel took 0.135 ms at scene_1m against 0.191 ms at 56 registers with
// the extents in the table and __ldg loads (H100 at 700 W, one call of
// scripts/torch_kernel_ab.py).
#include "resident_math.cuh"

// candidate predictions read from the global grid
struct TfGlobalPred {
    const float* px;
    const float* py;
    const float* vx;
    const float* vy;
    int K, gx;
    float dt, half_x, half_y;

    __device__ __forceinline__ bool pred(int sy, int kp, int sx, float& nx,
                                         float& ny) const {
        const size_t ci = tf_index(sy, kp, sx, K, gx);
        const float cx = px[ci];
        if (!tf_live(cx)) return false;
        nx = tf_pred(cx, vx[ci], dt, half_x);
        ny = tf_pred(py[ci], vy[ci], dt, half_y);
        return true;
    }
};

__global__ void __launch_bounds__(TF_BLOCK, 12)
density_kernel(const float* __restrict__ px, const float* __restrict__ py,
               const float* __restrict__ vx, const float* __restrict__ vy,
               const int* __restrict__ occ_row, const int* __restrict__ wid,
               const float* __restrict__ sc, float* __restrict__ pres,
               float* __restrict__ invr, int gy, int K, int gx, float h2,
               float norm, float half_x, float half_y) {
    const int x = blockIdx.x * TF_BLOCK + threadIdx.x;
    const int k = blockIdx.y;
    const int y = blockIdx.z;
    const float* scw = sc + tf_world(wid, y) * TF_DSC_N;
    const float dt = scw[TF_DSC_DT];
    const size_t ti = tf_index(y, k, x, K, gx);
    const float p0x = px[ti];
    if (k >= occ_row[y] || !tf_live(p0x)) {
        tf_density_empty(scw[TF_DSC_KP], scw[TF_DSC_RHO0], pres[ti],
                         invr[ti]);
        return;
    }
    const float tx = tf_pred(p0x, vx[ti], dt, half_x);
    const float ty = tf_pred(py[ti], vy[ti], dt, half_y);
    int occ_nb[3];
    tf_occ_nb(occ_row, y, gy, occ_nb);
    const int occ3 = max(max(occ_nb[0], occ_nb[1]), occ_nb[2]);
    const TfGlobalPred src{px, py, vx, vy, K, gx, dt, half_x, half_y};
    const float acc = tf_density_sum(src, y, x, gx, occ_nb, occ3, tx, ty, h2);
    tf_density_out(acc, scw[TF_DSC_MASS], norm, scw[TF_DSC_KP],
                   scw[TF_DSC_RHO0], pres[ti], invr[ti]);
}

extern "C" int tf_density(const float* px, const float* py, const float* vx,
                          const float* vy, const int* occ_row, const int* wid,
                          const float* sc, float* pres, float* invr, int gy,
                          int K, int gx, float h2, float norm, float half_x,
                          float half_y, cudaStream_t stream) {
    if (gx % TF_BLOCK != 0 || gy <= 0 || K <= 0 || gy > 65535 || K > 65535)
        return (int)cudaErrorInvalidValue;
    dim3 grid(gx / TF_BLOCK, K, gy);
    density_kernel<<<grid, TF_BLOCK, 0, stream>>>(
        px, py, vx, vy, occ_row, wid, sc, pres, invr, gy, K, gx, h2, norm,
        half_x, half_y);
    return (int)cudaGetLastError();
}
