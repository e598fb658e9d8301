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
// consecutive columns of one (row, slot). Candidate slot kp runs below
// occ3[y]; for each, the nine (row, dx) blocks are summed into a partial
// that is added to the running total: the TPU kernel's reduction order.
// Empty candidates (sentinel, or a slot at or beyond their row's
// occupancy) contribute exactly zero in the TPU kernel and are skipped
// here. Empty targets write the floor-density defaults, so every output
// element is written.
#include "common.cuh"

__global__ void __launch_bounds__(TF_BLOCK)
density_kernel(const float* __restrict__ px, const float* __restrict__ py,
               const float* __restrict__ vx, const float* __restrict__ vy,
               const int* __restrict__ occ_row, const float* __restrict__ sc,
               float* __restrict__ pres, float* __restrict__ invr, int gy,
               int K, int gx, float h2, float norm, float half_x,
               float half_y) {
    const int x = blockIdx.x * TF_BLOCK + threadIdx.x;
    const int k = blockIdx.y;
    const int y = blockIdx.z;
    // sc = [mass, dt, pressure_constant, rest_density]
    const float mass = sc[0];
    const float dt = sc[1];
    const float kp_c = sc[2];
    const float rho0 = sc[3];
    const size_t ti = tf_index(y, k, x, K, gx);
    const float p0x = px[ti];
    if (k >= occ_row[y] || !tf_live(p0x)) {
        pres[ti] = kp_c * (0.1f - rho0);
        invr[ti] = 10.0f;
        return;
    }
    const float tx = tf_pred(p0x, vx[ti], dt, half_x);
    const float ty = tf_pred(py[ti], vy[ti], dt, half_y);
    int occ_nb[3];
    for (int r = -1; r <= 1; ++r) {
        const int sy = y + r;
        occ_nb[r + 1] = (sy >= 0 && sy < gy) ? occ_row[sy] : 0;
    }
    const int occ3 = tf_occ3(occ_row, y, gy);
    float acc = 0.0f;
    for (int kp = 0; kp < occ3; ++kp) {
        float part = 0.0f;
        for (int r = -1; r <= 1; ++r) {
            if (kp >= occ_nb[r + 1]) continue;
            const int sy = y + r;
            for (int dx = -1; dx <= 1; ++dx) {
                const int sx = x + dx;
                if (sx < 0 || sx >= gx) continue;
                const size_t ci = tf_index(sy, kp, sx, K, gx);
                const float cx = px[ci];
                if (!tf_live(cx)) continue;
                const float nx = tf_pred(cx, vx[ci], dt, half_x);
                const float ny = tf_pred(py[ci], vy[ci], dt, half_y);
                const float ddx = nx - tx;
                const float ddy = ny - ty;
                const float r2 = ddx * ddx + ddy * ddy;
                const float diff = fmaxf(h2 - r2, 0.0f);
                part = part + diff * diff * diff;
            }
        }
        acc = acc + part;
    }
    float rho = mass * (norm * acc);
    rho = fmaxf(fmaxf(rho, TF_EPSILON), 0.1f);
    pres[ti] = kp_c * (rho - rho0);
    invr[ti] = 1.0f / rho;
}

extern "C" int tf_density(const float* px, const float* py, const float* vx,
                          const float* vy, const int* occ_row, const float* sc,
                          float* pres, float* invr, int gy, int K, int gx,
                          float h2, float norm, float half_x, float half_y,
                          cudaStream_t stream) {
    if (gx % TF_BLOCK != 0 || gy <= 0 || K <= 0 || gy > 65535 || K > 65535)
        return (int)cudaErrorInvalidValue;
    dim3 grid(gx / TF_BLOCK, K, gy);
    density_kernel<<<grid, TF_BLOCK, 0, stream>>>(
        px, py, vx, vy, occ_row, sc, pres, invr, gy, K, gx, h2, norm, half_x,
        half_y);
    return (int)cudaGetLastError();
}
