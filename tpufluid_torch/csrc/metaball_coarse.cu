// Metaball coarse fields: the Gaussian density and speed-weighted fields
// of the fluid surface on a world-aligned lattice of `sup` samples per grid
// cell per axis, read straight off the resident slot grid.
//
// Replaces tpufluid/ops/pallas/render.py:coarse_metaball_fields
// (_coarse_kernel, pallas_call "metaball_coarse_field"). The TPU kernel
// shaded one block of 8 coarse rows per program: it lane-rolled
// cell-expanded source rows by sup*dx and summed 8-slot sub-blocks in
// vector registers.
//
// Bound: the candidate exps. At scene_1m (sup=2, Gy=524, K=8, Gxp=512)
// 1.07M samples each walk 10 source rows x 7 columns x the live slots
// there, some 1e8 live (sample, candidate) pairs of ~9 flops and one exp
// each; the grid (3 fields, 25.7 MB) and the two outputs (8.6 MB) cross
// DRAM about once.
//
// Design: one thread per coarse sample (i, l), 128 consecutive lanes of
// one coarse row per block; pairs of neighbouring threads read the same
// candidate cell, so a warp's candidate loads are coalesced. The candidate
// set is the TPU kernel's exactly: for the 8-row block p = i / 8 the
// source rows r_first = 8p / sup - 3 .. r_first + n_rows - 1 (skipped when
// out of range or empty), 8-slot sub-blocks below the row's occupancy,
// and the columns (l / sup + dx) mod Gxp for dx in -3..3 (the lane roll's
// wrap). Per (row, sub-block, dx) a partial sum starts at 0 and is then
// added to the field, the TPU kernel's order. Empty slots would add
// exp(-1e18 / tau) == 0 exactly, so they are skipped. Built with
// -fmad=false and the accurate expf: every op rounds as in the plain
// PyTorch version.
#include "common.cuh"

#define TF_DX_REACH 3

__global__ void __launch_bounds__(TF_BLOCK)
metaball_coarse_kernel(const float* __restrict__ px,
                       const float* __restrict__ py,
                       const float* __restrict__ sp,
                       const int* __restrict__ occ_row,
                       float* __restrict__ dens, float* __restrict__ velf,
                       int gy, int K, int gx, int sup, int n_rows,
                       float neg_inv_tau, float h_s, float off_x,
                       float off_y) {
    const int l = blockIdx.x * TF_BLOCK + threadIdx.x;  // coarse column
    const int i = blockIdx.y;                           // coarse row
    const int wc = sup * gx;
    const int p = i >> 3;
    // world coords: (lane + 0.5) * h_s - off_x, ((8p + sub) + 0.5) * h_s - off_y
    const float wx = __fsub_rn(__fmul_rn(__fadd_rn((float)l, 0.5f), h_s),
                               off_x);
    const float wy = __fsub_rn(
        __fmul_rn(__fadd_rn(__fadd_rn(8.0f * (float)p, (float)(i & 7)), 0.5f),
                  h_s),
        off_y);
    const int x = l / sup;
    const int r_first = (8 * p) / sup - TF_DX_REACH;
    float d_acc = 0.0f;
    float v_acc = 0.0f;
    for (int j = 0; j < n_rows; ++j) {
        const int rj = r_first + j;
        if (rj < 0 || rj >= gy) continue;
        const int occ = occ_row[rj];
        for (int lo = 0; lo < K && occ > lo; lo += 8) {
            // slots at or beyond the row's occupancy are empty everywhere
            const int kend = min(min(lo + 8, K), occ);
            for (int dx = -TF_DX_REACH; dx <= TF_DX_REACH; ++dx) {
                int col = x + dx;
                if (col < 0) col += gx;
                if (col >= gx) col -= gx;
                float d = 0.0f;
                float v = 0.0f;
                for (int kp = lo; kp < kend; ++kp) {
                    const size_t ci = tf_index(rj, kp, col, K, gx);
                    const float cx = px[ci];
                    if (!tf_live(cx)) continue;
                    const float ddx = cx - wx;
                    const float ddy = py[ci] - wy;
                    const float r2 = ddx * ddx + ddy * ddy;
                    const float c = expf(r2 * neg_inv_tau);
                    d = d + c;
                    v = v + c * sp[ci];
                }
                d_acc = d_acc + d;
                v_acc = v_acc + v;
            }
        }
    }
    const size_t o = (size_t)i * wc + l;
    dens[o] = d_acc;
    velf[o] = v_acc;
}

extern "C" int tf_metaball_coarse(const float* px, const float* py,
                                  const float* sp, const int* occ_row,
                                  float* dens, float* velf, int gy, int K,
                                  int gx, int sup, int n_rows,
                                  float neg_inv_tau, float h_s, float off_x,
                                  float off_y, cudaStream_t stream) {
    const int hc = sup * gy;
    if (gx % TF_BLOCK != 0 || gy <= 0 || K <= 0 || sup <= 0 || hc % 8 != 0 ||
        hc > 65535)
        return (int)cudaErrorInvalidValue;
    dim3 grid(sup * gx / TF_BLOCK, hc);
    metaball_coarse_kernel<<<grid, TF_BLOCK, 0, stream>>>(
        px, py, sp, occ_row, dens, velf, gy, K, gx, sup, n_rows, neg_inv_tau,
        h_s, off_x, off_y);
    return (int)cudaGetLastError();
}
