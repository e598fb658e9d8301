// Rebin with a valid mask: the round-1 re-binning kernel, which re-packs
// the slot grid by each valid slot's next predicted cell.
//
// Replaces tpufluid/ops/pallas/rebin.py:rebin (_rebin_kernel, _cells_of).
// On the TPU one program per target row rolled the three source rows'
// fields by dx across the lanes and placed each candidate slot with a
// one-hot (K, Gx) select per field.
//
// Bound: memory. The kernel reads five input fields and writes six, each
// f32[Gy][K][Gx]; per valid slot it does a handful of flops (prediction,
// cell), ~14 per visit.
//
// Design: one thread per target cell (row y, column x), 128 consecutive
// columns of one row per block. The thread walks source rows y-1..y+1
// (a row outside the grid is skipped), then dx -1..+1 over column
// (x + dx) mod Gx (the TPU lane roll wraps), then the K slots ascending,
// recomputes each valid slot's clamped predicted cell with the same f32
// roundings as _cells_of (tf_pred, tf_cell) and appends a match to its own
// next output slot while the count is below K: that walk is the TPU
// kernel's packing order. Each written value is 0 + value, as the TPU
// kernel's one-hot accumulation makes it (a -0.0 velocity reads +0.0).
// The thread then zeroes its slots from the count on, and writes lost'
// (its source cell's valid far movers plus the arrivals beyond K, times
// the f32 1/K) into all K slots. Neighbouring threads read and write
// neighbouring columns, so every access is coalesced; the three source
// rows of a block are shared through L1/L2 with the rows above and below.
#include "common.cuh"

__global__ void __launch_bounds__(TF_BLOCK)
rebin_valid_kernel(const float* __restrict__ px, const float* __restrict__ py,
                   const float* __restrict__ vx, const float* __restrict__ vy,
                   const float* __restrict__ val,
                   const float* __restrict__ dt_p, float* __restrict__ opx,
                   float* __restrict__ opy, float* __restrict__ ovx,
                   float* __restrict__ ovy, float* __restrict__ oval,
                   float* __restrict__ olost, int gy, int K, int gx,
                   float h_inv, float half_x, float half_y, int cx_max,
                   int cy_max, float inv_k) {
    const int x = blockIdx.x * TF_BLOCK + threadIdx.x;  // gx % 128 == 0
    const int y = blockIdx.y;
    const float dt = dt_p[0];
    int count = 0;
    int far = 0;
    for (int r = -1; r <= 1; ++r) {
        const int sy = y + r;
        if (sy < 0 || sy >= gy) continue;
        for (int dx = -1; dx <= 1; ++dx) {
            const int sx = (x + dx + gx) % gx;
            for (int s = 0; s < K; ++s) {
                const size_t si = tf_index(sy, s, sx, K, gx);
                if (!(val[si] > 0.0f)) continue;
                const float p_x = px[si];
                const float p_y = py[si];
                const float v_x = vx[si];
                const float v_y = vy[si];
                const int ncx = tf_cell(tf_pred(p_x, v_x, dt, half_x),
                                        half_x, h_inv, cx_max);
                const int ncy = tf_cell(tf_pred(p_y, v_y, dt, half_y),
                                        half_y, h_inv, cy_max);
                if (r == 0 && dx == 0 &&
                    (abs(ncy - y) > 1 || abs(ncx - x) > 1)) {
                    ++far;
                }
                if (ncy == y && ncx == x) {
                    if (count < K) {
                        const size_t oi = tf_index(y, count, x, K, gx);
                        opx[oi] = __fadd_rn(0.0f, p_x);
                        opy[oi] = __fadd_rn(0.0f, p_y);
                        ovx[oi] = __fadd_rn(0.0f, v_x);
                        ovy[oi] = __fadd_rn(0.0f, v_y);
                        oval[oi] = 1.0f;
                    }
                    ++count;
                }
            }
        }
    }
    for (int s = min(count, K); s < K; ++s) {
        const size_t oi = tf_index(y, s, x, K, gx);
        opx[oi] = 0.0f;
        opy[oi] = 0.0f;
        ovx[oi] = 0.0f;
        ovy[oi] = 0.0f;
        oval[oi] = 0.0f;
    }
    // counts below 2^24 are exact in f32, as the TPU kernel's f32 sums
    const float lost = __fmul_rn((float)(far + max(count - K, 0)), inv_k);
    for (int s = 0; s < K; ++s) olost[tf_index(y, s, x, K, gx)] = lost;
}

extern "C" int tf_rebin_valid(const float* px, const float* py,
                              const float* vx, const float* vy,
                              const float* val, const float* dt, float* opx,
                              float* opy, float* ovx, float* ovy, float* oval,
                              float* olost, int gy, int K, int gx,
                              float h_inv, float half_x, float half_y,
                              int cx_max, int cy_max, float inv_k,
                              cudaStream_t stream) {
    if (gx % TF_BLOCK != 0 || gy <= 0 || gy > 65535 || K <= 0)
        return (int)cudaErrorInvalidValue;
    dim3 grid(gx / TF_BLOCK, gy);
    rebin_valid_kernel<<<grid, TF_BLOCK, 0, stream>>>(
        px, py, vx, vy, val, dt, opx, opy, ovx, ovy, oval, olost, gy, K, gx,
        h_inv, half_x, half_y, cx_max, cy_max, inv_k);
    return (int)cudaGetLastError();
}
