// Rebin: re-pack the slot grid by each particle's next predicted cell.
//
// Replaces tpufluid/ops/pallas/fused.py:rebin (_rebin_kernel), which on
// the TPU built per-block exclusive cumsums over 8-slot sublane tiles and
// one-hot selects on lane-rolled rows.
//
// Bound: memory. At scene_1m (Gy 524, K 8, Gxp 512) the kernel reads the
// four input fields (8.6 MB each) and writes four output fields; the
// arithmetic per slot is a handful of flops.
//
// Design: one thread per target cell (row y, column x); a block is 128
// consecutive columns of one row. The thread walks source rows y-1..y+1,
// then dx -1..+1, then source slots ascending below the source row's
// occupancy, recomputes each live slot's clamped predicted cell and
// appends a match to its own next slot. That walk IS the TPU kernel's
// packing order (source row, dx, slot), so the output is bitwise the
// same. Neighbouring threads read neighbouring columns, so every load and
// store is coalesced, and the three source rows a block reads are shared
// through L1/L2 with the blocks of the rows above and below. Rows and
// columns outside the grid are skipped: on the TPU they were the clamped
// or wrapped empty sentinel ring and pad columns.
//
// Batched world stacks: row_shift[y] (null for one world) is row y's
// world offset, negated: a slot's world-frame cell row ncy lands in
// stacked row y when ncy - row_shift[y] == y (fused.py:410-439).
//
// Per-row counters: occ_row' (max of min(count, K)), far_n (far movers of
// the centre source row, counted by the thread that owns their column)
// and over_n (arrivals beyond K) are reduced over the warp and added with
// one integer atomic per warp. Integer atomics commute, so the counts are
// deterministic.
#include "common.cuh"

__global__ void __launch_bounds__(TF_BLOCK)
rebin_kernel(const float* __restrict__ px, const float* __restrict__ py,
             const float* __restrict__ vx, const float* __restrict__ vy,
             const int* __restrict__ occ_row,
             const int* __restrict__ row_shift, const float* __restrict__ dt_p,
             float* __restrict__ opx, float* __restrict__ opy,
             float* __restrict__ ovx, float* __restrict__ ovy,
             int* __restrict__ oocc, int* __restrict__ ofar,
             int* __restrict__ oover, int gy, int K, int gx, float h_inv,
             float half_x, float half_y, int cx_max, int cy_max) {
    const int x = blockIdx.x * TF_BLOCK + threadIdx.x;  // gx % 128 == 0
    const int y = blockIdx.y;
    const float dt = dt_p[0];
    const int shift = row_shift != nullptr ? row_shift[y] : 0;
    int count = 0;
    int far = 0;
    for (int r = -1; r <= 1; ++r) {
        const int sy = y + r;
        if (sy < 0 || sy >= gy) continue;
        const int ns = min(occ_row[sy], K);
        for (int dx = -1; dx <= 1; ++dx) {
            const int sx = x + dx;
            if (sx < 0 || sx >= gx) continue;
            for (int s = 0; s < ns; ++s) {
                const size_t si = tf_index(sy, s, sx, K, gx);
                const float p_x = px[si];
                if (!tf_live(p_x)) continue;
                const float p_y = py[si];
                const float v_x = vx[si];
                const float v_y = vy[si];
                const int ncx = tf_cell(tf_pred(p_x, v_x, dt, half_x),
                                        half_x, h_inv, cx_max);
                const int ncy = tf_cell(tf_pred(p_y, v_y, dt, half_y),
                                        half_y, h_inv, cy_max) -
                                shift;
                if (r == 0 && dx == 0 &&
                    (abs(ncy - y) > 1 || abs(ncx - x) > 1)) {
                    ++far;
                }
                if (ncy == y && ncx == x) {
                    if (count < K) {
                        const size_t oi = tf_index(y, count, x, K, gx);
                        opx[oi] = p_x;
                        opy[oi] = p_y;
                        ovx[oi] = v_x;
                        ovy[oi] = v_y;
                    }
                    ++count;
                }
            }
        }
    }
    for (int s = min(count, K); s < K; ++s) {
        const size_t oi = tf_index(y, s, x, K, gx);
        opx[oi] = TF_SENTINEL;
        opy[oi] = TF_SENTINEL;
        ovx[oi] = 0.0f;
        ovy[oi] = 0.0f;
    }
    const unsigned full = 0xffffffffu;
    const int occ = __reduce_max_sync(full, min(count, K));
    const int far_w = __reduce_add_sync(full, far);
    const int over_w = __reduce_add_sync(full, max(count - K, 0));
    if ((threadIdx.x & 31) == 0) {
        if (occ > 0) atomicMax(&oocc[y], occ);
        if (far_w > 0) atomicAdd(&ofar[y], far_w);
        if (over_w > 0) atomicAdd(&oover[y], over_w);
    }
}

extern "C" int tf_rebin(const float* px, const float* py, const float* vx,
                        const float* vy, const int* occ_row,
                        const int* row_shift, const float* dt,
                        float* opx, float* opy, float* ovx, float* ovy,
                        int* oocc, int* ofar, int* oover, int gy, int K,
                        int gx, float h_inv, float half_x, float half_y,
                        int cx_max, int cy_max, cudaStream_t stream) {
    if (gx % TF_BLOCK != 0 || gy <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
    dim3 grid(gx / TF_BLOCK, gy);
    rebin_kernel<<<grid, TF_BLOCK, 0, stream>>>(
        px, py, vx, vy, occ_row, row_shift, dt, opx, opy, ovx, ovy, oocc, ofar, oover,
        gy, K, gx, h_inv, half_x, half_y, cx_max, cy_max);
    return (int)cudaGetLastError();
}

extern "C" const char* tf_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
