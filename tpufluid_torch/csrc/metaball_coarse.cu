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
// there, some 3e8 live (sample, candidate) pairs of ~9 flops and one
// accurate expf each (several instructions); the grid (3 fields, 25.7 MB)
// and the two outputs (8.6 MB) cross DRAM about once.
//
// Candidate set (the TPU kernel's exactly): for the 8-row block p the
// source rows r_first = 8p / sup - 3 .. r_first + n_rows - 1 (skipped when
// out of range or empty), 8-slot sub-blocks below the row's occupancy, and
// the columns (l / sup + dx) mod Gxp for dx in -3..3 (the lane roll's
// wrap). Per (row, sub-block, dx) a partial sum starts at 0 and is then
// added to the field, the TPU kernel's order.
//
// Design: one block per 8-row coarse block p and a tile of 64 coarse
// columns, one thread per column and RT of the block's 8 coarse rows,
// holding its samples in registers. The block streams the chunks
// (source row, 8-slot sub-block) in the sum order through two shared
// buffers: while the threads sum one chunk, the next one's px, py and
// speed for the tile's cells and DX_REACH cells either side land by
// cp.async, each staging thread then finds its cells' last live slot of
// the chunk. A thread sums a chunk into its samples per candidate:
// ddx^2 once for its column, then per sample the rest of the pair. So
// each candidate is loaded once per block rather than once by each of the
// 112 samples that read it, a cell's walk stops at its own last
// particle (empty slots would add exp(-1e18 / tau) == 0 exactly, so they
// are skipped), and shared memory does not grow with K. RT = 8 up to
// K = 32; above it, where the capacity has grown for dense clumps and a
// few threads would carry most of the pairs, RT = 2 spreads them over
// four times the threads (8 rows a thread was 1.9x slower on phase 4's
// K=192 grid; PERF.md, PR 6). Built with -fmad=false and the accurate
// expf: every op rounds as in the plain PyTorch version, and the fields
// are bitwise the plain version's at every shape tested.
#include "common.cuh"

#define TF_DX_REACH 3
// coarse columns a block shades
#define TF_COARSE_COLS 64
// coarse rows (of a block's 8) a thread holds: all 8 up to capacity
// TF_COARSE_DENSE_K, else TF_COARSE_ROWS_DENSE (more threads share a dense
// cell's candidates)
#define TF_COARSE_DENSE_K 32
#define TF_COARSE_ROWS_DENSE 2
// cells a chunk stages at most: a tile of sup = 1 and the reach
#define TF_COARSE_CELLS (TF_COARSE_COLS + 2 * TF_DX_REACH)
// source rows of a block at most (n_rows at sup = 1)
#define TF_COARSE_NROWS (7 + 1 + 2 * TF_DX_REACH)

__device__ __forceinline__ void tf_cp_async4(float* smem, const float* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
}

__device__ __forceinline__ void tf_cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void tf_cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int RT>
__global__ void __launch_bounds__(TF_COARSE_COLS * 8 / RT)
metaball_coarse_kernel(const float* __restrict__ px,
                       const float* __restrict__ py,
                       const float* __restrict__ sp,
                       const int* __restrict__ occ_row,
                       float* __restrict__ dens, float* __restrict__ velf,
                       int gy, int K, int gx, int sup, int n_rows,
                       float neg_inv_tau, float h_s, float off_x,
                       float off_y) {
    // two chunk buffers: px, py, speed per (slot, cell), and each cell's
    // last live slot + 1
    __shared__ float cand[2][3][8][TF_COARSE_CELLS];
    __shared__ int cnt[2][TF_COARSE_CELLS];
    __shared__ int socc[TF_COARSE_NROWS];  // source rows' occupancies
    constexpr int THREADS = TF_COARSE_COLS * 8 / RT;
    const int wc = sup * gx;
    const int p = blockIdx.y;
    const int l0 = blockIdx.x * TF_COARSE_COLS;
    const int l = l0 + threadIdx.x % TF_COARSE_COLS;  // coarse column
    const int i0 = threadIdx.x / TF_COARSE_COLS * RT;  // first coarse row
    const bool in = l < wc;
    // the chunk's cells: c_first .. c_first + n_cells - 1 (mod gx)
    const int c_first = l0 / sup - TF_DX_REACH;
    const int n_cells =
        (min(l0 + TF_COARSE_COLS, wc) - 1) / sup - l0 / sup + 1 +
        2 * TF_DX_REACH;
    const int w0 = (in ? l : l0) / sup - l0 / sup;  // cell x - 3, local
    // world coords: (lane + 0.5) * h_s - off_x, ((8p + sub) + 0.5) * h_s - off_y
    const float wx = __fsub_rn(__fmul_rn(__fadd_rn((float)l, 0.5f), h_s),
                               off_x);
    float wy[RT], d_acc[RT], v_acc[RT];
#pragma unroll
    for (int s = 0; s < RT; ++s) {
        wy[s] = __fsub_rn(
            __fmul_rn(__fadd_rn(__fadd_rn(8.0f * (float)p, (float)(i0 + s)),
                                0.5f),
                      h_s),
            off_y);
        d_acc[s] = 0.0f;
        v_acc[s] = 0.0f;
    }
    const int r_first = (8 * p) / sup - TF_DX_REACH;
    if (threadIdx.x < n_rows) {  // slots at or beyond these are empty
        const int rj = r_first + threadIdx.x;
        socc[threadIdx.x] = rj >= 0 && rj < gy ? min(occ_row[rj], K) : 0;
    }
    __syncthreads();

    // the chunks (source row j, 8-slot sub-block lo) in the sum order
    auto next = [&](int& j, int& lo) {
        lo += 8;
        while (j < n_rows && lo >= socc[j]) {
            ++j;
            lo = 0;
        }
    };
    // copy chunk (j, lo) into buffer b, asynchronously
    auto stage = [&](int b, int j, int lo) {
        const int kn = min(8, socc[j] - lo);
        const int rj = r_first + j;
        for (int w = threadIdx.x; w < n_cells; w += THREADS) {
            int col = c_first + w;
            if (col < 0) col += gx;
            if (col >= gx) col -= gx;
            const size_t g0 = tf_index(rj, lo, col, K, gx);
            for (int kk = 0; kk < kn; ++kk) {
                const size_t gi = g0 + (size_t)kk * gx;
                tf_cp_async4(&cand[b][0][kk][w], px + gi);
                tf_cp_async4(&cand[b][1][kk][w], py + gi);
                tf_cp_async4(&cand[b][2][kk][w], sp + gi);
            }
        }
        tf_cp_async_commit();
    };
    // after the copies land: each staged cell's last live slot + 1 (by
    // the thread that copied it)
    auto count = [&](int b, int j, int lo) {
        const int kn = min(8, socc[j] - lo);
        for (int w = threadIdx.x; w < n_cells; w += THREADS) {
            int last = 0;
            for (int kk = 0; kk < kn; ++kk)
                if (tf_live(cand[b][0][kk][w])) last = kk + 1;
            cnt[b][w] = last;
        }
    };

    int j = 0, lo = -8, b = 0;
    next(j, lo);
    if (j < n_rows) {
        stage(0, j, lo);
        tf_cp_async_wait_all();
        count(0, j, lo);
    }
    __syncthreads();
    while (j < n_rows) {
        int jn = j, lon = lo;
        next(jn, lon);
        if (jn < n_rows) stage(b ^ 1, jn, lon);  // lands while we sum
        if (in) {
            for (int dx = 0; dx <= 2 * TF_DX_REACH; ++dx) {
                const int w = w0 + dx;
                const int n = cnt[b][w];
                float d[RT], v[RT];
#pragma unroll
                for (int s = 0; s < RT; ++s) {
                    d[s] = 0.0f;
                    v[s] = 0.0f;
                }
                for (int kk = 0; kk < n; ++kk) {
                    const float cx = cand[b][0][kk][w];
                    if (!tf_live(cx)) continue;
                    const float cy = cand[b][1][kk][w];
                    const float cs = cand[b][2][kk][w];
                    const float ddx = cx - wx;
                    const float ddx2 = ddx * ddx;
#pragma unroll
                    for (int s = 0; s < RT; ++s) {
                        const float ddy = cy - wy[s];
                        const float r2 = ddx2 + ddy * ddy;
                        const float c = expf(r2 * neg_inv_tau);
                        d[s] = d[s] + c;
                        v[s] = v[s] + c * cs;
                    }
                }
#pragma unroll
                for (int s = 0; s < RT; ++s) {
                    d_acc[s] = d_acc[s] + d[s];
                    v_acc[s] = v_acc[s] + v[s];
                }
            }
        }
        if (jn < n_rows) {
            tf_cp_async_wait_all();
            count(b ^ 1, jn, lon);
        }
        __syncthreads();
        j = jn;
        lo = lon;
        b ^= 1;
    }
    if (!in) return;
#pragma unroll
    for (int s = 0; s < RT; ++s) {
        const size_t o = (size_t)(8 * p + i0 + s) * wc + l;
        dens[o] = d_acc[s];
        velf[o] = v_acc[s];
    }
}

template <int RT>
static cudaError_t launch_coarse(dim3 grid, cudaStream_t stream,
                                 const float* px, const float* py,
                                 const float* sp, const int* occ_row,
                                 float* dens, float* velf, int gy, int K,
                                 int gx, int sup, int n_rows,
                                 float neg_inv_tau, float h_s, float off_x,
                                 float off_y) {
    metaball_coarse_kernel<RT><<<grid, TF_COARSE_COLS * 8 / RT, 0, stream>>>(
        px, py, sp, occ_row, dens, velf, gy, K, gx, sup, n_rows, neg_inv_tau,
        h_s, off_x, off_y);
    return cudaGetLastError();
}

extern "C" int tf_metaball_coarse(const float* px, const float* py,
                                  const float* sp, const int* occ_row,
                                  float* dens, float* velf, int gy, int K,
                                  int gx, int sup, int n_rows,
                                  float neg_inv_tau, float h_s, float off_x,
                                  float off_y, cudaStream_t stream) {
    const int hc = sup * gy;
    if (gx <= 0 || gy <= 0 || K <= 0 || sup <= 0 || 8 % sup != 0 ||
        hc % 8 != 0 || hc / 8 > 65535 || n_rows > TF_COARSE_NROWS)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((sup * gx + TF_COARSE_COLS - 1) / TF_COARSE_COLS,
                    hc / 8);
    const cudaError_t err =
        K <= TF_COARSE_DENSE_K
            ? launch_coarse<8>(grid, stream, px, py, sp, occ_row, dens, velf,
                               gy, K, gx, sup, n_rows, neg_inv_tau, h_s,
                               off_x, off_y)
            : launch_coarse<TF_COARSE_ROWS_DENSE>(
                  grid, stream, px, py, sp, occ_row, dens, velf, gy, K, gx,
                  sup, n_rows, neg_inv_tau, h_s, off_x, off_y);
    return (int)err;
}
