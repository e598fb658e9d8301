// Far-mover re-insertion of the resident step, gated on the device.
//
// Replaces the XLA code that the JAX step runs under
// lax.cond(n_far > 0, do_far, ...) (tpufluid/ops/resident.py:396-462; not
// a Pallas kernel). The rebin (rebin.cu) leaves out of its output every
// far mover (a live slot whose predicted cell lies beyond the 3 x 3 cells
// around its own) and counts them per source row in far_n. This pass puts
// them back: in flat [Gy, K, Gx] slot order of the pre-rebin grid, the
// first far_capacity of them, stably ordered by target cell, each appended
// to its target cell after the slots the rebin filled. A mover that finds
// its cell full is dropped and counted in the step's lost counter.
//
// The gate: both entry points read far_n on the device. When its sum is 0
// every block returns before it writes anything, so the step launches the
// pass every step and never reads a count on the host (the JAX step's
// lax.cond, and what lets a CUDA graph hold the whole step).
//
// Bound on the H100: latency. At n_far == 0 the pass is two launches that
// read far_n (Gy ints) and return. With movers, the bytes are the movers'
// four fields read and written once and, per mover, its target cell's K
// slots read to count the cell's occupancy: kilobytes at scene_1m.
//
// Design:
//   collect (one block of 256 threads per source row): a row without far
//     movers returns at once. Otherwise the block sums far_n over the rows
//     above it (the row's offset into the mover list: an exclusive prefix
//     sum, valid because rebin.cu counts exactly the slots this predicate
//     selects), walks the row's slots below its occupancy in flat order
//     256 at a time, and compacts its movers in that order (a ballot per
//     warp, the warps' counts summed in shared memory), writing each
//     mover's fields and its key (target cell << 32 | list index) at its
//     place in the list; list places at or past far_capacity are not
//     written.
//   insert (one block of 1024 threads): n = min(n_far, far_capacity) keys
//     are sorted (bitonic, over the next power of two; the index in the
//     low bits makes every key distinct, so the order is the stable sort
//     by target cell), in shared memory up to TF_FAR_SMEM_ENTRIES keys
//     (16,384: scene_1m's far_capacity), else in place in the global key
//     list (correct, slower; a step flinging more movers than that is
//     rare). A mover's rank in its cell's run is its distance from the
//     run's first key (a binary search); its slot is the cell's live
//     count on the post-rebin grid plus its rank. Every slot is computed
//     before any is written (the counts read the grid the writes change),
//     then the movers that fit are written, occ_row[y] raised to
//     slot + 1 with an integer atomicMax (the value occ_row_of gives after
//     the inserts: the rebin's occ_row is already its grid's), and one
//     thread adds n_far - fits to lost and 1 to the far-step counter.
// No float is summed: the outputs are bitwise the plain version's
// (ops/resident.py _reinsert_far).
#include "far_common.cuh"

#define TF_FAR_COLLECT_THREADS 256
#define TF_FAR_INSERT_THREADS 1024

__global__ void __launch_bounds__(TF_FAR_COLLECT_THREADS)
far_collect_kernel(const float* __restrict__ px, const float* __restrict__ py,
                   const float* __restrict__ vx, const float* __restrict__ vy,
                   const int* __restrict__ occ_row,
                   const int* __restrict__ far_n,
                   const float* __restrict__ dt_p,
                   unsigned long long* __restrict__ keys,
                   float4* __restrict__ movers, int K, int gx, int rows_w,
                   int grid_w, int cap, float h_inv, float half_x,
                   float half_y, int cx_max, int cy_max) {
    constexpr int NT = TF_FAR_COLLECT_THREADS;
    __shared__ int red[NT / 32];
    const int y = blockIdx.x;
    if (far_n[y] == 0) return;  // the gate (every row, when n_far == 0)
    int part = 0;
    for (int r = threadIdx.x; r < y; r += NT) part += far_n[r];
    int base = tf_far_block_sum<NT>(part, red);
    if (base >= cap) return;
    const float dt = dt_p[0];
    const int n = min(occ_row[y], K) * gx;
    // a batched stack's rows: world-local cell row -> absolute stacked row
    const int row0 = (y / rows_w) * rows_w;
    const int lane = threadIdx.x & 31;
    for (int c0 = 0; c0 < n && base < cap; c0 += NT) {
        const int s = c0 + threadIdx.x;
        bool far = false;
        float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
        int tcell = 0;
        if (s < n) {
            const int k = s / gx, x = s - k * gx;
            const size_t gi = tf_index(y, k, x, K, gx);
            m.x = px[gi];
            if (tf_live(m.x)) {
                m.y = py[gi];
                m.z = vx[gi];
                m.w = vy[gi];
                const int ncx = tf_cell(tf_pred(m.x, m.z, dt, half_x),
                                        half_x, h_inv, cx_max);
                const int ncy = tf_cell(tf_pred(m.y, m.w, dt, half_y),
                                        half_y, h_inv, cy_max) + row0;
                far = abs(ncy - y) > 1 || abs(ncx - x) > 1;
                tcell = ncy * grid_w + ncx;
            }
        }
        const unsigned b = __ballot_sync(0xffffffffu, far);
        const int before = __popc(b & ((1u << lane) - 1u));
        // the warps' counts: an exclusive sum for this warp, and the total
        __syncthreads();
        if (lane == 0) red[threadIdx.x >> 5] = __popc(b);
        __syncthreads();
        int off = 0, total = 0;
        for (int i = 0; i < NT / 32; ++i) {
            const int c = red[i];
            off += i < (int)(threadIdx.x >> 5) ? c : 0;
            total += c;
        }
        const int g = base + off + before;
        if (far && g < cap) {
            keys[g] = (unsigned long long)(unsigned)tcell << 32 | (unsigned)g;
            movers[g] = m;
        }
        base += total;
    }
}

__global__ void __launch_bounds__(TF_FAR_INSERT_THREADS)
far_insert_kernel(const int* __restrict__ far_n,
                  unsigned long long* __restrict__ keys,
                  const float4* __restrict__ movers, int* __restrict__ gslot,
                  float* __restrict__ px, float* __restrict__ py,
                  float* __restrict__ vx, float* __restrict__ vy,
                  int* __restrict__ occ_row, int* __restrict__ lost,
                  long long* __restrict__ far_steps, int gy, int K, int gx,
                  int grid_w, int cap) {
    constexpr int NT = TF_FAR_INSERT_THREADS;
    extern __shared__ unsigned long long skeys[];
    __shared__ int red[NT / 32];
    const int tid = threadIdx.x;
    int part = 0;
    for (int r = tid; r < gy; r += NT) part += far_n[r];
    const int n_far = tf_far_block_sum<NT>(part, red);
    if (n_far == 0) return;  // the gate
    const int n = min(n_far, cap);
    const int n_pad = tf_far_pow2(n);
    const bool in_smem = n_pad <= TF_FAR_SMEM_ENTRIES;
    unsigned long long* buf = in_smem ? skeys : keys;
    int* slots = in_smem ? reinterpret_cast<int*>(skeys + n_pad) : gslot;
    for (int i = tid; i < n_pad; i += NT)
        buf[i] = i < n ? keys[i] : ~0ull;
    __syncthreads();
    tf_far_sort<NT>(buf, n_pad);
    // each mover's slot: its cell's live count plus its rank in the run
    int fit = 0;
    for (int p = tid; p < n; p += NT) {
        const unsigned key = (unsigned)(buf[p] >> 32);
        const int cy = min((int)(key / (unsigned)grid_w), gy - 1);
        const int cx = min((int)(key % (unsigned)grid_w), gx - 1);
        const int slot = tf_far_cell_count(px, cy, cx, K, gx) +
                         tf_far_rank(buf, p);
        slots[p] = slot < K ? slot : -1;
        fit += slot < K;
    }
    fit = tf_far_block_sum<NT>(fit, red);  // also: every count read first
    for (int p = tid; p < n; p += NT) {
        const int slot = slots[p];
        if (slot < 0) continue;
        const unsigned long long e = buf[p];
        const unsigned key = (unsigned)(e >> 32);
        const int cy = min((int)(key / (unsigned)grid_w), gy - 1);
        const int cx = min((int)(key % (unsigned)grid_w), gx - 1);
        const float4 m = movers[(unsigned)e];
        const size_t gi = tf_index(cy, slot, cx, K, gx);
        px[gi] = m.x;
        py[gi] = m.y;
        vx[gi] = m.z;
        vy[gi] = m.w;
        atomicMax(&occ_row[cy], slot + 1);
    }
    if (tid == 0) {
        lost[0] += n_far - fit;
        far_steps[0] += 1;
    }
}

// dynamic shared memory limit set so far
static int kFarSmem;

// Keys the insert pass sorts in shared memory (more sort in global memory).
extern "C" int tf_far_smem_entries() { return TF_FAR_SMEM_ENTRIES; }

// Both passes on the stream. keys: u64[pow2 >= cap], movers: f32[cap][4],
// gslot: i32[pow2 >= cap] (used when the movers do not fit shared memory);
// the post-rebin grids, occ_row and lost are updated in place.
extern "C" int tf_far_reinsert(const float* px0, const float* py0,
                               const float* vx0, const float* vy0,
                               const int* occ_row0, const int* far_n,
                               const float* dt, unsigned long long* keys,
                               float* movers, int* gslot, float* px,
                               float* py, float* vx, float* vy, int* occ_row,
                               int* lost, long long* far_steps, int gy, int K,
                               int gx, int rows_w, int grid_w, int cap,
                               float h_inv, float half_x, float half_y,
                               int cx_max, int cy_max, cudaStream_t stream) {
    if (gy <= 0 || K <= 0 || gx <= 0 || rows_w <= 0 || cap <= 0 ||
        (long long)gy * K * gx > 0x7fffffffLL ||
        (long long)gy * grid_w > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    int n_pad = 1;
    while (n_pad < cap && n_pad < TF_FAR_SMEM_ENTRIES) n_pad <<= 1;
    const int smem = n_pad * (int)(sizeof(unsigned long long) + sizeof(int));
    // raised for any size: the kernel's static shared memory comes on top
    if (smem > kFarSmem) {
        const cudaError_t err = cudaFuncSetAttribute(
            far_insert_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (err != cudaSuccess) return (int)err;
        kFarSmem = smem;
    }
    far_collect_kernel<<<gy, TF_FAR_COLLECT_THREADS, 0, stream>>>(
        px0, py0, vx0, vy0, occ_row0, far_n, dt, keys,
        reinterpret_cast<float4*>(movers), K, gx, rows_w, grid_w, cap, h_inv,
        half_x, half_y, cx_max, cy_max);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    far_insert_kernel<<<1, TF_FAR_INSERT_THREADS, smem, stream>>>(
        far_n, keys, reinterpret_cast<const float4*>(movers), gslot, px, py,
        vx, vy, occ_row, lost, far_steps, gy, K, gx, grid_w, cap);
    return (int)cudaGetLastError();
}
