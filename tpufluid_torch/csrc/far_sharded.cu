// Far-mover pass of the row-band sharded resident step, gated on the
// device.
//
// Replaces the XLA code that the JAX sharded step runs under
// lax.cond(psum(n_far) > 0, do_far, no_far) (tpufluid/parallel/shard.py:
// 658-731; not a Pallas kernel). Band d holds global rows [row_off,
// row_off + rloc) of the slot grid. The band's rebin (rebin.cu with a row
// shift, on the band plus one pad row each side) leaves out every far
// mover (a live slot whose predicted cell lies beyond the 3 x 3 cells
// around its own) and counts them per source row in far_n. Two entry
// points, each launched every step on every band, with an all_gather of
// the packets between them (a concatenation on one card):
//
//   collect: band d's far movers of the pre-rebin band, in flat
//     [rloc, K, Gx] slot order, into a packet of far_capacity rows of
//     (pos_x, pos_y, vel_x, vel_y, valid) f32; the rows past the band's
//     count are zero; pk_drop = the movers that did not fit.
//   insert: of the gathered [D * far_capacity, 5] rows, those valid whose
//     target row lies in the band, stably ordered by their band-local
//     cell (target row - row_off) * grid_w + target column, each appended
//     to its cell after the slots the post-merge band holds; a mover that
//     finds its cell full is dropped. lost += movers of the band that
//     found no room + pk_drop.
//
// The gate: both entry points read total (the psum of every band's far_n,
// an i32 on the band's device) and return before they write anything when
// it is 0, so the sharded step never reads a count on the host (the JAX
// step's lax.cond, and what lets a CUDA graph hold the whole step).
//
// Bound on the H100: latency. With total == 0 each is one launch that
// reads one int. With movers: collect reads the band's four fields below
// occupancy in the rows that hold movers and writes the packet; insert
// reads the gathered rows' valid flags, the band's movers' fields, each
// mover's target cell's K slots, and writes the movers' four fields.
//
// Design:
//   collect (one block of 256 threads per band row, then enough blocks to
//     clear the packet's tail): a row block returns at once when its row
//     has no far mover. Otherwise it sums far_n over the rows above it
//     (its offset into the packet: an exclusive prefix sum, valid because
//     the rebin with a row shift counts exactly the slots this predicate
//     selects), walks the row's slots below its occupancy 256 at a time
//     and compacts its movers in that order (a ballot per warp, the warps'
//     counts summed in shared memory). The tail blocks sum far_n over the
//     band, zero the packet rows from min(count, far_capacity) on, and
//     the first writes pk_drop.
//   insert (one block of 1024 threads): counts the band's movers among the
//     gathered rows, then compacts their keys (local cell << 32 | gathered
//     index; distinct, so the sort is the stable sort by cell with ties in
//     gathered order) with a shared counter, and sorts only those (bitonic,
//     in shared memory up to TF_FAR_SMEM_ENTRIES keys, else in place in a
//     global key list). A mover's slot is its cell's live count on the
//     post-merge band plus its rank in the cell's run. Every slot is
//     computed before any is written (the counts read the grid the writes
//     change); the movers that fit are written, occ_row[y] raised to
//     slot + 1 with an integer atomicMax (occ_row_of of the result: the
//     post-merge occ_row is its band's, the merged edge rows included).
// No float is summed: the outputs are bitwise the plain versions'
// (ops/far_sharded.py far_packet_plain, insert_far_plain).
#include "far_common.cuh"

#define TF_FAR_BAND_COLLECT_THREADS 256
#define TF_FAR_BAND_INSERT_THREADS 1024
#define TF_FAR_PACKET_W 5

__global__ void __launch_bounds__(TF_FAR_BAND_COLLECT_THREADS)
far_band_collect_kernel(const float* __restrict__ px,
                        const float* __restrict__ py,
                        const float* __restrict__ vx,
                        const float* __restrict__ vy,
                        const int* __restrict__ occ_row,
                        const int* __restrict__ far_n,
                        const int* __restrict__ total,
                        const float* __restrict__ dt_p,
                        float* __restrict__ packet, int* __restrict__ pk_drop,
                        int rloc, int K, int gx, int row_off, int cap,
                        float h_inv, float half_x, float half_y, int cx_max,
                        int cy_max) {
    constexpr int NT = TF_FAR_BAND_COLLECT_THREADS;
    __shared__ int red[NT / 32];
    if (total[0] == 0) return;  // the gate
    const int b = blockIdx.x;
    if (b >= rloc) {  // the packet's tail and the drop count
        int part = 0;
        for (int r = threadIdx.x; r < rloc; r += NT) part += far_n[r];
        const int n_band = tf_far_block_sum<NT>(part, red);
        if (b == rloc && threadIdx.x == 0) pk_drop[0] = max(n_band - cap, 0);
        const int stride = (gridDim.x - rloc) * NT;
        for (int r = min(n_band, cap) + (b - rloc) * NT + threadIdx.x;
             r < cap; r += stride)
            for (int f = 0; f < TF_FAR_PACKET_W; ++f)
                packet[(size_t)r * TF_FAR_PACKET_W + f] = 0.f;
        return;
    }
    const int y = b;
    if (far_n[y] == 0) return;
    int part = 0;
    for (int r = threadIdx.x; r < y; r += NT) part += far_n[r];
    int base = tf_far_block_sum<NT>(part, red);
    if (base >= cap) return;
    const float dt = dt_p[0];
    const int gy_glob = y + row_off;
    const int n = min(occ_row[y], K) * gx;
    const int lane = threadIdx.x & 31;
    for (int c0 = 0; c0 < n && base < cap; c0 += NT) {
        const int s = c0 + threadIdx.x;
        bool far = false;
        float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
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
                                        half_y, h_inv, cy_max);
                far = abs(ncy - gy_glob) > 1 || abs(ncx - x) > 1;
            }
        }
        const unsigned bal = __ballot_sync(0xffffffffu, far);
        const int before = __popc(bal & ((1u << lane) - 1u));
        // the warps' counts: an exclusive sum for this warp, and the total
        __syncthreads();
        if (lane == 0) red[threadIdx.x >> 5] = __popc(bal);
        __syncthreads();
        int off = 0, sum = 0;
        for (int i = 0; i < NT / 32; ++i) {
            const int c = red[i];
            off += i < (int)(threadIdx.x >> 5) ? c : 0;
            sum += c;
        }
        const int g = base + off + before;
        if (far && g < cap) {
            float* row = packet + (size_t)g * TF_FAR_PACKET_W;
            row[0] = m.x;
            row[1] = m.y;
            row[2] = m.z;
            row[3] = m.w;
            row[4] = 1.f;
        }
        base += sum;
    }
}

// The band-local cell of gathered row i when it is valid and its target
// row lies in the band, else -1.
__device__ __forceinline__ int tf_far_band_cell(
        const float* __restrict__ allp, int i, float dt, int rloc,
        int row_off, int grid_w, float h_inv, float half_x, float half_y,
        int cx_max, int cy_max) {
    const float* row = allp + (size_t)i * TF_FAR_PACKET_W;
    if (!(row[4] > 0.5f)) return -1;
    const int gcy = tf_cell(tf_pred(row[1], row[3], dt, half_y), half_y,
                            h_inv, cy_max);
    if (gcy < row_off || gcy >= row_off + rloc) return -1;
    const int gcx = tf_cell(tf_pred(row[0], row[2], dt, half_x), half_x,
                            h_inv, cx_max);
    return (gcy - row_off) * grid_w + gcx;
}

__global__ void __launch_bounds__(TF_FAR_BAND_INSERT_THREADS)
far_band_insert_kernel(const float* __restrict__ allp, int m,
                       const int* __restrict__ total,
                       const int* __restrict__ pk_drop,
                       const float* __restrict__ dt_p,
                       unsigned long long* __restrict__ keys,
                       int* __restrict__ gslot, int smem_entries,
                       float* __restrict__ px, float* __restrict__ py,
                       float* __restrict__ vx, float* __restrict__ vy,
                       int* __restrict__ occ_row, int* __restrict__ lost,
                       int rloc, int K, int gx, int row_off, int grid_w,
                       float h_inv, float half_x, float half_y, int cx_max,
                       int cy_max) {
    constexpr int NT = TF_FAR_BAND_INSERT_THREADS;
    extern __shared__ unsigned long long skeys[];
    __shared__ int red[NT / 32];
    __shared__ int fill;
    if (total[0] == 0) return;  // the gate
    const int tid = threadIdx.x;
    const float dt = dt_p[0];
    int part = 0;
    for (int i = tid; i < m; i += NT)
        part += tf_far_band_cell(allp, i, dt, rloc, row_off, grid_w, h_inv,
                                 half_x, half_y, cx_max, cy_max) >= 0;
    const int n = tf_far_block_sum<NT>(part, red);
    const int n_pad = tf_far_pow2(n);
    const bool in_smem = n_pad <= smem_entries;
    unsigned long long* buf = in_smem ? skeys : keys;
    int* slots = in_smem ? reinterpret_cast<int*>(skeys + n_pad) : gslot;
    if (tid == 0) fill = 0;
    __syncthreads();
    for (int i = tid; i < m; i += NT) {
        const int c = tf_far_band_cell(allp, i, dt, rloc, row_off, grid_w,
                                       h_inv, half_x, half_y, cx_max, cy_max);
        if (c >= 0)
            buf[atomicAdd(&fill, 1)] =
                (unsigned long long)(unsigned)c << 32 | (unsigned)i;
    }
    for (int i = n + tid; i < n_pad; i += NT) buf[i] = ~0ull;
    __syncthreads();
    tf_far_sort<NT>(buf, n_pad);
    // each mover's slot: its cell's live count plus its rank in the run
    int fit = 0;
    for (int p = tid; p < n; p += NT) {
        const unsigned key = (unsigned)(buf[p] >> 32);
        const int cy = (int)(key / (unsigned)grid_w);
        const int cx = (int)(key % (unsigned)grid_w);
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
        const int cy = (int)(key / (unsigned)grid_w);
        const int cx = (int)(key % (unsigned)grid_w);
        const float* row = allp + (size_t)(unsigned)e * TF_FAR_PACKET_W;
        const size_t gi = tf_index(cy, slot, cx, K, gx);
        px[gi] = row[0];
        py[gi] = row[1];
        vx[gi] = row[2];
        vy[gi] = row[3];
        atomicMax(&occ_row[cy], slot + 1);
    }
    if (tid == 0) lost[0] += n - fit + pk_drop[0];
}

static bool tf_far_band_args_ok(int rloc, int K, int gx, int cap) {
    return rloc > 0 && K > 0 && gx > 0 && cap > 0 &&
           (long long)rloc * K * gx <= 0x7fffffffLL &&
           (long long)cap * TF_FAR_PACKET_W <= 0x7fffffffLL;
}

// The collect pass on the stream. The band's pre-rebin grids f32[rloc][K]
// [gx] and occ_row i32[rloc]; far_n: i32[rloc], the band's rows of the
// padded rebin's count; total: i32[1]; packet: f32[cap][5]; pk_drop:
// i32[1]. Neither output is written when *total == 0.
extern "C" int tf_far_band_collect(const float* px, const float* py,
                                   const float* vx, const float* vy,
                                   const int* occ_row, const int* far_n,
                                   const int* total, const float* dt,
                                   float* packet, int* pk_drop, int rloc,
                                   int K, int gx, int row_off, int cap,
                                   float h_inv, float half_x, float half_y,
                                   int cx_max, int cy_max,
                                   cudaStream_t stream) {
    if (!tf_far_band_args_ok(rloc, K, gx, cap) || row_off < 0)
        return (int)cudaErrorInvalidValue;
    const int tail = (cap + TF_FAR_BAND_COLLECT_THREADS - 1) /
                     TF_FAR_BAND_COLLECT_THREADS;
    far_band_collect_kernel<<<rloc + tail, TF_FAR_BAND_COLLECT_THREADS, 0,
                              stream>>>(
        px, py, vx, vy, occ_row, far_n, total, dt, packet, pk_drop, rloc, K,
        gx, row_off, cap, h_inv, half_x, half_y, cx_max, cy_max);
    return (int)cudaGetLastError();
}

// dynamic shared memory limit set so far
static int kFarBandSmem;

// The insert pass on the stream. allp: f32[m][5], the gathered packets;
// total, pk_drop: i32[1]; keys: u64[pow2 >= m], gslot: i32[pow2 >= m]
// (used when the band's movers do not fit shared memory; else any size);
// the post-merge band grids, occ_row i32[rloc] and lost i32[1] are
// updated in place, and not written when *total == 0.
extern "C" int tf_far_band_insert(const float* allp, int m, const int* total,
                                  const int* pk_drop, const float* dt,
                                  unsigned long long* keys, int* gslot,
                                  float* px, float* py, float* vx, float* vy,
                                  int* occ_row, int* lost, int rloc, int K,
                                  int gx, int row_off, int grid_w,
                                  float h_inv, float half_x, float half_y,
                                  int cx_max, int cy_max,
                                  cudaStream_t stream) {
    if (!tf_far_band_args_ok(rloc, K, gx, m) || row_off < 0 ||
        (long long)rloc * grid_w > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const int entries = min(tf_far_pow2(m), TF_FAR_SMEM_ENTRIES);
    const int smem =
        entries * (int)(sizeof(unsigned long long) + sizeof(int));
    // raised for any size: the kernel's static shared memory comes on top
    if (smem > kFarBandSmem) {
        const cudaError_t err = cudaFuncSetAttribute(
            far_band_insert_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        kFarBandSmem = smem;
    }
    far_band_insert_kernel<<<1, TF_FAR_BAND_INSERT_THREADS, smem, stream>>>(
        allp, m, total, pk_drop, dt, keys, gslot, entries, px, py, vx, vy,
        occ_row, lost, rloc, K, gx, row_off, grid_w, h_inv, half_x, half_y,
        cx_max, cy_max);
    return (int)cudaGetLastError();
}
