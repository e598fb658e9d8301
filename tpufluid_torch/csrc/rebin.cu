// Rebin: re-pack the slot grid by each particle's next predicted cell.
//
// Replaces tpufluid/ops/pallas/fused.py:rebin (_rebin_kernel), which on
// the TPU built per-block exclusive cumsums over 8-slot sublane tiles and
// one-hot selects on lane-rolled rows.
//
// Bound: memory. At scene_1m (Gy 524, K 8, Gxp 512) the kernel reads the
// four input fields below each row's occupancy and writes all K slots of
// four output fields; the arithmetic is 14 flops a live particle.
//
// Design: one block of 256 threads per tile of R x C target cells with all
// K slots (tf_resident_tile picks the tile from K so that it fits shared
// memory, as for density.cu and forces.cu).
//   S: the tile's +-1 halo is read once (tf_stage_halo): per slot below
//      its row's occupancy the clamped predicted cell, computed once and
//      packed as ncx | ncy << 16 into shared memory (-1 for an empty
//      slot), and each halo cell's occupancy (last live slot + 1). Far
//      movers of a centre cell (a predicted cell beyond the 3 x 3
//      neighbourhood) are counted here, so each by the one block whose
//      tile owns its source cell.
//   W: L = 256 / (R C) lanes per target cell (1 at K=8, up to a warp)
//      walk its 3 x 3 source cells in (source row, dx, slot) order, each
//      cell below its own occupancy, L slots at a time: a ballot of the
//      matches and its prefix popcount give each arrival its packed slot,
//      so the packing is the TPU kernel's order, bitwise. The first K
//      arrivals' grid slots are listed per target, slot-major.
//   O: all threads write the tile's K output slots per cell, slot-major
//      (lanes on neighbouring columns: coalesced): a listed arrival's four
//      fields, gathered from the grid (the staging just read them, so
//      mostly from L1/L2), else SENTINEL / 0.
// So each source slot is loaded and predicted once per block rather than
// once by each of the nine target cells that read it, no walk runs past a
// cell's last particle, and at 4 bytes a staged slot the shared memory
// leaves room for 7-8 blocks an SM (staging the four fields beside the
// cell was slower at every K timed on the H100: PERF.md, PR 6).
//
// Batched world stacks: row_shift[y] (null for one world) is row y's
// world offset, negated: a slot's world-frame cell row ncy lands in
// stacked row y when ncy - row_shift[y] == y (fused.py:410-439); a far
// mover is judged in its own row's frame.
//
// Per-row counters: occ_row' (max of min(count, K)) and over_n (arrivals
// beyond K) are reduced over the lanes of one row in a warp and added
// with integer atomics; far_n with one shared integer atomic per far
// mover. Integer atomics commute, so the counts are deterministic.
#include "resident_math.cuh"

// shared memory a staged slot takes: its packed cell
#define TF_REBIN_SLOT_BYTES 4

__global__ void __launch_bounds__(TF_TILE_THREADS)
rebin_kernel(const float* __restrict__ px, const float* __restrict__ py,
             const float* __restrict__ vx, const float* __restrict__ vy,
             const int* __restrict__ occ_row,
             const int* __restrict__ row_shift, const float* __restrict__ dt_p,
             float* __restrict__ opx, float* __restrict__ opy,
             float* __restrict__ ovx, float* __restrict__ ovy,
             int* __restrict__ oocc, int* __restrict__ ofar,
             int* __restrict__ oover, int gy, int K, int gx, int lgR,
             int lgC, float h_inv, float half_x, float half_y, int cx_max,
             int cy_max) {
    extern __shared__ float4 smem4[];
    const int R = 1 << lgR, C = 1 << lgC;
    const int HR = R + 2, HC = C + 2;
    const int RC = R * C;
    const int n_h = HR * K * HC;
    int* scell = reinterpret_cast<int*>(smem4);  // ncx | ncy << 16, or -1
    const TfTileSmem t =
        tf_tile_smem(reinterpret_cast<float2*>(scell + n_h), K, R, C);
    const int y0 = blockIdx.y * R;
    const int x0 = blockIdx.x * C;
    tf_tile_begin(t, occ_row, nullptr, dt_p, 1, 0, R, C, K, y0, gy);
    const float dt = dt_p[0];

    // S: predicted cells of the +-1 halo; centre far movers
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
            const int s = (lr * K + kk) * HC + lc;
            if (!tf_live(ax[u])) {
                scell[s] = -1;
                return;
            }
            const int ncx = tf_cell(tf_pred(ax[u], ux[u], dt, half_x),
                                    half_x, h_inv, cx_max);
            const int ncy = tf_cell(tf_pred(ay[u], uy[u], dt, half_y),
                                    half_y, h_inv, cy_max);
            scell[s] = ncx | ncy << 16;
            atomicMax(&t.socc[lr * HC + lc], kk + 1);
            if (lr >= 1 && lr <= R && lc >= 1 && lc <= C) {
                const int sy = y0 + lr - 1;
                const int sx = x0 + lc - 1;
                const int sh = row_shift != nullptr ? row_shift[sy] : 0;
                if (abs(ncy - sh - sy) > 1 || abs(ncx - sx) > 1)
                    atomicAdd(&ofar[sy], 1);
            }
        });

    // W: each target cell's arrivals in packing order, L lanes a target.
    // Every lane of a warp runs each cell's loop to the warp's largest
    // count, and ballots over the whole warp: a ballot over only a team's
    // lanes would split the warp into its teams.
    const int L = min(32, max(1, TF_TILE_THREADS >> (lgR + lgC)));
    const int lane = threadIdx.x & 31;
    const int j = lane & (L - 1);
    const unsigned team = L == 32 ? 0xffffffffu
                                  : ((1u << L) - 1u) << (lane & ~(L - 1));
    const unsigned below = (1u << lane) - 1u;
    const int tg = threadIdx.x / L;  // RC * L <= 256: one target a team
    const int tr = tg >> lgC, tc = tg & (C - 1);
    const bool has_t = tg < RC && y0 + tr < gy;
    // the packed cell that lands here: (x, y) in the target row's world
    // frame; none when that row is outside the cell range
    const int cy = y0 + tr + (has_t && row_shift != nullptr
                                  ? row_shift[y0 + tr] : 0);
    const int code = cy >= 1 && cy <= cy_max ? (x0 + tc) | cy << 16 : -2;
    int cnt = 0;
    for (int r = 0; r < 3; ++r) {
        for (int dx = 0; dx < 3; ++dx) {
            const int n = has_t ? t.socc[(tr + r) * HC + tc + dx] : 0;
            const int n_w = __reduce_max_sync(0xffffffffu, n);
            const int base = (tr + r) * K * HC + tc + dx;
            for (int s0 = 0; s0 < n_w; s0 += L) {
                const int s = s0 + j;
                const bool m = s < n && scell[base + s * HC] == code;
                const unsigned b = __ballot_sync(0xffffffffu, m) & team;
                if (m) {
                    const int pos = cnt + __popc(b & below);
                    if (pos < K)
                        t.list[pos * RC + tg] = (int)tf_index(
                            y0 + tr + r - 1, s, x0 + tc + dx - 1, K, gx);
                }
                cnt += __popc(b);
            }
        }
    }
    __syncthreads();
    // the halo occupancies are read: the arrival counts take their place
    int* scnt = t.socc;
    if (j == 0 && tg < RC) scnt[tg] = cnt;
    __syncthreads();

    // O: the tile's output slots, slot-major
    for (int i = threadIdx.x; i < RC * K; i += TF_TILE_THREADS) {
        const int c = i & (RC - 1);
        const int y = y0 + (c >> lgC);
        if (y >= gy) continue;
        const size_t oi = tf_index(y, i >> (lgR + lgC), x0 + (c & (C - 1)),
                                   K, gx);
        if ((i >> (lgR + lgC)) < scnt[c]) {
            const int gi = t.list[i];
            opx[oi] = px[gi];
            opy[oi] = py[gi];
            ovx[oi] = vx[gi];
            ovy[oi] = vy[gi];
        } else {
            opx[oi] = TF_SENTINEL;
            opy[oi] = TF_SENTINEL;
            ovx[oi] = 0.0f;
            ovy[oi] = 0.0f;
        }
    }

    // per-row counters over the lanes of one row (min(C, 32) lanes)
    const int G = min(C, 32);
    for (int i0 = 0; i0 < RC; i0 += TF_TILE_THREADS) {
        const int i = i0 + threadIdx.x;
        const bool ok = i < RC && y0 + (i >> lgC) < gy;
        const int c = ok ? scnt[i] : 0;
        int occ = min(c, K);
        int over = max(c - K, 0);
        for (int off = 1; off < G; off <<= 1) {
            occ = max(occ, __shfl_xor_sync(0xffffffffu, occ, off));
            over += __shfl_xor_sync(0xffffffffu, over, off);
        }
        if (ok && (lane & (G - 1)) == 0) {
            const int y = y0 + (i >> lgC);
            if (occ > 0) atomicMax(&oocc[y], occ);
            if (over > 0) atomicAdd(&oover[y], over);
        }
    }
}

// dynamic shared memory limit set so far
static int kRebinSmem;

// The tile tf_rebin runs at capacity K as rows << 8 | columns; 0 when
// none fits shared memory.
extern "C" int tf_rebin_tile(int K) {
    int lgR, lgC;
    if (K <= 0 || !tf_resident_tile(TF_REBIN_SLOT_BYTES, TF_REBIN_SLOTS, K, lgR, lgC))
        return 0;
    return (1 << lgR) << 8 | (1 << lgC);
}

extern "C" int tf_rebin(const float* px, const float* py, const float* vx,
                        const float* vy, const int* occ_row,
                        const int* row_shift, const float* dt,
                        float* opx, float* opy, float* ovx, float* ovy,
                        int* oocc, int* ofar, int* oover, int gy, int K,
                        int gx, float h_inv, float half_x, float half_y,
                        int cx_max, int cy_max, cudaStream_t stream) {
    int lgR = 0, lgC = 0;
    // the packed cell holds a column and a row below 2^15 each, the
    // gathered slot index fits an int
    if (gy <= 0 || K <= 0 || gx > 32767 || cy_max > 32767 ||
        (long long)gy * K * gx > 0x7fffffffLL ||
        !tf_resident_tile(TF_REBIN_SLOT_BYTES, TF_REBIN_SLOTS, K, lgR, lgC) ||
        gx % (1 << lgC) != 0 || (gy + (1 << lgR) - 1) >> lgR > 65535)
        return (int)cudaErrorInvalidValue;
    const long long smem = tf_tile_smem_bytes(TF_REBIN_SLOT_BYTES, K, 1 << lgR, 1 << lgC);
    if (smem > kRebinSmem && smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            rebin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        kRebinSmem = (int)smem;
    }
    dim3 grid(gx >> lgC, (gy + (1 << lgR) - 1) >> lgR);
    rebin_kernel<<<grid, TF_TILE_THREADS, (size_t)smem, stream>>>(
        px, py, vx, vy, occ_row, row_shift, dt, opx, opy, ovx, ovy, oocc,
        ofar, oover, gy, K, gx, lgR, lgC, h_inv, half_x, half_y, cx_max,
        cy_max);
    return (int)cudaGetLastError();
}

extern "C" const char* tf_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
