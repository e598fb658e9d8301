// Rebin with a valid mask: the round-1 re-binning kernel, which re-packs
// the slot grid by each valid slot's next predicted cell.
//
// Replaces tpufluid/ops/pallas/rebin.py:rebin (_rebin_kernel, _cells_of).
// On the TPU one program per target row rolled the three source rows'
// fields by dx across the lanes and placed each candidate slot with a
// one-hot (K, Gx) select per field.
//
// Bound: memory. The kernel reads the valid mask whole and the four
// fields at its valid slots, and writes six fields, each f32[Gy][K][Gx];
// per valid slot it does 14 flops (prediction, cell).
//
// Design: one block of 256 threads per tile of R x C target cells with all
// K slots (tf_pick_tile picks the tile from K, capped at
// TF_REBIN_VALID_SLOTS target slots; tf_rebin_valid_tile reports it), as
// rebin.cu does for the sentinel grid:
//   S: the tile's +-1 halo is read once (tf_stage_halo; rows and columns
//      outside the grid skipped): the valid flag of every slot (the mask
//      is no prefix: a slot with valid_f == 0 may sit below valid ones and
//      hold stale data), and at a valid slot the four fields, whose
//      clamped predicted cell is packed as ncx | ncy << 16 into shared
//      memory (-1 for an invalid slot), with each halo cell's last valid
//      slot + 1. A centre cell's valid far movers (a predicted cell beyond
//      the 3 x 3 neighbourhood) are counted here, by the one block whose
//      tile owns the source cell.
//   W: L = 256 / (R C) lanes per target cell walk its 3 x 3 source cells
//      in the packing order (source row y-1..y+1, dx -1..+1, slot
//      ascending), each cell below its last valid slot, L slots at a time:
//      a whole-warp ballot of the matches and its prefix popcount give
//      each arrival its packed slot. The first K arrivals' grid slots are
//      listed per target, slot-major.
//   O: all threads write the tile's K output slots per cell, slot-major
//      (lanes on neighbouring columns: coalesced): a listed arrival's four
//      fields, gathered from the grid (the staging just read them, so
//      mostly from L1/L2) and written as 0 + value, as the TPU kernel's
//      one-hot accumulation makes them (a -0.0 velocity reads +0.0), and
//      valid' 1; else zeros in all five; and lost' (the cell's far movers
//      plus its arrivals beyond K, times the f32 1/K) in all K slots.
// So each source slot is read and its cell computed once per block rather
// than by each of the nine target cells that read it, and the walks run
// no further than each cell's last valid slot.
// The TPU kernel rolls columns modulo Gx, so targets in columns 0 and
// Gx-1 read the far edge column. Not staging it gives the same bits:
// every predicted cell is clamped to columns [1, grid_w - 2] (grid_w <=
// Gx), so nothing arrives in columns 0 and Gx-1, whose walks alone cross
// the edge, and far movers are counted at their source cell.
#include "resident_math.cuh"

// shared memory a staged slot takes: its packed cell
#define TF_REBIN_VALID_SLOT_BYTES 4

__global__ void __launch_bounds__(TF_TILE_THREADS)
rebin_valid_kernel(const float* __restrict__ px, const float* __restrict__ py,
                   const float* __restrict__ vx, const float* __restrict__ vy,
                   const float* __restrict__ val,
                   const float* __restrict__ dt_p, float* __restrict__ opx,
                   float* __restrict__ opy, float* __restrict__ ovx,
                   float* __restrict__ ovy, float* __restrict__ oval,
                   float* __restrict__ olost, int gy, int K, int gx, int lgR,
                   int lgC, float h_inv, float half_x, float half_y,
                   int cx_max, int cy_max, float inv_k) {
    extern __shared__ float4 smem4[];
    const int R = 1 << lgR, C = 1 << lgC;
    const int HC = C + 2;
    const int RC = R * C;
    int* scell = reinterpret_cast<int*>(smem4);  // ncx | ncy << 16, or -1
    int* sfar = scell + (R + 2) * K * HC;        // [R C] far movers
    const TfTileSmem t = tf_tile_smem(sfar + RC, K, R, C);
    const int y0 = blockIdx.y * R;
    const int x0 = blockIdx.x * C;
    for (int i = threadIdx.x; i < RC; i += TF_TILE_THREADS) sfar[i] = 0;
    tf_tile_begin(t, nullptr, nullptr, dt_p, 1, 0, R, C, K, y0, gy);
    const float dt = dt_p[0];

    // S: predicted cells of the +-1 halo's valid slots; centre far movers
    float av[TF_STAGE_BATCH], ax[TF_STAGE_BATCH], ay[TF_STAGE_BATCH];
    float ux[TF_STAGE_BATCH], uy[TF_STAGE_BATCH];
    tf_stage_halo(
        t, R, C, K, y0, x0, gx,
        [&](int u, size_t gi) {
            av[u] = val[gi];
            if (av[u] > 0.0f) {
                ax[u] = px[gi];
                ay[u] = py[gi];
                ux[u] = vx[gi];
                uy[u] = vy[gi];
            }
        },
        [&](int u, int lr, int kk, int lc) {
            const int s = (lr * K + kk) * HC + lc;
            if (!(av[u] > 0.0f)) {
                scell[s] = -1;
                return;
            }
            const int ncx = tf_cell(tf_pred(ax[u], ux[u], dt, half_x),
                                    half_x, h_inv, cx_max);
            const int ncy = tf_cell(tf_pred(ay[u], uy[u], dt, half_y),
                                    half_y, h_inv, cy_max);
            scell[s] = ncx | ncy << 16;
            atomicMax(&t.socc[lr * HC + lc], kk + 1);
            if (lr >= 1 && lr <= R && lc >= 1 && lc <= C &&
                (abs(ncy - (y0 + lr - 1)) > 1 || abs(ncx - (x0 + lc - 1)) > 1))
                atomicAdd(&sfar[(lr - 1) * C + lc - 1], 1);
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
    const int code = (x0 + tc) | (y0 + tr) << 16;  // the cell landing here
    int cnt = 0;
    for (int r = 0; r < 3; ++r) {
        for (int dx = 0; dx < 3; ++dx) {
            const int n = has_t ? t.socc[(tr + r) * HC + tc + dx] : 0;
            const int n_w = __reduce_max_sync(0xffffffffu, n);
            const int base = (tr + r) * K * HC + tc + dx;
            const int sx = x0 + tc + dx - 1;  // n is 0 outside the grid
            for (int s0 = 0; s0 < n_w; s0 += L) {
                const int s = s0 + j;
                const bool m = s < n && scell[base + s * HC] == code;
                const unsigned b = __ballot_sync(0xffffffffu, m) & team;
                if (m) {
                    const int pos = cnt + __popc(b & below);
                    if (pos < K)
                        t.list[pos * RC + tg] =
                            (int)tf_index(y0 + tr + r - 1, s, sx, K, gx);
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
        const int kk = i >> (lgR + lgC);
        const size_t oi = tf_index(y, kk, x0 + (c & (C - 1)), K, gx);
        const int n = scnt[c];
        if (kk < n) {
            const int gi = t.list[i];
            opx[oi] = __fadd_rn(0.0f, px[gi]);
            opy[oi] = __fadd_rn(0.0f, py[gi]);
            ovx[oi] = __fadd_rn(0.0f, vx[gi]);
            ovy[oi] = __fadd_rn(0.0f, vy[gi]);
            oval[oi] = 1.0f;
        } else {
            opx[oi] = 0.0f;
            opy[oi] = 0.0f;
            ovx[oi] = 0.0f;
            ovy[oi] = 0.0f;
            oval[oi] = 0.0f;
        }
        // counts below 2^24 are exact in f32, as the TPU kernel's f32 sums
        olost[oi] = __fmul_rn((float)(sfar[c] + max(n - K, 0)), inv_k);
    }
}

// dynamic shared memory limit set so far
static int kRebinValidSmem;

// Shared memory of a block: the staged cells and tile arrays, and the
// centre cells' far-mover counts.
static long long rebin_valid_smem_bytes(int K, int R, int C) {
    return tf_tile_smem_bytes(TF_REBIN_VALID_SLOT_BYTES, K, R, C) +
           4LL * R * C;
}

static bool rebin_valid_tile(int K, int& lgR, int& lgC) {
    return K > 0 && K <= 32767 &&
           tf_pick_tile(TF_REBIN_VALID_SLOTS, K, lgR, lgC,
                        [&](int R, int C) {
                            return rebin_valid_smem_bytes(K, R, C);
                        });
}

// The tile tf_rebin_valid runs at capacity K as rows << 8 | columns; 0
// when none fits shared memory.
extern "C" int tf_rebin_valid_tile(int K) {
    int lgR, lgC;
    if (!rebin_valid_tile(K, lgR, lgC)) return 0;
    return (1 << lgR) << 8 | (1 << lgC);
}

extern "C" int tf_rebin_valid(const float* px, const float* py,
                              const float* vx, const float* vy,
                              const float* val, const float* dt, float* opx,
                              float* opy, float* ovx, float* ovy, float* oval,
                              float* olost, int gy, int K, int gx,
                              float h_inv, float half_x, float half_y,
                              int cx_max, int cy_max, float inv_k,
                              cudaStream_t stream) {
    int lgR = 0, lgC = 0;
    // the packed cell and the target's code hold a column and a row below
    // 2^15 each, the gathered slot index fits an int
    if (gy <= 0 || gy > 32767 || gx > 32767 || cy_max > 32767 ||
        (long long)gy * K * gx > 0x7fffffffLL ||
        !rebin_valid_tile(K, lgR, lgC) || gx % (1 << lgC) != 0)
        return (int)cudaErrorInvalidValue;
    const long long smem = rebin_valid_smem_bytes(K, 1 << lgR, 1 << lgC);
    if (smem > kRebinValidSmem && smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            rebin_valid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        kRebinValidSmem = (int)smem;
    }
    dim3 grid(gx >> lgC, (gy + (1 << lgR) - 1) >> lgR);
    rebin_valid_kernel<<<grid, TF_TILE_THREADS, (size_t)smem, stream>>>(
        px, py, vx, vy, val, dt, opx, opy, ovx, ovy, oval, olost, gy, K, gx,
        lgR, lgC, h_inv, half_x, half_y, cx_max, cy_max, inv_k);
    return (int)cudaGetLastError();
}
