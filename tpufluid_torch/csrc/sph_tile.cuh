// The slot grid's tile helpers, shared by sph_density.cu and
// sph_forces.cu: one block of TF_TILE_THREADS per tile of R x C cells of
// the slot grid f32[Gy][K][Gxp] (R and C powers of two, C dividing the
// grid width, picked from K by tf_pick_tile) with all K slots, and the
// tile's +-1 halo of (R + 2) x (C + 2) cells staged in shared memory.
//
// The slot grid of ops.dense.build_grid_cols differs from the resident
// one: a cell's particles fill a prefix of its K slots flagged by a bool
// valid mask (empty slots hold zeros, not SENTINEL), and there is no row
// occupancy. Columns wrap modulo Gxp. Rows take one of two forms, the
// template parameter WRAP_ROWS: the TPU kernels' (pallas engine) clamp
// them to [0, Gy-1], as their clamped block index maps do (a target in
// row 0 visits row 0 twice); the roll passes' (dense engine) wrap them
// modulo Gy, as torch.roll does. So halo row lr is grid row
// clamp(y0 + lr - 1) or (y0 + lr - 1) mod Gy, halo column lc is grid
// column (x0 + lc - 1) mod Gxp, and each halo cell's occupancy is the
// length of its valid prefix, read from the mask.
//
// Shared memory: slot_bytes per halo slot, [row][slot][column] with pitch
// C + 2, then cell_bytes per centre cell (density: the first empty slot's
// position, a float2), then the halo cells' occupancies, the list of R x C
// x K entries, two per-warp count rows, the halo's and the centre's
// largest occupancy, then the rest of the cell_bytes (density: the first
// empty slot's sum, a float).
#pragma once

#include "resident_math.cuh"

// valid flags each thread loads before it tests any (memory parallelism)
#define TF_SPH_OCC_BATCH 8

__host__ __device__ __forceinline__ long long tf_sph_smem_bytes(
        int slot_bytes, int cell_bytes, int K, int R, int C) {
    const long long halo = (long long)(R + 2) * (C + 2);
    return (long long)slot_bytes * K * halo + (long long)cell_bytes * R * C +
           4LL * halo + 4LL * R * C * K + 8LL * TF_TILE_WARPS + 8LL;
}

// The tile of a dense kernel at capacity K; false when none fits. The caps
// on a tile's target slots are the resident kernels' (TF_DENSITY_SLOTS,
// TF_FORCES_SLOTS): a sweep of these kernels found none better (PERF.md).
static inline bool tf_sph_tile(int slot_bytes, int cell_bytes, int max_slots,
                               int K, int& lgR, int& lgC) {
    return K > 0 && tf_pick_tile(max_slots, K, lgR, lgC, [&](int R, int C) {
        return tf_sph_smem_bytes(slot_bytes, cell_bytes, K, R, C);
    });
}

// The largest K whose 1 x 1 tile fits shared memory.
static inline int tf_sph_max_k(int slot_bytes, int cell_bytes) {
    int K = 1;
    while (tf_sph_smem_bytes(slot_bytes, cell_bytes, K + 1, 1, 1) <=
           TF_SMEM_MAX)
        ++K;
    return K;
}

// The shared arrays behind the staged fields.
struct TfSphSmem {
    float2* first;  // [R C] density: each centre cell's first empty slot
    int* socc;      // [(R + 2) (C + 2)] halo cells' occupancies
    int* list;      // [R C K] targets
    int* wsum;      // [2][TF_TILE_WARPS] per-warp counts
    int* kmax;      // [2] largest occupancy of the halo, of the centre
    float* dead;    // [R C] density: the first empty slot's sum
};

__device__ __forceinline__ TfSphSmem tf_sph_smem(void* fields_end, int K,
                                                 int R, int C,
                                                 bool dead_cells) {
    TfSphSmem t;
    t.first = reinterpret_cast<float2*>(fields_end);
    t.socc = reinterpret_cast<int*>(t.first + (dead_cells ? R * C : 0));
    t.list = t.socc + (R + 2) * (C + 2);
    t.wsum = t.list + R * C * K;
    t.kmax = t.wsum + 2 * TF_TILE_WARPS;
    t.dead = reinterpret_cast<float*>(t.kmax + 2);
    return t;
}

template <bool WRAP_ROWS>
__device__ __forceinline__ int tf_sph_row(int y, int gy) {
    if (WRAP_ROWS) {
        y %= gy;
        return y < 0 ? y + gy : y;
    }
    return min(max(y, 0), gy - 1);
}

__device__ __forceinline__ int tf_sph_col(int x, int gx) {
    return x < 0 ? x + gx : (x >= gx ? x - gx : x);
}

// Each halo cell's occupancy, the length of its valid prefix (the kernels
// take any grid whose valid slots form a prefix of each cell, as
// build_grid_cols makes them), into socc; kmax[0] and kmax[1] get the
// largest occupancy of the halo and of the centre cells inside the grid.
// Ends with __syncthreads().
template <bool WRAP_ROWS>
__device__ __forceinline__ void tf_sph_occupancy(const TfSphSmem& t,
                                                 const uint8_t* valid, int R,
                                                 int C, int K, int y0,
                                                 int x0, int gy, int gx) {
    const int HR = R + 2, HC = C + 2;
    if (threadIdx.x < 2) t.kmax[threadIdx.x] = 0;
    __syncthreads();
    int m_halo = 0, m_centre = 0;
    for (int i = threadIdx.x; i < HR * HC; i += TF_TILE_THREADS) {
        const int lr = i / HC;
        const int lc = i - lr * HC;
        const uint8_t* v =
            valid + tf_index(tf_sph_row<WRAP_ROWS>(y0 + lr - 1, gy), 0,
                             tf_sph_col(x0 + lc - 1, gx), K, gx);
        int o = 0;
        while (o < K) {
            unsigned m = 0;
#pragma unroll
            for (int u = 0; u < TF_SPH_OCC_BATCH; ++u)
                if (o + u < K && v[(size_t)(o + u) * gx]) m |= 1u << u;
            const int n = __ffs(~m) - 1;  // the leading valid flags
            o += n;
            if (n < TF_SPH_OCC_BATCH) break;
        }
        t.socc[i] = o;
        m_halo = max(m_halo, o);
        if (lr >= 1 && lr <= R && lc >= 1 && lc <= C && y0 + lr - 1 < gy)
            m_centre = max(m_centre, o);
    }
    m_halo = __reduce_max_sync(0xffffffffu, m_halo);
    m_centre = __reduce_max_sync(0xffffffffu, m_centre);
    if ((threadIdx.x & 31) == 0) {
        atomicMax(&t.kmax[0], m_halo);
        atomicMax(&t.kmax[1], m_centre);
    }
    __syncthreads();
}

// Stage the halo's slots below each cell's occupancy: the flat (row, slot
// below the halo's largest occupancy, column) walk, TF_STAGE_BATCH slots'
// loads in flight per thread. load(u, gi) reads grid slot gi into batch
// entry u; store(u, lr, kk, lc) stages entry u at halo row lr, slot kk,
// column lc. Ends with __syncthreads().
template <bool WRAP_ROWS, class Load, class Store>
__device__ __forceinline__ void tf_sph_stage(const TfSphSmem& t, int R,
                                             int C, int K, int y0, int x0,
                                             int gy, int gx, Load load,
                                             Store store) {
    const int HR = R + 2, HC = C + 2;
    const int kh = t.kmax[0];
    const int n = HR * kh * HC;
    for (int i0 = threadIdx.x; i0 < n;
         i0 += TF_STAGE_BATCH * TF_TILE_THREADS) {
        int lr[TF_STAGE_BATCH], kk[TF_STAGE_BATCH], lc[TF_STAGE_BATCH];
        bool ok[TF_STAGE_BATCH];
#pragma unroll
        for (int u = 0; u < TF_STAGE_BATCH; ++u) {
            const int i = i0 + u * TF_TILE_THREADS;
            ok[u] = false;
            if (i < n) {
                const int q = i / HC;
                lc[u] = i - q * HC;
                lr[u] = q / kh;
                kk[u] = q - lr[u] * kh;
                ok[u] = kk[u] < t.socc[lr[u] * HC + lc[u]];
            }
            if (ok[u])
                load(u, tf_index(tf_sph_row<WRAP_ROWS>(y0 + lr[u] - 1, gy),
                                 kk[u], tf_sph_col(x0 + lc[u] - 1, gx), K,
                                 gx));
        }
#pragma unroll
        for (int u = 0; u < TF_STAGE_BATCH; ++u)
            if (ok[u]) store(u, lr[u], kk[u], lc[u]);
    }
    __syncthreads();
}

// Decode a list entry of tf_tile_list.
__device__ __forceinline__ void tf_sph_entry(int e, int& kk, int& lr,
                                             int& lc) {
    kk = e >> 16;
    lr = (e >> 8) & 255;
    lc = e & 255;
}
