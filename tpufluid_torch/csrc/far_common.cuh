// Device helpers of the far-mover passes: the single-device re-insert
// (far_reinsert.cu) and the row-band sharded collect and insert
// (far_sharded.cu). Both sort distinct 64-bit keys (target cell << 32 |
// list index) in one block, so the order is the stable sort by target
// cell, and rank each mover in its cell's run.
#pragma once

#include "common.cuh"

// keys (8 B) and slots (4 B) of this many movers sort in shared memory
#define TF_FAR_SMEM_ENTRIES 16384

// The sum of v over the block, in every thread (NT a multiple of 32).
template <int NT>
__device__ __forceinline__ int tf_far_block_sum(int v, int* red) {
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    __syncthreads();  // red may still be read by a previous call
    if (lane == 0) red[w] = v;
    __syncthreads();
    int s = 0;
    for (int i = 0; i < NT / 32; ++i) s += red[i];
    return s;
}

// The smallest power of two >= n (1 for n <= 1).
__device__ __host__ __forceinline__ int tf_far_pow2(int n) {
    int p = 1;
    while (p < n) p <<= 1;
    return p;
}

// Bitonic sort of buf[0, n_pad), ascending, by the whole block (n_pad a
// power of two); __syncthreads makes each pass's writes, shared or global,
// visible to the block.
template <int NT>
__device__ __forceinline__ void tf_far_sort(unsigned long long* buf,
                                            int n_pad) {
    const int tid = threadIdx.x;
    for (int k = 2; k <= n_pad; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = tid; i < n_pad; i += NT) {
                const int l = i ^ j;
                if (l > i) {
                    const unsigned long long a = buf[i], b = buf[l];
                    if ((a > b) == ((i & k) == 0)) {
                        buf[i] = b;
                        buf[l] = a;
                    }
                }
            }
            __syncthreads();
        }
    }
}

// The rank of sorted key p in its cell's run: its distance from the run's
// first key (a binary search of buf[0, p)).
__device__ __forceinline__ int tf_far_rank(const unsigned long long* buf,
                                           int p) {
    const unsigned long long first = buf[p] >> 32 << 32;
    int lo = 0, hi = p;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (buf[mid] < first) lo = mid + 1;
        else hi = mid;
    }
    return p - lo;
}

// Live slots of cell (cy, cx) (the grid is slot-packed: its count).
__device__ __forceinline__ int tf_far_cell_count(const float* px, int cy,
                                                 int cx, int K, int gx) {
    int occ = 0;
    for (int kk = 0; kk < K; ++kk)
        occ += tf_live(px[tf_index(cy, kk, cx, K, gx)]) ? 1 : 0;
    return occ;
}
