// Shared device helpers for the resident engine's kernels (rebin.cu,
// rebin_valid.cu, density.cu, forces.cu, physics.cu) and the dense
// engine's.
//
// Layout: every slot grid is f32[Gy][K][Gx], x fastest, Gx a multiple of
// 128. Empty slots hold pos = TF_SENTINEL. occ_row[y] is the row's max
// packed occupancy: slots >= occ_row[y] of row y are empty in every column.
//
// Numerics: the library is built with -fmad=false, so each f32 operation
// rounds on its own exactly as the plain PyTorch versions do (torch runs
// one rounding per op). The cell math below also spells it out with
// __fmul_rn/__fadd_rn, because rebin's cell assignment must be bitwise.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TF_SENTINEL 1.0e9f
#define TF_SENTINEL_HALF 5.0e8f
#define TF_MAX_SPEED 500.0f
#define TF_EPSILON 1.19209290e-07f
#define TF_BLOCK 128

// Clamped predicted coordinate (compute.wgsl:8-30): p + v*dt, product and
// sum rounded separately, clamped to [-half, half].
__device__ __forceinline__ float tf_pred(float p, float v, float dt,
                                         float half) {
    float q = __fadd_rn(p, __fmul_rn(v, dt));
    return fminf(fmaxf(q, -half), half);
}

// Interior-clamped cell index of a predicted coordinate:
// clamp(floor((q + half) * (1/h)) + 1, 1, cmax).
__device__ __forceinline__ int tf_cell(float q, float half, float h_inv,
                                       int cmax) {
    int c = (int)floorf(__fmul_rn(__fadd_rn(q, half), h_inv)) + 1;
    return min(max(c, 1), cmax);
}

__device__ __forceinline__ bool tf_live(float px) {
    return px < TF_SENTINEL_HALF;
}

__device__ __forceinline__ size_t tf_index(int y, int k, int x, int K,
                                           int gx) {
    return ((size_t)y * K + k) * gx + x;
}

__device__ __forceinline__ uint32_t tf_xorshift32(uint32_t x) {
    x ^= x << 13;
    x ^= x >> 17;
    x ^= x << 5;
    return x;
}

__device__ __forceinline__ float tf_u01(uint32_t x) {
    return __uint2float_rn(x) / 4294967296.0f;
}
