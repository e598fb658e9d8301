// Dense-grid density: rho = sum of mass * poly6 over the 3x3 cell stencil,
// self included (funcs.wgsl:157-203), on the slot grid that
// ops.dense.build_grid_cols rebuilds every step.
//
// Replaces tpufluid/ops/pallas/sph.py:density (_density_kernel), which on
// the TPU ran one program per grid row, read rows y-1, y, y+1 through
// clamped block index maps and lane-rolled whole rows by dx.
//
// Bound: memory traffic through L1/L2. Each target reads three fields
// (px, py, valid) of up to 9 * K candidate slots; the pair math is ~10
// flops. DRAM sees each input about once, since neighbouring blocks share
// candidate rows in L2.
//
// Design: one thread per output slot (y, k, x); a block covers 128
// consecutive columns of one (row, slot), so candidate loads of a warp are
// coalesced. Candidates are visited in the TPU kernel's order (row y-1, y,
// y+1 clamped to [0, Gy-1]; dx -1, 0, +1 wrapping modulo Gxp; slot kp
// ascending) and each is added to the running sum on its own. A cell's
// particles fill a prefix of its K slots, so a candidate column ends at
// its first empty slot; an empty or out-of-range candidate adds exactly
// +0.0 in the TPU kernel and is skipped here. Every output slot is
// written, empty ones included (no self mask).
#include "common.cuh"

__global__ void __launch_bounds__(TF_BLOCK)
sph_density_kernel(const float* __restrict__ px, const float* __restrict__ py,
                   const uint8_t* __restrict__ valid,
                   const float* __restrict__ mass_p, float* __restrict__ out,
                   int gy, int K, int gx, float h2, float norm) {
    const int x = blockIdx.x * TF_BLOCK + threadIdx.x;
    const int k = blockIdx.y;
    const int y = blockIdx.z;
    const float mass = mass_p[0];
    const size_t ti = tf_index(y, k, x, K, gx);
    const float tx = px[ti];
    const float ty = py[ti];
    float acc = 0.0f;
    for (int r = -1; r <= 1; ++r) {
        const int sy = min(max(y + r, 0), gy - 1);
        for (int dx = -1; dx <= 1; ++dx) {
            const int sx = (x + dx + gx) % gx;
            for (int kp = 0; kp < K; ++kp) {
                const size_t ci = tf_index(sy, kp, sx, K, gx);
                if (!valid[ci]) break;
                const float ddx = px[ci] - tx;
                const float ddy = py[ci] - ty;
                const float r2 = ddx * ddx + ddy * ddy;
                if (r2 >= h2) continue;  // poly6 is 0 there
                const float diff = h2 - r2;
                acc = acc + mass * (norm * (diff * diff * diff));
            }
        }
    }
    out[ti] = acc;
}

extern "C" int tf_sph_density(const float* px, const float* py,
                              const uint8_t* valid, const float* mass,
                              float* out, int gy, int K, int gx, float h2,
                              float norm, cudaStream_t stream) {
    if (gx % TF_BLOCK != 0 || gy <= 0 || K <= 0 || gy > 65535 || K > 65535)
        return (int)cudaErrorInvalidValue;
    dim3 grid(gx / TF_BLOCK, K, gy);
    sph_density_kernel<<<grid, TF_BLOCK, 0, stream>>>(px, py, valid, mass,
                                                      out, gy, K, gx, h2,
                                                      norm);
    return (int)cudaGetLastError();
}
