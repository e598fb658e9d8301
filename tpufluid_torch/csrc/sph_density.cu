// Slot-grid density: rho = sum of mass * poly6 over the 3x3 cell stencil,
// self included (funcs.wgsl:157-203), on the slot grid that
// ops.dense.build_grid_cols rebuilds every step. Two kernels, one tile
// body with the template parameter ROLL:
//
// sph_density_kernel (the pallas engine, ops/sph.py) replaces
// tpufluid/ops/pallas/sph.py:density (_density_kernel), which on the TPU
// ran one program per grid row, read rows y-1, y, y+1 through clamped
// block index maps and lane-rolled whole rows by dx, giving every slot a
// value (an empty slot sums the candidates around its own zero position:
// the JAX contract has no self mask). Its pair term is
// mass * (norm * (d * d * d)), d = max(h^2 - r^2, 0).
//
// dense_density_kernel (the dense engine, ops/dense.py:density) replaces
// no Pallas kernel: it is XLA's roll formulation of
// tpufluid/ops/dense.py:density_pass, nine rolled copies of the grid and
// K slices each. It computes exactly what ops/dense.py:density_pass does:
// rows wrap modulo Gy (torch.roll), and the pair term is ops.kernels.poly6
// times the mass, mass * (r^2 > h^2 ? 0 : norm * d * d * d), d = h^2 - r^2,
// in that order. The sum order and the rest of the design are shared.
//
// Bound on the H100: the pair loop's instructions, then memory. At
// scene_1m K=8 (~4 particles a cell) each target meets ~36 live
// candidates at 12 f32 operations; the grid's positions and mask cross
// DRAM about once and the output is written whole. One thread per output
// slot, the design this replaces, walked every slot of the 3 x 3 cells
// with three global loads per candidate, and ran its empty slots' walks
// too: at K=32 302M candidate tests for 12.6M pairs in range (PERF.md).
// The roll form's pair term costs the same; the roll it replaces ran
// ~6 torch kernels per candidate slot over the whole grid.
//
// Design: one block of 256 threads per tile of R x C cells with all K
// slots (tf_sph_tile picks the tile from K so that it fits shared memory;
// sph_tile.cuh has the layout and the rows and columns each form visits).
//   O: each halo cell's occupancy, the length of its valid prefix;
//   S: the halo's positions below each cell's occupancy go to shared
//      memory (a float2 per slot), and each centre cell's first empty
//      slot's position beside them;
//   L: the targets are listed in (slot, row, column) order: every live
//      slot and, per centre cell with an empty slot, its first one;
//   D: the threads take the listed targets, each walking its 3 x 3 cells
//      below each cell's own occupancy in the TPU kernel's order (row -1,
//      0, +1; then dx -1, 0, +1; then kp ascending), every term added on
//      its own as the plain version adds it (an out-of-range candidate
//      adds exactly +0: no sum is ever -0), so the sum is bitwise the
//      plain version's; a cell's first empty slot keeps its sum in shared
//      memory;
//   W: every other empty slot whose position bits equal those of its
//      cell's first empty slot (in every grid build_grid_cols makes, all
//      zeros) gets that sum; one with other bits is walked on its own.
// So no candidate is loaded from global memory more than once per block,
// no walk runs past a cell's last particle, and a cell's empty slots cost
// one walk, not K - occupancy.
#include "sph_tile.cuh"

// 8 B a staged slot; a centre cell's first empty slot: a float2 and its
// float sum
#define SPH_DENSITY_SLOT_BYTES 8
#define SPH_DENSITY_CELL_BYTES 12

// The density sum of a target at (tx, ty) in centre cell (lr, lc) over
// the staged halo sp, each candidate cell walked below its occupancy; ROLL
// picks the pair term of ops/dense.py:density_pass, else ops/sph.py's.
template <bool ROLL>
__device__ __forceinline__ float sph_density_walk(const float2* sp,
                                                  const int* socc, int K,
                                                  int HC, int lr, int lc,
                                                  float tx, float ty,
                                                  float h2, float mass,
                                                  float norm) {
    float acc = 0.0f;
    for (int r = 0; r < 3; ++r) {
        for (int dx = 0; dx < 3; ++dx) {
            const int o = socc[(lr + r) * HC + lc + dx];
            const float2* q = sp + (lr + r) * K * HC + lc + dx;
#pragma unroll 2  // two candidates' terms in flight (PERF.md)
            for (int kp = 0; kp < o; ++kp) {
                const float2 c = q[kp * HC];
                const float ddx = c.x - tx;
                const float ddy = c.y - ty;
                const float r2 = ddx * ddx + ddy * ddy;
                float diff = h2 - r2;
                if (ROLL) {  // ops.kernels.poly6, then the mass
                    const float w =
                        r2 > h2 ? 0.0f : norm * diff * diff * diff;
                    acc = acc + mass * w;
                } else {
                    diff = diff < 0.0f ? 0.0f : diff;  // torch.clamp(min=0)
                    acc = acc + mass * (norm * (diff * diff * diff));
                }
            }
        }
    }
    return acc;
}

// The tile of either kernel (ROLL: the dense engine's).
template <bool ROLL>
__device__ __forceinline__ void density_tile_body(
        const float* __restrict__ px, const float* __restrict__ py,
        const uint8_t* __restrict__ valid, const float* __restrict__ mass_p,
        float* __restrict__ out, int gy, int K, int gx, int lgR, int lgC,
        float h2, float norm) {
    extern __shared__ float2 smem2[];
    const int R = 1 << lgR, C = 1 << lgC;
    const int HR = R + 2, HC = C + 2;
    float2* sp = smem2;
    const TfSphSmem t = tf_sph_smem(sp + HR * K * HC, K, R, C, true);
    const int y0 = blockIdx.y * R;
    const int x0 = blockIdx.x * C;
    const float mass = mass_p[0];

    // O: occupancies
    tf_sph_occupancy<ROLL>(t, valid, R, C, K, y0, x0, gy, gx);

    // S: the first empty slot of each centre cell, then the halo
    for (int c = threadIdx.x; c < R * C; c += TF_TILE_THREADS) {
        const int lr = c >> lgC;
        const int lc = c & (C - 1);
        const int o = t.socc[(lr + 1) * HC + lc + 1];
        if (y0 + lr < gy && o < K) {
            const size_t gi = tf_index(y0 + lr, o, x0 + lc, K, gx);
            t.first[c] = make_float2(px[gi], py[gi]);
        }
    }
    float ax[TF_STAGE_BATCH], ay[TF_STAGE_BATCH];
    tf_sph_stage<ROLL>(
        t, R, C, K, y0, x0, gy, gx,
        [&](int u, size_t gi) {
            ax[u] = px[gi];
            ay[u] = py[gi];
        },
        [&](int u, int lr, int kk, int lc) {
            sp[(lr * K + kk) * HC + lc] = make_float2(ax[u], ay[u]);
        });

    // L: live slots and each cell's first empty slot
    const int kc = min(t.kmax[1] + 1, K);
    const int n = tf_tile_list(t.list, t.wsum, kc, lgR, lgC,
                               [&](int lr, int kk, int lc) {
        return y0 + lr < gy && kk <= t.socc[(lr + 1) * HC + lc + 1];
    });

    // D: the sums
    for (int j = threadIdx.x; j < n; j += TF_TILE_THREADS) {
        int kk, lr, lc;
        tf_sph_entry(t.list[j], kk, lr, lc);
        const int o = t.socc[(lr + 1) * HC + lc + 1];
        const float2 q = kk < o ? sp[((lr + 1) * K + kk) * HC + lc + 1]
                                : t.first[lr * C + lc];
        const float acc = sph_density_walk<ROLL>(sp, t.socc, K, HC, lr, lc,
                                                 q.x, q.y, h2, mass, norm);
        out[tf_index(y0 + lr, kk, x0 + lc, K, gx)] = acc;
        if (kk == o) t.dead[lr * C + lc] = acc;
    }
    __syncthreads();

    // W: the other empty slots, TF_STAGE_BATCH slots' loads in flight
    const int n_all = (K * R) << lgC;
    for (int i0 = threadIdx.x; i0 < n_all;
         i0 += TF_STAGE_BATCH * TF_TILE_THREADS) {
        int lr[TF_STAGE_BATCH], lc[TF_STAGE_BATCH];
        size_t gi[TF_STAGE_BATCH];
        bool ok[TF_STAGE_BATCH];
#pragma unroll
        for (int u = 0; u < TF_STAGE_BATCH; ++u) {
            const int i = i0 + u * TF_TILE_THREADS;
            lc[u] = i & (C - 1);
            lr[u] = (i >> lgC) & (R - 1);
            const int kk = i >> (lgC + lgR);
            ok[u] = i < n_all && y0 + lr[u] < gy &&
                    kk > t.socc[(lr[u] + 1) * HC + lc[u] + 1];
            if (ok[u]) {
                gi[u] = tf_index(y0 + lr[u], kk, x0 + lc[u], K, gx);
                ax[u] = px[gi[u]];
                ay[u] = py[gi[u]];
            }
        }
#pragma unroll
        for (int u = 0; u < TF_STAGE_BATCH; ++u) {
            if (!ok[u]) continue;
            const int c = lr[u] * C + lc[u];
            const float2 f = t.first[c];
            out[gi[u]] = __float_as_uint(ax[u]) == __float_as_uint(f.x) &&
                                 __float_as_uint(ay[u]) == __float_as_uint(f.y)
                             ? t.dead[c]
                             : sph_density_walk<ROLL>(sp, t.socc, K, HC,
                                                      lr[u], lc[u], ax[u],
                                                      ay[u], h2, mass, norm);
        }
    }
}

__global__ void __launch_bounds__(TF_TILE_THREADS, 5)
sph_density_kernel(const float* __restrict__ px, const float* __restrict__ py,
                   const uint8_t* __restrict__ valid,
                   const float* __restrict__ mass_p, float* __restrict__ out,
                   int gy, int K, int gx, int lgR, int lgC, float h2,
                   float norm) {
    density_tile_body<false>(px, py, valid, mass_p, out, gy, K, gx, lgR, lgC,
                             h2, norm);
}

__global__ void __launch_bounds__(TF_TILE_THREADS, 5)
dense_density_kernel(const float* __restrict__ px,
                     const float* __restrict__ py,
                     const uint8_t* __restrict__ valid,
                     const float* __restrict__ mass_p,
                     float* __restrict__ out, int gy, int K, int gx, int lgR,
                     int lgC, float h2, float norm) {
    density_tile_body<true>(px, py, valid, mass_p, out, gy, K, gx, lgR, lgC,
                            h2, norm);
}

typedef void (*DensityKernel)(const float*, const float*, const uint8_t*,
                              const float*, float*, int, int, int, int, int,
                              float, float);

static bool sph_density_tile(int K, int& lgR, int& lgC) {
    return tf_sph_tile(SPH_DENSITY_SLOT_BYTES, SPH_DENSITY_CELL_BYTES,
                       TF_DENSITY_SLOTS, K, lgR, lgC);
}

// Launch ``kernel``; smem_set: its dynamic shared memory limit set so far.
static int launch_density(DensityKernel kernel, int& smem_set,
                          const float* px, const float* py,
                          const uint8_t* valid, const float* mass, float* out,
                          int gy, int K, int gx, float h2, float norm,
                          cudaStream_t stream) {
    int lgR = 0, lgC = 0;
    if (gy <= 0 || gx <= 0 || !sph_density_tile(K, lgR, lgC) ||
        gx % (1 << lgC) != 0 || (gy + (1 << lgR) - 1) >> lgR > 65535)
        return (int)cudaErrorInvalidValue;
    const long long smem =
        tf_sph_smem_bytes(SPH_DENSITY_SLOT_BYTES, SPH_DENSITY_CELL_BYTES, K,
                          1 << lgR, 1 << lgC);
    if (smem > smem_set && smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        smem_set = (int)smem;
    }
    dim3 grid(gx >> lgC, (gy + (1 << lgR) - 1) >> lgR);
    kernel<<<grid, TF_TILE_THREADS, (size_t)smem, stream>>>(
        px, py, valid, mass, out, gy, K, gx, lgR, lgC, h2, norm);
    return (int)cudaGetLastError();
}

// dynamic shared memory limits set so far
static int kSphDensitySmem, kDenseDensitySmem;

// The tile both kernels run at capacity K as rows << 8 | columns; 0 when
// none fits shared memory.
extern "C" int tf_sph_density_tile(int K) {
    int lgR, lgC;
    if (!sph_density_tile(K, lgR, lgC)) return 0;
    return (1 << lgR) << 8 | (1 << lgC);
}

// The largest K tf_sph_density and tf_dense_density take.
extern "C" int tf_sph_density_max_k(void) {
    return tf_sph_max_k(SPH_DENSITY_SLOT_BYTES, SPH_DENSITY_CELL_BYTES);
}

extern "C" int tf_sph_density(const float* px, const float* py,
                              const uint8_t* valid, const float* mass,
                              float* out, int gy, int K, int gx, float h2,
                              float norm, cudaStream_t stream) {
    return launch_density(sph_density_kernel, kSphDensitySmem, px, py, valid,
                          mass, out, gy, K, gx, h2, norm, stream);
}

extern "C" int tf_dense_density(const float* px, const float* py,
                                const uint8_t* valid, const float* mass,
                                float* out, int gy, int K, int gx, float h2,
                                float norm, cudaStream_t stream) {
    return launch_density(dense_density_kernel, kDenseDensitySmem, px, py,
                          valid, mass, out, gy, K, gx, h2, norm, stream);
}
