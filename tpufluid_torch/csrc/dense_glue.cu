// The dense engine's slot-grid build and read-back (ops/dense.py: build,
// readback), around the tile kernels dense_density / dense_forces (or the
// pallas engine's sph_density / sph_forces) in dense_forces_cols.
//
// Neither replaces a Pallas kernel: they replace XLA's scatter in
// tpufluid/ops/dense.py:76-103 (build_grid_cols: a rank by searchsorted,
// five zeroed grids, five scatters) and its read-back at :353-358 (five
// grids stacked, a fill row concatenated, one gather), which the port ran
// as the same torch ops (ops/dense.py: build_grid_cols, readback_cols,
// the plain versions; both kernels are bitwise them).
//
// Bound on the H100: bytes. The build zeroes the slot grid (four f32
// fields and the u8 mask: 17 B a slot) and writes each particle's four
// fields, mask byte and i64 slot; the read-back reads five f32 fields at
// each particle's slot and writes them as [5, N]. At the CLI's default run
// ([267, 16, 384], 100k particles) that is ~28 MB of zeroing and ~6 MB
// else: ~10 us. The torch versions ran ~30 launches over whole grids,
// among them a 66 MB stack-and-cat.
//
// Design:
//   build (one thread per sorted particle i, cell c = cells[i]): the keys
//     are sorted ascending, so i's rank in its cell run is at least K
//     exactly when i >= K and cells[i - K] == c (dropped, counted); else
//     it is i less the first index of the run, a binary search over at
//     most K entries before i. Slot (cy * K + rank) * Gxp + cx, clamped to
//     size (a cell past the last row, the slab step's id for a slot
//     outside its slab, lands there too), size where dropped: the formula
//     and clamps of build_grid_cols. Kept slots are distinct, so the
//     writes are plain stores. The whole buffer (grids, mask, count) is
//     zeroed first by one cudaMemsetAsync; the drop count is a block count
//     (__syncthreads_count) and one integer atomicAdd a block, order-free.
//   readback (one thread per sorted particle): the five fields at its
//     slot, or (0.1, 0, 0, 0, 0) where the slot is size (dropped).
#include "common.cuh"

#define TF_GLUE_THREADS 256

// floor division and modulo, as torch's // and % on int64
__device__ __forceinline__ void tf_floor_divmod(long long a, long long b,
                                                long long& q, long long& r) {
    q = a / b;
    r = a - q * b;
    if (r != 0 && ((r < 0) != (b < 0))) {
        q -= 1;
        r += b;
    }
}

template <typename Key>
__global__ void __launch_bounds__(TF_GLUE_THREADS)
dense_build_kernel(const float* __restrict__ px, const float* __restrict__ py,
                   const float* __restrict__ vx, const float* __restrict__ vy,
                   long long spx, long long spy, long long svx,
                   long long svy, const Key* __restrict__ cells, int n,
                   int K, int gx, int gxp, long long size,
                   long long* __restrict__ flat, float* __restrict__ grids,
                   uint8_t* __restrict__ valid, int* __restrict__ n_dropped) {
    const int i = blockIdx.x * TF_GLUE_THREADS + threadIdx.x;
    int dropped = 0;
    if (i < n) {
        const Key c = cells[i];
        long long slot = size;
        if (i >= K && cells[i - K] == c) {
            dropped = 1;
        } else {
            int lo = max(i - K + 1, 0), hi = i;  // cells[hi] == c
            while (lo < hi) {
                const int mid = lo + ((hi - lo) >> 1);
                if (cells[mid] < c) lo = mid + 1;
                else hi = mid;
            }
            long long cy, cx;
            tf_floor_divmod((long long)c, gx, cy, cx);
            const long long f = (cy * K + (i - lo)) * gxp + cx;
            slot = f < size ? f : size;
            if (slot >= 0 && slot < size) {
                grids[slot] = px[i * spx];
                grids[size + slot] = py[i * spy];
                grids[2 * size + slot] = vx[i * svx];
                grids[3 * size + slot] = vy[i * svy];
                valid[slot] = 1;
            }
        }
        flat[i] = slot;
    }
    const int count = __syncthreads_count(dropped);
    if (threadIdx.x == 0 && count > 0) atomicAdd(n_dropped, count);
}

__global__ void __launch_bounds__(TF_GLUE_THREADS)
dense_readback_kernel(const long long* __restrict__ flat, int n,
                      long long size, const float* __restrict__ dens,
                      const float* __restrict__ fx,
                      const float* __restrict__ fy,
                      const float* __restrict__ gx,
                      const float* __restrict__ gy, float* __restrict__ out) {
    const int i = blockIdx.x * TF_GLUE_THREADS + threadIdx.x;
    if (i >= n) return;
    const long long s = flat[i];
    float d = 0.1f, a = 0.0f, b = 0.0f, c = 0.0f, e = 0.0f;
    if (s >= 0 && s < size) {
        d = dens[s];
        a = fx[s];
        b = fy[s];
        c = gx[s];
        e = gy[s];
    }
    out[i] = d;
    out[(size_t)n + i] = a;
    out[2 * (size_t)n + i] = b;
    out[3 * (size_t)n + i] = c;
    out[4 * (size_t)n + i] = e;
}

// The byte size of tf_dense_build's buffer for a grid of ``size`` slots
// (ops/dense.py: build makes its views): f32[4][size] (px, py, vx, vy),
// u8[size] valid, then the i32 drop count at byte 17 * size (size is a
// multiple of 128, so aligned).
static long long dense_build_bytes(long long size) { return 17 * size + 4; }

// Builds the slot grid of n cell-sorted particles (cells: i32 with
// key_bytes 4, else i64) into buf, zeroed first; column j of (px, py, vx,
// vy) is read at element stride s_j; flat gets each particle's slot.
extern "C" int tf_dense_build(const float* px, const float* py,
                              const float* vx, const float* vy,
                              long long spx, long long spy, long long svx,
                              long long svy, const void* cells, int key_bytes,
                              int n, int gy, int K, int gx, int gxp,
                              long long* flat, void* buf,
                              cudaStream_t stream) {
    if (n < 0 || gy <= 0 || K <= 0 || gx <= 0 || gxp < gx || gxp % 128 != 0 ||
        (key_bytes != 4 && key_bytes != 8))
        return (int)cudaErrorInvalidValue;
    const long long size = (long long)gy * K * gxp;
    cudaError_t err =
        cudaMemsetAsync(buf, 0, (size_t)dense_build_bytes(size), stream);
    if (err != cudaSuccess || n == 0) return (int)err;
    float* grids = (float*)buf;
    uint8_t* valid = (uint8_t*)buf + 16 * size;
    int* n_dropped = (int*)((uint8_t*)buf + 17 * size);
    const int blocks = (n + TF_GLUE_THREADS - 1) / TF_GLUE_THREADS;
    if (key_bytes == 4)
        dense_build_kernel<int><<<blocks, TF_GLUE_THREADS, 0, stream>>>(
            px, py, vx, vy, spx, spy, svx, svy, (const int*)cells, n, K, gx,
            gxp, size, flat, grids, valid, n_dropped);
    else
        dense_build_kernel<long long><<<blocks, TF_GLUE_THREADS, 0, stream>>>(
            px, py, vx, vy, spx, spy, svx, svy, (const long long*)cells, n, K,
            gx, gxp, size, flat, grids, valid, n_dropped);
    return (int)cudaGetLastError();
}

// Reads back the five [size] fields at each of the n slots in flat into
// out, f32[5][n].
extern "C" int tf_dense_readback(const long long* flat, int n, long long size,
                                 const float* dens, const float* fx,
                                 const float* fy, const float* gx,
                                 const float* gy, float* out,
                                 cudaStream_t stream) {
    if (n < 0 || size <= 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const int blocks = (n + TF_GLUE_THREADS - 1) / TF_GLUE_THREADS;
    dense_readback_kernel<<<blocks, TF_GLUE_THREADS, 0, stream>>>(
        flat, n, size, dens, fx, fy, gx, gy, out);
    return (int)cudaGetLastError();
}
