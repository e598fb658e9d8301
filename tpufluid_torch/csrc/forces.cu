// Forces + integrate: symmetrised spiky pressure and viscosity over the
// 3x3 cell stencil, fused with the full integration step.
//
// Replaces tpufluid/ops/pallas/fused.py:forces_integrate with every flag
// (_forces_kernel -> _forces_one_row, _forces_cand_block, _forces_one_cand,
// _adaptive_factor, _forces_integrate_sub). The TPU kernel folded the
// slot axis into 8-slot sublane sub-blocks, lane-rolled six candidate
// fields per (row, dx) block and carried per-target sums in VMEM scratch.
//
// Bound: memory traffic through L1/L2. At scene_1m each live target reads
// six fields (predicted position from pos/vel, pres, 1/rho) of about
// 9 * occ3 candidate slots and does ~40 flops and one rsqrt per candidate
// (surface tension: ~20 more and a sqrt); the grid's own reads and the
// four output fields cross DRAM about once.
//
// Design: one thread per target slot (y, k, x), 128 consecutive columns
// of one (row, slot) per block, so candidate loads of a warp are
// coalesced. Per-target sums live in registers. The candidate loop and
// the integration are tf_forces_target (resident_math.cuh), shared with
// physics.cu. Empty targets write SENTINEL / 0, so every output is
// written. The four variant flags (wrap_x, has_ff, surface_tension,
// adaptive) are template parameters, so each instantiation carries only
// its own code and registers (a runtime branch for has_ff cost the base
// launch ~12% on the H100); all 16 are built. At most 64 registers (8
// blocks of 128 on an SM): the base instantiation then takes 54 and
// 0.254 ms at scene_1m, against 91 and 0.332 ms unbounded (H100 at
// 700 W, one call of scripts/torch_kernel_ab.py).
// Batched world stacks: wid[y] (null for one world) picks row y's world
// in the per-world scalar table sc[W][17] (TF_SC_* columns).
#include "resident_math.cuh"

// candidate fields read from the global grid, predicted here
struct TfGlobalCand {
    const float* px;
    const float* py;
    const float* vx;
    const float* vy;
    const float* pres;
    const float* invr;
    int K, gx;
    float dt, half_x, half_y;

    __device__ __forceinline__ bool cand(int sy, int kp, int sx, float& nx,
                                         float& ny, float& nvx, float& nvy,
                                         float& p, float& ir) const {
        const size_t ci = tf_index(sy, kp, sx, K, gx);
        const float cpx = __ldg(px + ci);
        if (!tf_live(cpx)) return false;
        nvx = __ldg(vx + ci);
        nvy = __ldg(vy + ci);
        nx = tf_pred(cpx, nvx, dt, half_x);
        ny = tf_pred(__ldg(py + ci), nvy, dt, half_y);
        p = __ldg(pres + ci);
        ir = __ldg(invr + ci);
        return true;
    }
};

template <bool WRAP, bool HAS_FF, bool ST, bool ADAPT>
__global__ void __launch_bounds__(TF_BLOCK, 8)
forces_kernel(const float* __restrict__ px, const float* __restrict__ py,
              const float* __restrict__ vx, const float* __restrict__ vy,
              const float* __restrict__ pres, const float* __restrict__ invr,
              const int* __restrict__ occ_row, const int* __restrict__ wid,
              const float* __restrict__ sc,
              const long long* __restrict__ frame_p,
              const float* __restrict__ ffx, const float* __restrict__ ffy,
              float* __restrict__ npx, float* __restrict__ npy,
              float* __restrict__ nvx, float* __restrict__ nvy, int gy, int K,
              int gx, TfForceConsts c) {
    const int x = blockIdx.x * TF_BLOCK + threadIdx.x;
    const int k = blockIdx.y;
    const int y = blockIdx.z;
    const size_t ti = tf_index(y, k, x, K, gx);
    const float pos_x0 = px[ti];
    if (k >= occ_row[y] || !tf_live(pos_x0)) {
        npx[ti] = TF_SENTINEL;
        npy[ti] = TF_SENTINEL;
        nvx[ti] = 0.0f;
        nvy[ti] = 0.0f;
        return;
    }
    const float* scw = sc + tf_world(wid, y) * TF_SC_N;
    int occ_nb[3];
    tf_occ_nb(occ_row, y, gy, occ_nb);
    const int occ3 = max(max(occ_nb[0], occ_nb[1]), occ_nb[2]);
    const TfGlobalCand src{px, py, vx, vy, pres, invr, K, gx,
                           scw[TF_SC_DT], scw[TF_SC_HALF_X],
                           scw[TF_SC_HALF_Y]};
    float fx = 0.0f, fy = 0.0f;
    if (HAS_FF) {
        const size_t fi = (size_t)y * gx + x;
        fx = ffx[fi];
        fy = ffy[fi];
    }
    float ox, oy, ovx, ovy;
    tf_forces_target<WRAP, HAS_FF, ST, ADAPT>(
        src, scw, (uint32_t)frame_p[0], k, y, x, gx, occ_nb, occ3, pos_x0,
        py[ti], vx[ti], vy[ti], pres[ti], invr[ti], fx, fy, c, ox, oy, ovx,
        ovy);
    npx[ti] = ox;
    npy[ti] = oy;
    nvx[ti] = ovx;
    nvy[ti] = ovy;
}

typedef void (*ForcesKernel)(const float*, const float*, const float*,
                             const float*, const float*, const float*,
                             const int*, const int*, const float*,
                             const long long*, const float*, const float*,
                             float*, float*, float*, float*, int, int, int,
                             TfForceConsts);

template <int F>
static ForcesKernel forces_variant() {
    return forces_kernel<(F & TF_WRAP) != 0, (F & TF_HAS_FF) != 0,
                         (F & TF_ST) != 0, (F & TF_ADAPT) != 0>;
}

static const ForcesKernel kForces[16] = {
    forces_variant<0>(),  forces_variant<1>(),  forces_variant<2>(),
    forces_variant<3>(),  forces_variant<4>(),  forces_variant<5>(),
    forces_variant<6>(),  forces_variant<7>(),  forces_variant<8>(),
    forces_variant<9>(),  forces_variant<10>(), forces_variant<11>(),
    forces_variant<12>(), forces_variant<13>(), forces_variant<14>(),
    forces_variant<15>()};

extern "C" int tf_forces(const float* px, const float* py, const float* vx,
                         const float* vy, const float* pres, const float* invr,
                         const int* occ_row, const int* wid, const float* sc,
                         const long long* frame, const float* ffx,
                         const float* ffy, float* npx, float* npy,
                         float* nvx, float* nvy, int gy, int K, int gx,
                         int flags, const float* consts,
                         cudaStream_t stream) {
    const bool has_ff = (flags & TF_HAS_FF) != 0;
    if (gx % TF_BLOCK != 0 || gy <= 0 || K <= 0 || gy > 65535 || K > 65535 ||
        flags < 0 || flags > 15 || has_ff != (ffx != nullptr) ||
        (ffx == nullptr) != (ffy == nullptr))
        return (int)cudaErrorInvalidValue;
    TfForceConsts c;
    memcpy(&c, consts, sizeof(c));
    dim3 grid(gx / TF_BLOCK, K, gy);
    kForces[flags]<<<grid, TF_BLOCK, 0, stream>>>(
        px, py, vx, vy, pres, invr, occ_row, wid, sc, frame, ffx, ffy, npx,
        npy, nvx, nvy, gy, K, gx, c);
    return (int)cudaGetLastError();
}
