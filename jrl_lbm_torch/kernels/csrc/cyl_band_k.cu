// Cylinder channel, k full-boundary steps per launch on band rows
// (temporal blocking): the step of cyl_full.cu k times, on tiles of
// (64 - 2k) x 8 cells held in shared memory with a k-cell halo
// (cyl_common.cuh::tile_steps). Two variants, chosen by `edge`:
//  * "cyl" (mode FULL_CYL, the cylinder band): the sub-step velocity is
//    carried in shared memory from sub-step to sub-step, as the TPU
//    chain carries cvx/cvy, because the coupling stencils of sub-step
//    j + 1 read the step-j velocity one cell away; OBSTACLE cells keep it;
//  * "edge" (mode FULL_EDGE, the INFLOW and OUTFLOW tiles): no coupling,
//    no sub-grid bounce, no vel or phi read; OBSTACLE velocity 0.
// OBSTACLE rho is cfg.density in both, as in the TPU kernels.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_step.py::
// _make_full_kernel2 (body _full_step_rows, variants "cyl" and "edge").
// Plain twin: kernels/cylinder.py::cyl_band_k_ref.
//
// Bound on the card: the bytes give ~6 us a launch at 2048^2 (the band is
// 128 + 64 of 2048 rows), but a launch covers few tiles, and a full cell
// costs several times a plain one (flag-dependent pulls, the OUTFLOW
// recompute, the coupling next to the cylinder), so it is bound by
// instruction issue and by how few blocks fill the card. Design: 8-row
// tiles (twice the blocks of 16-row ones); the "cyl" tile keeps f and vel
// (two buffers each), flags and phi of its halo in 98 KB of shared memory
// at k = 4; the OUTFLOW copy recomputes the inward neighbour's streaming
// from the same sub-step buffer (a clamped read where that falls outside
// the tile only ever feeds a halo cell that does not reach the tile).
// In the bf16 storage modes only the tile load and the pass's one store
// convert (cyl_common.cuh::f_load, f_store).
#include "cyl_common.cuh"

namespace {

using namespace cyl;

template <int MODE, int K, int ST>
__global__ void __launch_bounds__(TILE_THREADS_X * TILE_THREADS_Y) cyl_band_k_kernel(
    const f_t<ST>* __restrict__ f, const float* __restrict__ vel, const int* __restrict__ flags,
    const float* __restrict__ phi, f_t<ST>* __restrict__ f_out, float* __restrict__ rho_out,
    float* __restrict__ vel_out, CylParams p) {
  tile_steps<MODE, K, ST>(f, vel, flags, phi, f_out, rho_out, vel_out, p);
}

template <int MODE, int ST>
int launch(const void* f, const float* vel, const int* flags, const float* phi, void* f_out,
           float* rho_out, float* vel_out, int k, const CylParams* p, cudaStream_t stream) {
  return with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    const int bytes = tile_smem_floats(MODE, K) * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(cyl_band_k_kernel<MODE, K, ST>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((p->W + tile_tx(K) - 1) / tile_tx(K), row_tiles(*p, tile_ty(MODE)));
    const dim3 block(TILE_THREADS_X, TILE_THREADS_Y);
    cyl_band_k_kernel<MODE, K, ST><<<grid, block, bytes, stream>>>(
        static_cast<const f_t<ST>*>(f), vel, flags, phi, static_cast<f_t<ST>*>(f_out), rho_out,
        vel_out, *p);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// storage: cyl_common.cuh::Storage; f and f_out hold f_t<storage>.
extern "C" int cyl_band_k_launch(const void* f, const float* vel, const int* flags,
                                 const float* phi, void* f_out, float* rho_out, float* vel_out,
                                 int k, int edge, int storage, const CylParams* p, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return with_storage(storage, [&](auto sc) {
    constexpr int ST = decltype(sc)::value;
    return edge ? launch<FULL_EDGE, ST>(f, vel, flags, phi, f_out, rho_out, vel_out, k, p, s)
                : launch<FULL_CYL, ST>(f, vel, flags, phi, f_out, rho_out, vel_out, k, p, s);
  });
}
