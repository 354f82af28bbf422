// Cylinder channel, k plain-channel steps per launch on the interior rows
// (temporal blocking): the step of cyl_interior.cu k times, on tiles of
// (64 - 2k) x 16 cells held in shared memory with a k-cell halo on all
// four sides (cyl_common.cuh::tile_steps, mode LEAN). rho and vel of the
// last sub-step are written only with p.write_macro. k is a template
// parameter (1..8, chosen at launch).
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_step.py::
// _make_interior_kernel2 (body _lean_step_rows). Plain twin:
// kernels/cylinder.py::cyl_interior_k_ref.
//
// Bound on the card: the bytes give 82 us a k=4 pass at 2048^2 (9 f
// planes in with the halo rows, 9 out), but the kernel is bound by
// instruction issue: ~190 float32 operations a cell and sub-step that
// --fmad=false keeps from pairing into multiply-adds, as many integer and
// branch instructions again, and 1.26x redundant halo work at k = 4.
// Design: the Pallas kernel streams whole rows and needs a y halo only; a
// 2D tile needs an x halo too, and applies the wall-column rules where it
// touches x = 0 or W-1 (global coordinates wrap, so no index leaves the
// grid). The tile with its halo is 64 cells wide (two warps) so that the
// shrinking sub-step regions keep the lanes busy; f of the halo, twice for
// the two sub-step buffers, takes 110 KB of shared memory at k = 4 (two
// blocks an SM); each thread updates two independent cells of a row at
// once so that their instructions interleave; buffer offsets are
// compile-time and from the shared base (no generic loads). In the bf16
// storage modes the tile load and the one store of the pass convert
// (cyl_common.cuh::f_load, f_store; the sub-steps stay float32 in shared
// memory, so a pass rounds once): the f bytes halve, the instructions
// per cell barely move, and the stochastic-rounding store adds two
// Philox calls a cell.
#include "cyl_common.cuh"

namespace {

using namespace cyl;

template <int K, int ST>
__global__ void __launch_bounds__(TILE_THREADS_X * TILE_THREADS_Y) cyl_interior_k_kernel(
    const f_t<ST>* __restrict__ f, f_t<ST>* __restrict__ f_out, float* __restrict__ rho_out,
    float* __restrict__ vel_out, CylParams p) {
  tile_steps<LEAN, K, ST>(f, nullptr, nullptr, nullptr, f_out, rho_out, vel_out, p);
}

}  // namespace

// storage: cyl_common.cuh::Storage; f and f_out hold f_t<storage>.
extern "C" int cyl_interior_k_launch(const void* f, void* f_out, float* rho_out, float* vel_out,
                                     int k, int storage, const CylParams* p, void* stream) {
  return with_storage(storage, [&](auto sc) {
    constexpr int ST = decltype(sc)::value;
    return with_k(k, [&](auto kc) {
      constexpr int K = decltype(kc)::value;
      const int bytes = tile_smem_floats(LEAN, K) * (int)sizeof(float);
      cudaError_t err = cudaFuncSetAttribute(cyl_interior_k_kernel<K, ST>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return (int)err;
      const dim3 grid((p->W + tile_tx(K) - 1) / tile_tx(K), row_tiles(*p, tile_ty(LEAN)));
      const dim3 block(TILE_THREADS_X, TILE_THREADS_Y);
      cyl_interior_k_kernel<K, ST><<<grid, block, bytes, (cudaStream_t)stream>>>(
          static_cast<const f_t<ST>*>(f), static_cast<f_t<ST>*>(f_out), rho_out, vel_out, *p);
      return (int)cudaGetLastError();
    });
  });
}
