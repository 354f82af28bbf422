// JRL fluid phase, k fused steps per launch on the full-class tiles (the
// tiles the moving tip or a wall row can reach): the level pyramid of
// jrl_tile.cuh with the analytic tip of each sub-step (FluidGeo).
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py::
// _make_fluid_k_kernel (bodies _fluid_a_update, _fluid_b_update; called by
// _fluid_k_chunk and _fluid_k_split_chunk). Plain twin:
// jrl_lbm_torch/kernels/jrl_tiled.py::fluid_k_ref. k = 1..4 are template
// instances chosen at launch.
//
// Bound on the card: the bytes at k = 1 (f, rho, vel in with a 2-row halo
// and out once, 12 planes each way: ~11 MB in and out for 7 of the 16
// 64-row tiles at 1024x512); a full cell costs ~650 float32 operations a
// step (~2 us for those tiles at the float32 peak). Design: the Pallas
// kernel streams whole rows with 8-row halo groups; a window of the full
// width does not fit a block's shared memory, so a block takes a
// 2D tile of 8 x (64 - 4k) cells with a 2k-cell halo (23 planes, 71 KB at
// k = 1, 141 KB at k = 4) and computes the tip geometry per sub-step from
// global coordinates, so no geometry plane crosses memory.
#include "jrl_tile.cuh"

namespace {

using namespace jrl;

template <int K>
__global__ void __launch_bounds__(TILE_THREADS) fluid_k_kernel(
    const float* __restrict__ f, const float* __restrict__ rho, const float* __restrict__ vel,
    float* __restrict__ f_out, float* __restrict__ rho_out, float* __restrict__ vel_out,
    int step, TileParams p) {
  tile_steps<TILE_FULL, K>(f, rho, vel, f_out, rho_out, vel_out, step, p);
}

}  // namespace

extern "C" int jrl_fluid_k(const float* f, const float* rho, const float* vel, float* f_out,
                           float* rho_out, float* vel_out, int step, int k, const TileParams* p,
                           void* stream) {
  return with_tile_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    return launch_tiles<K, fluid_k_kernel<K>>(*p, stream, f, rho, vel, f_out, rho_out,
                                              vel_out, step, *p);
  });
}
