// JRL fluid phase, k fused steps per launch on the below-tip tiles of a
// flat tip: tiles whose whole 2k-row reach lies at least two rows under the
// tip row and off the walls (jrl_lbm_torch/kernels/jrl_tiled.py::below).
// The level pyramid of jrl_tile.cuh with BtGeo: the tip is the columns
// x < rg on every row and phi the column distance, so the geometry is
// static along each column and needs no step index.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py::
// _make_fluid_k_bt_kernel (bodies _fluid_a_bt, _fluid_b_bt; called by
// _fluid_k_split_chunk). Plain twin: kernels/jrl_tiled.py::fluid_k_bt_ref.
// k = 1..4 are template instances chosen at launch.
//
// Bound on the card: the bytes (f, rho, vel in with a 2k-row halo and out
// once); the coupled column next to the tip costs a few times a plain
// cell, the rest is a plain BGK cell. Design: the 2D shared-memory tiles
// of fluid_k.cu.
#include "jrl_tile.cuh"

namespace {

using namespace jrl;

template <int K>
__global__ void __launch_bounds__(TILE_THREADS) fluid_k_bt_kernel(
    const float* __restrict__ f, const float* __restrict__ rho, const float* __restrict__ vel,
    float* __restrict__ f_out, float* __restrict__ rho_out, float* __restrict__ vel_out,
    TileParams p) {
  tile_steps<TILE_BT, K>(f, rho, vel, f_out, rho_out, vel_out, 0, p);
}

}  // namespace

extern "C" int jrl_fluid_k_bt(const float* f, const float* rho, const float* vel, float* f_out,
                              float* rho_out, float* vel_out, int k, const TileParams* p,
                              void* stream) {
  return with_tile_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    return launch_tiles<K, fluid_k_bt_kernel<K>>(*p, stream, f, rho, vel, f_out, rho_out,
                                                 vel_out, *p);
  });
}
