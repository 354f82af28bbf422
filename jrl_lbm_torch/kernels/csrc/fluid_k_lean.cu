// JRL fluid phase, k fused steps per launch on the lean-class tiles: the
// interior tiles whose 2k-row reach holds no tip cell and no wall row
// (jrl_lbm_torch/kernels/jrl_tiled.py::frontier). The level pyramid of
// jrl_tile.cuh with LeanGeo: every cell FLUID but the OUTFLOW column, so
// the sub-grid bounce, the coupling, the obstacle masks and the geometry
// fold away at compile time, and the kernel reads only f: rho and vel of
// the first sub-step are recomputed from it.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py::
// _make_fluid_k_lean_kernel (bodies _fluid_a_lean, _fluid_b_lean; called
// by _fluid_k_split_chunk). Plain twin: kernels/jrl_tiled.py::
// fluid_k_lean_ref. k = 1..4 are template instances chosen at launch.
//
// Bound on the card: the bytes at k = 1 (f in with a 2-row halo, 9 planes;
// f, rho, vel out, 12 planes: ~11 MB in, ~14 MB out for 9 of the 16 tiles
// at 1024x512), with ~350 float32 operations a lean cell and step. Design:
// the 2D shared-memory tiles of fluid_k.cu; nothing of rho or vel is
// loaded.
#include "jrl_tile.cuh"

namespace {

using namespace jrl;

template <int K>
__global__ void __launch_bounds__(TILE_THREADS) fluid_k_lean_kernel(
    const float* __restrict__ f, float* __restrict__ f_out, float* __restrict__ rho_out,
    float* __restrict__ vel_out, TileParams p) {
  tile_steps<TILE_LEAN, K>(f, nullptr, nullptr, f_out, rho_out, vel_out, 0, p);
}

}  // namespace

extern "C" int jrl_fluid_k_lean(const float* f, float* f_out, float* rho_out, float* vel_out,
                                int k, const TileParams* p, void* stream) {
  return with_tile_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    return launch_tiles<K, fluid_k_lean_kernel<K>>(*p, stream, f, f_out, rho_out, vel_out, *p);
  });
}
