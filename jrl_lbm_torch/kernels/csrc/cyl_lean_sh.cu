// Cylinder channel on one shard of a (ny, nx) mesh, the lean pass: k
// plain-channel steps per launch (temporal blocking) on every row of the
// shard, with the first and last rows' rules of the global grid (the
// INFLOW plug at y = 0, the OUTFLOW copy at y = H-1: the YB instance of
// cyl_common.cuh::lean_cell). Tiles of (64 - 2k) x 16 cells with a k-cell
// halo in shared memory (cyl_common.cuh::tile_run), loaded through the
// shard's k-row pieces and k-lane (or wider) column blocks of f
// (cyl_shard.cuh::shard_tile). k is a template parameter (1..8). Rows of
// the cylinder band come out wrong by design: cyl_window_sh rewrites them.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_sharded.py::
// _lean_tiled_step (body _lean_block_update) in its three x modes: a
// shard spanning the width wraps in its own body, the others read the
// column blocks, whatever their width. Plain twin: kernels/cyl_sharded.py::
// cyl_lean_sh_ref.
//
// Bound on the card: as cyl_interior_k, instruction issue (~190 float32
// operations a cell and sub-step that --fmad=false keeps apart) over the
// bytes (9 f planes in with the halo, 12 planes out). Design: the tile
// code of cyl_interior_k.cu; the loader's branch between body, row piece
// and column block runs once per tile cell, and the y-border rules are a
// few compares per cell.
#include "cyl_shard.cuh"

namespace {

using namespace cyl;

template <int K>
__global__ void __launch_bounds__(TILE_THREADS_X * TILE_THREADS_Y) cyl_lean_sh_kernel(
    CylShardSrc src, float* __restrict__ f_out, float* __restrict__ rho_out,
    float* __restrict__ vel_out, CylParams p, CylShardGeom s) {
  shard_tile<LEAN, K, true>(src, s, p, 0, s.h, f_out, rho_out, vel_out);
}

}  // namespace

// src: the shard's f with its pieces (the other fields unread); s.k >= k
// rows of pieces and s.xh >= k lanes where the mesh has them.
extern "C" int cyl_lean_sh_launch(const CylShardSrc* src, float* f_out, float* rho_out,
                                  float* vel_out, int k, const CylParams* p,
                                  const CylShardGeom* s, void* stream) {
  return with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    const int bytes = tile_smem_floats(LEAN, K) * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(cyl_lean_sh_kernel<K>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((s->w + tile_tx(K) - 1) / tile_tx(K),
                    (s->h + tile_ty(LEAN) - 1) / tile_ty(LEAN));
    const dim3 block(TILE_THREADS_X, TILE_THREADS_Y);
    cyl_lean_sh_kernel<K><<<grid, block, bytes, (cudaStream_t)stream>>>(*src, f_out, rho_out,
                                                                        vel_out, *p, *s);
    return (int)cudaGetLastError();
  });
}
