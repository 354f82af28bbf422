// Cylinder channel on one shard of a (ny, nx) mesh, the band window: k
// chained full-boundary steps on the shard's rows [b0, b0 + nb) (its
// intersection with the static cylinder band), written in place into the
// lean pass's outputs. Tiles of (64 - 2k) x 8 cells with a k-cell halo in
// shared memory (cyl_common.cuh::tile_run, mode FULL_CYL: f and the
// velocity carried from sub-step to sub-step, flags and phi held), loaded
// from the pre-step state through the shard's k-row pieces and column
// blocks of the 14-plane group (cyl_shard.cuh::shard_tile); at b0 = 0 or
// b0 + nb = h the halo rows come from the pieces. OBSTACLE cells keep the
// state's rho and velocity, as the JAX window's _block_update does.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_sharded.py::
// _window_full_step with _apply_window_fix's dynamic_update_slice (a
// shard that misses the band launches nothing: the host tests its rows,
// where JAX's lax.cond tests pred). Plain twin: kernels/cyl_sharded.py::
// cyl_window_sh_ref.
//
// Bound on the card: a launch covers nb rows (~80 of 2048 at bench.py's
// scene), so few blocks fill the card; a full cell costs several times a
// plain one (flag-dependent pulls, the OUTFLOW recompute, the coupling
// next to the cylinder). Design: the tile code of cyl_band_k.cu (8-row
// tiles, twice the blocks of 16-row ones); exactness over k sub-steps
// needs the border that kernels/cylinder.py::check_border accepts.
#include "cyl_shard.cuh"

namespace {

using namespace cyl;

template <int K>
__global__ void __launch_bounds__(TILE_THREADS_X * TILE_THREADS_Y) cyl_window_sh_kernel(
    CylShardSrc src, float* __restrict__ f_out, float* __restrict__ rho_out,
    float* __restrict__ vel_out, CylParams p, CylShardGeom s, int b0, int nb) {
  shard_tile<FULL_CYL, K, false>(src, s, p, b0, b0 + nb, f_out, rho_out, vel_out);
}

}  // namespace

// Rows [b0, b0 + nb) of the shard's f_out, rho_out, vel_out are written;
// the other rows are left as they are.
extern "C" int cyl_window_sh_launch(const CylShardSrc* src, float* f_out, float* rho_out,
                                    float* vel_out, int k, int b0, int nb, const CylParams* p,
                                    const CylShardGeom* s, void* stream) {
  return with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    const int bytes = tile_smem_floats(FULL_CYL, K) * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(cyl_window_sh_kernel<K>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((s->w + tile_tx(K) - 1) / tile_tx(K),
                    (nb + tile_ty(FULL_CYL) - 1) / tile_ty(FULL_CYL));
    const dim3 block(TILE_THREADS_X, TILE_THREADS_Y);
    cyl_window_sh_kernel<K><<<grid, block, bytes, (cudaStream_t)stream>>>(
        *src, f_out, rho_out, vel_out, *p, *s, b0, nb);
    return (int)cudaGetLastError();
  });
}
