// JRL fluid step B on one shard of a (ny, nx) mesh: BGK with the
// Guo-shifted gravity equilibrium and the LINE_X_EQ_0 axisymmetric source,
// one thread per body cell, with rho and vel beyond the shard read from
// the halo pieces of the post-moment fields. A LEAN instance serves shards
// above the tip front (no obstacle pair to mask, no OBSTACLE passthrough).
//
// Replaces the TPU kernels jrl_lbm_tpu/ops/pallas/fused_jrl_sharded.py::
// _step_b (fused_jrl_tiled._make_kernel_b with shard=True, xw windows on a
// 2D mesh) and _step_b_lean (body _make_kernel_b_lean_sh). Its plain twin
// is jrl_lbm_torch/kernels/jrl_sharded.py::fluid_b_sh_ref. The per-cell
// code is jrl_fluid.cuh::fluid_b_cell through jrl_shard.cuh::ShardState,
// so a shard computes what fluid_b.cu computes, bit for bit.
//
// Bound on the card: memory. It reads the shard's 12 float32 planes (f,
// rho, vel) and writes 9, plus 3 halo rows (rho, vel) a side and, on a 2D
// mesh, 3 planes of two (h+2) x 2 column blocks; ~400 flops per cell.
// Design: the one-thread-per-cell body of fluid_b.cu; f is read at the
// cell only, so only rho and vel carry halo pieces.
#include "jrl_fluid.cuh"
#include "jrl_shard.cuh"

namespace {

using namespace jrl;

template <bool LEAN>
__global__ void __launch_bounds__(256) fluid_b_sh_kernel(
    ShardPlanes<float> f, ShardPlanes<float> rho, ShardPlanes<float> vel,
    float* __restrict__ f_out, int step, FluidBParams p, ShardGeom s) {
  const int lx = blockIdx.x * blockDim.x + threadIdx.x;
  const int ly = blockIdx.y * blockDim.y + threadIdx.y;
  if (lx >= s.w || ly >= s.h) return;
  const int y = s.row0 + ly, x = s.col0 + lx;
  const ShardState a{f, rho, vel, s, y, x};
  float fo[9];
  if (LEAN)
    fluid_b_cell(a, LeanGeo{p.H, p.W}, p, y, x, fo);
  else
    fluid_b_cell(a, fluid_geo(step, p), p, y, x, fo);
  const int hw = s.h * s.w, i = ly * s.w + lx;
#pragma unroll
  for (int q = 0; q < 9; ++q) f_out[q * hw + i] = fo[q];
}

}  // namespace

extern "C" int jrl_fluid_b_sh(const ShardPlanes<float>* f, const ShardPlanes<float>* rho,
                              const ShardPlanes<float>* vel, float* f_out, int step,
                              const FluidBParams* p, const ShardGeom* s, int lean, void* stream) {
  const dim3 block(128, 2);
  const dim3 grid((s->w + block.x - 1) / block.x, (s->h + block.y - 1) / block.y);
  const cudaStream_t st = (cudaStream_t)stream;
  if (lean)
    fluid_b_sh_kernel<true><<<grid, block, 0, st>>>(*f, *rho, *vel, f_out, step, *p, *s);
  else
    fluid_b_sh_kernel<false><<<grid, block, 0, st>>>(*f, *rho, *vel, f_out, step, *p, *s);
  return (int)cudaGetLastError();
}
