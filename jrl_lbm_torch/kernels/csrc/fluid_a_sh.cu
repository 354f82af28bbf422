// JRL fluid step A on one shard of a (ny, nx) mesh: pull-streaming,
// moving-tip solid-fluid coupling and moments, one thread per body cell,
// with the neighbours beyond the shard read from its halo pieces. A LEAN
// instance serves shards above the tip front (no tip cell and no wall row
// in reach): every cell FLUID but the OUTFLOW column W-1.
//
// Replaces the TPU kernels jrl_lbm_tpu/ops/pallas/fused_jrl_sharded.py::
// _step_a (fused_jrl_tiled._make_kernel_a with shard=True, xw windows on a
// 2D mesh) and _step_a_lean (body _make_kernel_a_lean_sh). Its plain twin
// is jrl_lbm_torch/kernels/jrl_sharded.py::fluid_a_sh_ref. The per-cell
// code is jrl_fluid.cuh::fluid_a_cell, read through jrl_shard.cuh::
// ShardState in global coordinates, so a shard computes what fluid_a.cu
// computes on the whole grid, bit for bit.
//
// Bound on the card: memory. It moves the shard's 12 float32 planes in
// (f, rho, vel) and 12 out, plus 11 halo rows (f, vel) a side and, on a 2D
// mesh, 11 planes of two (h+2) x 2 column blocks; ~250 flops per cell away
// from the tip. Design: the one-thread-per-cell body of fluid_a.cu; the
// accessor picks body, row piece or column block per read, a branch that
// is uniform within a warp away from the shard's edge rows and columns.
#include "jrl_fluid.cuh"
#include "jrl_shard.cuh"

namespace {

using namespace jrl;

template <bool LEAN>
__global__ void __launch_bounds__(256) fluid_a_sh_kernel(
    ShardPlanes<float> f, ShardPlanes<float> rho, ShardPlanes<float> vel,
    float* __restrict__ f_out, float* __restrict__ rho_out, float* __restrict__ vel_out,
    int step, FluidParams p, ShardGeom s) {
  const int lx = blockIdx.x * blockDim.x + threadIdx.x;
  const int ly = blockIdx.y * blockDim.y + threadIdx.y;
  if (lx >= s.w || ly >= s.h) return;
  const int y = s.row0 + ly, x = s.col0 + lx;
  const ShardState a{f, rho, vel, s, y, x};
  float fo[9], r, u, v;
  if (LEAN)
    fluid_a_cell(a, LeanGeo{p.H, p.W}, p.cs2tau, y, x, fo, r, u, v);
  else
    fluid_a_cell(a, fluid_geo(step, p), p.cs2tau, y, x, fo, r, u, v);
  const int hw = s.h * s.w, i = ly * s.w + lx;
#pragma unroll
  for (int q = 0; q < 9; ++q) f_out[q * hw + i] = fo[q];
  rho_out[i] = r;
  vel_out[i] = u;
  vel_out[hw + i] = v;
}

}  // namespace

extern "C" int jrl_fluid_a_sh(const ShardPlanes<float>* f, const ShardPlanes<float>* rho,
                              const ShardPlanes<float>* vel, float* f_out, float* rho_out,
                              float* vel_out, int step, const FluidParams* p, const ShardGeom* s,
                              int lean, void* stream) {
  const dim3 block(128, 2);
  const dim3 grid((s->w + block.x - 1) / block.x, (s->h + block.y - 1) / block.y);
  const cudaStream_t st = (cudaStream_t)stream;
  if (lean)
    fluid_a_sh_kernel<true><<<grid, block, 0, st>>>(*f, *rho, *vel, f_out, rho_out, vel_out,
                                                    step, *p, *s);
  else
    fluid_a_sh_kernel<false><<<grid, block, 0, st>>>(*f, *rho, *vel, f_out, rho_out, vel_out,
                                                     step, *p, *s);
  return (int)cudaGetLastError();
}
