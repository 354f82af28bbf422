// JRL fluid step A: pull-streaming, moving-tip solid-fluid coupling and
// moments, one thread per cell.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py::
// _make_kernel_a (body _fluid_a_update, geometry _geometry). Its plain
// twin is jrl_lbm_torch/kernels/jrl_fluid.py::fluid_a_ref. The per-cell
// code is jrl_fluid.cuh::fluid_a_cell, shared with fused_fluid.cu.
//
// Bound on the card: memory. It moves 12 float32 planes in (f, rho, vel)
// and 12 out per step, 15 us at 1024x512 and 3.35 TB/s, against ~250
// flops per cell away from the tip (~2 us at the float32 peak; the few
// hundred cells next to the tip do a few times more). Design: the tip geometry
// (flags, phi, obstacle velocity) is analytic in the step index, so no
// geometry plane crosses memory; each thread reads its neighbours
// straight from global memory (the 9-point reuse is served by L1/L2); an
// OUTFLOW cell recomputes the streaming of its inward neighbour instead
// of reading another thread's output, which keeps the reference's
// second-pass semantics in one launch.
#include "jrl_fluid.cuh"

namespace {

using namespace jrl;

__global__ void __launch_bounds__(256) fluid_a_kernel(
    const float* __restrict__ f, const float* __restrict__ rho, const float* __restrict__ vel,
    float* __restrict__ f_out, float* __restrict__ rho_out, float* __restrict__ vel_out,
    int step, FluidParams p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= p.W || y >= p.H) return;
  float fo[9], r, u, v;
  fluid_a_cell(GlobalState{f, rho, vel, p.H, p.W, y, x}, fluid_geo(step, p), p.cs2tau, y, x, fo,
               r, u, v);
  const int HW = p.H * p.W, i = y * p.W + x;
#pragma unroll
  for (int q = 0; q < 9; ++q) f_out[q * HW + i] = fo[q];
  rho_out[i] = r;
  vel_out[i] = u;
  vel_out[HW + i] = v;
}

}  // namespace

extern "C" int jrl_fluid_a(const float* f, const float* rho, const float* vel, float* f_out,
                           float* rho_out, float* vel_out, int step, const FluidParams* p,
                           void* stream) {
  const dim3 block(128, 2);
  const dim3 grid((p->W + block.x - 1) / block.x, (p->H + block.y - 1) / block.y);
  fluid_a_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(f, rho, vel, f_out, rho_out,
                                                             vel_out, step, *p);
  return (int)cudaGetLastError();
}
