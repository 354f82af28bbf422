// JRL fluid step B: BGK with the Guo-shifted gravity equilibrium and the
// LINE_X_EQ_0 axisymmetric source (A1, A2, F2), one thread per cell.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py::
// _make_kernel_b (body _fluid_b_update). Its plain twin is
// jrl_lbm_torch/kernels/jrl_fluid.py::fluid_b_ref. The per-cell code is
// jrl_fluid.cuh::fluid_b_cell, shared with fused_fluid.cu.
//
// Bound on the card: memory. It reads 12 float32 planes (f, rho, vel) and
// writes 9 per step, 13.1 us at 1024x512 and 3.35 TB/s, against ~400
// flops per cell. Design: the source's stencils (obstacle-pair
// blocked grad of u, v, p and A1; unblocked div of rho u u) read rho and
// vel of the 3x3 neighbourhood from global memory, where L1/L2 serve the
// reuse; the flags come from the same analytic tip geometry as step A,
// so no flag plane is read.
#include "jrl_fluid.cuh"

namespace {

using namespace jrl;

__global__ void __launch_bounds__(256) fluid_b_kernel(
    const float* __restrict__ f, const float* __restrict__ rho, const float* __restrict__ vel,
    float* __restrict__ f_out, int step, FluidBParams p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= p.W || y >= p.H) return;
  float fo[9];
  fluid_b_cell(GlobalState{f, rho, vel, p.H, p.W, y, x}, fluid_geo(step, p), p, y, x, fo);
  const int HW = p.H * p.W, i = y * p.W + x;
#pragma unroll
  for (int q = 0; q < 9; ++q) f_out[q * HW + i] = fo[q];
}

}  // namespace

extern "C" int jrl_fluid_b(const float* f, const float* rho, const float* vel, float* f_out,
                           int step, const FluidBParams* p, void* stream) {
  const dim3 block(128, 2);
  const dim3 grid((p->W + block.x - 1) / block.x, (p->H + block.y - 1) / block.y);
  fluid_b_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(f, rho, vel, f_out, step, *p);
  return (int)cudaGetLastError();
}
