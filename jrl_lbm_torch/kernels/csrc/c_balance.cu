// JRL concentration balance step: streaming with INFLOW (C = 0) and
// INFLOW_2 (C = 1) reservoirs and the OUTFLOW copy, C = sum h with
// OBSTACLE passthrough, and BGK at u = 0 with the per-direction
// axisymmetric rate 1/tau_D + (1 - 0.5/tau_D) e_x / r. One thread per cell.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py::
// _make_c_balance_kernel (streaming in _stream_c). Its plain twin is
// jrl_lbm_torch/kernels/jrl_c.py::c_balance_ref. The per-cell code is
// jrl_c.cuh::balance_cell, shared with fused_balance.cu.
//
// Bound on the card: memory. It reads 11 planes (flags, h, C) and writes
// 10, 13.1 us at 1024x512 and 3.35 TB/s, against ~230 flops per cell.
// Design: the balance flags are fixed, so they come in as one int32
// plane; neighbours are read from global memory (L1/L2 serve the
// reuse); an OUTFLOW cell recomputes its inward neighbour's streaming.
#include "jrl_c.cuh"

namespace {

using namespace jrl;

__global__ void __launch_bounds__(256) c_balance_kernel(
    const int* __restrict__ flags, const float* __restrict__ h, const float* __restrict__ C,
    float* __restrict__ h_out, float* __restrict__ C_out, CBalanceParams p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= p.W || y >= p.H) return;
  const BalanceGeo g{GlobalPlane{flags, p.W}};
  balance_cell(h, C, g, balance_cell_flags(g, p.H, p.W, y, x), p, y, x, h_out, C_out);
}

}  // namespace

extern "C" int jrl_c_balance(const int* flags, const float* h, const float* C, float* h_out,
                             float* C_out, const CBalanceParams* p, void* stream) {
  const dim3 block(128, 2);
  const dim3 grid((p->W + block.x - 1) / block.x, (p->H + block.y - 1) / block.y);
  c_balance_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(flags, h, C, h_out, C_out, *p);
  return (int)cudaGetLastError();
}
