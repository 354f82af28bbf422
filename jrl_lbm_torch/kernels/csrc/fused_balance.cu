// JRL concentration balance, n steps in one launch: per step, streaming
// with the INFLOW / INFLOW_2 reservoirs and the OUTFLOW copy, C = sum h
// with OBSTACLE passthrough, BGK at u = 0 with the axisymmetric rate, then
// a grid-wide barrier.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl.py::
// _make_balance_kernel (called by _fused_balance_run). Its plain twin is
// jrl_lbm_torch/kernels/fused_jrl.py::fused_balance_ref, the loop of
// c_balance_ref; the per-cell code is jrl_c.cuh::balance_cell, shared with
// c_balance.cu.
//
// Bound on the card: at 128x64 the state (h, C and the flags: 11 planes)
// crosses device memory once per launch, so the bound is the ~230 float32
// operations per cell and step; the grid barrier a step costs far more.
// Design: the state lives in two ping-pong buffer sets in device memory
// (L2-resident across steps) under one persistent cooperative grid; each
// thread owns fixed cells, and since the flags are fixed it computes each
// cell's flag, OUTFLOW source and neighbour-obstacle mask once, before
// the step loop (as the Pallas kernel hoists its masks), and keeps them in
// registers.
#include "fused_launch.cuh"
#include "jrl_c.cuh"

namespace {

using namespace jrl;
namespace cg = cooperative_groups;

// Step i reads the buffer set step i - 1 wrote (the input for i = 0) and
// writes set P for even i, Q for odd i.
template <int CPT>
__global__ void __launch_bounds__(FUSED_BLOCK) fused_balance_kernel(
    const int* flags, const float* h_in, const float* C_in, float* hP, float* CP, float* hQ,
    float* CQ, int n, CBalanceParams p) {
  cg::grid_group grid = cg::this_grid();
  const int H = p.H, W = p.W, HW = H * W;
  const int threads = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const BalanceGeo g{GlobalPlane{flags, W}};
  BalanceCell cell[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int c = tid + j * threads;
    cell[j] = c < HW ? balance_cell_flags(g, H, W, c / W, c % W) : BalanceCell{0, 0, 0, 0u};
  }
  const float* h = h_in;
  const float* C = C_in;
  for (int i = 0; i < n; ++i) {
    float* hd = (i & 1) ? hQ : hP;
    float* Cd = (i & 1) ? CQ : CP;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tid + j * threads;
      if (c < HW) balance_cell(h, C, g, cell[j], p, c / W, c % W, hd, Cd);
    }
    grid.sync();
    h = hd;
    C = Cd;
  }
}

}  // namespace

extern "C" int jrl_fused_balance_max_blocks(int cpt, int block, int* out) {
  const auto k = JRL_FUSED_PICK(fused_balance_kernel, cpt);
  return k ? coresident_blocks(k, block, out) : (int)cudaErrorInvalidValue;
}

extern "C" int jrl_fused_balance(const int* flags, const float* h, const float* C, float* hP,
                                 float* CP, float* hQ, float* CQ, int n, const CBalanceParams* p,
                                 int cpt, int grid, void* stream) {
  const auto k = JRL_FUSED_PICK(fused_balance_kernel, cpt);
  if (!k) return (int)cudaErrorInvalidValue;
  CBalanceParams pp = *p;
  void* args[] = {&flags, &h, &C, &hP, &CP, &hQ, &CQ, &n, &pp};
  return launch_cooperative(k, grid, args, stream);
}
