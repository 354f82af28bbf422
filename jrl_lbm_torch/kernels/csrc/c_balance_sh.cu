// JRL concentration balance step on one shard of a (ny, nx) mesh:
// streaming with INFLOW (C = 0) and INFLOW_2 (C = 1) reservoirs and the
// OUTFLOW copy, C = sum h with OBSTACLE passthrough, BGK at u = 0 with the
// axisymmetric rate; one thread per body cell, with h and the fixed flags
// beyond the shard read from their halo pieces.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl_sharded.py::
// _step_balance (fused_jrl_tiled._make_c_balance_kernel with shard=True,
// xw windows on a 2D mesh). Its plain twin is jrl_lbm_torch/kernels/
// jrl_sharded.py::c_balance_sh_ref. The per-cell code is jrl_c.cuh::
// balance_cell_at through jrl_shard.cuh::ShardState and ShardFlags, so a
// shard computes what c_balance.cu computes, bit for bit.
//
// Bound on the card: memory. It reads the shard's 11 planes (flags, h, C)
// and writes 10, plus 10 halo rows (flags, h) a side and, on a 2D mesh, 10
// planes of two (h+2) x 2 column blocks; ~230 flops per cell. Design: the
// one-thread-per-cell body of c_balance.cu; the flags are fixed, so the
// runner exchanges their pieces once a run.
#include "jrl_c.cuh"
#include "jrl_shard.cuh"

namespace {

using namespace jrl;

__global__ void __launch_bounds__(256) c_balance_sh_kernel(
    ShardPlanes<int> flags, ShardPlanes<float> h, const float* __restrict__ C,
    float* __restrict__ h_out, float* __restrict__ C_out, CBalanceParams p, ShardGeom s) {
  const int lx = blockIdx.x * blockDim.x + threadIdx.x;
  const int ly = blockIdx.y * blockDim.y + threadIdx.y;
  if (lx >= s.w || ly >= s.h) return;
  const int y = s.row0 + ly, x = s.col0 + lx;
  const BalanceGeoT<ShardFlags> g{ShardFlags{flags, s}};
  const BalanceCell c = balance_cell_flags(g, p.H, p.W, y, x);
  const int sy = c.src / p.W, sx = c.src % p.W;
  const ShardPlanes<float> none{};
  balance_cell_at(ShardState{h, none, none, s, sy, sx}, C, g, c, p, x, sy, sx, h_out, C_out,
                  ly * s.w + lx, s.h * s.w);
}

}  // namespace

extern "C" int jrl_c_balance_sh(const ShardPlanes<int>* flags, const ShardPlanes<float>* h,
                                const float* C, float* h_out, float* C_out,
                                const CBalanceParams* p, const ShardGeom* s, void* stream) {
  const dim3 block(128, 2);
  const dim3 grid((s->w + block.x - 1) / block.x, (s->h + block.y - 1) / block.y);
  c_balance_sh_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(*flags, *h, C, h_out, C_out, *p,
                                                                *s);
  return (int)cudaGetLastError();
}
