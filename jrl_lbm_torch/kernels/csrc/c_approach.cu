// JRL concentration approach step: analytic moving tip (strict phi < 0
// for the wedge, a rectangle for flat tips, INFLOW sink on the head row),
// C zeroed inside the tip, streaming with sub-grid bounce, C = sum h
// (clamped to [0, 1] for flat tips), advection-diffusion BGK with the
// axisymmetric rate and source on the stored velocity, then the tip-disk
// integrals. One thread per cell, then one block for the integrals.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py::
// _make_c_approach_kernel (called by _c_one_approach_step). Its plain
// twin is jrl_lbm_torch/kernels/jrl_c.py::c_approach_ref. The per-cell
// code is jrl_c.cuh::approach_cell and disk_terms, shared with
// fused_approach.cu.
//
// Bound on the card: memory. The step kernel reads 12 planes (base flags,
// h, vel; the old C is never read, see below) and writes 10: 13.8 us at
// 1024x512 and 3.35 TB/s, against ~330 flops per cell. Design: tip flags
// and phi are computed from the base flags and the step at every cell a
// thread reads, so no per-step geometry plane exists; the stored-velocity
// frame pair is interpolated by PyTorch before the launch, as the JAX
// package does. The four
// integrals (inflow, current, rec_u, rec_v) need at most three rows of
// rint + 1 cells: a second launch of one block reads them from the new C,
// reduces in a fixed tree order (no atomics, so runs repeat bit for bit)
// and adds them into an accumulator on the card, so the runner never
// waits on the host between steps.
#include "jrl_c.cuh"

namespace {

using namespace jrl;

__global__ void __launch_bounds__(256) c_approach_kernel(
    const int* __restrict__ base, const float* __restrict__ h, const float* __restrict__ vel,
    float* __restrict__ h_out, float* __restrict__ C_out, int step, CApproachParams p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int H = p.H, W = p.W, HW = H * W;
  if (x >= W || y >= H) return;
  const int i = y * W + x;
  const PlaneVel pv{vel, HW};
  approach_cell(h, approach_geo(base, pv, step, p), p, y, x, pv.u(i), pv.v(i), h_out, C_out);
}

constexpr int DISK_THREADS = 128;

// Tip-disk integrals over rows walks_int - 1 .. walks_int + 1 of the new C
// (models/jrl.py::make_approach_step), added into acc = (inflow_sum,
// current_sum, rec_u, rec_v).
__global__ void __launch_bounds__(DISK_THREADS) c_disk_kernel(
    const float* __restrict__ Cn, const float* __restrict__ vel,
    const float* __restrict__ area, float* __restrict__ acc, int step, CApproachParams p) {
  const auto g = approach_geo(nullptr, PlaneVel{vel, p.H * p.W}, step, p);
  const int r_cur = disk_row(g.walks_int + 1, p.H);
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int x = threadIdx.x; x < p.rint; x += DISK_THREADS) {
    const float ar = area[x];
    float t_in, t_cur;
    disk_terms(Cn, p.H, p.W, g.walks_int, p.flat != 0, x, ar, t_in, t_cur);
    s[0] = s[0] + t_in;
    s[1] = s[1] + t_cur;
    s[2] = s[2] + g.cu(r_cur, x) * ar;
    s[3] = s[3] + g.cv(r_cur, x) * ar;
  }
  __shared__ float red[4][DISK_THREADS];
  block_sum4(red, s);
  if (threadIdx.x == 0) {
    acc[0] = acc[0] + red[0][0];
    acc[1] = acc[1] + red[1][0];
    acc[2] = red[2][0];
    acc[3] = red[3][0];
  }
}

}  // namespace

extern "C" int jrl_c_approach(const int* base, const float* h, const float* vel,
                              const float* area, float* h_out, float* C_out, float* acc,
                              int step, const CApproachParams* p, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(128, 2);
  const dim3 grid((p->W + block.x - 1) / block.x, (p->H + block.y - 1) / block.y);
  c_approach_kernel<<<grid, block, 0, s>>>(base, h, vel, h_out, C_out, step, *p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  c_disk_kernel<<<1, DISK_THREADS, 0, s>>>(C_out, vel, area, acc, step, *p);
  return (int)cudaGetLastError();
}
