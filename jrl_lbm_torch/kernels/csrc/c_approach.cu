// JRL concentration approach step: analytic moving tip (strict phi < 0
// for the wedge, a rectangle for flat tips, INFLOW sink on the head row),
// C zeroed inside the tip, streaming with sub-grid bounce, C = sum h
// (clamped to [0, 1] for flat tips), advection-diffusion BGK with the
// axisymmetric rate and source on the stored velocity, then the tip-disk
// integrals. One thread per cell, then one block for the integrals.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py::
// _make_c_approach_kernel (called by _c_one_approach_step). Its plain
// twin is jrl_lbm_torch/kernels/jrl_c.py::c_approach_ref.
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
#include "jrl_common.cuh"

// Launch constants, filled by the Python wrapper (ctypes.Structure).
struct CApproachParams {
  int H, W, rg, rint, inflow_h_int, flat, is_negative, clamp;
  float inflow_h, v, box_r, bcx, x1;
  float w_rate;  // 1 / tau_D
  float c_tau;   // 1 - 0.5 / tau_D
};

namespace {

using namespace jrl;

struct ApproachGeo {
  const int* base;
  const float* vel;  // interpolated stored velocity (not yet scaled by v)
  int H, W, rg, rint, inflow_h_int, walks_int;
  bool flat;
  float v;
  TipSdf sdf;

  __device__ float phi(int y, int x) const { return sdf.phi(y, x); }
  // models/jrl.py::_c_flags_at with strict=True
  __device__ int flag(int y, int x) const {
    const bool obs = flat ? (y < walks_int && x < rg)
                          : (phi(y, x) < 0.0f || (y < inflow_h_int && x < rg));
    int fl = obs ? OBSTACLE : base[y * W + x];
    if (y == walks_int - 1 && x < rint) fl = INFLOW;
    return fl;
  }
  __device__ bool tip_block(int y, int x) const { return y < walks_int && x < rg; }
  __device__ float cu(int y, int x) const {
    return tip_block(y, x) ? 0.0f : vel[y * W + x] * v;
  }
  __device__ float cv(int y, int x) const {
    return tip_block(y, x) ? v : vel[H * W + y * W + x] * v;
  }
  // INFLOW: feq(0, C_vel); INFLOW_2: feq(1, C_vel) with the local C_vel
  __device__ void inflow(int y, int x, int fl, float* out) const {
    if (fl != INFLOW && fl != INFLOW_2) return;
    const float rho_in = fl == INFLOW ? 0.0f : 1.0f;
    const float a = cu(y, x), b = cv(y, x);
#pragma unroll
    for (int q = 0; q < 9; ++q) out[q] = feq_q(q, rho_in, a, b);
  }
};

__device__ void make_geo(ApproachGeo& g, const int* base, const float* vel, int step,
                         const CApproachParams& p) {
  const float walks = tip_walks(step, p.inflow_h, p.v);
  g.base = base;
  g.vel = vel;
  g.H = p.H;
  g.W = p.W;
  g.rg = p.rg;
  g.rint = p.rint;
  g.inflow_h_int = p.inflow_h_int;
  g.walks_int = tip_row(walks);
  g.flat = p.flat != 0;
  g.v = p.v;
  g.sdf.bcx = p.bcx;
  g.sdf.box_r = p.box_r;
  g.sdf.x1 = p.x1;
  g.sdf.Hf = (float)p.H;
  g.sdf.flat = g.flat;
  g.sdf.with_top = p.is_negative != 0;
  g.sdf.set_walks(walks);
}

__global__ void __launch_bounds__(256) c_approach_kernel(
    const int* __restrict__ base, const float* __restrict__ h, const float* __restrict__ vel,
    float* __restrict__ h_out, float* __restrict__ C_out, int step, CApproachParams p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int H = p.H, W = p.W, HW = H * W;
  if (x >= W || y >= H) return;
  const int i = y * W + x;

  ApproachGeo g;
  make_geo(g, base, vel, step, p);
  const int fl = g.flag(y, x);

  float hs[9];
  int sy = y, sx = x;
  outflow_source(fl, H, W, sy, sx);
  stream_cell<true>(h, H, W, sy, sx, g, hs);

  // C is zeroed in the tip before streaming and OBSTACLE cells keep it, so
  // the new C never reads the old one
  float Cn;
  if (fl == OBSTACLE) {
    Cn = 0.0f;
  } else {
    Cn = hs[0];
#pragma unroll
    for (int q = 1; q < 9; ++q) Cn = Cn + hs[q];
  }
  if (p.clamp) Cn = fminf(fmaxf(Cn, 0.0f), 1.0f);
  C_out[i] = Cn;

  const float r = (float)x + 0.5f;
  const float a = g.cu(y, x), b = g.cv(y, x);
#pragma unroll
  for (int q = 0; q < 9; ++q)
    h_out[q * HW + i] =
        fl == OBSTACLE ? hs[q] : collide_conv_q(q, hs[q], Cn, a, b, r, p.w_rate, p.c_tau);
}

constexpr int DISK_THREADS = 128;

// Tip-disk integrals over rows walks_int - 1 .. walks_int + 1 of the new C
// (models/jrl.py::make_approach_step): the plain disk sums for the wedge,
// the dC_z + dC_r flux form for flat tips; rows clamp into [0, H-1] as
// the JAX package's dynamic_slice does. acc = (inflow_sum, current_sum,
// rec_u, rec_v).
__global__ void __launch_bounds__(DISK_THREADS) c_disk_kernel(
    const float* __restrict__ Cn, const float* __restrict__ vel,
    const float* __restrict__ area, float* __restrict__ acc, int step, CApproachParams p) {
  ApproachGeo g;
  make_geo(g, nullptr, vel, step, p);
  const int W = p.W, H = p.H;
  const int wi = g.walks_int;
  auto row = [H](int r_) { return r_ < 0 ? 0 : (r_ > H - 1 ? H - 1 : r_); };
  const int r_in = row(wi), r_cur = row(wi + 1);

  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int x = threadIdx.x; x < p.rint; x += DISK_THREADS) {
    const float ar = area[x];
    if (p.flat) {
      const float rx = (float)x + 0.5f, rx1 = (float)(x + 1) + 0.5f;
      const int rows[2] = {wi, wi + 1};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int rr = row(rows[k]), rm = row(rows[k] - 1);
        const float dCz = Cn[rr * W + x] - Cn[rm * W + x];
        const float rC0 = rx * Cn[rr * W + x];
        const float rC1 = rx1 * Cn[rr * W + x + 1];
        const float dCr = (rC1 - rC0) / rx;
        s[k] = s[k] + (dCz + dCr) * ar;
      }
    } else {
      s[0] = s[0] + Cn[r_in * W + x] * ar;
      s[1] = s[1] + Cn[r_cur * W + x] * ar;
    }
    s[2] = s[2] + g.cu(r_cur, x) * ar;
    s[3] = s[3] + g.cv(r_cur, x) * ar;
  }

  __shared__ float red[4][DISK_THREADS];
#pragma unroll
  for (int k = 0; k < 4; ++k) red[k][threadIdx.x] = s[k];
  __syncthreads();
  for (int half = DISK_THREADS / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        red[k][threadIdx.x] = red[k][threadIdx.x] + red[k][threadIdx.x + half];
    }
    __syncthreads();
  }
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
