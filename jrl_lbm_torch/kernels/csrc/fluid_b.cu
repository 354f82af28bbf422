// JRL fluid step B: BGK with the Guo-shifted gravity equilibrium and the
// LINE_X_EQ_0 axisymmetric source (A1, A2, F2), one thread per cell.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py::
// _make_kernel_b (body _fluid_b_update). Its plain twin is
// jrl_lbm_torch/kernels/jrl_fluid.py::fluid_b_ref.
//
// Bound on the card: memory. It reads 12 float32 planes (f, rho, vel) and
// writes 9 per step, 13.1 us at 1024x512 and 3.35 TB/s, against ~400
// flops per cell. Design: the source's stencils (obstacle-pair
// blocked grad of u, v, p and A1; unblocked div of rho u u) read rho and
// vel of the 3x3 neighbourhood from global memory, where L1/L2 serve the
// reuse; the flags come from the same analytic tip geometry as step A,
// so no flag plane is read.
#include "jrl_common.cuh"

// Launch constants, filled by the Python wrapper (ctypes.Structure).
struct FluidBParams {
  int H, W, rg, flat;
  float inflow_h, vel_obs, box_r, bcx, x1;
  float w_rate;  // 1 / tau
  float visc;    // cs2 (tau - 0.5)
  float ctau;    // dt (tau - 1) cs2
  float fx, fy;  // constant body force (rho0 = 1 times gravity)
};

namespace {

using namespace jrl;

struct Flags {
  int H, W, rg, walks_int;
  bool flat;
  TipSdf sdf;
  __device__ int flag(int y, int x) const {
    const bool tip = flat ? (y < walks_int && x < rg) : (sdf.phi(y, x) <= 0.0f);
    if (tip || y == H - 1) return OBSTACLE;
    if (x == 0) return FLUID;
    if (y == 0 || x == W - 1) return OUTFLOW;
    return FLUID;
  }
};

// x component of ops/stencil.py::get_grad (before the /12): a pair with an
// OBSTACLE member contributes nothing and zeroes the component.
__device__ __forceinline__ float grad_x(const float a[3][3], const bool o[3][3]) {
#define V(sx, sy) a[(sy) + 1][(sx) + 1]
#define O(sx, sy) o[(sy) + 1][(sx) + 1]
  const bool p1 = O(1, 0) || O(-1, 0);
  const bool p2 = O(1, 1) || O(-1, 1);
  const bool p3 = O(-1, -1) || O(1, -1);
  float g = 0.0f;
  g = g + (p1 ? 0.0f : 4.0f * (V(1, 0) - V(-1, 0)));
  g = g + (p2 ? 0.0f : V(1, 1) - V(-1, 1));
  g = g + (p3 ? 0.0f : V(1, -1) - V(-1, -1));
  return (p1 || p2 || p3) ? 0.0f : g;
}
__device__ __forceinline__ float grad_y(const float a[3][3], const bool o[3][3]) {
  const bool p1 = O(0, 1) || O(0, -1);
  const bool p2 = O(1, 1) || O(1, -1);
  const bool p3 = O(-1, 1) || O(-1, -1);
  float g = 0.0f;
  g = g + (p1 ? 0.0f : 4.0f * (V(0, 1) - V(0, -1)));
  g = g + (p2 ? 0.0f : V(1, 1) - V(1, -1));
  g = g + (p3 ? 0.0f : V(-1, 1) - V(-1, -1));
  return (p1 || p2 || p3) ? 0.0f : g;
}
// ops/stencil.py::get_div before the /12
__device__ __forceinline__ float div2(const float m0[3][3], const float m1[3][3]) {
  float d = 4.0f * (m0[1][2] - m0[1][0]);
  d = d + m0[2][2] - m0[2][0];
  d = d + m0[0][2] - m0[0][0];
  d = d + 4.0f * (m1[2][1] - m1[0][1]);
  d = d + m1[2][2] - m1[0][2];
  d = d + m1[2][0] - m1[0][0];
  return d;
#undef V
#undef O
}

__global__ void __launch_bounds__(256) fluid_b_kernel(
    const float* __restrict__ f, const float* __restrict__ rho, const float* __restrict__ vel,
    float* __restrict__ f_out, int step, FluidBParams p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int H = p.H, W = p.W, HW = H * W;
  if (x >= W || y >= H) return;
  const int i = y * W + x;

  const float walks = tip_walks(step, p.inflow_h, p.vel_obs);
  Flags g;
  g.H = H;
  g.W = W;
  g.rg = p.rg;
  g.walks_int = tip_row(walks);
  g.flat = p.flat != 0;
  g.sdf.bcx = p.bcx;
  g.sdf.box_r = p.box_r;
  g.sdf.x1 = p.x1;
  g.sdf.Hf = (float)H;
  g.sdf.flat = g.flat;
  g.sdf.with_top = true;
  g.sdf.set_walks(walks);

  const int fl = g.flag(y, x);
  if (fl == OBSTACLE) {
#pragma unroll
    for (int q = 0; q < 9; ++q) f_out[q * HW + i] = f[q * HW + i];
    return;
  }
  const bool fluid = fl == FLUID;

  // 3x3 neighbourhood of u, v, p = rho cs2, rho u u, rho u v and A1
  float nu[3][3], nv[3][3], np_[3][3], m0[3][3], m1[3][3], a1[3][3];
  bool no[3][3];
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int nx = at_x(x, dx, fluid, W), ny = at_y(y, dy, fluid, H);
      const int j = ny * W + nx;
      const float r_ = rho[j], u_ = vel[j], v_ = vel[HW + j];
      const float rn = (float)nx + 0.5f;
      nu[dy + 1][dx + 1] = u_;
      nv[dy + 1][dx + 1] = v_;
      np_[dy + 1][dx + 1] = r_ * CS2F;
      m0[dy + 1][dx + 1] = (r_ * u_) * u_;
      m1[dy + 1][dx + 1] = (r_ * u_) * v_;
      a1[dy + 1][dx + 1] = ((-r_) * u_) / rn;
      no[dy + 1][dx + 1] = g.flag(ny, nx) == OBSTACLE;
    }

  const float rho_c = rho[i], u = vel[i], v = vel[HW + i];
  const float r = (float)x + 0.5f;
  const float A1 = ((-rho_c) * u) / r;
  const float mu = p.visc * rho_c;
  const float gu_x = grad_x(nu, no) / 12.0f;
  const float gv_x = grad_x(nv, no) / 12.0f;
  const float gp_x = grad_x(np_, no) / 12.0f;
  const float dm = div2(m0, m1) / 12.0f;
  const float A2 = (gp_x + dm) * (1.0f / (2.0f * r));
  const float ga_x = grad_x(a1, no) / 12.0f;
  const float ga_y = grad_y(a1, no) / 12.0f;
  float F0 = (mu / r) * (gu_x - u / r);
  float F1 = (mu / r) * gv_x;
  F0 = F0 + u * A1;
  F1 = F1 + v * A1;
  F0 = F0 - p.ctau * ga_x;
  F1 = F1 - p.ctau * ga_y;

  // feq with the Guo half-force shift u + F / (2 rho), none where rho <= 1e-10
  const bool tiny = rho_c <= (float)1e-10;
  const float us = u + (tiny ? 0.0f : (0.5f * p.fx) / rho_c);
  const float vs = v + (tiny ? 0.0f : (0.5f * p.fy) / rho_c);
  const float base = A1 + A2;
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const float fq = f[q * HW + i];
    const float fe = feq_q(q, rho_c, us, vs);
    const float F2e = (float)ex_of(q) * F0 + (float)ey_of(q) * F1;
    const float Gi = (base + F2e / CS2F) * wq(q);
    f_out[q * HW + i] = (fq + p.w_rate * (fe - fq)) + Gi;
  }
}

}  // namespace

extern "C" int jrl_fluid_b(const float* f, const float* rho, const float* vel, float* f_out,
                           int step, const FluidBParams* p, void* stream) {
  const dim3 block(128, 2);
  const dim3 grid((p->W + block.x - 1) / block.x, (p->H + block.y - 1) / block.y);
  fluid_b_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(f, rho, vel, f_out, step, *p);
  return (int)cudaGetLastError();
}
