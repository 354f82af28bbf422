// JRL fluid step A: pull-streaming, moving-tip solid-fluid coupling and
// moments, one thread per cell.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py::
// _make_kernel_a (body _fluid_a_update, geometry _geometry). Its plain
// twin is jrl_lbm_torch/kernels/jrl_fluid.py::fluid_a_ref.
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
#include "jrl_common.cuh"

// Launch constants, filled by the Python wrapper (ctypes.Structure).
struct FluidParams {
  int H, W, rg, flat;
  float inflow_h, vel_obs, box_r, bcx, x1;
  float cs2tau;  // cs2 * tau
};

namespace {

using namespace jrl;

struct FluidGeo {
  const float* vel;
  int H, W, rg, walks_int;
  bool flat;
  float vel_obs;
  TipSdf sdf;

  __device__ int base(int y, int x) const {
    // models/jrl.py::fluid_base_flags: top row OBSTACLE, axis column
    // FLUID, row 0 and column W-1 OUTFLOW, interior FLUID
    if (y == H - 1) return OBSTACLE;
    if (x == 0) return FLUID;
    if (y == 0 || x == W - 1) return OUTFLOW;
    return FLUID;
  }
  __device__ float phi(int y, int x) const { return sdf.phi(y, x); }
  __device__ bool tip(int y, int x) const {
    return flat ? (y < walks_int && x < rg) : (phi(y, x) <= 0.0f);
  }
  __device__ int flag(int y, int x) const { return tip(y, x) ? OBSTACLE : base(y, x); }
  // y component of the obstacle velocity (x component is zero); the
  // wedge's top row stays at rest
  __device__ float obs_v(int y, int x) const {
    return (tip(y, x) && (flat || y != H - 1)) ? vel_obs : 0.0f;
  }
  // velocity with the tip override applied before streaming
  __device__ float u(int y, int x) const { return tip(y, x) ? 0.0f : vel[y * W + x]; }
  __device__ float v(int y, int x) const {
    return tip(y, x) ? obs_v(y, x) : vel[H * W + y * W + x];
  }
  __device__ void inflow(int, int, int, float*) const {}  // no INFLOW cells in the fluid phase
};

__global__ void __launch_bounds__(256) fluid_a_kernel(
    const float* __restrict__ f, const float* __restrict__ rho, const float* __restrict__ vel,
    float* __restrict__ f_out, float* __restrict__ rho_out, float* __restrict__ vel_out,
    int step, FluidParams p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int H = p.H, W = p.W, HW = H * W;
  if (x >= W || y >= H) return;

  const float walks = tip_walks(step, p.inflow_h, p.vel_obs);
  FluidGeo g;
  g.vel = vel;
  g.H = H;
  g.W = W;
  g.rg = p.rg;
  g.walks_int = tip_row(walks);
  g.flat = p.flat != 0;
  g.vel_obs = p.vel_obs;
  g.sdf.bcx = p.bcx;
  g.sdf.box_r = p.box_r;
  g.sdf.x1 = p.x1;
  g.sdf.Hf = (float)H;
  g.sdf.flat = g.flat;
  g.sdf.with_top = true;
  g.sdf.set_walks(walks);

  const int fl = g.flag(y, x);
  const bool fluid = fl == FLUID;
  const bool obs = fl == OBSTACLE;

  // ---- streaming (+ OUTFLOW copy of the inward neighbour) ----
  float fs[9];
  int sy = y, sx = x;
  outflow_source(fl, H, W, sy, sx);
  stream_cell<true>(f, H, W, sy, sx, g, fs);

  // ---- solid-fluid coupling (ops/coupling.py::solve_boundary) ----
  const bool skip = obs || x == W - 1 || y == H - 1;
  float vtx = 0.0f, vty = 0.0f, count = 0.0f, rho_tgt = 0.0f;
  bool valid[9];
  if (!skip) {
    const float t = g.phi(y, x);
    const bool t_ok = (t > (float)-1e-10) && (t <= (float)(1.0 + 1e-10));
    rho_tgt = fs[0];
#pragma unroll
    for (int q = 1; q < 9; ++q) rho_tgt = rho_tgt + fs[q];
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const int ex = ex_of(q), ey = ey_of(q);
      const int ox = at_x(x, ex, fluid, W), oy = at_y(y, ey, fluid, H);
      valid[q] = t_ok && g.flag(oy, ox) == OBSTACLE;
      if (valid[q]) {
        count = count + 1.0f;
        const int ux_ = at_x(x, -ex, fluid, W), uy_ = at_y(y, -ey, fluid, H);
        float ux = g.u(uy_, ux_);
        const float uy = g.v(uy_, ux_);
        if (x == 0 && axis_x_in(q)) ux = -ux;
        const float obs_ux = 0.0f;
        const float obs_uy = g.obs_v(oy, ox);
        vtx = vtx + (t * ux + obs_ux) / (t + 1.0f);
        vty = vty + (t * uy + obs_uy) / (t + 1.0f);
        const int qi = refl(q);
        rho_tgt = rho_tgt + (6.0f * wq(q)) *
                                ((float)ex_of(qi) * obs_ux + (float)ey_of(qi) * obs_uy);
      }
    }
  }
  // a cell with no valid direction keeps its streamed populations; the
  // gradient and reconstruction below would be computed and discarded
  if (!skip && count > 0.0f) {
    const float u0 = vtx / count;
    const float u1 = vty / count;

    // 12-point gradient of the overridden velocity, no obstacle masking
    float a0[3][3], a1[3][3];  // [sy + 1][sx + 1]
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int nx = at_x(x, dx, fluid, W), ny = at_y(y, dy, fluid, H);
        a0[dy + 1][dx + 1] = g.u(ny, nx);
        a1[dy + 1][dx + 1] = g.v(ny, nx);
      }
#define A(a, sx_, sy_) a[(sy_) + 1][(sx_) + 1]
    const float g00 = ((4.0f * (A(a0, 1, 0) - A(a0, -1, 0)) + (A(a0, 1, 1) - A(a0, -1, 1))) +
                       (A(a0, 1, -1) - A(a0, -1, -1))) / 12.0f;
    const float g01 = ((4.0f * (A(a0, 0, 1) - A(a0, 0, -1)) + (A(a0, 1, 1) - A(a0, 1, -1))) +
                       (A(a0, -1, 1) - A(a0, -1, -1))) / 12.0f;
    const float g10 = ((4.0f * (A(a1, 1, 0) - A(a1, -1, 0)) + (A(a1, 1, 1) - A(a1, -1, 1))) +
                       (A(a1, 1, -1) - A(a1, -1, -1))) / 12.0f;
    const float g11 = ((4.0f * (A(a1, 0, 1) - A(a1, 0, -1)) + (A(a1, 1, 1) - A(a1, 1, -1))) +
                       (A(a1, -1, 1) - A(a1, -1, -1))) / 12.0f;
#undef A
    const float t1 = u0 * u0 - p.cs2tau * (g00 + g00);
    const float t2 = u1 * u0 - p.cs2tau * (g10 + g01);
    const float t3 = u0 * u1 - p.cs2tau * (g01 + g10);
    const float t4 = u1 * u1 - p.cs2tau * (g11 + g11);
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      if (!valid[q]) continue;
      const int qi = refl(q);
      const int e0i = ex_of(qi), e1i = ey_of(qi);
      const float e0 = (float)e0i, e1 = (float)e1i;
      const float c1 = e0i != 0 ? (float)(1.0 - 1.0 / 3.0) : (float)(0.0 - 1.0 / 3.0);
      const float c4 = e1i != 0 ? (float)(1.0 - 1.0 / 3.0) : (float)(0.0 - 1.0 / 3.0);
      float pab = t1 * c1;
      pab = pab + t2 * (e1 * e0);
      pab = pab + t3 * (e0 * e1);
      pab = pab + t4 * c4;
      fs[qi] = (wq(qi) * rho_tgt) *
               ((1.0f + THREE * (u0 * e0 + u1 * e1)) + (0.5f * pab) / CS4F);
    }
  }

  // ---- moments (ops/macro.py::macro_compute), OBSTACLE passthrough ----
  float m = fs[0];
#pragma unroll
  for (int q = 1; q < 9; ++q) m = m + fs[q];
  const float rho_n = obs ? rho[y * W + x] : m;
  const float mom_x = fs[1] - fs[3] + fs[5] - fs[6] - fs[7] + fs[8];
  const float mom_y = fs[2] - fs[4] + fs[5] + fs[6] - fs[7] - fs[8];
  const float safe_rho = rho_n == 0.0f ? 1.0f : rho_n;
  const float inv = 1.0f / safe_rho;
  const int i = y * W + x;
#pragma unroll
  for (int q = 0; q < 9; ++q) f_out[q * HW + i] = fs[q];
  rho_out[i] = rho_n;
  vel_out[i] = obs ? g.u(y, x) : mom_x * inv;
  vel_out[HW + i] = obs ? g.v(y, x) : mom_y * inv;
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
