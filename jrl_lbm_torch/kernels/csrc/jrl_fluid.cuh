// Per-cell device code of the JRL fluid step, shared by the per-step
// kernels (fluid_a.cu, fluid_b.cu), the multi-step kernel (fused_fluid.cu)
// and the k-step tile kernels (fluid_k.cu, fluid_k_lean.cu, fluid_k_bt.cu,
// through jrl_tile.cuh), so that all of them round alike.
//
// Step A: pull-streaming, moving-tip solid-fluid coupling and moments.
// Step B: BGK with the Guo-shifted gravity equilibrium and the LINE_X_EQ_0
// axisymmetric source (A1, A2, F2). The tip geometry (flags, phi,
// obstacle velocity) is analytic in the step index, so no geometry plane
// crosses memory.
//
// The cell code reads the state through an accessor positioned at its cell
// (GlobalState for device memory, jrl_tile.cuh::TileState for a shared-
// memory tile) and the geometry through a policy: FluidGeo (the moving tip,
// every tile), LeanGeo (interior tiles with no tip cell and no wall row in
// reach) or BtGeo (flat-tip tiles wholly under the tip row). Under the
// conditions of the lean and below-tip classes the three policies give the
// same flags, so the class kernels compute what the full kernel computes,
// with the obstacle machinery folded away at compile time.
#pragma once

#include "jrl_common.cuh"

// Launch constants of step A, filled by the Python wrapper (ctypes.Structure).
struct FluidParams {
  int H, W, rg, flat;
  float inflow_h, vel_obs, box_r, bcx, x1;
  float cs2tau;  // cs2 * tau
};

// Launch constants of step B, filled by the Python wrapper (ctypes.Structure).
struct FluidBParams {
  int H, W, rg, flat;
  float inflow_h, vel_obs, box_r, bcx, x1;
  float w_rate;  // 1 / tau
  float visc;    // cs2 (tau - 0.5)
  float ctau;    // dt (tau - 1) cs2
  float fx, fy;  // constant body force (rho0 = 1 times gravity)
};

namespace jrl {

// Tip SDF of the fluid phase at `step` (the top wall is always part of it).
__device__ __forceinline__ TipSdf fluid_sdf(float walks, int H, int flat, float box_r,
                                            float bcx, float x1) {
  TipSdf s;
  s.bcx = bcx;
  s.box_r = box_r;
  s.x1 = x1;
  s.Hf = (float)H;
  s.flat = flat != 0;
  s.with_top = true;
  s.set_walks(walks);
  return s;
}

// The moving tip at one step.
struct FluidGeo {
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
  // the stored velocity `raw` of cell (y, x) with the tip override applied
  // before streaming
  __device__ float u(int y, int x, float raw) const { return tip(y, x) ? 0.0f : raw; }
  __device__ float v(int y, int x, float raw) const { return tip(y, x) ? obs_v(y, x) : raw; }
  __device__ void inflow(int, int, int, float*) const {}  // no INFLOW cells in the fluid phase
};

// The geometry at `step` (P: FluidParams or FluidBParams).
template <class P>
__device__ __forceinline__ FluidGeo fluid_geo(int step, const P& p) {
  const float walks = tip_walks(step, p.inflow_h, p.vel_obs);
  FluidGeo g;
  g.H = p.H;
  g.W = p.W;
  g.rg = p.rg;
  g.walks_int = tip_row(walks);
  g.flat = p.flat != 0;
  g.vel_obs = p.vel_obs;
  g.sdf = fluid_sdf(walks, p.H, p.flat, p.box_r, p.bcx, p.x1);
  return g;
}

// Lean class (fused_jrl_tiled.py::_fluid_a_lean, _fluid_b_lean): no tip
// cell and no wall row within reach, so every cell is FLUID but the
// OUTFLOW column W-1; nothing reads phi, rho or vel of the previous step.
struct LeanGeo {
  int H, W;
  __device__ int flag(int, int x) const { return x == W - 1 ? OUTFLOW : FLUID; }
  __device__ float phi(int, int) const { return 0.0f; }
  __device__ float obs_v(int, int) const { return 0.0f; }
  __device__ float u(int, int, float raw) const { return raw; }
  __device__ float v(int, int, float raw) const { return raw; }
  __device__ void inflow(int, int, int, float*) const {}
};

// Below-tip class of flat tips (fused_jrl_tiled.py::_fluid_a_bt,
// _fluid_b_bt): every row in reach lies under the tip row and off the
// walls, so the tip is the columns x < rg on every row, phi reduces to the
// column distance where anything reads it, and no step index is needed.
struct BtGeo {
  int H, W, rg;
  float vel_obs, bcx, box_r;
  __device__ int flag(int, int x) const {
    return x < rg ? OBSTACLE : (x == W - 1 ? OUTFLOW : FLUID);
  }
  __device__ float phi(int, int x) const { return (((float)x + 0.5f) - bcx) - box_r; }
  __device__ float obs_v(int, int x) const { return x < rg ? vel_obs : 0.0f; }
  __device__ float u(int, int x, float raw) const { return x < rg ? 0.0f : raw; }
  __device__ float v(int, int x, float raw) const { return x < rg ? vel_obs : raw; }
  __device__ void inflow(int, int, int, float*) const {}
};

// Fluid step A at cell (y, x): reads f, rho and vel of the pre-step state
// through `a` (positioned at the cell), returns the cell's new f, rho and
// vel. An OUTFLOW cell recomputes the streaming of its inward neighbour
// instead of reading another thread's output, which keeps the reference's
// second-pass semantics in one pass.
template <class Acc, class Geo>
__device__ __forceinline__ void fluid_a_cell(const Acc& a, const Geo& g, float cs2tau, int y,
                                             int x, float fs[9], float& rho_n, float& u_n,
                                             float& v_n) {
  const int H = g.H, W = g.W;
  const int fl = g.flag(y, x);
  const bool fluid = fl == FLUID;
  const bool obs = fl == OBSTACLE;

  // ---- streaming (+ OUTFLOW copy of the inward neighbour) ----
  int oy, ox;
  outflow_offset(fl, H, W, y, x, oy, ox);
  stream_cell<true>(a.at(oy, ox), H, W, y + oy, x + ox, g, fs);

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
      const int ox_ = at_x(x, ex, fluid, W), oy_ = at_y(y, ey, fluid, H);
      valid[q] = t_ok && g.flag(oy_, ox_) == OBSTACLE;
      if (valid[q]) {
        count = count + 1.0f;
        const int udx = at_dx(x, -ex, fluid, W), udy = at_dy(y, -ey, fluid, H);
        const int ux_ = wrap1(x + udx, W), uy_ = wrap1(y + udy, H);
        float ux = g.u(uy_, ux_, a.U(udy, udx));
        const float uy = g.v(uy_, ux_, a.V(udy, udx));
        if (x == 0 && axis_x_in(q)) ux = -ux;
        const float obs_ux = 0.0f;
        const float obs_uy = g.obs_v(oy_, ox_);
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
        const int ndx = at_dx(x, dx, fluid, W), ndy = at_dy(y, dy, fluid, H);
        const int nx = wrap1(x + ndx, W), ny = wrap1(y + ndy, H);
        a0[dy + 1][dx + 1] = g.u(ny, nx, a.U(ndy, ndx));
        a1[dy + 1][dx + 1] = g.v(ny, nx, a.V(ndy, ndx));
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
    const float t1 = u0 * u0 - cs2tau * (g00 + g00);
    const float t2 = u1 * u0 - cs2tau * (g10 + g01);
    const float t3 = u0 * u1 - cs2tau * (g01 + g10);
    const float t4 = u1 * u1 - cs2tau * (g11 + g11);
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
  rho_n = obs ? a.R(0, 0) : m;
  const float mom_x = fs[1] - fs[3] + fs[5] - fs[6] - fs[7] + fs[8];
  const float mom_y = fs[2] - fs[4] + fs[5] + fs[6] - fs[7] - fs[8];
  const float safe_rho = rho_n == 0.0f ? 1.0f : rho_n;
  const float inv = 1.0f / safe_rho;
  u_n = obs ? g.u(y, x, a.U(0, 0)) : mom_x * inv;
  v_n = obs ? g.v(y, x, a.V(0, 0)) : mom_y * inv;
}

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

// Fluid step B at cell (y, x): reads the post-moment f (this cell only),
// rho and vel (3x3 neighbourhood) through `a`, returns the cell's
// collided f. A caller may write it over the f it read: each population is
// read before it is written, and no other cell reads it.
template <class Acc, class Geo>
__device__ __forceinline__ void fluid_b_cell(const Acc& a, const Geo& g, const FluidBParams& p,
                                             int y, int x, float fo[9]) {
  const int H = p.H, W = p.W;
  const int fl = g.flag(y, x);
  if (fl == OBSTACLE) {
#pragma unroll
    for (int q = 0; q < 9; ++q) fo[q] = a.F(q, 0, 0);
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
      const int ndx = at_dx(x, dx, fluid, W), ndy = at_dy(y, dy, fluid, H);
      const int nx = wrap1(x + ndx, W), ny = wrap1(y + ndy, H);
      const float r_ = a.R(ndy, ndx), u_ = a.U(ndy, ndx), v_ = a.V(ndy, ndx);
      const float rn = (float)nx + 0.5f;
      nu[dy + 1][dx + 1] = u_;
      nv[dy + 1][dx + 1] = v_;
      np_[dy + 1][dx + 1] = r_ * CS2F;
      m0[dy + 1][dx + 1] = (r_ * u_) * u_;
      m1[dy + 1][dx + 1] = (r_ * u_) * v_;
      a1[dy + 1][dx + 1] = ((-r_) * u_) / rn;
      no[dy + 1][dx + 1] = g.flag(ny, nx) == OBSTACLE;
    }

  const float rho_c = a.R(0, 0), u = a.U(0, 0), v = a.V(0, 0);
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
    const float fq = a.F(q, 0, 0);
    const float fe = feq_q(q, rho_c, us, vs);
    const float F2e = (float)ex_of(q) * F0 + (float)ey_of(q) * F1;
    const float Gi = (base + F2e / CS2F) * wq(q);
    fo[q] = (fq + p.w_rate * (fe - fq)) + Gi;
  }
}

}  // namespace jrl
