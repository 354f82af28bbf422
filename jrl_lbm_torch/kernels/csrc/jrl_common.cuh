// Device helpers shared by the JRL kernels, per-step and multi-step
// (D2Q9, float32, layout f[q][y][x] with x fastest, as the PyTorch side
// stores [9, H, W]).
//
// No pointer here is __restrict__: a multi-step kernel reads, after a
// grid-wide barrier, state that other threads wrote earlier in the same
// launch, which the read-only (non-coherent) load path may not serve.
//
// Arithmetic follows the plain PyTorch twins (and the JAX package's jnp
// step) operation by operation, in the same order and with the same
// float32 constants. The sources are built with --fmad=false, so no
// multiply-add is contracted and every step rounds where the twin's
// does; what remains between kernel and twin is the order of a few sums.
//
// The symmetry axis is always x = 0 (AxiSymmetricType.LINE_X_EQ_0): every
// JRL phase runs axisymmetric about it.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "exact_div.cuh"

namespace jrl {

constexpr int FLUID = 1;
constexpr int OBSTACLE = 2;
constexpr int INFLOW = 8;
constexpr int OUTFLOW = 16;
constexpr int INFLOW_2 = 32;

// CS2F, CS4F: exact_div.cuh
constexpr float THREE = (float)(1.0 / (1.0 / 3.0));

__device__ __forceinline__ int ex_of(int q) {
  return (q == 1 || q == 5 || q == 8) ? 1 : ((q == 3 || q == 6 || q == 7) ? -1 : 0);
}
__device__ __forceinline__ int ey_of(int q) {
  return (q == 2 || q == 5 || q == 6) ? 1 : ((q == 4 || q == 7 || q == 8) ? -1 : 0);
}
__device__ __forceinline__ int refl(int q) {
  // 0 3 4 1 2 7 8 5 6
  return q == 0 ? 0 : (q <= 4 ? ((q + 1) & 3) + 1 : ((q - 3) & 3) + 5);
}
__device__ __forceinline__ int mirror_x(int q) {
  // 0 3 2 1 4 6 5 8 7
  return (q == 1) ? 3 : (q == 3) ? 1 : (q == 5) ? 6 : (q == 6) ? 5
       : (q == 7) ? 8 : (q == 8) ? 7 : q;
}
__device__ __forceinline__ bool axis_x_in(int q) { return q == 1 || q == 5 || q == 8; }
__device__ __forceinline__ bool axis_x_out(int q) { return q == 3 || q == 6 || q == 7; }
__device__ __forceinline__ float wq(int q) {
  return q == 0 ? (float)(4.0 / 9.0) : (q <= 4 ? (float)(1.0 / 9.0) : (float)(1.0 / 36.0));
}

// v in [0, n) for v in [-n, 2n).
__device__ __forceinline__ int wrap1(int v, int n) { return v < 0 ? v + n : (v >= n ? v - n : v); }

// Streaming neighbour (value at (y, x) pulled from (y - ey, x - ex)) as an
// offset from the cell, taken mod H / W: FLUID cells wrap, other cells
// reflect-clamp, and the x-1 pull collapses onto the axis column
// (ops/stream.py::_pull).
__device__ __forceinline__ int pull_dx(int x, int ex, bool fluid, int W) {
  if (ex == 1) return x == 0 ? 0 : -1;
  if (ex == -1) return (x == W - 1 && !fluid) ? -1 : 1;
  return 0;
}
__device__ __forceinline__ int pull_dy(int y, int ey, bool fluid, int H) {
  if (ey == 1) return (y == 0 && !fluid) ? 1 : -1;
  if (ey == -1) return (y == H - 1 && !fluid) ? -1 : 1;
  return 0;
}

// Stencil neighbour (value at (y + sy, x + sx)) as an offset: FLUID cells
// wrap, other cells clamp min/max, and x-1 collapses onto the axis
// (ops/stencil.py::_at).
__device__ __forceinline__ int at_dx(int x, int sx, bool fluid, int W) {
  if (sx == -1) return x == 0 ? 0 : -1;
  if (sx == 1) return (x == W - 1 && !fluid) ? 0 : 1;
  return 0;
}
__device__ __forceinline__ int at_dy(int y, int sy, bool fluid, int H) {
  if (sy == -1) return (y == 0 && !fluid) ? 0 : -1;
  if (sy == 1) return (y == H - 1 && !fluid) ? 0 : 1;
  return 0;
}

// The same neighbours as grid coordinates (for the geometry).
__device__ __forceinline__ int pull_x(int x, int ex, bool fluid, int W) {
  return wrap1(x + pull_dx(x, ex, fluid, W), W);
}
__device__ __forceinline__ int pull_y(int y, int ey, bool fluid, int H) {
  return wrap1(y + pull_dy(y, ey, fluid, H), H);
}
__device__ __forceinline__ int at_x(int x, int sx, bool fluid, int W) {
  return wrap1(x + at_dx(x, sx, fluid, W), W);
}
__device__ __forceinline__ int at_y(int y, int sy, bool fluid, int H) {
  return wrap1(y + at_dy(y, sy, fluid, H), H);
}

// State read around cell (y, x) from device memory ([Q][H][W] planes),
// offsets taken mod H / W. The per-cell code reads every value through an
// accessor, relative to its cell, so that the same code runs on device
// memory (one step per launch) and on a shared-memory tile (k steps per
// launch, jrl_tile.cuh). rho and vel may be null where nothing reads them.
struct GlobalState {
  const float* f;
  const float* rho;
  const float* vel;
  int H, W, y, x;
  __device__ __forceinline__ int idx(int dy, int dx) const {
    return wrap1(y + dy, H) * W + wrap1(x + dx, W);
  }
  __device__ __forceinline__ float F(int q, int dy, int dx) const {
    return f[q * H * W + idx(dy, dx)];
  }
  __device__ __forceinline__ float R(int dy, int dx) const { return rho[idx(dy, dx)]; }
  __device__ __forceinline__ float U(int dy, int dx) const { return vel[idx(dy, dx)]; }
  __device__ __forceinline__ float V(int dy, int dx) const { return vel[H * W + idx(dy, dx)]; }
  // the accessor of the cell at offset (dy, dx)
  __device__ __forceinline__ GlobalState at(int dy, int dx) const {
    return GlobalState{f, rho, vel, H, W, wrap1(y + dy, H), wrap1(x + dx, W)};
  }
};

// An int32 plane ([H][W], flags) read at global (y, x); the sharded
// kernels read theirs through jrl_shard.cuh::ShardFlags instead.
struct GlobalPlane {
  const int* p;
  int W;
  __device__ __forceinline__ int at(int y, int x) const { return p[y * W + x]; }
};

// Second-order equilibrium of one direction (ops/equilibrium.py::feq),
// its divisions by the policy `dv` (exact_div.cuh).
template <class Div = IeeeDiv>
__device__ __forceinline__ float feq_q(int q, float rho, float u, float v,
                                       const Div& dv = Div()) {
  const float eu = (float)ex_of(q) * u + (float)ey_of(q) * v;
  const float uv = u * u + v * v;
  const float rho_w = rho * wq(q);
  const float a = rho_w * (1.0f + dv.cs2(eu));
  const float b = rho_w * (dv.cs4((0.5f * eu) * eu) - dv.cs2(0.5f * uv));
  return a + b;
}

// feq_q of all nine directions with ten divisions in place of eighteen:
// an opposite direction's e.u is -e.u (the same products, negated; round to
// nearest is symmetric) up to the sign of a zero, so it takes the negated
// first quotient (1 + +-0 is 1 whatever the zero's sign) and the same
// second one ((0.5 e.u) e.u is the same product). Bit for bit feq_q.
template <class Div>
__device__ __forceinline__ void feq_all(float rho, float u, float v, const Div& dv,
                                        float fe[9]) {
  const float uv = u * u + v * v;
  const float t = dv.cs2(0.5f * uv);
#pragma unroll
  for (int q = 0; q < 5; ++q) {  // 0 and 1, 2, 5, 6; their opposites 3, 4, 7, 8
    const int p = q < 3 ? q : q + 2;
    const float eu = (float)ex_of(p) * u + (float)ey_of(p) * v;
    const float rho_w = rho * wq(p);
    const float d1 = dv.cs2(eu);
    const float b = rho_w * (dv.cs4((0.5f * eu) * eu) - t);
    fe[p] = rho_w * (1.0f + d1) + b;
    if (p != 0) fe[refl(p)] = rho_w * (1.0f - d1) + b;
  }
}

// walks = inflow_h + f32(step) * v, rounded as float32 at each operation
// (models/jrl.py: the tip row must match the twin's exactly). The integer
// step is converted once, round to nearest, as the JAX package's jnp step
// converts its int32 index; from 2**24 on that rounds the step itself,
// alike in kernel, twin and JAX.
__device__ __forceinline__ float tip_walks(int step, float inflow_h, float v) {
  return __fadd_rn(inflow_h, __fmul_rn((float)step, v));
}
__device__ __forceinline__ int tip_row(float walks) {
  return (int)floorf(__fadd_rn(walks, 0.5f));
}

// Tip SDFs of utils/sdf.py at cell centre (x + 0.5, y + 0.5).
struct TipSdf {
  float bcx, box_r, x1, Hf;  // host constants
  float bcy, y1;             // walks - box_r, bcy + box_r (float32)
  bool flat, with_top;

  __device__ __forceinline__ void set_walks(float walks) {
    bcy = __fsub_rn(walks, box_r);
    y1 = __fadd_rn(bcy, box_r);
  }
  template <class Div = IeeeDiv>
  __device__ __forceinline__ float phi(int y, int x, const Div& dv = Div()) const {
    const float xs = (float)x + 0.5f;
    const float ys = (float)y + 0.5f;
    float p;
    if (flat) {
      const float tx = (xs - bcx) - box_r;
      const float ty = (ys - bcy) - box_r;
      p = fmaxf(tx, ty);
    } else {
      const float ty = (ys - bcy) - box_r;
      const float align = dv.sqrt2((xs + ys) - (x1 + y1));
      p = fmaxf(ty, align);
    }
    if (with_top) p = fminf(p, -(ys - Hf));
    return p;
  }
};

// Bit q (1..8) set when the cell that (y, x) pulls direction q from is
// OBSTACLE. Fixed flags let a multi-step kernel compute it once.
template <class Geo>
__device__ __forceinline__ unsigned pull_obstacle_mask(int H, int W, int y, int x, bool fluid,
                                                       const Geo& g) {
  unsigned m = 0;
#pragma unroll
  for (int q = 1; q < 9; ++q) {
    const int sx = pull_x(x, ex_of(q), fluid, W), sy = pull_y(y, ey_of(q), fluid, H);
    if (g.flag(sy, sx) == OBSTACLE) m |= 1u << q;
  }
  return m;
}

// Post-stream populations of cell (y, x) of flag `fl` before the OUTFLOW
// pass (ops/stream.py::propagate): pulls with the axis mirror, sub-grid
// interpolation bounce at SDF value `t` when HAS_PHI (plain half-way
// bounce otherwise), reflected storage in OBSTACLE cells, then the
// geometry's INFLOW / INFLOW_2 rule. `a` reads the populations around the
// cell (an accessor such as GlobalState, positioned at it); `nbr` is
// pull_obstacle_mask of the cell; `Geo` answers inflow(y, x, flag, out).
template <bool HAS_PHI, class Acc, class Geo>
__device__ __forceinline__ void stream_cell_masked(const Acc& a, int H, int W, int y, int x,
                                                   int fl, unsigned nbr, float t, const Geo& g,
                                                   float out[9]) {
  const bool fluid = fl == FLUID;
  const bool obs = fl == OBSTACLE;
  float raw[9], str[9];
  raw[0] = str[0] = a.F(0, 0, 0);
#pragma unroll
  for (int q = 1; q < 9; ++q) {
    const int ex = ex_of(q), ey = ey_of(q);
    const int dx = pull_dx(x, ex, fluid, W), dy = pull_dy(y, ey, fluid, H);
    const int qv = (x == 0 && axis_x_in(q)) ? mirror_x(q) : q;
    const float val = a.F(qv, dy, dx);
    raw[q] = val;
    const bool nbr_obs = (nbr >> q) & 1u;
    const float f_this = a.F(refl(q), 0, 0);
    float v_obs = f_this;
    if (HAS_PHI && nbr_obs) {
      const int nx = pull_dx(x, -ex, fluid, W), ny = pull_dy(y, -ey, fluid, H);
      const int qn = (x == 0 && axis_x_out(q)) ? refl(mirror_x(q)) : refl(q);
      const float nxt = a.F(qn, ny, nx);
      const float t1 = 2.0f * t - 1.0f;
      const float v1 = t1 * val + (1.0f - t1) * f_this;
      const float t2 = 2.0f * t;
      const float v2 = t2 * f_this + (1.0f - t2) * nxt;
      v_obs = (t >= 0.5f && t <= 1.0f) ? v1 : ((t >= 0.0f && t <= 0.5f) ? v2 : f_this);
    }
    str[q] = nbr_obs ? v_obs : val;
  }
  out[0] = raw[0];
#pragma unroll
  for (int p = 1; p < 9; ++p) out[p] = obs ? raw[refl(p)] : str[p];
  g.inflow(y, x, fl, out);
}

// stream_cell_masked with the flags, mask and phi taken from `Geo`
// (flag(y, x), phi(y, x)).
template <bool HAS_PHI, class Acc, class Geo>
__device__ __forceinline__ void stream_cell(const Acc& a, int H, int W, int y, int x,
                                            const Geo& g, float out[9]) {
  const int fl = g.flag(y, x);
  const unsigned nbr = pull_obstacle_mask(H, W, y, x, fl == FLUID, g);
  stream_cell_masked<HAS_PHI>(a, H, W, y, x, fl, nbr, HAS_PHI ? g.phi(y, x) : 0.0f, g, out);
}

// Offset of the cell whose streamed populations an OUTFLOW cell copies:
// rows 0 and H-1 copy first, then columns 0 and W-1 from the row-fixed
// field, so the source is (row map, column map) of the cell (H, W >= 3),
// one cell inward. Recomputing that cell's streaming here never reads
// another thread's output.
__device__ __forceinline__ void outflow_offset(int fl, int H, int W, int y, int x, int& dy,
                                               int& dx) {
  dy = dx = 0;
  if (fl != OUTFLOW) return;
  dy = (y == 0) ? 1 : ((y == H - 1) ? -1 : 0);
  dx = (x == 0) ? 1 : ((x == W - 1) ? -1 : 0);
}

// Row segments [seg[2s], seg[2s+1]) of a launch that writes only some rows,
// cut into tiles of ty rows (the last tile of a segment may be short).
__host__ __device__ inline int seg_tiles(int nseg, const int* seg, int ty) {
  int n = 0;
  for (int s = 0; s < nseg; ++s) n += (seg[2 * s + 1] - seg[2 * s] + ty - 1) / ty;
  return n;
}

// First row and the segment's end row of row tile `bt`.
__device__ __forceinline__ bool seg_tile_origin(int nseg, const int* seg, int bt, int ty,
                                                int& ty0, int& yend) {
  for (int s = 0; s < nseg; ++s) {
    const int y0 = seg[2 * s], y1 = seg[2 * s + 1];
    const int n = (y1 - y0 + ty - 1) / ty;
    if (bt < n) {
      ty0 = y0 + bt * ty;
      yend = y1;
      return true;
    }
    bt -= n;
  }
  return false;
}

// v in [0, n) for v a few n away at most (one step for grids wider and
// taller than a tile).
__device__ __forceinline__ int wrap_near(int v, int n) {
  while (v < 0) v += n;
  while (v >= n) v -= n;
  return v;
}

// The terms of collide_conv_q that depend only on e_x, the column (r) and
// u_r: the rate 1/tau + s, s = c e_x / r, the source factor c - 0.5 s and
// -u_r / r. A kernel whose u_r is fixed (the balance, u = 0) computes them
// once per cell and launch; collide_conv then rounds as collide_conv_q.
struct ConvRate {
  float w_rate, src, ncu;
};
template <class Div = IeeeDiv>
__device__ __forceinline__ ConvRate conv_rate(int ex, float cu, float r, float w_rate_base,
                                              float c_tau, const Div& dv = Div()) {
  const float s = dv.col(c_tau * (float)ex, r);
  return ConvRate{w_rate_base + s, c_tau - 0.5f * s, -dv.col(cu, r)};
}
// collide_conv of direction population hq at equilibrium fe
__device__ __forceinline__ float collide_conv_fe(float hq, float fe, const ConvRate& k) {
  const float gi = (k.ncu * fe) * k.src;
  return (hq + k.w_rate * (fe - hq)) + gi;
}
template <class Div = IeeeDiv>
__device__ __forceinline__ float collide_conv(int q, float hq, float Cn, float cu, float cv,
                                              const ConvRate& k, const Div& dv = Div()) {
  return collide_conv_fe(hq, feq_q(q, Cn, cu, cv, dv), k);
}

// Advection-diffusion BGK of one direction about the x = 0 axis
// (ops/collide.py::bgk_collide, is_convection): rate 1/tau + c e_x / r and
// the Liu 2017 source -(u_r / r) feq (c - 0.5 s), with c = 1 - 0.5/tau.
template <class Div = IeeeDiv>
__device__ __forceinline__ float collide_conv_q(int q, float hq, float Cn, float cu, float cv,
                                                float r, float w_rate_base, float c_tau,
                                                const Div& dv = Div()) {
  return collide_conv(q, hq, Cn, cu, cv, conv_rate(ex_of(q), cu, r, w_rate_base, c_tau, dv), dv);
}

}  // namespace jrl

// Message of a cudaError_t returned by a launch (each library has its copy).
extern "C" const char* jrl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
