// Per-cell device code of the JRL concentration steps, shared by the
// per-step kernels (c_balance.cu, c_approach.cu) and the multi-step
// kernels (fused_balance.cu, fused_approach.cu), so that all of them round
// alike.
#pragma once

#include "jrl_common.cuh"

// Launch constants of the balance, filled by the Python wrapper (ctypes.Structure).
struct CBalanceParams {
  int H, W;
  float w_rate;  // 1 / tau_D
  float c_tau;   // 1 - 0.5 / tau_D
};

// Launch constants of the approach, filled by the Python wrapper (ctypes.Structure).
struct CApproachParams {
  int H, W, rg, rint, inflow_h_int, flat, is_negative, clamp;
  float inflow_h, v, box_r, bcx, x1;
  float w_rate;  // 1 / tau_D
  float c_tau;   // 1 - 0.5 / tau_D
};

namespace jrl {

// ---------------------------------------------------------------------------
// Balance: fixed flags, zero velocity
// ---------------------------------------------------------------------------

// The fixed flags read through B (GlobalPlane, or jrl_shard.cuh::ShardFlags
// in a shard): flag(y, x) at global coordinates.
template <class B>
struct BalanceGeoT {
  B base;
  __device__ int flag(int y, int x) const { return base.at(y, x); }
  __device__ float phi(int, int) const { return 0.0f; }
  // INFLOW: feq(0, 0) = 0 (sink); INFLOW_2: feq(1, 0) (reservoir)
  __device__ void inflow(int, int, int fl, float* out) const {
    if (fl == INFLOW) {
#pragma unroll
      for (int q = 0; q < 9; ++q) out[q] = feq_q(q, 0.0f, 0.0f, 0.0f);
    } else if (fl == INFLOW_2) {
#pragma unroll
      for (int q = 0; q < 9; ++q) out[q] = feq_q(q, 1.0f, 0.0f, 0.0f);
    }
  }
};
using BalanceGeo = BalanceGeoT<GlobalPlane>;

// What a balance cell needs of the fixed flags: its own flag, the cell
// whose streaming it takes (itself, or the inward neighbour of an OUTFLOW
// cell, as a global linear index), that cell's flag and its
// pull_obstacle_mask.
struct BalanceCell {
  int fl, src, src_fl;
  unsigned nbr;
};

template <class Geo>
__device__ __forceinline__ BalanceCell balance_cell_flags(const Geo& g, int H, int W, int y,
                                                          int x) {
  BalanceCell c;
  c.fl = g.flag(y, x);
  int dy, dx;
  outflow_offset(c.fl, H, W, y, x, dy, dx);
  const int sy = y + dy, sx = x + dx;
  c.src = sy * W + sx;
  c.src_fl = g.flag(sy, sx);
  c.nbr = pull_obstacle_mask(H, W, sy, sx, c.src_fl == FLUID, g);
  return c;
}

// The collision terms of a balance cell in column x (u = 0), by e_x + 1:
// fixed for a launch, so a multi-step kernel may compute them once.
struct BalanceRates {
  ConvRate k[3];
};
__device__ __forceinline__ BalanceRates balance_rates(int x, const CBalanceParams& p) {
  const float r = (float)x + 0.5f;
  BalanceRates b;
#pragma unroll
  for (int e = -1; e <= 1; ++e) b.k[e + 1] = conv_rate(e, 0.0f, r, p.w_rate, p.c_tau);
  return b;
}

// One balance step at global cell (., x) whose streaming source (sy, sx)
// the accessor `src` is positioned at: streaming with INFLOW (C = 0) and
// INFLOW_2 (C = 1) reservoirs and the OUTFLOW copy, C = sum h with
// OBSTACLE passthrough (the old C at C[i], read at OBSTACLE cells only; C
// a pointer, or any type C[i] reads), BGK at u = 0 with the per-direction
// axisymmetric rate 1/tau_D + (1 - 0.5/tau_D) e_x / r (`rates`:
// balance_rates(x, p)). The cell's outputs go to index i of planes
// `stride` apart.
template <class Acc, class CIn, class Geo>
__device__ __forceinline__ void balance_cell_at(const Acc& src, const CIn& C, const Geo& g,
                                                const BalanceCell& c, const CBalanceParams& p,
                                                const BalanceRates& rates, int sy, int sx,
                                                float* h_out, float* C_out, int i, int stride) {
  float hs[9];
  stream_cell_masked<false>(src, p.H, p.W, sy, sx, c.src_fl, c.nbr, 0.0f, g, hs);

  // propagate writes C = 0 / 1 at INFLOW / INFLOW_2; macro_compute_C keeps
  // C only at OBSTACLE cells
  float Cn;
  if (c.fl == OBSTACLE) {
    Cn = C[i];
  } else {
    Cn = hs[0];
#pragma unroll
    for (int q = 1; q < 9; ++q) Cn = Cn + hs[q];
  }
  C_out[i] = Cn;

#pragma unroll
  for (int q = 0; q < 9; ++q)
    h_out[q * stride + i] =
        c.fl == OBSTACLE ? hs[q] : collide_conv(q, hs[q], Cn, 0.0f, 0.0f, rates.k[ex_of(q) + 1]);
}

// balance_cell_at with the collision terms computed in place.
template <class Acc, class CIn, class Geo>
__device__ __forceinline__ void balance_cell_at(const Acc& src, const CIn& C, const Geo& g,
                                                const BalanceCell& c, const CBalanceParams& p,
                                                int x, int sy, int sx, float* h_out,
                                                float* C_out, int i, int stride) {
  balance_cell_at(src, C, g, c, p, balance_rates(x, p), sy, sx, h_out, C_out, i, stride);
}

// balance_cell_at on [H][W] device memory.
template <class Geo>
__device__ __forceinline__ void balance_cell(const float* h, const float* C, const Geo& g,
                                             const BalanceCell& c, const CBalanceParams& p,
                                             int y, int x, float* h_out, float* C_out) {
  const int H = p.H, W = p.W;
  const int sy = c.src / W, sx = c.src % W;
  balance_cell_at(GlobalState{h, nullptr, nullptr, H, W, sy, sx}, C, g, c, p, x, sy, sx, h_out,
                  C_out, y * W + x, H * W);
}

// ---------------------------------------------------------------------------
// Approach: moving tip on the stored fluid velocity
// ---------------------------------------------------------------------------

// The stored velocity of one step as one interpolated [2, H, W] plane
// (the per-step kernel: PyTorch interpolates before the launch).
struct PlaneVel {
  const float* vel;
  int HW;
  __device__ float u(int i) const { return vel[i]; }
  __device__ float v(int i) const { return vel[HW + i]; }
};

// The stored velocity read from its frame pair, interpolated as
// models/jrl.py::stored_velocity does (the multi-step kernel).
struct FrameVel {
  const float* f0;  // frame b, [2, H, W]
  const float* f1;  // frame b + 1 (unused when !lerp)
  float omt, t;     // 1 - t and t
  bool lerp;
  int HW;
  __device__ float at(float a, float b) const {
    return lerp ? __fadd_rn(__fmul_rn(a, omt), __fmul_rn(b, t)) : a;
  }
  __device__ float u(int i) const { return at(f0[i], lerp ? f1[i] : 0.0f); }
  __device__ float v(int i) const { return at(f0[HW + i], lerp ? f1[HW + i] : 0.0f); }
};

constexpr float X_INTERVAL = 0.1f;  // tip travel between stored frames

// The frame pair and weight of `step` (models/jrl.py::stored_velocity):
// q = f32(f32(step) * v) / 0.1, b = clip(floor(q), 0, n_frames - 1),
// t = q - b, lerp when b + 1 < n_frames. `frames` holds frames b0, b0 + 1,
// ... of the n_frames of the history (a window; b0 = 0 for all of it), and
// the caller has checked that it holds b and, when lerp, b + 1.
__device__ __forceinline__ FrameVel frame_vel(const float* frames, int n_frames, int b0, int HW,
                                              int step, float v, int& b) {
  const float q = __fdiv_rn(__fmul_rn((float)step, v), X_INTERVAL);
  const float fb = floorf(q);
  b = fb >= (float)(n_frames - 1) ? n_frames - 1 : (fb < 0.0f ? 0 : (int)fb);
  FrameVel fv;
  fv.t = __fsub_rn(q, (float)b);
  fv.omt = __fsub_rn(1.0f, fv.t);
  fv.lerp = b + 1 < n_frames;
  fv.HW = HW;
  fv.f0 = frames + (size_t)(b - b0) * 2 * HW;
  fv.f1 = fv.lerp ? fv.f0 + 2 * HW : fv.f0;
  return fv;
}

// The moving tip over the base flags B (GlobalPlane, or jrl_shard.cuh::
// ShardFlags in a shard), read at global coordinates.
template <class V, class B = GlobalPlane>
struct ApproachGeo {
  B base;
  V vel;  // interpolated stored velocity (not yet scaled by v), at global linear indices
  int H, W, rg, rint, inflow_h_int, walks_int;
  bool flat;
  float v;
  TipSdf sdf;

  __device__ float phi(int y, int x) const { return sdf.phi(y, x); }
  // models/jrl.py::_c_flags_at with strict=True, ph = phi(y, x) (read for
  // the wedge only)
  __device__ int flag_at(int y, int x, float ph) const {
    const bool obs = flat ? (y < walks_int && x < rg)
                          : (ph < 0.0f || (y < inflow_h_int && x < rg));
    int fl = obs ? OBSTACLE : base.at(y, x);
    if (y == walks_int - 1 && x < rint) fl = INFLOW;
    return fl;
  }
  __device__ int flag(int y, int x) const { return flag_at(y, x, flat ? 0.0f : phi(y, x)); }
  __device__ bool tip_block(int y, int x) const { return y < walks_int && x < rg; }
  // the convection velocity of a cell from its stored velocity (u_s, v_s)
  __device__ float cu_of(int y, int x, float u_s) const { return tip_block(y, x) ? 0.0f : u_s * v; }
  __device__ float cv_of(int y, int x, float v_s) const { return tip_block(y, x) ? v : v_s * v; }
  __device__ float cu(int y, int x) const { return cu_of(y, x, vel.u(y * W + x)); }
  __device__ float cv(int y, int x) const { return cv_of(y, x, vel.v(y * W + x)); }
  // INFLOW: feq(0, C_vel); INFLOW_2: feq(1, C_vel) with the local C_vel
  // (the equilibrium's divisions by the policy `dv`, exact_div.cuh)
  template <class Div = IeeeDiv>
  __device__ void inflow(int y, int x, int fl, float* out, const Div& dv = Div()) const {
    if (fl != INFLOW && fl != INFLOW_2) return;
    const float rho_in = fl == INFLOW ? 0.0f : 1.0f;
    const float a = cu(y, x), b = cv(y, x);
#pragma unroll
    for (int q = 0; q < 9; ++q) out[q] = feq_q(q, rho_in, a, b, dv);
  }
};

template <class V, class B>
__device__ __forceinline__ ApproachGeo<V, B> approach_geo_on(B base, V vel, int step,
                                                             const CApproachParams& p) {
  const float walks = tip_walks(step, p.inflow_h, p.v);
  ApproachGeo<V, B> g;
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
  return g;
}

template <class V>
__device__ __forceinline__ ApproachGeo<V> approach_geo(const int* base, V vel, int step,
                                                       const CApproachParams& p) {
  return approach_geo_on(GlobalPlane{base, p.W}, vel, step, p);
}

// The moving tip of one step read from a window of rows: the flag and phi
// of each window cell, computed once a cell and step by fill_window_geo
// from ApproachGeo's own functions, at local row j = y - ybase (mod H) of
// planes W wide. Every other answer (tip block, convection velocity, the
// inflow rule) is ApproachGeo's, so the cell code reads the values
// ApproachGeo computes on every call.
template <class V, class B = GlobalPlane>
struct WindowGeo : ApproachGeo<V, B> {
  const int* codes;
  const float* phis;
  int ybase;
  __device__ __forceinline__ int at(int y, int x) const {
    const int j = y - ybase;
    return (j < 0 ? j + this->H : j) * this->W + x;
  }
  __device__ int flag(int y, int x) const { return codes[at(y, x)]; }
  __device__ float phi(int y, int x) const { return phis[at(y, x)]; }
};

// flag and phi of window rows ybase .. ybase + rows - 1 (mod H) into
// codes / phis, cells split over `nthreads` threads; the SDF's division by
// the policy `dv` (exact_div.cuh).
template <class V, class B, class Div = IeeeDiv>
__device__ __forceinline__ void fill_window_geo(const ApproachGeo<V, B>& g, int ybase, int rows,
                                                int* codes, float* phis, int tid, int nthreads,
                                                const Div& dv = Div()) {
  for (int c = tid; c < rows * g.W; c += nthreads) {
    const int j = c / g.W, x = c - j * g.W, y = (ybase + j) % g.H;
    const float ph = g.sdf.phi(y, x, dv);
    codes[c] = g.flag_at(y, x, ph);
    phis[c] = ph;
  }
}

template <class V, class B>
__device__ __forceinline__ WindowGeo<V, B> window_geo(const ApproachGeo<V, B>& g, int ybase,
                                                      const int* codes, const float* phis) {
  WindowGeo<V, B> w;
  static_cast<ApproachGeo<V, B>&>(w) = g;
  w.codes = codes;
  w.phis = phis;
  w.ybase = ybase;
  return w;
}

// A geometry G whose inflow rule divides by the policy Div (exact_div.cuh),
// every other answer G's.
template <class G, class Div>
struct DivGeo : G {
  __device__ void inflow(int y, int x, int fl, float* out) const {
    G::inflow(y, x, fl, out, Div::for_col(0.0f));
  }
};

template <class Div, class G>
__device__ __forceinline__ DivGeo<G, Div> div_geo(const G& g) {
  DivGeo<G, Div> d;
  static_cast<G&>(d) = g;
  return d;
}

// The new C of cell (y, x) of flag `fl` (g.flag(y, x)), its streamed
// populations in hs: streaming with sub-grid bounce from the accessor `a`
// positioned at the cell, C = sum h (clamped to [0, 1] for flat tips). C is
// zeroed in the tip before streaming and OBSTACLE cells keep it, so the new
// C never reads the old one.
template <class Acc, class Geo>
__device__ __forceinline__ float approach_C(const Acc& a, const Geo& g, const CApproachParams& p,
                                            int y, int x, int fl, float hs[9]) {
  int dy, dx;
  outflow_offset(fl, p.H, p.W, y, x, dy, dx);
  stream_cell<true>(a.at(dy, dx), p.H, p.W, y + dy, x + dx, g, hs);

  float Cn;
  if (fl == OBSTACLE) {
    Cn = 0.0f;
  } else {
    Cn = hs[0];
#pragma unroll
    for (int q = 1; q < 9; ++q) Cn = Cn + hs[q];
  }
  if (p.clamp) Cn = fminf(fmaxf(Cn, 0.0f), 1.0f);
  return Cn;
}

// One approach step at cell (y, x) whose stored velocity is (u_s, v_s):
// approach_C, then advection-diffusion BGK with the axisymmetric rate and
// source. The cell's outputs go to index i of planes `stride` apart.
template <class Acc, class Geo>
__device__ __forceinline__ void approach_cell_at(const Acc& a, const Geo& g,
                                                 const CApproachParams& p, int y, int x,
                                                 float u_s, float v_s, float* h_out,
                                                 float* C_out, int i, int stride) {
  const int fl = g.flag(y, x);
  float hs[9];
  const float Cn = approach_C(a, g, p, y, x, fl, hs);
  C_out[i] = Cn;

  const float r = (float)x + 0.5f;
  const float a_ = g.cu_of(y, x, u_s), b = g.cv_of(y, x, v_s);
#pragma unroll
  for (int q = 0; q < 9; ++q)
    h_out[q * stride + i] =
        fl == OBSTACLE ? hs[q] : collide_conv_q(q, hs[q], Cn, a_, b, r, p.w_rate, p.c_tau);
}

// The collision terms of an approach cell in column x that do not change in
// a launch: the rate and source factor by e_x + 1 (balance_rates' terms, the
// same operations as conv_rate's in approach_cell_at above), r = x + 0.5, and
// the policy `dv` of the step's divisions (exact_div.cuh; RcpDiv holds the
// reciprocal of this r).
template <class Div>
struct ApproachRates {
  BalanceRates k;
  float r;
  Div dv;
};

// approach_cell_at above with the column's terms taken from `kr` (computed
// once a launch) and the equilibrium's divisions shared by opposite
// directions (feq_all): the same operations on the same values, so the same
// bits, with one division by r and ten by the lattice constants a cell and
// step in place of its forty-odd.
template <class Acc, class Geo, class Div>
__device__ __forceinline__ void approach_cell_at(const Acc& a, const Geo& g,
                                                 const CApproachParams& p, int y, int x,
                                                 float u_s, float v_s,
                                                 const ApproachRates<Div>& kr, float* h_out,
                                                 float* C_out, int i, int stride) {
  const int fl = g.flag(y, x);
  float hs[9];
  const float Cn = approach_C(a, g, p, y, x, fl, hs);
  C_out[i] = Cn;

  const float a_ = g.cu_of(y, x, u_s), b = g.cv_of(y, x, v_s);
  float fe[9];
  feq_all(Cn, a_, b, kr.dv, fe);
  const float ncu = -kr.dv.col(a_, kr.r);
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const ConvRate& k = kr.k.k[ex_of(q) + 1];
    h_out[q * stride + i] =
        fl == OBSTACLE ? hs[q] : collide_conv_fe(hs[q], fe[q], ConvRate{k.w_rate, k.src, ncu});
  }
}

// approach_cell_at on [H][W] device memory.
template <class V>
__device__ __forceinline__ void approach_cell(const float* h, const ApproachGeo<V>& g,
                                              const CApproachParams& p, int y, int x,
                                              float u_s, float v_s, float* h_out, float* C_out) {
  approach_cell_at(GlobalState{h, nullptr, nullptr, p.H, p.W, y, x}, g, p, y, x, u_s, v_s, h_out,
                   C_out, y * p.W + x, p.H * p.W);
}

// Row of the tip-disk integrals, clamped into [0, H-1] as the JAX
// package's dynamic_slice clamps its start.
__device__ __forceinline__ int disk_row(int r, int H) { return r < 0 ? 0 : (r > H - 1 ? H - 1 : r); }

// Column x's terms of the inflow and current integrals over rows walks_int
// and walks_int + 1 of the new C (models/jrl.py::make_approach_step): the
// plain disk for the wedge, the dC_z + dC_r flux form for flat tips (its
// division by r = x + 0.5 by the policy `dv`, exact_div.cuh: RcpDiv's of
// column x).
template <class Div = IeeeDiv>
__device__ __forceinline__ void disk_terms(const float* Cn, int H, int W, int wi, bool flat,
                                           int x, float ar, float& t_in, float& t_cur,
                                           const Div& dv = Div()) {
  if (flat) {
    const float rx = (float)x + 0.5f, rx1 = (float)(x + 1) + 0.5f;
    float t[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int rr = disk_row(wi + k, H), rm = disk_row(wi + k - 1, H);
      const float dCz = Cn[rr * W + x] - Cn[rm * W + x];
      const float rC0 = rx * Cn[rr * W + x];
      const float rC1 = rx1 * Cn[rr * W + x + 1];
      const float dCr = dv.col(rC1 - rC0, rx);
      t[k] = (dCz + dCr) * ar;
    }
    t_in = t[0];
    t_cur = t[1];
  } else {
    t_in = Cn[disk_row(wi, H) * W + x] * ar;
    t_cur = Cn[disk_row(wi + 1, H) * W + x] * ar;
  }
}

// Sum of v[k][0 .. N) for k < 4 over the first N threads of a block (N a
// power of two, at most the block's thread count; every thread calls it),
// in a fixed tree order (no atomics, so runs repeat bit for bit). The
// result is in red[k][0].
template <int N>
__device__ __forceinline__ void block_sum4(float (&red)[4][N], const float s[4]) {
  if (threadIdx.x < N) {
#pragma unroll
    for (int k = 0; k < 4; ++k) red[k][threadIdx.x] = s[k];
  }
  __syncthreads();
  for (int half = N / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        red[k][threadIdx.x] = red[k][threadIdx.x] + red[k][threadIdx.x + half];
    }
    __syncthreads();
  }
}

constexpr int DISK_SH_THREADS = 128;  // the threads of a shard's disk sum

// One step's terms of the tip-disk integrals (inflow, current, rec_u,
// rec_v) over the disk rows walks_int - 1 .. walks_int + 1 that a shard
// owns (rows [row0, row0 + h), columns [col0, col0 + w)), in the JAX
// package's row-split form, exact however the disk rows land on shard
// boundaries: every term a product of one cell's values, summed per row
// (inflow = sum C[wi] - sum C[wi-1] + sum dC_r[wi] for flat tips, the plain
// disk row otherwise). cn(r, x) is the new C at cell (r, x) of an owned
// row, x at most one column past the shard (dC_r at x reads x + 1). The
// first DISK_SH_THREADS threads sum the columns, then the fixed tree of
// block_sum4 (every thread of the block calls this); thread 0 adds
// inflow and current into part[0], part[1] and writes rec_u, rec_v to
// part[2], part[3].
template <class CNew, class Geo>
__device__ __forceinline__ void disk_sh_step(const CNew& cn, const Geo& g,
                                             const CApproachParams& p, const float* area,
                                             float* part, int row0, int h, int col0, int w,
                                             float (&red)[4][DISK_SH_THREADS]) {
  const int wi = g.walks_int;
  const bool flat = p.flat != 0;
  const auto owned = [&](int r) { return r >= row0 && r < row0 + h; };
  const int x_end = min(col0 + w, p.rint);
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (threadIdx.x < DISK_SH_THREADS) {
    for (int x = col0 + (int)threadIdx.x; x < x_end; x += DISK_SH_THREADS) {
      const float ar = area[x];
      float disk[3], dcr[3];  // rows wi - 1, wi, wi + 1
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int r = wi - 1 + k;
        disk[k] = dcr[k] = 0.0f;
        if (!owned(r)) continue;
        const float c = cn(r, x);
        disk[k] = c * ar;
        if (flat && k > 0) {
          const float c1 = cn(r, x + 1);
          const float rx = (float)x + 0.5f;
          const float rC = rx * c, rC1 = ((float)(x + 1) + 0.5f) * c1;
          dcr[k] = ((rC1 - rC) / rx) * ar;
        }
      }
      if (flat) {
        t[0] = t[0] + ((disk[1] - disk[0]) + dcr[1]);
        t[1] = t[1] + ((disk[2] - disk[1]) + dcr[2]);
      } else {
        t[0] = t[0] + disk[1];
        t[1] = t[1] + disk[2];
      }
      if (owned(wi + 1)) {
        t[2] = t[2] + g.cu(wi + 1, x) * ar;
        t[3] = t[3] + g.cv(wi + 1, x) * ar;
      }
    }
  }
  block_sum4(red, t);
  if (threadIdx.x == 0) {
    part[0] = part[0] + red[0][0];
    part[1] = part[1] + red[1][0];
    part[2] = red[2][0];
    part[3] = red[3][0];
  }
}

}  // namespace jrl
