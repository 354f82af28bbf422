// Device code shared by the cylinder-channel kernels (cyl_full,
// cyl_interior, cyl_interior_k, cyl_band_k, cyl_pass and the sharded
// ones): one full-boundary step and
// one plain-channel step of a cell, written against an accessor that
// reads the previous step either from global memory (one step per
// launch) or from a tile in shared memory (k steps per launch).
//
// Unlike the JRL helpers of jrl_common.cuh there is no symmetry axis
// here: non-FLUID cells reflect-clamp on all four borders (x = 0 pulls
// from x = 1), FLUID cells wrap.
//
// Arithmetic follows the plain twins of kernels/cylinder.py (the Pallas
// bodies of fused_step.py: the division-free _feq_terms and the paired
// even/odd _mrt_apply) operation by operation, with the same float32
// constants; built with --fmad=false, kernel and twin round alike.
//
// f crosses device memory in one of three storage modes, a template
// parameter of every kernel (Storage below): float32, or the bf16
// deviation g = f - w_q rounded to nearest or stochastically
// (fused_step.py::_mk_ld_st). The conversion happens only where f is
// loaded from or stored to device memory; every step in between, and the
// k-step kernels' sub-steps in shared memory, stay float32.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "jrl_common.cuh"
#include "philox.cuh"

namespace cyl {

using jrl::ex_of;
using jrl::ey_of;
using jrl::refl;
using jrl::wq;
using jrl::wrap_near;
using jrl::FLUID;
using jrl::INFLOW;
using jrl::OBSTACLE;
using jrl::OUTFLOW;

constexpr int MAX_SEGS = 3;

// Mirrors kernels/cylinder.py::CylParams.
struct CylParams {
  int H, W, nseg, write_macro;
  int seg[2 * MAX_SEGS];  // row segments [y0, y1) the launch writes
  float cs2tau;           // (float)(cs2 * tau)
  float wall_density;     // OBSTACLE rho of the k-step kernels (cfg.density)
  float feq_in[9];        // INFLOW plug equilibrium
  float ev0[5];           // even coefficients of direction 0
  float ev[4][5];         // even coefficients of the pairs (1,3) (2,4) (5,7) (6,8)
  float od[4][4];         // odd coefficients of the same pairs
  unsigned key[2];        // Philox key of a stochastic-rounding launch: (seed, launch number)
};

// Storage of f in device memory (the codes of kernels/cylinder.py::_storage).
enum Storage { F32 = 0, BF16_RN = 1, BF16_SR = 2 };

// The element type of f in device memory: float, or the bf16 bit pattern.
template <int ST>
using f_t = typename std::conditional<ST == F32, float, unsigned short>::type;

// f of population q from element i: the stored value, or float(g) + w_q
// (a bf16 pattern is the top half of the float32 with the same value).
template <int ST>
__device__ __forceinline__ float f_load(const f_t<ST>* f, int i, int q) {
  if constexpr (ST == F32) {
    return f[i];
  } else {
    return __uint_as_float((unsigned)f[i] << 16) + wq(q);
  }
}

// Stores the nine populations of cell c (planes HW apart): float32 as
// they are; bf16 of f - w_q rounded to nearest (even); or stochastically,
// by adding 16 random bits to the float32 pattern of f - w_q and keeping
// its top 16 bits (fused_step.py:189-201). The bits come from Philox
// under the key (key0, key1), counter (c, 0, 0, 0) for populations 0-7 and
// (c, 1, 0, 0) for population 8 (kernels/philox.py).
template <int ST>
__device__ __forceinline__ void f_store_key(f_t<ST>* f, int HW, int c, const float fo[9],
                                            unsigned key0, unsigned key1) {
  if constexpr (ST == F32) {
#pragma unroll
    for (int q = 0; q < 9; ++q) f[q * HW + c] = fo[q];
  } else if constexpr (ST == BF16_RN) {
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      f[q * HW + c] = __bfloat16_as_ushort(__float2bfloat16_rn(fo[q] - wq(q)));
    }
  } else {
    const uint4 w = philox::philox4x32_10(make_uint4((unsigned)c, 0u, 0u, 0u), key0, key1);
    const uint4 w8 = philox::philox4x32_10(make_uint4((unsigned)c, 1u, 0u, 0u), key0, key1);
    const unsigned r[9] = {w.x & 0xFFFFu, w.x >> 16, w.y & 0xFFFFu, w.y >> 16, w.z & 0xFFFFu,
                           w.z >> 16,     w.w & 0xFFFFu, w.w >> 16, w8.x & 0xFFFFu};
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const unsigned b = (__float_as_uint(fo[q] - wq(q)) + r[q]) & 0xFFFF0000u;
      f[q * HW + c] = (unsigned short)(b >> 16);
    }
  }
}

// f_store under the launch's key.
template <int ST>
__device__ __forceinline__ void f_store(f_t<ST>* f, int HW, int c, const float fo[9],
                                        const CylParams& p) {
  f_store_key<ST>(f, HW, c, fo, p.key[0], p.key[1]);
}

// Calls fn(std::integral_constant<int, ST>()) for the run-time storage mode.
template <class Fn>
int with_storage(int storage, Fn fn) {
  switch (storage) {
    case F32: return fn(std::integral_constant<int, F32>());
    case BF16_RN: return fn(std::integral_constant<int, BF16_RN>());
    case BF16_SR: return fn(std::integral_constant<int, BF16_SR>());
    default: return (int)cudaErrorInvalidValue;
  }
}

constexpr double CS2D = 1.0 / 3.0;  // constants below are rounded from doubles, as in JAX

// Offset of the cell a direction component pulls from (value at g from
// g - e): -e, except non-FLUID cells on the border, which take the
// reflected (REFLECT: 1 at g = 0) or clamped (0) neighbour.
template <bool REFLECT>
__device__ __forceinline__ int pull_off(int g, int e, bool nf, int N) {
  if (e == 1 && g == 0 && nf) return REFLECT ? 1 : 0;
  if (e == -1 && g == N - 1 && nf) return REFLECT ? -1 : 0;
  return -e;
}

// pull_off along x, or -e where the caller knows that no cell it runs lies
// on column 0 or W-1 (XW false: a body strip of cyl_pass.cu).
template <bool XW, bool REFLECT>
__device__ __forceinline__ int pull_x(int g, int e, bool nf, int N) {
  return XW ? pull_off<REFLECT>(g, e, nf, N) : -e;
}

// Global row of the r-th row of the launch's segments.
__device__ __forceinline__ int seg_row(const CylParams& p, int r, bool& ok) {
  for (int s = 0; s < p.nseg; ++s) {
    const int len = p.seg[2 * s + 1] - p.seg[2 * s];
    if (r < len) {
      ok = true;
      return p.seg[2 * s] + r;
    }
    r -= len;
  }
  ok = false;
  return 0;
}

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// Previous step read from global memory around cell (y, x); offsets wrap.
template <int ST>
struct GlobalAcc {
  const f_t<ST>* f;
  const float* vel;
  const int* flags;
  const float* phi;
  int H, W, y, x;
  __device__ __forceinline__ int idx(int dy, int dx) const {
    int yy = y + dy, xx = x + dx;
    yy += yy < 0 ? H : 0;
    yy -= yy >= H ? H : 0;
    xx += xx < 0 ? W : 0;
    xx -= xx >= W ? W : 0;
    return yy * W + xx;
  }
  __device__ __forceinline__ float F(int q, int dy, int dx) const {
    return f_load<ST>(f, q * H * W + idx(dy, dx), q);
  }
  __device__ __forceinline__ int flag(int dy, int dx) const { return flags[idx(dy, dx)]; }
  __device__ __forceinline__ float ph(int dy, int dx) const { return phi[idx(dy, dx)]; }
  __device__ __forceinline__ float vx(int dy, int dx) const { return vel[idx(dy, dx)]; }
  __device__ __forceinline__ float vy(int dy, int dx) const { return vel[H * W + idx(dy, dx)]; }
};

constexpr int TILE_EX = 64;  // width of a k-step tile with its halo (cells)

// Previous sub-step read from a shared-memory tile of TILE_EX x EY cells
// around local cell (ly, lx). With CLAMP, offsets clamp to the tile: only
// an OUTFLOW cell reads two cells away, and a clamped read only ever
// feeds a cell outside the tile's valid region. The plain-channel step
// reads one cell away only, always inside the tile, and needs no clamp.
template <bool CLAMP, int EY>
struct SmemAcc {
  static constexpr int EXT = TILE_EX * EY;
  const float* f;   // [9][EY][TILE_EX]
  const float* v;   // [2][EY][TILE_EX] or null
  const int* fl;    // [EY][TILE_EX] or null
  const float* phs; // [EY][TILE_EX] or null
  int ly, lx;
  __device__ __forceinline__ int idx(int dy, int dx) const {
    if (CLAMP) return min(max(ly + dy, 0), EY - 1) * TILE_EX + min(max(lx + dx, 0), TILE_EX - 1);
    return (ly + dy) * TILE_EX + lx + dx;
  }
  __device__ __forceinline__ float F(int q, int dy, int dx) const {
    return f[q * EXT + idx(dy, dx)];
  }
  __device__ __forceinline__ int flag(int dy, int dx) const { return fl[idx(dy, dx)]; }
  __device__ __forceinline__ float ph(int dy, int dx) const { return phs[idx(dy, dx)]; }
  __device__ __forceinline__ float vx(int dy, int dx) const { return v[idx(dy, dx)]; }
  __device__ __forceinline__ float vy(int dy, int dx) const { return v[EXT + idx(dy, dx)]; }
};

// fused_step.py::_feq_terms.
__device__ __forceinline__ void feq_terms(float rho, float ux, float uy, float out[9]) {
  const float uv = ux * ux + uy * uy;
  const float base = 1.0f - 1.5f * uv;
  out[0] = rho * (wq(0) * base);
  const float eus[4] = {ux, uy, ux + uy, uy - ux};
  const int qa[4] = {1, 2, 5, 6}, qb[4] = {3, 4, 7, 8};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float eu = eus[i];
    const float c = base + 4.5f * (eu * eu);
    const float e3 = 3.0f * eu;
    const float rw = rho * wq(qa[i]);
    out[qa[i]] = rw * (c + e3);
    out[qb[i]] = rw * (c - e3);
  }
}

// Sum of coeffs[i] * vals[i] in order (fused_step.py::_mrt_apply's dot).
// The twin skips zero coefficients and does not multiply by unit ones;
// for finite values c * x is then +-0 or x exactly, and adding +-0 leaves
// a sum unchanged, so the branch-free sum rounds alike.
template <int N>
__device__ __forceinline__ float dot(const float* coeffs, const float* vals) {
  float acc = coeffs[0] * vals[0];
#pragma unroll
  for (int i = 1; i < N; ++i) acc = acc + coeffs[i] * vals[i];
  return acc;
}

// Moments (OBSTACLE cells take rho_obs and the obstacle velocity), then
// the paired even/odd MRT relaxation with OBSTACLE passthrough.
__device__ __forceinline__ void moments_mrt(const CylParams& p, const float fb[9], bool obs,
                                            float rho_obs, float vx_obs, float vy_obs,
                                            float fo[9], float& rho_o, float& ux_o,
                                            float& uy_o) {
  float macro = fb[0];
#pragma unroll
  for (int q = 1; q < 9; ++q) macro = macro + fb[q];
  const float rho_n = obs ? rho_obs : macro;
  const float mom_x = fb[1] - fb[3] + fb[5] - fb[6] - fb[7] + fb[8];
  const float mom_y = fb[2] - fb[4] + fb[5] + fb[6] - fb[7] - fb[8];
  const float safe = rho_n == 0.0f ? 1.0f : rho_n;
  const float ux = obs ? vx_obs : mom_x / safe;
  const float uy = obs ? vy_obs : mom_y / safe;
  rho_o = rho_n;
  ux_o = ux;
  uy_o = uy;
  if (obs) {
#pragma unroll
    for (int q = 0; q < 9; ++q) fo[q] = fb[q];
    return;
  }
  float fe[9], d[9];
  feq_terms(rho_n, ux, uy, fe);
#pragma unroll
  for (int q = 0; q < 9; ++q) d[q] = fe[q] - fb[q];
  const float u[5] = {d[0], d[1] + d[3], d[2] + d[4], d[5] + d[7], d[6] + d[8]};
  const float v[4] = {d[1] - d[3], d[2] - d[4], d[5] - d[7], d[6] - d[8]};
  fo[0] = fb[0] + dot<5>(p.ev0, u);
  const int qa[4] = {1, 2, 5, 6}, qb[4] = {3, 4, 7, 8};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float e = dot<5>(p.ev[i], u);
    const float o = dot<4>(p.od[i], v);
    fo[qa[i]] = fb[qa[i]] + (e + o);
    fo[qb[i]] = fb[qb[i]] + (e - o);
  }
}

// Streaming of the cell at offset (oy, ox) from the accessor's cell, whose
// global coordinates are (gy, gx): reflect-clamp pulls, sub-grid
// interpolation bounce (HAS_PHI; plain half-way bounce otherwise),
// reflected storage in OBSTACLE cells, then the INFLOW plug. XW false: no
// cell on the wall columns x = 0, W-1 (pull_x).
template <bool HAS_PHI, bool XW = true, class Acc>
__device__ __forceinline__ void stream_full(const Acc& a, const CylParams& p, int gy, int gx,
                                            int oy, int ox, float out[9]) {
  const int fl = a.flag(oy, ox);
  const bool nf = fl != FLUID;
  float t = 0.0f;
  bool t_ok = false;
  if (HAS_PHI) {
    t = a.ph(oy, ox);
    t_ok = (t > -1e-10f) && (t <= (float)(1.0 + 1e-10));
  }
  float raw[9], str[9];
  raw[0] = a.F(0, oy, ox);
#pragma unroll
  for (int q = 1; q < 9; ++q) {
    const int ex = ex_of(q), ey = ey_of(q);
    const int dx = pull_x<XW, true>(gx, ex, nf, p.W), dy = pull_off<true>(gy, ey, nf, p.H);
    const float val = a.F(q, oy + dy, ox + dx);
    raw[q] = val;
    const bool nbr_obs = a.flag(oy + dy, ox + dx) == OBSTACLE;
    const float f_this = a.F(refl(q), oy, ox);
    float v_obs = f_this;
    if (HAS_PHI && nbr_obs && t_ok) {
      const int nx = pull_x<XW, true>(gx, -ex, nf, p.W), ny = pull_off<true>(gy, -ey, nf, p.H);
      const float nxt = a.F(refl(q), oy + ny, ox + nx);
      const float v1 = (2.0f * t - 1.0f) * val + (2.0f - 2.0f * t) * f_this;
      const float v2 = (2.0f * t) * f_this + (1.0f - 2.0f * t) * nxt;
      v_obs = t >= 0.5f ? v1 : v2;
    }
    str[q] = nbr_obs ? v_obs : val;
  }
  const bool obs = fl == OBSTACLE;
  out[0] = raw[0];
#pragma unroll
  for (int q = 1; q < 9; ++q) out[q] = obs ? raw[refl(q)] : str[q];
  if (fl == INFLOW) {
#pragma unroll
    for (int q = 0; q < 9; ++q) out[q] = p.feq_in[q];
  }
}

// Static-cylinder nonequilibrium reconstruction of a cell with flag `fl`
// and fraction t (fused_step.py coupling section), in place on fn. XW: as
// for stream_full.
template <bool XW = true, class Acc>
__device__ __forceinline__ void couple(const Acc& a, const CylParams& p, int gy, int gx, int fl,
                                       float t, float fn[9]) {
  const bool nf = fl != FLUID;
  float rho_tgt = fn[0];
#pragma unroll
  for (int q = 1; q < 9; ++q) rho_tgt = rho_tgt + fn[q];
  const float tqr = t / (t + 1.0f);
  float vtx = 0.0f, vty = 0.0f, count = 0.0f;
  unsigned valid = 0;
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const int ex = ex_of(q), ey = ey_of(q);
    // neighbour at (y + ey, x + ex), clamped
    const bool nb = a.flag(pull_off<false>(gy, -ey, nf, p.H),
                           pull_x<XW, false>(gx, -ex, nf, p.W)) == OBSTACLE;
    if (nb) valid |= 1u << q;
    const float vm = nb ? 1.0f : 0.0f;
    count = count + vm;
    // velocity pulled from (y - ey, x - ex), clamped
    const int dy = pull_off<false>(gy, ey, nf, p.H), dx = pull_x<XW, false>(gx, ex, nf, p.W);
    vtx = vtx + (vm * tqr) * a.vx(dy, dx);
    vty = vty + (vm * tqr) * a.vy(dy, dx);
  }
  const float sc = count > 0.0f ? count : 1.0f;
  const float u0 = vtx / sc, u1 = vty / sc;

  // 12-point gradient; at(sx, sy) = value at (y + sy, x + sx), clamped
  const int xp = pull_x<XW, false>(gx, -1, nf, p.W), xm = pull_x<XW, false>(gx, 1, nf, p.W);
  const int yp = pull_off<false>(gy, -1, nf, p.H), ym = pull_off<false>(gy, 1, nf, p.H);
  float g00, g01, g10, g11;
  {
    const float pp = a.vx(yp, xp), pm = a.vx(ym, xp), mp = a.vx(yp, xm), mm = a.vx(ym, xm);
    g00 = (4.0f * (a.vx(0, xp) - a.vx(0, xm)) + (pp - mp) + (pm - mm)) / 12.0f;
    g01 = (4.0f * (a.vx(yp, 0) - a.vx(ym, 0)) + (pp - pm) + (mp - mm)) / 12.0f;
  }
  {
    const float pp = a.vy(yp, xp), pm = a.vy(ym, xp), mp = a.vy(yp, xm), mm = a.vy(ym, xm);
    g10 = (4.0f * (a.vy(0, xp) - a.vy(0, xm)) + (pp - mp) + (pm - mm)) / 12.0f;
    g11 = (4.0f * (a.vy(yp, 0) - a.vy(ym, 0)) + (pp - pm) + (mp - mm)) / 12.0f;
  }
  const float c = p.cs2tau;
  const float s00 = u0 * u0 - c * (g00 + g00);
  const float s10 = u1 * u0 - c * (g10 + g01);
  const float s01 = u0 * u1 - c * (g01 + g10);
  const float s11 = u1 * u1 - c * (g11 + g11);
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    if (!((valid >> q) & 1u)) continue;
    const int qi = refl(q);
    const float e0 = (float)ex_of(qi), e1 = (float)ey_of(qi);
    float pab = s00 * (float)((double)ex_of(qi) * ex_of(qi) - CS2D);
    pab = pab + s10 * (float)(ey_of(qi) * ex_of(qi));
    pab = pab + s01 * (float)(ex_of(qi) * ey_of(qi));
    pab = pab + s11 * (float)((double)ey_of(qi) * ey_of(qi) - CS2D);
    fn[qi] = (wq(qi) * rho_tgt) *
             ((1.0f + (float)(1.0 / CS2D) * (u0 * e0 + u1 * e1)) +
              (0.5f * pab) / (float)(CS2D * CS2D));
  }
}

// One full-boundary step of the accessor's cell at global (gy, gx):
// streaming, INFLOW, OUTFLOW (the streamed + INFLOW values of the inward
// neighbour, recomputed here: no other thread's output is read), the
// coupling (COUPLING), moments and MRT. OBSTACLE cells keep rho_obs and
// (vx_obs, vy_obs). XW false: the cell is not on x = 0 or W-1 (pull_x).
template <bool COUPLING, bool XW = true, class Acc>
__device__ __forceinline__ void full_cell(const Acc& a, const CylParams& p, int gy, int gx,
                                          float rho_obs, float vx_obs, float vy_obs, float fo[9],
                                          float& rho_o, float& ux_o, float& uy_o) {
  const int fl = a.flag(0, 0);
  int oy = 0, ox = 0;
  if (fl == OUTFLOW) {
    oy = gy == 0 ? 1 : (gy == p.H - 1 ? -1 : 0);
    ox = XW ? (gx == 0 ? 1 : (gx == p.W - 1 ? -1 : 0)) : 0;
  }
  float fn[9];
  stream_full<COUPLING, XW>(a, p, gy + oy, gx + ox, oy, ox, fn);
  if (COUPLING) {
    const float t = a.ph(0, 0);
    const bool t_ok = (t > -1e-10f) && (t <= (float)(1.0 + 1e-10));
    const bool skip = fl == OBSTACLE || (XW && gx == p.W - 1) || gy == p.H - 1;
    if (t_ok && !skip) couple<XW>(a, p, gy, gx, fl, t, fn);
  }
  moments_mrt(p, fn, fl == OBSTACLE, rho_obs, vx_obs, vy_obs, fo, rho_o, ux_o, uy_o);
}

// One plain-channel step (walls at x = 0 and W-1, FLUID elsewhere; flags
// are not read) of the accessor's cell at global (gy, gx)
// (fused_step.py::_lean_step_rows). The YB instance adds the rules of the
// first and last rows, as the sharded lean pass runs every row
// (fused_sharded.py::_lean_block_update): the INFLOW plug at gy = 0 and
// the OUTFLOW copy at gy = H-1 of all nine streamed populations of the
// cell below (recomputed here, reading two rows away), both off the wall
// columns. Its wall cells of those two rows reflect their y pulls as the
// full step does (the JAX lean pass wraps them; no other cell reads a
// wall cell's populations, since the cells beside a wall take the
// half-way bounce), so no cell reads across the global y border. Without
// YB, gy is not read. XW false: the cell is none of the columns 0, 1, W-2,
// W-1, whose wall rules are then left out (a body strip of cyl_pass.cu).
template <bool YB = false, bool XW = true, class Acc>
__device__ __forceinline__ void lean_cell(const Acc& a, const CylParams& p, int gy, int gx,
                                          float fo[9], float& rho_o, float& ux_o, float& uy_o) {
  const int W = p.W;
  const bool obs = XW && (gx == 0 || gx == W - 1);
  int oy = 0;  // row offset of the cell streamed: -1 for the OUTFLOW copy
  bool refl_lo = false, refl_hi = false;
  if (YB) {
    if (obs) {
      refl_lo = gy == 0;
      refl_hi = gy == p.H - 1;
    } else if (gy == p.H - 1) {
      oy = -1;
    }
  }
  float raw[9], fn[9];
  raw[0] = a.F(0, oy, 0);
#pragma unroll
  for (int q = 1; q < 9; ++q) {
    const int ex = ex_of(q), ey = ey_of(q);
    const int dx = XW ? (ex == 1 ? (gx == 0 ? 1 : -1) : (ex == -1 ? (gx == W - 1 ? -1 : 1) : 0))
                      : -ex;
    int dy = -ey;
    if (YB && ((ey == 1 && refl_lo) || (ey == -1 && refl_hi))) dy = ey;
    raw[q] = a.F(q, oy + dy, dx);
  }
  fn[0] = raw[0];
#pragma unroll
  for (int q = 1; q < 9; ++q) {
    const int ex = ex_of(q);
    float s = raw[q];
    if (XW && ((ex == 1 && gx == 1) || (ex == -1 && gx == W - 2))) s = a.F(refl(q), oy, 0);
    fn[q] = obs ? raw[refl(q)] : s;
  }
  if (YB && !obs && gy + oy == 0) {
#pragma unroll
    for (int q = 0; q < 9; ++q) fn[q] = p.feq_in[q];
  }
  moments_mrt(p, fn, obs, p.wall_density, 0.0f, 0.0f, fo, rho_o, ux_o, uy_o);
}

// ---------------------------------------------------------------------------
// Temporal blocking: k steps of a (64 - 2k) x 16 (plain channel) or x 8
// (full boundary) tile per block, in shared memory (the tile with its
// halo is 64 cells wide: two warps' widths).
//
// The block loads its tile with a k-cell halo on all four sides (global
// coordinates wrap, so a halo past the grid's edge holds the cells the
// FLUID wrap and the reflect/clamp rules reach), then runs k sub-steps:
// sub-step j updates the tile grown by k - j cells from the previous
// sub-step's values, which are valid one cell further out, so the last
// sub-step gives the tile itself exactly. Two buffers alternate; a
// __syncthreads() separates sub-steps; only the tile's own cells (inside
// the launch's row segments and the grid) reach global memory.
//
// Exactness needs every cell's update to read the previous sub-step
// within one cell. An OUTFLOW cell on the border reads two cells inward;
// the tile stays exact on a border that kernels/cylinder.py::check_border
// accepts (OBSTACLE side columns, no FLUID cell on the first and last
// rows): OUTFLOW cells then copy along y only, no border cell reads
// across the wrap, and a halo cell that reads outside the loaded region
// never feeds the tile.
// ---------------------------------------------------------------------------

constexpr int KMAX = 8;
constexpr int TILE_THREADS_X = 32, TILE_THREADS_Y = 8;  // one warp per tile row
enum TileMode { LEAN = 0, FULL_CYL = 1, FULL_EDGE = 2 };

// Tile width without the halo at depth k.
__host__ __device__ inline int tile_tx(int k) { return TILE_EX - 2 * k; }

// Tile height: 16 rows for the plain channel (less halo work), 8 for the
// full-boundary modes, whose band launches cover few rows and need the
// blocks to fill the card.
__host__ __device__ constexpr int tile_ty(int mode) { return mode == LEAN ? 16 : 8; }

__host__ __device__ inline int row_tiles(const CylParams& p, int ty) {
  return jrl::seg_tiles(p.nseg, p.seg, ty);
}

// Floats of dynamic shared memory a tile of mode M takes at depth k.
__host__ __device__ inline int tile_smem_floats(int mode, int k) {
  const int ext = TILE_EX * (tile_ty(mode) + 2 * k);
  return ext * (mode == LEAN ? 18 : (mode == FULL_CYL ? 24 : 19));
}

// What a tile loader gives for one cell: f (float32), and as the mode
// needs them vel, phi and the flag.
struct TileIn {
  float f[9];
  float vx, vy, ph;
  int fl;
};

// k sub-steps of mode MODE on the tile whose halo starts at global row oy
// and column ox (unwrapped: wrap_near gives the cell); its own cells are
// those below row yend and column xend. load(gy, gx, TileIn&) reads the
// previous step at a global cell, store(yy, xx, fo, rho, ux, uy) writes an
// own cell of the last sub-step (yy, xx unwrapped). YB: the lean cell's
// first/last-row rules (lean_cell), with clamped tile reads (the OUTFLOW
// copy reads two rows away). k is a template parameter: the buffer
// strides become immediate offsets.
template <int MODE, int k, bool YB, class Load, class Store>
__device__ __forceinline__ void tile_run(const CylParams& p, int oy, int ox, int yend, int xend,
                                         Load load, Store store) {
  extern __shared__ float smem[];
  constexpr bool FULL = MODE != LEAN, VEL = MODE == FULL_CYL;
  constexpr int EY = tile_ty(MODE) + 2 * k, EXT = TILE_EX * EY;
  const int H = p.H, W = p.W;
  // sub-step buffers b = 0, 1 as offsets from smem (a pointer array indexed
  // at run time would lose the shared address space: generic loads)
  auto fb = [&](int b) { return smem + b * 9 * EXT; };
  auto vb = [&](int b) { return VEL ? smem + (18 + 2 * b) * EXT : nullptr; };
  int* fl = FULL ? reinterpret_cast<int*>(smem + (VEL ? 22 : 18) * EXT) : nullptr;
  float* ph = VEL ? smem + 23 * EXT : nullptr;
  const int tx = threadIdx.x, tyi = threadIdx.y;

  for (int ly = tyi; ly < EY; ly += TILE_THREADS_Y) {
    const int gy = wrap_near(oy + ly, H);
    for (int lx = tx; lx < TILE_EX; lx += TILE_THREADS_X) {
      const int i = ly * TILE_EX + lx;
      TileIn in;
      load(gy, wrap_near(ox + lx, W), in);
#pragma unroll
      for (int q = 0; q < 9; ++q) smem[q * EXT + i] = in.f[q];
      if (VEL) {
        smem[18 * EXT + i] = in.vx;
        smem[19 * EXT + i] = in.vy;
        ph[i] = in.ph;
      }
      if (FULL) fl[i] = in.fl;
    }
  }
  __syncthreads();

  int cur = 0;
  for (int j = 1; j <= k; ++j) {
    // store one updated cell into the other buffer, or at the last
    // sub-step into the outputs
    auto put = [&](int ly, int lx, const float fo[9], float r, float ux, float uy) {
      if (j < k) {
        const int li = ly * TILE_EX + lx;
        float* dst = fb(cur ^ 1);
#pragma unroll
        for (int q = 0; q < 9; ++q) dst[q * EXT + li] = fo[q];
        if (VEL) {
          vb(cur ^ 1)[li] = ux;
          vb(cur ^ 1)[EXT + li] = uy;
        }
      } else {
        const int yy = oy + ly, xx = ox + lx;
        if (yy < yend && xx < xend) store(yy, xx, fo, r, ux, uy);
      }
    };
    for (int ly = j + tyi; ly < EY - j; ly += TILE_THREADS_Y) {
      const int gy = wrap_near(oy + ly, H);
      if constexpr (MODE == LEAN) {
        // two independent cells a thread (x and x + 32), both computed
        // unconditionally so that their instructions interleave; past the
        // row's end the second repeats the last cell and is not stored
        const int la = j + tx, lb = min(la + TILE_THREADS_X, TILE_EX - 1 - j);
        float fa[9], fbb[9], ra, uxa, uya, rb, uxb, uyb;
        lean_cell<YB>(SmemAcc<YB, EY>{fb(cur), nullptr, nullptr, nullptr, ly, la}, p, gy,
                      wrap_near(ox + la, W), fa, ra, uxa, uya);
        lean_cell<YB>(SmemAcc<YB, EY>{fb(cur), nullptr, nullptr, nullptr, ly, lb}, p, gy,
                      wrap_near(ox + lb, W), fbb, rb, uxb, uyb);
        put(ly, la, fa, ra, uxa, uya);
        if (la + TILE_THREADS_X < TILE_EX - j) put(ly, lb, fbb, rb, uxb, uyb);
      } else {
        for (int lx = j + tx; lx < TILE_EX - j; lx += TILE_THREADS_X) {
          const int gx = wrap_near(ox + lx, W);
          const SmemAcc<true, EY> a{fb(cur), vb(cur), fl, ph, ly, lx};
          float fo[9], r, ux, uy;
          if constexpr (MODE == FULL_CYL) {
            full_cell<true>(a, p, gy, gx, p.wall_density, a.vx(0, 0), a.vy(0, 0), fo, r, ux,
                            uy);
          } else {
            full_cell<false>(a, p, gy, gx, p.wall_density, 0.0f, 0.0f, fo, r, ux, uy);
          }
          put(ly, lx, fo, r, ux, uy);
        }
      }
    }
    __syncthreads();
    cur ^= 1;
  }
}

// tile_run on the launch's row segments of the whole grid, from and to
// device memory. ST: the storage of f and f_out; the tile holds float32.
template <int MODE, int k, int ST>
__device__ __forceinline__ void tile_steps(const f_t<ST>* f, const float* vel, const int* flags,
                                           const float* phi, f_t<ST>* f_out, float* rho_out,
                                           float* vel_out, const CylParams& p) {
  constexpr bool FULL = MODE != LEAN, VEL = MODE == FULL_CYL;
  const int W = p.W, HW = p.H * p.W;
  int ty0, yend;
  if (!jrl::seg_tile_origin(p.nseg, p.seg, blockIdx.y, tile_ty(MODE), ty0, yend)) return;
  const bool write_macro = MODE != LEAN || p.write_macro;
  tile_run<MODE, k, false>(
      p, ty0 - k, blockIdx.x * tile_tx(k) - k, yend, W,
      [&](int gy, int gx, TileIn& in) {
        const int g = gy * W + gx;
#pragma unroll
        for (int q = 0; q < 9; ++q) in.f[q] = f_load<ST>(f, q * HW + g, q);
        if (VEL) {
          in.vx = vel[g];
          in.vy = vel[HW + g];
          in.ph = phi[g];
        }
        if (FULL) in.fl = flags[g];
      },
      [&](int yy, int xx, const float fo[9], float r, float ux, float uy) {
        const int c = yy * W + xx;
        f_store<ST>(f_out, HW, c, fo, p);
        if (write_macro) {
          rho_out[c] = r;
          vel_out[c] = ux;
          vel_out[HW + c] = uy;
        }
      });
}

// Calls fn(std::integral_constant<int, k>) for the run-time k in 1..KMAX.
template <class Fn>
int with_k(int k, Fn fn) {
  switch (k) {
    case 1: return fn(std::integral_constant<int, 1>());
    case 2: return fn(std::integral_constant<int, 2>());
    case 3: return fn(std::integral_constant<int, 3>());
    case 4: return fn(std::integral_constant<int, 4>());
    case 5: return fn(std::integral_constant<int, 5>());
    case 6: return fn(std::integral_constant<int, 6>());
    case 7: return fn(std::integral_constant<int, 7>());
    case 8: return fn(std::integral_constant<int, 8>());
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace cyl
