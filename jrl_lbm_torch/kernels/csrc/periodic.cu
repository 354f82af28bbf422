// Doubly-periodic shear layer, one step, one thread per cell: pull f[q]
// from ((y - ey) mod H, (x - ex) mod W), moments (rho, then mom_x, mom_y,
// u = mom / rho with rho == 0 read as 1), the division-free equilibrium,
// and the relaxation chosen at compile time: BGK, MRT (paired even/odd
// form, no obstacle) or KBC in its five types (LBGK, KBC_A .. KBC_D).
// Writes f, rho and vel (the pre-collision moments).
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_periodic.py::
// _make_kernel (its KBC body _kbc_apply). Plain twin: kernels/periodic.py::
// periodic_ref, operation by operation; each constant arrives rounded
// once from the double the Pallas body forms, and the build has
// --fmad=false and IEEE division, so kernel and twin round alike.
//
// Bound on the card: memory, 84 bytes a cell (9 f planes in; 9 f, rho and
// 2 vel planes out): at 2048² 4,194,304 cells, 352.3 MB, 105.2 µs a step
// at 3.35 TB/s; at 130² 1.42 MB, 0.42 µs, so there the launch and the
// host wrapper set the pace. Float32 work is ~95 (BGK), ~175 (MRT) and
// ~440 (KBC_A) operations a cell, at most 27.5 µs a step at 2048² at 67
// TFLOP/s. Design:
// consecutive threads on consecutive cells of a row (coalesced stores,
// the nine pulls served from L1/L2 through the neighbours' reads); the
// Pallas kernel's wrapped 8-row halo blocks and lane rolls have no
// counterpart, so H needs no multiple of 8. TMA, wgmma and multi-step
// blocking are later work.
#include "cyl_common.cuh"

// Outside the anonymous namespace: the C entry point takes it.
namespace shear {

// Mirrors kernels/periodic.py::PeriodicParams.
struct PeriodicParams {
  int H, W;
  float inv_tau;         // (float)(1/tau): BGK
  float beta;            // (float)(1/(2 tau))
  float beta2;           // (float)(beta * 2.0): LBGK
  float inv_beta;        // (float)(1/beta)
  float two_m_inv_beta;  // (float)(2 - 1/beta)
  float eps;             // (float)1e-10
  float ev0[5];          // even coefficients of direction 0
  float ev[4][5];        // even coefficients of the pairs (1,3) (2,4) (5,7) (6,8)
  float od[4][4];        // odd coefficients of the same pairs
};

}  // namespace shear

namespace {

using cyl::dot;
using cyl::feq_terms;
using jrl::ex_of;
using jrl::ey_of;
using shear::PeriodicParams;

enum Relax { BGK = 0, MRT = 1, KBC = 2 };
enum KbcKind { LBGK = 0, KBC_A = 1, KBC_B = 2, KBC_C = 3, KBC_D = 4 };

// fused_step.py::_mrt_apply without the obstacle.
__device__ __forceinline__ void mrt_apply(const PeriodicParams& p, const float fb[9],
                                          const float fe[9], float fo[9]) {
  float d[9];
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

// T = M20 + M02, N = M20 - M02, PIxy = M11 of fs: central moments
// (e - u)^p (e - u)^q for KBC A/B, the raw rows M20, M11, M02 of
// KBC_C_MAT for C/D; summed in q order as _kbc_apply does.
template <int KIND>
__device__ __forceinline__ void kbc_moments(const float fs[9], float ux, float uy, float& T,
                                            float& N, float& PI) {
  float m20, m11, m02;
  if (KIND == KBC_A || KIND == KBC_B) {
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const float du = (float)ex_of(q) - ux;
      const float dv = (float)ey_of(q) - uy;
      const float t20 = du * du * fs[q];
      const float t11 = du * dv * fs[q];
      const float t02 = dv * dv * fs[q];
      m20 = q == 0 ? t20 : m20 + t20;
      m11 = q == 0 ? t11 : m11 + t11;
      m02 = q == 0 ? t02 : m02 + t02;
    }
  } else {
    m20 = fs[1] + fs[3] + fs[5] + fs[6] + fs[7] + fs[8];
    m11 = fs[5] - fs[6] + fs[7] - fs[8];
    m02 = fs[2] + fs[4] + fs[5] + fs[6] + fs[7] + fs[8];
  }
  T = m20 + m02;
  N = m20 - m02;
  PI = m11;
}

template <int KIND>
__device__ __forceinline__ void shear_parts(float rho, float ux, float uy, float T, float N,
                                            float PI, float s[9]) {
  float s0, sp, sq;
  if (KIND == KBC_A || KIND == KBC_C) {
    s0 = rho - T;
    sp = 0.25f * (T + N);
    sq = 0.25f * (T - N);
  } else {
    s0 = rho;
    sp = 0.25f * N;
    sq = -0.25f * N;
  }
  const float hx = (0.5f * rho) * ux, hy = (0.5f * rho) * uy;
  s[0] = s0;
  s[1] = sp + hx;
  s[2] = sq + hy;
  s[3] = sp - hx;
  s[4] = sq - hy;
  s[5] = 0.25f * PI;
  s[6] = -0.25f * PI;
  s[7] = 0.25f * PI;
  s[8] = -0.25f * PI;
}

// fused_periodic.py::_kbc_apply: Omega = -beta (2 ds + gamma dh).
template <int KIND>
__device__ __forceinline__ void kbc_apply(const PeriodicParams& p, const float fb[9],
                                          const float fe[9], float rho, float ux, float uy,
                                          float fo[9]) {
  float df[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) df[q] = fb[q] - fe[q];
  if (KIND == LBGK) {
#pragma unroll
    for (int q = 0; q < 9; ++q) fo[q] = fb[q] - p.beta2 * df[q];
    return;
  }
  float T, N, PI, s_f[9], s_e[9];
  kbc_moments<KIND>(fb, ux, uy, T, N, PI);
  shear_parts<KIND>(rho, ux, uy, T, N, PI, s_f);
  kbc_moments<KIND>(fe, ux, uy, T, N, PI);
  shear_parts<KIND>(rho, ux, uy, T, N, PI, s_e);
  float ds[9], dh[9], dsdh, dhdh;
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    ds[q] = s_f[q] - s_e[q];
    dh[q] = df[q] - ds[q];
    const float inv = 1.0f / (fe[q] + p.eps);
    const float a = ds[q] * dh[q] * inv;
    const float b = dh[q] * dh[q] * inv;
    dsdh = q == 0 ? a : dsdh + a;
    dhdh = q == 0 ? b : dhdh + b;
  }
  const float gamma = p.inv_beta - p.two_m_inv_beta * (dsdh / (dhdh + p.eps));
#pragma unroll
  for (int q = 0; q < 9; ++q) fo[q] = fb[q] - p.beta * (2.0f * ds[q] + gamma * dh[q]);
}

template <int RELAX, int KIND>
__global__ void __launch_bounds__(256) periodic_kernel(const float* __restrict__ f,
                                                       float* __restrict__ f_out,
                                                       float* __restrict__ rho_out,
                                                       float* __restrict__ vel_out,
                                                       PeriodicParams p) {
  const int H = p.H, W = p.W;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;  // H * W < 2**31 (wrapper)
  if (c >= H * W) return;
  const int y = c / W, x = c - y * W;
  const size_t HW = (size_t)H * W;
  float fb[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    int yy = y - ey_of(q), xx = x - ex_of(q);
    yy += yy < 0 ? H : 0;
    yy -= yy >= H ? H : 0;
    xx += xx < 0 ? W : 0;
    xx -= xx >= W ? W : 0;
    fb[q] = f[q * HW + (size_t)yy * W + xx];
  }
  float rho = fb[0];
#pragma unroll
  for (int q = 1; q < 9; ++q) rho = rho + fb[q];
  const float mom_x = fb[1] - fb[3] + fb[5] - fb[6] - fb[7] + fb[8];
  const float mom_y = fb[2] - fb[4] + fb[5] + fb[6] - fb[7] - fb[8];
  const float safe = rho == 0.0f ? 1.0f : rho;
  const float ux = mom_x / safe;
  const float uy = mom_y / safe;
  float fe[9], fo[9];
  feq_terms(rho, ux, uy, fe);
  if (RELAX == BGK) {
#pragma unroll
    for (int q = 0; q < 9; ++q) fo[q] = fb[q] + p.inv_tau * (fe[q] - fb[q]);
  } else if (RELAX == MRT) {
    mrt_apply(p, fb, fe, fo);
  } else {
    kbc_apply<KIND>(p, fb, fe, rho, ux, uy, fo);
  }
#pragma unroll
  for (int q = 0; q < 9; ++q) f_out[q * HW + c] = fo[q];
  rho_out[c] = rho;
  vel_out[c] = ux;
  vel_out[HW + c] = uy;
}

template <int RELAX, int KIND>
int launch(const float* f, float* f_out, float* rho_out, float* vel_out, const PeriodicParams& p,
           cudaStream_t stream) {
  const int threads = 256;
  const long long cells = (long long)p.H * p.W;
  const unsigned blocks = (unsigned)((cells + threads - 1) / threads);
  periodic_kernel<RELAX, KIND><<<blocks, threads, 0, stream>>>(f, f_out, rho_out, vel_out, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int periodic_launch(const float* f, float* f_out, float* rho_out, float* vel_out,
                               int relax, int kind, const shear::PeriodicParams* p,
                               void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (relax == BGK) return launch<BGK, 0>(f, f_out, rho_out, vel_out, *p, s);
  if (relax == MRT) return launch<MRT, 0>(f, f_out, rho_out, vel_out, *p, s);
  if (relax != KBC) return (int)cudaErrorInvalidValue;
  switch (kind) {
    case LBGK: return launch<KBC, LBGK>(f, f_out, rho_out, vel_out, *p, s);
    case KBC_A: return launch<KBC, KBC_A>(f, f_out, rho_out, vel_out, *p, s);
    case KBC_B: return launch<KBC, KBC_B>(f, f_out, rho_out, vel_out, *p, s);
    case KBC_C: return launch<KBC, KBC_C>(f, f_out, rho_out, vel_out, *p, s);
    case KBC_D: return launch<KBC, KBC_D>(f, f_out, rho_out, vel_out, *p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
