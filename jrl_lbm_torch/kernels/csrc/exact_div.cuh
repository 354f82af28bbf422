// Division policies of the JRL cell code (jrl_common.cuh::feq_q, conv_rate,
// collide_conv_q, TipSdf::phi; jrl_c.cuh::approach_cell_at and the window
// fill). Every division there is by a divisor fixed for a launch: the
// lattice constants CS2F and CS4F, sqrt(2) of the wedge SDF, and the
// column's r = x + 0.5.
//
// - IeeeDiv, the default: x / d as written, which nvcc compiles to IEEE
//   round-to-nearest division (a reciprocal, Newton steps, a range check
//   and a branch to a slow path), so a kernel that names no policy
//   compiles to the machine code it had before the policies existed.
// - RcpDiv: the same quotient from the divisor's correctly rounded
//   reciprocal y = __frcp_rn(d), taken once a launch, and one FMA
//   correction (Markstein): q0 = x y, e = x - q0 d (exact, by FMA),
//   q = q0 + e y; the residual is formed negated, e' = q0 d - x and q =
//   q0 - e' y, the same values for x != 0 (round to nearest is
//   symmetric) and the signed zero that x = +-0 needs (the plain form
//   gives +0 for -0). Where |x| is 0 or lies in [RCP_DIV_LO, RCP_DIV_HI]
//   that is bit for bit __fdiv_rn(x, d) for every divisor the kernels use:
//   the check exact_div_count (built into fused_approach_rw.cu, run by
//   tests/test_torch_cuda.py and chip_smoke.py) compares the two over all
//   2^32 float32 bit patterns as x, for CS2F, CS4F, sqrt(2) and r = x + 0.5
//   at every column x < 512, and finds no difference. Outside that range
//   (subnormals, the largest magnitudes, inf, NaN) the float path is not
//   exact, and the guard takes rcp_div_far: the same correction in double
//   precision, rounded to float once more, which the check proves exact
//   too. Neither path calls a subroutine (nvcc's IEEE division branches
//   to one, whose call makes a register-bound kernel spill): three
//   multiply-adds and the guard's compares in place of the IEEE sequence.
//   A guard a division: one guard for a cell's equilibria, the group taken
//   again where a numerator fell outside the range, made the approach's
//   row kernel spill and run 11% slower (PERF.md §6).
#pragma once

#include <cuda_runtime.h>

namespace jrl {

// the magnitudes of x where RcpDiv's fast path is exact for every divisor
// in [2^-4, 2^10) (no product, residual or quotient leaves the normal range)
constexpr float RCP_DIV_LO = 0x1p-100f;
constexpr float RCP_DIV_HI = 0x1p+100f;

// x / d where x is subnormal, tiny, huge, inf or NaN: inf and NaN through
// the product x y (inf / d is inf; a NaN stays NaN); the rest from a double
// reciprocal of d (y and two Newton steps: within an ulp of 1 / d), the
// quotient and one FMA correction in double (no product, residual or
// quotient of a float x leaves double's normal range), rounded to float:
// the double quotient is within an ulp of x / d, and a quotient of two
// floats that is no float midpoint lies further than that from every one.
__device__ __forceinline__ float rcp_div_far(float x, float d, float y) {
  if (!(fabsf(x) <= 3.4028234663852886e38f)) return __fmul_rn(x, y);
  const double dd = d, xd = x;
  double yd = y;
  yd = __fma_rn(yd, __fma_rn(-dd, yd, 1.0), yd);
  yd = __fma_rn(yd, __fma_rn(-dd, yd, 1.0), yd);
  const double qd = __dmul_rn(xd, yd);
  return __double2float_rn(__fma_rn(-__fma_rn(qd, dd, -xd), yd, qd));
}

// Whether rcp_div's float path is exact for x: x = +-0 or |x| in
// [RCP_DIV_LO, RCP_DIV_HI].
__device__ __forceinline__ bool rcp_div_in(float x) {
  const float ax = fabsf(x);
  return ax <= RCP_DIV_HI && (ax >= RCP_DIV_LO || ax == 0.0f);
}

// The float path: q0 = x y, e' = q0 d - x (exact, by FMA), q0 - e' y.
__device__ __forceinline__ float rcp_div_near(float x, float d, float y) {
  const float q0 = __fmul_rn(x, y);
  const float e = __fmaf_rn(q0, d, -x);
  return __fmaf_rn(-e, y, q0);
}

// __fdiv_rn(x, d) from y = __frcp_rn(d) (d in [2^-4, 2^10))
__device__ __forceinline__ float rcp_div(float x, float d, float y) {
  if (rcp_div_in(x)) return rcp_div_near(x, d, y);
  return rcp_div_far(x, d, y);
}

// lattice constants as the JAX package rounds its Python doubles
constexpr float CS2F = (float)(1.0 / 3.0);
constexpr float CS4F = (float)((1.0 / 3.0) * (1.0 / 3.0));

// The constant divisors' reciprocals, rounded to nearest: 1 / CS2F, 1 / CS4F
// (CS2F, CS4F rounded from 1/3 and 1/9 a hair above, so 3 and 9 exactly) and
// 1 / f32(sqrt(2)). exact_div_count checks each against __frcp_rn of its
// divisor before it counts.
constexpr float RCP_CS2F = 3.0f;
constexpr float RCP_CS4F = 9.0f;
constexpr float SQRT2F = (float)1.4142135623730951;
constexpr float RCP_SQRT2F = 0x1.6a09e6p-1f;

// x / d as written: IEEE division
struct IeeeDiv {
  __device__ __forceinline__ static IeeeDiv for_col(float) { return IeeeDiv{}; }
  __device__ __forceinline__ float cs2(float x) const { return x / CS2F; }
  __device__ __forceinline__ float cs4(float x) const { return x / CS4F; }
  __device__ __forceinline__ float sqrt2(float x) const { return x / SQRT2F; }
  // x / r, r = the cell's column + 0.5
  __device__ __forceinline__ float col(float x, float r) const { return x / r; }
};

// x / d by rcp_div; col() divides by the r whose reciprocal yr holds (the
// cell's column: the caller passes that r)
struct RcpDiv {
  float yr;
  // the policy of a column whose r has the reciprocal yr (__frcp_rn(r))
  __device__ __forceinline__ static RcpDiv for_col(float yr) { return RcpDiv{yr}; }
  __device__ __forceinline__ float cs2(float x) const { return rcp_div(x, CS2F, RCP_CS2F); }
  __device__ __forceinline__ float cs4(float x) const { return rcp_div(x, CS4F, RCP_CS4F); }
  __device__ __forceinline__ float sqrt2(float x) const { return rcp_div(x, SQRT2F, RCP_SQRT2F); }
  __device__ __forceinline__ float col(float x, float r) const { return rcp_div(x, r, yr); }
};

}  // namespace jrl
