// Philox4x32-10 (Salmon et al., SC 2011; the Random123 definition): a
// counter-based generator, so each thread draws its own bits from (its
// counter, the launch's key) with no state in memory. Ten rounds of two
// 32x32->64 multiplies over a 4-word counter; the 2-word key is bumped
// between rounds. Plain twin: kernels/philox.py::philox4x32 (the same
// words for the same counter and key; known answers in
// tests/test_torch_storage.py). The counter layout of the
// stochastic-rounding stores is in kernels/philox.py.
#pragma once

namespace philox {

constexpr unsigned M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
constexpr unsigned BUMP0 = 0x9E3779B9u, BUMP1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0, unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += BUMP0;
      k1 += BUMP1;
    }
    const unsigned hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const unsigned hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

}  // namespace philox
