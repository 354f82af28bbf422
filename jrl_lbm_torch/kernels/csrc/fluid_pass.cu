// JRL fluid phase, one k = 1 split pass in one launch: the full class on
// the full rows and the lean class on the lean rows of the pass, streamed
// row by row (pass_state.cuh).
//
// Replaces, at k = 1, what the TPU code jrl_lbm_tpu/ops/pallas/
// fused_jrl_tiled.py::_fluid_k_split_chunk does with two of its kernels,
// _make_fluid_k_kernel (the full class) and _make_fluid_k_lean_kernel (the
// lean class); k = 2..4 keep fluid_k.cu and fluid_k_lean.cu, the rows
// under a flat tip fluid_k_bt.cu. Plain twin: kernels/jrl_tiled.py::
// fluid_pass_ref. The cell code is jrl_fluid.cuh's, unchanged, so the
// launch equals fluid_k + fluid_k_lean bit for bit.
//
// Bound on the card: the bytes (12 planes in and 12 out a full row, 9 in
// and 12 out a lean row: ~14 us for the 1024x512 pass at 3.35 TB/s); the
// cell code is ~650 float32 operations a full cell, ~420 a lean one. What
// held the tile classes back, and what this design does about it:
// - tiles of 8 x 60 cells from 12 x 64 windows (1.6 reads a cell, A on 1.3
//   cells a cell, 3 blocks an SM at 71 KB): one block an SM walks a run of
//   rows over the whole width (512 threads, one column each), so A runs on
//   (R + 2) / R rows a row and no column is recomputed;
// - two launches a pass, each with its tail: one launch, the class a
//   property of the run (one per block, so no warp diverges on it), lean
//   runs as much longer as a lean row is cheaper (jrl_tiled.py::
//   PASS_LEAN_COST), so that the blocks of the one wave end together;
// - the tip SDF evaluated tens of times per cell (an IEEE division each,
//   for the wedges): once per window cell and step, into the geometry ring;
// - the window loaded by every thread before any cell, and a barrier
//   between every two sub-steps: rows stream through a ring by
//   cp.async.bulk copies issued a phase ahead, and A on one row and B on
//   a row three behind share a phase, one barrier a row.
#include "pass_state.cuh"

namespace {

using namespace jrl;

template <int CLS>
__device__ __forceinline__ void pass_run(const float* f, const float* rho, const float* vel,
                                         float* f_out, float* rho_out, float* vel_out, int step,
                                         const PassParams& p, int ry0, int ry1, float* smem,
                                         uint64_t* bars) {
  const int H = p.a.H, W = p.a.W, HW = H * W, RS = p.rs;
  const PassStrip st(blockIdx.x, p.nstrips, W);
  float* const ring = smem;
  float* const rv = ring + PASS_D * PASS_NP * RS;
  float* const fa = rv + PASS_RV * 3 * RS;
  float* const phis = fa + PASS_FA * 9 * RS;
  unsigned char* const codes = reinterpret_cast<unsigned char*>(phis + PASS_G * RS);
  const int tid = threadIdx.x;
  const int n_in = ry1 - ry0 + 4;  // input rows y0 - 2 .. y1 + 1
  const int ybase = wrap1(ry0 - 2, H);
  const int ncols = st.cx1 - st.cx0;
  constexpr int NPL = CLS == TILE_LEAN ? 9 : PASS_NP;  // planes a row loads

  if (tid == 0) {
    for (int s = 0; s < PASS_D; ++s) mbar_init(smem_addr(bars + s));
    mbar_init_fence();
    // the initialised mbarriers visible to the async proxy, whose copies
    // complete on them
    fence_proxy_async();
  }
  __syncthreads();
  // thread 0: input row j into slot j % PASS_D
  auto issue = [&](int j) {
    const int s = j % PASS_D, y = wrap1(ybase + j, H);
    const uint32_t bar = smem_addr(bars + s), bytes = 4u * (uint32_t)ncols;
    mbar_expect(bar, bytes * NPL);
    const int g = y * W + st.cx0;
    float* const dst = ring + s * PASS_NP * RS;
#pragma unroll
    for (int q = 0; q < 9; ++q) bulk_g2s(smem_addr(dst + q * RS), f + q * HW + g, bytes, bar);
    if (CLS != TILE_LEAN) {
      bulk_g2s(smem_addr(dst + 9 * RS), rho + g, bytes, bar);
      bulk_g2s(smem_addr(dst + 10 * RS), vel + g, bytes, bar);
      bulk_g2s(smem_addr(dst + 11 * RS), vel + HW + g, bytes, bar);
    }
  };
  auto wait_row = [&](int j) { mbar_wait(smem_addr(bars + j % PASS_D), (j / PASS_D) & 1); };
  if (tid == 0)
    for (int j = 0; j < PASS_D && j < n_in; ++j) issue(j);

  // the geometry of the step: FluidGeo's values once per window cell
  const FluidGeo fg = fluid_geo(step, p.a);
  auto geo_row = [&](int j) {
    const int y = wrap1(ybase + j, H);
    float* const ph = phis + (j & (PASS_G - 1)) * RS;
    unsigned char* const cd = codes + (j & (PASS_G - 1)) * RS;
    for (int c = tid; c < ncols; c += PASS_THREADS) cd[c] = geo_code(fg, y, st.cx0 + c, ph[c]);
  };
  const auto geo = [&] {
    if constexpr (CLS == TILE_LEAN) {
      return LeanGeo{H, W};
    } else {
      return RingGeo{H, W, ybase, RS, st.cx0, fg.flat, fg.vel_obs, phis, codes};
    }
  }();
  if (CLS != TILE_LEAN)
    for (int j = 0; j < 4 && j < n_in; ++j) geo_row(j);
  __syncthreads();  // the geometry rows every thread's first A reads

  // this thread's column: A where a_on, B where b_on
  const int x = st.ax0 + tid, c = x - st.cx0;
  const bool a_on = x < st.ax1, b_on = x >= st.sx0 && x < st.sx1;

  // phase a: A on row t = y0 - 1 + a (ring row j = a + 1) and B on row
  // y0 + a - 3, which reads A's rows a - 3 .. a - 1; one barrier a phase
#pragma unroll 1
  for (int a = 0; a < n_in - 1; ++a) {
    // slot (a - 1) % PASS_D is free: A on rows a and on read j >= a
    if (tid == 0 && a >= 1 && a + 4 < n_in) {
      fence_proxy_async();
      issue(a + 4);
    }
    const int t = ry0 - 1 + a;
    if (a_on && a < n_in - 2 && t < H) {
      if (a == 0)
        for (int j = 0; j < 3; ++j) wait_row(j);
      if (a + 3 < n_in) wait_row(a + 3);
    }
    if (CLS != TILE_LEAN && a + 4 < n_in) geo_row(a + 4);
    if (a_on && a < n_in - 2 && t < H) {
      const int y = wrap1(t, H), k = a & (PASS_RV - 1), kf = a % PASS_FA;
      float fo[9], r, u, v;
      fluid_a_cell(PassIn{ring, RS, (a + 1) % PASS_D, c}, geo, p.a.cs2tau, y, x, fo, r, u, v);
#pragma unroll
      for (int q = 0; q < 9; ++q) fa[(kf * 9 + q) * RS + c] = fo[q];
      rv[(k * 3 + 0) * RS + c] = r;
      rv[(k * 3 + 1) * RS + c] = u;
      rv[(k * 3 + 2) * RS + c] = v;
    }
    if (a >= 3 && b_on) {
      const int y = ry0 + a - 3, k = (a - 2) & (PASS_RV - 1);
      float fo[9];
      fluid_b_cell(PassB{rv, fa + ((a - 2) % PASS_FA) * 9 * RS, RS, k, c}, geo, p.b, y, x, fo);
      const int o = y * W + x;
#pragma unroll
      for (int q = 0; q < 9; ++q) f_out[q * HW + o] = fo[q];
      rho_out[o] = rv[(k * 3 + 0) * RS + c];
      vel_out[o] = rv[(k * 3 + 1) * RS + c];
      vel_out[HW + o] = rv[(k * 3 + 2) * RS + c];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(PASS_THREADS, 1) fluid_pass_kernel(
    const float* __restrict__ f, const float* __restrict__ rho, const float* __restrict__ vel,
    float* __restrict__ f_out, float* __restrict__ rho_out, float* __restrict__ vel_out,
    int step, PassParams p) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t bars[PASS_D];
  const int code = p.run[blockIdx.y];
  const int ry0 = code & 0x7fff, ry1 = (code >> 15) & 0x7fff;
  if ((code >> 30) == TILE_LEAN)
    pass_run<TILE_LEAN>(f, rho, vel, f_out, rho_out, vel_out, step, p, ry0, ry1, smem, bars);
  else
    pass_run<TILE_FULL>(f, rho, vel, f_out, rho_out, vel_out, step, p, ry0, ry1, smem, bars);
}

}  // namespace

// Registers per thread and local (spill) bytes of the kernel.
extern "C" int jrl_fluid_pass_info(int* regs, int* local_bytes) {
  return kernel_info(fluid_pass_kernel, regs, local_bytes);
}

extern "C" int jrl_fluid_pass(const float* f, const float* rho, const float* vel, float* f_out,
                              float* rho_out, float* vel_out, int step, const PassParams* p,
                              void* stream) {
  if (p->rs < 4 || p->rs > PASS_MAX_RS || p->rs % 4 || p->a.W % 4 || p->nruns < 1 ||
      p->nruns > PASS_MAX_RUNS || p->nstrips < 1)
    return (int)cudaErrorInvalidValue;
  const int err = smem_attr_once<fluid_pass_kernel>(pass_smem_bytes(PASS_MAX_RS));
  if (err != (int)cudaSuccess) return err;
  fluid_pass_kernel<<<dim3(p->nstrips, p->nruns), PASS_THREADS, pass_smem_bytes(p->rs),
                      (cudaStream_t)stream>>>(f, rho, vel, f_out, rho_out, vel_out, step, *p);
  return (int)cudaGetLastError();
}
