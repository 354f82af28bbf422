// JRL concentration approach, n steps of the whole grid in one cooperative
// launch of whole-row runs: one persistent block an SM owns a run of whole
// rows for the launch; each step its window (the run and one row a side)
// lands in shared memory by cp.async.bulk while the block tables the step's
// tip (flag and phi of every window cell), its cells run the approach from
// the window and write h and C, one grid barrier ends the step, and block 0
// then adds the step's tip-disk terms from the new C. After the last step:
// the last step's record velocities (rec_u, rec_v) and one reduction of the
// integrals into acc.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl.py::
// _make_approach_kernel (called by _fused_approach_seg), as fused_approach.cu
// does, which stays the yardstick (route="coop") and the route of the grids
// where this kernel does not win; fused_jrl.py::fused_route takes this
// kernel where it measures faster (ROWS_MIN_CELLS). Plain twin: kernels/
// fused_jrl.py::fused_approach_rw_ref, the launch played run by run on the
// CPU, each run from its own window. The cell code is jrl_c.cuh's (streaming
// and C as approach_cell_at, the collision from the column's terms),
// unchanged in its operations (with --fmad=false), and the integrals are
// fused_approach's, in the same fixed order, so the launch equals
// fused_approach bit for bit, h, C and acc. Step i is start + i in integers,
// converted once (jrl_common.cuh::tip_walks): the jnp form.
//
// Bound on the card: the operations, ~335 float32 operations a cell and step
// (0.66 us a step at 512x256 at the 67 TFLOP/s float32 peak); the state (h,
// C, the base flags, 11 planes, 5.8 MB at 512x256) stays in the 50 MB L2
// between steps, and the frames the steps read cross device memory once a
// frame. What fused_approach pays, and what this design does about it:
// - every neighbour read of the cell code is an L2 round trip (a thread's
//   cells are strided over the whole grid): here the run's window of h (9
//   planes, the run's rows and one a side; two rows inward at rows 0 and H -
//   1 lie in the first and last runs' windows, runs of two rows or more)
//   lands in shared memory by cp.async.bulk, one copy a plane row, one
//   mbarrier a window row, and the cells of a row start once their rows
//   have landed (c_approach_pass.cu's form, made multi-step: a
//   fence.proxy.async.global before each copy, as the rows were written by
//   other blocks before the grid barrier);
// - the tip SDF at every geometry query (~10 a cell, each an IEEE division
//   for the wedges): flag and phi once a window cell and step into a table
//   (jrl_c.cuh::WindowGeo), filled while the rows land;
// - IEEE divisions in the cell code (~40 a cell and step: feq_q's two a
//   direction, conv_rate's two): the column's rate and source factor once a
//   launch (the same operations, so the same values), opposite directions'
//   equilibria sharing their quotients (jrl_common.cuh::feq_all: ten in
//   place of eighteen), and every division left (ten by CS2F and CS4F, one
//   by r = x + 0.5, the table's by sqrt(2)) by the divisor's correctly
//   rounded reciprocal and one FMA correction (exact_div.cuh::RcpDiv), bit
//   for bit IEEE division as exact_div_count below proves over every
//   float32 numerator.
//
// The stored velocity: each thread keeps its cells' frame pair beside it in
// shared memory (at 1024 threads the registers are the cell code's: four
// more spill) and reloads it only when the frame index changes
// (fused_approach's interval loop, jrl_c.cuh::frame_vel). Step i reads the
// h that step i - 1 wrote (the input for i = 0) and writes set P for even
// i, Q for odd i, so the last step writes the set the caller named last
// (fused_jrl.py::_ping_pong). No division in the cell code calls nvcc's
// IEEE slow path (exact_div.cuh): at 64 registers its call spilled 16
// bytes.
//
// Instances, by -D at build time (tools/fused_cluster_probe.py rows): the
// block's threads (JRL_RW_THREADS: 1024, one cell a thread of a run of up to
// RW_CELLS, kept: 64 registers, no spill, the faster at 512x256; or 512,
// two cells a thread in turn, ~120 registers, the faster at 256x128 by
// ~10%), IEEE division in place of RcpDiv (JRL_RW_IEEE), and the timing
// probes with wrong results or none of a saving, never a route: no cell
// code (JRL_RW_NO_CELLS), the SDF at every geometry query instead of the
// table (JRL_RW_SDF).
#include "pass_sh.cuh"

// Mirrors kernels/fused_jrl.py::RwParams.
struct RwParams {
  CApproachParams a;
  int nruns;     // blocks: block b computes rows [b H / nruns, (b + 1) H / nruns)
  int wrows;     // window rows a block's planes hold: the longest run + 2
  int n_frames;  // frames of the stored velocity
};

namespace {

using namespace jrl;
namespace cg = cooperative_groups;

#ifndef JRL_RW_THREADS
#define JRL_RW_THREADS 1024
#endif
constexpr int RW_THREADS = JRL_RW_THREADS;
constexpr int RW_CELLS = 1024;  // the most cells of a run
constexpr int RW_CPT = RW_CELLS / RW_THREADS;
static_assert(RW_CPT * RW_THREADS == RW_CELLS && RW_THREADS >= FUSED_BLOCK,
              "a run's cells over the threads; the disk tree needs FUSED_BLOCK threads");
#ifdef JRL_RW_IEEE
using RwDiv = IeeeDiv;
#else
using RwDiv = RcpDiv;
#endif
constexpr int RW_COLS = 8;  // a column's terms: rate and source by e_x + 1, r, 1 / r

// mbarriers (one a window row), then h (9 planes), phi and the flag codes,
// each plane wrows x W, then the column terms [RW_COLS][W], then the run's
// cells' frames [4][RW_CELLS] (u, v of frame b; u, v of frame b + 1)
__host__ __device__ constexpr int rw_bars_bytes(int wrows) { return (wrows * 8 + 15) / 16 * 16; }
__host__ __device__ constexpr int rw_smem_bytes(int wrows, int W) {
  return rw_bars_bytes(wrows) + ((wrows * 11 + RW_COLS) * W + 4 * RW_CELLS) * (int)sizeof(float);
}

__global__ void __launch_bounds__(RW_THREADS, 1) fused_approach_rw_kernel(
    const int* base, const float* frames, const float* area, const float* h_in, float* hP,
    float* CP, float* hQ, float* CQ, float* acc, int start, int n, RwParams pp) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[4][FUSED_BLOCK];
  const CApproachParams& p = pp.a;
  const int H = p.H, W = p.W, HW = H * W, tid = threadIdx.x;
  const int y0 = (int)blockIdx.x * H / pp.nruns, y1 = ((int)blockIdx.x + 1) * H / pp.nruns;
  const int nw = y1 - y0 + 2, ncell = (y1 - y0) * W;  // window rows y0 - 1 .. y1 (mod H)
  const int PL = pp.wrows * W, ybase = wrap1(y0 - 1, H);
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem);
  float* const hs = reinterpret_cast<float*>(smem + rw_bars_bytes(pp.wrows));
  float* const phis = hs + 9 * PL;
  int* const codes = reinterpret_cast<int*>(phis + PL);
  float* const cols = reinterpret_cast<float*>(codes + PL);
  float* const fr = cols + RW_COLS * W;
  // a launch whose plan the host got wrong stops (an error, not wrong cells)
  unsigned dyn;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
  if ((unsigned)rw_smem_bytes(pp.wrows, W) > dyn || nw > pp.wrows || ncell > RW_CELLS) __trap();
  cg::grid_group grid = cg::this_grid();
  const bool disk = blockIdx.x == 0 && tid < p.rint;
  const bool flat = p.flat != 0;

  if (tid == 0) {
    for (int j = 0; j < nw; ++j) mbar_init(smem_addr(bars + j));
    mbar_init_fence();
    fence_proxy_async();  // the initialised mbarriers visible to the copies
  }
  // the column terms, once a launch
  const CBalanceParams bp{H, W, p.w_rate, p.c_tau};
  for (int x = tid; x < W; x += RW_THREADS) {
    const BalanceRates k = balance_rates(x, bp);
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      cols[2 * e * W + x] = k.k[e].w_rate;
      cols[(2 * e + 1) * W + x] = k.k[e].src;
    }
    const float r = (float)x + 0.5f;
    cols[6 * W + x] = r;
    cols[7 * W + x] = __frcp_rn(r);
  }

  float s_in = 0.0f, s_cur = 0.0f;
  int b_held = -1;
  const float* h = h_in;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    float* const hd = (i & 1) ? hQ : hP;
    float* const Cd = (i & 1) ? CQ : CP;
    const int step = start + i;
    const uint32_t parity = (uint32_t)(i & 1);
    // the window's rows, a copy a plane row; the barrier orders the expected
    // bytes before every copy and the previous step's reads of the window
    // (and of the tables) before this step's writes
    if (tid == 0)
      for (int j = 0; j < nw; ++j) mbar_expect(smem_addr(bars + j), 36u * (uint32_t)W);
    __syncthreads();
    for (int c = tid; c < 9 * nw; c += RW_THREADS) {
      const int j = c / 9, q = c - j * 9;
      fence_proxy_async();         // the block's reads of the window before the copy
      fence_proxy_async_global();  // the rows other blocks wrote before grid.sync
      bulk_g2s(smem_addr(hs + q * PL + j * W), h + (size_t)q * HW + (size_t)((ybase + j) % H) * W,
               4u * (uint32_t)W, smem_addr(bars + j));
    }
    // the step's stored velocity and moving tip, while the rows land
    int b;
    const FrameVel fv = frame_vel(frames, pp.n_frames, 0, HW, step, p.v, b);
    if (b != b_held) {  // uniform over the grid: b depends on the step only
#pragma unroll
      for (int j = 0; j < RW_CPT; ++j) {  // a thread's own cells: no barrier
        const int c = tid + j * RW_THREADS;
        if (c < ncell) {
          const int gi = y0 * W + c;
          fr[c] = fv.f0[gi];
          fr[RW_CELLS + c] = fv.f0[HW + gi];
          fr[2 * RW_CELLS + c] = fv.f1[gi];
          fr[3 * RW_CELLS + c] = fv.f1[HW + gi];
        }
      }
      b_held = b;
    }
    const auto g0 = approach_geo(base, fv, step, p);
#ifndef JRL_RW_SDF
    fill_window_geo(g0, ybase, nw, codes, phis, tid, RW_THREADS, RwDiv::for_col(0.0f));
#endif
    __syncthreads();  // the tables, and the mbarriers' init, before any read or wait
#ifdef JRL_RW_SDF
    const auto g = div_geo<RwDiv>(g0);
#else
    const auto g = div_geo<RwDiv>(window_geo(g0, ybase, codes, phis));
#endif
    // the run's cells; a cell waits for the rows it reads: one a side, two
    // inward on rows 0 and H - 1 (an OUTFLOW cell there recomputes the
    // streaming of the cell one row in)
    int waited = -1;  // window rows 0 .. waited have landed
#pragma unroll
    for (int j = 0; j < RW_CPT; ++j) {
      const int c = tid + j * RW_THREADS;
      if (c >= ncell) break;
      const int lr = c / W, x = c - lr * W, ly = lr + 1, y = y0 + lr;
      const int need = min(nw - 1, ly + (y == 0 ? 2 : 1));
      for (; waited < need; ++waited) mbar_wait(smem_addr(bars + waited + 1), parity);
      const ClusterState a{hs, nullptr, nullptr, PL, W, ly, x};
#ifdef JRL_RW_NO_CELLS
      hd[y * W + x] = a.F(0, 0, 0) + fv.at(fr[c], fr[2 * RW_CELLS + c]) + (float)g.flag(y, x);
#else
      ApproachRates<RwDiv> kr;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        kr.k.k[e].w_rate = cols[2 * e * W + x];
        kr.k.k[e].src = cols[(2 * e + 1) * W + x];
      }
      kr.r = cols[6 * W + x];
      kr.dv = RwDiv::for_col(cols[7 * W + x]);
      approach_cell_at(a, g, p, y, x, fv.at(fr[c], fr[2 * RW_CELLS + c]),
                       fv.at(fr[RW_CELLS + c], fr[3 * RW_CELLS + c]), kr, hd, Cd, y * W + x, HW);
#endif
    }
    const int wi = g0.walks_int;
    grid.sync();
    if (disk) {
      float t_in, t_cur;
      disk_terms(Cd, H, W, wi, flat, tid, area[tid], t_in, t_cur,
                 RwDiv::for_col(cols[7 * W + tid]));
      s_in = s_in + t_in;
      s_cur = s_cur + t_cur;
    }
    h = hd;
  }
  if (blockIdx.x != 0 || n < 1) return;
  int b;
  const int last = start + n - 1;
  const auto g = approach_geo(base, frame_vel(frames, pp.n_frames, 0, HW, last, p.v, b), last, p);
  const int r_cur = disk_row(g.walks_int + 1, H);
  float s[4] = {s_in, s_cur, 0.0f, 0.0f};
  if (disk) {
    s[2] = g.cu(r_cur, tid) * area[tid];
    s[3] = g.cv(r_cur, tid) * area[tid];
  }
  block_sum4(red, s);
  if (tid == 0) {
    acc[0] = acc[0] + red[0][0];
    acc[1] = acc[1] + red[1][0];
    acc[2] = red[2][0];
    acc[3] = red[3][0];
  }
}

// The proof of exact_div.cuh's RcpDiv: for divisor k (blockIdx.y; k < 3 the
// constants CS2F, CS4F, sqrt(2) with RcpDiv's reciprocals, then r = (k - 3)
// + 0.5 with its reciprocal taken as the kernel takes it), every float32 bit
// pattern as numerator through RcpDiv against __fdiv_rn, bit for bit:
// out[2k] counts the patterns that differ, out[2k + 1] is 1 where the
// reciprocal RcpDiv uses is not __frcp_rn of the divisor; the first nfirst
// patterns found to differ (in no set order) go to first[k nfirst ..],
// their count to nrec[k].
__global__ void __launch_bounds__(256) exact_div_count_kernel(unsigned long long* out,
                                                              unsigned* first, unsigned* nrec,
                                                              int nfirst) {
  const int k = blockIdx.y;
  const float r = (float)(k - 3) + 0.5f;
  const RcpDiv dv{__frcp_rn(r)};
  const float d = k == 0 ? CS2F : k == 1 ? CS4F : k == 2 ? SQRT2F : r;
  const float y = k == 0 ? RCP_CS2F : k == 1 ? RCP_CS4F : k == 2 ? RCP_SQRT2F : dv.yr;
  if (blockIdx.x == 0 && threadIdx.x == 0)
    out[2 * k + 1] = __float_as_uint(y) != __float_as_uint(__frcp_rn(d)) ? 1ull : 0ull;
  unsigned long long bad = 0;
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long bits = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
       bits < (1ull << 32); bits += stride) {
    const float x = __uint_as_float((unsigned)bits);
    const float q = k == 0 ? dv.cs2(x) : k == 1 ? dv.cs4(x) : k == 2 ? dv.sqrt2(x) : dv.col(x, r);
    if (__float_as_uint(q) != __float_as_uint(__fdiv_rn(x, d))) {
      if (bad < 2) {
        const unsigned slot = atomicAdd(nrec + k, 1u);
        if ((int)slot < nfirst) first[k * nfirst + slot] = (unsigned)bits;
      }
      ++bad;
    }
  }
  for (int o = 16; o > 0; o >>= 1) bad += __shfl_down_sync(0xffffffffu, bad, o);
  if ((threadIdx.x & 31) == 0 && bad) atomicAdd(out + 2 * k, bad);
}

}  // namespace

// Registers per thread and local (spill) bytes of the kernel, its threads a
// block and the most cells of a run.
extern "C" int jrl_fused_approach_rw_info(int* regs, int* local_bytes, int* threads, int* cells) {
  *threads = RW_THREADS;
  *cells = RW_CELLS;
  return kernel_info(fused_approach_rw_kernel, regs, local_bytes);
}

// The launch shape, which the host plan mirrors (kernels/fused_jrl.py::
// rw_plan): the bytes a block of window rows `wrows` on a grid W wide
// takes, and the blocks of that size the card holds at once.
extern "C" int jrl_fused_approach_rw_shape(int wrows, int W, int* bytes, int* coresident) {
  *bytes = rw_smem_bytes(wrows, W);
  *coresident = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = (cudaError_t)smem_attr_once<fused_approach_rw_kernel>(*bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_approach_rw_kernel,
                                                      RW_THREADS, *bytes);
  *coresident = per_sm * sms;
  return (int)e;
}

// Approach steps start .. start + n - 1 of the whole grid in one launch. h:
// the state [9][H][W], rows 16-byte aligned (W % 4 == 0); the sets P and Q
// apart from it and from each other; frames [n_frames][2][H][W]; area
// [rint]; acc [4] (updated as fused_approach updates it). A cooperative grid
// of p->nruns blocks (refused, nothing launched, over the co-resident limit
// or for a plan whose runs are shorter than two rows, longer than RW_CELLS
// cells or over the window).
extern "C" int jrl_fused_approach_rw(const int* base, const float* frames, const float* area,
                                     const float* h, float* hP, float* CP, float* hQ, float* CQ,
                                     float* acc, int start, int n, const RwParams* p,
                                     void* stream) {
  const int H = p->a.H, W = p->a.W;
  const int longest = (H + p->nruns - 1) / p->nruns;
  if (n < 1 || W % 4 || p->nruns < 1 || H / p->nruns < 2 || longest * W > RW_CELLS ||
      p->wrows < longest + 2 || p->n_frames < 1 || p->a.rint > FUSED_BLOCK ||
      p->a.rint >= W)
    return (int)cudaErrorInvalidValue;
  int bytes = 0, most = 0;
  const int err = jrl_fused_approach_rw_shape(p->wrows, W, &bytes, &most);
  if (err != (int)cudaSuccess) return err;
  if (bytes > SH_SMEM_CAP) return (int)cudaErrorInvalidValue;
  if (p->nruns > most) return (int)cudaErrorCooperativeLaunchTooLarge;
  RwParams pp = *p;
  void* args[] = {&base, &frames, &area, &h, &hP, &CP, &hQ, &CQ, &acc, &start, &n, &pp};
  return (int)cudaLaunchCooperativeKernel((const void*)fused_approach_rw_kernel,
                                          dim3(p->nruns), dim3(RW_THREADS), args, bytes,
                                          (cudaStream_t)stream);
}

// The proof of RcpDiv over all 2^32 numerators, for CS2F, CS4F, sqrt(2) and
// r = x + 0.5 at each column x < ncols: out [2 (3 + ncols)] (zeroed here)
// and the first mismatches as exact_div_count_kernel writes them (first [(3
// + ncols) nfirst], nrec [3 + ncols], zeroed here). Queued on `stream`.
extern "C" int jrl_exact_div_count(int ncols, unsigned long long* out, unsigned* first,
                                   unsigned* nrec, int nfirst, void* stream) {
  const int nd = 3 + ncols;
  if (ncols < 0 || ncols > 65535 - 3 || nfirst < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(unsigned long long) * 2 * nd, s);
  if (e == cudaSuccess) e = cudaMemsetAsync(nrec, 0, sizeof(unsigned) * nd, s);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  exact_div_count_kernel<<<dim3(8 * sms, nd), 256, 0, s>>>(out, first, nrec, nfirst);
  return (int)cudaGetLastError();
}
