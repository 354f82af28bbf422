// JRL concentration approach, one step and its tip-disk integrals in one
// launch: the stored velocity interpolated between its two frames in the
// kernel, the moving tip (strict phi < 0 for the wedge, a rectangle for
// flat tips, INFLOW sink on the head row), streaming with sub-grid bounce,
// C = sum h (clamped to [0, 1] for flat tips), advection-diffusion BGK with
// the axisymmetric rate and source; then the last block to finish adds the
// step's four integrals into acc.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py::
// _make_c_approach_kernel together with the jnp frame lerp around it, as
// _c_one_approach_step calls them. Its plain twin is kernels/jrl_c.py::
// c_approach_pass_ref (models/jrl.py::stored_velocity, then c_approach_ref).
// The cell code is jrl_c.cuh's approach_cell_at, read through the window
// accessor and geometry below, and the integrals are c_disk_kernel's, so
// the launch equals c_approach.cu's pair (after PyTorch's lerp) bit for bit.
//
// Bound on the card: the bytes (h, the two frames and the base flags in,
// h and C out: 24 planes, 15.0 us at 1024x512 and 3.35 TB/s); the cell code
// is ~330 float32 operations. What held the pair back, and what this
// design does about it:
// - the tip SDF evaluated about ten times a cell (flag at the cell, again
//   in the streaming, at the eight neighbours of the obstacle mask, phi;
//   an IEEE division each for the wedge): flag and phi of every window cell
//   once a step into shared memory (jrl_c.cuh::WindowGeo), computed while
//   the window's rows are still in flight;
// - h read from device memory by up to nine threads a value: each block
//   stages the rows it reads in shared memory. Tiles of whole rows rather
//   than the row stream of pass_state.cuh: a run of R rows (8 at 1024x512,
//   one block of 1024 threads an SM, two rows at a time, one wave) with one
//   row a side is 1.25 reads a row, and
//   with an mbarrier a row and every copy issued at the start the cells of
//   a row start as soon as their three rows have landed; nothing in shared
//   memory is written after the fill, so no ring, refill or barrier a row
//   is needed. Whole rows (no column strips) keep the x wrap and the axis
//   mirror inside the window;
// - the frame lerp in PyTorch (14 planes, three launches a step): each
//   thread reads its cell's two frames and lerps as models/jrl.py::
//   stored_velocity does (jrl_c.cuh::frame_vel, shared with the multi-step
//   kernels); a caller may pass a window of frames (b0);
// - a second launch of one block for the integrals: every block counts
//   itself done (threadfence, atomic ticket, no atomics on the sums), and
//   the last one computes c_disk_kernel's terms from the new C in device
//   memory and sums them in the same fixed 128-slot tree, then resets the
//   ticket for the next launch.
#include "pass_state.cuh"

#include "jrl_c.cuh"

// Mirrors kernels/jrl_c.py::CPassParams.
struct CPassParams {
  CApproachParams a;
  int nruns;     // blocks: block b computes rows [b H / nruns, (b + 1) H / nruns)
  int wrows;     // window rows a block's planes hold: the longest run + 2
  int n_frames;  // frames of the whole history
  int b0;        // the history's frame that frames[0] is
};

namespace {

using namespace jrl;

// Threads a block, and blocks an SM the registers and the plan are made
// for: 1024 threads (32 warps an SM; 64 registers, 16 bytes of spills), one
// block an SM (a run of 8 rows at 1024x512). tools/approach_probe.py builds
// other shapes with -D: 512 threads took 59.3 us a launch, 1024 49.7 (PERF.md).
#ifndef JRL_CP_THREADS
#define JRL_CP_THREADS 1024
#endif
#ifndef JRL_CP_BLOCKS_PER_SM
#define JRL_CP_BLOCKS_PER_SM 1
#endif
constexpr int CP_THREADS = JRL_CP_THREADS;
constexpr int CP_BLOCKS_PER_SM = JRL_CP_BLOCKS_PER_SM;
constexpr int DISK_THREADS = 128;
static_assert(CP_THREADS >= DISK_THREADS, "the disk tree needs 128 threads");

// mbarriers (one a window row), then h (9 planes), phi and the flag codes,
// each plane wrows x W
__host__ __device__ constexpr int cp_bars_bytes(int wrows) { return (wrows * 8 + 15) / 16 * 16; }
__host__ __device__ constexpr int cp_smem_bytes(int wrows, int W) {
  return cp_bars_bytes(wrows) + wrows * W * 11 * (int)sizeof(float);
}

__global__ void __launch_bounds__(CP_THREADS, CP_BLOCKS_PER_SM) c_approach_pass_kernel(
    const int* __restrict__ base, const float* __restrict__ h, const float* __restrict__ frames,
    const float* __restrict__ area, float* h_out, float* C_out, float* acc, unsigned* ticket,
    int step, CPassParams pp) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[4][DISK_THREADS];
  __shared__ bool last;
  const CApproachParams& p = pp.a;
  const int H = p.H, W = p.W, HW = H * W, tid = threadIdx.x;
  const int y0 = (int)blockIdx.x * H / pp.nruns, y1 = ((int)blockIdx.x + 1) * H / pp.nruns;
  const int nw = y1 - y0 + 2;  // window rows y0 - 1 .. y1 (mod H)
  const int PL = pp.wrows * W, ybase = wrap1(y0 - 1, H);
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem);
  float* const hs = reinterpret_cast<float*>(smem + cp_bars_bytes(pp.wrows));
  float* const phis = hs + 9 * PL;
  int* const codes = reinterpret_cast<int*>(phis + PL);

  if (tid == 0) {
    for (int j = 0; j < nw; ++j) mbar_init(smem_addr(bars + j));
    mbar_init_fence();
    fence_proxy_async();  // the initialised mbarriers visible to the copies
    const uint32_t bytes = 4u * (uint32_t)W;
    for (int j = 0; j < nw; ++j) {
      const uint32_t bar = smem_addr(bars + j);
      const size_t g = (size_t)((ybase + j) % H) * W;
      mbar_expect(bar, 9u * bytes);
#pragma unroll
      for (int q = 0; q < 9; ++q)
        bulk_g2s(smem_addr(hs + q * PL + j * W), h + (size_t)q * HW + g, bytes, bar);
    }
  }

  // the step's geometry, once a window cell, while the rows land
  int bf;
  const FrameVel fv = frame_vel(frames, pp.n_frames, pp.b0, HW, step, p.v, bf);
  const auto g0 = approach_geo(base, fv, step, p);
  fill_window_geo(g0, ybase, nw, codes, phis, tid, CP_THREADS);
  __syncthreads();  // the geometry, and the mbarriers' init, before any wait
  const auto g = window_geo(g0, ybase, codes, phis);

  // the run's cells row by row; a row waits for the rows it reads: one a
  // side, two inward on rows 0 and H - 1 (an OUTFLOW cell there recomputes
  // the streaming of the cell one row in)
  int waited = -1;  // window rows 0 .. waited have landed
  for (int c = tid; c < (nw - 2) * W; c += CP_THREADS) {
    const int lr = c / W, x = c - lr * W, ly = lr + 1, y = y0 + lr;
    const int need = min(nw - 1, ly + (y == 0 ? 2 : 1));
    for (; waited < need; ++waited) mbar_wait(smem_addr(bars + waited + 1), 0);
    const int i = y * W + x;
#ifndef JRL_CP_NO_CELLS  // tools/approach_probe.py: the launch without its cells
    approach_cell_at(ClusterState{hs, nullptr, nullptr, PL, W, ly, x}, g, p, y, x, fv.u(i),
                     fv.v(i), h_out, C_out, i, HW);
#endif
  }
#ifdef JRL_CP_NO_DISK  // tools/approach_probe.py: the launch without its integrals
  return;
#endif

  // the integrals: the last block reads the new C of every block
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int r_cur = disk_row(g0.walks_int + 1, H);
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (tid < DISK_THREADS) {
    for (int x = tid; x < p.rint; x += DISK_THREADS) {
      const float ar = area[x];
      float t_in, t_cur;
      disk_terms(C_out, H, W, g0.walks_int, p.flat != 0, x, ar, t_in, t_cur);
      s[0] = s[0] + t_in;
      s[1] = s[1] + t_cur;
      s[2] = s[2] + g0.cu(r_cur, x) * ar;
      s[3] = s[3] + g0.cv(r_cur, x) * ar;
    }
  }
  block_sum4(red, s);
  if (tid == 0) {
    acc[0] = acc[0] + red[0][0];
    acc[1] = acc[1] + red[1][0];
    acc[2] = red[2][0];
    acc[3] = red[3][0];
    *ticket = 0u;
  }
}

}  // namespace

// The dynamic shared memory a block may use with CP_BLOCKS_PER_SM blocks
// on an SM (the card's opt-in a block, or its share of the SM less the 1 KB
// the card reserves a block, less the kernel's static shared memory), the
// threads a block and the blocks an SM.
extern "C" int jrl_c_approach_pass_limits(int* smem, int* threads, int* blocks_per_sm) {
  int dev = 0, optin = 0, per_sm = 0;
  cudaFuncAttributes a;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, (const void*)c_approach_pass_kernel);
  const int share = per_sm / CP_BLOCKS_PER_SM - 1024;
  *smem = e == cudaSuccess ? (optin < share ? optin : share) - (int)a.sharedSizeBytes : 0;
  *threads = CP_THREADS;
  *blocks_per_sm = CP_BLOCKS_PER_SM;
  return (int)e;
}

// Registers per thread and local (spill) bytes of the kernel.
extern "C" int jrl_c_approach_pass_info(int* regs, int* local_bytes) {
  return kernel_info(c_approach_pass_kernel, regs, local_bytes);
}

extern "C" int jrl_c_approach_pass(const int* base, const float* h, const float* frames,
                                   const float* area, float* h_out, float* C_out, float* acc,
                                   unsigned* ticket, int step, const CPassParams* p,
                                   void* stream) {
  const int H = p->a.H, W = p->a.W;
  if (W % 4 || p->nruns < 1 || p->nruns > H || p->wrows < (H + p->nruns - 1) / p->nruns + 2 ||
      (p->nruns > 1 && H / p->nruns < 2))
    return (int)cudaErrorInvalidValue;
  const int bytes = cp_smem_bytes(p->wrows, W);
  const int err = smem_attr_once<c_approach_pass_kernel>(bytes);
  if (err != (int)cudaSuccess) return err;
  c_approach_pass_kernel<<<p->nruns, CP_THREADS, bytes, (cudaStream_t)stream>>>(
      base, h, frames, area, h_out, C_out, acc, ticket, step, *p);
  return (int)cudaGetLastError();
}
