// JRL fluid phase, n steps of the whole grid in one cooperative launch of
// shared-memory tiles: each step one wave of 2D tiles over the H x W grid
// (rows wrapping, as a mesh of one row), A then B in each tile, one grid
// barrier a step.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl.py::
// _make_jrl_fluid_kernel (called by _fused_fluid_run), as fused_fluid.cu
// does, which stays the yardstick (route="coop"); fused_jrl.py::fused_route
// takes this kernel where it measures faster (TILES_MIN_CELLS). Plain
// twin: kernels/fused_jrl.py::fused_fluid_tl_ref, the launch played tile by
// tile on the CPU, each tile from its own window. The cell code is
// jrl_fluid.cuh's, unchanged (with --fmad=false), through the tile form of
// fluid_pass_sh.cu (fluid_tile.cuh), so the launch equals fused_fluid bit
// for bit. Step i is start + i in integers, converted once
// (jrl_common.cuh::tip_walks): the jnp form.
//
// Bound on the card: the operations, ~650 float32 operations a cell and
// step (1.27 us a step at 512x256 at the float32 peak); the state (f, rho,
// vel, 12 planes, 6.3 MB at 512x256) stays in the 50 MB L2 between steps,
// and crosses device memory once a launch. What fused_fluid pays, and what
// the tiles do about it:
// - every neighbour read of the cell code is an L2 round trip: here a
//   tile's window (two rows and columns a side) lands in shared memory by
//   cp.async.bulk, one copy a plane row and thread, on one mbarrier, and
//   every read of the cell code is a shared-memory read;
// - the tip SDF at every geometry query (~50 an A cell, 9 a B cell, each
//   with an IEEE division for the wedges): here once a window cell and
//   step, into a table (fluid_tile.cuh::TileGeo, pass_state.cuh::geo_code);
// - two grid barriers a step (A after the previous B, B after A): A runs
//   on the tile's cells and one cell past them, so B needs no barrier after
//   A, and one grid.sync() a step orders the next step's window copies
//   after every block's writes (fence.proxy.async.global before each copy:
//   the copies read through the async proxy what other blocks wrote);
// - two cells a thread, one after the other: one 512-thread block an SM
//   runs its tile's ~(R + 2) (S + 2) A cells and R S B cells, ~2.3 chains a
//   thread at ~32x32 tiles on 512x256.
// What the tiles add: A on the tile's halo (~13% more A cells at 32x32)
// and the window's copies and table (PERF.md §6).
//
// One persistent cooperative grid of SH_THREADS-thread blocks, one an SM,
// no larger than the co-resident limit (refused before launch above it).
// Step i reads the buffer set step i - 1 wrote (the caller's state for i =
// 0) and writes set P for even i, Q for odd i (f [9][H][W], rho [H][W], vel
// [2][H][W] each), so the last step writes the set the caller named last
// (fused_jrl.py::_ping_pong). The plan is the host's, as fluid_pass_sh's
// for a mesh of one row at k = 1 (kernels/jrl_sharded.py::pass_sh_plan):
// nty[0] row bands x ntx column strips, block b taking tiles b, b + grid,
// ... of every step.
#include "fluid_tile.cuh"

namespace {

using namespace jrl;
namespace cg = cooperative_groups;

#ifdef JRL_FTL_TILE_NS
// Timing probe (tools/fused_cluster_probe.py tiles): each tile's start and
// end (%globaltimer, ns; the end after the block's barrier) in the launch's
// last step, tile b at [2 b], [2 b + 1].
constexpr int FTL_MAX_TILES = 1024;
__device__ unsigned long long ftl_tile_ns[2 * FTL_MAX_TILES];
__device__ __forceinline__ unsigned long long ftl_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

// A buffer set of the whole grid.
struct FtlSet {
  const float* f;    // [9][H][W]
  const float* rho;  // [H][W]
  const float* vel;  // [2][H][W]
};

__global__ void __launch_bounds__(SH_THREADS, 1) fused_fluid_tl_kernel(
    FtlSet in, float* fP, float* rP, float* vP, float* fQ, float* rQ, float* vQ, int start,
    int n, FluidParams pa, FluidBParams pb, ShTilePlan t) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t bar;
  fluid_tile_smem_check(t.rmax, t.smax);
  const int H = pa.H, W = pa.W, HW = H * W, ntiles = t.nty[0] * t.ntx;
  const uint32_t bar_a = fluid_tile_bar(&bar);
  uint32_t parity = 0;
  cg::grid_group grid = cg::this_grid();
  FtlSet src = in;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    float* const fd = (i & 1) ? fQ : fP;
    float* const rd = (i & 1) ? rQ : rP;
    float* const vd = (i & 1) ? vQ : vP;
    const FluidGeo fg = fluid_geo(start + i, pa);
#pragma unroll 1
    for (int b = blockIdx.x; b < ntiles; b += gridDim.x) {
      const ShTile tl(b, t.nty[0], t.ntx, H, W);
      const int ybase = wrap1(tl.e0 - 2, H);  // global row of window row 0
      const auto row_of = [&](int q, int r) {
        const int y = wrap1(ybase + r, H);
        if (q < 9) return src.f + (q * H + y) * W;
        if (q == 9) return src.rho + y * W;
        return src.vel + ((q - 10) * H + y) * W;
      };
      const auto store = [&](int bi, int x, const float* fo, float r, float u, float v) {
        const int o = (tl.e0 + bi) * W + x;
#pragma unroll
        for (int q = 0; q < 9; ++q) fd[q * HW + o] = fo[q];
        rd[o] = r;
        vd[o] = u;
        vd[HW + o] = v;
      };
#ifdef JRL_FTL_TILE_NS
      const unsigned long long t0 = ftl_now();
#endif
      fluid_tile<false>(tl, ybase, fg, pa, pb, t.rmax, t.smax, smem, bar_a, parity, row_of,
                        store);
#ifdef JRL_FTL_TILE_NS
      __syncthreads();
      if (i + 1 == n && threadIdx.x == 0 && b < FTL_MAX_TILES) {
        ftl_tile_ns[2 * b] = t0;
        ftl_tile_ns[2 * b + 1] = ftl_now();
      }
#endif
    }
    if (i + 1 < n) grid.sync();
    src = FtlSet{fd, rd, vd};
  }
}

}  // namespace

#ifdef JRL_FTL_TILE_NS
// The timing probe's table: 2 x `tiles` words (start, end) of tiles 0 ..
// tiles - 1 of the last launch's last step.
extern "C" int jrl_fused_fluid_tl_tile_ns(unsigned long long* out, int tiles) {
  if (tiles < 1 || tiles > FTL_MAX_TILES) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(out, ftl_tile_ns, 2 * sizeof(unsigned long long) * tiles);
}
#endif

// Registers per thread and local (spill) bytes of the kernel.
extern "C" int jrl_fused_fluid_tl_info(int* regs, int* local_bytes) {
  return kernel_info(fused_fluid_tl_kernel, regs, local_bytes);
}

// The launch shape, which the host plan mirrors (kernels/fused_jrl.py::
// tl_plan on jrl_sharded.py::pass_sh_plan): threads a block, the shared
// memory a block may take, the bytes a tile of rmax x smax B cells takes,
// and the blocks of that size the card holds at once.
extern "C" int jrl_fused_fluid_tl_tile_shape(int rmax, int smax, int* threads, int* smem_cap,
                                             int* bytes, int* coresident) {
  if (rmax < 1 || smax < 4 || smax % 4) return (int)cudaErrorInvalidValue;
  *threads = SH_THREADS;
  *smem_cap = SH_SMEM_CAP;
  *bytes = FptLayout(rmax, smax).bytes();
  return sh_coresident<fused_fluid_tl_kernel>(*bytes, coresident);
}

// Fluid steps start .. start + n - 1 of the whole grid in one launch. f,
// rho, vel: the state, rows 16-byte aligned (W % 4 == 0); the sets P and Q
// apart from it and from each other. A cooperative grid of t->grid blocks
// (refused, nothing launched, over the co-resident limit or for a plan
// whose tiles leave the grid's rows or the shared memory).
extern "C" int jrl_fused_fluid_tl(const float* f, const float* rho, const float* vel, float* fP,
                                  float* rP, float* vP, float* fQ, float* rQ, float* vQ,
                                  int start, int n, const FluidParams* pa, const FluidBParams* pb,
                                  const ShTilePlan* t, void* stream) {
  const ShardGeom whole{pa->H, pa->W, pa->H, pa->W, 0, 0, 0};
  if (n < 1 || sh_plan_check(whole, 1, *t, nullptr, nullptr)) return (int)cudaErrorInvalidValue;
  const int bytes = FptLayout(t->rmax, t->smax).bytes();
  if (bytes > SH_SMEM_CAP) return (int)cudaErrorInvalidValue;
  int most = 0;
  const int err = sh_coresident<fused_fluid_tl_kernel>(bytes, &most);
  if (err != (int)cudaSuccess) return err;
  if (t->grid < 1 || t->grid > most) return (int)cudaErrorCooperativeLaunchTooLarge;
  FtlSet in{f, rho, vel};
  FluidParams a = *pa;
  FluidBParams b = *pb;
  ShTilePlan p = *t;
  void* args[] = {&in, &fP, &rP, &vP, &fQ, &rQ, &vQ, &start, &n, &a, &b, &p};
  return (int)cudaLaunchCooperativeKernel((const void*)fused_fluid_tl_kernel, dim3(t->grid),
                                          dim3(SH_THREADS), args, bytes, (cudaStream_t)stream);
}
