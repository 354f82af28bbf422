// k fused JRL fluid steps per launch on shared-memory tiles (temporal
// blocking), shared by the three tile-class kernels: fluid_k.cu (full
// class, the moving tip), fluid_k_lean.cu (interior tiles) and
// fluid_k_bt.cu (flat-tip tiles under the tip row).
//
// A step widens the dependency by two cells: step A (streaming, coupling,
// moments) reads one cell away, step B (the axisymmetric collision) reads
// A's rho and vel one cell further. So a block loads its tile of
// TILE_TY x tile_tx(k) cells with a halo of 2k cells on all four sides
// (rows and columns wrap mod H and W, so a halo past the grid's edge holds
// the cells the FLUID wrap reaches) and runs the level pyramid of the JAX
// package's _make_fluid_k_kernel: sub-step j computes A on the window less
// 2j + 1 cells a side and B on the window less 2j + 2, so the last B gives
// the tile itself exactly. Step j is start + j in integers, converted once
// (jrl_common.cuh::tip_walks), as the jnp step forms it.
//
// Buffers (23 planes of the window): two sets of f and vel, which A
// ping-pongs (it reads both of its neighbours'), one rho, which A updates
// in place (it reads only its own cell's, at OBSTACLE cells); B collides f
// in place in the set A wrote. A __syncthreads() separates every pass.
//
// Exactness: every cell reads within one cell, except an OUTFLOW cell,
// which recomputes its inward neighbour's streaming and reads two cells
// away; where that neighbour is on the window's edge, the source is held
// one cell inside the window (TileState::at), so no read leaves it. In the
// JRL geometry that only happens where nothing that reaches the tile reads
// the result: the halo columns past x = 0 and x = W-1 (the axis column
// collapses onto itself and column W-1 is never FLUID, so no real cell
// reads across the x edges), and the row-0 OUTFLOW cells on the last row
// of a window that wraps past H, which only the top wall row reads, and an
// OBSTACLE cell's step B reads nothing around it.
#pragma once

#include <type_traits>

#include "jrl_fluid.cuh"

constexpr int TILE_MAX_SEGS = 3;
constexpr int JRL_MAX_DEVICES = 16;  // devices whose kernel attributes are cached

// Mirrors kernels/jrl_tiled.py::TileParams.
struct TileParams {
  FluidParams a;
  FluidBParams b;
  int nseg;
  int seg[2 * TILE_MAX_SEGS];  // row segments [y0, y1) the launch writes
};

namespace jrl {

constexpr int TILE_EX = 64;  // window width with the halo (cells): two warps
constexpr int TILE_TY = 8;   // output rows of a block
constexpr int TILE_THREADS_X = 32, TILE_THREADS_Y = 8;
constexpr int TILE_THREADS = TILE_THREADS_X * TILE_THREADS_Y;
constexpr int TILE_KMAX = 4;
enum TileClass { TILE_FULL = 0, TILE_LEAN = 1, TILE_BT = 2 };

__host__ __device__ constexpr int tile_ey(int k) { return TILE_TY + 4 * k; }
// output columns of a block at depth k
__host__ __device__ constexpr int tile_tx(int k) { return TILE_EX - 4 * k; }
__host__ __device__ constexpr int tile_smem_bytes(int k) {
  return 23 * TILE_EX * tile_ey(k) * (int)sizeof(float);
}

// The previous sub-step read from the window ([Q][EY][TILE_EX] planes)
// around local cell (ly, lx), which lies at least one cell inside it.
template <int EY>
struct TileState {
  static constexpr int EXT = TILE_EX * EY;
  const float* f;
  const float* r;
  const float* v;
  int ly, lx;
  __device__ __forceinline__ int idx(int dy, int dx) const {
    return (ly + dy) * TILE_EX + lx + dx;
  }
  __device__ __forceinline__ float F(int q, int dy, int dx) const {
    return f[q * EXT + idx(dy, dx)];
  }
  __device__ __forceinline__ float R(int dy, int dx) const { return r[idx(dy, dx)]; }
  __device__ __forceinline__ float U(int dy, int dx) const { return v[idx(dy, dx)]; }
  __device__ __forceinline__ float V(int dy, int dx) const { return v[EXT + idx(dy, dx)]; }
  // the accessor of the cell at offset (dy, dx), held one cell inside the
  // window (only an OUTFLOW cell's source moves it; see the top)
  __device__ __forceinline__ TileState at(int dy, int dx) const {
    return TileState{f, r, v, min(max(ly + dy, 1), EY - 2), min(max(lx + dx, 1), TILE_EX - 2)};
  }
};

// The geometry policy of a class at step `step`.
template <int CLS>
__device__ __forceinline__ auto tile_geo(int step, const TileParams& p) {
  if constexpr (CLS == TILE_FULL) {
    return fluid_geo(step, p.a);
  } else if constexpr (CLS == TILE_LEAN) {
    return LeanGeo{p.a.H, p.a.W};
  } else {
    return BtGeo{p.a.H, p.a.W, p.a.rg, p.a.vel_obs, p.a.bcx, p.a.box_r};
  }
}

// k steps of the block's tile; the lean class reads only f (rho and vel
// are null), the below-tip class no step index.
template <int CLS, int K>
__device__ __forceinline__ void tile_steps(const float* __restrict__ f,
                                           const float* __restrict__ rho,
                                           const float* __restrict__ vel,
                                           float* __restrict__ f_out,
                                           float* __restrict__ rho_out,
                                           float* __restrict__ vel_out, int step0,
                                           const TileParams& p) {
  extern __shared__ float smem[];
  constexpr int EY = tile_ey(K), EXT = TILE_EX * EY, HALO = 2 * K;
  const int H = p.a.H, W = p.a.W, HW = H * W;
  // buffer sets as offsets from smem (a pointer array indexed at run time
  // would lose the shared address space)
  auto fb = [&](int b) { return smem + b * 9 * EXT; };
  auto vb = [&](int b) { return smem + (18 + 2 * b) * EXT; };
  float* rb = smem + 22 * EXT;

  int ty0, yend;
  if (!seg_tile_origin(p.nseg, p.seg, blockIdx.y, TILE_TY, ty0, yend)) return;
  const int oy = ty0 - HALO, ox = blockIdx.x * tile_tx(K) - HALO;
  const int tid = threadIdx.y * TILE_THREADS_X + threadIdx.x;

  // every pass walks its region's cells in one linear order over all the
  // block's threads (a region of 10 rows on 8 thread rows would leave six
  // warps idle for a second sweep); the window is a whole number of sweeps,
  // unrolled so that all of a thread's loads are in flight at once
  static_assert(EXT % TILE_THREADS == 0, "the window is 2 + k sweeps of the block");
#pragma unroll
  for (int n = 0; n < EXT / TILE_THREADS; ++n) {
    const int i = tid + n * TILE_THREADS;
    const int ly = i / TILE_EX, lx = i % TILE_EX;
    const int g = wrap_near(oy + ly, H) * W + wrap_near(ox + lx, W);
#pragma unroll
    for (int q = 0; q < 9; ++q) smem[q * EXT + i] = f[q * HW + g];
    if (CLS != TILE_LEAN) {
      vb(0)[i] = vel[g];
      vb(0)[EXT + i] = vel[HW + g];
      rb[i] = rho[g];
    }
  }
  __syncthreads();

#ifdef JRL_TILE_NO_CELLS
  // tools/tile_pass_probe.py: the window's load and the tile's store, no
  // cell code (the loaded values go out unchanged)
  for (int c = tid; c < tile_tx(K) * TILE_TY; c += TILE_THREADS) {
    const int ly = HALO + c / tile_tx(K), lx = HALO + c % tile_tx(K), i = ly * TILE_EX + lx;
    const int yy = oy + ly, xx = ox + lx;
    if (yy < yend && xx < W) {
      const int o = yy * W + xx;
#pragma unroll
      for (int q = 0; q < 9; ++q) f_out[q * HW + o] = smem[q * EXT + i];
      rho_out[o] = CLS != TILE_LEAN ? rb[i] : 0.0f;
      vel_out[o] = CLS != TILE_LEAN ? vb(0)[i] : 0.0f;
      vel_out[HW + o] = CLS != TILE_LEAN ? vb(0)[EXT + i] : 0.0f;
    }
  }
  return;
#endif

#pragma unroll 1
  for (int j = 0; j < K; ++j) {
    const int cur = j & 1;
    const auto g = tile_geo<CLS>(step0 + j, p);
    // step A on the window less 2j + 1 cells a side: set cur -> cur ^ 1
    const int ha = 2 * j + 1, wa = TILE_EX - 2 * ha;
    for (int c = tid; c < wa * (EY - 2 * ha); c += TILE_THREADS) {
      const int ly = ha + c / wa, lx = ha + c % wa, i = ly * TILE_EX + lx;
      const int gy = wrap_near(oy + ly, H), gx = wrap_near(ox + lx, W);
      float fo[9], r, u, v;
      fluid_a_cell(TileState<EY>{fb(cur), rb, vb(cur), ly, lx}, g, p.a.cs2tau, gy, gx, fo, r, u,
                   v);
      float* fd = fb(cur ^ 1);
#pragma unroll
      for (int q = 0; q < 9; ++q) fd[q * EXT + i] = fo[q];
      rb[i] = r;
      vb(cur ^ 1)[i] = u;
      vb(cur ^ 1)[EXT + i] = v;
    }
    __syncthreads();
    // step B on the window less 2j + 2 cells a side, in place; the last
    // sub-step's region is the tile, which goes to the outputs
    const int hb = 2 * j + 2, wb = TILE_EX - 2 * hb;
    const bool last = j == K - 1;
    for (int c = tid; c < wb * (EY - 2 * hb); c += TILE_THREADS) {
      const int ly = hb + c / wb, lx = hb + c % wb, i = ly * TILE_EX + lx;
      const int gy = wrap_near(oy + ly, H), gx = wrap_near(ox + lx, W);
      float fo[9];
      float* fd = fb(cur ^ 1);
      fluid_b_cell(TileState<EY>{fd, rb, vb(cur ^ 1), ly, lx}, g, p.b, gy, gx, fo);
      if (!last) {
#pragma unroll
        for (int q = 0; q < 9; ++q) fd[q * EXT + i] = fo[q];
      } else {
        const int yy = oy + ly, xx = ox + lx;
        if (yy < yend && xx < W) {
          const int o = yy * W + xx;
#pragma unroll
          for (int q = 0; q < 9; ++q) f_out[q * HW + o] = fo[q];
          rho_out[o] = rb[i];
          vel_out[o] = vb(cur ^ 1)[i];
          vel_out[HW + o] = vb(cur ^ 1)[EXT + i];
        }
      }
    }
    __syncthreads();
  }
}

// Lets `Kernel` use `bytes` of dynamic shared memory on the current device:
// one cudaFuncSetAttribute per kernel instance and device, not one per
// launch (the attribute persists; a larger request raises it again).
template <auto Kernel>
inline int smem_attr_once(int bytes) {
  static int set[JRL_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const bool cached = dev >= 0 && dev < JRL_MAX_DEVICES;
  if (cached && set[dev] >= bytes) return (int)cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && cached) set[dev] = bytes;
  return (int)err;
}

// Launches `Kernel` (a tile_steps kernel at depth K) over the launch's
// segments; returns the cudaError_t.
template <int K, auto Kernel, class... Args>
int launch_tiles(const TileParams& p, void* stream, Args... args) {
  int bytes = tile_smem_bytes(K);
#ifdef JRL_TILE_ONE_BLOCK_PER_SM
  // tools/tile_pass_probe.py: over half an SM's shared memory, so one block an SM
  bytes = bytes > 116 * 1024 ? bytes : 116 * 1024;
#endif
  const int err = smem_attr_once<Kernel>(bytes);
  if (err != (int)cudaSuccess) return err;
  const dim3 grid((p.a.W + tile_tx(K) - 1) / tile_tx(K), seg_tiles(p.nseg, p.seg, TILE_TY));
  const dim3 block(TILE_THREADS_X, TILE_THREADS_Y);
  Kernel<<<grid, block, bytes, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// Calls fn(std::integral_constant<int, k>) for the run-time k in 1..TILE_KMAX.
template <class Fn>
int with_tile_k(int k, Fn fn) {
  switch (k) {
    case 1: return fn(std::integral_constant<int, 1>());
    case 2: return fn(std::integral_constant<int, 2>());
    case 3: return fn(std::integral_constant<int, 3>());
    case 4: return fn(std::integral_constant<int, 4>());
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace jrl
