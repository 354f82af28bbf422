// Row streaming of one k = 1 split pass of the JRL fluid phase (fluid_pass.cu):
// the launch's items, the shared-memory rings, the state accessors of the
// two steps and the geometry policy read from a per-step table.
//
// Items. The host (kernels/jrl_tiled.py::pass_items) cuts the pass's rows
// into runs, each inside one segment of one class (full or lean), and the
// columns into strips; block (strip, run) writes the run's rows of the
// strip. A block walks down its run in phases: phase a runs step A on row
// t = y0 - 1 + a and step B on row t - 2, which reads A's rho and vel on
// rows t - 3 .. t - 1 (computed in earlier phases); one __syncthreads()
// ends a phase. So a run of R rows computes A on rows y0 - 1 .. y1 (y1 ==
// H left out: B of the top wall row reads nothing around it) and reads
// input rows y0 - 2 .. y1 + 1, with a strip of S columns A on S + 2
// columns from S + 4 (the halo columns exist only between strips; every
// read of a grid cell stays in columns 0 .. W-1).
//
// Reach. A cell of A reads one row away, except an OUTFLOW cell of row 0,
// which recomputes the streaming of row 1 and so reads row 2; B reads A's
// rho and vel one cell away and A's f at its own cell only. So A on row t
// needs input rows t - 1 .. t + 2 in the ring (t + 2 only on row 0), and
// every read of a real cell lands where the whole-grid step reads.
//
// Rings, indexed by a row's place j = y - (y0 - 2) (mod H) in the run's
// window:
// - input: PASS_D = 5 slots of 12 planes (f, rho, u, v; a lean run loads
//   the 9 f planes), each row filled by cp.async.bulk copies issued by one
//   thread, one per plane, counted on the slot's mbarrier. Phase a reads
//   rows a .. a + 3 and copies row a + 4 into the slot of row a - 1.
// - A's rho, u, v: PASS_RV = 4 slots (B reads three rows while A writes a
//   fourth); A's f: PASS_FA = 3 slots, each cell's read back by the thread
//   that wrote it (three rows of nine values would not fit the registers).
// - geometry (full runs): flag, tip bit and phi of every window cell, once
//   a row and step (RingGeo), in PASS_G = 8 slots: phase a reads rows
//   a - 2 .. a + 3 and fills row a + 4.
#pragma once

#include "cluster_state.cuh"
#include "jrl_tile.cuh"

constexpr int PASS_MAX_RUNS = 512;

// Mirrors kernels/jrl_tiled.py::PassParams.
struct PassParams {
  FluidParams a;
  FluidBParams b;
  int nstrips;  // column strips: strip s is [s W / nstrips, (s + 1) W / nstrips)
  int rs;       // floats of a ring row (the widest strip window, a multiple of 4)
  int nruns;
  int run[PASS_MAX_RUNS];  // y0 | y1 << 15 | class << 30 (TILE_FULL, TILE_LEAN)
};

namespace jrl {

constexpr int PASS_THREADS = 512;  // one A column a thread
constexpr int PASS_D = 5;          // input ring slots
constexpr int PASS_G = 8;          // geometry ring slots (a power of 2)
constexpr int PASS_RV = 4;         // slots of A's rho, u, v (a power of 2)
constexpr int PASS_FA = 3;         // slots of A's f
constexpr int PASS_NP = 12;        // planes of an input slot: f 0-8, rho 9, u 10, v 11
constexpr int PASS_MAX_RS = PASS_THREADS + 8;

__host__ __device__ constexpr int pass_smem_bytes(int rs) {
  return (PASS_D * PASS_NP + PASS_RV * 3 + PASS_FA * 9 + PASS_G) * rs * (int)sizeof(float) +
         PASS_G * rs;
}

// The columns of a strip: B on [sx0, sx1), A on [ax0, ax1), the window
// (ring row) [cx0, cx1) with 16-byte aligned ends (W % 4 == 0).
struct PassStrip {
  int sx0, sx1, ax0, ax1, cx0, cx1;
  __device__ PassStrip(int s, int ns, int W) {
    sx0 = s * W / ns;
    sx1 = (s + 1) * W / ns;
    ax0 = max(sx0 - 1, 0);
    ax1 = min(sx1 + 1, W);
    cx0 = max(sx0 - 2, 0) & ~3;
    cx1 = min((sx1 + 2 + 3) & ~3, W);
  }
};

// cp.async.bulk of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global `src` to shared `dst`, counted on mbarrier `bar`.
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :
      : "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// orders this thread's earlier shared-memory accesses (after a barrier: the
// block's) before its later async-proxy copies into the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// s in [0, n) for s in [-n, 2n): a ring slot some rows from a known one
__device__ __forceinline__ int ring_slot(int s, int n) {
  return s < 0 ? s + n : (s >= n ? s - n : s);
}

// Step A's view of the input ring around a cell: slot js (the cell's row),
// column c of the ring row; planes f 0-8, rho 9, u 10, v 11. Reads stay
// within two rows (slots js - 2 .. js + 2).
struct PassIn {
  const float* ring;
  int rs, js, c;
  __device__ __forceinline__ int idx(int q, int dy, int dx) const {
    return (ring_slot(js + dy, PASS_D) * PASS_NP + q) * rs + c + dx;
  }
  __device__ __forceinline__ float F(int q, int dy, int dx) const { return ring[idx(q, dy, dx)]; }
  __device__ __forceinline__ float R(int dy, int dx) const { return ring[idx(9, dy, dx)]; }
  __device__ __forceinline__ float U(int dy, int dx) const { return ring[idx(10, dy, dx)]; }
  __device__ __forceinline__ float V(int dy, int dx) const { return ring[idx(11, dy, dx)]; }
  __device__ __forceinline__ PassIn at(int dy, int dx) const {
    return PassIn{ring, rs, ring_slot(js + dy, PASS_D), c + dx};
  }
};

// Step B's view: A's post-moment f of the cell (fluid_b_cell reads f at
// its own cell only; the thread that ran A on it wrote it, 9 planes from
// `fa`), A's rho, u, v from their ring (slot ks the cell's row; planes rho
// 0, u 1, v 2).
struct PassB {
  const float* rv;
  const float* fa;
  int rs, ks, c;
  __device__ __forceinline__ int idx(int p, int dy, int dx) const {
    return (((ks + dy) & (PASS_RV - 1)) * 3 + p) * rs + c + dx;
  }
  __device__ __forceinline__ float F(int q, int, int) const { return fa[q * rs + c]; }
  __device__ __forceinline__ float R(int dy, int dx) const { return rv[idx(0, dy, dx)]; }
  __device__ __forceinline__ float U(int dy, int dx) const { return rv[idx(1, dy, dx)]; }
  __device__ __forceinline__ float V(int dy, int dx) const { return rv[idx(2, dy, dx)]; }
};

// The moving tip at one step, read from the geometry ring (the flag with
// the tip bit 0x80, and phi, of each window cell, computed once a row by
// geo_row from FluidGeo's own functions): the same values FluidGeo
// computes on every call.
struct RingGeo {
  int H, W, ybase, rs, cx0;
  bool flat;
  float vel_obs;
  const float* phis;
  const unsigned char* codes;
  __device__ __forceinline__ int at(int y, int x) const {
    int j = y - ybase;
    j += j < 0 ? H : 0;
    return (j & (PASS_G - 1)) * rs + x - cx0;
  }
  __device__ __forceinline__ int flag(int y, int x) const { return codes[at(y, x)] & 0x7f; }
  __device__ __forceinline__ bool tip(int y, int x) const { return codes[at(y, x)] >> 7; }
  __device__ __forceinline__ float phi(int y, int x) const { return phis[at(y, x)]; }
  __device__ __forceinline__ float obs_v(int y, int x) const {
    return (tip(y, x) && (flat || y != H - 1)) ? vel_obs : 0.0f;
  }
  __device__ __forceinline__ float u(int y, int x, float raw) const {
    return tip(y, x) ? 0.0f : raw;
  }
  __device__ __forceinline__ float v(int y, int x, float raw) const {
    return tip(y, x) ? obs_v(y, x) : raw;
  }
  __device__ void inflow(int, int, int, float*) const {}
};

// FluidGeo's phi and flag of cell (y, x) with the tip bit, as RingGeo reads them.
__device__ __forceinline__ unsigned char geo_code(const FluidGeo& g, int y, int x, float& phi) {
  phi = g.phi(y, x);
  const bool tip = g.flat ? (y < g.walks_int && x < g.rg) : (phi <= 0.0f);
  return (unsigned char)((tip ? OBSTACLE : g.base(y, x)) | (tip ? 0x80 : 0));
}

}  // namespace jrl
