// Cylinder channel on one shard of a (ny, nx) mesh, one lean-split pass in
// one launch: k plain-channel steps with the first and last rows' rules of
// the global grid (class "lean", cyl_common.cuh::lean_cell<YB>) on the
// shard's rows outside the static band windows, and k full-boundary steps
// with the sub-grid bounce and the static-cylinder coupling (class "cyl",
// full_cell<true>, the velocity carried between sub-steps) on the band
// window rows [b0, b0 + nb), all from the same pre-step state and its halo
// pieces: at k = 2..4 (a template parameter) streamed row by row, at k = 1
// one thread a cell. f float32.
//
// Replaces, in one launch, what the TPU code jrl_lbm_tpu/ops/pallas/
// fused_sharded.py does with two calls a pass: _lean_tiled_step (body
// _lean_block_update) on every row, then _window_full_step with
// _apply_window_fix on the band rows. Until this kernel the port ran them
// as the cyl_lean_sh and cyl_window_sh launches (kept, and the yardstick).
// Plain twin: kernels/cyl_sharded.py::cyl_pass_sh_ref. The cell code is
// that of the two launches, with the same operations in the same order
// under --fmad=false, and every cell a block writes is computed from the
// values those launches read, so the launch equals them bit for bit.
//
// Bound on the card: the bytes (9 f planes in, 9 f, rho and 2 vel planes
// out a cell, and vel, flags, phi in on the band rows: ~26 us a k = 1 pass
// on a 512x2048 shard, ~105 at 2048^2); at k = 4 the cell code's issue, as
// for cyl_pass (~190 float32 operations a cell and sub-step). What held the
// two launches back, and what this design does:
// - the tile loader decoded every value (cyl_shard.cuh::ShardPlanesK::at:
//   two wraps, up to six compares, a choice of body, row piece or column
//   block): here the source is chosen once a ring row (body row, or a row
//   of the top or bottom piece), copied by cp.async.bulk, and only a strip
//   at the shard's left or right edge adds k lanes at its row's ends, from
//   the column blocks or, on a mesh of one column, from its own row's other
//   end, loaded by a few threads one phase ahead;
// - 2-D tiles re-read a k-cell halo through shared memory (64 x (16 + 2k)
//   cells for (64 - 2k) x 16 outputs, 18 floats a cell: two blocks an SM):
//   a block streams a run of rows of a strip of up to cp_cols(k) - 2k
//   columns, so the y halo is paid once a run, the x halo is k columns of a
//   wide strip, and the k sub-steps run on k warp groups at once
//   (cyl_pass_state.cuh's wavefront, two 512-thread blocks an SM);
// - two launches a pass, the band rows computed twice and the window's
//   short launch with its tail: one launch, items of both classes, the band
//   runs shorter by their rows' cost, about one wave.
//
// Windows. An item writes rows [y0, y1) x columns [x0, x1) of the shard;
// sub-step j runs on rows and columns k - j further out, each class with
// its own cell code on its halo rows too, as the tiles of the two launches
// do. Rows outside the shard come from the pieces (global rows mod H). The
// route checks the border at k > 1 (kernels/cylinder.py::check_border), so
// a window stops at the grid's first and last rows, as cyl_pass's do (at
// k = 1, where it checks none, the cells' reads wrap as cyl_lean_sh's): no cell a block writes then depends on a row across them.
// The only reads two rows away (the OUTFLOW copy of row H-1, an OUTFLOW
// cell of row 0) land on rows within one row of the window's end, the
// window holding row 0 walking up (cyl_pass_state.cuh), so the rings hold
// them. Columns never stop: a strip at the shard's edge reads k lanes past
// it, whose values exist.
//
// At k = 1 the pass runs one thread a cell from device memory (as
// cyl_interior.cu does): warps whose cells lie two rows and one column
// inside the shard read its body planes directly, the others through the
// pieces (cyl_shard.cuh::ShardCylAcc). A single step has no halo to share
// and no sub-steps to overlap, and on an H100 this ran a 512x2048 shard in
// about half the time of the row-streaming design at k = 1 (PERF.md), so
// the row-streaming kernel is built for k = 2..4 only. Both equal the two
// launches bit for bit.
#include "cyl_pass_state.cuh"
#include "cyl_shard.cuh"

// Mirrors kernels/cyl_sharded.py::PassShParams (outside the unnamed
// namespace: the C entry points take it, and must keep external linkage).
struct PassShParams {
  cyl::CylParams c;  // the step's constants (the launch's rows are the items')
  CylShardGeom s;    // the shard's place
  int rs[2];         // the host's cp_rs of each class (checked against the kernel's)
  int nitems;
};

namespace {

using namespace cyl;

constexpr int PS_LEAN = CP_LEAN, PS_CYL = CP_CYL;  // the item classes
constexpr int PS_AOFF = 16;  // a ring row's first column a0 (>= -k - 3) is packed + PS_AOFF

// An item, packed by kernels/cyl_sharded.py::pass_sh_plan as four int32:
// y0 | y1 << 16, x0 | x1 << 16, (a0 + PS_AOFF) | (a1 + PS_AOFF) << 16,
// cls | desc << 4 (shard-local rows and columns).
struct PsItem {
  int y0, y1, x0, x1, a0, a1, cls, desc;
  __device__ explicit PsItem(int4 v)
      : y0(v.x & 0xffff), y1((int)((unsigned)v.x >> 16)), x0(v.y & 0xffff),
        x1((int)((unsigned)v.y >> 16)), a0((v.z & 0xffff) - PS_AOFF),
        a1((int)((unsigned)v.z >> 16) - PS_AOFF), cls(v.w & 0xf), desc((v.w >> 4) & 1) {}
};

// Row r (shard-local, -k <= r < h + k) of plane q of a field: a body row, or
// a row of the top or bottom piece; on a mesh of one row of shards the body
// itself, mod h.
template <class T>
__device__ __forceinline__ const T* src_row(const ShardPlanesK<T>& F, const CylShardGeom& s,
                                            int q, int r) {
  if (s.h == s.H) return F.body + (q * s.h + jrl::wrap1(r, s.h)) * s.w;
  if (r < 0) return F.top + (q * s.k + r + s.k) * s.w;
  if (r >= s.h) return F.bot + (q * s.k + r - s.h) * s.w;
  return F.body + (q * s.h + r) * s.w;
}

// Column cl (< 0 or >= w) of row r of plane q: a lane of the left or right
// column block (rows -k .. h + k - 1, corners included), or on a mesh of
// one column the other end of the row.
template <class T>
__device__ __forceinline__ T edge_val(const ShardPlanesK<T>& F, const CylShardGeom& s, int q,
                                      int r, int cl) {
  if (s.xh == 0) return src_row(F, s, q, r)[cl < 0 ? cl + s.w : cl - s.w];
  const int br = (s.h == s.H ? jrl::wrap1(r, s.h) : r) + s.k, bh = s.h + 2 * s.k;
  return cl < 0 ? F.left[(q * bh + br) * s.xh + cl + s.xh]
                : F.right[(q * bh + br) * s.xh + cl - s.w];
}

// The pass of one item of class CLS at depth K. XW false: no cell of the
// window on the global columns 0, 1, W-2, W-1 (the wall rules and their
// tests left out, cyl_common.cuh::pull_x); YB false (lean): none on the
// global rows 0 and H-1 (the border rows' rules left out).
template <int CLS, bool XW, bool YB, int K>
__device__ __forceinline__ void ps_run(const CylShardSrc& src, float* f_out, float* rho_out,
                                       float* vel_out, const PassShParams& p, const PsItem& it,
                                       unsigned char* smem, uint64_t* bars) {
  constexpr bool VEL = CLS == PS_CYL;
  constexpr int NV = cp_vel(CLS), CW = cp_cols(K);
  constexpr int RS = cp_rs(CLS, K, 4);
  constexpr int NP = VEL ? 13 : 9;  // planes a ring row takes: f; vel, flags, phi
  const CylParams& c = p.c;
  const CylShardGeom& s = p.s;
  const int h = s.h, w = s.w, hw = h * w;
  float* const in_f = reinterpret_cast<float*>(smem);
  float* const in_v = in_f + CP_D * 9 * RS;
  int* const g_fl = reinterpret_cast<int*>(in_v + CP_D * NV * RS);
  float* const g_ph = reinterpret_cast<float*>(g_fl + (VEL ? CP_G * RS : 0));
  float* const lv = g_ph + (VEL ? CP_G * RS : 0);   // sub-steps' f: [K-1][CP_R][9][RS]
  float* const lvv = lv + (K - 1) * CP_R * 9 * RS;  // sub-steps' vel: [K-1][CP_R][2][RS]
  const int tid = threadIdx.x;

  // the window's rows: k a side, cut at the grid's first and last rows
  const int lo = s.row0 == 0 ? 0 : -K;
  const int hi = s.row0 + h == s.H ? h : h + K;
  const int wy0 = max(it.y0 - K, lo), wy1 = min(it.y1 + K, hi), n_in = wy1 - wy0;
  const int sd = it.desc ? -1 : 1, yfirst = it.desc ? wy1 - 1 : wy0;
  // the body (or piece) columns of a ring row, copied in bulk; the lanes
  // past the shard's edges ne of them, loaded by threads
  const int ca = max(it.a0, 0), cb = min(it.a1, w);
  const int nl = it.x0 == 0 ? K : 0, ne = nl + (it.x1 == w ? K : 0);

  if (tid == 0) {
    for (int i = 0; i < CP_D; ++i) jrl::mbar_init(jrl::smem_addr(bars + i));
    jrl::mbar_init_fence();
    jrl::fence_proxy_async();  // the mbarriers visible to the async proxy (cyl_pass_state.cuh)
  }
  __syncthreads();
  // thread 0: the bulk part of input row i into slot i % CP_D, its
  // geometry into i % CP_G
  auto issue = [&](int i) {
    const int sl = i % CP_D, gsl = i & (CP_G - 1), r = yfirst + sd * i;
    const uint32_t bar = jrl::smem_addr(bars + sl);
    const uint32_t fb = 4u * (uint32_t)(cb - ca);
    jrl::mbar_expect(bar, (uint32_t)(9 + (VEL ? 4 : 0)) * fb);
    const int off = ca - it.a0;
#pragma unroll
    for (int q = 0; q < 9; ++q)
      jrl::bulk_g2s(jrl::smem_addr(in_f + (sl * 9 + q) * RS + off), src_row(src.f, s, q, r) + ca,
                    fb, bar);
    if (VEL) {
      jrl::bulk_g2s(jrl::smem_addr(in_v + (sl * 2) * RS + off), src_row(src.vel, s, 0, r) + ca,
                    fb, bar);
      jrl::bulk_g2s(jrl::smem_addr(in_v + (sl * 2 + 1) * RS + off),
                    src_row(src.vel, s, 1, r) + ca, fb, bar);
      jrl::bulk_g2s(jrl::smem_addr(g_ph + gsl * RS + off), src_row(src.phi, s, 0, r) + ca, fb,
                    bar);
      jrl::bulk_g2s(jrl::smem_addr(g_fl + gsl * RS + off), src_row(src.flags, s, 0, r) + ca, fb,
                    bar);
    }
  };
  auto wait_row = [&](int i) {
    jrl::mbar_wait(jrl::smem_addr(bars + i % CP_D), (uint32_t)((i / CP_D) & 1));
  };
  // threads 0 .. NP ne - 1 of a strip at the shard's edge: one lane of one
  // plane of a ring row each, loaded one phase before it is stored
  const bool edge = tid < NP * ne;
  const int ep = edge ? tid / ne : 0, el = edge ? tid % ne : 0;
  const int ecl = el < nl ? el - K : w + el - nl;
  auto edge_load = [&](int i) -> float {
    const int r = yfirst + sd * i;
    if (ep < 9) return edge_val(src.f, s, ep, r, ecl);
    if (ep < 11) return edge_val(src.vel, s, ep - 9, r, ecl);
    if (ep == 11) return __int_as_float(edge_val(src.flags, s, 0, r, ecl));
    return edge_val(src.phi, s, 0, r, ecl);
  };
  auto edge_store = [&](int i, float v) {
    const int cc = ecl - it.a0;
    if (ep < 9) {
      in_f[((i % CP_D) * 9 + ep) * RS + cc] = v;
    } else if (ep < 11) {
      in_v[((i % CP_D) * 2 + ep - 9) * RS + cc] = v;
    } else if (ep == 11) {
      g_fl[(i & (CP_G - 1)) * RS + cc] = __float_as_int(v);
    } else {
      g_ph[(i & (CP_G - 1)) * RS + cc] = v;
    }
  };
  float epend = 0.0f;
  if (tid == 0)
    for (int i = 0; i < CP_P && i < n_in; ++i) issue(i);
  if (edge) {
    for (int i = 0; i < CP_P && i < n_in; ++i) edge_store(i, edge_load(i));
    if (CP_P < n_in) epend = edge_load(CP_P);
  }

  // the rows of sub-step jj as relative rows [rlo, rhi)
  auto rows_of = [&](int jj, int& rlo, int& rhi) {
    const int ylo = max(it.y0 - (K - jj), lo), yhi = min(it.y1 + (K - jj), hi);
    rlo = it.desc ? wy1 - yhi : ylo - wy0;
    rhi = it.desc ? wy1 - ylo : yhi - wy0;
  };
  int t_end = 0;
#pragma unroll
  for (int jj = 1; jj <= K; ++jj) {
    int rlo, rhi;
    rows_of(jj, rlo, rhi);
    t_end = max(t_end, rhi + CP_LAG * jj);
  }
  // this thread's sub-step and column (shard-local; the window never stops at a column)
  const int j = min(tid / CW + 1, K + 1);
  const int lx = it.x0 - K + tid - (j - 1) * CW, cc = lx - it.a0;
  const bool on = j <= K && lx >= it.x0 - (K - j) && lx < it.x1 + (K - j);
  const int gx = jrl::wrap1(s.col0 + lx, s.W);
  int ilo = 0, ihi = 0;
  if (on) rows_of(j, ilo, ihi);
  const float* const prev = lv + (j - 2) * CP_R * 9 * RS;
  const float* const prev_v = lvv + (j - 2) * CP_R * 2 * RS;
  float* const next = lv + (j - 1) * CP_R * 9 * RS;
  float* const next_v = lvv + (j - 1) * CP_R * 2 * RS;

#pragma unroll 1
  for (int t = 0; t < t_end; ++t) {
    // slot (t + CP_P) % CP_D: its row t + CP_P - CP_D was last read in phase t - 1
    if (t + CP_P < n_in) {
      if (tid == 0) {
        jrl::fence_proxy_async();
        issue(t + CP_P);
      }
      if (edge) {
        edge_store(t + CP_P, epend);
        if (t + CP_P + 1 < n_in) epend = edge_load(t + CP_P + 1);
      }
    }
    if (t >= 1 && t <= n_in) wait_row(t - 1);
    const int i = t - CP_LAG * j;
    if (on && i >= ilo && i < ihi) {
      const int ly = yfirst + sd * i, gsl = i & (CP_G - 1);
      const int gy = jrl::wrap1(s.row0 + ly, s.H);
      float fo[9], r, ux, uy;
      auto cell = [&](const auto& a) {
        if constexpr (CLS == PS_LEAN) {
          lean_cell<YB, XW>(a, c, gy, gx, fo, r, ux, uy);
        } else {
          full_cell<true, XW>(a, c, gy, gx, c.wall_density, a.vx(0, 0), a.vy(0, 0), fo, r, ux,
                              uy);
        }
      };
      const RingAcc<float, RS> a =
          j == 1 ? RingAcc<float, RS>{in_f + cc, in_v + cc, g_fl + cc, g_ph + cc, i % CP_D, CP_D,
                                      gsl, sd}
                 : RingAcc<float, RS>{prev + cc, prev_v + cc, g_fl + cc, g_ph + cc,
                                      i & (CP_R - 1), CP_R, gsl, sd};
      cell(a);
      if (j < K) {
        const int sl = i & (CP_R - 1);
        float* const dst = next + sl * 9 * RS + cc;
#pragma unroll
        for (int q = 0; q < 9; ++q) dst[q * RS] = fo[q];
        if (VEL) {
          next_v[sl * 2 * RS + cc] = ux;
          next_v[(sl * 2 + 1) * RS + cc] = uy;
        }
      } else {
        const int o = ly * w + lx;
#pragma unroll
        for (int q = 0; q < 9; ++q) f_out[q * hw + o] = fo[q];
        if (VEL && a.flag(0, 0) == OBSTACLE) r = src.rho.body[o];  // as shard_tile
        rho_out[o] = r;
        vel_out[o] = ux;
        vel_out[hw + o] = uy;
      }
    }
    __syncthreads();
  }
}

template <int K>
__global__ void __launch_bounds__(CP_THREADS, CP_MIN_BLOCKS) cyl_pass_sh_kernel(
    CylShardSrc src, float* __restrict__ f_out, float* __restrict__ rho_out,
    float* __restrict__ vel_out, const int4* __restrict__ items, PassShParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[CP_D];
  const PsItem it(items[blockIdx.x]);
  const CylShardGeom& s = p.s;
  // a block whose plan the host got wrong stops the launch (an error, not
  // wrong cells): its rings must fit the shared memory, its window the threads
  unsigned dyn;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
  if (it.cls > PS_CYL || p.rs[it.cls] != cp_rs(it.cls, K, 4) || it.a0 > it.x0 - K ||
      it.a1 < it.x1 + K || it.a1 - it.a0 > cp_rs(it.cls, K, 4) || it.y0 >= it.y1 ||
      it.y1 > s.h || it.x0 >= it.x1 || it.x1 > s.w || it.x1 - it.x0 + 2 * K > cp_cols(K) ||
      (unsigned)cp_smem_bytes(it.cls, K, cp_rs(it.cls, K, 4), 4) > dyn)
    __trap();
  // the wall rules where a computed cell lies on a global column 0, 1, W-2,
  // W-1; the border rows' rules where one lies on the global row 0 or H-1
  const int gc0 = s.col0 + it.x0 - K + 1, gc1 = s.col0 + it.x1 + K - 1;
  const bool xw = !(gc0 >= 2 && gc1 <= s.W - 2);
  const int gr0 = s.row0 + it.y0 - K + 1, gr1 = s.row0 + it.y1 + K - 1;
  const bool yb = !(gr0 >= 1 && gr1 <= s.H - 1);
#define CYL_PASS_SH_RUN(CLS, XW, YB) \
  ps_run<CLS, XW, YB, K>(src, f_out, rho_out, vel_out, p, it, smem, bars)
  if (it.cls == PS_LEAN) {
    if (xw) {
      if (yb) CYL_PASS_SH_RUN(PS_LEAN, true, true); else CYL_PASS_SH_RUN(PS_LEAN, true, false);
    } else {
      if (yb) CYL_PASS_SH_RUN(PS_LEAN, false, true); else CYL_PASS_SH_RUN(PS_LEAN, false, false);
    }
  } else {
    if (xw) CYL_PASS_SH_RUN(PS_CYL, true, true); else CYL_PASS_SH_RUN(PS_CYL, false, true);
  }
#undef CYL_PASS_SH_RUN
}

// The shard's body planes around local cell (ly, lx), read directly (no
// piece decoded): the cells' reads of a warp two rows and one column inside
// the shard, where ShardCylAcc gives the same values.
struct BodyAcc {
  const float* f;
  const float* vel;
  const int* fl;
  const float* phi;
  int h, w, ly, lx;
  __device__ __forceinline__ int idx(int dy, int dx) const { return (ly + dy) * w + lx + dx; }
  __device__ __forceinline__ float F(int q, int dy, int dx) const {
    return f[q * h * w + idx(dy, dx)];
  }
  __device__ __forceinline__ int flag(int dy, int dx) const { return fl[idx(dy, dx)]; }
  __device__ __forceinline__ float ph(int dy, int dx) const { return phi[idx(dy, dx)]; }
  __device__ __forceinline__ float vx(int dy, int dx) const { return vel[idx(dy, dx)]; }
  __device__ __forceinline__ float vy(int dy, int dx) const { return vel[h * w + idx(dy, dx)]; }
};

// k = 1, one thread a cell: the lean cell outside the band window rows
// [b0, b0 + nb), the full cell with the coupling on them.
__global__ void __launch_bounds__(256) cyl_pass_sh_cells_kernel(
    CylShardSrc src, float* __restrict__ f_out, float* __restrict__ rho_out,
    float* __restrict__ vel_out, CylParams c, CylShardGeom s, int b0, int nb) {
  const int lx = blockIdx.x * blockDim.x + threadIdx.x;
  const int ly = blockIdx.y * blockDim.y + threadIdx.y;
  if (lx >= s.w || ly >= s.h) return;
  const int hw = s.h * s.w, o = ly * s.w + lx;
  const int gy = s.row0 + ly, gx = s.col0 + lx;
  const int wx0 = lx & ~31;  // a warp's columns [wx0, wx0 + 32), on one row
  const bool inner = ly >= 2 && ly + 2 < s.h && wx0 >= 1 && wx0 + 33 <= s.w;
  const bool band = ly >= b0 && ly < b0 + nb;
  float fo[9], r, ux, uy;
  auto cell = [&](const auto& a) {
    if (band) {
      full_cell<true>(a, c, gy, gx, c.wall_density, a.vx(0, 0), a.vy(0, 0), fo, r, ux, uy);
    } else {
      lean_cell<true>(a, c, gy, gx, fo, r, ux, uy);
    }
  };
  if (inner) {
    cell(BodyAcc{src.f.body, src.vel.body, src.flags.body, src.phi.body, s.h, s.w, ly, lx});
  } else {
    cell(ShardCylAcc{src, s, gy, gx});
  }
#pragma unroll
  for (int q = 0; q < 9; ++q) f_out[q * hw + o] = fo[q];
  if (band && src.flags.body[o] == OBSTACLE) r = src.rho.body[o];
  rho_out[o] = r;
  vel_out[o] = ux;
  vel_out[hw + o] = uy;
}

// Calls fn(std::integral_constant<int, k>) for the run-time k in 2..4.
template <class Fn>
int with_pass_sh_k(int k, Fn fn) {
  switch (k) {
    case 2: return fn(std::integral_constant<int, 2>());
    case 3: return fn(std::integral_constant<int, 3>());
    case 4: return fn(std::integral_constant<int, 4>());
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Registers per thread and local (spill) bytes of the instance at depth k:
// row-streaming at k = 2..4, one thread a cell at k = 1.
extern "C" int cyl_pass_sh_info(int k, int* regs, int* local_bytes) {
  if (k == 1) return jrl::kernel_info(cyl_pass_sh_cells_kernel, regs, local_bytes);
  return with_pass_sh_k(k, [&](auto kc) {
    return jrl::kernel_info(cyl_pass_sh_kernel<decltype(kc)::value>, regs, local_bytes);
  });
}

// The launch's threads a block, window columns at depth k and blocks an SM
// (the host plan reads them back, so that a build with other -D values
// plans for them).
extern "C" int cyl_pass_sh_shape(int k, int* threads, int* cols, int* min_blocks) {
  if (k < 2 || k > 4) return (int)cudaErrorInvalidValue;
  *threads = CP_THREADS;
  *cols = cp_cols(k);
  *min_blocks = CP_MIN_BLOCKS;
  return (int)cudaSuccess;
}

// One pass over p->nitems items (int32 x 4 each on the card); smem_bytes:
// the largest cp_smem_bytes of the launch's items. src: the shard's f, vel,
// phi, rho, flags with their k-row pieces and column blocks (s.k >= k rows,
// s.xh >= k lanes where the mesh has them), rows 16-byte aligned.
extern "C" int cyl_pass_sh_launch(const CylShardSrc* src, float* f_out, float* rho_out,
                                  float* vel_out, const int* items, int k, int smem_bytes,
                                  const PassShParams* p, void* stream) {
  if (p->nitems < 1 || p->s.w % 8 || p->s.k < k || (p->s.xh && p->s.xh < k) || smem_bytes < 1 ||
      smem_bytes > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  return with_pass_sh_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    const int err = jrl::smem_attr_once<cyl_pass_sh_kernel<K>>(smem_bytes);
    if (err != (int)cudaSuccess) return err;
    cyl_pass_sh_kernel<K><<<p->nitems, CP_THREADS, smem_bytes, (cudaStream_t)stream>>>(
        *src, f_out, rho_out, vel_out, reinterpret_cast<const int4*>(items), *p);
    return (int)cudaGetLastError();
  });
}

// The k = 1 pass one thread a cell; the band window rows [b0, b0 + nb)
// (nb = 0: the shard misses the band).
extern "C" int cyl_pass_sh_cells_launch(const CylShardSrc* src, float* f_out, float* rho_out,
                                        float* vel_out, int b0, int nb, const CylParams* c,
                                        const CylShardGeom* s, void* stream) {
  if (b0 < 0 || nb < 0 || b0 + nb > s->h || s->k < 1) return (int)cudaErrorInvalidValue;
  const dim3 block(128, 2);
  const dim3 grid((s->w + block.x - 1) / block.x, (s->h + block.y - 1) / block.y);
  cyl_pass_sh_cells_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(*src, f_out, rho_out,
                                                                     vel_out, *c, *s, b0, nb);
  return (int)cudaGetLastError();
}
