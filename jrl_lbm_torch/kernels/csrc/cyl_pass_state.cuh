// Row streaming of one k-step pass of the cylinder channel (cyl_pass.cu):
// the launch's items, the shared-memory rings, the wavefront over the k
// sub-steps and the ring accessor the cell code reads through.
//
// Items. The host (kernels/cylinder.py::cyl_pass_items) cuts each class's
// row segments into runs and the columns into strips (multiples of 8
// columns). The classes are those of the three launches the pass
// replaces: "interior" (the plain channel, cyl_common.cuh::lean_cell),
// "cyl" (the full step with the sub-grid bounce and the static-cylinder
// coupling, the velocity carried between sub-steps) and "edge" (the full
// step without them: the INFLOW and OUTFLOW rows). Block i writes the rows
// [y0, y1) x columns [x0, x1) of item i with its class's cell code.
//
// Windows. Sub-step j (1..k) of a block runs on rows [y0 - (k - j),
// y1 + (k - j)) and columns [x0 - (k - j), x1 + (k - j)), each cut to the
// grid: sub-step k on the item's own cells, each earlier sub-step one cell
// wider on every side, as far as the next one reads. The window is cut,
// not wrapped, at the grid's border: on a border that kernels/cylinder.py::
// check_border accepts (OBSTACLE side columns, no FLUID cell on the first
// and last rows) a border cell reflects or clamps its pulls inward, and an
// OUTFLOW cell of the first or last row reads two rows inward, so no cell
// reads past the border (a run that holds a border row has at least two
// rows, so those two rows are computed). Every value a sub-step reads was
// computed by the one before it: no clamped or stale value enters. The
// halo rows of a run are computed with the run's own class code, as the
// tiles of cyl_interior_k and cyl_band_k compute theirs, so the launch
// equals those kernels bit for bit by construction.
//
// Wavefront. A block walks its window row by row; its relative row i is
// global row yfirst + s i (s = +1 walks down, -1 up: a window that holds
// row 0 walks up, so that a border row, whose OUTFLOW cells read two rows
// inward, is the last one of its window in either direction). Phase t
// runs sub-step j on relative row t - 2 j for every j at once, one barrier
// a phase: sub-step j reads rows i - 1 .. i + 1 of sub-step j - 1 (i - 2
// .. i on a border row), all computed in earlier phases. The block's
// CP_THREADS threads are k groups of cp_cols(k) (a multiple of 32); thread
// (j, c) runs sub-step j on window column c, one cell a phase, so the k
// cells of a column's wavefront run on k warps at once.
//
// Rings (one slot a row: its relative index modulo the ring's slots; every
// ring row holds the item's columns [a0, a1), x0 - k and x1 + k rounded out
// to 16 bytes and cut to the grid):
// - input: CP_D slots of the 9 f planes in the storage type, and for "cyl"
//   the 2 vel planes, filled by cp.async.bulk copies that one thread
//   issues CP_P rows ahead, counted on the slot's mbarrier; phase t waits
//   for row t - 1 (the last one sub-step 1 reads) and copies row t + CP_P
//   into the slot of row t + CP_P - CP_D, which no one reads any more;
// - geometry ("cyl": flag and phi; "edge": flag): CP_G slots, copied with
//   the row's input (sub-step k reads rows down to t - 2 k - 2);
// - sub-steps 1 .. k-1: CP_R slots each of the 9 float32 f planes and, for
//   "cyl", a ring of the sub-step's velocity (the next sub-step's coupling
//   stencils read it, as cyl_common.cuh::tile_run carries it); sub-step j
//   writes row i + 2 while sub-step j + 1 reads i - 1 .. i + 1.
// Every ring row of a class takes cp_rs(class, k, storage) elements, a
// compile-time constant (the widest strip's), so that the cell code's ring
// offsets are immediates.
// A slot read two rows back (a border row's OUTFLOW reach) is the slot the
// phase writes only if a row past the border existed.
#pragma once

#include <cstdint>
#include <type_traits>

#include "cyl_common.cuh"
#include "pass_state.cuh"

#ifndef CYL_PASS_THREADS
#define CYL_PASS_THREADS 512
#endif
#ifndef CYL_PASS_MIN_BLOCKS
#define CYL_PASS_MIN_BLOCKS 2
#endif

namespace cyl {

constexpr int CP_THREADS = CYL_PASS_THREADS;        // threads a block
constexpr int CP_MIN_BLOCKS = CYL_PASS_MIN_BLOCKS;  // blocks an SM the registers allow
constexpr int CP_D = 6;   // input ring slots
constexpr int CP_P = 2;   // rows the input copies run ahead
constexpr int CP_R = 4;   // slots of a sub-step's ring (a power of 2)
constexpr int CP_G = 16;  // geometry ring slots (a power of 2)
constexpr int CP_LAG = 2; // rows between two consecutive sub-steps in a phase

enum PassClass { CP_LEAN = 0, CP_CYL = 1, CP_EDGE = 2 };

// Window columns a block takes at depth k: one group of threads each.
__host__ __device__ constexpr int cp_cols(int k) { return (CP_THREADS / k) & ~31; }
__host__ __device__ constexpr int cp_vel(int cls) { return cls == CP_CYL ? 2 : 0; }
__host__ __device__ constexpr int cp_geo(int cls) {
  return cls == CP_LEAN ? 0 : (cls == CP_CYL ? 2 : 1);
}

// Bytes of dynamic shared memory a block of class cls takes at depth k with
// ring rows of rs elements and f stored in es bytes an element
// (kernels/cylinder.py::cyl_pass_smem mirrors it).
__host__ __device__ constexpr int cp_smem_bytes(int cls, int k, int rs, int es) {
  return CP_D * 9 * rs * es +
         4 * rs * (CP_D * cp_vel(cls) + CP_G * cp_geo(cls) + (k - 1) * CP_R * (9 + cp_vel(cls)));
}

// Dynamic shared memory a block may take with CP_MIN_BLOCKS blocks an SM
// (228 KB an SM, 1 KB a block kept by the system, the static mbarriers).
__host__ __device__ constexpr int cp_budget() {
  return 233472 / CP_MIN_BLOCKS - 1024 - 64 < 232448 ? 233472 / CP_MIN_BLOCKS - 1024 - 64
                                                      : 232448;
}

// Elements a ring row holds past a strip's k halo columns on each side:
// x0 - k rounded down to 16 bytes, x0 a multiple of 8.
__host__ __device__ constexpr int cp_pad(int k, int es) {
  return (k + 16 / es - 1) / (16 / es) * (16 / es);
}

// The ring row (elements) of class cls at depth k, f in es bytes: the
// widest strip (a multiple of 8 columns) whose window fits cp_cols(k) and
// whose rings fit cp_budget(), with its pads. A compile-time constant, so
// that every ring offset of the cell code is an immediate
// (kernels/cylinder.py::cyl_pass_rs mirrors it).
__host__ __device__ constexpr int cp_rs(int cls, int k, int es) {
  int s = (cp_cols(k) - 2 * k) / 8 * 8;
  while (s > 8 && cp_smem_bytes(cls, k, s + 2 * cp_pad(k, es), es) > cp_budget()) s -= 8;
  return s + 2 * cp_pad(k, es);
}

// Mirrors kernels/cylinder.py::CylPassParams.
struct CylPassParams {
  CylParams c;         // the step's constants (c.key is not read)
  unsigned key[3][2];  // Philox key of each class's stores: interior, cyl, edge
  int rs[3];           // the host's cp_rs of each class (checked against the kernel's)
  int nitems;
};

// An item, packed by kernels/cylinder.py::cyl_pass_items as four int32:
// y0 | y1 << 16, x0 | x1 << 16, a0 | a1 << 16, cls | desc << 4.
struct CpItem {
  int y0, y1, x0, x1, a0, a1, cls, desc;
  __device__ explicit CpItem(int4 v)
      : y0(v.x & 0xffff), y1((int)((unsigned)v.x >> 16)), x0(v.y & 0xffff),
        x1((int)((unsigned)v.y >> 16)), a0(v.z & 0xffff), a1((int)((unsigned)v.z >> 16)),
        cls(v.w & 0xf), desc((v.w >> 4) & 1) {}
};

// A cell's view of the sub-step before it: f in a ring of `ns` slots of
// 9 planes of RS elements (element type FT: the storage's in the input
// ring, float32 after), the velocity ("cyl", a ring of 2 planes a slot)
// and the geometry ring's flag and phi. A row offset dy goes s dy slots
// away (the window's direction), a column offset dx to the next element.
// The pointers are at the cell's ring column; RS is a compile-time
// constant, so a read's plane and column offsets are immediates.
template <class FT, int RS>
struct RingAcc {
  const FT* f;       // slot 0, plane 0
  const float* v;    // vx of slot 0 (vy one ring row after), or unused
  const int* fl;     // geometry slot 0: flags
  const float* phs;  // geometry slot 0: phi, or unused
  int slot, ns;      // the cell's row's slot and the ring's slots
  int gslot, s;      // the cell's row's geometry slot; the window's direction
  static constexpr int ST = std::is_same<FT, float>::value ? F32 : BF16_RN;
  __device__ __forceinline__ int sl(int dy) const { return jrl::ring_slot(slot + s * dy, ns); }
  __device__ __forceinline__ int gs(int dy) const { return (gslot + s * dy) & (CP_G - 1); }
  __device__ __forceinline__ float F(int q, int dy, int dx) const {
    return f_load<ST>(f, sl(dy) * (9 * RS) + q * RS + dx, q);
  }
  __device__ __forceinline__ float vx(int dy, int dx) const { return v[sl(dy) * (2 * RS) + dx]; }
  __device__ __forceinline__ float vy(int dy, int dx) const {
    return v[sl(dy) * (2 * RS) + RS + dx];
  }
  __device__ __forceinline__ int flag(int dy, int dx) const { return fl[gs(dy) * RS + dx]; }
  __device__ __forceinline__ float ph(int dy, int dx) const { return phs[gs(dy) * RS + dx]; }
};

// The pass of one item of class CLS at depth K: XW false on a body strip
// (no cell of the window on the columns 0, 1, W-2, W-1: the wall rules
// and their tests are left out, cyl_common.cuh::pull_x). ST: the storage
// of f and f_out; the rings after the input hold float32.
template <int CLS, bool XW, int K, int ST>
__device__ __forceinline__ void cp_run(const f_t<ST>* f, const float* vel, const int* flags,
                                       const float* phi, f_t<ST>* f_out, float* rho_out,
                                       float* vel_out, const CylPassParams& p, const CpItem& it,
                                       unsigned char* smem, uint64_t* bars) {
  constexpr bool FULL = CLS != CP_LEAN, VEL = CLS == CP_CYL;
  constexpr int NV = cp_vel(CLS), CW = cp_cols(K);
  constexpr int RS = cp_rs(CLS, K, (int)sizeof(f_t<ST>));
  const CylParams& c = p.c;
  const int H = c.H, W = c.W, HW = H * W;
  f_t<ST>* const in_f = reinterpret_cast<f_t<ST>*>(smem);
  float* const in_v = reinterpret_cast<float*>(smem + CP_D * 9 * RS * (int)sizeof(f_t<ST>));
  int* const g_fl = reinterpret_cast<int*>(in_v + CP_D * NV * RS);
  float* const g_ph = reinterpret_cast<float*>(g_fl + (FULL ? CP_G * RS : 0));
  float* const lv = g_ph + (VEL ? CP_G * RS : 0);      // sub-steps' f: [K-1][CP_R][9][RS]
  float* const lvv = lv + (K - 1) * CP_R * 9 * RS;     // sub-steps' vel: [K-1][CP_R][2][RS]
  const int tid = threadIdx.x;

  const int wy0 = max(it.y0 - K, 0), wy1 = min(it.y1 + K, H), n_in = wy1 - wy0;
  const int s = it.desc ? -1 : 1, yfirst = it.desc ? wy1 - 1 : wy0;
  const int ncols = it.a1 - it.a0;

  if (tid == 0) {
    for (int i = 0; i < CP_D; ++i) jrl::mbar_init(jrl::smem_addr(bars + i));
    jrl::mbar_init_fence();
    // the initialised mbarriers visible to the async proxy, whose copies
    // complete on them (without it fluid_pass read a first row stale now and then)
    jrl::fence_proxy_async();
  }
  __syncthreads();
  // thread 0: input row i into slot i % CP_D, its geometry into i % CP_G
  auto issue = [&](int i) {
    const int sl = i % CP_D, gsl = i & (CP_G - 1), y = yfirst + s * i;
    const uint32_t bar = jrl::smem_addr(bars + sl);
    const uint32_t fb = (uint32_t)(ncols * (int)sizeof(f_t<ST>)), wb = 4u * (uint32_t)ncols;
    jrl::mbar_expect(bar, 9u * fb + (uint32_t)(NV + (FULL ? 1 : 0) + (VEL ? 1 : 0)) * wb);
    const int g = y * W + it.a0;
#pragma unroll
    for (int q = 0; q < 9; ++q)
      jrl::bulk_g2s(jrl::smem_addr(in_f + (sl * 9 + q) * RS), f + q * HW + g, fb, bar);
    if (VEL) {
      jrl::bulk_g2s(jrl::smem_addr(in_v + (sl * 2) * RS), vel + g, wb, bar);
      jrl::bulk_g2s(jrl::smem_addr(in_v + (sl * 2 + 1) * RS), vel + HW + g, wb, bar);
      jrl::bulk_g2s(jrl::smem_addr(g_ph + gsl * RS), phi + g, wb, bar);
    }
    if (FULL) jrl::bulk_g2s(jrl::smem_addr(g_fl + gsl * RS), flags + g, wb, bar);
  };
  auto wait_row = [&](int i) {
    jrl::mbar_wait(jrl::smem_addr(bars + i % CP_D), (uint32_t)((i / CP_D) & 1));
  };
  if (tid == 0)
    for (int i = 0; i < CP_P && i < n_in; ++i) issue(i);

  // the rows of sub-step jj as relative rows [lo, hi)
  auto rows_of = [&](int jj, int& lo, int& hi) {
    const int ylo = max(it.y0 - (K - jj), 0), yhi = min(it.y1 + (K - jj), H);
    lo = it.desc ? wy1 - yhi : ylo - wy0;
    hi = it.desc ? wy1 - ylo : yhi - wy0;
  };
  int t_end = 0;
#pragma unroll
  for (int jj = 1; jj <= K; ++jj) {
    int lo, hi;
    rows_of(jj, lo, hi);
    t_end = max(t_end, hi + CP_LAG * jj);
  }
  // this thread's sub-step and column
  const int j = min(tid / CW + 1, K + 1);
  const int gx = max(it.x0 - K, 0) + tid - (j - 1) * CW, cc = gx - it.a0;
  const bool on = j <= K && gx >= max(it.x0 - (K - j), 0) && gx < min(it.x1 + (K - j), W);
  int ilo = 0, ihi = 0;
  if (on) rows_of(j, ilo, ihi);
  // the rings sub-step j reads (j >= 2) and the ones it writes (j < K)
  const float* const prev = lv + (j - 2) * CP_R * 9 * RS;
  const float* const prev_v = lvv + (j - 2) * CP_R * 2 * RS;
  float* const next = lv + (j - 1) * CP_R * 9 * RS;
  float* const next_v = lvv + (j - 1) * CP_R * 2 * RS;

#pragma unroll 1
  for (int t = 0; t < t_end; ++t) {
    // slot (t + CP_P) % CP_D: its row t + CP_P - CP_D was last read in phase t - 1
    if (tid == 0 && t + CP_P < n_in) {
      jrl::fence_proxy_async();
      issue(t + CP_P);
    }
    if (t >= 1 && t <= n_in) wait_row(t - 1);
    const int i = t - CP_LAG * j;
    if (on && i >= ilo && i < ihi) {
      const int gy = yfirst + s * i, gsl = i & (CP_G - 1);
      float fo[9], r, ux, uy;
      auto cell = [&](const auto& a) {
#ifdef CYL_PASS_NO_CELLS
        // tools/cyl_pass_probe.py: the streaming and the stores without the cell code
#pragma unroll
        for (int q = 0; q < 9; ++q) fo[q] = a.F(q, 0, 0);
        r = fo[0];
        ux = uy = 0.0f;
#else
        if constexpr (CLS == CP_LEAN) {
          lean_cell<false, XW>(a, c, gy, gx, fo, r, ux, uy);
        } else if constexpr (CLS == CP_CYL) {
          full_cell<true, XW>(a, c, gy, gx, c.wall_density, a.vx(0, 0), a.vy(0, 0), fo, r, ux,
                              uy);
        } else {
          full_cell<false, XW>(a, c, gy, gx, c.wall_density, 0.0f, 0.0f, fo, r, ux, uy);
        }
#endif
      };
      auto from_input = [&] {
        return RingAcc<f_t<ST>, RS>{in_f + cc, in_v + cc, g_fl + cc, g_ph + cc,
                                    i % CP_D,  CP_D,      gsl,       s};
      };
      auto from_ring = [&] {
        return RingAcc<float, RS>{prev + cc,      prev_v + cc, g_fl + cc, g_ph + cc,
                                  i & (CP_R - 1), CP_R,        gsl,       s};
      };
      if constexpr (ST == F32) {
        cell(j == 1 ? from_input() : from_ring());  // one copy of the cell code
      } else if (j == 1) {
        cell(from_input());
      } else {
        cell(from_ring());
      }
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
        const int o = gy * W + gx;
        f_store_key<ST>(f_out, HW, o, fo, p.key[CLS][0], p.key[CLS][1]);
        if (FULL || c.write_macro) {
          rho_out[o] = r;
          vel_out[o] = ux;
          vel_out[HW + o] = uy;
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace cyl
