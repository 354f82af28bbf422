// Launch form, band and halo exchange of the multi-cluster kernels
// (fused_fluid_mc.cu, fused_balance_mc.cu, fused_approach_mc.cu): N
// thread-block clusters of C
// blocks, one block an SM, hold the whole grid in the shared memory of
// every block of the launch for the whole launch. Built on
// cluster_state.cuh (its accessor ClusterState, its window layout, its
// mbarrier and st.async primitives), which keeps one cluster.
//
// Row bands. Global block b = n C + r (cluster n, rank r; blockIdx.x) of
// B = N C blocks owns rows [b H / B, (b + 1) H / B) and keeps them with one
// halo row a side in the window layout of cluster_state.cuh (band_y0,
// band_pl taken over B bands), so every read of a step lands where
// GlobalState would read and the kernels equal the cooperative ones
// (fused_fluid.cu, fused_balance.cu, fused_approach.cu) bit for bit. Bands of at least
// CL_MIN_ROWS rows keep OUTFLOW's two-row reach inside a band and its halo.
//
// Halo rows inside a cluster travel as in cluster_state.cuh::Band: st.async
// into the neighbour's halo row, the bytes counted on its mbarrier.
//
// Halo rows between clusters: rank 0's first row goes down to the last
// block of the cluster below, rank C - 1's last row up to the first block
// of the cluster above (cluster n - 1 and n + 1 taken mod N: the periodic
// wrap from the last band to the first is one of these edges). Each value
// travels as one 8-byte word in a mailbox row in device memory: the float's
// bits and, above them, its pass's sequence number p + 1, written by the
// thread that computed the cell with one relaxed gpu-scope store. At the
// end of the pass the receiving block's threads load the words of its
// mailbox row (relaxed, gpu scope; all of a thread's words at once, again
// while any is still older than the pass) and store each value, once its
// word carries the pass, into their halo row, before the block barrier
// that ends the pass; the mbarrier then counts only the rows from inside
// the cluster. One 8-byte store is seen whole or not at all, so the number
// vouches for the value beside it: no fence, no flag and no copy stand
// between the sender's store and the receiver's load. No grid.sync() and
// no cluster-wide barrier in the step loop: a block waits only for its two
// neighbours' data.
//
// Mailbox slots. Pass p (the fluid's A of step i is pass 2i, its B 2i + 1;
// the balance's and the approach's step i is pass i) goes to slot p & 1. A sender writes slot
// p & 1 again at pass p + 2 only after it has received its receiver's pass
// p + 1 (the two blocks of an edge are each other's neighbours, so each
// waits for the other every pass), which the receiver sends only after the
// barrier that ends its pass p, which its threads reach only once they
// have loaded every word of pass p. So pass p + 2's stores come after pass p's
// loads in a chain of dependences, and two slots are enough. A receiver
// takes a word only if it carries exactly p + 1, so a stale word (0: the
// wrapper zeroes the mailbox before each launch, or p - 1) is never taken,
// and a word from the future could only stall the wait into its trap,
// never pass as data.
//
// Co-residency. A block waits for a neighbour in another cluster, so every
// cluster must be resident at once. The host plan takes N from
// cudaOccupancyMaxActiveClusters (kernels/fused_jrl.py::mc_plan), the
// launcher below refuses a grid over that limit before launch, and the
// launch carries the cooperative attribute together with the cluster
// dimension (the CUDA 12.8 runtime accepts the pair on an H100), so the
// runtime refuses what it cannot hold at once. Any wait that runs past
// MC_WAIT_NS ends in __trap(): a bad plan becomes a CUDA error, never a
// hang, and never a quiet switch to another kernel.
//
// Probes (-D, built by tests and tools, never shipped): JRL_MC_JITTER=ns
// delays each block by a pseudo-random time, different for every block and
// pass, before the cells of a pass and before it takes its mailbox rows,
// to shake out races in the exchange; JRL_MC_STALL makes every receiver
// wait for a pass that is never sent, which must trap; JRL_MC_WAIT_NS sets
// the wait budget; JRL_MC_NO_FAR skips the halo rows between clusters (a
// block neither waits for nor takes them: wrong results, the time of the
// rest).
#pragma once

#include "cluster_state.cuh"

namespace jrl {

#ifndef JRL_MC_WAIT_NS
#define JRL_MC_WAIT_NS 4000000000ull
#endif
constexpr unsigned long long MC_WAIT_NS = JRL_MC_WAIT_NS;
constexpr int MC_BATCH = 8;  // mailbox words a thread loads at once

typedef unsigned long long u64;

__device__ __forceinline__ u64 global_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// __trap() once a wait that started at *t0 (0: not yet) passes the budget
__device__ __forceinline__ void wait_budget(u64* t0) {
  const u64 t = global_ns();
  if (*t0 == 0) *t0 = t;
  else if (t - *t0 > MC_WAIT_NS) __trap();
}
__device__ __forceinline__ u64 ld_word(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_word(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
// mbar_wait (cluster_state.cuh) with the wait budget
__device__ __forceinline__ void mbar_wait_budget(uint32_t bar, uint32_t parity) {
  u64 t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    wait_budget(&t0);
  }
}

#ifdef JRL_MC_JITTER
__device__ __forceinline__ void mc_jitter(int b, int p, int salt) {
  unsigned h = (unsigned)b * 0x9E3779B1u ^ (unsigned)p * 0x85EBCA77u ^ (unsigned)salt * 0xC2B2AE3Du;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  __nanosleep(h % (unsigned)JRL_MC_JITTER);
}
#else
__device__ __forceinline__ void mc_jitter(int, int, int) {}
#endif

#ifdef JRL_MC_STALL
constexpr int MC_STALL = 2;  // wait for pass p + 2, which the neighbour never sends
#else
constexpr int MC_STALL = 0;
#endif
#ifdef JRL_MC_NO_FAR
constexpr bool MC_FAR = false;
#else
constexpr bool MC_FAR = true;
#endif

// The planes a pass sends: `count` window planes from `first`, then plane
// `extra` (none if < 0); mailbox row j holds the j-th of them.
struct PassPlanes {
  int first, count, extra;
  __device__ __forceinline__ int rows() const { return count + (extra >= 0); }
  __device__ __forceinline__ int plane(int j) const { return j < count ? first + j : extra; }
};

// The mailbox (kernels/fused_jrl.py allocates it zeroed): word ((2 n + d)
// 2 + (p & 1)) RP W + j W + x holds column x of mailbox row j of pass p
// entering cluster n, side d (0: rank 0 from below, 1: rank C - 1 from
// above); RP, the kernel's mailbox rows a slot, is the most planes one of
// its passes sends (9 for f or h, 10 for the approach's h and C).
// A block's place in the launch: its band, the plane stride, its two
// mbarriers, and where its edge rows go: into the neighbour's halo row
// (inside the cluster) or into a mailbox row (to another cluster).
struct GridBand {
  int b, y0, rows, PL, W, RP;
  bool dn_far, up_far;  // the neighbour below / above is in another cluster
  uint32_t dn, up;      // inside the cluster: element (halo row, x = 0) of plane 0
  uint32_t bar[2], dn_bar[2], up_bar[2];
  u64* dn_box;          // in another cluster: slot 0, row 0 of the neighbour's side
  u64* up_box;
  const u64* lo_box;    // this block's own sides: its row 0 from below,
  const u64* hi_box;    // row rows + 1 from above
  float* lo_row;        // those halo rows of plane 0 in this block's window
  float* hi_row;

  template <class Cluster>
  __device__ GridBand(const Cluster& cluster, float* sm, uint64_t* bars, int H, int W_, u64* box,
                      int row_planes)
      : W(W_), RP(row_planes) {
    const int C = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
    const int B = (int)gridDim.x, N = B / C, n = (int)blockIdx.x / C;
    b = (int)blockIdx.x;
    const int bb = (b + B - 1) % B;  // the block below
    y0 = band_y0(b, H, B);
    rows = band_y0(b + 1, H, B) - y0;
    PL = band_pl(H, W, B);
    dn_far = N > 1 && r == 0;
    up_far = N > 1 && r == C - 1;
    const uint32_t rb = (r + C - 1) % C, ra = (r + 1) % C;
    const int below_top = band_y0(bb + 1, H, B) - band_y0(bb, H, B) + 1;
    const uint32_t own = smem_addr(sm);
    dn = peer_addr(own, rb) + 4u * below_top * W;
    up = peer_addr(own, ra);
    for (int k = 0; k < 2; ++k) {
      bar[k] = smem_addr(bars + k);
      dn_bar[k] = peer_addr(bar[k], rb);
      up_bar[k] = peer_addr(bar[k], ra);
    }
    const size_t side = 2u * RP * (size_t)W;  // words of a side's two slots
    const int nb = (n + N - 1) % N, na = (n + 1) % N;
    dn_box = box + (2 * nb + 1) * side;  // enters rank C - 1 of the cluster below from above
    up_box = box + (2 * na + 0) * side;  // enters rank 0 of the cluster above from below
    lo_box = box + (2 * n + 0) * side;
    hi_box = box + (2 * n + 1) * side;
    lo_row = sm;
    hi_row = sm + (rows + 1) * W;
  }
  // the global row of local row ly (halo rows wrap)
  __device__ __forceinline__ int gy(int ly, int H) const { return wrap1(y0 - 1 + ly, H); }
  __device__ __forceinline__ bool edge(int ly) const { return ly == 1 || ly == rows; }
  // The cell (local row ly, column x) of cell number c = threadIdx.x + j
  // CL_THREADS of the band. Rows in the order: the two edge rows first,
  // then the rows between, so that at 2 or 4 cells a thread the
  // neighbours' halo rows travel while the block computes its inner rows;
  // each odd j's row turned by half the width, so that no thread takes two
  // cells of the same columns, where the tip's costly cells cluster (a
  // thread's cells run one after the other). Cells are independent within
  // a pass: the order changes no bit.
  __device__ __forceinline__ void cell_at(int c, int& ly, int& x) const {
    const int k = c / W;
    ly = k == 0 ? 1 : k == 1 ? rows : k;
    x = c - k * W + ((c / CL_THREADS) & 1) * (W / 2);
    if (x >= W) x -= W;
  }
  // push value v of edge cell (ly, x), window plane q, mailbox row j, of
  // pass p to the neighbour's halo row (counted on its mbarrier k) or to
  // its mailbox
  __device__ __forceinline__ void push(int ly, int x, int q, int j, float v, int k, int p) const {
    const bool down = ly == 1;
    if (down ? dn_far : up_far) {
      const size_t i = ((size_t)(p & 1) * RP + j) * W + x;
      st_word((down ? dn_box : up_box) + i, (u64)(unsigned)(p + 1) << 32 | __float_as_uint(v));
    } else {
      st_async((down ? dn : up) + 4u * (x + q * PL), v,
               down ? Band::pick(dn_bar, k) : Band::pick(up_bar, k));
    }
  }
  // before the first step: both mbarriers armed for `bytes0`, `bytes1`, then
  // every block of the cluster loaded and armed before any pushes (blocks
  // of other clusters reach this block only through its own threads)
  template <class Cluster>
  __device__ void arm(const Cluster& cluster, uint32_t bytes0, uint32_t bytes1) const {
    if (threadIdx.x == 0) {
      mbar_init(bar[0]);
      mbar_init(bar[1]);
      mbar_init_fence();
      mbar_expect(bar[0], bytes0);
      mbar_expect(bar[1], bytes1);
    }
    cluster.sync();
  }
  // the bytes of W cells of `planes` planes for each neighbour's edge row
  // that arrives by st.async (a mailbox row arrives by take(); 0 bytes
  // complete the phase at its arrival)
  __device__ __forceinline__ uint32_t bytes(int planes) const {
    return (2u - dn_far - up_far) * (uint32_t)W * (uint32_t)planes * 4u;
  }
  // end of pass p: the halo rows from other clusters taken (planes `pl`)
  // into the window, this block's writes visible to its threads, the
  // mbarrier `rearm` (none if < 0) armed for its next phase, then the wait
  // until both neighbours' bytes of mbarrier k's phase `parity` landed
  __device__ __forceinline__ void exchange(int k, uint32_t parity, int rearm, uint32_t rearm_bytes,
                                           int p, PassPlanes pl) const {
    finish(rearm, rearm_bytes, p, pl);
    wait(k, parity);
  }
  // exchange in two halves, for work between them that reads no halo row
  // of the pass (the halo rows from other clusters are in the window after
  // finish, those from inside the cluster only after wait)
  __device__ __forceinline__ void finish(int rearm, uint32_t rearm_bytes, int p,
                                         PassPlanes pl) const {
    if (dn_far || up_far) mc_jitter(b, p, 1);
    if (MC_FAR && dn_far) take(lo_box, lo_row, p, pl);
    if (MC_FAR && up_far) take(hi_box, hi_row, p, pl);
    __syncthreads();
    if (threadIdx.x == 0 && rearm >= 0) mbar_expect(Band::pick(bar, rearm), rearm_bytes);
  }
  __device__ __forceinline__ void wait(int k, uint32_t parity) const {
    mbar_wait_budget(Band::pick(bar, k), parity);
  }
  // this thread's words of the mailbox side `box`, pass p, each once it
  // carries the pass, into the halo row `row` (plane 0) of this block's
  // window: plain shared-memory stores, which the block barrier after them
  // makes visible to the block
  __device__ __forceinline__ void take(const u64* box, float* row, int p, PassPlanes pl) const {
    const int m = pl.rows() * W;
    const u64* slot = box + (size_t)(p & 1) * RP * W;
    const unsigned want = (unsigned)(p + 1 + MC_STALL);
    for (int e0 = threadIdx.x; e0 < m; e0 += MC_BATCH * CL_THREADS) {
      unsigned pending = 0;
#pragma unroll
      for (int u = 0; u < MC_BATCH; ++u)
        if (e0 + u * CL_THREADS < m) pending |= 1u << u;
      u64 t0 = 0;
      while (pending) {
        u64 w[MC_BATCH];
#pragma unroll
        for (int u = 0; u < MC_BATCH; ++u)
          if (pending >> u & 1u) w[u] = ld_word(slot + e0 + u * CL_THREADS);
#pragma unroll
        for (int u = 0; u < MC_BATCH; ++u) {
          if ((pending >> u & 1u) && (unsigned)(w[u] >> 32) == want) {
            const int e = e0 + u * CL_THREADS, j = e / W, x = e - j * W;
            row[pl.plane(j) * PL + x] = __uint_as_float((unsigned)w[u]);
            pending &= ~(1u << u);
          }
        }
        if (pending) wait_budget(&t0);
      }
    }
  }
};

// Cluster sizes a plan may take (kernels/fused_jrl.py::MC_SIZES)
constexpr int MC_SIZES[5] = {16, 8, 4, 2, 1};

// The card's limits for the plan: the dynamic shared memory a block may
// opt in to, and the clusters of each size of MC_SIZES of `kernel` it holds
// at once at that shared memory (the most a plan may ask for, so a plan
// with less holds at least as many; 0 where the card holds none).
template <class K>
inline int grid_limits(K kernel, int* smem_optin, int* active) {
  int dev = 0, optin = 0;
  cudaFuncAttributes a;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, (const void*)kernel);
  if (e != cudaSuccess) return (int)e;
  *smem_optin = optin - (int)a.sharedSizeBytes;
  for (int i = 0; i < 5; ++i) {
    const int ei = active_clusters(kernel, MC_SIZES[i], *smem_optin, active + i);
    if (ei == 0) continue;
    (void)cudaGetLastError();
    if (MC_SIZES[i] <= 8) return ei;
    active[i] = 0;  // a card without the non-portable size
  }
  return 0;
}

// The launch: `clusters` clusters of `cluster` blocks, the cluster
// dimension and the cooperative attribute together.
struct GridLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  GridLaunch(int clusters, int cluster, int smem, void* stream) : cfg(), attrs() {
    cfg.gridDim = dim3(clusters * cluster);
    cfg.blockDim = dim3(CL_THREADS);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = (cudaStream_t)stream;
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = cluster;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    attrs[1].id = cudaLaunchAttributeCooperative;
    attrs[1].val.cooperative = 1;
    cfg.attrs = attrs;
    cfg.numAttrs = 2;
  }
};

// `clusters` clusters of `cluster` blocks of CL_THREADS threads over an
// H x W grid of `planes` window planes at `cpt` cells per thread; refused
// before launch (cudaErrorInvalidValue) unless every band has at least
// CL_MIN_ROWS rows, a band's cells fit cpt cells per thread and `smem` is
// the windows' size, and (cudaErrorCooperativeLaunchTooLarge) unless the
// card holds every cluster at once at that shared memory.
template <class K>
inline int launch_grid(K kernel, int H, int W, int planes, int clusters, int cluster, int cpt,
                       int smem, void** args, void* stream) {
  if (!kernel || cluster < 1 || cluster > 16 || (cluster & (cluster - 1)) || clusters < 1)
    return (int)cudaErrorInvalidValue;
  const int B = clusters * cluster, rows_max = (H + B - 1) / B;
  if (H / B < CL_MIN_ROWS || rows_max * W > cpt * CL_THREADS ||
      smem != planes * band_pl(H, W, B) * (int)sizeof(float))
    return (int)cudaErrorInvalidValue;
  int active = 0;
  const int e = active_clusters(kernel, cluster, smem, &active);
  if (e != 0) return e;
  if (clusters > active) return (int)cudaErrorCooperativeLaunchTooLarge;
  GridLaunch l(clusters, cluster, smem, stream);
  return (int)cudaLaunchKernelExC(&l.cfg, (const void*)kernel, args);
}

}  // namespace jrl
