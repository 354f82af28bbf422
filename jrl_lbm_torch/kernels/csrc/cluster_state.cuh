// Launch form, state accessor and halo exchange of the cluster kernels
// (fused_fluid_cl.cu, fused_balance_cl.cu, fused_approach_cl.cu): one
// thread-block cluster holds the whole grid in the shared memory of its
// blocks for the whole launch (one cluster a lane in the approach's lanes
// instance).
//
// Row bands. Block r of a cluster of C blocks owns rows [y0(r), y0(r+1)),
// y0(r) = r H / C (integer division; bands differ by at most one row, so
// H % C need not be 0), and keeps them with one halo row on each side in a
// window of local rows: local row 0 is global row y0 - 1 (mod H), rows
// 1 .. R the band, row R + 1 global row y0 + R (mod H). Every plane of a
// window has the same stride PL = (ceil(H / C) + 2) W in every block, so a
// block finds a plane of its neighbour's window at the offset of its own.
//
// Reach. The cell code reads one row away, except an OUTFLOW cell of row 0
// or H - 1, which recomputes the streaming of the cell one row inward and
// so reads two rows inward: inside the first or last band plus its halo
// whenever every band has at least two rows (checked before launch). Every
// read then lands on the value GlobalState would read, and the kernels
// equal the cooperative ones (fused_fluid.cu, fused_balance.cu) bit for
// bit.
//
// Halo exchange, pushed and counted. A thread that computes a cell of its
// band's first (last) row stores the cell's new values into the top
// (bottom) halo row of the block below (above) with st.async, whose
// completion counts the bytes on that block's mbarrier for the pass. A
// block then waits on its own mbarrier until both neighbours' bytes have
// landed: the data dependencies of the step are the only synchronisation
// between blocks, with no cluster-wide barrier in the step loop (one
// cluster barrier with its release fence costs ~0.7 us on an H100, more
// than the exchange). Each kernel keeps two mbarriers (the fluid's two
// passes; the balance's even and odd steps), each completing one phase per
// use; thread 0 re-arms one (arrive.expect_tx of the bytes its next phase
// receives) only after a __syncthreads() that every thread reaches after
// waiting on it. That, and the causality of the exchange (a neighbour
// sends the next phase's bytes only after it received this block's bytes
// that follow this block's wait), keep the phases apart: no byte of a
// phase lands before the previous phase of its mbarrier completed, and a
// neighbour writes a halo row of a buffer set only after the threads that
// read that row (this band's edge rows, which push next) are past it.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "jrl_common.cuh"

namespace jrl {

constexpr int CL_THREADS = 512;  // threads per block, one cell each at 128x64
constexpr int CL_MIN_ROWS = 2;   // rows of the smallest band (the reach above)

__host__ __device__ inline int band_y0(int r, int H, int C) { return r * H / C; }
__host__ __device__ inline int band_pl(int H, int W, int C) {
  return ((H + C - 1) / C + 2) * W;
}

// ---------------------------------------------------------------------------
// Shared-memory addresses, mbarriers and st.async (PTX, sm_90)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// the address `a` of this block's shared memory in block `rank`'s
__device__ __forceinline__ uint32_t peer_addr(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}
// makes mbarrier_init visible to the cluster (then a cluster barrier)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// the one arrival of the current phase, which then completes once `bytes`
// have landed
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// v to shared::cluster address `dst`, its 4 bytes counted on mbarrier `bar`
// (an address in the same block as dst)
__device__ __forceinline__ void st_async(uint32_t dst, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
                   dst),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

// ---------------------------------------------------------------------------
// The accessor and the band
// ---------------------------------------------------------------------------

// The state read around local cell (ly, x) of a block's window: planes of
// PL floats, rows W wide, columns taken mod W as GlobalState takes them.
// rho and vel may be null where nothing reads them.
struct ClusterState {
  const float* f;
  const float* rho;
  const float* vel;
  int PL, W, ly, x;
  __device__ __forceinline__ int idx(int dy, int dx) const {
    return (ly + dy) * W + wrap1(x + dx, W);
  }
  __device__ __forceinline__ float F(int q, int dy, int dx) const {
    return f[q * PL + idx(dy, dx)];
  }
  __device__ __forceinline__ float R(int dy, int dx) const { return rho[idx(dy, dx)]; }
  __device__ __forceinline__ float U(int dy, int dx) const { return vel[idx(dy, dx)]; }
  __device__ __forceinline__ float V(int dy, int dx) const { return vel[PL + idx(dy, dx)]; }
  __device__ __forceinline__ ClusterState at(int dy, int dx) const {
    return ClusterState{f, rho, vel, PL, W, ly + dy, wrap1(x + dx, W)};
  }
};

// A block's place in the cluster: its band, the plane stride, its two
// mbarriers, and where its edge rows go in the neighbours' windows.
struct Band {
  int y0, rows, PL, W;
  uint32_t dn, up;         // element (halo row, x = 0) of plane 0 below / above
  uint32_t bar[2];         // own mbarriers
  uint32_t dn_bar[2], up_bar[2];

  template <class Cluster>
  __device__ Band(const Cluster& cluster, float* sm, uint64_t* bars, int H, int W_) : W(W_) {
    const int C = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
    const uint32_t rb = (r + C - 1) % C, ra = (r + 1) % C;
    y0 = band_y0(r, H, C);
    rows = band_y0(r + 1, H, C) - y0;
    PL = band_pl(H, W, C);
    const int below_top = band_y0(rb + 1, H, C) - band_y0(rb, H, C) + 1;
    dn = peer_addr(smem_addr(sm), rb) + 4u * below_top * W;
    up = peer_addr(smem_addr(sm), ra);
    for (int k = 0; k < 2; ++k) {
      bar[k] = smem_addr(bars + k);
      dn_bar[k] = peer_addr(bar[k], rb);
      up_bar[k] = peer_addr(bar[k], ra);
    }
  }
  // the global row of local row ly (halo rows wrap)
  __device__ __forceinline__ int gy(int ly, int H) const { return wrap1(y0 - 1 + ly, H); }
  __device__ __forceinline__ bool edge(int ly) const { return ly == 1 || ly == rows; }
  // push value v of edge cell (ly, x) at plane offset `off` (floats) to the
  // neighbour's halo, counted on its mbarrier k
  __device__ __forceinline__ void push(int ly, int x, int off, float v, int k) const {
    st_async((ly == 1 ? dn : up) + 4u * (x + off), v,
             ly == 1 ? pick(dn_bar, k) : pick(up_bar, k));
  }
  // before the first step: both mbarriers armed for `bytes0`, `bytes1`, then
  // every block loaded and armed before any pushes
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
  // the bytes of 2 W cells of `planes` planes: one edge row of each neighbour
  __device__ __forceinline__ uint32_t bytes(int planes) const {
    return 2u * (uint32_t)W * (uint32_t)planes * 4u;
  }
  // end of a pass: this block's writes visible to its threads, the
  // mbarrier `rearm` (none if < 0), which every thread has waited on
  // before this __syncthreads(), armed for its next phase, then the wait
  // until both neighbours' bytes of mbarrier k's phase `parity` landed
  __device__ __forceinline__ void exchange(int k, uint32_t parity, int rearm,
                                           uint32_t rearm_bytes) const {
    finish(rearm, rearm_bytes);
    wait(k, parity);
  }
  // exchange in two halves, for work between them that reads no halo row
  __device__ __forceinline__ void finish(int rearm, uint32_t rearm_bytes) const {
    __syncthreads();
    if (threadIdx.x == 0 && rearm >= 0) mbar_expect(pick(bar, rearm), rearm_bytes);
  }
  __device__ __forceinline__ void wait(int k, uint32_t parity) const {
    mbar_wait(pick(bar, k), parity);
  }
  // a[k] without indexing a register array by a runtime k (local memory)
  static __device__ __forceinline__ uint32_t pick(const uint32_t (&a)[2], int k) {
    return k ? a[1] : a[0];
  }
};

// Let `kernel` use `smem` bytes of dynamic shared memory and clusters of
// up to 16 blocks (the non-portable size).
template <class K>
inline cudaError_t cluster_attrs(K kernel, int smem) {
  cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  return e;
}

// `lanes` clusters of `cluster` blocks each (one cluster a lane; clusters
// that do not fit on the card at once run as they free SMs)
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  ClusterLaunch(int cluster, int smem, void* stream, int lanes = 1) : cfg(), attr() {
    cfg.gridDim = dim3(cluster * lanes);
    cfg.blockDim = dim3(CL_THREADS);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = (cudaStream_t)stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// The card's limits for `kernel`: the dynamic shared memory a block may opt
// in to (the card's opt-in less the kernel's static shared memory), and the
// largest cluster (16, else 8, else 0) of which the card can hold at least
// one at that shared memory (cudaOccupancyMaxActiveClusters).
template <class K>
inline int cluster_limits(K kernel, int* smem_optin, int* cluster) {
  int dev = 0, optin = 0;
  *cluster = 0;
  cudaFuncAttributes a;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, (const void*)kernel);
  if (e == cudaSuccess) {
    *smem_optin = optin - (int)a.sharedSizeBytes;
    e = cluster_attrs(kernel, *smem_optin);
  }
  for (int c = 16; e == cudaSuccess && c >= 8 && *cluster == 0; c /= 2) {
    ClusterLaunch l(c, *smem_optin, nullptr);
    int n = 0;
    const cudaError_t q = cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &l.cfg);
    if (q != cudaSuccess && c == 16) {
      (void)cudaGetLastError();  // a card without the non-portable size: try 8
      n = 0;
    } else if (q != cudaSuccess) {
      e = q;
    }
    if (n >= 1) *cluster = c;
  }
  return (int)e;
}

// Clusters of `cluster` blocks of `kernel` at `smem` bytes a block that the
// card holds at once (cudaOccupancyMaxActiveClusters).
template <class K>
inline int active_clusters(K kernel, int cluster, int smem, int* out) {
  *out = 0;
  cudaError_t e = cluster_attrs(kernel, smem);
  ClusterLaunch l(cluster, smem, nullptr);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(out, (const void*)kernel, &l.cfg);
  return (int)e;
}

// Registers per thread and local (spill) bytes of `kernel`.
template <class K>
inline int kernel_info(K kernel, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, (const void*)kernel);
  *regs = e == cudaSuccess ? a.numRegs : 0;
  *local_bytes = e == cudaSuccess ? (int)a.localSizeBytes : 0;
  return (int)e;
}

// One cluster (`lanes` clusters) of `cluster` blocks of CL_THREADS threads
// over an H x W grid of `planes` window planes at `cpt` cells per thread;
// refused (cudaErrorInvalidValue, nothing launched) unless the bands have
// at least CL_MIN_ROWS rows, a band's cells fit cpt cells per thread and
// `smem` is the windows' size.
template <class K>
inline int launch_cluster(K kernel, int H, int W, int planes, int cluster, int cpt, int smem,
                          void** args, void* stream, int lanes = 1) {
  if (!kernel || (cluster != 8 && cluster != 16) || lanes < 1) return (int)cudaErrorInvalidValue;
  const int rows_max = (H + cluster - 1) / cluster;
  if (H / cluster < CL_MIN_ROWS || rows_max * W > cpt * CL_THREADS ||
      smem != planes * band_pl(H, W, cluster) * (int)sizeof(float))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cluster_attrs(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  ClusterLaunch l(cluster, smem, stream, lanes);
  return (int)cudaLaunchKernelExC(&l.cfg, (const void*)kernel, args);
}

}  // namespace jrl
