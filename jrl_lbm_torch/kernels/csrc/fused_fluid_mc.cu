// JRL fluid phase, n steps in one launch of N thread-block clusters that
// hold the whole state in the shared memory of every block of the launch:
// per step, step A (pull-streaming, the moving-tip coupling, moments), the
// exchange of the new rho and vel of each band's edge rows, step B (BGK
// with the LINE_X_EQ_0 axisymmetric source) in place, the exchange of the
// new f.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl.py::
// _make_jrl_fluid_kernel (called by _fused_fluid_run) for grids over one
// cluster and up to 131,072 cells where the card's plan runs one cell a
// thread (on an H100 from refine 2's 256x128 down, where the tile kernel
// fused_fluid_tl.cu takes the grids of TILES_MIN_CELLS cells and more: at
// 256x128 it beats this kernel by ~9% with the wedge tips and loses ~2% with
// a flat one; at 512x256 two cells a thread lose to both it and
// fused_fluid.cu: kernels/fused_jrl.py::fused_route, PERF.md §6). Smaller
// grids than 256x128 that one cluster does not hold, and rows that are not
// 16-byte multiples, still reach it. Its plain twin is kernels/fused_jrl.py::
// fused_fluid_ref; the per-cell code is jrl_fluid.cuh's, unchanged, read
// through cluster_state.cuh::ClusterState, so the kernel equals
// fused_fluid.cu and fused_fluid_cl.cu bit for bit.
//
// Bound on the card: the state crosses device memory once per launch, so
// the bound is the ~650 float32 operations per cell and step (~1.27 us a
// step at 512x256 card-wide). The cooperative kernel keeps the state in
// L2, gives each thread cells strided over the whole grid (a cell's
// neighbours in other blocks) and crosses two grid barriers a step; it runs
// at ~4% of that bound at 512x256 (the tile kernel, with the state in L2
// too, at ~6%). Design: the Pallas kernel keeps the
// domain in VMEM for the whole launch; 512x256 does not fit one cluster's
// shared memory, but it fits the card's: every SM holds one block of a band
// of rows with one halo row a side (cluster_grid.cuh), so every read of a
// step is a shared-memory load, halo rows travel by st.async inside a
// cluster and through mailbox rows in L2 between clusters, and a block
// waits only for its two neighbours. Window planes as fused_fluid_cl.cu: f
// and vel in two sets, rho in one, 23 planes (59 KB a block at 3 rows of
// 128). The step is then one thread's cell chain, plus the exchange
// latency between clusters; at two cells a thread the chain doubles, and
// a wedge tip's costly cells gather in a few bands, which the cooperative
// grid spreads over the card (and the tile kernel over 2D tiles whose
// windows it copies and whose geometry it tables once a step).
#include "cluster_grid.cuh"
#include "fused_launch.cuh"
#include "jrl_fluid.cuh"

namespace {

using namespace jrl;
namespace cg = cooperative_groups;

constexpr int SET = 11;     // planes of a set: f 0-8, u 9, v 10
constexpr int PLANES = 23;  // two sets and rho
constexpr int ROW_PLANES = 9;  // mailbox rows a slot: pass B sends f, A u, v and rho
constexpr int RHO_Q = 2 * SET;

template <int CPT>
__global__ void __launch_bounds__(CL_THREADS, 1) fused_fluid_mc_kernel(
    const float* f_in, const float* rho_in, const float* vel_in, float* f_out, float* rho_out,
    float* vel_out, int start, int n, FluidParams pa, FluidBParams pb, u64* box) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float sm[];
  __shared__ uint64_t bars[2];  // the halo bytes of A (rho, vel) and of B (f)
  const int H = pa.H, W = pa.W, HW = H * W;
  const GridBand b(cluster, sm, bars, H, W, box, ROW_PLANES);
  const int PL = b.PL, cells = b.rows * W, RHO = RHO_Q * PL;
  const uint32_t bytes_a = b.bytes(3), bytes_b = b.bytes(9);
  float* const rho = sm + RHO;

  for (int i = threadIdx.x; i < (b.rows + 2) * W; i += CL_THREADS) {
    const int g = b.gy(i / W, H) * W + i % W;
#pragma unroll
    for (int q = 0; q < 9; ++q) sm[q * PL + i] = f_in[q * HW + g];
    sm[9 * PL + i] = vel_in[g];
    sm[10 * PL + i] = vel_in[HW + g];
    rho[i] = rho_in[g];
  }
  b.arm(cluster, bytes_a, bytes_b);

  for (int i = 0; i < n; ++i) {
    const float* cur = sm + (i & 1) * SET * PL;
    const int nq = ((i & 1) ^ 1) * SET;  // first plane of the set step i writes
    float* const set = sm + nq * PL;
    const FluidGeo g = fluid_geo(start + i, pa);
    mc_jitter(b.b, 2 * i, 0);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = threadIdx.x + j * CL_THREADS;
      if (c < cells) {
        int ly, x;
        b.cell_at(c, ly, x);
        const int y = b.y0 + ly - 1, li = ly * W + x;
        float fo[9], r, u, v;
        fluid_a_cell(ClusterState{cur, rho, cur + 9 * PL, PL, W, ly, x}, g, pa.cs2tau, y, x, fo,
                     r, u, v);
#pragma unroll
        for (int q = 0; q < 9; ++q) set[q * PL + li] = fo[q];
        set[9 * PL + li] = u;
        set[10 * PL + li] = v;
        rho[li] = r;
        if (b.edge(ly)) {
          b.push(ly, x, nq + 9, 0, u, 0, 2 * i);
          b.push(ly, x, nq + 10, 1, v, 0, 2 * i);
          b.push(ly, x, RHO_Q, 2, r, 0, 2 * i);
        }
      }
    }
    b.exchange(0, i & 1, i > 0 ? 1 : -1, bytes_b, 2 * i, PassPlanes{nq + 9, 2, RHO_Q});
    mc_jitter(b.b, 2 * i + 1, 0);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = threadIdx.x + j * CL_THREADS;
      if (c < cells) {
        int ly, x;
        b.cell_at(c, ly, x);
        const int y = b.y0 + ly - 1, li = ly * W + x;
        float fo[9];
        fluid_b_cell(ClusterState{set, rho, set + 9 * PL, PL, W, ly, x}, g, pb, y, x, fo);
#pragma unroll
        for (int q = 0; q < 9; ++q) set[q * PL + li] = fo[q];
        if (b.edge(ly)) {
#pragma unroll
          for (int q = 0; q < 9; ++q) b.push(ly, x, nq + q, q, fo[q], 1, 2 * i + 1);
        }
      }
    }
    b.exchange(1, i & 1, 0, bytes_a, 2 * i + 1, PassPlanes{nq, 9, -1});
  }
  cluster.sync();  // no block leaves while its cluster still pushes into it

  const float* fin = sm + (n & 1) * SET * PL;  // the set the last step wrote
  for (int c = threadIdx.x; c < cells; c += CL_THREADS) {
    const int li = c + W, g = b.y0 * W + c;
#pragma unroll
    for (int q = 0; q < 9; ++q) f_out[q * HW + g] = fin[q * PL + li];
    vel_out[g] = fin[9 * PL + li];
    vel_out[HW + g] = fin[10 * PL + li];
    rho_out[g] = rho[li];
  }
}

}  // namespace

// The opt-in shared memory and the clusters of 16, 8, 4, 2 and 1 blocks
// the card holds at once there (active[5]).
extern "C" int jrl_fused_fluid_mc_limits(int* smem_optin, int* active) {
  return grid_limits(fused_fluid_mc_kernel<1>, smem_optin, active);
}

extern "C" int jrl_fused_fluid_mc_info(int cpt, int* regs, int* local_bytes) {
  const auto k = JRL_FUSED_PICK(fused_fluid_mc_kernel, cpt);
  return k ? kernel_info(k, regs, local_bytes) : (int)cudaErrorInvalidValue;
}

// Clusters of `cluster` blocks the card holds at once at `smem` bytes a block.
extern "C" int jrl_fused_fluid_mc_active(int cpt, int cluster, int smem, int* out) {
  const auto k = JRL_FUSED_PICK(fused_fluid_mc_kernel, cpt);
  return k ? active_clusters(k, cluster, smem, out) : (int)cudaErrorInvalidValue;
}

extern "C" int jrl_fused_fluid_mc(const float* f, const float* rho, const float* vel,
                                  float* f_out, float* rho_out, float* vel_out, int start, int n,
                                  const FluidParams* pa, const FluidBParams* pb, u64* box,
                                  int clusters, int cluster, int cpt, int smem, void* stream) {
  FluidParams a = *pa;
  FluidBParams b = *pb;
  void* args[] = {&f, &rho, &vel, &f_out, &rho_out, &vel_out, &start, &n, &a, &b, &box};
  return launch_grid(JRL_FUSED_PICK(fused_fluid_mc_kernel, cpt), a.H, a.W, PLANES, clusters,
                     cluster, cpt, smem, args, stream);
}
