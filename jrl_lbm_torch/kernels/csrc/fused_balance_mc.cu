// JRL concentration balance, n steps in one launch of N thread-block
// clusters that hold the whole state in the shared memory of every block of
// the launch: per step, streaming with the INFLOW / INFLOW_2 reservoirs and
// the OUTFLOW copy, C = sum h with OBSTACLE passthrough, BGK at u = 0 with
// the axisymmetric rate, then the exchange of the new h of each band's edge
// rows.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl.py::
// _make_balance_kernel (called by _fused_balance_run) for grids over one
// cluster and up to 131,072 cells (256x128 and 512x256, refine 2 and 4 of
// the default case; kernels/fused_jrl.py::fused_route), where
// fused_balance.cu ran before. Its plain twin is kernels/fused_jrl.py::
// fused_balance_ref; the per-cell code is jrl_c.cuh::balance_cell_at, read
// through cluster_state.cuh::ClusterState with its collision terms computed
// once a launch (jrl_c.cuh::balance_rates, as fused_balance_cl.cu does), so
// the kernel equals fused_balance.cu bit for bit.
//
// Bound on the card: the state crosses device memory once per launch, so
// the bound is the ~230 float32 operations per cell and step (~0.45 us a
// step at 512x256 card-wide). The cooperative kernel keeps the state in L2
// and crosses a grid barrier a step (~8% of that bound at 512x256). Design:
// as fused_fluid_mc.cu, a band of rows per block of every SM with one halo
// row a side in shared memory for the whole launch (cluster_grid.cuh), the
// edge rows' new h pushed by st.async into the neighbours' halo rows inside
// a cluster and through mailbox rows between clusters, one mbarrier for
// even steps and one for odd. Window planes: h in two sets, C in one, 19
// planes. The fixed flags are decoded once per cell into registers, and the
// collision terms that depend only on the column are computed once.
#include "cluster_grid.cuh"
#include "fused_launch.cuh"
#include "jrl_c.cuh"

namespace {

using namespace jrl;
namespace cg = cooperative_groups;

constexpr int PLANES = 19;     // two sets of h, and C
constexpr int ROW_PLANES = 9;  // mailbox rows a slot: a pass sends h

template <int CPT>
__global__ void __launch_bounds__(CL_THREADS, 1) fused_balance_mc_kernel(
    const int* flags, const float* h_in, const float* C_in, float* h_out, float* C_out, int n,
    CBalanceParams p, u64* box) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float sm[];
  __shared__ uint64_t bars[2];  // the halo bytes of even and of odd steps
  const int H = p.H, W = p.W, HW = H * W;
  const GridBand b(cluster, sm, bars, H, W, box, ROW_PLANES);
  const int PL = b.PL, cells = b.rows * W;
  const uint32_t bytes = b.bytes(9);
  float* const Cs = sm + 18 * PL;
  const BalanceGeo g{GlobalPlane{flags, W}};
  BalanceCell cell[CPT];
  BalanceRates rates[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int c = threadIdx.x + j * CL_THREADS;
    int ly, x;
    b.cell_at(c, ly, x);
    cell[j] = c < cells ? balance_cell_flags(g, H, W, b.y0 + ly - 1, x) : BalanceCell{0, 0, 0, 0u};
    rates[j] = balance_rates(x, p);
  }

  for (int i = threadIdx.x; i < (b.rows + 2) * W; i += CL_THREADS) {
    const int gi = b.gy(i / W, H) * W + i % W;
#pragma unroll
    for (int q = 0; q < 9; ++q) sm[q * PL + i] = h_in[q * HW + gi];
    Cs[i] = C_in[gi];
  }
  b.arm(cluster, bytes, bytes);

  for (int i = 0; i < n; ++i) {
    const float* cur = sm + (i & 1) * 9 * PL;
    const int nq = ((i & 1) ^ 1) * 9;  // first plane of the set step i writes
    float* const set = sm + nq * PL;
    mc_jitter(b.b, i, 0);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = threadIdx.x + j * CL_THREADS;
      if (c < cells) {
        int ly, x;
        b.cell_at(c, ly, x);
        const int y = b.y0 + ly - 1, li = ly * W + x;
        const int sy = cell[j].src / W, sx = cell[j].src % W;
        balance_cell_at(ClusterState{cur, nullptr, nullptr, PL, W, ly + sy - y, sx}, Cs, g,
                        cell[j], p, rates[j], sy, sx, set, Cs, li, PL);
        if (b.edge(ly)) {
#pragma unroll
          for (int q = 0; q < 9; ++q) b.push(ly, x, nq + q, q, set[q * PL + li], i & 1, i);
        }
      }
    }
    b.exchange(i & 1, (i >> 1) & 1, i > 0 ? (i - 1) & 1 : -1, bytes, i, PassPlanes{nq, 9, -1});
  }
  cluster.sync();  // no block leaves while its cluster still pushes into it

  const float* fin = sm + (n & 1) * 9 * PL;  // the set the last step wrote
  for (int c = threadIdx.x; c < cells; c += CL_THREADS) {
    const int li = c + W, gi = b.y0 * W + c;
#pragma unroll
    for (int q = 0; q < 9; ++q) h_out[q * HW + gi] = fin[q * PL + li];
    C_out[gi] = Cs[li];
  }
}

}  // namespace

// The opt-in shared memory and the clusters of 16, 8, 4, 2 and 1 blocks
// the card holds at once there (active[5]).
extern "C" int jrl_fused_balance_mc_limits(int* smem_optin, int* active) {
  return grid_limits(fused_balance_mc_kernel<1>, smem_optin, active);
}

extern "C" int jrl_fused_balance_mc_info(int cpt, int* regs, int* local_bytes) {
  const auto k = JRL_FUSED_PICK(fused_balance_mc_kernel, cpt);
  return k ? kernel_info(k, regs, local_bytes) : (int)cudaErrorInvalidValue;
}

// Clusters of `cluster` blocks the card holds at once at `smem` bytes a block.
extern "C" int jrl_fused_balance_mc_active(int cpt, int cluster, int smem, int* out) {
  const auto k = JRL_FUSED_PICK(fused_balance_mc_kernel, cpt);
  return k ? active_clusters(k, cluster, smem, out) : (int)cudaErrorInvalidValue;
}

extern "C" int jrl_fused_balance_mc(const int* flags, const float* h, const float* C,
                                    float* h_out, float* C_out, int n, const CBalanceParams* p,
                                    u64* box, int clusters, int cluster, int cpt, int smem,
                                    void* stream) {
  CBalanceParams pp = *p;
  void* args[] = {&flags, &h, &C, &h_out, &C_out, &n, &pp, &box};
  return launch_grid(JRL_FUSED_PICK(fused_balance_mc_kernel, cpt), pp.H, pp.W, PLANES, clusters,
                     cluster, cpt, smem, args, stream);
}
