// JRL concentration balance, n steps in one launch of one thread-block
// cluster that holds the whole state in the shared memory of its blocks:
// per step, streaming with the INFLOW / INFLOW_2 reservoirs and the OUTFLOW
// copy, C = sum h with OBSTACLE passthrough, BGK at u = 0 with the
// axisymmetric rate, then the exchange of the new h of the band's edge
// rows.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl.py::
// _make_balance_kernel (called by _fused_balance_run), for grids whose
// state fits one cluster at one cell per thread (kernels/fused_jrl.py::
// fused_route); other grids keep fused_balance.cu. Its plain twin is
// kernels/fused_jrl.py::fused_balance_ref; the per-cell code is
// jrl_c.cuh::balance_cell_at, read through cluster_state.cuh::ClusterState
// with its collision terms computed once (below), so the kernel equals
// fused_balance.cu bit for bit.
//
// Bound on the card: the state crosses device memory once per launch, so
// the bound is the ~230 float32 operations per cell and step, 132/16 times
// the card-wide figure on the 16 SMs of one cluster. Design: as
// fused_fluid_cl.cu, a band of rows per block with one halo row a side in
// shared memory for the whole launch, the edge rows' new h pushed by
// st.async into the neighbours' halo rows of the other set and counted on
// their mbarriers (one for even steps, one for odd). Window planes: h in
// two sets (the pulls read the neighbours' h while the new set is
// written), C in one (a cell reads only its own old C, at OBSTACLE cells):
// 19 planes. The fixed flags are decoded once per cell into registers, as
// fused_balance.cu does, and so are the collision terms that depend only on
// the column (jrl_c.cuh::balance_rates: the same float32 operations, done
// once instead of every step, which takes the cell's divisions, each a
// branch to its slow path, out of the step).
#include "cluster_state.cuh"
#include "fused_launch.cuh"
#include "jrl_c.cuh"

namespace {

using namespace jrl;
namespace cg = cooperative_groups;

constexpr int PLANES = 19;  // two sets of h, and C

template <int CPT>
__global__ void __launch_bounds__(CL_THREADS, 1) fused_balance_cl_kernel(
    const int* flags, const float* h_in, const float* C_in, float* h_out, float* C_out, int n,
    CBalanceParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float sm[];
  __shared__ uint64_t bars[2];  // the halo bytes of even and of odd steps
  const int H = p.H, W = p.W, HW = H * W;
  const Band b(cluster, sm, bars, H, W);
  const int PL = b.PL, cells = b.rows * W;
  const uint32_t bytes = b.bytes(9);
  float* const Cs = sm + 18 * PL;
  const BalanceGeo g{GlobalPlane{flags, W}};
  BalanceCell cell[CPT];
  BalanceRates rates[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int c = threadIdx.x + j * CL_THREADS;
    cell[j] = c < cells ? balance_cell_flags(g, H, W, b.y0 + c / W, c % W)
                        : BalanceCell{0, 0, 0, 0u};
    rates[j] = balance_rates(c % W, p);
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
    const int nxt = ((i & 1) ^ 1) * 9 * PL;  // offset of the set step i writes
    float* const set = sm + nxt;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = threadIdx.x + j * CL_THREADS;
      if (c < cells) {
        const int ly = c / W + 1, x = c % W, y = b.y0 + ly - 1, li = ly * W + x;
        const int sy = cell[j].src / W, sx = cell[j].src % W;
        balance_cell_at(ClusterState{cur, nullptr, nullptr, PL, W, ly + sy - y, sx}, Cs, g,
                        cell[j], p, rates[j], sy, sx, set, Cs, li, PL);
        if (b.edge(ly)) {
#pragma unroll
          for (int q = 0; q < 9; ++q) b.push(ly, x, nxt + q * PL, set[q * PL + li], i & 1);
        }
      }
    }
    b.exchange(i & 1, (i >> 1) & 1, i > 0 ? (i - 1) & 1 : -1, bytes);
  }
  cluster.sync();  // no block leaves while the cluster still runs

  const float* fin = sm + (n & 1) * 9 * PL;  // the set the last step wrote
  for (int c = threadIdx.x; c < cells; c += CL_THREADS) {
    const int li = c + W, gi = b.y0 * W + c;
#pragma unroll
    for (int q = 0; q < 9; ++q) h_out[q * HW + gi] = fin[q * PL + li];
    C_out[gi] = Cs[li];
  }
}

}  // namespace

extern "C" int jrl_fused_balance_cl_limits(int* smem_optin, int* cluster) {
  return cluster_limits(fused_balance_cl_kernel<1>, smem_optin, cluster);
}

extern "C" int jrl_fused_balance_cl_info(int cpt, int* regs, int* local_bytes) {
  const auto k = JRL_FUSED_PICK(fused_balance_cl_kernel, cpt);
  return k ? kernel_info(k, regs, local_bytes) : (int)cudaErrorInvalidValue;
}

extern "C" int jrl_fused_balance_cl(const int* flags, const float* h, const float* C,
                                    float* h_out, float* C_out, int n, const CBalanceParams* p,
                                    int cluster, int cpt, int smem, void* stream) {
  CBalanceParams pp = *p;
  void* args[] = {&flags, &h, &C, &h_out, &C_out, &n, &pp};
  return launch_cluster(JRL_FUSED_PICK(fused_balance_cl_kernel, cpt), pp.H, pp.W, PLANES,
                        cluster, cpt, smem, args, stream);
}
