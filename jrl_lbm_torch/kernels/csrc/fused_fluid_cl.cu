// JRL fluid phase, n steps in one launch of one thread-block cluster that
// holds the whole state in the shared memory of its blocks: per step, step
// A (pull-streaming, the moving-tip coupling, moments), the exchange of the
// new rho and vel of the band's edge rows, step B (BGK with the
// LINE_X_EQ_0 axisymmetric source) in place, the exchange of the new f.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl.py::
// _make_jrl_fluid_kernel (called by _fused_fluid_run), for grids whose
// state fits one cluster at one cell per thread (kernels/fused_jrl.py::
// fused_route); other grids keep fused_fluid.cu. Its plain twin is
// kernels/fused_jrl.py::fused_fluid_ref; the per-cell code is
// jrl_fluid.cuh's, unchanged, read through cluster_state.cuh::ClusterState,
// so the kernel equals fused_fluid.cu bit for bit.
//
// Bound on the card: the state crosses device memory once per launch, so
// the bound is the ~650 float32 operations per cell and step; on the 16
// SMs of one cluster that is 132/16 times the card-wide figure (~0.65 us a
// step at 128x64). Design: the Pallas kernel keeps the domain in VMEM for
// the whole launch; here a cluster of 16 blocks (8 where the card holds no
// cluster of 16) keeps it in shared memory, each block a band of rows with
// one halo row a side (cluster_state.cuh), so every read of a step is a
// shared-memory load, and the halo rows arrive by st.async counted on
// mbarriers instead of a grid barrier and a trip through L2. Window planes:
// f and vel in two sets (A pulls its neighbours' f and reads their vel for
// the coupling while writing the new set), rho in one (A reads only its own
// cell's, B the new values): 23 planes. A pushes rho and vel into the other
// set's halo rows (read by B), B pushes f (read by the next A). What is
// left is the cell code's latency: one warp runs each cell's A and B as
// one long dependent chain, an IEEE division (a branch to its slow path)
// in most links, and 16 warps an SM hide little of it.
#include "cluster_state.cuh"
#include "fused_launch.cuh"
#include "jrl_fluid.cuh"

namespace {

using namespace jrl;
namespace cg = cooperative_groups;

constexpr int SET = 11;     // planes of a set: f 0-8, u 9, v 10
constexpr int PLANES = 23;  // two sets and rho

template <int CPT>
__global__ void __launch_bounds__(CL_THREADS, 1) fused_fluid_cl_kernel(
    const float* f_in, const float* rho_in, const float* vel_in, float* f_out, float* rho_out,
    float* vel_out, int start, int n, FluidParams pa, FluidBParams pb) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float sm[];
  __shared__ uint64_t bars[2];  // the halo bytes of A (rho, vel) and of B (f)
  const int H = pa.H, W = pa.W, HW = H * W;
  const Band b(cluster, sm, bars, H, W);
  const int PL = b.PL, cells = b.rows * W, RHO = 2 * SET * PL;
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
    const int nxt = ((i & 1) ^ 1) * SET * PL;  // offset of the set step i writes
    float* const set = sm + nxt;
    const FluidGeo g = fluid_geo(start + i, pa);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = threadIdx.x + j * CL_THREADS;
      if (c < cells) {
        const int ly = c / W + 1, x = c % W, y = b.y0 + ly - 1, li = ly * W + x;
        float fo[9], r, u, v;
        fluid_a_cell(ClusterState{cur, rho, cur + 9 * PL, PL, W, ly, x}, g, pa.cs2tau, y, x, fo,
                     r, u, v);
#pragma unroll
        for (int q = 0; q < 9; ++q) set[q * PL + li] = fo[q];
        set[9 * PL + li] = u;
        set[10 * PL + li] = v;
        rho[li] = r;
        if (b.edge(ly)) {
          b.push(ly, x, nxt + 9 * PL, u, 0);
          b.push(ly, x, nxt + 10 * PL, v, 0);
          b.push(ly, x, RHO, r, 0);
        }
      }
    }
    b.exchange(0, i & 1, i > 0 ? 1 : -1, bytes_b);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = threadIdx.x + j * CL_THREADS;
      if (c < cells) {
        const int ly = c / W + 1, x = c % W, y = b.y0 + ly - 1, li = ly * W + x;
        float fo[9];
        fluid_b_cell(ClusterState{set, rho, set + 9 * PL, PL, W, ly, x}, g, pb, y, x, fo);
#pragma unroll
        for (int q = 0; q < 9; ++q) set[q * PL + li] = fo[q];
        if (b.edge(ly)) {
#pragma unroll
          for (int q = 0; q < 9; ++q) b.push(ly, x, nxt + q * PL, fo[q], 1);
        }
      }
    }
    b.exchange(1, i & 1, 0, bytes_a);
  }
  cluster.sync();  // no block leaves while the cluster still runs

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

extern "C" int jrl_fused_fluid_cl_limits(int* smem_optin, int* cluster) {
  return cluster_limits(fused_fluid_cl_kernel<1>, smem_optin, cluster);
}

extern "C" int jrl_fused_fluid_cl_info(int cpt, int* regs, int* local_bytes) {
  const auto k = JRL_FUSED_PICK(fused_fluid_cl_kernel, cpt);
  return k ? kernel_info(k, regs, local_bytes) : (int)cudaErrorInvalidValue;
}

extern "C" int jrl_fused_fluid_cl(const float* f, const float* rho, const float* vel,
                                  float* f_out, float* rho_out, float* vel_out, int start, int n,
                                  const FluidParams* pa, const FluidBParams* pb, int cluster,
                                  int cpt, int smem, void* stream) {
  FluidParams a = *pa;
  FluidBParams b = *pb;
  void* args[] = {&f, &rho, &vel, &f_out, &rho_out, &vel_out, &start, &n, &a, &b};
  return launch_cluster(JRL_FUSED_PICK(fused_fluid_cl_kernel, cpt), a.H, a.W, PLANES, cluster,
                        cpt, smem, args, stream);
}
