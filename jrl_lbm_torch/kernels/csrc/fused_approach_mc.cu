// JRL concentration approach, n steps in one launch of N thread-block
// clusters that hold the whole state in the shared memory of every block of
// the launch: per step, the moving tip (strict phi < 0 for the wedge, a
// rectangle for flat tips, INFLOW sink on the head row), the stored fluid
// velocity interpolated between its two frames, streaming with sub-grid
// bounce, C = sum h (clamped for flat tips), BGK with the axisymmetric rate
// and convection source, the exchange of the new h and C of each band's
// edge rows, then the step's tip-disk inflow and current terms. After the
// last step: one reduction of the integrals over every cluster into acc,
// with the last step's record velocities.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl.py::
// _make_approach_kernel (called by _fused_approach_seg) for grids over one
// cluster and up to 131,072 cells (256x128 and 512x256, refine 2 and 4 of
// the default case; kernels/fused_jrl.py::fused_route takes it where it
// beats fused_approach.cu, which ran those grids before). Its plain twin is
// kernels/fused_jrl.py::fused_approach_ref; the cell code is jrl_c.cuh::
// approach_cell_at, read through cluster_state.cuh::ClusterState and
// jrl_c.cuh::WindowGeo, so h and C equal fused_approach.cu's bit for bit.
//
// Bound on the card: the state and the frames the run visits cross device
// memory once a launch, so the bound is the ~335 float32 operations per
// cell and step (~0.16 us a step at 256x128 card-wide). What held
// fused_approach.cu back, and what this design does, as fused_approach_cl.cu
// does on one cluster, spread over every cluster as fused_balance_mc.cu
// spreads fused_balance_cl.cu (cluster_grid.cuh):
// - a grid.sync() a step: a band of rows per block of every SM with one
//   halo row a side in shared memory for the whole launch; the edge rows'
//   new h and C are pushed by st.async into the neighbours' halo rows
//   inside a cluster and through mailbox rows between clusters (10 planes:
//   the flat tip's flux terms read C one row beyond the disk rows, which
//   can be a halo row from another cluster), one mbarrier for even steps
//   and one for odd;
// - h and C in device memory (L2) between steps: window planes of h in two
//   sets, C in two sets (the disk terms of a step read the new C while the
//   neighbours may already write the next), phi and the flag codes: 22
//   planes; the old C is never read, so only C_out is written;
// - the tip SDF evaluated about ten times a cell: flag and phi of every
//   window cell once a step (jrl_c.cuh::WindowGeo), the next step's filled
//   after the halo rows from other clusters were taken and while those from
//   inside the cluster are in flight;
// - the frame pair in registers, reloaded only when the frame index changes.
// The integrals: the block whose band holds row walks_int adds the step's
// disk terms of every column x < rint into its registers (the flat flux
// form reads one row below and one above, inside the band and its halo
// rows). At the end each cluster's rank 0 sums its blocks' terms per column
// in rank order through distributed shared memory and writes them into a
// table in device memory; the last cluster to finish (a __threadfence() and
// an atomic ticket, which it resets) sums the table in cluster order and
// reduces the columns in fused_approach.cu's fixed tree. No float atomics,
// so runs repeat bit for bit, and where one block held the disk rows for
// the whole launch the sums are fused_approach.cu's bit for bit.
#include "cluster_grid.cuh"
#include "fused_launch.cuh"
#include "jrl_c.cuh"

namespace {

using namespace jrl;
namespace cg = cooperative_groups;

constexpr int PLANES = 22;      // two sets of h, two of C, phi, the codes
constexpr int ROW_PLANES = 10;  // mailbox rows a slot: a pass sends h and C

// The table (kernels/fused_jrl.py allocates it beside the mailbox): words
// [n][2][FUSED_BLOCK] hold cluster n's inflow and current terms per column.
template <int CPT>
__global__ void __launch_bounds__(CL_THREADS, 1) fused_approach_mc_kernel(
    const int* base, const float* frames, int n_frames, const float* area, const float* h_in,
    float* h_out, float* C_out, float* acc, int start, int n, CApproachParams p, u64* box,
    float* table, unsigned* ticket) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float sm[];
  __shared__ uint64_t bars[2];  // the halo bytes of even and of odd steps
  __shared__ float part[2][CL_THREADS];
  __shared__ float red[4][FUSED_BLOCK];
  __shared__ unsigned last;  // this cluster finished last
  const int H = p.H, W = p.W, HW = H * W, tid = threadIdx.x;
  const GridBand b(cluster, sm, bars, H, W, box, ROW_PLANES);
  const int PL = b.PL, cells = b.rows * W, ybase = b.gy(0, H);
  const uint32_t bytes = b.bytes(ROW_PLANES);
  float* const phis = sm + 20 * PL;
  int* const codes = reinterpret_cast<int*>(sm + 21 * PL);
  const bool flat = p.flat != 0;

  for (int i = tid; i < (b.rows + 2) * W; i += CL_THREADS) {
    const int gi = b.gy(i / W, H) * W + i % W;
#pragma unroll
    for (int q = 0; q < 9; ++q) sm[q * PL + i] = h_in[q * HW + gi];
  }
  b.arm(cluster, bytes, bytes);

  float u0[CPT], v0[CPT], u1[CPT], v1[CPT];  // this thread's cells in frames bf, bf + 1
  int b_held = -1;
  float s_in = 0.0f, s_cur = 0.0f;  // column tid's terms of the steps this band held
  // the geometry of step `step` into the window planes
  auto fill = [&](int step) {
    int bf;
    const auto g0 = approach_geo(base, frame_vel(frames, n_frames, 0, HW, step, p.v, bf), step, p);
    fill_window_geo(g0, ybase, b.rows + 2, codes, phis, tid, CL_THREADS);
  };
  fill(start);
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    const int step = start + i;
    int bf;
    const FrameVel fv = frame_vel(frames, n_frames, 0, HW, step, p.v, bf);
    if (bf != b_held) {  // uniform over the launch: bf depends on the step only
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tid + j * CL_THREADS;
        if (c < cells) {
          int ly, x;
          b.cell_at(c, ly, x);
          const int gi = (b.y0 + ly - 1) * W + x;
          u0[j] = fv.f0[gi];
          v0[j] = fv.f0[HW + gi];
          u1[j] = fv.f1[gi];
          v1[j] = fv.f1[HW + gi];
        }
      }
      b_held = bf;
    }
    const auto g0 = approach_geo(base, fv, step, p);
    const auto g = window_geo(g0, ybase, codes, phis);

    const float* cur = sm + (i & 1) * 9 * PL;
    const int nq = ((i & 1) ^ 1) * 9;  // first plane of the h set step i writes
    const int cq = 18 + (i & 1);       // and its C plane
    float* const hs = sm + nq * PL;
    float* const Cs = sm + cq * PL;
    mc_jitter(b.b, i, 0);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tid + j * CL_THREADS;
      if (c < cells) {
        int ly, x;
        b.cell_at(c, ly, x);
        const int y = b.y0 + ly - 1, li = ly * W + x;
        approach_cell_at(ClusterState{cur, nullptr, nullptr, PL, W, ly, x}, g, p, y, x,
                         fv.at(u0[j], u1[j]), fv.at(v0[j], v1[j]), hs, Cs, li, PL);
        if (b.edge(ly)) {
#pragma unroll
          for (int q = 0; q < 9; ++q) b.push(ly, x, nq + q, q, hs[q * PL + li], i & 1, i);
          b.push(ly, x, cq, 9, Cs[li], i & 1, i);
        }
      }
    }
    // the exchange, with the next step's geometry filled once every thread
    // is past this step's cells (the fill reads no halo row)
    b.finish(i > 0 ? (i - 1) & 1 : -1, bytes, i, PassPlanes{nq, 9, cq});
    if (i + 1 < n) fill(step + 1);
    b.wait(i & 1, (i >> 1) & 1);

    // the disk terms, in the block whose band holds row walks_int; the
    // window row of global row r is r - y0 + 1
    const int rin = disk_row(g0.walks_int, H);
    if (rin >= b.y0 && rin < b.y0 + b.rows && tid < p.rint) {
      float t_in, t_cur;
      disk_terms(Cs - (b.y0 - 1) * W, H, W, g0.walks_int, flat, tid, area[tid], t_in, t_cur);
      s_in = s_in + t_in;
      s_cur = s_cur + t_cur;
    }
    __syncthreads();  // the next step's geometry visible to every thread
  }

  // the cluster's terms per column, its blocks in rank order, into the table
  part[0][tid] = s_in;
  part[1][tid] = s_cur;
  cluster.sync();  // every block's terms visible to rank 0; no pushes in flight
  const int N = (int)(gridDim.x / cluster.num_blocks());
  if (cluster.block_rank() == 0) {
    const int nc = (int)blockIdx.x / (int)cluster.num_blocks();
    if (tid < p.rint) {
      float a = 0.0f, c = 0.0f;
      for (unsigned r = 0; r < cluster.num_blocks(); ++r) {
        a = a + *cluster.map_shared_rank(&part[0][tid], r);
        c = c + *cluster.map_shared_rank(&part[1][tid], r);
      }
      table[(2 * nc + 0) * FUSED_BLOCK + tid] = a;
      table[(2 * nc + 1) * FUSED_BLOCK + tid] = c;
      __threadfence();
    }
    __syncthreads();
    if (tid == 0) last = atomicAdd(ticket, 1u) == (unsigned)(N - 1);
    __syncthreads();
  }
  cluster.sync();  // no block leaves while rank 0 reads its terms

  const float* fin = sm + (n & 1) * 9 * PL;            // the h set the last step wrote
  const float* Cfin = sm + (18 + ((n - 1) & 1)) * PL;  // and its C
  for (int c = tid; c < cells; c += CL_THREADS) {
    const int li = c + W, gi = b.y0 * W + c;
#pragma unroll
    for (int q = 0; q < 9; ++q) h_out[q * HW + gi] = fin[q * PL + li];
    C_out[gi] = Cfin[li];
  }

  // the last cluster: the table in cluster order, the columns in the tree
  if (cluster.block_rank() != 0 || !last) return;
  __threadfence();
  const int step = start + n - 1;
  int bf;
  const auto g = approach_geo(base, frame_vel(frames, n_frames, 0, HW, step, p.v, bf), step, p);
  const int r_cur = disk_row(g.walks_int + 1, H);
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (tid < p.rint) {
    for (int m = 0; m < N; ++m) {
      s[0] = s[0] + __ldcg(table + (2 * m + 0) * FUSED_BLOCK + tid);
      s[1] = s[1] + __ldcg(table + (2 * m + 1) * FUSED_BLOCK + tid);
    }
    s[2] = g.cu(r_cur, tid) * area[tid];
    s[3] = g.cv(r_cur, tid) * area[tid];
  }
  block_sum4(red, s);
  if (tid == 0) {
    acc[0] = acc[0] + red[0][0];
    acc[1] = acc[1] + red[1][0];
    acc[2] = red[2][0];
    acc[3] = red[3][0];
    *ticket = 0u;
  }
}

}  // namespace

// The opt-in shared memory and the clusters of 16, 8, 4, 2 and 1 blocks
// the card holds at once there (active[5]).
extern "C" int jrl_fused_approach_mc_limits(int* smem_optin, int* active) {
  return grid_limits(fused_approach_mc_kernel<1>, smem_optin, active);
}

extern "C" int jrl_fused_approach_mc_info(int cpt, int* regs, int* local_bytes) {
  const auto k = JRL_FUSED_PICK(fused_approach_mc_kernel, cpt);
  return k ? kernel_info(k, regs, local_bytes) : (int)cudaErrorInvalidValue;
}

// Clusters of `cluster` blocks the card holds at once at `smem` bytes a block.
extern "C" int jrl_fused_approach_mc_active(int cpt, int cluster, int smem, int* out) {
  const auto k = JRL_FUSED_PICK(fused_approach_mc_kernel, cpt);
  return k ? active_clusters(k, cluster, smem, out) : (int)cudaErrorInvalidValue;
}

// `box`: the zeroed mailbox; `table`: [clusters][2][FUSED_BLOCK] floats;
// `ticket`: zero, and zero again after the launch.
extern "C" int jrl_fused_approach_mc(const int* base, const float* frames, int n_frames,
                                     const float* area, const float* h, float* h_out,
                                     float* C_out, float* acc, int start, int n,
                                     const CApproachParams* p, u64* box, float* table,
                                     unsigned* ticket, int clusters, int cluster, int cpt,
                                     int smem, void* stream) {
  if (n < 1 || p->rint > FUSED_BLOCK || p->rint + 1 > p->W) return (int)cudaErrorInvalidValue;
  CApproachParams pp = *p;
  void* args[] = {&base, &frames, &n_frames, &area, &h,     &h_out, &C_out,
                  &acc,  &start,  &n,        &pp,   &box,   &table, &ticket};
  return launch_grid(JRL_FUSED_PICK(fused_approach_mc_kernel, cpt), pp.H, pp.W, PLANES, clusters,
                     cluster, cpt, smem, args, stream);
}
