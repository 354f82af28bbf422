// JRL concentration approach, n steps in one launch of one thread-block
// cluster that holds the whole state in the shared memory of its blocks:
// per step, the moving tip (strict phi < 0 for the wedge, a rectangle for
// flat tips, INFLOW sink on the head row), the stored fluid velocity
// interpolated between its two frames, streaming with sub-grid bounce,
// C = sum h (clamped for flat tips), BGK with the axisymmetric rate and
// convection source, the exchange of the band's edge rows, then the step's
// tip-disk inflow and current terms. After the last step: the last step's
// record velocities and one reduction of the integrals into acc.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl.py::
// _make_approach_kernel (called by _fused_approach_seg), for grids whose
// state fits one cluster at one cell per thread (kernels/fused_jrl.py::
// fused_route); other grids keep fused_approach.cu. Its plain twin is
// kernels/fused_jrl.py::fused_approach_ref; the cell code is jrl_c.cuh::
// approach_cell_at, read through cluster_state.cuh::ClusterState and
// jrl_c.cuh::WindowGeo, so h and C equal fused_approach.cu's bit for bit.
//
// Bound on the card: the state and the frames the run visits cross device
// memory once a launch, so the bound is the ~335 float32 operations per
// cell and step, 132/16 times the card-wide figure on the 16 SMs of one
// cluster. What held fused_approach.cu back, and what this design does:
// - a grid.sync() a step over a cooperative grid: as fused_balance_cl.cu,
//   a band of rows per block with one halo row a side in shared memory for
//   the whole launch; the edge rows' new h and C are pushed by st.async
//   into the neighbours' halo rows and counted on their mbarriers (one for
//   even steps, one for odd), with no cluster-wide barrier in the step loop;
// - h and C in device memory (L2) between steps: window planes of h in two
//   sets (the pulls read the neighbours' h while the new set is written), C
//   in two sets (the disk terms of a step read the new C while the
//   neighbours may already write the next), phi and the flag codes: 22
//   planes; the old C is never read (the cell code zeroes C in the tip
//   and keeps it only at OBSTACLE cells), so only C_out is written;
// - the tip SDF evaluated about ten times a cell: flag and phi of every
//   window cell once a step into shared memory (jrl_c.cuh::WindowGeo),
//   the next step's filled while this step's halo rows are in flight;
// - the frame pair in registers, reloaded only when the frame index
//   changes, as fused_approach.cu does.
// The disk terms follow the disk rows from band to band: the block whose
// band holds row walks_int computes both terms of every column x < rint
// from its window (the flat flux form reads one row below and one above,
// inside the band and its halo rows) and adds them into its registers. At
// the end block 0 sums each column's terms over the blocks in rank order
// through distributed shared memory and reduces the columns in
// fused_approach.cu's fixed tree; no atomics, so runs repeat bit for bit,
// and where one block held the disk rows for the whole launch the sums are
// fused_approach.cu's bit for bit.
#include "cluster_state.cuh"
#include "fused_launch.cuh"
#include "jrl_c.cuh"

namespace {

using namespace jrl;
namespace cg = cooperative_groups;

constexpr int PLANES = 22;  // two sets of h, two of C, phi, the codes

template <int CPT>
__global__ void __launch_bounds__(CL_THREADS, 1) fused_approach_cl_kernel(
    const int* base, const float* frames, int n_frames, const float* area, const float* h_in,
    float* h_out, float* C_out, float* acc, int start, int n, CApproachParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float sm[];
  __shared__ uint64_t bars[2];  // the halo bytes of even and of odd steps
  __shared__ float part[2][CL_THREADS];
  __shared__ float red[4][FUSED_BLOCK];
  const int H = p.H, W = p.W, HW = H * W, tid = threadIdx.x;
  const Band b(cluster, sm, bars, H, W);
  const int PL = b.PL, cells = b.rows * W, ybase = b.gy(0, H);
  const uint32_t bytes = b.bytes(10);
  float* const phis = sm + 20 * PL;
  int* const codes = reinterpret_cast<int*>(sm + 21 * PL);
  const bool flat = p.flat != 0;

  for (int i = tid; i < (b.rows + 2) * W; i += CL_THREADS) {
    const int gi = b.gy(i / W, H) * W + i % W;
#pragma unroll
    for (int q = 0; q < 9; ++q) sm[q * PL + i] = h_in[q * HW + gi];
  }
  b.arm(cluster, bytes, bytes);

  float u0[CPT], v0[CPT], u1[CPT], v1[CPT];  // this thread's cells in frames b, b + 1
  int b_held = -1;
  float s_in = 0.0f, s_cur = 0.0f;  // column tid's terms of the steps this band held
  // the geometry of step `step` into the window planes
  auto fill = [&](int step) {
    int bf;
    const auto g0 = approach_geo(base, frame_vel(frames, n_frames, 0, HW, step, p.v, bf), step, p);
    fill_window_geo(g0, ybase, b.rows + 2, codes, phis, tid, CL_THREADS);
  };
  if (n >= 1) fill(start);
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    const int step = start + i;
    int bf;
    const FrameVel fv = frame_vel(frames, n_frames, 0, HW, step, p.v, bf);
    if (bf != b_held) {  // uniform over the cluster: bf depends on the step only
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tid + j * CL_THREADS, gi = b.y0 * W + c;
        if (c < cells) {
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
    const int nxt = ((i & 1) ^ 1) * 9 * PL;  // offset of the h set step i writes
    const int cset = (18 + (i & 1)) * PL;     // offset of the C set step i writes
    float* const hs = sm + nxt;
    float* const Cs = sm + cset;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tid + j * CL_THREADS;
      if (c < cells) {
        const int ly = c / W + 1, x = c % W, y = b.y0 + ly - 1, li = ly * W + x;
        approach_cell_at(ClusterState{cur, nullptr, nullptr, PL, W, ly, x}, g, p, y, x,
                         fv.at(u0[j], u1[j]), fv.at(v0[j], v1[j]), hs, Cs, li, PL);
        if (b.edge(ly)) {
#pragma unroll
          for (int q = 0; q < 9; ++q) b.push(ly, x, nxt + q * PL, hs[q * PL + li], i & 1);
          b.push(ly, x, cset, Cs[li], i & 1);
        }
      }
    }
    // the exchange, with the next step's geometry filled while the halo
    // rows are in flight (every thread is past this step's cells)
    b.finish(i > 0 ? (i - 1) & 1 : -1, bytes);
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

  part[0][tid] = s_in;
  part[1][tid] = s_cur;
  cluster.sync();  // every block's terms visible to block 0
  if (cluster.block_rank() == 0 && n >= 1) {
    int bf;
    const int last = start + n - 1;
    const auto g = approach_geo(base, frame_vel(frames, n_frames, 0, HW, last, p.v, bf), last, p);
    const int r_cur = disk_row(g.walks_int + 1, H);
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (tid < p.rint) {
      for (unsigned r = 0; r < cluster.num_blocks(); ++r) {
        s[0] = s[0] + *cluster.map_shared_rank(&part[0][tid], r);
        s[1] = s[1] + *cluster.map_shared_rank(&part[1][tid], r);
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
    }
  }
  cluster.sync();  // no block leaves while block 0 reads its terms

  const float* fin = sm + (n & 1) * 9 * PL;         // the h set the last step wrote
  const float* Cfin = sm + (18 + ((n - 1) & 1)) * PL;  // and its C
  for (int c = tid; c < cells; c += CL_THREADS) {
    const int li = c + W, gi = b.y0 * W + c;
#pragma unroll
    for (int q = 0; q < 9; ++q) h_out[q * HW + gi] = fin[q * PL + li];
    C_out[gi] = Cfin[li];
  }
}

}  // namespace

extern "C" int jrl_fused_approach_cl_limits(int* smem_optin, int* cluster) {
  return cluster_limits(fused_approach_cl_kernel<1>, smem_optin, cluster);
}

extern "C" int jrl_fused_approach_cl_info(int cpt, int* regs, int* local_bytes) {
  const auto k = JRL_FUSED_PICK(fused_approach_cl_kernel, cpt);
  return k ? kernel_info(k, regs, local_bytes) : (int)cudaErrorInvalidValue;
}

extern "C" int jrl_fused_approach_cl(const int* base, const float* frames, int n_frames,
                                     const float* area, const float* h, float* h_out,
                                     float* C_out, float* acc, int start, int n,
                                     const CApproachParams* p, int cluster, int cpt, int smem,
                                     void* stream) {
  if (n < 1 || p->rint > FUSED_BLOCK || p->rint + 1 > p->W) return (int)cudaErrorInvalidValue;
  CApproachParams pp = *p;
  void* args[] = {&base, &frames, &n_frames, &area, &h, &h_out, &C_out, &acc, &start, &n, &pp};
  return launch_cluster(JRL_FUSED_PICK(fused_approach_cl_kernel, cpt), pp.H, pp.W, PLANES,
                        cluster, cpt, smem, args, stream);
}
