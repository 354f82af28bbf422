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
// fused_route); larger grids take fused_approach_mc.cu or fused_approach.cu.
// Its plain twin is kernels/fused_jrl.py::fused_approach_ref; the cell code
// is jrl_c.cuh::approach_cell_at, read through cluster_state.cuh::
// ClusterState and jrl_c.cuh::WindowGeo, so h and C equal
// fused_approach.cu's bit for bit.
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
//
// The lanes instance (fused_approach_lanes_kernel) runs the approach of a
// Pe sweep's lanes in one launch, one cluster a lane: lane = cluster index.
// Each lane has its own h, h_out, C_out, CApproachParams (the tip speed v
// and the rates w_rate, c_tau; the wrapper gives every lane the same grid
// and tip), step count and segment table; the lanes share the base flags,
// the area row and one copy of the stored velocity frames. A lane's
// cluster runs its own steps and exits, and no cluster waits on another,
// so lanes beyond the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters) run as a later wave; no cooperative
// launch. The host cuts each lane's steps into segments where the serial
// runner ends a launch (at each record step of models/jrl.py::
// c_dump_steps, and within an interval every kernels/fused_jrl.py::
// steps_per_launch steps). At a segment's end the cluster reduces its
// terms as the single-lane kernel does after its last step (disk_reduce:
// the same rank order, the same tree), adds them into the lane's running
// sums as the serial runner adds a launch into acc, and zeroes the
// per-column terms; at a record step it writes the sums and the step's
// record velocities into the lane's row and zeroes the sums. So every row,
// h and C are bit for bit those of the serial fused_approach_cl launches
// (jrl_main.py::run_approach). Its plain twin is kernels/fused_jrl.py::
// fused_approach_lanes_ref. It has no Pallas kernel of its own to replace
// (JAX's sweep, parallel/sweep.py, vmaps the jnp step over the lanes): it
// is the card's counterpart of that vmap over _make_approach_kernel's
// work. Bound: each lane's ~335 operations a cell and step on the 16 SMs
// of its cluster, the lanes side by side on the card's 132.
#include "cluster_state.cuh"
#include "fused_launch.cuh"
#include "jrl_c.cuh"

namespace {

using namespace jrl;
namespace cg = cooperative_groups;

constexpr int PLANES = 22;  // two sets of h, two of C, phi, the codes

// The per-lane tables of the lanes instance (all in device memory).
struct LaneTables {
  const CApproachParams* p;  // [L]
  const int* n;              // [L] steps of each lane
  const int* segs;           // [L, S, 2]: a segment's end (its last step + 1) and its
                             // record row, or -1; padded with (-1, -1)
  int S;
  float* rows;  // [L, R, 4]: inflow sum, current sum, rec_u, rec_v of each record
  int R;
};

// The integrals of the steps since the last reduction: every block's terms
// summed per column in rank order through distributed shared memory, the
// columns reduced in fused_approach.cu's fixed tree, with the record
// velocities of step `last`, into block 0's red[k][0] (k < 4). Every thread
// of every block calls it; the caller syncs the cluster again before any
// block writes `part` anew or leaves.
template <class Cluster>
__device__ __forceinline__ void disk_reduce(const Cluster& cluster, float (&part)[2][CL_THREADS],
                                            float (&red)[4][FUSED_BLOCK], float s_in,
                                            float s_cur, const int* base, const float* frames,
                                            int n_frames, const float* area, int last,
                                            const CApproachParams& p) {
  const int tid = threadIdx.x;
  part[0][tid] = s_in;
  part[1][tid] = s_cur;
  cluster.sync();  // every block's terms visible to block 0
  if (cluster.block_rank() == 0) {
    int bf;
    const auto g =
        approach_geo(base, frame_vel(frames, n_frames, 0, p.H * p.W, last, p.v, bf), last, p);
    const int r_cur = disk_row(g.walks_int + 1, p.H);
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
  }
}

// n approach steps from `start` on one cluster. One lane (LANES false):
// one reduction after the last step, into acc. Lanes: a reduction at the
// end of each segment of lane `lane`'s table, into its rows.
template <int CPT, bool LANES>
__device__ __forceinline__ void approach_cl_run(const int* base, const float* frames,
                                                int n_frames, const float* area,
                                                const float* h_in, float* h_out, float* C_out,
                                                float* acc, int start, int n,
                                                const CApproachParams& p, const LaneTables& lt,
                                                int lane) {
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
  // lanes: the segment being run, its end, and the lane's running sums
  // (kept by block 0's thread 0)
  const int* const segs = LANES ? lt.segs + (size_t)lane * lt.S * 2 : nullptr;
  int seg = 0, seg_end = LANES ? segs[0] : -1;
  float r_in = 0.0f, r_cur = 0.0f;
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

    if (LANES && step + 1 == seg_end) {  // uniform over the cluster
      disk_reduce(cluster, part, red, s_in, s_cur, base, frames, n_frames, area, step, p);
      const int row = segs[2 * seg + 1];
      if (cluster.block_rank() == 0 && tid == 0) {
        r_in = r_in + red[0][0];  // as the serial runner's acc[0] += one launch's sum
        r_cur = r_cur + red[1][0];
        if (row >= 0) {
          float* const out = lt.rows + ((size_t)lane * lt.R + row) * 4;
          out[0] = r_in;
          out[1] = r_cur;
          out[2] = red[2][0];
          out[3] = red[3][0];
          r_in = 0.0f;
          r_cur = 0.0f;
        }
      }
      cluster.sync();  // no block writes its terms anew while block 0 reads them
      s_in = 0.0f;
      s_cur = 0.0f;
      ++seg;
      seg_end = seg < lt.S ? segs[2 * seg] : -1;
    }
  }

  if (!LANES) {
    disk_reduce(cluster, part, red, s_in, s_cur, base, frames, n_frames, area, start + n - 1,
                p);
    if (cluster.block_rank() == 0 && tid == 0) {
      acc[0] = acc[0] + red[0][0];
      acc[1] = acc[1] + red[1][0];
      acc[2] = red[2][0];
      acc[3] = red[3][0];
    }
    cluster.sync();  // no block leaves while block 0 reads its terms
  }

  const float* fin = sm + (n & 1) * 9 * PL;            // the h set the last step wrote
  const float* Cfin = sm + (18 + ((n - 1) & 1)) * PL;  // and its C
  for (int c = tid; c < cells; c += CL_THREADS) {
    const int li = c + W, gi = b.y0 * W + c;
#pragma unroll
    for (int q = 0; q < 9; ++q) h_out[q * HW + gi] = fin[q * PL + li];
    C_out[gi] = Cfin[li];
  }
}

template <int CPT>
__global__ void __launch_bounds__(CL_THREADS, 1) fused_approach_cl_kernel(
    const int* base, const float* frames, int n_frames, const float* area, const float* h_in,
    float* h_out, float* C_out, float* acc, int start, int n, CApproachParams p) {
  approach_cl_run<CPT, false>(base, frames, n_frames, area, h_in, h_out, C_out, acc, start, n,
                              p, LaneTables{}, 0);
}

// One cluster a lane, lane = cluster index; one cell a thread.
__global__ void __launch_bounds__(CL_THREADS, 1) fused_approach_lanes_kernel(
    const int* base, const float* frames, int n_frames, const float* area, const float* h_in,
    float* h_out, float* C_out, int start, LaneTables lt) {
  const int lane = (int)(blockIdx.x / cg::this_cluster().num_blocks());
  const CApproachParams p = lt.p[lane];
  const size_t HW = (size_t)p.H * p.W;
  approach_cl_run<1, true>(base, frames, n_frames, area, h_in + lane * 9 * HW,
                           h_out + lane * 9 * HW, C_out + lane * HW, nullptr, start, lt.n[lane],
                           p, lt, lane);
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

// Clusters of the lanes instance the card holds at once at `smem` bytes a
// block, and its registers and local bytes a thread.
extern "C" int jrl_fused_approach_lanes_limits(int smem, int cluster, int* active, int* regs,
                                               int* local_bytes) {
  const int e = active_clusters(fused_approach_lanes_kernel, cluster, smem, active);
  return e ? e : kernel_info(fused_approach_lanes_kernel, regs, local_bytes);
}

// `lanes` lanes of n[l] steps each from `start`, one cluster a lane: `p`,
// `n`, `segs` ([lanes, S, 2]) and `rows` ([lanes, R, 4]) are the lane tables
// in device memory, `p0` lane 0's CApproachParams in host memory (the grid
// and the tip disk every lane shares).
extern "C" int jrl_fused_approach_lanes(const int* base, const float* frames, int n_frames,
                                        const float* area, const float* h, float* h_out,
                                        float* C_out, int start, const CApproachParams* p,
                                        const int* n, const int* segs, int S, float* rows, int R,
                                        int lanes, const CApproachParams* p0, int cluster,
                                        int smem, void* stream) {
  if (lanes < 1 || S < 1 || R < 1 || p0->rint > FUSED_BLOCK || p0->rint + 1 > p0->W)
    return (int)cudaErrorInvalidValue;
  LaneTables lt{p, n, segs, S, rows, R};
  void* args[] = {&base, &frames, &n_frames, &area, &h, &h_out, &C_out, &start, &lt};
  return launch_cluster(fused_approach_lanes_kernel, p0->H, p0->W, PLANES, cluster, 1, smem,
                        args, stream, lanes);
}
