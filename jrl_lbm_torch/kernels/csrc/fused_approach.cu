// JRL concentration approach, n steps in one launch: per step, the moving
// tip (strict phi < 0 for the wedge, a rectangle for flat tips, INFLOW
// sink on the head row), the stored fluid velocity interpolated between
// its two frames, streaming with sub-grid bounce, C = sum h (clamped for
// flat tips), BGK with the axisymmetric rate and convection source, a
// grid-wide barrier, then the step's tip-disk inflow and current terms.
// After the last step: the last step's record velocities (rec_u, rec_v)
// and one reduction of the integrals into acc.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl.py::
// _make_approach_kernel (called by _fused_approach_seg). Since the row
// kernel fused_approach_rw.cu took 512x256 (fused_jrl.py::ROWS_MIN_CELLS),
// no grid of the default case reaches this kernel: it stays the approach
// kernels' yardstick (route="coop") and the route of grids that one cluster
// does not hold at one cell a thread, whose multi-cluster plan needs two
// cells a thread or more and that the rows do not take (rows that are not
// 16-byte multiples, runs over the card's SMs). Its plain twin is
// jrl_lbm_torch/kernels/fused_jrl.py::fused_approach_ref, the loop of
// c_approach_ref on models/jrl.py::stored_velocity; the per-cell code is
// jrl_c.cuh's, shared with c_approach.cu.
//
// Bound on the card: at 128x64 the state (h, C, base flags) and the frames
// the run visits cross device memory once per launch, so the bound is the
// ~330 float32 operations per cell and step; the grid barrier a step
// costs far more. Design: the Pallas kernel holds a window of K frames in
// VMEM and splits calls at its edges; here the whole stored velocity
// [N, 2, H, W] stays in device memory. The frame index is monotone in the
// step, so each thread loads its cells' frame pair into registers when the
// index changes, and only then (the Pallas kernel's interval loop); index
// and weight come from the float32 arithmetic of stored_velocity
// (jrl_c.cuh::frame_vel, shared with the other approach kernels). The
// integrals: threads x < rint of block 0 add the step's disk terms into
// registers after each barrier (the step's C is not overwritten before
// the next barrier), and reduce once at the end in a fixed tree order, no
// atomics, so runs repeat bit for bit.
#include "fused_launch.cuh"
#include "jrl_c.cuh"

namespace {

using namespace jrl;
namespace cg = cooperative_groups;

// Step i reads the h that step i - 1 wrote (the input for i = 0) and
// writes set P for even i, Q for odd i.
template <int CPT>
__global__ void __launch_bounds__(FUSED_BLOCK) fused_approach_kernel(
    const int* base, const float* frames, int n_frames, const float* area, const float* h_in,
    float* hP, float* CP, float* hQ, float* CQ, float* acc, int start, int n,
    CApproachParams p) {
  cg::grid_group grid = cg::this_grid();
  const int H = p.H, W = p.W, HW = H * W;
  const int threads = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const bool disk = blockIdx.x == 0 && (int)threadIdx.x < p.rint;
  const bool flat = p.flat != 0;
  float s_in = 0.0f, s_cur = 0.0f;
  float u0[CPT], v0[CPT], u1[CPT], v1[CPT];  // this thread's cells in frames b, b + 1
  int b_held = -1;
  const float* h = h_in;
  for (int i = 0; i < n; ++i) {
    float* hd = (i & 1) ? hQ : hP;
    float* Cd = (i & 1) ? CQ : CP;
    const int step = start + i;
    int b;
    const FrameVel fv = frame_vel(frames, n_frames, 0, HW, step, p.v, b);
    if (b != b_held) {  // uniform over the grid: b depends on the step only
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tid + j * threads;
        if (c < HW) {
          u0[j] = fv.f0[c];
          v0[j] = fv.f0[HW + c];
          u1[j] = fv.f1[c];
          v1[j] = fv.f1[HW + c];
        }
      }
      b_held = b;
    }
    const auto g = approach_geo(base, fv, step, p);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tid + j * threads;
      if (c < HW)
        approach_cell(h, g, p, c / W, c % W, fv.at(u0[j], u1[j]), fv.at(v0[j], v1[j]), hd, Cd);
    }
    grid.sync();
    if (disk) {
      float t_in, t_cur;
      disk_terms(Cd, H, W, g.walks_int, flat, threadIdx.x, area[threadIdx.x], t_in, t_cur);
      s_in = s_in + t_in;
      s_cur = s_cur + t_cur;
    }
    h = hd;
  }
  if (blockIdx.x != 0 || n < 1) return;
  int b;
  const int last = start + n - 1;
  const auto g = approach_geo(base, frame_vel(frames, n_frames, 0, HW, last, p.v, b), last, p);
  const int r_cur = disk_row(g.walks_int + 1, H);
  float s[4] = {s_in, s_cur, 0.0f, 0.0f};
  if (disk) {
    const int x = threadIdx.x;
    s[2] = g.cu(r_cur, x) * area[x];
    s[3] = g.cv(r_cur, x) * area[x];
  }
  __shared__ float red[4][FUSED_BLOCK];
  block_sum4(red, s);
  if (threadIdx.x == 0) {
    acc[0] = acc[0] + red[0][0];
    acc[1] = acc[1] + red[1][0];
    acc[2] = red[2][0];
    acc[3] = red[3][0];
  }
}

}  // namespace

extern "C" int jrl_fused_approach_max_blocks(int cpt, int block, int* out) {
  const auto k = JRL_FUSED_PICK(fused_approach_kernel, cpt);
  return k ? coresident_blocks(k, block, out) : (int)cudaErrorInvalidValue;
}

extern "C" int jrl_fused_approach(const int* base, const float* frames, int n_frames,
                                  const float* area, const float* h, float* hP, float* CP,
                                  float* hQ, float* CQ, float* acc, int start, int n,
                                  const CApproachParams* p, int cpt, int grid, void* stream) {
  const auto k = JRL_FUSED_PICK(fused_approach_kernel, cpt);
  if (!k) return (int)cudaErrorInvalidValue;
  CApproachParams pp = *p;
  void* args[] = {&base, &frames, &n_frames, &area, &h, &hP, &CP, &hQ, &CQ, &acc,
                  &start, &n, &pp};
  return launch_cooperative(k, grid, args, stream);
}
