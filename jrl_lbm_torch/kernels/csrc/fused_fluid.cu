// JRL fluid phase, n steps in one launch: per step, pull-streaming with
// the moving-tip coupling and moments (step A), a grid-wide barrier, BGK
// with the LINE_X_EQ_0 axisymmetric source (step B), a barrier.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl.py::
// _make_jrl_fluid_kernel (called by _fused_fluid_run). Its plain twin is
// jrl_lbm_torch/kernels/fused_jrl.py::fused_fluid_ref, the loop of
// fluid_a_ref and fluid_b_ref; the per-cell code is jrl_fluid.cuh's, shared
// with fluid_a.cu and fluid_b.cu.
//
// Which grids reach it (kernels/fused_jrl.py::fused_route on an H100): none
// of the default case's refinements, whose fluid runs on the cluster kernel
// (128x64, fused_fluid_cl.cu) and the tile kernel (256x128 and 512x256,
// fused_fluid_tl.cu); grids of fewer than TILES_MIN_CELLS cells whose
// multi-cluster plan needs two cells a thread, grids from TILES_MIN_CELLS
// cells whose rows are not 16-byte multiples and need as many, and any
// grid a caller sends with route="coop", which keeps it as every fluid
// kernel's yardstick: the others equal it bit for bit.
//
// Bound on the card: at 128x64 the state (f, rho, vel: 12 planes, 393 KB)
// crosses device memory once per launch, so the bound is the ~650 float32
// operations per cell and step (~0.08 us a step at the float32 peak); the
// two grid barriers a step cost far more. Design: the Pallas kernel holds
// the whole domain in VMEM, which no H100 block can (f alone is 295 KB
// at 128x64). Here the state lives in two ping-pong buffer sets in device
// memory, where the 50 MB L2 keeps it across steps; one persistent
// cooperative grid, no larger than the co-resident limit, gives each
// thread fixed cells, and grid.sync() orders A after the previous B
// (A pulls the neighbours' f) and B after A (B's stencils read the
// neighbours' post-moment rho and vel). B updates f in place. The step
// index is start + i in integers, converted once, as the jnp step does.
#include "fused_launch.cuh"
#include "jrl_fluid.cuh"

namespace {

using namespace jrl;
namespace cg = cooperative_groups;

// Step i reads the buffer set step i - 1 wrote (the input for i = 0) and
// writes set P for even i, Q for odd i.
template <int CPT>
__global__ void __launch_bounds__(FUSED_BLOCK) fused_fluid_kernel(
    const float* f_in, const float* rho_in, const float* vel_in, float* fP, float* rP,
    float* vP, float* fQ, float* rQ, float* vQ, int start, int n, FluidParams pa,
    FluidBParams pb) {
  cg::grid_group grid = cg::this_grid();
  const int W = pa.W, HW = pa.H * pa.W;
  const int threads = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const float* f = f_in;
  const float* rho = rho_in;
  const float* vel = vel_in;
  for (int i = 0; i < n; ++i) {
    float* fd = (i & 1) ? fQ : fP;
    float* rd = (i & 1) ? rQ : rP;
    float* vd = (i & 1) ? vQ : vP;
    const int step = start + i;
    const FluidGeo g = fluid_geo(step, pa);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tid + j * threads;
      if (c < HW) {
        const int y = c / W, x = c % W;
        float fo[9], r, u, v;
        fluid_a_cell(GlobalState{f, rho, vel, pa.H, W, y, x}, g, pa.cs2tau, y, x, fo, r, u, v);
#pragma unroll
        for (int q = 0; q < 9; ++q) fd[q * HW + c] = fo[q];
        rd[c] = r;
        vd[c] = u;
        vd[HW + c] = v;
      }
    }
    grid.sync();
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tid + j * threads;
      if (c < HW) {
        const int y = c / W, x = c % W;
        float fo[9];
        fluid_b_cell(GlobalState{fd, rd, vd, pa.H, W, y, x}, g, pb, y, x, fo);
#pragma unroll
        for (int q = 0; q < 9; ++q) fd[q * HW + c] = fo[q];
      }
    }
    grid.sync();
    f = fd;
    rho = rd;
    vel = vd;
  }
}

}  // namespace

extern "C" int jrl_fused_fluid_max_blocks(int cpt, int block, int* out) {
  const auto k = JRL_FUSED_PICK(fused_fluid_kernel, cpt);
  return k ? coresident_blocks(k, block, out) : (int)cudaErrorInvalidValue;
}

extern "C" int jrl_fused_fluid(const float* f, const float* rho, const float* vel, float* fP,
                               float* rP, float* vP, float* fQ, float* rQ, float* vQ, int start,
                               int n, const FluidParams* pa, const FluidBParams* pb, int cpt,
                               int grid, void* stream) {
  const auto k = JRL_FUSED_PICK(fused_fluid_kernel, cpt);
  if (!k) return (int)cudaErrorInvalidValue;
  FluidParams a = *pa;
  FluidBParams b = *pb;
  void* args[] = {&f, &rho, &vel, &fP, &rP, &vP, &fQ, &rQ, &vQ, &start, &n, &a, &b};
  return launch_cooperative(k, grid, args, stream);
}
