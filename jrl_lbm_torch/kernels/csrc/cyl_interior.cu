// Cylinder channel, one plain-channel step on the interior rows, one
// thread per cell: streaming with static bounce at the wall columns
// x = 0 and W-1 (x = 0 pulls from column 1, x = W-1 from W-2; the cells
// next to them bounce what would come from the wall), moments (walls keep
// rho = cfg.density, vel = 0) and paired MRT. Flags are not read. rho and
// vel are written only with p.write_macro.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_step.py::
// _make_interior_kernel. Plain twin: kernels/cylinder.py::
// cyl_interior_ref. Per-cell code: cyl_common.cuh::lean_cell.
//
// Bound on the card: memory, 9 f planes in and 9 out (12 out with the
// macros) at ~130 float32 operations a cell. Design: one coalesced row
// segment per warp, neighbours from global memory through L1/L2; the
// Pallas kernel's 8-row halo blocks have no counterpart (a warp reads the
// rows above and below directly). In the bf16 storage modes the f planes
// are 2 bytes a cell each way (cyl_common.cuh::f_load, f_store).
#include "cyl_common.cuh"

namespace {

using namespace cyl;

template <int ST>
struct FOnly {  // lean_cell reads f only
  const f_t<ST>* f;
  int H, W, y, x;
  __device__ __forceinline__ float F(int q, int dy, int dx) const {
    int yy = y + dy, xx = x + dx;
    yy += yy < 0 ? H : 0;
    yy -= yy >= H ? H : 0;
    xx += xx < 0 ? W : 0;
    xx -= xx >= W ? W : 0;
    return f_load<ST>(f, q * H * W + yy * W + xx, q);
  }
};

template <int ST>
__global__ void __launch_bounds__(256) cyl_interior_kernel(const f_t<ST>* __restrict__ f,
                                                           f_t<ST>* __restrict__ f_out,
                                                           float* __restrict__ rho_out,
                                                           float* __restrict__ vel_out,
                                                           CylParams p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  bool ok;
  const int y = seg_row(p, blockIdx.y * blockDim.y + threadIdx.y, ok);
  if (x >= p.W || !ok) return;
  const int HW = p.H * p.W, c = y * p.W + x;
  float fo[9], r, ux, uy;
  lean_cell(FOnly<ST>{f, p.H, p.W, y, x}, p, y, x, fo, r, ux, uy);
  f_store<ST>(f_out, HW, c, fo, p);
  if (p.write_macro) {
    rho_out[c] = r;
    vel_out[c] = ux;
    vel_out[HW + c] = uy;
  }
}

}  // namespace

// storage: cyl_common.cuh::Storage; f and f_out hold f_t<storage>.
extern "C" int cyl_interior_launch(const void* f, void* f_out, float* rho_out, float* vel_out,
                                   int storage, const CylParams* p, void* stream) {
  int rows = 0;
  for (int s = 0; s < p->nseg; ++s) rows += p->seg[2 * s + 1] - p->seg[2 * s];
  const dim3 block(128, 2);
  const dim3 grid((p->W + block.x - 1) / block.x, (rows + block.y - 1) / block.y);
  return with_storage(storage, [&](auto sc) {
    constexpr int ST = decltype(sc)::value;
    cyl_interior_kernel<ST><<<grid, block, 0, (cudaStream_t)stream>>>(
        static_cast<const f_t<ST>*>(f), static_cast<f_t<ST>*>(f_out), rho_out, vel_out, *p);
    return (int)cudaGetLastError();
  });
}
