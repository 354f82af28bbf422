// Cylinder channel, one full-boundary step on given rows, one thread per
// cell: pull-streaming with all six cell types, sub-grid interpolation
// bounce, INFLOW plug equilibrium, OUTFLOW copy, static-cylinder coupling
// (12-point gradient, nonequilibrium reconstruction), moments and paired
// MRT with OBSTACLE passthrough (OBSTACLE cells keep the incoming rho and
// vel).
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_step.py::
// _make_full_kernel (band tiles of the split step, every tile of the
// generic step). Plain twin: kernels/cylinder.py::cyl_full_ref. Per-cell
// code: cyl_common.cuh::full_cell.
//
// Bound on the card: memory. It reads f, rho, vel, flags and phi (14
// planes) and writes f, rho, vel (12 planes) of its rows; the ~400
// float32 operations of a coupled cell are paid only next to the
// cylinder (the coupling is skipped where phi is out of range). Design:
// each thread reads its 3x3 neighbourhood straight from global memory
// (the reuse is served by L1/L2; nothing is staged, since the step has
// no second sub-step to share it with); the OUTFLOW copy recomputes the
// streaming of the inward neighbour instead of reading another thread's
// output, so the step needs one launch and no merge. In the bf16 storage
// modes f is read and written as 2-byte deviations (cyl_common.cuh::
// f_load, f_store), which cuts the f planes' bytes in half.
#include "cyl_common.cuh"

namespace {

using namespace cyl;

template <int ST>
__global__ void __launch_bounds__(256) cyl_full_kernel(
    const f_t<ST>* __restrict__ f, const float* __restrict__ rho, const float* __restrict__ vel,
    const int* __restrict__ flags, const float* __restrict__ phi, f_t<ST>* __restrict__ f_out,
    float* __restrict__ rho_out, float* __restrict__ vel_out, CylParams p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  bool ok;
  const int y = seg_row(p, blockIdx.y * blockDim.y + threadIdx.y, ok);
  if (x >= p.W || !ok) return;
  const int HW = p.H * p.W, c = y * p.W + x;
  const GlobalAcc<ST> a{f, vel, flags, phi, p.H, p.W, y, x};
  float fo[9], r, ux, uy;
  full_cell<true>(a, p, y, x, rho[c], vel[c], vel[HW + c], fo, r, ux, uy);
  f_store<ST>(f_out, HW, c, fo, p);
  rho_out[c] = r;
  vel_out[c] = ux;
  vel_out[HW + c] = uy;
}

}  // namespace

// storage: cyl_common.cuh::Storage; f and f_out hold f_t<storage>.
extern "C" int cyl_full_launch(const void* f, const float* rho, const float* vel,
                               const int* flags, const float* phi, void* f_out, float* rho_out,
                               float* vel_out, int storage, const CylParams* p, void* stream) {
  int rows = 0;
  for (int s = 0; s < p->nseg; ++s) rows += p->seg[2 * s + 1] - p->seg[2 * s];
  const dim3 block(128, 2);
  const dim3 grid((p->W + block.x - 1) / block.x, (rows + block.y - 1) / block.y);
  return with_storage(storage, [&](auto sc) {
    constexpr int ST = decltype(sc)::value;
    cyl_full_kernel<ST><<<grid, block, 0, (cudaStream_t)stream>>>(
        static_cast<const f_t<ST>*>(f), rho, vel, flags, phi, static_cast<f_t<ST>*>(f_out),
        rho_out, vel_out, *p);
    return (int)cudaGetLastError();
  });
}
