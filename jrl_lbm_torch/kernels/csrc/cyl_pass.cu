// Cylinder channel, one k-step pass of the split in one launch: k
// plain-channel steps on the interior rows, k full steps with the
// sub-grid bounce and the static-cylinder coupling on the cylinder band
// ("cyl") and k full steps without them on the INFLOW/OUTFLOW rows
// ("edge"), all from the same input state, streamed row by row
// (cyl_pass_state.cuh). k is a template parameter (2..4), and so is the
// storage of f (cyl_common.cuh::Storage).
//
// Replaces, in one launch, what the TPU code jrl_lbm_tpu/ops/pallas/
// fused_step.py::_fused_step2_split_impl does with three calls of its
// kernels: _make_interior_kernel2 (body _lean_step_rows) on the interior
// rows, and _make_full_kernel2 (body _full_step_rows) on the "cyl" and
// "edge" rows. Until this kernel the port ran them as cyl_interior_k and
// two cyl_band_k launches (kept, and the yardstick). Plain twin:
// kernels/cylinder.py::cyl_pass_ref. The cell code is cyl_common.cuh's
// lean_cell and full_cell, with the same operations in the same order
// under --fmad=false, so the launch equals the three launches bit for bit.
//
// Bound on the card: the bytes (9 f planes in and out a cell, plus vel,
// flags and phi in and rho, vel out on the band rows: ~82 us a k = 4 pass
// at 2048^2 in float32, ~41 in bf16), but the cell code issues ~190
// float32 operations a cell and sub-step that --fmad=false keeps unpaired,
// so instruction issue and the latency of one cell's dependent chain set
// the pace. What held the three launches back, and what this design does:
// - 2-D tiles with a k-cell halo on all four sides (a 64-wide window of a
//   56-column tile: 1.26x the sub-step work at k = 4 on the interior,
//   1.46x on the band): a block streams a run of rows of a strip of up to
//   cp_cols(k) - 2k columns (120 at k = 4), so the y halo is paid once a
//   run and the x halo is k columns of a wide strip;
// - two 256-thread blocks an SM (110 KB of shared memory a tile): rings of
//   4 rows a sub-step, two 512-thread blocks an SM (32 warps), each
//   thread one cell of one sub-step a phase, the k sub-steps of a column
//   on k warps at once;
// - the wall-column rules tested on every cell (4 of 2048 columns need
//   them) and clamped shared-memory reads on the band: a body strip takes
//   an instance without them, and no read needs a clamp;
// - three launches, each with its tail (the band launches fill 1.1 and
//   2.2 waves): one launch, items of all classes, the band runs shorter by
//   their rows' cost (kernels/cylinder.py::CYL_PASS_COST), about one wave.
// In the bf16 storage modes the input ring holds the stored patterns and
// the first sub-step converts as it reads (cyl_common.cuh::f_load), the
// one store of the pass rounds (f_store_key, under the key of the class
// that owns the row).
#include "cyl_pass_state.cuh"

namespace {

using namespace cyl;

template <int K, int ST>
__global__ void __launch_bounds__(CP_THREADS, CP_MIN_BLOCKS) cyl_pass_kernel(
    const f_t<ST>* __restrict__ f, const float* __restrict__ vel, const int* __restrict__ flags,
    const float* __restrict__ phi, f_t<ST>* __restrict__ f_out, float* __restrict__ rho_out,
    float* __restrict__ vel_out, const int4* __restrict__ items, CylPassParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[CP_D];
  const CpItem it(items[blockIdx.x]);
  // a block whose plan the host got wrong stops the launch (an error, not
  // wrong cells): its rings must fit the shared memory, its window the threads
  unsigned dyn;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
  constexpr int ES = (int)sizeof(f_t<ST>);
  if (it.cls > CP_EDGE || p.rs[it.cls] != cp_rs(it.cls, K, ES) ||
      it.a1 - it.a0 > cp_rs(it.cls, K, ES) ||
      min(it.x1 + K, p.c.W) - max(it.x0 - K, 0) > cp_cols(K) ||
      (unsigned)cp_smem_bytes(it.cls, K, cp_rs(it.cls, K, ES), ES) > dyn)
    __trap();
  const bool body = it.x0 - K + 1 >= 2 && it.x1 + K - 1 <= p.c.W - 2;
#define CYL_PASS_RUN(CLS, XW) \
  cp_run<CLS, XW, K, ST>(f, vel, flags, phi, f_out, rho_out, vel_out, p, it, smem, bars)
  if (it.cls == CP_LEAN) {
    if (body) CYL_PASS_RUN(CP_LEAN, false); else CYL_PASS_RUN(CP_LEAN, true);
  } else if (it.cls == CP_CYL) {
    if (body) CYL_PASS_RUN(CP_CYL, false); else CYL_PASS_RUN(CP_CYL, true);
  } else {
    if (body) CYL_PASS_RUN(CP_EDGE, false); else CYL_PASS_RUN(CP_EDGE, true);
  }
#undef CYL_PASS_RUN
}

// Calls fn(std::integral_constant<int, k>) for the run-time k in 2..4.
template <class Fn>
int with_pass_k(int k, Fn fn) {
  switch (k) {
    case 2: return fn(std::integral_constant<int, 2>());
    case 3: return fn(std::integral_constant<int, 3>());
    case 4: return fn(std::integral_constant<int, 4>());
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Registers per thread and local (spill) bytes of the instance (k, storage).
extern "C" int cyl_pass_info(int k, int storage, int* regs, int* local_bytes) {
  return with_storage(storage, [&](auto sc) {
    constexpr int ST = decltype(sc)::value;
    return with_pass_k(k, [&](auto kc) {
      constexpr int K = decltype(kc)::value;
      return jrl::kernel_info(cyl_pass_kernel<K, ST>, regs, local_bytes);
    });
  });
}

// The launch's threads a block and window columns at depth k (the host plan
// reads them back, so that a build with other -D values plans for them).
extern "C" int cyl_pass_shape(int k, int* threads, int* cols, int* min_blocks) {
  if (k < 2 || k > 4) return (int)cudaErrorInvalidValue;
  *threads = CP_THREADS;
  *cols = cp_cols(k);
  *min_blocks = CP_MIN_BLOCKS;
  return (int)cudaSuccess;
}

// One pass over p->nitems items (int32 x 4 each on the card); storage:
// cyl_common.cuh::Storage, f and f_out hold f_t<storage>; smem_bytes: the
// largest cp_smem_bytes of the launch's items.
extern "C" int cyl_pass_launch(const void* f, const float* vel, const int* flags,
                               const float* phi, void* f_out, float* rho_out, float* vel_out,
                               const int* items, int k, int storage, int smem_bytes,
                               const CylPassParams* p, void* stream) {
  if (p->nitems < 1 || p->c.W % 8 || smem_bytes < 1 || smem_bytes > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  return with_storage(storage, [&](auto sc) {
    constexpr int ST = decltype(sc)::value;
    return with_pass_k(k, [&](auto kc) {
      constexpr int K = decltype(kc)::value;
      const int err = jrl::smem_attr_once<cyl_pass_kernel<K, ST>>(smem_bytes);
      if (err != (int)cudaSuccess) return err;
      cyl_pass_kernel<K, ST><<<p->nitems, CP_THREADS, smem_bytes, (cudaStream_t)stream>>>(
          static_cast<const f_t<ST>*>(f), vel, flags, phi, static_cast<f_t<ST>*>(f_out), rho_out,
          vel_out, reinterpret_cast<const int4*>(items), *p);
      return (int)cudaGetLastError();
    });
  });
}
