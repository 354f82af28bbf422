// JRL concentration approach step on one shard of a (ny, nx) mesh, and
// the shard's partial sums of the tip-disk integrals. The step: analytic
// moving tip, C zeroed inside it, streaming with sub-grid bounce, C = sum
// h (clamped for flat tips), advection-diffusion BGK on the stored
// velocity; one thread per body cell, h and the base flags beyond the
// shard read from their halo pieces. Then one block sums the disk terms of
// the cells the shard owns into the shard's accumulator.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_jrl_sharded.py::
// _step_approach (fused_jrl_tiled._make_c_approach_kernel with shard=True,
// xw windows on a 2D mesh, per-tile partials in its acc output). Its plain
// twin is jrl_lbm_torch/kernels/jrl_sharded.py::c_approach_sh_ref. The
// per-cell code is jrl_c.cuh::approach_cell_at through jrl_shard.cuh, so a
// shard's h and C equal c_approach.cu's bit for bit.
//
// The partials take the JAX package's row-split form, exact however the
// disk rows land on shard boundaries: every term is a product of one
// cell's values, summed per row (inflow = sum C[wi] - sum C[wi-1] + sum
// dC_r[wi] for flat tips, the plain disk row otherwise), so each row's
// share comes from the shard that owns it. The flat flux term dC_r at
// column x reads the new C at x + 1; at the shard's last column the disk
// block recomputes that C (jrl_c.cuh::approach_C) from the halo, as the
// JAX package computes its extension lanes. A fixed tree order per shard
// (no atomics) and a fixed-order sum across shards keep runs repeatable.
//
// Bound on the card: memory. The step reads the shard's 12 planes (base
// flags, h, vel) and writes 10, plus 10 halo rows (flags, h) a side and,
// on a 2D mesh, 10 planes of two (h+2) x 2 column blocks; ~330 flops per
// cell. The disk block reads at most three rows of rint + 1 cells.
#include "jrl_c.cuh"
#include "jrl_shard.cuh"

namespace {

using namespace jrl;

__global__ void __launch_bounds__(256) c_approach_sh_kernel(
    ShardPlanes<int> base, ShardPlanes<float> h, const float* __restrict__ vel,
    float* __restrict__ h_out, float* __restrict__ C_out, int step, CApproachParams p,
    ShardGeom s) {
  const int lx = blockIdx.x * blockDim.x + threadIdx.x;
  const int ly = blockIdx.y * blockDim.y + threadIdx.y;
  if (lx >= s.w || ly >= s.h) return;
  const int y = s.row0 + ly, x = s.col0 + lx;
  const int hw = s.h * s.w, i = ly * s.w + lx;
  const auto g = approach_geo_on(ShardFlags{base, s}, ShardVel{vel, s}, step, p);
  const ShardPlanes<float> none{};
  approach_cell_at(ShardState{h, none, none, s, y, x}, g, p, y, x, vel[i], vel[hw + i], h_out,
                   C_out, i, hw);
}

// The shard's terms of (inflow, current, rec_u, rec_v) at the step, added
// into part[0], part[1] and written to part[2], part[3]
// (jrl_c.cuh::disk_sh_step).
__global__ void __launch_bounds__(DISK_SH_THREADS) c_disk_sh_kernel(
    ShardPlanes<int> base, ShardPlanes<float> h, const float* __restrict__ vel,
    const float* __restrict__ Cn, const float* __restrict__ area, float* __restrict__ part,
    int step, CApproachParams p, ShardGeom s) {
  const auto g = approach_geo_on(ShardFlags{base, s}, ShardVel{vel, s}, step, p);
  const ShardPlanes<float> none{};
  const auto cn = [&](int r, int x) -> float {
    const int lx = x - s.col0;
    if (lx < s.w) return Cn[(r - s.row0) * s.w + lx];
    float hs[9];  // the right neighbour's cell
    return approach_C(ShardState{h, none, none, s, r, x}, g, p, r, x, g.flag(r, x), hs);
  };
  __shared__ float red[4][DISK_SH_THREADS];
  disk_sh_step(cn, g, p, area, part, s.row0, s.h, s.col0, s.w, red);
}

}  // namespace

extern "C" int jrl_c_approach_sh(const ShardPlanes<int>* base, const ShardPlanes<float>* h,
                                 const float* vel, const float* area, float* h_out, float* C_out,
                                 float* part, int step, const CApproachParams* p,
                                 const ShardGeom* s, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 block(128, 2);
  const dim3 grid((s->w + block.x - 1) / block.x, (s->h + block.y - 1) / block.y);
  c_approach_sh_kernel<<<grid, block, 0, st>>>(*base, *h, vel, h_out, C_out, step, *p, *s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  c_disk_sh_kernel<<<1, DISK_SH_THREADS, 0, st>>>(*base, *h, vel, C_out, area, part, step, *p, *s);
  return (int)cudaGetLastError();
}
