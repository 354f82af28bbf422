// Cylinder channel on one shard of a (ny, nx) mesh, one full-boundary
// step, one thread per body cell: the cell code of cyl_full.cu
// (cyl_common.cuh::full_cell, OBSTACLE cells keep the incoming rho and
// vel) read in global coordinates, so a shard computes what cyl_full
// computes on the whole grid, bit for bit. Two instances:
//  * PADDED: f, vel and flags arrive padded to (h+2, w+2) by
//    parallel/halo.py::pad_halo (cyl_shard.cuh::PaddedCylAcc);
//  * PIECES: the body tensors as they are, with the 1-row pieces and
//    1-lane column blocks of the 12-plane group (flags, f, vel) packed by
//    halo_pack (cyl_shard.cuh::ShardCylAcc).
//
// Replaces the TPU kernels jrl_lbm_tpu/ops/pallas/fused_sharded.py::
// _padded_block_step (_make_padded_block_kernel, body _block_update) and
// _tiled_block_step. Plain twin: kernels/cyl_sharded.py::cyl_block_sh_ref.
//
// Bound on the card: memory, as cyl_full: it reads f, rho, vel, flags and
// phi (14 planes) and writes f, rho, vel (12 planes) of the shard, plus
// the halo (a padded copy of 12 planes for PADDED, O(h + w) words for
// PIECES). Design: cyl_full's body; the PIECES accessor picks body, row
// piece or column block per read, a branch that is uniform within a warp
// away from the shard's edge rows and columns.
#include "cyl_shard.cuh"

namespace {

using namespace cyl;

template <bool PADDED>
__global__ void __launch_bounds__(256)
    cyl_block_sh_kernel(CylShardSrc src, float* __restrict__ f_out, float* __restrict__ rho_out,
                        float* __restrict__ vel_out, CylParams p, CylShardGeom s) {
  const int lx = blockIdx.x * blockDim.x + threadIdx.x;
  const int ly = blockIdx.y * blockDim.y + threadIdx.y;
  if (lx >= s.w || ly >= s.h) return;
  const int y = s.row0 + ly, x = s.col0 + lx, hw = s.h * s.w, i = ly * s.w + lx;
  float fo[9], r, ux, uy;
  if (PADDED) {
    const int c = (ly + 1) * (s.w + 2) + lx + 1, pw = (s.h + 2) * (s.w + 2);
    const PaddedCylAcc a{src.f.body, src.vel.body, src.flags.body, src.phi.body, s.h, s.w, ly, lx};
    full_cell<true>(a, p, y, x, src.rho.body[i], src.vel.body[c], src.vel.body[pw + c], fo, r,
                    ux, uy);
  } else {
    const ShardCylAcc a{src, s, y, x};
    full_cell<true>(a, p, y, x, src.rho.body[i], src.vel.body[i], src.vel.body[hw + i], fo, r,
                    ux, uy);
  }
#pragma unroll
  for (int q = 0; q < 9; ++q) f_out[q * hw + i] = fo[q];
  rho_out[i] = r;
  vel_out[i] = ux;
  vel_out[hw + i] = uy;
}

}  // namespace

// padded: 1 when f, vel and flags of `src` are (h+2, w+2) padded planes
// (their pieces unused), 0 when they come with the halo pieces.
extern "C" int cyl_block_sh_launch(const CylShardSrc* src, float* f_out, float* rho_out,
                                   float* vel_out, int padded, const CylParams* p,
                                   const CylShardGeom* s, void* stream) {
  const dim3 block(128, 2);
  const dim3 grid((s->w + block.x - 1) / block.x, (s->h + block.y - 1) / block.y);
  const cudaStream_t st = (cudaStream_t)stream;
  if (padded)
    cyl_block_sh_kernel<true><<<grid, block, 0, st>>>(*src, f_out, rho_out, vel_out, *p, *s);
  else
    cyl_block_sh_kernel<false><<<grid, block, 0, st>>>(*src, f_out, rho_out, vel_out, *p, *s);
  return (int)cudaGetLastError();
}
