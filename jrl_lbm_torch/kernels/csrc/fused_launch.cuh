// Launch form shared by the multi-step kernels (fused_*.cu): one
// persistent cooperative grid, no larger than the co-resident limit, in
// which every thread owns up to CPT fixed cells (cell tid + j * threads,
// j < CPT) for the whole launch, and grid.sync() separates dependent
// passes. A grid over the co-resident limit is refused before launch.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace jrl {

constexpr int FUSED_BLOCK = 256;

// Blocks of `kernel` at `block` threads that fit on the current device at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SM count).
template <class K>
inline int coresident_blocks(K kernel, int block, int* out) {
  if (block != FUSED_BLOCK) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, 0);
  *out = per_sm * sms;
  return (int)e;
}

// Cooperative launch of `kernel` on `grid` blocks of FUSED_BLOCK threads;
// cudaErrorCooperativeLaunchTooLarge, without launching, for a grid over
// the co-resident limit.
template <class K>
inline int launch_cooperative(K kernel, int grid, void** args, void* stream) {
  int max_blocks = 0;
  const int e = coresident_blocks(kernel, FUSED_BLOCK, &max_blocks);
  if (e != 0) return e;
  if (grid < 1 || grid > max_blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(FUSED_BLOCK),
                                          args, 0, (cudaStream_t)stream);
}

}  // namespace jrl

// The kernel instance for `cpt` cells per thread (1, 2 or 4), else null.
#define JRL_FUSED_PICK(kernel, cpt) \
  ((cpt) == 1 ? kernel<1> : (cpt) == 2 ? kernel<2> : (cpt) == 4 ? kernel<4> : nullptr)
