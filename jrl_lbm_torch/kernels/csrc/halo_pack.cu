// Halo pieces of one shard: copies the k edge rows, and on a 2D mesh the
// edge column blocks of the row-extended block, of all planes of a field
// group (f and vel; rho and vel; flags; h; the cylinder's flags, f, vel
// and phi, rho) into one contiguous send buffer per neighbour, in one
// launch a phase.
//
// Replaces the TPU kernels jrl_lbm_tpu/ops/pallas/fused_sharded.py::
// _edge_blocks (the first and last lane blocks of a shard, called by
// fused_jrl_sharded.py::_xblocks and by the extended-window mode of
// make_sharded_fused_cylinder_step) and _edge_cols (the first and last
// lane: the columns phase at xh = 1), and the row slices of
// fused_jrl_sharded.py::_pieces and fused_sharded.py::_halo_pieces (k rows).
// Its plain twin is jrl_lbm_torch/kernels/halo.py::halo_pack_ref (slices
// and torch.cat).
//
// Two phases, as parallel/halo.py::pad_halo orders them, so the corner
// cells ride the second hop: "rows" packs rows [0, k) and [h-k, h) of
// every plane ([P][k][w] each), which go to the y neighbours; "cols" packs
// the first and last xh columns of the block extended by the received k
// top and k bottom rows ([P][h+2k][xh] each), which go to the x
// neighbours. A value is copied as 32 bits, so int32 flags and float32
// fields go alike.
//
// Bound on the card: memory, and launch latency at these sizes: it reads
// and writes 2 P k w words (rows) or 2 P (h+2k) xh words (cols), a few KB
// to a few MB. Design: one thread per output word, neighbouring threads
// on neighbouring words of the buffer; the strided column reads are
// (h+2k) rows of xh words.
#include <cuda_runtime.h>

constexpr int MAX_SOURCES = 5;  // kernels/halo.py::MAX_SOURCES

// The source tensors of one group, planes in order, as 32-bit words
// [planes][h][w] (filled by the Python wrapper, ctypes.Structure).
struct PackSrc {
  const unsigned* p[MAX_SOURCES];
  int planes[MAX_SOURCES];
};

namespace {

// plane q of the group: its source and the plane within it (the sources
// are walked at compile-time indices, so the parameter arrays are never
// copied to the stack for a run-time index)
__device__ __forceinline__ const unsigned* plane_of(const PackSrc& src, int q, int hw) {
  const unsigned* base = src.p[0];
  bool found = false;
#pragma unroll
  for (int s = 0; s < MAX_SOURCES - 1; ++s) {
    if (!found && q >= src.planes[s]) {
      q -= src.planes[s];
      base = src.p[s + 1];
    } else {
      found = true;
    }
  }
  return base + (size_t)q * hw;
}

__global__ void __launch_bounds__(256) halo_rows_kernel(PackSrc src, int P, int h, int w, int k,
                                                        unsigned* first, unsigned* last) {
  const int n = P * k * w;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * n) return;
  const bool is_last = t >= n;
  const int j = is_last ? t - n : t;
  const int q = j / (k * w), r = (j / w) % k, x = j % w;
  const unsigned* pl = plane_of(src, q, h * w);
  (is_last ? last : first)[j] = pl[(is_last ? h - k + r : r) * w + x];
}

__global__ void __launch_bounds__(256) halo_cols_kernel(PackSrc src, const unsigned* top,
                                                        const unsigned* bot, int P, int h, int w,
                                                        int k, int xh, unsigned* first,
                                                        unsigned* last) {
  const int bh = h + 2 * k, n = P * bh * xh;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * n) return;
  const bool is_last = t >= n;
  const int j = is_last ? t - n : t;
  const int c = j % xh, ry = (j / xh) % bh, q = j / (xh * bh);
  const int x = is_last ? w - xh + c : c;
  unsigned v;
  if (ry < k)
    v = top ? top[(q * k + ry) * w + x] : 0u;
  else if (ry >= h + k)
    v = bot ? bot[(q * k + ry - h - k) * w + x] : 0u;
  else
    v = plane_of(src, q, h * w)[(ry - k) * w + x];
  (is_last ? last : first)[j] = v;
}

}  // namespace

extern "C" int jrl_halo_rows(const PackSrc* src, int P, int h, int w, int k, unsigned* first,
                             unsigned* last, void* stream) {
  const int n = 2 * P * k * w;
  halo_rows_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(*src, P, h, w, k, first,
                                                                      last);
  return (int)cudaGetLastError();
}

extern "C" int jrl_halo_cols(const PackSrc* src, const unsigned* top, const unsigned* bot, int P,
                             int h, int w, int k, int xh, unsigned* first, unsigned* last,
                             void* stream) {
  const int n = 2 * P * (h + 2 * k) * xh;
  halo_cols_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(*src, top, bot, P, h, w,
                                                                      k, xh, first, last);
  return (int)cudaGetLastError();
}

extern "C" const char* jrl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
