// Halo pieces of one shard: copies the edge rows, and on a 2D mesh the
// edge column blocks of the row-extended block, of all planes of a field
// group (f and vel; rho and vel; flags; h) into one contiguous send
// buffer per neighbour, in one launch a phase.
//
// Replaces the TPU kernel jrl_lbm_tpu/ops/pallas/fused_sharded.py::
// _edge_blocks (the first and last lane blocks of a shard, called by
// fused_jrl_sharded.py::_xblocks), and the row slices of
// fused_jrl_sharded.py::_pieces. Its plain twin is jrl_lbm_torch/kernels/
// halo.py::halo_pack_ref (slices and torch.cat).
//
// Two phases, as parallel/halo.py::pad_halo orders them, so the corner
// cells ride the second hop: "rows" packs row 0 and row h-1 of every plane
// ([P][w] each), which go to the y neighbours; "cols" packs the first and
// last xh columns of the block extended by the received top and bottom
// rows ([P][h+2][xh] each), which go to the x neighbours. A value is
// copied as 32 bits, so int32 flags and float32 fields go alike.
//
// Bound on the card: memory, and launch latency at these sizes: it reads
// and writes 2 P w words (rows) or 2 P (h+2) xh words (cols), a few KB to
// a few hundred KB. Design: one thread per output word, neighbouring
// threads on neighbouring words of the buffer; the strided column reads
// are (h+2) rows of xh words.
#include <cuda_runtime.h>

// The one or two source tensors of one group, planes in order, as 32-bit
// words [planes][h][w] (filled by the Python wrapper, ctypes.Structure).
struct PackSrc {
  const unsigned* p[2];
  int planes[2];
};

namespace {

// plane q of the group: its source and the plane within it
__device__ __forceinline__ const unsigned* plane_of(const PackSrc& src, int q, int hw) {
  const int k = q < src.planes[0] ? 0 : 1;
  return src.p[k] + (size_t)(k ? q - src.planes[0] : q) * hw;
}

__global__ void __launch_bounds__(256) halo_rows_kernel(PackSrc src, int P, int h, int w,
                                                        unsigned* first, unsigned* last) {
  const int n = P * w;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * n) return;
  const bool is_last = t >= n;
  const int j = is_last ? t - n : t;
  const int q = j / w, x = j - q * w;
  const unsigned* pl = plane_of(src, q, h * w);
  (is_last ? last : first)[j] = pl[(is_last ? h - 1 : 0) * w + x];
}

__global__ void __launch_bounds__(256) halo_cols_kernel(PackSrc src, const unsigned* top,
                                                        const unsigned* bot, int P, int h, int w,
                                                        int xh, unsigned* first,
                                                        unsigned* last) {
  const int n = P * (h + 2) * xh;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * n) return;
  const bool is_last = t >= n;
  const int j = is_last ? t - n : t;
  const int c = j % xh, ry = (j / xh) % (h + 2), q = j / (xh * (h + 2));
  const int x = is_last ? w - xh + c : c;
  unsigned v;
  if (ry == 0)
    v = top ? top[q * w + x] : 0u;
  else if (ry == h + 1)
    v = bot ? bot[q * w + x] : 0u;
  else
    v = plane_of(src, q, h * w)[(ry - 1) * w + x];
  (is_last ? last : first)[j] = v;
}

}  // namespace

extern "C" int jrl_halo_rows(const PackSrc* src, int P, int h, int w, unsigned* first,
                             unsigned* last, void* stream) {
  const int n = 2 * P * w;
  halo_rows_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(*src, P, h, w, first, last);
  return (int)cudaGetLastError();
}

extern "C" int jrl_halo_cols(const PackSrc* src, const unsigned* top, const unsigned* bot, int P,
                             int h, int w, int xh, unsigned* first, unsigned* last,
                             void* stream) {
  const int n = 2 * P * (h + 2) * xh;
  halo_cols_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(*src, top, bot, P, h, w,
                                                                      xh, first, last);
  return (int)cudaGetLastError();
}

extern "C" const char* jrl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
