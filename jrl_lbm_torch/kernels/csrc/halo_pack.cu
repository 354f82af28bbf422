// Halo pieces of one shard: copies the k edge rows, and on a 2D mesh the
// edge column blocks of the row-extended block, of all planes of a field
// group (f and vel; rho and vel; flags; h; the cylinder's flags, f, vel
// and phi, rho) into one contiguous send buffer per neighbour, in one
// launch a phase. On a mesh whose shards all sit on one card, a third
// entry point (jrl_halo_mesh) writes every shard's received pieces at once,
// straight from its neighbours' tensors (see halo_mesh_kernel).
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

// ---------------------------------------------------------------------------
// The whole exchange of a mesh held on one card, in one launch
// ---------------------------------------------------------------------------
//
// Every shard of a (ny, nx) mesh lies in the same memory, so the pieces a
// shard receives are read straight from the neighbours that own them, with
// the ring directions of kernels/halo.py::exchange (indices mod ny and nx):
//   top   of (iy, ix): rows [h-k, h) of (iy-1, ix)           [P][k][w]
//   bot   of (iy, ix): rows [0, k) of (iy+1, ix)             [P][k][w]
//   left  of (iy, ix): the last xh lanes of (iy, ix-1)'s block extended by
//                      its k received rows a side, i.e. rows [h-k, h) of
//                      (iy-1, ix-1), then (iy, ix-1), then rows [0, k) of
//                      (iy+1, ix-1)                          [P][h+2k][xh]
//   right of (iy, ix): the first xh lanes of (iy, ix+1)'s, the same way
// The extended rows are zeros on a mesh of one row (ny = 1), as the
// two-phase exchange writes them. top and bot are absent (0 words) when
// ny = 1, left and right when nx = 1 or xh = 0. The pieces of shard s
// start at s * stride words of the output, at the offsets 0, bot_off,
// left_off and right_off, each a multiple of 32 words (128 bytes) chosen
// by the host; the words between the pieces are left unwritten.
//
// Bound on the card: memory (the words written, and as many read) and
// launch latency: a (2, 2) fluid exchange at k = 4 (512x256 shards, 12
// planes, 8 rows, 8 lanes) writes ~2.4 MB. Design: one thread per output
// word, neighbouring threads on neighbouring words (coalesced writes; the
// row reads coalesced too, the column reads xh words of a row); a block
// works on one piece of one shard, so the shard and piece are
// block-uniform and a thread's index math is two integer divisions.

constexpr int MAX_MESH_SHARDS = 64;  // kernels/halo.py::MAX_MESH_SHARDS

// The group's tensors on every shard, shards in row-major mesh order
// (filled by the Python wrapper); every shard holds the same plane counts.
struct MeshSrc {
  const unsigned* p[MAX_MESH_SHARDS][MAX_SOURCES];
  int planes[MAX_SOURCES];
};

namespace {

// plane q of shard s's group (the sources walked at compile-time indices;
// the table is a __grid_constant__ parameter, read in place for a run-time s)
__device__ __forceinline__ const unsigned* mesh_plane(const MeshSrc& src, int s, int q, int hw) {
  const unsigned* base = src.p[s][0];
  bool found = false;
#pragma unroll
  for (int i = 0; i < MAX_SOURCES - 1; ++i) {
    if (!found && q >= src.planes[i]) {
      q -= src.planes[i];
      base = src.p[s][i + 1];
    } else {
      found = true;
    }
  }
  return base + (size_t)q * hw;
}

__global__ void __launch_bounds__(256) halo_mesh_kernel(const __grid_constant__ MeshSrc src,
                                                        int ny, int nx, int P, int h, int w,
                                                        int k, int xh, int bot_off, int left_off,
                                                        int right_off, int stride,
                                                        unsigned* out) {
  // blockIdx.z: the shard (row-major); blockIdx.y: its piece (0 top, 1 bot,
  // 2 left, 3 right); x: the piece's words. Block-uniform shard and piece
  // leave two divisions a thread for the word's place in its piece.
  const int s = blockIdx.z, piece = blockIdx.y;
  const int iy = s / nx, ix = s - iy * nx;
  const int up = (iy + ny - 1) % ny, down = (iy + 1) % ny;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int hw = h * w;
  unsigned v;
  if (piece < 2) {
    if (ny == 1 || j >= P * k * w) return;
    const int qr = j / w, x = j - qr * w;
    const int q = qr / k, r = qr - q * k;
    v = piece ? mesh_plane(src, down * nx + ix, q, hw)[r * w + x]
              : mesh_plane(src, up * nx + ix, q, hw)[(h - k + r) * w + x];
    out[(size_t)s * stride + (piece ? bot_off : 0) + j] = v;
  } else {
    const int bh = h + 2 * k;
    if (nx == 1 || j >= P * bh * xh) return;
    const int qy = j / xh, c = j - qy * xh;
    const int q = qy / bh, ry = qy - q * bh;
    const bool is_right = piece == 3;
    const int sx = is_right ? (ix + 1) % nx : (ix + nx - 1) % nx;
    const int x = is_right ? c : w - xh + c;
    if (ry < k)
      v = ny > 1 ? mesh_plane(src, up * nx + sx, q, hw)[(h - k + ry) * w + x] : 0u;
    else if (ry >= h + k)
      v = ny > 1 ? mesh_plane(src, down * nx + sx, q, hw)[(ry - h - k) * w + x] : 0u;
    else
      v = mesh_plane(src, iy * nx + sx, q, hw)[(ry - k) * w + x];
    out[(size_t)s * stride + (is_right ? right_off : left_off) + j] = v;
  }
}

}  // namespace

extern "C" int jrl_halo_mesh(const MeshSrc* src, int ny, int nx, int P, int h, int w, int k,
                             int xh, int bot_off, int left_off, int right_off, int stride,
                             unsigned* out, void* stream) {
  const int nr = ny > 1 ? P * k * w : 0, nc = nx > 1 ? P * (h + 2 * k) * xh : 0;
  const int n = nr > nc ? nr : nc;
  const dim3 grid((n + 255) / 256, 4, ny * nx);
  halo_mesh_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      *src, ny, nx, P, h, w, k, xh, bot_off, left_off, right_off, stride, out);
  return (int)cudaGetLastError();
}

extern "C" const char* jrl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
