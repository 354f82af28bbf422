// One shard of a (ny, nx) mesh of the cylinder channel, read in global
// coordinates: the accessors through which the unchanged cell code of
// cyl_common.cuh (full_cell, lean_cell, tile_run) runs on a shard, so
// that a sharded step computes what the unsharded kernels compute.
//
// A shard owns rows row0 .. row0+h-1 and columns col0 .. col0+w-1 of the
// H x W grid. What its cells read beyond that arrives as halo pieces
// (kernels/halo.py, packed by halo_pack.cu): k rows above and k rows below
// (mod H, so the ring of shards gives the global FLUID wrap), and, when
// the mesh has more than one column of shards, xh-lane column blocks left
// and right of the k-row-extended block (corners included, mod W). One
// full step reaches one cell (an OUTFLOW cell's second row inward stays
// inside a shard of h, w >= 3), so a k-step tile needs k rows and k lanes;
// a read beyond the pieces gives 0 and only ever feeds a cell outside a
// tile's own cells.
#pragma once

#include "cyl_common.cuh"

// The shard's place in the grid, filled by the Python wrapper (ctypes.Structure,
// kernels/cyl_sharded.py::CylShardGeom).
struct CylShardGeom {
  int H, W;        // the global grid
  int h, w;        // the shard's body
  int row0, col0;  // its first global row and column
  int k;           // rows of each row piece (the column blocks span h + 2k rows)
  int xh;          // lanes of each column block; 0 when the mesh has one column
};

namespace cyl {

// P planes of one field of a shard and their halo pieces (null where the
// mesh has no neighbour along that axis): body [P][h][w]; top, bot
// [P][k][w] (global rows row0-k .. row0-1 and row0+h .. row0+h+k-1, mod
// H); left, right [P][h+2k][xh] (columns col0-xh .. col0-1 and col0+w ..
// col0+w+xh-1, mod W, on rows row0-k .. row0+h+k-1).
template <class T>
struct ShardPlanesK {
  const T* body;
  const T* top;
  const T* bot;
  const T* left;
  const T* right;

  // plane q at global (gy, gx) in [0, H) x [0, W); 0 beyond the pieces
  __device__ __forceinline__ T at(const CylShardGeom& s, int q, int gy, int gx) const {
    int ly = gy - s.row0;
    if (ly < 0) ly += s.H;
    int ry;  // row in the k-extended block: row0 - k is row 0
    if (ly < s.h + s.k)
      ry = ly + s.k;
    else if (ly >= s.H - s.k)
      ry = ly - (s.H - s.k);
    else
      return T(0);
    int lx = gx - s.col0;
    if (lx < 0) lx += s.W;
    if (lx < s.w) {
      if (ly < s.h) return body[(q * s.h + ly) * s.w + lx];
      if (ry < s.k) return top[(q * s.k + ry) * s.w + lx];
      return bot[(q * s.k + ry - s.k - s.h) * s.w + lx];
    }
    const int bh = s.h + 2 * s.k;
    if (lx < s.w + s.xh) return right[(q * bh + ry) * s.xh + lx - s.w];
    if (lx >= s.W - s.xh) return left[(q * bh + ry) * s.xh + lx - (s.W - s.xh)];
    return T(0);
  }
};

// The fields a sharded cylinder kernel reads (kernels/cyl_sharded.py::
// CylShardSrc): f [9], vel [2], phi, rho, and the flags as int32 words (a
// flags plane crosses the exchange as the float32 view of its bits).
struct CylShardSrc {
  ShardPlanesK<float> f, vel, phi, rho;
  ShardPlanesK<int> flags;
};

// cyl_common.cuh::GlobalAcc's interface on a shard: the previous step
// around global cell (y, x), offsets taken mod H / W.
struct ShardCylAcc {
  CylShardSrc src;
  CylShardGeom s;
  int y, x;
  __device__ __forceinline__ int gy(int dy) const { return jrl::wrap1(y + dy, s.H); }
  __device__ __forceinline__ int gx(int dx) const { return jrl::wrap1(x + dx, s.W); }
  __device__ __forceinline__ float F(int q, int dy, int dx) const {
    return src.f.at(s, q, gy(dy), gx(dx));
  }
  __device__ __forceinline__ int flag(int dy, int dx) const {
    return src.flags.at(s, 0, gy(dy), gx(dx));
  }
  __device__ __forceinline__ float ph(int dy, int dx) const {
    return src.phi.at(s, 0, gy(dy), gx(dx));
  }
  __device__ __forceinline__ float vx(int dy, int dx) const {
    return src.vel.at(s, 0, gy(dy), gx(dx));
  }
  __device__ __forceinline__ float vy(int dy, int dx) const {
    return src.vel.at(s, 1, gy(dy), gx(dx));
  }
};

// The same interface on (h+2, w+2) planes padded by parallel/halo.py::
// pad_halo (f, vel, flags), around local cell (ly, lx), as the JAX
// package's _PadPlane; phi is read in the body (only at the cell and an
// OUTFLOW cell's inward neighbour, both inside the shard).
struct PaddedCylAcc {
  const float* fp;   // [9][h+2][w+2]
  const float* vp;   // [2][h+2][w+2]
  const int* flp;    // [h+2][w+2]
  const float* phi;  // [h][w]
  int h, w, ly, lx;
  __device__ __forceinline__ int pidx(int dy, int dx) const {
    return (ly + 1 + dy) * (w + 2) + lx + 1 + dx;
  }
  __device__ __forceinline__ float F(int q, int dy, int dx) const {
    return fp[q * (h + 2) * (w + 2) + pidx(dy, dx)];
  }
  __device__ __forceinline__ int flag(int dy, int dx) const { return flp[pidx(dy, dx)]; }
  __device__ __forceinline__ float ph(int dy, int dx) const {
    return phi[(ly + dy) * w + lx + dx];
  }
  __device__ __forceinline__ float vx(int dy, int dx) const { return vp[pidx(dy, dx)]; }
  __device__ __forceinline__ float vy(int dy, int dx) const {
    return vp[(h + 2) * (w + 2) + pidx(dy, dx)];
  }
};

// tile_run on a shard: the tile (row tile by of height ty, column tile bx)
// of the shard rows [r0, r1) (local), loaded through the pieces and
// stored into the shard's local planes [P][h][w] of f_out, rho_out,
// vel_out. OBSTACLE cells of the full modes keep the shard's rho.
template <int MODE, int k, bool YB>
__device__ __forceinline__ void shard_tile(const CylShardSrc& src, const CylShardGeom& s,
                                           const CylParams& p, int r0, int r1, float* f_out,
                                           float* rho_out, float* vel_out) {
  constexpr bool FULL = MODE != LEAN, VEL = MODE == FULL_CYL;
  const int hw = s.h * s.w;
  tile_run<MODE, k, YB>(
      p, s.row0 + r0 + (int)blockIdx.y * tile_ty(MODE) - k,
      s.col0 + (int)blockIdx.x * tile_tx(k) - k, s.row0 + r1, s.col0 + s.w,
      [&](int gy, int gx, TileIn& in) {
#pragma unroll
        for (int q = 0; q < 9; ++q) in.f[q] = src.f.at(s, q, gy, gx);
        if (VEL) {
          in.vx = src.vel.at(s, 0, gy, gx);
          in.vy = src.vel.at(s, 1, gy, gx);
          in.ph = src.phi.at(s, 0, gy, gx);
        }
        if (FULL) in.fl = src.flags.at(s, 0, gy, gx);
      },
      [&](int yy, int xx, const float fo[9], float r, float ux, float uy) {
        const int c = (yy - s.row0) * s.w + (xx - s.col0);
#pragma unroll
        for (int q = 0; q < 9; ++q) f_out[q * hw + c] = fo[q];
        if (FULL && src.flags.body[c] == OBSTACLE) r = src.rho.body[c];
        rho_out[c] = r;
        vel_out[c] = ux;
        vel_out[hw + c] = uy;
      });
}

}  // namespace cyl
