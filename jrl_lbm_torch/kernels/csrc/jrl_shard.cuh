// One shard of a (ny, nx) mesh, read in global coordinates: the accessor
// and the flag and velocity sources through which the unchanged JRL cell
// code (jrl_fluid.cuh, jrl_c.cuh) runs on a shard, so that a sharded step
// computes what the unsharded kernels compute, bit for bit.
//
// A shard owns rows row0 .. row0+h-1 and columns col0 .. col0+w-1 of the
// H x W grid. What its cells read beyond that arrives as halo pieces
// (kernels/halo.py, packed by halo_pack.cu): the row above and the row
// below (mod H, so the ring of shards gives the global FLUID wrap), and,
// when the mesh has more than one column of shards, xh-lane column blocks
// left and right of the row-extended block (corners included, mod W).
// The cell code reaches at most one row beyond a shard (an OUTFLOW cell's
// second row stays inside a shard of h >= 2) and at most two columns (the
// OUTFLOW column W-1 reads W-3; the approach's disk recomputes the new C
// one column right of the shard), so xh = 2 lanes; a read farther out is
// a bug of the caller. A k-step pass of a column shard (fluid_pass_sh.cu,
// c_balance_pass_sh.cu, c_approach_pass_sh.cu) reads 2k lanes and 2k rows
// beyond it instead, from blocks of
// pass_sh.cuh::sh_pass_xh(k) lanes of the rows row0-2k .. row0+h+2k-1,
// which its own window copy reads (not this accessor).
#pragma once

#include "jrl_common.cuh"

// The shard's place in the grid, filled by the Python wrapper (ctypes.Structure).
struct ShardGeom {
  int H, W;        // the global grid
  int h, w;        // the shard's body
  int row0, col0;  // its first global row and column
  int xh;          // lanes of each column block (2; a pass: sh_pass_xh(k)); 0 when the
                   // mesh has one column
};

namespace jrl {

// P planes of one field of a shard and their halo pieces (null where the
// mesh has no neighbour along that axis): body [P][h][w]; top, bot [P][w]
// (global rows row0-1 and row0+h, mod H); left, right [P][h+2][xh]
// (columns col0-xh .. col0-1 and col0+w .. col0+w+xh-1, mod W, on rows
// row0-1 .. row0+h).
template <class T>
struct ShardPlanes {
  const T* body;
  const T* top;
  const T* bot;
  const T* left;
  const T* right;

  // plane q at global (gy, gx) in [0, H) x [0, W)
  __device__ __forceinline__ T at(const ShardGeom& s, int q, int gy, int gx) const {
    int ly = gy - s.row0;
    if (ly < 0) ly += s.H;
    int lx = gx - s.col0;
    if (lx < 0) lx += s.W;
    if (lx < s.w) {
      if (ly < s.h) return body[(q * s.h + ly) * s.w + lx];
      return (ly == s.h ? bot : top)[q * s.w + lx];
    }
    const int ry = ly < s.h + 1 ? ly + 1 : 0;  // row in the block: row0-1 is row 0
    if (lx < s.w + s.xh) return right[(q * (s.h + 2) + ry) * s.xh + (lx - s.w)];
    return left[(q * (s.h + 2) + ry) * s.xh + (lx - (s.W - s.xh))];
  }
};

// The state accessor of jrl_common.cuh::GlobalState on a shard: f, rho and
// vel around the global cell (y, x). A field whose pieces are null is read
// in the body only.
struct ShardState {
  ShardPlanes<float> f, rho, vel;
  ShardGeom s;
  int y, x;
  __device__ __forceinline__ int gy(int dy) const { return wrap1(y + dy, s.H); }
  __device__ __forceinline__ int gx(int dx) const { return wrap1(x + dx, s.W); }
  __device__ __forceinline__ float F(int q, int dy, int dx) const { return f.at(s, q, gy(dy), gx(dx)); }
  __device__ __forceinline__ float R(int dy, int dx) const { return rho.at(s, 0, gy(dy), gx(dx)); }
  __device__ __forceinline__ float U(int dy, int dx) const { return vel.at(s, 0, gy(dy), gx(dx)); }
  __device__ __forceinline__ float V(int dy, int dx) const { return vel.at(s, 1, gy(dy), gx(dx)); }
  __device__ __forceinline__ ShardState at(int dy, int dx) const {
    return ShardState{f, rho, vel, s, gy(dy), gx(dx)};
  }
};

// Flags of a shard at global (y, x): the flag source of BalanceGeoT and
// ApproachGeo (GlobalPlane's interface).
struct ShardFlags {
  ShardPlanes<int> p;
  ShardGeom s;
  __device__ __forceinline__ int at(int y, int x) const { return p.at(s, 0, y, x); }
};

// The interpolated stored velocity [2][h][w] of a shard, read at a global
// linear index y * W + x (ApproachGeo's velocity interface). Off the body it
// reads 0: the only such read is the disk's recompute of the new C one
// column right of the shard, which reads the velocity only at an INFLOW or
// INFLOW_2 cell, and neither lies on the disk's rows within x <= rint (the
// JAX package's extension lanes read 0 there alike).
struct ShardVel {
  const float* vel;
  ShardGeom s;
  __device__ __forceinline__ float read(int i, int c) const {
    const int gy = i / s.W, gx = i - gy * s.W;
    const int ly = gy - s.row0, lx = gx - s.col0;
    if (ly < 0 || ly >= s.h || lx < 0 || lx >= s.w) return 0.0f;
    return vel[(c * s.h + ly) * s.w + lx];
  }
  __device__ __forceinline__ float u(int i) const { return read(i, 0); }
  __device__ __forceinline__ float v(int i) const { return read(i, 1); }
};

}  // namespace jrl
