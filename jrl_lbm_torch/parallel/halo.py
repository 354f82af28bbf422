"""Halo exchange over a 2D mesh of shards (counterpart of the JAX
package's `parallel/halo.py`).

The two collectives the sharded runners use, written once for both kinds
of mesh (`mesh.py`):

* `ppermute` moves one block per shard one step along a ring of the mesh
  (JAX's ``jax.lax.ppermute`` with `ring_perm`): device copies on a local
  mesh, ``dist.batch_isend_irecv`` on a process group. A ring of one is
  the identity.
* `psum` sums one tensor per shard: a fixed-order sum on a local mesh (so
  runs repeat bit for bit), ``dist.all_reduce`` on a process group.

`pad_halo` pads every shard with its periodic global neighbours in two
axis-separable phases (rows, then the columns of the row-padded block),
so the corner cells are right without a corner message, and the ring of
each axis gives the global wrap. `DomainInfo` carries a shard's global
coordinates. These are plain PyTorch; the JRL kernels exchange O(surface)
pieces instead (`kernels/halo.py`).
"""

from __future__ import annotations

import dataclasses

import torch

from jrl_lbm_torch.parallel.mesh import AXIS_X, AXIS_Y, Mesh
from jrl_lbm_torch.utils.device import resolve_device


def ring_perm(n: int, shift: int):
    """Permutation sending shard i's block to shard (i + shift) mod n."""
    return [(i, (i + shift) % n) for i in range(n)]


def _axis(axis) -> int:
    if axis in (AXIS_Y, 0):
        return 0
    if axis in (AXIS_X, 1):
        return 1
    raise ValueError(f"unknown mesh axis {axis!r}")


def _moved(coord, a: int, d: int, n: int):
    c = list(coord)
    c[a] = (c[a] + d) % n
    return tuple(c)


def ppermute(blocks, mesh: Mesh, axis, shift: int):
    """One block per shard this process holds (``mesh.local`` order) moved
    ``shift`` shards along ``axis``: the shard at index i of the axis
    receives the block of the shard at i - shift (mod the axis length)."""
    a = _axis(axis)
    n = mesh.shape[a]
    if n == 1 or shift % n == 0:
        return list(blocks)
    if mesh.group is None:
        by = dict(zip(mesh.local, blocks))
        return [by[_moved(c, a, -shift, n)].to(mesh.devices[c]) for c in mesh.local]
    import torch.distributed as dist

    (c,) = mesh.local
    x = blocks[0].contiguous()
    buf = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, mesh.rank_of(_moved(c, a, shift, n)), mesh.group),
           dist.P2POp(dist.irecv, buf, mesh.rank_of(_moved(c, a, -shift, n)), mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [buf]


def psum(xs, mesh: Mesh) -> torch.Tensor:
    """The sum over all shards of one tensor per shard this process holds,
    on the device of its first; every process gets the whole sum."""
    if mesh.group is None:
        total = xs[0]
        for x in xs[1:]:
            total = total + x.to(total.device)
        return total
    import torch.distributed as dist

    total = xs[0].clone()
    dist.all_reduce(total, group=mesh.group)
    return total


def pad_halo(blocks, mesh: Mesh):
    """Each block ``[..., h, w]`` of the shards this process holds padded
    to ``[..., h+2, w+2]`` with the periodic global neighbours, corners
    included (rows first, then the columns of the row-padded blocks)."""
    top = ppermute([b[..., -1:, :] for b in blocks], mesh, AXIS_Y, 1)
    bot = ppermute([b[..., :1, :] for b in blocks], mesh, AXIS_Y, -1)
    rows = [torch.cat([t, b, u], dim=-2) for t, b, u in zip(top, blocks, bot)]
    left = ppermute([r[..., :, -1:] for r in rows], mesh, AXIS_X, 1)
    right = ppermute([r[..., :, :1] for r in rows], mesh, AXIS_X, -1)
    return [torch.cat([lf, r, rt], dim=-1) for lf, r, rt in zip(left, rows, right)]


@dataclasses.dataclass(frozen=True)
class DomainInfo:
    """Global-domain context of one shard."""

    h: int  # local block rows
    w: int  # local block cols
    H: int  # global rows
    W: int  # global cols
    gy: torch.Tensor  # [h, w] global row index of each local cell
    gx: torch.Tensor  # [h, w] global col index
    axis_x: bool  # axisymmetric about x = 0
    axis_y: bool

    @property
    def at_x0(self):
        return self.gx == 0

    @property
    def at_xW(self):
        return self.gx == self.W - 1

    @property
    def at_y0(self):
        return self.gy == 0

    @property
    def at_yH(self):
        return self.gy == self.H - 1


def make_domain(local_shape, global_shape, coord, axisymmetric_type: int = 0,
                device=None) -> DomainInfo:
    """The DomainInfo of the shard at mesh coordinate ``coord = (iy, ix)``
    (JAX reads the coordinate from the mesh axes inside ``shard_map``),
    its index tensors on ``device``: the shard's device, which a caller
    passes (``mesh.devices[coord]``); None means the card, and raises
    without one."""
    device = resolve_device("cuda" if device is None else device)
    h, w = local_shape
    H, W = global_shape
    iy, ix = coord
    gy = iy * h + torch.arange(h, dtype=torch.int32, device=device)[:, None].expand(h, w)
    gx = ix * w + torch.arange(w, dtype=torch.int32, device=device)[None, :].expand(h, w)
    return DomainInfo(h=h, w=w, H=H, W=W, gy=gy, gx=gx,
                      axis_x=int(axisymmetric_type) == 1, axis_y=int(axisymmetric_type) == 2)


def make_single_domain(shape, axisymmetric_type: int = 0, device=None) -> DomainInfo:
    """DomainInfo for an unsharded array (the whole domain on one device;
    ``device`` as for `make_domain`)."""
    return make_domain(shape, shape, (0, 0), axisymmetric_type, device)


def pad_periodic(x: torch.Tensor) -> torch.Tensor:
    """Single-device halo pad: periodic wrap."""
    xp = torch.cat([x[..., -1:, :], x, x[..., :1, :]], dim=-2)
    return torch.cat([xp[..., :, -1:], xp, xp[..., :, :1]], dim=-1)
