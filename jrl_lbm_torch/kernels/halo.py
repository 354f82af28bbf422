"""Halo pieces of the shards of a mesh: the row pieces and edge blocks
the sharded JRL kernels read (`jrl_sharded.py`), packed by a CUDA kernel
(`csrc/halo_pack.cu`) and moved by `parallel/halo.py::ppermute`.

Replaces the TPU kernel ``fused_sharded.py::_edge_blocks`` (the first and
last lane blocks of a shard) and the row slices of
``fused_jrl_sharded.py::_pieces``. A shard's halo arrives in two phases,
as `parallel/halo.py::pad_halo` orders them, so the corners ride the
second hop:

1. rows (``ny > 1``): row 0 and row h-1 of every plane of a field group go
   to the y neighbours, which keep them as their ``bot`` and ``top``
   pieces ``[P, w]`` (global rows row0+h and row0-1, mod H). No 8-row
   padding: that was Mosaic's block granularity.
2. columns (``nx > 1``): the first and last ``xh`` columns of the block
   extended by the received rows go to the x neighbours, which keep them
   as their ``right`` and ``left`` blocks ``[P, h+2, xh]``.

`halo_pack` packs one phase of one group in one launch, into one
contiguous buffer per neighbour, which is what ``batch_isend_irecv``
needs; its twin slices and concatenates. A wrapper given tensors on the
CPU runs the twin; given tensors on the card it launches the kernel or
raises. ``halo_pack.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from jrl_lbm_torch.kernels import build
from jrl_lbm_torch.kernels.jrl_fluid import _P, stream_of
from jrl_lbm_torch.parallel.halo import ppermute
from jrl_lbm_torch.parallel.mesh import AXIS_X, AXIS_Y, Mesh

MAX_SOURCES = 2  # tensors of a field group: f and vel, rho and vel


def as_planes(t: torch.Tensor) -> torch.Tensor:
    """``t`` as ``[P, h, w]``: a ``[h, w]`` field is one plane."""
    return t.reshape((-1,) + tuple(t.shape[-2:]))


def halo_pack_ref(planes, top=None, bot=None, xh: int = 0):
    """Twin of `halo_pack`: ``planes`` is a list of ``[..., h, w]``
    tensors (one field group, planes in order)."""
    x = torch.cat([as_planes(t) for t in planes], dim=0)
    if not xh:
        return x[:, 0].contiguous(), x[:, -1].contiguous()
    P, h, w = x.shape
    z = torch.zeros((P, 1, w), dtype=x.dtype, device=x.device)
    ext = torch.cat([z if top is None else top[:, None], x, z if bot is None else bot[:, None]],
                    dim=1)
    return ext[..., :xh].contiguous(), ext[..., w - xh:].contiguous()


class PackSrc(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p * MAX_SOURCES), ("planes", ctypes.c_int * MAX_SOURCES)]


def halo_pack(planes, top=None, bot=None, xh: int = 0):
    """One phase of a shard's halo for one field group ``planes`` (one or
    two ``[..., h, w]`` tensors of one 32-bit dtype, planes in order):
    with ``xh == 0`` the rows phase, ``(row 0, row h-1)`` of every plane as
    two ``[P, w]`` buffers; with ``xh > 0`` the columns phase, the first
    and last ``xh`` columns of the block extended by the received ``top``
    and ``bot`` pieces (zeros where None) as two ``[P, h+2, xh]`` buffers."""
    if planes[0].device.type == "cpu":
        return halo_pack_ref(planes, top, bot, xh)
    if not 1 <= len(planes) <= MAX_SOURCES:
        raise ValueError(f"{len(planes)} tensors in a group (1 .. {MAX_SOURCES})")
    h, w = planes[0].shape[-2:]
    dev, dt = planes[0].device, planes[0].dtype
    for t in planes:
        if tuple(t.shape[-2:]) != (h, w) or t.device != dev or t.dtype != dt \
                or t.element_size() != 4 or not t.is_contiguous():
            raise ValueError("a group holds contiguous 32-bit [..., h, w] tensors of one dtype "
                             "on one card")
    counts = [as_planes(t).shape[0] for t in planes]
    P = sum(counts)
    src = PackSrc()
    for i, t in enumerate(planes):
        src.p[i] = t.data_ptr()
        src.planes[i] = counts[i]
    if xh:
        if not 1 <= xh <= w:
            raise ValueError(f"xh={xh} outside 1 .. {w}")
        for piece in (top, bot):
            if piece is not None and (tuple(piece.shape) != (P, w) or piece.device != dev
                                      or piece.dtype != dt or not piece.is_contiguous()):
                raise ValueError(f"row piece must be a contiguous [{P}, {w}] tensor")
        first = torch.empty((P, h + 2, xh), dtype=dt, device=dev)
        last = torch.empty_like(first)
        fn = build.bind("halo_pack", "jrl_halo_cols", [_P, _P, _P] + [ctypes.c_int] * 4
                        + [_P, _P, _P])
        with torch.cuda.device(dev):
            err = fn(ctypes.byref(src), None if top is None else top.data_ptr(),
                     None if bot is None else bot.data_ptr(), P, h, w, xh, first.data_ptr(),
                     last.data_ptr(), stream_of(dev))
    else:
        first = torch.empty((P, w), dtype=dt, device=dev)
        last = torch.empty_like(first)
        fn = build.bind("halo_pack", "jrl_halo_rows", [_P] + [ctypes.c_int] * 3 + [_P, _P, _P])
        with torch.cuda.device(dev):
            err = fn(ctypes.byref(src), P, h, w, first.data_ptr(), last.data_ptr(),
                     stream_of(dev))
    build.check(err, "halo_pack")
    halo_pack.launches += 1
    return first, last


halo_pack.launches = 0


@dataclasses.dataclass
class Halo:
    """A shard's halo of one field group of ``P`` planes: row pieces
    ``top``, ``bot`` ``[P, w]`` (None on a mesh with one row of shards),
    column blocks ``left``, ``right`` ``[P, h+2, xh]`` (None on a mesh with
    one column)."""

    P: int
    top: Optional[torch.Tensor] = None
    bot: Optional[torch.Tensor] = None
    left: Optional[torch.Tensor] = None
    right: Optional[torch.Tensor] = None


def row_pieces(groups, mesh: Mesh):
    """``(top, bot)`` per shard this process holds: each group's row 0 and
    row h-1 (`halo_pack`) moved one shard up and down the ``dy`` ring
    (JAX's ``_pieces`` without the 8-row padding)."""
    packs = [halo_pack(g) for g in groups]
    tops = ppermute([last for _, last in packs], mesh, AXIS_Y, 1)
    bots = ppermute([first for first, _ in packs], mesh, AXIS_Y, -1)
    return list(zip(tops, bots))


def edge_blocks(groups, pieces, mesh: Mesh, xh: int):
    """``(left, right)`` per shard: the first and last ``xh`` columns of
    each group's block extended by its row pieces (`halo_pack`) moved one
    shard along the ``dx`` ring (JAX's ``_xblocks``, corners included)."""
    packs = [halo_pack(g, t, b, xh) for g, (t, b) in zip(groups, pieces)]
    lefts = ppermute([last for _, last in packs], mesh, AXIS_X, 1)
    rights = ppermute([first for first, _ in packs], mesh, AXIS_X, -1)
    return list(zip(lefts, rights))


def exchange(groups, mesh: Mesh, xh: int):
    """The `Halo` of each shard this process holds for one field group per
    shard (``groups[i]``: the group's tensors on shard ``mesh.local[i]``).
    Every process posts the same exchanges whatever its shards compute."""
    ny, nx = mesh.shape
    P = sum(as_planes(t).shape[0] for t in groups[0])
    pieces = row_pieces(groups, mesh) if ny > 1 else [(None, None)] * len(groups)
    blocks = edge_blocks(groups, pieces, mesh, xh) if nx > 1 else [(None, None)] * len(groups)
    return [Halo(P, t, b, lf, rt) for (t, b), (lf, rt) in zip(pieces, blocks)]
