"""Halo pieces of the shards of a mesh: the row pieces and edge blocks
the sharded JRL and cylinder kernels read (`jrl_sharded.py`,
`cyl_sharded.py`), packed by a CUDA kernel (`csrc/halo_pack.cu`) and
moved by `parallel/halo.py::ppermute`.

Replaces the TPU kernels ``fused_sharded.py::_edge_blocks`` (the first
and last lane blocks of a shard) and ``_edge_cols`` (the first and last
lane: the columns phase at ``xh = 1``), and the row slices of
``fused_jrl_sharded.py::_pieces`` and ``fused_sharded.py::_halo_pieces``.
A shard's halo arrives in two phases, as `parallel/halo.py::pad_halo`
orders them, so the corners ride the second hop:

1. rows (``ny > 1``): rows ``[0, k)`` and ``[h-k, h)`` of every plane of a
   field group go to the y neighbours, which keep them as their ``bot``
   and ``top`` pieces (global rows row0+h .. row0+h+k-1 and row0-k ..
   row0-1, mod H): ``[P, w]`` for k = 1, ``[P, k, w]`` for k > 1. No 8-row
   padding: that was Mosaic's block granularity.
2. columns (``nx > 1``): the first and last ``xh`` columns of the block
   extended by the received rows go to the x neighbours, which keep them
   as their ``right`` and ``left`` blocks ``[P, h+2k, xh]``.

`halo_pack` packs one phase of one group in one launch, into one
contiguous buffer per neighbour, which is what ``batch_isend_irecv``
needs; its twin slices and concatenates. A group is up to
``MAX_SOURCES`` tensors of one 32-bit dtype (an int32 flags plane rides
a float32 group as ``flags.view(torch.float32)``, its bits unchanged). A
wrapper given tensors on the CPU runs the twin; given tensors on the card
it launches the kernel or raises. ``halo_pack.launches`` counts the
launches.
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

MAX_SOURCES = 5  # tensors of a field group: up to the cylinder's flags, f, vel, phi, rho


def as_planes(t: torch.Tensor) -> torch.Tensor:
    """``t`` as ``[P, h, w]``: a ``[h, w]`` field is one plane."""
    return t.reshape((-1,) + tuple(t.shape[-2:]))


def _rows3(piece, k: int):
    """A row piece as ``[P, k, w]`` (k = 1 pieces are kept as ``[P, w]``)."""
    return None if piece is None else piece.reshape(piece.shape[0], k, piece.shape[-1])


def _rows_out(x, k: int):
    return x[:, 0] if k == 1 else x


def halo_pack_ref(planes, top=None, bot=None, xh: int = 0, rows: int = 1):
    """Twin of `halo_pack`: ``planes`` is a list of ``[..., h, w]``
    tensors (one field group, planes in order)."""
    x = torch.cat([as_planes(t) for t in planes], dim=0)
    P, h, w = x.shape
    k = int(rows)
    if not xh:
        return _rows_out(x[:, :k], k).contiguous(), _rows_out(x[:, h - k:], k).contiguous()
    z = torch.zeros((P, k, w), dtype=x.dtype, device=x.device)
    t, b = _rows3(top, k), _rows3(bot, k)
    ext = torch.cat([z if t is None else t, x, z if b is None else b], dim=1)
    return ext[..., :xh].contiguous(), ext[..., w - xh:].contiguous()


class PackSrc(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p * MAX_SOURCES), ("planes", ctypes.c_int * MAX_SOURCES)]


def halo_pack(planes, top=None, bot=None, xh: int = 0, rows: int = 1):
    """One phase of a shard's halo for one field group ``planes`` (one to
    ``MAX_SOURCES`` ``[..., h, w]`` tensors of one 32-bit dtype, planes in
    order), ``rows`` = k rows deep: with ``xh == 0`` the rows phase, rows
    ``[0, k)`` and ``[h-k, h)`` of every plane as two buffers (``[P, w]``
    for k = 1, ``[P, k, w]`` else); with ``xh > 0`` the columns phase, the
    first and last ``xh`` columns of the block extended by the received
    ``top`` and ``bot`` pieces (zeros where None) as two ``[P, h+2k, xh]``
    buffers."""
    if planes[0].device.type == "cpu":
        return halo_pack_ref(planes, top, bot, xh, rows)
    if not 1 <= len(planes) <= MAX_SOURCES:
        raise ValueError(f"{len(planes)} tensors in a group (1 .. {MAX_SOURCES})")
    h, w = planes[0].shape[-2:]
    k = int(rows)
    if not 1 <= k <= h:
        raise ValueError(f"rows={rows} outside 1 .. {h}")
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
            if piece is not None and (piece.numel() != P * k * w or piece.shape[-1] != w
                                      or piece.device != dev or piece.dtype != dt
                                      or not piece.is_contiguous()):
                raise ValueError(f"row piece must be a contiguous [{P}, {k}, {w}] tensor")
        first = torch.empty((P, h + 2 * k, xh), dtype=dt, device=dev)
        last = torch.empty_like(first)
        fn = build.bind("halo_pack", "jrl_halo_cols", [_P, _P, _P] + [ctypes.c_int] * 5
                        + [_P, _P, _P])
        with torch.cuda.device(dev):
            err = fn(ctypes.byref(src), None if top is None else top.data_ptr(),
                     None if bot is None else bot.data_ptr(), P, h, w, k, xh, first.data_ptr(),
                     last.data_ptr(), stream_of(dev))
    else:
        shape = (P, w) if k == 1 else (P, k, w)
        first = torch.empty(shape, dtype=dt, device=dev)
        last = torch.empty_like(first)
        fn = build.bind("halo_pack", "jrl_halo_rows", [_P] + [ctypes.c_int] * 4 + [_P, _P, _P])
        with torch.cuda.device(dev):
            err = fn(ctypes.byref(src), P, h, w, k, first.data_ptr(), last.data_ptr(),
                     stream_of(dev))
    build.check(err, "halo_pack")
    halo_pack.launches += 1
    return first, last


halo_pack.launches = 0


@dataclasses.dataclass
class Halo:
    """A shard's halo of one field group of ``P`` planes, ``k`` rows deep:
    row pieces ``top``, ``bot`` (``[P, w]`` for k = 1, ``[P, k, w]`` else;
    None on a mesh with one row of shards), column blocks ``left``,
    ``right`` ``[P, h+2k, xh]`` (None on a mesh with one column)."""

    P: int
    top: Optional[torch.Tensor] = None
    bot: Optional[torch.Tensor] = None
    left: Optional[torch.Tensor] = None
    right: Optional[torch.Tensor] = None
    k: int = 1


def row_pieces(groups, mesh: Mesh, rows: int = 1):
    """``(top, bot)`` per shard this process holds: each group's first and
    last ``rows`` rows (`halo_pack`) moved one shard up and down the ``dy``
    ring (JAX's ``_pieces`` without the 8-row padding)."""
    packs = [halo_pack(g, rows=rows) for g in groups]
    tops = ppermute([last for _, last in packs], mesh, AXIS_Y, 1)
    bots = ppermute([first for first, _ in packs], mesh, AXIS_Y, -1)
    return list(zip(tops, bots))


def edge_blocks(groups, pieces, mesh: Mesh, xh: int, rows: int = 1):
    """``(left, right)`` per shard: the first and last ``xh`` columns of
    each group's block extended by its ``rows``-row pieces (`halo_pack`)
    moved one shard along the ``dx`` ring (JAX's ``_xblocks``, corners
    included)."""
    packs = [halo_pack(g, t, b, xh, rows) for g, (t, b) in zip(groups, pieces)]
    lefts = ppermute([last for _, last in packs], mesh, AXIS_X, 1)
    rights = ppermute([first for first, _ in packs], mesh, AXIS_X, -1)
    return list(zip(lefts, rights))


def exchange(groups, mesh: Mesh, xh: int, rows: int = 1):
    """The `Halo` of each shard this process holds for one field group per
    shard (``groups[i]``: the group's tensors on shard ``mesh.local[i]``),
    ``rows`` rows and ``xh`` lanes deep (``xh = 0``: no column blocks).
    Every process posts the same exchanges whatever its shards compute."""
    ny, nx = mesh.shape
    P = sum(as_planes(t).shape[0] for t in groups[0])
    pieces = row_pieces(groups, mesh, rows) if ny > 1 else [(None, None)] * len(groups)
    blocks = edge_blocks(groups, pieces, mesh, xh, rows) if nx > 1 and xh \
        else [(None, None)] * len(groups)
    return [Halo(P, t, b, lf, rt, int(rows)) for (t, b), (lf, rt) in zip(pieces, blocks)]
