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
a float32 group as ``flags.view(torch.float32)``, its bits unchanged).

Where every shard of a local mesh sits on one device, the neighbours'
tensors are all in one memory, and `halo_mesh` computes the whole
exchange of a group in one launch (same file, ``jrl_halo_mesh``): every
shard's received pieces, corners included, read straight from the shards
that own them into one buffer, each piece a 128-byte aligned view of it.
`exchange` takes that route there (``route="mesh"``) and the two phases
of `halo_pack` + `ppermute` (``route="shards"``) on process groups and
on meshes over several cards; ``"shards"`` stays the yardstick.

A wrapper given tensors on the CPU runs the twin; given tensors on the
card it launches the kernel or raises. ``halo_pack.launches`` and
``halo_mesh.launches`` count the launches.
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
MAX_MESH_SHARDS = 64  # shards of a mesh that `halo_mesh` takes (csrc/halo_pack.cu)
PIECE_ALIGN = 32  # words: each piece of `halo_mesh`'s buffer starts on 128 bytes


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


class MeshSrc(ctypes.Structure):
    _fields_ = [("p", (ctypes.c_void_p * MAX_SOURCES) * MAX_MESH_SHARDS),
                ("planes", ctypes.c_int * MAX_SOURCES)]


@dataclasses.dataclass
class MeshLayout:
    """Where `halo_mesh` puts the pieces of every shard in its one buffer:
    shard s's pieces start at ``s * stride`` words, ``top`` at 0, ``bot``,
    ``left`` and ``right`` at their offsets (each a multiple of
    `PIECE_ALIGN`); ``rows``/``cols`` the row pieces' and column blocks'
    shapes and contiguous strides (None where absent). ``src`` is the
    kernel's parameter table, its pointers refilled on every call."""

    ny: int
    nx: int
    P: int
    h: int
    w: int
    k: int
    xh: int
    bot: int
    left: int
    right: int
    stride: int
    rows: Optional[tuple]
    cols: Optional[tuple]
    src: MeshSrc

    @property
    def words(self) -> int:
        return self.ny * self.nx * self.stride

    def halos(self, buf: torch.Tensor):
        """The `Halo` of every shard, its pieces views of ``buf``."""
        out = []
        for s in range(self.ny * self.nx):
            base = s * self.stride
            rows = [None, None] if self.rows is None else [
                buf.as_strided(*self.rows, base + o) for o in (0, self.bot)]
            cols = [None, None] if self.cols is None else [
                buf.as_strided(*self.cols, base + o) for o in (self.left, self.right)]
            out.append(Halo(self.P, *rows, *cols, self.k))
        return out


def _contiguous(shape):
    """``(shape, strides)`` of a contiguous tensor of ``shape``."""
    st, acc = [], 1
    for n in reversed(shape):
        st.append(acc)
        acc *= n
    return shape, tuple(reversed(st))


def _up(n: int) -> int:
    return -(-n // PIECE_ALIGN) * PIECE_ALIGN


_layouts: dict = {}


def _mesh_layout(shape, counts, h: int, w: int, k: int, xh: int) -> MeshLayout:
    """The (cached) layout of a mesh of ``shape`` whose shards hold groups
    of ``counts`` planes a tensor, ``[h, w]`` each, ``k`` rows and ``xh``
    lanes deep."""
    key = (tuple(shape), tuple(counts), h, w, k, xh)
    lay = _layouts.get(key)
    if lay is None:
        ny, nx = shape
        P = sum(counts)
        rows = _contiguous((P, w) if k == 1 else (P, k, w)) if ny > 1 else None
        cols = _contiguous((P, h + 2 * k, xh)) if nx > 1 and xh else None
        nr = _up(P * k * w) if rows else 0
        nc = _up(P * (h + 2 * k) * xh) if cols else 0
        src = MeshSrc()
        for i, c in enumerate(counts):
            src.planes[i] = c
        lay = _layouts[key] = MeshLayout(ny, nx, P, h, w, k, xh, nr, 2 * nr, 2 * nr + nc,
                                         2 * nr + 2 * nc, rows, cols, src)
    return lay


def _mesh_check(groups, mesh: Mesh, xh: int, rows: int):
    """The layout of `halo_mesh` for ``groups``, or ValueError where the
    mesh route cannot run: a process group, shards on several devices, or
    groups of differing shapes, dtypes or plane counts."""
    ny, nx = mesh.shape
    if mesh.group is not None:
        raise ValueError("halo_mesh: a process-group mesh exchanges through route='shards'")
    if len(groups) != ny * nx or len(mesh.local) != ny * nx:
        raise ValueError(f"halo_mesh: {len(groups)} groups on a {ny}x{nx} mesh")
    if ny * nx > MAX_MESH_SHARDS:
        raise ValueError(f"halo_mesh: {ny * nx} shards (at most {MAX_MESH_SHARDS})")
    g0 = groups[0]
    n = len(g0)
    if not 1 <= n <= MAX_SOURCES:
        raise ValueError(f"{n} tensors in a group (1 .. {MAX_SOURCES})")
    h, w = g0[0].shape[-2:]
    dev, dt = g0[0].device, g0[0].dtype
    sizes = [t.shape for t in g0]
    if any(sz[-2:] != (h, w) for sz in sizes) or g0[0].element_size() != 4:
        raise ValueError("halo_mesh: a group holds 32-bit [..., h, w] tensors of one h and w")
    for g in groups:  # plain loops: this runs once an exchange, on the host's critical path
        if len(g) != n:
            raise ValueError("halo_mesh: every shard's group must hold as many tensors")
        for t, sz in zip(g, sizes):
            if t.shape != sz or t.dtype != dt or t.device != dev or not t.is_contiguous():
                raise ValueError("halo_mesh: every shard's group must hold contiguous tensors "
                                 "of the same shapes and dtype on one device")
    k = int(rows)
    if not 1 <= k <= h or not 0 <= xh <= w:
        raise ValueError(f"rows={rows}, xh={xh} outside 1 .. {h}, 0 .. {w}")
    return _mesh_layout((ny, nx), [t.numel() // (h * w) for t in g0], h, w, k, int(xh))


def halo_mesh_ref(groups, mesh: Mesh, xh: int, rows: int = 1):
    """Twin of `halo_mesh`: every piece sliced straight from the neighbour
    shard that owns it (the kernel's index map), into one buffer of the
    same layout."""
    lay = _mesh_check(groups, mesh, xh, rows)
    ny, nx, h, w, k = lay.ny, lay.nx, lay.h, lay.w, lay.k
    g0 = groups[0][0]
    buf = torch.zeros(lay.words, dtype=g0.dtype, device=g0.device)
    halos = lay.halos(buf)

    def cut(iy, ix, r0, r1, c0, c1):
        return torch.cat([as_planes(t)[:, r0:r1, c0:c1]
                          for t in groups[(iy % ny) * nx + ix % nx]], dim=0)

    for s, hl in enumerate(halos):
        iy, ix = divmod(s, nx)
        if lay.rows is not None:
            _rows3(hl.top, k).copy_(cut(iy - 1, ix, h - k, h, 0, w))
            _rows3(hl.bot, k).copy_(cut(iy + 1, ix, 0, k, 0, w))
        if lay.cols is not None:
            for blk, sx, c0 in ((hl.left, ix - 1, w - xh), (hl.right, ix + 1, 0)):
                blk[:, k:h + k].copy_(cut(iy, sx, 0, h, c0, c0 + xh))
                if ny > 1:
                    blk[:, :k].copy_(cut(iy - 1, sx, h - k, h, c0, c0 + xh))
                    blk[:, h + k:].copy_(cut(iy + 1, sx, 0, k, c0, c0 + xh))
    return halos


def halo_mesh(groups, mesh: Mesh, xh: int, rows: int = 1):
    """The whole `exchange` of one field group for every shard of a local
    mesh whose shards all sit on one device (``groups[s]``: the group on
    shard s, row-major), in one launch: the same `Halo` list, its pieces
    128-byte aligned views of one buffer. Raises where the mesh route
    cannot run (`_mesh_check`)."""
    lay = _mesh_check(groups, mesh, xh, rows)
    g0 = groups[0][0]
    if g0.device.type == "cpu":
        return halo_mesh_ref(groups, mesh, xh, rows)
    if lay.stride == 0:  # a mesh of one shard: nothing to exchange
        return lay.halos(None)
    if lay.words >= 2**31:
        raise ValueError(f"halo_mesh: {lay.words} words overflow the kernel's int32 index")
    src = lay.src
    for s, g in enumerate(groups):
        row = src.p[s]
        for i, t in enumerate(g):
            row[i] = t.data_ptr()
    dev = g0.device
    buf = torch.empty(lay.words, dtype=g0.dtype, device=dev)
    fn = build.bind("halo_pack", "jrl_halo_mesh", [_P] + [ctypes.c_int] * 11 + [_P, _P])
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(src), lay.ny, lay.nx, lay.P, lay.h, lay.w, lay.k, lay.xh, lay.bot,
                 lay.left, lay.right, lay.stride, buf.data_ptr(), stream_of(dev))
    build.check(err, "halo_pack")
    halo_mesh.launches += 1
    return lay.halos(buf)


halo_mesh.launches = 0


def halo_route(groups, mesh: Mesh) -> str:
    """The route `exchange` takes by default: ``"mesh"`` (`halo_mesh`) on a
    local mesh of at most `MAX_MESH_SHARDS` shards whose groups all sit on
    one device, ``"shards"`` everywhere else. (A group is on one device
    either way: both routes refuse one that is not.)"""
    if mesh.group is not None or len(groups) > MAX_MESH_SHARDS \
            or len(groups) != mesh.shape[0] * mesh.shape[1]:
        return "shards"
    dev = groups[0][0].device
    return "mesh" if all(g[0].device == dev for g in groups) else "shards"


def exchange(groups, mesh: Mesh, xh: int, rows: int = 1, route: Optional[str] = None):
    """The `Halo` of each shard this process holds for one field group per
    shard (``groups[i]``: the group's tensors on shard ``mesh.local[i]``),
    ``rows`` rows and ``xh`` lanes deep (``xh = 0``: no column blocks).
    ``route``: ``"mesh"`` (`halo_mesh`, one launch for the mesh),
    ``"shards"`` (`halo_pack` a shard and phase, moved by `ppermute`), or
    None for `halo_route`'s pick; a forced ``"mesh"`` that cannot run
    raises. Every process posts the same exchanges whatever its shards
    compute."""
    if route is None:
        route = halo_route(groups, mesh)
    if route == "mesh":
        return halo_mesh(groups, mesh, xh, rows)
    if route != "shards":
        raise ValueError(f"unknown halo route {route!r}")
    ny, nx = mesh.shape
    P = sum(as_planes(t).shape[0] for t in groups[0])
    pieces = row_pieces(groups, mesh, rows) if ny > 1 else [(None, None)] * len(groups)
    blocks = edge_blocks(groups, pieces, mesh, xh, rows) if nx > 1 and xh \
        else [(None, None)] * len(groups)
    return [Halo(P, t, b, lf, rt, int(rows)) for (t, b), (lf, rt) in zip(pieces, blocks)]
