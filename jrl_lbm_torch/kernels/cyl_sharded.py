"""The cylinder channel on a ``(ny, nx)`` mesh of shards: four
hand-written CUDA kernels (`csrc/cyl_block_sh.cu`, `cyl_lean_sh.cu`,
`cyl_window_sh.cu`, `cyl_pass_sh.cu`), each with its plain PyTorch twin,
and the runner.

Replaces the TPU kernels of `jrl_lbm_tpu/ops/pallas/fused_sharded.py`:

* ``cyl_block_sh`` <- ``_padded_block_step`` (instance PADDED: f, vel and
  flags padded by `parallel/halo.py::pad_halo`) and ``_tiled_block_step``
  (instance PIECES: the body as it is, with the 1-row pieces and 1-lane
  columns of the 12-plane group flags, f, vel): one full-boundary step,
  one thread per cell;
* ``cyl_lean_sh`` <- ``_lean_tiled_step``: k plain-channel steps per
  launch on every row of the shard, with the INFLOW and OUTFLOW rules of
  the first and last rows of the grid; rows of the cylinder band come
  out wrong by design;
* ``cyl_window_sh`` <- ``_window_full_step`` (with ``_apply_window_fix``):
  k chained full-boundary steps on the shard's rows of the static band
  region (`_fix_regions`), written in place into the lean outputs;
* ``cyl_pass_sh`` <- the two above in one launch a shard and pass (k =
  1..4): the lean steps on the rows outside the band windows, the full
  steps on the windows (k = 2..4 rows streamed, k = 1 one thread a
  cell), bit for bit the two launches, which stay as ``route="launches"`` and for
  k = 5..8;

with `halo.py`'s exchange in place of ``_edge_cols`` and ``_edge_blocks``
(``halo_mesh``, one launch for the mesh, where every shard is on one card;
else ``halo_pack`` a shard and phase). `make_sharded_fused_cylinder_step` and ``_runner`` keep
the JAX functions' arguments (``interpret`` dropped: the CPU runs the
twins), checks and route choice: the lean split when eligible, else
PIECES when ``tile_rows`` is set or chosen, else PADDED; ``route`` picks
the pass or the two launches for the lean split. The runner takes
and returns global ``state`` / ``fields`` tensors.

Each kernel runs the unchanged cell code of the unsharded kernels
(`csrc/cyl_common.cuh`) in global coordinates through the accessors of
`csrc/cyl_shard.cuh`, so the full-boundary routes equal
`cylinder.make_fused_cylinder_runner(cfg, split=False)` (``cyl_full`` on
every row) bit for bit. The twins embed the shard and its pieces at their
global place in a grid of zeros, run the whole-grid twin of
`cylinder.py` (``full_step_ref``; `lean_yb_step_ref` for the lean pass)
k times and keep the shard's cells, which lie k cells inside the pieces,
so the zeros never reach them.

Where the port differs from the JAX functions, and why:

* ``tile_rows``, ``lean_x_ext`` and the row tiling size the TPU's tiles
  and lane windows; they are accepted and checked as in JAX and select
  the same route, and change nothing the port computes. The column halo
  of the lean split is k lanes (the reach of k steps), or
  ``lean_x_halo`` lanes when the caller gives it; a shard spanning the
  grid's width wraps in its own body and exchanges no columns. The
  lean/window route sends the 14-plane group (flags, f, vel, phi, rho) in
  both phases;
* the lean cell's wall cells of the first and last rows reflect their y
  pulls as the full step does (JAX's lean pass wraps them): no cell reads
  a wall cell's populations, and so no read crosses the global y border;
* the argument checks raise ``ValueError`` where JAX asserts;
* the k > 1 routes check the flags' border once per flags field, as
  `cylinder.make_fused_step2` does (`cylinder.check_border`).

A wrapper given tensors on the CPU runs its twin; given tensors on the
card it launches the kernel or raises. ``<wrapper>.launches`` counts the
launches (``cyl_block_sh.launches_by_inst`` per instance).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from jrl_lbm_torch.kernels import build
from jrl_lbm_torch.kernels import cylinder as K
from jrl_lbm_torch.kernels.halo import Halo, _rows3, as_planes, exchange
from jrl_lbm_torch.kernels.jrl_fluid import _P, stream_of
from jrl_lbm_torch.kernels.jrl_sharded import ShardPlanes
from jrl_lbm_torch.parallel.halo import pad_halo
from jrl_lbm_torch.parallel.mesh import Mesh, gather, split

_F32 = torch.float32
# Planes of the exchanged groups: flags (as the float32 view of its bits),
# f, vel, and on the lean/window route phi and rho.
PLANE = {"flags": 0, "f": 1, "vel": 10, "phi": 12, "rho": 13}
# Above this many cells the JAX package's single-tile kernel outgrows its
# VMEM budget and `make_sharded_fused_cylinder_step` picks the row-tiled
# one (fused_sharded.py:352-355); kept for the same route choice.
MAX_SINGLE_TILE_CELLS = 600_000


# ---------------------------------------------------------------------------
# A shard's place in the grid
# ---------------------------------------------------------------------------

class CylShardGeom(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("H", "W", "h", "w", "row0", "col0", "k", "xh")]


class CylShardSrc(ctypes.Structure):
    _fields_ = [(n, ShardPlanes) for n in ("f", "vel", "phi", "rho", "flags")]


@dataclasses.dataclass(frozen=True)
class CylShard:
    """Shard ``(iy, ix)`` of an ``H x W`` grid on a ``(ny, nx)`` mesh: rows
    ``row0 .. row0+h-1``, columns ``col0 .. col0+w-1``; its pieces are
    ``k`` rows and ``xh`` lanes deep (``xh = 0`` on a mesh of one column)."""

    H: int
    W: int
    h: int
    w: int
    row0: int
    col0: int
    k: int
    xh: int

    @classmethod
    def of(cls, H: int, W: int, mesh_shape, coord, k: int = 1, xh: int = 1) -> "CylShard":
        ny, nx = mesh_shape
        h, w = H // ny, W // nx
        return cls(H, W, h, w, coord[0] * h, coord[1] * w, int(k), int(xh) if nx > 1 else 0)

    @functools.cached_property
    def geom(self) -> CylShardGeom:
        return CylShardGeom(self.H, self.W, self.h, self.w, self.row0, self.col0, self.k,
                            self.xh)

    def body(self, x: torch.Tensor) -> torch.Tensor:
        """The shard's cells of a global ``[..., H, W]`` tensor."""
        return x[..., self.row0:self.row0 + self.h, self.col0:self.col0 + self.w].contiguous()


def lean_group(f, rho, vel, flags, phi):
    """The 14-plane halo group of the lean/window route (`PLANE`)."""
    return [flags.view(_F32), f, vel, phi, rho]


def full_group(f, vel, flags):
    """The 12-plane halo group of the PIECES route."""
    return [flags.view(_F32), f, vel]


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------

def _embed(sh: CylShard, body: torch.Tensor, halo: Halo | None = None, off: int = 0,
           fill: float = 0.0):
    """A global ``[n, H, W]`` grid of zeros (``fill`` in a float grid)
    holding the shard's ``n`` planes ``body`` and, from ``halo``, planes
    ``off .. off+n-1`` of its k-row pieces and column blocks at their
    global places (mod H, W)."""
    b = as_planes(body)
    n, dev = b.shape[0], b.device
    g = torch.zeros((n, sh.H, sh.W), dtype=b.dtype, device=dev)
    if b.is_floating_point():
        g.fill_(fill)
    if halo is not None:
        k = halo.k
        if halo.left is not None:
            er = torch.arange(sh.row0 - k, sh.row0 + sh.h + k, device=dev) % sh.H
            # without row pieces the blocks' end rows hold zeros, not the wrap
            keep = slice(None) if halo.top is not None else slice(k, k + sh.h)
            for blk, c0 in ((halo.left, sh.col0 - sh.xh), (halo.right, sh.col0 + sh.w)):
                cols = torch.arange(c0, c0 + sh.xh, device=dev) % sh.W
                g[:, er[keep][:, None], cols[None, :]] = blk[off:off + n, keep].view(b.dtype)
        if halo.top is not None:
            cs = slice(sh.col0, sh.col0 + sh.w)
            for piece, r0 in ((halo.top, sh.row0 - k), (halo.bot, sh.row0 + sh.h)):
                rows = torch.arange(r0, r0 + k, device=dev) % sh.H
                g[:, rows, cs] = _rows3(piece, k)[off:off + n].view(b.dtype)
    g[:, sh.row0:sh.row0 + sh.h, sh.col0:sh.col0 + sh.w] = b
    return g


def _embed_padded(sh: CylShard, xp: torch.Tensor):
    """A global ``[n, H, W]`` grid of zeros holding a ``[..., h+2, w+2]``
    block padded by `pad_halo` at its global place (mod H, W)."""
    b = as_planes(xp)
    dev = b.device
    g = torch.zeros((b.shape[0], sh.H, sh.W), dtype=b.dtype, device=dev)
    rows = torch.arange(sh.row0 - 1, sh.row0 + sh.h + 1, device=dev) % sh.H
    cols = torch.arange(sh.col0 - 1, sh.col0 + sh.w + 1, device=dev) % sh.W
    g[:, rows[:, None], cols[None, :]] = b
    return g


def cyl_block_sh_ref(f, rho, vel, flags, phi, halo, c: K.Consts, sh: CylShard):
    """Twin of `cyl_block_sh`: ``cylinder.cyl_full_ref``'s step on the
    shard embedded with its pieces (PIECES) or its padded planes (PADDED,
    ``halo`` None); returns the shard's ``(f, rho, vel)``."""
    if halo is None:
        F, V, FL = _embed_padded(sh, f), _embed_padded(sh, vel), _embed_padded(sh, flags)[0]
    else:
        F = _embed(sh, f, halo, PLANE["f"])
        V = _embed(sh, vel, halo, PLANE["vel"])
        FL = _embed(sh, flags, halo, PLANE["flags"])[0]
    rho_g = _embed(sh, rho)[0]
    fo, r, vx, vy = K.full_step_ref(F, V, FL, _embed(sh, phi)[0], c, rho_g, V)
    return sh.body(fo), sh.body(r), sh.body(torch.stack([vx, vy]))


def lean_yb_step_ref(f, c: K.Consts):
    """One plain-channel step on every row of the whole grid with the
    first and last rows' rules (csrc/cyl_common.cuh::lean_cell, YB): the
    INFLOW plug at y = 0 and the OUTFLOW copy at y = H-1 off the wall
    columns (``fused_sharded.py::_lean_block_update``), the wall cells of
    those rows reflecting their y pulls; returns ``(f, rho, vx, vy)``."""
    H, W = f.shape[-2:]
    dev = f.device
    gx = torch.arange(W, device=dev).expand(H, W)
    gy = torch.arange(H, device=dev)[:, None].expand(H, W)
    at_x0, at_xW = gx == 0, gx == W - 1
    is_obs = at_x0 | at_xW
    nbr_lo, nbr_hi = gx == 1, gx == W - 2

    def xpull(rows, ex):
        if ex == 0:
            return rows
        base = torch.roll(rows, ex, dims=-1)
        if ex == 1:
            return torch.where(at_x0, torch.roll(rows, -1, dims=-1), base)
        return torch.where(at_xW, torch.roll(rows, 1, dims=-1), base)

    def pull(q):
        ex, ey = int(K.E[q, 0]), int(K.E[q, 1])
        v = xpull(torch.roll(f[q], ey, dims=-2), ex)
        if ey != 0:  # wall cells of the border row pull from the row inside
            edge = 0 if ey == 1 else H - 1
            r = torch.roll(f[q], ey, dims=-2).clone()
            r[edge] = f[q][edge + ey]
            v = torch.where(is_obs & (gy == edge), xpull(r, ex), v)
        return v

    raw_in = [f[0]] + [pull(q) for q in range(1, 9)]
    f_new = [raw_in[0]]
    for q in range(1, 9):
        ex = int(K.E[q, 0])
        streamed = raw_in[q]
        if ex == 1:
            streamed = torch.where(nbr_lo, f[int(K.REFL[q])], streamed)
        elif ex == -1:
            streamed = torch.where(nbr_hi, f[int(K.REFL[q])], streamed)
        f_new.append(torch.where(is_obs, raw_in[int(K.REFL[q])], streamed))
    in_mask = (gy == 0) & ~is_obs
    of_mask = (gy == H - 1) & ~is_obs
    for q in range(9):
        g = torch.where(in_mask, c.feq_in[q], f_new[q])
        f_new[q] = torch.where(of_mask, torch.roll(g, 1, dims=-2), g)
    zero = torch.zeros((), dtype=f.dtype, device=dev)
    return K._moments_mrt(c, f_new, is_obs, torch.full_like(zero, c.density), zero, zero)


def cyl_lean_sh_ref(f, halo, k: int, c: K.Consts, sh: CylShard):
    """Twin of `cyl_lean_sh`: k `lean_yb_step_ref` steps on the shard
    embedded with its f pieces; returns the shard's ``(f, rho, vel)``."""
    F = _embed(sh, f, halo, PLANE["f"])
    for _ in range(int(k)):
        F, r, vx, vy = lean_yb_step_ref(F, c)
    return sh.body(F), sh.body(r), sh.body(torch.stack([vx, vy]))


def cyl_window_sh_ref(f, rho, vel, flags, phi, halo, k: int, b0: int, nb: int, out,
                      c: K.Consts, sh: CylShard):
    """Twin of `cyl_window_sh`: k ``full_step_ref`` steps on the shard
    embedded with its 14-plane pieces (OBSTACLE cells keep the state's rho
    and carry their velocity), rows [b0, b0 + nb) written into ``out``
    (``(f, rho, vel)`` of the shard)."""
    F = _embed(sh, f, halo, PLANE["f"])
    V = _embed(sh, vel, halo, PLANE["vel"])
    FL = _embed(sh, flags, halo, PLANE["flags"])[0]
    PHI = _embed(sh, phi, halo, PLANE["phi"])[0]
    RHO = _embed(sh, rho, halo, PLANE["rho"])[0]
    for _ in range(int(k)):
        F, r, vx, vy = K.full_step_ref(F, V, FL, PHI, c, RHO, V)
        V = torch.stack([vx, vy])
    rows = slice(b0, b0 + nb)
    f1, rho1, vel1 = out
    f1[:, rows] = sh.body(F)[:, rows]
    rho1[rows] = sh.body(r)[rows]
    vel1[:, rows] = sh.body(V)[:, rows]


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _check(sh: CylShard, **tensors) -> torch.device:
    """Float32 (int32 flags) contiguous tensors of the shard's shape (the
    padded shape for the ``*p`` names) on one CUDA device."""
    dev = None
    for name, (t, lead) in tensors.items():
        hh, ww = (sh.h + 2, sh.w + 2) if name.endswith("p") else (sh.h, sh.w)
        want = tuple(lead) + (hh, ww)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {want}")
        if t.dtype != (torch.int32 if name.startswith("flags") else _F32):
            raise ValueError(f"{name}: dtype {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if t.device.type != "cuda":
            raise ValueError(f"{name}: on {t.device}, the kernel needs the card")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: on {t.device}, the others on {dev}")
    return dev


def _pieces(sh: CylShard, halo: Halo, dev):
    """``[(name, data pointer, elements a plane), ...]`` of a halo group's
    pieces, each checked (shape, dtype, device, contiguity) before its
    pointer is taken."""
    k = halo.k
    if k != sh.k:
        raise ValueError(f"halo of {k} rows for a shard of k = {sh.k}")
    out = []
    for name, t, n_el, step in (("top", halo.top, halo.P * k * sh.w, k * sh.w),
                                ("bot", halo.bot, halo.P * k * sh.w, k * sh.w),
                                ("left", halo.left, halo.P * (sh.h + 2 * k) * sh.xh,
                                 (sh.h + 2 * k) * sh.xh),
                                ("right", halo.right, halo.P * (sh.h + 2 * k) * sh.xh,
                                 (sh.h + 2 * k) * sh.xh)):
        if t is None:
            continue
        if t.numel() != n_el or t.shape[-1] != (sh.xh if name in ("left", "right") else sh.w) \
                or t.element_size() != 4 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"halo {name}: {tuple(t.shape)} {t.dtype} on {t.device} does not "
                             f"fit the shard")
        out.append((name, t.data_ptr(), step))
    if (halo.top is None) == (sh.h < sh.H) or (halo.left is None) == bool(sh.xh):
        raise ValueError("halo pieces do not match the shard's mesh")
    return out


def _planes(sh: CylShard, body, halo: Halo | None, off: int, dev, pieces=None) -> ShardPlanes:
    """The kernel's view of planes ``off ..`` of a halo group, its pieces
    checked (`_pieces`, or ``pieces`` checked once for a group) before any
    pointer is taken; the body alone where ``halo`` is None or lacks the
    planes."""
    sp = ShardPlanes(body.data_ptr())
    if halo is None or off >= halo.P:
        return sp
    for name, ptr, step in (_pieces(sh, halo, dev) if pieces is None else pieces):
        setattr(sp, name, ptr + 4 * off * step)
    return sp


def _src(sh, dev, halo, f, vel, flags, phi, rho) -> CylShardSrc:
    pieces = None if halo is None else _pieces(sh, halo, dev)
    return CylShardSrc(_planes(sh, f, halo, PLANE["f"], dev, pieces),
                       _planes(sh, vel, halo, PLANE["vel"], dev, pieces),
                       _planes(sh, phi, halo, PLANE["phi"], dev, pieces),
                       _planes(sh, rho, halo, PLANE["rho"], dev, pieces),
                       _planes(sh, flags, halo, PLANE["flags"], dev, pieces))


def _params(c: K.Consts, sh: CylShard) -> K.CylParams:
    return K._params(c, [(sh.row0, sh.row0 + sh.h)], True)


def cyl_block_sh(f, rho, vel, flags, phi, halo, c: K.Consts, sh: CylShard):
    """One full-boundary step on a shard; returns its new ``(f, rho,
    vel)``. PIECES: ``halo`` is the 12-plane `Halo` (1 row, 1 lane) of
    `full_group`; PADDED (``halo`` None): ``f``, ``vel``, ``flags`` are
    ``[..., h+2, w+2]`` planes padded by `pad_halo`."""
    if f.device.type == "cpu":
        return cyl_block_sh_ref(f, rho, vel, flags, phi, halo, c, sh)
    padded = halo is None
    if padded:
        dev = _check(sh, fp=(f, (9,)), velp=(vel, (2,)), flagsp=(flags, ()), rho=(rho, ()),
                     phi=(phi, ()))
    else:
        dev = _check(sh, f=(f, (9,)), vel=(vel, (2,)), flags=(flags, ()), rho=(rho, ()),
                     phi=(phi, ()))
        if sh.k != 1 or halo.k != 1:
            raise ValueError("the PIECES step reads 1-row pieces")
    src = _src(sh, dev, halo, f, vel, flags, phi, rho)
    hw = (sh.h, sh.w)
    f_out = torch.empty((9,) + hw, dtype=_F32, device=dev)
    rho_out, vel_out = torch.empty(hw, dtype=_F32, device=dev), torch.empty((2,) + hw,
                                                                            dtype=_F32, device=dev)
    fn = build.bind("cyl_block_sh", "cyl_block_sh_launch", [_P] * 4 + [ctypes.c_int] + [_P] * 3)
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(src), f_out.data_ptr(), rho_out.data_ptr(), vel_out.data_ptr(),
                 int(padded), ctypes.byref(_params(c, sh)), ctypes.byref(sh.geom),
                 stream_of(dev))
    build.check(err, "cyl_block_sh")
    cyl_block_sh.launches += 1
    cyl_block_sh.launches_by_inst["padded" if padded else "pieces"] += 1
    return f_out, rho_out, vel_out


def cyl_lean_sh(f, halo, k: int, c: K.Consts, sh: CylShard):
    """k lean steps on every row of a shard; returns its ``(f, rho,
    vel)``. ``halo``: the `Halo` of `lean_group` (k rows; only f read)."""
    if f.device.type == "cpu":
        return cyl_lean_sh_ref(f, halo, k, c, sh)
    K._check_k(k)
    if sh.k < k or (sh.xh and sh.xh < k):
        raise ValueError(f"k = {k} needs pieces of k rows and lanes; the shard has {sh.k}, "
                         f"{sh.xh}")
    dev = _check(sh, f=(f, (9,)))
    src = CylShardSrc(f=_planes(sh, f, halo, PLANE["f"], dev))
    hw = (sh.h, sh.w)
    f_out = torch.empty((9,) + hw, dtype=_F32, device=dev)
    rho_out, vel_out = torch.empty(hw, dtype=_F32, device=dev), torch.empty((2,) + hw,
                                                                            dtype=_F32, device=dev)
    fn = build.bind("cyl_lean_sh", "cyl_lean_sh_launch", [_P] * 4 + [ctypes.c_int] + [_P] * 3)
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(src), f_out.data_ptr(), rho_out.data_ptr(), vel_out.data_ptr(),
                 int(k), ctypes.byref(_params(c, sh)), ctypes.byref(sh.geom), stream_of(dev))
    build.check(err, "cyl_lean_sh")
    cyl_lean_sh.launches += 1
    return f_out, rho_out, vel_out


def cyl_window_sh(f, rho, vel, flags, phi, halo, k: int, b0: int, nb: int, out,
                  c: K.Consts, sh: CylShard):
    """k full-boundary steps on the shard's rows [b0, b0 + nb) from the
    pre-step state, written in place into ``out`` (``(f, rho, vel)`` of
    the shard, the lean pass's outputs). ``halo``: the `Halo` of
    `lean_group`."""
    if f.device.type == "cpu":
        return cyl_window_sh_ref(f, rho, vel, flags, phi, halo, k, b0, nb, out, c, sh)
    K._check_k(k)
    if not (0 <= b0 and nb >= 1 and b0 + nb <= sh.h) or sh.k < k or (sh.xh and sh.xh < k):
        raise ValueError(f"window rows [{b0}, {b0 + nb}) of a shard of {sh.h} (k = {k}, pieces "
                         f"{sh.k} rows, {sh.xh} lanes)")
    f1, rho1, vel1 = out
    dev = _check(sh, f=(f, (9,)), vel=(vel, (2,)), flags=(flags, ()), rho=(rho, ()),
                 phi=(phi, ()), f_out=(f1, (9,)), rho_out=(rho1, ()), vel_out=(vel1, (2,)))
    ins = {t.data_ptr() for t in (f, rho, vel, flags, phi)}
    if ins & {t.data_ptr() for t in out}:
        raise ValueError("the window writes apart from the pre-step state it reads")
    src = _src(sh, dev, halo, f, vel, flags, phi, rho)
    fn = build.bind("cyl_window_sh", "cyl_window_sh_launch",
                    [_P] * 4 + [ctypes.c_int] * 3 + [_P] * 3)
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(src), f1.data_ptr(), rho1.data_ptr(), vel1.data_ptr(), int(k),
                 int(b0), int(nb), ctypes.byref(_params(c, sh)), ctypes.byref(sh.geom),
                 stream_of(dev))
    build.check(err, "cyl_window_sh")
    cyl_window_sh.launches += 1


# ---------------------------------------------------------------------------
# The lean-split pass in one launch (cyl_pass_sh, csrc/cyl_pass_sh.cu)
# ---------------------------------------------------------------------------

PASS_SH_KS = (1, 2, 3, 4)  # the depths cyl_pass_sh is built for
CLS_LEAN, CLS_CYL = K.CLS_INTERIOR, K.CLS_CYL  # csrc/cyl_pass_sh.cu's item classes
# a row's device time in the pass relative to a lean row's, by class: band
# runs are shorter by it (cylinder.py::CYL_PASS_COST's cyl rows)
PASS_SH_COST = (1.0, 2.0)
PS_AOFF = 16  # csrc/cyl_pass_sh.cu: a ring row's first column is packed + PS_AOFF


def band_windows(sh: CylShard, regions):
    """``[(b0, nb), ...]``: the shard-local rows [b0, b0 + nb) of each band
    region the shard meets, as the lean split places its window: the
    region's height, ``b0`` clamped into the shard."""
    out = []
    for gr0, gr1 in regions:
        if sh.row0 < gr1 and sh.row0 + sh.h > gr0:
            nb = gr1 - gr0
            out.append((min(max(gr0 - sh.row0, 0), sh.h - nb), nb))
    return out


def pass_sh_rows(sh: CylShard, windows):
    """``(lean, cyl)`` shard-local row segments of a pass: the band windows
    (`band_windows`) and the rows outside them."""
    cyl = sorted((b0, b0 + nb) for b0, nb in windows)
    lean, y = [], 0
    for y0, y1 in cyl:
        if y0 > y:
            lean.append((y, y0))
        y = max(y, y1)
    if y < sh.h:
        lean.append((y, sh.h))
    return tuple(lean), tuple(cyl)


def pass_sh_fits(sh: CylShard, k: int) -> bool:
    """Whether cyl_pass_sh takes the shard at depth k: 1 <= k <= 4, shards
    of multiples of 8 rows and columns (rows copied 16 bytes at a time)
    below 2**15, pieces of at least k rows and, on a mesh of more than one
    column, k lanes."""
    return (int(k) in PASS_SH_KS and sh.h % 8 == 0 and sh.w % 8 == 0 and sh.h < 2 ** 15
            and sh.w < 2 ** 15 and sh.k >= k and (sh.w == sh.W or sh.xh >= k))


def pass_sh_window(sh: CylShard, k: int, item):
    """``((r0, r1), (c0, c1))``: the shard-local rows and columns an item's
    first sub-step reads, k a side from the pieces (global rows mod H); at
    k > 1 the rows stop at the grid's first and last rows, the columns
    never (past the shard's edge they lie in its column blocks or, on a
    mesh of one column, at its other end)."""
    y0, y1, _, x0, x1 = item[:5]
    lo = 0 if k > 1 and sh.row0 == 0 else -k
    hi = sh.h if k > 1 and sh.row0 + sh.h == sh.H else sh.h + k
    return (max(y0 - k, lo), min(y1 + k, hi)), (x0 - k, x1 + k)


def cyl_pass_sh_items(sh: CylShard, k: int, rows, sms: int = K.CP_SMS,
                      threads: int = K.CP_THREADS, blocks_per_sm: int = K.CP_BLOCKS_PER_SM,
                      cost=PASS_SH_COST, max_width: int | None = None):
    """The blocks of a ``cyl_pass_sh`` launch, ``(y0, y1, cls, x0, x1, a0,
    a1, desc)`` each (shard-local): block i writes rows [y0, y1) x columns
    [x0, x1) with the class's steps (``CLS_LEAN``, ``CLS_CYL``; ``rows`` =
    (lean, cyl) segments, `pass_sh_rows`); its ring rows hold columns [a0,
    a1) (x0 - k and x1 + k rounded out to 16 bytes, past the shard's edges
    where it sits there); ``desc``: its window walks up (it computes the
    global row 0). About one wave of ``blocks_per_sm`` blocks an SM (the
    strips and runs of `cylinder.cyl_pass_items`); the most costly items
    first."""
    if not pass_sh_fits(sh, k):
        raise ValueError(f"cyl_pass_sh takes 1 <= k <= 4 on shards of multiples of 8 rows and "
                         f"columns below 2**15 with pieces of k rows and lanes (k = {k}, {sh})")
    budget = K.cyl_pass_budget(blocks_per_sm)
    strips = [K.cyl_pass_strips(sh.w, min(K.cyl_pass_strip(cls, k, 4, threads, budget),
                                          max_width or sh.w)) for cls in (CLS_LEAN, CLS_CYL)]
    runs = K.cyl_pass_runs(sh.h, k, [list(r) for r in rows], strips, sms * blocks_per_sm, cost)
    items = []
    for y0, y1, cls in runs:
        desc = sh.row0 == 0 and y0 < k
        if desc and sh.h == sh.H and y1 > sh.h - k:
            raise ValueError(f"rows {y0}..{y1 - 1}: a run reaches both border rows")
        for x0, x1 in strips[cls]:
            items.append((y0, y1, cls, x0, x1, (x0 - k) // 4 * 4, -(-(x1 + k) // 4) * 4,
                          int(desc)))
    items.sort(key=lambda it: -cost[it[2]] * (it[1] - it[0] + 4 * k))
    return items


def cyl_pass_sh_ref(f, rho, vel, flags, phi, halo, k: int, rows, c: K.Consts, sh: CylShard,
                    items=None):
    """Twin of `cyl_pass_sh`: item by item (``cyl_pass_sh_items`` unless
    ``items`` is given), the shard embedded with its 14-plane pieces
    (`_embed`) and NaN beyond the item's window (`pass_sh_window`, mod H
    and W), k `lean_yb_step_ref` steps (lean) or k ``full_step_ref`` steps
    (cyl: OBSTACLE cells keep the state's rho and carry their velocity);
    only the item's own cells are kept. Returns the shard's ``(f, rho,
    vel)``: `cyl_lean_sh_ref` followed by `cyl_window_sh_ref` on each band
    window, bit for bit. At k = 1 the card runs one thread a cell, whose
    reads lie inside any item's window: the items are the twin's blocks."""
    if items is None:
        items = cyl_pass_sh_items(sh, k, rows)
    dev = f.device
    F = _embed(sh, f, halo, PLANE["f"])
    V = _embed(sh, vel, halo, PLANE["vel"])
    FL = _embed(sh, flags, halo, PLANE["flags"])[0]
    PHI = _embed(sh, phi, halo, PLANE["phi"])[0]
    RHO = _embed(sh, rho, halo, PLANE["rho"])[0]
    hw = (sh.h, sh.w)
    f1 = torch.empty((9,) + hw, dtype=_F32, device=dev)
    rho1, vel1 = torch.empty(hw, dtype=_F32, device=dev), torch.empty((2,) + hw, dtype=_F32,
                                                                       device=dev)
    nan = float("nan")
    for item in items:
        y0, y1, cls, x0, x1 = item[:5]
        (r0, r1), (c0, c1) = pass_sh_window(sh, k, item)
        keep = torch.zeros((sh.H, sh.W), dtype=torch.bool, device=dev)
        keep[(torch.arange(sh.row0 + r0, sh.row0 + r1, device=dev) % sh.H)[:, None],
             (torch.arange(sh.col0 + c0, sh.col0 + c1, device=dev) % sh.W)[None, :]] = True

        def window(t):
            return torch.where(keep, t, torch.full_like(t, nan))

        G = window(F)
        if cls == CLS_LEAN:
            for _ in range(int(k)):
                G, r, vx, vy = lean_yb_step_ref(G, c)
            U = torch.stack([vx, vy])
        else:
            U, P, R = window(V), window(PHI), window(RHO)
            for _ in range(int(k)):
                G, r, vx, vy = K.full_step_ref(G, U, FL, P, c, R, U)
                U = torch.stack([vx, vy])
        ys, xs = slice(y0, y1), slice(x0, x1)
        f1[:, ys, xs] = sh.body(G)[:, ys, xs]
        rho1[ys, xs] = sh.body(r)[ys, xs]
        vel1[:, ys, xs] = sh.body(U)[:, ys, xs]
    return f1, rho1, vel1


class PassShParams(ctypes.Structure):
    _fields_ = [("c", K.CylParams), ("s", CylShardGeom), ("rs", ctypes.c_int * 2),
                ("nitems", ctypes.c_int)]


def cyl_pass_sh_shape(k: int, device_index: int = 0):
    """``(threads a block, window columns, blocks an SM)`` of the built
    row-streaming instance at depth k = 2..4 (its -D values)."""
    fn = build.bind("cyl_pass_sh", "cyl_pass_sh_shape", [ctypes.c_int, _P, _P, _P])
    t, cols, mb = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(fn(int(k), ctypes.byref(t), ctypes.byref(cols), ctypes.byref(mb)),
                    "cyl_pass_sh")
    return t.value, cols.value, mb.value


def cyl_pass_sh_info(k: int, device_index: int = 0):
    """``(registers per thread, local bytes)`` of the instance at depth k:
    row-streaming at k = 2..4, one thread a cell at k = 1."""
    fn = build.bind("cyl_pass_sh", "cyl_pass_sh_info", [ctypes.c_int, _P, _P])
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(fn(int(k), ctypes.byref(regs), ctypes.byref(local)), "cyl_pass_sh")
    return regs.value, local.value


def pass_sh_plan(c: K.Consts, sh: CylShard, items, k: int, dev, threads: int = K.CP_THREADS,
                 blocks_per_sm: int = K.CP_BLOCKS_PER_SM):
    """``(items packed on ``dev``, PassShParams, shared memory bytes)`` of a
    launch over ``items`` (`cyl_pass_sh_items`): each class's ring row
    `cylinder.cyl_pass_rs`; the bytes those of the items' class that takes
    most."""
    rs = [K.cyl_pass_rs(cls, k, 4, threads, blocks_per_sm) for cls in (CLS_LEAN, CLS_CYL)]
    for _, _, cls, _, _, a0, a1, _ in items:
        if a1 - a0 > rs[cls]:
            raise ValueError(f"an item's ring row of {a1 - a0} elements exceeds {rs[cls]}")
    smem = max(K.cyl_pass_smem(cls, k, rs[cls], 4) for cls in {it[2] for it in items})
    packed = torch.tensor([[y0 | y1 << 16, x0 | x1 << 16,
                            (a0 + PS_AOFF) | (a1 + PS_AOFF) << 16, cls | d << 4]
                           for y0, y1, cls, x0, x1, a0, a1, d in items],
                          dtype=torch.int32, device=dev)
    params = PassShParams(c=_params(c, sh), s=sh.geom, nitems=len(items))
    params.rs[:] = rs
    return packed, params, smem


class PassShContext:
    """What a ``cyl_pass_sh`` launch needs besides its tensors and stream,
    made once for a shard, its rows, k and a card. At k = 2..4 the items
    on the card (planned for the built kernel's threads and blocks an SM,
    and the card's SMs), the parameters, the shared memory; at k = 1 (one
    thread a cell) the band window and the step's constants."""

    def __init__(self, c: K.Consts, sh: CylShard, rows, k: int, dev: torch.device):
        self.consts = c
        if k == 1:
            wins = rows[1]
            if len(wins) > 1:
                raise ValueError("the k = 1 pass takes at most one band window")
            self.band = (wins[0][0], wins[0][1] - wins[0][0]) if wins else (0, 0)
            self.cparams = _params(c, sh)
            self.fn = build.bind("cyl_pass_sh", "cyl_pass_sh_cells_launch",
                                 [_P] * 4 + [ctypes.c_int] * 2 + [_P] * 3)
            return
        threads, _, per_sm = cyl_pass_sh_shape(k, dev.index or 0)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        self.items_list = cyl_pass_sh_items(sh, k, rows, sms, threads, per_sm)
        self.items, self.params, self.smem = pass_sh_plan(c, sh, self.items_list, k, dev,
                                                          threads, per_sm)
        self.fn = build.bind("cyl_pass_sh", "cyl_pass_sh_launch",
                             [_P] * 5 + [ctypes.c_int] * 2 + [_P] * 2)


_PASS_SH_CONTEXTS: dict = {}


def pass_sh_context(c: K.Consts, sh: CylShard, rows, k: int, dev) -> PassShContext:
    """The `PassShContext` of a shard's pass, made on first use."""
    key = (id(c), sh, tuple(tuple(map(tuple, r)) for r in rows), int(k), dev)
    ctx = _PASS_SH_CONTEXTS.get(key)
    if ctx is None or ctx.consts is not c:
        ctx = _PASS_SH_CONTEXTS[key] = PassShContext(c, sh, rows, k, dev)
    return ctx


def cyl_pass_sh(f, rho, vel, flags, phi, halo, k: int, rows, c: K.Consts, sh: CylShard):
    """One lean-split pass on a shard in one launch; returns its new ``(f,
    rho, vel)``: k lean steps (`cyl_lean_sh`) on the rows of ``rows[0]``
    and k full-boundary steps (`cyl_window_sh`) on the band windows
    ``rows[1]`` (`pass_sh_rows`), all from the pre-step state: what
    ``cyl_lean_sh`` and ``cyl_window_sh`` on each window write, bit for
    bit. ``halo``: the `Halo` of `lean_group` (k rows; lanes as the shard's
    ``xh``). k = 2..4 stream rows; k = 1 runs one thread a cell (at most
    one band window)."""
    if f.device.type == "cpu":
        return cyl_pass_sh_ref(f, rho, vel, flags, phi, halo, k, rows, c, sh)
    if not pass_sh_fits(sh, k):
        raise ValueError(f"cyl_pass_sh takes 1 <= k <= 4 on shards of multiples of 8 rows and "
                         f"columns below 2**15 with pieces of k rows and lanes (k = {k}, {sh})")
    dev = _check(sh, f=(f, (9,)), vel=(vel, (2,)), flags=(flags, ()), rho=(rho, ()),
                 phi=(phi, ()))
    src = _src(sh, dev, halo, f, vel, flags, phi, rho)
    if k > 1 and any((getattr(getattr(src, fld), part) or 0) % 16
                     for fld in ("f", "vel", "phi", "flags") for part in ("body", "top", "bot")):
        raise ValueError("cyl_pass_sh copies rows of 16-byte aligned planes and pieces")
    ctx = pass_sh_context(c, sh, rows, k, dev)
    hw = (sh.h, sh.w)
    f_out = torch.empty((9,) + hw, dtype=_F32, device=dev)
    rho_out, vel_out = torch.empty(hw, dtype=_F32, device=dev), torch.empty((2,) + hw,
                                                                            dtype=_F32, device=dev)
    with torch.cuda.device(dev):
        if k == 1:
            err = ctx.fn(ctypes.byref(src), f_out.data_ptr(), rho_out.data_ptr(),
                         vel_out.data_ptr(), ctx.band[0], ctx.band[1],
                         ctypes.byref(ctx.cparams), ctypes.byref(sh.geom), stream_of(dev))
        else:
            err = ctx.fn(ctypes.byref(src), f_out.data_ptr(), rho_out.data_ptr(),
                         vel_out.data_ptr(), ctx.items.data_ptr(), int(k), ctx.smem,
                         ctypes.byref(ctx.params), stream_of(dev))
    build.check(err, "cyl_pass_sh")
    cyl_pass_sh.launches += 1
    return f_out, rho_out, vel_out


WRAPPERS = (cyl_block_sh, cyl_lean_sh, cyl_window_sh, cyl_pass_sh)


def reset_launches():
    for fn in WRAPPERS:
        fn.launches = 0
    cyl_block_sh.launches_by_inst = {"padded": 0, "pieces": 0}


reset_launches()


# ---------------------------------------------------------------------------
# Routes and runners (fused_sharded.py::make_sharded_fused_cylinder_step)
# ---------------------------------------------------------------------------

def _fix_regions(cfg, margin=4.0):
    """Static 8-aligned global row regions where the lean pass is wrong:
    the cylinder +- margin group (the margin of `cylinder._band_tiles`).
    The y-border INFLOW/OUTFLOW rows are handled inside the lean kernel,
    so they need no fix window."""
    H, _ = cfg.res
    cy = cfg.center[1]
    r = cfg.D / 2.0
    c0 = max(0, int((cy - r - margin) // 8) * 8)
    c1 = min(H, int(-((cy + r + margin) // -8)) * 8)
    return [(c0, c1)] if c1 > c0 else []


def _pick_tile_rows(h, w):
    """None (the single-tile route) or the largest multiple-of-8 tile
    height <= 64 that divides h."""
    if (h + 2) * (w + 2) <= MAX_SINGLE_TILE_CELLS:
        return None
    if h % 8:
        raise ValueError(f"per-shard block of {h} rows x {w} cols exceeds the "
                         f"single-tile VMEM budget and h is not a multiple of 8")
    th = 64
    while h % th:
        th //= 2
    return th


def _check_border_shard(flags, sh: CylShard):
    """`cylinder.check_border` on the global border cells a shard owns."""
    ok = True
    if sh.col0 == 0:
        ok &= bool((flags[:, 0] == K.OBSTACLE).all())
    if sh.col0 + sh.w == sh.W:
        ok &= bool((flags[:, -1] == K.OBSTACLE).all())
    if sh.row0 == 0:
        ok &= not bool((flags[0] == K.FLUID).any())
    if sh.row0 + sh.h == sh.H:
        ok &= not bool((flags[-1] == K.FLUID).any())
    if not ok:
        raise ValueError("the k-step lean split needs the cylinder channel's border: OBSTACLE "
                         "side columns and no FLUID cell on the first and last rows")


def make_sharded_fused_cylinder_step(cfg, mesh: Mesh, tile_rows=0, lean_split=None,
                                     lean_x_whole=None, lean_k=None, lean_x_ext=None,
                                     lean_x_halo=None, route=None):
    """Sharded fused step ``step(state, fields) -> state`` on sharded
    dicts (per key, the blocks of the shards this process holds, in
    ``mesh.local`` order: `parallel.sharded.shard_state`), advancing
    ``step.k`` lattice steps per call; the arguments as for the JAX
    function (module note). ``step.route`` is "lean", "pieces" or
    "padded". ``route`` picks how the lean split runs (``step.lean_route``):
    None, one `cyl_pass_sh` launch a shard where the pass takes k and the
    shards (`pass_sh_fits`), else the two launches; "pass" the pass
    (ValueError where it cannot run); "launches" `cyl_lean_sh` and
    `cyl_window_sh` on each band window, the yardstick."""
    if route not in (None, "pass", "launches"):
        raise ValueError(f"route={route!r}: one of None, 'pass', 'launches'")
    H, W = cfg.res
    ny, nx = mesh.shape
    if H % ny or W % nx:
        raise ValueError("grid must tile the mesh")
    h, w = H // ny, W // nx
    if h < 3 or w < 3:
        raise ValueError("blocks must be at least 3 cells wide")
    lean_k = 1 if lean_k is None else int(lean_k)
    if not 1 <= lean_k <= 8:
        raise ValueError(f"lean_k = {lean_k} outside 1 .. 8")
    if lean_x_ext is None:
        x_ext = 128 if (nx > 1 and lean_k > 1) else 0
    else:
        x_ext = int(lean_x_ext)
    if x_ext and lean_x_whole:
        raise ValueError("extended-window mode and x_whole are mutually exclusive")
    x_halo = min(x_ext, 8) if lean_x_halo is None else int(lean_x_halo)
    if not (x_ext == 0 or lean_k <= x_halo <= x_ext):
        raise ValueError("need lean_k <= x_halo <= x_ext")
    # lean wrongness spreads (k-1) rows past the single-step band reach,
    # so the fix region widens with k (margin 4 mirrors _band_tiles)
    regions = _fix_regions(cfg, margin=4.0 + (lean_k - 1))
    lean_ok = (
        h % 8 == 0
        and w % 8 == 0
        and max((hi - lo for lo, hi in regions), default=0) <= h - 2 * lean_k
        and ((x_ext == 0 and (nx == 1 or (lean_k == 1 and lean_x_whole is not True)))
             or (lean_k <= x_ext <= w))
    )
    if lean_split is None:
        lean_split = lean_ok
    elif lean_split and not lean_ok:
        raise ValueError(
            f"lean_split needs 8-aligned shards with h - 2k >= the largest "
            f"band region (and nx == 1 or k <= x_ext <= w for k > 1); got "
            f"h={h}, w={w}, k={lean_k}, x_ext={x_ext}, regions={regions}")
    if tile_rows == 0:
        tile_rows = _pick_tile_rows(h, w)
    if tile_rows is not None and (tile_rows % 8 or h % tile_rows):
        raise ValueError(f"tile_rows={tile_rows} must be a multiple of 8 "
                         f"dividing the per-shard rows {h}")
    c = K.consts(cfg)
    if lean_split:
        k = lean_k
        xh = int(lean_x_halo) if lean_x_halo is not None else k
        body_route = "lean"
    else:
        k, xh = 1, 1
        body_route = "pieces" if tile_rows is not None else "padded"
    if nx > 1 and 2 * xh > (nx - 1) * w:
        raise ValueError(f"column blocks of {xh} lanes overlap on shards {w} wide")
    shards = [CylShard.of(H, W, mesh.shape, co, k, xh) for co in mesh.local]
    L = range(len(shards))
    checked = {}
    lean_route = None
    if lean_split:
        fits = all(pass_sh_fits(sh, k) for sh in shards)
        if route == "pass" and not fits:
            raise ValueError(f"route='pass': cyl_pass_sh takes 1 <= k <= 4 and pieces of k rows "
                             f"and lanes (k = {k}, shards of {h}x{w}, {xh} lanes)")
        lean_route = "pass" if fits and route != "launches" else "launches"
    elif route == "pass":
        raise ValueError("route='pass' runs the lean split, which these arguments do not take")
    windows = [band_windows(sh, regions) for sh in shards]
    pass_rows = [pass_sh_rows(sh, wi) for sh, wi in zip(shards, windows)]

    def lean_step(f, rho, vel, flags, phi):
        if k > 1:
            key = tuple((x.data_ptr(), x._version) for x in flags)
            if checked.get("key") != key:
                for x, sh in zip(flags, shards):
                    _check_border_shard(x, sh)
                checked["key"] = key
        halos = exchange([lean_group(f[i], rho[i], vel[i], flags[i], phi[i]) for i in L], mesh,
                         xh if nx > 1 else 0, rows=k)
        if lean_route == "pass":
            return [cyl_pass_sh(f[i], rho[i], vel[i], flags[i], phi[i], halos[i], k, pass_rows[i],
                                c, shards[i]) for i in L]
        out = [cyl_lean_sh(f[i], halos[i], k, c, shards[i]) for i in L]
        for i, sh in enumerate(shards):
            for b0, nb in windows[i]:
                cyl_window_sh(f[i], rho[i], vel[i], flags[i], phi[i], halos[i], k, b0, nb,
                              out[i], c, sh)
        return out

    def pieces_step(f, rho, vel, flags, phi):
        halos = exchange([full_group(f[i], vel[i], flags[i]) for i in L], mesh,
                         1 if nx > 1 else 0)
        return [cyl_block_sh(f[i], rho[i], vel[i], flags[i], phi[i], halos[i], c, shards[i])
                for i in L]

    def padded_step(f, rho, vel, flags, phi):
        fp, velp, flagsp = pad_halo(f, mesh), pad_halo(vel, mesh), pad_halo(flags, mesh)
        return [cyl_block_sh(fp[i], rho[i], velp[i], flagsp[i], phi[i], None, c, shards[i])
                for i in L]

    body = {"lean": lean_step, "pieces": pieces_step, "padded": padded_step}[body_route]

    def step(state, fields):
        out = body(state["f"], state["rho"], state["vel"], fields["flags"], fields["phi_obs"])
        return {"f": [o[0] for o in out], "rho": [o[1] for o in out],
                "vel": [o[2] for o in out]}

    step.k = lean_k if lean_split else 1
    step.route = body_route
    step.lean_route = lean_route
    step.shards = shards
    step.regions = regions if lean_split else []
    return step


def make_sharded_fused_cylinder_runner(cfg, mesh: Mesh, tile_rows=0, lean_split=None,
                                       lean_x_whole=None, lean_k=None, lean_x_ext=None,
                                       lean_x_halo=None, route=None):
    """``run(state, fields, n)``: n steps on the mesh, global ``state``
    (f, rho, vel) and ``fields`` (flags, phi_obs) in, global state out:
    k-step passes while at least k steps remain, then single steps (the
    JAX runner's cascade); ``route`` as for the step, for both."""
    kw = dict(tile_rows=tile_rows, lean_split=lean_split, lean_x_whole=lean_x_whole,
              lean_x_ext=lean_x_ext, lean_x_halo=lean_x_halo, route=route)
    stepk = make_sharded_fused_cylinder_step(cfg, mesh, lean_k=lean_k, **kw)
    step1 = stepk if stepk.k == 1 else make_sharded_fused_cylinder_step(cfg, mesh, lean_k=1,
                                                                         **kw)

    def run(state, fields, n: int):
        st = {x: split(state[x], mesh) for x in ("f", "rho", "vel")}
        fl = {x: split(fields[x], mesh) for x in ("flags", "phi_obs")}
        m = int(n)
        while m >= stepk.k:
            st = stepk(st, fl)
            m -= stepk.k
        for _ in range(m):
            st = step1(st, fl)
        return {x: gather(v, mesh) for x, v in st.items()}

    run.stepk, run.step1 = stepk, step1
    return run
