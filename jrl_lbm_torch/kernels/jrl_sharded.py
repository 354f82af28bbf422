"""The JRL case on a ``(ny, nx)`` mesh of shards: the fluid phase, the C
balance and the C approach, each shard through hand-written CUDA kernels
(`csrc/fluid_pass_sh.cu`, `c_balance_pass_sh.cu`, `c_approach_pass_sh.cu`,
`fluid_a_sh.cu`, `fluid_b_sh.cu`, `c_balance_sh.cu`, `c_approach_sh.cu`),
each with its plain PyTorch twin, and the runners.

Replaces the TPU kernels of `jrl_lbm_tpu/ops/pallas/fused_jrl_sharded.py`:
``_step_a`` and ``_step_b`` (and their lean pair ``_step_a_lean``,
``_step_b_lean``, here a LEAN template instance of each kernel),
``_step_balance`` and ``_step_approach``; and the ``shard=True`` mode of
`fused_jrl_tiled.py::_make_fluid_k_kernel` (k fused fluid steps of a
shard from its 2k-row pieces), which no JAX runner builds: here
`fluid_pass_sh`, the sharded fluid runner's default route (one
cooperative launch a shard and k-step pass, the full or, on a row mesh,
the lean class: the k sub-steps in turn over the whole shard, each in one
wave of tiles on every SM, `pass_sh_plan`; on a column mesh the pass has
the x window of JAX's 2D-mesh per-step route, ``_xblocks`` k steps deep:
2k lanes a side from the 2k-row column blocks, corners included); and k
launches of ``_step_balance`` or of
``_step_approach`` (with the jnp frame lerp before each) as one launch of
`c_balance_pass_sh` or `c_approach_pass_sh`, the C runners' default route
on a row mesh, on the same launch form (`csrc/pass_sh.cuh`). The runners
port ``make_sharded_tiled_{fluid,balance,approach}_runner`` with their
``(state, fields, ...)`` contracts: global tensors in and out.

Each kernel runs the unchanged cell code of the unsharded kernels in
global coordinates, reading beyond its shard through the halo pieces of
`halo.py` (`csrc/jrl_shard.cuh`), so a sharded run equals the unsharded
per-step kernels bit for bit; so do the twins on the CPU, which embed the
shard and its pieces in a grid of zeros and run the whole-grid twin of
the unsharded kernel (`jrl_fluid.py`, `jrl_c.py`), keeping the shard's
cells (the lean twins run the lean class bodies of `jrl_tiled.py` on the
shard's row window instead, so a lean body that differs shows on the
CPU). The tip-disk integrals are summed per shard in the JAX package's
row-split form and across shards once per chunk (`parallel/halo.py::
psum`), so they agree with the unsharded runner to rounding.

Where the JAX runner differs, and why:

* the step is ``(float)step`` of the integer step, the jnp form, not the
  Pallas form ``f32(step0) + f32(j)`` (ROADMAP, "Limits");
* the x halo is 2 lanes, the reach of the cell code, whatever ``x_ext``
  (accepted and checked as in JAX: it sizes the TPU's extension window,
  as ``tile_rows`` sizes its tiles; neither changes what the port
  computes). The flat flux term dC_r at a shard's last column reads the
  new C of the next shard's first column, which the disk block
  recomputes from the halo (JAX computes its extension lanes);
* ``unroll`` is the chunk over which the approach accumulates its disk
  partials before the one ``psum``; the fluid and balance runners accept
  it and ignore it;
* each runner runs passes of k steps, each one exchange of 2k-row
  pieces (and on a column mesh 2k-lane blocks) and one pass launch a
  shard, where JAX's runs its kernels a step (``route="launches"`` here;
  the C runners' route of column meshes).

A wrapper given tensors on the CPU runs its twin; given tensors on the
card it launches the kernel or raises. ``fluid_a_sh.launches`` etc.
count the launches, the lean instance's with the full one's.
`fluid_pass_sh`'s twin runs the port's tile-class pyramid
(`jrl_tiled.py::_pass_ref`) on the shard's rows, the C passes' twins k
whole-grid steps on the shard embedded with its pieces in a grid of NaN;
on the CPU each equals its kernel bit for bit (h, C; H100 runs, PERF.md).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from jrl_lbm_torch.kernels import build
from jrl_lbm_torch.kernels import jrl_c as _c
from jrl_lbm_torch.kernels import jrl_fluid as _fl
from jrl_lbm_torch.kernels import jrl_tiled as _tl
from jrl_lbm_torch.kernels.halo import Halo, as_planes, exchange
from jrl_lbm_torch.kernels.jrl_fluid import _P, stream_of
from jrl_lbm_torch.models import jrl as _jrl
from jrl_lbm_torch.parallel.halo import psum
from jrl_lbm_torch.parallel.mesh import Mesh, gather, split

XH = 2  # lanes of an x halo block: the cell code's reach (csrc/jrl_shard.cuh)
_F32 = torch.float32


def pass_xh(k: int) -> int:
    """Lanes of a column shard's blocks for a k-step pass
    (``pass_sh.cuh::sh_pass_xh``): its 2k-lane reach rounded up to a
    multiple of 4, so that each block row is whole 16-byte words."""
    return 4 * -(-2 * int(k) // 4)


# ---------------------------------------------------------------------------
# A shard's place in the grid
# ---------------------------------------------------------------------------

class ShardGeom(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("H", "W", "h", "w", "row0", "col0", "xh")]


class ShardPlanes(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("body", "top", "bot", "left", "right")]


@dataclasses.dataclass(frozen=True)
class Shard:
    """Shard ``(iy, ix)`` of an ``H x W`` grid on a ``(ny, nx)`` mesh: rows
    ``row0 .. row0+h-1``, columns ``col0 .. col0+w-1``; ``xh`` lanes of x
    halo (0 on a mesh of one column)."""

    H: int
    W: int
    h: int
    w: int
    row0: int
    col0: int
    xh: int

    @classmethod
    def of(cls, H: int, W: int, mesh_shape, coord) -> "Shard":
        ny, nx = mesh_shape
        h, w = H // ny, W // nx
        return cls(H, W, h, w, coord[0] * h, coord[1] * w, XH if nx > 1 else 0)

    @functools.cached_property
    def geom(self) -> ShardGeom:
        return ShardGeom(self.H, self.W, self.h, self.w, self.row0, self.col0, self.xh)

    def body(self, x: torch.Tensor) -> torch.Tensor:
        """The shard's cells of a global ``[..., H, W]`` tensor."""
        return x[..., self.row0:self.row0 + self.h, self.col0:self.col0 + self.w].contiguous()


# ---------------------------------------------------------------------------
# Plain twins: the whole-grid twins on the shard embedded with its pieces
# ---------------------------------------------------------------------------

def _embed(sh: Shard, body: torch.Tensor, halo: Halo | None = None, off: int = 0):
    """A global ``[n, H, W]`` grid of zeros holding the shard's ``n`` planes
    ``body`` and, from ``halo``, planes ``off .. off+n-1`` of its row
    pieces and column blocks at their global places (mod H, W)."""
    b = as_planes(body)
    n = b.shape[0]
    g = torch.zeros((n, sh.H, sh.W), dtype=b.dtype, device=b.device)
    if halo is not None and halo.left is not None:
        er = torch.arange(sh.row0 - 1, sh.row0 + sh.h + 1, device=b.device) % sh.H
        # without row pieces the blocks' end rows hold zeros, not the wrap
        keep = slice(None) if halo.top is not None else slice(1, -1)
        for blk, c0 in ((halo.left, sh.col0 - sh.xh), (halo.right, sh.col0 + sh.w)):
            cols = torch.arange(c0, c0 + sh.xh, device=b.device) % sh.W
            g[:, er[keep][:, None], cols[None, :]] = blk[off:off + n, keep]
    if halo is not None and halo.top is not None:
        cs = slice(sh.col0, sh.col0 + sh.w)
        g[:, (sh.row0 - 1) % sh.H, cs] = halo.top[off:off + n]
        g[:, (sh.row0 + sh.h) % sh.H, cs] = halo.bot[off:off + n]
    g[:, sh.row0:sh.row0 + sh.h, sh.col0:sh.col0 + sh.w] = b
    return g


def _lean_window(sh: Shard, body, halo: Halo, off: int):
    """Planes ``off ..`` of the shard's ``[n, h+2, W]`` row window (lean
    shards: a row mesh, so the shard spans the grid's width)."""
    b = as_planes(body)
    n = b.shape[0]
    return torch.cat([halo.top[off:off + n, None], b, halo.bot[off:off + n, None]], dim=1)


def _check_lean(sh: Shard, halo: Halo):
    if sh.w != sh.W or halo.top is None:
        raise ValueError("the lean pair serves shards of a row mesh of >= 2 rows")


def fluid_a_sh_ref(f, rho, vel, halo: Halo, step: int, cfg, fields, sh: Shard, lean=False):
    """Twin of `fluid_a_sh`; ``halo`` holds the f and vel pieces (11 planes)."""
    if lean:
        _check_lean(sh, halo)
        return _tl._a_lean(cfg, sh.h, _lean_window(sh, f, halo, 0))
    fo, ro, vo = _fl.fluid_a_ref(_embed(sh, f, halo, 0), _embed(sh, rho)[0],
                                 _embed(sh, vel, halo, 9), step, cfg, fields)
    return sh.body(fo), sh.body(ro), sh.body(vo)


def fluid_b_sh_ref(f, rho, vel, halo: Halo, step: int, cfg, fields, sh: Shard, lean=False):
    """Twin of `fluid_b_sh`; ``halo`` holds the rho and vel pieces of the
    post-moment fields (3 planes)."""
    if lean:
        _check_lean(sh, halo)
        return _tl._b_lean(cfg, sh.h, f, _lean_window(sh, rho, halo, 0)[0],
                           _lean_window(sh, vel, halo, 1))
    fo = _fl.fluid_b_ref(_embed(sh, f), _embed(sh, rho, halo, 0)[0], _embed(sh, vel, halo, 1),
                         step, cfg, fields)
    return sh.body(fo)


def _check_depth(sh: Shard, k: int):
    """A k-step pass (1 <= k <= 4) serves a shard whose pieces come from
    one neighbour (2k <= h on a mesh of >1 row, 2k <= w on a mesh of >1
    column) and whose window of h + 4k rows holds each grid row once (4k <
    H); a column shard's lanes as its rows (4k < W) and on 16-byte rows (w
    % 4 == 0)."""
    if not 1 <= int(k) <= _tl.KMAX:
        raise ValueError(f"k = {k}: the pass takes 1 <= k <= {_tl.KMAX}")
    if (sh.h < sh.H and 2 * k > sh.h) or 4 * k >= sh.H:
        raise ValueError(f"k = {k} too deep for shards of {sh.h} of {sh.H} rows (2k <= h, "
                         f"4k < H)")
    if sh.w < sh.W:
        if sh.w % 4:
            raise ValueError(f"shards of {sh.w} columns: the column pass copies 16-byte rows "
                             f"(w % 4 == 0)")
        if 2 * k > sh.w or 4 * k >= sh.W:
            raise ValueError(f"k = {k} too deep for shards of {sh.w} of {sh.W} columns (2k <= w, "
                             f"4k < W)")


def _check_pass_sh(sh: Shard, halo: Halo | None, k: int, lean: bool):
    """`_check_depth`, and the shard's 2k-row pieces of [f, vel, rho] (none
    on a mesh of one row) and its blocks of `pass_xh` lanes of the rows
    extended by 2k a side (none on a mesh of one column); a lean pass on an
    inner shard of a row mesh."""
    _check_depth(sh, k)
    rows = halo is not None and halo.top is not None
    cols = halo is not None and halo.left is not None
    blocks = (12, sh.h + 4 * k, pass_xh(k))
    if rows != (sh.h < sh.H) or cols != (sh.w < sh.W) or ((rows or cols) and (
            halo.k != 2 * k or halo.P != 12)) or (cols and any(
            tuple(t.shape) != blocks for t in (halo.left, halo.right))):
        raise ValueError(f"halo pieces do not match the shard's mesh: a mesh of >1 row needs the "
                         f"{2 * k}-row pieces of [f, vel, rho] (12 planes), a mesh of >1 column "
                         f"their {2 * k}-row blocks {blocks}")
    if lean and not (rows and sh.w == sh.W and 0 < sh.row0 and sh.row0 + sh.h < sh.H):
        raise ValueError("the lean pass serves the inner shards of a row mesh of >= 3 rows")


def _embed_rows(sh: Shard, body, halo: Halo | None, fill, planes: slice = slice(None)):
    """The shard's ``[..., h, w]`` planes ``body`` at their global places in
    a ``[..., H, W]`` grid of ``fill``, with planes ``planes`` of its row
    pieces (``halo.k`` rows a side, mod H) and of its column blocks' lanes
    that lie inside the grid (their rows: the shard's extended by
    ``halo.k`` a side, mod H; the shard's own on a mesh of one row). The
    outer shards' ring lanes are left ``fill``: a pass never reads them."""
    b = as_planes(body)
    dev = b.device
    g = torch.full((b.shape[0], sh.H, sh.W), fill, dtype=b.dtype, device=dev)
    if halo is not None and halo.left is not None:
        d, xh = halo.k, halo.left.shape[-1]
        if sh.h == sh.H:
            er, keep = torch.arange(sh.H, device=dev), slice(d, d + sh.h)
        else:
            er, keep = torch.arange(sh.row0 - d, sh.row0 + sh.h + d, device=dev) % sh.H, slice(None)
        for blk, c0 in ((halo.left, sh.col0 - xh), (halo.right, sh.col0 + sh.w)):
            lanes = torch.arange(c0, c0 + xh, device=dev)
            inside = (lanes >= 0) & (lanes < sh.W)
            g[:, er[:, None], lanes[inside][None, :]] = blk[planes, keep][..., inside]
    cs = slice(sh.col0, sh.col0 + sh.w)
    if halo is not None and halo.top is not None:
        d = halo.k
        g[:, torch.arange(sh.row0 - d, sh.row0, device=dev) % sh.H, cs] = \
            halo.top[planes].reshape(-1, d, sh.w)
        g[:, torch.arange(sh.row0 + sh.h, sh.row0 + sh.h + d, device=dev) % sh.H, cs] = \
            halo.bot[planes].reshape(-1, d, sh.w)
    g[:, sh.row0:sh.row0 + sh.h, cs] = b
    return g.reshape(tuple(body.shape[:-2]) + (sh.H, sh.W))


def fluid_pass_sh_ref(f, rho, vel, halo: Halo | None, step: int, k: int, cfg, fields, sh: Shard,
                      lean=False):
    """Twin of `fluid_pass_sh`: the shard, its pieces and its blocks'
    lanes embedded at their global places in a grid of NaN, and the port's
    tile-class pyramid (`jrl_tiled.py::_pass_ref`, full or lean) on the
    shard's rows, which reads the 2k rows and lanes beyond them a side and
    nothing else; the shard's columns of the result."""
    _check_pass_sh(sh, halo, k, lean)
    H, W = sh.H, sh.W
    dev = f.device
    nan = float("nan")

    def grid(body, planes):
        return _embed_rows(sh, body, halo, nan, planes)

    gf = grid(f, slice(0, 9))
    gr, gv = (None, None) if lean else (grid(rho, slice(11, 12)), grid(vel, slice(9, 11)))
    out = {"f": torch.full_like(gf, nan), "rho": torch.full((H, W), nan, device=dev),
           "vel": torch.full((2, H, W), nan, device=dev)}
    _tl._pass_ref("lean" if lean else "full", cfg, gf, gr, gv, out, [(sh.row0, sh.row0 + sh.h)],
                  int(step), int(k))
    return sh.body(out["f"]), sh.body(out["rho"]), sh.body(out["vel"])


def c_balance_sh_ref(h, C, flags, halo_h: Halo, halo_fl: Halo, cfg, fields, sh: Shard):
    """Twin of `c_balance_sh`."""
    ho, Co = _c.c_balance_ref(_embed(sh, h, halo_h), _embed(sh, C)[0],
                              _embed(sh, flags, halo_fl)[0], cfg, fields)
    return sh.body(ho), sh.body(Co)


def disk_partials_ref(Cn, vel, step: int, cfg, fields, sh: Shard):
    """The shard's terms of (inflow, current, rec_u, rec_v) from the new C
    and the stored velocity on the global grid (the JAX package's per-tile
    row-split sums of ``_make_c_approach_kernel``): each term a product of
    one cell's values on a disk row the shard owns."""
    dev = Cn.device
    v, rint, rg = cfg.vel_obs_conv, cfg.radius_obs_int, cfg.Rg_radius
    wi = _jrl.tip_walks(cfg.inflow_height, step, v)[1]
    zero = torch.zeros((), dtype=_F32, device=dev)
    if sh.col0 >= rint:
        return torch.stack([zero] * 4)
    x = torch.arange(sh.col0, min(sh.col0 + sh.w, rint), device=dev)
    area = fields["area"][x]
    rx = x.to(_F32) + 0.5

    def owned(r):
        return sh.row0 <= r < sh.row0 + sh.h

    def disk(r):
        return torch.sum(Cn[r, x] * area) if owned(r) else zero

    def dcr(r):
        if not owned(r):
            return zero
        rC, rC1 = rx * Cn[r, x], ((x + 1).to(_F32) + 0.5) * Cn[r, x + 1]
        return torch.sum(((rC1 - rC) / rx) * area)

    s_m1, s_in, s_cur = disk(wi - 1), disk(wi), disk(wi + 1)
    if cfg.shape in _jrl.FLAT_SHAPES:
        inflow, current = (s_in - s_m1) + dcr(wi), (s_cur - s_in) + dcr(wi + 1)
    else:
        inflow, current = s_in, s_cur
    r = wi + 1
    if owned(r):
        tip = (r < wi) & (x < rg)
        rec_u = torch.sum(torch.where(tip, 0.0, vel[0, r, x] * v) * area)
        rec_v = torch.sum(torch.where(tip, v, vel[1, r, x] * v) * area)
    else:
        rec_u = rec_v = zero
    return torch.stack([inflow, current, rec_u, rec_v]).to(_F32)


def c_approach_sh_ref(h, C, vel, base, halo_h: Halo, halo_fl: Halo, step: int, cfg, fields,
                      sh: Shard):
    """Twin of `c_approach_sh`: ``(h, C, partials)``, the partials as
    `disk_partials_ref`. The stored velocity off the shard reads 0, as the
    kernel's does."""
    vel_g = _embed(sh, vel)
    ho, Co, _ = _c.c_approach_ref(_embed(sh, h, halo_h), _embed(sh, C)[0], vel_g, step, cfg,
                                  dict(fields, base_flags=_embed(sh, base, halo_fl)[0]))
    return sh.body(ho), sh.body(Co), disk_partials_ref(Co, vel_g, step, cfg, fields, sh)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _check(sh: Shard, step: int, **tensors) -> torch.device:
    """Float32 (int32 flags) contiguous tensors of the shard's shape on one
    CUDA device, and an int32 step."""
    if not 0 <= int(step) < 2**31:
        raise ValueError(f"step {step} outside int32 [0, 2**31)")
    dev = None
    for name, (t, lead) in tensors.items():
        want = tuple(lead) + (sh.h, sh.w)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {want}")
        if t.dtype != (torch.int32 if name in ("flags", "base") else _F32):
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


def _planes_of(sh: Shard, body: torch.Tensor, halo: Halo | None = None, off: int = 0,
               dev=None) -> ShardPlanes:
    """The kernel's view of planes ``off ..`` of a halo group, with its
    pieces checked (shape, dtype, device, contiguity) before any pointer
    is taken."""
    sp = ShardPlanes(body.data_ptr())
    if halo is None:
        return sp
    for name, t, shape in (("top", halo.top, (halo.P, sh.w)), ("bot", halo.bot, (halo.P, sh.w)),
                           ("left", halo.left, (halo.P, sh.h + 2, sh.xh)),
                           ("right", halo.right, (halo.P, sh.h + 2, sh.xh))):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != body.dtype or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"halo {name}: {tuple(t.shape)} {t.dtype} on {t.device}, expected "
                             f"contiguous {shape} {body.dtype} on {dev}")
        step = (off * (sh.h + 2) * sh.xh if name in ("left", "right") else off * sh.w) * 4
        setattr(sp, name, t.data_ptr() + step)
    need_rows = sh.h < sh.H
    if (halo.top is None) == need_rows or (halo.left is None) == bool(sh.xh):
        raise ValueError("halo pieces do not match the shard's mesh")
    return sp


def fluid_a_sh(f, rho, vel, halo: Halo, step: int, cfg, fields, sh: Shard, lean=False):
    """Fluid step A on a shard; returns the shard's new ``(f, rho, vel)``.
    ``halo``: the f and vel pieces (`halo.exchange` of ``[f, vel]``);
    ``lean``: the instance for shards above the tip front."""
    if f.device.type == "cpu":
        return fluid_a_sh_ref(f, rho, vel, halo, step, cfg, fields, sh, lean)
    if lean:
        _check_lean(sh, halo)
    dev = _check(sh, step, f=(f, (9,)), rho=(rho, ()), vel=(vel, (2,)))
    f_out, rho_out, vel_out = torch.empty_like(f), torch.empty_like(rho), torch.empty_like(vel)
    pf, pv = _planes_of(sh, f, halo, 0, dev), _planes_of(sh, vel, halo, 9, dev)
    pr = _planes_of(sh, rho)
    fn = build.bind("fluid_a_sh", "jrl_fluid_a_sh", [_P] * 6 + [ctypes.c_int, _P, _P,
                                                               ctypes.c_int, _P])
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(pf), ctypes.byref(pr), ctypes.byref(pv), f_out.data_ptr(),
                 rho_out.data_ptr(), vel_out.data_ptr(), int(step), ctypes.byref(_fl._a_params(cfg)),
                 ctypes.byref(sh.geom), int(bool(lean)), stream_of(dev))
    build.check(err, "fluid_a_sh")
    fluid_a_sh.launches += 1
    return f_out, rho_out, vel_out


def fluid_b_sh(f, rho, vel, halo: Halo, step: int, cfg, fields, sh: Shard, lean=False):
    """Fluid step B on a shard; returns the shard's collided ``f``.
    ``halo``: the rho and vel pieces of the post-moment fields
    (`halo.exchange` of ``[rho, vel]``)."""
    if f.device.type == "cpu":
        return fluid_b_sh_ref(f, rho, vel, halo, step, cfg, fields, sh, lean)
    if lean:
        _check_lean(sh, halo)
    dev = _check(sh, step, f=(f, (9,)), rho=(rho, ()), vel=(vel, (2,)))
    f_out = torch.empty_like(f)
    pf, pr, pv = _planes_of(sh, f), _planes_of(sh, rho, halo, 0, dev), \
        _planes_of(sh, vel, halo, 1, dev)
    fn = build.bind("fluid_b_sh", "jrl_fluid_b_sh", [_P] * 4 + [ctypes.c_int, _P, _P,
                                                               ctypes.c_int, _P])
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(pf), ctypes.byref(pr), ctypes.byref(pv), f_out.data_ptr(),
                 int(step), ctypes.byref(_fl._b_params(cfg)), ctypes.byref(sh.geom),
                 int(bool(lean)), stream_of(dev))
    build.check(err, "fluid_b_sh")
    fluid_b_sh.launches += 1
    return f_out


def c_balance_sh(h, C, flags, halo_h: Halo, halo_fl: Halo, cfg, fields, sh: Shard):
    """Balance step on a shard; returns the shard's new ``(h, C)``."""
    if h.device.type == "cpu":
        return c_balance_sh_ref(h, C, flags, halo_h, halo_fl, cfg, fields, sh)
    dev = _check(sh, 0, h=(h, (9,)), C=(C, ()), flags=(flags, ()))
    h_out, C_out = torch.empty_like(h), torch.empty_like(C)
    pfl, ph = _planes_of(sh, flags, halo_fl, 0, dev), _planes_of(sh, h, halo_h, 0, dev)
    fn = build.bind("c_balance_sh", "jrl_c_balance_sh", [_P] * 8)
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(pfl), ctypes.byref(ph), C.data_ptr(), h_out.data_ptr(),
                 C_out.data_ptr(), ctypes.byref(_c._balance_params(cfg)), ctypes.byref(sh.geom),
                 stream_of(dev))
    build.check(err, "c_balance_sh")
    c_balance_sh.launches += 1
    return h_out, C_out


def c_approach_sh(h, C, vel, base, halo_h: Halo, halo_fl: Halo, step: int, cfg, fields,
                  sh: Shard, part):
    """Approach step on a shard; returns the shard's new ``(h, C)`` and
    updates ``part`` (float32 ``[4]`` on the shard's device) in place with
    the shard's terms of the step's integrals: ``part[0] += inflow``,
    ``part[1] += current``, ``part[2] = rec_u``, ``part[3] = rec_v``.
    ``vel`` is the shard's interpolated stored velocity; the old ``C`` is
    never read (`c_approach.cu`)."""
    if h.device.type == "cpu":
        h, C, p = c_approach_sh_ref(h, C, vel, base, halo_h, halo_fl, step, cfg, fields, sh)
        part[0] += p[0]
        part[1] += p[1]
        part[2] = p[2]
        part[3] = p[3]
        return h, C
    dev = _check(sh, step, h=(h, (9,)), C=(C, ()), vel=(vel, (2,)), base=(base, ()))
    area = fields["area"]
    if tuple(area.shape) != (cfg.radius_obs_int,) or area.device != dev or area.dtype != _F32:
        raise ValueError("area must be a float32 [rint] tensor on the shard's card")
    if tuple(part.shape) != (4,) or part.dtype != _F32 or part.device != dev:
        raise ValueError("part must be a float32 [4] tensor on the shard's card")
    h_out, C_out = torch.empty_like(h), torch.empty_like(C)
    pb, ph = _planes_of(sh, base, halo_fl, 0, dev), _planes_of(sh, h, halo_h, 0, dev)
    fn = build.bind("c_approach_sh", "jrl_c_approach_sh", [_P] * 7 + [ctypes.c_int, _P, _P, _P])
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(pb), ctypes.byref(ph), vel.data_ptr(), area.data_ptr(),
                 h_out.data_ptr(), C_out.data_ptr(), part.data_ptr(), int(step),
                 ctypes.byref(_c._approach_params(cfg)), ctypes.byref(sh.geom), stream_of(dev))
    build.check(err, "c_approach_sh")
    c_approach_sh.launches += 1
    return h_out, C_out


class ShTilePlan(ctypes.Structure):
    """Mirrors ``csrc/pass_sh.cuh::ShTilePlan`` (a `TilePlan`)."""
    _fields_ = [("nty", ctypes.c_int * _tl.KMAX), ("ntx", ctypes.c_int), ("rmax", ctypes.c_int),
                ("smax", ctypes.c_int), ("grid", ctypes.c_int)]


def _tile_plan_struct(plan: TilePlan) -> ShTilePlan:
    t = ShTilePlan(ntx=plan.ntx, rmax=plan.rmax, smax=plan.smax, grid=plan.grid)
    for j, n in enumerate(plan.nty):
        t.nty[j] = n
    return t


class PassShParams(ctypes.Structure):
    """Mirrors ``csrc/fluid_pass_sh.cu::FluidPassShParams``."""
    _fields_ = [("a", _fl.FluidParams), ("b", _fl.FluidBParams), ("s", ShardGeom),
                ("lean", ctypes.c_int), ("t", ShTilePlan)]


class PassShSrc(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("f", "rho", "vel", "top", "bot")]


class PassShCols(ctypes.Structure):
    """Mirrors ``csrc/fluid_pass_sh.cu::FluidPassShCols``."""
    _fields_ = [(n, ctypes.c_void_p) for n in ("left", "right")]


# threads a block (one block an SM) and the dynamic shared memory a block
# may take, in every pass (csrc/pass_sh.cuh: SH_THREADS, SH_SMEM_CAP)
TILE_THREADS = 512
TILE_SMEM_CAP = 231424
# the plan's cost of a wave of tiles, per cell of its largest tile: an A
# cell, a B cell (shares of one A-and-B chain of the first design) and a
# window cell (its copies and geometry; PERF.md §6)
TILE_COST_A, TILE_COST_B, TILE_COST_W = 0.45, 0.55, 0.25
# the cells a thread a wave's tile costs at least: a cell of each kind for
# every thread of a block, or for half of them for the fluid, whose step
# still ran faster on tiles of 8 x 32 B cells (10 of 16 warps busy with A)
# than on 13 x 32 (16 warps) over 256x128 (PERF.md §6)
TILE_FLOOR_THREADS = {"fluid": TILE_THREADS // 2, "balance": TILE_THREADS,
                      "approach": TILE_THREADS}


def tile_smem_bytes(rmax: int, smax: int) -> int:
    """Bytes of a block's tables for tiles of at most ``rmax`` x ``smax``
    B cells (``FptLayout::bytes``): rows of ``smax + 8`` floats, ``rmax +
    5`` window rows; the input (12 planes), A's rho, u, v, phi, A's f of
    the B cells, the geometry codes."""
    rs, wp = smax + 8, rmax + 5
    return 4 * ((12 + 3 + 1) * wp * rs + 9 * rmax * smax) + wp * rs


def pass_sh_rows(sh: Shard, k: int):
    """B rows of each sub-step of a k-step pass: the shard's rows extended
    by 2 (k - 1 - j) a side (``h + 4 (k - 1 - j)``); on a mesh of one row
    the grid's ``H``, nothing extended."""
    k = int(k)
    return [sh.H if sh.h == sh.H else sh.h + 4 * (k - 1 - j) for j in range(k)]


def pass_sh_lanes(sh: Shard, k: int):
    """B lanes ``(X0, X1)`` of each sub-step of a k-step pass
    (``pass_sh.cuh::sh_lanes``): on a column mesh the shard's columns
    extended by 2 (k - 1 - j) a side and cut to the grid; else the grid's
    ``(0, W)``."""
    k = int(k)
    if sh.w == sh.W:
        return [(0, sh.W)] * k
    return [(max(sh.col0 - 2 * (k - 1 - j), 0), min(sh.col0 + sh.w + 2 * (k - 1 - j), sh.W))
            for j in range(k)]


def tile_strip(tx: int, ntx: int, W: int, X0: int = 0, X1: int | None = None):
    """``(sx0, sx1, cx0, cx1)`` of column strip ``tx`` of ``ntx`` of the
    lanes ``[X0, X1)`` (default the grid's): the B columns (inner ends on
    multiples of 4, the outer ones X0 and X1) and the window columns, two a
    side cut to the grid and rounded out to 16 bytes (``ShTile``)."""
    X1 = W if X1 is None else X1
    L = X1 - X0
    sx0 = X0 if tx == 0 else (X0 + tx * L // ntx) & ~3
    sx1 = X1 if tx + 1 == ntx else (X0 + (tx + 1) * L // ntx) & ~3
    return sx0, sx1, max(sx0 - 2, 0) & ~3, min((sx1 + 2 + 3) & ~3, W)


def pass_sh_tile(t: int, nty: int, ntx: int, E: int, W: int, X0: int = 0,
                 X1: int | None = None):
    """``(e0, e1, sx0, sx1, cx0, cx1)`` of tile ``t`` of a sub-step of
    ``E`` B rows and the lanes ``[X0, X1)``: extended rows ``[e0, e1)`` x
    the strip's columns."""
    ty, tx = divmod(int(t), int(ntx))
    return (ty * E // nty, (ty + 1) * E // nty) + tile_strip(tx, ntx, W, X0, X1)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """A launch: ``nty[j]`` row bands of sub-step j x ``ntx`` column
    strips, the largest tile ``rmax`` x ``smax``, ``grid`` blocks."""
    nty: tuple
    ntx: int
    rmax: int
    smax: int
    grid: int

    def tiles(self, j: int, E: int, W: int, X0: int = 0, X1: int | None = None):
        return [pass_sh_tile(t, self.nty[j], self.ntx, E, W, X0, X1)
                for t in range(self.nty[j] * self.ntx)]


def _smax_of(ntx: int, W: int, X0: int = 0, X1: int | None = None) -> int:
    """The widest strip, rounded up to a multiple of 4 (the tables' rows
    stay 16-byte aligned; a column shard's outer strips may end 2 past a
    multiple of 4)."""
    widest = max(b - a for a, b, _, _ in (tile_strip(t, ntx, W, X0, X1) for t in range(ntx)))
    return -(-widest // 4) * 4


# the plan's cost of a C cell (the balance's or the approach's step), per
# cell of its largest tile, beside TILE_COST_W a window cell (PERF.md §6)
C_TILE_COST = {"balance": 0.5, "approach": 0.6}
PASS_KINDS = ("fluid",) + tuple(C_TILE_COST)


def c_tile_smem_bytes(kind: str, rmax: int, smax: int) -> int:
    """Bytes of a block's tables for C tiles of at most ``rmax`` x ``smax``
    cells (``CbLayout`` of `csrc/c_balance_pass_sh.cu`, ``CaLayout`` of
    `csrc/c_approach_pass_sh.cu`): rows of ``smax + 8`` words, ``rmax + 4``
    window rows; h (9 planes) and the flags, then the column rates (9 floats
    a column) for the balance; h, phi and the flag codes, then the disk
    sum's tree (4 x 128 floats) for the approach."""
    rs, wp = smax + 8, rmax + 4
    if kind == "balance":
        return 4 * (10 * wp * rs + 9 * smax)
    return 4 * (11 * wp * rs + 4 * 128)


def pass_tile_bytes(kind: str, R: int, S_: int) -> int:
    """Bytes of a block's tables for tiles of ``R`` x ``S_`` cells of the
    pass of ``kind``."""
    return tile_smem_bytes(R, S_) if kind == "fluid" else c_tile_smem_bytes(kind, R, S_)


def _tile_cost(kind: str, R: int, S_: int) -> float:
    """A wave's cost of tiles of ``R`` x ``S_`` cells, at least a cell of
    each kind for ``TILE_FLOOR_THREADS[kind]`` threads."""
    if kind == "fluid":
        cost = TILE_COST_A * (R + 2) * (S_ + 2) + TILE_COST_B * R * S_
        cell = TILE_COST_A + TILE_COST_B
    else:
        cost, cell = C_TILE_COST[kind] * R * S_, C_TILE_COST[kind]
    cost += TILE_COST_W * (R + 4) * (S_ + 8)
    return max(cost, (cell + TILE_COST_W) * TILE_FLOOR_THREADS[kind])


@functools.lru_cache(maxsize=256)
def pass_sh_plan(sh: Shard, k: int, sms: int = _tl.PASS_SMS, kind: str = "fluid") -> TilePlan:
    """The plan of a k-step pass of ``sh`` by the kernel of ``kind``
    (`PASS_KINDS`: `fluid_pass_sh`, `c_balance_pass_sh`,
    `c_approach_pass_sh`). Each sub-step's bands and the launch's strips
    minimise the waves of ``sms`` blocks times a wave's cost (`_tile_cost`:
    ``TILE_COST_*`` x the largest tile's A cells (R + 2) x (S + 2), B cells
    R x S and window cells (R + 4) x (S + 8); a C tile's cells at
    ``C_TILE_COST``), with strips of at least 32 columns (the window rows'
    copies), each tile's tables within ``TILE_SMEM_CAP`` and its window (R
    + 5 rows) within the grid's rows. On a column mesh each sub-step's
    strips cut its lanes (`pass_sh_lanes`), the widest sets the tables."""
    H, W, k = sh.H, sh.W, int(k)
    if kind not in PASS_KINDS:
        raise ValueError(f"kind {kind!r}: one of {PASS_KINDS}")
    rows, lanes = pass_sh_rows(sh, k), pass_sh_lanes(sh, k)
    if W % 4 or W < 4 or sh.w % 4:
        raise ValueError(f"W = {W}, w = {sh.w}: the tiles take W % 4 == 0 and w % 4 == 0")
    best = None
    for ntx in range(1, max(1, min(X1 - X0 for X0, X1 in lanes) // 32) + 1):
        widths = [_smax_of(ntx, W, X0, X1) for X0, X1 in lanes]
        S_ = max(widths)
        total, nty = 0.0, []
        for E, Sj in zip(rows, widths):
            pick = None
            for R in range(1, min(E, H - 5, 256) + 1):
                if pass_tile_bytes(kind, R, S_) > TILE_SMEM_CAP:
                    break
                n = -(-E // R)
                waves = -(-(n * ntx) // int(sms))
                cost = waves * _tile_cost(kind, R, Sj)
                if pick is None or (cost, n) < pick[:2]:
                    pick = (cost, n)
            if pick is None:
                break
            total += pick[0]
            nty.append(pick[1])
        else:
            key = (total, max(nty) * ntx)
            if best is None or key < best[0]:
                best = (key, ntx, tuple(nty), S_)
    if best is None:
        raise ValueError(f"{H}x{W}: no tile fits the shared memory")
    _, ntx, nty, smax = best
    rmax = max(-(-E // n) for E, n in zip(rows, nty))
    return TilePlan(nty, ntx, rmax, smax, _grid_of(kind, nty, ntx, sms))


def _grid_of(kind: str, nty, ntx: int, sms: int) -> int:
    """Blocks of a launch: one a tile of the largest sub-step, at most
    ``sms``; the approach one more where the card holds it, a block with no
    tile that sums each step's disk terms while the others run the next
    sub-step."""
    return min(int(sms), max(nty) * ntx + (kind == "approach"))


def tile_plan(sh: Shard, k: int, R: int, S_: int, sms: int = _tl.PASS_SMS) -> TilePlan:
    """A plan of `fluid_pass_sh` of bands of about ``R`` rows and strips of
    about ``S_`` columns in place of `pass_sh_plan`'s (the CPU tests'
    schedules, the probe's tile shapes)."""
    H, W = sh.H, sh.W
    rows, lanes = pass_sh_rows(sh, k), pass_sh_lanes(sh, k)
    L = min(X1 - X0 for X0, X1 in lanes)
    ntx = min(max(1, -(-L // int(S_))), L // 4)
    nty = tuple(min(E, max(1, -(-E // int(R)))) for E in rows)
    rmax = max(-(-E // n) for E, n in zip(rows, nty))
    smax = max(_smax_of(ntx, W, X0, X1) for X0, X1 in lanes)
    if rmax + 5 > H or tile_smem_bytes(rmax, smax) > TILE_SMEM_CAP:
        raise ValueError(f"tiles of {R}x{S_}: rmax {rmax}, smax {smax} outgrow the grid or the "
                         f"shared memory")
    return TilePlan(nty, ntx, rmax, smax, min(int(sms), max(nty) * ntx))


@functools.lru_cache(maxsize=256)
def _pass_sh_params(cfg, sh: Shard, lean: bool, plan: TilePlan) -> PassShParams:
    return PassShParams(a=_fl._a_params(cfg), b=_fl._b_params(cfg), s=sh.geom, lean=int(lean),
                        t=_tile_plan_struct(plan))


def _scratch_rows_cols(sh: Shard, k: int):
    """A scratch plane of a pass at depth k: the shard's rows extended by
    2k a side (a mesh of one row: its ``H``) x ``W`` (a column shard: its
    ``w`` columns and `pass_xh` lanes a side)."""
    return (sh.H if sh.h == sh.H else sh.h + 4 * int(k),
            sh.W if sh.w == sh.W else sh.w + 2 * pass_xh(k))


def pass_sh_scratch(sh: Shard, k: int, device, planes: int = 12) -> torch.Tensor | None:
    """The scratch of a pass of ``sh`` at depth k or below: ``min(k - 1,
    2)`` buffers of ``planes`` planes (12 for the fluid's [f, rho, u, v],
    10 for the C passes' [h, C]) of the shard's rows extended by 2k a side
    (a mesh of one row: its ``H`` rows) x ``W`` (a column shard: ``w +
    2 pass_xh(k)``); None at k = 1."""
    k = int(k)
    if k < 2:
        return None
    return torch.empty((min(k - 1, 2), int(planes)) + _scratch_rows_cols(sh, k), dtype=_F32,
                       device=device)


def fluid_pass_sh(f, rho, vel, halo: Halo | None, step: int, k: int, cfg, fields, sh: Shard,
                  lean=False, scratch=None):
    """k fluid steps (A then B each) of a shard from ``step`` in one launch;
    returns the shard's new ``(f, rho, vel)``. ``halo``: the 2k-row pieces
    of ``[f, vel, rho]`` and, on a column mesh, their blocks of `pass_xh`
    lanes (`halo.exchange` with ``rows=2k`` and ``xh=pass_xh(k)``; None or
    neither on a mesh of one shard); ``lean``: the lean class, for an inner
    shard of a row mesh above the tip front for every step of the pass
    (`lean_pass`); ``scratch``: the sub-steps' planes, `pass_sh_scratch`
    of the shard at this k or a deeper one (allocated here when None)."""
    if f.device.type == "cpu":
        return fluid_pass_sh_ref(f, rho, vel, halo, step, k, cfg, fields, sh, lean)
    _check_pass_sh(sh, halo, k, lean)
    _check(sh, step)  # steps step .. step + k - 1 in int32
    dev = _check(sh, int(step) + int(k) - 1, f=(f, (9,)), rho=(rho, ()), vel=(vel, (2,)))
    src, cols = PassShSrc(f.data_ptr(), rho.data_ptr(), vel.data_ptr()), None
    pieces = [] if halo is None else [("top", halo.top, (12, 2 * k, sh.w)),
                                      ("bot", halo.bot, (12, 2 * k, sh.w))]
    if halo is not None and halo.left is not None:
        cols = PassShCols()
        pieces += [(x, getattr(halo, x), (12, sh.h + 4 * k, pass_xh(k))) for x in ("left", "right")]
    for name, t, shape in pieces:
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != _F32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"halo {name}: {tuple(t.shape)} {t.dtype} on {t.device}, expected "
                             f"contiguous {shape} float32 on {dev}")
        setattr(src if name in ("top", "bot") else cols, name, t.data_ptr())
    ptrs = [src.f, src.rho, src.vel, src.top or 0, src.bot or 0] + \
        ([cols.left, cols.right] if cols else [])
    if sh.W % 4 or any(t % 16 for t in ptrs):
        raise ValueError("fluid_pass_sh copies rows of 16-byte aligned planes (W % 4 == 0)")
    # the kernel's ShardGeom carries a column shard's block lanes as xh
    psh = sh if sh.w == sh.W else dataclasses.replace(sh, xh=pass_xh(k))
    p = _pass_sh_params(cfg, psh, bool(lean), pass_sh_plan(sh, int(k), _fl.sm_count(dev)))
    scratch, scr = _scratch_ptrs(sh, k, 9 if lean else 12, scratch, dev)
    f_out, rho_out, vel_out = torch.empty_like(f), torch.empty_like(rho), torch.empty_like(vel)
    fn = build.bind("fluid_pass_sh", "jrl_fluid_pass_sh", [_P] * 7 + [ctypes.c_int] * 2
                    + [_P, _P])
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(src), None if cols is None else ctypes.byref(cols),
                 f_out.data_ptr(), rho_out.data_ptr(), vel_out.data_ptr(), scr[0], scr[1],
                 int(step), int(k), ctypes.byref(p), stream_of(dev))
    build.check(err, "fluid_pass_sh")
    fluid_pass_sh.launches += 1
    return f_out, rho_out, vel_out


def _scratch_ptrs(sh: Shard, k: int, planes: int, scratch, dev):
    """``(scratch, pointers)``: the scratch of a pass at depth k
    (`pass_sh_scratch` of the shard at this k or a deeper one, allocated
    here when None; the caller holds it until the launch is queued) and its
    two buffers' pointers (None where unused), each buffer holding
    ``planes`` planes of the pass's rows. Buffer b holds sub-step j's planes
    (j % 2 == b) for j + 1: shard row r at buffer row r + 2k (a mesh of one
    row: row r)."""
    k = int(k)
    if k < 2:
        return None, [None, None]
    nb = min(k - 1, 2)
    if scratch is None:
        scratch = pass_sh_scratch(sh, k, dev, planes)
    rows, cols = _scratch_rows_cols(sh, k)
    need = planes * rows * cols
    if scratch.dtype != _F32 or scratch.device != dev or not scratch.is_contiguous() \
            or scratch.dim() < 2 or scratch.shape[0] < nb or scratch[0].numel() < need:
        raise ValueError(f"scratch: {tuple(scratch.shape)} {scratch.dtype} on "
                         f"{scratch.device}, expected pass_sh_scratch's for k = {k} on {dev}")
    return scratch, [scratch[b].data_ptr() for b in range(nb)] + [None] * (2 - nb)


# the library of each kind of pass
PASS_LIBS = {"fluid": "fluid_pass_sh", "balance": "c_balance_pass_sh",
             "approach": "c_approach_pass_sh"}


def _pass_entry(kind: str, cols: bool) -> str:
    """The C entry prefix of the pass of ``kind``, its column instance
    (the fluid's) with ``cols``."""
    if cols and kind != "fluid":
        raise ValueError(f"kind {kind!r} has no column instance")
    return f"jrl_{PASS_LIBS[kind]}{'_cols' if cols else ''}"


def pass_sh_info(k: int, device_index: int = 0, kind: str = "fluid", cols: bool = False):
    """``(registers per thread, local bytes)`` of the instance at depth k of
    the pass of ``kind`` (`PASS_LIBS`; ``cols``: the fluid's column
    instance)."""
    lib = PASS_LIBS[kind]
    fn = build.bind(lib, f"{_pass_entry(kind, cols)}_info", [ctypes.c_int, _P, _P])
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(fn(int(k), ctypes.byref(regs), ctypes.byref(local)), lib)
    return regs.value, local.value


def pass_sh_tile_shape(k: int, rmax: int, smax: int, device_index: int = 0, kind: str = "fluid",
                       cols: bool = False):
    """The kernel's own ``(threads, shared memory cap, bytes of an rmax x
    smax tile, co-resident blocks at that size)`` at depth k, which
    `pass_sh_plan` mirrors (`TILE_THREADS`, `TILE_SMEM_CAP`, `pass_tile_bytes`)."""
    lib = PASS_LIBS[kind]
    fn = build.bind(lib, f"{_pass_entry(kind, cols)}_tile_shape", [ctypes.c_int] * 3 + [_P] * 4)
    out = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device_index):
        build.check(fn(int(k), int(rmax), int(smax), *(ctypes.byref(x) for x in out)), lib)
    return tuple(x.value for x in out)


# ---------------------------------------------------------------------------
# The C phases' k-step passes: c_balance_pass_sh, c_approach_pass_sh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardFrames:
    """A shard's window of the stored-velocity history: ``t`` holds frames
    ``b0 .. b0 + N - 1`` of a history of ``n_frames`` (None: ``b0 + N``) as
    ``[N, 2, rows, W]``, shard row r at row ``r + row0`` (its reach rows a
    side; on a mesh of one row the grid's rows, ``row0`` 0)."""

    t: torch.Tensor
    row0: int
    b0: int = 0
    n_frames: int | None = None

    @property
    def total(self) -> int:
        return self.b0 + int(self.t.shape[0]) if self.n_frames is None else int(self.n_frames)


def shard_frames(vel_field, sh: Shard, reach: int, device=None, b0: int = 0,
                 n_frames: int | None = None) -> ShardFrames:
    """The shard's `ShardFrames` cut from the global ``[N, 2, H, W]``
    history ``vel_field``: its rows and ``reach`` rows a side (mod H; all
    rows on a mesh of one row), on ``device`` (default the history's)."""
    v = torch.as_tensor(vel_field, dtype=_F32)
    if sh.h == sh.H:
        t, row0 = v, 0
    else:
        rows = torch.arange(sh.row0 - int(reach), sh.row0 + sh.h + int(reach),
                            device=v.device) % sh.H
        t, row0 = v[:, :, rows], int(reach)
    t = t[..., sh.col0:sh.col0 + sh.w].to(v.device if device is None else device).contiguous()
    return ShardFrames(t, row0, int(b0), n_frames)


def _check_c_pass_sh(sh: Shard, halo: Halo | None, P: int, halo_fl: Halo | None, k: int):
    """A shard of a row mesh (the C passes have no x window yet), `_check_depth`;
    the shard's 2k-row pieces of the ``P`` planes of its state group ([h,
    C] for the balance, [h] for the approach) and its flag pieces, at least
    2k rows deep (none on a mesh of one row)."""
    if sh.w != sh.W:
        raise ValueError("the C passes serve shards of a row mesh; a column mesh takes the "
                         "per-step kernels")
    _check_depth(sh, k)
    rows = sh.h < sh.H
    for name, hx, depth in (("state", halo, 2 * int(k)), ("flag", halo_fl, None)):
        has = hx is not None and hx.top is not None
        if has != rows or (has and (hx.P != (P if depth else 1)
                                    or (hx.k != depth if depth else hx.k < 2 * int(k)))):
            raise ValueError(f"{name} pieces do not match the shard's mesh: a mesh of >1 row "
                             f"needs the {2 * int(k)}-row pieces of the state group ({P} "
                             f"planes) and flag pieces at least as deep")


def c_balance_pass_sh_ref(h, C, flags, halo: Halo | None, halo_fl: Halo | None, k: int, cfg,
                          fields, sh: Shard):
    """Twin of `c_balance_pass_sh`: the shard and its pieces of [h, C]
    embedded at their global rows in a grid of NaN (the flags in a grid of
    0, no cell type), and k steps of the whole-grid twin
    (`jrl_c.c_balance_ref`); the shard's rows of the result."""
    _check_c_pass_sh(sh, halo, 10, halo_fl, k)
    nan = float("nan")
    hc = _embed_rows(sh, torch.cat([h, C[None]]), halo, nan)
    hg, Cg = hc[:9], hc[9]
    fg = _embed_rows(sh, flags, halo_fl, 0)
    for _ in range(int(k)):
        hg, Cg = _c.c_balance_ref(hg, Cg, fg, cfg, fields)
    return sh.body(hg), sh.body(Cg)


def c_approach_pass_sh_ref(h, base, frames: ShardFrames, halo: Halo | None,
                           halo_fl: Halo | None, step: int, k: int, cfg, fields, sh: Shard):
    """Twin of `c_approach_pass_sh`: the shard and its h pieces embedded at
    their global rows in a grid of NaN, its base flags and their pieces in a
    grid of 0 and its frame window at its global rows in frames of NaN; k
    steps of the stored velocity's lerp and the whole-grid twin
    (`jrl_c.c_approach_ref`) from ``step``. Returns ``(h, C, parts)``, the
    shard's rows and its ``[k, 4]`` disk terms a step
    (`disk_partials_ref`)."""
    _check_c_pass_sh(sh, halo, 9, halo_fl, k)
    nan = float("nan")
    hg = _embed_rows(sh, h, halo, nan)
    bg = _embed_rows(sh, base, halo_fl, 0)
    ft = frames.t
    fg = torch.full(tuple(ft.shape[:2]) + (sh.H, sh.W), nan, dtype=_F32, device=ft.device)
    fg[:, :, (torch.arange(ft.shape[2], device=ft.device) + sh.row0 - frames.row0) % sh.H] = ft
    fl = dict(fields, base_flags=bg)
    Cg, parts = torch.zeros_like(hg[0]), []
    for j in range(int(k)):
        s = int(step) + j
        vel = _jrl.stored_velocity(fg, s, cfg.vel_obs_conv, frames.b0, frames.total)
        hg, Cg, _ = _c.c_approach_ref(hg, Cg, vel, s, cfg, fl)
        parts.append(disk_partials_ref(Cg, vel, s, cfg, fields, sh))
    return sh.body(hg), sh.body(Cg), torch.stack(parts)


class CPassShSrc(ctypes.Structure):
    """Mirrors ``csrc/pass_sh.cuh::CPassShSrc``."""
    _fields_ = [(n, ctypes.c_void_p) for n in ("h", "C", "top", "bot", "fl", "fl_top", "fl_bot",
                                                "frames")]


class CBalancePassShParams(ctypes.Structure):
    """Mirrors ``csrc/c_balance_pass_sh.cu::CBalancePassShParams``."""
    _fields_ = [("p", _c.CBalanceParams), ("s", ShardGeom), ("t", ShTilePlan),
                ("fl_rows", ctypes.c_int)]


class CApproachPassShParams(ctypes.Structure):
    """Mirrors ``csrc/c_approach_pass_sh.cu::CApproachPassShParams``."""
    _fields_ = [("p", _c.CApproachParams), ("s", ShardGeom), ("t", ShTilePlan),
                ("fl_rows", ctypes.c_int), ("n_frames", ctypes.c_int), ("b0", ctypes.c_int),
                ("vrow0", ctypes.c_int), ("vrows", ctypes.c_int)]


def _c_pass_src(sh: Shard, k: int, dev, h, C, flags, halo, halo_fl, P: int) -> CPassShSrc:
    """The kernel's view of the shard's state, flags and pieces, each
    checked (shape, dtype, device, contiguity, 16-byte rows) before any
    pointer is taken."""
    src = CPassShSrc(h=h.data_ptr(), C=None if C is None else C.data_ptr(), fl=flags.data_ptr())
    if halo is not None and halo.top is not None:
        for name, t, shape, dt in (("top", halo.top, (P, 2 * k, sh.w), _F32),
                                   ("bot", halo.bot, (P, 2 * k, sh.w), _F32),
                                   ("fl_top", halo_fl.top, (1, halo_fl.k, sh.w), torch.int32),
                                   ("fl_bot", halo_fl.bot, (1, halo_fl.k, sh.w), torch.int32)):
            if tuple(t.shape) != shape or t.dtype != dt or t.device != dev \
                    or not t.is_contiguous():
                raise ValueError(f"halo {name}: {tuple(t.shape)} {t.dtype} on {t.device}, "
                                 f"expected contiguous {shape} {dt} on {dev}")
            setattr(src, name, t.data_ptr())
    ptrs = [getattr(src, n) or 0 for n, _ in CPassShSrc._fields_]
    if sh.W % 4 or any(p % 16 for p in ptrs):
        raise ValueError("the C passes copy rows of 16-byte aligned planes (W % 4 == 0)")
    return src


def c_balance_pass_sh(h, C, flags, halo: Halo | None, halo_fl: Halo | None, k: int, cfg, fields,
                      sh: Shard, scratch=None):
    """k balance steps of a shard of a row mesh in one launch; returns the
    shard's new ``(h, C)``. ``halo``: the 2k-row pieces of ``[h, C]``
    (`halo.exchange` with ``rows=2k``; None or no pieces on a mesh of one
    row); ``halo_fl``: the fixed flags' pieces, at least 2k rows deep (a
    run exchanges them once, at its deepest pass); ``scratch``:
    `pass_sh_scratch` of the shard (10 planes) at this k or a deeper one."""
    if h.device.type == "cpu":
        return c_balance_pass_sh_ref(h, C, flags, halo, halo_fl, k, cfg, fields, sh)
    k = int(k)
    _check_c_pass_sh(sh, halo, 10, halo_fl, k)
    dev = _check(sh, 0, h=(h, (9,)), C=(C, ()), flags=(flags, ()))
    src = _c_pass_src(sh, k, dev, h, C, flags, halo, halo_fl, 10)
    plan = pass_sh_plan(sh, k, _fl.sm_count(dev), "balance")
    p = CBalancePassShParams(p=_c._balance_params(cfg), s=sh.geom, t=_tile_plan_struct(plan),
                             fl_rows=halo_fl.k if src.fl_top else 0)
    scratch, scr = _scratch_ptrs(sh, k, 10, scratch, dev)
    h_out, C_out = torch.empty_like(h), torch.empty_like(C)
    fn = build.bind("c_balance_pass_sh", "jrl_c_balance_pass_sh",
                    [_P] * 5 + [ctypes.c_int, _P, _P])
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(src), h_out.data_ptr(), C_out.data_ptr(), scr[0], scr[1], k,
                 ctypes.byref(p), stream_of(dev))
    build.check(err, "c_balance_pass_sh")
    c_balance_pass_sh.launches += 1
    return h_out, C_out


def _check_frames(frames: ShardFrames, sh: Shard, k: int, step: int, v: float, dev=None):
    """The window holds the reach of a k-step pass (2k rows a side) and the
    frames steps ``step .. step + k - 1`` read."""
    N, two, rows, w = frames.t.shape
    if two != 2 or w != sh.w or (dev is not None and (frames.t.device != dev
                                                     or frames.t.dtype != _F32
                                                     or not frames.t.is_contiguous())):
        raise ValueError(f"frames: {tuple(frames.t.shape)} {frames.t.dtype} on "
                         f"{frames.t.device}, expected contiguous [N, 2, rows, {sh.w}] float32")
    whole = sh.h == sh.H
    if (whole and (frames.row0 != 0 or rows != sh.H)) or \
            (not whole and (frames.row0 < 2 * k or rows - frames.row0 - sh.h < 2 * k)):
        raise ValueError(f"frames: rows {rows} from row0 {frames.row0} do not hold the shard and "
                         f"its {2 * k}-row reach a side")
    n_frames = frames.total
    if not 0 <= frames.b0 <= n_frames - N:
        raise ValueError(f"a window of {N} frames from frame {frames.b0} in a history of "
                         f"{n_frames}")
    for s in (int(step), int(step) + k - 1):
        b, _, lerp = _jrl.frame_pair(s, v, n_frames)
        if not (frames.b0 <= b and b + int(lerp) < frames.b0 + N):
            raise ValueError(f"step {s} reads frames {b}..{b + int(lerp)}, outside the window "
                             f"of frames {frames.b0}..{frames.b0 + N - 1}")


def c_approach_pass_sh(h, base, frames: ShardFrames, halo: Halo | None, halo_fl: Halo | None,
                       step: int, k: int, cfg, fields, sh: Shard, part, scratch=None):
    """k approach steps of a shard of a row mesh from ``step`` in one
    launch, the stored velocity interpolated in the kernel from
    ``frames`` (`shard_frames`, at least 2k reach rows a side); returns the
    shard's new ``(h, C)`` and updates ``part`` (float32 ``[4]`` on the
    shard's device) in place with each step's disk terms in step order, as
    k `c_approach_sh` launches do. ``halo``: the 2k-row pieces of ``[h]``;
    ``halo_fl``: the base flags' pieces, at least 2k rows deep;
    ``scratch``: `pass_sh_scratch` of the shard (10 planes). The old C is
    never read."""
    k = int(k)
    if h.device.type == "cpu":
        _check_frames(frames, sh, k, step, cfg.vel_obs_conv)
        h, C, parts = c_approach_pass_sh_ref(h, base, frames, halo, halo_fl, step, k, cfg,
                                             fields, sh)
        for p in parts:
            part[0] += p[0]
            part[1] += p[1]
            part[2] = p[2]
            part[3] = p[3]
        return h, C
    _check_c_pass_sh(sh, halo, 9, halo_fl, k)
    _check(sh, step)
    dev = _check(sh, int(step) + k - 1, h=(h, (9,)), base=(base, ()))
    _check_frames(frames, sh, k, step, cfg.vel_obs_conv, dev)
    area = fields["area"]
    if tuple(area.shape) != (cfg.radius_obs_int,) or area.device != dev or area.dtype != _F32:
        raise ValueError("area must be a float32 [rint] tensor on the shard's card")
    if tuple(part.shape) != (4,) or part.dtype != _F32 or part.device != dev:
        raise ValueError("part must be a float32 [4] tensor on the shard's card")
    src = _c_pass_src(sh, k, dev, h, None, base, halo, halo_fl, 9)
    src.frames = frames.t.data_ptr()
    if src.frames % 16:
        raise ValueError("the C passes copy rows of 16-byte aligned planes (W % 4 == 0)")
    plan = pass_sh_plan(sh, k, _fl.sm_count(dev), "approach")
    p = CApproachPassShParams(p=_c._approach_params(cfg), s=sh.geom, t=_tile_plan_struct(plan),
                              fl_rows=halo_fl.k if src.fl_top else 0, n_frames=frames.total,
                              b0=frames.b0, vrow0=frames.row0, vrows=int(frames.t.shape[2]))
    scratch, scr = _scratch_ptrs(sh, k, 10, scratch, dev)
    h_out, C_out = torch.empty_like(h), torch.empty_like(h[0])
    fn = build.bind("c_approach_pass_sh", "jrl_c_approach_pass_sh",
                    [_P] * 7 + [ctypes.c_int] * 2 + [_P, _P])
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(src), area.data_ptr(), h_out.data_ptr(), C_out.data_ptr(),
                 part.data_ptr(), scr[0], scr[1], int(step), k, ctypes.byref(p), stream_of(dev))
    build.check(err, "c_approach_pass_sh")
    c_approach_pass_sh.launches += 1
    return h_out, C_out


fluid_a_sh.launches = 0
fluid_b_sh.launches = 0
fluid_pass_sh.launches = 0
c_balance_sh.launches = 0
c_approach_sh.launches = 0
c_balance_pass_sh.launches = 0
c_approach_pass_sh.launches = 0


# ---------------------------------------------------------------------------
# Runners (the JAX package's make_sharded_tiled_*_runner)
# ---------------------------------------------------------------------------

def _pick_local_tile_rows(h: int) -> int:
    for TH in (64, 32, 16, 8):
        if h % TH == 0:
            return TH
    raise ValueError(f"shard height {h} not tileable (need h % 8 == 0)")


def _xw_of(w: int, nx: int, x_ext=None):
    """The JAX package's extension width check: None on a one-column mesh,
    else ``min(x_ext or 8, w)``, which must be >= 2."""
    if nx == 1:
        return None
    xe = min(8 if x_ext is None else int(x_ext), w)
    if xe < 2:
        raise ValueError(f"shard width {w} too narrow for x_ext >= 2")
    return (xe, w)


def shard_plan(cfg, mesh: Mesh, tile_rows=None, unroll=8, x_ext=None):
    """The argument checks of the JAX runners, and the `Shard` of each
    shard this process holds."""
    ny, nx = mesh.shape
    H, W = cfg.eff_res
    if H % ny:
        raise ValueError(f"H={H} not divisible by ny={ny}")
    if W % nx:
        raise ValueError(f"W={W} not divisible by nx={nx}")
    h, w = H // ny, W // nx
    _xw_of(w, nx, x_ext)
    TH = tile_rows if tile_rows is not None else _pick_local_tile_rows(h)
    if int(TH) < 1 or h % int(TH):
        raise ValueError(f"tile_rows={TH} does not divide the shard height {h}")
    if int(unroll) < 1:
        raise ValueError(f"unroll={unroll} < 1")
    return [Shard.of(H, W, mesh.shape, c) for c in mesh.local]


def lean_shard(cfg, sh: Shard, step: int) -> bool:
    """Whether the shard runs the lean pair at ``step``
    (``fused_jrl_sharded.py:339-342``): its first row at least 3 rows above
    the tip row (the lowest computed row's reach stays above the top
    obstacle row, + a rounding guard), and neither the first nor the last
    shard."""
    wi = _jrl.tip_walks(cfg.inflow_height, step, cfg.vel_obs)[1]
    return sh.row0 >= wi + 3 and sh.row0 > 0 and sh.row0 + sh.h < sh.H


def lean_pass(cfg, sh: Shard, step: int, k: int) -> bool:
    """Whether the shard runs a k-step pass from ``step`` lean:
    `lean_shard` at every step of the pass, and the pass's reach, 2k rows
    past the shard a side, clear of the tip (its lowest row at least one
    above the tip row, the `lean_shard` guard at k = 1) and of the top wall
    row. At k = 1 this is `lean_shard` on shards of h >= 3 rows."""
    k = int(k)
    if not all(lean_shard(cfg, sh, s) for s in range(int(step), int(step) + k)):
        return False
    wi = max(_jrl.tip_walks(cfg.inflow_height, s, cfg.vel_obs)[1]
             for s in range(int(step), int(step) + k))
    return sh.row0 - 2 * k >= wi + 1 and sh.row0 + sh.h + 2 * k < sh.H


# the routes of the sharded runners: one pass launch a shard and k-step pass
# (fluid_pass_sh on every mesh, the C passes on row meshes), or the per-step
# kernels (fluid_a_sh + fluid_b_sh, c_balance_sh, c_approach_sh)
FLUID_ROUTES = ("pass", "launches")
# the default k of every pass (fluid_pass_sh on every mesh, c_balance_pass_sh
# and c_approach_pass_sh on row meshes): the lowest wall of the (4, 1) and
# (1, 1) meshes at 1024x512 on an H100 (PERF.md §6; the fluid: 234.3-249.2
# µs/step at k = 4 against 287.6-598.6 at k = 1..3 on (4, 1), where the host
# sets the wall, 70.65-70.72 against 71.3-76.7 on (1, 1); the balance and
# the approach on (4, 1): 132.9 and 264.3 at k = 4 against 191.2-602.9 and
# 315.5-688.1 at k = 1..3; each bit for bit route="launches"; the device
# time a step is within 10% at every k); and of the fluid's column pass on
# (2, 2) (tools/fluid_pass_sh_probe.py runner, two runs in one call, H100 at
# 700 W: 247.6 and 380.8 µs/step at k = 4 against 301.2-527.3, 447.0-731.0
# and 1030.7-1261.3 at k = 3, 2, 1; device 92.1-92.4 against 96.4-101.0;
# route="launches" 1438.3-1890.8, device 150.6-150.8)
PASS_SH_K = 4


def default_k(sh: Shard) -> int:
    """The k a shard's pass takes by default: `PASS_SH_K` or the deepest k
    its shards take (`_check_depth`: 2k <= h and 4k < H, on a column mesh
    2k <= w and 4k < W)."""
    deep = [PASS_SH_K, (sh.H - 1) // 4]
    if sh.h < sh.H:
        deep.append(sh.h // 2)
    if sh.w < sh.W:
        deep += [sh.w // 2, (sh.W - 1) // 4]
    return max(1, min(deep))


def fluid_route(route: str | None = None) -> str:
    """The sharded fluid runner's route: ``"pass"`` on every mesh (on a
    column mesh with its x window); ``route`` forces one."""
    if route is None:
        return "pass"
    if route not in FLUID_ROUTES:
        raise ValueError(f"route {route!r}: one of {FLUID_ROUTES}")
    return route


def c_route(mesh: Mesh, route: str | None = None, pair: str = "the per-step kernels") -> str:
    """The sharded C runners' route, ``pair`` naming their per-step
    kernels: ``"pass"`` on a row mesh (``nx == 1``), ``"launches"`` on a
    column mesh, whose x halo the C passes have no window for yet;
    ``route`` forces one."""
    nx = mesh.shape[1]
    if route is None:
        return "pass" if nx == 1 else "launches"
    if route not in FLUID_ROUTES:
        raise ValueError(f"route {route!r}: one of {FLUID_ROUTES}")
    if route == "pass" and nx > 1:
        raise ValueError(f"route 'pass' of the C phases serves row meshes (nx == 1), not "
                         f"{mesh.shape}: a column mesh takes {pair}")
    return route


def _run_k(shards, k, rt):
    """A runner's k: `default_k` or ``k``, checked for the pass."""
    kk = default_k(shards[0]) if k is None else int(k)
    if not 1 <= kk <= _tl.KMAX:
        raise ValueError(f"k = {kk}: the pass takes 1 <= k <= {_tl.KMAX}")
    if rt == "pass":
        _check_depth(shards[0], kk)
    return kk


def _scratch_of(store: dict, sh: Shard, k: int, planes: int, x):
    """The pass's scratch, one a device for the run's life (the shards of a
    device launch in turn on its stream); None on the CPU or at k = 1."""
    if x.device.type == "cpu" or k < 2:
        return None
    if x.device not in store:
        store[x.device] = pass_sh_scratch(sh, k, x.device, planes)
    return store[x.device]


def make_sharded_tiled_fluid_runner(cfg, mesh: Mesh, tile_rows=None, unroll=8, x_ext=None,
                                    lean_split=True, k=None, route=None):
    """Sharded fluid runner ``(state, fields, start_step, n) -> state``
    with global ``f``, ``rho``, ``vel``, through `fluid_route`'s route:

    * ``"pass"`` (the default): per k-step pass, one exchange of the
      2k-row pieces of ``[f, vel, rho]`` (on a column mesh with their
      blocks of `pass_xh` lanes) and one `fluid_pass_sh` launch a shard
      (the k steps of A and B in one launch); the steps left over run as
      one pass at a smaller k;
    * ``"launches"`` (the yardstick): per step, the f and vel pieces,
      `fluid_a_sh` on every shard, the pieces of the post-moment rho and
      vel, `fluid_b_sh`.

    ``k`` (1..4, default `default_k`): the steps a pass; the pair runs
    step by step. ``lean_split`` (row meshes with ny >= 3): a shard above the
    tip front runs the lean class (`lean_shard` a step, `lean_pass` a
    pass); the exchanges run for every shard whichever class it is in.
    ``run.lean_steps`` counts the steps each shard ``(iy, ix)`` ran lean.
    The result is the per-step kernels' bit for bit on either route."""
    shards = shard_plan(cfg, mesh, tile_rows, unroll, x_ext)
    ny, nx = mesh.shape
    rt = fluid_route(route)
    kk = _run_k(shards, k, rt)
    lean_on = bool(lean_split) and nx == 1 and ny >= 3

    def count_lean(lean, steps):
        for c, ln in zip(mesh.local, lean):
            run.lean_steps[c] = run.lean_steps.get(c, 0) + steps * int(ln)

    def run(state, fields, start_step: int, n: int):
        f, rho, vel = (split(state[x], mesh) for x in ("f", "rho", "vel"))
        L = range(len(shards))
        s, end = int(start_step), int(start_step) + int(n)
        if rt == "pass":
            scr = [_scratch_of(scratch, shards[0], kk, 12, x) for x in f]
            while s < end:
                kj = min(kk, end - s)
                lean = [lean_on and lean_pass(cfg, sh, s, kj) for sh in shards]
                count_lean(lean, kj)
                hx = exchange([[f[i], vel[i], rho[i]] for i in L], mesh,
                              pass_xh(kj) if nx > 1 else 0, rows=2 * kj)
                out = [fluid_pass_sh(f[i], rho[i], vel[i], hx[i], s, kj, cfg, fields, shards[i],
                                     lean[i], scratch=scr[i]) for i in L]
                f, rho, vel = ([o[x] for o in out] for x in range(3))
                s += kj
            return {"f": gather(f, mesh), "rho": gather(rho, mesh), "vel": gather(vel, mesh)}
        for s in range(s, end):
            lean = [lean_on and lean_shard(cfg, sh, s) for sh in shards]
            count_lean(lean, 1)
            ha = exchange([[f[i], vel[i]] for i in L], mesh, XH)
            out = [fluid_a_sh(f[i], rho[i], vel[i], ha[i], s, cfg, fields, shards[i], lean[i])
                   for i in L]
            f1 = [o[0] for o in out]
            rho, vel = [o[1] for o in out], [o[2] for o in out]
            hb = exchange([[rho[i], vel[i]] for i in L], mesh, XH)
            f = [fluid_b_sh(f1[i], rho[i], vel[i], hb[i], s, cfg, fields, shards[i], lean[i])
                 for i in L]
        return {"f": gather(f, mesh), "rho": gather(rho, mesh), "vel": gather(vel, mesh)}

    scratch = {}
    run.lean_steps = {}
    run.shards = shards
    run.k, run.route = kk, rt
    return run


def make_sharded_tiled_balance_runner(cfg, flags, mesh: Mesh, tile_rows=None, unroll=8,
                                      x_ext=None, route=None, k=None):
    """Sharded balance runner ``(state, fields, n) -> state`` with global
    ``h``, ``C``, through `c_route`'s route:

    * ``"pass"`` (row meshes, the default there): per k-step pass, one
      exchange of the 2k-row pieces of ``[h, C]`` and one
      `c_balance_pass_sh` launch a shard; the steps left over run as one
      pass at a smaller k;
    * ``"launches"`` (column meshes, and the yardstick on row meshes): per
      step, the h pieces and `c_balance_sh` on every shard.

    The fixed flags' pieces are exchanged once a run (2k rows deep on the
    pass). ``k`` (1..4, default `default_k`): the steps a pass. The result
    is the per-step kernels' bit for bit on either route."""
    shards = shard_plan(cfg, mesh, tile_rows, unroll, x_ext)
    rt = c_route(mesh, route, "c_balance_sh a step")
    kk = _run_k(shards, k, rt)

    def run(state, fields, n: int):
        h, C, fl = split(state["h"], mesh), split(state["C"], mesh), split(flags, mesh)
        L = range(len(shards))
        if rt == "pass":
            hfl = exchange([[x] for x in fl], mesh, XH, rows=2 * kk)
            scr = [_scratch_of(scratch, shards[0], kk, 10, x) for x in h]
            left = int(n)
            while left > 0:
                kj = min(kk, left)
                hx = exchange([[h[i], C[i]] for i in L], mesh, XH, rows=2 * kj)
                out = [c_balance_pass_sh(h[i], C[i], fl[i], hx[i], hfl[i], kj, cfg, fields,
                                         shards[i], scratch=scr[i]) for i in L]
                h, C = [o[0] for o in out], [o[1] for o in out]
                left -= kj
            return {"C": gather(C, mesh), "h": gather(h, mesh)}
        hfl = exchange([[x] for x in fl], mesh, XH)
        for _ in range(int(n)):
            hh = exchange([[x] for x in h], mesh, XH)
            out = [c_balance_sh(h[i], C[i], fl[i], hh[i], hfl[i], cfg, fields, shards[i])
                   for i in L]
            h, C = [o[0] for o in out], [o[1] for o in out]
        return {"C": gather(C, mesh), "h": gather(h, mesh)}

    scratch = {}
    run.shards = shards
    run.k, run.route = kk, rt
    return run


def make_sharded_tiled_approach_runner(cfg, vel_field, mesh: Mesh, tile_rows=None, unroll=8,
                                       x_ext=None, route=None, k=None):
    """Sharded approach runner ``(state, fields, start_step, n) -> (state,
    acc)`` with global ``h``, ``C`` and the integrals of
    `models/jrl.py::make_approach_runner`, through `c_route`'s route:

    * ``"pass"`` (row meshes, the default there): each shard's frames are
      cut once, with 2k reach rows a side (`shard_frames`); per k-step
      pass, one exchange of the 2k-row pieces of ``[h]`` and one
      `c_approach_pass_sh` launch a shard (the lerp, k steps and their
      disk terms); passes end at the ``unroll`` chunks' ends;
    * ``"launches"`` (column meshes, and the yardstick on row meshes): the
      frames split onto the shards and interpolated per shard each step,
      the h pieces and `c_approach_sh` a step.

    The base flags' pieces are exchanged once a run. Each shard accumulates
    its disk terms over a chunk of ``unroll`` steps, then one `psum` per
    chunk adds them into the integrals (inflow and current sum over the
    steps, rec_u and rec_v are the last step's). The result is the
    per-step kernels' bit for bit on either route (h, C)."""
    shards = shard_plan(cfg, mesh, tile_rows, unroll, x_ext)
    rint, W = cfg.radius_obs_int, cfg.eff_res[1]
    if not (rint < cfg.Rg_radius and rint < W - 1):
        # the disk's reads of the new C stay clear of the INFLOW_2 cells
        raise ValueError(f"tip disk rint={rint} must lie inside rg={cfg.Rg_radius} and W-1")
    rt = c_route(mesh, route, "c_approach_sh a step")
    kk = _run_k(shards, k, rt)
    vf = torch.as_tensor(vel_field, dtype=_F32)
    v = cfg.vel_obs_conv
    if rt == "pass":
        sfr = [shard_frames(vf, sh, 2 * kk, mesh.devices[c]) for sh, c in zip(shards, mesh.local)]
    else:
        frames = split(vf, mesh)

    def run(state, fields, start_step: int, n: int):
        h, C = split(state["h"], mesh), split(state["C"], mesh)
        base = split(fields["base_flags"], mesh)
        L = range(len(shards))
        if rt == "pass":
            hfl = exchange([[x] for x in base], mesh, XH, rows=2 * kk)
            scr = [_scratch_of(scratch, shards[0], kk, 10, x) for x in h]
        else:
            hfl = exchange([[x] for x in base], mesh, XH)
        acc = torch.zeros(4, dtype=_F32, device=h[0].device)
        s, end = int(start_step), int(start_step) + int(n)
        while s < end:
            chunk = min(int(unroll), end - s)
            parts = [torch.zeros(4, dtype=_F32, device=x.device) for x in h]
            if rt == "pass":
                for s0 in range(s, s + chunk, kk):
                    kj = min(kk, s + chunk - s0)
                    hx = exchange([[x] for x in h], mesh, XH, rows=2 * kj)
                    out = [c_approach_pass_sh(h[i], base[i], sfr[i], hx[i], hfl[i], s0, kj, cfg,
                                              fields, shards[i], parts[i], scratch=scr[i])
                           for i in L]
                    h, C = [o[0] for o in out], [o[1] for o in out]
            else:
                for step in range(s, s + chunk):
                    vel = [_jrl.stored_velocity(fr, step, v) for fr in frames]
                    hh = exchange([[x] for x in h], mesh, XH)
                    out = [c_approach_sh(h[i], C[i], vel[i], base[i], hh[i], hfl[i], step, cfg,
                                         fields, shards[i], parts[i]) for i in L]
                    h, C = [o[0] for o in out], [o[1] for o in out]
            tot = psum(parts, mesh).to(acc.device)
            acc = torch.stack([acc[0] + tot[0], acc[1] + tot[1], tot[2], tot[3]])
            s += chunk
        acc_d = {
            "inflow_sum": acc[0],
            "current_sum": acc[1],
            "count": torch.tensor(float(n), dtype=_F32),
            "rec_u": acc[2],
            "rec_v": acc[3],
        }
        return {"C": gather(C, mesh), "h": gather(h, mesh)}, acc_d

    scratch = {}
    run.shards = shards
    run.k, run.route = kk, rt
    return run
