"""The JRL case on a ``(ny, nx)`` mesh of shards: the fluid phase, the C
balance and the C approach, each shard through hand-written CUDA kernels
(`csrc/fluid_pass_sh.cu`, `fluid_a_sh.cu`, `fluid_b_sh.cu`,
`c_balance_sh.cu`, `c_approach_sh.cu`), each with its plain PyTorch twin,
and the runners.

Replaces the TPU kernels of `jrl_lbm_tpu/ops/pallas/fused_jrl_sharded.py`:
``_step_a`` and ``_step_b`` (and their lean pair ``_step_a_lean``,
``_step_b_lean``, here a LEAN template instance of each kernel),
``_step_balance`` and ``_step_approach``; and the ``shard=True`` mode of
`fused_jrl_tiled.py::_make_fluid_k_kernel` (k fused fluid steps of a
shard from its 2k-row pieces), which no JAX runner builds: here
`fluid_pass_sh`, the row-mesh fluid runner's default route (one launch a
shard and k-step pass, the full or the lean class). The runners port
``make_sharded_tiled_{fluid,balance,approach}_runner`` with their
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
* on a row mesh the fluid runner runs passes of k steps, each one
  exchange of 2k-row pieces and one `fluid_pass_sh` a shard, where JAX's
  runs the A/B pair a step (its ``route="launches"`` here, and the route
  of column meshes).

A wrapper given tensors on the CPU runs its twin; given tensors on the
card it launches the kernel or raises. ``fluid_a_sh.launches`` etc.
count the launches, the lean instance's with the full one's.
`fluid_pass_sh`'s twin runs the port's tile-class pyramid
(`jrl_tiled.py::_pass_ref`) on the shard's rows; on the CPU it equals the
kernel bit for bit (an H100 run, PERF.md).
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
    """A k-step pass serves a shard of a row mesh (1 <= k <= 4), its pieces
    from one neighbour (2k <= h on a mesh of >1 row) and its window of
    h + 4k rows holding each grid row once (4k < H)."""
    if not 1 <= int(k) <= _tl.KMAX:
        raise ValueError(f"k = {k}: the pass takes 1 <= k <= {_tl.KMAX}")
    if sh.w != sh.W:
        raise ValueError("the k-step pass serves shards of a row mesh (JAX's shard mode has no "
                         "x window); a column mesh takes the A/B pair")
    if (sh.h < sh.H and 2 * k > sh.h) or 4 * k >= sh.H:
        raise ValueError(f"k = {k} too deep for shards of {sh.h} of {sh.H} rows (2k <= h, "
                         f"4k < H)")


def _check_pass_sh(sh: Shard, halo: Halo | None, k: int, lean: bool):
    """`_check_depth`, and the shard's 2k-row pieces of [f, vel, rho] (none
    on a mesh of one row); a lean pass on an inner shard."""
    _check_depth(sh, k)
    rows = halo is not None and halo.top is not None
    if rows != (sh.h < sh.H) or (rows and (halo.k != 2 * k or halo.P != 12)):
        raise ValueError(f"halo pieces do not match the shard's mesh: a mesh of >1 row needs the "
                         f"{2 * k}-row pieces of [f, vel, rho] (12 planes)")
    if lean and not (rows and 0 < sh.row0 and sh.row0 + sh.h < sh.H):
        raise ValueError("the lean pass serves the inner shards of a row mesh of >= 3 rows")


def fluid_pass_sh_ref(f, rho, vel, halo: Halo | None, step: int, k: int, cfg, fields, sh: Shard,
                      lean=False):
    """Twin of `fluid_pass_sh`: the shard and its pieces embedded at their
    global rows in a grid of NaN, and the port's tile-class pyramid
    (`jrl_tiled.py::_pass_ref`, full or lean) on the shard's rows, which
    reads the 2k rows beyond them a side and nothing else."""
    _check_pass_sh(sh, halo, k, lean)
    H, W, r2 = sh.H, sh.W, 2 * int(k)
    dev = f.device
    nan = float("nan")

    def grid(body, planes):
        b = as_planes(body)
        g = torch.full((b.shape[0], H, W), nan, dtype=_F32, device=dev)
        if halo is not None and halo.top is not None:
            g[:, torch.arange(sh.row0 - r2, sh.row0, device=dev) % H] = halo.top[planes]
            g[:, torch.arange(sh.row0 + sh.h, sh.row0 + sh.h + r2, device=dev) % H] = \
                halo.bot[planes]
        g[:, sh.row0:sh.row0 + sh.h] = b
        return g

    gf = grid(f, slice(0, 9))
    gr, gv = (None, None) if lean else (grid(rho, slice(11, 12))[0], grid(vel, slice(9, 11)))
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


class PassShParams(ctypes.Structure):
    """Mirrors ``csrc/fluid_pass_sh.cu::FluidPassShParams``."""
    _fields_ = [("a", _fl.FluidParams), ("b", _fl.FluidBParams), ("s", ShardGeom),
                ("nstrips", ctypes.c_int), ("nruns", ctypes.c_int), ("rs", ctypes.c_int),
                ("lean", ctypes.c_int)]


class PassShSrc(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("f", "rho", "vel", "top", "bot")]


# csrc/fluid_pass_sh.cu: threads a block, dynamic shared memory a block may
# take, and bytes a ring column takes per sub-step ((5 x 12 + 3 x 9 + 4 x 3 +
# 8) floats and 8 geometry codes)
PASS_SH_THREADS = 512
PASS_SH_SMEM = 232448
PASS_SH_BYTES = 436


def pass_sh_cols(k: int) -> int:
    """Columns of a sub-step's group of threads at depth k (a multiple of 32)."""
    return (PASS_SH_THREADS // int(k)) & ~31


def pass_sh_max_rs(k: int) -> int:
    """The widest ring row (floats) at depth k."""
    return min(pass_sh_cols(k) + 8, (PASS_SH_SMEM // (int(k) * PASS_SH_BYTES)) & ~3)


def pass_sh_strip(s: int, ns: int, W: int, k: int):
    """``(sx0, sx1, cx0, cx1)`` of strip ``s`` of ``ns``: the columns it
    writes (ends on multiples of 4) and its window, 2k columns a side cut
    to the grid and rounded out to 16 bytes."""
    sx0 = (s * W // ns) & ~3
    sx1 = W if s + 1 == ns else ((s + 1) * W // ns) & ~3
    return sx0, sx1, max(sx0 - 2 * k, 0) & ~3, min((sx1 + 2 * k + 3) & ~3, W)


def pass_sh_plan(sh: Shard, k: int, sms: int = _tl.PASS_SMS):
    """``(nstrips, nruns, rs)`` of a `fluid_pass_sh` launch: the fewest
    column strips whose windows fit a ring row and whose first A columns
    (2k - 1 past the strip) fit a group of threads; runs of the shard's
    rows for about one block an SM, each window (run + 4k rows) inside the
    grid's rows."""
    k, W = int(k), sh.W
    cols, most = pass_sh_cols(k), pass_sh_max_rs(k)
    for ns in range(1, W // 4 + 1):
        strips = [pass_sh_strip(s, ns, W, k) for s in range(ns)]
        if all(sx0 < sx1 and cx1 - cx0 <= most
               and min(sx1 + 2 * k - 1, W) - max(sx0 - 2 * k + 1, 0) <= cols
               for sx0, sx1, cx0, cx1 in strips):
            break
    else:
        raise ValueError(f"W = {W} has no strip plan at k = {k}")
    least = -(-sh.h // (sh.H - 4 * k))
    nruns = min(sh.h, max(1, sms // ns, least))
    return ns, nruns, max(cx1 - cx0 for *_, cx0, cx1 in strips)


@functools.lru_cache(maxsize=256)
def _pass_sh_params(cfg, sh: Shard, k: int, lean: bool, sms: int) -> PassShParams:
    ns, nruns, rs = pass_sh_plan(sh, k, sms)
    return PassShParams(a=_fl._a_params(cfg), b=_fl._b_params(cfg), s=sh.geom, nstrips=ns,
                        nruns=nruns, rs=rs, lean=int(bool(lean)))


def fluid_pass_sh(f, rho, vel, halo: Halo | None, step: int, k: int, cfg, fields, sh: Shard,
                  lean=False):
    """k fluid steps (A then B each) of a shard of a row mesh from ``step``
    in one launch; returns the shard's new ``(f, rho, vel)``. ``halo``: the
    2k-row pieces of ``[f, vel, rho]`` (`halo.exchange` with ``rows=2k``;
    None or no pieces on a mesh of one row); ``lean``: the lean class, for
    an inner shard above the tip front for every step of the pass
    (`lean_pass`)."""
    if f.device.type == "cpu":
        return fluid_pass_sh_ref(f, rho, vel, halo, step, k, cfg, fields, sh, lean)
    _check_pass_sh(sh, halo, k, lean)
    _check(sh, step)  # steps step .. step + k - 1 in int32
    dev = _check(sh, int(step) + int(k) - 1, f=(f, (9,)), rho=(rho, ()), vel=(vel, (2,)))
    src = PassShSrc(f.data_ptr(), rho.data_ptr(), vel.data_ptr())
    if halo is not None and halo.top is not None:
        for name, t in (("top", halo.top), ("bot", halo.bot)):
            if tuple(t.shape) != (12, 2 * k, sh.w) or t.dtype != _F32 or t.device != dev \
                    or not t.is_contiguous():
                raise ValueError(f"halo {name}: {tuple(t.shape)} {t.dtype} on {t.device}, "
                                 f"expected contiguous (12, {2 * k}, {sh.w}) float32 on {dev}")
            setattr(src, name, t.data_ptr())
    if sh.W % 4 or any(t % 16 for t in (src.f, src.rho, src.vel, src.top or 0, src.bot or 0)):
        raise ValueError("fluid_pass_sh copies rows of 16-byte aligned planes (W % 4 == 0)")
    f_out, rho_out, vel_out = torch.empty_like(f), torch.empty_like(rho), torch.empty_like(vel)
    p = _pass_sh_params(cfg, sh, int(k), bool(lean), _fl.sm_count(dev))
    fn = build.bind("fluid_pass_sh", "jrl_fluid_pass_sh", [_P] * 4 + [ctypes.c_int] * 2
                    + [_P, _P])
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(src), f_out.data_ptr(), rho_out.data_ptr(), vel_out.data_ptr(),
                 int(step), int(k), ctypes.byref(p), stream_of(dev))
    build.check(err, "fluid_pass_sh")
    fluid_pass_sh.launches += 1
    return f_out, rho_out, vel_out


def pass_sh_info(k: int, device_index: int = 0):
    """``(registers per thread, local bytes)`` of `fluid_pass_sh`'s
    instance at depth k."""
    fn = build.bind("fluid_pass_sh", "jrl_fluid_pass_sh_info", [ctypes.c_int, _P, _P])
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(fn(int(k), ctypes.byref(regs), ctypes.byref(local)), "fluid_pass_sh")
    return regs.value, local.value


def pass_sh_shape(k: int, device_index: int = 0):
    """The kernel's own ``(threads, cols, max_rs, bytes_per_col)`` at depth
    k, which `pass_sh_plan` mirrors."""
    fn = build.bind("fluid_pass_sh", "jrl_fluid_pass_sh_shape", [ctypes.c_int] + [_P] * 4)
    out = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device_index):
        build.check(fn(int(k), *(ctypes.byref(x) for x in out)), "fluid_pass_sh")
    return tuple(x.value for x in out)


fluid_a_sh.launches = 0
fluid_b_sh.launches = 0
fluid_pass_sh.launches = 0
c_balance_sh.launches = 0
c_approach_sh.launches = 0


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


# the routes of the sharded fluid runner: one fluid_pass_sh launch a shard
# and k-step pass (row meshes), or fluid_a_sh + fluid_b_sh a step
FLUID_ROUTES = ("pass", "launches")
# the default k of the pass on a row mesh of more than one shard: the lowest
# wall of the (4, 1) mesh at 1024x512 on an H100 (PERF.md: 210.1 µs/step at
# k = 4 against 642.0 at k = 1, each bit for bit route="launches"); a mesh of
# one shard has no exchange to save and runs k = 1 (78.95 against 122.26)
PASS_SH_K = 4


def default_k(mesh: Mesh, sh: Shard) -> int:
    """The k a row mesh's pass takes by default: 1 on a mesh of one shard,
    else `PASS_SH_K` or the deepest k its shards take (`_check_depth`)."""
    if mesh.shape[0] * mesh.shape[1] == 1:
        return 1
    return max(1, min(PASS_SH_K, sh.h // 2, (sh.H - 1) // 4))


def fluid_route(mesh: Mesh, route: str | None = None) -> str:
    """The sharded fluid runner's route: ``"pass"`` on a row mesh
    (``nx == 1``), ``"launches"`` on a column mesh, whose x halo the pass
    has no window for; ``route`` forces one."""
    nx = mesh.shape[1]
    if route is None:
        return "pass" if nx == 1 else "launches"
    if route not in FLUID_ROUTES:
        raise ValueError(f"route {route!r}: one of {FLUID_ROUTES}")
    if route == "pass" and nx > 1:
        raise ValueError(f"route 'pass' serves row meshes (nx == 1), not {mesh.shape}: a column "
                         f"mesh takes the A/B pair")
    return route


def make_sharded_tiled_fluid_runner(cfg, mesh: Mesh, tile_rows=None, unroll=8, x_ext=None,
                                    lean_split=True, k=None, route=None):
    """Sharded fluid runner ``(state, fields, start_step, n) -> state``
    with global ``f``, ``rho``, ``vel``, through `fluid_route`'s route:

    * ``"pass"`` (row meshes, ``nx == 1``, the default there): per k-step
      pass, one exchange of the 2k-row pieces of ``[f, vel, rho]`` and one
      `fluid_pass_sh` launch a shard (the k steps of A and B in one
      launch); the steps left over run as one pass at a smaller k;
    * ``"launches"`` (column meshes, where JAX's shard mode has no x
      window, and the yardstick on row meshes): per step, the f and vel
      pieces, `fluid_a_sh` on every shard, the pieces of the post-moment
      rho and vel, `fluid_b_sh`.

    ``k`` (1..4, default `default_k`): the steps a pass; the pair runs
    step by step. ``lean_split`` (row meshes with ny >= 3): a shard above the
    tip front runs the lean class (`lean_shard` a step, `lean_pass` a
    pass); the exchanges run for every shard whichever class it is in.
    ``run.lean_steps`` counts the steps each shard ``(iy, ix)`` ran lean.
    The result is the per-step kernels' bit for bit on either route."""
    shards = shard_plan(cfg, mesh, tile_rows, unroll, x_ext)
    ny, nx = mesh.shape
    rt = fluid_route(mesh, route)
    kk = default_k(mesh, shards[0]) if k is None else int(k)
    if not 1 <= kk <= _tl.KMAX:
        raise ValueError(f"k = {kk}: the pass takes 1 <= k <= {_tl.KMAX}")
    if rt == "pass":
        _check_depth(shards[0], kk)
    lean_on = bool(lean_split) and nx == 1 and ny >= 3

    def count_lean(lean, steps):
        for c, ln in zip(mesh.local, lean):
            run.lean_steps[c] = run.lean_steps.get(c, 0) + steps * int(ln)

    def run(state, fields, start_step: int, n: int):
        f, rho, vel = (split(state[x], mesh) for x in ("f", "rho", "vel"))
        L = range(len(shards))
        s, end = int(start_step), int(start_step) + int(n)
        if rt == "pass":
            while s < end:
                kj = min(kk, end - s)
                lean = [lean_on and lean_pass(cfg, sh, s, kj) for sh in shards]
                count_lean(lean, kj)
                hx = exchange([[f[i], vel[i], rho[i]] for i in L], mesh, XH, rows=2 * kj)
                out = [fluid_pass_sh(f[i], rho[i], vel[i], hx[i], s, kj, cfg, fields, shards[i],
                                     lean[i]) for i in L]
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

    run.lean_steps = {}
    run.shards = shards
    run.k, run.route = kk, rt
    return run


def make_sharded_tiled_balance_runner(cfg, flags, mesh: Mesh, tile_rows=None, unroll=8,
                                      x_ext=None):
    """Sharded balance runner ``(state, fields, n) -> state`` with global
    ``h``, ``C``: per step, the h pieces and `c_balance_sh` on every shard;
    the fixed flags' pieces are exchanged once a run."""
    shards = shard_plan(cfg, mesh, tile_rows, unroll, x_ext)

    def run(state, fields, n: int):
        h, C, fl = split(state["h"], mesh), split(state["C"], mesh), split(flags, mesh)
        L = range(len(shards))
        hfl = exchange([[x] for x in fl], mesh, XH)
        for _ in range(int(n)):
            hh = exchange([[x] for x in h], mesh, XH)
            out = [c_balance_sh(h[i], C[i], fl[i], hh[i], hfl[i], cfg, fields, shards[i])
                   for i in L]
            h, C = [o[0] for o in out], [o[1] for o in out]
        return {"C": gather(C, mesh), "h": gather(h, mesh)}

    run.shards = shards
    return run


def make_sharded_tiled_approach_runner(cfg, vel_field, mesh: Mesh, tile_rows=None, unroll=8,
                                       x_ext=None):
    """Sharded approach runner ``(state, fields, start_step, n) -> (state,
    acc)`` with global ``h``, ``C`` and the integrals of
    `models/jrl.py::make_approach_runner`. The stored-velocity frames are
    split onto the shards and interpolated per shard each step; each
    shard accumulates its disk terms over a chunk of ``unroll`` steps,
    then one `psum` per chunk adds them into the integrals (inflow and
    current sum over the steps, rec_u and rec_v are the last step's)."""
    shards = shard_plan(cfg, mesh, tile_rows, unroll, x_ext)
    rint, W = cfg.radius_obs_int, cfg.eff_res[1]
    if not (rint < cfg.Rg_radius and rint < W - 1):
        # the disk's reads of the new C stay clear of the INFLOW_2 cells
        raise ValueError(f"tip disk rint={rint} must lie inside rg={cfg.Rg_radius} and W-1")
    frames = split(torch.as_tensor(vel_field, dtype=_F32), mesh)
    v = cfg.vel_obs_conv

    def run(state, fields, start_step: int, n: int):
        h, C = split(state["h"], mesh), split(state["C"], mesh)
        base = split(fields["base_flags"], mesh)
        L = range(len(shards))
        hfl = exchange([[x] for x in base], mesh, XH)
        acc = torch.zeros(4, dtype=_F32, device=h[0].device)
        s, end = int(start_step), int(start_step) + int(n)
        while s < end:
            k = min(int(unroll), end - s)
            parts = [torch.zeros(4, dtype=_F32, device=x.device) for x in h]
            for step in range(s, s + k):
                vel = [_jrl.stored_velocity(fr, step, v) for fr in frames]
                hh = exchange([[x] for x in h], mesh, XH)
                out = [c_approach_sh(h[i], C[i], vel[i], base[i], hh[i], hfl[i], step, cfg,
                                     fields, shards[i], parts[i]) for i in L]
                h, C = [o[0] for o in out], [o[1] for o in out]
            tot = psum(parts, mesh).to(acc.device)
            acc = torch.stack([acc[0] + tot[0], acc[1] + tot[1], tot[2], tot[3]])
            s += k
        acc_d = {
            "inflow_sum": acc[0],
            "current_sum": acc[1],
            "count": torch.tensor(float(n), dtype=_F32),
            "rec_u": acc[2],
            "rec_v": acc[3],
        }
        return {"C": gather(C, mesh), "h": gather(h, mesh)}, acc_d

    run.shards = shards
    return run
