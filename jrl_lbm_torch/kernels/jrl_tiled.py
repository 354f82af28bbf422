"""The JRL fluid phase on grids above ``fused_jrl.MAX_FUSED_CELLS``: k
fused steps per launch on three tile classes (`csrc/fluid_k.cu`,
`csrc/fluid_k_lean.cu`, `csrc/fluid_k_bt.cu`), the k = 1 split pass in one
row-streaming launch (`csrc/fluid_pass.cu`), each with its plain PyTorch
twin, and the runner that picks the class of each row tile.

Replace the TPU kernels of `jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py`:
``_make_fluid_k_kernel`` (the full class: every tile the moving tip or a
wall row can reach), ``_make_fluid_k_lean_kernel`` (interior tiles above
the tip: no obstacle in reach, so no geometry, bounce or coupling; reads
only f) and ``_make_fluid_k_bt_kernel`` (flat tips: tiles wholly under the
tip row, where the tip is the columns x < rg). The runner
(`make_tiled_fluid_runner`) ports ``make_tiled_fluid_runner`` and its
dispatch loop: the same tile rows, frontier and below-tip choices per
chunk, so the launches follow the JAX package's chunk plan; remainder
steps go through the per-step pair ``fluid_a``/``fluid_b``.

A chunk's passes each launch the full class and, where the plan has
them, the below-tip and lean classes on their row segments; at k = 1
(the runner's default) ``fluid_pass`` runs the full and lean rows in one
launch instead (`pass_route`; ``route="classes"`` forces the two class
kernels). The launches read one buffer set and write their own rows of
one output set, the CUDA form of the Pallas calls'
``input_output_aliases``; sets ping-pong, and the caller's state is never
written. The runner checks the state and both sets once a run; the
wrappers check their arguments on every call made outside it.

One reference fault is not copied: with ``tile_rows=8, k=4`` (2k = TH)
the JAX lean range reaches tile n-2, whose pyramid then computes row H-2
next to the top wall with the lean body, which has no wall rule. As the
jnp step requires, the lean range here stops at tile n-3 when TH <= 2k
(`lean_last`); tile n-2 stays in the full class.

A wrapper given tensors on the CPU runs its twin; given tensors on the
card it launches the kernel or raises. ``fluid_k.launches`` etc. count
the launches. The twins take a padded row window and return the tile's
rows through the class bodies, with the arithmetic of the port's
whole-grid step (`jrl_fluid.py::fluid_a_ref`, ``fluid_b_ref``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch

from jrl_lbm_torch import lattice
from jrl_lbm_torch.kernels import build
from jrl_lbm_torch.kernels.jrl_fluid import FluidBParams, FluidParams, _P, _a_params, \
    _b_params, check_state, fluid_a, fluid_b, sm_count, stream_of
from jrl_lbm_torch.models import jrl as _jrl
from jrl_lbm_torch.ops.equilibrium import feq
from jrl_lbm_torch.utils.types import CellType

FLUID = int(CellType.FLUID)
OBSTACLE = int(CellType.OBSTACLE)
OUTFLOW = int(CellType.OUTFLOW)
KMAX = 4  # the halo of a k-step tile is 2k rows (csrc/jrl_tile.cuh)
MAX_SEGS = 3
ROUTES = ("pass", "classes")
TILE_FULL, TILE_LEAN = 0, 1  # csrc/jrl_tile.cuh::TileClass
PASS_THREADS = 512   # csrc/pass_state.cuh: one A column a thread
PASS_MAX_RUNS = 512
PASS_SMS = 132       # SMs of an H100 SXM: the runs a pass is cut into on the CPU
# a lean row's cost in fluid_pass relative to a full row's (runs of the
# lean class are longer by its inverse, so that the blocks of one wave end
# together; measured on the H100, PERF.md)
PASS_LEAN_COST = 0.5
_CS2 = 1.0 / 3.0
_E, _REFL, _MX, _WQ = lattice.E, lattice.REFLECT, lattice.MIRROR_X, lattice.W
_F32 = torch.float32


# ---------------------------------------------------------------------------
# Tile plan (the JAX package's pick_tile_rows, _cfg_consts and the
# frontier / below closures of make_tiled_fluid_runner)
# ---------------------------------------------------------------------------

def pick_tile_rows(cfg) -> int:
    """The largest of 64, 32, 16, 8 rows that cuts the grid into >= 3 tiles."""
    H, _ = cfg.eff_res
    for TH in (64, 32, 16, 8):
        if H % TH == 0 and H // TH >= 3:
            return TH
    raise ValueError(f"H={H} not tileable (need H % 8 == 0, >= 3 tiles)")


def tileable(cfg) -> bool:
    """Whether the tiled runner serves the config's grid (the JAX package
    takes it for any grid with H % 8 == 0 beyond the whole-domain kernel)."""
    H, _ = cfg.eff_res
    return H % 8 == 0 and H // 8 >= 3


def tile_consts(cfg) -> dict:
    """The constants the plan reads, as Python floats (``_cfg_consts``)."""
    H, W = cfg.eff_res
    return dict(
        H=H, W=W, tau=float(cfg.tau), vel_obs=float(cfg.vel_obs), rg=float(cfg.Rg_radius),
        box_r=float(cfg.box_radius), inflow_h=float(cfg.inflow_height),
        fy=float(-cfg.gravity_strength), flat=cfg.shape in _jrl.FLAT_SHAPES,
    )


def frontier(c: dict, TH: int, k: int, s_end: int) -> int:
    """Last tile the full class must cover at steps < ``s_end``: the
    deepest row an obstacle cell can influence within one k-block is
    walks_int - 1 + 2k (A and B widen the reach by 2 rows a step), +1
    rounding guard."""
    walks = c["inflow_h"] + float(s_end) * c["vel_obs"]
    reach = int(walks + 0.5) + 2 * k + 2
    return reach // TH


def below(c: dict, TH: int, k: int, s_start: int) -> int:
    """Last tile the below-tip class may cover at steps >= ``s_start``
    (flat tips): every computed row of the tile's 2k-row reach stays >= 2
    rows under the tip row for the whole chunk."""
    if not (c["flat"] and TH > 2 * k):
        return 0
    wi = int(c["inflow_h"] + float(s_start) * c["vel_obs"] + 0.5)
    return max(0, (wi - 2 * k - 2) // TH - 1)


def lean_last(n_tiles: int, TH: int, k: int) -> int:
    """Last tile of the lean range: n-2, or n-3 when TH <= 2k, where the
    pyramid of tile n-2 would compute row H-2 next to the top wall."""
    return n_tiles - 2 if TH > 2 * k else n_tiles - 3


def _depth(cfg, tile_rows, k, lean_split):
    TH = tile_rows if tile_rows is not None else pick_tile_rows(cfg)
    kk = 1 if k is None else int(k)
    if not 1 <= kk <= KMAX:
        raise ValueError(f"k={kk} out of range (halo groups hold 2k <= 8)")
    if (kk > 1 or lean_split) and (TH % 8 or cfg.eff_res[0] % 8):
        raise ValueError("k > 1 / lean_split need 8-aligned tiles and grid height")
    return TH, kk


def chunk_plan(cfg, start: int, n: int, tile_rows: int | None = None, unroll: int = 8,
               k: int | None = None, lean_split: bool = True):
    """The chunks `make_tiled_fluid_runner` runs for steps ``start ..
    start + n - 1``, as ``(kind, start, reps, fr, fb)``: ``"split"``
    (``reps`` k-step passes, full tiles {0, fb+1..fr, lean_last+1..n-1},
    below-tip tiles {1..fb}, lean tiles {fr+1..lean_last}), ``"k"``
    (``reps`` k-step passes of the full class on every tile) or ``"ab"``
    (``reps`` single steps of the per-step pair); the JAX package's
    ``_fluid_k_split_chunk``, ``_fluid_k_chunk`` and ``_tiled_chunk``."""
    TH, kk = _depth(cfg, tile_rows, k, lean_split)
    c = tile_consts(cfg)
    n_tiles = c["H"] // TH
    last = lean_last(n_tiles, TH, kk)
    plan = []
    s = int(start)
    end = s + int(n)
    while end - s >= kk:
        reps = min(unroll, (end - s) // kk)
        fr = frontier(c, TH, kk, s + reps * kk) if lean_split else n_tiles
        fb = min(below(c, TH, kk, s), n_tiles - 2) if lean_split else 0
        if fr < last:
            plan.append(("split", s, reps, fr, min(fb, fr)))
        elif fb >= 1:
            # late travel: no lean tile left, but (flat tips) most tiles
            # sit wholly under the tip
            plan.append(("split", s, reps, n_tiles - 2, fb))
        elif kk > 1:
            plan.append(("k", s, reps, None, None))
        else:
            break
        s += reps * kk
    while s < end:
        j = min(unroll, end - s)
        plan.append(("ab", s, j, None, None))
        s += j
    return plan


def _segments(tiles, TH: int):
    """Row segments [y0, y1) of a sorted list of tiles, contiguous runs merged."""
    segs = []
    for t in tiles:
        if segs and segs[-1][1] == t * TH:
            segs[-1] = (segs[-1][0], (t + 1) * TH)
        else:
            segs.append((t * TH, (t + 1) * TH))
    return segs


def class_rows(H: int, TH: int, k: int, fr: int, fb: int):
    """``(full, bt, lean)`` row segments of a split pass; below-tip tiles
    need TH > 2k (the bt bodies' reach must stay under the tip row), as
    the JAX split chunk asserts."""
    if not 0 <= fb <= fr or (fb and TH <= 2 * k):
        raise ValueError(f"below-tip tiles 1..{fb} need fb <= fr = {fr} and TH = {TH} > 2k = "
                         f"{2 * k}")
    n = H // TH
    last = lean_last(n, TH, k)
    full = sorted({0, *range(fb + 1, fr + 1), *range(max(last, fr) + 1, n)})
    return (_segments(full, TH), _segments(range(1, fb + 1), TH),
            _segments(range(fr + 1, last + 1), TH))


# ---------------------------------------------------------------------------
# Plain twins: the class bodies on a padded row window
# ---------------------------------------------------------------------------

class _Win:
    """Per-cell neighbour reads on a padded row window (the JAX package's
    ``_TileCtx``, with the port's rules): planes ``[..., R + 2, W]`` whose
    rows 1..R are the output rows; the padded rows hold the global rows
    above and below (mod H), so the FLUID wrap is a plain row shift. ``y0``
    / ``yH`` mark output rows on global row 0 / H-1 (None: the window holds
    neither, as in the lean and below-tip classes)."""

    def __init__(self, W: int, R: int, fluid, y0=None, yH=None):
        x = torch.arange(W, device=fluid.device)[None, :]
        nf = ~fluid
        self.R = R
        self.x0 = x == 0
        self.xW = x == W - 1
        self.xW_nf = self.xW & nf
        self.y0_nf = None if y0 is None else y0 & nf
        self.yH_nf = None if yH is None else yH & nf

    def _s(self, pad, dy: int, dx: int):
        a = pad[..., 1 + dy: 1 + dy + self.R, :]
        return torch.roll(a, -dx, dims=-1) if dx else a

    def _read(self, pad, dy, ym, dya, dx, xm, dxa):
        def row(d):
            v = self._s(pad, d, dx)
            return v if xm is None else torch.where(xm, self._s(pad, d, dxa), v)

        v = row(dy)
        return v if ym is None else torch.where(ym, row(dya), v)

    def pull(self, pad, ex: int, ey: int):
        """Value at (y - ey, x - ex) with the streaming rules: non-FLUID
        cells reflect at rows 0 / H-1 and column W-1, the x-1 pull
        collapses onto the axis (ops/stream.py::_pull)."""
        ym = {1: self.y0_nf, -1: self.yH_nf}.get(ey)
        xm = {1: self.x0, -1: self.xW_nf}.get(ex)
        return self._read(pad, -ey, ym, ey, -ex, xm, 0 if ex == 1 else -1)

    def at(self, pad, sx: int, sy: int):
        """Value at (y + sy, x + sx) with the stencil clamps
        (ops/stencil.py::_at)."""
        ym = {-1: self.y0_nf, 1: self.yH_nf}.get(sy)
        xm = {-1: self.x0, 1: self.xW_nf}.get(sx)
        return self._read(pad, sy, ym, 0, sx, xm, 0)


def _geometry(cfg, gy, step: int):
    """Flags, phi, tip and obstacle y velocity of the moving tip on global
    rows ``gy`` (`models/jrl.py::fluid_geometry`, `fluid_base_flags`)."""
    H, W = cfg.eff_res
    dev = gy.device
    y = gy[:, None]
    x = torch.arange(W, device=dev)[None, :]
    R = gy.shape[0]
    mesh = torch.stack([(x.to(_F32) + 0.5).expand(R, W), (y.to(_F32) + 0.5).expand(R, W)])
    walks, walks_int = _jrl.tip_walks(cfg.inflow_height, step, cfg.vel_obs)
    phi = _jrl._tip_phi(cfg, mesh, walks)
    if cfg.shape in _jrl.FLAT_SHAPES:
        tip = (y < walks_int) & (x < cfg.Rg_radius)
        obs_v = torch.where(tip, cfg.vel_obs, 0.0).to(_F32)
    else:
        tip = phi <= 0
        obs_v = torch.where(tip & (y != H - 1), cfg.vel_obs, 0.0).to(_F32)
    base = torch.where((y == 0) | (x == W - 1), OUTFLOW, FLUID)
    base = torch.where(x == 0, FLUID, base)
    base = torch.where(y == H - 1, OBSTACLE, base)
    flags = torch.where(tip, OBSTACLE, base)
    return flags, phi, tip, obs_v


def _stream(ctx, f_pad, is_obs, nbr_obs, phi):
    """Pulls with the axis mirror, sub-grid bounce from the cells where
    ``nbr_obs(ex, ey)`` holds and reflected storage in ``is_obs`` cells
    (ops/stream.py::propagate before its OUTFLOW pass); ``nbr_obs`` None:
    no obstacle in reach (lean class)."""
    f = f_pad[:, 1:-1]
    raw, streamed = [f[0]] + [None] * 8, [f[0]] + [None] * 8
    for q in range(1, 9):
        ex, ey = int(_E[q, 0]), int(_E[q, 1])
        val = ctx.pull(f_pad[q], ex, ey)
        if q in lattice.AXIS_X_IN:
            val = torch.where(ctx.x0, ctx.pull(f_pad[int(_MX[q])], ex, ey), val)
        raw[q] = val
        if nbr_obs is None:
            streamed[q] = val
            continue
        f_this = f[int(_REFL[q])]
        nxt = ctx.pull(f_pad[int(_REFL[q])], -ex, -ey)
        if q in lattice.AXIS_X_OUT:
            nxt = torch.where(ctx.x0, ctx.pull(f_pad[int(_REFL[int(_MX[q])])], -ex, -ey), nxt)
        t = phi
        t1 = 2.0 * t - 1.0
        v1 = t1 * val + (1.0 - t1) * f_this
        t2 = 2.0 * t
        v2 = t2 * f_this + (1.0 - t2) * nxt
        v_obs = torch.where((t >= 0.5) & (t <= 1.0), v1,
                            torch.where((t >= 0.0) & (t <= 0.5), v2, f_this))
        streamed[q] = torch.where(nbr_obs(ex, ey), v_obs, val)
    if is_obs is None:
        return torch.stack(streamed)
    return torch.stack([f[0]] + [torch.where(is_obs, raw[int(_REFL[p])], streamed[p])
                                 for p in range(1, 9)])


def _couple(cfg, ctx, f, vel_p, phi, skip, nb, obs_uy):
    """Moving-wall nonequilibrium reconstruction (ops/coupling.py::
    solve_boundary) of the cells where ``nb(ex, ey)`` marks an obstacle
    at (y + ey, x + ex); ``obs_uy(ex, ey)`` is its y velocity, ``vel_p`` the
    tip-overridden velocity on the padded rows."""
    eps = 1e-10
    tau = cfg.tau
    t = phi
    t_ok = (t > -eps) & (t <= 1.0 + eps)
    zeros = torch.zeros_like(t)
    rho_tgt = torch.sum(f, dim=0)
    count, vtx, vty = zeros, zeros, zeros
    valid = []
    for q in range(9):
        ex, ey = int(_E[q, 0]), int(_E[q, 1])
        v_q = nb(ex, ey) & t_ok
        valid.append(v_q)
        vmask = v_q.to(_F32)
        count = count + vmask
        tq = torch.where(v_q, t, zeros)
        ux = ctx.at(vel_p[0], -ex, -ey)
        uy = ctx.at(vel_p[1], -ex, -ey)
        if q in lattice.AXIS_X_IN:
            ux = torch.where(ctx.x0, -ux, ux)
        obs_ux, o_uy = zeros, obs_uy(ex, ey)
        vtx = vtx + vmask * (tq * ux + obs_ux) / (tq + 1.0)
        vty = vty + vmask * (tq * uy + o_uy) / (tq + 1.0)
        qi = int(_REFL[q])
        rho_tgt = rho_tgt + vmask * 6.0 * float(_WQ[q]) * (
            float(_E[qi, 0]) * obs_ux + float(_E[qi, 1]) * o_uy)
    safe = torch.where(count > 0, count, torch.ones_like(count))
    u0, u1 = vtx / safe, vty / safe

    def grad12(a):
        gx = (4.0 * (ctx.at(a, 1, 0) - ctx.at(a, -1, 0)) + (ctx.at(a, 1, 1) - ctx.at(a, -1, 1))
              + (ctx.at(a, 1, -1) - ctx.at(a, -1, -1))) / 12.0
        gy = (4.0 * (ctx.at(a, 0, 1) - ctx.at(a, 0, -1)) + (ctx.at(a, 1, 1) - ctx.at(a, 1, -1))
              + (ctx.at(a, -1, 1) - ctx.at(a, -1, -1))) / 12.0
        return gx, gy

    g00, g01 = grad12(vel_p[0])
    g10, g11 = grad12(vel_p[1])
    out = list(f.unbind(0))
    for q in range(9):
        qi = int(_REFL[q])
        e0, e1 = float(_E[qi, 0]), float(_E[qi, 1])
        pab = (u0 * u0 - _CS2 * tau * (g00 + g00)) * (e0 * e0 - _CS2)
        pab = pab + (u1 * u0 - _CS2 * tau * (g10 + g01)) * (e1 * e0)
        pab = pab + (u0 * u1 - _CS2 * tau * (g01 + g10)) * (e0 * e1)
        pab = pab + (u1 * u1 - _CS2 * tau * (g11 + g11)) * (e1 * e1 - _CS2)
        recon = float(_WQ[qi]) * rho_tgt * (
            1.0 + (1.0 / _CS2) * (u0 * e0 + u1 * e1) + 0.5 * pab / (_CS2 * _CS2))
        out[qi] = torch.where(valid[q] & ~skip, recon, out[qi])
    return torch.stack(out)


def _macro(f, is_obs, rho_mid, vel_mid):
    """Moments with OBSTACLE passthrough (ops/macro.py::macro_compute)."""
    rho = torch.sum(f, dim=0)
    if is_obs is not None:
        rho = torch.where(is_obs, rho_mid, rho)
    mom_x = f[1] - f[3] + f[5] - f[6] - f[7] + f[8]
    mom_y = f[2] - f[4] + f[5] + f[6] - f[7] - f[8]
    safe = torch.where(rho == 0, torch.ones_like(rho), rho)
    vel = torch.stack([mom_x, mom_y]) * (1.0 / safe)[None]
    if is_obs is not None:
        vel = torch.where(is_obs[None], vel_mid, vel)
    return rho, vel


def _outflow(f, of, ctx, y0=None):
    """OUTFLOW cells copy the streamed populations of the inward cell, rows
    first, then columns (row H-1 and column 0 hold no OUTFLOW cell)."""
    g = f if y0 is None else torch.where(y0, torch.roll(f, -1, dims=-2), f)
    g = torch.where(ctx.xW, torch.roll(g, 1, dims=-1), g)
    return torch.where(of, g, f)


def _rows(cfg, t0: int, R: int, device):
    H = cfg.eff_res[0]
    return torch.remainder(torch.arange(t0 - 1, t0 + R + 1, device=device), H)


def _a_full(cfg, step, t0, R, f_pad, vel_pad, rho_mid):
    """Step A on the R rows from global row t0 (`fluid_a_ref`): the moving
    tip's geometry at ``step`` on the window's rows."""
    H, W = cfg.eff_res
    gy_p = _rows(cfg, t0, R, f_pad.device)
    flags_p, phi_p, tip_p, obs_v_p = _geometry(cfg, gy_p, step)
    flags, phi = flags_p[1:-1], phi_p[1:-1]
    gy = gy_p[1:-1, None]
    is_obs = flags == OBSTACLE
    ctx = _Win(W, R, flags == FLUID, gy == 0, gy == H - 1)
    obs_pad = (flags_p == OBSTACLE).to(_F32)
    # the tip-overridden velocity (models/jrl.py::fluid_tip_velocity)
    vel_p = torch.stack([torch.where(tip_p, 0.0, vel_pad[0]),
                         torch.where(tip_p, obs_v_p, vel_pad[1])])
    f = _stream(ctx, f_pad, is_obs, lambda ex, ey: ctx.pull(obs_pad, ex, ey) > 0.5, phi)
    f = _outflow(f, flags == OUTFLOW, ctx, gy == 0)
    f = _couple(cfg, ctx, f, vel_p, phi, is_obs | ctx.xW | (gy == H - 1),
                lambda ex, ey: ctx.at(obs_pad, ex, ey) > 0.5,
                lambda ex, ey: ctx.at(obs_v_p, ex, ey))
    rho, vel = _macro(f, is_obs, rho_mid, vel_p[:, 1:-1])
    return f, rho, vel


def _a_lean(cfg, R, f_pad):
    """Lean step A (``_fluid_a_lean``): pulls, the x-edge rules and the
    moments; no geometry, bounce or coupling."""
    W = cfg.eff_res[1]
    x = torch.arange(W, device=f_pad.device)[None, :].expand(R, W)
    ctx = _Win(W, R, x != W - 1)
    f = _stream(ctx, f_pad, None, None, None)
    f = _outflow(f, ctx.xW, ctx)
    return (f, *_macro(f, None, None, None))


def _bt_masks(cfg, R, device):
    """Lane-static tip of the below-tip class: obstacle columns x < rg."""
    W = cfg.eff_res[1]
    x = torch.arange(W, device=device)[None, :].expand(R, W)
    return x, x < cfg.Rg_radius


def _a_bt(cfg, R, f_pad, vel_pad, rho_mid):
    """Below-tip step A (``_fluid_a_bt``): the obstacle is x < rg on every
    row, phi the column distance, every mask a column compare."""
    W, rg, v_obs = cfg.eff_res[1], cfg.Rg_radius, cfg.vel_obs
    x, obs = _bt_masks(cfg, R, f_pad.device)
    tip_p = obs[:1].expand(R + 2, W)
    ctx = _Win(W, R, ~(obs | (x == W - 1)))
    phi = (x.to(_F32) + 0.5 - (cfg.Rg_radius - cfg.box_radius)) - cfg.box_radius
    vel_p = torch.stack([torch.where(tip_p, 0.0, vel_pad[0]),
                         torch.where(tip_p, v_obs, vel_pad[1])])
    f = _stream(ctx, f_pad, obs, lambda ex, ey: (x - ex) < rg, phi)
    f = _outflow(f, ctx.xW, ctx)
    f = _couple(cfg, ctx, f, vel_p, phi, obs | ctx.xW, lambda ex, ey: (x + ex) < rg,
                lambda ex, ey: torch.where((x + ex) < rg, v_obs, 0.0).to(_F32))
    rho, vel = _macro(f, obs, rho_mid, vel_p[:, 1:-1])
    return f, rho, vel


def _grad(ctx, a_pad, nb, is_obs, want_y: bool):
    """ops/stencil.py::get_grad on the window: a direction pair with an
    obstacle member (``nb(sx, sy)``) is dropped and zeroes the component;
    ``nb`` None: no obstacle in reach."""
    def val(sx, sy):
        return ctx.at(a_pad, sx, sy)

    def comp(pairs):
        if nb is None:
            (a1, b1), (a2, b2), (a3, b3) = pairs
            return ((4.0 * (val(*a1) - val(*b1)) + (val(*a2) - val(*b2)))
                    + (val(*a3) - val(*b3)))
        g = torch.zeros_like(a_pad[1:-1])
        blocked = None
        for i, (a, b) in enumerate(pairs):
            p = nb(*a) | nb(*b)
            d = val(*a) - val(*b)
            g = g + torch.where(p, 0.0, 4.0 * d if i == 0 else d)
            blocked = p if blocked is None else blocked | p
        return torch.where(blocked, 0.0, g)

    gx = comp((((1, 0), (-1, 0)), ((1, 1), (-1, 1)), ((1, -1), (-1, -1))))
    gy = comp((((0, 1), (0, -1)), ((1, 1), (1, -1)), ((-1, 1), (-1, -1)))) if want_y else gx
    grad = torch.stack([gx, gy]) / 12.0
    return grad if is_obs is None else torch.where(is_obs[None], 0.0, grad)


def _div(ctx, m_pad, is_obs):
    """ops/stencil.py::get_div on the window (no obstacle masking)."""
    u, v = m_pad[0], m_pad[1]
    at = ctx.at
    d = 4.0 * (at(u, 1, 0) - at(u, -1, 0))
    d = d + at(u, 1, 1) - at(u, -1, 1)
    d = d + at(u, 1, -1) - at(u, -1, -1)
    d = d + 4.0 * (at(v, 0, 1) - at(v, 0, -1))
    d = d + at(v, 1, 1) - at(v, 1, -1)
    d = d + at(v, -1, 1) - at(v, -1, -1)
    d = d / 12.0
    return d if is_obs is None else torch.where(is_obs, 0.0, d)


def _collide(cfg, ctx, f, rho_pad, vel_pad, nb, is_obs):
    """Axisymmetric BGK with gravity (ops/collide.py::bgk_collide,
    axisymmetric_source, LINE_X_EQ_0) on the window; ``nb`` / ``is_obs``
    None: no obstacle in reach."""
    tau = cfg.tau
    W = cfg.eff_res[1]
    dev = f.device
    rho, vel = rho_pad[1:-1], vel_pad[:, 1:-1]
    force = torch.tensor([0.0, -cfg.gravity_strength], dtype=_F32, device=dev)[:, None, None]
    feq_ = feq(rho, vel, force=force)
    r = (torch.arange(W, dtype=_F32, device=dev) + 0.5)[None, :]
    ur = vel[0]
    A1 = -rho * ur / r
    A1_pad = -rho_pad * vel_pad[0] / r
    mu = _CS2 * (tau - 0.5) * rho
    grad_u = _grad(ctx, vel_pad[0], nb, is_obs, False)
    grad_v = _grad(ctx, vel_pad[1], nb, is_obs, False)
    A2 = _grad(ctx, rho_pad * _CS2, nb, is_obs, False)[0]
    A2 = A2 + _div(ctx, rho_pad[None] * vel_pad[0][None] * vel_pad, is_obs)
    A2 = A2 * (1.0 / (2.0 * r))
    F2 = (mu / r)[None] * torch.stack([grad_u[0] - ur / r, grad_v[0]])
    F2 = F2 + vel * A1[None]
    F2 = F2 - 1.0 * (tau - 1.0) * _CS2 * _grad(ctx, A1_pad, nb, is_obs, True)
    e, w = lattice.tables(dev, _F32)
    F2e = e[:, 0][:, None, None] * F2[0][None] + e[:, 1][:, None, None] * F2[1][None]
    Gi = (A1[None] + A2[None] + F2e / _CS2) * w[:, None, None]
    collided = f + (1.0 / tau) * (feq_ - f) + 1.0 * Gi
    return collided if is_obs is None else torch.where(is_obs[None], f, collided)


def _b_full(cfg, step, t0, R, f, rho_pad, vel_pad):
    """Step B on the R rows from global row t0 (`fluid_b_ref`)."""
    H, W = cfg.eff_res
    gy_p = _rows(cfg, t0, R, f.device)
    flags_p = _geometry(cfg, gy_p, step)[0]
    flags = flags_p[1:-1]
    gy = gy_p[1:-1, None]
    ctx = _Win(W, R, flags == FLUID, gy == 0, gy == H - 1)
    obs_pad = (flags_p == OBSTACLE).to(_F32)
    return _collide(cfg, ctx, f, rho_pad, vel_pad,
                    lambda sx, sy: ctx.at(obs_pad, sx, sy) > 0.5, flags == OBSTACLE)


def _b_lean(cfg, R, f, rho_pad, vel_pad):
    """Lean step B (``_fluid_b_lean``): no obstacle-pair masks, no
    OBSTACLE passthrough."""
    W = cfg.eff_res[1]
    x = torch.arange(W, device=f.device)[None, :].expand(R, W)
    return _collide(cfg, _Win(W, R, x != W - 1), f, rho_pad, vel_pad, None, None)


def _b_bt(cfg, R, f, rho_pad, vel_pad):
    """Below-tip step B (``_fluid_b_bt``): obstacle-pair masks as column
    compares."""
    W, rg = cfg.eff_res[1], cfg.Rg_radius
    x, obs = _bt_masks(cfg, R, f.device)
    ctx = _Win(W, R, ~(obs | (x == W - 1)))
    return _collide(cfg, ctx, f, rho_pad, vel_pad, lambda sx, sy: (x + sx) < rg, obs)


def _pyramid(cls: str, cfg, k: int, t0: int, R0: int, step0: int, f_win, rho_win, vel_win):
    """k steps of rows t0 .. t0 + R0 - 1 from a window of R0 + 4k rows
    (the level pyramid of ``_make_fluid_k_kernel``): sub-step j runs A on
    the window less 2j + 1 rows a side and B on two rows fewer; the lean
    class reads only ``f_win``. Returns the rows' ``(f, rho, vel)``."""
    f_cur, v_cur = f_win, vel_win
    r_cur = None if rho_win is None else rho_win[1:-1]
    for j in range(k):
        lvl = k - 1 - j
        ra = R0 + 2 * (2 * lvl + 1)
        t0a = t0 - (2 * lvl + 1)
        step = step0 + j
        if cls == "full":
            f1, rho1, vel1 = _a_full(cfg, step, t0a, ra, f_cur, v_cur, r_cur)
            f_cur = _b_full(cfg, step, t0a + 1, ra - 2, f1[:, 1:-1], rho1, vel1)
        elif cls == "lean":
            f1, rho1, vel1 = _a_lean(cfg, ra, f_cur)
            f_cur = _b_lean(cfg, ra - 2, f1[:, 1:-1], rho1, vel1)
        else:
            f1, rho1, vel1 = _a_bt(cfg, ra, f_cur, v_cur, r_cur)
            f_cur = _b_bt(cfg, ra - 2, f1[:, 1:-1], rho1, vel1)
        v_cur = vel1[:, 1:-1]
        r_cur = rho1[2:-2] if lvl else rho1[1:-1]
    return f_cur, r_cur, v_cur


def _pass_ref(cls, cfg, f, rho, vel, out, segs, step, k):
    """The class pyramid on each segment's window, into ``out``'s rows."""
    H = cfg.eff_res[0]
    for y0, y1 in segs:
        rows = torch.remainder(torch.arange(y0 - 2 * k, y1 + 2 * k, device=f.device), H)
        fo, ro, vo = _pyramid(
            cls, cfg, int(k), y0, y1 - y0, int(step), f.index_select(1, rows),
            None if rho is None else rho.index_select(0, rows),
            None if vel is None else vel.index_select(1, rows))
        out["f"][:, y0:y1] = fo
        out["rho"][y0:y1] = ro
        out["vel"][:, y0:y1] = vo


# the twins take the wrappers' ``ctx`` and ignore it: a twin runs where its
# tensors are (the runner passes it to whatever it calls)

def fluid_k_ref(f, rho, vel, out, segs, step: int, k: int, cfg, ctx=None):
    """Twin of ``fluid_k``: k full-class steps from ``step`` on the rows of
    ``segs`` into ``out``."""
    _pass_ref("full", cfg, f, rho, vel, out, segs, step, k)


def fluid_k_lean_ref(f, out, segs, k: int, cfg, ctx=None):
    """Twin of ``fluid_k_lean``: k lean steps from f alone."""
    _pass_ref("lean", cfg, f, None, None, out, segs, 0, k)


def fluid_k_bt_ref(f, rho, vel, out, segs, k: int, cfg, ctx=None):
    """Twin of ``fluid_k_bt``: k below-tip steps (no step index)."""
    _pass_ref("bt", cfg, f, rho, vel, out, segs, 0, k)


def fluid_pass_ref(f, rho, vel, out, full, lean, step: int, cfg, ctx=None):
    """Twin of ``fluid_pass``: one full-class step from ``step`` on the rows
    of ``full`` and one lean step on the rows of ``lean``."""
    _pass_ref("full", cfg, f, rho, vel, out, full, step, 1)
    _pass_ref("lean", cfg, f, None, None, out, lean, 0, 1)


# ---------------------------------------------------------------------------
# The decomposition of a pass (csrc/pass_state.cuh)
# ---------------------------------------------------------------------------

def pass_strips(W: int):
    """Column strips ``[(sx0, sx1), ...]``: the whole width up to
    ``PASS_THREADS`` columns, else strips whose A columns (one halo column
    a side) fit the block's threads."""
    n = 1 if W <= PASS_THREADS else -(-W // (PASS_THREADS - 2))
    return [(s * W // n, (s + 1) * W // n) for s in range(n)]


def pass_window(W: int, sx0: int, sx1: int):
    """Columns ``(cx0, cx1)`` a strip's ring rows hold: two halo columns a
    side inside the grid, the ends on 16 bytes."""
    return max(sx0 - 2, 0) & ~3, min((sx1 + 2 + 3) & ~3, W)


def pass_runs(H: int, full, lean, runs_wanted: int, lean_cost: float = PASS_LEAN_COST):
    """Runs ``[(y0, y1, cls), ...]`` of the full and lean segments (class
    ``TILE_FULL`` / ``TILE_LEAN``): each segment cut into near-equal runs
    of at most R rows, R the rows' cost (a lean row ``lean_cost`` of a full
    one) over ``runs_wanted`` rounded up, for a lean run R / ``lean_cost``
    (each at most H - 4, so that a run's window of R + 4 rows holds each
    row once)."""
    segs = sorted([(y0, y1, TILE_FULL) for y0, y1 in full]
                  + [(y0, y1, TILE_LEAN) for y0, y1 in lean])
    cost = sum(y1 - y0 for y0, y1 in full) + lean_cost * sum(y1 - y0 for y0, y1 in lean)
    R = max(1, math.ceil(cost / max(1, runs_wanted) - 1e-9))
    most = {TILE_FULL: min(R, H - 4), TILE_LEAN: min(max(R, math.ceil(R / lean_cost)), H - 4)}
    runs = []
    for y0, y1, cls in segs:
        L = y1 - y0
        n = -(-L // most[cls])
        runs += [(y0 + i * L // n, y0 + (i + 1) * L // n, cls) for i in range(n)]
    return runs


def pass_items(H: int, W: int, full, lean, sms: int = PASS_SMS):
    """The blocks of a ``fluid_pass`` launch as ``(y0, y1, cls, sx0, sx1)``:
    block (strip, run) writes rows [y0, y1) x columns [sx0, sx1) with the
    run's class; about one block an SM."""
    strips = pass_strips(W)
    return [(y0, y1, cls, sx0, sx1) for y0, y1, cls in pass_runs(H, full, lean, sms // len(strips))
            for sx0, sx1 in strips]


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

class TileParams(ctypes.Structure):
    _fields_ = [("a", FluidParams), ("b", FluidBParams), ("nseg", ctypes.c_int),
                ("seg", ctypes.c_int * (2 * MAX_SEGS))]


class PassParams(ctypes.Structure):
    _fields_ = [("a", FluidParams), ("b", FluidBParams), ("nstrips", ctypes.c_int),
                ("rs", ctypes.c_int), ("nruns", ctypes.c_int),
                ("run", ctypes.c_int * PASS_MAX_RUNS)]


@functools.lru_cache(maxsize=64)
def _params(cfg, segs: tuple) -> TileParams:
    p = TileParams(a=_a_params(cfg), b=_b_params(cfg), nseg=len(segs))
    for i, (y0, y1) in enumerate(segs):
        p.seg[2 * i], p.seg[2 * i + 1] = y0, y1
    return p


@functools.lru_cache(maxsize=64)
def _pass_params(cfg, full: tuple, lean: tuple, sms: int,
                 lean_cost: float = PASS_LEAN_COST) -> PassParams:
    H, W = cfg.eff_res
    strips = pass_strips(W)
    runs = pass_runs(H, full, lean, sms // len(strips), lean_cost)
    if len(runs) > PASS_MAX_RUNS:
        raise ValueError(f"{len(runs)} runs; fluid_pass takes at most {PASS_MAX_RUNS}")
    p = PassParams(a=_a_params(cfg), b=_b_params(cfg), nstrips=len(strips), nruns=len(runs),
                   rs=max(b - a for a, b in (pass_window(W, *sx) for sx in strips)))
    for i, (y0, y1, cls) in enumerate(runs):
        p.run[i] = y0 | y1 << 15 | cls << 30
    return p


def _check_rows(H: int, segs, least: int = 1, most: int = MAX_SEGS):
    """``least`` to ``most`` sorted, disjoint row segments inside [0, H)."""
    if not least <= len(segs) <= most:
        raise ValueError(f"{len(segs)} row segments; the kernels take {least} to {most}")
    last = 0
    for y0, y1 in segs:
        if not last <= y0 < y1 <= H:
            raise ValueError(f"row segments {segs} not sorted, disjoint and inside [0, {H})")
        last = y1


def _check_k(k: int):
    if not 1 <= int(k) <= KMAX:
        raise ValueError(f"k = {k}: the tile kernels take 1 <= k <= {KMAX}")


def _check(cfg, step: int, n: int, **tensors) -> torch.device:
    """Float32 contiguous tensors of the grid on one card, outputs (names
    holding ``_out``) apart from the inputs and from each other, and steps
    ``step .. step + n - 1`` in int32 range."""
    dev = check_state(cfg, step, n, **tensors)
    outs = [t.data_ptr() for name, (t, _) in tensors.items() if "_out" in name]
    ins = [t.data_ptr() for name, (t, _) in tensors.items() if "_out" not in name]
    if set(outs) & set(ins) or len(set(outs)) != len(outs):
        raise ValueError("output buffers must be apart from the inputs and from each other")
    return dev


_I = ctypes.c_int


def _out_args(out):
    return dict(f_out=(out["f"], (9,)), rho_out=(out["rho"], ()), vel_out=(out["vel"], (2,)))


def _state_args(f, rho, vel, out):
    return dict(f=(f, (9,)), rho=(rho, ()), vel=(vel, (2,)), **_out_args(out))


def _launch_ctx(dev: torch.device):
    """``(device, stream)`` of launches on ``dev``'s current stream."""
    return dev, stream_of(dev)


def _launch(name, symbol, argtypes, ctx, *args):
    """Launch through ``symbol`` on ``ctx``'s stream (the caller's device
    current) and raise on a launch error."""
    build.check(build.bind(name, symbol, argtypes)(*args, ctx[1]), name)


def fluid_k(f, rho, vel, out, segs, step: int, k: int, cfg, ctx=None):
    """k full-class steps from ``step`` in one launch on the rows of
    ``segs`` (``[(y0, y1), ...]``) into ``out["f"]``, ``out["rho"]``,
    ``out["vel"]``; reads only ``f``, ``rho``, ``vel``. ``ctx``: the
    runner's launch context, its arguments checked once a run."""
    if f.device.type == "cpu":
        return fluid_k_ref(f, rho, vel, out, segs, step, k, cfg)
    if ctx is None:
        _check_k(k)
        _check_rows(cfg.eff_res[0], segs)
        dev = _check(cfg, step, k, **_state_args(f, rho, vel, out))
        with torch.cuda.device(dev):
            return fluid_k(f, rho, vel, out, segs, step, k, cfg, _launch_ctx(dev))
    _launch("fluid_k", "jrl_fluid_k", [_P] * 6 + [_I, _I, _P, _P], ctx, f.data_ptr(),
            rho.data_ptr(), vel.data_ptr(), out["f"].data_ptr(), out["rho"].data_ptr(),
            out["vel"].data_ptr(), int(step), int(k), ctypes.byref(_params(cfg, tuple(segs))))
    fluid_k.launches += 1


def fluid_k_lean(f, out, segs, k: int, cfg, ctx=None):
    """k lean steps in one launch on the rows of ``segs``; reads only f."""
    if f.device.type == "cpu":
        return fluid_k_lean_ref(f, out, segs, k, cfg)
    if ctx is None:
        _check_k(k)
        _check_rows(cfg.eff_res[0], segs)
        dev = _check(cfg, 0, k, f=(f, (9,)), **_out_args(out))
        with torch.cuda.device(dev):
            return fluid_k_lean(f, out, segs, k, cfg, _launch_ctx(dev))
    _launch("fluid_k_lean", "jrl_fluid_k_lean", [_P] * 4 + [_I, _P, _P], ctx, f.data_ptr(),
            out["f"].data_ptr(), out["rho"].data_ptr(), out["vel"].data_ptr(), int(k),
            ctypes.byref(_params(cfg, tuple(segs))))
    fluid_k_lean.launches += 1


def fluid_k_bt(f, rho, vel, out, segs, k: int, cfg, ctx=None):
    """k below-tip steps in one launch on the rows of ``segs``."""
    if f.device.type == "cpu":
        return fluid_k_bt_ref(f, rho, vel, out, segs, k, cfg)
    if ctx is None:
        _check_k(k)
        _check_rows(cfg.eff_res[0], segs)
        dev = _check(cfg, 0, k, **_state_args(f, rho, vel, out))
        with torch.cuda.device(dev):
            return fluid_k_bt(f, rho, vel, out, segs, k, cfg, _launch_ctx(dev))
    _launch("fluid_k_bt", "jrl_fluid_k_bt", [_P] * 6 + [_I, _P, _P], ctx, f.data_ptr(),
            rho.data_ptr(), vel.data_ptr(), out["f"].data_ptr(), out["rho"].data_ptr(),
            out["vel"].data_ptr(), int(k), ctypes.byref(_params(cfg, tuple(segs))))
    fluid_k_bt.launches += 1


def pass_fits(cfg) -> bool:
    """Whether ``fluid_pass`` takes the grid: rows of 16 bytes' multiples
    (the bulk copies of its ring) and rows that its run table can name."""
    H, W = cfg.eff_res
    return W % 4 == 0 and H < 2**15


def fluid_pass(f, rho, vel, out, full, lean, step: int, cfg, ctx=None):
    """One k = 1 split pass in one launch: a full-class step from ``step``
    on the rows of ``full`` and a lean step on the rows of ``lean`` (either
    list of up to three segments; ``full`` not empty) into ``out``; reads
    only ``f``, ``rho``, ``vel``."""
    if f.device.type == "cpu":
        return fluid_pass_ref(f, rho, vel, out, full, lean, step, cfg)
    if ctx is None:
        H = cfg.eff_res[0]
        _check_rows(H, full)
        _check_rows(H, lean, least=0)
        _check_rows(H, sorted(list(full) + list(lean)), most=2 * MAX_SEGS)
        if not pass_fits(cfg):
            raise ValueError(f"grid {cfg.eff_res}: fluid_pass needs W % 4 == 0 and H < 2**15")
        dev = _check(cfg, step, 1, **_state_args(f, rho, vel, out))
        if any(t.data_ptr() % 16 for t in (f, rho, vel)):
            raise ValueError("fluid_pass copies rows of 16-byte aligned inputs")
        with torch.cuda.device(dev):
            return fluid_pass(f, rho, vel, out, full, lean, step, cfg, _launch_ctx(dev))
    p = _pass_params(cfg, tuple(full), tuple(lean), sm_count(ctx[0]))
    _launch("fluid_pass", "jrl_fluid_pass", [_P] * 6 + [_I, _P, _P], ctx, f.data_ptr(),
            rho.data_ptr(), vel.data_ptr(), out["f"].data_ptr(), out["rho"].data_ptr(),
            out["vel"].data_ptr(), int(step), ctypes.byref(p))
    fluid_pass.launches += 1


def pass_info(device_index: int = 0):
    """``(registers per thread, local bytes)`` of the ``fluid_pass`` kernel
    (local bytes are its spills and stack)."""
    fn = build.bind("fluid_pass", "jrl_fluid_pass_info", [_P, _P])
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(fn(ctypes.byref(regs), ctypes.byref(local)), "fluid_pass")
    return regs.value, local.value


fluid_k.launches = 0
fluid_k_lean.launches = 0
fluid_k_bt.launches = 0
fluid_pass.launches = 0


# ---------------------------------------------------------------------------
# The runner (make_tiled_fluid_runner)
# ---------------------------------------------------------------------------

def pass_route(cfg, k: int, route: str | None = None) -> str:
    """How a k-step split pass runs: ``"pass"`` (``fluid_pass``, the full
    and lean rows in one launch; k = 1 on a grid it takes) or
    ``"classes"`` (``fluid_k`` and ``fluid_k_lean``); ``route`` forces one."""
    if route is None:
        return "pass" if int(k) == 1 and pass_fits(cfg) else "classes"
    if route not in ROUTES:
        raise ValueError(f"route {route!r}: one of {ROUTES}")
    if route == "pass" and not (int(k) == 1 and pass_fits(cfg)):
        raise ValueError(f"route 'pass' runs k = 1 on grids with W % 4 == 0 (k = {k}, "
                         f"grid {cfg.eff_res})")
    return route


def k_pass(state, out, segs, step: int, k: int, cfg, route: str | None = None, ctx=None):
    """One k-step pass: the full class on ``segs[0]``, the below-tip class
    on ``segs[1]`` and the lean class on ``segs[2]`` (each may be empty
    but the first), all reading ``state`` and writing their rows of
    ``out``; the full and lean rows through ``fluid_pass`` or the two
    class kernels (`pass_route`). Returns ``out``."""
    full, bt, lean = segs
    f, rho, vel = state["f"], state["rho"], state["vel"]
    if pass_route(cfg, k, route) == "pass":
        fluid_pass(f, rho, vel, out, full, lean, step, cfg, ctx=ctx)
    else:
        fluid_k(f, rho, vel, out, full, step, k, cfg, ctx=ctx)
        if lean:
            fluid_k_lean(f, out, lean, k, cfg, ctx=ctx)
    if bt:
        fluid_k_bt(f, rho, vel, out, bt, k, cfg, ctx=ctx)
    return out


def make_tiled_fluid_runner(cfg, tile_rows: int | None = None, unroll: int = 8,
                            k: int | None = None, lean_split: bool = True,
                            route: str | None = None):
    """Runner ``(state, fields, start_step, n) -> state`` of the JAX
    package's ``make_tiled_fluid_runner`` (same arguments and defaults):
    the chunks of `chunk_plan`, each split chunk ``reps`` k-step passes of
    the tile classes (the full and lean rows through `pass_route`'s choice,
    ``route`` forcing one), remainder steps through ``fluid_a`` /
    ``fluid_b``. On the card the state and both buffer sets are checked
    once a run and the launches go out unchecked."""
    TH, kk = _depth(cfg, tile_rows, k, lean_split)
    H = cfg.eff_res[0]
    rt = pass_route(cfg, kk, route)

    def run(state, fields, start_step: int, n: int):
        cur = {"f": state["f"], "rho": state["rho"], "vel": state["vel"]}
        plan = chunk_plan(cfg, start_step, n, TH, unroll, kk, lean_split)
        bufs = [{key: torch.empty_like(v) for key, v in cur.items()} for _ in range(2)] \
            if any(kind != "ab" for kind, *_ in plan) else []
        ctx = None
        if bufs and cur["f"].device.type == "cuda":
            dev = _check(cfg, start_step, max(int(n), 1), **_state_args(
                cur["f"], cur["rho"], cur["vel"], bufs[0]), **{
                f"{key}2": t for key, t in _out_args(bufs[1]).items()})
            ctx = _launch_ctx(dev)
        with torch.cuda.device(ctx[0]) if ctx else contextlib.nullcontext():
            for kind, s, reps, fr, fb in plan:
                if kind == "ab":
                    f, rho, vel = cur["f"], cur["rho"], cur["vel"]
                    for i in range(reps):
                        f, rho, vel = fluid_a(f, rho, vel, s + i, cfg, fields)
                        f = fluid_b(f, rho, vel, s + i, cfg, fields)
                    cur = {"f": f, "rho": rho, "vel": vel}
                    continue
                segs = class_rows(H, TH, kk, fr, fb) if kind == "split" else ([(0, H)], [], [])
                for r in range(reps):
                    out = bufs[1] if bufs[0]["f"] is cur["f"] else bufs[0]
                    cur = k_pass(cur, out, segs, s + r * kk, kk, cfg, rt, ctx)
        return dict(cur)

    run.tile_rows, run.k, run.route = TH, kk, rt
    return run
