"""Concentration-phase kernels: the balance step (`csrc/c_balance.cu`),
the approach step with its tip-disk integrals as a kernel pair after
PyTorch's frame lerp (`csrc/c_approach.cu`, the yardstick) and in one
launch with the lerp inside (`csrc/c_approach_pass.cu`, the main path),
each with its plain PyTorch twin.

Replace the TPU kernels ``_make_c_balance_kernel`` and
``_make_c_approach_kernel`` (with the jnp lerp of
``_c_one_approach_step``) of `jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py`.
A wrapper given tensors on the CPU runs the twin; given tensors on the
card it launches the kernel or raises. ``c_balance.launches``,
``c_approach.launches`` and ``c_approach_pass.launches`` count the
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from jrl_lbm_torch.kernels import build
from jrl_lbm_torch.kernels.jrl_fluid import _P, check_state, sm_count, stream_of
from jrl_lbm_torch.models import jrl as _jrl
from jrl_lbm_torch.ops import collide as _collide
from jrl_lbm_torch.ops import macro as _macro
from jrl_lbm_torch.ops import stream as _stream
from jrl_lbm_torch.utils.types import AxiSymmetricType, CellType

_AX = int(AxiSymmetricType.LINE_X_EQ_0)


# ---------------------------------------------------------------------------
# Plain twins (the jnp steps of `jrl_lbm_tpu/models/jrl.py`)
# ---------------------------------------------------------------------------

def c_balance_ref(h, C, flags, cfg, fields):
    """Balance step at zero velocity; returns ``(h, C)``."""
    H, W = cfg.eff_res
    zero_vel = torch.zeros((2, H, W), dtype=cfg.dtype, device=h.device)
    C, _, h = _stream.propagate(
        h, flags, rho=C, vel=zero_vel, inflow_density=0.0, axisymmetric_type=_AX,
    )
    C = _macro.macro_compute_C(h, C, flags)
    h = _collide.bgk_collide(
        h, C, zero_vel, flags, tau=cfg.tau_D, mesh_grid=fields["mesh"],
        is_convection=True, axisymmetric_type=_AX,
    )
    return h, C


def c_approach_ref(h, C, vel, step: int, cfg, fields, v=None, tau_D=None):
    """Approach step on the interpolated stored velocity ``vel`` (not yet
    scaled by the tip speed); returns ``(h, C, (inflow, current, rec_u,
    rec_v))``. ``v`` and ``tau_D`` (0-d float32 tensors) override the
    config's tip speed and relaxation time, as the JAX package's
    parametrized step does."""
    v = cfg.vel_obs_conv if v is None else v
    tau_D = cfg.tau_D if tau_D is None else tau_D
    mesh = fields["mesh"]
    walks, walks_int = _jrl.tip_walks(cfg.inflow_height, step, v)
    flags = _jrl._c_flags_at(cfg, fields["base_flags"], mesh, walks, walks_int, strict=True)
    phi = _jrl._c_tip_phi(cfg, mesh, walks)
    C = torch.where(flags == int(CellType.OBSTACLE), 0.0, C)
    C_vel = convection_velocity(vel, walks_int, cfg, v)

    C, _, h = _stream.propagate(
        h, flags, phi_obs=phi, rho=C, vel=C_vel, inflow_density=0.0,
        axisymmetric_type=_AX,
    )
    C = _macro.macro_compute_C(h, C, flags)
    if cfg.clamp_C:
        C = torch.clamp(C, 0.0, 1.0)
    h = _collide.bgk_collide(
        h, C, C_vel, flags, tau=tau_D, mesh_grid=mesh,
        is_convection=True, axisymmetric_type=_AX,
    )

    return h, C, disk_integrals(C, C_vel, walks_int, cfg, fields)


def convection_velocity(vel, walks_int: int, cfg, v):
    """The approach step's convection velocity from the interpolated stored
    velocity ``vel`` ``[2, H, W]`` at tip speed ``v``: ``vel * v``, with the
    tip block (rows below ``walks_int``, columns below Rg) moving at
    ``(0, v)``."""
    H, W = cfg.eff_res
    C_vel = vel * v
    iy, ix = _jrl._iota(H, W, vel.device)
    tip_block = (iy < walks_int) & (ix < cfg.Rg_radius)
    return torch.stack(
        [torch.where(tip_block, 0.0, C_vel[0]), torch.where(tip_block, v, C_vel[1])]
    ).to(cfg.dtype)


def _disk_row(arr, row: int, H: int, n: int):
    return arr[min(max(row, 0), H - 1), :n]


def disk_columns(C, walks_int: int, cfg, fields):
    """The step's inflow and current terms of each tip-disk column ``x <
    rint`` from the new C (`csrc/jrl_c.cuh::disk_terms`, whose sums over the
    columns are the integrals): rows ``walks_int`` and ``walks_int + 1``
    (the flat flux form also reads the row below and column rint); rows
    clamp into [0, H-1] as jax.lax.dynamic_slice clamps its start."""
    H = cfg.eff_res[0]
    rint = cfg.radius_obs_int
    mesh = fields["mesh"]
    area = fields["area"]
    if cfg.shape in _jrl.FLAT_SHAPES:
        def flux(row):  # dC_z + dC_r (`C_cylinder:344-358`)
            dC_z = _disk_row(C, row, H, rint) - _disk_row(C, row - 1, H, rint)
            r_line = _disk_row(mesh[0], row, H, rint + 1)
            rC = r_line * _disk_row(C, row, H, rint + 1)
            dC_r = (rC[1:] - rC[:-1]) / r_line[:-1]
            return (dC_z + dC_r) * area

        return flux(walks_int), flux(walks_int + 1)
    # plain disk integral (`C_ethaline:364-381`)
    return _disk_row(C, walks_int, H, rint) * area, _disk_row(C, walks_int + 1, H, rint) * area


def disk_integrals(C, C_vel, walks_int: int, cfg, fields):
    """The step's ``(inflow, current, rec_u, rec_v)`` from the new C and the
    convection velocity ``C_vel``: sums of `disk_columns` and of the
    convection velocity over the tip disk of row ``walks_int + 1``."""
    H = cfg.eff_res[0]
    rint = cfg.radius_obs_int
    area = fields["area"]
    inflow, current = (torch.sum(t) for t in disk_columns(C, walks_int, cfg, fields))
    rec_u = torch.sum(_disk_row(C_vel[0], walks_int + 1, H, rint) * area)
    rec_v = torch.sum(_disk_row(C_vel[1], walks_int + 1, H, rint) * area)
    return inflow, current, rec_u, rec_v


def c_approach_pass_ref(h, frames, step: int, cfg, fields, b0: int = 0,
                        n_frames: int | None = None):
    """`c_approach_pass`'s twin: the stored velocity of ``step`` from the
    window ``frames`` (frames ``b0 ..`` of a history of ``n_frames``), then
    `c_approach_ref`. The step never reads the old C (zeroed in the tip,
    kept only at OBSTACLE cells), so none is taken; returns ``(h, C,
    (inflow, current, rec_u, rec_v))``."""
    vel = _jrl.stored_velocity(frames, step, cfg.vel_obs_conv, b0, n_frames)
    return c_approach_ref(h, torch.zeros_like(h[0]), vel, step, cfg, fields)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

class CBalanceParams(ctypes.Structure):
    _fields_ = [
        ("H", ctypes.c_int), ("W", ctypes.c_int),
        ("w_rate", ctypes.c_float), ("c_tau", ctypes.c_float),
    ]


class CApproachParams(ctypes.Structure):
    _fields_ = [
        ("H", ctypes.c_int), ("W", ctypes.c_int), ("rg", ctypes.c_int), ("rint", ctypes.c_int),
        ("inflow_h_int", ctypes.c_int), ("flat", ctypes.c_int), ("is_negative", ctypes.c_int),
        ("clamp", ctypes.c_int),
        ("inflow_h", ctypes.c_float), ("v", ctypes.c_float), ("box_r", ctypes.c_float),
        ("bcx", ctypes.c_float), ("x1", ctypes.c_float),
        ("w_rate", ctypes.c_float), ("c_tau", ctypes.c_float),
    ]


@functools.lru_cache(maxsize=16)
def _balance_params(cfg) -> CBalanceParams:
    H, W = cfg.eff_res
    tau = cfg.tau_D
    return CBalanceParams(H=H, W=W, w_rate=1.0 / tau, c_tau=1.0 * (1.0 - 0.5 / tau))


@functools.lru_cache(maxsize=16)
def _approach_params(cfg) -> CApproachParams:
    H, W = cfg.eff_res
    tau = cfg.tau_D
    bcx = cfg.Rg_radius - cfg.box_radius
    return CApproachParams(
        H=H, W=W, rg=cfg.Rg_radius, rint=cfg.radius_obs_int,
        inflow_h_int=cfg.inflow_height_int, flat=int(cfg.shape in _jrl.FLAT_SHAPES),
        is_negative=int(cfg.is_negative), clamp=int(cfg.clamp_C), inflow_h=cfg.inflow_height,
        v=cfg.vel_obs_conv, box_r=cfg.box_radius, bcx=bcx, x1=bcx + cfg.box_radius,
        w_rate=1.0 / tau, c_tau=1.0 * (1.0 - 0.5 / tau),
    )


def c_balance(h, C, flags, cfg, fields):
    """Balance step; returns new ``(h, C)``."""
    if h.device.type == "cpu":
        return c_balance_ref(h, C, flags, cfg, fields)
    dev = check_state(cfg, 0, h=(h, (9,)), C=(C, ()), flags=(flags, ()))
    h_out, C_out = torch.empty_like(h), torch.empty_like(C)
    p = _balance_params(cfg)
    fn = build.bind("c_balance", "jrl_c_balance", [_P] * 6 + [_P])
    with torch.cuda.device(dev):
        err = fn(flags.data_ptr(), h.data_ptr(), C.data_ptr(), h_out.data_ptr(),
                 C_out.data_ptr(), ctypes.byref(p), stream_of(dev))
    build.check(err, "c_balance")
    c_balance.launches += 1
    return h_out, C_out


def c_approach(h, C, vel, step: int, cfg, fields, acc):
    """Approach step; returns new ``(h, C)`` and updates ``acc`` (float32
    ``[4]`` on the state's device) in place: ``acc[0] += inflow``,
    ``acc[1] += current``, ``acc[2] = rec_u``, ``acc[3] = rec_v``.
    ``vel`` is the interpolated stored velocity of this step."""
    if h.device.type == "cpu":
        h, C, (inflow, current, rec_u, rec_v) = c_approach_ref(h, C, vel, step, cfg, fields)
        acc[0] += inflow
        acc[1] += current
        acc[2] = rec_u
        acc[3] = rec_v
        return h, C
    base = fields["base_flags"]
    dev = check_state(cfg, step, h=(h, (9,)), C=(C, ()), vel=(vel, (2,)),
                      base_flags=(base, ()))
    rint = cfg.radius_obs_int
    area = fields["area"]
    if rint + 1 > cfg.eff_res[1] or tuple(area.shape) != (rint,) or area.device != dev:
        raise ValueError("tip disk does not fit the grid, or area is not on the card")
    if tuple(acc.shape) != (4,) or acc.dtype != torch.float32 or acc.device != dev:
        raise ValueError("acc must be a float32 [4] tensor on the card")
    h_out, C_out = torch.empty_like(h), torch.empty_like(C)
    p = _approach_params(cfg)
    fn = build.bind("c_approach", "jrl_c_approach", [_P] * 7 + [ctypes.c_int, _P, _P])
    with torch.cuda.device(dev):
        err = fn(base.data_ptr(), h.data_ptr(), vel.data_ptr(), area.data_ptr(),
                 h_out.data_ptr(), C_out.data_ptr(), acc.data_ptr(), int(step),
                 ctypes.byref(p), stream_of(dev))
    build.check(err, "c_approach")
    c_approach.launches += 1
    return h_out, C_out


# ---------------------------------------------------------------------------
# c_approach_pass: one launch a step
# ---------------------------------------------------------------------------

# shared memory of a window cell: h (9 floats), phi, the flag code
PASS_CELL_BYTES = 11 * 4
APPROACH_ROUTES = ("pass", "pair")


class CPassParams(ctypes.Structure):
    _fields_ = [("a", CApproachParams), ("nruns", ctypes.c_int), ("wrows", ctypes.c_int),
                ("n_frames", ctypes.c_int), ("b0", ctypes.c_int)]


def approach_route(route: str | None) -> str:
    """How the per-step approach runs: ``"pass"`` (`c_approach_pass`, the
    default) or ``"pair"`` (`c_approach` after PyTorch's lerp)."""
    if route is None:
        return "pass"
    if route not in APPROACH_ROUTES:
        raise ValueError(f"route {route!r}: one of {APPROACH_ROUTES}")
    return route


def pass_smem_bytes(wrows: int, W: int) -> int:
    """Dynamic shared memory of a block whose planes hold ``wrows`` rows:
    an mbarrier a row (16-byte aligned), then the window cells."""
    return -(-wrows * 8 // 16) * 16 + wrows * W * PASS_CELL_BYTES


def approach_pass_plan(H: int, W: int, sms: int, smem: int, per_sm: int = 1):
    """``(blocks, window rows, shared memory bytes)`` of `c_approach_pass`
    on an ``H x W`` grid of a card with ``sms`` SMs, ``per_sm`` blocks an SM
    and ``smem`` bytes of dynamic shared memory a block, or None where it
    cannot run: block b computes rows ``[b H // blocks, (b + 1) H //
    blocks)`` (runs of at least two rows, so that the OUTFLOW rows' reach
    two rows inward stays in the first and last windows) with one row a
    side; one wave (8 rows a run at 1024x512 on 132 SMs), shorter runs where
    a window would not fit (more waves), none where a run of two rows does
    not fit (W over ~1,300) or the rows are no multiple of 16 bytes (the
    bulk copies)."""
    if W % 4 or H < 2:
        return None
    most = 2
    while pass_smem_bytes(most + 3, W) <= smem:
        most += 1
    if pass_smem_bytes(most + 2, W) > smem:
        return None
    rows = min(max(2, -(-H // (sms * per_sm))), most)
    blocks = max(1, min(-(-H // rows), H // 2))
    wrows = -(-H // blocks) + 2
    if pass_smem_bytes(wrows, W) > smem:
        return None
    return blocks, wrows, pass_smem_bytes(wrows, W)


@functools.lru_cache(maxsize=16)
def pass_limits(device_index: int):
    """``(dynamic shared memory a block, threads a block, blocks an SM)`` of
    the `c_approach_pass` kernel on the card."""
    fn = build.bind("c_approach_pass", "jrl_c_approach_pass_limits", [_P, _P, _P])
    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device_index):
        build.check(fn(*(ctypes.byref(x) for x in out)), "c_approach_pass")
    return tuple(x.value for x in out)


def pass_info(device_index: int = 0):
    """``(registers per thread, local bytes)`` of the `c_approach_pass` kernel."""
    fn = build.bind("c_approach_pass", "jrl_c_approach_pass_info", [_P, _P])
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(fn(ctypes.byref(regs), ctypes.byref(local)), "c_approach_pass")
    return regs.value, local.value


class PassCtx(NamedTuple):
    """A run's launch context of `c_approach_pass`, its arguments checked:
    the device, its stream, the launch constants and the kernel's ticket
    (an int32 on the card that the last block of a launch resets)."""

    dev: torch.device
    stream: ctypes.c_void_p
    params: CPassParams
    ticket: torch.Tensor


def approach_pass_ctx(h, outs, frames, start_step: int, n: int, cfg, fields, acc,
                      b0: int = 0, n_frames: int | None = None) -> PassCtx:
    """Check, once, the arguments of ``n`` `c_approach_pass` launches from
    ``start_step`` reading ``h`` and writing the ``(h, C)`` pairs of
    ``outs``, and return their launch context."""
    base, area = fields["base_flags"], fields["area"]
    N = int(frames.shape[0])
    n_frames = b0 + N if n_frames is None else int(n_frames)
    out_args = {f"{k}{j}": (t, lead) for j, (ho, Co) in enumerate(outs)
                for k, t, lead in (("h_out", ho, (9,)), ("C_out", Co, ()))}
    dev = check_state(cfg, start_step, n, h=(h, (9,)), base_flags=(base, ()),
                      frames=(frames, (N, 2)), **out_args)
    H, W = cfg.eff_res
    rint = cfg.radius_obs_int
    if rint + 1 > W or tuple(area.shape) != (rint,) or area.dtype != torch.float32 \
            or area.device != dev:
        raise ValueError("tip disk does not fit the grid, or area is not a float32 [rint] "
                         "tensor on the card")
    if tuple(acc.shape) != (4,) or acc.dtype != torch.float32 or acc.device != dev:
        raise ValueError("acc must be a float32 [4] tensor on the card")
    if any(t.data_ptr() % 16 for t in [h] + [ho for ho, _ in outs]):
        raise ValueError("c_approach_pass copies rows of 16-byte aligned h")
    if not 0 <= b0 <= n_frames - N:
        raise ValueError(f"a window of {N} frames from frame {b0} in a history of {n_frames}")
    for s in (int(start_step), int(start_step) + int(n) - 1):
        b, _, lerp = _jrl.frame_pair(s, cfg.vel_obs_conv, n_frames)
        if not (b0 <= b and b + int(lerp) < b0 + N):
            raise ValueError(f"step {s} reads frames {b}..{b + int(lerp)}, outside the window "
                             f"of frames {b0}..{b0 + N - 1}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    smem, _, per_sm = pass_limits(index)
    plan = approach_pass_plan(H, W, sm_count(index), smem, per_sm)
    if plan is None:
        raise ValueError(f"grid {H}x{W}: c_approach_pass needs W % 4 == 0 and a window of "
                         f"4 rows of {W} cells within {smem} bytes")
    blocks, wrows, _ = plan
    params = CPassParams(a=_approach_params(cfg), nruns=blocks, wrows=wrows,
                         n_frames=n_frames, b0=int(b0))
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    return PassCtx(dev, stream_of(dev), params, ticket)


def c_approach_pass(h, frames, step: int, cfg, fields, acc, out=None, b0: int = 0,
                    n_frames: int | None = None, ctx: PassCtx | None = None):
    """One approach step in one launch on the stored velocity ``frames``
    (float32 ``[N, 2, H, W]``: frames ``b0 .. b0 + N - 1`` of a history of
    ``n_frames``, default ``b0 + N``), interpolated in the kernel; returns
    the new ``(h, C)``, written into ``out = (h_out, C_out)`` when given,
    and updates ``acc`` in place as `c_approach` does. ``ctx``: a run's
    context from `approach_pass_ctx` (its ``b0`` and ``n_frames`` rule);
    without one every argument is checked here."""
    if h.device.type == "cpu":
        h, C, (inflow, current, rec_u, rec_v) = c_approach_pass_ref(h, frames, step, cfg,
                                                                    fields, b0, n_frames)
        acc[0] += inflow
        acc[1] += current
        acc[2] = rec_u
        acc[3] = rec_v
        return h, C
    if out is None:
        out = (torch.empty_like(h), torch.empty_like(h[0]))
    if ctx is None:
        ctx = approach_pass_ctx(h, [out], frames, step, 1, cfg, fields, acc, b0, n_frames)
        with torch.cuda.device(ctx.dev):
            return c_approach_pass(h, frames, step, cfg, fields, acc, out, ctx=ctx)
    fn = build.bind("c_approach_pass", "jrl_c_approach_pass",
                    [_P] * 8 + [ctypes.c_int, _P, _P])
    err = fn(fields["base_flags"].data_ptr(), h.data_ptr(), frames.data_ptr(),
             fields["area"].data_ptr(), out[0].data_ptr(), out[1].data_ptr(), acc.data_ptr(),
             ctx.ticket.data_ptr(), int(step), ctypes.byref(ctx.params), ctx.stream)
    build.check(err, "c_approach_pass")
    c_approach_pass.launches += 1
    return out


c_balance.launches = 0
c_approach.launches = 0
c_approach_pass.launches = 0
