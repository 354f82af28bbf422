"""Fluid-phase kernels: step A (`csrc/fluid_a.cu`) and step B
(`csrc/fluid_b.cu`), each with its plain PyTorch twin.

Replace the TPU kernels of `jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py`:
``_make_kernel_a`` (stream, moving-tip coupling, moments) and
``_make_kernel_b`` (axisymmetric BGK). A wrapper given tensors on the
CPU runs the twin; given tensors on the card it launches the kernel or
raises. ``fluid_a.launches`` / ``fluid_b.launches`` count the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from jrl_lbm_torch.kernels import build
from jrl_lbm_torch.models import jrl as _jrl
from jrl_lbm_torch.ops import collide as _collide
from jrl_lbm_torch.ops import coupling as _coupling
from jrl_lbm_torch.ops import macro as _macro
from jrl_lbm_torch.ops import stream as _stream
from jrl_lbm_torch.utils.types import AxiSymmetricType

_AX = int(AxiSymmetricType.LINE_X_EQ_0)
_CS2 = 1.0 / 3.0


# ---------------------------------------------------------------------------
# Plain twins (the jnp step of `jrl_lbm_tpu/models/jrl.py::make_fluid_step`)
# ---------------------------------------------------------------------------

def fluid_a_ref(f, rho, vel, step: int, cfg, fields):
    """Stream, moving-tip coupling and moments; returns ``(f, rho, vel)``."""
    geo = _jrl.fluid_geometry(cfg, fields, step)
    flags, phi = geo["flags"], geo["phi"]
    vel = _jrl.fluid_tip_velocity(cfg, geo, vel)
    _, _, f = _stream.propagate(f, flags, phi_obs=phi, rho=rho, vel=vel, axisymmetric_type=_AX)
    f = _coupling.solve_boundary(
        vel, flags, f, phi, obs_vel=geo["obs_vel"], tau=cfg.tau, axisymmetric_type=_AX,
    )
    rho, vel = _macro.macro_compute(f, rho, vel, flags)
    return f, rho, vel


def fluid_b_ref(f, rho, vel, step: int, cfg, fields):
    """Axisymmetric BGK with gravity; returns ``f``."""
    flags = _jrl.fluid_geometry(cfg, fields, step)["flags"]
    return _collide.bgk_collide(
        f, rho, vel, flags, tau=cfg.tau, force=fields["force"],
        mesh_grid=fields["mesh"], axisymmetric_type=_AX,
    )


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

class _Tip(ctypes.Structure):
    _fields_ = [
        ("H", ctypes.c_int), ("W", ctypes.c_int), ("rg", ctypes.c_int), ("flat", ctypes.c_int),
        ("inflow_h", ctypes.c_float), ("vel_obs", ctypes.c_float), ("box_r", ctypes.c_float),
        ("bcx", ctypes.c_float), ("x1", ctypes.c_float),
    ]


class FluidParams(ctypes.Structure):
    _fields_ = _Tip._fields_ + [("cs2tau", ctypes.c_float)]


class FluidBParams(ctypes.Structure):
    _fields_ = _Tip._fields_ + [
        ("w_rate", ctypes.c_float), ("visc", ctypes.c_float), ("ctau", ctypes.c_float),
        ("fx", ctypes.c_float), ("fy", ctypes.c_float),
    ]


def _tip_fields(cfg):
    H, W = cfg.eff_res
    bcx = cfg.Rg_radius - cfg.box_radius
    return dict(
        H=H, W=W, rg=cfg.Rg_radius, flat=int(cfg.shape in _jrl.FLAT_SHAPES),
        inflow_h=cfg.inflow_height, vel_obs=cfg.vel_obs, box_r=cfg.box_radius,
        bcx=bcx, x1=bcx + cfg.box_radius,
    )


@functools.lru_cache(maxsize=16)
def _a_params(cfg) -> FluidParams:
    return FluidParams(**_tip_fields(cfg), cs2tau=_CS2 * cfg.tau)


@functools.lru_cache(maxsize=16)
def _b_params(cfg) -> FluidBParams:
    if cfg.density_fluid != 1.0:
        raise ValueError("fluid_b assumes the unit initial density of fluid_init")
    tau = cfg.tau
    return FluidBParams(
        **_tip_fields(cfg), w_rate=1.0 / tau, visc=_CS2 * (tau - 0.5),
        ctau=1.0 * (tau - 1.0) * _CS2, fx=0.0, fy=-cfg.gravity_strength,
    )


def check_state(cfg, step: int, n: int = 1, **tensors) -> torch.device:
    """Common checks of a launch: float32 contiguous tensors of the
    config's grid on one CUDA device, and steps ``step .. step + n - 1``
    that the kernels' int32 step index holds. The kernels convert the
    step to float32 as the jnp step does, rounding it from 2**24 on."""
    H, W = cfg.eff_res
    if H < 3 or W < 3:
        raise ValueError(f"grid {H}x{W} too small for the kernels (need >= 3x3)")
    if int(n) < 1:
        raise ValueError(f"{n} steps: a launch runs at least one")
    if not (0 <= int(step) and int(step) + int(n) - 1 < 2**31):
        raise ValueError(f"steps {step} .. {int(step) + int(n) - 1} outside int32 [0, 2**31)")
    dev = None
    for name, (t, lead) in tensors.items():
        want = tuple(lead) + (H, W)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {want}")
        if t.dtype != (torch.int32 if name in ("flags", "base_flags") else torch.float32):
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


def stream_of(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


@functools.lru_cache(maxsize=16)
def sm_count(dev) -> int:
    """The card's SMs (``dev``: a device or its index)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


_P = ctypes.c_void_p


def fluid_a(f, rho, vel, step: int, cfg, fields):
    """Fluid step A; returns new ``(f, rho, vel)``. The kernel computes the
    tip geometry from ``cfg`` and ``step``; ``fields`` feed the twin."""
    if f.device.type == "cpu":
        return fluid_a_ref(f, rho, vel, step, cfg, fields)
    dev = check_state(cfg, step, f=(f, (9,)), rho=(rho, ()), vel=(vel, (2,)))
    f_out, rho_out, vel_out = torch.empty_like(f), torch.empty_like(rho), torch.empty_like(vel)
    p = _a_params(cfg)
    fn = build.bind("fluid_a", "jrl_fluid_a", [_P] * 6 + [ctypes.c_int, _P, _P])
    with torch.cuda.device(dev):
        err = fn(f.data_ptr(), rho.data_ptr(), vel.data_ptr(), f_out.data_ptr(),
                 rho_out.data_ptr(), vel_out.data_ptr(), int(step), ctypes.byref(p),
                 stream_of(dev))
    build.check(err, "fluid_a")
    fluid_a.launches += 1
    return f_out, rho_out, vel_out


def fluid_b(f, rho, vel, step: int, cfg, fields):
    """Fluid step B; returns the collided ``f``. The body force is the
    constant ``(0, -g)`` of `fluid_init` (rho0 = 1 everywhere)."""
    if f.device.type == "cpu":
        return fluid_b_ref(f, rho, vel, step, cfg, fields)
    dev = check_state(cfg, step, f=(f, (9,)), rho=(rho, ()), vel=(vel, (2,)))
    f_out = torch.empty_like(f)
    p = _b_params(cfg)
    fn = build.bind("fluid_b", "jrl_fluid_b", [_P] * 4 + [ctypes.c_int, _P, _P])
    with torch.cuda.device(dev):
        err = fn(f.data_ptr(), rho.data_ptr(), vel.data_ptr(), f_out.data_ptr(), int(step),
                 ctypes.byref(p), stream_of(dev))
    build.check(err, "fluid_b")
    fluid_b.launches += 1
    return f_out


fluid_a.launches = 0
fluid_b.launches = 0
