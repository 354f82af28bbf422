"""Multi-step kernels of the three JRL phases for grids of at most
``MAX_FUSED_CELLS`` cells (`csrc/fused_fluid.cu`, `csrc/fused_balance.cu`,
`csrc/fused_approach.cu`), each with its plain PyTorch twin, and the
runners built on them.

Replace the TPU kernels of `jrl_lbm_tpu/ops/pallas/fused_jrl.py`:
``_make_jrl_fluid_kernel``, ``_make_balance_kernel`` and
``_make_approach_kernel``. One launch advances n steps in one persistent
cooperative grid, the state kept in device memory (L2) between steps.
A wrapper given tensors on the CPU runs its twin (the loop of the
per-step twins); given tensors on the card it launches the kernel or
raises. ``fused_fluid.launches`` etc. count the launches.

The runners keep the signatures of the JAX package's
``make_fused_{fluid,balance,approach}_runner`` and split a run into
launches of at most ``MAX_LAUNCH_CELL_STEPS[kernel]`` cell updates.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from jrl_lbm_torch.kernels import build
from jrl_lbm_torch.kernels.jrl_c import _approach_params, _balance_params, c_approach_ref, \
    c_balance_ref
from jrl_lbm_torch.kernels.jrl_fluid import _P, _a_params, _b_params, check_state, \
    fluid_a_ref, fluid_b_ref, stream_of
from jrl_lbm_torch.models import jrl as _jrl

# Grids the multi-step kernels serve, as the JAX package's whole-domain
# kernels (`fused_jrl.py::MAX_FUSED_CELLS`): 512x256, refine 4 of 128x64.
MAX_FUSED_CELLS = 131072
FUSED_BLOCK = 256  # threads per block (csrc/fused_launch.cuh)
# the kernels' instances: at 131,072 cells an H100 SXM needs 2 cells per
# thread for the fluid kernel (2 blocks of 256 threads per SM), a card with
# fewer SMs 4
CELLS_PER_THREAD = (1, 2, 4)
# Cell updates per launch, about a second of card time at 128x64 (13.3,
# 4.2 and 9.5 us a step on an NVIDIA H100 80GB HBM3 at 700 W,
# chip_smoke.py): 65,536 fluid steps
# (a record interval of the default case is ~39,000), 262,144 balance
# steps (a balance interval is 255,528) and 131,072 approach steps.
MAX_LAUNCH_CELL_STEPS = {"fused_fluid": 2**29, "fused_balance": 2**31, "fused_approach": 2**30}


def fits(cfg) -> bool:
    """Whether the multi-step kernels serve the config's grid."""
    H, W = cfg.eff_res
    return H * W <= MAX_FUSED_CELLS


def steps_per_launch(cfg, name: str) -> int:
    """The most steps one launch of kernel ``name`` runs on the config's grid."""
    H, W = cfg.eff_res
    return max(1, MAX_LAUNCH_CELL_STEPS[name] // (H * W))


# ---------------------------------------------------------------------------
# Plain twins: the loops of the per-step twins
# ---------------------------------------------------------------------------

def fused_fluid_ref(f, rho, vel, start: int, n: int, cfg, fields):
    """Fluid steps ``start .. start + n - 1``; returns ``(f, rho, vel)``."""
    for i in range(int(n)):
        f, rho, vel = fluid_a_ref(f, rho, vel, int(start) + i, cfg, fields)
        f = fluid_b_ref(f, rho, vel, int(start) + i, cfg, fields)
    return f, rho, vel


def fused_balance_ref(h, C, flags, n: int, cfg, fields):
    """``n`` balance steps; returns ``(h, C)``."""
    for _ in range(int(n)):
        h, C = c_balance_ref(h, C, flags, cfg, fields)
    return h, C


def fused_approach_ref(h, C, vel_field, start: int, n: int, cfg, fields):
    """Approach steps ``start .. start + n - 1`` on the stored velocity
    ``vel_field`` ``[N, 2, H, W]``; returns ``(h, C, (inflow_sum,
    current_sum, rec_u, rec_v))`` with the sums over the steps and the
    record velocities of the last step."""
    zero = torch.zeros((), dtype=torch.float32)
    inflow_sum = current_sum = rec_u = rec_v = zero
    for i in range(int(n)):
        s = int(start) + i
        vel = _jrl.stored_velocity(vel_field, s, cfg.vel_obs_conv)
        h, C, (inflow, current, rec_u, rec_v) = c_approach_ref(h, C, vel, s, cfg, fields)
        inflow_sum = inflow_sum + inflow
        current_sum = current_sum + current
    return h, C, (inflow_sum, current_sum, rec_u, rec_v)


# ---------------------------------------------------------------------------
# Launch shape: a cooperative grid no larger than the co-resident limit
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def max_blocks(name: str, cpt: int, block: int, device_index: int) -> int:
    """Blocks of kernel ``name`` (``cpt`` cells per thread, ``block``
    threads) that fit on the card at once."""
    fn = build.bind(name, f"jrl_{name}_max_blocks", [ctypes.c_int, ctypes.c_int, _P])
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(fn(int(cpt), int(block), ctypes.byref(out)), name)
    return out.value


def check_coresident(name: str, cpt: int, block: int, grid: int, device_index: int) -> None:
    """Raise, before any launch, for a grid of kernel ``name`` over the
    co-resident limit: a cooperative grid must fit on the card at once."""
    limit = max_blocks(name, cpt, block, device_index)
    if not 1 <= grid <= limit:
        raise ValueError(f"{name}: grid of {grid} blocks of {block} threads is over the "
                         f"co-resident limit of {limit} blocks ({cpt} cells per thread)")


def launch_shape(name: str, cells: int, device_index: int):
    """``(cells per thread, blocks)``: the fewest cells per thread whose
    grid fits on the card at once."""
    for cpt in CELLS_PER_THREAD:
        grid = math.ceil(cells / (cpt * FUSED_BLOCK))
        if grid <= max_blocks(name, cpt, FUSED_BLOCK, device_index):
            return cpt, grid
    raise ValueError(f"{name}: {cells} cells do not fit one co-resident grid "
                     f"at up to {CELLS_PER_THREAD[-1]} cells per thread")


def _launch(name: str, cells: int, dev: torch.device, argtypes, args) -> None:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    cpt, grid = launch_shape(name, cells, index)
    check_coresident(name, cpt, FUSED_BLOCK, grid, index)
    fn = build.bind(name, f"jrl_{name}", argtypes + [ctypes.c_int, ctypes.c_int, _P])
    with torch.cuda.device(dev):
        err = fn(*args, cpt, grid, stream_of(dev))
    build.check(err, name)


def _ping_pong(out, n: int):
    """``(P, Q)`` buffer sets: step i writes P for even i, Q for odd i, so
    the last step (i = n - 1) writes ``out``."""
    tmp = [torch.empty_like(t) for t in out]
    return (out, tmp) if n % 2 == 1 else (tmp, out)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def fused_fluid(f, rho, vel, start: int, n: int, cfg, fields):
    """Fluid steps ``start .. start + n - 1`` in one launch; returns new
    ``(f, rho, vel)``. The kernel computes the tip geometry from ``cfg`` and
    the step; ``fields`` feed the twin."""
    if f.device.type == "cpu":
        return fused_fluid_ref(f, rho, vel, start, n, cfg, fields)
    dev = check_state(cfg, start, n, f=(f, (9,)), rho=(rho, ()), vel=(vel, (2,)))
    out = (torch.empty_like(f), torch.empty_like(rho), torch.empty_like(vel))
    P, Q = _ping_pong(out, n)
    H, W = cfg.eff_res
    _launch("fused_fluid", H * W, dev, [_P] * 9 + [ctypes.c_int] * 2 + [_P, _P],
            [f.data_ptr(), rho.data_ptr(), vel.data_ptr(), *(t.data_ptr() for t in P),
             *(t.data_ptr() for t in Q), int(start), int(n), ctypes.byref(_a_params(cfg)),
             ctypes.byref(_b_params(cfg))])
    fused_fluid.launches += 1
    return out


def fused_balance(h, C, flags, n: int, cfg, fields):
    """``n`` balance steps in one launch; returns new ``(h, C)``."""
    if h.device.type == "cpu":
        return fused_balance_ref(h, C, flags, n, cfg, fields)
    dev = check_state(cfg, 0, n, h=(h, (9,)), C=(C, ()), flags=(flags, ()))
    out = (torch.empty_like(h), torch.empty_like(C))
    P, Q = _ping_pong(out, n)
    H, W = cfg.eff_res
    _launch("fused_balance", H * W, dev, [_P] * 7 + [ctypes.c_int, _P],
            [flags.data_ptr(), h.data_ptr(), C.data_ptr(), *(t.data_ptr() for t in P),
             *(t.data_ptr() for t in Q), int(n), ctypes.byref(_balance_params(cfg))])
    fused_balance.launches += 1
    return out


def fused_approach(h, C, vel_field, start: int, n: int, cfg, fields, acc):
    """Approach steps ``start .. start + n - 1`` in one launch on the
    stored velocity ``vel_field`` (float32 ``[N, 2, H, W]``); returns new
    ``(h, C)`` and updates ``acc`` (float32 ``[4]`` on the state's device)
    in place: ``acc[0] += inflow_sum``, ``acc[1] += current_sum``,
    ``acc[2] = rec_u``, ``acc[3] = rec_v`` of the last step."""
    if h.device.type == "cpu":
        h, C, (inflow_sum, current_sum, rec_u, rec_v) = fused_approach_ref(
            h, C, vel_field, start, n, cfg, fields)
        acc[0] += inflow_sum
        acc[1] += current_sum
        acc[2] = rec_u
        acc[3] = rec_v
        return h, C
    base = fields["base_flags"]
    n_frames = int(vel_field.shape[0])
    dev = check_state(cfg, start, n, h=(h, (9,)), C=(C, ()), base_flags=(base, ()),
                      vel_field=(vel_field, (n_frames, 2)))
    rint = cfg.radius_obs_int
    area = fields["area"]
    if n_frames < 1:
        raise ValueError("vel_field holds no frame")
    if rint + 1 > cfg.eff_res[1] or rint > FUSED_BLOCK:
        raise ValueError(f"tip disk of {rint} cells does not fit the grid or one block")
    if tuple(area.shape) != (rint,) or area.dtype != torch.float32 or area.device != dev:
        raise ValueError("area must be a float32 [rint] tensor on the card")
    if tuple(acc.shape) != (4,) or acc.dtype != torch.float32 or acc.device != dev:
        raise ValueError("acc must be a float32 [4] tensor on the card")
    out = (torch.empty_like(h), torch.empty_like(C))
    P, Q = _ping_pong(out, n)
    H, W = cfg.eff_res
    _launch("fused_approach", H * W, dev,
            [_P, _P, ctypes.c_int] + [_P] * 7 + [ctypes.c_int] * 2 + [_P],
            [base.data_ptr(), vel_field.data_ptr(), n_frames, area.data_ptr(), h.data_ptr(),
             *(t.data_ptr() for t in P), *(t.data_ptr() for t in Q), acc.data_ptr(),
             int(start), int(n), ctypes.byref(_approach_params(cfg))])
    fused_approach.launches += 1
    return out


fused_fluid.launches = 0
fused_balance.launches = 0
fused_approach.launches = 0


# ---------------------------------------------------------------------------
# Runners (the contracts of the JAX package's make_fused_*_runner)
# ---------------------------------------------------------------------------

def _require_fit(cfg) -> None:
    if cfg.shape not in _jrl.FLAT_SHAPES + _jrl.WEDGE_SHAPES:
        raise ValueError(f"unknown tip shape {cfg.shape}")
    if not fits(cfg):
        raise ValueError(f"grid {cfg.eff_res} exceeds the multi-step kernels' "
                         f"{MAX_FUSED_CELLS} cells")


def _chunks(n: int, cfg, name: str):
    left, size = int(n), steps_per_launch(cfg, name)
    while left > 0:
        m = min(left, size)
        yield m
        left -= m


def make_fused_fluid_runner(cfg):
    """``(state, fields, start_step, n) -> state`` through `fused_fluid`,
    one launch per ``steps_per_launch(cfg, "fused_fluid")`` steps."""
    _require_fit(cfg)

    def run(state, fields, start_step: int, n: int):
        f, rho, vel = state["f"], state["rho"], state["vel"]
        s = int(start_step)
        for m in _chunks(n, cfg, "fused_fluid"):
            f, rho, vel = fused_fluid(f, rho, vel, s, m, cfg, fields)
            s += m
        return {"f": f, "rho": rho, "vel": vel}

    return run


def make_fused_balance_runner(cfg, flags):
    """``(state, fields, n) -> state`` through `fused_balance` on the fixed
    balance ``flags``."""
    _require_fit(cfg)

    def run(state, fields, n: int):
        h, C = state["h"], state["C"]
        for m in _chunks(n, cfg, "fused_balance"):
            h, C = fused_balance(h, C, flags, m, cfg, fields)
        return {"C": C, "h": h}

    return run


def make_fused_approach_runner(cfg, vel_field):
    """``(state, fields, start_step, n) -> (state, acc)`` through
    `fused_approach`, with the stored velocity history ``vel_field``
    ``[N, 2, H, W]`` bound here; ``acc`` as `models.jrl.make_approach_runner`
    returns it (sums over the n steps, record velocities of the last)."""
    _require_fit(cfg)
    frames = torch.as_tensor(vel_field, dtype=torch.float32).contiguous()

    def run(state, fields, start_step: int, n: int):
        h, C = state["h"], state["C"]
        acc = torch.zeros(4, dtype=torch.float32, device=h.device)
        s = int(start_step)
        for m in _chunks(n, cfg, "fused_approach"):
            h, C = fused_approach(h, C, frames, s, m, cfg, fields, acc)
            s += m
        acc_d = {
            "inflow_sum": acc[0],
            "current_sum": acc[1],
            "count": torch.tensor(float(n), dtype=torch.float32),
            "rec_u": acc[2],
            "rec_v": acc[3],
        }
        return {"C": C, "h": h}, acc_d

    return run
