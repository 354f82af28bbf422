"""Pe sweeps of the approach phase: all the lanes of a sweep row at once
(counterpart of the JAX package's `parallel/sweep.py`).

The reference sweeps Pe with one OS process per (Re, Pe) pair
(`demo/batch_Pe.py:47-52`). The lanes of one Re row share the grid, the
balance state and the stored fluid history; they differ only in the tip
speed ``vel_obs_conv``, ``tau_D`` (`C_ethaline:96-103`) and their step
counts. JAX vmaps its jnp step over the lanes. Here, on the card, every
lane runs in one launch of `kernels/fused_jrl.py::fused_approach_lanes`,
one thread-block cluster a lane, where the grid fits one cluster at one
cell a thread (the default 128x64: one lane fills 16 of the card's 132
SMs). On larger grids one lane already fills the card, and the lanes run
one after another through `models/jrl.py::pick_approach_runner` on the
kernel `fused_jrl.fused_route` takes for the grid (the multi-cluster
`fused_approach_mc` at 256x128, the cooperative `fused_approach` at
512x256, `c_approach_pass` above).
``route="serial"`` takes that way on any grid: the yardstick. On the CPU
the lanes go through the kernel's plain twin.

Records. A lane writes a record row after each step of
`models/jrl.py::c_dump_steps`, computed in Python doubles as the serial
path (`jrl_main.py::run_approach`) computes them: every committed record
of the reference sweep came from that path. JAX's sweep decides a dump
with a float32 test inside the vmapped step (its `sweep.py:119-120`),
which at 128x64 gives other schedules: 54 rows against 89 for water at
Pe 1e-3. The port does not copy that. Each row equals the serial path's
row after rounding to float32: the kernel reduces the disk integrals
where the serial runner's launches end (`fused_jrl.lane_segments`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence

import numpy as np
import torch

from jrl_lbm_torch.kernels import fused_jrl
from jrl_lbm_torch.models import jrl

ROUTES = ("lanes", "serial")


@dataclasses.dataclass
class SweepResult:
    Pes: List[float]
    records: np.ndarray  # [L, max_dumps, 5] float32: x_um, inflow, current, u, v
    n_dumps: np.ndarray  # [L] valid rows per lane


def lane_route(cfg, device, route=None) -> str:
    """``"lanes"`` where the lanes of ``cfg``'s grid run in one launch (the
    CPU twin, or on the card a grid that fits one cluster at one cell a
    thread), else ``"serial"``; ``route`` forces one."""
    if route is not None:
        if route not in ROUTES:
            raise ValueError(f"route {route!r}: one of {ROUTES}")
        return route
    dev = torch.device(device)
    if dev.type == "cpu":
        return "lanes"
    H, W = cfg.eff_res
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    limits = fused_jrl.card_limits("fused_approach", index)
    return "lanes" if fused_jrl.fused_route("fused_approach", H, W, limits) == "cluster" \
        else "serial"


def _records(cfgs, dumps, sums, max_dumps: int):
    """``[L, max_dumps, 5]`` float32 records from each lane's dump steps and
    its rows of ``(inflow_sum, current_sum, rec_u, rec_v)``, in doubles as
    `jrl_main.run_approach` forms them."""
    out = np.zeros((len(cfgs), max_dumps, 5), np.float32)
    for lane, (cfg, steps) in enumerate(zip(cfgs, dumps)):
        prev = 0
        for d, s in enumerate(steps):
            cnt = max(float(s + 1 - prev), 1.0)
            prev = s + 1
            in_sum, cur_sum, rec_u, rec_v = (float(x) for x in sums[lane][d])
            out[lane, d] = ((s + 1) * cfg.dt_conv_real * cfg.vel_obs_real * 1e6,
                            in_sum / cnt, cur_sum / cnt, rec_u, rec_v)
    return out


def _group_sums(cfgs, totals, dumps, states, fields, vel_field, route):
    """Each lane's rows of ``(inflow_sum, current_sum, rec_u, rec_v)``, the
    lanes all on the device of ``states``."""
    h, C = states["h"], states["C"]
    if route == "lanes":
        segs = [fused_jrl.lane_segments(c, d, n) for c, d, n in zip(cfgs, dumps, totals)]
        n_rows = max(1, max(len(d) for d in dumps))
        _, _, rows = fused_jrl.fused_approach_lanes(h, C, vel_field, 0, totals, segs, n_rows,
                                                    cfgs, fields)
        rows = rows.cpu().numpy()
        return [rows[lane, :len(d)] for lane, d in enumerate(dumps)]
    out = []
    for lane, (cfg, steps) in enumerate(zip(cfgs, dumps)):
        run = jrl.pick_approach_runner(cfg, vel_field)
        state, cur, rows = {"h": h[lane], "C": C[lane]}, 0, []
        for s in steps:
            state, acc = run(state, fields, cur, s + 1 - cur)
            cur = s + 1
            rows.append([float(acc[k]) for k in ("inflow_sum", "current_sum", "rec_u",
                                                 "rec_v")])
        out.append(np.asarray(rows, np.float32).reshape(len(steps), 4))
    return out


def pe_sweep_approach(
    cfg_base: jrl.JRLCConfig,
    Pes: Sequence[float],
    states,  # per-lane {"C": [L, H, W], "h": [L, 9, H, W]} (e.g. balance results)
    fields,  # shared fields incl. "vel_field"
    chunk: int = 256,
    lane_devices=None,  # split the lanes over these torch devices
    max_steps: int | None = None,  # cap on each lane's step count
    route: str | None = None,
) -> SweepResult:
    """Run the approach phase of every Pe lane of ``cfg_base``'s row.

    ``states`` holds each lane's starting state (torch tensors, or numpy),
    ``fields`` the shared ``base_flags``, ``mesh``, ``area`` and
    ``vel_field`` (`models/jrl.py::c_init`'s fields with the stored fluid
    history). ``lane_devices``: a list of torch devices; the lanes go to
    them in contiguous groups (sizes differing by at most one, no padding),
    each group one launch on its device. ``max_steps`` caps every lane's
    steps (and so its records). ``chunk`` is the JAX signature's (its steps
    per compiled loop); the lanes here run in one launch. ``route``: None
    picks `lane_route`'s, ``"serial"`` runs lane after lane through
    `pick_approach_runner`. Records as `SweepResult` (the JAX package's):
    ``records[l, :n_dumps[l]]`` are lane l's rows."""
    del chunk
    cfgs = [dataclasses.replace(cfg_base, Pe=float(p)) for p in Pes]
    totals = [c.total_steps if max_steps is None else min(c.total_steps, int(max_steps))
              for c in cfgs]
    all_dumps = [jrl.c_dump_steps(c) for c in cfgs]
    dumps = [[s for s in d if s < n] for d, n in zip(all_dumps, totals)]
    h = torch.as_tensor(states["h"], dtype=torch.float32)
    C = torch.as_tensor(states["C"], dtype=torch.float32)
    devices = [h.device] if lane_devices is None else [torch.device(d) for d in lane_devices]
    groups = np.array_split(np.arange(len(cfgs)), len(devices))
    sums = []
    for dev, idx in zip(devices, groups):
        if len(idx) == 0:
            continue
        lo, hi = int(idx[0]), int(idx[-1]) + 1
        vf = torch.as_tensor(fields["vel_field"], dtype=torch.float32, device=dev).contiguous()
        fl = {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in fields.items()}
        fl["vel_field"] = vf
        st = {"h": h[lo:hi].to(dev).contiguous(), "C": C[lo:hi].to(dev).contiguous()}
        sums += _group_sums(cfgs[lo:hi], totals[lo:hi], dumps[lo:hi], st, fl, vf,
                            lane_route(cfg_base, dev, route))
    max_dumps = max(len(d) for d in all_dumps) + 1
    return SweepResult(Pes=list(Pes), records=_records(cfgs, dumps, sums, max_dumps),
                       n_dumps=np.asarray([len(d) for d in dumps], np.int32))


def write_sweep_records(result: SweepResult, cfg_base, record_dir, Re: float):
    """Emit one reference-format record file per lane
    (`C_ethaline:283-286,406-416`)."""
    os.makedirs(record_dir, exist_ok=True)
    paths = []
    for k, Pe in enumerate(result.Pes):
        name = os.path.join(
            record_dir,
            f"record_res{min(cfg_base.eff_res)}_Re{Re}_Pe{int(Pe * 10000)}.txt",
        )
        with open(name, "w") as fo:
            fo.write("Step Inflow Current u, v\n")
            for row in result.records[k, : int(result.n_dumps[k])]:
                fo.write("{} {} {} {} {}\n".format(*row))
        paths.append(name)
    return paths
