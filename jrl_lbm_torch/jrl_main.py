"""One JRL tip-approach case on the PyTorch port (counterpart of the JAX
package's `demo/_jrl_main.py` and its eight demo CLIs).

Compute is kept apart from file writing: `run_fluid`, `run_balance` and
`run_approach` return states and rows (and call an optional hook per
interval or record), `run_case` chains them, and `fluid_main` / `c_main`
write the artifacts of the demos: ``Re_{Re}.h5``, ``C_balance*.h5``,
``balance.txt``, ``record_res*_Re*_Pe*.txt`` (same text formats), PNGs
and Tecplot dumps. Outputs go under ``$JRL_DEMO_OUT`` (default: the
current directory).

    python -m jrl_lbm_torch.jrl_main fluid --shape 45degree --res 48 32 \\
        --Re 4.0 --vel_obs_real 0.2848 --gravity_strength_real 0
    python -m jrl_lbm_torch.jrl_main c --shape 45degree --res 48 32 \\
        --Re 4.0 --Pe 5.0 --vel_obs_real 0.2848 --gravity_strength_real 0 \\
        --balance_time 0.3
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib

import numpy as np
import torch

from jrl_lbm_torch.models import jrl
from jrl_lbm_torch.utils.device import resolve_device
from jrl_lbm_torch.utils.grid import get_staggered

_FLUID_PREFIX = {"cylinder": "", "45degree": "_45degree", "infiniteplane": "_InfinitePlane"}
_C_PREFIX = {"cylinder": "_cylinder", "45degree": "_45degree", "infiniteplane": "_InfinitePlane"}


def demo_path() -> pathlib.Path:
    override = os.environ.get("JRL_DEMO_OUT")
    return pathlib.Path(override).absolute() if override else pathlib.Path.cwd()


def _fluid_prefix(shape: str, fluid: str, g_real: float) -> str:
    if shape == "ethaline":
        return f"_{fluid}_g{int(abs(g_real))}"
    return f"{_FLUID_PREFIX[shape]}_g{int(abs(g_real))}"


def _c_prefix(shape: str, fluid: str, g_real: float) -> str:
    if shape == "ethaline":
        return f"_{fluid}_g{int(abs(g_real))}"
    return _C_PREFIX[shape] + f"_g{int(abs(g_real))}"


def _progress(it, progress: bool):
    if not progress:
        return it
    from tqdm import tqdm

    return tqdm(it)


# ---------------------------------------------------------------------------
# Compute
# ---------------------------------------------------------------------------

def run_fluid(cfg: jrl.JRLFluidConfig, device="cuda", progress: bool = False):
    """Fluid phase: ``(snapshots [N, 2, H, W] numpy, final state)``."""
    return jrl.run_fluid_phase(cfg, device=device, progress=progress)


def run_balance(cfg: jrl.JRLCConfig, state, fields, flags, start_done: int = 0,
                on_interval=None, progress: bool = False):
    """Balance phase in ~100 intervals; returns ``(state, rows)`` with one
    ``(time, inflow)`` row per interval (`C_ethaline:230-263`).
    ``on_interval(done, row, state)`` runs after each interval."""
    run_bal = jrl.pick_balance_runner(cfg, flags)
    steps = cfg.balance_steps
    interval = max(1, steps // 100)
    area = np.asarray(cfg.area_array)
    wi, rint = cfg.inflow_height_int, cfg.radius_obs_int
    done = start_done
    rows = []
    for _ in _progress(range(start_done, steps, interval), progress):
        n = min(interval, steps - done)
        state = run_bal(state, fields, n)
        done += n
        C_np = state["C"].cpu().numpy()
        rows.append((done * cfg.dt_conv_real, float((C_np[wi, :rint] * area).sum())))
        if on_interval is not None:
            on_interval(done, rows[-1], state)
    return state, rows


def run_approach(cfg: jrl.JRLCConfig, state, fields, vel_field, on_record=None,
                 progress: bool = False):
    """Approach phase; returns ``(state, rows)`` with one record row
    ``(x_um, inflow, current, rec_u, rec_v)`` per dump step, the integrals
    averaged since the previous dump (`C_ethaline:364-416`).
    ``on_record(s, row, state)`` runs after each record."""
    run_app = jrl.pick_approach_runner(cfg, vel_field)
    rows = []
    cur = 0
    for s in _progress(jrl.c_dump_steps(cfg), progress):
        state, acc = run_app(state, fields, cur, s + 1 - cur)
        cur = s + 1
        cnt = max(float(acc["count"]), 1.0)
        rows.append((
            (s + 1) * cfg.dt_conv_real * cfg.vel_obs_real * 1e6,
            float(acc["inflow_sum"]) / cnt,
            float(acc["current_sum"]) / cnt,
            float(acc["rec_u"]),
            float(acc["rec_v"]),
        ))
        if on_record is not None:
            on_record(s, rows[-1], state)
    if cur < cfg.total_steps:
        state, _ = run_app(state, fields, cur, cfg.total_steps - cur)
    return state, rows


@dataclasses.dataclass
class CaseResult:
    snapshots: np.ndarray  # [N, 2, H, W] normalized fluid velocity history
    fluid_state: dict
    balance_rows: list
    record_rows: list
    c_state: dict


def run_case(fluid_cfg: jrl.JRLFluidConfig, c_cfg: jrl.JRLCConfig, device="cuda",
             progress: bool = False) -> CaseResult:
    """Fluid phase, balance and approach of one case, without writing files."""
    dev = resolve_device(device)
    snapshots, fluid_state = run_fluid(fluid_cfg, dev, progress)
    state, fields, flags = jrl.c_init(c_cfg, dev)
    state, balance_rows = run_balance(c_cfg, state, fields, flags, progress=progress)
    vel_field = torch.as_tensor(snapshots, device=dev)
    state, record_rows = run_approach(c_cfg, state, fields, vel_field, progress=progress)
    return CaseResult(snapshots, fluid_state, balance_rows, record_rows, state)


# ---------------------------------------------------------------------------
# Artifact writers (the demo CLIs)
# ---------------------------------------------------------------------------

def fluid_main(shape, res, Re, vel_obs_real, gravity_strength_real, Rg,
               fluid="ethaline", refine=1, progress=True, device="cuda"):
    """Fluid phase: run the moving-tip flow and write ``Re_{Re}.h5``."""
    from jrl_lbm_torch.utils.io import dump_2d_plt_file_C_rho, mkdir, save_fluid_h5

    if shape == "ethaline" and Re <= 1e-5:
        Re = 1e-5  # `fluid_ethaline:66`
    path = demo_path()
    prefix = _fluid_prefix(shape, fluid, gravity_strength_real)
    mkdir(f"{path}/{prefix}")
    h5name = f"{path}/{prefix}/Re_{Re}.h5"
    if os.path.exists(h5name):
        print("The fluid field is already all set")
        return h5name

    cfg = jrl.JRLFluidConfig(
        res=tuple(res), Re=Re, vel_obs_real=vel_obs_real,
        gravity_strength_real=gravity_strength_real, Rg=Rg, shape=shape, refine=refine,
    )
    print("=========== Parameters in real world ===========")
    print("velocity of pin (Real) = {}".format(vel_obs_real))
    print("radius of pin (Real) = {}".format(cfg.radius_obs_real))
    print("time step (Real) = {}".format(cfg.dt_real))
    print("g = {}".format(gravity_strength_real))
    print("=========== Parameters in Computational world ===========")
    print("velocity of pin = {}".format(cfg.vel_obs))
    print("radius of pin = {}".format(cfg.radius_obs))
    print("viscosity = {}".format(cfg.visc))
    print("g = {}".format(cfg.gravity_strength))
    print("tau = {}".format(cfg.tau))
    print("total_steps = {}".format(cfg.total_steps))

    data_dir = f"{path}/{prefix}/demo_data_Re{Re}/"
    mkdir(data_dir)
    snapshots, state = run_fluid(cfg, device, progress)

    record_steps = jrl.fluid_record_steps(cfg)
    rho = state["rho"].cpu().numpy()
    for k in (0, len(record_steps) - 1) if record_steps else ():
        vel_mac = get_staggered(torch.as_tensor(snapshots[k]))
        dump_2d_plt_file_C_rho(
            os.path.join(data_dir, f"{record_steps[k]}.dat"),
            np.zeros(rho.shape, np.float32), rho,
            vel_mac[0].numpy(), vel_mac[1].numpy(),
        )
    save_fluid_h5(h5name, snapshots)
    return h5name


def c_main(shape, res, balance_time, Re, Pe, vel_obs_real, gravity_strength_real, Rg,
           fluid="ethaline", refine=1, is_negative=True, progress=True, device="cuda"):
    """Concentration phase: balance run (checkpointed) and approach run
    with records."""
    from jrl_lbm_torch.utils.io import (
        dump_2d_plt_file_C_rho, load_balance_h5, load_fluid_h5, mkdir, save_balance_h5,
        save_img,
    )

    dev = resolve_device(device)
    positive_fix = "" if is_negative else "_positive"
    path = demo_path()
    prefix = _c_prefix(shape, fluid, gravity_strength_real)
    mkdir(f"{path}/{prefix}")

    re_name = Re if (shape != "ethaline" or Re > 3e-5) else 3e-5
    h5_fluid = f"{path}/{_fluid_prefix(shape, fluid, gravity_strength_real)}/Re_{re_name}.h5"
    if not os.path.exists(h5_fluid):
        print("Error: We cannot find this fluid field")
        return None

    cfg = jrl.JRLCConfig(
        res=tuple(res), balance_time=balance_time, Re=Re, Pe=Pe, vel_obs_real=vel_obs_real,
        gravity_strength_real=gravity_strength_real, Rg=Rg, shape=shape, refine=refine,
        is_negative=is_negative,
    )
    print("vel_obs_conv = {}, tau_D = {}, D = {}".format(cfg.vel_obs_conv, cfg.tau_D, cfg.D_coeff))
    print("total_steps = {}".format(cfg.total_steps))

    dir_path = (f"{path}/{prefix}/demo_data_LBM_2d{positive_fix}_res{min(cfg.eff_res)}"
                f"_Re{Re}_Pe{int(Pe * 10000)}/")
    mkdir(dir_path)
    record_path = f"{path}/{prefix}/records{positive_fix}/"
    mkdir(record_path)

    state, fields, flags = jrl.c_init(cfg, dev)

    # ---- phase A: balance (checkpointed) ----
    h5_C = f"{path}/{prefix}/C_balance{positive_fix}.h5"
    balance_name = dir_path + "balance.txt"
    if os.path.exists(h5_C):
        with open(balance_name, "w") as fo:
            fo.write("Step Inflow\n")
        C_np, h_np = load_balance_h5(h5_C)
        state = jrl.state_from_numpy({"C": C_np, "h": h_np}, dev)
    else:
        # partial checkpoint every ~10 intervals, so an interrupted
        # balance resumes instead of restarting
        partial = h5_C + ".partial"
        pmeta = partial + ".json"
        start_done = 0
        if os.path.exists(partial) and os.path.exists(pmeta):
            with open(pmeta) as fo:
                start_done = int(json.load(fo)["done"])
            C_np, h_np = load_balance_h5(partial)
            state = jrl.state_from_numpy({"C": C_np, "h": h_np}, dev)
            print(f"resuming balance from step {start_done}")
        else:
            with open(balance_name, "w") as fo:
                fo.write("Step Inflow\n")

        n_done = [0]

        def on_interval(done, row, st):
            with open(balance_name, "a+") as fo:
                fo.write("{} {}\n".format(*row))
            n_done[0] += 1
            if n_done[0] % 10 == 0 and done < cfg.balance_steps:
                save_balance_h5(partial, st["C"].cpu().numpy(), st["h"].cpu().numpy())
                with open(pmeta, "w") as fo:
                    json.dump({"done": done}, fo)

        state, _ = run_balance(cfg, state, fields, flags, start_done, on_interval, progress)
        save_balance_h5(h5_C, state["C"].cpu().numpy(), state["h"].cpu().numpy())
        for p in (partial, pmeta):
            if os.path.exists(p):
                os.remove(p)

    save_img(state["C"].cpu().numpy(), dir_path + "C_000.png")

    # ---- phase B: approach ----
    record_name = record_path + (
        f"record_res{min(cfg.eff_res)}_Re{Re}_Pe{int(Pe * 10000)}.txt")
    with open(record_name, "w") as fo:
        fo.write("Step Inflow Current u, v\n")
    vel_field = torch.as_tensor(load_fluid_h5(h5_fluid), device=dev)

    def on_record(s, row, st):
        with open(record_name, "a+") as fo:
            fo.write("{} {} {} {} {}\n".format(*row))
        C_np = st["C"].cpu().numpy()
        save_img(C_np, dir_path + "C_{:03}.png".format(s + 1))
        walks = cfg.inflow_height + s * cfg.vel_obs_conv
        phi = jrl._c_tip_phi(cfg, fields["mesh"], walks).cpu().numpy()
        dump_2d_plt_file_C_rho(dir_path + "{:03}.dat".format(s + 1), C_np, phi,
                               C_np * 0.0, C_np * 0.0)

    run_approach(cfg, state, fields, vel_field, on_record, progress)
    return record_name


_SHAPES = {"cylinder": "cylinder", "45degree": "45degree",
           "InfinitePlane": "infiniteplane", "infiniteplane": "infiniteplane",
           "ethaline": "ethaline"}


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m jrl_lbm_torch.jrl_main",
        description="JRL tip-approach case on the PyTorch port",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter, allow_abbrev=False,
    )
    sub = parser.add_subparsers(dest="phase", required=True)
    for phase in ("fluid", "c"):
        p = sub.add_parser(phase, allow_abbrev=False)
        p.add_argument("--shape", choices=sorted(_SHAPES), required=True)
        p.add_argument("--res", type=int, nargs="+", default=[128, 64])
        p.add_argument("--Re", type=float, default=1e-4)
        p.add_argument("--vel_obs_real", type=float,
                       default=28e-6 if phase == "fluid" else 21e-6)
        p.add_argument("--gravity_strength_real", type=float, default=-9.8)
        p.add_argument("--Rg", type=float, default=None,
                       help="4, or 200 for the infinite plane")
        p.add_argument("--fluid", type=str, default="ethaline")
        p.add_argument("--refine", type=int, default=1)
        p.add_argument("--device", type=str, default="cuda")
        p.add_argument("--no-progress", dest="progress", action="store_false")
        if phase == "c":
            p.add_argument("--balance_time", type=float, default=None,
                           help="600, or 6000 for the cylinder and the infinite plane")
            p.add_argument("--Pe", type=float, default=0.01)
            p.add_argument("--is_negative", dest="is_negative", action="store_true")
            p.add_argument("--no-is_negative", dest="is_negative", action="store_false")
            p.set_defaults(is_negative=True)
    opt = vars(parser.parse_args(argv))
    print(opt)
    phase = opt.pop("phase")
    shape = _SHAPES[opt.pop("shape")]
    if opt["Rg"] is None:
        opt["Rg"] = 200.0 if shape == "infiniteplane" else 4.0
    if phase == "fluid":
        return fluid_main(shape=shape, **opt)
    if opt["balance_time"] is None:
        opt["balance_time"] = 6000.0 if shape in jrl.FLAT_SHAPES else 600.0
    return c_main(shape=shape, **opt)


if __name__ == "__main__":
    main()
