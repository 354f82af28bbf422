"""Re x Pe sweep for the approach-curve study on the PyTorch port
(counterpart of the JAX package's `demo/batch_Pe.py`): the reference's
water and ethaline property tables and Re / Pe lists
(`demo/batch_Pe.py:9-52` of the reference), run in-process.

    python -m jrl_lbm_torch.batch_pe --fluid water --vmap_pe --device cuda

``--skip_existing`` skips a case whose record file exists (the sweep
resumes where it stopped); ``--vmap_pe`` runs each Re row's remaining Pe
lanes together (`run_re_vmapped`, implies skipping). Outputs go under
``$JRL_DEMO_OUT`` (default: the current directory), as `jrl_main.py`'s.
`run_re_row` runs one row in memory and writes nothing (no h5py needed).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from jrl_lbm_torch import jrl_main
from jrl_lbm_torch.jrl_main import c_main, demo_path, fluid_main
from jrl_lbm_torch.models import jrl
from jrl_lbm_torch.parallel import sweep
from jrl_lbm_torch.utils.device import resolve_device

mus = {"water": 0.89e-3, "ethaline": 45.23e-3}
rhos = {"water": 1e3, "ethaline": 1.11614e3}
Ds = {"water": 7.85e-10, "ethaline": 0.22e-10}
viscs = {"water": 0.89e-6, "ethaline": mus["ethaline"] / rhos["ethaline"]}
shapes = {"water": "45degree", "ethaline": "ethaline"}
RADIUS_OBS = 12.5e-6
PES = [1e-3, 3e-3, 7e-3, 1e-2, 3e-2, 7e-2, 1e-1]


def res_list(fluid: str, is_negative: bool):
    """The Re values of a fluid's sweep (`demo/batch_Pe.py:116-123`)."""
    if fluid == "water":
        if not is_negative:
            return [3e-3, 1e-3, 7e-4]
        return [1e-2, 7e-3, 5e-3, 3e-3, 1e-3, 7e-4, 5e-4, 3e-4, 1e-4, 7e-5]
    if fluid == "ethaline":
        return [1e-4, 7e-5, 3e-5, 1e-5, 7e-6, 3e-6, 1e-6]
    raise NotImplementedError(f"Not implemented for fluid {fluid}")


def record_file(fluid, shape, res, Re, Pe, is_negative, g_real=-9.8):
    """Record path of a case (as `jrl_main.c_main` names it)."""
    positive_fix = "" if is_negative else "_positive"
    prefix = jrl_main._c_prefix(shape, fluid, g_real)
    return (f"{demo_path()}/{prefix}/records{positive_fix}/"
            f"record_res{min(res)}_Re{Re}_Pe{int(Pe * 10000)}.txt")


def _c_cfg(shape, res, Re, Pe, is_negative, vel_obs, balance_time, Rg, g_real):
    return jrl.JRLCConfig(
        res=tuple(res), balance_time=balance_time, Re=Re, Pe=Pe, vel_obs_real=vel_obs,
        gravity_strength_real=g_real, Rg=Rg, shape=shape, is_negative=is_negative,
    )


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _lane_states(state, L: int):
    return {k: v.unsqueeze(0).expand((L,) + tuple(v.shape)).contiguous()
            for k, v in state.items()}


def row_inputs(fluid, shape, res, Re, Pes, is_negative, vel_obs, balance_steps=None,
               balance_time=600, Rg=4, g_real=-9.8, device="cuda", progress=False):
    """What the Pe lanes of one Re row start from, in memory: the fluid
    phase's stored history and the shared balance run for ``balance_steps``
    steps (default: the row's own ``balance_time``). Returns ``(cfg, states,
    fields, info)`` for `parallel.sweep.pe_sweep_approach`; ``info`` holds
    the C config, the step counts and each phase's wall seconds (the card
    synchronised)."""
    dev = resolve_device(device)
    # the fluid history `jrl_main.c_main` would load: the ethaline rows at
    # Re <= 3e-5 read the Re = 3e-5 row's (`C_ethaline:69`)
    fluid_Re = Re if (shape != "ethaline" or Re > 3e-5) else 3e-5
    fcfg = jrl.JRLFluidConfig(res=tuple(res), Re=fluid_Re, vel_obs_real=vel_obs * fluid_Re / Re,
                              gravity_strength_real=g_real, Rg=Rg, shape=shape)
    cfg = _c_cfg(shape, res, Re, Pes[0], is_negative, vel_obs, balance_time, Rg, g_real)
    n_bal = cfg.balance_steps if balance_steps is None else int(balance_steps)
    t0 = time.perf_counter()
    snapshots, _ = jrl_main.run_fluid(fcfg, dev, progress)
    _sync(dev)
    t1 = time.perf_counter()
    state, fields, flags = jrl.c_init(cfg, dev)
    state = jrl.pick_balance_runner(cfg, flags)(state, fields, n_bal)
    _sync(dev)
    info = {"c_cfg": cfg, "fluid_steps": fcfg.total_steps,
            "balance_steps": n_bal, "fluid_s": t1 - t0, "balance_s": time.perf_counter() - t1}
    fields = dict(fields, vel_field=torch.as_tensor(snapshots, device=dev))
    return cfg, _lane_states(state, len(Pes)), fields, info


def run_re_row(fluid, shape, res, Re, Pes, is_negative, vel_obs, balance_steps=None,
               balance_time=600, Rg=4, g_real=-9.8, device="cuda", route=None,
               max_steps=None, progress=False):
    """One Re row in memory, writing nothing: `row_inputs`, then the Pe
    lanes through `parallel.sweep.pe_sweep_approach` (``route``,
    ``max_steps`` as there). Returns ``(SweepResult, info)``, ``info`` as
    `row_inputs`' with the approach's wall seconds, route and step counts."""
    cfg, states, fields, info = row_inputs(fluid, shape, res, Re, Pes, is_negative, vel_obs,
                                           balance_steps, balance_time, Rg, g_real, device,
                                           progress)
    dev = states["h"].device
    t0 = time.perf_counter()
    result = sweep.pe_sweep_approach(cfg, Pes, states, fields, max_steps=max_steps, route=route)
    _sync(dev)
    totals = [dataclasses.replace(cfg, Pe=p).total_steps for p in Pes]
    info.update(approach_s=time.perf_counter() - t0, route=sweep.lane_route(cfg, dev, route),
                approach_steps=[n if max_steps is None else min(n, int(max_steps))
                                for n in totals])
    return result, info


def run_re_vmapped(fluid, shape, res, Re, Pes, is_negative, vel_obs, progress=True,
                   balance_time=600, Rg=4, g_real=-9.8, device="cuda"):
    """One Re row with its missing Pe lanes run together: the first missing
    Pe through the serial `jrl_main.c_main` (which writes the shared
    ``C_balance*.h5`` and that case's per-dump media), the rest as lanes of
    `parallel.sweep.pe_sweep_approach` from that balance state, writing
    record files only (the per-dump media of the serial path is scratch the
    plot layer never reads). Returns the number of cases run (0 when every
    record exists)."""
    from jrl_lbm_torch.utils.io import load_balance_h5, load_fluid_h5

    missing = [Pe for Pe in Pes
               if not os.path.exists(record_file(fluid, shape, tuple(res), Re, Pe, is_negative,
                                                 g_real=g_real))]
    if not missing:
        return 0
    fluid_main(shape=shape, res=res, Re=Re, vel_obs_real=vel_obs, gravity_strength_real=g_real,
               Rg=Rg, fluid=fluid, progress=progress, device=device)
    c_main(shape=shape, res=res, balance_time=balance_time, Re=Re, Pe=missing[0],
           vel_obs_real=vel_obs, gravity_strength_real=g_real, Rg=Rg, fluid=fluid,
           is_negative=is_negative, progress=progress, device=device)
    rest = missing[1:]
    if not rest:
        return 1

    dev = resolve_device(device)
    path = demo_path()
    positive_fix = "" if is_negative else "_positive"
    prefix = jrl_main._c_prefix(shape, fluid, g_real)
    cfg = _c_cfg(shape, res, Re, rest[0], is_negative, vel_obs, balance_time, Rg, g_real)
    _, fields, _ = jrl.c_init(cfg, dev)
    C_np, h_np = load_balance_h5(f"{path}/{prefix}/C_balance{positive_fix}.h5")
    state = jrl.state_from_numpy({"C": C_np, "h": h_np}, dev)
    re_name = Re if (shape != "ethaline" or Re > 3e-5) else 3e-5
    fluid_prefix = jrl_main._fluid_prefix(shape, fluid, g_real)
    fields = dict(fields, vel_field=torch.as_tensor(
        load_fluid_h5(f"{path}/{fluid_prefix}/Re_{re_name}.h5"), device=dev))
    result = sweep.pe_sweep_approach(cfg, rest, _lane_states(state, len(rest)), fields)
    sweep.write_sweep_records(result, cfg, f"{path}/{prefix}/records{positive_fix}", Re)
    return len(missing)


def main(fluid: str, is_negative: bool, res=(128, 64), skip_existing=False, progress=True,
         vmap_pe=False, device="cuda"):
    visc = viscs[fluid]
    shape = shapes[fluid]
    Res = res_list(fluid, is_negative)
    Pes = PES
    t_sweep = time.time()
    n_done = 0
    n_total = len(Res) * len(Pes)
    if vmap_pe:
        for Re in Res:
            vel_obs = Re * visc / RADIUS_OBS
            t_row = time.time()
            n = run_re_vmapped(fluid, shape, res, Re, Pes, is_negative, vel_obs,
                               progress=progress, device=device)
            n_done += n
            print(f"[batch_pe] Re={Re}: {n} lanes in {time.time() - t_row:.0f}s "
                  f"({n_done} new, total {time.time() - t_sweep:.0f}s)", flush=True)
        print(f"[batch_pe] lane sweep complete: {n_done} new cases, "
              f"{time.time() - t_sweep:.0f}s wall", flush=True)
        return
    for Re in Res:
        for Pe in Pes:
            vel_obs = Re * visc / RADIUS_OBS
            t_case = time.time()
            rec = record_file(fluid, shape, tuple(res), Re, Pe, is_negative)
            if skip_existing and os.path.exists(rec):
                n_done += 1
                print(f"[batch_pe] skip existing Re={Re} Pe={Pe} ({n_done}/{n_total})",
                      flush=True)
                continue
            print(f"[batch_pe] Re={Re} Pe={Pe} ({n_done + 1}/{n_total}, "
                  f"t={time.time() - t_sweep:.0f}s)", flush=True)
            fluid_main(shape=shape, res=res, Re=Re, vel_obs_real=vel_obs,
                       gravity_strength_real=-9.8, Rg=4, fluid=fluid, progress=progress,
                       device=device)
            c_main(shape=shape, res=res, balance_time=600, Re=Re, Pe=Pe, vel_obs_real=vel_obs,
                   gravity_strength_real=-9.8, Rg=4, fluid=fluid, is_negative=is_negative,
                   progress=progress, device=device)
            n_done += 1
            print(f"[batch_pe] done Re={Re} Pe={Pe} in {time.time() - t_case:.0f}s "
                  f"({n_done}/{n_total}, total {time.time() - t_sweep:.0f}s)", flush=True)
    print(f"[batch_pe] sweep complete: {n_done}/{n_total} cases, "
          f"{time.time() - t_sweep:.0f}s wall", flush=True)


def cli(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m jrl_lbm_torch.batch_pe",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter, allow_abbrev=False)
    parser.add_argument("--fluid", type=str, default="water")
    parser.add_argument("--res", type=int, nargs="+", default=[128, 64])
    parser.add_argument("--is_negative", dest="is_negative", action="store_true")
    parser.add_argument("--no-is_negative", dest="is_negative", action="store_false")
    parser.add_argument("--skip_existing", action="store_true")
    parser.add_argument("--vmap_pe", action="store_true",
                        help="run each Re row's Pe lanes together (implies skip_existing)")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--no-progress", dest="progress", action="store_false")
    parser.set_defaults(is_negative=True, progress=True)
    opt = vars(parser.parse_args(argv))
    print(opt)
    opt["res"] = tuple(opt["res"])
    return main(**opt)


if __name__ == "__main__":
    cli()
