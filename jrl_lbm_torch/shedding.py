"""Vortex-shedding gate of the cylinder channel: St, Cd and Cl_rms of a
saturated limit cycle (counterpart of the JAX package's
`validation/run_cylinder_shedding*.py`).

    python -m jrl_lbm_torch.shedding <case> --device cuda|cpu --out DIR

writes ``DIR/cylinder_shedding_<case>.json`` (the keys of the JAX
script's result) and ``DIR/cylinder_shedding_<case>_series.npz`` (the
lift and drag coefficients and the wake probe of every sample).

A case starts from the scene with an antisymmetric kick in the wake
(`perturb_wake`), runs ``warmup`` steps, then ``n_samples`` samples
``every`` steps apart: the force on the cylinder from the momentum
balance (`models/cylinder.py::drag_lift`, on the float32 f of the
stored state) and the transverse velocity 4 D downstream. St is the
dominant lift frequency (Hann window, rfft) times D over the reference
velocity. On the card the case runs through
`kernels/cylinder.py::make_fused_cylinder_runner` in the case's storage
mode; on the CPU a float32 case runs through the plain
`models/cylinder.py::make_runner`, and a bf16 case through the fused
runner's plain twins (the plain step has no storage modes).

Cases (`CASES`): ``lowblock`` (1600x800, D 20, 2.5% blockage, float32;
`validation/run_cylinder_shedding_lowblock.py`), ``b025_bf16`` and
``b025_bf16sr``, the same physics in bf16 deviation storage rounded to
nearest and stochastically (`validation/run_cylinder_shedding_sweep.py`),
and ``mini``, the 320x160 anchor of `tests/test_shedding.py` (D 16, 10%
blockage). The 1600x800 cases normalise by the measured incident
velocity (the mean streamwise velocity 6-8 D upstream over the central
10 D); ``mini`` by the nominal Vmax, as its anchor does.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from jrl_lbm_torch.kernels import cylinder as K
from jrl_lbm_torch.models import cylinder as CY
from jrl_lbm_torch.ops.equilibrium import feq
from jrl_lbm_torch.utils.device import resolve_device
from jrl_lbm_torch.utils.grid import create_2d_meshgrid

_B025 = dict(res=(1600, 800), Re=10000.0, D=20.0, cylinder_center=(400.0, 200.0))
CASES = {
    "lowblock": dict(cfg=_B025, warmup=150000, n_samples=1000, every=50, bf16_dev=False,
                     norm="measured"),
    "b025_bf16": dict(cfg=_B025, warmup=150000, n_samples=1000, every=50, bf16_dev=True,
                      norm="measured"),
    "b025_bf16sr": dict(cfg=_B025, warmup=150000, n_samples=1000, every=50, bf16_dev="sr",
                        norm="measured"),
    "mini": dict(cfg=dict(res=(320, 160), Re=1800.0, Vmax=0.1, D=16.0,
                          cylinder_center=(80.0, 80.0)),
                 warmup=12000, n_samples=400, every=25, bf16_dev=False, norm="nominal"),
}


def perturb_wake(state, cfg, amplitude=0.2):
    """The state with a Gaussian bump of +x velocity one diameter
    downstream of the cylinder, f at its equilibrium: skips the slow
    linear growth of the shedding instability
    (`validation/run_cylinder_shedding.py::perturb_wake`)."""
    H, W = cfg.res
    cx, cy = cfg.center
    dev = state["f"].device
    mesh = create_2d_meshgrid((H, W), dtype=cfg.dtype, device=dev) + 0.5 * cfg.dx
    x, y = mesh[0], mesh[1]
    r2 = ((x - cx) / cfg.D) ** 2 + ((y - (cy + cfg.D)) / cfg.D) ** 2
    bump = amplitude * cfg.Vmax * torch.exp(-r2)
    vel = state["vel"].clone()
    vel[0] = vel[0] + bump.to(cfg.dtype)
    f = feq(state["rho"], vel, dx=cfg.dx, dt=cfg.dt, force=torch.zeros_like(vel))
    return {"f": f, "rho": state["rho"], "vel": vel}


def williamson_st(re):
    """Williamson's (1988) St(Re) fit for the laminar regime, 49 < Re < 178."""
    return -3.3265 / re + 0.1816 + 1.6e-4 * re


def dominant_freq(sig, every: int) -> float:
    """The frequency (cycles per step) of the largest non-zero bin of the
    Hann-windowed spectrum of ``sig`` sampled every ``every`` steps."""
    z = sig - sig.mean()
    spec = np.abs(np.fft.rfft(z * np.hanning(len(z)))) ** 2
    freqs = np.fft.rfftfreq(len(z), d=every)
    return float(freqs[int(spec[1:].argmax()) + 1])


def run_case(case: str, device="cuda", warmup=None, n_samples=None, seed: int = 0,
             every=None, route=None) -> dict:
    """Run one case of `CASES` (``warmup``, ``n_samples`` and ``every``
    cut it down when given; ``seed`` keys the stochastic rounding) and
    return its result: the keys of the JAX script's JSON, unrounded, and
    ``series`` (numpy arrays of every sample). ``route``: how the fused
    runner's k-step passes run (`kernels.cylinder.pass_route`; the
    three-launch yardstick with ``"launches"``)."""
    p = CASES[case]
    dev = resolve_device(device)
    warmup = p["warmup"] if warmup is None else int(warmup)
    n_samples = p["n_samples"] if n_samples is None else int(n_samples)
    every = p["every"] if every is None else int(every)
    bf16_dev = p["bf16_dev"]
    cfg = CY.CylinderConfig(**p["cfg"])
    nu = (cfg.tau - 0.5) / 3.0
    state, fields = CY.init(cfg, dev)
    state = perturb_wake(state, cfg)
    if dev.type == "cpu" and bf16_dev is False:
        run = CY.make_runner(cfg)
    else:
        run = K.make_fused_cylinder_runner(cfg, bf16_dev=bf16_dev, seed=seed, route=route)
        state = dict(state, f=K.f_to_storage(state["f"], bf16_dev))

    t0 = time.perf_counter()
    state = run(state, fields, warmup)
    cx, cy = cfg.center
    px, py = int(cx), int(cy + 4 * cfg.D)
    lifts, probes = [], []
    for _ in range(n_samples):
        state = run(state, fields, every)
        f32 = dict(state, f=K.f_from_storage(state["f"], bf16_dev))
        fx, fy = CY.drag_lift(f32, fields, cfg)
        lifts.append((float(fx), float(fy)))
        probes.append(float(state["vel"][0, py, px]))
    wall = time.perf_counter() - t0
    fx = np.asarray([v[0] for v in lifts])
    fy = np.asarray([v[1] for v in lifts])
    ux = np.asarray(probes)

    if p["norm"] == "measured":
        vel = state["vel"]
        y0, y1 = int(cy - 8 * cfg.D), int(cy - 6 * cfg.D)
        x0, x1 = int(cx - 5 * cfg.D), int(cx + 5 * cfg.D)
        u_ref = float(vel[1, y0:y1, x0:x1].double().mean())
    else:
        u_ref = cfg.Vmax
    re_eff = u_ref * cfg.D / nu
    denom = 0.5 * cfg.density * u_ref ** 2 * cfg.D
    cl, cd = fx / denom, fy / denom
    clz = cl - cl.mean()
    cl_rms = float(np.sqrt((clz ** 2).mean()))
    st = dominant_freq(cl, every) * cfg.D / u_ref
    return {
        "case": case, "res": list(cfg.res), "D": cfg.D, "blockage": cfg.D / cfg.res[1],
        "bf16_dev": bf16_dev, "seed": seed, "norm": p["norm"], "device": str(dev),
        "steps": warmup + n_samples * every, "warmup": warmup, "n_samples": n_samples,
        "every": every, "wall_s": wall,
        "u_eff": u_ref, "re_cylinder_effective": re_eff, "cd_mean": float(cd.mean()),
        "cl_mean": float(cl.mean()), "cl_rms": cl_rms, "strouhal": st,
        "strouhal_williamson_at_re_eff": williamson_st(re_eff),
        "shedding": bool(cl_rms > 0.01),
        "series": {"cl": cl, "cd": cd, "u_probe": ux, "every": every, "warmup": warmup},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("case", choices=sorted(CASES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True, help="directory for the JSON and the series")
    ap.add_argument("--warmup", type=int, default=None)
    ap.add_argument("--samples", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    res = run_case(a.case, a.device, warmup=a.warmup, n_samples=a.samples, seed=a.seed)
    series = res.pop("series")
    os.makedirs(a.out, exist_ok=True)
    np.savez(os.path.join(a.out, f"cylinder_shedding_{a.case}_series.npz"), **series)
    with open(os.path.join(a.out, f"cylinder_shedding_{a.case}.json"), "w") as fo:
        json.dump(res, fo)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
