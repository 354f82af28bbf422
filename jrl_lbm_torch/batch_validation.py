"""Shape and gravity validation sweep on the PyTorch port (counterpart of
the JAX package's `demo/batch_validation.py`): one Re through four tip and
gravity configurations (45 degrees with and without gravity, the flat tip,
the infinite plane); agreement across them is the validation (the paper's
claim of shape and gravity independence). Run in-process.

    python -m jrl_lbm_torch.batch_validation --fluid water --device cuda
"""

from __future__ import annotations

import argparse

from jrl_lbm_torch.jrl_main import c_main, fluid_main

mus = {"water": 0.89e-3, "ethaline": 45.23e-3}
rhos = {"water": 1e3, "ethaline": 1.11614e3}
Ds = {"water": 7.85e-10, "ethaline": 0.22e-10}
viscs = {"water": 0.89e-6, "ethaline": mus["ethaline"] / rhos["ethaline"]}
# (shape, gravity) of each configuration
CONFIGS = [("45degree", -9.8), ("45degree", 0.0), ("cylinder", -9.8), ("infiniteplane", -9.8)]


def case_params(fluid: str, Re: float):
    """``(vel_obs_real, Pe)`` of a fluid at Re (tip radius 12.5 um)."""
    radius_obs = 12.5e-6
    vel_obs = Re * viscs[fluid] / radius_obs
    return vel_obs, vel_obs * radius_obs / Ds[fluid]


def main(fluid: str, is_negative: bool, Re: float = 3e-4, res=(128, 64), device="cuda"):
    vel_obs, Pe = case_params(fluid, Re)
    for shape, g in CONFIGS:
        rg = 200 if shape == "infiniteplane" else 4
        fluid_main(shape=shape, res=res, Re=Re, vel_obs_real=vel_obs, gravity_strength_real=g,
                   Rg=rg, device=device)
        c_main(shape=shape, res=res, balance_time=600, Re=Re, Pe=Pe, vel_obs_real=vel_obs,
               gravity_strength_real=g, Rg=rg, is_negative=is_negative, device=device)


def cli(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m jrl_lbm_torch.batch_validation",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter, allow_abbrev=False)
    parser.add_argument("--fluid", type=str, default="water")
    parser.add_argument("--Re", type=float, default=3e-4)
    parser.add_argument("--res", type=int, nargs="+", default=[128, 64])
    parser.add_argument("--is_negative", dest="is_negative", action="store_true")
    parser.add_argument("--no-is_negative", dest="is_negative", action="store_false")
    parser.add_argument("--device", type=str, default="cuda")
    parser.set_defaults(is_negative=True)
    opt = vars(parser.parse_args(argv))
    print(opt)
    opt["res"] = tuple(opt["res"])
    return main(**opt)


if __name__ == "__main__":
    cli()
