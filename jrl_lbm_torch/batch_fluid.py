"""Re sweep over fluids on the PyTorch port (counterpart of the JAX
package's `demo/batch_fluid.py`): the reference's extended property table
(water80/60/40 mixtures) and per-fluid Re lists, run in-process; each Re
runs at its own Pe = vel_obs radius / D.

    python -m jrl_lbm_torch.batch_fluid --fluid water --device cuda
"""

from __future__ import annotations

import argparse

from jrl_lbm_torch.jrl_main import c_main, fluid_main

mus = {
    "water": 0.89e-3, "water80": 1.57e-3, "water60": 3.99e-3,
    "water40": 6.06e-3, "ethaline": 45.23e-3,
}
rhos = {
    "water": 1e3, "water80": 1.0239e3, "water60": 1.05329e3,
    "water40": 1.07819e3, "ethaline": 1.11614e3,
}
Ds = {
    "water": 7.85e-10, "water80": 5.64e-10, "water60": 3.33e-10,
    "water40": 1.53e-10, "ethaline": 0.22e-10,
}
viscs = {k: mus[k] / rhos[k] for k in mus}
viscs["water"] = 0.89e-6
shapes = {
    "water": "45degree", "water40": "ethaline", "water60": "ethaline",
    "water80": "ethaline", "ethaline": "ethaline",
}


def res_list(fluid: str, is_negative: bool):
    """The Re values of a fluid's run (`demo/batch_fluid.py` of the reference)."""
    if fluid == "water":
        if not is_negative:
            return [3e-3, 1e-3, 7e-4]
        return [1e-2, 7e-3, 5e-3, 3e-3, 1e-3, 7e-4, 5e-4, 3e-4, 1e-4, 7e-5]
    if fluid == "ethaline":
        return [1e-3]
    if fluid == "water40":
        return [7e-5]
    if fluid == "water80":
        return [1e-2, 7e-3, 5e-3, 3e-3, 1e-3, 7e-4, 5e-4, 3e-4, 1e-4, 7e-5]
    raise NotImplementedError(f"Not implemented for fluid {fluid}")


def main(fluid: str, refine: int, is_negative: bool, res=(128, 64), device="cuda"):
    visc = viscs[fluid]
    D = Ds[fluid]
    shape = shapes[fluid]
    radius_obs = 12.5e-6
    for Re in res_list(fluid, is_negative):
        vel_obs = Re * visc / radius_obs
        Pe = vel_obs * radius_obs / D
        print(Pe)
        fluid_main(shape=shape, res=res, Re=Re, vel_obs_real=vel_obs,
                   gravity_strength_real=-9.8, Rg=4, fluid=fluid, refine=refine, device=device)
        c_main(shape=shape, res=res, balance_time=600, Re=Re, Pe=Pe, vel_obs_real=vel_obs,
               gravity_strength_real=-9.8, Rg=4, fluid=fluid, refine=refine,
               is_negative=is_negative, device=device)


def cli(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m jrl_lbm_torch.batch_fluid",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter, allow_abbrev=False)
    parser.add_argument("--fluid", type=str, default="water")
    parser.add_argument("--refine", type=int, default=1)
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
