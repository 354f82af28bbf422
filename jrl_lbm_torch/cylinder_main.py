"""Flow past a cylinder in a channel on the PyTorch port (counterpart of
the JAX package's `demo/demo_2d_LBM_cylinder.py`, with its flags and
outputs).

Compute is kept apart from file writing: `run_cylinder` returns the final
state and the vorticity of each dump; `main` writes the demo's artifacts
under ``--out`` (default ``$JRL_DEMO_OUT``, else the current directory):
``demo_data_LBM_cylinder_2d/{step+1:03}.png`` every 1000 steps, the final
Tecplot zone of the staggered velocity ``{step+1:03}.plt`` and the video
``2d_LBM_cylinder.mp4`` (a GIF where no mp4 writer is installed).

    python -m jrl_lbm_torch.cylinder_main --res 800 400 --total_steps 50000 \\
        --D 20 --device cuda

On the card the steps go through `kernels/cylinder.py::
make_fused_cylinder_runner` with its defaults (a 1000-step dump interval
is 250 ``cyl_pass`` launches); on the CPU through the plain
`models/cylinder.py::make_runner`. There is no fallback between the two:
``--device cuda`` without a card raises.
"""

from __future__ import annotations

import argparse
import os
import pathlib

from jrl_lbm_torch.kernels import cylinder as _cyl
from jrl_lbm_torch.models import cylinder as cyl
from jrl_lbm_torch.ops.macro import get_vort
from jrl_lbm_torch.utils.device import resolve_device

DUMP_EVERY = 1000


def run_cylinder(cfg: cyl.CylinderConfig, total_steps: int, dump_every: int = DUMP_EVERY,
                 device="cuda"):
    """``(state, dumps)``: the state after ``total_steps`` steps from
    `init`, and one ``(step, vorticity [H, W] numpy)`` per ``dump_every``
    steps (and at the end), as the demo dumps them."""
    dev = resolve_device(device)
    state, fields = cyl.init(cfg, dev)
    run = _cyl.make_fused_cylinder_runner(cfg) if dev.type == "cuda" else cyl.make_runner(cfg)
    dumps = []
    step = 0
    while step < total_steps:
        n = min(dump_every, total_steps - step)
        state = run(state, fields, n)
        step += n
        dumps.append((step, get_vort(state["vel"], dx=cfg.dx).cpu().numpy()))
    return state, dumps


def parse(argv=None):
    """``(config, options)`` of the command line."""
    parser = argparse.ArgumentParser(
        prog="python -m jrl_lbm_torch.cylinder_main",
        description="flow past a cylinder in a channel on the PyTorch port",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter, allow_abbrev=False,
    )
    parser.add_argument("--res", type=int, nargs=2, default=[800, 400], help="H W")
    parser.add_argument("--total_steps", type=int, default=50000)
    parser.add_argument("--dt", type=float, default=1.0)
    parser.add_argument("--dx", type=float, default=1.0)
    parser.add_argument("--D", type=float, default=20.0,
                        help="cylinder diameter in cells (center stays at (10D, 10D))")
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--no-video", dest="video", action="store_false")
    opt = parser.parse_args(argv)
    cfg = cyl.CylinderConfig(res=tuple(opt.res), dt=opt.dt, dx=opt.dx, D=opt.D)
    return cfg, opt


def main(argv=None):
    """Run the demo and write its artifacts; returns ``(state, files)``,
    the final state and the paths written (frames, then the ``.plt``)."""
    from jrl_lbm_torch.utils.grid import get_staggered
    from jrl_lbm_torch.utils.io import dump_2d_plt_file_single, mkdir, save_img, write_video

    cfg, opt = parse(argv)
    print(vars(opt))
    print("Re = {}, tau = {}".format(cfg.Re, cfg.tau))
    state, dumps = run_cylinder(cfg, opt.total_steps, device=opt.device)
    out = opt.out or os.environ.get("JRL_DEMO_OUT") or os.getcwd()
    path = pathlib.Path(out).absolute()
    out_dir = f"{path}/demo_data_LBM_cylinder_2d/"
    mkdir(out_dir)
    files = []
    for step, vort in dumps:
        filename = out_dir + "{:03}.png".format(step + 1)
        save_img(vort, filename)
        files.append(filename)
    if opt.video:
        write_video(files, f"{path}/2d_LBM_cylinder.mp4")
    vel_mac = get_staggered(state["vel"])
    plt = out_dir + "{:03}.plt".format(opt.total_steps + 1)
    dump_2d_plt_file_single(plt, state["rho"].cpu().numpy(), vel_mac[0].cpu().numpy(),
                            vel_mac[1].cpu().numpy())
    return state, files + [plt]


if __name__ == "__main__":
    main()
