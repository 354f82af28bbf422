"""The doubly-periodic shear layer on the PyTorch port (counterpart of the
JAX package's `demo/demo_2d_LBM.py` and `demo/demo_2d_LBM_KBC.py`).

Compute is kept apart from file writing: `run_shear` returns the final
state and the vorticity of each dump; `main` writes the demos' artifacts,
``demo_data_LBM_2d/{step+1:03}.png`` and the video ``2d_LBM.mp4`` (BGK)
or ``2d_LBM_KBC.mp4`` (a GIF where no mp4 writer is installed), under
``--out`` (default ``$JRL_DEMO_OUT``, else the current directory).

    python -m jrl_lbm_torch.shear_main --res 130 130 --total_steps 1000 \\
        --collision bgk --dump_every 10 --device cuda

On the card the steps always go through the ``periodic`` kernel
(`kernels/periodic.py::make_fused_periodic_runner`), at any H; on the CPU
through the plain `models/shear_layer.py::make_runner`. The reference
"KBC" demo builds the MRT operator, so ``--collision mrt`` reproduces it;
``--collision kbc`` runs the entropic operator (``--kbc_type``, default
KBC_A).
"""

from __future__ import annotations

import argparse
import math
import os
import pathlib

from jrl_lbm_torch.kernels import periodic as _periodic
from jrl_lbm_torch.models import shear_layer as sl
from jrl_lbm_torch.utils.device import resolve_device


def run_shear(cfg: sl.ShearLayerConfig, total_steps: int, dump_every: int = 10, device="cuda"):
    """``(state, dumps)``: the state after ``total_steps`` steps from
    `init`, and one ``(step, vorticity [H, W] numpy)`` per ``dump_every``
    steps (and at the end), as the demo dumps them."""
    dev = resolve_device(device)
    state, fields = sl.init(cfg, dev)
    run = (_periodic.make_fused_periodic_runner(cfg) if dev.type == "cuda"
           else sl.make_runner(cfg))
    dumps = []
    step = 0
    while step < total_steps:
        n = min(dump_every, total_steps - step)
        state = run(state, fields, n)
        step += n
        dumps.append((step, sl.vorticity(state, cfg).cpu().numpy()))
    return state, dumps


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m jrl_lbm_torch.shear_main",
        description="doubly-periodic shear layer on the PyTorch port",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter, allow_abbrev=False,
    )
    parser.add_argument("--res", type=int, nargs=2, default=[130, 130])
    parser.add_argument("--total_steps", type=int, default=1000)
    parser.add_argument("--dt", type=float, default=1.0)
    parser.add_argument("--dx", type=float, default=1.0)
    parser.add_argument("--collision", choices=["bgk", "mrt", "kbc"], default="bgk")
    parser.add_argument("--kbc_type", type=int, default=None,
                        help="KBC type for --collision kbc (default KBC_A)")
    parser.add_argument("--dump_every", type=int, default=10)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--no-video", dest="video", action="store_false")
    opt = parser.parse_args(argv)
    print(vars(opt))
    from jrl_lbm_torch.utils.io import mkdir, save_img, write_video

    cfg = sl.ShearLayerConfig(res=tuple(opt.res), dt=opt.dt, dx=opt.dx,
                              collision=opt.collision, kbc_type=opt.kbc_type,
                              contact_angle=0.5 * math.pi)
    _, dumps = run_shear(cfg, opt.total_steps, opt.dump_every, opt.device)
    out = opt.out or os.environ.get("JRL_DEMO_OUT") or os.getcwd()
    path = pathlib.Path(out).absolute()
    out_dir = f"{path}/demo_data_LBM_2d/"
    mkdir(out_dir)
    file_list = []
    for step, vort in dumps:
        filename = out_dir + "{:03}.png".format(step + 1)
        save_img(vort, filename)
        file_list.append(filename)
    if opt.video:
        suffix = "" if opt.collision == "bgk" else "_KBC"
        write_video(file_list, f"{path}/2d_LBM{suffix}.mp4")
    return file_list


if __name__ == "__main__":
    main()
