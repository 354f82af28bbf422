#!/usr/bin/env python3
"""Time the unsharded cylinder channel of the tree in the current
directory on one card: the runner at bench.py's 2048² scene (best of
three 600-step windows after 20 warm-up steps, CUDA events) and each of
its four kernels alone (`chip_smoke.cyl_alone`: device µs per launch at
the main path's shapes), in float32 and bf16 (round-to-nearest) storage.
For A/B runs of two trees in one call on one card, in turns:

    (cd <tree> && python3 <this repo>/tools/cyl_kernels_ab.py <label>)

The tree must hold `chip_smoke.py` and `jrl_lbm_torch/`. Prints one JSON
line, last.
"""

import json
import os
import sys


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as C
    from jrl_lbm_torch.kernels import build
    from jrl_lbm_torch.kernels import cylinder as K
    from jrl_lbm_torch.models import cylinder as CY

    if not torch.cuda.is_available():
        print("cyl_kernels_ab: no CUDA device", file=sys.stderr)
        return 2
    label = sys.argv[1] if len(sys.argv) > 1 else os.getcwd()
    dev = torch.device("cuda")
    build.build_all(("cyl_full", "cyl_interior", "cyl_interior_k", "cyl_band_k"))
    cfg = CY.CylinderConfig(**C.CYL_MAIN)
    s0, fl = CY.init(cfg, dev)
    out = {"label": label, "device": C.smi_line()}
    for bf16, mode in ((False, "f32"), (True, "bf16")):
        run = K.make_fused_cylinder_runner(cfg, bf16_dev=bf16)
        st = run(dict(s0, f=K.f_to_storage(s0["f"], bf16)), fl, 20)
        windows = []
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            st = run(st, fl, 600)
            b.record()
            torch.cuda.synchronize()
            windows.append(a.elapsed_time(b) * 1e3 / 600)
        alone = C.cyl_alone(K, cfg, run, st, fl, C.MEM_RATE_DEFAULT, bf16)
        out[mode] = {"runner_us_per_step": windows,
                     "us_per_launch": {k: v["ms"] * 1e3 for k, v in alone.items()}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
