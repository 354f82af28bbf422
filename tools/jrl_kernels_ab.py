#!/usr/bin/env python3
"""Run the JRL kernels of the tree in the current directory on seeded
inputs on one card and print a SHA-256 of each result's bytes, so that
two trees can be held to each other bit for bit:

    (cd <tree> && python3 <this repo>/tools/jrl_kernels_ab.py <label>)

Kernels, through their wrappers: the per-step `fluid_a`, `fluid_b`,
`c_balance`, `c_approach`; the multi-step `fused_fluid`, `fused_balance`,
`fused_approach` over 300 steps at 128x64 (the route the tree takes
there) and at 256x128 (the cooperative kernels), for a wedge and a flat
tip and both signs of ``is_negative``. The tree must hold
`jrl_lbm_torch/`. Prints one JSON line, last.
"""

import hashlib
import json
import os
import sys


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    from jrl_lbm_torch.kernels import fused_jrl as F
    from jrl_lbm_torch.kernels import jrl_c, jrl_fluid
    from jrl_lbm_torch.models import jrl as T

    if not torch.cuda.is_available():
        print("jrl_kernels_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    out = {"label": sys.argv[1] if len(sys.argv) > 1 else os.getcwd()}

    def noisy(state):
        return {k: v + 1e-3 * torch.randn(v.shape, generator=gen, device=dev)
                for k, v in state.items()}

    def digest(tag, tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
        out[tag] = h.hexdigest()[:16]

    n = 300
    for shape, refine in (("45degree", 1), ("cylinder", 1), ("ethaline", 2)):
        fc = T.JRLFluidConfig(res=(128, 64), Re=4.0, vel_obs_real=0.2848, shape=shape,
                              refine=refine)
        s, fl = T.fluid_init(fc, dev)
        s = noisy(s)
        a = jrl_fluid.fluid_a(s["f"], s["rho"], s["vel"], 7, fc, fl)
        digest(f"fluid_a {shape} x{refine}", a)
        digest(f"fluid_b {shape} x{refine}", [jrl_fluid.fluid_b(*a, 7, fc, fl)])
        digest(f"fused_fluid {shape} x{refine}",
               F.fused_fluid(s["f"], s["rho"], s["vel"], 7, n, fc, fl))
        for neg in (True, False):
            cc = T.JRLCConfig(res=(128, 64), Re=4.0, Pe=5.0, vel_obs_real=0.2848, shape=shape,
                              refine=refine, is_negative=neg)
            st, cf, flags = T.c_init(cc, dev)
            st = noisy(st)
            tag = f"{shape} x{refine} neg={neg}"
            digest(f"c_balance {tag}", jrl_c.c_balance(st["h"], st["C"], flags, cc, cf))
            digest(f"fused_balance {tag}", F.fused_balance(st["h"], st["C"], flags, n, cc, cf))
            H, W = cc.eff_res
            frames = 0.3 * torch.randn((6, 2, H, W), generator=gen, device=dev)
            vel = T.stored_velocity(frames, 11, cc.vel_obs_conv)
            acc = torch.zeros(4, device=dev)
            digest(f"c_approach {tag}",
                   list(jrl_c.c_approach(st["h"], st["C"], vel, 11, cc, cf, acc)) + [acc])
            acc = torch.zeros(4, device=dev)
            digest(f"fused_approach {tag}",
                   list(F.fused_approach(st["h"], st["C"], frames, 0, n, cc, cf, acc)) + [acc])
    torch.cuda.synchronize()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
