#!/usr/bin/env python3
"""Run the JRL kernels of the tree in the current directory on seeded
inputs on one card and print a SHA-256 of each result's bytes, so that
two trees can be held to each other bit for bit:

    (cd <tree> && python3 <this repo>/tools/jrl_kernels_ab.py <label>)

Kernels, through their wrappers: the per-step `fluid_a`, `fluid_b`,
`c_balance`, `c_approach`; the multi-step `fused_fluid`, `fused_balance`
over 300 steps at 128x64 and at 256x128 (the routes the tree takes
there), `fused_approach` there through the cooperative kernel (forced
where the tree routes elsewhere), for a wedge and a flat tip and both
signs of ``is_negative``; the multi-cluster kernels `fused_fluid_mc`,
`fused_balance_mc` and, where the tree has it, `fused_approach_mc` at
256x128 and 512x256 over 300 steps (the approach's disk row crossing
from one cluster into the next); the tile
classes `fluid_k`, `fluid_k_lean`, `fluid_k_bt` at 1024x512, k = 1, 2, 4,
on the ethaline step-0 plan and a flat tip's plan with below-tip rows,
and `fluid_pass` on the same plans at k = 1; the sharded runners on a
(2, 2) mesh on the one card at 1024x512, 12 steps a phase, through their
default routes (the passes' column instances and `halo_mesh` in this
tree, the per-step kernels and `halo_pack` in a tree before them: all bit
for bit the per-step kernels). The tree must hold `jrl_lbm_torch/`.
Prints one JSON line, last.
"""

import hashlib
import inspect
import json
import os
import sys


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    from jrl_lbm_torch.kernels import fused_jrl as F
    from jrl_lbm_torch.kernels import jrl_c, jrl_fluid
    from jrl_lbm_torch.kernels import jrl_sharded as S
    from jrl_lbm_torch.kernels import jrl_tiled as JT
    from jrl_lbm_torch.models import jrl as T
    from jrl_lbm_torch.parallel.mesh import make_mesh

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
    coop = {"route": "coop"} if "route" in inspect.signature(F.fused_approach).parameters else {}
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
                   list(F.fused_approach(st["h"], st["C"], frames, 0, n, cc, cf, acc, **coop))
                   + [acc])
    for shape, kw, step in (("ethaline", dict(refine=8, res=(128, 64)), 0),
                            ("cylinder", dict(res=(1024, 512)), 1085)):
        fc = T.JRLFluidConfig(Re=4.0, vel_obs_real=0.2848, shape=shape, **kw)
        H = fc.eff_res[0]
        s = noisy(T.fluid_init(fc, dev)[0])
        for k in (1, 2, 4):
            _, _, _, fr, fb = JT.chunk_plan(fc, step, k, k=k)[0]
            full, bt, lean = JT.class_rows(H, JT.pick_tile_rows(fc), k, fr, fb)
            o = {key: torch.full_like(v, 7.0) for key, v in s.items()}
            JT.fluid_k(s["f"], s["rho"], s["vel"], o, full, step, k, fc)
            if lean:
                JT.fluid_k_lean(s["f"], o, lean, k, fc)
            if bt:
                JT.fluid_k_bt(s["f"], s["rho"], s["vel"], o, bt, k, fc)
            digest(f"tile classes {shape} k={k} full {full} bt {bt} lean {lean}", o.values())
            if k == 1:
                o = {key: torch.full_like(v, 7.0) for key, v in s.items()}
                JT.fluid_pass(s["f"], s["rho"], s["vel"], o, full, lean, step, fc)
                if bt:
                    JT.fluid_k_bt(s["f"], s["rho"], s["vel"], o, bt, 1, fc)
                digest(f"fluid_pass {shape} full {full} bt {bt} lean {lean}", o.values())
    fc = T.JRLFluidConfig(res=(128, 64), Re=4.0, vel_obs_real=0.2848, shape="ethaline",
                          refine=8)
    cc = T.JRLCConfig(res=(128, 64), Re=4.0, Pe=5.0, vel_obs_real=0.2848, shape="ethaline",
                      refine=8)
    mesh = make_mesh((2, 2), [dev] * 4)
    s, fl = T.fluid_init(fc, dev)
    digest("sharded fluid (2, 2)",
           S.make_sharded_tiled_fluid_runner(fc, mesh)(noisy(s), fl, 0, 12).values())
    st, cf, flags = T.c_init(cc, dev)
    st = noisy(st)
    digest("sharded balance (2, 2)",
           S.make_sharded_tiled_balance_runner(cc, flags, mesh)(st, cf, 12).values())
    frames = 0.3 * torch.randn((4, 2) + cc.eff_res, generator=gen, device=dev)
    a_out, a_acc = S.make_sharded_tiled_approach_runner(cc, frames, mesh)(st, cf, 0, 12)
    digest("sharded approach (2, 2)", list(a_out.values()) + [torch.as_tensor(v) for v in
                                                                 a_acc.values()])
    for refine in (2, 4):
        fc = T.JRLFluidConfig(res=(128, 64), Re=4.0, vel_obs_real=0.2848, shape="ethaline",
                              refine=refine)
        s, fl = T.fluid_init(fc, dev)
        s = noisy(s)
        digest(f"fused_fluid_mc x{refine}", F.fused_fluid_mc(s["f"], s["rho"], s["vel"], 7, n, fc,
                                                             fl))
        cc = T.JRLCConfig(res=(128, 64), Re=4.0, Pe=5.0, vel_obs_real=0.2848, shape="ethaline",
                          refine=refine)
        st, cf, flags = T.c_init(cc, dev)
        st = noisy(st)
        digest(f"fused_balance_mc x{refine}", F.fused_balance_mc(st["h"], st["C"], flags, n, cc,
                                                                 cf))
    # last, so that a tree without it gives every other digest alike
    for refine in (2, 4) if hasattr(F, "fused_approach_mc") else ():
        cc = T.JRLCConfig(res=(128, 64), Re=4.0, Pe=5.0, vel_obs_real=0.2848, shape="ethaline",
                          refine=refine)
        st, cf, _ = T.c_init(cc, dev)
        st = noisy(st)
        # Pe 5: the tip crosses 10-20 rows in the launch
        frames = 0.3 * torch.randn((int(n * cc.vel_obs_conv / 0.1) + 2, 2) + cc.eff_res,
                                   generator=gen, device=dev)
        acc = torch.zeros(4, device=dev)
        digest(f"fused_approach_mc x{refine}",
               list(F.fused_approach_mc(st["h"], st["C"], frames, 0, n, cc, cf, acc)) + [acc])
    torch.cuda.synchronize()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
