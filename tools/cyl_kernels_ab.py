#!/usr/bin/env python3
"""Hold the cylinder channel of the tree in the current directory to
another tree's on one card: the bits of every kernel and the times.
For A/B runs of two trees in one call on one card, in turns:

    (cd <tree> && python3 <this repo>/tools/cyl_kernels_ab.py <label>)

Bits (a SHA-256 of each result's bytes, seeded inputs): one launch of
`cyl_full`, `cyl_interior`, `cyl_interior_k` and `cyl_band_k` ("cyl",
"edge") at k = 1, 2, 4, in float32, bf16 and stochastically rounded
bf16, at the split 256x128 and at `bench.py`'s 2048² scene; the runner
over 23 steps (k = 4, k = 2 and single steps) at both, by the tree's own
route (the k-step passes through `cyl_pass` where the tree has it) and,
where the tree has the option, through the three launches
(``route="launches"``), so that the pass and the launches of two trees
show as the same bits; the sharded
cylinder runner over 12 steps on a (2, 2) mesh of the one card at 2048²,
lean k = 4 and PIECES (`cyl_block_sh`), then lean k = 1 on (4, 1) and
(1, 1), each lean route by the tree's own route (one `cyl_pass_sh` launch
a shard and pass where the tree has it) and, where the tree has the
option, through `cyl_lean_sh` + `cyl_window_sh` (``route="launches"``).

Times: the runner at 2048² (best of three 600-step windows after 20
warm-up steps, CUDA events) and each kernel alone
(`chip_smoke.cyl_alone`: device µs per launch at the main path's
shapes), in float32 and bf16 (round-to-nearest) storage.

The tree must hold `chip_smoke.py` and `jrl_lbm_torch/`. Prints one JSON
line, last.
"""

import hashlib
import inspect
import json
import os
import sys


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as C
    from jrl_lbm_torch.kernels import build
    from jrl_lbm_torch.kernels import cyl_sharded as CS
    from jrl_lbm_torch.kernels import cylinder as K
    from jrl_lbm_torch.models import cylinder as CY
    from jrl_lbm_torch.parallel.mesh import make_mesh

    if not torch.cuda.is_available():
        print("cyl_kernels_ab: no CUDA device", file=sys.stderr)
        return 2
    label = sys.argv[1] if len(sys.argv) > 1 else os.getcwd()
    dev = torch.device("cuda")
    names = [n for n in ("cyl_full", "cyl_interior", "cyl_interior_k", "cyl_band_k", "cyl_pass",
                         "cyl_block_sh", "cyl_lean_sh", "cyl_window_sh", "cyl_pass_sh")
             if n in build.NAMES]
    build.build_all(names)
    out = {"label": label, "device": C.smi_line(), "bits": {}}
    has_route = "route" in inspect.signature(K.make_fused_cylinder_runner).parameters
    has_sh_route = "route" in inspect.signature(CS.make_sharded_fused_cylinder_runner).parameters

    def digest(tag, tensors):
        h = hashlib.sha256()
        for t in tensors:
            t = t.detach().contiguous()
            h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).cpu().numpy()
                     .tobytes())
        out["bits"][tag] = h.hexdigest()[:16]

    scenes = {"256x128": (dict(res=(256, 128), D=16.0, Re=500.0, cylinder_center=(64.0, 128.0)),
                          dict(tile_rows=16, interior_rows=32)),
              "2048x2048": (C.CYL_MAIN, {})}
    for scene, (ckw, rkw) in scenes.items():
        cfg = CY.CylinderConfig(**ckw)
        c = K.consts(cfg)
        s, fl = CY.init(cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(1234)
        s = {k: v + 1e-3 * torch.randn(v.shape, generator=gen, device=dev) for k, v in s.items()}
        flags, phi = fl["flags"], fl["phi_obs"]
        run = K.make_fused_cylinder_runner(cfg, **rkw)
        interior, band, edge = run.step4.rows
        int1, band1 = run.step.rows
        for mode in (False, True, "sr"):
            st = dict(s, f=K.f_to_storage(s["f"], mode))
            m = (mode, (7, 9) if mode == "sr" else None)
            calls = {"cyl_full": lambda o: K.cyl_full(st["f"], st["rho"], st["vel"], flags, phi,
                                                      o, band1, c, *m),
                     "cyl_interior": lambda o: K.cyl_interior(st["f"], o, int1, c, True, *m)}
            for k in (1, 2, 4):
                calls[f"cyl_interior_k k={k}"] = (
                    lambda o, k=k: K.cyl_interior_k(st["f"], o, interior, k, c, False, *m))
                for e, segs in ((False, band), (True, edge)):
                    calls[f"cyl_band_k k={k} {'edge' if e else 'cyl'}"] = (
                        lambda o, k=k, e=e, segs=segs: K.cyl_band_k(
                            st["f"], st["vel"], flags, phi, o, segs, k, e, c, *m))
            for tag, call in calls.items():
                o = {n: v.clone() for n, v in st.items()}
                call(o)
                digest(f"{scene} {mode} {tag}", o.values())
            routes = [("own route", {})] + ([("launches", {"route": "launches"})]
                                            if has_route else [])
            for rlabel, extra in routes:
                r = K.make_fused_cylinder_runner(cfg, bf16_dev=mode, seed=5, **rkw, **extra)
                digest(f"{scene} {mode} runner 23 steps, {rlabel}", r(st, fl, 23).values())
        torch.cuda.synchronize()
    cfg = CY.CylinderConfig(**C.CYL_MAIN)
    s, fl = CY.init(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(99)
    s = {k: v + 1e-3 * torch.randn(v.shape, generator=gen, device=dev) for k, v in s.items()}
    for shape, tag, kw in (((2, 2), "lean k=4", dict(lean_k=4, lean_x_ext=128, lean_x_halo=8)),
                           ((2, 2), "PIECES", dict(lean_split=False, tile_rows=64)),
                           ((4, 1), "lean k=1", {}), ((1, 1), "lean k=1", {})):
        mesh = make_mesh(shape, [dev] * (shape[0] * shape[1]))
        r = CS.make_sharded_fused_cylinder_runner(cfg, mesh, **kw)
        digest(f"sharded {shape} {tag} 12 steps", r(s, fl, 12).values())
        if has_sh_route and tag != "PIECES":
            r = CS.make_sharded_fused_cylinder_runner(cfg, mesh, route="launches", **kw)
            digest(f"sharded {shape} {tag} 12 steps, launches", r(s, fl, 12).values())
    print(f"{len(out['bits'])} digests", flush=True)

    s0, fl = CY.init(cfg, dev)
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
        print(f"{mode}: {out[mode]}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
