#!/usr/bin/env python3
"""What sets the time of the k = 1 tile-class kernels (`fluid_k`,
`fluid_k_lean`) on one card, at the 1024x512 grid of the refine-8
ethaline case (``JRLFluidConfig(shape="ethaline", refine=8)``):

    python3 tools/tile_pass_probe.py

On the split-pass plans of step 0 (full rows [(0,384),(960,1024)], lean
[(384,960)]) and step 825,712,484 (full [(0,640),(960,1024)], lean
[(640,960)]), device µs per launch of each kernel and of the pair back
to back (CUDA events over 200 launches, best of three), for four builds
of the same sources:

- (a) as shipped;
- (b) with ``-prec-div=false`` (approximate division, no branch to a slow
  path): what the IEEE divisions of the cell code cost; a diagnosis, not
  a kernel of the port (its results differ; the largest difference from
  (a) is printed);
- (c) at one block an SM (the launch asks for 116 KB of shared memory);
- (d) the window loaded and the tile written back, no cell code: what
  the tile structure's memory traffic costs alone.

Then `fluid_pass` as shipped: a block's cost per row of each class (all
1024 rows full, rows 64..960 lean, runs of 4 to 32 rows) and the two
plans with the lean rows' cost weight (`jrl_tiled.PASS_LEAN_COST`) swept.

Prints each build's registers and spills, then one JSON line, last.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"a shipped": [], "b -prec-div=false": ["-prec-div=false"],
            "c one block an SM": ["-DJRL_TILE_ONE_BLOCK_PER_SM"],
            "d load and store only": ["-DJRL_TILE_NO_CELLS"]}
PLAN_STEPS = (0, 825_712_484)


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as C
    from jrl_lbm_torch.kernels import build
    from jrl_lbm_torch.kernels import jrl_tiled as JT
    from jrl_lbm_torch.kernels.jrl_fluid import _P, stream_of
    from jrl_lbm_torch.models import jrl as T

    if not torch.cuda.is_available():
        print("tile_pass_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    names = ("fluid_k", "fluid_k_lean")
    build.build_all(("fluid_pass",))
    tmp = tempfile.mkdtemp(dir=build.BUILD_DIR)
    libs, regs = {}, {}
    procs = {}
    for label, flags in VARIANTS.items():
        for k in names:
            out = os.path.join(tmp, f"{k}-{label[0]}.so")
            procs[label, k] = (out, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", out,
                 str(build.CSRC / f"{k}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    for (label, k), (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {label} {k}:\n{log}")
        libs.setdefault(label, {})[k] = ctypes.CDLL(out)
        regs[f"{label} {k}"] = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln]
        print(f"{label} {k}: {'; '.join(regs[f'{label} {k}'])}", flush=True)

    def fn(label, k):
        f = getattr(libs[label][k], f"jrl_{k}")
        f.restype = ctypes.c_int
        f.argtypes = [_P] * 6 + [ctypes.c_int] * 2 + [_P, _P] if k == "fluid_k" \
            else [_P] * 4 + [ctypes.c_int, _P, _P]
        return f

    def us_per_launch(call, n=200):
        best = float("inf")
        call()
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            for _ in range(n):
                call()
            b.record()
            torch.cuda.synchronize()
            best = min(best, a.elapsed_time(b) * 1e3 / n)
        return best

    cfg = T.JRLFluidConfig(shape="ethaline", refine=8)
    H, W = cfg.eff_res
    TH = JT.pick_tile_rows(cfg)
    s, _ = T.fluid_init(cfg, dev)
    s = C.noisy(s, dev, 3)
    report = {"device": C.smi_line(), "grid": [H, W], "registers": regs}
    for step in PLAN_STEPS:
        kind, _, _, fr, fb = JT.chunk_plan(cfg, step, 8)[0]
        full, bt, lean = JT.class_rows(H, TH, 1, fr, fb)
        if kind != "split" or bt or not lean:
            raise RuntimeError(f"step {step}: no full + lean split ({kind}, {fr}, {fb})")
        outs = {lab: {key: torch.empty_like(v) for key, v in s.items()} for lab in VARIANTS}
        stream = stream_of(dev)
        pf, pl = JT._params(cfg, tuple(full)), JT._params(cfg, tuple(lean))
        rec = {"full": full, "lean": lean}

        def calls(label):
            o = outs[label]
            fk, fl = fn(label, "fluid_k"), fn(label, "fluid_k_lean")
            ptrs = [t.data_ptr() for t in (s["f"], s["rho"], s["vel"], o["f"], o["rho"], o["vel"])]

            def full_():
                build.check(fk(*ptrs, step, 1, ctypes.byref(pf), stream), "fluid_k")

            def lean_():
                build.check(fl(ptrs[0], *ptrs[3:], 1, ctypes.byref(pl), stream), "fluid_k_lean")

            return full_, lean_

        for label in VARIANTS:
            full_, lean_ = calls(label)
            rec[label] = {"fluid_k": us_per_launch(full_), "fluid_k_lean": us_per_launch(lean_),
                          "pair": us_per_launch(lambda: (full_(), lean_()))}
        want = outs["a shipped"]
        for label in ("b -prec-div=false",):
            rec[f"{label} max |diff| from a"] = max(
                float((outs[label][k] - want[k]).abs().max()) for k in want)
        report[f"step {step}"] = rec
        print(f"step {step}: {rec}", flush=True)

    fp = build.bind("fluid_pass", "jrl_fluid_pass", [_P] * 6 + [ctypes.c_int, _P, _P])
    o = outs["a shipped"]
    ptrs = [t.data_ptr() for t in (s["f"], s["rho"], s["vel"], o["f"], o["rho"], o["vel"])]

    def pass_us(full, lean, step, sms, lean_cost):
        p = JT._pass_params(cfg, tuple(full), tuple(lean), sms, lean_cost)
        rows = max(((c >> 15) & 0x7FFF) - (c & 0x7FFF) for c in p.run[:p.nruns])
        t = us_per_launch(lambda: build.check(fp(*ptrs, step, ctypes.byref(p), stream_of(dev)),
                                              "fluid_pass"))
        return t, rows, p.nruns

    rec = {}
    for label, full, lean in (("full", [(0, H)], []), ("lean", [], [(64, H - 64)])):
        for sms in (264, 132, 66, 33):
            t, rows, runs = pass_us(full, lean, 0, sms, 1.0)
            rec[f"{label} rows a run {rows} ({runs} runs)"] = t
    for step in PLAN_STEPS:
        full, _, lean = JT.class_rows(H, TH, 1, *JT.chunk_plan(cfg, step, 8)[0][3:])
        for w in (1.0, 0.7, 0.6, 0.5, 0.4, 0.3):
            rec[f"step {step} lean cost {w}"] = pass_us(full, lean, step, JT.sm_count(dev), w)[0]
    report["fluid_pass"] = rec
    print(f"fluid_pass: {rec}", flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
