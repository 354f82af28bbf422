#!/usr/bin/env python3
"""What sets the time of the C approach's kernels on one card:

    python3 tools/approach_probe.py

1. `c_approach_pass` at 1024x512 on two plans: step 0 of the refine-8
   ethaline grid at Pe 5 (`chip_smoke.py`'s main path) and step
   10,170,450 of the default refine-8 case (a two-frame window of its
   history), device µs per launch (CUDA events over 200 launches, best of
   three), for four builds of the same source:

   - (a) as shipped (1024 threads a block, two rows at once, one block an
     SM, runs of 8 rows, 64 registers);
   - (b) 512 threads a block (the first design: a row at a time);
   - (c) 768 threads a block;
   - (d) two blocks of 512 threads an SM (runs of 3 rows, 64 registers);
   - (e) ``-prec-div=false`` (approximate division): what the cell code's
     IEEE divisions cost;
   - (f) no cells (``-DJRL_CP_NO_CELLS``): the row copies, the geometry
     and the integrals' tail alone;
   - (g) no integrals (``-DJRL_CP_NO_DISK``): the tail's share.

   (b), (c) and (d) must equal (a) bit for bit; (e)-(g) are diagnoses, not
   kernels of the port (their results differ; the largest difference from
   (a) is printed). Beside them, on the same
   states: the `c_approach` pair alone and PyTorch's frame lerp alone.
2. The host µs of an approach step: the ctypes call alone with its
   arguments made once, `c_approach_pass` on a run's checked context (as
   the runner calls it), and checked.
3. `fused_approach_cl` against `fused_approach` at 128x64 (the default
   case), one 1000-step launch, best of three; and `fused_approach_cl`
   built with ``-prec-div=false`` (a diagnosis, as (e)).

Prints each build's registers and spills, then one JSON line, last.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"a shipped": [], "b 512 threads": ["-DJRL_CP_THREADS=512"],
            "c 768 threads": ["-DJRL_CP_THREADS=768"],
            "d two blocks of 512 an SM": ["-DJRL_CP_THREADS=512", "-DJRL_CP_BLOCKS_PER_SM=2"],
            "e -prec-div=false": ["-prec-div=false"],
            "f no cells": ["-DJRL_CP_NO_CELLS"], "g no integrals": ["-DJRL_CP_NO_DISK"]}
SAME_BITS = ("b 512 threads", "c 768 threads", "d two blocks of 512 an SM")


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    from jrl_lbm_torch.kernels import build
    from jrl_lbm_torch.kernels import fused_jrl as F
    from jrl_lbm_torch.kernels import jrl_c
    from jrl_lbm_torch.kernels.jrl_fluid import _P, stream_of
    from jrl_lbm_torch.models import jrl as T

    if not torch.cuda.is_available():
        print("approach_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    build.build_all(("c_approach_pass", "c_approach", "fused_approach", "fused_approach_cl"))
    tmp = tempfile.mkdtemp(dir=build.BUILD_DIR)
    libs, regs, procs = {}, {}, {}
    for label, flags in VARIANTS.items():
        out = os.path.join(tmp, f"c_approach_pass-{label[0]}.so")
        procs[label] = (out, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", out,
             str(build.CSRC / "c_approach_pass.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    cl_out = os.path.join(tmp, "fused_approach_cl-e.so")
    procs["cluster -prec-div=false"] = (cl_out, subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-prec-div=false", "-o", cl_out,
         str(build.CSRC / "fused_approach_cl.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
    for label, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {label}:\n{log}")
        libs[label] = ctypes.CDLL(out)
        regs[label] = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
        print(f"{label}: {'; '.join(regs[label])}", flush=True)
    cl_lib = libs.pop("cluster -prec-div=false")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    report = {"device": torch.cuda.get_device_name(0), "registers": regs, "pass": {}}

    def events_us(fn, n, best_of=3):
        fn()
        best = None
        for _ in range(best_of):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            for _ in range(n):
                fn()
            b.record()
            torch.cuda.synchronize()
            us = a.elapsed_time(b) * 1e3 / n
            best = us if best is None else min(best, us)
        return best

    def noisy(st, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return {k: v + 1e-3 * torch.randn(v.shape, generator=g, device=dev) for k, v in st.items()}

    main_cfg = T.JRLCConfig(res=(128, 64), Re=4.0, Pe=5.0, vel_obs_real=0.2848,
                            shape="ethaline", refine=8)
    c8 = T.JRLCConfig(shape="ethaline", refine=8)
    n_fr8 = T.frame_pair(c8.total_steps - 1, c8.vel_obs_conv, 2**31)[0] + 1
    mid = 10_170_450
    b8 = T.frame_pair(mid, c8.vel_obs_conv, n_fr8)[0]
    H, W = c8.eff_res
    gen = torch.Generator(device=dev).manual_seed(5)
    plans = {
        "step 0": (main_cfg, 0, 0, 3, 0.5 * torch.randn((3, 2, H, W), generator=gen, device=dev)),
        "step 10,170,450": (c8, mid, b8, n_fr8,
                            0.5 * torch.randn((2, 2, H, W), generator=gen, device=dev)),
    }
    for pname, (cfg, step, b0, n_frames, frames) in plans.items():
        st, fields, _ = T.c_init(cfg, dev)
        st = noisy(st, 7)
        h = st["h"]
        acc = torch.zeros(4, device=dev)
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        outs, rec = {}, {}
        for label, lib in libs.items():
            lim = [ctypes.c_int(0) for _ in range(3)]
            lib.jrl_c_approach_pass_limits.argtypes = [_P] * 3
            build.check(lib.jrl_c_approach_pass_limits(*(ctypes.byref(x) for x in lim)),
                        "c_approach_pass")
            smem, threads, per_sm = (x.value for x in lim)
            blocks, wrows, _ = jrl_c.approach_pass_plan(H, W, sms, smem, per_sm)
            params = jrl_c.CPassParams(a=jrl_c._approach_params(cfg), nruns=blocks, wrows=wrows,
                                       n_frames=n_frames, b0=b0)
            fn = lib.jrl_c_approach_pass
            fn.argtypes = [_P] * 8 + [ctypes.c_int, _P, _P]
            fn.restype = ctypes.c_int
            o = (torch.empty_like(h), torch.empty_like(st["C"]))
            args = (fields["base_flags"].data_ptr(), h.data_ptr(), frames.data_ptr(),
                    fields["area"].data_ptr(), o[0].data_ptr(), o[1].data_ptr(), acc.data_ptr(),
                    ticket.data_ptr(), step, ctypes.byref(params), stream_of(dev))

            def call(fn=fn, args=args):
                build.check(fn(*args), "c_approach_pass")

            acc.zero_()
            call()
            torch.cuda.synchronize()
            outs[label] = [o[0].clone(), o[1].clone(), acc.clone()]
            rec[label] = {"us": events_us(call, 200), "threads": threads,
                          "blocks_per_sm": per_sm, "blocks": blocks, "run_rows": wrows - 2}
            if label != "a shipped":
                ref = outs["a shipped"]
                rec[label]["bit_for_bit"] = all(torch.equal(x, y)
                                                for x, y in zip(outs[label], ref))
                rec[label]["max_diff"] = max(float((x - y).abs().max())
                                             for x, y in zip(outs[label][:2], ref[:2]))
            print(f"  {pname} {label}: {rec[label]}", flush=True)
        vel = T.stored_velocity(frames, step, cfg.vel_obs_conv, b0, n_frames)
        rec["pair alone"] = {"us": events_us(
            lambda: jrl_c.c_approach(h, st["C"], vel, step, cfg, fields, acc), 200)}
        rec["lerp alone"] = {"us": events_us(
            lambda: T.stored_velocity(frames, step, cfg.vel_obs_conv, b0, n_frames), 200)}
        print(f"  {pname} pair alone {rec['pair alone']}, lerp alone {rec['lerp alone']}",
              flush=True)
        report["pass"][pname] = rec
        for label in SAME_BITS:
            if not rec[label]["bit_for_bit"]:
                print(f"approach_probe FAILED: {label} differs from the shipped build",
                      flush=True)
                return 1

    # host µs a step
    cfg, step, b0, n_frames, frames = plans["step 0"]
    st, fields, _ = T.c_init(cfg, dev)
    h = st["h"]
    acc = torch.zeros(4, device=dev)
    bufs = [(torch.empty_like(h), torch.empty_like(st["C"])) for _ in range(2)]
    ctx = jrl_c.approach_pass_ctx(h, bufs, frames, 0, 1, cfg, fields, acc)
    fn = build.bind("c_approach_pass", "jrl_c_approach_pass", [_P] * 8 + [ctypes.c_int, _P, _P])
    args = (fields["base_flags"].data_ptr(), h.data_ptr(), frames.data_ptr(),
            fields["area"].data_ptr(), bufs[0][0].data_ptr(), bufs[0][1].data_ptr(),
            acc.data_ptr(), ctx.ticket.data_ptr(), 0, ctypes.byref(ctx.params), ctx.stream)
    host = {}
    for label, call in (
            ("ctypes call alone", lambda: fn(*args)),
            ("wrapper on the run's context", lambda: jrl_c.c_approach_pass(
                h, frames, 0, cfg, fields, acc, out=bufs[0], ctx=ctx)),
            ("wrapper, checked", lambda: jrl_c.c_approach_pass(h, frames, 0, cfg, fields, acc,
                                                               out=bufs[0]))):
        with torch.cuda.device(dev):
            call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                call()
            host[label] = (time.perf_counter() - t0) / 50 * 1e6
            torch.cuda.synchronize()
    report["host_us"] = host
    print(f"  host us a step: {host}", flush=True)

    # the cluster kernel against the cooperative one at 128x64
    cc = T.JRLCConfig()
    st, cf, _ = T.c_init(cc, dev)
    st = noisy(st, 9)
    vf = 0.5 * torch.randn((4, 2) + cc.eff_res, generator=gen, device=dev)
    acc = torch.zeros(4, device=dev)
    cl = {r: events_us(lambda r=r: F.fused_approach(st["h"], st["C"], vf, 0, 1000, cc, cf, acc,
                                                    route=r), 1) / 1000
          for r in ("cluster", "coop")}
    cluster, cpt, smem = F._cluster_shape("fused_approach", cc, dev)
    fnc = cl_lib.jrl_fused_approach_cl
    fnc.argtypes = [_P, _P, ctypes.c_int] + [_P] * 5 + [ctypes.c_int] * 2 + [_P] \
        + [ctypes.c_int] * 3 + [_P]
    fnc.restype = ctypes.c_int
    o = (torch.empty_like(st["h"]), torch.empty_like(st["C"]))

    def approx():
        build.check(fnc(cf["base_flags"].data_ptr(), vf.data_ptr(), 4, cf["area"].data_ptr(),
                        st["h"].data_ptr(), o[0].data_ptr(), o[1].data_ptr(), acc.data_ptr(), 0,
                        1000, ctypes.byref(jrl_c._approach_params(cc)), cluster, cpt, smem,
                        stream_of(dev)), "fused_approach_cl")

    cl["cluster -prec-div=false"] = events_us(approx, 1) / 1000
    cl["registers"] = F.cluster_info("fused_approach", 1, 0)
    report["fused_approach_cl_us_per_step"] = cl
    print(f"  128x64 us/step: {cl}", flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
