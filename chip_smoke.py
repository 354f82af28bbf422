#!/usr/bin/env python3
"""Drive the PyTorch port's JRL main path on one NVIDIA card and check it.

    python3 chip_smoke.py

1. Builds the four CUDA kernels of ``jrl_lbm_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together).
2. Holds each kernel to its plain PyTorch twin from the same state, after
   1 step (f, rho, C, h at 1e-5; vel at 1e-4) and after 100 steps (2e-5;
   vel 2e-4; integrals rtol 2e-4 / atol 1e-4), on the refine-8 ethaline
   grid (1024x512) and on the flat-tip cylinder at 128x64.
3. Runs the main path at 1024x512 through the ``pick_*`` runners: 1000
   fluid steps, 1000 balance steps, 1000 approach steps on a 3-frame
   stored velocity from the fluid run; each phase's launch counts are
   zeroed just before it and read just after, and every kernel of the
   phase must have launched. Times the phases, each kernel per launch
   (beside its memory bound) and each twin per call, with CUDA events.
4. Runs one whole case through ``jrl_main.run_case`` at 128x64 and checks
   that the record rows are finite and positive.
5. Prints ``{"kernels": [...]}``, the card's name and power limit, and
   last ``{"ok": true, "device": {...}}``.

Exits non-zero on any failure, and without printing a result when no
card is present or the package is missing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))

# Least time for the bytes each kernel must move: each input read once,
# each output written once, at the card's memory rate. Rates from NVIDIA's
# data sheets; an unlisted card falls back to the H100 SXM figure.
MEM_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}
MEM_RATE_DEFAULT = 3.35e12  # H100 SXM (HBM3)
F32_PEAK = 67e12  # H100 SXM float32 outside the tensor cores
# float32 operations per cell away from the tip, counted by hand from the
# kernel sources (geometry at the neighbours, sums, equilibrium and
# collision; the cells next to the tip do more, but they are a few
# hundred of 524288). The operation bound stays far under the memory one.
FLOPS_PER_CELL = {"fluid_a": 250, "fluid_b": 400, "c_balance": 230, "c_approach": 330}
SOURCE = {
    "fluid_a": ("jrl_lbm_torch/kernels/csrc/fluid_a.cu",
                "jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py:506"),
    "fluid_b": ("jrl_lbm_torch/kernels/csrc/fluid_b.cu",
                "jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py:598"),
    "c_balance": ("jrl_lbm_torch/kernels/csrc/c_balance.cu",
                  "jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py:1897"),
    "c_approach": ("jrl_lbm_torch/kernels/csrc/c_approach.cu",
                   "jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py:1998"),
}


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check_close(name, got, want, tol, report):
    import torch

    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    report.append(err)
    print(f"  {name:28s} max|kernel - twin| = {err:.3e} (|twin| max {scale:.3e}, tol {tol:g})",
          flush=True)
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output not finite")
    if err > tol * (1.0 + scale):
        fail(f"{name}: deviation {err:.3e} above {tol:g} (scaled by 1 + |twin|)")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, n: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` over ``n`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


KERNEL_FUNCS = {  # CUDA functions each wrapper launches
    "fluid_a": ("fluid_a_kernel",),
    "fluid_b": ("fluid_b_kernel",),
    "c_balance": ("c_balance_kernel",),
    "c_approach": ("c_approach_kernel", "c_disk_kernel"),
}


def device_profile(fn, steps: int):
    """``(device µs by kernel name, wall s)`` of ``fn(steps)`` from a
    torch.profiler trace of the card; ``({}, wall)`` if the trace holds no
    device time (the profiler is a measurement, not a phase: the run
    itself must not depend on it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        times = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            events = prof.events()
        for ev in events:
            if ev.device_type == DeviceType.CUDA:
                times[ev.name] = times.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    except (RuntimeError, AttributeError) as e:
        print(f"  profiler gave no device times ({e!r})", flush=True)
        return {}, None
    return times, wall


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from jrl_lbm_torch import jrl_main, kernels
    from jrl_lbm_torch.kernels import build, jrl_c, jrl_fluid
    from jrl_lbm_torch.models import jrl as T

    dev = torch.device("cuda")
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)
    t_build = build.build_all()
    print(f"built {len(build.NAMES)} kernels in {t_build:.1f} s", flush=True)
    for k, log in build.build_log.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {k}: {'; '.join(regs)}", flush=True)
    rate = next((r for key, r in MEM_RATE.items() if key in name), MEM_RATE_DEFAULT)

    errs = {k: [] for k in kernels.KERNELS}

    # ---- 1. each kernel against its twin ----
    def fluid_cfg(shape, refine):
        return T.JRLFluidConfig(res=(128, 64), Re=4.0, vel_obs_real=0.2848,
                                gravity_strength_real=-9.8, shape=shape, refine=refine)

    def c_cfg(shape, refine):
        return T.JRLCConfig(res=(128, 64), Re=4.0, Pe=5.0, vel_obs_real=0.2848,
                            shape=shape, refine=refine)

    cases = (("ethaline", 8), ("cylinder", 1))
    frames = {}
    for shape, refine in cases:
        fc, cc = fluid_cfg(shape, refine), c_cfg(shape, refine)
        H, W = fc.eff_res
        print(f"compare kernels with twins: {shape} {H}x{W}", flush=True)
        s, fl = T.fluid_init(fc, dev)
        s = T.make_fluid_runner(fc)(s, fl, 0, 20)
        k0 = 20
        a = jrl_fluid.fluid_a(s["f"], s["rho"], s["vel"], k0, fc, fl)
        ar = jrl_fluid.fluid_a_ref(s["f"], s["rho"], s["vel"], k0, fc, fl)
        for nm, g, w, tol in zip(("f", "rho", "vel"), a, ar, (1e-5, 1e-5, 1e-4)):
            check_close(f"fluid_a 1 step {nm}", g, w, tol, errs["fluid_a"])
        b = jrl_fluid.fluid_b(*ar, k0, fc, fl)
        br = jrl_fluid.fluid_b_ref(*ar, k0, fc, fl)
        check_close("fluid_b 1 step f", b, br, 1e-5, errs["fluid_b"])
        sk = T.pick_fluid_runner(fc)(s, fl, k0, 100)
        sr = T.make_fluid_runner(fc)(s, fl, k0, 100)
        for nm, tol in (("f", 2e-5), ("rho", 2e-5), ("vel", 2e-4)):
            check_close(f"fluid 100 steps {nm}", sk[nm], sr[nm], tol, errs["fluid_a"])
        # three stored frames from the fluid run, normalized as the
        # snapshots of run_fluid_phase
        frames[shape] = torch.stack([s["vel"], sr["vel"], sk["vel"]]) / fc.vel_obs

        st, cf, flags = T.c_init(cc, dev)
        st = T.make_balance_runner(cc, flags)(st, cf, 20)
        h, C = jrl_c.c_balance(st["h"], st["C"], flags, cc, cf)
        hr, Cr = jrl_c.c_balance_ref(st["h"], st["C"], flags, cc, cf)
        check_close("c_balance 1 step h", h, hr, 1e-5, errs["c_balance"])
        check_close("c_balance 1 step C", C, Cr, 1e-5, errs["c_balance"])
        bk = T.pick_balance_runner(cc, flags)(st, cf, 100)
        br_ = T.make_balance_runner(cc, flags)(st, cf, 100)
        check_close("c_balance 100 steps h", bk["h"], br_["h"], 2e-5, errs["c_balance"])
        check_close("c_balance 100 steps C", bk["C"], br_["C"], 2e-5, errs["c_balance"])

        vf = frames[shape]
        vel = T.stored_velocity(vf, 5, cc.vel_obs_conv)
        acc = torch.zeros(4, device=dev)
        h, C = jrl_c.c_approach(bk["h"], bk["C"], vel, 5, cc, cf, acc)
        hr, Cr, ints = jrl_c.c_approach_ref(bk["h"], bk["C"], vel, 5, cc, cf)
        check_close("c_approach 1 step h", h, hr, 1e-5, errs["c_approach"])
        check_close("c_approach 1 step C", C, Cr, 1e-5, errs["c_approach"])
        check_close("c_approach 1 step integrals", acc,
                    torch.stack([ints[0], ints[1], ints[2], ints[3]]), 1e-4, [])
        ak, acc_k = T.pick_approach_runner(cc, vf)(bk, cf, 0, 100)
        ar_, acc_r = T.make_approach_runner(cc)(bk, dict(cf, vel_field=vf), 0, 100)
        check_close("c_approach 100 steps h", ak["h"], ar_["h"], 2e-5, errs["c_approach"])
        check_close("c_approach 100 steps C", ak["C"], ar_["C"], 2e-5, errs["c_approach"])
        for key in ("inflow_sum", "current_sum", "rec_u", "rec_v"):
            g, w = float(acc_k[key]), float(acc_r[key])
            print(f"  c_approach 100 steps {key:12s} kernel {g:.7g} twin {w:.7g}", flush=True)
            if not abs(g - w) <= 1e-4 + 2e-4 * abs(w):
                fail(f"c_approach {key}: {g} vs {w}")

    # ---- 2. the main path at 1024x512, through the kernels ----
    fc, cc = fluid_cfg("ethaline", 8), c_cfg("ethaline", 8)
    H, W = fc.eff_res
    cells = H * W
    n = 1000
    phases = {}
    print(f"main path {H}x{W}: {n} steps per phase", flush=True)

    def run_phase(pname, kernel_names, fn):
        fn(10)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(n)
        end.record()
        torch.cuda.synchronize()
        counts = kernels.launches()
        ms = start.elapsed_time(end)
        phases[pname] = {"ms_per_step": ms / n, "mlups": cells * n / (ms * 1e3),
                         "launches": {k: counts[k] for k in kernel_names}}
        print(f"  {pname:9s} {ms / n:.4f} ms/step  {cells * n / (ms * 1e3):.1f} MLUPS  "
              f"launches {counts}", flush=True)
        for k in kernel_names:
            if counts[k] < n:
                fail(f"{pname}: kernel {k} launched {counts[k]} times, expected {n}")
        # device time by kernel over a further profiled window
        n_prof = 200
        times, wall = device_profile(fn, n_prof)
        busy = sum(times.values())
        per_kernel = {}
        for k in kernel_names:
            us = sum(t for nm, t in times.items() if any(f in nm for f in KERNEL_FUNCS[k]))
            per_kernel[k] = us / n_prof if us > 0 else None
        if wall:
            phases[pname].update({
                "device_us_per_step": busy / n_prof,
                "wall_us_per_step_profiled": wall * 1e6 / n_prof,
                "idle_share": 1.0 - busy / (wall * 1e6),
                "kernel_us_per_launch": per_kernel,
                "device_us_per_step_by_function": {nm: t / n_prof for nm, t in times.items()},
            })
            print(f"    profiled {n_prof} steps: device busy {busy / n_prof:.1f} us/step of "
                  f"{wall * 1e6 / n_prof:.1f} us wall (idle {1 - busy / (wall * 1e6):.1%}); "
                  f"per launch {per_kernel}", flush=True)
            for nm, t in sorted(times.items(), key=lambda kv: -kv[1]):
                print(f"      {t / n_prof:8.2f} us/step  {nm[:90]}", flush=True)
        return out

    s, fl = T.fluid_init(fc, dev)
    fluid_run = T.pick_fluid_runner(fc)
    fstate = {"s": s, "cur": 0}

    def fluid_steps(k):
        fstate["s"] = fluid_run(fstate["s"], fl, fstate["cur"], k)
        fstate["cur"] += k
        return fstate["s"]

    sf = run_phase("fluid", ("fluid_a", "fluid_b"), fluid_steps)
    if not all(torch.isfinite(v).all() for v in sf.values()):
        fail("fluid state not finite")
    vel_field = torch.stack([s["vel"], sf["vel"], sf["vel"]]) / fc.vel_obs

    st, cf, flags = T.c_init(cc, dev)
    bal_run = T.pick_balance_runner(cc, flags)
    bstate = {"s": st}

    def balance_steps(k):
        bstate["s"] = bal_run(bstate["s"], cf, k)
        return bstate["s"]

    sb = run_phase("balance", ("c_balance",), balance_steps)
    app_run = T.pick_approach_runner(cc, vel_field)
    astate = {"s": sb, "acc": None, "cur": 0}

    def approach_steps(k):
        astate["s"], astate["acc"] = app_run(astate["s"], cf, astate["cur"], k)
        astate["cur"] += k
        return astate["s"]

    sa = run_phase("approach", ("c_approach",), approach_steps)
    acc = astate["acc"]
    print(f"  approach integrals: inflow_sum {float(acc['inflow_sum']):.6g} "
          f"current_sum {float(acc['current_sum']):.6g}", flush=True)
    if not (torch.isfinite(sa["C"]).all() and float(acc["inflow_sum"]) > 0):
        fail("approach state not finite or inflow not positive")

    # ---- 3. each kernel alone, and its twin, at 1024x512 ----
    s, fl = T.fluid_init(fc, dev)
    f, rho, vel = s["f"], s["rho"], s["vel"]
    a_out = jrl_fluid.fluid_a(f, rho, vel, 0, fc, fl)
    st, cf, flags = T.c_init(cc, dev)
    vel_c = T.stored_velocity(vel_field, 0, cc.vel_obs_conv)
    acc0 = torch.zeros(4, device=dev)
    runs = {
        "fluid_a": (lambda: jrl_fluid.fluid_a(f, rho, vel, 0, fc, fl),
                    lambda: jrl_fluid.fluid_a_ref(f, rho, vel, 0, fc, fl),
                    [f, rho, vel], list(a_out)),
        "fluid_b": (lambda: jrl_fluid.fluid_b(*a_out, 0, fc, fl),
                    lambda: jrl_fluid.fluid_b_ref(*a_out, 0, fc, fl),
                    list(a_out), [f]),
        "c_balance": (lambda: jrl_c.c_balance(st["h"], st["C"], flags, cc, cf),
                      lambda: jrl_c.c_balance_ref(st["h"], st["C"], flags, cc, cf),
                      [flags, st["h"], st["C"]], [st["h"], st["C"]]),
        "c_approach": (lambda: jrl_c.c_approach(st["h"], st["C"], vel_c, 0, cc, cf, acc0),
                       lambda: jrl_c.c_approach_ref(st["h"], st["C"], vel_c, 0, cc, cf),
                       [cf["base_flags"], st["h"], vel_c, cf["area"], acc0],
                       [st["h"], st["C"], acc0]),
    }
    rows = []
    print(f"per launch at {H}x{W} (memory rate {rate / 1e12:.2f} TB/s):", flush=True)
    for k in kernels.KERNELS:
        kfn, tfn, ins, outs = runs[k]
        call_ms = cuda_ms(kfn, 200)
        # the kernel's device time on the main path (profiler), else the
        # event time of back-to-back wrapper calls (host time included)
        dev_us = next((p["kernel_us_per_launch"][k] for p in phases.values()
                       if p.get("kernel_us_per_launch", {}).get(k)), None)
        ms = dev_us / 1e3 if dev_us else call_ms
        plain_ms = cuda_ms(tfn, 5, warmup=1)
        nbytes = sum(t.numel() * t.element_size() for t in ins + outs)
        mem_ms = nbytes / rate * 1e3
        ops_ms = FLOPS_PER_CELL[k] * cells / F32_PEAK * 1e3
        bound_ms = max(mem_ms, ops_ms)
        print(f"  {k:10s} device {ms * 1e3:8.2f} us  bound {bound_ms * 1e3:6.2f} us "
              f"({nbytes / 1e6:.1f} MB, {bound_ms / ms * 100:5.1f}% of bound)  "
              f"wrapper call {call_ms * 1e3:7.2f} us  twin {plain_ms:.3f} ms", flush=True)
        phases.setdefault("per_launch", {})[k] = {
            "device_ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bytes": nbytes, "device_time_from": "profiler" if dev_us else "events"}
        src, rep = SOURCE[k]
        launches = sum(p["launches"].get(k, 0) for p in phases.values() if "launches" in p)
        rows.append({
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches, "max_abs_err": max(errs[k]) if errs[k] else None,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if mem_ms >= ops_ms else "operations",
            "library_ms": None,
        })

    # ---- 4. one whole case at 128x64 ----
    fcase = T.JRLFluidConfig(res=(128, 64), Re=4.0, vel_obs_real=0.2848,
                             gravity_strength_real=0.0, shape="45degree")
    ccase = T.JRLCConfig(res=(128, 64), balance_time=0.01, Re=4.0, Pe=5.0,
                         vel_obs_real=0.2848, gravity_strength_real=0.0, shape="45degree")
    t0 = time.perf_counter()
    res = jrl_main.run_case(fcase, ccase, device=dev)
    torch.cuda.synchronize()
    print(f"whole case 128x64: {fcase.total_steps} fluid + {ccase.balance_steps} balance + "
          f"{ccase.total_steps} approach steps in {time.perf_counter() - t0:.1f} s, "
          f"{len(res.record_rows)} records", flush=True)
    if not res.record_rows:
        fail("the case wrote no record rows")
    print(f"  first record {res.record_rows[0]}", flush=True)
    print(f"  last record  {res.record_rows[-1]}", flush=True)
    for row in res.record_rows:
        if not all(v == v and abs(v) != float("inf") for v in row) or row[1] <= 0 or row[2] <= 0:
            fail(f"record row not finite and positive: {row}")

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as fo:
        json.dump({"device": smi, "torch": torch.__version__, "build_s": t_build,
                   "phases": phases, "kernels": rows, "build_log": build.build_log}, fo,
                  indent=1)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
