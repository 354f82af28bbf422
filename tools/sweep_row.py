#!/usr/bin/env python3
"""Whole cases of the water study on the card, held to the committed
records of the JAX package's runs.

    python3 tools/sweep_row.py [A] [B] [--out chiprun_out/sweep_row] [--no-serial]

A. The water Re 1e-2 row at 128x64 through `jrl_lbm_torch.batch_pe.
   run_re_row`: the fluid phase (335,400 steps), the shared balance for
   the 60,645,312 steps of the case that seeded the committed sweep's
   ``C_balance.h5`` (`validation/run_batch_pe.py:30-45`: Re 7e-5, Pe 1e-3;
   every water case has tau_D = 1, so the balance map is the same; the
   row's own count would be 8.7e9 steps), then the seven Pe lanes in one
   launch (`parallel/sweep.py`). Then the same lanes through the serial
   route (`fused_approach_cl` lane after lane), timed, their records bit
   for bit the lanes'. Gates: each record has the committed record's rows
   (`validation/sweep_out/_45degree_g9/records/record_res64_Re0.01_Pe*.txt`),
   its normalised current (`demo/plot_utils.py::load_approach_curve`)
   within 0.01 max abs of the committed one's (~3.5x JAX's own fused-vs-jnp
   spread, 0.00289: `validation/results/water_fused_vs_jnp.json`), and the
   Pe 1e-3 and 3e-3 records pass the analytic gate
   (`validation/run_theory_gate.py::gate_dir`, Cornut-Lefrou, its REGIONS).
B. `batch_validation`'s water case (45-degree tip with gravity, Re 3e-4,
   Pe 0.3401; 11.18 M fluid steps, its own 764,150 balance steps) through
   the same path (one lane). Gates: the normalised current within 0.01 of
   `validation/water_out_fused/_45degree_g9/records/
   record_res64_Re0.0003_Pe3401.txt`, and the verdict's near-contact
   (mean of the first five points, 0.3053) and far (mean of the last ten,
   1.1388) values of `validation/results/water_Re3e-4_verdict.json`
   (`validation/run_water_validation.py:61-72`) within 0.01.

Writes each case's records under ``OUT/<case>/records/`` and everything
measured to ``OUT/sweep_row.json``; prints the card's name and power
limit; exits 1 if a gate fails. Needs the card (exits 2 without one).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WATER_VISC = 0.89e-6
RADIUS = 12.5e-6
BALANCE_SEED_STEPS = 60_645_312  # Re 7e-5, Pe 1e-3: 600 s of balance at its dt
TOL = 0.01
SWEEP_RECORDS = os.path.join(ROOT, "validation", "sweep_out", "_45degree_g9", "records")
CASE_B_RECORD = os.path.join(ROOT, "validation", "water_out_fused", "_45degree_g9", "records",
                             "record_res64_Re0.0003_Pe3401.txt")
CASE_B_VERDICT = os.path.join(ROOT, "validation", "results", "water_Re3e-4_verdict.json")


def smi_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


def compare(path, ref_path):
    """``(rows, committed rows, max abs diff of the normalised currents,
    the port's normalised current)``."""
    from plot_utils import load_approach_curve, read_record

    n, n_ref = len(read_record(path)[0]), len(read_record(ref_path)[0])
    _, cur = load_approach_curve(path, is_negative=True)
    _, ref = load_approach_curve(ref_path, is_negative=True)
    diff = float("inf") if len(cur) != len(ref) else float(abs(cur - ref).max())
    return n, n_ref, diff, cur


def run_case(label, Re, Pes, balance_steps, out, serial):
    import numpy as np
    import torch

    from jrl_lbm_torch import batch_pe, kernels
    from jrl_lbm_torch.parallel import sweep

    vel = Re * WATER_VISC / RADIUS
    args = ("water", "45degree", (128, 64), Re, Pes, True, vel)
    print(f"case {label}: water Re {Re:g}, Pe {Pes}, balance {balance_steps} steps", flush=True)
    kernels.reset_launches()
    res, info = batch_pe.run_re_row(*args, balance_steps=balance_steps, device="cuda")
    counts = {k: c for k, c in kernels.launches().items() if c}
    rep = {"fluid_steps": info["fluid_steps"], "balance_steps": info["balance_steps"],
           "approach_steps": info["approach_steps"], "route": info["route"],
           "fluid_s": info["fluid_s"], "balance_s": info["balance_s"],
           "lanes_s": info["approach_s"], "launches": counts, "n_dumps": res.n_dumps.tolist()}
    print(f"  fluid {info['fluid_steps']} steps {info['fluid_s']:.2f} s, balance "
          f"{info['balance_steps']} steps {info['balance_s']:.2f} s, approach "
          f"({info['route']}, {sum(info['approach_steps'])} lane-steps) "
          f"{info['approach_s']:.3f} s; launches {counts}", flush=True)
    if serial:
        cfg, states, fields, _ = batch_pe.row_inputs(*args, balance_steps=balance_steps,
                                                      device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ser = sweep.pe_sweep_approach(cfg, Pes, states, fields, route="serial")
        torch.cuda.synchronize()
        rep["serial_s"] = time.perf_counter() - t0
        rep["serial_equal"] = bool(np.array_equal(ser.records, res.records))
        print(f"  the same lanes serially: {rep['serial_s']:.3f} s "
              f"(lanes / serial {info['approach_s'] / rep['serial_s']:.3f}); records bit for "
              f"bit the lanes': {rep['serial_equal']}", flush=True)
    rec_dir = os.path.join(out, label, "records")
    paths = sweep.write_sweep_records(res, info["c_cfg"], rec_dir, Re)
    return rep, paths


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("cases", nargs="*", default=["A", "B"], choices=["A", "B"])
    parser.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "sweep_row"))
    parser.add_argument("--no-serial", dest="serial", action="store_false",
                        help="skip the serial route of case A")
    opt = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("sweep_row: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "demo"), os.path.join(ROOT, "validation")]
    from run_theory_gate import REGIONS, gate_dir, nf_theory

    from jrl_lbm_torch import batch_pe
    from jrl_lbm_torch.kernels import build

    smi = smi_line()
    print(smi, flush=True)
    print(f"built {len(build.NAMES)} kernels in {build.build_all():.1f} s", flush=True)
    report = {"device": smi, "torch": torch.__version__}
    ok = True
    if "A" in opt.cases:
        rep, paths = run_case("A", 1e-2, batch_pe.PES, BALANCE_SEED_STEPS, opt.out, opt.serial)
        rep["records"] = {}
        for Pe, path in zip(batch_pe.PES, paths):
            ref = os.path.join(SWEEP_RECORDS, os.path.basename(path))
            n, n_ref, diff, _ = compare(path, ref)
            good = n == n_ref and diff <= TOL
            ok = ok and good
            rep["records"][os.path.basename(path)] = {"rows": n, "committed_rows": n_ref,
                                                      "max_abs_norm_current": diff,
                                                      "pass": good}
            print(f"  Pe {Pe:g}: {n} rows (committed {n_ref}), normalised current max |diff| "
                  f"{diff:.5f} (gate {TOL}): {'pass' if good else 'FAIL'}", flush=True)
        gate = gate_dir(os.path.join(opt.out, "A", "records"), nf_theory, REGIONS)
        rep["theory_gate"] = gate
        for g in gate:
            print(f"  theory gate {g['file']}: " + "; ".join(
                f"L {r['L_range']} max |dev| {r['max_abs_dev']:.4f} (tol {r['tol']})"
                for r in g["regions"]) + f": {'pass' if g['pass'] else 'FAIL'}", flush=True)
        ok = ok and len(gate) == 2 and all(g["pass"] for g in gate)
        if rep.get("serial_equal") is False:
            ok = False
        report["A"] = rep
    if "B" in opt.cases:
        Re = 3e-4
        Pe = Re * WATER_VISC / 7.85e-10
        from jrl_lbm_torch.models import jrl

        cfg = jrl.JRLCConfig(res=(128, 64), Re=Re, Pe=Pe, vel_obs_real=Re * WATER_VISC / RADIUS,
                             shape="45degree")
        rep, paths = run_case("B", Re, [Pe], cfg.balance_steps, opt.out, False)
        n, n_ref, diff, cur = compare(paths[0], CASE_B_RECORD)
        with open(CASE_B_VERDICT) as fo:
            verdict = json.load(fo)
        near, far = float(cur[:5].mean()), float(cur[-10:].mean())
        good = (n == n_ref and diff <= TOL and abs(near - verdict["near_contact"]) <= TOL
                and abs(far - verdict["far"]) <= TOL)
        ok = ok and good
        rep.update(rows=n, committed_rows=n_ref, max_abs_norm_current=diff, near_contact=near,
                   far=far, verdict={k: verdict[k] for k in ("near_contact", "far")}, ok=good)
        print(f"  {n} rows (committed {n_ref}), normalised current max |diff| {diff:.5f}; "
              f"near contact {near:.4f} (verdict {verdict['near_contact']}), far {far:.4f} "
              f"(verdict {verdict['far']}): {'pass' if good else 'FAIL'}", flush=True)
        report["B"] = rep
    report["ok"] = ok
    os.makedirs(opt.out, exist_ok=True)
    with open(os.path.join(opt.out, "sweep_row.json"), "w") as fo:
        json.dump(report, fo, indent=1, default=str)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": ok, "cases": opt.cases}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
