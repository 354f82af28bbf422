#!/usr/bin/env python3
"""The sharded JRL fluid step's k-step pass (`fluid_pass_sh`,
`csrc/fluid_pass_sh.cu`) on one card, at `chip_smoke.py`'s sharded case
(the ethaline wedge at refine 8, 1024x512, Re 4, every shard on the one
card):

    python3 tools/fluid_pass_sh_probe.py [check] [time]

``check``: the kernel's registers and local bytes at k = 1..4, its own
launch shape against the host plan's mirror (`jrl_sharded.pass_sh_cols`,
``pass_sh_max_rs``), then one launch on every shard of the (1, 1), (2, 1)
and (4, 1) meshes at k = 1..4, from steps 0 and 5 (and the lean class
where `lean_pass` holds), at 1024x512 and at 256x128 (45degree): bit for
bit k steps of the A/B pair (the runner's ``route="launches"``), within
1e-4 of its twin on the card (`fluid_pass_sh_ref`: PyTorch's reductions
sum in another order), and, at k = 1 and 4 on the meshes of >1 row,
whether it equals the twin run on the CPU bit for bit.

``time``: the sharded fluid runner over 200 steps from step 0 on the
(1, 1) and (4, 1) meshes through ``route="pass"`` at k = 1..4 and through
``route="launches"`` (the A/B pair), each bit for bit the unsharded
per-step runner: wall µs/step (CUDA events around the 200 steps after 10
warm-up steps, the best of three), device µs/step and busy share from a
profiled run (`chip_smoke.device_profile`), launches and exchanges a
step.

With no argument both. Prints one JSON line, last; the card's name and
power limit first.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STEPS = 200


def fail(msg):
    print(f"fluid_pass_sh_probe: FAIL: {msg}", flush=True)
    sys.exit(1)


def setup(dev, res, shape, refine):
    import chip_smoke as C
    from jrl_lbm_torch.models import jrl as T

    fc = T.JRLFluidConfig(res=res, Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8,
                          shape=shape, refine=refine)
    s0, fl = T.fluid_init(fc, dev)
    return fc, C.noisy(s0, dev, 71, scale=1e-4), fl


def check(dev):
    import torch

    from jrl_lbm_torch.kernels import halo as HA
    from jrl_lbm_torch.kernels import jrl_sharded as S
    from jrl_lbm_torch.parallel.mesh import make_mesh, split

    rep = {"info": {}, "shape": {}, "cases": []}
    for k in range(1, 5):
        rep["info"][k] = S.pass_sh_info(k)
        got = S.pass_sh_shape(k)
        want = (S.PASS_SH_THREADS, S.pass_sh_cols(k), S.pass_sh_max_rs(k), k * S.PASS_SH_BYTES)
        rep["shape"][k] = got
        print(f"  k={k}: registers, local bytes {rep['info'][k]}; shape {got}", flush=True)
        if got != want:
            fail(f"k={k}: the kernel's shape {got}, the host's mirror {want}")
        if rep["info"][k][1]:
            print(f"  k={k}: {rep['info'][k][1]} local bytes (spills)", flush=True)
    for res, shape, refine in (((128, 64), "ethaline", 8), ((256, 128), "45degree", 1)):
        fc, s0, fl = setup(dev, res, shape, refine)
        H, W = fc.eff_res
        s_cpu = {x: v.cpu() for x, v in s0.items()}
        for mshape in ((1, 1), (2, 1), (4, 1)):
            mesh = make_mesh(mshape, [dev] * mshape[0])
            shards = [S.Shard.of(H, W, mshape, c) for c in mesh.local]
            f, rho, vel = (split(s0[x], mesh) for x in ("f", "rho", "vel"))
            for k in range(1, 5):
                hx = HA.exchange([[f[i], vel[i], rho[i]] for i in range(len(shards))], mesh,
                                 S.XH, rows=2 * k)
                for step in (0, 5):
                    pair = S.make_sharded_tiled_fluid_runner(fc, mesh, route="launches")(
                        s0, fl, step, k)
                    for i, sh in enumerate(shards):
                        leans = (False, True) if mshape[0] > 1 and S.lean_pass(
                            fc, sh, step, k) else (False,)
                        for lean in leans:
                            got = S.fluid_pass_sh(f[i], rho[i], vel[i], hx[i], step, k, fc, fl,
                                                  sh, lean)
                            want = [sh.body(pair[x]) for x in ("f", "rho", "vel")]
                            twin = S.fluid_pass_sh_ref(f[i], rho[i], vel[i], hx[i], step, k, fc,
                                                       fl, sh, lean)
                            torch.cuda.synchronize()
                            same = all(torch.equal(g, w) for g, w in zip(got, want))
                            diff = max(float((g - w).abs().max()) for g, w in zip(got, want))
                            tdiff = max(float((g - w).abs().max()) for g, w in zip(got, twin))
                            rec = {"bit_for_bit_pair": same, "max_pair": diff, "max_twin": tdiff}
                            if k in (1, 4) and mshape != (1, 1):
                                # the twin on the CPU, from the same inputs
                                cpu = S.fluid_pass_sh_ref(
                                    *(S.Shard.body(sh, s_cpu[x]) for x in ("f", "rho", "vel")),
                                    None if hx[i].top is None else HA.Halo(
                                        12, hx[i].top.cpu(), hx[i].bot.cpu(), k=2 * k),
                                    step, k, fc, fl, sh, lean)
                                rec["bit_for_bit_cpu_twin"] = all(
                                    torch.equal(g.cpu(), w) for g, w in zip(got, cpu))
                            tag = f"{H}x{W} {mshape} k={k} step {step} shard {i} lean={lean}"
                            rep["cases"].append(dict(rec, case=tag))
                            print(f"  {tag}: {rec}", flush=True)
                            if not same:
                                fail(f"{tag}: not bit for bit k steps of the A/B pair")
                            if tdiff > 1e-4:
                                fail(f"{tag}: {tdiff:.3e} from its twin")
    return rep


def sweep(dev):
    import torch

    import chip_smoke as C
    from jrl_lbm_torch import kernels
    from jrl_lbm_torch.kernels import jrl_sharded as S
    from jrl_lbm_torch.models import jrl as T
    from jrl_lbm_torch.parallel.mesh import make_mesh

    fc, s0, fl = setup(dev, (128, 64), "ethaline", 8)
    want = T.make_per_step_fluid_runner(fc)(s0, fl, 0, STEPS)
    rep = {}
    for mshape in ((1, 1), (4, 1)):
        mesh = make_mesh(mshape, [dev] * mshape[0])
        for route, k in [("pass", k) for k in range(1, 5)] + [("launches", 1)]:
            run = S.make_sharded_tiled_fluid_runner(fc, mesh, k=k, route=route)
            kernels.reset_launches()
            out = run(s0, fl, 0, STEPS)
            torch.cuda.synchronize()
            counts = {x: c for x, c in kernels.launches().items() if c}
            same = all(torch.equal(out[x], want[x]) for x in want)
            run(s0, fl, 0, 10)
            walls = []
            for _ in range(3):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                a.record()
                run(s0, fl, 0, STEPS)
                b.record()
                torch.cuda.synchronize()
                walls.append(a.elapsed_time(b) * 1e3 / STEPS)
            times, wall = C.device_profile(lambda n: run(s0, fl, 0, n), STEPS)
            busy = sum(times.values())
            passes = -(-STEPS // k) if route == "pass" else STEPS
            tag = f"{mshape} {route} k={k}"
            rec = {"wall_us_per_step": min(walls), "walls": walls,
                   "device_us_per_step": busy / STEPS if busy else None,
                   "busy_share": busy / (wall * 1e6) if busy and wall else None,
                   "launches_per_step": {x: c / STEPS for x, c in counts.items()},
                   "exchanges_per_step": (passes if route == "pass" else 2 * STEPS) / STEPS
                   if mshape != (1, 1) else 0.0, "bit_for_bit": same}
            rep[tag] = rec
            print(f"  {tag:24s} wall {rec['wall_us_per_step']:9.2f} us/step  device "
                  f"{rec['device_us_per_step'] or float('nan'):8.2f} us/step  busy "
                  f"{rec['busy_share'] or float('nan'):.1%}  launches {rec['launches_per_step']}"
                  f"  bit for bit {same}", flush=True)
            if not same:
                fail(f"{tag}: not bit for bit the per-step runner")
    return rep


def main():
    import torch

    import chip_smoke as C
    from jrl_lbm_torch.kernels import build

    if not torch.cuda.is_available():
        print("fluid_pass_sh_probe: no CUDA device", file=sys.stderr)
        return 2
    print(C.smi_line(), flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.build_all(["fluid_pass_sh", "fluid_a_sh", "fluid_b_sh", "halo_pack", "fluid_a",
                     "fluid_b"])
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    log = build.build_log.get("fluid_pass_sh", "")
    print("\n".join(ln for ln in log.splitlines() if "registers" in ln or "spill" in ln),
          flush=True)
    modes = sys.argv[1:] or ["check", "time"]
    out = {"device": C.smi_line()}
    if "check" in modes:
        out["check"] = check(dev)
    if "time" in modes:
        out["time"] = sweep(dev)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "fluid_pass_sh_probe.json"), "w") as fo:
        json.dump(out, fo, indent=1, default=str)
    print(json.dumps({k: v for k, v in out.items() if k != "check"}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
