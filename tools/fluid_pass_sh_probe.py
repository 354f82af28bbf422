#!/usr/bin/env python3
"""The sharded JRL fluid step's k-step pass (`fluid_pass_sh`,
`csrc/fluid_pass_sh.cu`) on one card, at `chip_smoke.py`'s sharded case
(the ethaline wedge at refine 8, 1024x512, Re 4, every shard on the one
card):

    python3 tools/fluid_pass_sh_probe.py [check] [time] [alone] [variants] [runner]

``check``: the registers and local bytes at k = 1..4 of the row and the
column instances, the kernel's own launch shape against the host plan's
mirrors (`jrl_sharded.TILE_THREADS`, ``TILE_SMEM_CAP``,
``tile_smem_bytes`` and the co-resident limit), then one launch on every
shard of the (1, 1), (2, 1), (4, 1), (2, 2) and (1, 2) meshes at k =
1..4, from steps 0 and 5 (and the lean class where `lean_pass` holds), at
1024x512 and at 256x128 (45degree), through the plan and, at 1024x512,
through the tile shapes of ``TILES`` (`jrl_sharded.tile_plan` in place of
`pass_sh_plan`): bit for bit k steps of the A/B pair (the runner's
``route="launches"``), within 1e-4 of its twin on the card
(`fluid_pass_sh_ref`: PyTorch's reductions sum in another order), and, at
k = 1 and 4 on the meshes of >1 shard, whether it equals the twin run on
the CPU bit for bit.

``alone``: one pass alone on the (4, 1) shard with the tip (256x512), on
the (2, 2) shard with the tip (512x256) and on the (1, 1) grid at k =
1..4, through the plan and each tile shape of ``TILES``, the (4, 1)
mesh's other shards at k = 1 and 4, and one step of the A/B pair on the
(4, 1) and the (2, 2) shard with the tip: CUDA events around 20 launches
queued behind a sleep kernel, the L2 flushed before each (a 128 MB write,
its own time taken off), the median of three.

``variants``: builds of `fluid_pass_sh.cu` with timing-only ``-D`` values
(``VARIANTS``: without the cell code, and without the geometry as well,
which time the copies, the geometry and the barriers), each timed as
``alone``.

``time``: ``alone``, ``variants`` and ``runner`` in turn.

``runner``: the sharded fluid runner over 200 steps from step 0 on the
(1, 1), (4, 1) and (2, 2) meshes through ``route="pass"`` at k = 1..4 and through
``route="launches"`` (the A/B pair), each bit for bit the unsharded
per-step runner: wall µs/step (CUDA events around the 200 steps after 10
warm-up steps, the best of three), host µs/step (the time the 200 steps
take to queue, from a synchronised start, the best of three), device
µs/step and busy share from a profiled run (`chip_smoke.device_profile`),
launches and exchanges a step. It calls only the runner's public API, so
the same file also runs in a checkout of an earlier tree.

With no argument ``check`` and ``time``. Prints one JSON line,
last; the card's name and power limit first.
"""

import ctypes
import json
import os
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STEPS = 200
# tile shapes (R, S) timed beside the plan's own: wide, middle, square
# (one wave of at most 132 tiles on the (4, 1) shard at every k)
TILES = ((9, 128), (17, 64), (34, 32))
# timing-only -D builds (wrong results): they time the copies, the
# geometry and the barriers without the cell code
VARIANTS = {"no cells": ["-DJRL_FPT_NO_CELLS"],
            "no cells, no geometry": ["-DJRL_FPT_NO_CELLS", "-DJRL_FPT_NO_GEO"]}


def fail(msg):
    print(f"fluid_pass_sh_probe: FAIL: {msg}", flush=True)
    sys.exit(1)


# the meshes `check` holds every shard of
CHECK_MESHES = ((1, 1), (2, 1), (4, 1), (2, 2), (1, 2))


def setup(dev, res, shape, refine):
    import chip_smoke as C
    from jrl_lbm_torch.models import jrl as T

    fc = T.JRLFluidConfig(res=res, Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8,
                          shape=shape, refine=refine)
    s0, fl = T.fluid_init(fc, dev)
    return fc, C.noisy(s0, dev, 71, scale=1e-4), fl


def planned(sh, k, tile, sms):
    """The plan of a pass: `pass_sh_plan`'s, or tiles of about ``tile``."""
    from jrl_lbm_torch.kernels import jrl_sharded as S

    return S.pass_sh_plan(sh, k, sms) if tile is None else S.tile_plan(sh, k, *tile, sms)


def with_plan(sh, k, tile, sms):
    """A context in which `fluid_pass_sh` launches ``planned``'s plan."""
    from jrl_lbm_torch.kernels import jrl_sharded as S

    return mock.patch.object(S, "pass_sh_plan", return_value=planned(sh, k, tile, sms))


def exchange_of(S, HA, mesh, f, rho, vel, k):
    """The pass's halo of every shard: the 2k-row pieces of [f, vel, rho]
    and, on a column mesh, their blocks of `pass_xh` lanes."""
    xh = S.pass_xh(k) if mesh.shape[1] > 1 else 0
    return HA.exchange([[f[i], vel[i], rho[i]] for i in range(len(f))], mesh, xh, rows=2 * k)


def cpu_halo(HA, hx):
    """A halo's pieces and blocks on the CPU."""
    return HA.Halo(hx.P, *(None if t is None else t.cpu()
                           for t in (hx.top, hx.bot, hx.left, hx.right)), k=hx.k)


def shapes(dev):
    """Registers, spills and the launch shape against the host's mirrors."""
    import torch

    from jrl_lbm_torch.kernels import jrl_sharded as S

    rep = {"info": {}, "tile_shape": {}}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for k in range(1, 5):
        for cols in (False, True):
            info = S.pass_sh_info(k, cols=cols)
            rep["info"][f"{'cols ' if cols else ''}k={k}"] = info
            print(f"  {'column instance ' if cols else ''}k={k}: registers, local bytes {info}",
                  flush=True)
            if info[1]:
                fail(f"{'column instance ' if cols else ''}k={k} spills {info[1]} bytes")
        for mshape, co in (((4, 1), (1, 0)), ((1, 1), (0, 0)), ((2, 2), (0, 0)),
                           ((2, 2), (0, 1))):
            cols = mshape[1] > 1
            plan = S.pass_sh_plan(S.Shard.of(1024, 512, mshape, co), k, sms)
            got = S.pass_sh_tile_shape(k, plan.rmax, plan.smax, cols=cols)
            rep["tile_shape"][f"{mshape} {co} k={k}"] = {"plan": str(plan), "kernel": got}
            print(f"  {mshape} {co} k={k}: {plan}; threads, cap, bytes, co-resident {got}",
                  flush=True)
            want = (S.TILE_THREADS, S.TILE_SMEM_CAP, S.tile_smem_bytes(plan.rmax, plan.smax))
            if got[:3] != want or plan.grid > got[3]:
                fail(f"{mshape} k={k}: the kernel's shape {got}, the host's {want}, "
                     f"grid {plan.grid}")
    return rep


def check(dev):
    import torch

    from jrl_lbm_torch.kernels import halo as HA
    from jrl_lbm_torch.kernels import jrl_sharded as S
    from jrl_lbm_torch.parallel.mesh import make_mesh, split

    rep = {"cases": []}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for res, shape, refine in (((128, 64), "ethaline", 8), ((256, 128), "45degree", 1)):
        fc, s0, fl = setup(dev, res, shape, refine)
        H, W = fc.eff_res
        s_cpu = {x: v.cpu() for x, v in s0.items()}
        for mshape in CHECK_MESHES:
            mesh = make_mesh(mshape, [dev] * (mshape[0] * mshape[1]))
            shards = [S.Shard.of(H, W, mshape, c) for c in mesh.local]
            f, rho, vel = (split(s0[x], mesh) for x in ("f", "rho", "vel"))
            for k in range(1, 5):
                hx = exchange_of(S, HA, mesh, f, rho, vel, k)
                tiles = [None] + (list(TILES) if W == 512 and mshape not in ((2, 1), (1, 2))
                                  else [])
                for step in (0, 5):
                    pair = S.make_sharded_tiled_fluid_runner(fc, mesh, route="launches")(
                        s0, fl, step, k)
                    for i, sh in enumerate(shards):
                        leans = (False, True) if mshape[0] > 1 and S.lean_pass(
                            fc, sh, step, k) else (False,)
                        for lean in leans:
                            want = [sh.body(pair[x]) for x in ("f", "rho", "vel")]
                            twin = S.fluid_pass_sh_ref(f[i], rho[i], vel[i], hx[i], step, k, fc,
                                                       fl, sh, lean)
                            cpu = None
                            if k in (1, 4) and mshape != (1, 1):
                                # the twin on the CPU, from the same inputs
                                cpu = S.fluid_pass_sh_ref(
                                    *(S.Shard.body(sh, s_cpu[x]) for x in ("f", "rho", "vel")),
                                    cpu_halo(HA, hx[i]), step, k, fc, fl, sh, lean)
                            for tile in tiles:
                                with with_plan(sh, k, tile, sms):
                                    got = S.fluid_pass_sh(f[i], rho[i], vel[i], hx[i], step, k,
                                                          fc, fl, sh, lean)
                                torch.cuda.synchronize()
                                same = all(torch.equal(g, w) for g, w in zip(got, want))
                                diff = max(float((g - w).abs().max()) for g, w in zip(got, want))
                                tdiff = max(float((g - w).abs().max())
                                            for g, w in zip(got, twin))
                                rec = {"bit_for_bit_pair": same, "max_pair": diff,
                                       "max_twin": tdiff}
                                if cpu is not None:
                                    rec["bit_for_bit_cpu_twin"] = all(
                                        torch.equal(g.cpu(), w) for g, w in zip(got, cpu))
                                tag = (f"{H}x{W} {mshape} k={k} step {step} shard {i} "
                                       f"lean={lean}{'' if tile is None else f' tiles {tile}'}")
                                rep["cases"].append(dict(rec, case=tag))
                                print(f"  {tag}: {rec}", flush=True)
                                if not same:
                                    fail(f"{tag}: not bit for bit k steps of the A/B pair")
                                if tdiff > 1e-4 or rec.get("bit_for_bit_cpu_twin") is False:
                                    fail(f"{tag}: {tdiff:.3e} from its twin")
    return rep


def alone(dev, tiles=(None,) + TILES, label=""):
    """µs of one pass alone, L2 flushed, per (mesh, k, tile shape)."""
    import torch

    import chip_smoke as C
    from jrl_lbm_torch.kernels import halo as HA
    from jrl_lbm_torch.kernels import jrl_sharded as S
    from jrl_lbm_torch.parallel.mesh import make_mesh, split

    fc, s0, fl = setup(dev, (128, 64), "ethaline", 8)
    H, W = fc.eff_res
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    l2 = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    rep = {}
    full = not label

    def flushed_us(call):
        pairs = sorted(C.queued_ms(lambda: (l2.zero_(), call()), 20)
                       - C.queued_ms(l2.zero_, 20) for _ in range(3))
        return pairs[1] * 1e3

    for mshape, co in (((4, 1), (1, 0)), ((2, 2), tip_shard(fc, (2, 2))), ((1, 1), (0, 0))):
        mesh = make_mesh(mshape, [dev] * (mshape[0] * mshape[1]))
        sh = S.Shard.of(H, W, mshape, co)
        f, rho, vel = (split(s0[x], mesh) for x in ("f", "rho", "vel"))
        i = mesh.local.index(co)
        if mshape != (1, 1) and full:
            ha = HA.exchange([[f[j], vel[j]] for j in range(len(f))], mesh, S.XH)
            a = S.fluid_a_sh(f[i], rho[i], vel[i], ha[i], 0, fc, fl, sh)
            hb = HA.exchange([[rho[j], vel[j]] for j in range(len(f))], mesh, S.XH)
            ua = flushed_us(lambda: S.fluid_a_sh(f[i], rho[i], vel[i], ha[i], 0, fc, fl, sh))
            ub = flushed_us(lambda: S.fluid_b_sh(*a, hb[i], 0, fc, fl, sh))
            rep[f"{mshape} pair"] = {"a_us": ua, "b_us": ub, "us_per_step": ua + ub}
            print(f"  {mshape} A/B pair: {ua:.2f} + {ub:.2f} = {ua + ub:.2f} us a step",
                  flush=True)
        for k in range(1, 5):
            hx = exchange_of(S, HA, mesh, f, rho, vel, k)
            scr = S.pass_sh_scratch(sh, k, dev)
            for tile in tiles:
                with with_plan(sh, k, tile, sms):
                    us = flushed_us(lambda: S.fluid_pass_sh(f[i], rho[i], vel[i], hx[i], 0, k,
                                                            fc, fl, sh, scratch=scr))
                plan = planned(sh, k, tile, sms)
                tag = f"{label}{mshape} k={k}{'' if tile is None else f' tiles {tile}'}"
                rep[tag] = {"us_per_pass": us, "us_per_step": us / k, "plan": str(plan)}
                print(f"  {tag:40s} {us:9.2f} us a pass {us / k:9.2f} a step  {plan}",
                      flush=True)
            if mshape == (4, 1) and full and k in (1, 4):
                # the shards without the tip's lowest rows: how much the tip's tiles cost
                for jj in (0, 2, 3):
                    shj = S.Shard.of(H, W, mshape, (jj, 0))
                    us = flushed_us(lambda: S.fluid_pass_sh(f[jj], rho[jj], vel[jj], hx[jj], 0, k,
                                                            fc, fl, shj, scratch=scr))
                    rep[f"{mshape} shard {jj} k={k}"] = {"us_per_pass": us}
                    print(f"  {mshape} shard {jj} k={k} {us:9.2f} us a pass", flush=True)
    return rep


def tip_shard(fc, mshape):
    """The shard of a mesh that holds the tip row's axis cell at step 0."""
    from jrl_lbm_torch.models import jrl as T

    H, W = fc.eff_res
    wi = T.tip_walks(fc.inflow_height, 0, fc.vel_obs)[1]
    return (wi * mshape[0] // H, 0)


def variants(dev):
    """Timing-only -D builds of the kernel, each timed as ``alone``."""
    from jrl_lbm_torch.kernels import build

    out_dir = os.path.join(ROOT, "jrl_lbm_torch", "kernels", "_build")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for label, flags in VARIANTS.items():
        lib = os.path.join(out_dir, f"fluid_pass_sh-probe-{len(procs)}.so")
        procs[label] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", lib,
             str(build.CSRC / "fluid_pass_sh.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    rep = {}
    shipped = build.bind("fluid_pass_sh", "jrl_fluid_pass_sh", [ctypes.c_void_p] * 7
                         + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
    for label, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            fail(f"nvcc {label}:\n{log}")
        regs = sorted({ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                       if "registers" in ln})
        fn = ctypes.CDLL(lib).jrl_fluid_pass_sh
        fn.argtypes, fn.restype = shipped.argtypes, ctypes.c_int
        build._fns["jrl_fluid_pass_sh"] = fn
        try:
            print(f" variant {label} ({' '.join(VARIANTS[label])}): {regs}; timing only",
                  flush=True)
            rep[label] = {"flags": VARIANTS[label], "registers": regs,
                          "times": alone(dev, (None,), f"{label} ")}
        finally:
            build._fns["jrl_fluid_pass_sh"] = shipped
    return rep


# the meshes `runner` times (a tree before the column pass refuses
# route="pass" on (2, 2): recorded as refused)
RUNNER_MESHES = ((1, 1), (4, 1), (2, 2))


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
    for mshape in RUNNER_MESHES:
        mesh = make_mesh(mshape, [dev] * (mshape[0] * mshape[1]))
        for route, k in [("pass", k) for k in range(1, 5)] + [("launches", 1)]:
            try:
                run = S.make_sharded_tiled_fluid_runner(fc, mesh, k=k, route=route)
            except ValueError as e:
                rep[f"{mshape} {route} k={k}"] = {"refused": str(e)}
                print(f"  {mshape} {route} k={k}: refused ({e})", flush=True)
                continue
            kernels.reset_launches()
            out = run(s0, fl, 0, STEPS)
            torch.cuda.synchronize()
            counts = {x: c for x, c in kernels.launches().items() if c}
            same = all(torch.equal(out[x], want[x]) for x in want)
            run(s0, fl, 0, 10)
            walls, hosts = [], []
            for _ in range(3):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                a.record()
                run(s0, fl, 0, STEPS)
                b.record()
                hosts.append((time.perf_counter() - t0) * 1e6 / STEPS)
                torch.cuda.synchronize()
                walls.append(a.elapsed_time(b) * 1e3 / STEPS)
            times, wall = C.device_profile(lambda n: run(s0, fl, 0, n), STEPS)
            busy = sum(times.values())
            passes = -(-STEPS // k) if route == "pass" else STEPS
            tag = f"{mshape} {route} k={k}"
            rec = {"wall_us_per_step": min(walls), "walls": walls,
                   "host_us_per_step": min(hosts), "hosts": hosts,
                   "device_us_per_step": busy / STEPS if busy else None,
                   "busy_share": busy / (wall * 1e6) if busy and wall else None,
                   "launches_per_step": {x: c / STEPS for x, c in counts.items()},
                   "exchanges_per_step": (passes if route == "pass" else 2 * STEPS) / STEPS
                   if mshape != (1, 1) else 0.0, "bit_for_bit": same}
            rep[tag] = rec
            print(f"  {tag:24s} wall {rec['wall_us_per_step']:9.2f} us/step  host "
                  f"{rec['host_us_per_step']:9.2f} us/step  device "
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
    modes = set(sys.argv[1:] or ["check", "time"])
    if "time" in modes:
        modes |= {"alone", "variants", "runner"}
    out = {"device": C.smi_line()}
    if "check" in modes:
        out["shapes"] = shapes(dev)
        out["check"] = check(dev)
    if "alone" in modes:
        out["alone"] = alone(dev)
    if "variants" in modes:
        out["variants"] = variants(dev)
    if "runner" in modes:
        out["runner"] = sweep(dev)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "fluid_pass_sh_probe.json"), "w") as fo:
        json.dump(out, fo, indent=1, default=str)
    print(json.dumps({k: v for k, v in out.items() if k not in ("check", "shapes")},
                     default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
