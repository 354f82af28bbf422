#!/usr/bin/env python3
"""The sharded C phases' k-step passes (`c_balance_pass_sh`,
`c_approach_pass_sh`; `csrc/c_balance_pass_sh.cu`,
`csrc/c_approach_pass_sh.cu`) on one card, at `chip_smoke.py`'s sharded
case (the ethaline wedge at refine 8, 1024x512, Re 4, Pe 5, every shard on
the one card):

    python3 tools/c_pass_sh_probe.py [shapes] [check] [alone] [variants] [hostprof] [runner]
                                     [runner22]

``shapes``: each pass's registers and local bytes at k = 1..4 and its own
launch shape against the host plan's mirrors (`jrl_sharded.TILE_THREADS`,
``TILE_SMEM_CAP``, ``c_tile_smem_bytes`` and the co-resident limit) on the
(4, 1) shard and the (1, 1) grid, and those of the column instances on
the (2, 2) shards.

``check``: one launch of each column instance on every shard of the (2,
2) and (1, 2) meshes at k = 1..4 (the approach from step 8 and from 2**24
- 5): bit for bit k steps of the per-step kernels (h, C and, for the
approach, the shard's disk sums).

``alone``: one pass alone on the (4, 1) shard with the tip (256x512), on
the (2, 2) and (1, 2) shards with the tip (512x256, 1024x256; the column
instances) and on the (1, 1) grid at k = 1..4, and one step of the
per-step kernel (`c_balance_sh`; `c_approach_sh` with its disk block) on
the (4, 1) and the (2, 2) shard: CUDA events around 20 launches queued
behind a sleep kernel, the L2 flushed before each (a 128 MB write, its
own time taken off), the median of three.

``variants``: `c_approach_pass_sh` alone as in ``alone`` (the (4, 1)
shard with the tip and the (1, 1) grid at k = 1 and 4) through the shipped
build and plan, through the plan without its block past the tiles (the
disk sums on a block with a tile), and through timing builds of
`c_approach_pass_sh.cu` (``VARIANTS``: without the cell code, the tip
table or the disk sums, whose results are wrong).

``hostprof``: where the host's time goes: cProfile of 40 steps of each C
runner through the pass at its default k on the (4, 1) mesh.

``runner``: the sharded balance and approach runners over 200 steps from
step 0 on the (1, 1), (4, 1), (2, 2) and (1, 2) meshes through the
default route, ``route="pass"`` at k = 1..4 and ``route="launches"``,
each bit for bit the unsharded per-step runner (h, C): wall µs/step (CUDA
events around the 200 steps after 10 warm-up steps, the best of three),
host µs/step (the time the 200 steps take to queue, from a synchronised
start, the best of three), device µs/step and busy share from a profiled
run (`chip_smoke.device_profile`), launches and halo packs a step. A
route the tree refuses (an earlier tree's pass on a column mesh) is
listed as refused. ``runner22``: the same on the (2, 2) mesh alone. Both
call only the runners' API, so the file also runs in a checkout of an
earlier tree (copied into a `git archive` of it under the git-ignored
``_archive/``, beside that tree's ``chip_smoke.py``): parent, change,
change, parent in one call.

With no argument all of them. Prints one JSON line, last; the card's name
and power limit first; the whole report to
``chiprun_out/c_pass_sh_probe.json``.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STEPS = 200
KINDS = ("balance", "approach")
# timing builds of c_approach_pass_sh.cu (-D), beside the shipped one
VARIANTS = {"no cells": ["-DJRL_CAPS_NO_CELLS"],
            "no tip table": ["-DJRL_CAPS_NO_GEO"],
            "no disk sums": ["-DJRL_CAPS_NO_DISK"]}


def fail(msg):
    print(f"c_pass_sh_probe: FAIL: {msg}", flush=True)
    sys.exit(1)


def setup(dev):
    """The refine-8 ethaline C config, a state 20 balance steps in, its
    fields and flags, and 8 seeded stored frames (`chip_smoke.py`'s)."""
    import torch

    from jrl_lbm_torch.models import jrl as T

    cc = T.JRLCConfig(res=(128, 64), Re=4.0, Pe=5.0, vel_obs_real=0.2848, shape="ethaline",
                      refine=8)
    st, cf, flags = T.c_init(cc, dev)
    st = T.make_per_step_balance_runner(cc, flags)(st, cf, 20)
    H, W = cc.eff_res
    g = torch.Generator(device=dev).manual_seed(72)
    vf = 0.5 * torch.randn((8, 2, H, W), generator=g, device=dev)
    return cc, st, cf, flags, vf


def shapes(dev):
    """Registers, spills and the launch shape against the host's mirrors."""
    import torch

    from jrl_lbm_torch.kernels import jrl_sharded as S

    rep = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kind in KINDS:
        for k in range(1, 5):
            info = S.pass_sh_info(k, kind=kind)
            rep[f"{kind} k={k} registers, local bytes"] = info
            print(f"  {kind} k={k}: registers, local bytes {info}", flush=True)
            if info[1]:
                fail(f"{kind} k={k} spills {info[1]} bytes")
            for mshape, co in (((4, 1), (1, 0)), ((1, 1), (0, 0))):
                plan = S.pass_sh_plan(S.Shard.of(1024, 512, mshape, co), k, sms, kind)
                got = S.pass_sh_tile_shape(k, plan.rmax, plan.smax, kind=kind)
                want = (S.TILE_THREADS, S.TILE_SMEM_CAP,
                        S.c_tile_smem_bytes(kind, plan.rmax, plan.smax))
                rep[f"{kind} {mshape} k={k}"] = {"plan": str(plan), "kernel": got}
                print(f"  {kind} {mshape} k={k}: {plan}; threads, cap, bytes, co-resident {got}",
                      flush=True)
                if got[:3] != want or plan.grid > got[3]:
                    fail(f"{kind} {mshape} k={k}: the kernel's shape {got}, the host's {want}, "
                         f"grid {plan.grid}")
            info = S.pass_sh_info(k, kind=kind, cols=True)
            rep[f"{kind} column instance k={k} registers, local bytes"] = info
            print(f"  {kind} column instance k={k}: registers, local bytes {info}", flush=True)
            if info[1]:
                fail(f"{kind} column instance k={k} spills {info[1]} bytes")
            for co in ((0, 0), (1, 1)):
                plan = S.pass_sh_plan(S.Shard.of(1024, 512, (2, 2), co), k, sms, kind)
                got = S.pass_sh_tile_shape(k, plan.rmax, plan.smax, kind=kind, cols=True)
                want = (S.TILE_THREADS, S.TILE_SMEM_CAP,
                        S.c_tile_smem_bytes(kind, plan.rmax, plan.smax))
                rep[f"{kind} (2, 2) {co} k={k}"] = {"plan": str(plan), "kernel": got}
                print(f"  {kind} (2, 2) {co} k={k}: {plan}; threads, cap, bytes, co-resident "
                      f"{got}", flush=True)
                if got[:3] != want or plan.grid > got[3]:
                    fail(f"{kind} (2, 2) {co} k={k}: the kernel's shape {got}, the host's "
                         f"{want}, grid {plan.grid}")
    return rep


def tip_shard(cc, mshape):
    """The shard of ``mshape`` that holds the tip's first row and column."""
    from jrl_lbm_torch.models import jrl as T

    H, _ = cc.eff_res
    return (T.tip_walks(cc.inflow_height, 0, cc.vel_obs_conv)[1] * mshape[0] // H, 0)


def check(dev):
    """Each column instance on every (2, 2) and (1, 2) shard at k = 1..4,
    bit for bit k steps of the per-step kernels."""
    import torch

    from jrl_lbm_torch.kernels import halo as HA
    from jrl_lbm_torch.kernels import jrl_sharded as S
    from jrl_lbm_torch.models import jrl as T
    from jrl_lbm_torch.parallel.mesh import make_mesh, split

    cc, st, cf, flags, vf = setup(dev)
    H, W = cc.eff_res
    rep = {}
    for mshape in ((2, 2), (1, 2)):
        mesh = make_mesh(mshape, [dev] * (mshape[0] * mshape[1]))
        shards = [S.Shard.of(H, W, mshape, c) for c in mesh.local]
        L = range(len(shards))
        h, C_, fl = (split(x, mesh) for x in (st["h"], st["C"], flags))
        base, frames = split(cf["base_flags"], mesh), split(vf, mesh)
        hb1 = HA.exchange([[x] for x in base], mesh, S.XH)
        for k in range(1, 5):
            xh = S.pass_xh(k)
            hx = HA.exchange([[h[i], C_[i]] for i in L], mesh, xh, rows=2 * k)
            hxa = HA.exchange([[x] for x in h], mesh, xh, rows=2 * k)
            hfl = HA.exchange([[x] for x in fl], mesh, xh, rows=2 * k)
            hb = HA.exchange([[x] for x in base], mesh, xh, rows=2 * k)
            per = S.make_sharded_tiled_balance_runner(cc, flags, mesh, route="launches")(
                st, cf, k)
            ok = all(torch.equal(g, sh.body(per[nm])) for i, sh in enumerate(shards)
                     for g, nm in zip(S.c_balance_pass_sh(h[i], C_[i], fl[i], hx[i], hfl[i], k,
                                                          cc, cf, sh), ("h", "C")))
            rep[f"balance {mshape} k={k}"] = ok
            for start in (8, 2**24 - 5):
                ph, pC = h, C_
                pparts = [torch.zeros(4, device=dev) for _ in L]
                for step in range(start, start + k):
                    vel = [T.stored_velocity(f, step, cc.vel_obs_conv) for f in frames]
                    hh = HA.exchange([[x] for x in ph], mesh, S.XH)
                    out = [S.c_approach_sh(ph[i], pC[i], vel[i], base[i], hh[i], hb1[i], step, cc,
                                           cf, sh, pparts[i]) for i, sh in enumerate(shards)]
                    ph, pC = [o[0] for o in out], [o[1] for o in out]
                same = True
                for i, sh in enumerate(shards):
                    part = torch.zeros(4, device=dev)
                    got = S.c_approach_pass_sh(h[i], base[i], S.shard_frames(vf, sh, 2 * k),
                                               hxa[i], hb[i], start, k, cc, cf, sh, part)
                    same &= bool(torch.equal(got[0], ph[i]) and torch.equal(got[1], pC[i])
                                 and torch.equal(part, pparts[i]))
                rep[f"approach {mshape} k={k} from {start}"] = same
                ok = ok and same
            print(f"  {mshape} k={k}: bit for bit the per-step kernels {ok}", flush=True)
            if not ok:
                fail(f"{mshape} k={k}: a column instance differs from the per-step kernels")
    return rep


def alone(dev):
    """µs of one pass alone, L2 flushed, per (kind, mesh, k); the per-step
    kernel a step on the (4, 1) shard with the tip."""
    import torch

    import chip_smoke as C
    from jrl_lbm_torch.kernels import halo as HA
    from jrl_lbm_torch.kernels import jrl_sharded as S
    from jrl_lbm_torch.models import jrl as T
    from jrl_lbm_torch.parallel.mesh import make_mesh, split

    cc, st, cf, flags, vf = setup(dev)
    H, W = cc.eff_res
    l2 = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    rep = {}

    def flushed_us(call):
        pairs = sorted(C.queued_ms(lambda: (l2.zero_(), call()), 20)
                       - C.queued_ms(l2.zero_, 20) for _ in range(3))
        return pairs[1] * 1e3

    for mshape, co in (((4, 1), (1, 0)), ((2, 2), tip_shard(cc, (2, 2))),
                       ((1, 2), (0, 0)), ((1, 1), (0, 0))):
        mesh = make_mesh(mshape, [dev] * (mshape[0] * mshape[1]))
        sh = S.Shard.of(H, W, mshape, co)
        i = mesh.local.index(co)
        h, C_, fl = (split(x, mesh) for x in (st["h"], st["C"], flags))
        base = split(cf["base_flags"], mesh)
        part = torch.zeros(4, device=dev)
        cols = mshape[1] > 1
        if mshape in ((4, 1), (2, 2)):
            hh = HA.exchange([[x] for x in h], mesh, S.XH)
            hfl1 = HA.exchange([[x] for x in fl], mesh, S.XH)
            hb1 = HA.exchange([[x] for x in base], mesh, S.XH)
            v = T.stored_velocity(split(vf, mesh)[i], 0, cc.vel_obs_conv)
            ub = flushed_us(lambda: S.c_balance_sh(h[i], C_[i], fl[i], hh[i], hfl1[i], cc, cf,
                                                   sh))
            ua = flushed_us(lambda: S.c_approach_sh(h[i], C_[i], v, base[i], hh[i], hb1[i], 0,
                                                    cc, cf, sh, part))
            rep[f"{mshape} c_balance_sh"] = {"us_per_step": ub}
            rep[f"{mshape} c_approach_sh"] = {"us_per_step": ua}
            print(f"  {mshape} per step: c_balance_sh {ub:.2f} us, c_approach_sh (+ disk) "
                  f"{ua:.2f} us", flush=True)
        for k in range(1, 5):
            xh = S.pass_xh(k) if cols else S.XH
            hx = HA.exchange([[h[j], C_[j]] for j in range(len(h))], mesh, xh, rows=2 * k)
            hxa = HA.exchange([[x] for x in h], mesh, xh, rows=2 * k)
            hfl = HA.exchange([[x] for x in fl], mesh, xh, rows=2 * k)
            hb = HA.exchange([[x] for x in base], mesh, xh, rows=2 * k)
            fr = S.shard_frames(vf, sh, 2 * k)
            scr = S.pass_sh_scratch(sh, k, dev, 10)
            calls = {
                "balance": lambda: S.c_balance_pass_sh(h[i], C_[i], fl[i], hx[i], hfl[i], k, cc,
                                                       cf, sh, scratch=scr),
                "approach": lambda: S.c_approach_pass_sh(h[i], base[i], fr, hxa[i], hb[i], 0, k,
                                                         cc, cf, sh, part, scratch=scr),
            }
            for kind, call in calls.items():
                us = flushed_us(call)
                plan = S.pass_sh_plan(sh, k, torch.cuda.get_device_properties(dev)
                                      .multi_processor_count, kind)
                tag = f"{kind} {mshape} k={k}"
                rep[tag] = {"us_per_pass": us, "us_per_step": us / k, "plan": str(plan),
                            "shard": [sh.h, sh.w, sh.row0, sh.col0]}
                print(f"  {tag:28s} {us:9.2f} us a pass {us / k:9.2f} a step  {plan}",
                      flush=True)
    return rep


def approach_alone(dev, label, spare=True):
    """µs of one `c_approach_pass_sh` pass alone (L2 flushed) on the (4, 1)
    shard with the tip and the (1, 1) grid at k = 1 and 4; without
    ``spare``, the plan's grid cut to its tiles."""
    import dataclasses
    from unittest import mock

    import torch

    import chip_smoke as C
    from jrl_lbm_torch.kernels import halo as HA
    from jrl_lbm_torch.kernels import jrl_sharded as S
    from jrl_lbm_torch.parallel.mesh import make_mesh, split

    cc, st, cf, flags, vf = setup(dev)
    H, W = cc.eff_res
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    l2 = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    rep = {}
    for mshape, co in (((4, 1), (1, 0)), ((1, 1), (0, 0))):
        mesh = make_mesh(mshape, [dev] * mshape[0])
        sh = S.Shard.of(H, W, mshape, co)
        i = mesh.local.index(co)
        h, base = split(st["h"], mesh), split(cf["base_flags"], mesh)
        part = torch.zeros(4, device=dev)
        for k in (1, 4):
            hxa = HA.exchange([[x] for x in h], mesh, S.XH, rows=2 * k)
            hb = HA.exchange([[x] for x in base], mesh, S.XH, rows=2 * k)
            fr = S.shard_frames(vf, sh, 2 * k)
            scr = S.pass_sh_scratch(sh, k, dev, 10)
            plan = S.pass_sh_plan(sh, k, sms, "approach")
            if not spare:
                plan = dataclasses.replace(plan, grid=min(plan.grid, max(plan.nty) * plan.ntx))
            with mock.patch.object(S, "pass_sh_plan", return_value=plan):
                pairs = sorted(C.queued_ms(lambda: (l2.zero_(), S.c_approach_pass_sh(
                    h[i], base[i], fr, hxa[i], hb[i], 0, k, cc, cf, sh, part, scratch=scr)), 20)
                    - C.queued_ms(l2.zero_, 20) for _ in range(3))
            tag = f"{label} {mshape} k={k}"
            rep[tag] = {"us_per_pass": pairs[1] * 1e3, "plan": str(plan)}
            print(f"  {tag:44s} {pairs[1] * 1e3:9.2f} us a pass  {plan}", flush=True)
    return rep


def variants(dev):
    """`c_approach_pass_sh` alone: shipped, a spare block, -D builds."""
    import ctypes
    import subprocess

    from jrl_lbm_torch.kernels import build

    out_dir = os.path.join(ROOT, "jrl_lbm_torch", "kernels", "_build")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for label, flags in VARIANTS.items():
        lib = os.path.join(out_dir, f"c_approach_pass_sh-probe-{len(procs)}.so")
        procs[label] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", lib,
             str(build.CSRC / "c_approach_pass_sh.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    rep = {"shipped": approach_alone(dev, "shipped"),
           "no spare block": approach_alone(dev, "no spare block", spare=False)}
    shipped = build.bind("c_approach_pass_sh", "jrl_c_approach_pass_sh",
                         [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
    for label, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            fail(f"nvcc {label}:\n{log}")
        regs = sorted({ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln})
        fn = ctypes.CDLL(lib).jrl_c_approach_pass_sh
        fn.argtypes, fn.restype = shipped.argtypes, ctypes.c_int
        build._fns["jrl_c_approach_pass_sh"] = fn
        try:
            print(f" variant {label} ({' '.join(VARIANTS[label])}): {regs}", flush=True)
            rep[label] = {"flags": VARIANTS[label], "registers": regs,
                          "times": approach_alone(dev, label)}
        finally:
            build._fns["jrl_c_approach_pass_sh"] = shipped
    return rep


def hostprof(dev):
    """Where the host's time goes: cProfile of 40 steps of each C runner
    through the pass at the default k on the (4, 1) mesh (the top 25
    functions by own time)."""
    import cProfile
    import io
    import pstats

    import torch

    from jrl_lbm_torch.kernels import jrl_sharded as S
    from jrl_lbm_torch.parallel.mesh import make_mesh

    cc, st, cf, flags, vf = setup(dev)
    mesh = make_mesh((4, 1), [dev] * 4)
    rb = S.make_sharded_tiled_balance_runner(cc, flags, mesh)
    ra = S.make_sharded_tiled_approach_runner(cc, vf, mesh)
    rep = {}
    for kind, call in (("balance", lambda: rb(st, cf, 40)),
                       ("approach", lambda: ra(st, cf, 0, 40))):
        call()
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        prof.enable()
        call()
        torch.cuda.synchronize()
        prof.disable()
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(25)
        rep[kind] = buf.getvalue()
        print(f" host profile, {kind} (4, 1) pass k={rb.k}, 40 steps:\n{buf.getvalue()}",
              flush=True)
    return rep


def runner(dev, meshes, routes):
    """Wall, host and device µs/step of the sharded C runners by mesh and
    route (a route the tree refuses listed as refused)."""
    import torch

    import chip_smoke as C
    from jrl_lbm_torch import kernels
    from jrl_lbm_torch.kernels import jrl_sharded as S
    from jrl_lbm_torch.models import jrl as T
    from jrl_lbm_torch.parallel.mesh import make_mesh

    cc, st, cf, flags, vf = setup(dev)
    want = {"balance": T.make_per_step_balance_runner(cc, flags)(st, cf, STEPS),
            "approach": T.make_per_step_approach_runner(cc, vf)(st, cf, 0, STEPS)[0]}
    rep = {}
    for mshape in meshes:
        mesh = make_mesh(mshape, [dev] * (mshape[0] * mshape[1]))
        for kind in KINDS:
            for route, k in routes:
                kw = dict({"route": route} if route else {}, **({"k": k} if k else {}))
                try:
                    if kind == "balance":
                        run = S.make_sharded_tiled_balance_runner(cc, flags, mesh, **kw)
                    else:
                        run = S.make_sharded_tiled_approach_runner(cc, vf, mesh, **kw)
                except ValueError as e:
                    rep[f"{kind} {mshape} {route} k={k}"] = {"refused": str(e)}
                    print(f"  {kind} {mshape} {route} k={k}: refused ({e})", flush=True)
                    continue
                if kind == "balance":
                    def call(n, run=run):
                        return run(st, cf, n)
                else:
                    def call(n, run=run):
                        return run(st, cf, 0, n)[0]
                kernels.reset_launches()
                out = call(STEPS)
                torch.cuda.synchronize()
                counts = {x: c for x, c in kernels.launches().items() if c}
                same = all(torch.equal(out[x], want[kind][x]) for x in ("h", "C"))
                call(10)
                walls, hosts = [], []
                for _ in range(3):
                    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                        enable_timing=True)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    a.record()
                    call(STEPS)
                    b.record()
                    hosts.append((time.perf_counter() - t0) * 1e6 / STEPS)
                    torch.cuda.synchronize()
                    walls.append(a.elapsed_time(b) * 1e3 / STEPS)
                times, wall = C.device_profile(call, STEPS)
                busy = sum(times.values())
                kk = getattr(run, "k", 1)
                rt = getattr(run, "route", route)
                tag = (f"{kind} {mshape} {route or 'default'} ({rt}) "
                       f"k={kk if rt == 'pass' else 1}")
                halo = counts.get("halo_pack", 0)
                rec = {"wall_us_per_step": min(walls), "walls": walls,
                       "host_us_per_step": min(hosts), "hosts": hosts,
                       "device_us_per_step": busy / STEPS if busy else None,
                       "busy_share": busy / (wall * 1e6) if busy and wall else None,
                       "launches_per_step": {x: c / STEPS for x, c in counts.items()},
                       "halo_pack_per_step": halo / STEPS, "bit_for_bit": same}
                rep[tag] = rec
                print(f"  {tag:44s} wall {rec['wall_us_per_step']:9.2f} us/step  host "
                      f"{rec['host_us_per_step']:9.2f}  device "
                      f"{rec['device_us_per_step'] or float('nan'):8.2f}  busy "
                      f"{rec['busy_share'] or float('nan'):.1%}  launches "
                      f"{rec['launches_per_step']}  bit for bit {same}", flush=True)
                if not same:
                    fail(f"{tag}: not bit for bit the per-step runner")
    return rep


def main():
    import torch

    import chip_smoke as C
    from jrl_lbm_torch.kernels import build

    if not torch.cuda.is_available():
        print("c_pass_sh_probe: no CUDA device", file=sys.stderr)
        return 2
    print(C.smi_line(), flush=True)
    dev = torch.device("cuda")
    modes = set(sys.argv[1:]) or {"shapes", "check", "alone", "variants", "hostprof", "runner"}
    names = ["c_balance_sh", "c_approach_sh", "halo_pack", "c_balance", "c_approach_pass",
             "c_balance_pass_sh", "c_approach_pass_sh"]
    t0 = time.perf_counter()
    build.build_all(names)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in ("c_balance_pass_sh", "c_approach_pass_sh"):
        log = build.build_log.get(name, "")
        print("\n".join(ln for ln in log.splitlines() if "registers" in ln or "spill" in ln),
              flush=True)
    out = {"device": C.smi_line()}
    if "shapes" in modes:
        out["shapes"] = shapes(dev)
    if "check" in modes:
        out["check"] = check(dev)
    if "alone" in modes:
        out["alone"] = alone(dev)
    if "variants" in modes:
        out["variants"] = variants(dev)
    if "hostprof" in modes:
        out["hostprof"] = hostprof(dev)
    routes = [(None, None)] + [("pass", k) for k in range(1, 5)] + [("launches", None)]
    if "runner" in modes:
        out["runner"] = runner(dev, ((1, 1), (4, 1), (2, 2), (1, 2)), routes)
    if "runner22" in modes:
        out["runner22"] = runner(dev, ((2, 2),), routes)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "c_pass_sh_probe.json"), "w") as fo:
        json.dump(out, fo, indent=1, default=str)
    print(json.dumps({k: v for k, v in out.items() if k != "shapes"}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
