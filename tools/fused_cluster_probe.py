#!/usr/bin/env python3
"""What sets the step time of the cluster kernels (`fused_fluid_cl`,
`fused_balance_cl`) on one card, beside the cooperative kernels:

    python3 tools/fused_cluster_probe.py

From a state 3000 steps into each phase (cooperative kernel), µs/step of
4000-step launches, CUDA events, best of three:

- the default 128x64 grid (cylinder and 45degree fluid tips, ethaline
  balance) through the cooperative kernel, the cluster kernel at 16 blocks
  (one cell a thread) and at 8 blocks (two cells a thread, the shape of a
  card that holds no cluster of 16);
- the same cluster sources built with ``-prec-div=false`` (approximate
  division, no branch to a slow path): a timing of what the IEEE
  divisions of the cell code cost, not a kernel of the port (its results
  differ; the largest difference from the shipped kernel is printed);
- 256x128 (refine 2), where the cluster kernel runs 4 cells a thread,
  beside the cooperative kernel;
- 256x128 and 512x256 (refine 2 and 4 of the ethaline case): the
  multi-cluster kernels (`fused_fluid_mc`, `fused_balance_mc`) on the
  plan `mc_plan` takes, on clusters of 16, 8 and 4 as many as the card
  holds, built with ``-prec-div=false`` (the division share) and built
  ``-DJRL_MC_NO_FAR`` (no halo rows between clusters: wrong results, the
  time without them), beside the cooperative kernel; and the flat tip
  (cylinder) and the wedge (45degree) at 256x128 and 512x256, whose tips
  stay small, through both routes.

The C approach at 256x128 and 512x256 (refine 2 and 4; the ethaline,
``cylinder`` and ``45degree`` tips): from a state 3000 steps into the
approach on a stored velocity of random frames, µs/step of 2000-step
launches of the cooperative ``fused_approach`` (its cells a thread and
blocks printed) and of ``fused_approach_mc`` on the plan `mc_plan` takes,
on every cluster size, built with ``-prec-div=false`` and with
``-DJRL_MC_NO_FAR``, each checked against the cooperative kernel over 500
steps (h and C bit for bit), with its registers and local bytes; these
numbers set ``MC_MAX_CPT["fused_approach"]``.

The fluid's tile kernel at 256x128 and 512x256 (``tiles``; the
ethaline, ``45degree`` and ``cylinder`` tips): from a state 3000 steps
into the fluid phase (cooperative kernel), µs/step of launches of the
case's own length (``steps_per_launch``: 16,384 steps at 256x128, 4,096
at 512x256), CUDA events, best of three, of ``fused_fluid_tl`` on the
card's plan (``tl_plan``) and on forced tile shapes (the plan's cost
model shared with ``fluid_pass_sh``, `jrl_sharded.pass_sh_plan`), beside
``fused_fluid`` and ``fused_fluid_mc`` on theirs, each timed launch bit
for bit ``fused_fluid``'s; then ``fused_fluid_tl`` built without cell
code (``-DJRL_FPT_NO_CELLS``), with the tip SDF at every geometry query
instead of the table (``-DJRL_FPT_SDF``) and with ``-prec-div=false``:
timings only, with each build's registers and local bytes; these numbers
set ``TILES_MIN_CELLS``. Last, at 512x256, what ends a step's wave of
tiles: a build that stamps each tile's start and end
(``-DJRL_FTL_TILE_NS``, %globaltimer, the last step of a launch), each
tile's duration beside the tip-boundary cells it holds (fluid cells with a
tip cell among their eight neighbours).

The approach's row kernel at 256x128 and 512x256 (``rows``; the
ethaline, ``45degree`` and ``cylinder`` tips): from a state 3000 steps
into the approach (cooperative kernel) on a stored velocity of random
frames, µs/step of launches of the case's own length (``steps_per_launch``:
32,768 steps at 256x128, 8,192 at 512x256, across stored frames), CUDA
events, best of three, of ``fused_approach_rw`` on the card's plan
(``rw_plan``) in both thread instances (1024 threads, one cell a thread;
``-DJRL_RW_THREADS=512``, two) with the division policy on (the shipped
reciprocals) and off (``-DJRL_RW_IEEE``), beside ``fused_approach`` and
``fused_approach_mc`` on theirs, each timed launch bit for bit
``fused_approach``'s (h, C and acc); then the split builds, timings only:
no cell code (``-DJRL_RW_NO_CELLS``), the tip SDF at every geometry query
instead of the table (``-DJRL_RW_SDF``) and IEEE division built with
``-prec-div=false``; each build's registers and local bytes. These
numbers set ``ROWS_MIN_CELLS`` and the instance the build keeps.

    python3 tools/fused_cluster_probe.py [cl] [mc] [approach] [tiles] [rows]

runs the named parts (all five without arguments).
Builds into a temporary directory; prints one JSON line, last.
"""

import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the row kernel's builds: the shipped one (1024 threads) first, then the
# other thread instance and the policy off (bit for bit), then the split
# builds (timings only)
RW_BUILDS = (("shipped", []), ("512 threads", ["-DJRL_RW_THREADS=512"]),
             ("IEEE division", ["-DJRL_RW_IEEE"]),
             ("512 threads, IEEE division", ["-DJRL_RW_THREADS=512", "-DJRL_RW_IEEE"]),
             ("no cell code", ["-DJRL_RW_NO_CELLS"]), ("SDF at every query", ["-DJRL_RW_SDF"]),
             ("IEEE division, -prec-div=false", ["-DJRL_RW_IEEE", "-prec-div=false"]))
RW_EXACT = 4  # the builds before this one compute the kernel's results


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as C
    from jrl_lbm_torch.kernels import build
    from jrl_lbm_torch.kernels import fused_jrl as F
    from jrl_lbm_torch.kernels.jrl_fluid import _P, stream_of
    from jrl_lbm_torch.models import jrl as T

    if not torch.cuda.is_available():
        print("fused_cluster_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    parts = set(sys.argv[1:]) or {"cl", "mc", "approach", "tiles", "rows"}
    mc_names = ("fused_fluid_mc", "fused_balance_mc", "fused_approach_mc")
    cl_names = ("fused_fluid_cl", "fused_balance_cl")
    build.build_all(("fused_fluid", "fused_balance", "fused_approach", "fused_fluid_tl",
                     "fused_approach_rw") + cl_names + mc_names)
    tmp = tempfile.mkdtemp(dir=build.BUILD_DIR)
    builds = [(k, "approx_div", ["-prec-div=false"]) for k in cl_names + mc_names]
    builds += [(k, "no_far", ["-DJRL_MC_NO_FAR"]) for k in mc_names]
    builds = [b for b in builds if ("cl" in parts and b[0] in cl_names)
              or ("mc" in parts and b[0] in mc_names[:2])
              or ("approach" in parts and b[0] == "fused_approach_mc")]
    if "tiles" in parts:
        builds += [("fused_fluid_tl", kind, flags) for kind, flags in (
            ("no_cells", ["-DJRL_FPT_NO_CELLS"]), ("sdf", ["-DJRL_FPT_SDF"]),
            ("approx_div", ["-prec-div=false"]), ("tile_ns", ["-DJRL_FTL_TILE_NS"]))]
    if "rows" in parts:
        builds += [("fused_approach_rw", kind, flags) for kind, flags in RW_BUILDS[1:]]
    jobs = []
    for k, kind, flags in builds:
        out = os.path.join(tmp, f"{k}-{re.sub(r'[^A-Za-z0-9]+', '_', kind)}.so")
        jobs.append((k, kind, out, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", out,
             str(build.CSRC / f"{k}.cu")], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)))
    libs = {"shipped": {k: build.load(k) for k in cl_names + mc_names
                        + ("fused_fluid_tl", "fused_approach_rw")}}
    for k, kind, out, proc in jobs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc {k} ({kind}): {proc.stderr.read().decode()}")
        libs.setdefault(kind, {})[k] = ctypes.CDLL(out)

    def cl(kind, name):
        fn = getattr(libs[kind][name], f"jrl_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = ([_P] * 6 + [ctypes.c_int] * 2 + [_P, _P] if name == "fused_fluid_cl"
                       else [_P] * 5 + [ctypes.c_int, _P]) + [ctypes.c_int] * 3 + [_P]
        return fn

    def us_per_step(fn, n):
        best = float("inf")
        fn(n)
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            fn(n)
            b.record()
            torch.cuda.synchronize()
            best = min(best, a.elapsed_time(b) * 1e3 / n)
        return best

    report = {"device": C.smi_line()}
    n, start = 4000, 3000
    cl_cases = (("cylinder", 1), ("45degree", 1), ("ethaline", 2)) if "cl" in parts else ()
    for shape, refine in cl_cases:
        fc, cc = T.JRLFluidConfig(shape=shape, refine=refine), T.JRLCConfig(refine=refine)
        H, W = fc.eff_res
        s, fl = T.fluid_init(fc, dev)
        s = F.fused_fluid(s["f"], s["rho"], s["vel"], 0, start, fc, fl, route="coop")
        st, cf, flags = T.c_init(cc, dev)
        st = F.fused_balance(st["h"], st["C"], flags, start, cc, cf, route="coop")
        fout = [torch.empty_like(t) for t in s]
        bout = [torch.empty_like(t) for t in st]

        def fluid(kind, blocks):
            shape_ = F.cluster_shape("fused_fluid", H, W,
                                     F.card_limits("fused_fluid", 0)._replace(cluster=blocks))
            fn = cl(kind, "fused_fluid_cl")
            ptrs = [t.data_ptr() for t in list(s) + fout]
            return lambda m: build.check(fn(*ptrs, start, m, ctypes.byref(F._a_params(fc)),
                                            ctypes.byref(F._b_params(fc)), *shape_,
                                            stream_of(dev)), "fused_fluid_cl")

        def balance(kind, blocks):
            shape_ = F.cluster_shape("fused_balance", H, W,
                                     F.card_limits("fused_balance", 0)._replace(cluster=blocks))
            fn = cl(kind, "fused_balance_cl")
            ptrs = [t.data_ptr() for t in [flags] + list(st) + bout]
            return lambda m: build.check(fn(*ptrs, m, ctypes.byref(F._balance_params(cc)),
                                            *shape_, stream_of(dev)), "fused_balance_cl")

        rec = {
            "fluid coop": us_per_step(
                lambda m: F.fused_fluid(*s, start, m, fc, fl, route="coop"), n),
            "balance coop": us_per_step(
                lambda m: F.fused_balance(*st, flags, m, cc, cf, route="coop"), n),
        }
        variants = [("16 blocks", "shipped", 16), ("8 blocks", "shipped", 8),
                    ("16 blocks, -prec-div=false", "approx_div", 16)]
        if refine > 1:
            variants = variants[:1]
        for label, kind, blocks in variants:
            rec[f"fluid cluster, {label}"] = us_per_step(fluid(kind, blocks), n)
            rec[f"balance cluster, {label}"] = us_per_step(balance(kind, blocks), n)
        if refine == 1:  # how far the approximate division lands from the kernel
            diffs = {}
            for phase, make, outs in (("fluid", fluid, fout), ("balance", balance, bout)):
                make("shipped", 16)(1000)
                want = [t.clone() for t in outs]
                make("approx_div", 16)(1000)
                diffs[phase] = max(float((a - b).abs().max()) for a, b in zip(outs, want))
            rec["approx_div max |diff| after 1000 steps"] = diffs
        report[f"{shape} {H}x{W}"] = rec
        print(f"{shape} {H}x{W}: {rec}", flush=True)

    def mc(kind, name):
        fn = getattr(libs[kind][name], f"jrl_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = ([_P] * 6 + [ctypes.c_int] * 2 + [_P] * 3 if name == "fused_fluid_mc"
                       else [_P] * 5 + [ctypes.c_int] + [_P] * 2) + [ctypes.c_int] * 4 + [_P]
        return fn

    for name in ("fused_fluid", "fused_balance"):
        report[f"{name} limits"] = F.card_limits(name, 0)._asdict()
    n_mc = 2000
    for refine in (2, 4) if "mc" in parts else ():
        fc, cc = T.JRLFluidConfig(shape="ethaline", refine=refine), T.JRLCConfig(refine=refine)
        H, W = fc.eff_res
        s, fl = T.fluid_init(fc, dev)
        s = F.fused_fluid(s["f"], s["rho"], s["vel"], 0, start, fc, fl, route="coop")
        st, cf, flags = T.c_init(cc, dev)
        st = F.fused_balance(st["h"], st["C"], flags, start, cc, cf, route="coop")
        fout = [torch.empty_like(t) for t in s]
        bout = [torch.empty_like(t) for t in st]
        rec = {"fluid coop": us_per_step(
                   lambda m: F.fused_fluid(*s, start, m, fc, fl, route="coop"), n_mc),
               "balance coop": us_per_step(
                   lambda m: F.fused_balance(*st, flags, m, cc, cf, route="coop"), n_mc)}
        for name, cfg in (("fused_fluid", fc), ("fused_balance", cc)):
            phase = name[6:]
            lim = F.card_limits(name, 0)
            plans = {"plan": F.mc_plan(name, H, W, lim)}
            plans.update({f"clusters of {c}": F.mc_plan(name, H, W, lim, cluster=c)
                          for c in F.MC_SIZES})
            rec[f"{phase} plan"] = plans["plan"]._asdict()
            variants = [(label, "shipped", p) for label, p in plans.items() if p]
            variants += [("plan, -prec-div=false", "approx_div", plans["plan"]),
                         ("plan, no exchange between clusters", "no_far", plans["plan"])]
            for label, kind, plan in variants:
                fn = mc(kind, f"{name}_mc")
                box = F._mailbox(name, plan, W, dev)
                if name == "fused_fluid":
                    ptrs = [t.data_ptr() for t in list(s) + fout]

                    def run(m, fn=fn, plan=plan, box=box, ptrs=ptrs):
                        box.zero_()
                        build.check(fn(*ptrs, start, m, ctypes.byref(F._a_params(fc)),
                                       ctypes.byref(F._b_params(fc)), box.data_ptr(), *plan,
                                       stream_of(dev)), name)
                    want = F.fused_fluid(*s, start, 500, fc, fl, route="coop")
                    outs = fout
                else:
                    ptrs = [t.data_ptr() for t in [flags] + list(st) + bout]

                    def run(m, fn=fn, plan=plan, box=box, ptrs=ptrs):
                        box.zero_()
                        build.check(fn(*ptrs, m, ctypes.byref(F._balance_params(cc)),
                                       box.data_ptr(), *plan, stream_of(dev)), name)
                    want = F.fused_balance(*st, flags, 500, cc, cf, route="coop")
                    outs = bout
                run(500)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(outs, want))
                rec[f"{phase} mc, {label}"] = us_per_step(run, n_mc)
                rec[f"{phase} mc, {label}: bit for bit coop over 500 steps"] = same
        regs = {name: [F.mc_info(name, c, 0) for c in F.CELLS_PER_THREAD]
                for name in ("fused_fluid", "fused_balance")}
        rec["registers, local bytes at 1, 2, 4 cells a thread"] = regs
        report[f"ethaline {H}x{W} multi-cluster"] = rec
        print(f"ethaline {H}x{W} multi-cluster: {rec}", flush=True)
    for res in ((256, 128), (512, 256)) if "mc" in parts else ():
        rec = {}
        for shape in ("cylinder", "45degree"):
            fc = T.JRLFluidConfig(res=res, shape=shape)
            cc = T.JRLCConfig(res=res, shape=shape)
            s, fl = T.fluid_init(fc, dev)
            s = F.fused_fluid(s["f"], s["rho"], s["vel"], 0, start, fc, fl, route="coop")
            st, cf, flags = T.c_init(cc, dev)
            st = F.fused_balance(st["h"], st["C"], flags, start, cc, cf, route="coop")
            for route in ("clusters", "coop"):
                rec[f"{shape} fluid {route}"] = us_per_step(
                    lambda m: F.fused_fluid(*s, start, m, fc, fl, route=route), n_mc)
                rec[f"{shape} balance {route}"] = us_per_step(
                    lambda m: F.fused_balance(*st, flags, m, cc, cf, route=route), n_mc)
        label = f"{res[0]}x{res[1]} small tips"
        report[label] = rec
        print(f"{label}: {rec}", flush=True)
    if "approach" in parts:
        approach(report, us_per_step, dev, libs)
    if "tiles" in parts:
        tiles(report, us_per_step, dev, libs)
    if "rows" in parts:
        rows(report, us_per_step, dev, libs)
    print(json.dumps(report), flush=True)
    return 0


def approach_cfg(T, shape: str, res):
    """The approach config of a tip at 256x128 or 512x256: the default
    ethaline case at refine 2 or 4, the other tips at that grid."""
    if shape == "ethaline":
        return T.JRLCConfig(shape=shape, refine=res[0] // 128)
    return T.JRLCConfig(res=res, shape=shape)


def approach_frames(T, cfg, end: int, dev, seed: int = 0):
    """Random stored-velocity frames [N, 2, H, W] covering steps up to
    ``end`` (at least two)."""
    import torch

    H, W = cfg.eff_res
    n = max(2, int((end + 1) * cfg.vel_obs_conv / T.X_INTERVAL) + 2)
    g = torch.Generator(device=dev).manual_seed(seed)
    return 0.5 * torch.randn((n, 2, H, W), generator=g, device=dev)


def approach(report, us_per_step, dev, libs):
    """The approach part: the cooperative kernel and the multi-cluster one
    (as shipped, on each plan, and its -D builds) at both grids and tips."""
    import torch

    from jrl_lbm_torch.kernels import build
    from jrl_lbm_torch.kernels import fused_jrl as F
    from jrl_lbm_torch.kernels.jrl_fluid import _P, stream_of
    from jrl_lbm_torch.models import jrl as T

    name = "fused_approach"
    lim = F.card_limits(name, 0)
    report["fused_approach limits"] = lim._asdict()

    def mc_fn(kind):
        fn = getattr(libs[kind]["fused_approach_mc"], "jrl_fused_approach_mc")
        fn.restype = ctypes.c_int
        fn.argtypes = ([_P, _P, ctypes.c_int] + [_P] * 5 + [ctypes.c_int] * 2 + [_P] * 4
                       + [ctypes.c_int] * 4 + [_P])
        return fn

    n, start = 2000, 3000
    for res in ((256, 128), (512, 256)):
        H, W = res
        cpt, grid = F.launch_shape("fused_approach", H * W, 0)
        rec = {"coop launch shape": {"cells a thread": cpt, "blocks": grid,
                                     "threads a block": F.FUSED_BLOCK}}
        for shape in ("ethaline", "cylinder", "45degree"):
            cc = approach_cfg(T, shape, res)
            st, cf, _ = T.c_init(cc, dev)
            vf = approach_frames(T, cc, start + 3 * n, dev)
            acc = torch.zeros(4, device=dev)
            h, C = F.fused_approach(st["h"], st["C"], vf, 0, start, cc, cf, acc, route="coop")
            rec[f"{shape} coop"] = us_per_step(
                lambda m: F.fused_approach(h, C, vf, start, m, cc, cf, acc, route="coop"), n)
            plans = {"plan": F.mc_plan(name, H, W, lim)}
            plans.update({f"clusters of {c}": F.mc_plan(name, H, W, lim, cluster=c)
                          for c in F.MC_SIZES})
            variants = [(label, "shipped", p) for label, p in plans.items() if p]
            if shape != "ethaline":
                variants = variants[:1]
            variants += [("plan, -prec-div=false", "approx_div", plans["plan"]),
                         ("plan, no exchange between clusters", "no_far", plans["plan"])]
            want = F.fused_approach(h, C, vf, start, 500, cc, cf, torch.zeros(4, device=dev),
                                    route="coop")
            out = [torch.empty_like(h), torch.empty_like(C)]
            for label, kind, plan in variants:
                fn = mc_fn(kind)

                def run(m, fn=fn, plan=plan):
                    box, table, ticket = F._approach_box(plan, W, dev)
                    build.check(fn(cf["base_flags"].data_ptr(), vf.data_ptr(), vf.shape[0],
                                   cf["area"].data_ptr(), h.data_ptr(), out[0].data_ptr(),
                                   out[1].data_ptr(), acc.data_ptr(), start, m,
                                   ctypes.byref(F._approach_params(cc)), box.data_ptr(), table,
                                   ticket, *plan, stream_of(dev)), name)
                run(500)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(out, want))
                rec[f"{shape} mc, {label}"] = us_per_step(run, n)
                rec[f"{shape} mc, {label}: bit for bit coop over 500 steps"] = same
            if shape == "ethaline":
                rec["plan"] = plans["plan"]._asdict()
        rec["registers, local bytes at 1, 2, 4 cells a thread"] = [
            F.mc_info(name, c, 0) for c in F.CELLS_PER_THREAD]
        label = f"approach {H}x{W}"
        report[label] = rec
        print(f"{label}: {rec}", flush=True)


def tiles(report, us_per_step, dev, libs):
    """The tiles part: `fused_fluid_tl` (as shipped on the card's plan and
    on forced tiles, and its -D builds) beside `fused_fluid` and
    `fused_fluid_mc` at both grids and tips."""
    import torch

    from jrl_lbm_torch.kernels import build
    from jrl_lbm_torch.kernels import fused_jrl as F
    from jrl_lbm_torch.kernels import jrl_sharded as S
    from jrl_lbm_torch.kernels.jrl_fluid import _P, sm_count, stream_of
    from jrl_lbm_torch.models import jrl as T

    sms = sm_count(dev)
    report["fused_fluid_tl registers, local bytes"] = {}
    for kind, lib in libs.items():
        if "fused_fluid_tl" in lib:
            fn = getattr(lib["fused_fluid_tl"], "jrl_fused_fluid_tl_info")
            fn.argtypes, fn.restype = [_P, _P], ctypes.c_int
            regs, local = ctypes.c_int(0), ctypes.c_int(0)
            build.check(fn(ctypes.byref(regs), ctypes.byref(local)), "fused_fluid_tl")
            report["fused_fluid_tl registers, local bytes"][kind] = (regs.value, local.value)

    def tl_fn(kind):
        fn = getattr(libs[kind]["fused_fluid_tl"], "jrl_fused_fluid_tl")
        fn.restype = ctypes.c_int
        fn.argtypes = [_P] * 9 + [ctypes.c_int] * 2 + [_P] * 4
        return fn

    start = 3000
    for res in ((256, 128), (512, 256)):
        H, W = res
        shapes = {}
        for shape in ("ethaline", "45degree", "cylinder"):
            fc = T.JRLFluidConfig(shape=shape, refine=H // 128) if shape == "ethaline" \
                else T.JRLFluidConfig(res=res, shape=shape)
            s, fl = T.fluid_init(fc, dev)
            s = F.fused_fluid(s["f"], s["rho"], s["vel"], 0, start, fc, fl, route="coop")
            n = F.steps_per_launch(fc, "fused_fluid")
            rec = {"steps a launch": n}
            want = F.fused_fluid(*s, start, n, fc, fl, route="coop")
            rec["fused_fluid"] = us_per_step(
                lambda m: F.fused_fluid(*s, start, m, fc, fl, route="coop"), n)
            last = {}

            def keep(out):
                last["out"] = out

            rec["fused_fluid_mc"] = us_per_step(
                lambda m: keep(F.fused_fluid(*s, start, m, fc, fl, route="clusters")), n)
            rec["fused_fluid_mc bit for bit"] = all(
                torch.equal(a, b) for a, b in zip(last["out"], want))
            plans = {"plan": F.tl_plan(H, W, sms)}
            sh = S.Shard.of(H, W, (1, 1), (0, 0))
            for tile in ((16, 32), (32, 16), (16, 64), (64, 16), (24, 24), (8, 32), (16, 16),
                         (128, 8)):
                try:
                    plans[f"tiles {tile[0]}x{tile[1]}"] = S.tile_plan(sh, 1, *tile, sms)
                except ValueError:
                    pass
            rec["plan"] = dataclasses.asdict(plans["plan"])
            variants = [(label, "shipped", p) for label, p in plans.items()]
            variants += [(f"plan, {kind}", kind, plans["plan"])
                         for kind in ("no_cells", "sdf", "approx_div")]
            for label, kind, plan in variants:
                fn = tl_fn(kind)
                pa, pb, pt = F._tl_args(fc, plan)
                out = [torch.empty_like(t) for t in s]
                tmp = [torch.empty_like(t) for t in s]

                def run(m, fn=fn, pa=pa, pb=pb, pt=pt, out=out, tmp=tmp):
                    P, Q = (out, tmp) if m % 2 else (tmp, out)
                    build.check(fn(*(t.data_ptr() for t in list(s) + P + Q), start, m,
                                   ctypes.byref(pa), ctypes.byref(pb), ctypes.byref(pt),
                                   stream_of(dev)), "fused_fluid_tl")
                rec[f"fused_fluid_tl, {label}"] = us_per_step(run, n)
                torch.cuda.synchronize()
                rec[f"fused_fluid_tl, {label}: bit for bit"] = all(
                    torch.equal(a, b) for a, b in zip(out, want))
            if H == 512:
                rec["wave"] = tile_wave(libs, tl_fn, s, start, n, fc, plans["plan"], dev)
            shapes[shape] = rec
            print(f"tiles {H}x{W} {shape}: {rec}", flush=True)
        report[f"tiles {H}x{W}"] = shapes


def tile_wave(libs, tl_fn, s, start, n, fc, plan, dev):
    """One launch of the tile-stamping build: the last step's tiles, each
    one's µs beside the tip-boundary cells it holds, and the wave's end."""
    import torch

    from jrl_lbm_torch.kernels import build
    from jrl_lbm_torch.kernels import fused_jrl as F
    from jrl_lbm_torch.kernels import jrl_tiled as JT
    from jrl_lbm_torch.kernels.jrl_fluid import stream_of

    H, W = fc.eff_res
    fn = tl_fn("tile_ns")
    pa, pb, pt = F._tl_args(fc, plan)
    out = [torch.empty_like(t) for t in s]
    tmp = [torch.empty_like(t) for t in s]
    P, Q = (out, tmp) if n % 2 else (tmp, out)
    build.check(fn(*(t.data_ptr() for t in list(s) + P + Q), start, n, ctypes.byref(pa),
                   ctypes.byref(pb), ctypes.byref(pt), stream_of(dev)), "fused_fluid_tl")
    torch.cuda.synchronize()
    tiles = plan.tiles(0, H, W)
    get = libs["tile_ns"]["fused_fluid_tl"].jrl_fused_fluid_tl_tile_ns
    get.restype, get.argtypes = ctypes.c_int, [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    ns = (ctypes.c_ulonglong * (2 * len(tiles)))()
    build.check(get(ns, len(tiles)), "fused_fluid_tl")
    t0 = min(ns[0::2])
    tip = JT._geometry(fc, torch.arange(H), start + n - 1)[2]
    pad = torch.nn.functional.pad(tip[None, None].float(), (1, 1, 1, 1))[0, 0]
    near = sum(pad[1 + dy:1 + dy + H, 1 + dx:1 + dx + W] for dy in (-1, 0, 1)
               for dx in (-1, 0, 1)) > 0
    edge = near & ~tip  # fluid cells with a tip neighbour
    rows = []
    for b, (e0, e1, sx0, sx1, _, _) in enumerate(tiles):
        rows.append({"tile": b, "rows": (e0, e1), "cols": (sx0, sx1),
                     "us": (ns[2 * b + 1] - ns[2 * b]) / 1e3,
                     "end_us": (ns[2 * b + 1] - t0) / 1e3,
                     "tip_edge_cells": int(edge[e0:e1, sx0:sx1].sum())})
    us = sorted(r["us"] for r in rows)
    with_tip = [r["us"] for r in rows if r["tip_edge_cells"]]
    without = [r["us"] for r in rows if not r["tip_edge_cells"]]
    last = max(rows, key=lambda r: r["end_us"])
    return {"tiles": len(rows), "us min/median/max": (us[0], us[len(us) // 2], us[-1]),
            "wave us": last["end_us"], "last tile": last,
            "tiles with tip edge": len(with_tip),
            "mean us with / without tip edge": (sum(with_tip) / max(1, len(with_tip)),
                                               sum(without) / max(1, len(without))),
            "slowest five": sorted(rows, key=lambda r: -r["us"])[:5]}


def rows(report, us_per_step, dev, libs):
    """The rows part: `fused_approach_rw` (its builds, on the card's plan)
    beside `fused_approach` and `fused_approach_mc` at both grids and tips."""
    import torch

    from jrl_lbm_torch.kernels import build
    from jrl_lbm_torch.kernels import fused_jrl as F
    from jrl_lbm_torch.kernels.jrl_fluid import _P, sm_count, stream_of
    from jrl_lbm_torch.models import jrl as T

    sms = sm_count(dev)
    info = {}
    for kind, _ in RW_BUILDS:
        fn = getattr(libs[kind]["fused_approach_rw"], "jrl_fused_approach_rw_info")
        fn.argtypes, fn.restype = [_P] * 4, ctypes.c_int
        out = [ctypes.c_int(0) for _ in range(4)]
        build.check(fn(*(ctypes.byref(x) for x in out)), "fused_approach_rw")
        info[kind] = {"registers": out[0].value, "local bytes": out[1].value,
                      "threads": out[2].value}
    report["fused_approach_rw builds"] = info
    print(f"fused_approach_rw builds: {info}", flush=True)

    def rw_fn(kind):
        fn = getattr(libs[kind]["fused_approach_rw"], "jrl_fused_approach_rw")
        fn.restype = ctypes.c_int
        fn.argtypes = [_P] * 9 + [ctypes.c_int] * 2 + [_P, _P]
        return fn

    start = 3000
    for res in ((256, 128), (512, 256)):
        H, W = res
        plan = F.rw_plan(H, W, sms)
        shapes = {}
        for shape in ("ethaline", "45degree", "cylinder"):
            cc = approach_cfg(T, shape, res)
            n = F.steps_per_launch(cc, "fused_approach")
            st, cf, _ = T.c_init(cc, dev)
            vf = approach_frames(T, cc, start + n, dev)
            acc = torch.zeros(4, device=dev)
            h, C = F.fused_approach(st["h"], st["C"], vf, 0, start, cc, cf, acc, route="coop")
            want_acc = torch.zeros(4, device=dev)
            want = F.fused_approach(h, C, vf, start, n, cc, cf, want_acc, route="coop")
            b0 = T.frame_pair(start, cc.vel_obs_conv, vf.shape[0])[0]
            b1 = T.frame_pair(start + n - 1, cc.vel_obs_conv, vf.shape[0])[0]
            rec = {"steps a launch": n, "frames crossed": b1 - b0, "plan": plan._asdict()}
            for route, label in (("coop", "fused_approach"), ("clusters", "fused_approach_mc")):
                rec[label] = us_per_step(
                    lambda m, r=route: F.fused_approach(h, C, vf, start, m, cc, cf, acc, route=r),
                    n)
            params = F._rw_args(cc, plan, vf.shape[0])
            out = [torch.empty_like(h), torch.empty_like(C)]
            tmp = [torch.empty_like(h), torch.empty_like(C)]
            got_acc = torch.zeros(4, device=dev)
            for i, (kind, _) in enumerate(RW_BUILDS):
                fn = rw_fn(kind)

                def run(m, fn=fn):
                    P, Q = (out, tmp) if m % 2 else (tmp, out)
                    got_acc.zero_()
                    build.check(fn(cf["base_flags"].data_ptr(), vf.data_ptr(),
                                   cf["area"].data_ptr(), h.data_ptr(),
                                   *(t.data_ptr() for t in P + Q), got_acc.data_ptr(), start,
                                   m, ctypes.byref(params), stream_of(dev)),
                                "fused_approach_rw")
                rec[f"fused_approach_rw, {kind}"] = us_per_step(run, n)
                if i < RW_EXACT:
                    torch.cuda.synchronize()
                    rec[f"fused_approach_rw, {kind}: bit for bit"] = all(
                        torch.equal(a, b) for a, b in zip(out + [got_acc], list(want)
                                                          + [want_acc]))
            shapes[shape] = rec
            print(f"rows {H}x{W} {shape}: {rec}", flush=True)
        report[f"rows {H}x{W}"] = shapes


if __name__ == "__main__":
    sys.exit(main())
