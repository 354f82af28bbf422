#!/usr/bin/env python3
"""What sets the time of the cylinder channel's k-step pass (`cyl_pass`,
`csrc/cyl_pass.cu`) on one card, at `bench.py`'s 2048² scene
(``CylinderConfig(res=(2048, 2048), D=64, Re=5000)``, the runner's k = 4
pass rows):

    python3 tools/cyl_pass_probe.py [sass] [time] [sharded]

``sass`` (no timing): the machine instructions of one cell's code, by
class and design, counted from ``cuobjdump -sass`` of probe kernels that
run one cell each (built with the shipped flags into the ignored build
directory): the k-step tiles' plain-channel, "cyl" and "edge" cells
(``cyl_common.cuh::SmemAcc``, the wall rules on every cell) against the
pass's (``cyl_pass_state.cuh::RingAcc``, body strips without the wall
rules; the bf16 first sub-step converting as it reads). Each count is
split into float32, integer, memory and control instructions; from them
the issue bound of a k = 4 pass at 2048² (one warp instruction a cycle
on each of the SM's four schedulers at the card's top SM clock, the
runner's rows; the coupling branch taken on no cell) beside the byte
bound. Also the whole kernels' instruction counts.

``time``: device µs of a k = 4 pass in float32 (CUDA events, 50 launches,
best of three) for builds of `cyl_pass.cu` with other ``-D`` values and
flags, each into the ignored build directory (the shipped library is not
rebuilt): (a) as shipped; (b) ``-prec-div=false`` (approximate division:
what the IEEE divisions cost; a diagnosis, its bits differ); (c) no cell
code (the rows streamed and stored: the rings' cost alone); (d) 1024
threads, one block an SM; (e) 256 threads, four blocks an SM; then the
shipped build with strips capped at 56 and 88 columns, and with the band
rows' cost weights (`cylinder.CYL_PASS_COST`) swept; the three launches
it replaces in the same run.

``sharded``: the sharded lean-split pass (`cyl_pass_sh`,
`csrc/cyl_pass_sh.cu`, row-streamed at k = 2..4) on other plans of the
same shard (`cyl_sharded.cyl_pass_sh_items`): 132 to 528 blocks, band
rows costing 1.5 to 3 lean rows, on the band's shard of a (4, 1) mesh at
k = 2 and 4 and on the whole grid at k = 4; each plan's result bit for bit
the route's plan, its device µs a launch from the profiler with the L2
flushed between launches (`chip_smoke.kernel_us`).

With no argument ``sass`` and ``time``.

Prints one JSON line, last.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"a shipped": [], "b -prec-div=false": ["-prec-div=false"],
            "c no cells": ["-DCYL_PASS_NO_CELLS"],
            "d 1024 threads x 1": ["-DCYL_PASS_THREADS=1024", "-DCYL_PASS_MIN_BLOCKS=1"],
            "e 256 threads x 4": ["-DCYL_PASS_THREADS=256", "-DCYL_PASS_MIN_BLOCKS=4"]}
K_PASS = 4

# one cell of each class and design, read from shared memory, written out
PROBE = r'''
#include "cyl_pass_state.cuh"
using namespace cyl;
constexpr int EYL = 16 + 2 * 4, EYF = 8 + 2 * 4;  // the k = 4 tiles' heights with halo
__device__ void put(float* o, const float fo[9], float r, float ux, float uy) {
  for (int q = 0; q < 9; ++q) o[q * 1024 + threadIdx.x] = fo[q];
  o[9 * 1024 + threadIdx.x] = r + ux + uy;
}
#define RING(FT) RingAcc<FT, 128>{(const FT*)sm + c, sm + 9 * 128 + c, \
                                  (const int*)sm + 11 * 128 + c, sm + 12 * 128 + c, slot, ns, \
                                  gslot, s}
#define ARGS CylParams p, float* o, int gy, int gx, int ly, int lx, int rs, int c, int slot, \
             int ns, int gslot, int s
extern "C" __global__ void tile_lean(ARGS) {
  extern __shared__ float sm[]; float fo[9], r, ux, uy;
  lean_cell<false>(SmemAcc<false, EYL>{sm, nullptr, nullptr, nullptr, ly, lx}, p, gy, gx, fo, r, ux, uy);
  put(o, fo, r, ux, uy);
}
extern "C" __global__ void tile_cyl(ARGS) {
  extern __shared__ float sm[]; float fo[9], r, ux, uy;
  const SmemAcc<true, EYF> a{sm, sm + 18 * 64 * EYF, (const int*)sm + 22 * 64 * EYF,
                             sm + 23 * 64 * EYF, ly, lx};
  full_cell<true>(a, p, gy, gx, p.wall_density, a.vx(0, 0), a.vy(0, 0), fo, r, ux, uy);
  put(o, fo, r, ux, uy);
}
extern "C" __global__ void tile_edge(ARGS) {
  extern __shared__ float sm[]; float fo[9], r, ux, uy;
  const SmemAcc<true, EYF> a{sm, nullptr, (const int*)sm + 18 * 64 * EYF, nullptr, ly, lx};
  full_cell<false>(a, p, gy, gx, p.wall_density, 0.0f, 0.0f, fo, r, ux, uy);
  put(o, fo, r, ux, uy);
}
extern "C" __global__ void pass_lean_body(ARGS) {
  extern __shared__ float sm[]; float fo[9], r, ux, uy;
  lean_cell<false, false>(RING(float), p, gy, gx, fo, r, ux, uy);
  put(o, fo, r, ux, uy);
}
extern "C" __global__ void pass_lean_wall(ARGS) {
  extern __shared__ float sm[]; float fo[9], r, ux, uy;
  lean_cell<false, true>(RING(float), p, gy, gx, fo, r, ux, uy);
  put(o, fo, r, ux, uy);
}
extern "C" __global__ void pass_lean_body_bf16_input(ARGS) {
  extern __shared__ float sm[]; float fo[9], r, ux, uy;
  lean_cell<false, false>(RING(unsigned short), p, gy, gx, fo, r, ux, uy);
  put(o, fo, r, ux, uy);
}
extern "C" __global__ void pass_cyl_body(ARGS) {
  extern __shared__ float sm[]; float fo[9], r, ux, uy;
  const auto a = RING(float);
  full_cell<true, false>(a, p, gy, gx, p.wall_density, a.vx(0, 0), a.vy(0, 0), fo, r, ux, uy);
  put(o, fo, r, ux, uy);
}
extern "C" __global__ void pass_edge_body(ARGS) {
  extern __shared__ float sm[]; float fo[9], r, ux, uy;
  full_cell<false, false>(RING(float), p, gy, gx, p.wall_density, 0.0f, 0.0f, fo, r, ux, uy);
  put(o, fo, r, ux, uy);
}
'''
PROBES = ("tile_lean", "pass_lean_body", "pass_lean_wall", "pass_lean_body_bf16_input",
          "tile_cyl", "pass_cyl_body", "tile_edge", "pass_edge_body")
CONTROL = {"BRA", "BSSY", "BSYNC", "EXIT", "RET", "CALL", "BAR", "NOP", "WARPSYNC", "YIELD",
           "BREAK", "JMP", "BPT", "ELECT", "ACQBULK"}


def classify(op: str) -> str:
    base = op.split(".")[0]
    if base in CONTROL:
        return "control"
    if base.startswith(("LD", "ST", "ATOM", "RED", "SYNCS", "UBLKCP")):
        return "memory"
    if (base.startswith("F") and base not in ("F2I", "FLO")) or base in ("MUFU", "HADD2", "HFMA2"):
        return "float"
    return "integer"


def sass_counts(text: str) -> dict:
    """Instructions by class in each ``Function :`` section of cuobjdump
    output."""
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = out.setdefault(m.group(1), {"float": 0, "integer": 0, "memory": 0,
                                              "control": 0, "total": 0})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if m and cur is not None:
            cur[classify(m.group(1))] += 1
            cur["total"] += 1
    return out


def cuobjdump() -> str:
    return shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"


def sass_report(build, C, K, cfg, rows):
    tmp = tempfile.mkdtemp(dir=build.BUILD_DIR)
    src = os.path.join(tmp, "cyl_cell_probe.cu")
    with open(src, "w") as fo:
        fo.write(PROBE)
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cubin = os.path.join(tmp, "probe.cubin")
    subprocess.run([build.nvcc_path(), *flags, "-cubin", "-I", str(build.CSRC), "-o", cubin, src],
                   check=True, capture_output=True, text=True, timeout=600)
    dump = subprocess.run([cuobjdump(), "-sass", cubin], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    cells = sass_counts(dump)
    cells = {name: cells[name] for name in PROBES}
    whole = {}
    for lib in ("cyl_interior_k", "cyl_band_k", "cyl_pass"):
        txt = subprocess.run([cuobjdump(), "-sass", str(build._lib_file(lib))],
                             capture_output=True, text=True, check=True, timeout=120).stdout
        for fn_name, cnt in sass_counts(txt).items():
            if "ILi4ELi0E" in fn_name or "ILi1ELi4ELi0E" in fn_name or "ILi2ELi4ELi0E" in fn_name:
                whole[f"{lib} {fn_name[-60:]}"] = cnt["total"]
    clock = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                  "--format=csv,noheader,nounits"], capture_output=True,
                                 text=True, check=True).stdout.split()[0]) * 1e6
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    H, W = cfg.res
    interior, band, edge = rows
    n = {cls: sum(y1 - y0 for y0, y1 in segs) * W for cls, segs in
         (("lean", interior), ("cyl", band), ("edge", edge))}
    issue = 4 * sms * clock  # warp instructions a second

    def bound_us(design):
        per = {"lean": cells[f"{design}_lean" + ("_body" if design == "pass" else "")],
               "cyl": cells[f"{design}_cyl" + ("_body" if design == "pass" else "")],
               "edge": cells[f"{design}_edge" + ("_body" if design == "pass" else "")]}
        return sum(per[c]["total"] * n[c] * K_PASS / 32 for c in n) / issue * 1e6

    rep = {"cells": cells, "whole_kernels_k4_f32": whole, "clock_hz": clock, "sms": sms,
           "issue_bound_us_k4_pass": {"tiles": bound_us("tile"), "pass": bound_us("pass")}}
    for name, cnt in cells.items():
        print(f"  {name:28s} {cnt}", flush=True)
    for name, tot in whole.items():
        print(f"  whole {name}: {tot} instructions", flush=True)
    print(f"  issue bound of a k = 4 pass at {H}x{W} ({clock / 1e9:.3f} GHz, {sms} SMs): "
          f"tiles' cell code {rep['issue_bound_us_k4_pass']['tiles']:.1f} us, the pass's "
          f"{rep['issue_bound_us_k4_pass']['pass']:.1f} us", flush=True)
    return rep


def time_report(build, C, K, cfg, rows, dev):
    import torch

    H, W = cfg.res
    from jrl_lbm_torch.models import cylinder as CY

    c = K.consts(cfg)
    s, fl = CY.init(cfg, dev)
    s = CY.make_runner(cfg)(s, fl, 20)
    out = {key: torch.empty_like(v) for key, v in s.items()}
    tmp = tempfile.mkdtemp(dir=build.BUILD_DIR)
    procs, libs, regs = {}, {}, {}
    for label, flags in VARIANTS.items():
        lib = os.path.join(tmp, f"cyl_pass-{label[0]}.so")
        procs[label] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", lib,
             str(build.CSRC / "cyl_pass.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for label, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {label}:\n{log}")
        libs[label] = ctypes.CDLL(lib)
        regs[label] = sorted({ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                              if "ILi4ELi0E" in ln or ("registers" in ln and "ILi4" in ln)})
    P, I = ctypes.c_void_p, ctypes.c_int

    def us_per_launch(call, n=50):
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

    def pass_call(label, **plan):
        lib = libs[label]
        shape = lib.cyl_pass_shape
        shape.argtypes, shape.restype = [I, P, P, P], ctypes.c_int
        t, cols, mb = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        build.check(shape(K_PASS, ctypes.byref(t), ctypes.byref(cols), ctypes.byref(mb)),
                    "cyl_pass")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        items = K.cyl_pass_items(H, W, K_PASS, *rows, 0, sms, t.value, mb.value, **plan)
        packed, p, smem = K.pass_plan(c, items, K_PASS, 0, dev, t.value, mb.value)
        fn = lib.cyl_pass_launch
        fn.argtypes, fn.restype = [P] * 8 + [I, I, I, P, P], ctypes.c_int
        ptrs = [x.data_ptr() for x in (s["f"], s["vel"], fl["flags"], fl["phi_obs"], out["f"],
                                       out["rho"], out["vel"], packed)]

        def call():
            build.check(fn(*ptrs, K_PASS, 0, smem, ctypes.byref(p),
                           ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)),
                        "cyl_pass")
        return call, len(items), smem

    rec = {"registers": regs}
    for label in VARIANTS:
        call, n_items, smem = pass_call(label)
        rec[label] = {"us": us_per_launch(call), "items": n_items, "smem": smem}
        print(f"  {label}: {rec[label]}", flush=True)
    for width in (56, 88):
        call, n_items, smem = pass_call("a shipped", max_width=width)
        rec[f"a strips <= {width}"] = {"us": us_per_launch(call), "items": n_items}
        print(f"  strips <= {width}: {rec[f'a strips <= {width}']}", flush=True)
    for cost in ((1.0, 1.5, 2.0), (1.0, 2.0, 2.0), (1.0, 3.0, 2.0), (1.0, 4.0, 2.0),
                 (1.0, 2.5, 1.5), (1.0, 2.5, 3.0)):
        call, n_items, _ = pass_call("a shipped", cost=cost)
        rec[f"a cost {cost}"] = {"us": us_per_launch(call), "items": n_items}
        print(f"  cost {cost}: {rec[f'a cost {cost}']}", flush=True)
    interior, band, edge = rows

    def launches():
        K.cyl_interior_k(s["f"], out, interior, K_PASS, c, False)
        K.cyl_band_k(s["f"], s["vel"], fl["flags"], fl["phi_obs"], out, band, K_PASS, False, c)
        K.cyl_band_k(s["f"], s["vel"], fl["flags"], fl["phi_obs"], out, edge, K_PASS, True, c)

    rec["three launches"] = {"us": us_per_launch(launches)}
    print(f"  three launches: {rec['three launches']}", flush=True)
    return rec


def sharded_report(build, C, K, cfg, dev):
    import torch

    from jrl_lbm_torch.kernels import cyl_sharded as CS
    from jrl_lbm_torch.kernels import halo as HA
    from jrl_lbm_torch.models import cylinder as CY
    from jrl_lbm_torch.parallel.mesh import make_mesh, split

    build.build_all(("cyl_pass_sh", "halo_pack"))
    c = K.consts(cfg)
    s0, fl = CY.init(cfg, dev)
    cx, cy = (int(v) for v in cfg.center)
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    rec = {}
    for label, shape, k in (("k=2 (4, 1) band shard", (4, 1), 2),
                            ("k=4 (4, 1) band shard", (4, 1), 4), ("k=4 (1, 1)", (1, 1), 4)):
        mesh = make_mesh(shape, [dev] * (shape[0] * shape[1]))
        step = CS.make_sharded_fused_cylinder_step(cfg, mesh, lean_k=k)
        f, rho, vel = (split(s0[x], mesh) for x in ("f", "rho", "vel"))
        flags, phi = split(fl["flags"], mesh), split(fl["phi_obs"], mesh)
        halos = HA.exchange([CS.lean_group(f[j], rho[j], vel[j], flags[j], phi[j])
                             for j in range(len(step.shards))], mesh, 0, rows=k)
        i = next(j for j, sh in enumerate(step.shards)
                 if sh.row0 <= cy < sh.row0 + sh.h and sh.col0 <= cx < sh.col0 + sh.w)
        sh = step.shards[i]
        rows = CS.pass_sh_rows(sh, CS.band_windows(sh, step.regions))
        want = CS.cyl_pass_sh(f[i], rho[i], vel[i], flags[i], phi[i], halos[i], k, rows, c, sh)
        ctx = CS.pass_sh_context(c, sh, rows, k, dev)
        src = CS._src(sh, f[i].device, halos[i], f[i], vel[i], flags[i], phi[i], rho[i])
        res = {}
        for blocks, cost in ((132, 2.0), (198, 2.0), (264, 2.0), (396, 2.0), (528, 2.0),
                             (264, 1.5), (264, 3.0)):
            items = CS.cyl_pass_sh_items(sh, k, rows, sms=blocks // 2, cost=(1.0, cost))
            packed, params, smem = CS.pass_sh_plan(c, sh, items, k, dev)
            got = [torch.empty_like(x) for x in want]

            def go(packed=packed, params=params, smem=smem, got=got):
                err = ctx.fn(ctypes.byref(src), got[0].data_ptr(), got[1].data_ptr(),
                             got[2].data_ptr(), packed.data_ptr(), k, smem,
                             ctypes.byref(params), torch.cuda.current_stream().cuda_stream)
                build.check(err, "cyl_pass_sh")

            go()
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(got, want))
            us = C.kernel_us(lambda: (flush.zero_(), go()), ("cyl_pass_sh_kernel",), reps=20)
            res[f"{blocks} blocks, band cost {cost}"] = {
                "us": us, "items": len(items), "bit_for_bit": same,
                "mean_run_rows": sum(it[1] - it[0] for it in items) / len(items)}
            print(f"  {label}: {blocks} blocks, band cost {cost}: {us} us, {len(items)} items, "
                  f"bit for bit {same}", flush=True)
        rec[label] = res
    return rec


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as C
    from jrl_lbm_torch.kernels import build
    from jrl_lbm_torch.kernels import cylinder as K
    from jrl_lbm_torch.models import cylinder as CY

    if not torch.cuda.is_available():
        print("cyl_pass_probe: no CUDA device", file=sys.stderr)
        return 2
    what = set(sys.argv[1:]) or {"sass", "time"}
    dev = torch.device("cuda")
    build.build_all(("cyl_pass", "cyl_interior_k", "cyl_band_k"))
    cfg = CY.CylinderConfig(**C.CYL_MAIN)
    rows = K.make_fused_cylinder_runner(cfg).step4.rows
    report = {"device": C.smi_line(), "grid": list(cfg.res), "rows": rows}
    if "sass" in what:
        print("one cell's machine instructions:", flush=True)
        report["sass"] = sass_report(build, C, K, cfg, rows)
    if "time" in what:
        print(f"device us of a k = {K_PASS} pass at {cfg.res[0]}x{cfg.res[1]}, float32:",
              flush=True)
        report["time"] = time_report(build, C, K, cfg, rows, dev)
    if "sharded" in what:
        print("device us of a cyl_pass_sh launch by plan:", flush=True)
        report["sharded"] = sharded_report(build, C, K, cfg, dev)
    print(json.dumps(report, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
