#!/usr/bin/env python3
"""The sharded runners' walls on one card around the halo exchange
(`kernels/halo.py`): the three JRL runners at `chip_smoke.py`'s sharded
case (the ethaline wedge at refine 8, 1024x512, Re 4, Pe 5) and the
cylinder's lean split at k = 1 at `bench.py`'s 2048² scene, on the (4, 1)
and (2, 2) meshes, every shard on the one card:

    python3 tools/halo_mesh_probe.py [label]

Each runner at its default route: wall µs/step (CUDA events around the
steps after a warm-up, the best of three), host µs/step (the time the
steps take to queue, from a synchronised start, the best of three),
device µs/step and busy share from a profiled run
(`chip_smoke.device_profile`), launches a step, and a SHA-256 digest of
the state after the steps (f, rho, vel; h, C; the approach's integrals).
Where the tree has `halo.halo_route`, each runner also runs with its
exchanges on ``route="shards"`` (the pick patched), and its digest must
equal the default route's. The runs call only the runners' API, so the
file also runs in a checkout of an earlier tree (copied into a `git
archive` of it under the git-ignored ``_archive/``, beside that tree's
``chip_smoke.py``): parent, change, change, parent in one call; equal
digests say the trees agree bit for bit.

Prints the card's name and power limit first and one JSON line last;
the report to ``chiprun_out/halo_mesh_probe_<label>.json``.
"""

import hashlib
import json
import os
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

JRL_STEPS = 200
CYL_STEPS = 600
MESHES = ((4, 1), (2, 2))


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def timed(call, steps, C):
    """Wall, host and device µs/step, busy share and launches of
    ``call(steps)``."""
    import torch

    from jrl_lbm_torch import kernels

    call(10)
    walls, hosts = [], []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        call(steps)
        b.record()
        hosts.append((time.perf_counter() - t0) * 1e6 / steps)
        torch.cuda.synchronize()
        walls.append(a.elapsed_time(b) * 1e3 / steps)
    torch.cuda.synchronize()
    kernels.reset_launches()
    times, wall = C.device_profile(call, steps)
    counts = {x: c / steps for x, c in kernels.launches().items() if c}
    busy = sum(times.values())
    return {"wall_us_per_step": min(walls), "walls": walls, "host_us_per_step": min(hosts),
            "hosts": hosts, "device_us_per_step": busy / steps if busy else None,
            "busy_share": busy / (wall * 1e6) if busy and wall else None,
            "launches_per_step": counts}


def runs(dev):
    """``{name: (make runner, call(run, n) -> tensors to digest, steps)}``."""
    import torch

    import chip_smoke as C
    from jrl_lbm_torch.kernels import cyl_sharded as CS
    from jrl_lbm_torch.kernels import jrl_sharded as S
    from jrl_lbm_torch.models import cylinder as CY
    from jrl_lbm_torch.models import jrl as T

    fc = T.JRLFluidConfig(res=(128, 64), Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8,
                          shape="ethaline", refine=8)
    cc = T.JRLCConfig(res=(128, 64), Re=4.0, Pe=5.0, vel_obs_real=0.2848, shape="ethaline",
                      refine=8)
    H, W = fc.eff_res
    s0, fl = T.fluid_init(fc, dev)
    s0 = C.noisy(s0, dev, 71, scale=1e-4)
    st0, cf, flags = T.c_init(cc, dev)
    st0 = T.make_per_step_balance_runner(cc, flags)(st0, cf, 20)
    g = torch.Generator(device=dev).manual_seed(72)
    vf = 0.5 * torch.randn((8, 2, H, W), generator=g, device=dev)
    cfg = CY.CylinderConfig(**C.CYL_MAIN)
    c0, cfl = CY.init(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(81)
    c0 = {k: v + 1e-5 * torch.randn(v.shape, generator=g, device=dev) for k, v in c0.items()}

    def pick(out, names):
        return [out[x] for x in names]

    def approach(run, n):
        out, acc = run(st0, cf, 0, n)
        return pick(out, ("h", "C")) + [torch.as_tensor(acc[x]) for x in sorted(acc)]

    return {
        "fluid": (lambda m: S.make_sharded_tiled_fluid_runner(fc, m),
                  lambda run, n: pick(run(s0, fl, 0, n), ("f", "rho", "vel")), JRL_STEPS),
        "balance": (lambda m: S.make_sharded_tiled_balance_runner(cc, flags, m),
                    lambda run, n: pick(run(st0, cf, n), ("h", "C")), JRL_STEPS),
        "approach": (lambda m: S.make_sharded_tiled_approach_runner(cc, vf, m), approach,
                     JRL_STEPS),
        "cylinder lean k=1": (lambda m: CS.make_sharded_fused_cylinder_runner(cfg, m),
                              lambda run, n: pick(run(c0, cfl, n), ("f", "rho", "vel")),
                              CYL_STEPS),
    }


def main():
    import torch

    import chip_smoke as C
    from jrl_lbm_torch.kernels import build
    from jrl_lbm_torch.kernels import halo as HA
    from jrl_lbm_torch.parallel.mesh import make_mesh

    if not torch.cuda.is_available():
        print("halo_mesh_probe: no CUDA device", file=sys.stderr)
        return 2
    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    print(C.smi_line(), flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.build_all(["fluid_pass_sh", "c_balance_pass_sh", "c_approach_pass_sh", "cyl_pass_sh",
                     "halo_pack", "fluid_a", "fluid_b", "c_balance"])
    print(f"[{label}] built in {time.perf_counter() - t0:.1f} s", flush=True)
    routes = ["default"] + (["shards"] if hasattr(HA, "halo_route") else [])
    rep = {"device": C.smi_line(), "label": label}
    for name, (make, call, steps) in runs(dev).items():
        for mshape in MESHES:
            mesh = make_mesh(mshape, [dev] * (mshape[0] * mshape[1]))
            run = make(mesh)
            digests = {}
            for route in routes:
                def go(n, run=run, call=call, route=route):
                    if route == "default":
                        return call(run, n)
                    # a plain function: a Mock would keep every call's tensors
                    with mock.patch.object(HA, "halo_route", lambda groups, mesh: route):
                        return call(run, n)
                digests[route] = digest(go(steps))
                rec = dict(timed(go, steps, C), digest=digests[route])
                tag = f"{name} {mshape} {route}"
                rep[tag] = rec
                print(f"[{label}] {tag:34s} wall {rec['wall_us_per_step']:9.2f} us/step  host "
                      f"{rec['host_us_per_step']:9.2f}  device "
                      f"{rec['device_us_per_step'] or float('nan'):8.2f}  busy "
                      f"{rec['busy_share'] or float('nan'):.1%}  digest {rec['digest']}  "
                      f"launches {rec['launches_per_step']}", flush=True)
            if len(set(digests.values())) != 1:
                print(f"halo_mesh_probe: FAIL: {name} {mshape}: routes differ {digests}",
                      flush=True)
                return 1
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"halo_mesh_probe_{label}.json"), "w") as fo:
        json.dump(rep, fo, indent=1, default=str)
    print(json.dumps(rep, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
