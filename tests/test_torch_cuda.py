"""The CUDA kernels of the PyTorch port against their plain twins, on an
NVIDIA card; every test skips without one (the kernels have no CPU
mode). The file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` sets up JAX for the rest
of the suite.)

Each per-step kernel is compared one step at a time with its twin, from
the twin's own trajectory, over steps in which the tip crosses a row.
Tolerances: f, rho, C and h at rtol = atol = 1e-5, vel at 1e-4 (float32
sums in another order); the tip-disk integrals at rtol 2e-4 / atol 1e-4.
Each multi-step kernel runs one launch of many steps (a tip-row crossing,
stored-velocity frame boundaries) against the loop of the twins, at the
trajectory tolerances: f, rho, C and h 2e-5, vel 2e-4; the fluid and
balance through both routes (the cluster kernels and the cooperative
ones), which also equal each other bit for bit, and the route each grid
takes is read from the launch counters. The shear
layer's periodic kernel, in each of its seven instances, is held to its
twin after one launch at 1e-6 and over 100 steps at the trajectory
tolerances. The sharded JRL kernels (four shards on the one card) are
held to their twins after one launch at the per-step tolerances, and the
sharded runners to the unsharded per-step kernels bit for bit (the
integrals at rtol 2e-4 / atol 1e-4: summed per shard, in another order);
the sharded fluid step's k-step pass (``fluid_pass_sh``) equals its twin,
run on the CPU, and k steps of the A/B pair bit for bit on every shard,
and its route equals ``route="launches"`` at every k over 50 steps; so do
the sharded C phases' passes (``c_balance_pass_sh``, ``c_approach_pass_sh``:
bit for bit k per-step launches and, h and C, their twins; the approach's
disk sums too, and from step 2**24 - 2), and each pass called without
scratch holds its own until the launch is queued.
The sharded cylinder kernels are held to their twins after one launch at
1e-5 (vel 1e-4), the full-boundary sharded routes to the unsharded
``split=False`` runner bit for bit, the lean split (through the pass
``cyl_pass_sh`` and through the two launches) to the unsharded default
runner on non-OBSTACLE cells (f, rho 2e-5; vel 2e-4) and to its own twin
runner; ``cyl_pass_sh`` equals its twin and the two launches bit for bit
after one pass and the runner through the launches over 201 steps; the
four unsharded cylinder kernels equal their twins bit for bit in all
three storage modes. The lanes of a Pe sweep in one
launch (``fused_approach_lanes``) equal each lane's serial
``fused_approach_cl`` launches bit for bit (h, C, every record row). The
multi-cluster approach (``fused_approach_mc``) equals the cooperative one
bit for bit in h and C over launches whose disk row crosses from one
cluster into the next (``chip_smoke.handover_start``), its integrals bit
for bit where one block held the disk row and within rtol 2e-4 / atol
1e-4 elsewhere.
"""

import ctypes
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke as smoke
from jrl_lbm_torch import kernels, shear_main
from jrl_lbm_torch.kernels import build, jrl_c, jrl_fluid
from jrl_lbm_torch.kernels import cyl_sharded as CS
from jrl_lbm_torch.kernels import cylinder as K
from jrl_lbm_torch.kernels import fused_jrl as F
from jrl_lbm_torch.kernels import halo as HA
from jrl_lbm_torch.kernels import jrl_sharded as S
from jrl_lbm_torch.kernels import jrl_tiled as JT
from jrl_lbm_torch.kernels import periodic as P
from jrl_lbm_torch.models import cylinder as CY
from jrl_lbm_torch.models import jrl as T
from jrl_lbm_torch.models import shear_layer as SL
from jrl_lbm_torch.parallel.halo import pad_halo
from jrl_lbm_torch.parallel.mesh import make_mesh, split
from jrl_lbm_torch.utils.types import CellType, KBCType

RES = (128, 64)
# (shape, refine, Rg): the wedges, the flat tips (the infinite plane at the
# CLI's Rg = 200, wider than the grid) and a refined ethaline grid
SCENES = [("45degree", 1, 4.0), ("cylinder", 1, 4.0), ("infiniteplane", 1, 200.0),
          ("ethaline", 2, 4.0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, tol, tag):
    torch.testing.assert_close(got, want, rtol=tol, atol=tol, msg=lambda m: f"{tag}: {m}")


def _fluid_steps(dev, shape, refine, rg):
    """Yield ``(cfg, fields, state, k)`` along the twin's fluid trajectory,
    over steps in which the tip crosses a row."""
    cfg = T.JRLFluidConfig(res=RES, Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8,
                           shape=shape, refine=refine, Rg=rg)
    s, fields = T.fluid_init(cfg, dev)
    step = T.make_fluid_step(cfg)
    s = T.make_fluid_runner(cfg)(s, fields, 0, 8)
    steps = range(8, 8 + int(1.5 / cfg.vel_obs))
    assert T.tip_walks(cfg.inflow_height, steps[-1], cfg.vel_obs)[1] > T.tip_walks(
        cfg.inflow_height, steps[0], cfg.vel_obs)[1]
    for k in steps:
        yield cfg, fields, s, k
        s = step(s, fields, k)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,refine,rg", SCENES)
def test_cuda_fluid_a_matches_twin(cuda, shape, refine, rg):
    n0, n = jrl_fluid.fluid_a.launches, 0
    for cfg, fields, s, k in _fluid_steps(cuda, shape, refine, rg):
        a = jrl_fluid.fluid_a(s["f"], s["rho"], s["vel"], k, cfg, fields)
        ar = jrl_fluid.fluid_a_ref(s["f"], s["rho"], s["vel"], k, cfg, fields)
        for name, got, want, tol in zip(("f", "rho", "vel"), a, ar, (1e-5, 1e-5, 1e-4)):
            _close(got, want, tol, f"fluid_a step {k} {name}")
        n += 1
    torch.cuda.synchronize()
    assert jrl_fluid.fluid_a.launches - n0 == n


@pytest.mark.cuda
@pytest.mark.parametrize("shape,refine,rg", SCENES)
def test_cuda_fluid_b_matches_twin(cuda, shape, refine, rg):
    n0, n = jrl_fluid.fluid_b.launches, 0
    for cfg, fields, s, k in _fluid_steps(cuda, shape, refine, rg):
        ar = jrl_fluid.fluid_a_ref(s["f"], s["rho"], s["vel"], k, cfg, fields)
        _close(jrl_fluid.fluid_b(*ar, k, cfg, fields), jrl_fluid.fluid_b_ref(*ar, k, cfg, fields),
               1e-5, f"fluid_b step {k} f")
        n += 1
    torch.cuda.synchronize()
    assert jrl_fluid.fluid_b.launches - n0 == n


def _c_setup(dev, shape, refine, rg, is_negative):
    cfg = T.JRLCConfig(res=RES, Re=4.0, Pe=5.0, shape=shape, refine=refine, Rg=rg,
                       is_negative=is_negative)
    st, fields, flags = T.c_init(cfg, dev)
    return cfg, T.make_balance_runner(cfg, flags)(st, fields, 5), fields, flags


@pytest.mark.cuda
@pytest.mark.parametrize("is_negative", [True, False])
@pytest.mark.parametrize("shape,refine,rg", SCENES)
def test_cuda_c_balance_matches_twin(cuda, shape, refine, rg, is_negative):
    cfg, st, fields, flags = _c_setup(cuda, shape, refine, rg, is_negative)
    step = T.make_balance_step(cfg, flags)
    n0 = jrl_c.c_balance.launches
    for k in range(3):
        h, C = jrl_c.c_balance(st["h"], st["C"], flags, cfg, fields)
        hr, Cr = jrl_c.c_balance_ref(st["h"], st["C"], flags, cfg, fields)
        _close(h, hr, 1e-5, f"c_balance step {k} h")
        _close(C, Cr, 1e-5, f"c_balance step {k} C")
        st = step(st, fields)
    torch.cuda.synchronize()
    assert jrl_c.c_balance.launches - n0 == 3


@pytest.mark.cuda
@pytest.mark.parametrize("is_negative", [True, False])
@pytest.mark.parametrize("shape,refine,rg", SCENES)
def test_cuda_c_approach_matches_twin(cuda, shape, refine, rg, is_negative):
    cfg, st, fields, _ = _c_setup(cuda, shape, refine, rg, is_negative)
    H, W = cfg.eff_res
    vf = np.random.default_rng(5).uniform(-0.5, 0.5, (3, 2, H, W)).astype(np.float32)
    vf = torch.as_tensor(vf, device=cuda)
    step = T.make_approach_step(cfg)
    fields = dict(fields, vel_field=vf)
    n0 = jrl_c.c_approach.launches
    steps = range(3, 3 + int(1.5 / cfg.vel_obs_conv))  # the tip crosses a row
    for k in steps:
        vel = T.stored_velocity(vf, k, cfg.vel_obs_conv)
        acc = torch.zeros(4, device=cuda)
        h, C = jrl_c.c_approach(st["h"], st["C"], vel, k, cfg, fields, acc)
        hr, Cr, ints = jrl_c.c_approach_ref(st["h"], st["C"], vel, k, cfg, fields)
        _close(h, hr, 1e-5, f"c_approach step {k} h")
        _close(C, Cr, 1e-5, f"c_approach step {k} C")
        np.testing.assert_allclose(acc.cpu().numpy(), [float(x) for x in ints], rtol=2e-4,
                                   atol=1e-4, err_msg=f"c_approach step {k} integrals")
        st, _ = step(st, fields, k)
    torch.cuda.synchronize()
    assert jrl_c.c_approach.launches - n0 == len(steps)


# --- the multi-step kernels (kernels/fused_jrl.py) ---

TRAJ_TOL = {"f": 2e-5, "rho": 2e-5, "vel": 2e-4, "h": 2e-5, "C": 2e-5}


# the kernel each route of fused_fluid / fused_balance launches
ROUTE_KERNEL = {("fused_fluid", "coop"): "fused_fluid",
                ("fused_fluid", "cluster"): "fused_fluid_cl",
                ("fused_balance", "coop"): "fused_balance",
                ("fused_balance", "cluster"): "fused_balance_cl",
                ("fused_approach", "coop"): "fused_approach",
                ("fused_approach", "cluster"): "fused_approach_cl",
                ("fused_fluid", "clusters"): "fused_fluid_mc",
                ("fused_balance", "clusters"): "fused_balance_mc",
                ("fused_approach", "clusters"): "fused_approach_mc",
                ("fused_fluid", "tiles"): "fused_fluid_tl",
                ("fused_approach", "rows"): "fused_approach_rw"}


def _launched(name, route):
    return getattr(F, ROUTE_KERNEL[(name, route)]).launches


@pytest.mark.cuda
@pytest.mark.parametrize("route", F.ROUTES)
@pytest.mark.parametrize("shape,refine,rg", SCENES)
def test_cuda_fused_fluid_matches_twin(cuda, shape, refine, rg, route):
    """One launch across a tip-row crossing, for an odd and an even step
    count (the final state lands in the outputs either way), through the
    cluster kernel (every scene fits one cluster, 256x128 at 4 cells a
    thread) and the cooperative kernel."""
    cfg = T.JRLFluidConfig(res=RES, Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8,
                           shape=shape, refine=refine, Rg=rg)
    s, fields = T.fluid_init(cfg, cuda)
    s = T.make_fluid_runner(cfg)(s, fields, 0, 8)
    n = int(1.5 / cfg.vel_obs)
    assert T.tip_walks(cfg.inflow_height, 8 + n, cfg.vel_obs)[1] > T.tip_walks(
        cfg.inflow_height, 8, cfg.vel_obs)[1]
    want = F.fused_fluid_ref(s["f"], s["rho"], s["vel"], 8, n, cfg, fields)
    n0 = _launched("fused_fluid", route)
    for m in (n, n + 1):
        got = F.fused_fluid(s["f"], s["rho"], s["vel"], 8, m, cfg, fields, route=route)
        for name, g, w in zip(("f", "rho", "vel"), got, want):
            _close(g, w, TRAJ_TOL[name], f"fused_fluid ({route}) {m} steps {name}")
        want = F.fused_fluid_ref(*want, 8 + m, 1, cfg, fields)
    torch.cuda.synchronize()
    assert _launched("fused_fluid", route) - n0 == 2


@pytest.mark.cuda
@pytest.mark.parametrize("route", F.ROUTES)
@pytest.mark.parametrize("is_negative", [True, False])
@pytest.mark.parametrize("shape,refine,rg", SCENES)
def test_cuda_fused_balance_matches_twin(cuda, shape, refine, rg, is_negative, route):
    cfg, st, fields, flags = _c_setup(cuda, shape, refine, rg, is_negative)
    n0 = _launched("fused_balance", route)
    want = F.fused_balance_ref(st["h"], st["C"], flags, 20, cfg, fields)
    for m in (20, 21):
        got = F.fused_balance(st["h"], st["C"], flags, m, cfg, fields, route=route)
        _close(got[0], want[0], TRAJ_TOL["h"], f"fused_balance ({route}) {m} steps h")
        _close(got[1], want[1], TRAJ_TOL["C"], f"fused_balance ({route}) {m} steps C")
        want = F.fused_balance_ref(*want, flags, 1, cfg, fields)
    torch.cuda.synchronize()
    assert _launched("fused_balance", route) - n0 == 2


def _equal(got, want, tag):
    torch.testing.assert_close(got, want, rtol=0, atol=0, msg=lambda m: f"{tag}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["45degree", "cylinder"])
def test_cuda_cluster_kernels_equal_cooperative_bit_for_bit(cuda, shape):
    """The cluster kernels equal the cooperative ones bit for bit (same
    cell code, only where the bytes live differs): one 1000-step launch
    and two chained launches (400 + 601 steps) at 128x64, the balance
    with ``is_negative`` both ways."""
    cfg = T.JRLFluidConfig(res=RES, Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8,
                           shape=shape)
    s, fields = T.fluid_init(cfg, cuda)
    s = T.make_fluid_runner(cfg)(s, fields, 0, 8)
    x = (s["f"], s["rho"], s["vel"])
    runs = {r: (F.fused_fluid(*x, 8, 1000, cfg, fields, route=r),
                F.fused_fluid(*F.fused_fluid(*x, 8, 400, cfg, fields, route=r), 408, 601, cfg,
                              fields, route=r)) for r in F.ROUTES}
    for k, (a, b) in enumerate(zip(*runs.values())):
        for name, g, w in zip(("f", "rho", "vel"), a, b):
            _equal(g, w, f"fused_fluid run {k} {name}")
    for neg in (True, False):
        cc, st, cf, flags = _c_setup(cuda, shape, 1, 4.0, neg)
        runs = {r: (F.fused_balance(st["h"], st["C"], flags, 1000, cc, cf, route=r),
                    F.fused_balance(*F.fused_balance(st["h"], st["C"], flags, 400, cc, cf,
                                                     route=r), flags, 601, cc, cf, route=r))
                for r in F.ROUTES}
        for k, (a, b) in enumerate(zip(*runs.values())):
            for name, g, w in zip(("h", "C"), a, b):
                _equal(g, w, f"fused_balance neg={neg} run {k} {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("is_negative", [True, False])
@pytest.mark.parametrize("shape,refine,rg", SCENES)
def test_cuda_fused_approach_matches_twin(cuda, shape, refine, rg, is_negative):
    """One launch over stored-velocity frame boundaries (a new frame pair
    every ~3 steps) and a tip-row crossing, with the integrals."""
    probe = T.JRLCConfig(res=RES, shape=shape, refine=refine, Rg=rg)
    Pe = 0.03 * probe.radius_obs / (0.5 / 3.0)  # tip speed 0.03: ~3.3 steps per frame
    cfg = T.JRLCConfig(res=RES, Re=4.0, Pe=Pe, shape=shape, refine=refine, Rg=rg,
                       is_negative=is_negative)
    st, fields, flags = T.c_init(cfg, cuda)
    st = T.make_balance_runner(cfg, flags)(st, fields, 5)
    H, W = cfg.eff_res
    n = int(1.5 / cfg.vel_obs_conv)
    vf = np.random.default_rng(6).uniform(-0.5, 0.5, (20, 2, H, W)).astype(np.float32)
    vf = torch.as_tensor(vf, device=cuda)
    assert int(n * cfg.vel_obs_conv / 0.1) >= 10  # frame boundaries inside the run
    acc = torch.zeros(4, device=cuda)
    routed = ROUTE_KERNEL[("fused_approach", F.fused_route(
        "fused_approach", H, W, F.card_limits("fused_approach", 0)))]
    kernels.reset_launches()
    h, C = F.fused_approach(st["h"], st["C"], vf, 0, n, cfg, fields, acc)
    hr, Cr, ints = F.fused_approach_ref(st["h"], st["C"], vf, 0, n, cfg, fields)
    _close(h, hr, TRAJ_TOL["h"], "fused_approach h")
    _close(C, Cr, TRAJ_TOL["C"], "fused_approach C")
    np.testing.assert_allclose(acc.cpu().numpy(), [float(x) for x in ints], rtol=2e-4,
                               atol=1e-4, err_msg="fused_approach integrals")
    torch.cuda.synchronize()
    assert {k: c for k, c in kernels.launches().items() if c} == {routed: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("route", F.ROUTES)
@pytest.mark.parametrize("shape", ["45degree", "cylinder"])
def test_cuda_fluid_from_step_2_24_minus_5_matches_twin(cuda, shape, route):
    """Steps 2**24 - 5 .. 2**24 + 4 (float32 rounds the step from 2**24 on)
    through the multi-step kernel of each route and through fluid_a /
    fluid_b; Re is small enough that the tip is inside the grid there."""
    cfg = T.JRLFluidConfig(res=RES, Re=1.2e-5, shape=shape)
    start, n = 2**24 - 5, 10
    assert 1 < T.tip_walks(cfg.inflow_height, start + n, cfg.vel_obs)[1] < RES[0] - 1
    s, fields = T.fluid_init(cfg, cuda)
    rng = np.random.default_rng(24)
    s = {k: v + torch.as_tensor((1e-3 * rng.standard_normal(tuple(v.shape))).astype(np.float32),
                                device=cuda) for k, v in s.items()}
    want = F.fused_fluid_ref(s["f"], s["rho"], s["vel"], start, n, cfg, fields)
    got = F.fused_fluid(s["f"], s["rho"], s["vel"], start, n, cfg, fields, route=route)
    per_step = T.make_per_step_fluid_runner(cfg)(s, fields, start, n)
    for name, g, w in zip(("f", "rho", "vel"), got, want):
        _close(g, w, TRAJ_TOL[name], f"fused_fluid {name}")
        _close(per_step[name], w, TRAJ_TOL[name], f"fluid_a/fluid_b {name}")


@pytest.mark.cuda
def test_cuda_fused_grid_over_coresident_limit_raises(cuda):
    """The co-residency check passes the limit and refuses one block more,
    and the launcher itself refuses such a grid without launching."""
    index = torch.cuda.current_device()
    for name in ("fused_fluid", "fused_balance", "fused_approach"):
        for cpt in F.CELLS_PER_THREAD:
            limit = F.max_blocks(name, cpt, F.FUSED_BLOCK, index)
            assert limit >= 1
            F.check_coresident(name, cpt, F.FUSED_BLOCK, limit, index)
            with pytest.raises(ValueError, match="co-resident"):
                F.check_coresident(name, cpt, F.FUSED_BLOCK, limit + 1, index)
    cfg, st, fields, flags = _c_setup(cuda, "45degree", 1, 4.0, True)
    out = [torch.empty_like(st["h"]), torch.empty_like(st["C"])] * 2
    limit = F.max_blocks("fused_balance", 1, F.FUSED_BLOCK, index)
    fn = build.bind("fused_balance", "jrl_fused_balance", [jrl_fluid._P] * 7 + [
        ctypes.c_int, jrl_fluid._P, ctypes.c_int, ctypes.c_int, jrl_fluid._P])
    n0 = F.fused_balance.launches
    err = fn(flags.data_ptr(), st["h"].data_ptr(), st["C"].data_ptr(),
             *(t.data_ptr() for t in out), 1, ctypes.byref(F._balance_params(cfg)), 1, limit + 1,
             jrl_fluid.stream_of(cuda))
    assert err != 0
    with pytest.raises(RuntimeError, match="cudaError"):
        build.check(err, "fused_balance")
    assert F.fused_balance.launches == n0


@pytest.mark.cuda
def test_cuda_fused_route_by_grid(cuda):
    """The runners take the cluster kernels at 128x64, the multi-cluster
    balance at 256x128 and 512x256 (refine 2, 4), the fluid's tile kernel
    at both, the approach's row kernel at both, read from the launch
    counters; above the multi-step
    kernels' limit (1024x512) the approach takes c_approach_pass, once a
    step."""
    for refine, route, route_c in ((1, ("cluster", "cluster"), "cluster"),
                                   (2, ("tiles", "clusters"), "rows"),
                                   (4, ("tiles", "clusters"), "rows")):
        fc = T.JRLFluidConfig(res=RES, shape="ethaline", refine=refine)
        cc = T.JRLCConfig(res=RES, shape="ethaline", refine=refine)
        H, W = fc.eff_res
        for name, want in zip(("fused_fluid", "fused_balance", "fused_approach"),
                              route + (route_c,)):
            assert F.fused_route(name, H, W, F.card_limits(name, 0)) == want, (name, refine)
        s, fl = T.fluid_init(fc, cuda)
        st, cf, flags = T.c_init(cc, cuda)
        vf = torch.zeros((2, 2, H, W), device=cuda)
        kernels.reset_launches()
        if refine != 2:
            T.pick_fluid_runner(fc)(s, fl, 0, 3)
            T.pick_balance_runner(cc, flags)(st, cf, 3)
        T.pick_approach_runner(cc, vf)(st, cf, 0, 3)
        torch.cuda.synchronize()
        counts = {k: c for k, c in kernels.launches().items() if c}
        want = {ROUTE_KERNEL[(name, r)]: 1 for name, r in zip(("fused_fluid", "fused_balance"),
                                                              route)} if refine != 2 else {}
        assert counts == dict(want, **{ROUTE_KERNEL[("fused_approach", route_c)]: 1}), \
            (refine, counts)
    cc = T.JRLCConfig(res=RES, shape="ethaline", refine=8)
    st, cf, _ = T.c_init(cc, cuda)
    kernels.reset_launches()
    T.pick_approach_runner(cc, torch.zeros((2, 2) + cc.eff_res, device=cuda))(st, cf, 0, 3)
    torch.cuda.synchronize()
    assert {k: c for k, c in kernels.launches().items() if c} == {"c_approach_pass": 3}


@pytest.mark.cuda
def test_cuda_forced_cluster_route_over_limit_raises(cuda):
    """A forced cluster route on a grid over the cluster limit (512x256)
    raises before any launch, and the launcher itself refuses a shape that
    does not match the grid."""
    fc = T.JRLFluidConfig(res=RES, shape="ethaline", refine=4)
    cc = T.JRLCConfig(res=RES, shape="ethaline", refine=4)
    s, fl = T.fluid_init(fc, cuda)
    st, cf, flags = T.c_init(cc, cuda)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="cluster limit"):
        F.fused_fluid(s["f"], s["rho"], s["vel"], 0, 2, fc, fl, route="cluster")
    with pytest.raises(ValueError, match="cluster limit"):
        F.fused_balance_cl(st["h"], st["C"], flags, 2, cc, cf)
    with pytest.raises(ValueError, match="route"):
        F.fused_balance(st["h"], st["C"], flags, 2, cc, cf, route="tiles")
    assert not any(kernels.launches().values())
    cfg, st, fields, flags = _c_setup(cuda, "45degree", 1, 4.0, True)
    blocks, cpt, smem = F.cluster_shape("fused_balance", *cfg.eff_res,
                                        F.card_limits("fused_balance", 0))
    out = [torch.empty_like(st["h"]), torch.empty_like(st["C"])]
    fn = build.bind("fused_balance_cl", "jrl_fused_balance_cl", [jrl_fluid._P] * 5 + [
        ctypes.c_int, jrl_fluid._P] + [ctypes.c_int] * 3 + [jrl_fluid._P])
    for bad in ((blocks, cpt, smem + 4), (blocks, cpt, smem // 2), (4, cpt, smem)):
        err = fn(flags.data_ptr(), st["h"].data_ptr(), st["C"].data_ptr(),
                 *(t.data_ptr() for t in out), 1, ctypes.byref(F._balance_params(cfg)), *bad,
                 jrl_fluid.stream_of(cuda))
        assert err != 0, bad
        with pytest.raises(RuntimeError, match="cudaError"):
            build.check(err, "fused_balance_cl")
    assert F.fused_balance_cl.launches == 0


# --- the fluid and balance of 256x128 and 512x256 on every cluster: *_mc ---

# (shape, res, refine) of the multi-cluster kernels' grids: refine 2 and 4
# of the ethaline case, the flat tip and the wedge at the same sizes, and
# heights that no plan divides evenly (bands of 3 and 4 rows)
MC_GRIDS = [("ethaline", RES, 2), ("ethaline", RES, 4), ("cylinder", (256, 128), 1),
            ("cylinder", (512, 256), 1), ("45degree", (256, 128), 1),
            ("45degree", (512, 256), 1)]


def _mc_state(dev, shape, res, refine, seed, cfg=None):
    cfg = cfg or T.JRLFluidConfig(res=res, Re=4.0, vel_obs_real=0.2848,
                                  gravity_strength_real=-9.8, shape=shape, refine=refine)
    s, fields = T.fluid_init(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    s = {k: v + 1e-3 * torch.randn(v.shape, generator=g, device=dev) for k, v in s.items()}
    return cfg, s, fields


def _mc_c_state(dev, shape, res, refine, is_negative, seed):
    cfg = T.JRLCConfig(res=res, Re=4.0, Pe=5.0, shape=shape, refine=refine,
                       is_negative=is_negative)
    st, fields, flags = T.c_init(cfg, dev)
    st = F.fused_balance(st["h"], st["C"], flags, 50, cfg, fields, route="coop")
    g = torch.Generator(device=dev).manual_seed(seed)
    st = tuple(v + 1e-3 * torch.randn(v.shape, generator=g, device=dev) for v in st)
    return cfg, st, fields, flags


def _mc_equal_coop(cuda, shape, res, refine, n, start=0, tag=""):
    """fused_fluid_mc and fused_balance_mc (both signs of is_negative) over
    one n-step launch against route="coop", bit for bit."""
    cfg, s, fl = _mc_state(cuda, shape, res, refine, 31)
    H, W = cfg.eff_res
    x = (s["f"], s["rho"], s["vel"])
    n0 = F.fused_fluid_mc.launches
    for name, g, w in zip(("f", "rho", "vel"),
                          F.fused_fluid(*x, start, n, cfg, fl, route="clusters"),
                          F.fused_fluid(*x, start, n, cfg, fl, route="coop")):
        _equal(g, w, f"{tag}fused_fluid_mc {shape} {H}x{W} {name}")
    for neg in (True, False):
        cc, st, cf, flags = _mc_c_state(cuda, shape, res, refine, neg, 32)
        for name, g, w in zip(("h", "C"),
                              F.fused_balance(*st, flags, n, cc, cf, route="clusters"),
                              F.fused_balance(*st, flags, n, cc, cf, route="coop")):
            _equal(g, w, f"{tag}fused_balance_mc {shape} {H}x{W} neg={neg} {name}")
    torch.cuda.synchronize()
    assert F.fused_fluid_mc.launches == n0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape,res,refine", MC_GRIDS)
def test_cuda_mc_kernels_equal_coop_bit_for_bit(cuda, shape, res, refine):
    """The multi-cluster kernels on the plan the card gives equal the
    cooperative ones bit for bit over a 1000-step launch."""
    _mc_equal_coop(cuda, shape, res, refine, 1000)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,res", [("cylinder", (500, 256)), ("45degree", (250, 128)),
                                       ("cylinder", (256, 124))])
def test_cuda_mc_kernels_equal_coop_on_uneven_bands(cuda, shape, res):
    """Heights that no plan of the card divides evenly (bands that differ
    by one row) and a width that is not a multiple of 8."""
    lim = F.card_limits("fused_fluid", 0)
    plan = F.mc_plan("fused_fluid", *res, lim)
    assert res[0] % (plan.clusters * plan.cluster) != 0 or res[1] % 8
    _mc_equal_coop(cuda, shape, res, 1, 600)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", F.MC_SIZES)
def test_cuda_mc_kernels_equal_coop_on_every_cluster_size(cuda, cluster):
    """Each cluster size a plan may take, forced, at 256x128 and 512x256
    (refine 2 and 4): bit for bit the cooperative kernels."""
    for refine in (2, 4):
        cfg, s, fl = _mc_state(cuda, "ethaline", RES, refine, 33)
        H, W = cfg.eff_res
        x = (s["f"], s["rho"], s["vel"])
        for name in ("fused_fluid", "fused_balance"):
            plan = F.mc_plan(name, H, W, F.card_limits(name, 0), cluster=cluster)
            if plan is None:
                continue
            if name == "fused_fluid":
                got = F.fused_fluid_mc(*x, 0, 400, cfg, fl, plan=plan)
                want = F.fused_fluid(*x, 0, 400, cfg, fl, route="coop")
            else:
                cc, st, cf, flags = _mc_c_state(cuda, "ethaline", RES, refine, True, 34)
                got = F.fused_balance_mc(*st, flags, 400, cc, cf, plan=plan)
                want = F.fused_balance(*st, flags, 400, cc, cf, route="coop")
            for k, (g, w) in enumerate(zip(got, want)):
                _equal(g, w, f"{name} {H}x{W} plan {plan} output {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("res", [(256, 128), (512, 256)])
def test_cuda_mc_fluid_across_2_24(cuda, res):
    """Steps 2**24 - 100 .. 2**24 + 99 (float32 rounds the step from 2**24
    on; Re small enough that the tip is inside the grid there): bit for
    bit the cooperative kernel, and within 2e-5 / 2e-4 of the twin over
    the ten steps around 2**24."""
    for shape in ("45degree", "cylinder"):
        cfg, s, fl = _mc_state(cuda, shape, res, 1, 35,
                               cfg=T.JRLFluidConfig(res=res, Re=1.2e-5, shape=shape))
        start = 2**24 - 100
        assert 1 < T.tip_walks(cfg.inflow_height, start + 200, cfg.vel_obs)[1] < res[0] - 1
        x = (s["f"], s["rho"], s["vel"])
        for name, g, w in zip(("f", "rho", "vel"), F.fused_fluid_mc(*x, start, 200, cfg, fl),
                              F.fused_fluid(*x, start, 200, cfg, fl, route="coop")):
            _equal(g, w, f"{shape} {res} across 2**24 {name}")
        want = F.fused_fluid_ref(*x, 2**24 - 5, 10, cfg, fl)
        for name, g, w in zip(("f", "rho", "vel"), F.fused_fluid_mc(*x, 2**24 - 5, 10, cfg, fl),
                              want):
            _close(g, w, TRAJ_TOL[name], f"{shape} {res} twin across 2**24 {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("refine", [2, 4])
def test_cuda_mc_kernels_match_twin(cuda, refine):
    """One launch across a tip-row crossing against the loop of the twins:
    f, rho 2e-5, vel 2e-4; h, C 2e-5."""
    cfg, s, fl = _mc_state(cuda, "ethaline", RES, refine, 36)
    n = int(1.5 / cfg.vel_obs)
    assert T.tip_walks(cfg.inflow_height, n, cfg.vel_obs)[1] > T.tip_walks(
        cfg.inflow_height, 0, cfg.vel_obs)[1]
    x = (s["f"], s["rho"], s["vel"])
    for name, g, w in zip(("f", "rho", "vel"), F.fused_fluid_mc(*x, 0, n, cfg, fl),
                          F.fused_fluid_ref(*x, 0, n, cfg, fl)):
        _close(g, w, TRAJ_TOL[name], f"fused_fluid_mc refine {refine} {name}")
    cc, st, cf, flags = _mc_c_state(cuda, "ethaline", RES, refine, False, 37)
    for name, g, w in zip(("h", "C"), F.fused_balance_mc(*st, flags, 300, cc, cf),
                          F.fused_balance_ref(*st, flags, 300, cc, cf)):
        _close(g, w, TRAJ_TOL[name], f"fused_balance_mc refine {refine} {name}")


# the fluid's tile kernel: the three tips at 256x128 and 512x256 (refine 2
# and 4 of the ethaline case)
TL_GRIDS = [(shape, res) for shape in ("ethaline", "45degree", "cylinder")
            for res in ((256, 128), (512, 256))]


def _tl_state(dev, shape, res, seed, **kw):
    """``(cfg, fields, state)`` of the fluid at ``res``: the ethaline case
    at its refine, the other tips at that grid; seeded noise on the init."""
    kw = dict(dict(Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8), **kw)
    cfg = T.JRLFluidConfig(res=RES, shape=shape, refine=res[0] // RES[0], **kw) \
        if shape == "ethaline" else T.JRLFluidConfig(res=res, shape=shape, **kw)
    assert cfg.eff_res == res
    cfg_, s, fl = _mc_state(dev, shape, res, 1, seed, cfg=cfg)
    return cfg_, fl, s


def _row_crossing(cfg, n: int) -> int:
    """A first step from which ``n`` steps cross a tip row."""
    walks, row = T.tip_walks(cfg.inflow_height, 0, cfg.vel_obs)
    nxt = int(np.ceil((row + 0.5 - cfg.inflow_height) / cfg.vel_obs))
    start = max(0, nxt - n // 2)
    assert T.tip_walks(cfg.inflow_height, start + n - 1, cfg.vel_obs)[1] > T.tip_walks(
        cfg.inflow_height, start, cfg.vel_obs)[1]
    return start


@pytest.mark.cuda
@pytest.mark.parametrize("shape,res", TL_GRIDS)
def test_cuda_fused_fluid_tl_equals_coop_bit_for_bit(cuda, shape, res):
    """`fused_fluid_tl` on the card's plan equals the cooperative
    `fused_fluid` bit for bit over a 1000-step launch across a tip row, and
    over one from step 2**24 - 5 (Re small enough that the tip is inside
    the grid there); one launch each."""
    cfg, fl, s = _tl_state(cuda, shape, res, 50)
    x = (s["f"], s["rho"], s["vel"])
    n0 = F.fused_fluid_tl.launches
    start = _row_crossing(cfg, 1000)
    for name, g, w in zip(("f", "rho", "vel"), F.fused_fluid_tl(*x, start, 1000, cfg, fl),
                          F.fused_fluid(*x, start, 1000, cfg, fl, route="coop")):
        _equal(g, w, f"fused_fluid_tl {shape} {res} from {start} {name}")
    cfg, fl, s = _tl_state(cuda, shape, res, 51, Re=1.2e-5, vel_obs_real=28e-6,
                           gravity_strength_real=0.0)
    start = 2**24 - 5
    assert 1 < T.tip_walks(cfg.inflow_height, start + 1000, cfg.vel_obs)[1] < res[0] - 1
    x = (s["f"], s["rho"], s["vel"])
    for name, g, w in zip(("f", "rho", "vel"), F.fused_fluid_tl(*x, start, 1000, cfg, fl),
                          F.fused_fluid(*x, start, 1000, cfg, fl, route="coop")):
        _equal(g, w, f"fused_fluid_tl {shape} {res} across 2**24 {name}")
    torch.cuda.synchronize()
    assert F.fused_fluid_tl.launches == n0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(8, 64), (16, 16), (24, 40), (64, 16)])
def test_cuda_fused_fluid_tl_on_forced_tiles(cuda, tile):
    """Tile shapes other than the plan's (several waves of tiles, strips of
    unequal width, bands that do not divide the rows): bit for bit the
    cooperative kernel over 300 steps at 512x256 (wedge) and 256x128
    (flat tip); and the tile twin, run on the CPU, within the trajectory
    tolerances over 4 steps."""
    for shape, res in (("45degree", (512, 256)), ("cylinder", (256, 128))):
        cfg, fl, s = _tl_state(cuda, shape, res, 52)
        plan = S.tile_plan(S.Shard.of(*res, (1, 1), (0, 0)), 1, *tile,
                           jrl_fluid.sm_count(cuda))
        x = (s["f"], s["rho"], s["vel"])
        for name, g, w in zip(("f", "rho", "vel"), F.fused_fluid_tl(*x, 7, 300, cfg, fl, plan),
                              F.fused_fluid(*x, 7, 300, cfg, fl, route="coop")):
            _equal(g, w, f"fused_fluid_tl {shape} {res} tiles {tile} {name}")
    cfg, fl, s = _tl_state(cuda, "45degree", (256, 128), 53)
    plan = S.tile_plan(S.Shard.of(256, 128, (1, 1), (0, 0)), 1, *tile, jrl_fluid.sm_count(cuda))
    x = (s["f"], s["rho"], s["vel"])
    cpu = [t.cpu() for t in x]
    _, fl_cpu = T.fluid_init(cfg, "cpu")
    for name, g, w in zip(("f", "rho", "vel"), F.fused_fluid_tl(*x, 3, 4, cfg, fl, plan),
                          F.fused_fluid_tl_ref(*cpu, 3, 4, cfg, fl_cpu, plan)):
        _close(g.cpu(), w, TRAJ_TOL[name], f"fused_fluid_tl vs twin tiles {tile} {name}")


@pytest.mark.cuda
def test_cuda_fused_fluid_tl_runner_and_shape(cuda, monkeypatch):
    """The runner at 512x256 (refine 4) goes through `fused_fluid_tl`, one
    launch a chunk, its state checked once a run, bit for bit the
    cooperative kernel's runner; the kernel's launch shape is the host
    plan's (512 threads, one block an SM, the tables' bytes), with no
    spills."""
    cfg, fl, s = _tl_state(cuda, "ethaline", (512, 256), 54)
    H, W = cfg.eff_res
    monkeypatch.setattr(F, "MAX_LAUNCH_CELL_STEPS", dict(F.MAX_LAUNCH_CELL_STEPS,
                                                         fused_fluid=64 * H * W))
    kernels.reset_launches()
    got = F.make_fused_fluid_runner(cfg)(s, fl, 11, 150)
    torch.cuda.synchronize()
    assert {k: c for k, c in kernels.launches().items() if c} == {"fused_fluid_tl": 3}
    want = {"f": s["f"], "rho": s["rho"], "vel": s["vel"]}
    for a, m in ((11, 64), (75, 64), (139, 22)):
        want = dict(zip(("f", "rho", "vel"), F.fused_fluid(
            want["f"], want["rho"], want["vel"], a, m, cfg, fl, route="coop")))
    for k in want:
        _equal(got[k], want[k], f"runner {k}")
    plan = F.tl_plan(H, W, jrl_fluid.sm_count(cuda))
    threads, cap, nbytes, most = F.tl_tile_shape(plan.rmax, plan.smax)
    assert (threads, cap, nbytes) == (S.TILE_THREADS, S.TILE_SMEM_CAP,
                                      S.tile_smem_bytes(plan.rmax, plan.smax))
    assert most >= plan.grid and plan.grid <= jrl_fluid.sm_count(cuda)
    regs, local = F.tl_info()
    assert local == 0 and 0 < regs <= 128, (regs, local)


@pytest.mark.cuda
def test_cuda_fused_fluid_tl_refuses_bad_inputs(cuda):
    """Rows that are not 16-byte multiples raise before launch; a plan over
    the co-resident limit, or whose tiles leave the rows, is refused by the
    launcher (nothing launched)."""
    cfg, fl, s = _tl_state(cuda, "45degree", (512, 256), 55)
    x = (s["f"], s["rho"], s["vel"])
    odd = T.JRLFluidConfig(res=(256, 126), shape="cylinder")
    so, flo = T.fluid_init(odd, cuda)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        F.fused_fluid_tl(so["f"], so["rho"], so["vel"], 0, 2, odd, flo)
    plan = F.tl_plan(512, 256, jrl_fluid.sm_count(cuda))
    most = F.tl_tile_shape(plan.rmax, plan.smax)[3]
    for bad, code in ((dataclasses.replace(plan, grid=most + 1), "cudaError 720"),
                      (dataclasses.replace(plan, nty=(plan.nty[0] // 2,)), "cudaError"),
                      (dataclasses.replace(plan, rmax=512), "cudaError")):
        with pytest.raises(RuntimeError, match=code):
            F.fused_fluid_tl(*x, 0, 2, cfg, fl, bad)
    torch.cuda.synchronize()
    assert not any(kernels.launches().values())


# the approach's row kernel: the three tips at 256x128 and 512x256 (the
# default case's approach at refine 2 and 4, the other tips at that grid)
RW_GRIDS = TL_GRIDS


def _rw_cfg(shape, res, **kw):
    cfg = T.JRLCConfig(shape=shape, refine=res[0] // RES[0], **kw) if shape == "ethaline" \
        else T.JRLCConfig(res=res, shape=shape, **kw)
    assert cfg.eff_res == res
    return cfg


def _rw_equal_coop(dev, cfg, st, fields, start, n, vf, tag, plan=None):
    """`fused_approach_rw` (``plan``, else the card's) over one n-step
    launch against ``route="coop"``: h, C and acc bit for bit, one launch."""
    accs = [torch.full((4,), 0.5, device=dev) for _ in range(2)]
    n0 = F.fused_approach_rw.launches
    got = F.fused_approach_rw(st["h"], st["C"], vf, start, n, cfg, fields, accs[0], plan=plan)
    want = F.fused_approach(st["h"], st["C"], vf, start, n, cfg, fields, accs[1], route="coop")
    for name, g, w in zip(("h", "C", "acc"), list(got) + accs[:1], list(want) + accs[1:]):
        _equal(g, w, f"fused_approach_rw {tag} {name}")
    torch.cuda.synchronize()
    assert F.fused_approach_rw.launches == n0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape,res", RW_GRIDS)
def test_cuda_fused_approach_rw_equals_coop_bit_for_bit(cuda, shape, res):
    """`fused_approach_rw` on the card's plan equals the cooperative
    `fused_approach` bit for bit (h, C and the four sums) over a 1000-step
    launch across a stored frame at the case's tip speed, one across tip
    rows (0.005 rows a step), and one from step 2**24 - 5 on the history's
    last frame (Pe small enough that the tip is inside the grid there)."""
    cfg = _rw_cfg(shape, res)
    st, fields = _noisy_c(cfg, cuda, 60)
    v = cfg.vel_obs_conv
    start = max(0, int(T.X_INTERVAL / v) - 500)
    vf = _approach_vf(cfg, cuda, start + 1000, 61)
    assert T.frame_pair(start + 999, v, 2**31)[0] > T.frame_pair(start, v, 2**31)[0]
    _rw_equal_coop(cuda, cfg, st, fields, start, 1000, vf, f"{shape} {res} frames")
    fast = _rw_cfg(shape, res, Re=4.0, Pe=0.005 * cfg.radius_obs / (0.5 / 3.0))
    rows = [T.tip_walks(fast.inflow_height, x, fast.vel_obs_conv)[1] for x in (0, 999)]
    assert rows[0] < rows[1] < res[0] - 1
    st, fields = _noisy_c(fast, cuda, 62)
    _rw_equal_coop(cuda, fast, st, fields, 0, 1000, _approach_vf(fast, cuda, 1000, 62),
                   f"{shape} {res} tip rows")
    small = _rw_cfg(shape, res, Pe=1e-5)
    start = 2**24 - 5
    assert 1 < T.tip_walks(small.inflow_height, start + 999, small.vel_obs_conv)[1] < res[0] - 1
    vf = _approach_vf(small, cuda, 0, 63)[:2]
    assert not T.frame_pair(start, small.vel_obs_conv, 2)[2]
    st, fields = _noisy_c(small, cuda, 63)
    _rw_equal_coop(cuda, small, st, fields, start, 1000, vf, f"{shape} {res} across 2**24")


@pytest.mark.cuda
@pytest.mark.parametrize("res,nruns", [((256, 128), 32), ((256, 128), 77), ((512, 256), 130)])
def test_cuda_fused_approach_rw_on_forced_runs(cuda, res, nruns):
    """Run plans other than the card's (runs of 8 rows, of 3-4 rows that do
    not divide the grid, 130 runs of 3-4 rows at 512x256): bit for bit the
    cooperative kernel over 300 steps with the wedge and the flat tip; and
    the twin, run on the CPU, within the trajectory tolerances over 2
    steps."""
    H, W = res
    plan = F.rw_plan_of(H, W, nruns)
    assert plan is not None and plan != F.rw_plan(H, W, jrl_fluid.sm_count(cuda))
    for shape in ("45degree", "cylinder"):
        cfg = _rw_cfg(shape, res, Re=4.0, Pe=0.02 * _rw_cfg(shape, res).radius_obs / (0.5 / 3.0))
        st, fields = _noisy_c(cfg, cuda, 64)
        vf = _approach_vf(cfg, cuda, 310, 65)
        _rw_equal_coop(cuda, cfg, st, fields, 7, 300, vf, f"{shape} {res} {nruns} runs", plan)
    acc = torch.zeros(4, device=cuda)
    h, C = F.fused_approach_rw(st["h"], st["C"], vf, 7, 2, cfg, fields, acc, plan=plan)
    _, fl_cpu, _ = T.c_init(cfg, "cpu")
    hr, Cr, ints = F.fused_approach_rw_ref(st["h"].cpu(), st["C"].cpu(), vf.cpu(), 7, 2, cfg,
                                           fl_cpu, nruns)
    _close(h.cpu(), hr, TRAJ_TOL["h"], f"fused_approach_rw vs twin {nruns} runs h")
    _close(C.cpu(), Cr, TRAJ_TOL["C"], f"fused_approach_rw vs twin {nruns} runs C")
    np.testing.assert_allclose(acc.cpu().numpy(), torch.stack(list(ints)).numpy(), **INT_TOL)


@pytest.mark.cuda
def test_cuda_fused_approach_rw_runner_and_shape(cuda, monkeypatch):
    """The runner at 512x256 (refine 4) goes through `fused_approach_rw`,
    one launch a chunk, its arguments checked once a run, bit for bit the
    cooperative kernel's chunks (h, C and the sums); the kernel's shared
    memory is the host plan's (128 runs of 4 rows, one block an SM), with
    no spills."""
    cfg = _rw_cfg("ethaline", (512, 256))
    st, fields = _noisy_c(cfg, cuda, 66)
    H, W = cfg.eff_res
    vf = _approach_vf(cfg, cuda, 3200, 67)
    monkeypatch.setattr(F, "MAX_LAUNCH_CELL_STEPS", dict(F.MAX_LAUNCH_CELL_STEPS,
                                                         fused_approach=64 * H * W))
    kernels.reset_launches()
    got, acc = F.make_fused_approach_runner(cfg, vf)(st, fields, 3011, 150)
    torch.cuda.synchronize()
    assert {k: c for k, c in kernels.launches().items() if c} == {"fused_approach_rw": 3}
    want, want_acc = dict(st), torch.zeros(4, device=cuda)
    for a, m in ((3011, 64), (3075, 64), (3139, 22)):
        want = dict(zip(("h", "C"), F.fused_approach(want["h"], want["C"], vf, a, m, cfg,
                                                     fields, want_acc, route="coop")))
    for k in ("h", "C"):
        _equal(got[k], want[k], f"runner {k}")
    _equal(torch.stack([acc[k] for k in ("inflow_sum", "current_sum", "rec_u", "rec_v")]),
           want_acc, "runner sums")
    sms = jrl_fluid.sm_count(cuda)
    plan = F.rw_plan(H, W, sms)
    assert plan == F.RwPlan(128, 6, F.rw_smem_bytes(6, 256))
    nbytes, most = F.rw_shape(plan.wrows, W)
    assert nbytes == plan.smem and most >= plan.nruns and plan.nruns <= sms
    regs, local, threads, cells = F.rw_info()
    assert local == 0 and 0 < regs and threads in (512, 1024) and cells == F.RW_CELLS, \
        (regs, local, threads, cells)


@pytest.mark.cuda
def test_cuda_fused_approach_rw_refuses_bad_inputs(cuda):
    """Rows that are not 16-byte multiples raise before launch; a plan over
    the co-resident limit, with runs over 1024 cells or a window that does
    not hold its runs is refused by the launcher (nothing launched)."""
    cfg = _rw_cfg("45degree", (512, 256))
    st, fields = _noisy_c(cfg, cuda, 68)
    vf = _approach_vf(cfg, cuda, 10, 69)
    odd = T.JRLCConfig(res=(256, 126), shape="cylinder")
    so, flo = _noisy_c(odd, cuda, 70)
    acc = torch.zeros(4, device=cuda)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        F.fused_approach_rw(so["h"], so["C"], _approach_vf(odd, cuda, 10, 71), 0, 2, odd, flo,
                            acc)
    plan = F.rw_plan(512, 256, jrl_fluid.sm_count(cuda))
    for bad, code in ((F.RwPlan(256, 4, F.rw_smem_bytes(4, 256)), "cudaError 720"),
                      (F.RwPlan(64, 10, F.rw_smem_bytes(10, 256)), "cudaError"),
                      (plan._replace(wrows=5), "cudaError")):
        with pytest.raises(RuntimeError, match=code):
            F.fused_approach_rw(st["h"], st["C"], vf, 0, 2, cfg, fields, acc, plan=bad)
    torch.cuda.synchronize()
    assert not any(kernels.launches().values())


@pytest.mark.cuda
def test_cuda_exact_division_equals_ieee_on_every_numerator(cuda):
    """The proof of `csrc/exact_div.cuh`: the reciprocal policy's quotient
    equals `__fdiv_rn`'s bit for bit for all 2^32 float32 bit patterns as
    numerator, for CS2F, CS4F, sqrt(2) and r = x + 0.5 at every column x <
    512 (1024x512's: a later kernel may use it there), each reciprocal the
    divisor's `__frcp_rn`."""
    proof = F.exact_div_count(512)
    assert len(proof) == 3 + 512
    assert [p[0] for p in proof[3:6]] == [0.5, 1.5, 2.5]
    bad = [p for p in proof if p[1] or p[2]]
    assert not bad, bad[:8]


MC_LIBS = ("fused_fluid_mc", "fused_balance_mc", "fused_approach_mc")


def _mc_variant(flags, tag):
    """The three multi-cluster libraries built with extra ``flags`` (a -D
    probe of csrc/cluster_grid.cuh) into the build directory."""
    import os
    import subprocess

    out = {}
    procs = []
    for k in MC_LIBS:
        path = build.BUILD_DIR / f"{k}-{tag}.so"
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs.append((k, path, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", str(path),
             str(build.CSRC / f"{k}.cu")], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)))
    for k, path, proc in procs:
        assert proc.wait() == 0, proc.stderr.read().decode()
        out[k] = ctypes.CDLL(os.fspath(path))
    return out


@pytest.mark.cuda
def test_cuda_mc_jitter_build_equals_coop(cuda, monkeypatch):
    """Built with a random delay of up to 3 us before each block's pass and
    before it takes its mailbox rows (-DJRL_MC_JITTER), which reorders the
    exchange between clusters, the kernels still equal the cooperative
    ones bit for bit (256x128 and 512x256, fluid and both balances; the
    approach across a disk handover between clusters)."""
    libs = _mc_variant(["-DJRL_MC_JITTER=3000"], "jitter")
    monkeypatch.setattr(build, "_libs", dict(build._libs, **libs))
    monkeypatch.setattr(build, "_fns", {k: v for k, v in build._fns.items()
                                        if not k.startswith(tuple(f"jrl_{x}" for x in MC_LIBS))})
    for refine in (2, 4):
        _mc_equal_coop(cuda, "ethaline", RES, refine, 300, tag="jitter ")
        _mc_approach_equal_coop(cuda, "ethaline", RES, refine, 300, tag="jitter ")


@pytest.mark.cuda
def test_cuda_mc_stalled_wait_traps(cuda, tmp_path):
    """A receiver that waits for a pass its neighbour never sends
    (-DJRL_MC_STALL, a 0.2 s budget) ends the launch with a CUDA error
    instead of hanging: run in a process of its own, whose context the
    trap ends."""
    import os
    import subprocess
    import sys

    libs = _mc_variant(["-DJRL_MC_STALL", "-DJRL_MC_WAIT_NS=200000000ull"], "stall")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "stall.py"
    script.write_text(f"""
import ctypes, sys
sys.path.insert(0, {root!r})
import torch
from jrl_lbm_torch.kernels import build, fused_jrl as F
from jrl_lbm_torch.models import jrl as T
build._libs["fused_balance_mc"] = ctypes.CDLL({os.fspath(libs["fused_balance_mc"]._name)!r})
cfg = T.JRLCConfig(refine=2)
st, cf, flags = T.c_init(cfg, torch.device("cuda"))
try:
    h, C = F.fused_balance_mc(st["h"], st["C"], flags, 50, cfg, cf)
    torch.cuda.synchronize()
except Exception as e:
    print("launch failed:", e)
    sys.exit(3)
print("no error")
""")
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 3, (proc.returncode, proc.stdout, proc.stderr)
    assert "launch failed" in proc.stdout


def _mc_over(name, H, W, plan):
    """The plan of one cluster more than the card holds at once of the
    plan's cluster size (its bands, cells a thread and windows to match)."""
    lim = F.card_limits(name, 0)
    active = F.mc_active(name, plan, 0)
    big = lim._replace(smem_optin=2**30, active=tuple(
        active + 1 if c == plan.cluster else a for c, a in zip(F.MC_SIZES, lim.active)))
    over = F.mc_plan(name, H, W, big, cluster=plan.cluster)
    assert over.clusters == active + 1
    return over


@pytest.mark.cuda
def test_cuda_mc_refuses_plans_over_the_card(cuda):
    """A plan of one cluster more than the card holds at once raises before
    any launch, and the launcher itself refuses it
    (cudaErrorCooperativeLaunchTooLarge) and a window of the wrong size,
    launching nothing."""
    cfg, s, fl = _mc_state(cuda, "ethaline", RES, 4, 38)
    H, W = cfg.eff_res
    plan = F.mc_plan("fused_fluid", H, W, F.card_limits("fused_fluid", 0))
    assert plan.clusters <= F.mc_active("fused_fluid", plan, 0)
    over = _mc_over("fused_fluid", H, W, plan)
    kernels.reset_launches()
    x = (s["f"], s["rho"], s["vel"])
    with pytest.raises(ValueError, match="co-resident"):
        F.fused_fluid_mc(*x, 0, 2, cfg, fl, plan=over)
    cc, st, cf, flags = _mc_c_state(cuda, "ethaline", RES, 4, True, 39)
    kernels.reset_launches()
    bplan = F.mc_plan("fused_balance", H, W, F.card_limits("fused_balance", 0))
    with pytest.raises(ValueError, match="co-resident"):
        F.fused_balance_mc(*st, flags, 2, cc, cf, plan=_mc_over("fused_balance", H, W, bplan))
    assert not any(kernels.launches().values())
    fn = build.bind("fused_fluid_mc", "jrl_fused_fluid_mc",
                    [jrl_fluid._P] * 6 + [ctypes.c_int] * 2 + [jrl_fluid._P] * 3
                    + [ctypes.c_int] * 4 + [jrl_fluid._P])
    out = [torch.empty_like(t) for t in x]
    box = F._mailbox("fused_fluid", over, W, cuda)
    for bad, code in ((over, "cudaError 720"),  # cudaErrorCooperativeLaunchTooLarge
                      (plan._replace(smem=plan.smem + 4), None), (plan._replace(cluster=3), None)):
        err = fn(*(t.data_ptr() for t in list(x) + out), 0, 2, ctypes.byref(F._a_params(cfg)),
                 ctypes.byref(F._b_params(cfg)), box.data_ptr(), *bad, jrl_fluid.stream_of(cuda))
        assert err != 0, bad
        with pytest.raises(RuntimeError, match=code or "cudaError"):
            build.check(err, "fused_fluid_mc")
    torch.cuda.synchronize()
    assert F.fused_fluid_mc.launches == 0
    # the approach: over the card, or one cluster more than it holds at once
    ca, sa, fa = _mc_approach_state(cuda, "ethaline", RES, 4, 41)
    aplan = F.mc_plan("fused_approach", H, W, F.card_limits("fused_approach", 0))
    vf = torch.zeros((2, 2, H, W), device=cuda)
    acc = torch.zeros(4, device=cuda)
    kernels.reset_launches()
    for bad in (_mc_over("fused_approach", H, W, aplan),
                aplan._replace(clusters=aplan.clusters * 4)):
        with pytest.raises(ValueError, match="co-resident"):
            F.fused_approach_mc(sa["h"], sa["C"], vf, 0, 2, ca, fa, acc, plan=bad)
    assert not any(kernels.launches().values())
    torch.cuda.synchronize()
    assert not acc.any()


# --- the approach of 256x128 and 512x256 on every cluster: fused_approach_mc ---

# (shape, res, refine) of the approach's multi-cluster grids: refine 2 and 4
# of the ethaline case, the flat tip and the wedge at the same sizes, and
# heights that no plan divides evenly
MC_APPROACH_GRIDS = MC_GRIDS + [("cylinder", (500, 256), 1), ("45degree", (250, 128), 1)]
INT_TOL = dict(rtol=2e-4, atol=1e-4)


def _mc_approach_state(dev, shape, res, refine, seed, tip_speed=0.005):
    """A noisy approach state; the tip moves ``tip_speed`` rows a step
    (five rows over a 1000-step launch at the default)."""
    probe = T.JRLCConfig(res=res, shape=shape, refine=refine)
    cfg = T.JRLCConfig(res=res, Re=4.0, shape=shape, refine=refine,
                       Pe=tip_speed * probe.radius_obs / (0.5 / 3.0))
    st, fields = _noisy_c(cfg, dev, seed)
    return cfg, st, fields


def _approach_vf(cfg, dev, end, seed):
    H, W = cfg.eff_res
    n_frames = T.frame_pair(end + 1, cfg.vel_obs_conv, 2**31)[0] + 2
    return 0.5 * torch.randn((n_frames, 2, H, W),
                             generator=torch.Generator(device=dev).manual_seed(seed), device=dev)


def _mc_approach_equal_coop(cuda, shape, res, refine, n, plan=None, handover=True, tag=""):
    """fused_approach_mc over one n-step launch against route="coop": h and
    C bit for bit; the integrals bit for bit where one block held the disk
    row for the whole launch, else within rtol 2e-4 / atol 1e-4. With
    ``handover`` the launch hands the disk row across a cluster edge half
    way, else it runs from step 3000 at the case's own tip speed. Returns
    whether one block held the disk row."""
    if handover:
        cfg, st, fields = _mc_approach_state(cuda, shape, res, refine, 42)
    else:
        cfg = T.JRLCConfig(res=res, shape=shape, refine=refine)
        st, fields = _noisy_c(cfg, cuda, 43)
    H, W = cfg.eff_res
    used = plan or F.mc_plan("fused_approach", H, W, F.card_limits("fused_approach", 0))
    start = smoke.handover_start(T, cfg, used, n) if handover else 3000
    vf = _approach_vf(cfg, cuda, start + n, 44)
    accs = [torch.zeros(4, device=cuda) for _ in range(2)]
    n0 = F.fused_approach_mc.launches
    got = F.fused_approach_mc(st["h"], st["C"], vf, start, n, cfg, fields, accs[0], plan=plan)
    want = F.fused_approach(st["h"], st["C"], vf, start, n, cfg, fields, accs[1], route="coop")
    label = f"{tag}fused_approach_mc {shape} {H}x{W} plan {used}"
    for name, g, w in zip(("h", "C"), got, want):
        _equal(g, w, f"{label} {name}")
    one = smoke.disk_band(T, cfg, used, start) == smoke.disk_band(T, cfg, used, start + n - 1)
    if handover:
        assert not one, f"{label}: no handover from step {start}"
    if one:
        _equal(accs[0], accs[1], f"{label} integrals")
    else:
        np.testing.assert_allclose(accs[0].cpu().numpy(), accs[1].cpu().numpy(), **INT_TOL)
    torch.cuda.synchronize()
    assert F.fused_approach_mc.launches == n0 + 1
    return one


@pytest.mark.cuda
@pytest.mark.parametrize("shape,res,refine", MC_APPROACH_GRIDS)
def test_cuda_mc_approach_equals_coop_bit_for_bit(cuda, shape, res, refine):
    """The multi-cluster approach on the plan the card gives equals the
    cooperative kernel bit for bit over a 1000-step launch whose disk row
    crosses from one cluster into the next (and the band edges around it),
    and over one from step 3000 at the case's tip speed; where one block
    held the disk row the integrals too."""
    _mc_approach_equal_coop(cuda, shape, res, refine, 1000)
    _mc_approach_equal_coop(cuda, shape, res, refine, 1000, handover=False)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", F.MC_SIZES)
def test_cuda_mc_approach_equals_coop_on_every_cluster_size(cuda, cluster):
    """Each cluster size a plan may take, forced, at 256x128 and 512x256
    (refine 2 and 4) for the wedge and the flat tip: bit for bit the
    cooperative kernel across a disk handover between clusters."""
    for refine in (2, 4):
        H, W = T.JRLCConfig(res=RES, refine=refine).eff_res
        plan = F.mc_plan("fused_approach", H, W, F.card_limits("fused_approach", 0),
                         cluster=cluster)
        if plan is None:
            continue
        for shape, res, ref in (("ethaline", RES, refine), ("cylinder", (H, W), 1)):
            _mc_approach_equal_coop(cuda, shape, res, ref, 1000, plan=plan)


@pytest.mark.cuda
@pytest.mark.parametrize("refine", [2, 4])
def test_cuda_mc_approach_matches_twin(cuda, refine):
    """One 300-step launch across tip-row crossings and frame boundaries
    against the loop of the twins: h, C 2e-5, the integrals rtol 2e-4 /
    atol 1e-4."""
    cfg, st, fields = _mc_approach_state(cuda, "ethaline", RES, refine, 45, tip_speed=0.02)
    H, W = cfg.eff_res
    plan = F.mc_plan("fused_approach", H, W, F.card_limits("fused_approach", 0))
    start = smoke.handover_start(T, cfg, plan, 300)
    vf = _approach_vf(cfg, cuda, start + 300, 46)
    acc = torch.zeros(4, device=cuda)
    h, C = F.fused_approach_mc(st["h"], st["C"], vf, start, 300, cfg, fields, acc)
    hr, Cr, ints = F.fused_approach_ref(st["h"], st["C"], vf, start, 300, cfg, fields)
    _close(h, hr, TRAJ_TOL["h"], f"fused_approach_mc refine {refine} h")
    _close(C, Cr, TRAJ_TOL["C"], f"fused_approach_mc refine {refine} C")
    np.testing.assert_allclose(acc.cpu().numpy(), torch.stack(list(ints)).cpu().numpy(),
                               **INT_TOL)


# --- the approach redesigned: c_approach_pass (1024x512), fused_approach_cl (128x64) ---

# the default refine-8 case: 20,340,900 approach steps; its history holds
# the frames its last step reads, so that step reads the last frame alone
R8 = T.JRLCConfig(shape="ethaline", refine=8)
R8_FRAMES = T.frame_pair(R8.total_steps - 1, R8.vel_obs_conv, 2**31)[0] + 1


def _noisy_c(cfg, dev, seed):
    st, fields, _ = T.c_init(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    return {k: v + 1e-3 * torch.randn(v.shape, generator=g, device=dev)
            for k, v in st.items()}, fields


def _frame_window(cfg, dev, steps, n_frames, seed):
    """Random frames covering what ``steps`` read, as a window: ``(frames,
    b0)``."""
    b = [T.frame_pair(s, cfg.vel_obs_conv, n_frames) for s in (steps[0], steps[-1])]
    b0, b1 = b[0][0], b[1][0] + int(b[1][2])
    H, W = cfg.eff_res
    g = torch.Generator(device=dev).manual_seed(seed)
    return 0.5 * torch.randn((b1 - b0 + 1, 2, H, W), generator=g, device=dev), b0


def _pass_against_pair(cfg, st, fields, steps, frames, b0, n_frames, tag, twin=True):
    """Each step from the pass's own trajectory: c_approach_pass equals the
    c_approach pair after PyTorch's lerp bit for bit (h, C, the four
    integrals) and its twin at 1e-5 (integrals rtol 2e-4 / atol 1e-4)."""
    h, C = st["h"], st["C"]
    n0 = jrl_c.c_approach_pass.launches
    for s in steps:
        acc_p, acc_q = torch.ones(4, device=h.device), torch.ones(4, device=h.device)
        hp, Cp = jrl_c.c_approach_pass(h, frames, s, cfg, fields, acc_p, b0=b0,
                                       n_frames=n_frames)
        vel = T.stored_velocity(frames, s, cfg.vel_obs_conv, b0, n_frames)
        hq, Cq = jrl_c.c_approach(h, C, vel, s, cfg, fields, acc_q)
        for name, g, w in (("h", hp, hq), ("C", Cp, Cq), ("integrals", acc_p, acc_q)):
            _equal(g, w, f"{tag} step {s} {name}")
        if twin:
            hr, Cr, ints = jrl_c.c_approach_pass_ref(h, frames, s, cfg, fields, b0, n_frames)
            _close(hp, hr, 1e-5, f"{tag} step {s} h (twin)")
            _close(Cp, Cr, 1e-5, f"{tag} step {s} C (twin)")
            np.testing.assert_allclose(acc_p.cpu().numpy(), [1.0 + float(ints[0]),
                                                             1.0 + float(ints[1])]
                                       + [float(x) for x in ints[2:]], rtol=2e-4, atol=1e-4,
                                       err_msg=f"{tag} step {s} integrals (twin)")
        h, C = hp, Cp
    torch.cuda.synchronize()
    assert jrl_c.c_approach_pass.launches - n0 == len(steps)


def _r8_plan(dev, start, n, seed):
    steps = list(range(start, start + n))
    frames, b0 = _frame_window(R8, dev, steps, R8_FRAMES, seed)
    st, fields = _noisy_c(R8, dev, seed)
    return R8, st, fields, steps, frames, b0, R8_FRAMES


def _small_plan(dev, shape, res, is_negative, seed):
    """A grid of its own with a frame change every ~3 steps: 20 steps."""
    probe = T.JRLCConfig(res=res, shape=shape)
    cfg = T.JRLCConfig(res=res, Re=4.0, Pe=0.03 * probe.radius_obs / (0.5 / 3.0), shape=shape,
                       is_negative=is_negative)
    steps = list(range(30, 50))
    n_frames = T.frame_pair(steps[-1], cfg.vel_obs_conv, 2**31)[0] + 2
    frames, b0 = _frame_window(cfg, dev, steps, n_frames, seed)
    st, fields = _noisy_c(cfg, dev, seed)
    return cfg, st, fields, steps, frames, b0, n_frames


# the first step after which the refine-8 case reads a new frame
R8_FRAME_CHANGE = next(s for s in range(1, 6000)
                       if T.frame_pair(s, R8.vel_obs_conv, R8_FRAMES)[0]
                       != T.frame_pair(s + 1, R8.vel_obs_conv, R8_FRAMES)[0])
PASS_PLANS = {
    "r8 step 0": lambda dev: _r8_plan(dev, 0, 3, 1),
    "r8 step 10,170,450": lambda dev: _r8_plan(dev, 10_170_450, 3, 2),
    "r8 last steps": lambda dev: _r8_plan(dev, R8.total_steps - 3, 3, 3),
    "r8 2**24 - 5 .. 2**24 + 4": lambda dev: _r8_plan(dev, 2**24 - 5, 10, 4),
    "r8 frame change": lambda dev: _r8_plan(dev, R8_FRAME_CHANGE - 2, 5, 5),
    "flat negative 256x64": lambda dev: _small_plan(dev, "cylinder", (256, 64), True, 6),
    "flat 256x64": lambda dev: _small_plan(dev, "cylinder", (256, 64), False, 7),
    "wedge 256x64": lambda dev: _small_plan(dev, "ethaline", (256, 64), True, 8),
    "wedge 96x516": lambda dev: _small_plan(dev, "45degree", (96, 516), False, 9),
}


@pytest.mark.cuda
@pytest.mark.parametrize("plan", list(PASS_PLANS))
def test_cuda_c_approach_pass_equals_pair(cuda, plan):
    """c_approach_pass against the c_approach pair it replaces (bit for
    bit) and its twin: the default refine-8 case at steps 0, 10,170,450 (a
    two-frame window from frame 3,495) and its last steps (the last frame,
    no lerp), across 2**24 and a frame change; flat tips either
    ``is_negative``, a wedge at 256x64 and a width (516) that is no
    multiple of the block, each over 20 steps with frame changes."""
    cfg, st, fields, steps, frames, b0, n_frames = PASS_PLANS[plan](cuda)
    _pass_against_pair(cfg, st, fields, steps, frames, b0, n_frames, plan,
                       twin=len(steps) <= 10)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,res", [("ethaline", (1024, 512)), ("cylinder", (256, 64))])
def test_cuda_approach_runner_pass_equals_pair(cuda, shape, res):
    """The per-step runner through c_approach_pass (one launch a step and
    nothing else) equals it through the pair, bit for bit, over steps with
    frame changes, and runs of 0 and 1 steps."""
    probe = T.JRLCConfig(res=res, shape=shape)
    cfg = T.JRLCConfig(res=res, Re=4.0, Pe=0.03 * probe.radius_obs / (0.5 / 3.0), shape=shape)
    st, fields = _noisy_c(cfg, cuda, 11)
    H, W = cfg.eff_res
    vf = 0.5 * torch.randn((4, 2, H, W), generator=torch.Generator(device=cuda).manual_seed(12),
                           device=cuda)
    for start, n in ((3, 12), (7, 1), (7, 0)):
        kernels.reset_launches()
        a, acc_a = T.make_per_step_approach_runner(cfg, vf)(st, fields, start, n)
        torch.cuda.synchronize()
        assert {k: c for k, c in kernels.launches().items() if c} == (
            {"c_approach_pass": n} if n else {})
        b, acc_b = T.make_per_step_approach_runner(cfg, vf, route="pair")(st, fields, start, n)
        for k in ("h", "C"):
            _equal(a[k], b[k], f"runner {start}+{n} {k}")
        for k in ("inflow_sum", "current_sum", "rec_u", "rec_v", "count"):
            _equal(acc_a[k], acc_b[k], f"runner {start}+{n} {k}")


@pytest.mark.cuda
def test_cuda_c_approach_pass_refuses_bad_args(cuda):
    cfg, st, fields, steps, frames, b0, n_frames = PASS_PLANS["r8 step 10,170,450"](cuda)
    acc = torch.zeros(4, device=cuda)
    n0 = jrl_c.c_approach_pass.launches
    with pytest.raises(ValueError, match="outside the window"):
        jrl_c.c_approach_pass(st["h"], frames, 0, cfg, fields, acc, b0=b0, n_frames=n_frames)
    with pytest.raises(ValueError, match="16-byte"):
        jrl_c.c_approach_pass(st["h"], frames, steps[0], cfg, fields, acc, b0=b0,
                              n_frames=n_frames, out=(torch.empty(9 * 1024 * 512 + 1,
                                                                  device=cuda)[1:].view(
                                                                      9, 1024, 512),
                                                      torch.empty_like(st["C"])))
    with pytest.raises(ValueError, match="W % 4"):
        odd = T.JRLCConfig(res=(64, 66), shape="cylinder")
        so, fo = _noisy_c(odd, cuda, 1)
        jrl_c.c_approach_pass(so["h"], torch.zeros((1, 2, 64, 66), device=cuda), 0, odd, fo, acc)
    assert jrl_c.c_approach_pass.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["default", "45degree", "cylinder", "2**24"])
def test_cuda_fused_approach_cl_equals_cooperative(cuda, case):
    """fused_approach_cl equals fused_approach bit for bit in h and C over
    one 1000-step launch (the default case's tip crosses two frames in it;
    steps 2**24 - 500 .. 2**24 + 499 at a tip speed that keeps the tip in
    the grid), and two chained launches (400 + 601 steps); the integrals
    within rtol 2e-4 / atol 1e-4 of the cooperative kernel's."""
    kw = {"default": {}, "45degree": dict(shape="45degree", is_negative=False),
          "cylinder": dict(shape="cylinder"), "2**24": dict(Pe=1e-5)}[case]
    cfg = T.JRLCConfig(**kw)
    start = 2**24 - 500 if case == "2**24" else 0
    H, W = cfg.eff_res
    assert 1 < T.tip_walks(cfg.inflow_height, start + 1000, cfg.vel_obs_conv)[1] < H - 1
    st, fields = _noisy_c(cfg, cuda, 13)
    n_frames = T.frame_pair(start + 1001, cfg.vel_obs_conv, 2**31)[0] + 2
    vf = 0.5 * torch.randn((n_frames, 2, H, W),
                           generator=torch.Generator(device=cuda).manual_seed(14), device=cuda)
    out = {}
    for r in F.ROUTES:
        acc, acc2 = torch.zeros(4, device=cuda), torch.zeros(4, device=cuda)
        one = F.fused_approach(st["h"], st["C"], vf, start, 1000, cfg, fields, acc, route=r)
        two = F.fused_approach(*F.fused_approach(st["h"], st["C"], vf, start, 400, cfg, fields,
                                                 acc2, route=r),
                               vf, start + 400, 601, cfg, fields, acc2, route=r)
        out[r] = (one, two, acc, acc2)
    for k, (a, b) in enumerate(zip(out["cluster"][:2], out["coop"][:2])):
        for name, g, w in zip(("h", "C"), a, b):
            _equal(g, w, f"{case} run {k} {name}")
    for k in (2, 3):
        np.testing.assert_allclose(out["cluster"][k].cpu().numpy(),
                                   out["coop"][k].cpu().numpy(), rtol=2e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_fused_approach_cl_matches_twin_and_refuses_over_limit(cuda):
    """The cluster route against the twin over 200 steps (a frame change
    every ~3 steps, a tip-row crossing), and a forced cluster route over
    the cluster limit (512x256) raises before any launch."""
    probe = T.JRLCConfig(res=RES)
    cfg = T.JRLCConfig(res=RES, Re=4.0, Pe=0.03 * probe.radius_obs / (0.5 / 3.0))
    st, fields = _noisy_c(cfg, cuda, 15)
    H, W = cfg.eff_res
    vf = torch.as_tensor(np.random.default_rng(16).uniform(-0.5, 0.5, (80, 2, H, W))
                         .astype(np.float32), device=cuda)
    acc = torch.zeros(4, device=cuda)
    h, C = F.fused_approach_cl(st["h"], st["C"], vf, 0, 200, cfg, fields, acc)
    hr, Cr, ints = F.fused_approach_ref(st["h"], st["C"], vf, 0, 200, cfg, fields)
    _close(h, hr, TRAJ_TOL["h"], "fused_approach_cl h")
    _close(C, Cr, TRAJ_TOL["C"], "fused_approach_cl C")
    np.testing.assert_allclose(acc.cpu().numpy(), [float(x) for x in ints], rtol=2e-4,
                               atol=1e-4, err_msg="fused_approach_cl integrals")
    c4 = T.JRLCConfig(res=RES, refine=4)
    s4, f4 = _noisy_c(c4, cuda, 17)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="cluster limit"):
        F.fused_approach(s4["h"], s4["C"], torch.zeros((2, 2) + c4.eff_res, device=cuda), 0, 2,
                         c4, f4, acc, route="cluster")
    assert not any(kernels.launches().values())


# --- the Pe sweep's lanes: fused_approach_lanes, one cluster a lane ---

def _lane_cfgs(shape, L):
    """L lanes at 128x64 with tip speeds of 0.01 .. 0.03 rows a step (a
    record row every 33-100 steps)."""
    probe = T.JRLCConfig(res=RES, shape=shape)
    return [T.JRLCConfig(res=RES, Re=4.0, shape=shape,
                         Pe=(0.01 + 0.02 * k / max(1, L - 1)) * probe.radius_obs / (0.5 / 3.0))
            for k in range(L)]


def _lane_inputs(dev, cfgs, ns, seed):
    st, fields = _noisy_c(cfgs[0], dev, seed)
    H, W = cfgs[0].eff_res
    n_frames = max(T.frame_pair(n, c.vel_obs_conv, 2**31)[0] for c, n in zip(cfgs, ns)) + 2
    vf = 0.5 * torch.randn((n_frames, 2, H, W),
                           generator=torch.Generator(device=dev).manual_seed(seed + 1), device=dev)
    L = len(cfgs)
    states = {k: v.unsqueeze(0).expand((L,) + tuple(v.shape)).contiguous() for k, v in st.items()}
    dumps = [[s for s in T.c_dump_steps(c) if s < n - 7] for c, n in zip(cfgs, ns)]
    segs = [F.lane_segments(c, d, n) for c, d, n in zip(cfgs, dumps, ns)]
    return states, fields, vf, dumps, segs


@pytest.mark.cuda
@pytest.mark.parametrize("L,shape,cap", [(1, "ethaline", None), (7, "45degree", None),
                                         (12, "cylinder", 37)])
def test_cuda_fused_approach_lanes_equal_serial_bit_for_bit(cuda, monkeypatch, L, shape, cap):
    """L lanes of unequal speed and length (L = 12 is above the clusters an
    H100 holds at once, so later lanes run as a second wave) in one launch
    equal each lane's serial fused_approach_cl launches bit for bit: h, C,
    and each record row's inflow and current sums, rec_u and rec_v. With
    ``cap``, a launch cap of that many steps splits the serial intervals
    into launches, and the lanes' segments with them."""
    if cap:
        monkeypatch.setitem(F.MAX_LAUNCH_CELL_STEPS, "fused_approach", RES[0] * RES[1] * cap)
    cfgs = _lane_cfgs(shape, L)
    ns = [1500 - 61 * k for k in range(L)]
    states, fields, vf, dumps, segs = _lane_inputs(cuda, cfgs, ns, 19)
    n_rows = max(len(d) for d in dumps)
    kernels.reset_launches()
    h, C, rows = F.fused_approach_lanes(states["h"], states["C"], vf, 0, ns, segs, n_rows, cfgs,
                                        fields)
    torch.cuda.synchronize()
    assert {k: c for k, c in kernels.launches().items() if c} == {"fused_approach_lanes": 1}
    assert min(len(d) for d in dumps) >= 10
    for lane, (cfg, d, n) in enumerate(zip(cfgs, dumps, ns)):
        run = F.make_fused_approach_runner(cfg, vf)
        st, cur = {"h": states["h"][lane], "C": states["C"][lane]}, 0
        for k, step in enumerate(d):
            st, acc = run(st, fields, cur, step + 1 - cur)
            cur = step + 1
            _equal(rows[lane, k], torch.stack([acc[x] for x in ("inflow_sum", "current_sum",
                                                                 "rec_u", "rec_v")]),
                   f"lane {lane} row {k}")
        st, _ = run(st, fields, cur, n - cur)
        _equal(h[lane], st["h"], f"lane {lane} h")
        _equal(C[lane], st["C"], f"lane {lane} C")
        assert not rows[lane, len(d):].any()
    assert kernels.launches()["fused_approach_cl"] >= sum(len(d) for d in dumps)


@pytest.mark.cuda
def test_cuda_fused_approach_lanes_match_twin(cuda):
    """Two lanes over 150 and 120 steps against the twin (trajectory
    tolerances; the integrals rtol 2e-4 / atol 1e-4)."""
    cfgs = _lane_cfgs("45degree", 2)
    ns = [150, 120]
    states, fields, vf, dumps, segs = _lane_inputs(cuda, cfgs, ns, 23)
    got = F.fused_approach_lanes(states["h"], states["C"], vf, 0, ns, segs, 8, cfgs, fields)
    want = F.fused_approach_lanes_ref(states["h"], states["C"], vf, 0, ns, segs, 8, cfgs, fields)
    _close(got[0], want[0], TRAJ_TOL["h"], "lanes h")
    _close(got[1], want[1], TRAJ_TOL["C"], "lanes C")
    np.testing.assert_allclose(got[2].cpu().numpy(), want[2].cpu().numpy(), rtol=2e-4,
                               atol=1e-4, err_msg="lanes rows")
    assert got[2][:, :, 0].abs().sum() > 0


@pytest.mark.cuda
def test_cuda_fused_approach_lanes_refuse_before_launch(cuda):
    """Lanes that differ in more than the tip speed and tau_D, a grid over
    the cluster limit and segments past a lane's steps raise before any
    launch."""
    cfgs = _lane_cfgs("45degree", 2)
    states, fields, vf, dumps, segs = _lane_inputs(cuda, cfgs, [100, 100], 29)
    kernels.reset_launches()
    other = [cfgs[0], T.JRLCConfig(res=RES, Re=4.0, Pe=cfgs[1].Pe, shape="45degree",
                                   is_negative=False)]
    with pytest.raises(ValueError, match="differ"):
        F.fused_approach_lanes(states["h"], states["C"], vf, 0, [100, 100], segs, 4, other,
                               fields)
    with pytest.raises(ValueError, match="segment ends"):
        F.fused_approach_lanes(states["h"], states["C"], vf, 0, [100, 100],
                               [[(101, 0)], []], 4, cfgs, fields)
    c4 = T.JRLCConfig(res=RES, refine=4)
    s4, f4 = _noisy_c(c4, cuda, 17)
    with pytest.raises(ValueError, match="one cluster"):
        F.fused_approach_lanes(s4["h"][None], s4["C"][None],
                               torch.zeros((2, 2) + c4.eff_res, device=cuda), 0, [2], [[]], 1,
                               [c4], f4)
    assert not any(kernels.launches().values())


@pytest.mark.cuda
def test_cuda_pe_sweep_lanes_equal_serial_route(cuda):
    """`pe_sweep_approach` at 128x64 takes the lanes kernel (one launch)
    and its records equal the serial route's (fused_approach_cl lane after
    lane) bit for bit."""
    from jrl_lbm_torch.parallel import sweep

    cfg = T.JRLCConfig(res=RES, Re=4.0, shape="45degree")
    Pes = [c.Pe for c in _lane_cfgs("45degree", 4)]
    st, fields = _noisy_c(cfg, cuda, 31)
    states = {k: torch.stack([v] * len(Pes)) for k, v in st.items()}
    fields = dict(fields, vel_field=0.5 * torch.randn(
        (500, 2) + RES, generator=torch.Generator(device=cuda).manual_seed(32), device=cuda))
    assert sweep.lane_route(cfg, cuda) == "lanes"
    out = {}
    for route in ("lanes", "serial"):
        kernels.reset_launches()
        out[route] = sweep.pe_sweep_approach(cfg, Pes, states, fields, max_steps=1200,
                                             route=route)
        torch.cuda.synchronize()
        counts = {k: c for k, c in kernels.launches().items() if c}
        assert set(counts) == {"fused_approach_lanes" if route == "lanes"
                               else "fused_approach_cl"}
    np.testing.assert_array_equal(out["lanes"].n_dumps, out["serial"].n_dumps)
    assert out["lanes"].n_dumps.min() >= 10
    assert np.array_equal(out["lanes"].records, out["serial"].records)


# --- the cylinder channel (kernels/cylinder.py) ---


# a split geometry (interior, band and edge rows) and a generic one (every
# row through cyl_full)
CYL = {
    "split": (dict(res=(256, 128), D=16.0, Re=500.0, cylinder_center=(64.0, 128.0)),
              dict(tile_rows=16, interior_rows=32)),
    "generic": (dict(res=(64, 32), D=8.0, Re=500.0, cylinder_center=(16.0, 32.0)),
                dict(tile_rows=8, split=False)),
    # narrower than a k-step tile: the halo wraps around the grid
    "narrow": (dict(res=(96, 32), D=8.0, Re=500.0, cylinder_center=(16.0, 48.0)),
               dict(tile_rows=8, interior_rows=16)),
}
TWINS = {"cyl_full": K.cyl_full_ref, "cyl_interior": K.cyl_interior_ref,
         "cyl_interior_k": K.cyl_interior_k_ref, "cyl_band_k": K.cyl_band_k_ref,
         "cyl_pass": K.cyl_pass_ref}


def _cyl_state(dev, geometry, steps=30):
    """A developed state (``steps`` plain steps), nudged by seeded noise so
    that every cell differs from its neighbours."""
    cfg = CY.CylinderConfig(**CYL[geometry][0])
    s, fields = CY.init(cfg, dev)
    s = CY.make_runner(cfg)(s, fields, steps)
    rng = np.random.default_rng(7)
    s = {k: v + torch.as_tensor((1e-4 * rng.standard_normal(tuple(v.shape))).astype(np.float32),
                                device=dev) for k, v in s.items()}
    return cfg, s, fields


def _twin_runner(cfg, **kw):
    """``make_fused_cylinder_runner`` with every kernel call replaced by its
    plain twin, on any device."""
    run = K.make_fused_cylinder_runner(cfg, **kw)

    def twin_run(state, fields, n):
        with mock.patch.multiple(K, **TWINS):
            return run(state, fields, n)

    return twin_run


def _outs(s):
    return {k: torch.full_like(v, 7.0) for k, v in s.items()}


def _close_all(got, want, tol, tag):
    for k in ("f", "rho", "vel"):
        _close(got[k], want[k], tol, f"{tag} {k}")


def _segments(cfg, kw):
    """(interior, cylinder band, edge) rows of the split; (all rows) else."""
    H = cfg.res[0]
    if kw.get("split", True):
        T, b0, b1 = K._choose_interior_T(cfg, kw["tile_rows"], kw["interior_rows"], margin=5.0)
        return K._split_rows(H, T, b0, b1)
    return [], [(0, H)], []


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", ["split", "generic"])
def test_cuda_cyl_full_matches_twin(cuda, geometry):
    cfg, s, fields = _cyl_state(cuda, geometry)
    c = K.consts(cfg)
    interior, band, edge = _segments(cfg, CYL[geometry][1])
    segs = sorted(edge + band)
    got, want = _outs(s), _outs(s)
    n0 = K.cyl_full.launches
    K.cyl_full(s["f"], s["rho"], s["vel"], fields["flags"], fields["phi_obs"], got, segs, c)
    K.cyl_full_ref(s["f"], s["rho"], s["vel"], fields["flags"], fields["phi_obs"], want, segs, c)
    torch.cuda.synchronize()
    _close_all(got, want, 1e-5, "cyl_full 1 step")
    assert K.cyl_full.launches - n0 == 1


@pytest.mark.cuda
@pytest.mark.parametrize("write_macro", [True, False])
def test_cuda_cyl_interior_matches_twin(cuda, write_macro):
    cfg, s, fields = _cyl_state(cuda, "split")
    c = K.consts(cfg)
    interior, _, _ = _segments(cfg, CYL["split"][1])
    got, want = _outs(s), _outs(s)
    K.cyl_interior(s["f"], got, interior, c, write_macro)
    K.cyl_interior_ref(s["f"], want, interior, c, write_macro)
    torch.cuda.synchronize()
    _close_all(got, want, 1e-5, "cyl_interior 1 step")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 4])
def test_cuda_cyl_interior_k_matches_twin(cuda, k):
    cfg, s, fields = _cyl_state(cuda, "split")
    c = K.consts(cfg)
    interior, _, _ = _segments(cfg, CYL["split"][1])
    got, want = _outs(s), _outs(s)
    K.cyl_interior_k(s["f"], got, interior, k, c, True)
    K.cyl_interior_k_ref(s["f"], want, interior, k, c, True)
    torch.cuda.synchronize()
    _close_all(got, want, 1e-5, f"cyl_interior_k k={k}")


@pytest.mark.cuda
@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_cuda_cyl_band_k_matches_twin(cuda, k, edge):
    cfg, s, fields = _cyl_state(cuda, "split")
    K.check_border(fields["flags"])
    c = K.consts(cfg)
    _, band, edge_rows = _segments(cfg, CYL["split"][1])
    segs = edge_rows if edge else band
    got, want = _outs(s), _outs(s)
    args = (s["f"], s["vel"], fields["flags"], fields["phi_obs"])
    K.cyl_band_k(*args, got, segs, k, edge, c)
    K.cyl_band_k_ref(*args, want, segs, k, edge, c)
    torch.cuda.synchronize()
    _close_all(got, want, 1e-5, f"cyl_band_k k={k} edge={edge}")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [40, 41, 42, 43])
@pytest.mark.parametrize("geometry", ["split", "generic", "narrow"])
def test_cuda_cyl_runner_matches_twin_runner(cuda, geometry, n):
    """n steps of the kernel runner against the twin runner: odd n runs
    the k=4, k=2 and k=1 kernels in one call on the split geometry; f and
    rho 2e-5, vel 2e-4, all cells."""
    cfg, s, fields = _cyl_state(cuda, geometry, steps=0)
    kw = CYL[geometry][1]
    kernels.reset_launches()
    got = K.make_fused_cylinder_runner(cfg, **kw)(s, fields, n)
    torch.cuda.synchronize()
    counts = kernels.launches()
    want = _twin_runner(cfg, **kw)(s, fields, n)
    for name in ("f", "rho", "vel"):
        _close(got[name], want[name], TRAJ_TOL[name], f"runner {geometry} {n} steps {name}")
    if geometry != "generic":  # one cyl_pass launch a k=4 or k=2 pass
        assert counts["cyl_pass"] == n // 4 + (n % 4) // 2
        assert counts["cyl_interior_k"] == 0 and counts["cyl_band_k"] == 0
        assert (counts["cyl_full"] > 0) == (n % 2 == 1)
    else:
        assert counts["cyl_full"] == n and counts["cyl_pass"] == 0
    assert kernels.launches()["cyl_full"] == counts["cyl_full"]  # the twins launch nothing


@pytest.mark.cuda
def test_cuda_cyl_wrappers_refuse_bad_tensors(cuda):
    cfg, s, fields = _cyl_state(cuda, "generic", steps=0)
    c = K.consts(cfg)
    out = _outs(s)
    H = cfg.res[0]
    args = (s["rho"], s["vel"], fields["flags"], fields["phi_obs"])
    with pytest.raises(ValueError, match="dtype"):
        K.cyl_full(s["f"].double(), *args, out, [(0, H)], c)
    with pytest.raises(ValueError, match="contiguous"):
        K.cyl_full(s["f"].transpose(1, 2).contiguous().transpose(1, 2), *args, out, [(0, H)], c)
    with pytest.raises(ValueError, match="shape"):
        K.cyl_full(s["f"][:, :-1], *args, out, [(0, H - 1)], c)
    with pytest.raises(ValueError, match="apart"):
        K.cyl_full(s["f"], *args, dict(out, f=s["f"]), [(0, H)], c)
    with pytest.raises(ValueError, match="segments"):
        K.cyl_interior(s["f"], out, [(8, 4)], c, True)
    with pytest.raises(ValueError, match="k ="):
        K.cyl_interior_k(s["f"], out, [(8, 16)], 9, c, True)


@pytest.mark.cuda
def test_cuda_cyl_launch_failure_raises(cuda):
    """A launch the card refuses (k past the kernels' depth, called below
    the wrapper's check) comes back as a cudaError and raises."""
    cfg, s, fields = _cyl_state(cuda, "generic", steps=0)
    c = K.consts(cfg)
    out = _outs(s)
    p = K._params(c, [(8, 16)], True)
    fn = build.bind("cyl_interior_k", "cyl_interior_k_launch",
                    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
    for k, storage in ((9, 0), (4, 3)):  # k past the depth; no such storage mode
        err = fn(s["f"].data_ptr(), out["f"].data_ptr(), out["rho"].data_ptr(),
                 out["vel"].data_ptr(), k, storage, ctypes.byref(p), jrl_fluid.stream_of(cuda))
        assert err != 0
        with pytest.raises(RuntimeError, match="cudaError"):
            build.check(err, "cyl_interior_k")


# --- the k-step pass in one launch (cyl_pass) ---
# cyl_pass against the three launches it replaces (cyl_interior_k and the
# "cyl" and "edge" cyl_band_k), from the same state, bit for bit in every
# storage mode, over chained passes; and against its plain twin (1e-5 in
# float32, bit for bit in bf16).

PASS_GEOMETRIES = {
    "split 256x128": CYL["split"],
    "mini 320x160": (dict(res=(320, 160), Re=1800.0, Vmax=0.1, D=16.0),
                     dict(tile_rows=16, interior_rows=32)),
    "gate 1600x800": (dict(res=(1600, 800), Re=10000.0, D=20.0, cylinder_center=(400.0, 200.0)),
                      dict(tile_rows=16, interior_rows=32)),
    "bench 2048x2048": (dict(res=(2048, 2048), D=64.0, Re=5000.0),
                        dict(tile_rows=16, interior_rows=32)),
}


def _pass_scene(dev, geometry, mode, flipped=False):
    """A noisy state of the geometry in storage ``mode`` and its fields;
    ``flipped``: the OUTFLOW row first and the INFLOW row last, so that the
    window holding row 0 walks up to an OUTFLOW row."""
    cfg = CY.CylinderConfig(**PASS_GEOMETRIES[geometry][0])
    s, fields = CY.init(cfg, dev)
    rng = np.random.default_rng(11)
    s = {k: v + torch.as_tensor((1e-3 * rng.standard_normal(tuple(v.shape))).astype(np.float32),
                                device=dev) for k, v in s.items()}
    if flipped:
        flags = fields["flags"].clone()
        flags[0, 1:-1], flags[-1, 1:-1] = K.OUTFLOW, K.INFLOW
        fields = dict(fields, flags=flags)
    return cfg, dict(s, f=K.f_to_storage(s["f"], mode)), fields


def _pass_steps(cfg, k, mode, geometry):
    kw = PASS_GEOMETRIES[geometry][1]
    return (K.make_fused_step2(cfg, kw["tile_rows"], interior_rows=kw["interior_rows"],
                               bf16_dev=mode, k=k, seed=5, route=route)
            for route in ("pass", "launches"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [False, True, "sr"])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("geometry", list(PASS_GEOMETRIES) + ["flipped 256x128"])
def test_cuda_cyl_pass_equals_the_three_launches(cuda, geometry, k, mode):
    """20 chained k-step passes: each pass through cyl_pass and through
    cyl_interior_k + cyl_band_k ("cyl", "edge") from the same state, the
    same keys (interior, cyl, edge) and the same output buffers, bit for
    bit (stored f, rho, vel); one cyl_pass launch a pass."""
    flipped = geometry.startswith("flipped")
    geometry = "split 256x128" if flipped else geometry
    cfg, s, fields = _pass_scene(cuda, geometry, mode, flipped)
    step_pass, step_launches = _pass_steps(cfg, k, mode, geometry)
    assert step_pass.route == "pass" and step_launches.route == "launches"
    kernels.reset_launches()
    for i in range(20):
        base = {n: v.clone() for n, v in s.items()}
        got = step_pass(s, fields, {n: v.clone() for n, v in base.items()})
        want = step_launches(s, fields, {n: v.clone() for n, v in base.items()})
        torch.cuda.synchronize()
        _equal_all(got, want, f"{geometry} k={k} bf16_dev={mode!r} pass {i}")
        s = got
    counts = kernels.launches()
    assert counts["cyl_pass"] == 20 and counts["cyl_interior_k"] == 20
    assert counts["cyl_band_k"] == 40
    if mode == "sr":
        assert step_pass.keys.n == step_launches.keys.n == 60


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [False, True, "sr"])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_cuda_cyl_pass_matches_twin(cuda, k, mode):
    """One pass against cyl_pass_ref (the class twins item by item, each on
    its window): 1e-5 in float32, bit for bit in the bf16 modes."""
    cfg, s, fields = _pass_scene(cuda, "split 256x128", mode)
    c = K.consts(cfg)
    step = next(_pass_steps(cfg, 2, mode, "split 256x128"))
    keys = ((3, 0), (3, 1), (3, 2)) if mode == "sr" else None
    args = (s["f"], s["vel"], fields["flags"], fields["phi_obs"])
    got, want = _outs(s), _outs(s)
    K.cyl_pass(*args, got, step.rows, k, c, False, mode, keys)
    K.cyl_pass_ref(*args, want, step.rows, k, c, False, mode, keys)
    torch.cuda.synchronize()
    if mode is False:
        _close_all(got, want, 1e-5, f"cyl_pass k={k}")
    else:
        _equal_all(got, want, f"cyl_pass k={k} bf16_dev={mode!r}")


@pytest.mark.cuda
def test_cuda_cyl_pass_refuses_bad_tensors(cuda):
    cfg, s, fields = _pass_scene(cuda, "split 256x128", False)
    c = K.consts(cfg)
    rows = next(_pass_steps(cfg, 4, False, "split 256x128")).rows
    args = (s["vel"], fields["flags"], fields["phi_obs"])
    with pytest.raises(ValueError, match="2 <= k <= 4"):
        K.cyl_pass(s["f"], *args, _outs(s), rows, 5, c, False)
    with pytest.raises(ValueError, match="apart"):
        K.cyl_pass(s["f"], *args, dict(_outs(s), f=s["f"]), rows, 4, c, False)
    with pytest.raises(ValueError, match="aligned"):
        f = torch.empty(9 * 256 * 128 + 1, device=cuda)[1:].view(9, 256, 128)
        K.cyl_pass(f, *args, _outs(s), rows, 4, c, False)
    with pytest.raises(ValueError, match="three keys"):
        K.cyl_pass(K.f_to_storage(s["f"], "sr"), *args,
                   dict(_outs(s), f=K.f_to_storage(s["f"], "sr")), rows, 4, c, False, "sr",
                   ((1, 2),))


# --- the cylinder kernels in bf16 deviation storage ---
# Kernel and twin load the same bf16 patterns, step in float32 and store
# with the same rounding (for "sr" the same Philox bits under the same
# key): the stored patterns and rho/vel are held equal, bit for bit.

MODES = [True, "sr"]


def _bf16_state(dev, geometry, mode):
    cfg, s, fields = _cyl_state(dev, geometry)
    return cfg, dict(s, f=K.f_to_storage(s["f"], mode)), fields


def _equal_all(got, want, tag):
    assert torch.equal(got["f"].view(torch.int16), want["f"].view(torch.int16)), f"{tag} f"
    for k in ("rho", "vel"):
        assert torch.equal(got[k], want[k]), f"{tag} {k}"


def _one_launch_cases(cfg, s, fields, geometry):
    """(tag, call(wrapper or twin, out, mode, key), kernel name) of one
    launch of each kernel: every kernel at k = 1, 2, 4 on the split
    geometry, cyl_full on every row of the generic one."""
    c = K.consts(cfg)
    f, rho, vel, flags, phi = s["f"], s["rho"], s["vel"], fields["flags"], fields["phi_obs"]
    interior, band, edge = _segments(cfg, CYL[geometry][1])
    if geometry == "generic":
        return [("cyl_full", lambda fn, o, m, key: fn(f, rho, vel, flags, phi, o, band, c, m, key),
                 "cyl_full")]
    cases = [("cyl_full", lambda fn, o, m, key: fn(f, rho, vel, flags, phi, o,
                                                  sorted(edge + band), c, m, key), "cyl_full"),
             ("cyl_interior", lambda fn, o, m, key: fn(f, o, interior, c, True, m, key),
              "cyl_interior")]
    for k in (1, 2, 4):
        cases.append((f"cyl_interior_k k={k}",
                      lambda fn, o, m, key, k=k: fn(f, o, interior, k, c, False, m, key),
                      "cyl_interior_k"))
        for e, segs in ((False, band), (True, edge)):
            cases.append((f"cyl_band_k k={k} edge={e}",
                          lambda fn, o, m, key, k=k, e=e, segs=segs: fn(f, vel, flags, phi, o,
                                                                        segs, k, e, c, m, key),
                          "cyl_band_k"))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("geometry", ["split", "generic"])
def test_cuda_cyl_kernels_bf16_match_twins(cuda, geometry, mode):
    cfg, s, fields = _bf16_state(cuda, geometry, mode)
    key = (11, 42) if mode == "sr" else None
    for tag, call, name in _one_launch_cases(cfg, s, fields, geometry):
        got, want = _outs(s), _outs(s)
        n0 = getattr(K, name).launches_by_mode[K.MODE_NAMES[K._storage(mode)]]
        call(getattr(K, name), got, mode, key)
        call(TWINS[name], want, mode, key)
        torch.cuda.synchronize()
        _equal_all(got, want, f"{tag} bf16_dev={mode!r}")
        assert getattr(K, name).launches_by_mode[K.MODE_NAMES[K._storage(mode)]] == n0 + 1


@pytest.mark.cuda
def test_cuda_cyl_sr_keys_change_bits(cuda):
    """Two keys give other patterns; the same key the same ones."""
    cfg, s, fields = _bf16_state(cuda, "split", "sr")
    c = K.consts(cfg)
    interior, _, _ = _segments(cfg, CYL["split"][1])
    outs = []
    for key in ((1, 0), (1, 1), (1, 0)):
        o = _outs(s)
        K.cyl_interior_k(s["f"], o, interior, 4, c, False, "sr", key)
        outs.append(o["f"][:, interior[0][0]:interior[0][1]].view(torch.int16))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[2]) and not torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [40, 41, 43])
@pytest.mark.parametrize("geometry", ["split", "generic"])
def test_cuda_cyl_bf16_runner_matches_twin_runner(cuda, geometry, n, mode):
    """n steps of the bf16 runner against the twin runner of the same seed
    (k=4, k=2 and k=1 on the split geometry at odd n), bit for bit."""
    cfg, s, fields = _cyl_state(cuda, geometry, steps=0)
    s = dict(s, f=K.f_to_storage(s["f"], mode))
    kw = CYL[geometry][1]
    kernels.reset_launches()
    got = K.make_fused_cylinder_runner(cfg, bf16_dev=mode, seed=3, **kw)(s, fields, n)
    torch.cuda.synchronize()
    by_mode = kernels.launches_by_mode()
    want = _twin_runner(cfg, bf16_dev=mode, seed=3, **kw)(s, fields, n)
    _equal_all(got, want, f"runner {geometry} {n} steps bf16_dev={mode!r}")
    name = K.MODE_NAMES[K._storage(mode)]
    used = {k.split("/")[0] for k, v in by_mode.items() if v}
    assert all(k.endswith(name) for k, v in by_mode.items() if v)
    if geometry == "generic":
        assert used == {"cyl_full"}
    else:  # single split steps at odd n
        assert used == {"cyl_pass"} | ({"cyl_full", "cyl_interior"} if n % 2 else set())


# --- the tile-class kernels of the JRL fluid phase (kernels/jrl_tiled.py) ---

TILE_RES, TILE_TH = (256, 64), 16


def _tile_case(dev, shape, k):
    """``(cfg, fields, state, step, (full, bt, lean))``: a noisy state at a
    step whose k-block holds a tip-row crossing (for a flat tip, far
    enough into the travel that below-tip tiles exist), and the row
    segments of the tile classes there. Every launch spans the whole width
    (W = 64 takes two blocks: one touches x = 0, one x = W-1)."""
    cfg = T.JRLFluidConfig(res=TILE_RES, Re=4.0, vel_obs_real=0.2848,
                           gravity_strength_real=-9.8, shape=shape)
    c = JT.tile_consts(cfg)
    s0 = 240 if shape in T.FLAT_SHAPES else 0
    row = lambda s: T.tip_walks(cfg.inflow_height, s, cfg.vel_obs)[1]  # noqa: E731
    while row(s0 + max(k - 1, 1)) == row(s0):
        s0 += 1
    fr = JT.frontier(c, TILE_TH, k, s0 + k)
    fb = min(JT.below(c, TILE_TH, k, s0), fr)
    segs = JT.class_rows(TILE_RES[0], TILE_TH, k, fr, fb)
    assert segs[2] and (shape not in T.FLAT_SHAPES or segs[1]), segs
    s, fields = T.fluid_init(cfg, dev)
    rng = np.random.default_rng(4)
    s = {key: v + torch.as_tensor((1e-3 * rng.standard_normal(tuple(v.shape))).astype(np.float32),
                                  device=dev) for key, v in s.items()}
    return cfg, fields, s, s0, segs


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("shape", ["45degree", "cylinder"])
def test_cuda_fluid_k_matches_twin(cuda, shape, k):
    """One launch of each tile-class kernel on its rows of the split
    (the full class's three segments wrap rows 0 and H-1) against its
    twin: every cell of the outputs, rows off the launch untouched; 1e-5."""
    cfg, _, s, step, (full, bt, lean) = _tile_case(cuda, shape, k)
    calls = [("fluid_k", lambda fn, o: fn(s["f"], s["rho"], s["vel"], o, full, step, k, cfg),
              JT.fluid_k_ref),
             ("fluid_k_lean", lambda fn, o: fn(s["f"], o, lean, k, cfg), JT.fluid_k_lean_ref)]
    if bt:
        calls.append(("fluid_k_bt", lambda fn, o: fn(s["f"], s["rho"], s["vel"], o, bt, k, cfg),
                      JT.fluid_k_bt_ref))
    for name, call, twin in calls:
        wrapper = getattr(JT, name)
        n0 = wrapper.launches
        got, want = _outs(s), _outs(s)
        call(wrapper, got)
        call(twin, want)
        torch.cuda.synchronize()
        assert wrapper.launches == n0 + 1
        _close_all(got, want, 1e-5, f"{name} {shape} k={k} step {step}")


def _tile_twin_runner(cfg, **kw):
    run = JT.make_tiled_fluid_runner(cfg, **kw)
    twins = dict(fluid_k=JT.fluid_k_ref, fluid_k_lean=JT.fluid_k_lean_ref,
                 fluid_k_bt=JT.fluid_k_bt_ref, fluid_pass=JT.fluid_pass_ref,
                 fluid_a=jrl_fluid.fluid_a_ref, fluid_b=jrl_fluid.fluid_b_ref)

    def twin_run(state, fields, start, n):
        with mock.patch.multiple(JT, **twins):
            return run(state, fields, start, n)

    return twin_run


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("shape", ["45degree", "cylinder"])
def test_cuda_tiled_runner_matches_twin_runner(cuda, shape, k):
    """The tiled runner over 41 steps in which the frontier tile changes,
    against the same runner on the twins: f and rho 2e-5, vel 2e-4; at
    k = 1 the full and lean rows go through fluid_pass, at k = 2 through
    the two class kernels."""
    cfg, fields, s, _, _ = _tile_case(cuda, shape, k)
    c, n = JT.tile_consts(cfg), 41
    start = 0 if shape not in T.FLAT_SHAPES else 200
    while JT.frontier(c, TILE_TH, k, start) == JT.frontier(c, TILE_TH, k, start + n):
        start += 10
    kw = dict(tile_rows=TILE_TH, unroll=4, k=k)
    kernels.reset_launches()
    got = JT.make_tiled_fluid_runner(cfg, **kw)(s, fields, start, n)
    torch.cuda.synchronize()
    counts = kernels.launches()
    want = _tile_twin_runner(cfg, **kw)(s, fields, start, n)
    for name in ("f", "rho", "vel"):
        _close(got[name], want[name], TRAJ_TOL[name], f"tiled runner {shape} k={k} {name}")
    if k == 1:
        assert counts["fluid_pass"] >= 1 and counts["fluid_k"] == counts["fluid_k_lean"] == 0
    else:
        assert counts["fluid_k"] >= 1 and counts["fluid_k_lean"] >= 1 and not counts["fluid_pass"]
    assert kernels.launches() == counts  # the twins launch nothing


@pytest.mark.cuda
def test_cuda_tile_wrappers_refuse_bad_args(cuda):
    cfg, _, s, step, (full, _, lean) = _tile_case(cuda, "45degree", 1)
    out = _outs(s)
    with pytest.raises(ValueError, match="k ="):
        JT.fluid_k(s["f"], s["rho"], s["vel"], out, full, step, 5, cfg)
    with pytest.raises(ValueError, match="segments"):
        JT.fluid_k_lean(s["f"], out, [(32, 16)], 1, cfg)
    with pytest.raises(ValueError, match="apart"):
        JT.fluid_k_lean(s["f"], dict(out, f=s["f"]), lean, 1, cfg)
    with pytest.raises(ValueError, match="dtype"):
        JT.fluid_k(s["f"], s["rho"].double(), s["vel"], out, full, step, 1, cfg)


# --- the k = 1 split pass in one launch (fluid_pass) ---

# the default refine-8 case (1024x512): the split plans of its travel's
# first step, its middle and its last split steps
PASS_STEPS = (0, 825_712_484, 1_651_000_000)


def _pass_case(dev, cfg, step, seed=8):
    H = cfg.eff_res[0]
    kind, _, _, fr, fb = JT.chunk_plan(cfg, step, 1)[0]
    assert kind == "split", (kind, step)
    s, fields = T.fluid_init(cfg, dev)
    rng = np.random.default_rng(seed)
    s = {key: v + torch.as_tensor((1e-3 * rng.standard_normal(tuple(v.shape))).astype(np.float32),
                                  device=dev) for key, v in s.items()}
    return s, fields, JT.class_rows(H, JT.pick_tile_rows(cfg), 1, fr, fb)


def _pass_against_classes(s, cfg, step, full, lean, tag, reps=3):
    """fluid_pass (``reps`` launches) equals fluid_k + fluid_k_lean bit for
    bit and its twin within 1e-5; one launch counted each."""
    cls, want = _outs(s), _outs(s)
    JT.fluid_k(s["f"], s["rho"], s["vel"], cls, full, step, 1, cfg)
    if lean:
        JT.fluid_k_lean(s["f"], cls, lean, 1, cfg)
    JT.fluid_pass_ref(s["f"], s["rho"], s["vel"], want, full, lean, step, cfg)
    for _ in range(reps):
        got = _outs(s)
        n0 = JT.fluid_pass.launches
        JT.fluid_pass(s["f"], s["rho"], s["vel"], got, full, lean, step, cfg)
        torch.cuda.synchronize()
        assert JT.fluid_pass.launches == n0 + 1
        for k in ("f", "rho", "vel"):
            assert torch.equal(got[k], cls[k]), f"{tag} {k}: not the classes' bits"
        _close_all(got, want, 1e-5, tag)


@pytest.mark.cuda
@pytest.mark.parametrize("step", PASS_STEPS)
def test_cuda_fluid_pass_equals_classes_on_refine8_plans(cuda, step):
    cfg = T.JRLFluidConfig(shape="ethaline", refine=8)
    s, _, (full, bt, lean) = _pass_case(cuda, cfg, step)
    assert not bt and lean
    _pass_against_classes(s, cfg, step, full, lean, f"step {step}")


@pytest.mark.cuda
def test_cuda_fluid_pass_equals_classes_across_2_24(cuda):
    cfg = T.JRLFluidConfig(shape="ethaline", refine=8, res=(128, 64), Re=1.2e-5,
                           vel_obs_real=28e-6, gravity_strength_real=-9.8)
    s, _, _ = _pass_case(cuda, cfg, 2**24 - 5)
    for step in range(2**24 - 5, 2**24 + 5):
        full, _, lean = _pass_case(cuda, cfg, step)[2]
        _pass_against_classes(s, cfg, step, full, lean, f"step {step}", reps=1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,res", [("cylinder", (1024, 512)), ("45degree", (256, 64)),
                                       ("45degree", (1024, 1280))])
def test_cuda_fluid_pass_equals_classes_on_other_grids(cuda, shape, res):
    """A flat tip whose pass also has below-tip rows (fluid_k_bt's, left
    alone), the small grid of the tile tests and a grid of three column
    strips."""
    cfg = T.JRLFluidConfig(res=res, Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8,
                           shape=shape)
    c, TH = JT.tile_consts(cfg), JT.pick_tile_rows(cfg)
    last, step = JT.lean_last(res[0] // TH, TH, 1), 5
    while not (JT.frontier(c, TH, 1, step + 1) < last
               and (shape not in T.FLAT_SHAPES or JT.below(c, TH, 1, step))):
        step += 8
    s, _, (full, bt, lean) = _pass_case(cuda, cfg, step)
    assert lean and (shape not in T.FLAT_SHAPES or bt), (full, bt, lean)
    _pass_against_classes(s, cfg, step, full, lean, f"{shape} {res} step {step}")


@pytest.mark.cuda
def test_cuda_tiled_runner_pass_equals_classes(cuda):
    """The runner at k = 1 through fluid_pass and through the classes over
    41 steps across a frontier change, bit for bit; launch counts."""
    cfg = T.JRLFluidConfig(shape="ethaline", refine=8)
    start, n = PASS_STEPS[1], 41
    s, fields, _ = _pass_case(cuda, cfg, start)
    got = {}
    for route in JT.ROUTES:
        kernels.reset_launches()
        got[route] = JT.make_tiled_fluid_runner(cfg, route=route)(s, fields, start, n)
        torch.cuda.synchronize()
        counts = {k: c for k, c in kernels.launches().items() if c}
        assert counts == ({"fluid_pass": n} if route == "pass"
                          else {"fluid_k": n, "fluid_k_lean": n}), counts
    for k in ("f", "rho", "vel"):
        assert torch.equal(got["pass"][k], got["classes"][k]), k


@pytest.mark.cuda
def test_cuda_fluid_pass_refuses_bad_args(cuda):
    cfg = T.JRLFluidConfig(shape="ethaline", refine=8)
    s, _, (full, _, lean) = _pass_case(cuda, cfg, 0)
    out = _outs(s)
    with pytest.raises(ValueError, match="segments"):
        JT.fluid_pass(s["f"], s["rho"], s["vel"], out, [], lean, 0, cfg)
    with pytest.raises(ValueError, match="segments"):
        JT.fluid_pass(s["f"], s["rho"], s["vel"], out, full, [(300, 500)], 0, cfg)
    with pytest.raises(ValueError, match="apart"):
        JT.fluid_pass(s["f"], s["rho"], s["vel"], dict(out, rho=s["rho"]), full, lean, 0, cfg)
    with pytest.raises(ValueError, match="dtype"):
        JT.fluid_pass(s["f"], s["rho"].double(), s["vel"], out, full, lean, 0, cfg)
    odd = T.JRLFluidConfig(res=(256, 66), Re=4.0, vel_obs_real=0.2848, shape="45degree")
    so, _ = T.fluid_init(odd, cuda)
    with pytest.raises(ValueError, match="W % 4"):
        JT.fluid_pass(so["f"], so["rho"], so["vel"], _outs(so), [(0, 64)], [], 0, odd)


# --- the shear layer's periodic kernel (kernels/periodic.py) ---

# (collision, kbc_type): BGK, MRT and the five KBC types, one template
# instance each
RELAXES = [("bgk", None), ("mrt", None)] + [("kbc", int(k)) for k in KBCType]


def _shear_state(dev, res, collision, kbc_type, seed=5):
    """``(cfg, fields, state)``: the scene's initial state plus seeded
    noise (1e-3 of each field's scale), so that every cell differs."""
    cfg = SL.ShearLayerConfig(res=res, collision=collision, kbc_type=kbc_type)
    s, fields = SL.init(cfg, dev)
    rng = np.random.default_rng(seed)
    s = {k: v * (1.0 + torch.as_tensor((1e-3 * rng.standard_normal(tuple(v.shape)))
                                       .astype(np.float32), device=dev))
         for k, v in s.items()}
    return cfg, fields, s


@pytest.mark.cuda
@pytest.mark.parametrize("res", [(130, 130), (64, 48)])
@pytest.mark.parametrize("collision,kbc_type", RELAXES)
def test_cuda_periodic_matches_twin(cuda, collision, kbc_type, res):
    """One launch of each instance against the twin at 130² (H no
    multiple of 8) and 64x48: 1e-6 (bit for bit is expected)."""
    cfg, _, s = _shear_state(cuda, res, collision, kbc_type)
    c = P.consts(cfg)
    got, want = _outs(s), _outs(s)
    n0 = P.periodic.launches
    P.periodic(s["f"], got, c)
    P.periodic_ref(s["f"], want, c)
    torch.cuda.synchronize()
    assert P.periodic.launches == n0 + 1
    _close_all(got, want, 1e-6, f"periodic {collision} {kbc_type} {res}")


@pytest.mark.cuda
@pytest.mark.parametrize("collision,kbc_type", RELAXES)
def test_cuda_periodic_runner_matches_twin_runner(cuda, collision, kbc_type):
    """100 steps of the kernel runner at 130² against the runner on the
    twin: f and rho 2e-5, vel 2e-4; one launch a step."""
    cfg, fields, s = _shear_state(cuda, (130, 130), collision, kbc_type)
    run = P.make_fused_periodic_runner(cfg)
    kernels.reset_launches()
    got = run(s, fields, 100)
    torch.cuda.synchronize()
    assert kernels.launches() == dict({k: 0 for k in kernels.KERNELS}, periodic=100)
    with mock.patch.object(P, "periodic", P.periodic_ref):
        want = run(s, fields, 100)
    for name in ("f", "rho", "vel"):
        _close(got[name], want[name], TRAJ_TOL[name], f"periodic runner {collision} {name}")


@pytest.mark.cuda
def test_cuda_run_shear_launches_periodic_only(cuda):
    """`run_shear` on the card goes through the kernel, one launch a
    step and no other kernel; mass stays at H W density."""
    cfg = SL.ShearLayerConfig(collision="mrt")
    kernels.reset_launches()
    state, dumps = shear_main.run_shear(cfg, 50, 10, cuda)
    torch.cuda.synchronize()
    assert kernels.launches() == dict({k: 0 for k in kernels.KERNELS}, periodic=50)
    assert [d[0] for d in dumps] == [10, 20, 30, 40, 50]
    H, W = cfg.res
    assert abs(float(state["f"].sum()) / (H * W * cfg.density) - 1.0) < 1e-4


@pytest.mark.cuda
def test_cuda_periodic_refuses_and_raises(cuda):
    """Bad tensors raise before a launch; a launch the library refuses (an
    unknown relaxation, called below the wrapper) raises a cudaError."""
    cfg, _, s = _shear_state(cuda, (64, 48), "mrt", None)
    c = P.consts(cfg)
    out = _outs(s)
    with pytest.raises(ValueError, match="dtype"):
        P.periodic(s["f"].double(), out, c)
    with pytest.raises(ValueError, match="apart"):
        P.periodic(s["f"], dict(out, f=s["f"]), c)
    with pytest.raises(ValueError, match="on cpu"):
        P.periodic(s["f"], dict(out, rho=out["rho"].cpu()), c)
    fn = build.bind("periodic", "periodic_launch", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                    + [ctypes.c_void_p] * 2)
    err = fn(s["f"].data_ptr(), out["f"].data_ptr(), out["rho"].data_ptr(), out["vel"].data_ptr(),
             7, 0, ctypes.byref(c.params), jrl_fluid.stream_of(cuda))
    assert err != 0
    with pytest.raises(RuntimeError, match="cudaError"):
        build.check(err, "periodic")


# --- the JRL case on a mesh of shards (kernels/jrl_sharded.py, kernels/halo.py) ---

SH_RES = (256, 128)
SH_MESHES = [(4, 1), (2, 2)]


def _sh_setup(dev, mesh_shape):
    """A 256x128 wedge fluid state 8 twin steps in, a cylinder C state 5
    balance steps in, the mesh on the one card and its shards."""
    fc = T.JRLFluidConfig(res=SH_RES, Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8,
                          shape="45degree")
    s, fl = T.fluid_init(fc, dev)
    s = T.make_fluid_runner(fc)(s, fl, 0, 8)
    cc = T.JRLCConfig(res=SH_RES, Re=4.0, Pe=5.0, shape="cylinder")
    st, cf, flags = T.c_init(cc, dev)
    st = T.make_balance_runner(cc, flags)(st, cf, 5)
    mesh = make_mesh(mesh_shape, [dev] * (mesh_shape[0] * mesh_shape[1]))
    shards = [S.Shard.of(*SH_RES, mesh.shape, c) for c in mesh.local]
    return fc, s, fl, cc, st, cf, flags, mesh, shards


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", SH_MESHES)
def test_cuda_sharded_kernels_match_twins(cuda, mesh_shape):
    """One launch of each sharded kernel on every shard against its twin,
    from the same halo pieces: fluid A and B (the lean instances too on
    the shards above the tip, where they equal the full ones bit for
    bit), balance and approach (with the shard's disk terms), and
    halo_pack in both phases bit for bit."""
    fc, s, fl, cc, st, cf, flags, mesh, shards = _sh_setup(cuda, mesh_shape)
    L, k = range(len(shards)), 8
    f, rho, vel = (split(s[x], mesh) for x in ("f", "rho", "vel"))
    g0 = [f[0], vel[0]]
    for got, want in zip(HA.halo_pack(g0), HA.halo_pack_ref(g0)):
        assert torch.equal(got, want)
    t, b = HA.halo_pack_ref([f[1], vel[1]])
    for got, want in zip(HA.halo_pack(g0, t, b, 2), HA.halo_pack_ref(g0, t, b, 2)):
        assert torch.equal(got, want)
    ha = HA.exchange([[f[i], vel[i]] for i in L], mesh, S.XH)
    a_ref = [S.fluid_a_sh_ref(f[i], rho[i], vel[i], ha[i], k, fc, fl, shards[i]) for i in L]
    hb = HA.exchange([[a[1], a[2]] for a in a_ref], mesh, S.XH)
    n_lean = 0
    for i, sh in enumerate(shards):
        leans = (False, True) if mesh.shape[1] == 1 and S.lean_shard(fc, sh, k) else (False,)
        for lean in leans:
            tag = f"shard {mesh.local[i]} lean={lean}"
            a = S.fluid_a_sh(f[i], rho[i], vel[i], ha[i], k, fc, fl, sh, lean)
            want = S.fluid_a_sh_ref(f[i], rho[i], vel[i], ha[i], k, fc, fl, sh, lean)
            for name, g_, w_, tol in zip(("f", "rho", "vel"), a, want, (1e-5, 1e-5, 1e-4)):
                _close(g_, w_, tol, f"fluid_a_sh {tag} {name}")
            fb = S.fluid_b_sh(*a_ref[i], hb[i], k, fc, fl, sh, lean)
            _close(fb, S.fluid_b_sh_ref(*a_ref[i], hb[i], k, fc, fl, sh, lean), 1e-5,
                   f"fluid_b_sh {tag} f")
            if lean:
                n_lean += 1
                full_a = S.fluid_a_sh(f[i], rho[i], vel[i], ha[i], k, fc, fl, sh)
                assert all(torch.equal(x, y) for x, y in zip(a, full_a)), tag
                assert torch.equal(fb, S.fluid_b_sh(*a_ref[i], hb[i], k, fc, fl, sh)), tag
    assert n_lean == (2 if mesh.shape == (4, 1) else 0)

    h, C, fls = split(st["h"], mesh), split(st["C"], mesh), split(flags, mesh)
    hh = HA.exchange([[x] for x in h], mesh, S.XH)
    hfl = HA.exchange([[x] for x in fls], mesh, S.XH)
    for i, sh in enumerate(shards):
        got = S.c_balance_sh(h[i], C[i], fls[i], hh[i], hfl[i], cc, cf, sh)
        want = S.c_balance_sh_ref(h[i], C[i], fls[i], hh[i], hfl[i], cc, cf, sh)
        for name, g_, w_ in zip(("h", "C"), got, want):
            _close(g_, w_, 1e-5, f"c_balance_sh {mesh.local[i]} {name}")
    H, W = SH_RES
    vf = np.random.default_rng(7).uniform(-0.5, 0.5, (3, 2, H, W)).astype(np.float32)
    frames = split(torch.as_tensor(vf, device=cuda), mesh)
    base = split(cf["base_flags"], mesh)
    hbase = HA.exchange([[x] for x in base], mesh, S.XH)
    for k in (3, 4):
        for i, sh in enumerate(shards):
            v = T.stored_velocity(frames[i], k, cc.vel_obs_conv)
            part = torch.zeros(4, device=cuda)
            got = S.c_approach_sh(h[i], C[i], v, base[i], hh[i], hbase[i], k, cc, cf, sh, part)
            *want, p_ref = S.c_approach_sh_ref(h[i], C[i], v, base[i], hh[i], hbase[i], k, cc,
                                               cf, sh)
            for name, g_, w_ in zip(("h", "C"), got, want):
                _close(g_, w_, 1e-5, f"c_approach_sh {mesh.local[i]} step {k} {name}")
            np.testing.assert_allclose(part.cpu().numpy(), p_ref.cpu().numpy(), rtol=2e-4,
                                       atol=1e-4, err_msg=f"disk terms {mesh.local[i]}")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", SH_MESHES)
def test_cuda_sharded_runners_equal_per_step_kernels(cuda, mesh_shape):
    """The three sharded runners against the unsharded per-step kernels'
    runners: fluid over 60 steps (six tip rows), balance 40, approach 40
    across stored-velocity frames, f/rho/vel and h/C bit for bit; only the
    sharded kernels and halo_mesh launch (the fluid through fluid_pass_sh
    on both meshes, the C phases through c_balance_pass_sh and
    c_approach_pass_sh, on (2, 2) their column instances)."""
    fc, s, fl, cc, st, cf, flags, mesh, _ = _sh_setup(cuda, mesh_shape)
    sharded = {"fluid_pass_sh", "halo_mesh"}
    kernels.reset_launches()
    got = S.make_sharded_tiled_fluid_runner(fc, mesh)(s, fl, 8, 60)
    torch.cuda.synchronize()
    assert {k for k, c in kernels.launches().items() if c} == sharded
    want = T.make_per_step_fluid_runner(fc)(s, fl, 8, 60)
    for name in ("f", "rho", "vel"):
        assert torch.equal(got[name], want[name]), f"fluid {name}"
    kernels.reset_launches()
    got = S.make_sharded_tiled_balance_runner(cc, flags, mesh)(st, cf, 40)
    torch.cuda.synchronize()
    assert {k for k, c in kernels.launches().items() if c} == {"c_balance_pass_sh", "halo_mesh"}
    want = T.make_per_step_balance_runner(cc, flags)(st, cf, 40)
    for name in ("h", "C"):
        assert torch.equal(got[name], want[name]), f"balance {name}"
    H, W = SH_RES
    vf = torch.as_tensor(np.random.default_rng(9).uniform(-0.5, 0.5, (8, 2, H, W))
                         .astype(np.float32), device=cuda)
    got, acc = S.make_sharded_tiled_approach_runner(cc, vf, mesh)(st, cf, 0, 40)
    want, acc_r = T.make_per_step_approach_runner(cc, vf)(st, cf, 0, 40)
    for name in ("h", "C"):
        assert torch.equal(got[name], want[name]), f"approach {name}"
    for key in ("inflow_sum", "current_sum", "count", "rec_u", "rec_v"):
        np.testing.assert_allclose(float(acc[key]), float(acc_r[key]), rtol=2e-4, atol=1e-4,
                                   err_msg=key)


@pytest.mark.cuda
def test_cuda_sharded_fluid_from_step_2_24_minus_5(cuda):
    """Steps 2**24 - 5 .. 2**24 + 4 on a (4, 1) mesh keep the jnp step form
    ((float)step of the integer step): bit for bit the per-step kernels."""
    cfg = T.JRLFluidConfig(res=SH_RES, Re=1.2e-5, shape="cylinder")
    start, n = 2**24 - 5, 10
    s, fl = T.fluid_init(cfg, cuda)
    rng = np.random.default_rng(24)
    s = {k: v + torch.as_tensor((1e-3 * rng.standard_normal(tuple(v.shape))).astype(np.float32),
                                device=cuda) for k, v in s.items()}
    mesh = make_mesh((4, 1), [cuda] * 4)
    got = S.make_sharded_tiled_fluid_runner(cfg, mesh)(s, fl, start, n)
    want = T.make_per_step_fluid_runner(cfg)(s, fl, start, n)
    for name in ("f", "rho", "vel"):
        assert torch.equal(got[name], want[name]), name


# --- the whole exchange of a mesh on one card (halo_mesh) ---

HALO_MESHES = [(2, 1), (4, 1), (1, 2), (2, 2)]


def _halos_equal(got, want, tag):
    """Two `Halo` lists equal bit for bit, piece by piece."""
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a.P, a.k) == (b.P, b.k), tag
        for name in ("top", "bot", "left", "right"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), f"{tag} shard {i} {name}"
            if x is not None:
                assert x.is_contiguous() and x.data_ptr() % 16 == 0, f"{tag} {name}"
                assert x.shape == y.shape and x.dtype == y.dtype, f"{tag} shard {i} {name}"
                assert torch.equal(x.view(torch.int32), y.view(torch.int32)), \
                    f"{tag} shard {i} {name}"


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", HALO_MESHES)
def test_cuda_halo_mesh_equals_twin_and_shards(cuda, mesh_shape):
    """halo_mesh (one launch an exchange) bit for bit its twin and the
    per-shard route (``route="shards"``: halo_pack a shard and phase) on
    the JRL passes' groups (``[f, vel, rho]``, ``[h, C]``, ``[h]``, int32
    flags at 2k rows and ``pass_xh(k)`` lanes, k = 1..4) and the
    cylinder's lean (k = 1, 4) and full groups; the default route of a
    one-card mesh is the mesh route, one launch an exchange."""
    _, s, _, _, st, _, flags, mesh, _ = _sh_setup(cuda, mesh_shape)
    nx = mesh_shape[1]
    f, rho, vel = (split(s[x], mesh) for x in ("f", "rho", "vel"))
    h, C, fl = (split(x, mesh) for x in (st["h"], st["C"], flags))
    L = range(len(f))
    cases = []
    for k in (1, 2, 3, 4):
        xh = S.pass_xh(k) if nx > 1 else 0
        for tag, grp in (("[f, vel, rho]", [[f[i], vel[i], rho[i]] for i in L]),
                         ("[h, C]", [[h[i], C[i]] for i in L]), ("[h]", [[x] for x in h]),
                         ("[flags]", [[x] for x in fl])):
            cases.append((f"{tag} k={k}", grp, xh, 2 * k))
    cfg, cs, cfl = _cyl_sh_setup(cuda)
    cf_, crho, cvel = (split(cs[x], mesh) for x in ("f", "rho", "vel"))
    cflags, cphi = split(cfl["flags"], mesh), split(cfl["phi_obs"], mesh)
    for k in (1, 4):
        cases.append((f"cylinder lean k={k}", [CS.lean_group(cf_[i], crho[i], cvel[i], cflags[i],
                                                              cphi[i]) for i in L],
                      k if nx > 1 else 0, k))
    cases.append(("cylinder full", [CS.full_group(cf_[i], cvel[i], cflags[i]) for i in L],
                  1 if nx > 1 else 0, 1))
    for tag, grp, xh, rows in cases:
        assert HA.halo_route(grp, mesh) == "mesh"
        n0 = HA.halo_mesh.launches
        got = HA.exchange(grp, mesh, xh, rows)
        assert HA.halo_mesh.launches == n0 + 1, tag
        _halos_equal(got, HA.halo_mesh_ref(grp, mesh, xh, rows), f"{tag}: twin")
        _halos_equal(got, HA.exchange(grp, mesh, xh, rows, route="shards"), f"{tag}: shards")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_fluid_pass_on_2x2_mesh_route_equals_shards_route(cuda):
    """One k = 4 pass of the (2, 2) fluid runner with its exchange through
    halo_mesh (the default: one launch) and through ``route="shards"``
    (eight halo_pack launches): bit for bit."""
    fc, s, fl, _, _, _, _, mesh, _ = _sh_setup(cuda, (2, 2))
    run = S.make_sharded_tiled_fluid_runner(fc, mesh, k=4)
    assert (run.route, run.k) == ("pass", 4)
    out = {}
    for route in ("mesh", "shards"):
        kernels.reset_launches()
        with mock.patch.object(HA, "halo_route", lambda groups, mesh, route=route: route):
            out[route] = run(s, fl, 8, 4)
        torch.cuda.synchronize()
        halo = {"halo_mesh": 1} if route == "mesh" else {"halo_pack": 8}
        assert {x: c for x, c in kernels.launches().items() if c} == \
            dict({"fluid_pass_sh": 4}, **halo), route
    for name in ("f", "rho", "vel"):
        assert torch.equal(out["mesh"][name], out["shards"][name]), name


# --- the sharded fluid step's k-step pass (fluid_pass_sh) ---

PASS_MESHES = [(1, 1), (2, 1), (4, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", PASS_MESHES)
def test_cuda_fluid_pass_sh_equals_twin_and_pair(cuda, mesh_shape):
    """One launch on every shard at k = 1..4 from step 8 (the lean class too
    on the shards where `lean_pass` holds; one cooperative launch of
    sub-steps in turn): bit for bit its twin, run on the CPU from the same
    inputs, and bit for bit k steps of the A/B pair
    (``route="launches"``)."""
    fc, s, fl, _, _, _, _, mesh, shards = _sh_setup(cuda, mesh_shape)
    L = range(len(shards))
    f, rho, vel = (split(s[x], mesh) for x in ("f", "rho", "vel"))
    n_lean = 0
    for k in range(1, 5):
        hx = HA.exchange([[f[i], vel[i], rho[i]] for i in L], mesh, S.XH, rows=2 * k)
        pair = S.make_sharded_tiled_fluid_runner(fc, mesh, route="launches")(s, fl, 8, k)
        for i, sh in enumerate(shards):
            for lean in (False, True) if S.lean_pass(fc, sh, 8, k) else (False,):
                tag = f"shard {mesh.local[i]} k={k} lean={lean}"
                n0 = S.fluid_pass_sh.launches
                got = S.fluid_pass_sh(f[i], rho[i], vel[i], hx[i], 8, k, fc, fl, sh, lean)
                assert S.fluid_pass_sh.launches == n0 + 1
                halo = None if hx[i].top is None else HA.Halo(12, hx[i].top.cpu(),
                                                               hx[i].bot.cpu(), k=2 * k)
                want = S.fluid_pass_sh_ref(f[i].cpu(), rho[i].cpu(), vel[i].cpu(), halo, 8, k,
                                           fc, None, sh, lean)
                for name, g_, w_, p_ in zip(("f", "rho", "vel"), got, want,
                                            (pair["f"], pair["rho"], pair["vel"])):
                    assert torch.equal(g_.cpu(), w_), f"{tag} {name}: twin"
                    assert torch.equal(g_, sh.body(p_)), f"{tag} {name}: pair"
                n_lean += lean
    assert n_lean == {(1, 1): 0, (2, 1): 0, (4, 1): 8}[mesh_shape]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("mesh_shape", PASS_MESHES)
def test_cuda_fluid_pass_route_equals_launches(cuda, mesh_shape, k):
    """The runner through the pass over 50 steps from step 8 (passes that
    cross tip rows; the remainder at a smaller k): bit for bit
    ``route="launches"`` and the unsharded per-step runner; one
    fluid_pass_sh launch a shard and pass, one halo_mesh launch a pass
    (the whole exchange) on (2, 1) and (4, 1)."""
    fc, s, fl, _, _, _, _, mesh, shards = _sh_setup(cuda, mesh_shape)
    n = 50
    rows = [T.tip_walks(fc.inflow_height, st, fc.vel_obs)[1] for st in (8, 8 + n - 1)]
    assert rows[1] > rows[0]
    kernels.reset_launches()
    got = S.make_sharded_tiled_fluid_runner(fc, mesh, k=k)(s, fl, 8, n)
    torch.cuda.synchronize()
    passes = -(-n // k)
    want_counts = {"fluid_pass_sh": passes * len(shards)}
    if len(shards) > 1:
        want_counts["halo_mesh"] = passes
    assert {x: c for x, c in kernels.launches().items() if c} == want_counts
    pair = S.make_sharded_tiled_fluid_runner(fc, mesh, route="launches")(s, fl, 8, n)
    per_step = T.make_per_step_fluid_runner(fc)(s, fl, 8, n)
    for name in ("f", "rho", "vel"):
        assert torch.equal(got[name], pair[name]), f"k={k} {name}: launches"
        assert torch.equal(got[name], per_step[name]), f"k={k} {name}: per-step"


@pytest.mark.cuda
def test_cuda_fluid_pass_sh_refuses_bad_inputs(cuda):
    """Pieces of another depth or plane count, a lean pass off the inner
    shards, a misaligned plane, a column mesh's shard without its blocks
    and a scratch too small for the pass raise before a launch."""
    fc, s, fl, _, _, _, _, mesh, shards = _sh_setup(cuda, (4, 1))
    f, rho, vel = (split(s[x], mesh) for x in ("f", "rho", "vel"))
    hx = HA.exchange([[f[i], vel[i], rho[i]] for i in range(4)], mesh, S.XH, rows=4)
    sh = shards[0]
    n0 = S.fluid_pass_sh.launches
    with pytest.raises(ValueError, match="do not match"):
        S.fluid_pass_sh(f[0], rho[0], vel[0], hx[0], 8, 1, fc, fl, sh)
    with pytest.raises(ValueError, match="halo top"):
        S.fluid_pass_sh(f[0], rho[0], vel[0], HA.Halo(12, hx[0].top[:, :3].contiguous(),
                                                      hx[0].bot, k=4), 8, 2, fc, fl, sh)
    with pytest.raises(ValueError, match="inner shards"):
        S.fluid_pass_sh(f[0], rho[0], vel[0], hx[0], 8, 2, fc, fl, sh, lean=True)
    buf = torch.empty(f[0].numel() + 1, device=cuda)
    odd = buf[1:].view_as(f[0]).copy_(f[0])
    with pytest.raises(ValueError, match="16-byte"):
        S.fluid_pass_sh(odd, rho[0], vel[0], hx[0], 8, 2, fc, fl, sh)
    with pytest.raises(ValueError, match="do not match"):
        S.fluid_pass_sh(f[0], rho[0], vel[0], None, 8, 1, fc, fl,
                        S.Shard.of(*SH_RES, (2, 2), (0, 0)))
    with pytest.raises(ValueError, match="scratch"):
        S.fluid_pass_sh(f[0], rho[0], vel[0], hx[0], 8, 2, fc, fl, sh,
                        scratch=torch.empty((1, 12, 4, sh.W), device=cuda))
    assert S.fluid_pass_sh.launches == n0


@pytest.mark.cuda
def test_cuda_fluid_pass_sh_refuses_a_plan_over_the_card(cuda):
    """A tiles plan whose grid outgrows the blocks the card holds at once is
    refused by the cooperative launcher, and one whose tables outgrow the
    shared memory by the entry point: both raise, nothing launched."""
    fc, s, fl, _, _, _, _, mesh, shards = _sh_setup(cuda, (4, 1))
    f, rho, vel = (split(s[x], mesh) for x in ("f", "rho", "vel"))
    hx = HA.exchange([[f[i], vel[i], rho[i]] for i in range(4)], mesh, S.XH, rows=4)
    sh = shards[1]
    plan = S.pass_sh_plan(sh, 2, jrl_fluid.sm_count(cuda))
    n0 = S.fluid_pass_sh.launches
    for bad, match in ((S.TilePlan(plan.nty, plan.ntx, plan.rmax, plan.smax, 100000),
                        "cudaError 720"),
                       (S.TilePlan(plan.nty, plan.ntx, 59, 512, plan.grid), "cudaError 1 ")):
        with mock.patch.object(S, "pass_sh_plan", return_value=bad):
            with pytest.raises(RuntimeError, match=match):
                S.fluid_pass_sh(f[1], rho[1], vel[1], hx[1], 8, 2, fc, fl, sh)
    assert S.fluid_pass_sh.launches == n0


# --- the column meshes' pass (fluid_pass_sh_cols: fluid_pass_sh with its x window) ---

COL_PASS_MESHES = [(2, 2), (1, 2)]


def _col_exchange(mesh, f, rho, vel, k):
    """The pass's halo on a column mesh: 2k-row pieces, `pass_xh` lanes."""
    return HA.exchange([[f[i], vel[i], rho[i]] for i in range(len(f))], mesh, S.pass_xh(k),
                       rows=2 * k)


def _cpu_halo(hx):
    """A halo's row pieces and column blocks on the CPU; None without either."""
    if hx.top is None and hx.left is None:
        return None
    return HA.Halo(hx.P, *(None if t is None else t.cpu()
                           for t in (hx.top, hx.bot, hx.left, hx.right)), k=hx.k)


@pytest.mark.cuda
@pytest.mark.parametrize("start", [8, 2**24 - 5])
@pytest.mark.parametrize("mesh_shape", COL_PASS_MESHES)
def test_cuda_fluid_pass_sh_cols_equals_twin_and_pair(cuda, mesh_shape, start):
    """One launch of the column instance on every shard at k = 1..4 from
    step 8 of the wedge and from 2**24 - 5 of a slow flat tip (the pass's
    steps cross 2**24, as `test_cuda_sharded_fluid_from_step_2_24_minus_5`):
    bit for bit its twin, run on the CPU from the same pieces and blocks,
    and bit for bit k steps of the A/B pair (``route="launches"``)."""
    fc, s, fl, _, _, _, _, mesh, shards = _sh_setup(cuda, mesh_shape)
    if start > 8:
        fc = T.JRLFluidConfig(res=SH_RES, Re=1.2e-5, shape="cylinder")
        s, fl = T.fluid_init(fc, cuda)
        rng = np.random.default_rng(25)
        s = {k: v + torch.as_tensor((1e-3 * rng.standard_normal(tuple(v.shape)))
                                    .astype(np.float32), device=cuda) for k, v in s.items()}
    f, rho, vel = (split(s[x], mesh) for x in ("f", "rho", "vel"))
    for k in range(1, 5):
        hx = _col_exchange(mesh, f, rho, vel, k)
        pair = S.make_sharded_tiled_fluid_runner(fc, mesh, route="launches")(s, fl, start, k)
        for i, sh in enumerate(shards):
            tag = f"shard {mesh.local[i]} k={k} from {start}"
            n0 = S.fluid_pass_sh.launches
            got = S.fluid_pass_sh(f[i], rho[i], vel[i], hx[i], start, k, fc, fl, sh)
            assert S.fluid_pass_sh.launches == n0 + 1
            want = S.fluid_pass_sh_ref(f[i].cpu(), rho[i].cpu(), vel[i].cpu(), _cpu_halo(hx[i]),
                                       start, k, fc, None, sh)
            for name, g_, w_, p_ in zip(("f", "rho", "vel"), got, want,
                                        (pair["f"], pair["rho"], pair["vel"])):
                assert torch.equal(g_.cpu(), w_), f"{tag} {name}: twin"
                assert torch.equal(g_, sh.body(p_)), f"{tag} {name}: pair"


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_cuda_fluid_pass_route_on_2x2_equals_launches(cuda, k):
    """The (2, 2) runner through the pass (its default route) over 50 steps
    from step 8: bit for bit ``route="launches"`` and the unsharded
    per-step runner; one fluid_pass_sh launch a shard and pass and one
    halo_mesh launch a pass (the rows and the column blocks of every
    shard)."""
    fc, s, fl, _, _, _, _, mesh, shards = _sh_setup(cuda, (2, 2))
    n = 50
    kernels.reset_launches()
    run = S.make_sharded_tiled_fluid_runner(fc, mesh, k=k)
    got = run(s, fl, 8, n)
    torch.cuda.synchronize()
    passes = -(-n // k)
    assert run.route == "pass"
    assert {x: c for x, c in kernels.launches().items() if c} == \
        {"fluid_pass_sh": passes * 4, "halo_mesh": passes}
    pair = S.make_sharded_tiled_fluid_runner(fc, mesh, route="launches")(s, fl, 8, n)
    per_step = T.make_per_step_fluid_runner(fc)(s, fl, 8, n)
    for name in ("f", "rho", "vel"):
        assert torch.equal(got[name], pair[name]), f"k={k} {name}: launches"
        assert torch.equal(got[name], per_step[name]), f"k={k} {name}: per-step"


@pytest.mark.cuda
def test_cuda_fluid_pass_sh_cols_registers_and_shape(cuda):
    """The column instance at k = 1..4 spills nothing, and its launch shape
    is the host plan's mirrors' on the (2, 2) shards."""
    sms = jrl_fluid.sm_count(cuda)
    for k in range(1, 5):
        regs, local = S.pass_sh_info(k, cols=True)
        assert local == 0 and 0 < regs <= 128, (k, regs, local)
        for co in ((0, 0), (1, 1)):
            plan = S.pass_sh_plan(S.Shard.of(*SH_RES, (2, 2), co), k, sms)
            got = S.pass_sh_tile_shape(k, plan.rmax, plan.smax, cols=True)
            assert got[:3] == (S.TILE_THREADS, S.TILE_SMEM_CAP,
                               S.tile_smem_bytes(plan.rmax, plan.smax)) and plan.grid <= got[3]


@pytest.mark.cuda
def test_cuda_fluid_pass_sh_cols_refuses_bad_inputs(cuda):
    """On a (2, 2) shard: blocks of 2 lanes or of another depth, no blocks,
    the lean class, a misaligned block and a scratch of a row shard's
    width raise before a launch; the C passes refuse the shard without its
    pieces and blocks."""
    fc, s, fl, cc, st, cf, flags, mesh, shards = _sh_setup(cuda, (2, 2))
    f, rho, vel = (split(s[x], mesh) for x in ("f", "rho", "vel"))
    hx = _col_exchange(mesh, f, rho, vel, 2)
    sh = shards[1]
    n0 = S.fluid_pass_sh.launches
    for bad in (HA.exchange([[f[i], vel[i], rho[i]] for i in range(4)], mesh, S.XH, rows=4)[1],
                _col_exchange(mesh, f, rho, vel, 1)[1],
                HA.Halo(12, hx[1].top, hx[1].bot, k=4)):
        with pytest.raises(ValueError, match="do not match"):
            S.fluid_pass_sh(f[1], rho[1], vel[1], bad, 8, 2, fc, fl, sh)
    with pytest.raises(ValueError, match="row mesh"):
        S.fluid_pass_sh(f[1], rho[1], vel[1], hx[1], 8, 2, fc, fl, sh, lean=True)
    buf = torch.empty(hx[1].left.numel() + 1, device=cuda)
    odd = buf[1:].view_as(hx[1].left).copy_(hx[1].left)
    with pytest.raises(ValueError, match="16-byte"):
        S.fluid_pass_sh(f[1], rho[1], vel[1], HA.Halo(12, hx[1].top, hx[1].bot, odd,
                                                      hx[1].right, k=4), 8, 2, fc, fl, sh)
    row_scr = S.pass_sh_scratch(S.Shard.of(*SH_RES, (2, 1), (0, 0)), 2, cuda)[:, :, :, :sh.w]
    with pytest.raises(ValueError, match="scratch"):
        S.fluid_pass_sh(f[1], rho[1], vel[1], hx[1], 8, 2, fc, fl, sh,
                        scratch=row_scr.contiguous())
    with pytest.raises(ValueError, match="do not match"):
        S.c_balance_pass_sh(split(st["h"], mesh)[1], split(st["C"], mesh)[1],
                            split(flags, mesh)[1], None, None, 1, cc, cf, sh)
    assert S.fluid_pass_sh.launches == n0


# --- the sharded C phases' k-step passes (c_balance_pass_sh, c_approach_pass_sh) ---

# (grid, mesh): the refine-8 ethaline case (1024x512) and the 256x128 flat tip
C_PASS_GRIDS = ["1024x512", "256x128"]


def _c_pass_case(dev, grid):
    """The C config, a state 5 balance steps in (seeded noise), its fields
    and flags, and the approach's start steps: one whose k = 4 steps cross a
    tip row and stored-frame boundaries, and 2**24 - 2."""
    if grid == "1024x512":
        cc = T.JRLCConfig(res=(128, 64), Re=4.0, Pe=5.0, vel_obs_real=0.2848, shape="ethaline",
                          refine=8)
        start = 27
    else:
        cc = T.JRLCConfig(res=SH_RES, Re=4.0, Pe=5.0, shape="cylinder")
        start = 8
    st, cf, flags = T.c_init(cc, dev)
    st = T.make_per_step_balance_runner(cc, flags)(st, cf, 5)
    rng = np.random.default_rng(20)
    st = {k: v + torch.as_tensor((1e-4 * rng.standard_normal(tuple(v.shape))).astype(np.float32),
                                 device=dev) for k, v in st.items()}
    v = cc.vel_obs_conv
    walks = [T.tip_walks(cc.inflow_height, x, v)[1] for x in (start, start + 3)]
    frames = [T.frame_pair(x, v, 10**9)[0] for x in (start, start + 3)]
    assert walks[1] > walks[0] and frames[1] > frames[0]
    return cc, st, cf, flags, (start, 2**24 - 2)


def _pass_frames(dev, cc, start, k, seed):
    """A window of seeded stored frames for steps start .. start + k - 1:
    ``(frames [N, 2, H, W], b0, n_frames)``."""
    v = cc.vel_obs_conv
    b0 = T.frame_pair(start, v, 10**9)[0]
    b1 = T.frame_pair(start + k - 1, v, 10**9)[0]
    H, W = cc.eff_res
    g = torch.Generator(device=dev).manual_seed(seed)
    return 0.5 * torch.randn((b1 - b0 + 2, 2, H, W), generator=g, device=dev), b0, b1 + 10


def _approach_launches(cc, st, cf, mesh, shards, vf, b0, n_frames, start, k):
    """k steps of the per-step route by hand (the lerp, the h pieces and
    c_approach_sh a step) from a frame window: the shards' (h, C) and their
    disk sums."""
    h, C = split(st["h"], mesh), split(st["C"], mesh)
    base, fr = split(cf["base_flags"], mesh), split(vf, mesh)
    hb = HA.exchange([[x] for x in base], mesh, S.XH)
    parts = [torch.zeros(4, device=x.device) for x in h]
    for step in range(start, start + k):
        vel = [T.stored_velocity(f, step, cc.vel_obs_conv, b0, n_frames) for f in fr]
        hh = HA.exchange([[x] for x in h], mesh, S.XH)
        out = [S.c_approach_sh(h[i], C[i], vel[i], base[i], hh[i], hb[i], step, cc, cf, sh,
                               parts[i]) for i, sh in enumerate(shards)]
        h, C = [o[0] for o in out], [o[1] for o in out]
    return h, C, parts


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", PASS_MESHES)
@pytest.mark.parametrize("grid", C_PASS_GRIDS)
def test_cuda_c_balance_pass_sh_equals_twin_and_launches(cuda, grid, mesh_shape):
    """One `c_balance_pass_sh` launch on every shard at k = 1..4: bit for
    bit its twin, run on the CPU from the same inputs, and k steps of
    `c_balance_sh` (``route="launches"``), h and C."""
    cc, st, cf, flags, _ = _c_pass_case(cuda, grid)
    H, W = cc.eff_res
    mesh = make_mesh(mesh_shape, [cuda] * mesh_shape[0])
    shards = [S.Shard.of(H, W, mesh_shape, c) for c in mesh.local]
    h, C, fl = (split(x, mesh) for x in (st["h"], st["C"], flags))
    cf_cpu = {x: y.cpu() for x, y in cf.items()}
    for k in range(1, 5):
        hx = HA.exchange([[h[i], C[i]] for i in range(len(h))], mesh, S.XH, rows=2 * k)
        hfl = HA.exchange([[x] for x in fl], mesh, S.XH, rows=2 * k)
        per = S.make_sharded_tiled_balance_runner(cc, flags, mesh, route="launches")(st, cf, k)
        for i, sh in enumerate(shards):
            tag = f"{grid} shard {mesh.local[i]} k={k}"
            n0 = S.c_balance_pass_sh.launches
            got = S.c_balance_pass_sh(h[i], C[i], fl[i], hx[i], hfl[i], k, cc, cf, sh)
            assert S.c_balance_pass_sh.launches == n0 + 1
            want = S.c_balance_pass_sh_ref(h[i].cpu(), C[i].cpu(), fl[i].cpu(), _cpu_halo(hx[i]),
                                           _cpu_halo(hfl[i]), k, cc, cf_cpu, sh)
            for name, g_, w_ in zip(("h", "C"), got, want):
                assert torch.equal(g_.cpu(), w_), f"{tag} {name}: twin"
                assert torch.equal(g_, sh.body(per[name])), f"{tag} {name}: launches"


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", PASS_MESHES)
@pytest.mark.parametrize("grid", C_PASS_GRIDS)
def test_cuda_c_approach_pass_sh_equals_twin_and_launches(cuda, grid, mesh_shape):
    """One `c_approach_pass_sh` launch on every shard at k = 1..4, from a
    step whose k steps cross a tip row and stored-frame boundaries and from
    2**24 - 2 (a window of the frame history): bit for bit k steps of the
    lerp and `c_approach_sh` (h, C and the shard's disk sums), h and C bit
    for bit its twin run on the CPU, the sums within rtol 2e-4 / atol 1e-4
    of the twin's (PyTorch sums the disk in another order)."""
    cc, st, cf, _, starts = _c_pass_case(cuda, grid)
    H, W = cc.eff_res
    mesh = make_mesh(mesh_shape, [cuda] * mesh_shape[0])
    shards = [S.Shard.of(H, W, mesh_shape, c) for c in mesh.local]
    h, base = split(st["h"], mesh), split(cf["base_flags"], mesh)
    cf_cpu = {x: y.cpu() for x, y in cf.items()}
    for start in starts:
        for k in range(1, 5):
            vf, b0, n_frames = _pass_frames(cuda, cc, start, k, seed=start + k)
            hx = HA.exchange([[x] for x in h], mesh, S.XH, rows=2 * k)
            hb = HA.exchange([[x] for x in base], mesh, S.XH, rows=2 * k)
            ph, pC, pparts = _approach_launches(cc, st, cf, mesh, shards, vf, b0, n_frames,
                                                start, k)
            for i, sh in enumerate(shards):
                tag = f"{grid} shard {mesh.local[i]} step {start} k={k}"
                fr = S.shard_frames(vf, sh, 2 * k, b0=b0, n_frames=n_frames)
                part = torch.zeros(4, device=cuda)
                got = S.c_approach_pass_sh(h[i], base[i], fr, hx[i], hb[i], start, k, cc, cf, sh,
                                           part)
                assert torch.equal(part, pparts[i]), f"{tag}: disk sums"
                for name, g_, p_ in zip(("h", "C"), got, (ph[i], pC[i])):
                    assert torch.equal(g_, p_), f"{tag} {name}: launches"
                fr_c = S.ShardFrames(fr.t.cpu(), fr.row0, fr.b0, fr.n_frames)
                wh, wC, wparts = S.c_approach_pass_sh_ref(
                    h[i].cpu(), base[i].cpu(), fr_c, _cpu_halo(hx[i]), _cpu_halo(hb[i]), start, k,
                    cc, cf_cpu, sh)
                assert torch.equal(got[0].cpu(), wh) and torch.equal(got[1].cpu(), wC), \
                    f"{tag}: twin"
                want = torch.zeros(4)
                for p_ in wparts:
                    want = torch.stack([want[0] + p_[0], want[1] + p_[1], p_[2], p_[3]])
                np.testing.assert_allclose(part.cpu().numpy(), want.numpy(), rtol=2e-4,
                                           atol=1e-4, err_msg=f"{tag}: twin's disk sums")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("mesh_shape", PASS_MESHES)
def test_cuda_c_pass_routes_equal_launches(cuda, mesh_shape, k):
    """The balance runner through the pass over 30 steps and the approach
    runner over 30 steps from step 8 (unroll 8: passes end at the chunks'
    ends; tip rows and stored frames crossed): bit for bit ``route=
    "launches"`` (h, C, the integrals); one pass launch a shard and pass,
    one halo_mesh launch a pass (and one for the flags) on (2, 1) and
    (4, 1)."""
    fc, s, fl, cc, st, cf, flags, _, _ = _sh_setup(cuda, mesh_shape)
    mesh = make_mesh(mesh_shape, [cuda] * mesh_shape[0])
    n, sh_n = 30, mesh_shape[0]
    kernels.reset_launches()
    got = S.make_sharded_tiled_balance_runner(cc, flags, mesh, k=k)(st, cf, n)
    torch.cuda.synchronize()
    passes = -(-n // k)
    want_counts = {"c_balance_pass_sh": passes * sh_n}
    if sh_n > 1:
        want_counts["halo_mesh"] = passes + 1
    assert {x: c for x, c in kernels.launches().items() if c} == want_counts
    want = S.make_sharded_tiled_balance_runner(cc, flags, mesh, route="launches")(st, cf, n)
    for name in ("h", "C"):
        assert torch.equal(got[name], want[name]), f"balance k={k} {name}"
    H, W = SH_RES
    vf = torch.as_tensor(np.random.default_rng(9).uniform(-0.5, 0.5, (48, 2, H, W))
                         .astype(np.float32), device=cuda)
    kernels.reset_launches()
    got, acc = S.make_sharded_tiled_approach_runner(cc, vf, mesh, k=k)(st, cf, 8, n)
    torch.cuda.synchronize()
    passes = sum(-(-min(8, 8 + n - c) // k) for c in range(8, 8 + n, 8))
    want_counts = {"c_approach_pass_sh": passes * sh_n}
    if sh_n > 1:
        want_counts["halo_mesh"] = passes + 1
    assert {x: c for x, c in kernels.launches().items() if c} == want_counts
    want, acc_l = S.make_sharded_tiled_approach_runner(cc, vf, mesh, route="launches")(
        st, cf, 8, n)
    for name in ("h", "C"):
        assert torch.equal(got[name], want[name]), f"approach k={k} {name}"
    for key in acc:
        assert torch.equal(acc[key], acc_l[key]), f"approach k={k} {key}"


@pytest.mark.cuda
def test_cuda_pass_wrappers_hold_their_scratch(cuda):
    """A pass called without scratch allocates its own and holds it until
    the launch is queued (else the caching allocator hands its memory to
    the outputs allocated next): at 1024x512 on (2, 1), k = 2, each pass
    without scratch equals the pass with the runner's, bit for bit."""
    fc = T.JRLFluidConfig(res=(128, 64), Re=4.0, vel_obs_real=0.2848,
                          gravity_strength_real=-9.8, shape="ethaline", refine=8)
    s, fl = T.fluid_init(fc, cuda)
    cc, st, cf, flags, _ = _c_pass_case(cuda, "1024x512")
    H, W = cc.eff_res
    mesh = make_mesh((2, 1), [cuda] * 2)
    sh = S.Shard.of(H, W, (2, 1), (1, 0))
    f, rho, vel = (split(s[x], mesh) for x in ("f", "rho", "vel"))
    h, C, fls = (split(x, mesh) for x in (st["h"], st["C"], flags))
    base = split(cf["base_flags"], mesh)
    hx = HA.exchange([[f[i], vel[i], rho[i]] for i in range(2)], mesh, S.XH, rows=4)
    hc = HA.exchange([[h[i], C[i]] for i in range(2)], mesh, S.XH, rows=4)
    hh = HA.exchange([[x] for x in h], mesh, S.XH, rows=4)
    hfl = HA.exchange([[x] for x in fls], mesh, S.XH, rows=4)
    hb = HA.exchange([[x] for x in base], mesh, S.XH, rows=4)
    vf, b0, n_frames = _pass_frames(cuda, cc, 0, 2, seed=3)
    fr = S.shard_frames(vf, sh, 4, b0=b0, n_frames=n_frames)
    part = torch.zeros(4, device=cuda)
    calls = {
        "fluid_pass_sh": (lambda scr: S.fluid_pass_sh(f[1], rho[1], vel[1], hx[1], 8, 2, fc, fl,
                                                      sh, scratch=scr), 12),
        "c_balance_pass_sh": (lambda scr: S.c_balance_pass_sh(h[1], C[1], fls[1], hc[1], hfl[1],
                                                              2, cc, cf, sh, scratch=scr), 10),
        "c_approach_pass_sh": (lambda scr: S.c_approach_pass_sh(h[1], base[1], fr, hh[1], hb[1],
                                                                0, 2, cc, cf, sh, part,
                                                                scratch=scr), 10),
    }
    for name, (call, planes) in calls.items():
        want = call(S.pass_sh_scratch(sh, 2, cuda, planes))
        for _ in range(3):
            got = call(None)
            torch.cuda.synchronize()
            assert all(torch.equal(g_, w_) for g_, w_ in zip(got, want)), name


@pytest.mark.cuda
def test_cuda_c_pass_sh_refuses_bad_inputs(cuda):
    """Pieces of another depth, a scratch too small for the pass, a
    misaligned plane and a plan over the card's co-resident limit raise
    before a launch."""
    _, _, _, cc, st, cf, flags, mesh, shards = _sh_setup(cuda, (4, 1))
    h, C, fl = (split(x, mesh) for x in (st["h"], st["C"], flags))
    hx = HA.exchange([[h[i], C[i]] for i in range(4)], mesh, S.XH, rows=4)
    hfl = HA.exchange([[x] for x in fl], mesh, S.XH, rows=4)
    sh = shards[1]
    n0 = S.c_balance_pass_sh.launches
    with pytest.raises(ValueError, match="do not match"):
        S.c_balance_pass_sh(h[1], C[1], fl[1], hx[1], hfl[1], 1, cc, cf, sh)
    with pytest.raises(ValueError, match="scratch"):
        S.c_balance_pass_sh(h[1], C[1], fl[1], hx[1], hfl[1], 2, cc, cf, sh,
                            scratch=torch.empty((1, 10, 4, sh.W), device=cuda))
    buf = torch.empty(h[1].numel() + 1, device=cuda)
    odd = buf[1:].view_as(h[1]).copy_(h[1])
    with pytest.raises(ValueError, match="16-byte"):
        S.c_balance_pass_sh(odd, C[1], fl[1], hx[1], hfl[1], 2, cc, cf, sh)
    plan = S.pass_sh_plan(sh, 2, jrl_fluid.sm_count(cuda), "balance")
    bad = S.TilePlan(plan.nty, plan.ntx, plan.rmax, plan.smax, 100000)
    with mock.patch.object(S, "pass_sh_plan", return_value=bad):
        with pytest.raises(RuntimeError, match="cudaError 720"):
            S.c_balance_pass_sh(h[1], C[1], fl[1], hx[1], hfl[1], 2, cc, cf, sh)
    assert S.c_balance_pass_sh.launches == n0


# --- the column meshes' C passes (c_balance_pass_sh_cols, c_approach_pass_sh_cols) ---


def _c_col_halos(mesh, h, C, fl, base, k):
    """The C passes' halos on a column mesh at depth k: the 2k-row pieces
    and `pass_xh` lanes of [h, C], [h], the flags and the base flags."""
    L = range(len(h))
    xh = S.pass_xh(k)
    return (HA.exchange([[h[i], C[i]] for i in L], mesh, xh, rows=2 * k),
            HA.exchange([[x] for x in h], mesh, xh, rows=2 * k),
            HA.exchange([[x] for x in fl], mesh, xh, rows=2 * k),
            HA.exchange([[x] for x in base], mesh, xh, rows=2 * k))


class WideTip(T.JRLCConfig):
    """The flat tip with a radius of 63.5 (rint = 64): at 256x128 its disk
    crosses the column boundary x = 64 of the (1, 2) and (2, 2) meshes, so
    the dC_r term of the first shard's last column reads the new C of the
    next shard's first."""

    @property
    def radius_obs(self) -> float:
        return 63.50000000000001


@pytest.mark.cuda
@pytest.mark.parametrize("start", [8, 2**24 - 5])
@pytest.mark.parametrize("mesh_shape", COL_PASS_MESHES)
def test_cuda_c_pass_sh_cols_equals_twin_and_launches(cuda, mesh_shape, start):
    """One launch of each C column instance on every shard at k = 1..4 (the
    flat tip of 256x128): bit for bit k steps of the per-step kernels
    (``route="launches"``: the balance's, and the approach's lerp and
    `c_approach_sh` from ``start``, h, C and the shard's disk sums) and, h
    and C, the twins run on the CPU from the same pieces, blocks and frame
    window (the disk sums within rtol 2e-4 / atol 1e-4: PyTorch sums in
    another order); the balance from step 8's state only (it has no step)."""
    cc, st, cf, flags, _ = _c_pass_case(cuda, "256x128")
    H, W = cc.eff_res
    mesh = make_mesh(mesh_shape, [cuda] * (mesh_shape[0] * mesh_shape[1]))
    shards = [S.Shard.of(H, W, mesh_shape, c) for c in mesh.local]
    h, C, fl, base = (split(x, mesh) for x in (st["h"], st["C"], flags, cf["base_flags"]))
    cf_cpu = {x: y.cpu() for x, y in cf.items()}
    for k in range(1, 5):
        hx, hxa, hfl, hb = _c_col_halos(mesh, h, C, fl, base, k)
        if start == 8:
            per = S.make_sharded_tiled_balance_runner(cc, flags, mesh, route="launches")(st, cf, k)
            for i, sh in enumerate(shards):
                tag = f"balance shard {mesh.local[i]} k={k}"
                n0 = S.c_balance_pass_sh.launches
                got = S.c_balance_pass_sh(h[i], C[i], fl[i], hx[i], hfl[i], k, cc, cf, sh)
                assert S.c_balance_pass_sh.launches == n0 + 1
                want = S.c_balance_pass_sh_ref(h[i].cpu(), C[i].cpu(), fl[i].cpu(),
                                               _cpu_halo(hx[i]), _cpu_halo(hfl[i]), k, cc, cf_cpu,
                                               sh)
                for name, g_, w_ in zip(("h", "C"), got, want):
                    assert torch.equal(g_.cpu(), w_), f"{tag} {name}: twin"
                    assert torch.equal(g_, sh.body(per[name])), f"{tag} {name}: launches"
        vf, b0, n_frames = _pass_frames(cuda, cc, start, k, seed=start + k)
        ph, pC, pparts = _approach_launches(cc, st, cf, mesh, shards, vf, b0, n_frames, start, k)
        for i, sh in enumerate(shards):
            tag = f"approach shard {mesh.local[i]} step {start} k={k}"
            fr = S.shard_frames(vf, sh, 2 * k, b0=b0, n_frames=n_frames)
            part = torch.zeros(4, device=cuda)
            got = S.c_approach_pass_sh(h[i], base[i], fr, hxa[i], hb[i], start, k, cc, cf, sh,
                                       part)
            assert torch.equal(part, pparts[i]), f"{tag}: disk sums"
            for name, g_, p_ in zip(("h", "C"), got, (ph[i], pC[i])):
                assert torch.equal(g_, p_), f"{tag} {name}: launches"
            fr_c = S.ShardFrames(fr.t.cpu(), fr.row0, fr.b0, fr.n_frames, fr.col0)
            wh, wC, wparts = S.c_approach_pass_sh_ref(
                h[i].cpu(), base[i].cpu(), fr_c, _cpu_halo(hxa[i]), _cpu_halo(hb[i]), start, k,
                cc, cf_cpu, sh)
            assert torch.equal(got[0].cpu(), wh) and torch.equal(got[1].cpu(), wC), f"{tag}: twin"
            want = torch.zeros(4)
            for p_ in wparts:
                want = torch.stack([want[0] + p_[0], want[1] + p_[1], p_[2], p_[3]])
            np.testing.assert_allclose(part.cpu().numpy(), want.numpy(), rtol=2e-4, atol=1e-4,
                                       err_msg=f"{tag}: twin's disk sums")


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", COL_PASS_MESHES)
def test_cuda_c_approach_pass_sh_cols_disk_across_a_column_boundary(cuda, mesh_shape):
    """The wide flat tip (`WideTip`: rint 64, its disk across x = 64) from
    step 20 over 13 steps, ``unroll`` 4, at k = 1..4 (passes that end inside
    a chunk): the last sub-step recomputes the new C of the column past the
    shard; h, C and the integrals bit for bit ``route="launches"``, h and C
    bit for bit the unsharded per-step runner."""
    cc = WideTip(res=SH_RES, Re=4.0, Pe=5.0, shape="cylinder")
    assert cc.radius_obs_int >= SH_RES[1] // 2 and cc.radius_obs_int < SH_RES[1] - 1
    st, cf, _ = T.c_init(cc, cuda)
    rng = np.random.default_rng(26)
    st = {k: v + torch.as_tensor((1e-4 * rng.standard_normal(tuple(v.shape))).astype(np.float32),
                                 device=cuda) for k, v in st.items()}
    H, W = SH_RES
    vf = torch.as_tensor(np.random.default_rng(27).uniform(-0.5, 0.5, (48, 2, H, W))
                         .astype(np.float32), device=cuda)
    mesh = make_mesh(mesh_shape, [cuda] * (mesh_shape[0] * mesh_shape[1]))
    want, acc_w = S.make_sharded_tiled_approach_runner(cc, vf, mesh, unroll=4,
                                                       route="launches")(st, cf, 20, 13)
    per_step = T.make_per_step_approach_runner(cc, vf)(st, cf, 20, 13)[0]
    for k in range(1, 5):
        got, acc = S.make_sharded_tiled_approach_runner(cc, vf, mesh, unroll=4, k=k)(
            st, cf, 20, 13)
        for name in ("h", "C"):
            assert torch.equal(got[name], want[name]), f"k={k} {name}: launches"
            assert torch.equal(got[name], per_step[name]), f"k={k} {name}: per-step"
        for key in acc:
            assert torch.equal(acc[key], acc_w[key]), f"k={k} {key}"


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_cuda_c_pass_routes_on_2x2_equal_launches(cuda, k):
    """The (2, 2) balance runner through the pass (its default route) over
    50 steps and the approach runner over 50 steps from step 8 (unroll 8):
    bit for bit ``route="launches"`` (h, C, the integrals) and, h and C, the
    unsharded per-step runners; one pass launch a shard and pass, one
    halo_mesh launch an exchange, one exchange a pass and one for the
    flags."""
    _, _, _, cc, st, cf, flags, mesh, _ = _sh_setup(cuda, (2, 2))
    n = 50
    kernels.reset_launches()
    run = S.make_sharded_tiled_balance_runner(cc, flags, mesh, k=k)
    got = run(st, cf, n)
    torch.cuda.synchronize()
    passes = -(-n // k)
    assert (run.route, run.k) == ("pass", k)
    assert {x: c for x, c in kernels.launches().items() if c} == \
        {"c_balance_pass_sh": passes * 4, "halo_mesh": passes + 1}
    want = S.make_sharded_tiled_balance_runner(cc, flags, mesh, route="launches")(st, cf, n)
    per_step = T.make_per_step_balance_runner(cc, flags)(st, cf, n)
    for name in ("h", "C"):
        assert torch.equal(got[name], want[name]), f"balance k={k} {name}: launches"
        assert torch.equal(got[name], per_step[name]), f"balance k={k} {name}: per-step"
    H, W = SH_RES
    vf = torch.as_tensor(np.random.default_rng(9).uniform(-0.5, 0.5, (48, 2, H, W))
                         .astype(np.float32), device=cuda)
    kernels.reset_launches()
    got, acc = S.make_sharded_tiled_approach_runner(cc, vf, mesh, k=k)(st, cf, 8, n)
    torch.cuda.synchronize()
    passes = sum(-(-min(8, 8 + n - c) // k) for c in range(8, 8 + n, 8))
    assert {x: c for x, c in kernels.launches().items() if c} == \
        {"c_approach_pass_sh": passes * 4, "halo_mesh": passes + 1}
    want, acc_l = S.make_sharded_tiled_approach_runner(cc, vf, mesh, route="launches")(
        st, cf, 8, n)
    per_step = T.make_per_step_approach_runner(cc, vf)(st, cf, 8, n)[0]
    for name in ("h", "C"):
        assert torch.equal(got[name], want[name]), f"approach k={k} {name}: launches"
        assert torch.equal(got[name], per_step[name]), f"approach k={k} {name}: per-step"
    for key in acc:
        assert torch.equal(acc[key], acc_l[key]), f"approach k={k} {key}"


@pytest.mark.cuda
def test_cuda_c_pass_sh_cols_registers_and_shape(cuda):
    """Both C column instances at k = 1..4 spill nothing, and their launch
    shape is the host plan's mirrors' on the (2, 2) shards of 1024x512."""
    sms = jrl_fluid.sm_count(cuda)
    for kind in ("balance", "approach"):
        for k in range(1, 5):
            regs, local = S.pass_sh_info(k, kind=kind, cols=True)
            assert local == 0 and 0 < regs <= 128, (kind, k, regs, local)
            for co in ((0, 0), (1, 1)):
                plan = S.pass_sh_plan(S.Shard.of(1024, 512, (2, 2), co), k, sms, kind)
                got = S.pass_sh_tile_shape(k, plan.rmax, plan.smax, kind=kind, cols=True)
                assert got[:3] == (S.TILE_THREADS, S.TILE_SMEM_CAP,
                                   S.pass_tile_bytes(kind, plan.rmax, plan.smax)), (kind, k)
                assert plan.grid <= got[3], (kind, k, plan.grid, got)


@pytest.mark.cuda
def test_cuda_c_pass_sh_cols_refuses_bad_inputs(cuda):
    """On a (2, 2) shard: blocks of 2 lanes, flag blocks narrower than the
    pass's, no blocks, a misaligned block, a frame window without its
    reach lanes and a scratch of a row shard's width raise before a launch;
    a runner through the pass refuses flags with a FLUID cell in the grid's
    last column, which ``route="launches"`` takes."""
    _, _, _, cc, st, cf, flags, mesh, shards = _sh_setup(cuda, (2, 2))
    h, C, fl, base = (split(x, mesh) for x in (st["h"], st["C"], flags, cf["base_flags"]))
    hx, hxa, hfl, hb = _c_col_halos(mesh, h, C, fl, base, 3)
    sh = shards[1]
    n0 = S.c_balance_pass_sh.launches, S.c_approach_pass_sh.launches
    narrow = HA.exchange([[h[i], C[i]] for i in range(4)], mesh, S.XH, rows=6)[1]
    fl_narrow = HA.exchange([[x] for x in fl], mesh, 4, rows=6)[1]
    for bad_hx, bad_fl in ((narrow, hfl[1]), (hx[1], fl_narrow),
                           (HA.Halo(10, hx[1].top, hx[1].bot, k=6), hfl[1])):
        with pytest.raises(ValueError, match="do not match"):
            S.c_balance_pass_sh(h[1], C[1], fl[1], bad_hx, bad_fl, 3, cc, cf, sh)
    buf = torch.empty(hx[1].left.numel() + 1, device=cuda)
    odd = buf[1:].view_as(hx[1].left).copy_(hx[1].left)
    with pytest.raises(ValueError, match="16-byte"):
        S.c_balance_pass_sh(h[1], C[1], fl[1], HA.Halo(10, hx[1].top, hx[1].bot, odd,
                                                       hx[1].right, k=6), hfl[1], 3, cc, cf, sh)
    row_scr = S.pass_sh_scratch(S.Shard.of(*SH_RES, (2, 1), (0, 0)), 3, cuda, 10)[..., :sh.w]
    with pytest.raises(ValueError, match="scratch"):
        S.c_balance_pass_sh(h[1], C[1], fl[1], hx[1], hfl[1], 3, cc, cf, sh,
                            scratch=row_scr.contiguous())
    vf, b0, n_frames = _pass_frames(cuda, cc, 8, 3, seed=4)
    part = torch.zeros(4, device=cuda)
    fr = S.shard_frames(vf, sh, 6, b0=b0, n_frames=n_frames)
    rows_only = S.ShardFrames(fr.t[..., fr.col0:fr.col0 + sh.w].contiguous(), fr.row0, fr.b0,
                              fr.n_frames)
    with pytest.raises(ValueError, match="columns"):
        S.c_approach_pass_sh(h[1], base[1], rows_only, hxa[1], hb[1], 8, 3, cc, cf, sh, part)
    assert (S.c_balance_pass_sh.launches, S.c_approach_pass_sh.launches) == n0
    assert torch.equal(part, torch.zeros(4, device=cuda))
    edge = flags.clone()
    edge[SH_RES[0] // 2, -1] = int(CellType.FLUID)
    with pytest.raises(ValueError, match="last column"):
        S.make_sharded_tiled_balance_runner(cc, edge, mesh)
    S.make_sharded_tiled_balance_runner(cc, edge, mesh, route="launches")(st, cf, 1)


@pytest.mark.cuda
def test_cuda_sharded_wrappers_refuse_bad_inputs(cuda):
    """Halo pieces that do not fit the shard's mesh, a tensor of the wrong
    dtype or shape, and a lean launch off a row mesh raise before a launch."""
    fc, s, fl, cc, st, cf, flags, mesh, shards = _sh_setup(cuda, (2, 2))
    f, rho, vel = (split(s[x], mesh) for x in ("f", "rho", "vel"))
    ha = HA.exchange([[f[i], vel[i]] for i in range(4)], mesh, S.XH)
    sh = shards[0]
    with pytest.raises(ValueError, match="do not match"):
        S.fluid_a_sh(f[0], rho[0], vel[0], HA.Halo(11, ha[0].top, ha[0].bot), 8, fc, fl, sh)
    with pytest.raises(ValueError, match="halo left"):
        S.fluid_a_sh(f[0], rho[0], vel[0], HA.Halo(11, ha[0].top, ha[0].bot, ha[0].left[:3],
                                                       ha[0].right), 8, fc, fl, sh)
    with pytest.raises(ValueError, match="dtype"):
        S.fluid_a_sh(f[0].double(), rho[0], vel[0], ha[0], 8, fc, fl, sh)
    with pytest.raises(ValueError, match="row mesh"):
        S.fluid_a_sh(f[0], rho[0], vel[0], ha[0], 8, fc, fl, sh, lean=True)
    h = split(st["h"], mesh)
    hh = HA.exchange([[x] for x in h], mesh, S.XH)
    hb = HA.exchange([[x] for x in split(cf["base_flags"], mesh)], mesh, S.XH)
    v = torch.zeros((2, sh.h, sh.w), device=cuda)
    with pytest.raises(ValueError, match="part"):
        S.c_approach_sh(h[0], h[0][0], v, split(cf["base_flags"], mesh)[0], hh[0], hb[0], 3, cc,
                        cf, sh, torch.zeros(3, device=cuda))
    with pytest.raises(ValueError, match="in a group"):
        HA.halo_pack([f[0], vel[0], rho[0]] * 2)


# ---------------------------------------------------------------------------
# The cylinder channel on a mesh of shards (kernels/cyl_sharded.py)
# ---------------------------------------------------------------------------

CYL_SH = dict(res=(256, 128), D=16.0, Re=500.0, cylinder_center=(64.0, 128.0))
CYL_SH_MESHES = [(4, 1), (2, 2)]


def _cyl_sh_setup(dev):
    """The 256x128 split scene 30 plain steps in, with seeded noise (the
    band region at k = 1 is rows 112-144: on both meshes it straddles two
    shards, so the windows run at b0 + nb = h and at b0 = 0)."""
    cfg = CY.CylinderConfig(**CYL_SH)
    s, fl = CY.init(cfg, dev)
    s = CY.make_runner(cfg)(s, fl, 30)
    rng = np.random.default_rng(31)
    s = {k: v + torch.as_tensor((1e-4 * rng.standard_normal(tuple(v.shape))).astype(np.float32),
                                device=dev) for k, v in s.items()}
    return cfg, s, fl


def _close3(got, want, tag, tol=1e-5):
    for name, g_, w_, t in zip(("f", "rho", "vel"), got, want, (tol, tol, 10 * tol)):
        _close(g_, w_, t, f"{tag} {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", CYL_SH_MESHES)
def test_cuda_cyl_sharded_kernels_match_twins(cuda, mesh_shape):
    """One launch of each sharded cylinder kernel on every shard against
    its twin from the same pieces: cyl_block_sh PADDED and PIECES,
    cyl_lean_sh at k = 1, 2, 4, cyl_window_sh at k = 1, 2, 4 on the shards
    that meet the band; halo_pack's k-row and one-lane phases bit for bit."""
    cfg, s, fl = _cyl_sh_setup(cuda)
    c = K.consts(cfg)
    H, W = cfg.res
    mesh = make_mesh(mesh_shape, [cuda] * 4)
    L = range(4)
    f, rho, vel = (split(s[x], mesh) for x in ("f", "rho", "vel"))
    flags, phi = split(fl["flags"], mesh), split(fl["phi_obs"], mesh)
    nx = mesh_shape[1]
    fp, velp, flp = (pad_halo(x, mesh) for x in (f, vel, flags))
    h12 = HA.exchange([CS.full_group(f[i], vel[i], flags[i]) for i in L], mesh, 1)
    for i, co in enumerate(mesh.local):
        sh = CS.CylShard.of(H, W, mesh_shape, co, 1, 1)
        _close3(CS.cyl_block_sh(fp[i], rho[i], velp[i], flp[i], phi[i], None, c, sh),
                CS.cyl_block_sh_ref(fp[i], rho[i], velp[i], flp[i], phi[i], None, c, sh),
                f"cyl_block_sh PADDED {co}")
        _close3(CS.cyl_block_sh(f[i], rho[i], vel[i], flags[i], phi[i], h12[i], c, sh),
                CS.cyl_block_sh_ref(f[i], rho[i], vel[i], flags[i], phi[i], h12[i], c, sh),
                f"cyl_block_sh PIECES {co}")
    n_win = 0
    for k in (1, 2, 4):
        g14 = [CS.lean_group(f[i], rho[i], vel[i], flags[i], phi[i]) for i in L]
        for got, want in zip(HA.halo_pack(g14[1], rows=k), HA.halo_pack_ref(g14[1], rows=k)):
            assert torch.equal(got, want), f"halo_pack rows k={k}"
        hk = HA.exchange(g14, mesh, k, rows=k)
        if nx > 1:
            t, b = hk[1].top, hk[1].bot
            for xh in (1, k):
                for got, want in zip(HA.halo_pack(g14[1], t, b, xh, k),
                                     HA.halo_pack_ref(g14[1], t, b, xh, k)):
                    assert torch.equal(got, want), f"halo_pack cols k={k} xh={xh}"
        (gr0, gr1), = CS._fix_regions(cfg, margin=4.0 + (k - 1))
        for i, co in enumerate(mesh.local):
            sh = CS.CylShard.of(H, W, mesh_shape, co, k, k)
            got = CS.cyl_lean_sh(f[i], hk[i], k, c, sh)
            _close3(got, CS.cyl_lean_sh_ref(f[i], hk[i], k, c, sh), f"cyl_lean_sh k={k} {co}")
            if sh.row0 < gr1 and sh.row0 + sh.h > gr0:
                nb = gr1 - gr0
                b0 = min(max(gr0 - sh.row0, 0), sh.h - nb)
                outs = [[x.clone() for x in got] for _ in range(2)]
                CS.cyl_window_sh(f[i], rho[i], vel[i], flags[i], phi[i], hk[i], k, b0, nb,
                                 outs[0], c, sh)
                CS.cyl_window_sh_ref(f[i], rho[i], vel[i], flags[i], phi[i], hk[i], k, b0, nb,
                                     outs[1], c, sh)
                _close3(outs[0], outs[1], f"cyl_window_sh k={k} {co} b0={b0}")
                n_win += 1
    assert n_win == 6 * mesh_shape[1]
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", CYL_SH_MESHES)
@pytest.mark.parametrize("tile_rows", [8, None])
def test_cuda_cyl_sharded_full_routes_equal_unsharded(cuda, mesh_shape, tile_rows):
    """PIECES (tile_rows=8) and PADDED over 23 steps: bit for bit the
    unsharded ``split=False`` runner (cyl_full on every row); only
    cyl_block_sh and halo_mesh launch."""
    cfg, s, fl = _cyl_sh_setup(cuda)
    mesh = make_mesh(mesh_shape, [cuda] * 4)
    run = CS.make_sharded_fused_cylinder_runner(cfg, mesh, lean_split=False, tile_rows=tile_rows)
    kernels.reset_launches()
    got = run(s, fl, 23)
    torch.cuda.synchronize()
    used = {k for k, v in kernels.launches().items() if v}
    assert used == ({"cyl_block_sh", "halo_mesh"} if tile_rows else {"cyl_block_sh"})
    want = K.make_fused_cylinder_runner(cfg, split=False)(s, fl, 23)
    for name in ("f", "rho", "vel"):
        assert torch.equal(got[name], want[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["pass", "launches"])
@pytest.mark.parametrize("mesh_shape,kw", [((1, 1), {}), ((4, 1), {}), ((2, 2), {}),
                                           ((4, 1), dict(lean_k=4)),
                                           ((2, 2), dict(lean_k=4, lean_x_ext=8, lean_x_halo=8))])
def test_cuda_cyl_sharded_lean_routes(cuda, mesh_shape, kw, route):
    """The lean split over 23 steps (k = 4: five passes and three single
    steps), through the pass or the two launches: the unsharded default
    runner on non-OBSTACLE cells (f, rho 2e-5; vel 2e-4), and the same
    runner on the twins at the same tolerances; only the route's kernels
    and halo_mesh launch."""
    cfg, s, fl = _cyl_sh_setup(cuda)
    mesh = make_mesh(mesh_shape, [cuda] * (mesh_shape[0] * mesh_shape[1]))
    run = CS.make_sharded_fused_cylinder_runner(cfg, mesh, route=route, **kw)
    assert run.stepk.route == "lean" and run.stepk.lean_route == route
    kernels.reset_launches()
    got = run(s, fl, 23)
    torch.cuda.synchronize()
    used = {k for k, v in kernels.launches().items() if v}
    path = {"cyl_pass_sh"} if route == "pass" else {"cyl_lean_sh", "cyl_window_sh"}
    assert path <= used <= path | {"halo_mesh"}
    want = K.make_fused_cylinder_runner(cfg)(s, fl, 23)
    fluid = fl["flags"] != int(CY.CellType.OBSTACLE)
    for name, tol in (("f", 2e-5), ("rho", 2e-5), ("vel", 2e-4)):
        m = fluid.expand_as(got[name])
        _close(got[name][m], want[name][m], tol, f"vs unsharded {name}")
    with mock.patch.multiple(CS, cyl_lean_sh=CS.cyl_lean_sh_ref,
                             cyl_window_sh=CS.cyl_window_sh_ref, cyl_pass_sh=CS.cyl_pass_sh_ref):
        twin = run(s, fl, 23)
    for name, tol in (("f", 2e-5), ("rho", 2e-5), ("vel", 2e-4)):
        _close(got[name], twin[name], tol, f"vs twin runner {name}")


# the sharded lean split in one launch a pass (cyl_pass_sh) against its twin
# and the two launches it replaces, bit for bit

@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("mesh_shape", [(1, 1), (4, 1), (2, 2)])
def test_cuda_cyl_pass_sh_equals_twin_and_launches(cuda, mesh_shape, k):
    """One pass of every shard (the 256x128 scene: the band across two
    shards' edge), through cyl_pass_sh (k = 1 one thread a cell, k = 2..4
    row-streamed) against cyl_pass_sh_ref and against cyl_lean_sh +
    cyl_window_sh on each band window, bit for bit in f, rho and vel; one
    launch a call."""
    cfg, s, fl = _cyl_sh_setup(cuda)
    c = K.consts(cfg)
    H, W = cfg.res
    n = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, [cuda] * n)
    f, rho, vel = (split(s[x], mesh) for x in ("f", "rho", "vel"))
    flags, phi = split(fl["flags"], mesh), split(fl["phi_obs"], mesh)
    L = range(n)
    xh = k if mesh_shape[1] > 1 else 0
    halos = HA.exchange([CS.lean_group(f[i], rho[i], vel[i], flags[i], phi[i]) for i in L],
                        mesh, xh, rows=k)
    regions = CS._fix_regions(cfg, margin=4.0 + (k - 1))
    n_band = 0
    for i, co in enumerate(mesh.local):
        sh = CS.CylShard.of(H, W, mesh_shape, co, k, k)
        st = (f[i], rho[i], vel[i], flags[i], phi[i])
        windows = CS.band_windows(sh, regions)
        rows = CS.pass_sh_rows(sh, windows)
        n_band += bool(windows)
        want = list(CS.cyl_lean_sh(f[i], halos[i], k, c, sh))
        for b0, nb in windows:
            CS.cyl_window_sh(*st, halos[i], k, b0, nb, want, c, sh)
        twin = CS.cyl_pass_sh_ref(*st, halos[i], k, rows, c, sh)
        n0 = CS.cyl_pass_sh.launches
        got = CS.cyl_pass_sh(*st, halos[i], k, rows, c, sh)
        torch.cuda.synchronize()
        assert CS.cyl_pass_sh.launches == n0 + 1
        for name, g_, w_, t_ in zip(("f", "rho", "vel"), got, want, twin):
            assert torch.equal(g_, w_), f"{co} k={k} {name} vs the two launches"
            assert torch.equal(g_, t_), f"{co} k={k} {name} vs the twin"
    assert n_band >= 1


CYL_SH_LEAN_ROUTES = [r for r in smoke.CYL_SH_ROUTES if r[0].startswith("lean")] + [
    ("lean k=2 (4, 1)", (4, 1), dict(lean_k=2)), ("lean k=3 (4, 1)", (4, 1), dict(lean_k=3))]


@pytest.mark.cuda
@pytest.mark.parametrize("label,shape,kw", CYL_SH_LEAN_ROUTES)
def test_cuda_cyl_sharded_pass_route_equals_launches_over_200_steps(cuda, label, shape, kw):
    """Every lean route of chip_smoke.py at 2048² (and k = 2, 3 on (4, 1)):
    the runner through the pass equals the runner through the two launches
    bit for bit in f, rho and vel after 201 steps from a perturbed state
    (k-step passes and single steps)."""
    cfg = CY.CylinderConfig(**smoke.CYL_MAIN)
    s, fl = CY.init(cfg, cuda)
    g = torch.Generator(device=cuda).manual_seed(17)
    s = {k: v + 1e-5 * torch.randn(v.shape, generator=g, device=cuda) for k, v in s.items()}
    mesh = make_mesh(shape, [cuda] * (shape[0] * shape[1]))
    want = CS.make_sharded_fused_cylinder_runner(cfg, mesh, route="launches", **kw)(s, fl, 201)
    run = CS.make_sharded_fused_cylinder_runner(cfg, mesh, **kw)
    assert run.stepk.lean_route == "pass"
    kernels.reset_launches()
    got = run(s, fl, 201)
    torch.cuda.synchronize()
    assert CS.cyl_pass_sh.launches >= 201 // run.stepk.k
    assert kernels.launches()["cyl_lean_sh"] == kernels.launches()["cyl_window_sh"] == 0
    for name in ("f", "rho", "vel"):
        assert torch.equal(got[name], want[name]), f"{label} {name}"


@pytest.mark.cuda
@pytest.mark.parametrize("bf16_dev", [False, True, "sr"])
def test_cuda_unsharded_cylinder_kernels_equal_twins_bit_for_bit(cuda, bf16_dev):
    """The four unsharded cylinder kernels (their tile loader now shared
    with the sharded kernels, cyl_common.cuh::tile_run) equal their twins
    bit for bit after one launch, k = 2 and 4 for the k-step pair, in each
    storage mode."""
    cfg, s, fl = _cyl_sh_setup(cuda)
    c = K.consts(cfg)
    run = K.make_fused_cylinder_runner(cfg, tile_rows=16, interior_rows=32)
    st = dict(s, f=K.f_to_storage(s["f"], bf16_dev))
    key = (5, 7) if bf16_dev == "sr" else None
    m = (bf16_dev, key)
    interior, band, edge = run.step4.rows
    calls = [("cyl_full", lambda o, fn: fn(st["f"], st["rho"], st["vel"], fl["flags"],
                                           fl["phi_obs"], o, run.step.rows[1], c, *m)),
             ("cyl_interior", lambda o, fn: fn(st["f"], o, run.step.rows[0], c, True, *m))]
    for k in (2, 4):
        calls.append(("cyl_interior_k", lambda o, fn, k=k: fn(st["f"], o, interior, k, c, True,
                                                              *m)))
        for e, segs in ((False, band), (True, edge)):
            calls.append(("cyl_band_k", lambda o, fn, k=k, e=e, segs=segs: fn(
                st["f"], st["vel"], fl["flags"], fl["phi_obs"], o, segs, k, e, c, *m)))
    twins = {"cyl_full": K.cyl_full_ref, "cyl_interior": K.cyl_interior_ref,
             "cyl_interior_k": K.cyl_interior_k_ref, "cyl_band_k": K.cyl_band_k_ref}
    for name, call in calls:
        got, want = ({x: torch.full_like(v, 7.0) for x, v in st.items()} for _ in range(2))
        call(got, getattr(K, name))
        call(want, twins[name])
        for x in ("f", "rho", "vel"):
            g, w = got[x], want[x]
            if g.dtype == torch.bfloat16:
                g, w = g.view(torch.int16), w.view(torch.int16)
            assert torch.equal(g, w), f"{name} {x}"
