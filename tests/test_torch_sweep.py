"""The PyTorch port's Pe sweep (`jrl_lbm_torch/parallel/sweep.py`), the
plain twin of its lanes kernel and the batch drivers, on the CPU: against
the JAX package's sweep and parametrized step, against the port's serial
approach (`jrl_main.run_approach`), and against the JAX demo drivers.

Tolerances: the sweep against JAX's at JAX's own sweep-vs-serial bound,
rtol = atol = 2e-4 (`tests/test_sweep.py:75`: float32 sums in another
order over the run); the parametrized step at the trajectory tolerances
of `tests/test_torch_jrl.py` (C, h 2e-5; integrals rtol 2e-4 / atol
1e-4). The port's lanes and its serial path are held equal exactly: the
twin runs the serial runner's steps and sums in the serial order.
"""

import dataclasses
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from jrl_lbm_tpu.models import jrl as J
from jrl_lbm_tpu.parallel import sweep as JS
from jrl_lbm_torch import batch_fluid, batch_pe, batch_validation, jrl_main
from jrl_lbm_torch.kernels import fused_jrl as F
from jrl_lbm_torch.models import jrl as T
from jrl_lbm_torch.parallel import sweep as TS

ROOT = Path(__file__).resolve().parents[1]
PES = [2.0, 5.0, 9.0]
RE = 4.0
VEL = RE * 0.89e-6 / 1.25e-5


def _c_kw(**kw):
    return dict(dict(res=(48, 32), balance_time=0.5, Re=RE, Pe=1.0, vel_obs_real=VEL,
                     gravity_strength_real=0.0, shape="cylinder", is_negative=True), **kw)


@pytest.fixture(scope="module")
def case():
    """`tests/test_sweep.py::_setup`'s case (48x32, cylinder tip, JAX's fluid
    phase and 100 balance steps), handed to both packages as numpy."""
    fcfg = J.JRLFluidConfig(res=(48, 32), Re=RE, vel_obs_real=VEL, gravity_strength_real=0.0,
                            shape="cylinder")
    snapshots, _ = J.run_fluid_phase(fcfg)
    jc = J.JRLCConfig(**_c_kw())
    state, fields, flags = J.c_init(jc)
    state = J.make_balance_runner(jc, flags)(state, fields, 100)
    jfields = dict(fields, vel_field=jnp.asarray(snapshots))
    tc = T.JRLCConfig(**_c_kw())
    tstate = T.state_from_numpy(jax.tree.map(np.asarray, state), "cpu")
    _, tfields, _ = T.c_init(tc, "cpu")
    tfields = dict(tfields, vel_field=torch.as_tensor(np.asarray(snapshots)))
    return {"jc": jc, "jstate": state, "jfields": jfields, "tc": tc, "tstate": tstate,
            "tfields": tfields}


def _lanes(state, L=len(PES)):
    return {k: torch.stack([v] * L) for k, v in state.items()}


@pytest.fixture(scope="module")
def port_sweep(case):
    return TS.pe_sweep_approach(case["tc"], PES, _lanes(case["tstate"]), case["tfields"],
                                chunk=64)


def test_sweep_matches_jax_sweep(case, port_sweep):
    """Equal record counts, records within JAX's sweep-vs-serial bound. At
    this size JAX's float32 dump test and the double `c_dump_steps` agree
    (26 rows a lane)."""
    states = {k: jnp.stack([case["jstate"][k]] * len(PES)) for k in ("C", "h")}
    ref = JS.pe_sweep_approach(case["jc"], PES, states, case["jfields"], chunk=64)
    np.testing.assert_array_equal(port_sweep.n_dumps, ref.n_dumps)
    assert list(port_sweep.n_dumps) == [26, 26, 26]
    assert port_sweep.records.shape == ref.records.shape
    np.testing.assert_allclose(port_sweep.records, ref.records, rtol=2e-4, atol=2e-4)


def test_sweep_rows_equal_serial_run_approach(case, port_sweep):
    """Each lane's dump steps are `c_dump_steps`' and its rows equal the
    serial `jrl_main.run_approach` rows after rounding to float32."""
    for k, Pe in enumerate(PES):
        cfg = dataclasses.replace(case["tc"], Pe=Pe)
        _, rows = jrl_main.run_approach(cfg, case["tstate"], case["tfields"],
                                        case["tfields"]["vel_field"])
        nd = int(port_sweep.n_dumps[k])
        assert nd == len(T.c_dump_steps(cfg)) == len(rows)
        np.testing.assert_array_equal(port_sweep.records[k, :nd], np.asarray(rows, np.float32))
        assert not port_sweep.records[k, nd:].any()


@pytest.mark.parametrize("kw", [dict(lane_devices=["cpu", "cpu"]), dict(route="serial"),
                                dict(lane_devices=[torch.device("cpu")] * 3)])
def test_sweep_lane_groups_and_serial_route_equal_one_launch(case, port_sweep, kw):
    """The lanes split over two or three devices in contiguous groups (no
    padding), and the serial yardstick route, give the same records."""
    got = TS.pe_sweep_approach(case["tc"], PES, _lanes(case["tstate"]), case["tfields"], **kw)
    np.testing.assert_array_equal(got.n_dumps, port_sweep.n_dumps)
    np.testing.assert_array_equal(got.records, port_sweep.records)


def test_max_steps_caps_each_lane(case, port_sweep):
    """``max_steps`` keeps each lane's rows before the cap, unchanged."""
    cap = 300
    got = TS.pe_sweep_approach(case["tc"], PES, _lanes(case["tstate"]), case["tfields"],
                               max_steps=cap)
    for k, Pe in enumerate(PES):
        n = sum(1 for s in T.c_dump_steps(dataclasses.replace(case["tc"], Pe=Pe)) if s < cap)
        assert int(got.n_dumps[k]) == n
        np.testing.assert_array_equal(got.records[k, :n], port_sweep.records[k, :n])
    assert got.records.shape == port_sweep.records.shape


# water, 128x64, Re 1e-2: record rows by the double `c_dump_steps` and by
# JAX's float32 test (`jrl_lbm_tpu/parallel/sweep.py:119-120`)
WATER_ROWS = [(1e-3, 89, 54), (3e-3, 87, 86), (7e-3, 86, 86), (1e-2, 88, 78), (3e-2, 84, 86),
              (7e-2, 86, 82), (1e-1, 85, 86)]


@pytest.mark.parametrize("Pe,serial,f32", WATER_ROWS)
def test_water_128x64_dump_schedule(Pe, serial, f32):
    """The sweep dumps on the serial path's schedule (the JAX package's
    `c_dump_steps`, in doubles), which the committed records follow
    (`validation/sweep_out/_45degree_g9/records/record_res64_Re0.01_Pe*.txt`);
    JAX's float32 test inside its vmapped step gives another."""
    vel = 1e-2 * 0.89e-6 / 12.5e-6
    tc = T.JRLCConfig(res=(128, 64), Re=1e-2, Pe=Pe, vel_obs_real=vel, shape="45degree")
    jc = J.JRLCConfig(res=(128, 64), Re=1e-2, Pe=Pe, vel_obs_real=vel, shape="45degree")
    steps = T.c_dump_steps(tc)
    assert steps == J.c_dump_steps(jc)
    assert len(steps) == serial
    rec = ROOT / "validation/sweep_out/_45degree_g9/records" / \
        f"record_res64_Re0.01_Pe{int(Pe * 10000)}.txt"
    assert len(rec.read_text().splitlines()) - 1 == serial
    v = np.float32(jc.vel_obs_conv)
    walks = np.float32(jc.inflow_height) + np.arange(jc.total_steps).astype(np.float32) * v
    assert int(np.sum(np.floor(walks) == np.floor(walks + v) - np.float32(1.0))) == f32


def test_lane_segments_end_where_serial_launches_end(case, monkeypatch):
    """With a launch cap below the record intervals, the lanes twin still
    equals the serial runner (which splits each interval into launches and
    adds them into one acc), lanes of unequal length, plus a tail past the
    last record."""
    monkeypatch.setitem(F.MAX_LAUNCH_CELL_STEPS, "fused_approach", 48 * 32 * 7)
    cfgs = [dataclasses.replace(case["tc"], Pe=p) for p in (2.0, 9.0)]
    ns = [200, 150]
    dumps = [[s for s in T.c_dump_steps(c) if s < n - 5] for c, n in zip(cfgs, ns)]
    segs = [F.lane_segments(c, d, n) for c, d, n in zip(cfgs, dumps, ns)]
    assert any(r == -1 for t in segs for _, r in t)  # some interval spans launches
    st = _lanes(case["tstate"], 2)
    h, C, rows = F.fused_approach_lanes(st["h"], st["C"], case["tfields"]["vel_field"], 0, ns,
                                        segs, 40, cfgs, case["tfields"])
    for lane, (cfg, d, n) in enumerate(zip(cfgs, dumps, ns)):
        run = T.pick_approach_runner(cfg, case["tfields"]["vel_field"])
        s, cur = case["tstate"], 0
        for k, step in enumerate(d):
            s, acc = run(s, case["tfields"], cur, step + 1 - cur)
            cur = step + 1
            want = torch.stack([acc[x] for x in ("inflow_sum", "current_sum", "rec_u", "rec_v")])
            assert torch.equal(rows[lane, k], want), (lane, k)
        s, _ = run(s, case["tfields"], cur, n - cur)
        assert torch.equal(h[lane], s["h"]) and torch.equal(C[lane], s["C"])
        assert not rows[lane, len(d):].any()


def test_write_sweep_records(case, port_sweep, tmp_path):
    paths = TS.write_sweep_records(port_sweep, case["tc"], str(tmp_path), Re=RE)
    assert [os.path.basename(p) for p in paths] == [
        f"record_res32_Re4.0_Pe{int(p * 10000)}.txt" for p in PES]
    for k, p in enumerate(paths):
        lines = open(p).read().splitlines()
        assert lines[0] == "Step Inflow Current u, v"
        assert len(lines) == int(port_sweep.n_dumps[k]) + 1
        rows = np.loadtxt(lines[1:], dtype=np.float64).astype(np.float32)
        np.testing.assert_array_equal(rows, port_sweep.records[k, :len(lines) - 1])


def test_parametrized_step_matches_jax(case):
    """``vel_obs_conv`` and ``tau_D`` in the fields override the config's,
    as in the JAX package's parametrized step: a config of Pe 1 stepped with
    Pe 5's scalars, 40 steps (the tip crosses a row)."""
    lane_j = dataclasses.replace(case["jc"], Pe=5.0)
    jf = dict(case["jfields"], vel_obs_conv=jnp.float32(lane_j.vel_obs_conv),
              tau_D=jnp.float32(lane_j.tau_D))
    tf = dict(case["tfields"], vel_obs_conv=torch.tensor(lane_j.vel_obs_conv, dtype=torch.float32),
              tau_D=torch.tensor(lane_j.tau_D, dtype=torch.float32))
    jstep = jax.jit(J.make_approach_step(case["jc"], parametrized=True))
    tstep = T.make_approach_step(case["tc"], parametrized=True)
    plain = T.make_approach_step(dataclasses.replace(case["tc"], Pe=5.0))
    js, ts, ps = case["jstate"], case["tstate"], case["tstate"]
    for i in range(40):
        js, jints = jstep(js, jf, jnp.asarray(i, jnp.int32))
        ts, tints = tstep(ts, tf, i)
        ps, _ = plain(ps, case["tfields"], i)
        np.testing.assert_allclose([float(x) for x in tints], [float(x) for x in jints],
                                   rtol=2e-4, atol=1e-4, err_msg=f"step {i} integrals")
    for key in ("C", "h"):
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(ts[key].numpy(), ps[key].numpy(), rtol=2e-5, atol=2e-5)
    v = case["tc"].vel_obs_conv
    assert T.tip_walks(case["tc"].inflow_height, 40, float(tf["vel_obs_conv"]))[1] > \
        T.tip_walks(case["tc"].inflow_height, 40, v)[1]


def test_batch_pe_row_writes_records_resumes_and_matches_run_re_row(tmp_path, monkeypatch):
    """`batch_pe.run_re_vmapped` at 48x32: the fluid phase, one serial lane
    (which writes the shared balance h5), the other two as lanes; three
    reference-format record files, and a rerun is a no-op. `run_re_row`
    (in memory, nothing written) gives the same rows."""
    monkeypatch.setenv("JRL_DEMO_OUT", str(tmp_path))
    kw = dict(progress=False, balance_time=5e-4, Rg=4, g_real=0.0, device="cpu")
    assert batch_pe.run_re_vmapped("water", "cylinder", (48, 32), RE, PES, True, VEL, **kw) == 3
    files = [batch_pe.record_file("water", "cylinder", (48, 32), RE, Pe, True, g_real=0.0)
             for Pe in PES]
    assert (tmp_path / "_cylinder_g0" / "C_balance.h5").is_file()
    assert (tmp_path / "_g0" / f"Re_{RE}.h5").is_file()
    rows = []
    for rec in files:
        lines = open(rec).read().splitlines()
        assert lines[0] == "Step Inflow Current u, v"
        r = np.loadtxt(lines[1:])
        assert r.shape[1] == 5 and r.shape[0] >= 20 and np.isfinite(r).all()
        assert abs(r[-1, 2]) > 0 or abs(r[-1, 1]) > 0
        rows.append(r.astype(np.float32))
    assert batch_pe.run_re_vmapped("water", "cylinder", (48, 32), RE, PES, True, VEL, **kw) == 0

    res, info = batch_pe.run_re_row("water", "cylinder", (48, 32), RE, PES, True, VEL,
                                    balance_time=5e-4, Rg=4, g_real=0.0, device="cpu")
    assert info["route"] == "lanes" and info["balance_steps"] == info["c_cfg"].balance_steps
    for k, r in enumerate(rows):
        assert int(res.n_dumps[k]) == len(r)
        np.testing.assert_array_equal(res.records[k, :len(r)], r)


def _jax_demo(name, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "demo"))
    import importlib

    return importlib.import_module(name)


def _calls(mod, monkeypatch, fn, *args, **kw):
    """The fluid_main / c_main calls ``fn`` makes, with the phases patched
    out of module ``mod``."""
    calls = []
    for phase in ("fluid_main", "c_main"):
        monkeypatch.setattr(mod, phase, lambda _p=phase, **a: calls.append((_p, a)))
    fn(*args, **kw)
    return [(p, {k: v for k, v in a.items() if k not in ("device", "progress")})
            for p, a in calls]


@pytest.mark.parametrize("driver,args", [
    ("batch_fluid", dict(fluid="water", refine=1, is_negative=True)),
    ("batch_fluid", dict(fluid="water80", refine=2, is_negative=True)),
    ("batch_fluid", dict(fluid="water", refine=1, is_negative=False)),
    ("batch_validation", dict(fluid="water", is_negative=True, Re=3e-4)),
    ("batch_Pe", dict(fluid="ethaline", is_negative=True)),
    ("batch_Pe", dict(fluid="water", is_negative=False)),
])
def test_batch_drivers_run_the_jax_demos_cases(driver, args, monkeypatch, tmp_path):
    """Each driver runs the JAX demo's cases: the same fluid_main and
    c_main calls with the same arguments, in the same order."""
    monkeypatch.setenv("JRL_DEMO_OUT", str(tmp_path))
    demo = _jax_demo(driver, monkeypatch)
    port = {"batch_fluid": batch_fluid, "batch_validation": batch_validation,
            "batch_Pe": batch_pe}[driver]
    want = _calls(demo, monkeypatch, demo.main, **args)
    got = _calls(port, monkeypatch, port.main, **args, device="cpu")
    assert len(got) == len(want) > 0
    assert got == want
