"""The PyTorch port's JRL scenes against the JAX package's jnp path, on the
CPU: fluid, balance and approach trajectories, the step schedules, JAX
states carried into the port, and one whole case against the JAX demo
driver.

Trajectory tolerances are those of `tests/test_fused_jrl_tiled.py`: f,
rho, C and h at 2e-5, vel at 2e-4, integrals rtol 2e-4 / atol 1e-4
(float32 sums in another order, compounded over the steps).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from jrl_lbm_tpu.models import jrl as J
from jrl_lbm_torch import jrl_main
from jrl_lbm_torch.models import jrl as T

ROOT = Path(__file__).resolve().parents[1]
TOL = {"f": 2e-5, "rho": 2e-5, "vel": 2e-4, "C": 2e-5, "h": 2e-5}
ACC_KEYS = ("inflow_sum", "current_sum", "count", "rec_u", "rec_v")


def _fluid_kw(shape, res=(48, 32)):
    return dict(res=res, Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8, shape=shape)


def _assert_state(port, ref, tag=""):
    for key, val in ref.items():
        np.testing.assert_allclose(
            port[key].cpu().numpy(), np.asarray(val), rtol=TOL[key], atol=TOL[key],
            err_msg=f"{tag}:{key}",
        )


def _assert_acc(port, ref, tag=""):
    for key in ACC_KEYS:
        np.testing.assert_allclose(float(port[key]), float(ref[key]), rtol=2e-4, atol=1e-4,
                                   err_msg=f"{tag}:{key}")


def _jax_fluid(cfg, state, fields, start, n):
    step = jax.jit(J.make_fluid_step(cfg))
    for i in range(start, start + n):
        state = step(state, fields, jnp.asarray(i, jnp.int32))
    return state


@pytest.mark.parametrize("shape,res,n", [
    ("45degree", (48, 32), 24),
    ("cylinder", (48, 32), 24),
    ("45degree", (128, 64), 12),
])
def test_fluid_trajectory(shape, res, n):
    """The tip advances at least one row (vel_obs ~ 0.1 row per step)."""
    jc, tc = J.JRLFluidConfig(**_fluid_kw(shape, res)), T.JRLFluidConfig(**_fluid_kw(shape, res))
    js, jf = J.fluid_init(jc)
    ts, tf = T.fluid_init(tc, "cpu")
    _assert_state(ts, js, "init")
    ref = _jax_fluid(jc, js, jf, 0, n)
    out = T.make_fluid_runner(tc)(ts, tf, 0, n)
    _assert_state(out, ref, shape)
    assert T.tip_walks(tc.inflow_height, n, tc.vel_obs)[1] > tc.inflow_height_int


def test_jax_state_carried_into_port():
    """JAX for n steps, the port for m more == JAX for n + m steps."""
    kw = _fluid_kw("45degree")
    jc, tc = J.JRLFluidConfig(**kw), T.JRLFluidConfig(**kw)
    js, jf = J.fluid_init(jc)
    mid = _jax_fluid(jc, js, jf, 0, 8)
    ref = _jax_fluid(jc, mid, jf, 8, 8)
    _, tf = T.fluid_init(tc, "cpu")
    port = T.state_from_numpy(jax.tree.map(np.asarray, mid), "cpu")
    out = T.pick_fluid_runner(tc)(port, tf, 8, 8)
    _assert_state(out, ref)
    back = T.state_to_numpy(out)
    assert set(back) == {"f", "rho", "vel"} and back["f"].dtype == np.float32


def _vel_field(seed, H=48, W=32):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 0.5, size=(4, 2, H, W)).astype(np.float32)


@pytest.mark.parametrize("shape,res", [
    ("45degree", (48, 32)),
    ("cylinder", (48, 32)),
    ("ethaline", (16, 8)),
])
def test_balance_and_approach(shape, res):
    refine = 3 if shape == "ethaline" else 1
    kw = dict(res=res, Re=4.0, Pe=5.0, shape=shape, refine=refine)
    jc, tc = J.JRLCConfig(**kw), T.JRLCConfig(**kw)
    js, jf, jflags = J.c_init(jc)
    ts, tf, tflags = T.c_init(tc, "cpu")
    np.testing.assert_array_equal(tflags.numpy(), np.asarray(jflags))
    _assert_state(ts, js, "init")

    js = J.make_balance_runner(jc, jflags)(js, jf, 20)
    ts_plain = T.make_balance_runner(tc, tflags)(ts, tf, 20)
    ts_pick = T.pick_balance_runner(tc, tflags)(ts, tf, 20)
    _assert_state(ts_plain, js, "balance")
    _assert_state(ts_pick, js, "balance/pick")

    H, W = jc.eff_res
    vf = _vel_field(11, H, W)
    jf = dict(jf, vel_field=jnp.asarray(vf))
    tf = dict(tf, vel_field=torch.as_tensor(vf))
    ref_state, ref_acc = J.make_approach_runner(jc)(js, jf, jnp.asarray(0, jnp.int32), 12)
    for name, run in (("plain", T.make_approach_runner(tc)),
                      ("pick", T.pick_approach_runner(tc, tf["vel_field"]))):
        st, acc = run(ts_pick, tf, 0, 12)
        _assert_state(st, ref_state, f"approach/{name}")
        _assert_acc(acc, ref_acc, f"approach/{name}")


def test_flat_disk_row_on_multiple_of_8():
    """Flux-form integrals while the disk row sits on row 24 (a multiple
    of 8: walks_int = 21 + floor(s / 10) at Pe = 5 puts it there for
    steps 30..39), starting from a JAX state at step 25."""
    kw = dict(res=(48, 32), Re=4.0, Pe=5.0, shape="cylinder")
    jc, tc = J.JRLCConfig(**kw), T.JRLCConfig(**kw)
    assert abs(jc.vel_obs_conv - 0.1) < 1e-12
    js, jf, _ = J.c_init(jc)
    _, tf, _ = T.c_init(tc, "cpu")
    vf = _vel_field(7)
    jf = dict(jf, vel_field=jnp.asarray(vf))
    run = J.make_approach_runner(jc)
    s25, _ = run(js, jf, jnp.asarray(0, jnp.int32), 25)
    ref_state, ref_acc = run(s25, jf, jnp.asarray(25, jnp.int32), 10)
    port = T.state_from_numpy(jax.tree.map(np.asarray, s25), "cpu")
    st, acc = T.pick_approach_runner(tc, torch.as_tensor(vf))(port, tf, 25, 10)
    _assert_state(st, ref_state)
    _assert_acc(acc, ref_acc)


@pytest.mark.parametrize("shape,refine", [("cylinder", 1), ("45degree", 1), ("ethaline", 8),
                                          ("infiniteplane", 1)])
def test_step_schedules_equal(shape, refine):
    fkw = dict(res=(128, 64), Re=4.0, vel_obs_real=0.2848, shape=shape, refine=refine)
    assert T.fluid_record_steps(T.JRLFluidConfig(**fkw)) == J.fluid_record_steps(
        J.JRLFluidConfig(**fkw))
    ckw = dict(res=(128, 64), Re=4.0, Pe=5.0, shape=shape, refine=refine)
    tc, jc = T.JRLCConfig(**ckw), J.JRLCConfig(**ckw)
    assert T.c_dump_steps(tc) == J.c_dump_steps(jc)
    for prop in ("tau_D", "vel_obs_conv", "total_steps", "balance_steps", "Rg_radius",
                 "radius_obs_int", "inflow_height_int", "eff_res", "clamp_C"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    np.testing.assert_array_equal(tc.area_array, jc.area_array)


# --- one whole case: the port's driver against the JAX demo driver ---

CASE = dict(shape="45degree", res=(48, 32), Re=4.0, vel_obs_real=0.2848,
            gravity_strength_real=0.0, Rg=4.0)
C_CASE = dict(balance_time=0.5, Pe=5.0, c_vel_obs_real=21e-6)


def _read_rows(path):
    lines = Path(path).read_text().splitlines()
    return lines[0], [[float(v) for v in ln.split()] for ln in lines[1:]]


@pytest.fixture(scope="module")
def jax_case(tmp_path_factory):
    """The JAX demo driver's fluid and C phases, run into a temp dir."""
    out = tmp_path_factory.mktemp("jax_case")
    mp = pytest.MonkeyPatch()
    mp.setenv("JRL_DEMO_OUT", str(out))
    mp.syspath_prepend(str(ROOT / "demo"))
    try:
        import _jrl_main

        _jrl_main.fluid_main(progress=False, **CASE)
        rec = _jrl_main.c_main(
            shape=CASE["shape"], res=CASE["res"], balance_time=C_CASE["balance_time"],
            Re=CASE["Re"], Pe=C_CASE["Pe"], vel_obs_real=C_CASE["c_vel_obs_real"],
            gravity_strength_real=CASE["gravity_strength_real"], Rg=CASE["Rg"],
            progress=False,
        )
    finally:
        mp.undo()
        sys.modules.pop("_jrl_main", None)
    return out, rec


def test_run_case_matches_jax_demo(jax_case):
    out, rec = jax_case
    fcfg = T.JRLFluidConfig(res=CASE["res"], Re=CASE["Re"], vel_obs_real=CASE["vel_obs_real"],
                            gravity_strength_real=CASE["gravity_strength_real"],
                            shape=CASE["shape"])
    ccfg = T.JRLCConfig(res=CASE["res"], balance_time=C_CASE["balance_time"], Re=CASE["Re"],
                        Pe=C_CASE["Pe"], vel_obs_real=C_CASE["c_vel_obs_real"],
                        gravity_strength_real=CASE["gravity_strength_real"],
                        shape=CASE["shape"])
    res = jrl_main.run_case(fcfg, ccfg, device="cpu")
    header, want = _read_rows(rec)
    assert header == "Step Inflow Current u, v"
    assert len(res.record_rows) == len(want) > 0
    got = np.asarray(res.record_rows)
    want = np.asarray(want)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=2e-4, atol=1e-4)
    assert np.isfinite(got).all() and (got[:, 1:3] > 0).all()
    bal = next(out.glob("*/demo_data_*/balance.txt"))
    _, want_bal = _read_rows(bal)
    np.testing.assert_allclose(np.asarray(res.balance_rows), np.asarray(want_bal),
                               rtol=2e-4, atol=1e-4)


def test_cli_writes_demo_artifacts(jax_case, tmp_path, monkeypatch):
    """`python -m jrl_lbm_torch.jrl_main` writes the demo's files with the
    same layout and text formats."""
    out, rec = jax_case
    monkeypatch.setenv("JRL_DEMO_OUT", str(tmp_path))
    common = ["--shape", CASE["shape"], "--res", "48", "32", "--Re", "4.0",
              "--gravity_strength_real", "0", "--device", "cpu", "--no-progress"]
    jrl_main.main(["fluid", *common, "--vel_obs_real", "0.2848"])
    rec_t = jrl_main.main(["c", *common, "--vel_obs_real", "2.1e-05", "--Pe", "5.0",
                           "--balance_time", "0.5"])
    for rel in (p.relative_to(out) for p in out.rglob("*")):
        if rel.suffix in (".h5", ".txt"):
            assert (tmp_path / rel).exists(), rel
    assert Path(rec_t).relative_to(tmp_path) == Path(rec).relative_to(out)
    header, got = _read_rows(rec_t)
    _, want = _read_rows(rec)
    assert header == "Step Inflow Current u, v"
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-4, atol=1e-4)
    from jrl_lbm_tpu.utils.io import load_fluid_h5

    vel_t = load_fluid_h5(next(tmp_path.glob("_45degree_g0/Re_*.h5")))
    vel_j = load_fluid_h5(next(out.glob("_45degree_g0/Re_*.h5")))
    np.testing.assert_allclose(vel_t, vel_j, rtol=2e-4, atol=2e-4)
