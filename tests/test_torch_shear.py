"""The shear-layer slice of the PyTorch port on the CPU: the KBC and
multiphase ops against the JAX package's jnp ops, the scene
(`models/shear_layer.py`) against the jnp scene, the periodic kernel's
twin (`kernels/periodic.py`, which the wrapper runs for CPU tensors)
against the interpreted Pallas kernel of `ops/pallas/fused_periodic.py`,
the demo default against JAX, and the demo CLI's frames against the
committed goldens. The CUDA kernel against its twin, on a card, is in
`test_torch_cuda.py`.

Inputs come from numpy with a seed; JAX states enter the port through
`state_from_numpy`. Tolerances: ops rtol = atol = 1e-5 (float32 sums in
another order; jnp's `kbc_omega` forms its moments with `jnp.power` and
an einsum), trajectories f and rho 2e-5, vel 2e-4; the twin against the
interpreted Pallas kernel f 1e-6, vel 1e-5 (both follow the Pallas body).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from jrl_lbm_tpu.models import shear_layer as sl
from jrl_lbm_tpu.ops import collide as jcollide
from jrl_lbm_tpu.ops import equilibrium as jeq
from jrl_lbm_tpu.ops import macro as jmacro
from jrl_lbm_tpu.utils import types as jtypes
from jrl_lbm_torch import kernels, shear_main
from jrl_lbm_torch.kernels import periodic as P
from jrl_lbm_torch.models import shear_layer as tsl
from jrl_lbm_torch.ops import collide as tcollide
from jrl_lbm_torch.ops import equilibrium as teq
from jrl_lbm_torch.ops import macro as tmacro
from jrl_lbm_torch.utils import types as ttypes
from jrl_lbm_torch.utils.types import AxiSymmetricType, CellType, KBCType

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "validation", "goldens")
TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ = {"f": 2e-5, "rho": 2e-5, "vel": 2e-4}
KBC_TYPES = [int(k) for k in KBCType]
# (collision, kbc_type) of the seven kernel instances
RELAXES = [("bgk", None), ("mrt", None)] + [("kbc", k) for k in KBC_TYPES]


def _t(a):
    return None if a is None else torch.as_tensor(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _state(rng, H, W):
    f = rng.uniform(0.02, 0.3, size=(9, H, W)).astype(np.float32)
    rho = f.sum(0)
    vel = rng.uniform(-0.08, 0.08, size=(2, H, W)).astype(np.float32)
    return f, rho, vel


def _mesh(H, W):
    iy, ix = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    return np.stack([ix + 0.5, iy + 0.5]).astype(np.float32)


def _close(got, want, tol, tag):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=tag)


def _jax_state(cfg):
    js, jf = sl.init(cfg)
    return js, jf, tsl.state_from_numpy(dict(js), "cpu"), tsl.state_from_numpy(dict(jf), "cpu")


# --- ops ---

def test_kbc_tables_and_enum_match():
    for name in ("KBC_C_MAT", "KBC_P", "KBC_Q"):
        np.testing.assert_array_equal(getattr(tcollide, name), getattr(jcollide, name))
    assert {m.name: int(m) for m in ttypes.KBCType} == {m.name: int(m) for m in jtypes.KBCType}


@pytest.mark.parametrize("kbc_type", KBC_TYPES)
def test_kbc_omega_matches_jnp(kbc_type):
    rng = np.random.default_rng(2)
    f, rho, vel = _state(rng, 12, 10)
    fe = np.asarray(jeq.feq(_j(rho), _j(vel)))
    want = jcollide.kbc_omega(_j(rho), _j(vel), _j(f), _j(fe), 0.57, kbc_type)
    got = tcollide.kbc_omega(_t(rho), _t(vel), _t(f), _t(fe), 0.57, kbc_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("axisym", [int(AxiSymmetricType.NOT), int(AxiSymmetricType.LINE_X_EQ_0)])
@pytest.mark.parametrize("kbc_type", KBC_TYPES)
def test_kbc_collide_matches_jnp(kbc_type, axisym):
    """With OBSTACLE cells (passed through) and a body force; on the
    LINE_X_EQ_0 axis with its source term."""
    rng = np.random.default_rng(3)
    H, W = 12, 10
    f, rho, vel = _state(rng, H, W)
    flags = np.where(rng.uniform(size=(H, W)) < 0.2, int(CellType.OBSTACLE),
                     int(CellType.FLUID)).astype(np.int32)
    force = (1e-3 * rng.standard_normal((2, H, W))).astype(np.float32)
    mesh = _mesh(H, W)
    kw = dict(tau=0.62, kbc_type=kbc_type, axisymmetric_type=axisym)
    want = jcollide.kbc_collide(_j(f), _j(rho), _j(vel), _j(flags), force=_j(force),
                                mesh_grid=_j(mesh), **kw)
    got = tcollide.kbc_collide(_t(f), _t(rho), _t(vel), _t(flags), force=_t(force),
                               mesh_grid=_t(mesh), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    obs = flags == int(CellType.OBSTACLE)
    np.testing.assert_array_equal(got.numpy()[:, obs], f[:, obs])


def test_kbc_omega_refuses_unknown_type():
    rng = np.random.default_rng(0)
    f, rho, vel = _state(rng, 4, 4)
    with pytest.raises(ValueError, match="KBC type"):
        tcollide.kbc_omega(_t(rho), _t(vel), _t(f), _t(f), 0.6, 3)


@pytest.mark.parametrize("op", ["geq", "equation_of_states", "density_remap", "get_pressure",
                                "get_vort"])
def test_multiphase_and_vorticity_ops_match_jnp(op):
    rng = np.random.default_rng(4)
    H, W = 11, 9
    _, rho, vel = _state(rng, H, W)
    rho = rng.uniform(0.04, 0.27, size=(H, W)).astype(np.float32)
    density = rng.uniform(0.05, 0.2, size=(H, W)).astype(np.float32)
    pressure = rng.uniform(0.01, 0.05, size=(H, W)).astype(np.float32)
    force = (1e-3 * rng.standard_normal((2, H, W))).astype(np.float32)
    calls = {
        "geq": (lambda m, a: m.geq(a(rho), a(density), a(vel), a(pressure), force=a(force)),
                jeq, teq),
        "equation_of_states": (lambda m, a: m.equation_of_states(a(rho), dx=1.0, dt=0.5),
                               jeq, teq),
        "density_remap": (lambda m, a: m.density_remap(a(rho), 0.265, 0.038, 0.265, 0.038),
                          jmacro, tmacro),
        "get_pressure": (lambda m, a: m.get_pressure(a(density)), jmacro, tmacro),
        "get_vort": (lambda m, a: m.get_vort(a(vel), dx=0.5), jmacro, tmacro),
    }
    call, jm, tm = calls[op]
    want, got = np.asarray(call(jm, _j)), call(tm, _t)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# --- init ---

def test_init_matches_jax_init():
    cfg = sl.ShearLayerConfig()
    js, jf, ts, tf = _jax_state(cfg)
    ps, pf = tsl.init(tsl.ShearLayerConfig(), "cpu")
    for key in js:
        np.testing.assert_allclose(ps[key].numpy(), np.asarray(js[key]), rtol=1e-6, atol=1e-6,
                                   err_msg=key)
        assert ts[key].dtype == torch.float32
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))
    for key in jf:
        np.testing.assert_array_equal(pf[key].numpy(), np.asarray(jf[key]))
    assert tf["flags"].dtype == torch.int32
    assert tsl.ShearLayerConfig().tau == cfg.tau


# --- the twin against the interpreted Pallas kernel, and the jnp step ---

@pytest.mark.parametrize("collision,kbc_type", RELAXES)
def test_periodic_twin_matches_interpreted_pallas(collision, kbc_type):
    """5 steps at 32x32: the port's runner (the twin on the CPU) against
    the Pallas step in TPU interpret mode (f 1e-6, vel 1e-5) and against
    the jnp step at `tests/test_fused.py`'s tolerances."""
    from jax.experimental.pallas import tpu as pltpu

    from jrl_lbm_tpu.ops.pallas import fused_periodic as fp

    kw = dict(res=(32, 32), Re=1000.0, collision=collision, kbc_type=kbc_type)
    cfg, tcfg = sl.ShearLayerConfig(**kw), tsl.ShearLayerConfig(**kw)
    js, jf, ts, tf = _jax_state(cfg)
    # the jnp steps first: interleaving eager jnp ops with interpret-mode
    # pallas calls deadlocks the interpret runtime (tests/test_fused.py)
    ref = dict(js)
    step_ref = sl.make_step(cfg)
    for _ in range(5):
        ref = step_ref(ref, jf)
    ref = jax.tree.map(np.asarray, ref)
    with pltpu.force_tpu_interpret_mode():
        step_p = fp.make_fused_periodic_step(cfg, tile_rows=8)
        out = dict(js)
        for _ in range(5):
            out = step_p(out, jf)
        out = jax.tree.map(np.asarray, out)
    kernels.reset_launches()
    got = P.make_fused_periodic_runner(tcfg)(ts, tf, 5)
    assert kernels.launches()["periodic"] == 0  # CPU tensors: the twin, no launch
    _close(got["f"], out["f"], 1e-6, "f vs pallas")
    _close(got["rho"], out["rho"], 1e-6, "rho vs pallas")
    _close(got["vel"], out["vel"], 1e-5, "vel vs pallas")
    np.testing.assert_allclose(got["f"].numpy(), ref["f"], rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got["vel"].numpy(), ref["vel"], rtol=1e-4, atol=1e-5)


# --- the scene ---

@pytest.mark.parametrize("collision,kbc_type", RELAXES)
def test_plain_scene_matches_jnp_scene(collision, kbc_type):
    """The plain runner against the jnp runner, 20 steps at 64x64."""
    kw = dict(res=(64, 64), collision=collision, kbc_type=kbc_type)
    cfg, tcfg = sl.ShearLayerConfig(**kw), tsl.ShearLayerConfig(**kw)
    js, jf, ts, tf = _jax_state(cfg)
    want = jax.tree.map(np.asarray, sl.make_runner(cfg)(js, jf, 20))
    got = tsl.make_runner(tcfg)(ts, tf, 20)
    for key, tol in TRAJ.items():
        _close(got[key], want[key], tol, key)
    _close(tsl.vorticity(got, tcfg), np.asarray(sl.vorticity(want, cfg)), 2e-4, "vorticity")


@pytest.mark.parametrize("collision,kbc_type,steps", [
    ("mrt", None, 1000),
    ("kbc", int(KBCType.KBC_A), 1000),
    ("bgk", None, 400),
])
def test_demo_default_matches_jax(collision, kbc_type, steps):
    """The demo default (130², Re 3000, tau 0.526) from JAX's initial state,
    the kernel path's runner (its twin here) against the jnp runner: vel
    2e-4. BGK only to step 400: the BGK demo turns chaotic between steps
    500 and 600, where a relative perturbation of 1e-7 on f grows to a
    velocity difference of 2.5e-2 by step 600 (1.2e-1 by 1000); MRT and
    KBC_A stay within ~4e-6 of a perturbed run over all 1000 steps."""
    kw = dict(collision=collision, kbc_type=kbc_type)
    cfg, tcfg = sl.ShearLayerConfig(**kw), tsl.ShearLayerConfig(**kw)
    js, jf, ts, tf = _jax_state(cfg)
    want = np.asarray(sl.make_runner(cfg)(js, jf, steps)["vel"])
    got = P.make_fused_periodic_runner(tcfg)(ts, tf, steps)
    _close(got["vel"], want, 2e-4, f"{collision} vel after {steps} steps")


@pytest.mark.parametrize("name,collision,steps,frames", [
    ("2d_LBM_KBC", "mrt", 1000, ("011", "301", "631", "1001")),
    ("2d_LBM", "bgk", 300, ("011", "301")),
])
def test_cli_frames_match_goldens(name, collision, steps, frames, tmp_path):
    """The shear CLI on the CPU (the plain runner) at the demo default
    writes the reference demos' frames: mean |pixel difference| < 1.0
    against the committed goldens (`tests/test_goldens.py:84`). The MRT
    run is the reference "KBC" demo's. The BGK run stops at step 300:
    frames 631 and 1001 lie past the chaotic transition (steps 500-600),
    where two codes that round differently part completely."""
    from PIL import Image

    files = shear_main.main(["--collision", collision, "--total_steps", str(steps),
                             "--out", str(tmp_path), "--device", "cpu", "--no-video"])
    assert len(files) == steps // 10
    for fr in frames:
        a = np.asarray(Image.open(os.path.join(GOLD, name, f"{fr}.png")), np.float64)
        b = np.asarray(Image.open(tmp_path / "demo_data_LBM_2d" / f"{fr}.png"), np.float64)
        assert a.shape == b.shape
        assert np.abs(a - b).mean() < 1.0, fr
