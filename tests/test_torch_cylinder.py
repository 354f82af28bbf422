"""The cylinder channel of the PyTorch port on the CPU, where each kernel
wrapper of `kernels/cylinder.py` runs its plain twin: the new ops
(`propagate` with ``inflow_vel``, the contact-angle extrapolation, MRT,
`cylinder_phi`) against the JAX package's jnp ops, the scene
(`models/cylinder.py`) against the JAX scene, the twins against the
Pallas fused step of `ops/pallas/fused_step.py` in TPU interpret mode (as
`tests/test_fused.py` runs it), the runner against the jnp runner, and
the contract. The CUDA kernels against these twins, on a card, are in
`test_torch_cuda.py`.

Inputs come from numpy with a seed; JAX states enter the port through
`models/cylinder.py::state_from_numpy`. Tolerances: ops 1e-5 (moments
1e-6); trajectories those of `tests/test_fused.py`, f and rho 2e-5, vel
2e-4 (the fused step sums the equilibrium and MRT in another order than
the jnp step). The fused path keeps the fused step's semantics (no
contact-angle extrapolation, OBSTACLE rho passthrough), so it is held to
jnp steps on non-OBSTACLE cells only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from jrl_lbm_tpu.models import cylinder as J
from jrl_lbm_tpu.ops import collide as Jcol
from jrl_lbm_tpu.ops import macro as Jmac
from jrl_lbm_tpu.ops import stream as Jstr
from jrl_lbm_tpu.ops.pallas import fused_step as JF
from jrl_lbm_tpu.utils import sdf as Jsdf
from jrl_lbm_torch.kernels import cylinder as K
from jrl_lbm_torch.models import cylinder as T
from jrl_lbm_torch.ops import collide as Tcol
from jrl_lbm_torch.ops import macro as Tmac
from jrl_lbm_torch.ops import stream as Tstr
from jrl_lbm_torch.utils import sdf as Tsdf
from jrl_lbm_torch.utils.grid import create_2d_meshgrid
from jrl_lbm_torch.utils.types import CellType

TRAJ = {"f": 2e-5, "rho": 2e-5, "vel": 2e-4}
GENERIC = dict(res=(64, 32), D=8.0, Re=500.0, cylinder_center=(16.0, 32.0))
SPLIT = dict(res=(96, 32), D=8.0, Re=500.0, cylinder_center=(16.0, 48.0))
CELL_TYPES = [int(c) for c in (CellType.FLUID, CellType.OBSTACLE, CellType.INFLOW,
                               CellType.OUTFLOW, CellType.INFLOW_2)]


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, tol, tag, mask=None):
    got, want = np.asarray(got), np.asarray(want)
    if mask is not None:
        m = np.broadcast_to(mask, got.shape)
        got, want = got[m], want[m]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=tag)


def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


def _scene(kw):
    """The JAX and port configs and initial states (port on the CPU)."""
    jc, tc = J.CylinderConfig(**kw), T.CylinderConfig(**kw)
    js, jf = J.init(jc)
    ts = T.state_from_numpy({k: np.asarray(v) for k, v in js.items()}, "cpu")
    tf = T.state_from_numpy({k: np.asarray(v) for k, v in jf.items()}, "cpu")
    return jc, tc, js, jf, ts, tf


def _not_obstacle(fields):
    return np.asarray(fields["flags"]) != int(CellType.OBSTACLE)


def _random_state(rng, H, W):
    f = (1.0 / 9.0 + 0.02 * rng.standard_normal((9, H, W))).astype(np.float32)
    rho = (1.0 + 0.05 * rng.standard_normal((H, W))).astype(np.float32)
    vel = (0.05 * rng.standard_normal((2, H, W))).astype(np.float32)
    return f, rho, vel


# --- ops ---

@pytest.mark.parametrize("seed", [0, 1])
def test_propagate_inflow_vel_matches_jax(seed):
    """All six cell types at random, sub-grid phi, no symmetry axis."""
    rng = np.random.default_rng(seed)
    H, W = 24, 20
    f, rho, vel = _random_state(rng, H, W)
    flags = rng.choice(CELL_TYPES + [int(CellType.FLUID)] * 3, size=(H, W)).astype(np.int32)
    phi = rng.uniform(-0.5, 1.5, (H, W)).astype(np.float32)
    iv = np.asarray([0.01, 0.05], np.float32)
    for kw in (dict(inflow_vel=iv, inflow_density=1.0), dict(inflow_vel=iv), dict()):
        jr, jv, jfn = Jstr.propagate(jnp.asarray(f), jnp.asarray(flags), phi_obs=jnp.asarray(phi),
                                     rho=jnp.asarray(rho), vel=jnp.asarray(vel), **kw)
        tr, tv, tfn = Tstr.propagate(_t(f), _t(flags), phi_obs=_t(phi), rho=_t(rho),
                                     vel=_t(vel), **kw)
        _close(tfn, jfn, 1e-5, f"propagate f {kw}")
        _close(tr, jr, 1e-5, f"propagate rho {kw}")
        _close(tv, jv, 1e-5, f"propagate vel {kw}")


@pytest.mark.parametrize("angle", [0.5 * np.pi, 0.3 * np.pi])
def test_contact_angle_and_macro_match_jax(angle):
    rng = np.random.default_rng(3)
    H, W = 20, 16
    f, rho, vel = _random_state(rng, H, W)
    flags = rng.choice([int(CellType.FLUID), int(CellType.OBSTACLE)], size=(H, W),
                       p=[0.7, 0.3]).astype(np.int32)
    _close(Tmac.contact_angle_correctness(_t(rho), _t(flags), angle),
           Jmac.contact_angle_correctness(jnp.asarray(rho), jnp.asarray(flags), angle), 1e-6,
           "contact_angle_correctness")
    for ca in (angle, None):
        jr, jv = Jmac.macro_compute(jnp.asarray(f), jnp.asarray(rho), jnp.asarray(vel),
                                    jnp.asarray(flags), contact_angle=ca)
        tr, tv = Tmac.macro_compute(_t(f), _t(rho), _t(vel), _t(flags), contact_angle=ca)
        _close(tr, jr, 1e-6, f"macro rho contact_angle={ca}")
        _close(tv, jv, 1e-6, f"macro vel contact_angle={ca}")


@pytest.mark.parametrize("tau,tau_D", [(0.53, None), (0.8, 0.6), (1.7, 1.1)])
def test_mrt_matrices_match_jax(tau, tau_D):
    jm, jc = Jcol.mrt_matrices(tau, tau_D)
    tm, tc = Tcol.mrt_matrices(tau, tau_D)
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-15)
    if tau_D is None:
        assert jc is None and tc is None
    else:
        np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-15)


@pytest.mark.parametrize("tau", [0.5048, 0.9])
def test_mrt_collide_matches_jax(tau):
    rng = np.random.default_rng(4)
    H, W = 16, 12
    f, rho, vel = _random_state(rng, H, W)
    flags = rng.choice([int(CellType.FLUID), int(CellType.OBSTACLE)], size=(H, W),
                       p=[0.8, 0.2]).astype(np.int32)
    m, _ = Jcol.mrt_matrices(tau)
    want = Jcol.mrt_collide(jnp.asarray(f), jnp.asarray(rho), jnp.asarray(vel),
                            jnp.asarray(flags), minv_s_m=m, tau=tau)
    got = Tcol.mrt_collide(_t(f), _t(rho), _t(vel), _t(flags), minv_s_m=m, tau=tau)
    _close(got, want, 1e-5, "mrt_collide")


def test_cylinder_phi_exact():
    from jrl_lbm_tpu.utils.grid import create_2d_meshgrid as jmesh

    for (H, W), center, r in (((64, 32), (16.0, 32.0), 4.0), ((50, 70), (33.3, 20.7), 9.5)):
        jm = jmesh((H, W)) + 0.5
        tm = create_2d_meshgrid((H, W), dtype=torch.float32, device="cpu") + 0.5
        np.testing.assert_array_equal(Tsdf.cylinder_phi(tm, center, r).numpy(),
                                      np.asarray(Jsdf.cylinder_phi(jm, center, r)))


# --- the scene ---

def test_init_matches_jax():
    for kw in (GENERIC, SPLIT, dict(res=(80, 40), D=10.0, cylinder_center=(20.0, 30.0))):
        jc, tc = J.CylinderConfig(**kw), T.CylinderConfig(**kw)
        assert tc.tau == jc.tau and tc.center == jc.center
        js, jf = J.init(jc)
        ts, tf = T.init(tc, "cpu")
        np.testing.assert_array_equal(tf["flags"].numpy(), np.asarray(jf["flags"]))
        for d, e in ((ts, js), (tf, jf)):
            for k in d:
                if k != "flags":
                    _close(d[k], e[k], 1e-7, f"init {k}")


def test_runner_matches_jax():
    """Five plain steps (the jnp step: contact angle, MRT) at (64, 32),
    all cells."""
    jc, tc, js, jf, _, _ = _scene(GENERIC)
    ts, tf = T.init(tc, "cpu")
    want = J.make_runner(jc)(js, jf, 5)
    got = T.make_runner(tc)(ts, tf, 5)
    for k in ("f", "rho", "vel"):
        _close(got[k], want[k], TRAJ[k], f"runner {k}")


def test_drag_lift_matches_jax():
    jc, tc = J.CylinderConfig(**GENERIC), T.CylinderConfig(**GENERIC)
    f = np.random.default_rng(9).uniform(0.0, 1.0, (9,) + GENERIC["res"]).astype(np.float32)
    _, jf = J.init(jc)
    want = J.drag_lift({"f": jnp.asarray(f)}, jf, jc)
    got = T.drag_lift({"f": _t(f)}, None, tc)
    for g, w in zip(got, want):
        assert float(w) != 0.0
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


def test_state_numpy_round_trip():
    ts, tf = T.init(T.CylinderConfig(**GENERIC), "cpu")
    for d in (ts, tf):
        back = T.state_from_numpy(T.state_to_numpy(d), "cpu")
        for k, v in d.items():
            assert back[k].dtype == v.dtype and torch.equal(back[k], v)


# --- the twins against the Pallas fused step, interpret mode ---

def _pallas_steps(jc, js, jf, n, **kw):
    with _interpret():
        step = JF.make_fused_step(jc, **kw)
        out = dict(js)
        for _ in range(n):
            out = step(out, jf)
        return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("kw,split,interior_rows", [(GENERIC, False, 32), (SPLIT, True, 16)])
def test_fused_step_matches_pallas(kw, split, interior_rows):
    """Five fused steps through the twins against the Pallas step: the
    generic path (every row through cyl_full) and the k=1 split
    (cyl_interior + cyl_full), all cells."""
    jc, tc, js, jf, ts, tf = _scene(kw)
    ref = J.make_runner(jc)(js, jf, 5)  # jnp first: interleaving deadlocks interpret mode
    want = _pallas_steps(jc, js, jf, 5, tile_rows=8, split=split, interior_rows=interior_rows)
    step = K.make_fused_step(tc, tile_rows=8, split=split, interior_rows=interior_rows)
    assert step.split == split
    out = ts
    for _ in range(5):
        out = step(out, tf)
    for k in ("f", "rho", "vel"):
        _close(out[k], want[k], TRAJ[k], f"fused step {k}")
        _close(out[k], ref[k], TRAJ[k], f"fused step vs jnp {k}", _not_obstacle(jf))


def test_fused_step2_matches_pallas():
    """Two k=2 passes (cyl_interior_k, cyl_band_k "cyl" and "edge") and the
    macro refresh against the Pallas k=2 path, all cells."""
    jc, tc, js, jf, ts, tf = _scene(SPLIT)
    with _interpret():
        st2 = JF.make_fused_step2(jc, tile_rows=8, k=2)
        o = st2(dict(js), jf)
        o = st2(o, jf)
        want = {k: np.asarray(v) for k, v in JF.make_macro_refresh(jc)(o, jf).items()}
    step2 = K.make_fused_step2(tc, tile_rows=8, k=2)
    assert step2 is not None and step2.skip_macro and step2.k == 2
    out = step2(step2(ts, tf), tf)
    out = K.make_macro_refresh(tc)(out, tf)
    for k in ("f", "rho", "vel"):
        _close(out[k], want[k], TRAJ[k], f"k=2 {k}")


def test_fused_step4_matches_jnp():
    """One k=4 pass and the refresh against four jnp steps, non-OBSTACLE
    cells (an interpreted k=4 Pallas pass takes ~20 min)."""
    jc, tc, js, jf, ts, tf = _scene(SPLIT)
    want = J.make_runner(jc)(js, jf, 4)
    step4 = K.make_fused_step2(tc, tile_rows=8, k=4)
    assert step4 is not None and step4.k == 4
    out = K.make_macro_refresh(tc)(step4(ts, tf), tf)
    for k in ("f", "rho", "vel"):
        _close(out[k], want[k], TRAJ[k], f"k=4 {k}", _not_obstacle(jf))


@pytest.mark.parametrize("n", [7, 1])
def test_fused_runner_matches_jnp(n):
    """n = 7 runs a k=4 pass, a k=2 pass and a single step in one call."""
    jc, tc, js, jf, ts, tf = _scene(SPLIT)
    want = J.make_runner(jc)(js, jf, n)
    run = K.make_fused_cylinder_runner(tc, tile_rows=8)
    assert run.step4 is not None and run.step2 is not None and run.step.split
    got = run(ts, tf, n)
    for k in ("f", "rho", "vel"):
        _close(got[k], want[k], TRAJ[k], f"runner n={n} {k}", _not_obstacle(jf))
    # the caller's state is not written
    assert torch.equal(ts["f"], T.state_from_numpy({"f": np.asarray(js["f"])}, "cpu")["f"])


def test_fused_runner_k_selection(monkeypatch):
    """LBM_FUSED_K other than 4 drops the k=4 pass, as in the JAX runner;
    the generic path has no k-step pass."""
    tc = T.CylinderConfig(**SPLIT)
    monkeypatch.setenv("LBM_FUSED_K", "2")
    run = K.make_fused_cylinder_runner(tc, tile_rows=8)
    assert run.step4 is None and run.step2 is not None
    monkeypatch.delenv("LBM_FUSED_K")
    run = K.make_fused_cylinder_runner(tc, tile_rows=8, split=False)
    assert run.step4 is None and run.step2 is None and not run.step.split


# --- the contract ---

def test_preconditions_raise():
    tc = T.CylinderConfig(**SPLIT)
    with pytest.raises(ValueError, match="divisible"):
        K.make_fused_step(tc, tile_rows=7)
    for k in (1, 9, 16):  # outside 2 <= k <= min(8, tile_rows)
        assert K.make_fused_step2(tc, tile_rows=8, k=k) is None
    assert K.make_fused_step2(tc, tile_rows=2, k=4) is None
    # a cylinder too close to the INFLOW row leaves no split with the margin
    near = T.CylinderConfig(res=(96, 32), D=8.0, Re=500.0, cylinder_center=(16.0, 10.0))
    assert K.make_fused_step2(near, tile_rows=8, k=2) is None
    assert not K.make_fused_step(near, tile_rows=8).split
    # the storage modes are False, True and "sr"; any other value raises
    for bad in ("bf16", 1, 0, None, "SR"):
        for fn in (lambda: K.make_fused_step(tc, bf16_dev=bad),
                   lambda: K.make_fused_step2(tc, bf16_dev=bad),
                   lambda: K.make_fused_cylinder_runner(tc, bf16_dev=bad),
                   lambda: K.f_to_storage(torch.zeros(9, 4, 4), bad),
                   lambda: K.make_macro_refresh(tc, bf16_dev=bad)):
            with pytest.raises(ValueError, match="storage modes"):
                fn()
    assert K.f_to_storage(torch.ones(2), False) is not None


def test_border_check_refuses_fluid_border():
    tc = T.CylinderConfig(**SPLIT)
    ts, tf = T.init(tc, "cpu")
    K.check_border(tf["flags"])
    bad = tf["flags"].clone()
    bad[5, 0] = int(CellType.FLUID)
    with pytest.raises(ValueError, match="border"):
        K.check_border(bad)
    with pytest.raises(ValueError, match="border"):
        K.make_fused_step2(tc, tile_rows=8)(ts, dict(tf, flags=bad))


def test_wrapper_checks():
    """What a launch on the card would refuse: wrong dtype, shape or
    layout, shared output buffers, bad row segments, k past the kernels'
    depth; tensors that pass every check still need the card."""
    tc = T.CylinderConfig(**GENERIC)
    c = K.consts(tc)
    ts, tf = T.init(tc, "cpu")
    H = tc.res[0]
    out = {k: torch.empty_like(v) for k, v in ts.items()}

    def check(f=ts["f"], rho=ts["rho"], flags=tf["flags"], out=out, segs=((0, H),)):
        return K._check(c, list(segs), f=(f, (9,)), rho=(rho, ()), flags=(flags, ()),
                        f_out=(out["f"], (9,)), rho_out=(out["rho"], ()))

    with pytest.raises(ValueError, match="dtype"):
        check(f=ts["f"].double())
    with pytest.raises(ValueError, match="dtype"):
        check(flags=tf["flags"].float())
    with pytest.raises(ValueError, match="shape"):
        check(rho=ts["rho"][:-1])
    with pytest.raises(ValueError, match="contiguous"):
        check(f=ts["f"].transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="apart"):
        check(out=dict(out, f=ts["f"]))
    for segs in (((4, 2),), ((0, 8), (4, 12)), ((0, H + 1),), ()):
        with pytest.raises(ValueError, match="segment"):
            check(segs=segs)
    with pytest.raises(ValueError, match="card"):
        check()
    with pytest.raises(ValueError, match="k ="):
        K._check_k(9)
