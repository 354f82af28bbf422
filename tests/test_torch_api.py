"""The reference-parity API (`jrl_lbm_torch/simulation.py`) and the
diagnostics (`utils/metrics.py`) of the PyTorch port on the CPU, mirroring
`tests/test_simulation_api.py`: the factories, the frame clock, the demo
loop through the wrappers against the port's shear-layer step, and the
same numpy inputs through the JAX package's wrappers and the port's
(rtol = atol = 1e-5, float32 sums in another order). Also the entry
points' device contract and the periodic wrapper's checks.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from jrl_lbm_tpu import SimulationParameters as JParams
from jrl_lbm_tpu import SimulationRunner as JRunner
from jrl_lbm_tpu.utils import metrics as jmetrics
from jrl_lbm_torch import SimulationParameters, SimulationRunner, kernels, shear_main
from jrl_lbm_torch.kernels import build
from jrl_lbm_torch.kernels import periodic as P
from jrl_lbm_torch.models import shear_layer as tsl
from jrl_lbm_torch.utils import metrics
from jrl_lbm_torch.utils.types import CellType, KBCType

TOL = dict(rtol=1e-5, atol=1e-5)
ALL_TYPES = [1, 1, 1, int(CellType.OBSTACLE), int(CellType.OUTFLOW),
             int(CellType.INFLOW), int(CellType.INFLOW_2)]


def _kw(res=(32, 32), tau=0.6, axisym=0, contact=0.5 * math.pi):
    return dict(dim=2, simulation_size=(1, 1, *res), dt=1.0, density_gas=0.038,
                density_fluid=0.265, contact_angle=contact, Q=9, tau=tau,
                axisymmetric_type=axisym)


def _params(**kw):
    return SimulationParameters(**_kw(**kw))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_runner_factories():
    runner = SimulationRunner(_params())
    prop = runner.create_propagation()
    macro = runner.create_macro_compute()
    bgk = runner.create_collision()
    kbc = runner.create_collision_KBC()
    mrt = runner.create_collision_MRT()
    sfc = runner.create_LBM_fluid_solid_coupling()
    assert bgk.KIND == "bgk" and kbc.KIND == "kbc" and mrt.KIND == "mrt"
    assert prop.axisymmetric_type == 0 and sfc.axisymmetric_type == 0
    assert macro._contact_angle == pytest.approx(0.5 * math.pi)
    runner.step()
    assert runner.frame == 1
    assert SimulationParameters().res == (256, 256)


def test_frame_clock_matches_jax():
    jr, tr = JRunner(JParams(dt=0.3)), SimulationRunner(SimulationParameters(dt=0.3))
    for _ in range(11):
        jr.step()
        tr.step()
        assert tr.frame == jr.frame
        assert tr._clock.time_total == jr._clock.time_total
        assert tr._clock.time_per_frame == jr._clock.time_per_frame


@pytest.mark.parametrize("factory", ["create_propagation", "create_macro_compute",
                                     "create_collision", "create_collision_KBC",
                                     "create_collision_MRT", "create_LBM_fluid_solid_coupling"])
def test_runner_raises_for_3d(factory):
    runner = SimulationRunner(SimulationParameters(dim=3, simulation_size=(1, 1, 8, 8, 8)))
    with pytest.raises((RuntimeError, NotImplementedError)):
        getattr(runner, factory)()


def test_params_validate_size():
    with pytest.raises(ValueError):
        SimulationParameters(simulation_size=(8, 8))


def test_demo_loop_via_wrappers_matches_scene():
    """The reference demo_2d_LBM loop written against the wrappers
    reproduces the shear-layer scene step."""
    cfg = tsl.ShearLayerConfig(res=(32, 32), Re=1000.0)
    state, fields = tsl.init(cfg, "cpu")
    runner = SimulationRunner(_params(res=(32, 32), tau=cfg.tau))
    prop = runner.create_propagation()
    macro = runner.create_macro_compute()
    collision = runner.create_collision()
    f, density, vel = state["f"], state["rho"], state["vel"]
    flags, force = fields["flags"], fields["force"]
    for _ in range(10):
        f = prop.propagation(f=f, flags=flags)
        density, vel = macro.macro_compute(f=f, rho=density, vel=vel, flags=flags)
        f = collision.collision(f=f, rho=density, vel=vel, flags=flags, force=force,
                                KBC_type=None)
        runner.step()
    ref = tsl.make_runner(cfg)(state, fields, 10)
    np.testing.assert_allclose(f.numpy(), ref["f"].numpy(), rtol=1e-5, atol=1e-7)
    assert runner.frame == 10


def test_kbc_wrapper_collision_conserves_mass():
    runner = SimulationRunner(_params())
    kbc = runner.create_collision_KBC()
    kbc.preset_KBC(dx=1.0, dt=1.0, tau=0.7)
    rng = np.random.default_rng(0)
    f = torch.as_tensor(rng.uniform(0.05, 0.2, (9, 16, 16)).astype(np.float32))
    rho = f.sum(0)
    vel = torch.zeros((2, 16, 16))
    flags = torch.full((16, 16), int(CellType.FLUID), dtype=torch.int32)
    out = kbc.collision(f=f, rho=rho, vel=vel, flags=flags, force=None,
                        KBC_type=int(KBCType.KBC_C))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.sum(0).numpy(), rho.numpy(), rtol=1e-4)


def test_propagation_tuple_return_contract():
    """A tuple iff inflow information is given (`LBM_propagation_2d.py:51-92`)."""
    prop = SimulationRunner(_params()).create_propagation()
    f = torch.ones((9, 8, 8))
    flags = torch.full((8, 8), int(CellType.FLUID), dtype=torch.int32)
    assert isinstance(prop.propagation(f=f, flags=flags), torch.Tensor)
    out = prop.propagation(f=f, flags=flags, rho=torch.ones((8, 8)), vel=torch.zeros((2, 8, 8)),
                           inflow_density=1.0, inflow_vel=np.array([0.0, 0.01], np.float32))
    assert isinstance(out, tuple) and len(out) == 3


def test_rebounce_wrapper():
    prop = SimulationRunner(_params()).create_propagation()
    f = torch.arange(9, dtype=torch.float32)[:, None, None] * torch.ones((9, 4, 4))
    flags = torch.full((4, 4), int(CellType.OBSTACLE), dtype=torch.int32)
    out = prop.rebounce_obstacle(f, flags).numpy()
    np.testing.assert_allclose(out[:, 0, 0], [0, 3, 4, 1, 2, 7, 8, 5, 6])


@pytest.mark.parametrize("case", ["propagation", "propagation_inflow", "macro_density",
                                  "collision_bgk", "collision_mrt", "collision_kbc_A",
                                  "collision_kbc_D", "collision_kbc_lbgk", "boundary",
                                  "feq_geq_eos"])
def test_wrappers_match_jax_wrappers(case):
    """Numpy inputs through the JAX package's wrappers and the port's, on
    random flags with all six cell types (the boundary case on an
    obstacle block), about the x = 0 axis."""
    rng = np.random.default_rng(7)
    H, W = 12, 10
    f = rng.uniform(0.02, 0.3, (9, H, W)).astype(np.float32)
    rho = f.sum(0)
    vel = rng.uniform(-0.05, 0.05, (2, H, W)).astype(np.float32)
    flags = rng.choice(ALL_TYPES, size=(H, W)).astype(np.int32)
    force = (1e-3 * rng.standard_normal((2, H, W))).astype(np.float32)
    phi = rng.uniform(-0.5, 1.5, (H, W)).astype(np.float32)
    iy, ix = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    mesh = np.stack([ix + 0.5, iy + 0.5]).astype(np.float32)
    kw = _kw(res=(H, W), tau=0.63, axisym=1, contact=0.4 * math.pi)
    jr, tr = JRunner(JParams(**kw)), SimulationRunner(SimulationParameters(**kw))

    def both(call):
        return call(jr, jnp.asarray), call(tr, torch.as_tensor)

    def collide(make, kbc_type=None):
        def call(r, a):
            op = getattr(r, make)()
            op.preset_KBC(dx=1.0, dt=1.0, tau=0.63)
            return op.collision(f=a(f), rho=a(rho), vel=a(vel), flags=a(flags), force=a(force),
                                mesh_grid=a(mesh), KBC_type=kbc_type)
        return call

    calls = {
        "propagation": lambda r, a: r.create_propagation().propagation(
            f=a(f), flags=a(flags), phi_obs=a(phi)),
        "propagation_inflow": lambda r, a: r.create_propagation().propagation(
            f=a(f), flags=a(flags), rho=a(rho), vel=a(vel), inflow_density=0.9,
            inflow_vel=np.array([0.0, 0.02], np.float32)),
        "macro_density": lambda r, a: r.create_macro_compute().macro_compute(
            f=a(f), rho=a(rho), vel=a(vel), flags=a(flags), density=a(rho)),
        "collision_bgk": collide("create_collision", int(KBCType.KBC_A)),
        "collision_mrt": collide("create_collision_MRT"),
        "collision_kbc_A": collide("create_collision_KBC", int(KBCType.KBC_A)),
        "collision_kbc_D": collide("create_collision_KBC", int(KBCType.KBC_D)),
        "collision_kbc_lbgk": collide("create_collision_KBC"),
        "boundary": lambda r, a: r.create_LBM_fluid_solid_coupling().solve_boundary(
            a(rho), a(vel), a(np.where(flags == int(CellType.OBSTACLE), flags, 1).astype(
                np.int32)), a(f), a(phi), obs_vel=a(0.1 * vel), tau=0.7),
        "feq_geq_eos": lambda r, a: (
            r.create_collision().get_feq_(a(rho), a(vel), force=a(force)),
            r.create_collision().get_geq_(a(rho), a(0.5 * rho), a(vel), a(0.1 * rho)),
            r.create_collision().equation_of_states(a(0.2 * rho)),
            r.create_macro_compute().get_pressure(a(0.2 * rho)),
            r.create_macro_compute().get_vort(a(vel)),
        ),
    }
    want, got = both(calls[case])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


# --- diagnostics ---

def test_conservation_diagnostics_match_jax():
    rng = np.random.default_rng(5)
    f = rng.uniform(0.02, 0.3, (9, 20, 18)).astype(np.float32)
    vel = rng.uniform(-0.05, 0.05, (2, 20, 18)).astype(np.float32)
    np.testing.assert_allclose(metrics.mass(torch.as_tensor(f)).item(),
                               float(jmetrics.mass(jnp.asarray(f))), rtol=1e-5)
    np.testing.assert_allclose(metrics.momentum(torch.as_tensor(f)).numpy(),
                               np.asarray(jmetrics.momentum(jnp.asarray(f))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(metrics.divergence_norm(torch.as_tensor(vel)).item(),
                               float(jmetrics.divergence_norm(jnp.asarray(vel))), rtol=1e-5)
    state = {"f": torch.as_tensor(f), "vel": torch.as_tensor(vel)}
    assert metrics.field_stats(state) == jmetrics.field_stats(
        {"f": jnp.asarray(f), "vel": jnp.asarray(vel)})


def test_step_timer_trace_and_scope_on_cpu(tmp_path):
    cfg = tsl.ShearLayerConfig(res=(16, 16), collision="mrt")
    s, fl = tsl.init(cfg, "cpu")
    timer = metrics.StepTimer(cells=256)
    with metrics.trace(str(tmp_path)):
        timer.start(s)
        with metrics.named_scope("shear_steps"):
            s = tsl.make_runner(cfg)(s, fl, 3)
        timer.stop(3, s)
    assert timer.steps == 3 and timer.elapsed > 0 and timer.mlups > 0
    assert set(timer.report()) == {"cells", "steps", "seconds", "mlups"}
    assert "shear_steps" in (tmp_path / "trace.json").read_text()


# --- the device contract ---

def test_entry_points_default_to_the_card(monkeypatch):
    """Without CUDA the entry points raise unless the caller asks for the
    CPU; nothing falls back to the plain path silently. The API's wrappers
    make no tensor of their own and run where their inputs are."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tsl.ShearLayerConfig(res=(16, 16))
    with pytest.raises(RuntimeError, match="CUDA"):
        tsl.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        shear_main.run_shear(cfg, 10)
    s, fl = tsl.init(cfg, "cpu")
    out = SimulationRunner(SimulationParameters()).create_collision().collision(
        f=s["f"], rho=s["rho"], vel=s["vel"], flags=fl["flags"])
    assert out.device.type == "cpu" and torch.isfinite(out).all()


def test_periodic_wrapper_on_cpu_runs_the_twin(monkeypatch):
    """CPU tensors go through the twin, with no build and no launch."""
    def no_nvcc():
        raise AssertionError("nvcc must not be needed for CPU tensors")

    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    cfg = tsl.ShearLayerConfig(res=(18, 14), collision="kbc")
    s, _ = tsl.init(cfg, "cpu")
    c = P.consts(cfg)
    got = {k: torch.empty_like(v) for k, v in s.items()}
    want = {k: torch.empty_like(v) for k, v in s.items()}
    kernels.reset_launches()
    P.periodic(s["f"], got, c)
    P.periodic_ref(s["f"], want, c)
    assert kernels.launches() == {k: 0 for k in kernels.KERNELS}
    for k in got:
        assert torch.equal(got[k], want[k])


def test_periodic_refuses_bad_tensors():
    cfg = tsl.ShearLayerConfig(res=(18, 14), collision="mrt")
    s, _ = tsl.init(cfg, "cpu")
    c = P.consts(cfg)
    out = {k: torch.empty_like(v) for k, v in s.items()}
    with pytest.raises(ValueError, match="dtype"):
        P.periodic(s["f"].double(), out, c)
    with pytest.raises(ValueError, match="contiguous"):
        P.periodic(s["f"].transpose(1, 2).contiguous().transpose(1, 2), out, c)
    with pytest.raises(ValueError, match="shape"):
        P.periodic(s["f"][:, :-1], out, c)
    with pytest.raises(ValueError, match="apart"):
        P.periodic(s["f"], dict(out, f=s["f"]), c)
    with pytest.raises(ValueError, match="grid"):
        P.periodic(s["f"][:, :1], out, P.consts(tsl.ShearLayerConfig(res=(1, 14))))
    with pytest.raises(ValueError, match="bgk/mrt/kbc"):
        P.consts(tsl.ShearLayerConfig(collision="lbm"))


# --- the package's re-exports: the JAX package's names ---

def _jax_all(rel: str):
    """The ``__all__`` list of a module of the JAX package, read with ``ast``
    from its source (nothing of it imported)."""
    import ast
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "jrl_lbm_tpu" / rel
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__"
                                                for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    raise AssertionError(f"{path} has no __all__")


@pytest.mark.parametrize("rel,mod", [("__init__.py", "jrl_lbm_torch"),
                                     ("ops/__init__.py", "jrl_lbm_torch.ops"),
                                     ("models/__init__.py", "jrl_lbm_torch.models")])
def test_package_exports_the_jax_packages_names(rel, mod):
    """The port's package, ops and models export every name of the JAX
    package's ``__all__`` at the same place, and list it in their own."""
    import importlib

    m = importlib.import_module(mod)
    names = _jax_all(rel)
    assert names and all(hasattr(m, n) for n in names), [n for n in names if not hasattr(m, n)]
    assert set(names) <= set(m.__all__)


def test_package_names_reach_the_operators():
    """One call through the package name: ``jrl_lbm_torch.ops.feq`` is
    ``ops.equilibrium.feq``, on the same inputs the same values; the scene
    modules and the lattice after ``import jrl_lbm_torch.models``."""
    import jrl_lbm_torch
    import jrl_lbm_torch.models
    import jrl_lbm_torch.ops
    from jrl_lbm_torch.ops import equilibrium, feq

    rng = np.random.default_rng(19)
    rho = torch.as_tensor(1.0 + 0.1 * rng.standard_normal((6, 5)), dtype=torch.float32)
    vel = torch.as_tensor(0.05 * rng.standard_normal((2, 6, 5)), dtype=torch.float32)
    assert feq is equilibrium.feq
    assert torch.equal(jrl_lbm_torch.ops.feq(rho, vel), equilibrium.feq(rho, vel))
    assert callable(jrl_lbm_torch.models.jrl.pick_fluid_runner)
    assert jrl_lbm_torch.lattice.Q == 9
