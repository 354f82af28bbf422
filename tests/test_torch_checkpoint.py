"""Checkpoints of the port (`utils/checkpoint.py`) on the CPU: the three
scenes round-trip and a resumed run equals an unbroken one bit for bit
(as `tests/test_metrics_checkpoint.py` holds the JAX package), dtypes
round-trip, files cross between the two packages in both directions, and
a bfloat16 tensor is refused as the JAX package's `load_state` refuses
it. Inputs come from numpy with a seed; arrays compare exactly.
About 5 s on one worker.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from jrl_lbm_tpu.utils import checkpoint as jckpt
from jrl_lbm_torch.models import cylinder as tcyl
from jrl_lbm_torch.models import jrl as tjrl
from jrl_lbm_torch.models import shear_layer as tsl
from jrl_lbm_torch.utils import checkpoint as ckpt


def _scene(name):
    """``(state, step(state, n, start) -> state)`` of a scene at small size,
    through the runner its entry point takes on the CPU."""
    if name == "shear 16x16":
        cfg = tsl.ShearLayerConfig(res=(16, 16))
        state, fields = tsl.init(cfg, "cpu")
        run = tsl.make_runner(cfg)
        return state, lambda s, n, start: run(s, fields, n)
    if name == "cylinder 64x32":
        cfg = tcyl.CylinderConfig(res=(64, 32), D=8.0, Re=500.0, cylinder_center=(16.0, 32.0))
        state, fields = tcyl.init(cfg, "cpu")
        run = tcyl.make_runner(cfg)
        return state, lambda s, n, start: run(s, fields, n)
    if name == "jrl fluid 48x32":
        cfg = tjrl.JRLFluidConfig(res=(48, 32), Re=4.0, vel_obs_real=0.2848,
                                  gravity_strength_real=0.0)
        state, fields = tjrl.fluid_init(cfg, "cpu")
        run = tjrl.pick_fluid_runner(cfg)
        return state, lambda s, n, start: run(s, fields, start, n)
    cfg = tjrl.JRLCConfig(res=(48, 32), Re=4.0, Pe=5.0, vel_obs_real=0.2848)
    state, fields, flags = tjrl.c_init(cfg, "cpu")
    run = tjrl.pick_balance_runner(cfg, flags)
    return state, lambda s, n, start: run(s, fields, n)


@pytest.mark.parametrize("name", ["shear 16x16", "cylinder 64x32", "jrl fluid 48x32",
                                  "jrl C 48x32"])
def test_round_trip_and_resume_bit_for_bit(name, tmp_path):
    state0, run = _scene(name)
    state = run(state0, 10, 0)
    path = str(tmp_path / "state.h5")
    ckpt.save_state(path, state, step=10, scene=name)
    assert not (tmp_path / "state.h5.tmp").exists()
    state2, step, extra = ckpt.load_state(path, device="cpu")
    assert step == 10 and extra["scene"] == name
    assert sorted(state2) == sorted(state)
    for k in state:
        assert state2[k].dtype == state[k].dtype and state2[k].device.type == "cpu"
        assert torch.equal(state2[k], state[k]), k
    unbroken = run(state0, 22, 0)
    resumed = run(state2, 12, step)
    for k in unbroken:
        assert torch.equal(resumed[k], unbroken[k]), k


def test_dtypes_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    state = {"f32": torch.as_tensor(rng.normal(size=(3, 4)).astype(np.float32)),
             "f64": torch.as_tensor(rng.normal(size=(5,))),
             "flags": torch.as_tensor(rng.integers(0, 32, size=(4, 6)).astype(np.int32)),
             "i64": torch.arange(7),
             "mask": torch.as_tensor(rng.uniform(size=(3,)) > 0.5),
             "scalar": torch.tensor(2.5),
             "numpy": rng.uniform(size=(2, 2)).astype(np.float32)}
    path = str(tmp_path / "d.h5")
    ckpt.save_state(path, state, step=3, tau=0.75)
    got, step, extra = ckpt.load_state(path, device="cpu")
    assert step == 3 and float(extra["tau"]) == 0.75
    for k, v in state.items():
        v = torch.as_tensor(v)
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k


def _mixed_state(seed):
    rng = np.random.default_rng(seed)
    return {"f": rng.uniform(size=(9, 6, 5)).astype(np.float32),
            "vel": rng.normal(size=(2, 6, 5)).astype(np.float32),
            "flags": rng.integers(0, 32, size=(6, 5)).astype(np.int32)}


def test_jax_file_loads_in_port(tmp_path):
    arrays = _mixed_state(1)
    path = str(tmp_path / "jax.h5")
    jckpt.save_state(path, {k: jnp.asarray(v) for k, v in arrays.items()}, step=42,
                     scene="cylinder", Re=5000.0)
    state, step, extra = ckpt.load_state(path, device="cpu")
    jstate, jstep, jextra = jckpt.load_state(path)
    assert step == jstep == 42 and extra == jextra
    for k, v in arrays.items():
        assert state[k].dtype == torch.from_numpy(v).dtype
        np.testing.assert_array_equal(state[k].numpy(), v)
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(jstate[k]))


def test_port_file_loads_in_jax(tmp_path):
    arrays = _mixed_state(2)
    path = str(tmp_path / "port.h5")
    ckpt.save_state(path, {k: torch.as_tensor(v) for k, v in arrays.items()}, step=7,
                    scene="shear")
    jstate, step, extra = jckpt.load_state(path)
    assert step == 7 and extra["scene"] == "shear"
    for k, v in arrays.items():
        assert np.asarray(jstate[k]).dtype == v.dtype
        np.testing.assert_array_equal(np.asarray(jstate[k]), v)


def test_bfloat16_is_refused_as_jax_refuses_it(tmp_path):
    """JAX's `save_state` writes a bfloat16 leaf as opaque 2-byte records
    that its own `load_state` cannot read; the port refuses the tensor
    before writing, and refuses such a file, naming the key."""
    f = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    path = tmp_path / "bf.h5"
    with pytest.raises(TypeError, match="'f'"):
        ckpt.save_state(str(path), {"rho": f, "f": f.to(torch.bfloat16)}, step=1)
    assert not path.exists() and not (tmp_path / "bf.h5.tmp").exists()

    jckpt.save_state(str(path), {"f": jnp.asarray(f.numpy()).astype(jnp.bfloat16)}, step=1)
    with pytest.raises(TypeError):
        jckpt.load_state(str(path))
    with pytest.raises(TypeError, match="'f'"):
        ckpt.load_state(str(path), device="cpu")


def test_load_state_defaults_to_the_card(tmp_path):
    path = str(tmp_path / "s.h5")
    ckpt.save_state(path, {"f": torch.zeros(2)})
    if torch.cuda.is_available():
        assert ckpt.load_state(path)[0]["f"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ckpt.load_state(path)
