"""The port's sharded JRL runners (`jrl_lbm_torch/kernels/jrl_sharded.py`)
against the JAX package's unfused jnp steps, case for case as
`tests/test_fused_jrl_sharded.py` holds JAX's sharded kernels, at its
sizes and tolerances (f, rho, C, h 2e-5; vel 2e-4; integrals rtol 2e-4 /
atol 1e-4), and against the port's own unsharded per-step runners bit for
bit (the integrals at the same tolerance: summed per shard, in another
order).

The shards of a local mesh are CPU tensors, so every wrapper runs its
plain twin. Inputs come from the JAX init plus seeded numpy noise,
through `state_from_numpy`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from jrl_lbm_tpu.models import jrl
from jrl_lbm_torch.kernels import jrl_sharded as S
from jrl_lbm_torch.models import jrl as T
from jrl_lbm_torch.parallel.mesh import make_mesh
from jrl_lbm_torch.utils.device import state_from_numpy

TOL = {"f": 2e-5, "rho": 2e-5, "vel": 2e-4, "C": 2e-5, "h": 2e-5}
ACC_KEYS = ("inflow_sum", "current_sum", "count", "rec_u", "rec_v")


def _mesh(shape):
    return make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))


def _noisy(state, seed, scale=1e-4):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v) + (scale * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in state.items()}


def _close(got, want, tag):
    for k, tol in TOL.items():
        if k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=tol, atol=tol,
                                       err_msg=f"{tag} {k}")


def _equal(got, want, tag):
    for k in want:
        assert torch.equal(got[k], want[k]), f"{tag} {k}"


def _fluid_cfgs(res, shape):
    kw = dict(res=res, Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8, shape=shape)
    return jrl.JRLFluidConfig(**kw), T.JRLFluidConfig(**kw)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (3, 1), (2, 2)])
def test_sharded_fluid_matches_jnp_and_unsharded(mesh_shape):
    """12 steps at 48x32 (the tip crosses a row): the jnp step at 2e-5 (vel
    2e-4), the port's per-step runner bit for bit. (2, 2): the tip (rg =
    26 of W = 32) straddles the x shard boundary."""
    cj, ct = _fluid_cfgs((48, 32), "45degree")
    n = 12
    state, fields = jrl.fluid_init(cj)
    state = _noisy(state, 1)
    step = jrl.make_fluid_step(cj)
    ref = {k: jnp.asarray(v) for k, v in state.items()}
    for i in range(n):
        ref = step(ref, fields, jnp.asarray(i, jnp.int32))
    s = state_from_numpy(state, "cpu")
    fl = T.fluid_init(ct, "cpu")[1]
    out = S.make_sharded_tiled_fluid_runner(ct, _mesh(mesh_shape), tile_rows=8, unroll=4)(
        s, fl, 0, n)
    _close(out, jax.tree.map(np.asarray, ref), f"fluid {mesh_shape}")
    _equal(out, T.make_per_step_fluid_runner(ct)(s, fl, 0, n), f"fluid {mesh_shape}")


def test_sharded_fluid_lean_split_exact():
    """(4, 1) over 96x32 with a flat tip, through the A/B pair
    (``route="launches"``; the pass's lean shards are in
    `test_torch_fluid_pass_sh.py`): the two middle shards sit above the tip
    and run the lean twins; the result is exact against ``lean_split=False``
    and against the unsharded runner."""
    _, ct = _fluid_cfgs((96, 32), "cylinder")
    s, fl = T.fluid_init(ct, "cpu")
    s = state_from_numpy(_noisy(s, 2), "cpu")
    mesh = _mesh((4, 1))
    lean = S.make_sharded_tiled_fluid_runner(ct, mesh, tile_rows=8, unroll=3, route="launches")
    a = lean(s, fl, 0, 6)
    b = S.make_sharded_tiled_fluid_runner(ct, mesh, tile_rows=8, unroll=3, lean_split=False,
                                          route="launches")(s, fl, 0, 6)
    assert lean.lean_steps == {(0, 0): 0, (1, 0): 6, (2, 0): 6, (3, 0): 0}
    _equal(a, b, "lean vs full")
    _equal(a, T.make_per_step_fluid_runner(ct)(s, fl, 0, 6), "lean vs unsharded")


@pytest.mark.parametrize(
    "mesh_shape,route",
    [
        pytest.param((2, 1), "launches", id="mesh_shape0"),
        pytest.param((2, 2), "launches", id="mesh_shape1"),
        # the row meshes' default route: k-step passes (c_balance_pass_sh)
        pytest.param((2, 1), None, id="mesh_shape0-pass"),
        pytest.param((4, 1), None, id="mesh_shape2-pass"),
    ],
)
def test_sharded_balance_matches_jnp_and_unsharded(mesh_shape, route):
    """12 steps through ``route`` (None: the mesh's default, the pass on a
    row mesh): the jnp runner at 2e-5, the port's per-step runner bit for
    bit."""
    kw = dict(res=(48, 32), Re=4.0, Pe=5.0, shape="45degree")
    cj, ct = jrl.JRLCConfig(**kw), T.JRLCConfig(**kw)
    state, fields, flags = jrl.c_init(cj)
    state = _noisy(state, 3)
    ref = jrl.make_balance_runner(cj, flags)({k: jnp.asarray(v) for k, v in state.items()},
                                             fields, 12)
    st = state_from_numpy(state, "cpu")
    _, cf, fl_t = T.c_init(ct, "cpu")
    assert torch.equal(fl_t, torch.as_tensor(np.array(flags)))
    run = S.make_sharded_tiled_balance_runner(ct, fl_t, _mesh(mesh_shape),
                                              tile_rows=8 if mesh_shape[0] < 4 else 4, unroll=4,
                                              route=route)
    assert run.route == (route or "pass")
    out = run(st, cf, 12)
    _close(out, jax.tree.map(np.asarray, ref), f"balance {mesh_shape}")
    _equal(out, T.make_per_step_balance_runner(ct, fl_t)(st, cf, 12), f"balance {mesh_shape}")


@pytest.mark.parametrize(
    "shape,mesh_shape,route",
    [
        # plain disk integrals, the whole disk in shard 0
        pytest.param("45degree", (2, 1), "launches", id="45degree-mesh_shape0"),
        # flat flux form; shard rows 16/32 near the tip rows
        pytest.param("cylinder", (3, 1), "launches", id="cylinder-mesh_shape1"),
        # the tip block (rg = 26) straddles the x boundary
        pytest.param("cylinder", (2, 2), "launches", id="cylinder-mesh_shape2"),
        # w = 4: the tip disk (rint = 7) spans two x shards
        pytest.param("cylinder", (1, 8), "launches", id="cylinder-mesh_shape3"),
        pytest.param("45degree", (2, 2), "launches", id="45degree-mesh_shape4"),
        # the row meshes' default route: k-step passes (c_approach_pass_sh)
        pytest.param("45degree", (2, 1), None, id="45degree-mesh_shape0-pass"),
        pytest.param("cylinder", (3, 1), None, id="cylinder-mesh_shape1-pass"),
    ],
)
def test_sharded_approach_matches_jnp_and_unsharded(shape, mesh_shape, route):
    """10 steps across stored-velocity frames through ``route`` (None: the
    mesh's default, the pass on a row mesh): the jnp runner at 2e-5 and its
    integrals at rtol 2e-4 / atol 1e-4; the port's per-step runner, h and C
    bit for bit."""
    kw = dict(res=(48, 32), Re=4.0, Pe=5.0, shape=shape)
    cj, ct = jrl.JRLCConfig(**kw), T.JRLCConfig(**kw)
    state, fields, _ = jrl.c_init(cj)
    state = _noisy(state, 4)
    vf = np.random.default_rng(11).uniform(-0.5, 0.5, size=(4, 2, 48, 32)).astype(np.float32)
    ref_state, ref_acc = jrl.make_approach_runner(cj)(
        {k: jnp.asarray(v) for k, v in state.items()}, dict(fields, vel_field=jnp.asarray(vf)),
        jnp.asarray(0, jnp.int32), 10)
    st = state_from_numpy(state, "cpu")
    cf = T.c_init(ct, "cpu")[1]
    vft = torch.as_tensor(vf)
    run = S.make_sharded_tiled_approach_runner(ct, vft, _mesh(mesh_shape), tile_rows=8,
                                               unroll=4, route=route)
    assert run.route == (route or "pass")
    out, acc = run(st, cf, 0, 10)
    _close(out, jax.tree.map(np.asarray, ref_state), f"approach {shape} {mesh_shape}")
    un, un_acc = T.make_per_step_approach_runner(ct, vft)(st, cf, 0, 10)
    _equal(out, un, f"approach {shape} {mesh_shape}")
    for key in ACC_KEYS:
        for want in (float(np.asarray(ref_acc[key])), float(un_acc[key])):
            np.testing.assert_allclose(float(acc[key]), want, rtol=2e-4, atol=1e-4,
                                       err_msg=f"{shape}:{key}")


def test_sharded_runners_check_their_arguments():
    """The JAX runners' checks: H % ny, W % nx, x_ext >= 2 lanes after
    min(x_ext, w), tile_rows dividing the shard height; and the tip disk
    inside the tip and the grid for the approach."""
    _, ct = _fluid_cfgs((48, 32), "45degree")
    cc = T.JRLCConfig(res=(48, 32), Re=4.0, Pe=5.0, shape="cylinder")
    with pytest.raises(ValueError, match="H=48 not divisible by ny=5"):
        S.make_sharded_tiled_fluid_runner(ct, _mesh((5, 1)))
    with pytest.raises(ValueError, match="W=32 not divisible by nx=3"):
        S.make_sharded_tiled_fluid_runner(ct, _mesh((1, 3)))
    with pytest.raises(ValueError, match="x_ext >= 2"):
        S.make_sharded_tiled_balance_runner(cc, None, _mesh((1, 8)), x_ext=1)
    with pytest.raises(ValueError, match="tile_rows=5"):
        S.make_sharded_tiled_fluid_runner(ct, _mesh((2, 1)), tile_rows=5)
    with pytest.raises(ValueError, match="not tileable"):
        S.make_sharded_tiled_fluid_runner(T.JRLFluidConfig(res=(44, 32)), _mesh((1, 1)))
    with pytest.raises(ValueError, match="unroll"):
        S.make_sharded_tiled_fluid_runner(ct, _mesh((2, 1)), unroll=0)
    wide = T.JRLCConfig(res=(48, 32), Re=4.0, Pe=5.0, shape="cylinder", Rg=1.0)
    with pytest.raises(ValueError, match="rint"):
        S.make_sharded_tiled_approach_runner(wide, torch.zeros(1, 2, 48, 32), _mesh((2, 1)))
    assert S.make_sharded_tiled_fluid_runner(ct, _mesh((1, 8)), x_ext=2).shards[1].col0 == 4
