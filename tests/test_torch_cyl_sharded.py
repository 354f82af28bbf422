"""The port's sharded cylinder channel (`jrl_lbm_torch/kernels/
cyl_sharded.py`) on local meshes of CPU shards, where every wrapper runs
its plain twin: against the JAX package's jnp step case for case as
`tests/test_parallel.py` holds JAX's sharded kernels, at its sizes and
tolerances (non-OBSTACLE cells; f, rho 2e-5, vel 2e-4), against the
port's own unsharded runner bit for bit on the full-boundary routes, and
the route choice, the x modes and the argument checks. Inputs come from
the JAX init through `state_from_numpy`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)
from jax.sharding import PartitionSpec as PS

from jrl_lbm_tpu.models import cylinder as cyl
from jrl_lbm_tpu.ops.pallas import fused_sharded as fsh
from jrl_lbm_tpu.parallel import make_mesh as jmake_mesh
from jrl_lbm_tpu.parallel import mesh as jmesh
from jrl_lbm_tpu.parallel.sharded import shard_state
from jrl_lbm_torch.kernels import cyl_sharded as CS
from jrl_lbm_torch.kernels import cylinder as K
from jrl_lbm_torch.kernels import halo as HA
from jrl_lbm_torch.models import cylinder as TC
from jrl_lbm_torch.parallel.mesh import make_mesh, split
from jrl_lbm_torch.utils.device import state_from_numpy
from jrl_lbm_torch.utils.types import CellType

TOL = (("f", 2e-5), ("rho", 2e-5), ("vel", 2e-4))


def _mesh(shape):
    return make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))


@functools.lru_cache(maxsize=None)
def _scene(res, cy=16.0, cx=16.0):
    kw = dict(res=res, D=7.4, Re=500.0, cylinder_center=(cx, cy))
    cj = cyl.CylinderConfig(**kw)
    state, fields = cyl.init(cj)
    return cj, TC.CylinderConfig(**kw), state, fields


def _port(state, fields):
    s = state_from_numpy({k: state[k] for k in ("f", "rho", "vel")}, "cpu")
    f = state_from_numpy({k: fields[k] for k in ("flags", "phi_obs")}, "cpu")
    return s, f


@functools.lru_cache(maxsize=None)
def _jnp_ref(res, cy, cx, n):
    cj, _, state, fields = _scene(res, cy, cx)
    return jax.tree.map(np.asarray, cyl.make_runner(cj)(state, fields, n))


def _close_fluid(out, ref, flags, tag):
    fluid = np.asarray(flags) != int(CellType.OBSTACLE)
    for key, tol in TOL:
        a, b = out[key].numpy(), np.asarray(ref[key])
        mask = fluid if a.ndim == 2 else np.broadcast_to(fluid, a.shape)
        np.testing.assert_allclose(a[mask], b[mask], rtol=tol, atol=tol, err_msg=f"{tag} {key}")


def _equal(got, want, tag):
    for k in ("f", "rho", "vel"):
        assert torch.equal(got[k], want[k]), f"{tag} {k}"


@pytest.mark.parametrize("kw,route", [
    (dict(), "lean"),  # test_parallel.py:249: the defaults pick the lean split here
    (dict(tile_rows=8), "lean"),  # test_parallel.py:284
    (dict(lean_split=False, tile_rows=None), "padded"),
    (dict(lean_split=False, tile_rows=8), "pieces"),
])
def test_sharded_fused_cylinder_matches_unsharded(kw, route):
    """(2, 4) at 48x32, 6 steps: JAX's jnp step on non-OBSTACLE cells;
    the full-boundary routes equal the port's unsharded ``split=False``
    runner (``cyl_full`` on every row) bit for bit, all cells."""
    cj, ct, state, fields = _scene((48, 32))
    s, fl = _port(state, fields)
    run = CS.make_sharded_fused_cylinder_runner(ct, _mesh((2, 4)), **kw)
    assert run.stepk.route == route
    out = run(s, fl, 6)
    _close_fluid(out, _jnp_ref((48, 32), 16.0, 16.0, 6), fields["flags"], route)
    if route != "lean":
        _equal(out, K.make_fused_cylinder_runner(ct, split=False)(s, fl, 6), route)


@pytest.mark.parametrize("route", ["pass", "launches"])
@pytest.mark.parametrize("mesh_shape,cy,k,x_ext", [
    ((2, 4), 24.0, 1, 0),
    ((2, 1), 24.0, 1, 0),
    ((2, 4), 48.0, 1, 0),
    ((2, 1), 24.0, 2, 0),
    ((2, 1), 48.0, 2, 0),
    ((2, 4), 24.0, 2, 8),
    ((2, 4), 48.0, 2, 8),
    ((2, 2), 24.0, 1, 8),
    ((2, 4), 48.0, 2, 16),
])
def test_sharded_fused_lean_split_matches_unsharded(mesh_shape, cy, k, x_ext, route):
    """The lean split (`tests/test_parallel.py:318-356`, all nine cases):
    6 or 7 steps (k-passes and the trailing single steps) against JAX's
    jnp step on non-OBSTACLE cells; every shard owns one y border. Through
    each route: one `cyl_pass_sh` a shard and pass, or the two launches."""
    ny, nx = mesh_shape
    W = 32 * nx
    cj, ct, state, fields = _scene((96, W), cy, W / 2.0)
    regions = CS._fix_regions(ct, margin=4.0 + (k - 1))
    assert regions == fsh._fix_regions(cj, margin=4.0 + (k - 1))
    if k == 1:
        assert regions == ([(16, 32)] if cy == 24.0 else [(40, 56)])
    n = 6 if k == 1 else 7
    s, fl = _port(state, fields)
    run = CS.make_sharded_fused_cylinder_runner(ct, _mesh(mesh_shape), lean_split=True,
                                                lean_k=k, lean_x_ext=x_ext or None, route=route)
    assert run.stepk.route == "lean" and run.stepk.k == k and run.stepk.lean_route == route
    out = run(s, fl, n)
    _close_fluid(out, _jnp_ref((96, W), cy, W / 2.0, n), fields["flags"], f"{mesh_shape} k={k}")


@pytest.mark.parametrize("route", ["pass", "launches"])
def test_lean_k1_f_equals_the_unsharded_split_step(route):
    """k = 1: the lean pass with the window (one `cyl_pass_sh` a shard, or
    the two launches) gives f of the unsharded split step
    (``cyl_interior`` + ``cyl_full``) bit for bit on every cell, and rho,
    vel on every non-OBSTACLE cell (the lean walls keep cfg.density and
    velocity 0 where ``cyl_full`` passes the incoming values)."""
    _, ct, state, fields = _scene((96, 128), 24.0, 64.0)
    s, fl = _port(state, fields)
    got = CS.make_sharded_fused_cylinder_runner(ct, _mesh((2, 4)), lean_split=True,
                                                route=route)(s, fl, 3)
    step = K.make_fused_step(ct, tile_rows=8, interior_rows=16)
    assert step.split
    want = s
    for _ in range(3):
        want = step(want, fl)
    assert torch.equal(got["f"], want["f"])
    fluid = fl["flags"] != int(CellType.OBSTACLE)
    assert torch.equal(got["rho"][fluid], want["rho"][fluid])
    assert torch.equal(got["vel"][:, fluid], want["vel"][:, fluid])


@pytest.mark.parametrize("mesh_shape,k,modes", [
    ((2, 4), 2, (dict(lean_x_ext=8), dict(lean_x_ext=8, lean_x_halo=8),
                 dict(lean_x_ext=16, lean_x_halo=4))),
    ((2, 4), 1, (dict(), dict(lean_x_ext=8), dict(lean_x_ext=8, lean_x_halo=3))),
    ((2, 1), 2, (dict(), dict(lean_x_whole=True), dict(lean_x_ext=8))),
])
def test_lean_x_modes_give_one_result(mesh_shape, k, modes):
    """The x mode the arguments select (whole-width, column-patched,
    extended window at any x_halo) changes the bytes exchanged, not the
    result: bit for bit."""
    nx = mesh_shape[1]
    _, ct, state, fields = _scene((96, 32 * nx), 48.0, 16.0 * nx)
    s, fl = _port(state, fields)
    outs = [CS.make_sharded_fused_cylinder_runner(ct, _mesh(mesh_shape), lean_split=True,
                                                  lean_k=k, **m)(s, fl, 2 * k + 1)
            for m in modes]
    for m, o in zip(modes[1:], outs[1:]):
        _equal(o, outs[0], str(m))


@pytest.mark.parametrize("kw", [dict(lean_split=True, lean_k=2, lean_x_ext=8),
                                dict(lean_split=True, lean_k=3),
                                dict(lean_split=False, tile_rows=8)])
def test_halo_reach(monkeypatch, kw):
    """The pieces reach every cell the shard's update reads: with NaN
    beyond them in the embedded twins the result is finite and unchanged."""
    mesh_shape = (2, 4) if kw.get("lean_x_ext") or not kw["lean_split"] else (2, 1)
    nx = mesh_shape[1]
    _, ct, state, fields = _scene((96, 32 * nx), 48.0, 16.0 * nx)
    s, fl = _port(state, fields)
    run = CS.make_sharded_fused_cylinder_runner(ct, _mesh(mesh_shape), **kw)
    want = run(s, fl, 4)
    monkeypatch.setattr(CS, "_embed", functools.partial(CS._embed, fill=float("nan")))
    got = run(s, fl, 4)
    for x in got.values():
        assert torch.isfinite(x).all()
    _equal(got, want, str(kw))


def test_argument_checks():
    """The JAX function's checks (`fused_sharded.py:1136-1182`), raised as
    ValueError; ``lean_ok`` picks the same route as in JAX."""
    _, ct, _, _ = _scene((96, 128), 24.0, 64.0)
    m24, m21 = _mesh((2, 4)), _mesh((2, 1))
    mk = functools.partial(CS.make_sharded_fused_cylinder_step, ct)
    with pytest.raises(ValueError, match="lean_k"):
        mk(m24, lean_k=9)
    with pytest.raises(ValueError, match="mutually exclusive"):
        mk(m24, lean_x_ext=8, lean_x_whole=True)
    with pytest.raises(ValueError, match="lean_k <= x_halo <= x_ext"):
        mk(m24, lean_k=4, lean_x_ext=8, lean_x_halo=2)
    with pytest.raises(ValueError, match="lean_split needs"):
        mk(m24, lean_split=True, lean_k=2, lean_x_ext=0)  # k > 1 on nx > 1 without x_ext
    with pytest.raises(ValueError, match="lean_split needs"):
        mk(m24, lean_split=True, lean_k=1, lean_x_whole=True)
    with pytest.raises(ValueError, match="tile_rows=12"):
        mk(m24, lean_split=False, tile_rows=12)
    with pytest.raises(ValueError, match="grid must tile"):
        mk(_mesh((5, 1)))
    with pytest.raises(ValueError, match="at least 3"):
        CS.make_sharded_fused_cylinder_step(_scene((96, 8), 24.0, 4.0)[1], _mesh((1, 4)))
    # the routes of the defaults, as JAX picks them
    assert mk(m24).route == "lean" and mk(m24, lean_split=False).route == "padded"
    assert mk(m21, lean_split=False, tile_rows=16).route == "pieces"
    assert mk(m21, lean_k=4).k == 4
    assert mk(m24, lean_k=4).route == "padded"  # x_ext 128 > w = 32: not eligible
    # the k-step lean split refuses a border the tiles cannot be exact on
    c2, st2, fl2 = _scene((96, 32), 24.0, 16.0)[1:]
    s, fl = _port(st2, fl2)
    fl = dict(fl, flags=fl["flags"].clone())
    fl["flags"][:, 0] = int(CellType.FLUID)
    with pytest.raises(ValueError, match="border"):
        CS.make_sharded_fused_cylinder_runner(c2, m21, lean_k=2)(s, fl, 2)


def test_halo_pack_k_rows_match_jax_halo_pieces():
    """``halo_pack``'s k-row phase + ppermute equals the rows of JAX's
    ``_halo_pieces(rows=k)``; the 14-plane group with int32 flags as the
    float32 view of their bits arrives exactly."""
    rng = np.random.default_rng(9)
    H, W, shape, k = 32, 16, (2, 2), 3
    x = rng.standard_normal((13, H, W)).astype(np.float32)
    fl = rng.integers(0, 40, (H, W)).astype(np.int32)
    jm = jmesh.make_mesh(shape, devices=jax.devices()[:4])
    spec = PS(None, jmesh.AXIS_Y, jmesh.AXIS_X)
    jt, jb = jax.jit(jax.shard_map(
        lambda a: fsh._halo_pieces(a, jmesh.AXIS_Y, jmesh.AXIS_X, cols=False, rows=k)[:2],
        mesh=jm, in_specs=spec, out_specs=(spec, spec), check_vma=False))(jnp.asarray(x))
    pm = _mesh(shape)
    xs, fls = split(torch.as_tensor(x), pm), split(torch.as_tensor(fl), pm)
    groups = [[b.view(torch.float32), a] for a, b in zip(xs, fls)]
    pieces = HA.row_pieces(groups, pm, rows=k)
    jt, jb = np.asarray(jt), np.asarray(jb)
    for (iy, ix), (t, b) in zip(pm.local, pieces):
        cs = slice(ix * 8, ix * 8 + 8)
        np.testing.assert_array_equal(t[1:].numpy(), jt[:, iy * k:(iy + 1) * k, cs])
        np.testing.assert_array_equal(b[1:].numpy(), jb[:, iy * k:(iy + 1) * k, cs])
        want_t = fl[np.arange(iy * 16 - k, iy * 16) % H][:, cs]
        np.testing.assert_array_equal(t[0].view(torch.int32).numpy(), want_t)


def test_edge_cols_interpreted_matches_halo_pack_twin():
    """JAX's ``_edge_cols`` (interpreted Pallas) equals ``halo_pack``'s
    one-lane columns phase (its body rows; the end rows hold the pieces)."""
    rng = np.random.default_rng(3)
    for shape in [(9, 16, 32), (12, 24, 128)]:
        x = rng.normal(size=shape).astype(np.float32)
        cl, cr = fsh._edge_cols(jnp.asarray(x), interpret=True)
        lf, rt = HA.halo_pack([torch.as_tensor(x)], xh=1)
        np.testing.assert_array_equal(lf[:, 1:-1].numpy(), np.asarray(cl))
        np.testing.assert_array_equal(rt[:, 1:-1].numpy(), np.asarray(cr))
        assert not lf[:, [0, -1]].any()


def test_padded_route_matches_interpreted_pallas():
    """PADDED (2, 4), 6 steps, against JAX's ``_padded_block_step`` run
    interpreted on the 8 virtual CPU devices (lean_split=False, one tile
    per shard), every cell (both keep OBSTACLE rho)."""
    cj, ct, state, fields = _scene((48, 32))
    jm = jmake_mesh((2, 4))
    ss, sf = shard_state(state, fields, jm)
    ref = jax.tree.map(np.asarray, fsh.make_sharded_fused_cylinder_runner(
        cj, jm, interpret=True, lean_split=False, tile_rows=None)(ss, sf, 6))
    s, fl = _port(state, fields)
    out = CS.make_sharded_fused_cylinder_runner(ct, _mesh((2, 4)), lean_split=False,
                                                tile_rows=None)(s, fl, 6)
    for key, tol in TOL:
        np.testing.assert_allclose(out[key].numpy(), ref[key], rtol=tol, atol=tol, err_msg=key)
