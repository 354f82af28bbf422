"""The sharded C phases' k-step passes (`kernels/jrl_sharded.py::
c_balance_pass_sh`, `c_approach_pass_sh`; `csrc/c_balance_pass_sh.cu`,
`csrc/c_approach_pass_sh.cu`) and the row-mesh route of the sharded
balance and approach runners on the CPU, where the wrappers run their
plain twins: the runners through the passes at k = 1..4 on the (2, 1),
(3, 1) and (4, 1) meshes against ``route="launches"`` bit for bit (h, C
and the four integrals) and against the JAX package's jnp runners; the
halo proof (each shard's pass from a grid that is NaN beyond its 2k-row
pieces); the disk rows across a shard boundary with passes that end inside
an ``unroll`` chunk; the host plan of a launch; the route and depth
checks. The kernels against k per-step launches, on a card, are in
`test_torch_cuda.py`.

Inputs come from the JAX init plus seeded numpy noise at 48x32 (the grid
of `tests/test_torch_jrl_sharded.py`). Tolerances: the jnp runners h and C
2e-5, the integrals rtol 2e-4 / atol 1e-4 (the per-shard disk sums add in
another order); the port's routes, twins and per-step runners against each
other bit for bit (they share the arithmetic of the port's whole-grid step
and sum the disk terms in the same order).
"""

import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrl_lbm_tpu.models import jrl as J
from jrl_lbm_torch.kernels import halo as HA
from jrl_lbm_torch.kernels import jrl_sharded as S
from jrl_lbm_torch.models import jrl as T
from jrl_lbm_torch.parallel.mesh import make_mesh, split
from jrl_lbm_torch.utils.device import state_from_numpy

RES = (48, 32)
TOL = 2e-5
ACC_KEYS = ("inflow_sum", "current_sum", "count", "rec_u", "rec_v")
MESHES = [(2, 1), (3, 1), (4, 1)]
N_BAL, N_APP, UNROLL = 11, 10, 4  # steps: no multiple of k = 2, 3, 4


def _mesh(shape):
    return make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))


@functools.lru_cache(maxsize=None)
def _case(shape):
    """``(jax cfg, torch cfg, numpy state, torch state, torch fields, torch
    flags, frames)``: the JAX init plus seeded noise, and 32 stored
    frames (the tip travels one frame a step: steps 0 .. 30 lerp)."""
    kw = dict(res=RES, Re=4.0, Pe=5.0, shape=shape)
    cj, ct = J.JRLCConfig(**kw), T.JRLCConfig(**kw)
    state, _, _ = J.c_init(cj)
    rng = np.random.default_rng(20)
    state = {k: (np.asarray(v) + 1e-4 * rng.standard_normal(np.shape(v))).astype(np.float32)
             for k, v in state.items()}
    _, cf, flags = T.c_init(ct, "cpu")
    vf = np.random.default_rng(21).uniform(-0.5, 0.5, size=(32, 2) + RES).astype(np.float32)
    return cj, ct, state, state_from_numpy(state, "cpu"), cf, flags, vf


@functools.lru_cache(maxsize=None)
def _jnp_balance(shape, n):
    cj, _, state, _, _, _, _ = _case(shape)
    _, fields, flags = J.c_init(cj)
    out = J.make_balance_runner(cj, flags)({k: jnp.asarray(v) for k, v in state.items()},
                                           fields, n)
    return {k: np.asarray(v) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _jnp_approach(shape, start, n):
    cj, _, state, _, _, _, vf = _case(shape)
    _, fields, _ = J.c_init(cj)
    out, acc = J.make_approach_runner(cj)(
        {k: jnp.asarray(v) for k, v in state.items()}, dict(fields, vel_field=jnp.asarray(vf)),
        jnp.asarray(start, jnp.int32), n)
    return {k: np.asarray(v) for k, v in out.items()}, {k: float(v) for k, v in acc.items()}


def _equal(got, want, tag):
    for k in want:
        assert torch.equal(got[k], want[k]), f"{tag} {k}"


def _close(got, want, tag):
    for k in ("h", "C"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=TOL, atol=TOL,
                                   err_msg=f"{tag} {k}")


def _ints_close(acc, want, tag):
    for key in ACC_KEYS:
        np.testing.assert_allclose(float(acc[key]), want[key], rtol=2e-4, atol=1e-4,
                                   err_msg=f"{tag} {key}")


# --- the runners through the passes ---

@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_balance_pass_route_matches_launches_and_jnp(mesh_shape, k):
    """11 balance steps at 48x32 (the wedge): one exchange of the 2k-row
    pieces of [h, C] and one `c_balance_pass_sh` a shard a pass (the rest
    at a smaller k), the flags' pieces once; bit for bit ``route=
    "launches"`` and the per-step runner, the jnp runner at 2e-5."""
    _, ct, _, st, cf, flags, _ = _case("45degree")
    mesh = _mesh(mesh_shape)
    run = S.make_sharded_tiled_balance_runner(ct, flags, mesh, tile_rows=4, k=k)
    assert (run.route, run.k) == ("pass", k)
    with mock.patch.object(S, "c_balance_pass_sh", wraps=S.c_balance_pass_sh) as bp, \
            mock.patch.object(S, "exchange", wraps=S.exchange) as ex, \
            mock.patch.object(S, "c_balance_sh", wraps=S.c_balance_sh) as per:
        got = run(st, cf, N_BAL)
    passes = -(-N_BAL // k)
    assert ex.call_count == passes + 1 and bp.call_count == passes * mesh_shape[0]
    assert not per.called
    assert [c.args[5] for c in bp.call_args_list[::mesh_shape[0]]] == \
        [k] * (N_BAL // k) + ([N_BAL % k] if N_BAL % k else [])
    _close(got, _jnp_balance("45degree", N_BAL), f"{mesh_shape} k={k}")
    launches = S.make_sharded_tiled_balance_runner(ct, flags, mesh, tile_rows=4,
                                                   route="launches")
    assert launches.route == "launches"
    _equal(got, launches(st, cf, N_BAL), f"{mesh_shape} k={k} launches")
    _equal(got, T.make_per_step_balance_runner(ct, flags)(st, cf, N_BAL), f"{mesh_shape} k={k}")


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("shape", ["45degree", "cylinder"])
def test_approach_pass_route_matches_launches_and_jnp(shape, mesh_shape, k):
    """10 approach steps at 48x32 across stored frames (the wedge's plain
    disk, the cylinder's flat flux form), ``unroll`` 4: passes end at the
    chunks' ends, one exchange of the 2k-row h pieces and one
    `c_approach_pass_sh` a shard a pass, no per-step lerp; h, C and the
    integrals bit for bit ``route="launches"``, h and C bit for bit the
    per-step runner, the jnp runner at 2e-5 (integrals rtol 2e-4 / atol
    1e-4)."""
    _, ct, _, st, cf, _, vf = _case(shape)
    vft = torch.as_tensor(vf)
    mesh = _mesh(mesh_shape)
    run = S.make_sharded_tiled_approach_runner(ct, vft, mesh, tile_rows=4, unroll=UNROLL, k=k)
    assert (run.route, run.k) == ("pass", k)
    with mock.patch.object(S, "c_approach_pass_sh", wraps=S.c_approach_pass_sh) as ap, \
            mock.patch.object(S, "c_approach_sh", wraps=S.c_approach_sh) as per, \
            mock.patch.object(T, "stored_velocity", wraps=T.stored_velocity) as lerp:
        got, acc = run(st, cf, 0, N_APP)
    chunks = [min(UNROLL, N_APP - s) for s in range(0, N_APP, UNROLL)]
    ks = [min(k, c - s) for c in chunks for s in range(0, c, k)]
    assert [c.args[6] for c in ap.call_args_list[::mesh_shape[0]]] == ks
    assert ap.call_count == len(ks) * mesh_shape[0] and not per.called
    # the only lerps are the twin's, on its embedded window (b0, the history's length)
    assert lerp.called and all(len(c.args) == 5 for c in lerp.call_args_list)
    want, want_acc = _jnp_approach(shape, 0, N_APP)
    _close(got, want, f"{shape} {mesh_shape} k={k}")
    _ints_close(acc, want_acc, f"{shape} {mesh_shape} k={k}")
    l_out, l_acc = S.make_sharded_tiled_approach_runner(ct, vft, mesh, tile_rows=4,
                                                        unroll=UNROLL, route="launches")(
        st, cf, 0, N_APP)
    _equal(got, l_out, f"{shape} {mesh_shape} k={k} launches")
    _equal(acc, l_acc, f"{shape} {mesh_shape} k={k} launches' integrals")
    _equal(got, T.make_per_step_approach_runner(ct, vft)(st, cf, 0, N_APP)[0],
           f"{shape} {mesh_shape} k={k} per-step")


@pytest.mark.parametrize("mesh_shape", [(2, 1), (4, 1)])
def test_disk_rows_across_a_shard_boundary(mesh_shape):
    """The flat tip from step 20 (disk rows 22-24 about the shard boundary
    at row 24) over 11 steps, ``unroll`` 4 and k = 3: passes of 3 and 1 a
    chunk, so passes end inside chunks; each step's disk terms come from
    the shards that own its rows. Bit for bit ``route="launches"`` (h, C,
    integrals), the jnp runner at 2e-5 (integrals rtol 2e-4 / atol 1e-4)."""
    _, ct, _, st, cf, _, vf = _case("cylinder")
    wi = T.tip_walks(ct.inflow_height, 20, ct.vel_obs_conv)[1]
    assert wi - 1 < 24 <= wi + 1
    vft = torch.as_tensor(vf)
    mesh = _mesh(mesh_shape)
    with mock.patch.object(S, "c_approach_pass_sh", wraps=S.c_approach_pass_sh) as ap:
        got, acc = S.make_sharded_tiled_approach_runner(ct, vft, mesh, tile_rows=4, unroll=4,
                                                        k=3)(st, cf, 20, 11)
    assert [(c.args[5], c.args[6]) for c in ap.call_args_list[::mesh_shape[0]]] == \
        [(20, 3), (23, 1), (24, 3), (27, 1), (28, 3)]
    l_out, l_acc = S.make_sharded_tiled_approach_runner(ct, vft, mesh, tile_rows=4, unroll=4,
                                                        route="launches")(st, cf, 20, 11)
    _equal(got, l_out, f"{mesh_shape} launches")
    _equal(acc, l_acc, f"{mesh_shape} launches' integrals")
    want, want_acc = _jnp_approach("cylinder", 20, 11)
    _close(got, want, f"{mesh_shape}")
    _ints_close(acc, want_acc, f"{mesh_shape}")


# --- the halo proof: each shard's pass reads its pieces and nothing else ---

def _cut(x, sh, k):
    """``x`` NaN (int flags: 0) beyond the shard's rows and 2k rows a side."""
    H = sh.H
    keep = torch.zeros(H, dtype=torch.bool)
    keep[torch.arange(sh.row0 - 2 * k, sh.row0 + sh.h + 2 * k) % H] = True
    fill = torch.full_like(x, 0 if x.dtype == torch.int32 else float("nan"))
    return torch.where(keep[:, None], x, fill)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("mesh_shape", [(2, 1), (3, 1), (4, 1)])
def test_each_balance_pass_needs_only_its_pieces(mesh_shape, k):
    """For every shard: h, C and the flags NaN (flags 0) beyond the shard's
    rows and 2k rows a side, split and exchanged at 2k rows; the shard's
    pass equals k per-step steps on its rows bit for bit, and is finite."""
    _, ct, _, st, cf, flags, _ = _case("cylinder")
    H, W = ct.eff_res
    mesh = _mesh(mesh_shape)
    want = T.make_per_step_balance_runner(ct, flags)(st, cf, k)
    for i, (iy, _) in enumerate(mesh.local):
        sh = S.Shard.of(H, W, mesh_shape, (iy, 0))
        h, C, fl = (split(_cut(x, sh, k), mesh) for x in (st["h"], st["C"], flags))
        hx = HA.exchange([[h[j], C[j]] for j in range(len(h))], mesh, S.XH, rows=2 * k)
        hfl = HA.exchange([[x] for x in fl], mesh, S.XH, rows=2 * k)
        got = S.c_balance_pass_sh(h[i], C[i], fl[i], hx[i], hfl[i], k, ct, cf, sh)
        for name, g in zip(("h", "C"), got):
            assert torch.isfinite(g).all(), f"{mesh_shape} k={k} shard {i} {name}: NaN reached"
            assert torch.equal(g, sh.body(want[name])), f"{mesh_shape} k={k} shard {i} {name}"


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("mesh_shape", [(2, 1), (3, 1), (4, 1)])
def test_each_approach_pass_needs_only_its_pieces(mesh_shape, k):
    """For every shard, from step 20 (the flat tip's disk rows about row
    24): h and the base flags NaN (flags 0) beyond the shard's rows and 2k
    rows a side, its frames cut with 2k reach rows; the shard's pass equals
    k per-step steps on its rows bit for bit, finite, and its disk terms
    are each step's terms of the rows it owns in step order, bit for
    bit."""
    _, ct, _, st, cf, _, vf = _case("cylinder")
    H, W = ct.eff_res
    vft = torch.as_tensor(vf)
    mesh = _mesh(mesh_shape)
    start = 20
    traj = [st]
    for j in range(k):
        traj.append(T.make_per_step_approach_runner(ct, vft)(traj[-1], cf, start + j, 1)[0])
    for i, (iy, _) in enumerate(mesh.local):
        sh = S.Shard.of(H, W, mesh_shape, (iy, 0))
        h, base = (split(_cut(x, sh, k), mesh) for x in (st["h"], cf["base_flags"]))
        hx = HA.exchange([[x] for x in h], mesh, S.XH, rows=2 * k)
        hfl = HA.exchange([[x] for x in base], mesh, S.XH, rows=2 * k)
        frames = S.shard_frames(vft, sh, 2 * k)
        part = torch.zeros(4)
        got = S.c_approach_pass_sh(h[i], base[i], frames, hx[i], hfl[i], start, k, ct, cf, sh,
                                   part)
        for name, g in zip(("h", "C"), got):
            assert torch.isfinite(g).all(), f"{mesh_shape} k={k} shard {i} {name}: NaN reached"
            assert torch.equal(g, sh.body(traj[-1][name])), f"{mesh_shape} k={k} shard {i} {name}"
        want = torch.zeros(4)
        for j in range(k):
            vel = T.stored_velocity(vft, start + j, ct.vel_obs_conv)
            p = S.disk_partials_ref(traj[j + 1]["C"], vel, start + j, ct, cf, sh)
            want[0] += p[0]
            want[1] += p[1]
            want[2] = p[2]
            want[3] = p[3]
        assert torch.equal(part, want), f"{mesh_shape} k={k} shard {i} disk terms"


# --- the host plan ---

@pytest.mark.parametrize("kind", ["balance", "approach"])
@pytest.mark.parametrize("W", [32, 512, 1024])
def test_c_pass_plan_covers_the_shard(kind, W):
    """On an inner (4, 1) shard and a mesh of one row of a 1024-row grid at
    k = 1..4: every extended row of every sub-step written exactly once, the
    tables (`c_tile_smem_bytes`) in the shared memory, each window inside
    the rows the sub-step before wrote; the (4, 1) shard of 1024x512 in one
    wave of at most 132 tiles."""
    H = 1024
    for k in range(1, 5):
        for ms, co in (((4, 1), (1, 0)), ((1, 1), (0, 0))):
            sh = S.Shard.of(H, W, ms, co)
            whole = sh.h == H
            plan = S.pass_sh_plan(sh, k, 132, kind)
            assert len(plan.nty) == k and 1 <= plan.grid <= 132 and plan.rmax + 5 <= H
            assert S.c_tile_smem_bytes(kind, plan.rmax, plan.smax) <= S.TILE_SMEM_CAP
            avail = (0, H) if whole else (-2 * k, sh.h + 2 * k)
            for j, E in enumerate(S.pass_sh_rows(sh, k)):
                r_lo = 0 if whole else -2 * (k - 1 - j)
                cover = np.zeros((E, W), np.int32)
                for e0, e1, sx0, sx1, cx0, cx1 in plan.tiles(j, E, W):
                    assert e1 - e0 <= plan.rmax and sx1 - sx0 <= plan.smax
                    assert cx1 - cx0 + (4 if cx1 == W else 0) <= plan.smax + 8
                    if not whole:
                        assert avail[0] <= r_lo + e0 - 2 and r_lo + e1 + 2 <= avail[1]
                    cover[e0:e1, sx0:sx1] += 1
                assert (cover == 1).all(), f"{kind} {ms} k={k} sub-step {j}"
                avail = (0, H) if whole else (r_lo, r_lo + E)
            if W == 512 and not whole:
                assert all(n * plan.ntx <= 132 for n in plan.nty)
    with pytest.raises(ValueError, match="kind"):
        S.pass_sh_plan(S.Shard.of(H, W, (4, 1), (1, 0)), 2, 132, "cylinder")
    sh = S.Shard.of(64, 32, (4, 1), (1, 0))
    buf = S.pass_sh_scratch(sh, 3, "cpu", 10)
    assert tuple(buf.shape) == (2, 10, 16 + 12, 32)


# --- argument checks ---

def test_c_route_and_depth_checks():
    """Column meshes take the pass too (the passes' column instances) and
    ``route="launches"`` when asked; the
    default k is `PASS_SH_K` where the shards take it; k outside 1..4, a k
    whose pieces outgrow the shard, pieces of another depth, flag pieces
    shallower than 2k, a frame window without the reach or the steps'
    frames are refused."""
    _, ct, _, st, cf, flags, vf = _case("cylinder")
    H, W = ct.eff_res
    vft = torch.as_tensor(vf)
    mk_b, mk_a = S.make_sharded_tiled_balance_runner, S.make_sharded_tiled_approach_runner
    assert mk_b(ct, flags, _mesh((2, 2)), tile_rows=8).route == "pass"
    assert mk_a(ct, vft, _mesh((2, 2)), tile_rows=8).route == "pass"
    assert (mk_b(ct, flags, _mesh((1, 1))).route, mk_b(ct, flags, _mesh((1, 1))).k) == \
        ("pass", S.PASS_SH_K)
    assert S.PASS_SH_K == 4
    assert mk_a(ct, vft, _mesh((2, 1))).k == S.PASS_SH_K
    assert mk_b(ct, flags, _mesh((12, 1)), tile_rows=4).k == 2
    assert mk_a(ct, vft, _mesh((2, 1)), route="launches").route == "launches"
    for mk, arg in ((mk_b, flags), (mk_a, vft)):
        assert mk(ct, arg, _mesh((2, 2)), tile_rows=8, route="launches").route == "launches"
        with pytest.raises(ValueError, match="one of"):
            mk(ct, arg, _mesh((2, 1)), route="tiles")
        for k in (0, 5):
            with pytest.raises(ValueError, match="1 <= k <= 4"):
                mk(ct, arg, _mesh((2, 1)), k=k)
        with pytest.raises(ValueError, match="too deep"):
            mk(ct, arg, _mesh((12, 1)), tile_rows=4, k=3)
    mesh = _mesh((3, 1))
    sh = S.Shard.of(H, W, (3, 1), (1, 0))
    h, C, fl = (split(x, mesh) for x in (st["h"], st["C"], flags))
    base = split(cf["base_flags"], mesh)
    hx2 = HA.exchange([[h[i], C[i]] for i in range(3)], mesh, S.XH, rows=2)
    hfl2 = HA.exchange([[x] for x in fl], mesh, S.XH, rows=2)
    hfl4 = HA.exchange([[x] for x in fl], mesh, S.XH, rows=4)
    with pytest.raises(ValueError, match="do not match"):  # 2-row pieces at k = 2
        S.c_balance_pass_sh(h[1], C[1], fl[1], hx2[1], hfl4[1], 2, ct, cf, sh)
    hx4 = HA.exchange([[h[i], C[i]] for i in range(3)], mesh, S.XH, rows=4)
    with pytest.raises(ValueError, match="do not match"):  # flag pieces of 2 rows at k = 2
        S.c_balance_pass_sh(h[1], C[1], fl[1], hx4[1], hfl2[1], 2, ct, cf, sh)
    with pytest.raises(ValueError, match="do not match"):  # a column shard without blocks
        S.c_balance_pass_sh(h[1], C[1], fl[1], None, None, 1, ct, cf,
                            S.Shard.of(H, W, (1, 2), (0, 0)))
    hh = HA.exchange([[x] for x in h], mesh, S.XH, rows=4)
    hb = HA.exchange([[x] for x in base], mesh, S.XH, rows=4)
    part = torch.zeros(4)
    with pytest.raises(ValueError, match="reach"):
        S.c_approach_pass_sh(h[1], base[1], S.shard_frames(vft, sh, 2), hh[1], hb[1], 0, 2, ct,
                             cf, sh, part)
    with pytest.raises(ValueError, match="outside the window"):
        S.c_approach_pass_sh(h[1], base[1], S.shard_frames(vft[:4], sh, 4, n_frames=32), hh[1],
                             hb[1], 5, 2, ct, cf, sh, part)
    assert torch.equal(part, torch.zeros(4))
