"""The sharded C phases' k-step passes on column meshes
(`kernels/jrl_sharded.py::c_balance_pass_sh`, `c_approach_pass_sh` with
their x window; `csrc/c_balance_pass_sh.cu::c_balance_pass_sh_cols`,
`csrc/c_approach_pass_sh.cu::c_approach_pass_sh_cols`) and the column-mesh
route of the sharded balance and approach runners on the CPU, where the
wrappers run their plain twins: the runners through the passes on (2, 2),
(1, 2) and (1, 4) at k = 1..4 bit for bit ``route="launches"`` (h, C and
the five integrals) and within the tolerances of the JAX package's jnp
runners, for both tip shapes; the halo proof (each shard's pass from a grid
that is NaN beyond its 2k-row pieces, its 2k-lane blocks, corners included,
and its frame lanes; a NaN corner and a NaN frame lane reach the shard);
the flat tip's disk across a column boundary; the host plan covering the
window; the refusals. The kernels against k per-step launches, on a card,
are in `test_torch_cuda.py`.

Inputs come from the JAX init plus seeded numpy noise at 48x32 (the halo
proof at 96x64, where the (2, 2) corners lie off the tip). Tolerances: the
jnp runners h and C 2e-5, the integrals rtol 2e-4 / atol 1e-4 (the
per-shard disk sums add in another order); the port's routes, twins and
per-step runners against each other bit for bit.
"""

import dataclasses
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
from jrl_lbm_torch.utils.types import CellType

RES, HALO_RES, N, UNROLL = (48, 32), (96, 64), 12, 4
TOL = 2e-5
ACC_KEYS = ("inflow_sum", "current_sum", "count", "rec_u", "rec_v")
COL_MESHES = [(2, 2), (1, 2), (1, 4)]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this module's small grids (several pytest
    workers' OpenMP pools, each as wide as the machine, contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Wide:
    """A flat tip of radius 15.5 (rint 16): at 48x32 its disk crosses the
    column boundary x = 16 of the (1, 2) and (2, 2) meshes, so the dC_r term
    of the first shard's last column reads the next shard's new C."""

    @property
    def radius_obs(self) -> float:
        return 15.50000000000001


class WideJ(_Wide, J.JRLCConfig):
    pass


class WideT(_Wide, T.JRLCConfig):
    pass


def _mesh(shape):
    return make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))


@functools.lru_cache(maxsize=None)
def _case(shape, res=RES, wide=False):
    """``(jax cfg, torch cfg, numpy state, torch state, torch fields, torch
    flags, frames)``: the JAX init plus seeded noise, and 32 stored frames
    (the tip travels one frame a step at 48x32)."""
    kw = dict(res=res, Re=4.0, Pe=5.0, shape=shape)
    cj, ct = (WideJ(**kw), WideT(**kw)) if wide else (J.JRLCConfig(**kw), T.JRLCConfig(**kw))
    state, _, _ = J.c_init(cj)
    rng = np.random.default_rng(24)
    state = {k: (np.asarray(v) + 1e-4 * rng.standard_normal(np.shape(v))).astype(np.float32)
             for k, v in state.items()}
    _, cf, flags = T.c_init(ct, "cpu")
    vf = np.random.default_rng(25).uniform(-0.5, 0.5, size=(32, 2) + res).astype(np.float32)
    return cj, ct, state, state_from_numpy(state, "cpu"), cf, flags, vf


@functools.lru_cache(maxsize=None)
def _jnp(shape, start=0, wide=False):
    """The JAX package's jnp balance runner over N steps and its approach
    runner over N steps from ``start``."""
    cj, _, state, _, _, _, vf = _case(shape, RES, wide)
    _, fields, flags = J.c_init(cj)
    js = {k: jnp.asarray(v) for k, v in state.items()}
    bal = J.make_balance_runner(cj, flags)(js, fields, N)
    out, acc = J.make_approach_runner(cj)(js, dict(fields, vel_field=jnp.asarray(vf)),
                                          jnp.asarray(start, jnp.int32), N)
    return ({k: np.asarray(v) for k, v in bal.items()},
            {k: np.asarray(v) for k, v in out.items()}, {k: float(v) for k, v in acc.items()})


@functools.lru_cache(maxsize=None)
def _launches(shape, mesh_shape, start=0, wide=False):
    """The per-step kernels' route (``route="launches"``): N balance steps,
    and N approach steps from ``start`` with their integrals."""
    _, ct, _, st, cf, flags, vf = _case(shape, RES, wide)
    mesh = _mesh(mesh_shape)
    bal = S.make_sharded_tiled_balance_runner(ct, flags, mesh, tile_rows=8,
                                              route="launches")(st, cf, N)
    app = S.make_sharded_tiled_approach_runner(ct, torch.as_tensor(vf), mesh, tile_rows=8,
                                               unroll=UNROLL, route="launches")(st, cf, start, N)
    return bal, app


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
@pytest.mark.parametrize("mesh_shape", COL_MESHES)
@pytest.mark.parametrize("shape", ["45degree", "cylinder"])
def test_column_pass_routes_match_launches_and_jnp(shape, mesh_shape, k):
    """12 balance and 12 approach steps at 48x32 (the wedge's plain disk,
    the cylinder's flat flux form) through the default route, the passes at
    k: per pass one exchange of the 2k-row pieces and their `pass_xh(k)`-lane
    blocks and one pass launch a shard (the rest at a smaller k), the flags'
    pieces and blocks once a run at the deepest k; bit for bit ``route=
    "launches"`` (h, C, the integrals), the jnp runners at 2e-5 (integrals
    rtol 2e-4 / atol 1e-4)."""
    _, ct, _, st, cf, flags, vf = _case(shape)
    ny, nx = mesh_shape
    mesh = _mesh(mesh_shape)
    kjs = [k] * (N // k) + ([N % k] if N % k else [])
    run = S.make_sharded_tiled_balance_runner(ct, flags, mesh, tile_rows=8, k=k)
    assert (run.route, run.k) == ("pass", k)
    with mock.patch.object(S, "exchange", wraps=S.exchange) as ex, \
            mock.patch.object(S, "c_balance_pass_sh", wraps=S.c_balance_pass_sh) as bp, \
            mock.patch.object(S, "c_balance_sh", wraps=S.c_balance_sh) as per:
        got = run(st, cf, N)
    assert not per.called and bp.call_count == len(kjs) * ny * nx
    assert [(c.args[2], c.kwargs["rows"]) for c in ex.call_args_list] == \
        [(S.pass_xh(k), 2 * k)] + [(S.pass_xh(kj), 2 * kj) for kj in kjs]
    bal_l, (app_l, acc_l) = _launches(shape, mesh_shape)
    _equal(got, bal_l, f"balance {mesh_shape} k={k} launches")
    bal_j, app_j, acc_j = _jnp(shape)
    _close(got, bal_j, f"balance {mesh_shape} k={k} jnp")
    run = S.make_sharded_tiled_approach_runner(ct, torch.as_tensor(vf), mesh, tile_rows=8,
                                               unroll=UNROLL, k=k)
    assert (run.route, run.k) == ("pass", k)
    with mock.patch.object(S, "c_approach_pass_sh", wraps=S.c_approach_pass_sh) as ap, \
            mock.patch.object(S, "c_approach_sh", wraps=S.c_approach_sh) as per:
        got, acc = run(st, cf, 0, N)
    ks = [min(k, c - s) for c in [UNROLL] * (N // UNROLL) for s in range(0, c, k)]
    assert not per.called and [c.args[6] for c in ap.call_args_list[::ny * nx]] == ks
    _equal(got, app_l, f"approach {mesh_shape} k={k} launches")
    _equal(acc, acc_l, f"approach {mesh_shape} k={k} launches' integrals")
    _close(got, app_j, f"approach {mesh_shape} k={k} jnp")
    _ints_close(acc, acc_j, f"approach {mesh_shape} k={k} jnp")


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 2)])
def test_flat_disk_across_a_column_boundary(mesh_shape):
    """The wide flat tip (rint 16, its disk across x = 16) from step 20 over
    12 steps, ``unroll`` 4, k = 3: passes of 3 and 1 a chunk, so passes end
    inside chunks; the disk's last column on the first shard reads the new
    C of the column past it. Bit for bit ``route="launches"`` (h, C,
    integrals) and the per-step runner (h, C), the jnp runner at 2e-5
    (integrals rtol 2e-4 / atol 1e-4)."""
    _, ct, _, st, cf, _, vf = _case("cylinder", RES, True)
    sh = S.Shard.of(*RES, mesh_shape, (0, 0))
    assert sh.col0 + sh.w <= ct.radius_obs_int < RES[1] - 1
    vft = torch.as_tensor(vf)
    with mock.patch.object(S, "c_approach_pass_sh", wraps=S.c_approach_pass_sh) as ap:
        got, acc = S.make_sharded_tiled_approach_runner(ct, vft, _mesh(mesh_shape), tile_rows=8,
                                                        unroll=UNROLL, k=3)(st, cf, 20, N)
    n_sh = mesh_shape[0] * mesh_shape[1]
    assert [(c.args[5], c.args[6]) for c in ap.call_args_list[::n_sh]] == \
        [(20, 3), (23, 1), (24, 3), (27, 1), (28, 3), (31, 1)]
    _, (l_out, l_acc) = _launches("cylinder", mesh_shape, 20, True)
    _equal(got, l_out, f"{mesh_shape} launches")
    _equal(acc, l_acc, f"{mesh_shape} launches' integrals")
    _equal(got, T.make_per_step_approach_runner(ct, vft)(st, cf, 20, N)[0], f"{mesh_shape}")
    _, want, want_acc = _jnp("cylinder", 20, True)
    _close(got, want, f"{mesh_shape} jnp")
    _ints_close(acc, want_acc, f"{mesh_shape} jnp")


# --- the halo proof: each shard's pass reads its pieces, blocks and lanes only ---

def _keep(sh, k, corner=None):
    """The cells of the shard's rows and columns extended by 2k a side
    (rows mod H, columns inside the grid); with ``corner`` (a pair of signs)
    less the 2k x 2k block off that corner."""
    H, W = sh.H, sh.W
    keep = torch.zeros((H, W), dtype=torch.bool)
    rows = torch.arange(sh.row0 - 2 * k, sh.row0 + sh.h + 2 * k) % H
    cols = torch.arange(max(sh.col0 - 2 * k, 0), min(sh.col0 + sh.w + 2 * k, W))
    keep[rows[:, None], cols[None, :]] = True
    if corner is not None:
        cy, cx = corner
        r = torch.arange(sh.row0 - 2 * k, sh.row0) if cy < 0 else \
            torch.arange(sh.row0 + sh.h, sh.row0 + sh.h + 2 * k)
        c = torch.arange(sh.col0 - 2 * k, sh.col0) if cx < 0 else \
            torch.arange(sh.col0 + sh.w, sh.col0 + sh.w + 2 * k)
        keep[(r % H)[:, None], c[None, :]] = False
    return keep


def _cut(x, keep):
    """``x`` NaN (int flags: 0) off ``keep``."""
    fill = torch.full_like(x, 0 if x.dtype == torch.int32 else float("nan"))
    return torch.where(keep, x, fill)


@functools.lru_cache(maxsize=None)
def _halo_refs(k):
    """k per-step balance steps and k per-step approach steps from step 20
    at 96x64 (the flat tip), and the approach's disk terms a step."""
    _, ct, _, st, cf, flags, vf = _case("cylinder", HALO_RES)
    vft = torch.as_tensor(vf)
    bal = T.make_per_step_balance_runner(ct, flags)(st, cf, k)
    traj = [st]
    for j in range(k):
        traj.append(T.make_per_step_approach_runner(ct, vft)(traj[-1], cf, 20 + j, 1)[0])
    return bal, traj


def _shard_passes(mesh_shape, k, i, keep, vf_keep=None):
    """Shard i's balance and approach passes at k from the state, flags and
    frames cut to ``keep`` (the frames to ``vf_keep``, default ``keep``),
    exchanged at 2k rows and `pass_xh(k)` lanes: ``(sh, (h, C), (h, C),
    part)``."""
    _, ct, _, st, cf, flags, vf = _case("cylinder", HALO_RES)
    mesh = _mesh(mesh_shape)
    sh = S.Shard.of(*HALO_RES, mesh_shape, mesh.local[i])
    L = range(len(mesh.local))
    xh = S.pass_xh(k)
    h, C, fl, base = (split(_cut(x, keep), mesh)
                      for x in (st["h"], st["C"], flags, cf["base_flags"]))
    hx = HA.exchange([[h[j], C[j]] for j in L], mesh, xh, rows=2 * k)
    hfl = HA.exchange([[x] for x in fl], mesh, xh, rows=2 * k)
    bal = S.c_balance_pass_sh(h[i], C[i], fl[i], hx[i], hfl[i], k, ct, cf, sh)
    hh = HA.exchange([[x] for x in h], mesh, xh, rows=2 * k)
    hb = HA.exchange([[x] for x in base], mesh, xh, rows=2 * k)
    frames = S.shard_frames(_cut(torch.as_tensor(vf), keep if vf_keep is None else vf_keep), sh,
                            2 * k)
    part = torch.zeros(4)
    app = S.c_approach_pass_sh(h[i], base[i], frames, hh[i], hb[i], 20, k, ct, cf, sh, part)
    return sh, bal, app, part


def _finite(xs):
    return all(torch.isfinite(x).all() for x in xs)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 2)])
def test_each_column_pass_needs_only_its_pieces_blocks_and_lanes(mesh_shape, k):
    """For every shard of 96x64 (the flat tip from step 20): h, C, the
    flags and the stored frames NaN (flags 0) beyond the shard's rows and
    columns extended by 2k a side (corners kept), split, exchanged with
    `pass_xh` lanes (k = 1, 3: the lanes past 2k NaN too, never read) and
    the frames cut with 2k reach rows and lanes; each pass equals k
    per-step steps on the shard's cells bit for bit, finite, and the
    approach's disk terms are each step's terms of the rows it owns. On (2,
    2) a NaN 2k x 2k block off an inner corner (a shard per k, in turn)
    reaches the shard's balance and approach; at k >= 2 a NaN frame lane
    just past an inner column edge reaches the approach: the corners and
    the frame lanes are read."""
    _, ct, _, _, cf, _, vf = _case("cylinder", HALO_RES)
    bal_ref, traj = _halo_refs(k)
    n_sh = mesh_shape[0] * mesh_shape[1]
    for i in range(n_sh):
        sh0 = S.Shard.of(*HALO_RES, mesh_shape, _mesh(mesh_shape).local[i])
        sh, bal, app, part = _shard_passes(mesh_shape, k, i, _keep(sh0, k))
        tag = f"{mesh_shape} k={k} shard {i}"
        assert _finite(bal + app), f"{tag}: NaN reached"
        for name, g in zip(("h", "C"), bal):
            assert torch.equal(g, sh.body(bal_ref[name])), f"{tag} balance {name}"
        for name, g in zip(("h", "C"), app):
            assert torch.equal(g, sh.body(traj[-1][name])), f"{tag} approach {name}"
        want = torch.zeros(4)
        for j in range(k):
            vel = T.stored_velocity(torch.as_tensor(vf), 20 + j, ct.vel_obs_conv)
            p = S.disk_partials_ref(traj[j + 1]["C"], vel, 20 + j, ct, cf, sh)
            want = torch.stack([want[0] + p[0], want[1] + p[1], p[2], p[3]])
        assert torch.equal(part, want), f"{tag} disk terms"
    if mesh_shape == (2, 2):  # a shard's corner at the mesh's centre, shard k - 1
        i = k - 1
        iy, ix = _mesh(mesh_shape).local[i]
        sh = S.Shard.of(*HALO_RES, mesh_shape, (iy, ix))
        corner = (1 if iy == 0 else -1, 1 if ix == 0 else -1)
        _, bal, app, _ = _shard_passes(mesh_shape, k, i, _keep(sh, k, corner))
        assert not _finite(bal) and not _finite(app), f"k={k} {(iy, ix)}: corner {corner} unread"
    if k >= 2:  # the first lane past shard 0's last column, NaN in its frames
        sh = S.Shard.of(*HALO_RES, mesh_shape, (0, 0))
        keep = _keep(sh, k)
        vkeep = keep.clone()
        vkeep[:, sh.col0 + sh.w] = False
        _, _, app, _ = _shard_passes(mesh_shape, k, 0, keep, vkeep)
        assert not _finite(app), f"{mesh_shape} k={k}: the frame lanes went unread"


# --- the host plan ---

@pytest.mark.parametrize("kind", ["balance", "approach"])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 2), (1, 4)])
def test_c_column_plan_covers_the_window(mesh_shape, kind):
    """On the outer and inner column shards of a 1024x512 grid at k = 1..4,
    for an H100's 132 SMs: every cell of every sub-step's extended rows x
    lanes (`pass_sh_lanes`) written exactly once; each tile's window (two
    rows and columns a side, 16-byte ends, no wrap column) within a table
    row and inside what the sub-step before wrote, or in sub-step 0 inside
    the shard, its pieces and its blocks' `pass_xh` lanes; the tables
    (`c_tile_smem_bytes`) in the shared memory; the scratch rows and lanes
    in the buffers."""
    H, W = 1024, 512
    ny, nx = mesh_shape
    for k in range(1, 5):
        for co in {(0, 0), (ny - 1, nx - 1), (ny // 2, nx // 2)}:
            sh = S.Shard.of(H, W, mesh_shape, co)
            whole, xh = sh.h == H, S.pass_xh(k)
            plan = S.pass_sh_plan(sh, k, 132, kind)
            assert len(plan.nty) == k and 1 <= plan.grid <= 132 and plan.rmax + 5 <= H
            assert S.c_tile_smem_bytes(kind, plan.rmax, plan.smax) <= S.TILE_SMEM_CAP
            srows, scols = S.pass_sh_scratch(sh, k, "meta", 10).shape[-2:] if k > 1 else (0, 0)
            avail_r = (0, H) if whole else (-2 * k, sh.h + 2 * k)
            avail_c = (max(sh.col0 - xh, 0), min(sh.col0 + sh.w + xh, W))
            for j, (E, (X0, X1)) in enumerate(zip(S.pass_sh_rows(sh, k),
                                                  S.pass_sh_lanes(sh, k))):
                r_lo = 0 if whole else -2 * (k - 1 - j)
                cover = np.zeros((E, W), np.int32)
                for e0, e1, sx0, sx1, cx0, cx1 in plan.tiles(j, E, W, X0, X1):
                    assert e1 - e0 <= plan.rmax and sx1 - sx0 <= plan.smax
                    assert cx0 % 4 == 0 and cx1 % 4 == 0 and cx1 - cx0 <= plan.smax + 8
                    assert cx0 <= max(sx0 - 2, 0) and cx1 >= min(sx1 + 2, W)
                    assert avail_c[0] <= cx0 and cx1 <= avail_c[1]
                    if not whole:
                        assert avail_r[0] <= r_lo + e0 - 2 and r_lo + e1 + 2 <= avail_r[1]
                    cover[e0:e1, sx0:sx1] += 1
                assert (cover[:, X0:X1] == 1).all() and cover.sum() == E * (X1 - X0), \
                    f"{kind} {mesh_shape} {co} k={k} sub-step {j}"
                avail_r = (0, H) if whole else (r_lo, r_lo + E)
                if j < k - 1:  # scratch row r + 2k, lane x - col0 + xh
                    assert 0 <= X0 - sh.col0 + xh and X1 - sh.col0 + xh <= scols
                    if not whole:
                        assert 0 <= r_lo + 2 * k and r_lo + E + 2 * k <= srows


# --- argument checks ---

def test_column_pass_refusals():
    """A column shard's C passes refuse: no blocks, blocks of 2 lanes or of
    another depth, flag blocks narrower than `pass_xh(k)`, a frame window
    without its reach lanes, and a FLUID flag in the grid's last column
    (the twins at every call, the runners once a run; ``route="launches"``
    takes it); the frames' lanes are the shard's and 2k a side cut to the
    grid."""
    _, ct, _, st, cf, flags, vf = _case("cylinder")
    H, W = RES
    mesh = _mesh((2, 2))
    sh = S.Shard.of(H, W, (2, 2), (0, 1))
    h, C, fl, base = (split(x, mesh) for x in (st["h"], st["C"], flags, cf["base_flags"]))
    L = range(4)
    hx = HA.exchange([[h[i], C[i]] for i in L], mesh, S.pass_xh(2), rows=4)
    hfl = HA.exchange([[x] for x in fl], mesh, S.pass_xh(2), rows=4)
    S.c_balance_pass_sh(h[1], C[1], fl[1], hx[1], hfl[1], 2, ct, cf, sh)
    for bad_hx, bad_fl in ((HA.Halo(10, hx[1].top, hx[1].bot, k=4), hfl[1]),
                           (HA.exchange([[h[i], C[i]] for i in L], mesh, S.XH, rows=4)[1],
                            hfl[1]),
                           (HA.exchange([[h[i], C[i]] for i in L], mesh, 4, rows=2)[1], hfl[1]),
                           (hx[1], HA.exchange([[x] for x in fl], mesh, S.XH, rows=4)[1]),
                           (hx[1], HA.Halo(1, hfl[1].top, hfl[1].bot, k=4))):
        with pytest.raises(ValueError, match="do not match"):
            S.c_balance_pass_sh(h[1], C[1], fl[1], bad_hx, bad_fl, 2, ct, cf, sh)
    # flag blocks deeper and wider than the pass's (a run's, at its deepest k)
    hfl8 = HA.exchange([[x] for x in fl], mesh, S.pass_xh(4), rows=8)
    S.c_balance_pass_sh(h[1], C[1], fl[1], hx[1], hfl8[1], 2, ct, cf, sh)
    vft = torch.as_tensor(vf)
    assert S.frame_lanes(sh, 4) == (12, 32) and S.frame_lanes(S.Shard.of(H, W, (2, 1), (0, 0)),
                                                               4) == (0, 32)
    fr = S.shard_frames(vft, sh, 4)
    assert (fr.col0, tuple(fr.t.shape[2:])) == (4, (32, 20))
    hh = HA.exchange([[x] for x in h], mesh, S.pass_xh(2), rows=4)
    hb = HA.exchange([[x] for x in base], mesh, S.pass_xh(2), rows=4)
    part = torch.zeros(4)
    for bad in (S.ShardFrames(fr.t[..., 4:20].contiguous(), fr.row0),
                dataclasses.replace(fr, col0=2)):
        with pytest.raises(ValueError, match="columns"):
            S.c_approach_pass_sh(h[1], base[1], bad, hh[1], hb[1], 0, 2, ct, cf, sh, part)
    assert torch.equal(part, torch.zeros(4))
    edge, edge_base = flags.clone(), cf["base_flags"].clone()
    edge[10, -1] = edge_base[10, -1] = int(CellType.FLUID)
    with pytest.raises(ValueError, match="last column"):
        S.c_balance_pass_sh(h[1], C[1], split(edge, mesh)[1], hx[1], hfl[1], 2, ct, cf, sh)
    with pytest.raises(ValueError, match="last column"):
        S.make_sharded_tiled_balance_runner(ct, edge, mesh, tile_rows=8)
    with pytest.raises(ValueError, match="last column"):
        S.make_sharded_tiled_approach_runner(ct, vft, mesh, tile_rows=8)(
            st, dict(cf, base_flags=edge_base), 0, 1)
    # the yardstick and the row meshes take such flags
    S.make_sharded_tiled_balance_runner(ct, edge, mesh, tile_rows=8, route="launches")(st, cf, 1)
    S.make_sharded_tiled_balance_runner(ct, edge, _mesh((2, 1)), tile_rows=8)(st, cf, 1)
    # the left shard of the column boundary is not at the grid's edge
    S.check_edge_flags(split(edge, mesh)[0], S.Shard.of(H, W, (2, 2), (0, 0)))
