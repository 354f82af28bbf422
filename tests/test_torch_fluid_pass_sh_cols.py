"""The sharded JRL fluid step's k-step pass on column meshes
(`kernels/jrl_sharded.py::fluid_pass_sh` with its x window,
`csrc/fluid_pass_sh.cu::fluid_pass_sh_cols`) on the CPU, where the wrapper
runs its plain twin: the sharded fluid runner through the pass on (2, 2)
against the JAX package's own 2D-mesh runner
(``fused_jrl_sharded.make_sharded_tiled_fluid_runner``, interpreted on the
virtual CPU devices) and its jnp step; the pass route bit for bit the A/B
pair (``route="launches"``) on (2, 2), (1, 2) and (1, 4) at k = 1..4; the
halo proof (each shard's pass from a grid that is NaN beyond its 2k-row
pieces and its 2k-lane blocks, corners included, equal to k steps of the
pair's twins); the kernel's schedule on a column shard (sub-steps over
the shard's rows and lanes extended by 2 (k - 1 - j) a side, tile by
tile, each from its own window) played against the twin; the host plan
covering the window; the argument checks. The kernel against the pair on
a card is in `test_torch_cuda.py`.

Inputs come from the JAX init plus seeded numpy noise. Tolerances: JAX's
interpreted runner and the jnp step f and rho 2e-5, vel 2e-4 over 12 steps
(as `tests/test_fused_jrl_sharded.py`); the port's routes, twins and the
played schedule against each other bit for bit.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrl_lbm_tpu.models import jrl as J
from jrl_lbm_tpu.ops.pallas import fused_jrl_sharded as JS
from jrl_lbm_tpu.parallel.mesh import make_mesh as jax_mesh
from jrl_lbm_torch.kernels import halo as HA
from jrl_lbm_torch.kernels import jrl_sharded as S
from jrl_lbm_torch.kernels import jrl_tiled as TL
from jrl_lbm_torch.models import jrl as T
from jrl_lbm_torch.parallel.mesh import make_mesh, split
from jrl_lbm_torch.utils.device import state_from_numpy

RES, N = (48, 32), 12  # 48 rows by 32 columns, 12 steps
# the halo proof's and the schedule's grid: at 48x32 the tip covers every
# inner shard corner (rows < 41), at 96x64 the fluid reaches the (2, 2)
# corners, so a NaN corner block shows in the shard's pass at every k
HALO_RES = (96, 64)
TOL = {"f": 2e-5, "rho": 2e-5, "vel": 2e-4}
COL_MESHES = [(2, 2), (1, 2), (1, 4)]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this module's small grids: with several
    pytest workers on the CPU at once, their OpenMP pools, each as wide as
    the machine, contend (10-20x slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    return make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))


@functools.lru_cache(maxsize=None)
def _case(res=RES):
    """``(jax cfg, torch cfg, numpy state, torch state, torch fields)``: the
    45degree wedge (at 48x32 its tip, rg = 26 of W = 32, crosses every x
    shard boundary of the three meshes) from the JAX init plus seeded
    noise."""
    kw = dict(res=res, Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8,
              shape="45degree")
    jc, tc = J.JRLFluidConfig(**kw), T.JRLFluidConfig(**kw)
    state, _ = J.fluid_init(jc)
    rng = np.random.default_rng(23)
    state = {k: (np.asarray(v) + 1e-4 * rng.standard_normal(np.shape(v))).astype(np.float32)
             for k, v in state.items()}
    return jc, tc, state, state_from_numpy(state, "cpu"), T.fluid_init(tc, "cpu")[1]


@functools.lru_cache(maxsize=None)
def _jax_runs():
    """JAX's (2, 2) runner, interpreted, and its jnp step, N steps each."""
    jc, _, state, _, _ = _case()
    _, fields = J.fluid_init(jc)
    js = {k: jnp.asarray(v) for k, v in state.items()}
    mesh = jax_mesh((2, 2), devices=jax.devices()[:4])
    run = JS.make_sharded_tiled_fluid_runner(jc, mesh, tile_rows=8, unroll=4, interpret=True)
    sharded = jax.tree.map(np.asarray, run(js, fields, jnp.asarray(0, jnp.int32), N))
    step = jax.jit(J.make_fluid_step(jc))
    for i in range(N):
        js = step(js, fields, jnp.asarray(i, jnp.int32))
    return sharded, jax.tree.map(np.asarray, js)


@functools.lru_cache(maxsize=None)
def _launches(mesh_shape, start, n, res=RES):
    """The A/B pair's route: n steps from ``start``."""
    _, tc, _, s, fl = _case(res)
    return S.make_sharded_tiled_fluid_runner(tc, _mesh(mesh_shape), tile_rows=8, unroll=4,
                                             route="launches")(s, fl, start, n)


def _equal(got, want, tag):
    for k in want:
        assert torch.equal(got[k], want[k]), f"{tag} {k}"


# --- the runner through the pass ---

@pytest.mark.parametrize("k", [4, 3])
def test_2x2_pass_matches_jax_runner_and_jnp(k):
    """12 steps at 48x32 on (2, 2), the default route (the pass) at k: JAX's
    interpreted 2D-mesh runner and the jnp step at 2e-5 (vel 2e-4), the
    A/B pair bit for bit."""
    _, tc, _, s, fl = _case()
    run = S.make_sharded_tiled_fluid_runner(tc, _mesh((2, 2)), tile_rows=8, unroll=4, k=k)
    assert (run.route, run.k) == ("pass", k)
    got = run(s, fl, 0, N)
    for ref, name in zip(_jax_runs(), ("JAX's (2, 2) runner", "jnp")):
        for key, tol in TOL.items():
            np.testing.assert_allclose(got[key].numpy(), ref[key], rtol=tol, atol=tol,
                                       err_msg=f"k={k} {key} vs {name}")
    _equal(got, _launches((2, 2), 0, N), f"k={k} launches")


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("mesh_shape", COL_MESHES)
def test_pass_route_equals_launches(mesh_shape, k):
    """12 steps from step 3 (the tip crosses a row; it lies across every x
    shard boundary): one exchange of the 2k-row pieces and their
    pass_xh(k)-lane blocks and one `fluid_pass_sh` a shard a pass (the
    remainder at a smaller k), no pair; bit for bit ``route="launches"``."""
    _, tc, _, s, fl = _case()
    ny, nx = mesh_shape
    run = S.make_sharded_tiled_fluid_runner(tc, _mesh(mesh_shape), tile_rows=8, unroll=4, k=k)
    with mock.patch.object(S, "fluid_pass_sh", wraps=S.fluid_pass_sh) as fp, \
            mock.patch.object(S, "exchange", wraps=S.exchange) as ex, \
            mock.patch.object(S, "fluid_a_sh", wraps=S.fluid_a_sh) as fa:
        got = run(s, fl, 3, N)
    passes = -(-N // k)
    assert ex.call_count == passes and fp.call_count == passes * ny * nx and not fa.called
    kjs = [k] * (N // k) + ([N % k] if N % k else [])
    assert [c.args[2] for c in ex.call_args_list] == [S.pass_xh(kj) for kj in kjs]
    assert [c.kwargs["rows"] for c in ex.call_args_list] == [2 * kj for kj in kjs]
    _equal(got, _launches(mesh_shape, 3, N), f"{mesh_shape} k={k}")


# --- the halo proof: each shard's pass from its pieces and blocks ---

def _cut(s, sh, k, corner=None):
    """The global state NaN beyond the shard's rows and columns extended by
    2k a side (rows mod H, columns inside the grid); with ``corner`` (a
    pair of signs) the 2k x 2k block off that corner NaN too."""
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
    return {x: torch.where(keep, v, torch.full_like(v, float("nan"))) for x, v in s.items()}


def _shard_pass(mesh_shape, state, i, k, step):
    _, tc, _, _, fl = _case(HALO_RES)
    mesh = _mesh(mesh_shape)
    f, rho, vel = (split(state[x], mesh) for x in ("f", "rho", "vel"))
    hx = HA.exchange([[f[j], vel[j], rho[j]] for j in range(len(f))], mesh, S.pass_xh(k),
                     rows=2 * k)
    sh = S.Shard.of(*HALO_RES, mesh_shape, mesh.local[i])
    return sh, S.fluid_pass_sh(f[i], rho[i], vel[i], hx[i], step, k, tc, fl, sh)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 2)])
def test_each_shard_pass_needs_only_its_pieces_and_blocks(mesh_shape, k):
    """For every shard of 96x64: the global state NaN beyond the shard's
    rows and columns extended by 2k a side (corners kept), split and
    exchanged with `pass_xh` lanes (k = 1, 3: the lanes past 2k NaN too,
    never read); the shard's pass equals k steps of the pair's twins
    (``route="launches"``) on its cells, and is finite. On (2, 2) a NaN
    2k x 2k block off an inner corner (a shard per k, in turn) reaches
    the shard: the corners are read."""
    _, _, _, s, _ = _case(HALO_RES)
    want = _launches(mesh_shape, 5, k, HALO_RES)
    for i in range(mesh_shape[0] * mesh_shape[1]):
        sh0 = S.Shard.of(*HALO_RES, mesh_shape, _mesh(mesh_shape).local[i])
        sh, got = _shard_pass(mesh_shape, _cut(s, sh0, k), i, k, 5)
        for name, g in zip(("f", "rho", "vel"), got):
            assert torch.isfinite(g).all(), f"{mesh_shape} k={k} shard {i} {name}: NaN reached"
            assert torch.equal(g, sh.body(want[name])), f"{mesh_shape} k={k} shard {i} {name}"
    if mesh_shape == (2, 2):  # a shard's corner at the mesh's centre, shard k - 1
        i = k - 1
        iy, ix = _mesh(mesh_shape).local[i]
        sh = S.Shard.of(*HALO_RES, mesh_shape, (iy, ix))
        corner = (1 if iy == 0 else -1, 1 if ix == 0 else -1)
        _, got = _shard_pass(mesh_shape, _cut(s, sh, k, corner), i, k, 5)
        assert not all(torch.isfinite(g).all() for g in got), \
            f"k={k} shard {(iy, ix)}: the corner {corner} went unread"


# --- the tiles' schedule on a column shard, played tile by tile ---

def _emulate(sh, f, rho, vel, halo, step0, k, cfg, plan):
    """`fluid_pass_sh`'s tiles on a column shard as the kernel schedules
    them: sub-step j over the shard's rows and lanes extended by 2 (k - 1 -
    j) a side (`pass_sh_lanes`), tile after tile of ``plan``, each tile's A
    on its rows and columns one past its B cells and its B from a window of
    rows -2 .. R + 1 and columns two past the tile (NaN beyond it, and
    beyond what the sub-step before wrote)."""
    H, W, k = sh.H, sh.W, int(k)
    nan = float("nan")
    cur = {"f": S._embed_rows(sh, f, halo, nan, slice(0, 9)),
           "rho": S._embed_rows(sh, rho, halo, nan, slice(11, 12)),
           "vel": S._embed_rows(sh, vel, halo, nan, slice(9, 11))}
    rows, lanes = S.pass_sh_rows(sh, k), S.pass_sh_lanes(sh, k)
    for j in range(k):
        r_lo = 0 if sh.h == H else -2 * (k - 1 - j)
        nxt = {"f": torch.full((9, H, W), nan), "rho": torch.full((H, W), nan),
               "vel": torch.full((2, H, W), nan)}
        for e0, e1, sx0, sx1, _, _ in plan.tiles(j, rows[j], W, *lanes[j]):
            R, y0 = e1 - e0, sh.row0 + r_lo + e0
            win = torch.arange(y0 - 2, y0 + R + 2) % H
            cols = torch.zeros(W, dtype=torch.bool)
            cols[max(sx0 - 2, 0):min(sx1 + 2, W)] = True

            def cut(x):
                return torch.where(cols, x.index_select(-2, win), torch.full((), nan))

            f1, rho1, vel1 = TL._a_full(cfg, step0 + j, y0 - 1, R + 2, cut(cur["f"]),
                                        cut(cur["vel"]), cut(cur["rho"])[1:-1])
            fo = TL._b_full(cfg, step0 + j, y0, R, f1[:, 1:-1], rho1, vel1)
            out = torch.arange(y0, y0 + R) % H
            nxt["f"][:, out, sx0:sx1] = fo[:, :, sx0:sx1]
            nxt["rho"][out, sx0:sx1] = rho1[1:-1, sx0:sx1]
            nxt["vel"][:, out, sx0:sx1] = vel1[:, 1:-1, sx0:sx1]
        cur = nxt
    return sh.body(cur["f"]), sh.body(cur["rho"]), sh.body(cur["vel"])


# tiles of about R x S cells a k: bands and strips of unequal size, outer
# strips ending 2 past a multiple of 4, both grid edges
EMU_TILES = {1: (11, 12), 2: (13, 16), 3: (9, 12), 4: (14, 20)}


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 2)])
def test_tile_schedule_equals_the_twin(mesh_shape, k):
    """Every shard's pass on 96x64 played tile by tile (`_emulate`, the
    plan of ``EMU_TILES[k]``), each tile from its own window only: bit for
    bit `fluid_pass_sh_ref` from step 5, and finite."""
    _, tc, _, s, fl = _case(HALO_RES)
    mesh = _mesh(mesh_shape)
    f, rho, vel = (split(s[x], mesh) for x in ("f", "rho", "vel"))
    hx = HA.exchange([[f[i], vel[i], rho[i]] for i in range(len(f))], mesh, S.pass_xh(k),
                     rows=2 * k)
    for i, co in enumerate(mesh.local):
        sh = S.Shard.of(*HALO_RES, mesh_shape, co)
        plan = S.tile_plan(sh, k, *EMU_TILES[k])
        assert plan.ntx > 1 and min(plan.nty) > 1
        got = _emulate(sh, f[i], rho[i], vel[i], hx[i], 5, k, tc, plan)
        want = S.fluid_pass_sh_ref(f[i], rho[i], vel[i], hx[i], 5, k, tc, fl, sh)
        for name, g, w in zip(("f", "rho", "vel"), got, want):
            assert torch.isfinite(g).all(), f"{mesh_shape} k={k} shard {co} {name}: NaN reached"
            assert torch.equal(g, w), f"{mesh_shape} k={k} shard {co} {name}"


# --- the launch's host plan ---

@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 2), (1, 4), (4, 4)])
def test_pass_sh_plan_covers_the_window(mesh_shape, k):
    """On every column shard of a 1024x512 grid, for one SM, an H100's 132
    and a tile asked for: every B cell of every sub-step's extended rows x
    lanes (`pass_sh_lanes`: 2 (k - 1 - j) a side, cut to the grid) written
    exactly once; each tile's window (two rows and columns a side, 16-byte
    ends) inside what the sub-step before wrote, or in sub-step 0 inside
    the shard, its pieces and its blocks' `pass_xh` lanes; strips within
    smax, windows within a table row, the tables in the shared memory, the
    scratch rows and lanes in the buffers."""
    H, W = 1024, 512
    ny, nx = mesh_shape
    for co in {(0, 0), (ny - 1, nx - 1), (ny // 2, nx // 2)}:
        sh = S.Shard.of(H, W, mesh_shape, co)
        whole, xh = sh.h == H, S.pass_xh(k)
        rows, lanes = S.pass_sh_rows(sh, k), S.pass_sh_lanes(sh, k)
        assert lanes == [(max(sh.col0 - 2 * (k - 1 - j), 0),
                          min(sh.col0 + sh.w + 2 * (k - 1 - j), W)) for j in range(k)]
        srows, scols = S.pass_sh_scratch(sh, k, "meta").shape[-2:] if k > 1 else (0, 0)
        for sms, tile in ((1, None), (132, None), (132, (10, 60))):
            plan = S.pass_sh_plan(sh, k, sms) if tile is None else S.tile_plan(sh, k, *tile, sms)
            assert len(plan.nty) == k and 1 <= plan.grid <= sms
            assert plan.smax % 4 == 0 and plan.rmax + 5 <= H
            assert S.tile_smem_bytes(plan.rmax, plan.smax) <= S.TILE_SMEM_CAP
            avail_r = (0, H) if whole else (-2 * k, sh.h + 2 * k)
            avail_c = (max(sh.col0 - xh, 0), min(sh.col0 + sh.w + xh, W))
            for j, (E, (X0, X1)) in enumerate(zip(rows, lanes)):
                r_lo = 0 if whole else -2 * (k - 1 - j)
                cover = np.zeros((E, W), np.int32)
                for e0, e1, sx0, sx1, cx0, cx1 in plan.tiles(j, E, W, X0, X1):
                    assert e0 < e1 <= E and e1 - e0 <= plan.rmax
                    assert cx0 % 4 == 0 and cx1 % 4 == 0 and sx0 < sx1
                    assert sx1 - sx0 <= plan.smax and cx1 - cx0 <= plan.smax + 8
                    assert cx0 <= max(sx0 - 2, 0) and cx1 >= min(sx1 + 2, W)
                    assert avail_c[0] <= cx0 and cx1 <= avail_c[1]
                    if not whole:
                        assert avail_r[0] <= r_lo + e0 - 2 and r_lo + e1 + 2 <= avail_r[1]
                    cover[e0:e1, sx0:sx1] += 1
                assert (cover[:, X0:X1] == 1).all() and cover.sum() == E * (X1 - X0), \
                    f"{mesh_shape} {co} sms={sms} k={k} sub-step {j}"
                avail_r = (0, H) if whole else (r_lo, r_lo + E)
                if j < k - 1:  # scratch row r + 2k, lane x - col0 + xh
                    assert 0 <= X0 - sh.col0 + xh and X1 - sh.col0 + xh <= scols
                    if not whole:
                        assert 0 <= r_lo + 2 * k and r_lo + E + 2 * k <= srows


def test_column_scratch_serves_every_shallower_k():
    """A column shard's scratch (`pass_sh_scratch`): ``min(k - 1, 2)``
    buffers of 12 planes of h + 4k rows (a mesh of one row: H) x w +
    2 pass_xh(k) lanes, each as large as a pass at any k' <= k takes."""
    H, W = 64, 64
    for ms in ((2, 2), (1, 2)):
        sh = S.Shard.of(H, W, ms, (0, 1))
        assert S.pass_sh_scratch(sh, 1, "cpu") is None
        for k in (2, 3, 4):
            buf = S.pass_sh_scratch(sh, k, "cpu")
            rows = H if sh.h == H else sh.h + 4 * k
            assert tuple(buf.shape) == (min(k - 1, 2), 12, rows, sh.w + 2 * S.pass_xh(k))
            for kj in range(2, k + 1):
                need = 12 * (H if sh.h == H else sh.h + 4 * kj) * (sh.w + 2 * S.pass_xh(kj))
                assert buf.shape[0] >= min(kj - 1, 2) and buf[0].numel() >= need


# --- argument checks ---

def test_column_checks_and_routes():
    """The pass takes a column shard with 2k <= w, 4k < W and w % 4 == 0
    (and refuses one outside them), blocks of `pass_xh` lanes and 2k rows
    only, and no lean class on a column mesh; the fluid runner takes the
    pass on every mesh by default, its k the deepest the shards take; so do
    the C runners (their passes' column instances), ``"launches"`` when
    asked, and the C passes refuse a column shard without its blocks."""
    _, tc, _, s, fl = _case()
    H, W = RES
    assert [S.pass_xh(k) for k in range(1, 5)] == [4, 4, 8, 8]
    for ms, k in (((2, 2), 4), ((1, 2), 4), ((1, 4), 4), ((1, 8), 2)):
        run = S.make_sharded_tiled_fluid_runner(tc, _mesh(ms), tile_rows=8, x_ext=2)
        assert (run.route, run.k) == ("pass", k), ms
        assert S.default_k(run.shards[0]) == k
    with pytest.raises(ValueError, match="too deep"):  # 2k > w = 4
        S.make_sharded_tiled_fluid_runner(tc, _mesh((1, 8)), x_ext=2, k=3)
    S._check_depth(S.Shard.of(H, 24, (1, 2), (0, 0)), 4)  # w = 12: 2k = 8, 4k = 16 < 24
    with pytest.raises(ValueError, match="too deep"):  # 4k >= W
        S._check_depth(S.Shard.of(H, 16, (1, 2), (0, 0)), 4)
    with pytest.raises(ValueError, match="w % 4"):
        S._check_depth(S.Shard.of(H, 36, (1, 6), (0, 1)), 1)
    mesh = _mesh((2, 2))
    f, rho, vel = (split(s[x], mesh) for x in ("f", "rho", "vel"))
    sh = S.Shard.of(H, W, (2, 2), (0, 1))
    hx = HA.exchange([[f[i], vel[i], rho[i]] for i in range(4)], mesh, S.pass_xh(2), rows=4)
    S.fluid_pass_sh(f[1], rho[1], vel[1], hx[1], 0, 2, tc, fl, sh)
    for bad in (HA.exchange([[f[i], vel[i], rho[i]] for i in range(4)], mesh, S.XH, rows=4)[1],
                HA.exchange([[f[i], vel[i], rho[i]] for i in range(4)], mesh, 4, rows=2)[1],
                HA.Halo(12, hx[1].top, hx[1].bot, k=4)):
        with pytest.raises(ValueError, match="do not match"):
            S.fluid_pass_sh(f[1], rho[1], vel[1], bad, 0, 2, tc, fl, sh)
    with pytest.raises(ValueError, match="row mesh"):
        S.fluid_pass_sh(f[1], rho[1], vel[1], hx[1], 0, 2, tc, fl, sh, lean=True)
    cc = T.JRLCConfig(res=RES, Re=4.0, Pe=5.0, shape="45degree")
    flags = T.c_init(cc, "cpu")[2]
    vf = torch.zeros(2, 2, H, W)
    assert S.make_sharded_tiled_balance_runner(cc, flags, mesh, tile_rows=8).route == "pass"
    assert S.make_sharded_tiled_approach_runner(cc, vf, mesh, tile_rows=8).route == "pass"
    assert S.make_sharded_tiled_balance_runner(cc, flags, mesh, tile_rows=8,
                                               route="launches").route == "launches"
    assert S.make_sharded_tiled_approach_runner(cc, vf, mesh, tile_rows=8,
                                                route="launches").route == "launches"
    with pytest.raises(ValueError, match="do not match"):
        S._check_c_pass_sh(sh, None, 10, None, 1)
