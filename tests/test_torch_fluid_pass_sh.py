"""The sharded JRL fluid step's k-step pass (`kernels/jrl_sharded.py::
fluid_pass_sh`, `csrc/fluid_pass_sh.cu`) and the row-mesh route of the
sharded fluid runner on the CPU, where the wrapper runs its plain twin:
the runner through the pass at k = 1..4 against the JAX package's jnp
step and, bit for bit, against the port's per-step runner and the A/B
pair (``route="launches"``); the lean shards inside the pass, and why a
lean pass needs its 2k-row reach clear of the tip; the halo proof (each
shard's pass from a grid that is NaN beyond its 2k-row pieces); the
kernel's schedule (sub-steps in turn over the shard's extended rows, tile
by tile, each tile from its own window, NaN beyond it) played on the CPU
against the twin; JAX's own ``_make_fluid_k_kernel(shard=True)`` in
interpret mode against the twin; the host plan of a launch; the argument
checks. The kernel against the pair, on a card, is in
`test_torch_cuda.py`.

Inputs come from the JAX init plus seeded numpy noise. Tolerances: the jnp
step f and rho 2e-5, vel 2e-4 over 12 steps (as
`tests/test_torch_jrl_sharded.py`); the interpreted Pallas kernel 1e-5,
vel 2e-4 after one pass (its bodies fold divides into reciprocals); the
port's runners, twins and the played schedule against each other bit for
bit (they share the arithmetic of the port's whole-grid step).
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from jrl_lbm_tpu.models import jrl as J
from jrl_lbm_tpu.ops.pallas import fused_jrl_tiled as JT
from jrl_lbm_torch.kernels import halo as HA
from jrl_lbm_torch.kernels import jrl_sharded as S
from jrl_lbm_torch.kernels import jrl_tiled as TL
from jrl_lbm_torch.models import jrl as T
from jrl_lbm_torch.parallel.mesh import make_mesh, split
from jrl_lbm_torch.utils.device import state_from_numpy

RES, N = (48, 32), 12  # 48 rows by 32 columns, 12 steps
TOL = {"f": 2e-5, "rho": 2e-5, "vel": 2e-4}


def _kw(shape, res=RES):
    return dict(res=res, Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8, shape=shape)


def _mesh(shape):
    return make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))


@functools.lru_cache(maxsize=None)
def _case(shape, res=RES):
    """``(jax cfg, torch cfg, numpy state, torch state, torch fields)``: the
    JAX init plus seeded noise."""
    jc, tc = J.JRLFluidConfig(**_kw(shape, res)), T.JRLFluidConfig(**_kw(shape, res))
    state, _ = J.fluid_init(jc)
    rng = np.random.default_rng(18)
    state = {k: (np.asarray(v) + 1e-4 * rng.standard_normal(np.shape(v))).astype(np.float32)
             for k, v in state.items()}
    return jc, tc, state, state_from_numpy(state, "cpu"), T.fluid_init(tc, "cpu")[1]


@functools.lru_cache(maxsize=None)
def _jnp_run(shape):
    jc, _, state, _, _ = _case(shape)
    _, fields = J.fluid_init(jc)
    step = jax.jit(J.make_fluid_step(jc))
    js = {k: jnp.asarray(v) for k, v in state.items()}
    for i in range(N):
        js = step(js, fields, jnp.asarray(i, jnp.int32))
    return {k: np.asarray(v) for k, v in js.items()}


@functools.lru_cache(maxsize=None)
def _per_step(shape, start, n, res=RES):
    _, tc, _, s, fl = _case(shape, res)
    return T.make_per_step_fluid_runner(tc)(s, fl, start, n)


def _equal(got, want, tag):
    for k in want:
        assert torch.equal(got[k], want[k]), f"{tag} {k}"


# --- the runner through the pass ---

@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 1), (3, 1)])
def test_pass_route_matches_jnp_and_the_pair(mesh_shape, k):
    """12 steps at 48x32 (the wedge's tip crosses a row): one exchange and
    one `fluid_pass_sh` a shard a pass (the remainder at a smaller k); the
    jnp step at 2e-5 (vel 2e-4); the per-step runner and the A/B pair bit
    for bit."""
    _, tc, _, s, fl = _case("45degree")
    mesh = _mesh(mesh_shape)
    run = S.make_sharded_tiled_fluid_runner(tc, mesh, tile_rows=8, unroll=4, k=k)
    assert (run.route, run.k) == ("pass", k)
    with mock.patch.object(S, "fluid_pass_sh", wraps=S.fluid_pass_sh) as fp, \
            mock.patch.object(S, "exchange", wraps=S.exchange) as ex, \
            mock.patch.object(S, "fluid_a_sh", wraps=S.fluid_a_sh) as fa:
        got = run(s, fl, 0, N)
    passes = -(-N // k)
    assert ex.call_count == passes and fp.call_count == passes * mesh_shape[0]
    assert not fa.called
    assert [c.args[5] for c in fp.call_args_list[::mesh_shape[0]]] == \
        [k] * (N // k) + ([N % k] if N % k else [])
    for key, tol in TOL.items():
        np.testing.assert_allclose(got[key].numpy(), _jnp_run("45degree")[key], rtol=tol,
                                   atol=tol, err_msg=f"{mesh_shape} k={k} {key}")
    _equal(got, _per_step("45degree", 0, N), f"{mesh_shape} k={k} per-step")
    pair = S.make_sharded_tiled_fluid_runner(tc, mesh, tile_rows=8, unroll=4, route="launches")
    _equal(got, pair(s, fl, 0, N), f"{mesh_shape} k={k} launches")


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_lean_shards_run_lean_inside_the_pass(k):
    """(4, 1) over 96x32 with a flat tip: shard 2 runs every pass lean, and
    shard 1 (row 24, the tip near row 21) at k = 1 only, where its reach
    stays clear of the tip; the result is bit for bit ``lean_split=False``
    and the per-step runner."""
    _, tc, _, s, fl = _case("cylinder", (96, 32))
    mesh = _mesh((4, 1))
    lean = S.make_sharded_tiled_fluid_runner(tc, mesh, tile_rows=8, unroll=3, k=k)
    with mock.patch.object(S, "fluid_pass_sh", wraps=S.fluid_pass_sh) as fp:
        a = lean(s, fl, 0, 6)
    assert lean.lean_steps == {(0, 0): 0, (1, 0): 6 if k == 1 else 0, (2, 0): 6, (3, 0): 0}
    assert [c.args[-1] for c in fp.call_args_list[:4]] == [False, k == 1, True, False]
    b = S.make_sharded_tiled_fluid_runner(tc, mesh, tile_rows=8, unroll=3, k=k,
                                          lean_split=False)(s, fl, 0, 6)
    _equal(a, b, f"k={k} lean vs full")
    _equal(a, _per_step("cylinder", 0, 6, (96, 32)), f"k={k} lean vs unsharded")


@pytest.mark.parametrize("k", [2, 3, 4])
def test_a_lean_pass_needs_its_reach_clear_of_the_tip(k):
    """Shard 1 of the (4, 1) flat-tip case is lean for every step of a pass
    by the per-step rule (`lean_shard`), but a k-step pass reads 2k rows
    below it, into the tip's reach: the lean class there gives other
    values, so `lean_pass` keeps it full."""
    _, tc, _, s, fl = _case("cylinder", (96, 32))
    mesh = _mesh((4, 1))
    H, W = tc.eff_res
    sh = S.Shard.of(H, W, (4, 1), (1, 0))
    assert all(S.lean_shard(tc, sh, st) for st in range(k)) and not S.lean_pass(tc, sh, 0, k)
    f, rho, vel = (split(s[x], mesh) for x in ("f", "rho", "vel"))
    hx = HA.exchange([[f[i], vel[i], rho[i]] for i in range(4)], mesh, S.XH, rows=2 * k)
    full = S.fluid_pass_sh_ref(f[1], rho[1], vel[1], hx[1], 0, k, tc, fl, sh)
    lean = S.fluid_pass_sh_ref(f[1], rho[1], vel[1], hx[1], 0, k, tc, fl, sh, lean=True)
    assert not all(torch.equal(x, y) for x, y in zip(full, lean))


def test_lean_pass_at_k_1_is_the_per_step_rule():
    _, tc, _, _, _ = _case("cylinder", (96, 32))
    H, W = tc.eff_res
    for ms in ((3, 1), (4, 1), (6, 1)):
        for c in range(ms[0]):
            sh = S.Shard.of(H, W, ms, (c, 0))
            for st in range(0, 400, 7):
                assert S.lean_pass(tc, sh, st, 1) == S.lean_shard(tc, sh, st), (ms, c, st)


# --- the halo proof: each shard's pass from its 2k-row pieces ---

@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("mesh_shape", [(2, 1), (3, 1)])
def test_each_shard_pass_needs_only_its_pieces(mesh_shape, k):
    """For every shard: the global state NaN beyond the shard's rows and 2k
    rows a side (mod H), split and exchanged; the shard's pass equals k
    per-step steps on its rows, bit for bit, and is finite."""
    _, tc, _, s, fl = _case("45degree")
    H, W = tc.eff_res
    mesh = _mesh(mesh_shape)
    want = _per_step("45degree", 3, k)
    for i, (iy, _) in enumerate(mesh.local):
        sh = S.Shard.of(H, W, mesh_shape, (iy, 0))
        keep = torch.zeros(H, dtype=torch.bool)
        keep[torch.arange(sh.row0 - 2 * k, sh.row0 + sh.h + 2 * k) % H] = True
        cut = {x: torch.where(keep[:, None], v, torch.full_like(v, float("nan")))
               for x, v in s.items()}
        f, rho, vel = (split(cut[x], mesh) for x in ("f", "rho", "vel"))
        hx = HA.exchange([[f[j], vel[j], rho[j]] for j in range(len(f))], mesh, S.XH,
                         rows=2 * k)
        got = S.fluid_pass_sh(f[i], rho[i], vel[i], hx[i], 3, k, tc, fl, sh)
        for name, g in zip(("f", "rho", "vel"), got):
            assert torch.isfinite(g).all(), f"{mesh_shape} k={k} shard {i} {name}: NaN reached"
            assert torch.equal(g, sh.body(want[name])), f"{mesh_shape} k={k} shard {i} {name}"


# --- JAX's shard mode of the k-step kernel, interpreted ---

def _pallas_shard_pass(jc, state, ny, iy, k, step, TH=8):
    """One pass of ``_make_fluid_k_kernel(cfg_c, TH, k, shard=True)`` on
    shard ``iy`` of a ``(ny, 1)`` split: the SMEM step and row offset, the
    shard's 2k-row pieces of [f, vel, rho] padded to 8 rows as
    ``fused_jrl_sharded.py::_pieces`` pads its rows (real rows next to the
    body), the ``_k_specs`` blocks of the shard."""
    cfg_c = JT._cfg_consts(jc)
    H, W = cfg_c["H"], cfg_c["W"]
    h, r2 = H // ny, 2 * k
    row0 = iy * h
    upg, dng, m2, m3, h2, h3 = JT._k_specs(h, W, TH)
    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    pb = pl.BlockSpec((12, 8, W), lambda i: (0, 0, 0))
    grp = np.concatenate([state["f"], state["vel"], state["rho"][None]], axis=0)
    z = np.zeros((12, 8 - r2, W), np.float32)
    tp = np.concatenate([z, grp[:, np.arange(row0 - r2, row0) % H]], axis=1)
    bt = np.concatenate([grp[:, np.arange(row0 + h, row0 + h + r2) % H], z], axis=1)
    f, rho, vel = (jnp.asarray(state[x][..., row0:row0 + h, :]) for x in ("f", "rho", "vel"))
    f32 = jnp.float32
    with pltpu.force_tpu_interpret_mode():
        out = pl.pallas_call(
            JT._make_fluid_k_kernel(cfg_c, TH, k, shard=True),
            grid=(h // TH,),
            in_specs=[smem, smem, m3(), h3(upg), h3(dng), m3(2), h3(upg, 2), h3(dng, 2), m2(),
                      h2(upg), h2(dng), pb, pb],
            out_specs=[m3(), m2(), m3(2)],
            out_shape=[jax.ShapeDtypeStruct((9, h, W), f32), jax.ShapeDtypeStruct((h, W), f32),
                       jax.ShapeDtypeStruct((2, h, W), f32)],
            compiler_params=JT._VMEM_PARAMS,
        )(jnp.asarray(step, f32).reshape(1, 1), jnp.asarray([row0], jnp.int32), f, f, f, vel, vel,
          vel, rho, rho, rho, jnp.asarray(tp), jnp.asarray(bt))
    return [np.asarray(x) for x in out], torch.as_tensor(tp[:, 8 - r2:]), \
        torch.as_tensor(bt[:, :r2])


@pytest.mark.parametrize("k", [1, 2])
def test_pallas_shard_mode_matches_twin(k):
    """Each shard of a (2, 1) split of 48x32 (wedge tip) from step 5: JAX's
    kernel in shard mode, which no JAX runner builds, against
    `fluid_pass_sh_ref` from the same pieces, 1e-5 (vel 2e-4)."""
    jc, tc, state, s, fl = _case("45degree")
    H, W = tc.eff_res
    for iy in range(2):
        (fj, rj, vj), top, bot = _pallas_shard_pass(jc, state, 2, iy, k, 5)
        sh = S.Shard.of(H, W, (2, 1), (iy, 0))
        got = S.fluid_pass_sh_ref(sh.body(s["f"]), sh.body(s["rho"]), sh.body(s["vel"]),
                                  HA.Halo(12, top.contiguous(), bot.contiguous(), k=2 * k), 5, k,
                                  tc, fl, sh)
        for name, g, w, tol in zip(("f", "rho", "vel"), got, (fj, rj, vj), (1e-5, 1e-5, 2e-4)):
            np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol,
                                       err_msg=f"k={k} shard {iy} {name}")


# --- the tiles' schedule, played tile by tile on the CPU ---

def _emulate(sh, f, rho, vel, halo, step0, k, cfg, plan, lean=False):
    """`fluid_pass_sh`'s tiles as the kernel schedules them: sub-step j
    over the shard's rows extended by 2 (k - 1 - j) a side, tile after
    tile of ``plan``, each tile's A on its rows and columns one past its
    B cells and its B from a window of rows -2 .. R + 1 and columns two
    past the tile (NaN beyond it, and beyond what the sub-step before
    wrote: the scratch starts as NaN); the class bodies of the twin
    (`jrl_tiled.py`) on that window."""
    H, W, k = sh.H, sh.W, int(k)
    nan = float("nan")
    r2 = 2 * k

    def grid(body, planes):
        b = body.reshape(-1, sh.h, W)
        g = torch.full((b.shape[0], H, W), nan)
        if halo is not None and halo.top is not None:
            g[:, torch.arange(sh.row0 - r2, sh.row0) % H] = halo.top[planes]
            g[:, torch.arange(sh.row0 + sh.h, sh.row0 + sh.h + r2) % H] = halo.bot[planes]
        g[:, sh.row0:sh.row0 + sh.h] = b
        return g

    cur = {"f": grid(f, slice(0, 9)), "rho": grid(rho, slice(11, 12))[0],
           "vel": grid(vel, slice(9, 11))}
    rows = S.pass_sh_rows(sh, k)
    for j in range(k):
        lvl = k - 1 - j
        r_lo = 0 if sh.h == H else -2 * lvl
        nxt = {"f": torch.full((9, H, W), nan), "rho": torch.full((H, W), nan),
               "vel": torch.full((2, H, W), nan)}
        for e0, e1, sx0, sx1, _, _ in plan.tiles(j, rows[j], W):
            R, y0 = e1 - e0, sh.row0 + r_lo + e0
            win = torch.arange(y0 - 2, y0 + R + 2) % H
            cols = torch.zeros(W, dtype=torch.bool)
            cols[max(sx0 - 2, 0):min(sx1 + 2, W)] = True

            def cut(x):
                return torch.where(cols, x.index_select(-2, win), torch.full((), nan))

            if lean:
                f1, rho1, vel1 = TL._a_lean(cfg, R + 2, cut(cur["f"]))
                fo = TL._b_lean(cfg, R, f1[:, 1:-1], rho1, vel1)
            else:
                f1, rho1, vel1 = TL._a_full(cfg, step0 + j, y0 - 1, R + 2, cut(cur["f"]),
                                            cut(cur["vel"]), cut(cur["rho"])[1:-1])
                fo = TL._b_full(cfg, step0 + j, y0, R, f1[:, 1:-1], rho1, vel1)
            out = torch.arange(y0, y0 + R) % H
            nxt["f"][:, out, sx0:sx1] = fo[:, :, sx0:sx1]
            nxt["rho"][out, sx0:sx1] = rho1[1:-1, sx0:sx1]
            nxt["vel"][:, out, sx0:sx1] = vel1[:, 1:-1, sx0:sx1]
        cur = nxt
    return sh.body(cur["f"]), sh.body(cur["rho"]), sh.body(cur["vel"])


# tiles of about R x S cells a k, so that bands and strips of unequal
# size, and both grid edges, meet inside the 48x32 grid
EMU_TILES = {1: (5, 12), 2: (7, 8), 3: (4, 16), 4: (6, 12)}


def _pass_inputs(tc, s, mesh, k):
    f, rho, vel = (split(s[x], mesh) for x in ("f", "rho", "vel"))
    hx = HA.exchange([[f[i], vel[i], rho[i]] for i in range(len(f))], mesh, S.XH, rows=2 * k)
    return f, rho, vel, hx


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 1), (3, 1)])
def test_tile_schedule_equals_the_twin(mesh_shape, k):
    """Every shard's pass played tile by tile (`_emulate`, the plan of
    ``EMU_TILES[k]``; a mesh of one row wraps its rows), each tile from its
    own window only: bit for bit `fluid_pass_sh_ref` from step 5 (the
    wedge's tip crosses rows), and finite."""
    _, tc, _, s, fl = _case("45degree")
    H, W = tc.eff_res
    mesh = _mesh(mesh_shape)
    f, rho, vel, hx = _pass_inputs(tc, s, mesh, k)
    for i, (iy, _) in enumerate(mesh.local):
        sh = S.Shard.of(H, W, mesh_shape, (iy, 0))
        plan = S.tile_plan(sh, k, *EMU_TILES[k])
        assert plan.ntx > 1 and min(plan.nty) > 1
        halo = hx[i] if mesh_shape[0] > 1 else None
        got = _emulate(sh, f[i], rho[i], vel[i], halo, 5, k, tc, plan)
        want = S.fluid_pass_sh_ref(f[i], rho[i], vel[i], halo, 5, k, tc, fl, sh)
        for name, g, w in zip(("f", "rho", "vel"), got, want):
            assert torch.isfinite(g).all(), f"{mesh_shape} k={k} shard {i} {name}: NaN reached"
            assert torch.equal(g, w), f"{mesh_shape} k={k} shard {i} {name}"


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_tile_schedule_of_the_lean_class(k):
    """The lean class (9 input planes, no geometry) played tile by tile on
    the (4, 1) flat-tip shard that `lean_pass` keeps lean at every k: bit
    for bit the lean twin, and the full class's own schedule on it equals
    the full twin."""
    _, tc, _, s, fl = _case("cylinder", (96, 32))
    H, W = tc.eff_res
    mesh = _mesh((4, 1))
    f, rho, vel, hx = _pass_inputs(tc, s, mesh, k)
    sh = S.Shard.of(H, W, (4, 1), (2, 0))
    assert S.lean_pass(tc, sh, 0, k)
    plan = S.tile_plan(sh, k, *EMU_TILES[k])
    for lean in (True, False):
        got = _emulate(sh, f[2], rho[2], vel[2], hx[2], 0, k, tc, plan, lean)
        want = S.fluid_pass_sh_ref(f[2], rho[2], vel[2], hx[2], 0, k, tc, fl, sh, lean)
        for name, g, w in zip(("f", "rho", "vel"), got, want):
            assert torch.equal(g, w), f"k={k} lean={lean} {name}"


# --- the launch's host plan ---

@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("W", [32, 128, 512, 1024, 4 * 333])
def test_pass_sh_plan_covers_the_shard(W, k):
    """On an inner (4, 1) shard and a mesh of one row of a 1024-row grid,
    for one SM, an H100's 132 and a tile asked for: every extended row of
    every sub-step written exactly once, each tile's window (two rows and
    columns a side, 16-byte ends) inside what the sub-step before wrote
    (or the shard and its 2k-row pieces) and inside a table row; the tables
    in the shared memory, the scratch rows in the buffers, the grid within
    the blocks."""
    H = 1024
    for ms, co in (((4, 1), (1, 0)), ((1, 1), (0, 0))):
        sh = S.Shard.of(H, W, ms, co)
        whole = sh.h == H
        rows = S.pass_sh_rows(sh, k)
        assert rows == ([H] * k if whole else [sh.h + 4 * (k - 1 - j) for j in range(k)])
        for sms, tile in ((1, None), (132, None), (132, (10, 60))):
            plan = S.pass_sh_plan(sh, k, sms) if tile is None else S.tile_plan(sh, k, *tile, sms)
            assert len(plan.nty) == k and 1 <= plan.grid <= sms
            assert plan.smax % 4 == 0 and plan.rmax + 5 <= H
            assert S.tile_smem_bytes(plan.rmax, plan.smax) <= S.TILE_SMEM_CAP
            # rows a sub-step may read: the shard and its pieces, then the
            # rows the sub-step before wrote (shard rows; all rows mod H)
            avail = (0, H) if whole else (-2 * k, sh.h + 2 * k)
            for j, E in enumerate(rows):
                r_lo = 0 if whole else -2 * (k - 1 - j)
                cover = np.zeros((E, W), np.int32)
                for e0, e1, sx0, sx1, cx0, cx1 in plan.tiles(j, E, W):
                    assert e0 < e1 <= E and e1 - e0 <= plan.rmax
                    assert sx0 % 4 == 0 and cx0 % 4 == 0 and cx1 % 4 == 0 and sx0 < sx1
                    assert sx1 - sx0 <= plan.smax and cx1 - cx0 <= plan.smax + 8
                    assert cx0 <= max(sx0 - 2, 0) and cx1 >= min(sx1 + 2, W)
                    if not whole:
                        assert avail[0] <= r_lo + e0 - 2 and r_lo + e1 + 2 <= avail[1]
                    cover[e0:e1, sx0:sx1] += 1
                assert (cover == 1).all(), f"{ms} sms={sms} k={k} sub-step {j}"
                avail = (0, H) if whole else (r_lo, r_lo + E)
                if j < k - 1 and not whole:  # scratch row r + 2k of h + 4k
                    assert 0 <= r_lo + 2 * k and r_lo + E + 2 * k <= sh.h + 4 * k
    with pytest.raises(ValueError, match="outgrow"):
        S.tile_plan(S.Shard.of(H, 512, (4, 1), (1, 0)), 2, 200, 512)
    # the (4, 1) shard of 256x512: one wave of at most 132 tiles at every k
    for k_ in range(1, 5):
        plan = S.pass_sh_plan(S.Shard.of(1024, 512, (4, 1), (1, 0)), k_)
        assert plan.grid <= 132 and all(n * plan.ntx <= 132 for n in plan.nty)


def test_pass_sh_scratch_serves_every_shallower_k():
    """The scratch a runner holds for its k (`pass_sh_scratch`): none at k
    = 1; else ``min(k - 1, 2)`` buffers of 12 planes of the shard's rows
    extended by 2k a side (a mesh of one row: its H rows), each as large as
    a pass at any k' <= k takes (the kernel's own layout at k': 12 planes
    of h + 4k' rows), so one buffer serves the run's shorter last pass."""
    H, W = 64, 32
    for ms, co in (((4, 1), (1, 0)), ((1, 1), (0, 0))):
        sh = S.Shard.of(H, W, ms, co)
        assert S.pass_sh_scratch(sh, 1, "cpu") is None
        for k in (2, 3, 4):
            buf = S.pass_sh_scratch(sh, k, "cpu")
            rows = H if sh.h == H else sh.h + 4 * k
            assert tuple(buf.shape) == (min(k - 1, 2), 12, rows, W)
            assert buf.dtype == torch.float32 and buf.is_contiguous()
            for kj in range(2, k + 1):
                need = 12 * (H if sh.h == H else sh.h + 4 * kj) * W
                assert buf.shape[0] >= min(kj - 1, 2) and buf[0].numel() >= need


# --- argument checks ---

def test_route_and_depth_checks():
    """Every mesh takes the pass (column meshes with its x window,
    `test_torch_fluid_pass_sh_cols.py`), the C runners too (their column
    instances, `test_torch_c_pass_sh_cols.py`); k outside 1..4, a k
    whose 2k-row pieces outgrow the shard, pieces of another depth, a lean
    pass off the inner shards and a column mesh's shard without its blocks
    are refused."""
    _, tc, _, s, fl = _case("45degree")
    H, W = tc.eff_res
    assert S.make_sharded_tiled_fluid_runner(tc, _mesh((2, 2)), tile_rows=8).route == "pass"
    assert S.make_sharded_tiled_fluid_runner(tc, _mesh((1, 1))).route == "pass"
    # the default k: PASS_SH_K where the shards take it, one shard too
    assert S.make_sharded_tiled_fluid_runner(tc, _mesh((1, 1))).k == S.PASS_SH_K == 4
    assert S.make_sharded_tiled_fluid_runner(tc, _mesh((2, 1))).k == S.PASS_SH_K
    assert S.make_sharded_tiled_fluid_runner(tc, _mesh((12, 1)), tile_rows=4).k == 2
    assert S.make_sharded_tiled_fluid_runner(tc, _mesh((2, 1)), route="launches").route == \
        "launches"
    cc = T.JRLCConfig(res=RES, Re=4.0, Pe=5.0, shape="45degree")
    assert S.make_sharded_tiled_balance_runner(cc, T.c_init(cc, "cpu")[2], _mesh((2, 2)),
                                               tile_rows=8, route="pass").route == "pass"
    with pytest.raises(ValueError, match="one of"):
        S.make_sharded_tiled_fluid_runner(tc, _mesh((2, 1)), route="tiles")
    for k in (0, 5):
        with pytest.raises(ValueError, match="1 <= k <= 4"):
            S.make_sharded_tiled_fluid_runner(tc, _mesh((2, 1)), k=k)
    with pytest.raises(ValueError, match="too deep"):
        S.make_sharded_tiled_fluid_runner(tc, _mesh((12, 1)), tile_rows=4, k=3)
    mesh = _mesh((3, 1))
    f, rho, vel = (split(s[x], mesh) for x in ("f", "rho", "vel"))
    hx = HA.exchange([[f[i], vel[i], rho[i]] for i in range(3)], mesh, S.XH, rows=2)
    sh = S.Shard.of(H, W, (3, 1), (0, 0))
    with pytest.raises(ValueError, match="do not match"):
        S.fluid_pass_sh(f[0], rho[0], vel[0], hx[0], 0, 2, tc, fl, sh)
    with pytest.raises(ValueError, match="inner shards"):
        S.fluid_pass_sh(f[0], rho[0], vel[0], hx[0], 0, 1, tc, fl, sh, lean=True)
    with pytest.raises(ValueError, match="do not match"):
        S.fluid_pass_sh(f[0], rho[0], vel[0], None, 0, 1, tc, fl,
                        S.Shard.of(H, W, (1, 2), (0, 0)))
