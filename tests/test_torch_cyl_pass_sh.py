"""The sharded cylinder's lean-split pass in one launch
(`kernels/cyl_sharded.py::cyl_pass_sh`, `csrc/cyl_pass_sh.cu`) on the CPU,
where the wrapper runs its plain twin `cyl_pass_sh_ref`: the launch's
blocks (runs of a shard's rows by strips of its columns) cover the shard
once, each cell in the class of its row (the band windows "cyl", the rest
"lean"); the halo proof (each block's cells computed from its window, the
rest of the grid, pieces included, NaN, equal `cyl_lean_sh_ref` followed
by `cyl_window_sh_ref` on each band window bit for bit, and a window one
row or lane short lets NaN in); the route (the pass for k <= 4 on the lean
split, ``route="launches"`` the two launches, ``route="pass"`` refusing
what the pass cannot run). The runner through the pass against the JAX
package's jnp step is in `test_torch_cyl_sharded.py`; the kernel against
the launches and its twin, on a card, in `test_torch_cuda.py`.

Scenes as `test_torch_cyl_sharded.py`'s (96 rows, 32 columns a shard, D
7.4, the band inside a shard at cy 24 and across a shard's edge at cy 48),
from the port's init with numpy noise of a seed. Tolerance: bit for bit
(`torch.equal`, every cell): the same cell arithmetic on the same values.
"""

from unittest import mock

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from jrl_lbm_torch.kernels import cyl_sharded as CS
from jrl_lbm_torch.kernels import cylinder as K
from jrl_lbm_torch.kernels import halo as HA
from jrl_lbm_torch.models import cylinder as TC
from jrl_lbm_torch.parallel.mesh import make_mesh, split

MESHES = [(2, 1), (2, 4), (2, 2)]


def _scene(mesh_shape, cy, k, seed=5):
    """The shards' states, halos (k rows, k lanes) and band windows."""
    ny, nx = mesh_shape
    W = 32 * nx
    cfg = TC.CylinderConfig(res=(96, W), D=7.4, Re=500.0, cylinder_center=(W / 2.0, cy))
    s, fl = TC.init(cfg, "cpu")
    rng = np.random.default_rng(seed)
    s = {n: v + torch.as_tensor((1e-3 * rng.standard_normal(tuple(v.shape))).astype(np.float32))
         for n, v in s.items()}
    mesh = make_mesh(mesh_shape, ["cpu"] * (ny * nx))
    f, rho, vel = (split(s[x], mesh) for x in ("f", "rho", "vel"))
    flags, phi = split(fl["flags"], mesh), split(fl["phi_obs"], mesh)
    L = range(ny * nx)
    halos = HA.exchange([CS.lean_group(f[i], rho[i], vel[i], flags[i], phi[i]) for i in L], mesh,
                        k if nx > 1 else 0, rows=k)
    regions = CS._fix_regions(cfg, margin=4.0 + (k - 1))
    shards = [CS.CylShard.of(96, W, mesh_shape, co, k, k) for co in mesh.local]
    states = [(f[i], rho[i], vel[i], flags[i], phi[i]) for i in L]
    return cfg, K.consts(cfg), shards, states, halos, regions


def _launches_ref(st, halo, k, c, sh, regions):
    """`cyl_lean_sh_ref`, then `cyl_window_sh_ref` on each band window."""
    out = [x.clone() for x in CS.cyl_lean_sh_ref(st[0], halo, k, c, sh)]
    for b0, nb in CS.band_windows(sh, regions):
        CS.cyl_window_sh_ref(*st, halo, k, b0, nb, out, c, sh)
    return out


# --- the decomposition: host arithmetic ---

@pytest.mark.parametrize("cy", [24.0, 48.0])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_items_cover_every_shard_cell_once_in_its_class(mesh_shape, k, cy):
    """Every cell of every shard is written by exactly one block, with the
    class of its row (the band windows the lean split places, the rest
    lean); strips on multiples of 8 columns; each block's ring rows hold
    its window on 16-byte ends and fit the class's ring row, its window the
    threads; the window walks up where it computes the global row 0; about
    one wave; a shard that misses the band has no "cyl" item."""
    _, _, shards, _, _, regions = _scene(mesh_shape, cy, k)
    for sh in shards:
        windows = CS.band_windows(sh, regions)
        rows = CS.pass_sh_rows(sh, windows)
        for sms, width in ((132, None), (4, 16)):
            items = CS.cyl_pass_sh_items(sh, k, rows, sms=sms, max_width=width)
            hits = torch.zeros((sh.h, sh.w), dtype=torch.int64)
            owner = torch.full((sh.h, sh.w), -1, dtype=torch.int64)
            for y0, y1, cls, x0, x1, a0, a1, desc in items:
                hits[y0:y1, x0:x1] += 1
                owner[y0:y1, x0:x1] = cls
                assert x0 % 8 == 0 and x1 % 8 == 0 and 0 <= x0 < x1 <= sh.w
                assert a0 % 4 == 0 and a1 % 4 == 0 and a0 <= x0 - k and a1 >= x1 + k
                assert a1 - a0 <= K.cyl_pass_rs(cls, k, 4)
                assert x1 - x0 + 2 * k <= K.cyl_pass_cols(k)
                assert desc == (sh.row0 == 0 and y0 < k)
            assert bool((hits == 1).all())
            want = torch.zeros((sh.h, sh.w), dtype=torch.int64)
            for b0, nb in windows:
                want[b0:b0 + nb] = CS.CLS_CYL
            assert torch.equal(owner, want)
            if not windows:
                assert {it[2] for it in items} == {CS.CLS_LEAN}
            if sms == 132:
                assert len(items) <= 132 * K.CP_BLOCKS_PER_SM


def test_rows_and_fits():
    sh = CS.CylShard.of(96, 128, (2, 4), (0, 1), 2, 2)
    assert CS.pass_sh_rows(sh, [(16, 16)]) == (((0, 16), (32, 48)), ((16, 32),))
    assert CS.pass_sh_rows(sh, []) == (((0, 48),), ())
    assert CS.pass_sh_rows(sh, [(0, 16)]) == (((16, 48),), ((0, 16),))
    assert CS.pass_sh_fits(sh, 2) and not CS.pass_sh_fits(sh, 3)  # pieces of 2 rows and lanes
    assert not CS.pass_sh_fits(sh, 5)
    assert not CS.pass_sh_fits(CS.CylShard.of(96, 120, (2, 4), (0, 0), 1, 1), 1)  # w = 30
    wide = CS.CylShard.of(96, 32, (2, 1), (1, 0), 4, 0)
    assert CS.pass_sh_fits(wide, 4)  # a mesh of one column: no lanes needed
    with pytest.raises(ValueError, match="cyl_pass_sh takes"):
        CS.cyl_pass_sh_items(sh, 3, CS.pass_sh_rows(sh, []))
    # at k > 1 a window stops at the grid's first and last rows, at k = 1 it wraps
    top, bot = (CS.CylShard.of(96, 32, (2, 1), (i, 0), 2, 0) for i in (0, 1))
    assert CS.pass_sh_window(top, 2, (0, 8, 0, 0, 32)) == ((0, 10), (-2, 34))
    assert CS.pass_sh_window(bot, 2, (40, 48, 0, 0, 32)) == ((38, 48), (-2, 34))
    top1 = CS.CylShard.of(96, 32, (2, 1), (0, 0), 1, 0)
    assert CS.pass_sh_window(top1, 1, (0, 8, 0, 0, 32)) == ((-1, 9), (-1, 33))


# --- the halo proof: each block from its window ---

@pytest.mark.parametrize("cy", [24.0, 48.0])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_pass_twin_equals_the_two_launches_twins(mesh_shape, k, cy):
    """On every shard, `cyl_pass_sh_ref` (each block on the grid NaN beyond
    its window: the body and the pieces) equals `cyl_lean_sh_ref` followed
    by `cyl_window_sh_ref` on each band window, bit for bit in f, rho and
    vel on every cell, with blocks of 16 columns (body strips and strips
    reading the column blocks or the wrap, runs reading the pieces)."""
    _, c, shards, states, halos, regions = _scene(mesh_shape, cy, k)
    for sh, st, halo in zip(shards, states, halos):
        rows = CS.pass_sh_rows(sh, CS.band_windows(sh, regions))
        items = CS.cyl_pass_sh_items(sh, k, rows, sms=4, max_width=16)
        got = CS.cyl_pass_sh_ref(*st, halo, k, rows, c, sh, items=items)
        want = _launches_ref(st, halo, k, c, sh, regions)
        for name, g, w in zip(("f", "rho", "vel"), got, want):
            assert torch.isfinite(g).all(), f"{sh} {name}: NaN reached a block's cells"
            assert torch.equal(g, w), f"{sh} {name}"


@pytest.mark.parametrize("k", [1, 4])
def test_a_window_one_row_or_lane_short_lets_nan_in(k):
    """The halo proof is not vacuous: on the (2, 2) mesh with the band
    across the shards' edge, a lean block and a band block reading the
    pieces, and a strip reading the column block, each on a window one row
    (or one lane) short at either end, give NaN on their cells."""
    _, c, shards, states, halos, regions = _scene((2, 2), 48.0, k)
    i = next(j for j, sh in enumerate(shards) if sh.row0 == 48 and sh.col0 == 0)
    sh, st, halo = shards[i], states[i], halos[i]
    rows = CS.pass_sh_rows(sh, CS.band_windows(sh, regions))
    items = CS.cyl_pass_sh_items(sh, k, rows, sms=4, max_width=16)
    lean = next(it for it in items if it[2] == CS.CLS_LEAN and it[0] > 0)
    band = next(it for it in items if it[2] == CS.CLS_CYL and it[0] == 0)
    cut = ((lean, (1, 0, 0, 0)), (lean, (0, -1, 0, 0)), (band, (1, 0, 0, 0)),
           (band, (0, -1, 0, 0)), (next(it for it in items if it[4] == sh.w), (0, 0, 0, -1)))
    window = CS.pass_sh_window
    for item, (dy0, dy1, dx0, dx1) in cut:
        def short(s_, k_, it_, d=(dy0, dy1, dx0, dx1)):
            (r0, r1), (c0, c1) = window(s_, k_, it_)
            return (r0 + d[0], r1 + d[1]), (c0 + d[2], c1 + d[3])

        with mock.patch.object(CS, "pass_sh_window", short):
            f1, _, _ = CS.cyl_pass_sh_ref(*st, halo, k, rows, c, sh, items=[item])
        y0, y1, _, x0, x1 = item[:5]
        assert torch.isnan(f1[:, y0:y1, x0:x1]).any(), (item, dy0, dy1, dx0, dx1)


# --- the route ---

def _spied():
    calls = []

    def spy(name, twin):
        def call(*a, **kw):
            calls.append(name)
            return twin(*a, **kw)
        return call

    names = ("cyl_lean_sh", "cyl_window_sh", "cyl_pass_sh")  # on the CPU each runs its twin
    return calls, mock.patch.multiple(CS, **{n: spy(n, getattr(CS, n)) for n in names})


@pytest.mark.parametrize("route,want", [
    (None, ["cyl_pass_sh"] * 2),
    ("pass", ["cyl_pass_sh"] * 2),
    ("launches", ["cyl_lean_sh", "cyl_lean_sh", "cyl_window_sh"]),
])
def test_route_takes_the_pass_on_the_lean_split(route, want):
    """(2, 1) at k = 2 with the band inside one shard: a pass through one
    `cyl_pass_sh` call a shard (or the two launches, the window on the
    band's shard only); the same bits either way."""
    cfg = TC.CylinderConfig(res=(96, 32), D=7.4, Re=500.0, cylinder_center=(16.0, 24.0))
    s, fl = TC.init(cfg, "cpu")
    mesh = make_mesh((2, 1), ["cpu"] * 2)
    run = CS.make_sharded_fused_cylinder_runner(cfg, mesh, lean_k=2, route=route)
    assert run.stepk.lean_route == ("launches" if route == "launches" else "pass")
    calls, patches = _spied()
    with patches:
        got = run(s, fl, 2)
    assert calls == want
    yard = CS.make_sharded_fused_cylinder_runner(cfg, mesh, lean_k=2, route="launches")(s, fl, 2)
    for n in ("f", "rho", "vel"):
        assert torch.equal(got[n], yard[n]), n


def test_route_choice_and_refusals():
    """The default takes the pass for k <= 4 on the lean split, the two
    launches for k = 5..8; ``route="pass"`` refuses k > 4, pieces short
    of k lanes and a route that is not the lean split; no other route
    changes."""
    cfg = TC.CylinderConfig(res=(96, 32), D=7.4, Re=500.0, cylinder_center=(16.0, 48.0))
    m21 = make_mesh((2, 1), ["cpu"] * 2)
    mk = CS.make_sharded_fused_cylinder_step
    for k in (1, 2, 3, 4):
        assert mk(cfg, m21, lean_k=k).lean_route == "pass"
    for k in (5, 8):
        assert mk(cfg, m21, lean_k=k).lean_route == "launches"
        with pytest.raises(ValueError, match="route='pass'"):
            mk(cfg, m21, lean_k=k, route="pass")
    assert mk(cfg, m21, lean_k=2, route="launches").lean_route == "launches"
    with pytest.raises(ValueError, match="one of"):
        mk(cfg, m21, route="tiles")
    with pytest.raises(ValueError, match="lean split"):
        mk(cfg, m21, lean_split=False, route="pass")
    for kw in (dict(lean_split=False), dict(lean_split=False, tile_rows=8)):
        st = mk(cfg, m21, **kw)
        assert st.lean_route is None and st.route in ("padded", "pieces")
    cfg4 = TC.CylinderConfig(res=(96, 128), D=7.4, Re=500.0, cylinder_center=(64.0, 48.0))
    m24 = make_mesh((2, 4), ["cpu"] * 8)
    assert mk(cfg4, m24, lean_k=2, lean_x_ext=8, lean_x_halo=4).lean_route == "pass"
    with pytest.raises(ValueError, match="route='pass'"):
        mk(cfg4, m24, lean_x_halo=0, route="pass")  # no column blocks on a mesh of four columns


def test_pass_on_cpu_counts_no_launch():
    cfg = TC.CylinderConfig(res=(96, 32), D=7.4, Re=500.0, cylinder_center=(16.0, 24.0))
    s, fl = TC.init(cfg, "cpu")
    CS.reset_launches()
    CS.make_sharded_fused_cylinder_runner(cfg, make_mesh((2, 1), ["cpu"] * 2))(s, fl, 2)
    assert CS.cyl_pass_sh.launches == 0
