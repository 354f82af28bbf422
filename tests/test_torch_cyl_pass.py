"""The cylinder channel's k-step pass in one launch
(`kernels/cylinder.py::cyl_pass`, `csrc/cyl_pass.cu`) on the CPU, where the
wrapper runs its plain twin `cyl_pass_ref`: the launch's blocks (runs of
rows by strips of columns) cover the pass once, each cell in the class of
its row; the halo proof (each block's cells computed from its window, the
rest of the grid NaN, equal the three twins of the launches the pass
replaces bit for bit, in float32, bf16 and stochastically rounded bf16);
the stochastic-rounding keys (three a pass, interior, cyl, edge); the
route (k = 4 and k = 2 passes take the pass, single steps never,
``route="launches"`` the three launches); the runner through the pass
against the JAX package's jnp runner. The kernel against the three
launches and against its twin, on a card, is in `test_torch_cuda.py`.

Inputs come from numpy with a seed; JAX states enter the port through
`models/cylinder.py::state_from_numpy`. Tolerances: the twin against the
three launches' twins bit for bit (the same cell arithmetic on every
cell a block writes); the runner against the jnp runner those of
`tests/test_torch_cylinder.py::test_fused_runner_matches_jnp` (f and rho
2e-5, vel 2e-4, non-OBSTACLE cells: the fused step's OBSTACLE rule
differs from the jnp step's).
"""

from unittest import mock

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)
from hypothesis import given, settings
from hypothesis import strategies as st

from jrl_lbm_tpu.models import cylinder as J
from jrl_lbm_torch.kernels import cylinder as K
from jrl_lbm_torch.models import cylinder as T
from jrl_lbm_torch.utils.types import CellType

TRAJ = {"f": 2e-5, "rho": 2e-5, "vel": 2e-4}
# the grids the pass runs on (bench.py's scene, the shedding gate's, its
# mini case, chip_smoke.py's split geometry) and a small one
SCENES = {
    "2048x2048": dict(res=(2048, 2048), D=64.0, Re=5000.0),
    "1600x800": dict(res=(1600, 800), Re=10000.0, D=20.0, cylinder_center=(400.0, 200.0)),
    "320x160": dict(res=(320, 160), Re=1800.0, Vmax=0.1, D=16.0, cylinder_center=(80.0, 160.0)),
    "256x128": dict(res=(256, 128), D=16.0, Re=500.0, cylinder_center=(64.0, 128.0)),
    "128x64": dict(res=(128, 64), D=8.0, Re=500.0, cylinder_center=(32.0, 64.0)),
}
MODES = [False, True, "sr"]


def _rows(scene, k, tile_rows=16):
    """(interior, cyl, edge) rows of the scene's k-step split."""
    step = K.make_fused_step2(T.CylinderConfig(**SCENES[scene]), tile_rows, k=k)
    assert step is not None, (scene, k)
    return step.rows


def _noisy(scene, seed, mode=False):
    cfg = T.CylinderConfig(**SCENES[scene])
    s, fields = T.init(cfg, "cpu")
    rng = np.random.default_rng(seed)
    s = {n: v + torch.as_tensor((1e-3 * rng.standard_normal(tuple(v.shape))).astype(np.float32))
         for n, v in s.items()}
    return cfg, dict(s, f=K.f_to_storage(s["f"], mode)), fields


# --- the decomposition: host arithmetic ---

@settings(max_examples=60, deadline=None)
@given(scene=st.sampled_from(sorted(SCENES)), k=st.integers(2, 4), storage=st.integers(0, 2),
       sms=st.sampled_from((1, 16, 66, 114, 132)), width=st.sampled_from((None, 24, 56)))
def test_items_cover_every_cell_once_in_its_class(scene, k, storage, sms, width):
    """Every cell of the pass's rows is written by exactly one block, with
    the class of the segment that holds its row; strips on multiples of 8
    columns; each block's ring rows hold its window on 16-byte ends; its
    window fits the threads and its rings the shared memory; a window that
    holds row 0 walks up, none reaches both border rows; about one wave."""
    H, W = SCENES[scene]["res"]
    rows = _rows(scene, k)
    items = K.cyl_pass_items(H, W, k, *rows, storage, sms, max_width=width)
    owner = torch.full((H, W), -1, dtype=torch.int64)
    hits = torch.zeros((H, W), dtype=torch.int64)
    es = 4 if storage == 0 else 2
    a = 16 // es
    for y0, y1, cls, x0, x1, a0, a1, desc in items:
        hits[y0:y1, x0:x1] += 1
        owner[y0:y1, x0:x1] = cls
        assert x0 % 8 == 0 and x1 % 8 == 0 and 0 <= x0 < x1 <= W
        (r0, r1), (c0, c1) = K.cyl_pass_window(H, W, k, (y0, y1, cls, x0, x1))
        assert a0 % a == 0 and (a1 % a == 0 or a1 == W) and a0 <= c0 and c1 <= a1 <= W
        assert a1 - a0 - (c1 - c0) < 2 * a
        assert c1 - c0 <= K.cyl_pass_cols(k)
        rs = -(-(a1 - a0) // 8) * 8
        assert K.cyl_pass_smem(cls, k, rs, es) <= K.cyl_pass_budget(K.CP_BLOCKS_PER_SM)
        assert desc == (y0 < k) and not (desc and y1 > H - k)
        if cls != K.CLS_EDGE:  # the interior and band windows stay off the border rows
            assert r0 >= 1 and r1 <= H - 1
    want = torch.full((H, W), -1, dtype=torch.int64)
    for cls, segs in enumerate(rows):
        for y0, y1 in segs:
            want[y0:y1] = cls
    covered = want >= 0
    assert bool((hits[covered] == 1).all()) and bool((hits[~covered] == 0).all())
    assert torch.equal(owner, want)
    n_strips = [len(K.cyl_pass_strips(W, min(K.cyl_pass_strip(c, k, es), width or W)))
                for c in range(3)]
    one_each = sum(n * len(segs) for n, segs in zip(n_strips, rows))
    assert len(items) <= max(sms * K.CP_BLOCKS_PER_SM, one_each)


def test_items_raise_where_the_pass_cannot_run():
    rows = _rows("256x128", 4)
    with pytest.raises(ValueError, match="W % 8"):
        K.cyl_pass_items(256, 124, 4, *rows)
    with pytest.raises(ValueError, match="2 <= k <= 4"):
        K.cyl_pass_items(256, 128, 5, *rows)
    with pytest.raises(ValueError, match="from the border"):
        K.cyl_pass_items(256, 128, 4, [(2, 32)], *rows[1:])


# --- the halo proof: each block from its window ---

def _equal(got, want, tag):
    for n in ("f", "rho", "vel"):
        g, w = got[n], want[n]
        if g.dtype == torch.bfloat16:
            g, w = g.view(torch.int16), w.view(torch.int16)
        else:
            assert torch.isfinite(g).all(), f"{tag} {n}: NaN reached a block's cells"
        assert torch.equal(g, w), f"{tag} {n}"


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", [2, 4])
def test_each_block_needs_only_its_window(k, mode):
    """256x128 cut into blocks of 32 columns (body strips and wall strips,
    edge windows walking up and down): `cyl_pass_ref` computes each block
    on the grid NaN beyond the block's window (`cyl_pass_window`: rows and
    strip k cells a side, cut at the border) with the block's class twin,
    and the pass equals the three launches' twins on the whole grid bit
    for bit, rho and vel of the interior rows left as they were."""
    cfg, s, fields = _noisy("256x128", 7, mode)
    c = K.consts(cfg)
    rows = _rows("256x128", k)
    items = K.cyl_pass_items(256, 128, k, *rows, K._storage(mode), sms=4, max_width=32)
    assert {it[2] for it in items} == {0, 1, 2} and {it[7] for it in items} == {0, 1}
    assert len({(it[3], it[4]) for it in items}) == 4
    keys = ((9, 3), (9, 4), (9, 5)) if mode == "sr" else (None, None, None)
    args = (s["f"], s["vel"], fields["flags"], fields["phi_obs"])
    base = {n: torch.full_like(v, 7.0) for n, v in s.items()}
    got, want = ({n: v.clone() for n, v in base.items()} for _ in range(2))
    K.cyl_pass_ref(*args, got, rows, k, c, False, mode, keys if mode == "sr" else None,
                   items=items)
    K.cyl_interior_k_ref(s["f"], want, rows[0], k, c, False, mode, keys[0])
    K.cyl_band_k_ref(*args, want, rows[1], k, False, c, mode, keys[1])
    K.cyl_band_k_ref(*args, want, rows[2], k, True, c, mode, keys[2])
    _equal(got, want, f"k={k} bf16_dev={mode!r}")


def test_a_window_one_row_short_lets_nan_in():
    """The halo proof is not vacuous: an interior block on a window one row
    short at either end, and the bottom edge block one row short at its
    top, give NaN on their cells."""
    cfg, s, fields = _noisy("256x128", 8)
    c = K.consts(cfg)
    rows = _rows("256x128", 4)
    items = K.cyl_pass_items(256, 128, 4, *rows, sms=4, max_width=32)
    interior = next(it for it in items if it[2] == K.CLS_INTERIOR)
    bottom = next(it for it in items if it[2] == K.CLS_EDGE and it[1] == 256)
    for item, (dy0, dy1) in ((interior, (1, 0)), (interior, (0, -1)), (bottom, (1, 0))):
        y0, y1, _, x0, x1 = item[:5]
        (r0, r1), (c0, c1) = K.cyl_pass_window(256, 128, 4, item)
        keep = torch.zeros((256, 128), dtype=torch.bool)
        keep[r0 + dy0:r1 + dy1, c0:c1] = True
        cut = {n: torch.where(keep, v, torch.full_like(v, float("nan"))) for n, v in s.items()}
        out = {n: torch.zeros_like(v) for n, v in s.items()}
        if item[2] == K.CLS_INTERIOR:
            K.cyl_interior_k_ref(cut["f"], out, [(y0, y1)], 4, c, True)
        else:
            K.cyl_band_k_ref(cut["f"], cut["vel"], fields["flags"], fields["phi_obs"], out,
                             [(y0, y1)], 4, True, c)
        assert torch.isnan(out["f"][:, y0:y1, x0:x1]).any(), (item, dy0, dy1)


# --- the stochastic-rounding keys ---

def test_sr_pass_takes_three_keys_interior_cyl_edge():
    """A stochastic-rounding pass takes three consecutive keys of the
    step's `LaunchKeys`, the interior rows' first, then the cylinder
    band's, then the edge rows'; each block stores under its class's key;
    a seed replays its bits, another seed gives others."""
    cfg, s, fields = _noisy("128x64", 9, "sr")
    seen = []

    def spy(twin, cls_of):
        def call(*a, **kw):
            seen.append((cls_of(a), a[-1]))
            return twin(*a, **kw)
        return call

    def run(seed, passes=2):
        step = K.make_fused_step2(cfg, 16, k=4, bf16_dev="sr", seed=seed)
        return step, [step(s, fields) for _ in range(passes)]

    patches = mock.patch.multiple(
        K, cyl_interior_k_ref=spy(K.cyl_interior_k_ref, lambda a: "interior"),
        cyl_band_k_ref=spy(K.cyl_band_k_ref, lambda a: "edge" if a[7] else "cyl"))
    with patches:
        step, (a1, a2) = run(5)
    assert step.keys.n == 6
    half = len(seen) // 2
    for calls, n0 in ((seen[:half], 0), (seen[half:], 3)):
        by_class = {cls: {key for c_, key in calls if c_ == cls} for cls in ("interior", "cyl",
                                                                            "edge")}
        assert by_class == {"interior": {(5, n0)}, "cyl": {(5, n0 + 1)}, "edge": {(5, n0 + 2)}}
    _, (b1,) = run(5, 1)
    _, (c1,) = run(6, 1)
    for n in ("f", "rho", "vel"):
        x, y = a1[n], b1[n]
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        assert torch.equal(x, y), n
    assert not torch.equal(a1["f"].view(torch.int16), c1["f"].view(torch.int16))
    assert not torch.equal(a1["f"].view(torch.int16), a2["f"].view(torch.int16))


# --- the route ---

def _spied():
    """Patches recording which wrapper each step calls (the twins run)."""
    calls = []

    def spy(name, twin):
        def call(*a, **kw):
            calls.append(name)
            return twin(*a, **kw)
        return call

    names = ("cyl_full", "cyl_interior", "cyl_interior_k", "cyl_band_k", "cyl_pass")
    return calls, mock.patch.multiple(K, **{n: spy(n, getattr(K, n + "_ref")) for n in names})


@pytest.mark.parametrize("route,k4,k2", [
    (None, ["cyl_pass"], ["cyl_pass"]),
    ("pass", ["cyl_pass"], ["cyl_pass"]),
    ("launches", ["cyl_interior_k", "cyl_band_k", "cyl_band_k"],
     ["cyl_interior_k", "cyl_band_k", "cyl_band_k"]),
])
def test_route_takes_the_pass_for_k_step_passes(route, k4, k2):
    """n = 7: a k = 4 pass, a k = 2 pass, a single split step; the passes
    through `cyl_pass` (or the three launches), the single step never."""
    cfg, s, fields = _noisy("128x64", 10)
    run = K.make_fused_cylinder_runner(cfg, route=route)
    assert run.route == (route or "pass")
    calls, patches = _spied()
    with patches:
        run(s, fields, 7)
    assert calls == k4 + k2 + ["cyl_interior", "cyl_full"]
    calls.clear()
    with patches:
        run.step(s, fields)
    assert calls == ["cyl_interior", "cyl_full"]


def test_route_pass_refuses_what_it_cannot_run():
    cfg = T.CylinderConfig(**SCENES["256x128"])
    with pytest.raises(ValueError, match="one of"):
        K.pass_route(cfg, 4, "tiles")
    with pytest.raises(ValueError, match="2 <= k <= 4"):
        K.make_fused_step2(cfg, 16, k=5, route="pass")
    assert K.make_fused_step2(cfg, 16, k=5).route == "launches"
    odd = T.CylinderConfig(res=(256, 132), D=16.0, Re=500.0, cylinder_center=(64.0, 128.0))
    assert K.pass_route(odd, 4) == "launches"


def test_pass_on_cpu_counts_no_launch():
    cfg, s, fields = _noisy("128x64", 11)
    step = K.make_fused_step2(cfg, 8, k=2)
    n0 = K.cyl_pass.launches
    step(s, fields)
    assert K.cyl_pass.launches == n0
    assert step.context(s, fields, [s]) is None


# --- the runner through the pass against the jnp runner ---

def test_runner_through_the_pass_matches_jnp():
    """n = 7 (a k = 4 pass, a k = 2 pass, a single step) on 128x64 from
    the JAX package's initial state: the port's runner through `cyl_pass`
    against `models/cylinder.py::make_runner` of the JAX package, and bit
    for bit the runner through the three launches."""
    kw = SCENES["128x64"]
    jc, tc = J.CylinderConfig(**kw), T.CylinderConfig(**kw)
    js, jf = J.init(jc)
    ts = T.state_from_numpy({n: np.asarray(v) for n, v in js.items()}, "cpu")
    tf = T.state_from_numpy({n: np.asarray(v) for n, v in jf.items()}, "cpu")
    want = J.make_runner(jc)(js, jf, 7)
    calls, patches = _spied()
    with patches:
        got = K.make_fused_cylinder_runner(tc)(ts, tf, 7)
    assert calls.count("cyl_pass") == 2 and "cyl_interior_k" not in calls
    yard = K.make_fused_cylinder_runner(tc, route="launches")(ts, tf, 7)
    mask = np.asarray(jf["flags"]) != int(CellType.OBSTACLE)
    for n in ("f", "rho", "vel"):
        assert torch.equal(got[n], yard[n]), n
        g, w = got[n].numpy(), np.asarray(want[n])
        m = np.broadcast_to(mask, g.shape)
        np.testing.assert_allclose(g[m], w[m], rtol=TRAJ[n], atol=TRAJ[n], err_msg=n)
