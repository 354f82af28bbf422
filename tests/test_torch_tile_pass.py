"""The k = 1 split pass in one launch (`kernels/jrl_tiled.py::fluid_pass`,
`csrc/fluid_pass.cu`) on the CPU, where the wrapper runs its plain twin:
the launch's blocks (runs of rows by strips of columns) cover the pass
once, with the class of each row as `class_rows` gives it over whole
travels; the halo proof (each block's cells computed from its input
window, the rest of the grid NaN, equal the whole-grid pass bit for bit);
the route (k = 1 takes the pass, k > 1 the classes, ``route=`` forces
either); the tiled runner through the pass against the JAX package's jnp
step. The kernel against the two class kernels, on a card, is in
`test_torch_cuda.py`; the twin against the interpreted Pallas split chunk
in `test_torch_tiled.py`.

Inputs come from numpy with a seed; JAX states enter the port through
`models/jrl.py::state_from_numpy`. Tolerances: the twin against the class
twins and the halo proof bit for bit (they share the arithmetic of the
port's whole-grid step); the runner against the jnp step f and rho 1e-5,
vel 2e-4 over 12 steps.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)
from hypothesis import given, settings
from hypothesis import strategies as st

from jrl_lbm_tpu.models import jrl as J
from jrl_lbm_torch.kernels import jrl_tiled as K
from jrl_lbm_torch.models import jrl as T


def _kw(shape, res=(48, 32), **kw):
    return dict(dict(res=res, Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8,
                     shape=shape), **kw)


def _noisy(cfg, seed):
    s, fields = T.fluid_init(cfg, "cpu")
    rng = np.random.default_rng(seed)
    return {k: v + torch.as_tensor((1e-3 * rng.standard_normal(tuple(v.shape))).astype(np.float32))
            for k, v in s.items()}, fields


# --- the decomposition: host arithmetic ---

@st.composite
def _plans(draw):
    """A grid (H % 8 == 0, W % 4 == 0, some wider than one strip), a k = 1
    split plan of it (`class_rows` of a frontier and a below-tip tile) and
    a card's SM count."""
    TH = draw(st.sampled_from((8, 16, 32, 64)))
    n = draw(st.integers(3, 40))
    H, W = n * TH, 4 * draw(st.integers(1, 400))
    fr = draw(st.integers(0, n - 2))
    fb = draw(st.integers(0, fr))
    sms = draw(st.sampled_from((1, 16, 114, 132, 264)))
    return (H, W, *K.class_rows(H, TH, 1, fr, fb), sms)


@settings(max_examples=300, deadline=None, database=None)
@given(_plans())
def test_pass_blocks_cover_every_cell_once(plan):
    H, W, full, bt, lean, sms = plan
    items = K.pass_items(H, W, full, lean, sms)
    cover = np.zeros((H, W), np.int32)
    cls = np.full((H, W), -1)
    for y0, y1, c, sx0, sx1 in items:
        assert 0 <= y0 < y1 <= H and 0 <= sx0 < sx1 <= W
        assert y1 - y0 + 4 <= H  # a run's window holds each row once
        # the block's A columns fit its threads; its window is 16-byte aligned
        assert min(sx1 + 1, W) - max(sx0 - 1, 0) <= K.PASS_THREADS
        cx0, cx1 = K.pass_window(W, sx0, sx1)
        assert cx0 % 4 == 0 and cx1 % 4 == 0 and cx0 <= max(sx0 - 2, 0)
        assert cx1 >= min(sx1 + 2, W) and cx1 - cx0 <= K.PASS_THREADS + 8
        cover[y0:y1, sx0:sx1] += 1
        cls[y0:y1, sx0:sx1] = c
    want = np.zeros((H, W), np.int32)
    for y0, y1 in full + lean:
        want[y0:y1] = 1
    np.testing.assert_array_equal(cover, want)
    for segs, c in ((full, K.TILE_FULL), (lean, K.TILE_LEAN)):
        for y0, y1 in segs:
            assert (cls[y0:y1] == c).all()
    # each run lies in one segment; about one block an SM
    wanted = max(1, sms // len(K.pass_strips(W)))
    runs = K.pass_runs(H, full, lean, wanted)
    assert len(items) == len(runs) * len(K.pass_strips(W))
    assert len(runs) <= min(K.PASS_MAX_RUNS, wanted + len(full) + len(lean))


# the refine-8 ethaline case (1024x512; Re 4 so that the travel is short,
# the same tile plans as the default case) and a flat tip on the same grid
TRAVELS = {
    "ethaline-1024x512": dict(shape="ethaline", refine=8, res=(128, 64)),
    "cylinder-1024x512": dict(shape="cylinder", res=(1024, 512)),
}


@pytest.mark.parametrize("case", sorted(TRAVELS))
def test_pass_row_classes_equal_class_rows_over_the_travel(case):
    cfg = T.JRLFluidConfig(**dict(dict(Re=4.0, vel_obs_real=0.2848), **TRAVELS[case]))
    H, W = cfg.eff_res
    TH = K.pick_tile_rows(cfg)
    plans = {(fr, fb) for kind, _, _, fr, fb in K.chunk_plan(cfg, 0, cfg.total_steps)
             if kind == "split"}
    assert len(plans) >= 3
    for fr, fb in sorted(plans):
        full, bt, lean = K.class_rows(H, TH, 1, fr, fb)
        want = [None] * H
        for segs, name in ((full, "full"), (lean, "lean")):
            for y0, y1 in segs:
                want[y0:y1] = [name] * (y1 - y0)
        got = [None] * H
        for y0, y1, cls, _, _ in K.pass_items(H, W, full, lean):
            got[y0:y1] = [{K.TILE_FULL: "full", K.TILE_LEAN: "lean"}[cls]] * (y1 - y0)
        assert got == want, (fr, fb)
        for y0, y1 in bt:  # the below-tip rows stay with fluid_k_bt
            assert want[y0:y1] == [None] * (y1 - y0)


def test_pass_params_pack_the_runs():
    cfg = T.JRLFluidConfig(shape="ethaline", refine=8)
    full, lean = ((0, 384), (960, 1024)), ((384, 960),)
    p = K._pass_params(cfg, full, lean, 132)
    runs = [(c & 0x7FFF, (c >> 15) & 0x7FFF, c >> 30) for c in p.run[:p.nruns]]
    assert runs == [r[:3] for r in K.pass_items(1024, 512, full, lean, 132)]
    # 448 full rows and 576 lean ones at half a full row's cost: runs of 5-6
    # full or 12 lean rows, 123 blocks for the 132 SMs
    assert (p.nstrips, p.rs, p.nruns) == (1, 512, 123)
    assert {(y1 - y0, c) for y0, y1, c in runs} == {(5, K.TILE_FULL), (6, K.TILE_FULL),
                                                    (12, K.TILE_LEAN)}


# --- the halo proof: each block from its input window ---

def _outside(t, rows, cols):
    """``t`` NaN everywhere but on ``rows`` x ``cols``."""
    out = torch.full_like(t, float("nan"))
    keep = torch.zeros(t.shape[-2:], dtype=torch.bool)
    keep[np.ix_(rows, cols)] = True
    return torch.where(keep, t, out)


def test_each_block_needs_only_its_window():
    """Ethaline at refine 2 (256x128, TH 64: full tiles {0, 1, 3}, lean {2}
    at step 0). For every block of the launch, the twin on a grid NaN
    beyond the block's input window (rows y0 - 2 .. y1 + 1 mod H, its
    strip's window columns) computes the block's cells as the whole-grid
    pass does, bit for bit. The twin runs the block's class on its
    segment cut to 4 rows around the block, so that it reads 2 rows into
    the NaN past each end of the window."""
    cfg = T.JRLFluidConfig(**_kw("ethaline", res=(128, 64), refine=2))
    H, W = cfg.eff_res
    full, bt, lean = K.class_rows(H, K.pick_tile_rows(cfg), 1, *K.chunk_plan(cfg, 0, 8)[0][3:])
    assert (full, bt, lean) == ([(0, 128), (192, 256)], [], [(128, 192)])
    s, _ = _noisy(cfg, 3)
    step = 2
    want = {n: torch.full_like(v, 7.0) for n, v in s.items()}
    K.fluid_pass(s["f"], s["rho"], s["vel"], want, full, lean, step, cfg)
    items = K.pass_items(H, W, full, lean)
    assert {(y1 - y0, c) for y0, y1, c, *_ in items} == {(2, K.TILE_FULL), (4, K.TILE_LEAN)}
    for y0, y1, cls, sx0, sx1 in items:
        rows = [y % H for y in range(y0 - 2, y1 + 2)]
        cols = list(range(*K.pass_window(W, sx0, sx1)))
        seg = next(sg for sg in (full if cls == K.TILE_FULL else lean) if sg[0] <= y0 < sg[1])
        seg = (max(seg[0], y0 - 4), min(seg[1], y1 + 4))
        got = {n: torch.full_like(v, 7.0) for n, v in s.items()}
        args = ([seg], []) if cls == K.TILE_FULL else ([], [seg])
        K.fluid_pass_ref(*(_outside(s[n], rows, cols) for n in ("f", "rho", "vel")), got,
                         *args, step, cfg)
        for n in ("f", "rho", "vel"):
            g, w = got[n][..., y0:y1, sx0:sx1], want[n][..., y0:y1, sx0:sx1]
            assert torch.isfinite(g).all(), f"{n}: NaN reached rows {y0}..{y1 - 1}"
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=f"{n} rows {y0}..{y1 - 1}")


# --- the twin and the route ---

def _mid_travel(cfg):
    """A step of the (80, 32) grid with below-tip tiles under a flat tip
    (as `test_torch_tiled.py` takes it)."""
    return int((40.0 - cfg.inflow_height) / cfg.vel_obs)


@pytest.mark.parametrize("shape", ["45degree", "cylinder"])
def test_fluid_pass_on_cpu_equals_the_class_twins(shape):
    """On the CPU the wrapper is its twin: the full and lean twins on their
    rows, bit for bit, and no launch counted."""
    cfg = T.JRLFluidConfig(**_kw(shape, res=(80, 32)))
    step = 3 if shape == "45degree" else _mid_travel(cfg)
    c, TH = K.tile_consts(cfg), 8
    fr, fb = K.frontier(c, TH, 1, step + 1), min(K.below(c, TH, 1, step), K.frontier(
        c, TH, 1, step + 1))
    full, bt, lean = K.class_rows(80, TH, 1, fr, fb)
    assert lean and (shape == "45degree" or bt)
    s, _ = _noisy(cfg, 4)
    got, want = ({n: torch.full_like(v, 7.0) for n, v in s.items()} for _ in range(2))
    n0 = K.fluid_pass.launches
    K.fluid_pass(s["f"], s["rho"], s["vel"], got, full, lean, step, cfg)
    K.fluid_k_ref(s["f"], s["rho"], s["vel"], want, full, step, 1, cfg)
    K.fluid_k_lean_ref(s["f"], want, lean, 1, cfg)
    assert K.fluid_pass.launches == n0
    for n in ("f", "rho", "vel"):
        assert torch.equal(got[n], want[n]), n


def _spied():
    """Patches recording which wrapper each pass calls (the twins run)."""
    calls = []

    def spy(name, twin):
        def call(*a, **kw):
            calls.append(name)
            return twin(*a, **kw)
        return call

    return calls, mock.patch.multiple(
        K, fluid_pass=spy("fluid_pass", K.fluid_pass_ref), fluid_k=spy("fluid_k", K.fluid_k_ref),
        fluid_k_lean=spy("fluid_k_lean", K.fluid_k_lean_ref),
        fluid_k_bt=spy("fluid_k_bt", K.fluid_k_bt_ref))


@pytest.mark.parametrize("k,route,want", [
    (1, None, ["fluid_pass", "fluid_k_bt"]),
    (1, "pass", ["fluid_pass", "fluid_k_bt"]),
    (1, "classes", ["fluid_k", "fluid_k_lean", "fluid_k_bt"]),
    (2, None, ["fluid_k", "fluid_k_lean", "fluid_k_bt"]),
    (2, "classes", ["fluid_k", "fluid_k_lean", "fluid_k_bt"]),
])
def test_route_takes_the_pass_at_k_1(k, route, want):
    cfg = T.JRLFluidConfig(**_kw("cylinder", res=(80, 32)))
    step = _mid_travel(cfg)
    c = K.tile_consts(cfg)
    fr = K.frontier(c, 8, k, step + k)
    segs = K.class_rows(80, 8, k, fr, min(K.below(c, 8, k, step), fr))
    assert all(segs), segs
    s, _ = _noisy(cfg, 5)
    calls, patches = _spied()
    with patches:
        K.k_pass(s, {n: torch.empty_like(v) for n, v in s.items()}, segs, step, k, cfg, route)
    assert calls == want
    run = K.make_tiled_fluid_runner(cfg, tile_rows=8, k=k, route=route)
    assert run.route == ("pass" if want[0] == "fluid_pass" else "classes")


def test_route_pass_refuses_what_it_cannot_run():
    cfg = T.JRLFluidConfig(**_kw("45degree", res=(80, 32)))
    with pytest.raises(ValueError, match="k = 1"):
        K.make_tiled_fluid_runner(cfg, tile_rows=8, k=2, route="pass")
    with pytest.raises(ValueError, match="one of"):
        K.pass_route(cfg, 1, "tiles")
    odd = T.JRLFluidConfig(**_kw("45degree", res=(80, 30)))
    assert K.pass_route(odd, 1) == "classes"
    with pytest.raises(ValueError, match="W % 4"):
        K.pass_route(odd, 1, "pass")


# --- the runner through the pass against the jnp step ---

@functools.lru_cache(maxsize=None)
def _jnp_step(jc):
    return jax.jit(J.make_fluid_step(jc))


@pytest.mark.parametrize("shape,res", [("cylinder", (48, 32)), ("45degree", (80, 32))])
def test_runner_through_the_pass_matches_jnp_step(shape, res):
    jc, tc = J.JRLFluidConfig(**_kw(shape, res=res)), T.JRLFluidConfig(**_kw(shape, res=res))
    n, start = 12, 3
    js, jf = J.fluid_init(jc)
    rng = np.random.default_rng(6)
    state = {k: (np.asarray(v) + 1e-3 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in js.items()}
    js = {k: jnp.asarray(v) for k, v in state.items()}
    for i in range(n):
        js = _jnp_step(jc)(js, jf, jnp.asarray(start + i, jnp.int32))
    run = K.make_tiled_fluid_runner(tc, tile_rows=8, unroll=4, route="pass")
    assert any(kind == "split" for kind, *_ in K.chunk_plan(tc, start, n, 8, 4))
    _, tf = T.fluid_init(tc, "cpu")
    calls, patches = _spied()
    with patches:
        got = run(T.state_from_numpy(state, "cpu"), tf, start, n)
    assert "fluid_pass" in calls and "fluid_k" not in calls
    for key, tol in (("f", 1e-5), ("rho", 1e-5), ("vel", 2e-4)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(js[key]), rtol=tol, atol=tol,
                                   err_msg=key)
