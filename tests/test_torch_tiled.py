"""The tile-class module of the PyTorch port (`kernels/jrl_tiled.py`) on the
CPU, where each wrapper runs its plain twin: the chunk plan against the
JAX package's ``make_tiled_fluid_runner`` over whole phases, the class
twins against the interpreted Pallas ``_fluid_k_split_chunk``, the
runner against the JAX package's jnp step, the TH > 2k guard and the
pick. The CUDA kernels against these twins, on a card, are in
`test_torch_cuda.py`.

Inputs come from numpy with a seed; JAX states enter the port through
`models/jrl.py::state_from_numpy`. Tolerances: 1e-5 against one Pallas
split chunk (the Pallas bodies fold divides into reciprocals), f and rho
2e-5 and vel 2e-4 against the jnp step over 12 steps, as
`tests/test_fused_jrl_tiled.py`; the twins against the port's own
whole-grid step exactly (they share its arithmetic).
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from jrl_lbm_tpu.models import jrl as J
from jrl_lbm_tpu.ops.pallas import fused_jrl_tiled as JT
from jrl_lbm_torch.kernels import jrl_tiled as K
from jrl_lbm_torch.models import jrl as T


def _kw(shape, res=(48, 32), **kw):
    return dict(dict(res=res, Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8,
                     shape=shape), **kw)


def _pair(shape, **kw):
    return J.JRLFluidConfig(**_kw(shape, **kw)), T.JRLFluidConfig(**_kw(shape, **kw))


@functools.lru_cache(maxsize=None)
def _jnp_step(jc):
    return jax.jit(J.make_fluid_step(jc))


def _jnp_steps(jc, state, start, n):
    """``n`` jnp steps of the JAX package from ``start``."""
    js, jf = J.fluid_init(jc)
    js = {key: jnp.asarray(v) for key, v in state.items()} if state is not None else js
    step = _jnp_step(jc)
    for i in range(n):
        js = step(js, jf, jnp.asarray(start + i, jnp.int32))
    return {key: np.asarray(v) for key, v in js.items()}


def _noisy_state(jc, seed=0):
    """The JAX package's initial state perturbed with numpy noise."""
    js = _jnp_steps(jc, None, 0, 0)
    rng = np.random.default_rng(seed)
    return {k: (v + 1e-3 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in js.items()}


@functools.lru_cache(maxsize=None)
def _jnp_run(shape, res, start, n):
    """A noisy initial state, taken as the state at step ``start``, and
    the state ``n`` jnp steps on (shared by the cases of one configuration)."""
    jc = J.JRLFluidConfig(**_kw(shape, res=res))
    state = _noisy_state(jc)
    return state, _jnp_steps(jc, state, start, n)


def _close(got, want, tol, tag):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=tag)


# --- the chunk plan, host only ---

# the refine-8 ethaline case of demo/batch_fluid.py --refine 8 (1024x512)
# and a flat tip on the same grid, whole travels
PLAN_CASES = {
    "ethaline-1024x512": dict(shape="ethaline", refine=8, res=(128, 64)),
    "cylinder-1024x512": dict(shape="cylinder", res=(1024, 512)),
}


def _jax_plan(jc, start, n, **run_kw):
    """The JAX runner's chunks, with its three chunk functions recorded
    and not run."""
    rec = []

    def split(f, rho, vel, s, cfg_key, TH, k, reps, fr, fb=0):
        rec.append(("split", int(s), reps, fr, fb))
        return f, rho, vel

    def kchunk(f, rho, vel, s, cfg_key, TH, k, reps):
        rec.append(("k", int(s), reps, None, None))
        return f, rho, vel

    def ab(f, rho, vel, s, cfg_key, TH, k):
        rec.append(("ab", int(s), k, None, None))
        return f, rho, vel

    with mock.patch.multiple(JT, _fluid_k_split_chunk=split, _fluid_k_chunk=kchunk,
                             _tiled_chunk=ab):
        JT.make_tiled_fluid_runner(jc, **run_kw)({"f": 0, "rho": 0, "vel": 0}, None, start, n)
    return rec


@pytest.mark.parametrize("case,run_kw", [
    ("ethaline-1024x512", {}),
    ("cylinder-1024x512", {}),
    ("ethaline-1024x512", dict(k=2, unroll=4)),
    ("cylinder-1024x512", dict(k=4)),
    ("cylinder-1024x512", dict(k=2, lean_split=False)),
])
def test_chunk_plan_matches_jax_over_the_whole_travel(case, run_kw):
    kw = dict(Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8, **PLAN_CASES[case])
    jc, tc = J.JRLFluidConfig(**kw), T.JRLFluidConfig(**kw)
    n = tc.total_steps
    want = _jax_plan(jc, 0, n, **run_kw)
    got = K.chunk_plan(tc, 0, n, **run_kw)
    assert got == want
    assert sum(r for kind, _, r, _, _ in got if kind != "ab") * (run_kw.get("k") or 1) \
        + sum(r for kind, _, r, _, _ in got if kind == "ab") == n
    if not run_kw:
        kinds = {kind for kind, *_ in got}
        assert "split" in kinds
        if case.startswith("ethaline"):
            # lean tiles from the start; the late travel falls to the A/B pair
            assert got[0][0] == "split" and got[-1][0] == "ab"
        else:
            # three-way splits (full + below-tip + lean) on the way
            assert any(kind == "split" and fb >= 1 and fr < 16 - 2 for kind, _, _, fr, fb in got)


# --- the class twins against the interpreted Pallas split chunk ---

@pytest.mark.parametrize("shape", ["45degree", "cylinder"])
def test_split_pass_matches_pallas_split_chunk(shape):
    """One k=1 split pass at 80x32, TH=8 (the sizes of
    tests/test_fused_jrl_tiled.py): 45degree full + lean; cylinder full +
    below-tip + lean, mid-travel; through both routes of the pass (the
    full and lean rows by ``fluid_pass``'s twin, or by the two class
    twins), which agree bit for bit."""
    jc, tc = _pair(shape, res=(80, 32))
    TH, k, reps = 8, 1, 1
    c = K.tile_consts(tc)
    s0 = 0 if shape == "45degree" else int((40.0 - tc.inflow_height) / tc.vel_obs)
    fr = K.frontier(c, TH, k, s0 + reps * k)
    fb = min(K.below(c, TH, k, s0), fr)
    assert fr <= 10 - 3 and (shape == "45degree" or fb >= 1), (fr, fb)
    state = _noisy_state(jc)
    cfg_key = tuple(sorted(JT._cfg_consts(jc).items()))
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        want = JT._fluid_k_split_chunk(*(jnp.asarray(state[n]) for n in ("f", "rho", "vel")),
                                       float(s0), cfg_key, TH, k, reps, fr, fb)
    segs = K.class_rows(80, TH, k, fr, fb)
    assert bool(segs[1]) == (shape == "cylinder") and segs[2]
    st = T.state_from_numpy(state, "cpu")
    got = {}
    for route in K.ROUTES:
        out = {n: torch.full_like(v, 7.0) for n, v in st.items()}
        got[route] = K.k_pass(st, out, segs, s0, k, tc, route)
        for name, w in zip(("f", "rho", "vel"), want):
            _close(got[route][name], w, 1e-5, f"{shape}:{route}:{name}")
    # fluid_pass_ref on the full and lean rows, the bt rows from their twin
    out = {n: torch.full_like(v, 7.0) for n, v in st.items()}
    K.fluid_pass_ref(st["f"], st["rho"], st["vel"], out, segs[0], segs[2], s0, tc)
    if segs[1]:
        K.fluid_k_bt_ref(st["f"], st["rho"], st["vel"], out, segs[1], k, tc)
    for name in ("f", "rho", "vel"):
        assert torch.equal(out[name], got["pass"][name]), name
        assert torch.equal(got["pass"][name], got["classes"][name]), name


# --- the runner against the jnp step ---

@pytest.mark.parametrize("shape,res,k", [
    ("cylinder", (48, 32), 1),   # full + below-tip + lean
    ("cylinder", (48, 32), 2),   # full + lean, then full + below-tip + lean
    ("45degree", (80, 32), 1),   # full + lean
    ("45degree", (80, 32), 2),
])
def test_tiled_runner_matches_jnp_step(shape, res, k):
    _, tc = _pair(shape, res=res)
    n, start = 12, 3
    state, js = _jnp_run(shape, res, start, n)
    plan = K.chunk_plan(tc, start, n, tile_rows=8, unroll=4, k=k)
    assert any(kind == "split" for kind, *_ in plan), plan
    _, tf = T.fluid_init(tc, "cpu")
    run = K.make_tiled_fluid_runner(tc, tile_rows=8, unroll=4, k=k)
    got = run(T.state_from_numpy(state, "cpu"), tf, start, n)
    for key, tol in (("f", 2e-5), ("rho", 2e-5), ("vel", 2e-4)):
        _close(got[key], js[key], tol, f"{shape}:k{k}:{key}")


# --- the twins against the port's own whole-grid step ---

@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", ["45degree", "cylinder"])
def test_full_class_twin_equals_whole_grid_steps(shape, k):
    _, tc = _pair(shape)
    s, fl = T.fluid_init(tc, "cpu")
    s = T.make_fluid_runner(tc)(s, fl, 0, 3)
    H = tc.eff_res[0]
    out = {n: torch.full_like(v, 7.0) for n, v in s.items()}
    K.fluid_k_ref(s["f"], s["rho"], s["vel"], out, [(0, 16), (24, H)], 3, k, tc)
    want = T.make_fluid_runner(tc)(s, fl, 3, k)
    for name in ("f", "rho", "vel"):
        assert torch.equal(out[name][..., :16, :], want[name][..., :16, :]), name
        assert torch.equal(out[name][..., 24:, :], want[name][..., 24:, :]), name
        assert bool((out[name][..., 16:24, :] == 7.0).all()), f"{name}: rows off the segments"


def test_lean_twin_reads_only_f_and_equals_full():
    """On tiles above the frontier the lean twin equals the full twin, and
    stale rho / vel never reach it (it takes none)."""
    _, tc = _pair("45degree", res=(80, 32))
    s, fl = T.fluid_init(tc, "cpu")
    s = T.make_fluid_runner(tc)(s, fl, 0, 3)
    c, k = K.tile_consts(tc), 2
    fr = K.frontier(c, 8, k, 3 + k)
    lean = [((fr + 1) * 8, (10 - 1) * 8)]
    full, lean_out = ({n: torch.zeros_like(v) for n, v in s.items()} for _ in range(2))
    K.fluid_k_ref(s["f"], s["rho"], s["vel"], full, lean, 3, k, tc)
    K.fluid_k_lean_ref(s["f"], lean_out, lean, k, tc)
    for name in ("f", "rho", "vel"):
        assert torch.equal(lean_out[name], full[name]), name


def test_below_tip_twin_equals_full():
    _, tc = _pair("cylinder", res=(80, 32))
    s, fl = T.fluid_init(tc, "cpu")
    s0 = int((40.0 - tc.inflow_height) / tc.vel_obs)
    s = T.make_fluid_runner(tc)(s, fl, 0, 2)
    c, k = K.tile_consts(tc), 2
    fb = K.below(c, 8, k, s0)
    assert fb >= 1
    bt = [(8, (fb + 1) * 8)]
    full, bt_out = ({n: torch.zeros_like(v) for n, v in s.items()} for _ in range(2))
    K.fluid_k_ref(s["f"], s["rho"], s["vel"], full, bt, s0, k, tc)
    K.fluid_k_bt_ref(s["f"], s["rho"], s["vel"], bt_out, bt, k, tc)
    for name in ("f", "rho", "vel"):
        np.testing.assert_allclose(bt_out[name].numpy(), full[name].numpy(), rtol=0,
                                   atol=1e-7, err_msg=name)


# --- the TH > 2k guard ---

def test_guard_keeps_tile_n_minus_2_full_at_th_8_k_4():
    """tile_rows=8, k=4 (2k = TH): the JAX lean range would take tile n-2,
    whose pyramid computes row H-2 next to the top wall with the lean body.
    The port keeps it in the full class and matches the jnp step there; the
    lean body on that tile does not."""
    jc, tc = _pair("cylinder", res=(80, 32))
    H, TH, k, start = 80, 8, 4, 3
    plan = K.chunk_plan(tc, start, k, tile_rows=TH, unroll=1, k=k)
    assert plan[0][0] == "split", plan
    _, _, _, fr, fb = plan[0]
    full, bt, lean = K.class_rows(H, TH, k, fr, fb)
    assert full[-1] == ((10 - 2) * TH, H) and lean[-1][1] == (10 - 2) * TH, (full, lean)
    state = _noisy_state(jc)
    js = _jnp_steps(jc, state, start, k)
    _, tf = T.fluid_init(tc, "cpu")
    st = T.state_from_numpy(state, "cpu")
    got = K.make_tiled_fluid_runner(tc, tile_rows=TH, unroll=1, k=k)(st, tf, start, k)
    for key, tol in (("f", 2e-5), ("rho", 2e-5), ("vel", 2e-4)):
        _close(got[key], js[key], tol, key)
        _close(got[key][..., H - 2, :], js[key][..., H - 2, :], tol, f"{key} H-2")
    # the unguarded lean range: tile n-2's first pyramid level computes row
    # H-2 with the lean body, which streams from the top wall as if it
    # were FLUID; the full body bounces there
    t0 = (10 - 2) * TH
    rows = torch.arange(t0 - 2 * k, t0 + TH + 2 * k) % H
    fw = st["f"].index_select(1, rows)
    ra, t0a = TH + 2 * (2 * k - 1), t0 - (2 * k - 1)
    assert t0a + ra - 1 == H - 2
    lean = K._a_lean(tc, ra, fw)[0][:, -1]
    full = K._a_full(tc, start, t0a, ra, fw, st["vel"].index_select(1, rows),
                     st["rho"].index_select(0, rows)[1:-1])[0][:, -1]
    assert float((lean - full).abs().max()) > 1e-4


def test_below_tip_tiles_need_th_over_2k():
    """The below-tip plan gives no tile when TH <= 2k, and a split asked
    for one there raises, as the JAX split chunk asserts."""
    _, tc = _pair("cylinder", res=(80, 32))
    c, s0 = K.tile_consts(tc), int((40.0 - tc.inflow_height) / tc.vel_obs)
    assert K.below(c, 8, 2, s0) >= 1 and K.below(c, 8, 4, s0) == 0
    with pytest.raises(ValueError, match="TH = 8 > 2k = 8"):
        K.class_rows(80, 8, 4, 5, 1)
    with pytest.raises(ValueError, match="fb <= fr"):
        K.class_rows(80, 8, 1, 2, 3)


# --- the pick ---

@pytest.mark.parametrize("kw,want", [
    (dict(shape="ethaline", refine=8, res=(128, 64)), "make_tiled_fluid_runner"),
    (dict(shape="ethaline", res=(128, 64)), "make_fused_fluid_runner"),
    (dict(shape="cylinder", res=(1004, 200)), "make_per_step_fluid_runner"),  # H % 8 = 4
])
def test_pick_fluid_runner_by_grid(kw, want):
    cfg = T.JRLFluidConfig(**dict(dict(Re=4.0, vel_obs_real=0.2848), **kw))
    run = T.pick_fluid_runner(cfg)
    assert run.__qualname__.split(".")[0] == want
    if want == "make_tiled_fluid_runner":
        assert (run.tile_rows, run.k) == (64, 1)
