"""The approach's row kernel of the multi-step module (`kernels/fused_jrl.py::
fused_approach_rw`, `csrc/fused_approach_rw.cu`) on the CPU, where the
wrapper runs its plain twin `fused_approach_rw_ref`: the launch played run
by run (each step of each run from its own window of rows, NaN beyond it)
against `fused_approach_ref` bit for bit over run plans, wedge and flat
tips, both signs of ``is_negative``, a frame change, the last frame and
step 2**24; against the JAX package's jnp approach step and its
``_make_approach_kernel`` in TPU interpret mode; the route's choice by grid
on an H100's limits; the run plan's coverage and shared memory. The
kernel against the cooperative ``fused_approach``, and the card's proof of
its division, are in `test_torch_cuda.py`.

Inputs come from the JAX init and a few balance steps, or from seeded
numpy noise, and seeded numpy frames. Tolerances: the jnp step h and C
1e-5, the sums rtol 2e-4 / atol 1e-4 (ROADMAP); the interpreted Pallas
kernel as `tests/test_torch_fused.py` holds the cooperative twin (h, C
1e-5, sums rtol = atol = 1e-4: its bodies fold divides into reciprocals
and sum in another order); the twins against each other bit for bit (they
share the arithmetic of the port's whole-grid step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from jrl_lbm_tpu.models import jrl as J
from jrl_lbm_tpu.ops.pallas import fused_jrl as JF
from jrl_lbm_torch.kernels import fused_jrl as F
from jrl_lbm_torch.models import jrl as T

RES = (48, 32)
# an H100 SXM's limits as `tests/test_torch_fused_clusters.py` states them
H100 = F.ClusterLimits(smem_optin=232_432, cluster=16, active=(7, 15, 30, 66, 132))
SUMS = ("inflow", "current", "rec_u", "rec_v")


def _kw(shape, is_negative=True, Pe=3.0, res=RES):
    return dict(res=res, Re=4.0, Pe=Pe, vel_obs_real=0.2848, shape=shape,
                is_negative=is_negative)


def _frames(H, W, n, seed):
    return torch.as_tensor((0.1 * np.random.default_rng(seed).standard_normal((n, 2, H, W)))
                           .astype(np.float32))


def _noisy(cfg, seed):
    """The config's initial state plus seeded noise, and its fields."""
    st, fields, _ = T.c_init(cfg, "cpu")
    rng = np.random.default_rng(seed)
    return {k: v + torch.as_tensor((1e-3 * rng.standard_normal(tuple(v.shape)))
                                   .astype(np.float32)) for k, v in st.items()}, fields


def _equal(got, want, tag):
    h, C, sums = got
    hw, Cw, sw = want
    assert torch.isfinite(h).all() and torch.isfinite(C).all(), f"{tag}: NaN reached"
    assert torch.equal(h, hw), f"{tag} h"
    assert torch.equal(C, Cw), f"{tag} C"
    for name, g, w in zip(SUMS, sums, sw):
        assert torch.equal(g, w), f"{tag} {name}: {float(g)} vs {float(w)}"


def _frame_change(v, n_frames):
    """A first step from which 6 steps cross a stored frame (lerp on both
    sides)."""
    s = next(s for s in range(1, 400) if T.frame_pair(s, v, n_frames)[0]
             != T.frame_pair(s + 3, v, n_frames)[0])
    pairs = [T.frame_pair(x, v, n_frames) for x in range(s, s + 6)]
    assert len({b for b, _, _ in pairs}) >= 2 and all(lerp for *_, lerp in pairs)
    return s


# --- the twin, played run by run, against the whole-grid twin ---

@pytest.mark.parametrize("shape,is_negative", [
    ("ethaline", True), ("45degree", False), ("cylinder", True), ("cylinder", False)])
@pytest.mark.parametrize("nruns", [24, 5])
def test_runs_across_a_frame_change_equal_the_whole_grid_twin(shape, is_negative, nruns):
    """48x32, 6 steps across a stored frame from a noisy state, in runs of 2
    rows (24 runs: every window reaches two rows past its run at rows 0 and
    H - 1) and of 9-10 (5): bit for bit `fused_approach_ref` in h, C and the
    four sums, finite (no cell read outside its run's window)."""
    cfg = T.JRLCConfig(**_kw(shape, is_negative))
    st, fields = _noisy(cfg, 31)
    vf = _frames(*RES, 12, seed=2)
    start = _frame_change(cfg.vel_obs_conv, 12)
    rows = {T.tip_walks(cfg.inflow_height, s, cfg.vel_obs_conv)[1] for s in (start, start + 5)}
    assert all(1 < r < RES[0] - 1 for r in rows)
    _equal(F.fused_approach_rw_ref(st["h"], st["C"], vf, start, 6, cfg, fields, nruns),
           F.fused_approach_ref(st["h"], st["C"], vf, start, 6, cfg, fields),
           f"{shape} {is_negative} {nruns} runs from {start}")


@pytest.mark.parametrize("shape", ["ethaline", "cylinder"])
def test_runs_across_a_tip_row_on_the_last_frame_equal_the_whole_grid_twin(shape):
    """8 steps across a tip row on the history's last frame (no lerp), 7
    runs of 6-7 rows: bit for bit `fused_approach_ref`."""
    cfg = T.JRLCConfig(**_kw(shape))
    st, fields = _noisy(cfg, 32)
    v = cfg.vel_obs_conv
    vf = _frames(*RES, 2, seed=3)
    walks, row = T.tip_walks(cfg.inflow_height, 0, v)
    start = int(np.ceil((row + 0.5 - cfg.inflow_height) / v)) - 4
    assert not T.frame_pair(start, v, 2)[2]
    rows = [T.tip_walks(cfg.inflow_height, s, v)[1] for s in (start, start + 7)]
    assert rows[1] == rows[0] + 1 < RES[0] - 1
    _equal(F.fused_approach_rw_ref(st["h"], st["C"], vf, start, 8, cfg, fields, 7),
           F.fused_approach_ref(st["h"], st["C"], vf, start, 8, cfg, fields),
           f"{shape} last frame from {start}")


@pytest.mark.parametrize("shape", ["45degree", "cylinder"])
def test_runs_across_step_2_24_equal_the_whole_grid_twin(shape):
    """Steps 2**24 - 3 .. 2**24 + 2 (float32 rounds the step from 2**24 on,
    alike in the kernel, the twins and JAX), Pe small enough that the tip is
    inside the grid there, 12 runs: bit for bit `fused_approach_ref`."""
    cfg = T.JRLCConfig(**_kw(shape, Pe=1e-5))
    st, fields = _noisy(cfg, 33)
    start = 2**24 - 3
    assert 1 < T.tip_walks(cfg.inflow_height, start + 5, cfg.vel_obs_conv)[1] < RES[0] - 1
    vf = _frames(*RES, 3, seed=4)
    _equal(F.fused_approach_rw_ref(st["h"], st["C"], vf, start, 6, cfg, fields, 12),
           F.fused_approach_ref(st["h"], st["C"], vf, start, 6, cfg, fields),
           f"{shape} across 2**24")


def test_twin_refuses_runs_under_two_rows():
    """Runs of one row would put an OUTFLOW cell's two-row reach outside the
    first and last windows: the twin refuses them, as the kernel does."""
    cfg = T.JRLCConfig(**_kw("ethaline"))
    st, fields = _noisy(cfg, 34)
    with pytest.raises(ValueError, match="two rows"):
        F.fused_approach_rw_ref(st["h"], st["C"], _frames(*RES, 2, 5), 0, 1, cfg, fields, 25)


def test_wrapper_on_the_cpu_runs_the_twin():
    """`fused_approach_rw` given CPU tensors runs its twin on `rw_plan`'s runs
    and updates acc as `fused_approach` does (counting no launch), bit for
    bit what `fused_approach` gives on the CPU with ``route="rows"``."""
    cfg = T.JRLCConfig(**_kw("45degree"))
    st, fields = _noisy(cfg, 35)
    vf = _frames(*RES, 4, seed=6)
    n0 = F.fused_approach_rw.launches
    acc = torch.ones(4)
    got = F.fused_approach_rw(st["h"], st["C"], vf, 9, 4, cfg, fields, acc)
    h, C, (inflow, current, rec_u, rec_v) = F.fused_approach_rw_ref(
        st["h"], st["C"], vf, 9, 4, cfg, fields, F.rw_plan(*RES).nruns)
    assert torch.equal(got[0], h) and torch.equal(got[1], C)
    assert torch.equal(acc, torch.stack([1 + inflow, 1 + current, rec_u, rec_v]))
    acc2 = torch.ones(4)
    routed = F.fused_approach(st["h"], st["C"], vf, 9, 4, cfg, fields, acc2, route="rows")
    assert all(torch.equal(a, b) for a, b in zip(routed, got)) and torch.equal(acc2, acc)
    assert F.fused_approach_rw.launches == n0


# --- against the JAX package ---

def _jax_state(jc, n_bal=4):
    js, jf, jflags = J.c_init(jc)
    return J.make_balance_runner(jc, jflags)(js, jf, n_bal), jf


@pytest.mark.parametrize("shape,is_negative", [("ethaline", True), ("cylinder", False)])
def test_runs_match_the_jnp_step(shape, is_negative):
    """10 steps at 48x32 across a frame change from 4 balance steps, in 6
    runs: the JAX package's jnp approach runner within h, C 1e-5 and the
    sums rtol 2e-4 / atol 1e-4."""
    jc, tc = J.JRLCConfig(**_kw(shape, is_negative)), T.JRLCConfig(**_kw(shape, is_negative))
    vf = _frames(*RES, 12, seed=7)
    start = _frame_change(tc.vel_obs_conv, 12) - 2
    js, jf = _jax_state(jc)
    out, acc = J.make_approach_runner(jc)(js, dict(jf, vel_field=jnp.asarray(vf.numpy())),
                                          jnp.asarray(start, jnp.int32), 10)
    out, acc = jax.tree.map(np.asarray, (out, acc))
    _, tf, _ = T.c_init(tc, "cpu")
    s = T.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    h, C, sums = F.fused_approach_rw_ref(s["h"], s["C"], vf, start, 10, tc, tf, 6)
    np.testing.assert_allclose(h.numpy(), out["h"], rtol=1e-5, atol=1e-5, err_msg="h")
    np.testing.assert_allclose(C.numpy(), out["C"], rtol=1e-5, atol=1e-5, err_msg="C")
    for name, g, key in zip(SUMS, sums, ("inflow_sum", "current_sum", "rec_u", "rec_v")):
        np.testing.assert_allclose(float(g), float(acc[key]), rtol=2e-4, atol=1e-4,
                                   err_msg=name)


def test_runs_match_the_interpreted_pallas_kernel():
    """The JAX package's whole-domain approach runner
    (``_make_approach_kernel`` through ``_fused_approach_seg``) in TPU
    interpret mode, 8 steps of the ethaline tip at 48x32 across frame
    boundaries, against the twin in 8 runs, as
    `test_torch_fused.py::test_fused_approach_matches_pallas` holds the
    cooperative twin: h, C 1e-5, the sums rtol = atol = 1e-4."""
    from jax.experimental.pallas import tpu as pltpu

    jc, tc = J.JRLCConfig(**_kw("ethaline")), T.JRLCConfig(**_kw("ethaline"))
    vf = (0.1 * np.random.default_rng(0).standard_normal((3, 2) + RES)).astype(np.float32)
    js, jf = _jax_state(jc)
    with pltpu.force_tpu_interpret_mode():
        out, acc = JF.make_fused_approach_runner(jc, vf)(js, jf, 0, 8)
        out, acc = jax.tree.map(np.asarray, (out, acc))
    _, tf, _ = T.c_init(tc, "cpu")
    s = T.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    h, C, sums = F.fused_approach_rw_ref(s["h"], s["C"], torch.as_tensor(vf), 0, 8, tc, tf, 8)
    np.testing.assert_allclose(h.numpy(), out["h"], rtol=1e-5, atol=1e-5, err_msg="h")
    np.testing.assert_allclose(C.numpy(), out["C"], rtol=1e-5, atol=1e-5, err_msg="C")
    for name, g, key in zip(SUMS, sums, ("inflow_sum", "current_sum", "rec_u", "rec_v")):
        np.testing.assert_allclose(float(g), float(acc[key]), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


# --- the route and the plan ---

@pytest.mark.parametrize("res,route", [
    ((128, 64), "cluster"),    # the default grid: one cluster, one cell a thread
    ((256, 128), "rows"),      # refine 2: ROWS_MIN_CELLS
    ((512, 256), "rows"),      # refine 4
    ((1024, 512), "coop"),     # over MAX_FUSED_CELLS: no multi-step runner takes it
])
def test_approach_route_by_grid_on_h100(res, route):
    """The approach's route on an H100's limits (132 SMs): the row kernel
    from ``ROWS_MIN_CELLS`` cells up to ``MAX_FUSED_CELLS``, for the
    approach only; the other phases keep theirs."""
    assert F.ROWS_MIN_CELLS == {"fused_approach": 256 * 128}
    assert F.fused_route("fused_approach", 248, 128, H100) == "clusters"
    assert F.fused_route("fused_approach", *res, H100) == route
    assert F.fused_route("fused_approach", *res, H100, sms=132) == route
    assert F.fused_route("fused_balance", *res, H100) != "rows"
    assert F.fused_route("fused_fluid", *res, H100) != "rows"
    assert F.rows_take("fused_approach", *res) == (route == "rows")


def test_rows_need_a_plan_and_are_the_approachs_only():
    """A card whose SMs cannot hold 512x256's runs (runs over 1024 cells on
    fewer than 128 SMs), or rows that are not 16-byte multiples, keep the
    grid off the rows; no phase but the approach takes them, nor may a
    caller force them on one."""
    assert F.fused_route("fused_approach", 512, 256, H100, sms=132) == "rows"
    assert F.rw_plan(512, 256, 114) is None
    assert F.fused_route("fused_approach", 512, 256, H100, sms=114) != "rows"
    assert F.rw_plan(512, 258, 132) is None and not F.rows_take("fused_approach", 512, 258)
    assert "rows" in F.PHASE_ROUTES["fused_approach"]
    assert all("rows" not in F.PHASE_ROUTES[n] for n in ("fused_fluid", "fused_balance"))
    cc = T.JRLCConfig(res=RES)
    with pytest.raises(ValueError, match="route 'rows'"):
        F._route("fused_balance", cc, torch.device("cpu"), "rows")


@pytest.mark.parametrize("res", [(48, 32), (128, 64), (256, 128), (512, 256)])
def test_plan_covers_every_row_once(res):
    """`rw_plan` for an H100 (132 SMs) and forced runs: every row of the grid
    in exactly one run, each of two rows or more and at most ``RW_CELLS``
    cells, its window (the run and a row a side) within the planes' rows
    and the shared memory a block may take, the runs within the SMs; at
    512x256 128 runs of 4 rows."""
    H, W = res
    plans = [F.rw_plan(H, W)] + [F.rw_plan_of(H, W, n) for n in (H // 2, H // 5)]
    plans = [p for p in plans if p is not None]
    assert plans and plans[0] == F.rw_plan(H, W, 132)
    for plan in plans:
        assert plan.smem == F.rw_smem_bytes(plan.wrows, W) <= F.RW_SMEM_CAP
        cover = np.zeros(H, np.int32)
        for y0, y1 in F.row_bands(H, plan.nruns):
            assert 2 <= y1 - y0 and y1 - y0 + 2 <= plan.wrows and (y1 - y0) * W <= F.RW_CELLS
            cover[y0:y1] += 1
        assert (cover == 1).all(), f"{res} {plan}"
    assert plans[0].nruns <= 132
    if res == (512, 256):
        assert plans[0] == F.RwPlan(128, 6, F.rw_smem_bytes(6, 256))
    assert F.rw_plan_of(H, W, H // 2 + 1) is None
