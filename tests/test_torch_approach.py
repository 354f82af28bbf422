"""The C approach's two redesigned kernels on the CPU, where each wrapper
runs its plain twin: `kernels/jrl_c.py::c_approach_pass` (one step, its
frame lerp and its tip-disk integrals in one launch, `csrc/
c_approach_pass.cu`) and `kernels/fused_jrl.py::fused_approach_cl` (n
steps on one thread-block cluster, `csrc/fused_approach_cl.cu`).

- the twins against the JAX package's Pallas kernels in TPU interpret
  mode (as its own tests run them): `c_approach_pass_ref` against
  `fused_jrl_tiled.py::_c_one_approach_step` over steps that cross a
  frame change and that read the last frame (no lerp), from a window of
  frames; the cluster wrapper against `fused_jrl.py::_fused_approach_seg`;
  the per-step runner against the tiled approach runner;
- the premise of each design, bit for bit: every block's rows (and the
  disk terms from the blocks' new C) computed from a grid NaN beyond the
  block's window equal the whole-grid step; every cluster band from a
  grid NaN beyond its one halo row, and the disk terms from the band that
  holds the disk rows with its halo rows;
- the route and the launch plan as arithmetic on an H100's limits.

The kernels themselves, against the kernels they replace (bit for bit)
and their twins, are in `test_torch_cuda.py`. Inputs come from numpy
with a seed; JAX states enter the port through `models/jrl.py::
state_from_numpy`. Tolerances are those of `tests/test_fused_jrl_tiled.py`
and `tests/test_fused_jrl.py`: h and C 1e-5, the integrals rtol 2e-4 /
atol 1e-4 (the Pallas kernels sum in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from jrl_lbm_tpu.models import jrl as J
from jrl_lbm_tpu.ops.pallas import fused_jrl as JF
from jrl_lbm_tpu.ops.pallas import fused_jrl_tiled as JT
from jrl_lbm_torch.kernels import fused_jrl as F
from jrl_lbm_torch.kernels import jrl_c
from jrl_lbm_torch.models import jrl as T

INT_TOL = dict(rtol=2e-4, atol=1e-4)
# an H100 SXM: 132 SMs; the dynamic shared memory a block may opt in to
# (232,448 bytes) less each kernel's static shared memory: c_approach_pass
# 2,176 bytes (the reduction tree and its flag), fused_approach_cl 8,208
# (two mbarriers, the blocks' terms, the reduction tree)
H100_SMS = 132
PASS_OPTIN = 232_448 - 2_176
CLUSTER = F.ClusterLimits(smem_optin=232_448 - 8_208, cluster=16)
# and with the multi-cluster kernel's limits: its static shared memory is
# 8,224 bytes (the ticket's flag beside the cluster kernel's), and the card
# holds 7, 15, 30, 66, 132 clusters of 16, 8, 4, 2, 1 blocks at once
CLUSTER_MC = CLUSTER._replace(smem_optin=232_448 - 8_224, active=(7, 15, 30, 66, 132))


def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


def _kw(shape, res=(48, 32), is_negative=True, Pe=5.0):
    return dict(res=res, Re=4.0, Pe=Pe, vel_obs_real=0.2848, shape=shape,
                is_negative=is_negative)


def _jax_state(jc, n_bal=4):
    js, jf, jflags = J.c_init(jc)
    return J.make_balance_runner(jc, jflags)(js, jf, n_bal), jf


def _frames(H, W, n, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal((n, 2, H, W))).astype(np.float32)


def _noisy(cfg, seed):
    st, fields, _ = T.c_init(cfg, "cpu")
    rng = np.random.default_rng(seed)
    return {k: v + torch.as_tensor((1e-3 * rng.standard_normal(tuple(v.shape))).astype(np.float32))
            for k, v in st.items()}, fields


def _ints(acc):
    return [float(x) for x in acc]


# --- the twins against the Pallas kernels, interpret mode ---

@pytest.mark.parametrize("shape,is_negative,where", [
    ("ethaline", True, "frame change"),
    ("cylinder", False, "last frame"),
])
def test_c_approach_pass_twin_matches_pallas_step(shape, is_negative, where):
    """Two steps of `_c_one_approach_step` (tile rows 8) against
    `c_approach_pass_ref` fed the window of the history that the steps
    read: across a frame change (lerp on both sides), and on the history's
    last frame (lerp off)."""
    kw = _kw(shape, is_negative=is_negative, Pe=0.03 * 6.5 / (0.5 / 3.0))  # tip speed 0.03
    jc, tc = J.JRLCConfig(**kw), T.JRLCConfig(**kw)
    H, W = tc.eff_res
    v = tc.vel_obs_conv
    n_frames = 5
    vf = _frames(H, W, n_frames, seed=1)
    if where == "frame change":
        start = next(s for s in range(1, 60) if T.frame_pair(s, v, n_frames)[0]
                     != T.frame_pair(s + 1, v, n_frames)[0])
    else:
        start = next(s for s in range(1, 400) if not T.frame_pair(s, v, n_frames)[2])
    steps = range(start, start + 2)
    lerps = [T.frame_pair(s, v, n_frames) for s in steps]
    assert len({b for b, _, _ in lerps}) == (2 if where == "frame change" else 1)
    assert all(lerp for *_, lerp in lerps) == (where == "frame change")
    b0, b1 = lerps[0][0], lerps[-1][0] + int(lerps[-1][2])
    window = torch.as_tensor(vf[b0:b1 + 1])

    js, jf = _jax_state(jc)
    key = tuple(sorted(JT._c_cfg_consts(jc).items()))
    h, C = js["h"], js["C"]
    th = T.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")["h"]
    _, tf, _ = T.c_init(tc, "cpu")
    for s in steps:
        with _interpret():
            h, C, ints = JT._c_one_approach_step(h, C, jf["base_flags"], jnp.asarray(vf),
                                                 jnp.asarray(float(s), jnp.float32), key, 8,
                                                 n_frames)
            h, C, ints = jax.tree.map(np.asarray, (h, C, ints))
        th, tC, tints = jrl_c.c_approach_pass_ref(th, window, s, tc, tf, b0, n_frames)
        np.testing.assert_allclose(th.numpy(), h, rtol=1e-5, atol=1e-5, err_msg=f"step {s} h")
        np.testing.assert_allclose(tC.numpy(), C, rtol=1e-5, atol=1e-5, err_msg=f"step {s} C")
        np.testing.assert_allclose(_ints(tints), _ints(ints), err_msg=f"step {s}", **INT_TOL)
        h, C = jnp.asarray(h), jnp.asarray(C)


@pytest.mark.parametrize("shape,is_negative", [("ethaline", True), ("cylinder", False)])
def test_fused_approach_cl_on_cpu_matches_pallas(shape, is_negative):
    """The cluster wrapper (its twin here) against the JAX package's fused
    approach runner (`_fused_approach_seg`) over 8 steps that cross frame
    boundaries, as `test_torch_fused.py::test_fused_approach_matches_pallas`
    holds `fused_approach`."""
    kw = _kw(shape, is_negative=is_negative, Pe=3.0)
    jc, tc = J.JRLCConfig(**kw), T.JRLCConfig(**kw)
    H, W = tc.eff_res
    vf = _frames(H, W, 3, seed=2)
    js, jf = _jax_state(jc)
    with _interpret():
        out, acc = JF.make_fused_approach_runner(jc, vf)(js, jf, 0, 8)
        out, acc = jax.tree.map(np.asarray, (out, acc))
    _, tf, _ = T.c_init(tc, "cpu")
    s = T.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    tacc = torch.zeros(4)
    got = F.fused_approach_cl(s["h"], s["C"], torch.as_tensor(vf), 0, 8, tc, tf, tacc)
    twin = F.fused_approach_ref(s["h"], s["C"], torch.as_tensor(vf), 0, 8, tc, tf)
    for key, g, t in zip(("h", "C"), got, twin):
        torch.testing.assert_close(g, t, rtol=0, atol=0)
        np.testing.assert_allclose(g.numpy(), out[key], rtol=1e-5, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(_ints(tacc), [float(acc[k]) for k in
                                             ("inflow_sum", "current_sum", "rec_u", "rec_v")],
                               **INT_TOL)


def test_approach_runner_matches_tiled_runner():
    """The per-step runner (`c_approach_pass` once a step, its twin here)
    against the JAX package's tiled approach runner at 48x32 (tile rows 8,
    one chunk of 4), over 4 steps that cross a frame change."""
    kw = _kw("45degree")
    jc, tc = J.JRLCConfig(**kw), T.JRLCConfig(**kw)
    H, W = tc.eff_res
    vf = _frames(H, W, 6, seed=3)
    v = tc.vel_obs_conv
    start = next(s for s in range(1, 60) if T.frame_pair(s, v, 6)[0]
                 != T.frame_pair(s + 2, v, 6)[0])
    js, jf = _jax_state(jc)
    with _interpret():
        out, acc = JT.make_tiled_approach_runner(jc, jnp.asarray(vf), tile_rows=8, unroll=4)(
            js, jf, start, 4)
        out, acc = jax.tree.map(np.asarray, (out, acc))
    _, tf, _ = T.c_init(tc, "cpu")
    run = T.make_per_step_approach_runner(tc, torch.as_tensor(vf))
    assert run.route == "pass"
    got, tacc = run(T.state_from_numpy(jax.tree.map(np.asarray, js), "cpu"), tf, start, 4)
    for key in ("h", "C"):
        np.testing.assert_allclose(got[key].numpy(), out[key], rtol=2e-5, atol=2e-5, err_msg=key)
    for key in ("inflow_sum", "current_sum", "count", "rec_u", "rec_v"):
        np.testing.assert_allclose(float(tacc[key]), float(acc[key]), err_msg=key, **INT_TOL)


# --- the twins of the port against each other ---

@pytest.mark.parametrize("shape", ["ethaline", "cylinder"])
def test_pass_twin_equals_pair_twin_and_reads_no_old_C(shape):
    """`c_approach_pass_ref` (no C taken, a window of frames) equals the
    pair's twin (`stored_velocity` of the whole history, then
    `c_approach_ref`) bit for bit, and `c_approach_ref` gives the same
    result from a NaN C: the step never reads the old C, so the kernel
    takes none. The runner through the pass equals it through the pair."""
    cfg = T.JRLCConfig(**_kw(shape))
    H, W = cfg.eff_res
    st, fields = _noisy(cfg, 4)
    vf = torch.as_tensor(_frames(H, W, 8, seed=5))
    for s in (0, 5, 17, 31):
        b, _, _ = T.frame_pair(s, cfg.vel_obs_conv, 8)
        vel = T.stored_velocity(vf, s, cfg.vel_obs_conv)
        want = jrl_c.c_approach_ref(st["h"], st["C"], vel, s, cfg, fields)
        nan_C = jrl_c.c_approach_ref(st["h"], torch.full_like(st["C"], float("nan")), vel, s,
                                     cfg, fields)
        got = jrl_c.c_approach_pass_ref(st["h"], vf[b:b + 2], s, cfg, fields, b, 8)
        for other in (nan_C, got):
            torch.testing.assert_close(other[0], want[0], rtol=0, atol=0)
            torch.testing.assert_close(other[1], want[1], rtol=0, atol=0)
            assert _ints(other[2]) == _ints(want[2])
    with pytest.raises(ValueError, match="outside the window"):
        jrl_c.c_approach_pass_ref(st["h"], vf[2:4], 0, cfg, fields, 2, 8)
    a, acc_a = T.make_per_step_approach_runner(cfg, vf)(st, fields, 3, 9)
    b, acc_b = T.make_per_step_approach_runner(cfg, vf, route="pair")(st, fields, 3, 9)
    for key in ("h", "C"):
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    assert [float(x) for x in acc_a.values()] == [float(x) for x in acc_b.values()]


# --- the premise of each design: each block from its window ---

def _poison_rows(t, keep):
    out = torch.full_like(t, float("nan"))
    out[..., keep, :] = t[..., keep, :]
    return out


def _disk_steps(cfg, bounds):
    """The first step at each tip row of the travel, those whose disk rows
    (walks_int - 1 .. walks_int + 1) straddle a boundary of ``bounds``
    first, at most four; at least one straddles."""
    v, inflow = cfg.vel_obs_conv, cfg.inflow_height
    first = {}
    for s in range(cfg.total_steps):
        first.setdefault(T.tip_walks(inflow, s, v)[1], s)
    cross = [s for w, s in first.items() if any(w - 1 < y <= w + 1 for y in bounds)]
    assert cross, "no step's disk rows straddle a boundary"
    return (cross + [s for s in first.values() if s not in cross])[:4]


@pytest.mark.parametrize("shape,res", [("ethaline", (48, 32)), ("cylinder", (52, 32))])
def test_each_pass_block_needs_only_its_window(shape, res):
    """The plan of `c_approach_pass` on a card of 12 SMs (runs of 4 or 5
    rows): every block's rows computed from h NaN beyond its window (its
    rows and one a side, mod H) equal the whole-grid step bit for bit, and
    the integrals from the C assembled of the blocks' rows equal the
    whole-grid step's, at steps whose disk rows straddle a run boundary."""
    cfg = T.JRLCConfig(**_kw(shape, res=res))
    H, W = cfg.eff_res
    blocks, wrows, _ = jrl_c.approach_pass_plan(H, W, 12, PASS_OPTIN)
    runs = F.row_bands(H, blocks)
    assert min(y1 - y0 for y0, y1 in runs) >= 2 and wrows == max(y1 - y0 for y0, y1 in runs) + 2
    st, fields = _noisy(cfg, 6)
    vf = torch.as_tensor(_frames(H, W, 40, seed=7))
    steps = _disk_steps(cfg, [y0 for y0, _ in runs[1:]])
    for s in steps:
        b, _, _ = T.frame_pair(s, cfg.vel_obs_conv, 40)
        win = vf[b:b + 2]
        want = jrl_c.c_approach_pass_ref(st["h"], win, s, cfg, fields, b, 40)
        C = torch.full_like(want[1], float("nan"))
        for y0, y1 in runs:
            keep = [y % H for y in range(y0 - 1, y1 + 1)]
            got = jrl_c.c_approach_pass_ref(_poison_rows(st["h"], keep), win, s, cfg, fields, b,
                                            40)
            for name, g, w in zip(("h", "C"), got[:2], want[:2]):
                assert torch.isfinite(g[..., y0:y1, :]).all(), f"step {s} rows {y0}..{y1 - 1}"
                torch.testing.assert_close(g[..., y0:y1, :], w[..., y0:y1, :], rtol=0, atol=0,
                                           msg=f"step {s} rows {y0}..{y1 - 1} {name}")
            C[y0:y1] = got[1][y0:y1]
        walks_int = T.tip_walks(cfg.inflow_height, s, cfg.vel_obs_conv)[1]
        vel = T.stored_velocity(win, s, cfg.vel_obs_conv, b, 40)
        C_vel = _conv_velocity(cfg, vel, walks_int)
        assert _ints(jrl_c.disk_integrals(C, C_vel, walks_int, cfg, fields)) == _ints(want[2])


def _conv_velocity(cfg, vel, walks_int):
    """c_approach_ref's convection velocity: the stored one times the tip
    speed, (0, v) in the tip block."""
    H, W = cfg.eff_res
    v = cfg.vel_obs_conv
    iy, ix = T._iota(H, W, vel.device)
    tip = (iy < walks_int) & (ix < cfg.Rg_radius)
    return torch.stack([torch.where(tip, 0.0, vel[0] * v), torch.where(tip, v, vel[1] * v)])


@pytest.mark.parametrize("shape,is_negative", [("ethaline", True), ("cylinder", False)])
@pytest.mark.parametrize("H,C", [(48, 16), (44, 16)])
def test_approach_band_needs_one_halo_row(shape, is_negative, H, C):
    """An approach step of a cluster band from its h with one row a side
    (the rest NaN) equals the whole-grid step (row 0's and row H - 1's
    OUTFLOW copies read two rows inward, inside the band), and the band
    that holds row walks_int computes the step's inflow and current terms
    from its new C and its two halo rows alone (the flat flux form reads
    the row below), at steps whose disk rows reach a band's edge."""
    cfg = T.JRLCConfig(**_kw(shape, res=(H, 32), is_negative=is_negative))
    st, fields = _noisy(cfg, 8)
    vf = torch.as_tensor(_frames(H, 32, 40, seed=9))
    bands = F.row_bands(H, C)
    steps = _disk_steps(cfg, [y0 for y0, _ in bands[1:]])
    for s in steps:
        want = F.fused_approach_ref(st["h"], st["C"], vf, s, 1, cfg, fields)
        walks_int = T.tip_walks(cfg.inflow_height, s, cfg.vel_obs_conv)[1]
        rin = min(max(walks_int, 0), H - 1)
        for y0, y1 in bands:
            win = [y % H for y in range(y0 - 1, y1 + 1)]
            got = F.fused_approach_ref(_poison_rows(st["h"], win), st["C"], vf, s, 1, cfg, fields)
            for name, g, w in zip(("h", "C"), got[:2], want[:2]):
                assert torch.isfinite(g[..., y0:y1, :]).all(), f"step {s} rows {y0}..{y1 - 1}"
                torch.testing.assert_close(g[..., y0:y1, :], w[..., y0:y1, :], rtol=0, atol=0,
                                           msg=f"step {s} rows {y0}..{y1 - 1} {name}")
            if y0 <= rin < y1:  # the band that holds the disk rows
                vel = T.stored_velocity(vf, s, cfg.vel_obs_conv)
                C_band = _poison_rows(want[1], [y for y in range(y0 - 1, y1 + 1) if 0 <= y < H])
                got_ints = jrl_c.disk_integrals(C_band, _conv_velocity(cfg, vel, walks_int),
                                                walks_int, cfg, fields)
                assert _ints(got_ints)[:2] == _ints(want[2])[:2], (s, y0, y1)


# --- the route and the launch plan on an H100's limits ---

@pytest.mark.parametrize("refine,route", [(1, "cluster"), (2, "rows"), (4, "rows")])
def test_approach_route_on_h100(refine, route):
    """The approach takes the cluster kernel where its 22 window planes fit
    one cluster at one cell a thread (the default 128x64: 16 bands of 8
    rows, 56,320 bytes a block) and the row kernel at 256x128 and 512x256
    (``ROWS_MIN_CELLS``: it beats the multi-cluster kernel's 7 clusters of
    16 at 256x128 and the cooperative kernel at 512x256, where 66 clusters
    of 2 at two cells a thread lose, PERF.md §6), whatever the clusters
    the card holds; a multi-cluster plan still exists at both grids."""
    H, W = T.JRLCConfig(shape="ethaline", refine=refine).eff_res
    assert F.fused_route("fused_approach", H, W, CLUSTER_MC) == route
    assert F.fused_route("fused_approach", H, W, CLUSTER) == ("cluster" if refine == 1 else "rows")
    assert F.CLUSTER_PLANES["fused_approach"] == F.MC_PLANES["fused_approach"] == 22
    if refine == 1:
        assert F.cluster_shape("fused_approach", H, W, CLUSTER) == (16, 1, 22 * 10 * 64 * 4)
    else:
        want = {2: F.McPlan(7, 16, 1, 22 * 5 * 128 * 4), 4: F.McPlan(66, 2, 2, 22 * 6 * 256 * 4)}
        assert F.mc_plan("fused_approach", H, W, CLUSTER_MC) == want[refine]
    assert F.fused_route("fused_approach", H, W, CLUSTER._replace(cluster=8)) == (
        "coop" if refine == 1 else "rows")


@pytest.mark.parametrize("H,W,sms,want", [
    (1024, 512, 132, (128, 10)),   # refine 8: 8 rows a block, one block an SM
    (256, 64, 132, (128, 4)),      # runs of two rows
    (96, 516, 132, (48, 4)),       # a width that is no multiple of the block
    (2048, 1024, 132, (683, 5)),   # refine 16: three rows fit a block's shared memory
    (1024, 512, 78, (128, 10)),    # fewer SMs: runs held to 8 rows by the shared memory
    (1024, 512, 200, (171, 8)),    # more SMs: runs of 6 rows
])
def test_approach_pass_plan(H, W, sms, want):
    """Blocks and window rows of `c_approach_pass`: one block an SM where
    the window fits, runs of at least two rows, every run's window within
    the shared memory; grids it cannot take are refused."""
    blocks, wrows, smem = jrl_c.approach_pass_plan(H, W, sms, PASS_OPTIN)
    assert (blocks, wrows) == want
    runs = F.row_bands(H, blocks)
    assert min(y1 - y0 for y0, y1 in runs) >= 2
    assert smem == jrl_c.pass_smem_bytes(wrows, W) <= PASS_OPTIN
    assert jrl_c.approach_pass_plan(H, W + 2, sms, PASS_OPTIN) is None  # rows of 16 bytes
    assert jrl_c.approach_pass_plan(H, 1500, sms, PASS_OPTIN) is None   # 4 rows do not fit


def test_pass_route_and_window_checks():
    """The per-step runner's routes, and a window that misses a step's
    frames is refused by the twin as the kernel's checks refuse it."""
    cfg = T.JRLCConfig(**_kw("ethaline"))
    vf = torch.zeros((4, 2) + cfg.eff_res)
    assert T.make_per_step_approach_runner(cfg, vf).route == "pass"
    assert T.make_per_step_approach_runner(cfg, vf, route="pair").route == "pair"
    with pytest.raises(ValueError, match="route"):
        T.make_per_step_approach_runner(cfg, vf, route="tiles")
    b, _, lerp = T.frame_pair(1, cfg.vel_obs_conv, 4)
    assert lerp
    with pytest.raises(ValueError, match="outside the window"):
        T.stored_velocity(vf[:1], 1, cfg.vel_obs_conv, b, 4)
