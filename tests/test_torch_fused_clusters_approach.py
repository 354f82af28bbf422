"""The multi-cluster approach (`kernels/fused_jrl.py::fused_approach_mc`,
`csrc/fused_approach_mc.cu` on `csrc/cluster_grid.cuh`) on the CPU, the
approach's share of `test_torch_fused_clusters.py` (kept apart so that
the suite's workers take the two files side by side): a launch played
block by block on windows at 256x128 equal to the whole-grid twin bit for
bit, the disk terms too from the window of the block that holds the disk
rows while the disk crosses a cluster edge; the kernels' orders of summing
the integrals over blocks and clusters; the wrapper, which runs its twin
here, against the JAX package's Pallas runner in TPU interpret mode. The
schedule's mirrors and the window helpers are
`test_torch_fused_clusters.py`'s.

Inputs come from numpy with a seed; JAX states enter the port through
`models/jrl.py::state_from_numpy`. Tolerances against JAX are those of
`tests/test_fused_jrl.py`: h and C 1e-5, the integrals rtol 2e-4 / atol
1e-4 (sums taken in another order).
"""

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)
from test_torch_fused_clusters import H100, INT_TOL, NAN, _equal, _exchange, _groups, \
    _interpret, _noisy, _rows, mc_links, mc_passes

from jrl_lbm_tpu.models import jrl as J
from jrl_lbm_tpu.ops.pallas import fused_jrl as JF
from jrl_lbm_torch.kernels import fused_jrl as F
from jrl_lbm_torch.kernels import jrl_c
from jrl_lbm_torch.models import jrl as T


def _approach_cfg(shape):
    """256x128: refine 2 of the default ethaline case, or the flat tip."""
    if shape == "ethaline":
        return T.JRLCConfig(shape=shape, refine=2)
    return T.JRLCConfig(res=(256, 128), shape=shape)


def _first_step_at(cfg, row):
    """The first step whose tip row walks_int is ``row`` or beyond."""
    lo, hi = 0, 10**8
    while lo < hi:
        m = (lo + hi) // 2
        if T.tip_walks(cfg.inflow_height, m, cfg.vel_obs_conv)[1] >= row:
            hi = m
        else:
            lo = m + 1
    return lo


def _crossing(cfg, plan):
    """The first step whose disk row is the first row of a cluster's rank 0
    (a block's first row where clusters of 1) above the tip: the step
    before holds the disk in the last band of the cluster below."""
    links = mc_links(cfg.eff_res[0], plan)
    row0 = T.tip_walks(cfg.inflow_height, 0, cfg.vel_obs_conv)[1]
    edge = next(y0 for b, (y0, *_) in enumerate(links) if b % plan.cluster == 0 and y0 > row0)
    return _first_step_at(cfg, edge), edge


def _step_columns(C, step, cfg, fields):
    """The step's per-column disk terms from its new C."""
    walks_int = T.tip_walks(cfg.inflow_height, step, cfg.vel_obs_conv)[1]
    return jrl_c.disk_columns(C, walks_int, cfg, fields)


def _play_approach(h, C, vf, start, n, cfg, fields, plan):
    """`fused_approach_mc`'s launch on windows; returns ``(h, C, terms)``
    with each step's per-column disk terms, computed from the window of
    the block whose band holds the disk row alone (its halo rows included,
    the rest of the grid NaN)."""
    H, W = cfg.eff_res
    links = mc_links(H, plan)
    P = F.MC_PLANES["fused_approach"]
    win = []
    for y0, rows, _, _ in links:
        rw = _rows(y0, rows, H)
        w = torch.full((P, rows + 2, W), NAN)
        w[0:9] = h[:, rw]
        w[19] = C[rw]  # the C "before step 0", which the step never reads
        win.append(w)
    box = torch.full((2 * plan.clusters, 2, P, W), NAN)
    seq = [0] * (2 * plan.clusters)
    groups = _groups(links, H)
    passes = iter(mc_passes("fused_approach", n))
    terms = []
    for i in range(n):
        step = start + i
        vel = T.stored_velocity(vf, step, cfg.vel_obs_conv)
        cq, nq, cc, nc = (i & 1) * 9, ((i & 1) ^ 1) * 9, 18 + ((i - 1) & 1), 18 + (i & 1)
        for grp in groups:
            hg = torch.full((9, H, W), NAN)
            Cg = torch.full((H, W), NAN)
            for b in grp:
                rw = _rows(*links[b][:2], H)
                hg[:, rw] = win[b][cq:cq + 9]
                Cg[rw] = win[b][cc]
            ho, Co, _ = jrl_c.c_approach_ref(hg, Cg, vel, step, cfg, fields)
            for b in grp:
                y0, rows = links[b][:2]
                win[b][nq:nq + 9, 1:rows + 1] = ho[:, y0:y0 + rows]
                win[b][nc, 1:rows + 1] = Co[y0:y0 + rows]
        _exchange(win, links, box, seq, next(passes), plan.cluster)
        rin = min(max(T.tip_walks(cfg.inflow_height, step, cfg.vel_obs_conv)[1], 0), H - 1)
        b = next(b for b, (y0, rows, _, _) in enumerate(links) if y0 <= rin < y0 + rows)
        Cb = torch.full((H, W), NAN)
        Cb[_rows(*links[b][:2], H)] = win[b][nc]
        terms.append((b, _step_columns(Cb, step, cfg, fields)))
    fq, fc = (n & 1) * 9, 18 + ((n - 1) & 1)
    out = (torch.empty(9, H, W), torch.empty(H, W))
    for b, (y0, rows, _, _) in enumerate(links):
        out[0][:, y0:y0 + rows] = win[b][fq:fq + 9, 1:rows + 1]
        out[1][y0:y0 + rows] = win[b][fc, 1:rows + 1]
    return out + (terms,)


def _approach_state(cfg, seed):
    st, fields, _ = T.c_init(cfg, "cpu")
    st = _noisy(st, seed)
    # three frames: the steps near the cluster edges read the last (no lerp)
    vf = torch.as_tensor((0.5 * np.random.default_rng(seed).standard_normal(
        (3, 2) + cfg.eff_res)).astype(np.float32))
    return st, fields, vf


@pytest.mark.parametrize("cluster", [16, 2, 1])
@pytest.mark.parametrize("shape", ["ethaline", "cylinder"])
def test_approach_launch_on_windows_equals_whole_grid(shape, cluster):
    """256x128 (refine 2 of the ethaline case, and the flat tip) on the
    H100 plans of clusters of 16, 2 and 1: four steps from windows across
    the step where the disk row leaves the last band of one cluster for the
    first band of the next (a band edge and a cluster edge: the wedge's
    current row and the flat tip's flux rows are then halo rows from the
    other cluster's mailbox), equal to the twin's steps bit for bit in h
    and C, and each step's disk terms from the window of the block that
    holds the disk row equal the whole grid's."""
    cfg = _approach_cfg(shape)
    assert cfg.eff_res == (256, 128)
    plan = F.mc_plan("fused_approach", 256, 128, H100, cluster=cluster)
    st, fields, vf = _approach_state(cfg, 16)
    cross, edge = _crossing(cfg, plan)
    start, n = cross - 2, 4
    got = _play_approach(st["h"], st["C"], vf, start, n, cfg, fields, plan)
    h, C = st["h"], st["C"]
    holders = []
    for i, (b, cols) in enumerate(got[2]):
        h, C, _ = jrl_c.c_approach_ref(h, C, T.stored_velocity(vf, start + i, cfg.vel_obs_conv),
                                       start + i, cfg, fields)
        for k, (g, w) in enumerate(zip(cols, _step_columns(C, start + i, cfg, fields))):
            assert torch.isfinite(g).all(), f"step {start + i}: NaN in disk terms {k}"
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        holders.append(b)
    links = mc_links(256, plan)
    b_edge = next(b for b, (y0, *_) in enumerate(links) if y0 == edge)
    assert holders == [b_edge - 1, b_edge - 1, b_edge, b_edge]  # across the cluster edge
    _equal(got[:2], (h, C), f"approach {shape}, clusters of {cluster}")


def _tree(v):
    """`csrc/jrl_c.cuh::block_sum4`'s order over FUSED_BLOCK columns."""
    v = torch.cat([v, torch.zeros(F.FUSED_BLOCK - v.numel())])
    while v.numel() > 1:
        h = v.numel() // 2
        v = v[:h] + v[h:]
    return v[0]


def _coop_sums(terms):
    """`csrc/fused_approach.cu`'s order: each column's terms over the steps
    in one thread, then the tree over the columns."""
    s = [torch.zeros_like(terms[0][1][k]) for k in range(2)]
    for _, cols in terms:
        s = [a + c for a, c in zip(s, cols)]
    return [_tree(a) for a in s]


def _mc_sums(terms, plan):
    """`csrc/fused_approach_mc.cu`'s order: each block's column terms over
    the steps it held the disk, each cluster's blocks in rank order, the
    clusters in order, then the tree over the columns."""
    zero = [torch.zeros_like(terms[0][1][k]) for k in range(2)]
    blocks = {}
    for b, cols in terms:
        blocks[b] = [a + c for a, c in zip(blocks.get(b, zero), cols)]
    total = zero
    for n in range(plan.clusters):
        part = zero
        for r in range(plan.cluster):
            part = [a + c for a, c in zip(part, blocks.get(n * plan.cluster + r, zero))]
        total = [a + c for a, c in zip(total, part)]
    return [_tree(a) for a in total]


@pytest.mark.parametrize("cluster", [16, 2])
def test_mc_disk_sums_across_clusters(cluster):
    """The multi-cluster kernel's order of summing the integrals, played on
    the twin's per-step disk terms of six steps at 256x128 (the disk row
    leaves one cluster for the next after the third): bit for bit the
    cooperative kernel's order over the steps one block held, within rtol
    2e-4 / atol 1e-4 of it across the handover, and both that close to the
    twin's sums (`fused_approach_ref`)."""
    cfg = _approach_cfg("ethaline")
    plan = F.mc_plan("fused_approach", 256, 128, H100, cluster=cluster)
    st, fields, vf = _approach_state(cfg, 17)
    cross, edge = _crossing(cfg, plan)
    start, n = cross - 3, 6
    links = mc_links(256, plan)
    h, C, terms = st["h"], st["C"], []
    for i in range(n):
        h, C, _ = jrl_c.c_approach_ref(h, C, T.stored_velocity(vf, start + i, cfg.vel_obs_conv),
                                       start + i, cfg, fields)
        rin = T.tip_walks(cfg.inflow_height, start + i, cfg.vel_obs_conv)[1]
        b = next(b for b, (y0, rows, _, _) in enumerate(links) if y0 <= rin < y0 + rows)
        terms.append((b, _step_columns(C, start + i, cfg, fields)))
    b_edge = next(b for b, (y0, *_) in enumerate(links) if y0 == edge)
    assert [b for b, _ in terms] == [b_edge - 1] * 3 + [b_edge] * 3  # across the cluster edge
    twin = F.fused_approach_ref(st["h"], st["C"], vf, start, n, cfg, fields)[2]
    for part, held in ((terms[:3], True), (terms[3:], True), (terms, False)):
        got, coop = _mc_sums(part, plan), _coop_sums(part)
        for g, c in zip(got, coop):
            if held:
                assert float(g) == float(c)
            else:
                np.testing.assert_allclose(float(g), float(c), **INT_TOL)
    for g, w in zip(_mc_sums(terms, plan), twin[:2]):
        np.testing.assert_allclose(float(g), float(w), **INT_TOL)


@pytest.mark.parametrize("shape,is_negative", [("ethaline", True), ("cylinder", False)])
def test_fused_approach_mc_on_cpu_matches_pallas(shape, is_negative):
    """The multi-cluster approach wrapper (its twin here) and
    ``fused_approach(route="clusters")`` against the JAX package's fused
    approach runner (`_fused_approach_seg`) over 8 steps that cross frame
    boundaries, at 48x32 as `test_torch_approach.py::
    test_fused_approach_cl_on_cpu_matches_pallas` holds the cluster kernel."""
    kw = dict(res=(48, 32), Re=4.0, Pe=3.0, vel_obs_real=0.2848, shape=shape,
              is_negative=is_negative)
    jc, tc = J.JRLCConfig(**kw), T.JRLCConfig(**kw)
    H, W = tc.eff_res
    vf = (0.1 * np.random.default_rng(2).standard_normal((3, 2, H, W))).astype(np.float32)
    js, jf, jflags = J.c_init(jc)
    js = J.make_balance_runner(jc, jflags)(js, jf, 4)
    with _interpret():
        out, acc = JF.make_fused_approach_runner(jc, vf)(js, jf, 0, 8)
        out, acc = jax.tree.map(np.asarray, (out, acc))
    _, tf, _ = T.c_init(tc, "cpu")
    s = T.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    got_acc, routed_acc = torch.zeros(4), torch.zeros(4)
    got = F.fused_approach_mc(s["h"], s["C"], torch.as_tensor(vf), 0, 8, tc, tf, got_acc)
    routed = F.fused_approach(s["h"], s["C"], torch.as_tensor(vf), 0, 8, tc, tf, routed_acc,
                              route="clusters")
    for key, g, r in zip(("h", "C"), got, routed):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
        np.testing.assert_allclose(g.numpy(), out[key], rtol=1e-5, atol=1e-5, err_msg=key)
    torch.testing.assert_close(got_acc, routed_acc, rtol=0, atol=0)
    np.testing.assert_allclose([float(x) for x in got_acc],
                               [float(acc[k]) for k in ("inflow_sum", "current_sum", "rec_u",
                                                        "rec_v")], **INT_TOL)
    assert F.fused_approach_mc.launches == 0
