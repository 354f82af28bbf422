"""The multi-cluster route of the multi-step JRL kernels
(`kernels/fused_jrl.py::fused_fluid_mc`, `fused_balance_mc`,
`fused_approach_mc`; `csrc/fused_fluid_mc.cu`, `csrc/fused_balance_mc.cu`,
`csrc/fused_approach_mc.cu` on `csrc/cluster_grid.cuh`) on the CPU: the
host plan on an H100's limits, the
mailbox and mbarrier arithmetic of the exchange (`mc_links`, `mc_passes`,
the mirrors of `GridBand` and of the kernels' step loops), a launch of the
fluid and of the balance played block by block on windows (each block's
band computed from a grid that is NaN outside its window, the halo rows
arriving from the neighbours inside a cluster or through the mailbox rows
between clusters, as the schedule says), which must equal the whole-grid
twin bit for bit at 256x128, and the fluid and balance wrappers, which run
their twins here, against the JAX package's Pallas runners in TPU
interpret mode. The approach's share, on these mirrors and window helpers,
is `test_torch_fused_clusters_approach.py`; the kernels themselves, against
``route="coop"``, are in `test_torch_cuda.py`.

Inputs come from numpy with a seed; JAX states enter the port through
`models/jrl.py::state_from_numpy`. Tolerances against JAX are those of
`tests/test_fused_jrl.py`: f and rho 2e-5, vel 2e-4, h and C 1e-5, the
integrals rtol 2e-4 / atol 1e-4 (sums taken in another order).
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
from jrl_lbm_torch.kernels import jrl_c, jrl_fluid
from jrl_lbm_torch.models import jrl as T

# an H100 SXM (NVIDIA H100 80GB HBM3): 232,448 bytes of shared memory a
# block may opt in to, less the kernels' 16 bytes of static shared memory;
# at once 7 clusters of 16 blocks, 15 of 8, 30 of 4, 66 of 2, 132 of 1
# (cudaOccupancyMaxActiveClusters at one block an SM)
H100 = F.ClusterLimits(smem_optin=232_432, cluster=16, active=(7, 15, 30, 66, 132))
NAN = float("nan")
INT_TOL = dict(rtol=2e-4, atol=1e-4)


# --- mirrors of the device code's arithmetic ---

def mc_links(H: int, plan):
    """Per block b of the plan (b = n C + r, as `csrc/cluster_grid.cuh::
    GridBand` numbers it): ``(y0, rows, dn, up)``. ``dn`` says where the
    band's first row goes, ``up`` its last: ``("peer", block)`` inside
    the cluster (the neighbour's halo row), or ``("box", side)`` to another
    cluster, mailbox side ``2 n' + d`` (d 0: the row entering rank 0 of
    cluster n' from below, 1: rank C - 1 from above). A block reads its
    halo row 0 from side ``2 n`` and row ``rows + 1`` from ``2 n + 1``
    where the neighbour there is in another cluster."""
    N, C = plan.clusters, plan.cluster
    B = N * C
    out = []
    for b in range(B):
        n, r = divmod(b, C)
        y0 = b * H // B
        far = N > 1
        dn = ("box", 2 * ((n - 1) % N) + 1) if far and r == 0 else ("peer", (b - 1) % B)
        up = ("box", 2 * ((n + 1) % N)) if far and r == C - 1 else ("peer", (b + 1) % B)
        out.append((y0, (b + 1) * H // B - y0, dn, up))
    return out


def mc_passes(name: str, n: int):
    """The exchanges of an n-step launch of the multi-cluster kernel of
    ``name``, in order, as `csrc/fused_fluid_mc.cu` / `fused_balance_mc.cu`
    make them: ``(pass p, mbarrier k, phase parity, mbarrier re-armed
    before the wait or -1, mailbox slot, the pass number its mailbox words
    carry, window planes sent, mailbox row j the j-th)``. Fluid planes: f
    0-8, u 9, v 10 of set 0, the same + 11 of set 1, rho 22; balance: h 0-8
    of set 0, 9-17 of set 1, C 18; approach: h as the balance's, C 18 and
    19 (step i writes 18 + (i & 1))."""
    out = []
    for i in range(int(n)):
        nq = ((i & 1) ^ 1) * (11 if name == "fused_fluid" else 9)  # the set step i writes
        if name == "fused_fluid":
            out.append((2 * i, 0, i & 1, 1 if i > 0 else -1, 0, 2 * i + 1, (nq + 9, nq + 10, 22)))
            out.append((2 * i + 1, 1, i & 1, 0, 1, 2 * i + 2, tuple(range(nq, nq + 9))))
        else:
            c = (18 + (i & 1),) if name == "fused_approach" else ()
            out.append((i, i & 1, (i >> 1) & 1, (i - 1) & 1 if i > 0 else -1, i & 1, i + 1,
                        tuple(range(nq, nq + 9)) + c))
    return out


# --- the host plan ---

@pytest.mark.parametrize("name,planes", [("fused_fluid", 23), ("fused_balance", 19),
                                         ("fused_approach", 22)])
@pytest.mark.parametrize("H,W,cluster,want", [
    (256, 128, None, (7, 16, 1, 5)),    # refine 2: 112 bands of 2 or 3 rows, one cell a thread
    (512, 256, None, (66, 2, 2, 6)),    # refine 4: 132 bands of 3 or 4 rows of 256, two cells
    (256, 128, 8, (15, 8, 1, 5)),       # 120 blocks of 8
    (512, 256, 16, (7, 16, 4, 7)),      # 112 blocks: 4 or 5 rows, four cells a thread
    (512, 256, 1, (132, 1, 2, 6)),      # every block alone, both halo rows from mailboxes
    (500, 256, None, (66, 2, 2, 6)),    # H not a multiple of N C: bands of 3 or 4 rows
])
def test_mc_plan_on_h100(name, planes, H, W, cluster, want):
    """As many clusters as the card holds at once, of the size that needs
    the fewest cells a thread (the largest of those): 16 where every size
    gives one cell a thread, 2 where only 132 blocks (66 x 2, 132 x 1)
    bring 512 rows down to bands of 4; the fewest cells a thread that cover
    the largest band, a window of that band and two halo rows; the bands
    cover the rows in order and differ by at most one."""
    N, C, cpt, win_rows = want
    plan = F.mc_plan(name, H, W, H100, cluster=cluster)
    assert plan == F.McPlan(N, C, cpt, planes * win_rows * W * 4)
    assert plan.smem <= H100.smem_optin
    links = mc_links(H, plan)
    assert len(links) == N * C and links[0][0] == 0
    assert all(a[0] + a[1] == b[0] for a, b in zip(links, links[1:]))
    assert links[-1][0] + links[-1][1] == H
    rows = [r for _, r, _, _ in links]
    assert min(rows) >= F.CLUSTER_MIN_ROWS and max(rows) - min(rows) <= 1
    assert max(rows) == win_rows - 2 and max(rows) * W <= cpt * F.CLUSTER_THREADS


def test_mc_plan_refused_where_the_card_cannot_hold_it():
    """No plan for too little shared memory (one byte under the smallest
    window), too few co-resident clusters (one of 16 at 512x256: 32 rows of
    256 a block, over 4 cells a thread), none at all, or the approach's 22
    planes where the balance's 19 still fit; and the route then stays
    cooperative (the approach's rows, which need no cluster, take 512x256,
    not a width of no 16-byte multiple)."""
    name = "fused_balance"
    smallest = min(F.mc_plan(name, 512, 256, H100, cluster=c).smem for c in F.MC_SIZES)
    tight = H100._replace(smem_optin=smallest - 1)
    assert F.mc_plan(name, 512, 256, tight) is None
    assert F.fused_route(name, 512, 256, tight) == "coop"
    few = H100._replace(active=(1, 0, 0, 0, 0))
    assert F.mc_plan(name, 512, 256, few) is None
    assert F.fused_route(name, 512, 256, few) == "coop"
    assert F.mc_plan(name, 512, 256, H100._replace(active=())) is None
    a_smem = F.mc_plan("fused_approach", 512, 256, H100).smem
    tight_a = H100._replace(smem_optin=a_smem - 1)
    assert F.mc_plan("fused_approach", 512, 256, tight_a) is None
    assert F.fused_route("fused_approach", 512, 256, tight_a) == "rows"  # ROWS_MIN_CELLS
    assert F.fused_route("fused_approach", 500, 250, tight_a) == "coop"
    assert F.mc_plan(name, 512, 256, tight_a) is not None
    # a grid too short for bands of two rows on every cluster size the card
    # holds (but one block alone, its halo rows its own: a plan)
    assert F.mc_plan(name, 3, 64, H100._replace(active=(7, 15, 30, 66, 0))) is None
    assert F.mc_plan(name, 3, 64, H100) == F.McPlan(1, 1, 1, 19 * 5 * 64 * 4)


# --- the mailbox and the passes ---

@pytest.mark.parametrize("H,cluster", [(256, 8), (256, 16), (40, 16), (500, 2), (64, 1)])
def test_mc_links_pair_every_edge(H, cluster):
    """Each band's first row goes to the block below and its last to the
    block above (the last band's to the first): inside a cluster as a
    neighbour's halo row, from rank 0 and rank C - 1 of every cluster to
    another cluster's mailbox side, each side with one sender; one cluster
    (40 rows) has no mailbox, and blocks alone (clusters of 1) send and
    take both rows through mailboxes. A block reads its halo row 0 from
    side 2 n where its first row goes to a mailbox, and row rows + 1 from
    2 n + 1."""
    plan = F.mc_plan("fused_balance", H, 64, H100, cluster=cluster)
    links = mc_links(H, plan)
    N, C, B = plan.clusters, plan.cluster, len(links)
    senders = {}
    for b, (_, _, dn, up) in enumerate(links):
        n, r = divmod(b, C)
        for link, nb, far in ((dn, (b - 1) % B, N > 1 and r == 0),
                              (up, (b + 1) % B, N > 1 and r == C - 1)):
            if far:
                assert link[0] == "box"
                senders.setdefault(link[1], []).append(b)
                # the receiver reads that side: row 0 (side 2 n'), row rows + 1 (2 n' + 1)
                n2 = nb // C
                assert link[1] == (2 * n2 + 1 if link is dn else 2 * n2)
                assert (links[nb][3] if link is dn else links[nb][2])[0] == "box"
            else:
                assert link == ("peer", nb) and nb // C == n
    assert sorted(senders) == list(range(2 * N if N > 1 else 0))
    assert all(len(v) == 1 for v in senders.values())


@pytest.mark.parametrize("name", ["fused_fluid", "fused_balance", "fused_approach"])
def test_mc_passes_slots_and_phases(name):
    """The schedule of an 8-step launch: passes 0, 1, 2, ... each in slot
    p & 1 and published as p + 1; each mbarrier used in turn with its
    phase parity flipping every use, re-armed exactly once between two
    uses and only after its previous wait (so no byte of a phase lands in
    the one before); the planes sent are those the next pass reads from the
    set just written (fluid A: u, v and rho; B: f; balance: h; approach: h
    and the step's C, within the mailbox rows of a slot)."""
    passes = mc_passes(name, 8)
    assert [p[0] for p in passes] == list(range(len(passes)))
    uses = {0: 0, 1: 0}
    armed = {0: True, 1: True}  # both armed before the first step
    waited = set()
    for p, k, parity, rearm, slot, seq, planes in passes:
        assert slot == p & 1 and seq == p + 1
        if rearm >= 0:
            assert not armed[rearm] and rearm in waited
            armed[rearm] = True
        assert armed[k] and parity == uses[k] & 1
        armed[k] = False
        uses[k] += 1
        waited.add(k)
    for p, _, _, _, _, _, planes in passes:
        step = p // 2 if name == "fused_fluid" else p
        nq = ((step & 1) ^ 1) * (11 if name == "fused_fluid" else 9)
        if name == "fused_fluid" and p % 2 == 0:
            assert planes == (nq + 9, nq + 10, 22)
        elif name == "fused_approach":
            assert planes == tuple(range(nq, nq + 9)) + (18 + (step & 1),)
        else:
            assert planes == tuple(range(nq, nq + 9))
        assert len(planes) <= F.MC_ROW_PLANES[name]


# --- a launch played block by block ---

GROUPS = 4  # blocks b = g mod 4 share a grid: their windows lie >= 3 rows apart


def _groups(links, H):
    """The blocks in ``GROUPS`` groups whose windows do not meet within two
    rows of another member's band (the cell code's reach), checked."""
    groups = [list(range(g, len(links), GROUPS)) for g in range(GROUPS)]
    for grp in groups:
        for b in grp:
            y0, rows = links[b][:2]
            reach = {(y0 + d) % H for d in range(-2, rows + 2)}
            for o in grp:
                if o != b:
                    oy, orows = links[o][:2]
                    assert not reach & {(oy + d) % H for d in range(-1, orows + 1)}, (b, o)
    return groups


def _rows(y0, rows, H):
    return [(y0 - 1 + j) % H for j in range(rows + 2)]


def _exchange(win, links, box, seq, pss, C):
    """One pass's exchange: each band's edge rows of the pass's planes into
    the neighbour's halo row or the mailbox slot, then each block's halo
    rows from the mailbox sides where its neighbour is in another cluster."""
    p, _, _, _, slot, seq_no, planes = pss
    q = list(planes)
    for b, (_, rows, dn, up) in enumerate(links):
        for link, row, down in ((dn, 1, True), (up, rows, False)):
            vals = win[b][q, row]
            if link[0] == "peer":
                r = link[1]
                win[r][q, links[r][1] + 1 if down else 0] = vals
            else:
                box[link[1], slot][q] = vals
                seq[link[1]] = seq_no
    for b, (_, rows, dn, up) in enumerate(links):
        n = b // C
        for link, side, halo in ((dn, 2 * n, 0), (up, 2 * n + 1, rows + 1)):
            if link[0] == "box":
                assert seq[side] == seq_no, (b, p, seq[side])
                win[b][q, halo] = box[side, slot][q]


def _play_fluid(s, start, n, cfg, fields, plan):
    """`fused_fluid_mc`'s launch on windows; returns ``(f, rho, vel)``."""
    H, W = cfg.eff_res
    links = mc_links(H, plan)
    P = F.MC_PLANES["fused_fluid"]
    win = []
    for y0, rows, _, _ in links:
        rw = _rows(y0, rows, H)
        w = torch.full((P, rows + 2, W), NAN)
        w[0:9] = s["f"][:, rw]
        w[9:11] = s["vel"][:, rw]
        w[22] = s["rho"][rw]
        win.append(w)
    box = torch.full((2 * plan.clusters, 2, P, W), NAN)
    seq = [0] * (2 * plan.clusters)
    groups = _groups(links, H)
    passes = iter(mc_passes("fused_fluid", n))
    for i in range(n):
        cq, nq = (i & 1) * 11, ((i & 1) ^ 1) * 11
        for half in ("A", "B"):
            q0 = cq if half == "A" else nq
            for grp in groups:
                f = torch.full((9, H, W), NAN)
                vel = torch.full((2, H, W), NAN)
                rho = torch.full((H, W), NAN)
                for b in grp:
                    rw = _rows(*links[b][:2], H)
                    f[:, rw] = win[b][q0:q0 + 9]
                    vel[:, rw] = win[b][q0 + 9:q0 + 11]
                    rho[rw] = win[b][22]
                if half == "A":
                    fo, ro, vo = jrl_fluid.fluid_a_ref(f, rho, vel, start + i, cfg, fields)
                else:
                    fo = jrl_fluid.fluid_b_ref(f, rho, vel, start + i, cfg, fields)
                for b in grp:
                    y0, rows = links[b][:2]
                    win[b][nq:nq + 9, 1:rows + 1] = fo[:, y0:y0 + rows]
                    if half == "A":
                        win[b][nq + 9:nq + 11, 1:rows + 1] = vo[:, y0:y0 + rows]
                        win[b][22, 1:rows + 1] = ro[y0:y0 + rows]
            _exchange(win, links, box, seq, next(passes), plan.cluster)
    fq = (n & 1) * 11
    out = (torch.empty(9, H, W), torch.empty(H, W), torch.empty(2, H, W))
    for b, (y0, rows, _, _) in enumerate(links):
        out[0][:, y0:y0 + rows] = win[b][fq:fq + 9, 1:rows + 1]
        out[1][y0:y0 + rows] = win[b][22, 1:rows + 1]
        out[2][:, y0:y0 + rows] = win[b][fq + 9:fq + 11, 1:rows + 1]
    return out


def _play_balance(h, C, flags, n, cfg, fields, plan):
    """`fused_balance_mc`'s launch on windows; returns ``(h, C)``."""
    H, W = cfg.eff_res
    links = mc_links(H, plan)
    P = F.MC_PLANES["fused_balance"]
    win = []
    for y0, rows, _, _ in links:
        rw = _rows(y0, rows, H)
        w = torch.full((P, rows + 2, W), NAN)
        w[0:9] = h[:, rw]
        w[18] = C[rw]
        win.append(w)
    box = torch.full((2 * plan.clusters, 2, P, W), NAN)
    seq = [0] * (2 * plan.clusters)
    groups = _groups(links, H)
    passes = iter(mc_passes("fused_balance", n))
    for i in range(n):
        cq, nq = (i & 1) * 9, ((i & 1) ^ 1) * 9
        for grp in groups:
            hg = torch.full((9, H, W), NAN)
            Cg = torch.full((H, W), NAN)
            for b in grp:
                rw = _rows(*links[b][:2], H)
                hg[:, rw] = win[b][cq:cq + 9]
                Cg[rw] = win[b][18]
            ho, Co = jrl_c.c_balance_ref(hg, Cg, flags, cfg, fields)
            for b in grp:
                y0, rows = links[b][:2]
                win[b][nq:nq + 9, 1:rows + 1] = ho[:, y0:y0 + rows]
                win[b][18, 1:rows + 1] = Co[y0:y0 + rows]
        _exchange(win, links, box, seq, next(passes), plan.cluster)
    fq = (n & 1) * 9
    out = (torch.empty(9, H, W), torch.empty(H, W))
    for b, (y0, rows, _, _) in enumerate(links):
        out[0][:, y0:y0 + rows] = win[b][fq:fq + 9, 1:rows + 1]
        out[1][y0:y0 + rows] = win[b][18, 1:rows + 1]
    return out


def _noisy(state, seed):
    rng = np.random.default_rng(seed)
    return {k: v + torch.as_tensor((1e-3 * rng.standard_normal(tuple(v.shape))).astype(np.float32))
            for k, v in state.items()}


def _equal(got, want, tag):
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.isfinite(g).all(), f"{tag}: NaN reached output {k}"
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=lambda m: f"{tag} output {k}: {m}")


@pytest.mark.parametrize("cluster", [16, 2, 1])
def test_fluid_launch_on_windows_equals_whole_grid(cluster):
    """256x128 (refine 2) on the H100 plans of clusters of 16 (112 bands of
    2 or 3 rows), 2 and 1 (128 bands of 2 rows, every block or every other
    with a mailbox side): four steps (eight passes, both mailbox slots
    twice) from windows, equal to the twin's steps."""
    cfg = T.JRLFluidConfig(shape="ethaline", refine=2)
    assert cfg.eff_res == (256, 128)
    s, fields = T.fluid_init(cfg, "cpu")
    s = _noisy(T.make_fluid_runner(cfg)(s, fields, 0, 2), 14)
    plan = F.mc_plan("fused_fluid", 256, 128, H100, cluster=cluster)
    got = _play_fluid(s, 2, 4, cfg, fields, plan)
    want = F.fused_fluid_ref(s["f"], s["rho"], s["vel"], 2, 4, cfg, fields)
    _equal(got, want, f"fluid, clusters of {cluster}")


@pytest.mark.parametrize("cluster", [16, 2, 1])
@pytest.mark.parametrize("is_negative", [True, False])
def test_balance_launch_on_windows_equals_whole_grid(cluster, is_negative):
    """256x128 balance, five steps from windows, equal to the twin's."""
    cfg = T.JRLCConfig(shape="ethaline", refine=2, is_negative=is_negative)
    st, fields, flags = T.c_init(cfg, "cpu")
    st = _noisy(T.make_balance_runner(cfg, flags)(st, fields, 2), 15)
    plan = F.mc_plan("fused_balance", 256, 128, H100, cluster=cluster)
    got = _play_balance(st["h"], st["C"], flags, 5, cfg, fields, plan)
    want = F.fused_balance_ref(st["h"], st["C"], flags, 5, cfg, fields)
    _equal(got, want, f"balance neg={is_negative}, clusters of {cluster}")


# --- the multi-cluster wrappers on the CPU: their twins, against JAX ---

def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


def test_fused_fluid_mc_on_cpu_matches_pallas():
    kw = dict(res=(48, 32), Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8,
              shape="cylinder")
    jc, tc = J.JRLFluidConfig(**kw), T.JRLFluidConfig(**kw)
    js, jf = J.fluid_init(jc)
    with _interpret():
        out = jax.tree.map(np.asarray,
                           JF.make_fused_fluid_runner(jc)(js, jf, jnp.asarray(0, jnp.int32), 9))
    _, tf = T.fluid_init(tc, "cpu")
    s = T.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    got = F.fused_fluid_mc(s["f"], s["rho"], s["vel"], 0, 9, tc, tf)
    routed = F.fused_fluid(s["f"], s["rho"], s["vel"], 0, 9, tc, tf, route="clusters")
    for key, g, r, tol in zip(("f", "rho", "vel"), got, routed, (2e-5, 2e-5, 2e-4)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
        np.testing.assert_allclose(g.numpy(), out[key], rtol=tol, atol=tol, err_msg=key)
    assert F.fused_fluid_mc.launches == 0


@pytest.mark.parametrize("is_negative", [True, False])
def test_fused_balance_mc_on_cpu_matches_pallas(is_negative):
    kw = dict(res=(48, 32), Re=4.0, Pe=5.0, vel_obs_real=0.2848, shape="45degree",
              is_negative=is_negative)
    jc, tc = J.JRLCConfig(**kw), T.JRLCConfig(**kw)
    js, jf, jflags = J.c_init(jc)
    with _interpret():
        out = jax.tree.map(np.asarray, JF.make_fused_balance_runner(jc, jflags)(js, jf, 9))
    _, tf, tflags = T.c_init(tc, "cpu")
    s = T.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    got = F.fused_balance_mc(s["h"], s["C"], tflags, 9, tc, tf)
    routed = F.fused_balance(s["h"], s["C"], tflags, 9, tc, tf, route="clusters")
    for key, g, r in zip(("h", "C"), got, routed):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
        np.testing.assert_allclose(g.numpy(), out[key], rtol=1e-5, atol=1e-5, err_msg=key)
    assert F.fused_balance_mc.launches == 0
