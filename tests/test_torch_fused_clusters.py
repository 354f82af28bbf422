"""The multi-cluster route of the multi-step JRL kernels
(`kernels/fused_jrl.py::fused_fluid_mc`, `fused_balance_mc`,
`fused_approach_mc`; `csrc/fused_fluid_mc.cu`, `csrc/fused_balance_mc.cu`,
`csrc/fused_approach_mc.cu` on `csrc/cluster_grid.cuh`) on the CPU: the
host plan on an H100's limits, the
mailbox and mbarrier arithmetic of the exchange (`mc_links`, `mc_passes`,
the mirrors of `GridBand` and of the kernels' step loops), a launch played
block by block on windows (each block's band computed from a grid that is
NaN outside its window, the halo rows arriving from the neighbours inside
a cluster or through the mailbox rows between clusters, as the schedule
says), which must equal the whole-grid twin bit for bit at 256x128 (the
approach's disk terms too, from the window of the block that holds the
disk rows, while the disk crosses a cluster edge), the approach's order of
summing the integrals over blocks and clusters, and
the wrappers, which run their twins here, against the JAX package's
Pallas runners in TPU interpret mode. The kernels themselves, against
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
    cooperative."""
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
    assert F.fused_route("fused_approach", 512, 256, tight_a) == "coop"
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
