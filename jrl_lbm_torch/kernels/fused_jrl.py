"""Multi-step kernels of the three JRL phases for grids of at most
``MAX_FUSED_CELLS`` cells (`csrc/fused_fluid.cu`, `csrc/fused_balance.cu`,
`csrc/fused_approach.cu`, the cluster kernels `csrc/fused_fluid_cl.cu`,
`csrc/fused_balance_cl.cu`, `csrc/fused_approach_cl.cu`, the
multi-cluster kernels `csrc/fused_fluid_mc.cu`, `csrc/fused_balance_mc.cu`,
`csrc/fused_approach_mc.cu`, the fluid's tile kernel
`csrc/fused_fluid_tl.cu` and the approach's row kernel
`csrc/fused_approach_rw.cu`), each with its plain PyTorch twin, and the
runners built on them.

Replace the TPU kernels of `jrl_lbm_tpu/ops/pallas/fused_jrl.py`:
``_make_jrl_fluid_kernel``, ``_make_balance_kernel`` and
``_make_approach_kernel``. One launch advances n steps. The balance
takes one of three routes, the fluid and the approach one of four,
picked by `fused_route` from the grid and the card's limits before any
launch: where the state fits the shared memory of one thread-block
cluster at one cell per thread (the default 128x64), the cluster kernel
keeps it there for the whole launch; the fluid of the grids of
``TILES_MIN_CELLS`` cells and more (256x128 and 512x256, refine 2 and 4)
runs each step as one wave of shared-memory tiles over the whole grid,
the state in device memory (L2) between steps (`fused_fluid_tl`, one grid
barrier a step), and the approach of the grids of ``ROWS_MIN_CELLS``
cells and more (256x128 and 512x256) each step as runs of whole rows, a run an SM,
each from its window in shared memory (`fused_approach_rw`, one grid
barrier a step, its divisions by reciprocals proved exact); the balance
of those grids keeps the state in the shared
memory of every cluster the card holds at once (`mc_plan`: bands of rows
over N clusters, halo rows between clusters through mailbox rows in
device memory) where that beats the cooperative grid on the card;
otherwise one persistent cooperative grid keeps it in device memory (L2)
between steps. A wrapper given tensors on the CPU runs its twin (the
loop of the per-step twins); given tensors on the card it launches the
kernel or raises, never falling back to another route.
``fused_fluid.launches``, ``fused_fluid_cl.launches``,
``fused_fluid_mc.launches``, ``fused_fluid_tl.launches``,
``fused_approach_mc.launches``, ``fused_approach_rw.launches`` etc.
count the launches of each kernel.
`fused_approach_lanes` runs many approach lanes (a Pe sweep's,
`parallel/sweep.py`) in one launch of the cluster kernel's lanes instance,
one cluster a lane.

The runners keep the signatures of the JAX package's
``make_fused_{fluid,balance,approach}_runner`` and split a run into
launches of at most ``MAX_LAUNCH_CELL_STEPS[kernel]`` cell updates.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from jrl_lbm_torch.kernels import build
from jrl_lbm_torch.kernels import jrl_sharded as _sh
from jrl_lbm_torch.kernels import jrl_tiled as _tl
from jrl_lbm_torch.kernels.jrl_c import CApproachParams, _approach_params, _balance_params, \
    c_approach_ref, c_balance_ref, convection_velocity, disk_integrals
from jrl_lbm_torch.kernels.jrl_fluid import _P, _a_params, _b_params, check_state, \
    fluid_a_ref, fluid_b_ref, sm_count, stream_of
from jrl_lbm_torch.models import jrl as _jrl

# Grids the multi-step kernels serve, as the JAX package's whole-domain
# kernels (`fused_jrl.py::MAX_FUSED_CELLS`): 512x256, refine 4 of 128x64.
MAX_FUSED_CELLS = 131072
FUSED_BLOCK = 256  # threads per block (csrc/fused_launch.cuh)
# the cooperative kernels' instances: at 131,072 cells an H100 SXM needs 2
# cells per thread for `fused_fluid` (2 blocks of 256 threads per SM; the
# route's yardstick there since `fused_fluid_tl`), a card with fewer SMs 4
CELLS_PER_THREAD = (1, 2, 4)
# Cell updates per launch, about a second of card time at 128x64 (13.3,
# 4.2 and 9.5 us a step on an NVIDIA H100 80GB HBM3 at 700 W,
# chip_smoke.py): 65,536 fluid steps
# (a record interval of the default case is ~39,000), 262,144 balance
# steps (a balance interval is 255,528) and 131,072 approach steps.
MAX_LAUNCH_CELL_STEPS = {"fused_fluid": 2**29, "fused_balance": 2**31, "fused_approach": 2**30}

# The cluster kernels (csrc/cluster_state.cuh): one cluster of 16 blocks
# (8 on a card that holds no cluster of 16), CLUSTER_THREADS threads per
# block, each block a band of rows (at least CLUSTER_MIN_ROWS) with one
# halo row a side in shared memory: window planes of each kernel
CLUSTER_THREADS = 512
CLUSTER_MIN_ROWS = 2
CLUSTER_PLANES = {"fused_fluid": 23, "fused_balance": 19, "fused_approach": 22}
# the multi-cluster kernels (csrc/cluster_grid.cuh): the same window planes
# over the bands of every cluster, and the mailbox rows of a slot (the most
# planes one pass sends: f or h; the approach's h and C)
MC_PLANES = {"fused_fluid": 23, "fused_balance": 19, "fused_approach": 22}
MC_ROW_PLANES = {"fused_fluid": 9, "fused_balance": 9, "fused_approach": 10}
MC_SIZES = (16, 8, 4, 2, 1)  # cluster sizes a plan may take (csrc/cluster_grid.cuh)
# the most cells a thread at which the route takes a multi-cluster plan:
# a step is one thread's cells one after the other, and on an H100 the
# fluid and the approach lose to the cooperative grid from two (512x256),
# the balance at none; the fluid takes the tiles from TILES_MIN_CELLS on
# and the approach the rows from ROWS_MIN_CELLS on, ahead of this rule
# (PERF.md §6, tools/fused_cluster_probe.py)
MC_MAX_CPT = {"fused_fluid": 1, "fused_balance": 4, "fused_approach": 1}
# the fewest cells at which the route takes the approach's row kernel
# (`fused_approach_rw`, grids with W % 4 == 0 up to MAX_FUSED_CELLS whose
# runs fit the card, `rw_plan`): on an H100 it beats the cooperative
# `fused_approach` at 512x256 by 33-41% (the multi-cluster kernel loses
# there) and `fused_approach_mc` at 256x128 by 16-20%, with the ethaline,
# 45degree and cylinder tips (PERF.md §6, tools/fused_cluster_probe.py rows)
ROWS_MIN_CELLS = {"fused_approach": 256 * 128}
# the fewest cells at which the route takes the fluid's tile kernel
# (`fused_fluid_tl`, grids with W % 4 == 0 up to MAX_FUSED_CELLS): on an
# H100 it beats the cooperative `fused_fluid` at 512x256 by 14-27% and
# `fused_fluid_mc` at 256x128 by ~9% with the wedge tips (the ethaline
# case's, 45degree), losing 2.5% there with a flat tip (PERF.md §6,
# tools/fused_cluster_probe.py tiles)
TILES_MIN_CELLS = {"fused_fluid": 256 * 128}
# the routes of every phase: "cluster" (one cluster), "clusters" (the
# multi-cluster kernels), "coop" (the cooperative grid), the fluid's
# "tiles" (`fused_fluid_tl`) and the approach's "rows" (`fused_approach_rw`)
ROUTES = ("cluster", "coop")
PHASE_ROUTES = {name: ("cluster", "clusters", "coop") + (("tiles",) if name in TILES_MIN_CELLS
                                                         else ())
                + (("rows",) if name in ROWS_MIN_CELLS else ())
                for name in ("fused_fluid", "fused_balance", "fused_approach")}


def fits(cfg) -> bool:
    """Whether the multi-step kernels serve the config's grid."""
    H, W = cfg.eff_res
    return H * W <= MAX_FUSED_CELLS


def steps_per_launch(cfg, name: str) -> int:
    """The most steps one launch of kernel ``name`` runs on the config's grid."""
    H, W = cfg.eff_res
    return max(1, MAX_LAUNCH_CELL_STEPS[name] // (H * W))


# ---------------------------------------------------------------------------
# Plain twins: the loops of the per-step twins
# ---------------------------------------------------------------------------

def fused_fluid_ref(f, rho, vel, start: int, n: int, cfg, fields):
    """Fluid steps ``start .. start + n - 1``; returns ``(f, rho, vel)``."""
    for i in range(int(n)):
        f, rho, vel = fluid_a_ref(f, rho, vel, int(start) + i, cfg, fields)
        f = fluid_b_ref(f, rho, vel, int(start) + i, cfg, fields)
    return f, rho, vel


def fused_balance_ref(h, C, flags, n: int, cfg, fields):
    """``n`` balance steps; returns ``(h, C)``."""
    for _ in range(int(n)):
        h, C = c_balance_ref(h, C, flags, cfg, fields)
    return h, C


def fused_approach_ref(h, C, vel_field, start: int, n: int, cfg, fields):
    """Approach steps ``start .. start + n - 1`` on the stored velocity
    ``vel_field`` ``[N, 2, H, W]``; returns ``(h, C, (inflow_sum,
    current_sum, rec_u, rec_v))`` with the sums over the steps and the
    record velocities of the last step."""
    zero = torch.zeros((), dtype=torch.float32)
    inflow_sum = current_sum = rec_u = rec_v = zero
    for i in range(int(n)):
        s = int(start) + i
        vel = _jrl.stored_velocity(vel_field, s, cfg.vel_obs_conv)
        h, C, (inflow, current, rec_u, rec_v) = c_approach_ref(h, C, vel, s, cfg, fields)
        inflow_sum = inflow_sum + inflow
        current_sum = current_sum + current
    return h, C, (inflow_sum, current_sum, rec_u, rec_v)


# ---------------------------------------------------------------------------
# Launch shape: a cooperative grid no larger than the co-resident limit
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def max_blocks(name: str, cpt: int, block: int, device_index: int) -> int:
    """Blocks of kernel ``name`` (``cpt`` cells per thread, ``block``
    threads) that fit on the card at once."""
    fn = build.bind(name, f"jrl_{name}_max_blocks", [ctypes.c_int, ctypes.c_int, _P])
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(fn(int(cpt), int(block), ctypes.byref(out)), name)
    return out.value


def check_coresident(name: str, cpt: int, block: int, grid: int, device_index: int) -> None:
    """Raise, before any launch, for a grid of kernel ``name`` over the
    co-resident limit: a cooperative grid must fit on the card at once."""
    limit = max_blocks(name, cpt, block, device_index)
    if not 1 <= grid <= limit:
        raise ValueError(f"{name}: grid of {grid} blocks of {block} threads is over the "
                         f"co-resident limit of {limit} blocks ({cpt} cells per thread)")


def launch_shape(name: str, cells: int, device_index: int):
    """``(cells per thread, blocks)``: the fewest cells per thread whose
    grid fits on the card at once."""
    for cpt in CELLS_PER_THREAD:
        grid = math.ceil(cells / (cpt * FUSED_BLOCK))
        if grid <= max_blocks(name, cpt, FUSED_BLOCK, device_index):
            return cpt, grid
    raise ValueError(f"{name}: {cells} cells do not fit one co-resident grid "
                     f"at up to {CELLS_PER_THREAD[-1]} cells per thread")


# ---------------------------------------------------------------------------
# Route: one cluster holding the state in shared memory, or the cooperative grid
# ---------------------------------------------------------------------------

class ClusterLimits(NamedTuple):
    """What the card offers a cluster kernel: the dynamic shared memory a
    block may opt in to (bytes, the card's opt-in less the kernel's static
    shared memory), the largest cluster (16, 8, or 0 for none) of which
    it holds one at that shared memory, and, for the multi-cluster
    kernels, ``active``: the clusters of each size of ``MC_SIZES`` it holds
    at once there (cudaOccupancyMaxActiveClusters; empty where there is no
    such kernel)."""

    smem_optin: int
    cluster: int
    active: tuple = ()


class McPlan(NamedTuple):
    """A launch of a multi-cluster kernel: ``clusters`` clusters of
    ``cluster`` blocks (one block an SM), ``cpt`` cells a thread, ``smem``
    bytes of shared memory a block."""

    clusters: int
    cluster: int
    cpt: int
    smem: int


def row_bands(H: int, C: int):
    """``[(y0, y1), ...]``: the rows of each of the ``C`` blocks, block r
    from ``r H // C`` (as `csrc/cluster_state.cuh::band_y0`)."""
    return [(r * H // C, (r + 1) * H // C) for r in range(C)]


def cluster_shape(name: str, H: int, W: int, limits: ClusterLimits):
    """``(blocks, cells per thread, shared memory bytes per block)`` of the
    cluster kernel of ``name`` on an ``H x W`` grid, or None where the
    state does not fit one cluster of a card with ``limits``: every band at
    least ``CLUSTER_MIN_ROWS`` rows, the largest band at most 4 cells per
    thread, its window (band and two halo rows) within the opt-in."""
    C = limits.cluster
    if C not in (8, 16):
        return None
    rows = [y1 - y0 for y0, y1 in row_bands(H, C)]
    if min(rows) < CLUSTER_MIN_ROWS:
        return None
    cpt = next((c for c in CELLS_PER_THREAD if max(rows) * W <= c * CLUSTER_THREADS), None)
    smem = CLUSTER_PLANES[name] * (max(rows) + 2) * W * 4
    if cpt is None or smem > limits.smem_optin:
        return None
    return C, cpt, smem


def mc_plan(name: str, H: int, W: int, limits: ClusterLimits, cluster: int | None = None):
    """The `McPlan` of the multi-cluster kernel of ``name`` (``"fused_fluid"``,
    ``"fused_balance"`` or ``"fused_approach"``) on an ``H x W`` grid, or None where the card
    with ``limits`` cannot hold it. For each cluster size of ``MC_SIZES``
    (``cluster`` forces one): as many clusters as the card holds at once
    and the bands allow (every band at least ``CLUSTER_MIN_ROWS`` rows,
    block b from ``b H // B`` over ``B`` blocks), the fewest cells a thread
    (1, 2, 4) that cover the largest band, its window within the opt-in.
    Of those, the fewest cells a thread, then the largest clusters: a step
    is one thread's cells one after the other, and every cluster edge is a
    mailbox row in device memory (PERF.md §6)."""
    if name not in MC_PLANES:
        return None
    active = dict(zip(MC_SIZES, limits.active))
    best = None
    for C in (cluster,) if cluster else MC_SIZES:
        N = min(active.get(C, 0), H // (C * CLUSTER_MIN_ROWS))
        if N < 1:
            continue
        rows_max = -(-H // (N * C))
        cpt = next((c for c in CELLS_PER_THREAD if rows_max * W <= c * CLUSTER_THREADS), None)
        smem = MC_PLANES[name] * (rows_max + 2) * W * 4
        if cpt is not None and smem <= limits.smem_optin and (best is None or cpt < best.cpt):
            best = McPlan(N, C, cpt, smem)
    return best


def tiles_take(name: str, H: int, W: int) -> bool:
    """Whether the route takes the tile kernel for ``name`` on an ``H x W``
    grid: the fluid from ``TILES_MIN_CELLS`` cells up to ``MAX_FUSED_CELLS``,
    rows of 16 bytes' multiples (W % 4 == 0: its bulk copies)."""
    least = TILES_MIN_CELLS.get(name)
    return least is not None and W % 4 == 0 and least <= H * W <= MAX_FUSED_CELLS


def rows_take(name: str, H: int, W: int, sms: int = _tl.PASS_SMS) -> bool:
    """Whether the route takes the row kernel for ``name`` on an ``H x W``
    grid of a card with ``sms`` SMs: the approach from ``ROWS_MIN_CELLS``
    cells up to ``MAX_FUSED_CELLS``, where `rw_plan` finds runs that fit
    (rows of 16 bytes' multiples, at most ``RW_CELLS`` cells a run, a run an
    SM)."""
    least = ROWS_MIN_CELLS.get(name)
    return least is not None and least <= H * W <= MAX_FUSED_CELLS \
        and rw_plan(H, W, sms) is not None


def fused_route(name: str, H: int, W: int, limits: ClusterLimits,
                sms: int = _tl.PASS_SMS) -> str:
    """``"cluster"`` where the state of ``name`` (``"fused_fluid"``,
    ``"fused_balance"`` or ``"fused_approach"``) on an ``H x W`` grid fits
    one cluster of a card with ``limits`` at one cell per thread;
    ``"tiles"`` for the fluid where `tiles_take` holds (``TILES_MIN_CELLS``:
    256x128 and 512x256 on an H100); ``"rows"`` for the approach where
    `rows_take` holds on a card of ``sms`` SMs (``ROWS_MIN_CELLS``: 256x128
    and 512x256 on an H100); ``"clusters"`` where the state fits the clusters the card
    holds at once (`mc_plan`) at most ``MC_MAX_CPT[name]`` cells a thread;
    else ``"coop"`` (the cooperative kernel). A cluster kernel's step is
    one thread's cell latency: one cluster at 2 or 4 cells a thread runs
    them one after the other on 16 SMs and loses to the cooperative grid
    (PERF.md §6: 256x128 at 4 cells a thread); every SM of the card at once
    keeps 1-2 cells a thread up to 512x256, where the approach's two lose to
    the cooperative grid; the row kernel beats both at both grids. The fluid's
    tiles win at both grids: one wave of tiles a step, the cell code on
    shared memory and tabled geometry, one grid barrier a step; the
    approach's rows likewise, a run of whole rows a block, with its
    divisions by reciprocals proved exact."""
    shape = cluster_shape(name, H, W, limits)
    if shape and shape[1] == 1:
        return "cluster"
    if tiles_take(name, H, W):
        return "tiles"
    if rows_take(name, H, W, sms):
        return "rows"
    plan = mc_plan(name, H, W, limits)
    return "clusters" if plan and plan.cpt <= MC_MAX_CPT[name] else "coop"


@functools.lru_cache(maxsize=16)
def card_limits(name: str, device_index: int) -> ClusterLimits:
    """The card's `ClusterLimits` for the cluster kernels of ``name``
    (queried once: opt-in shared memory, cudaOccupancyMaxActiveClusters)."""
    lib = f"{name}_cl"
    fn = build.bind(lib, f"jrl_{lib}_limits", [_P, _P])
    smem, cl, smem_mc = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    active = (ctypes.c_int * len(MC_SIZES))()
    with torch.cuda.device(device_index):
        build.check(fn(ctypes.byref(smem), ctypes.byref(cl)), lib)
        if name in MC_PLANES:
            mc = f"{name}_mc"
            fn = build.bind(mc, f"jrl_{mc}_limits", [_P, _P])
            build.check(fn(ctypes.byref(smem_mc), active), mc)
            smem.value = min(smem.value, smem_mc.value)
    return ClusterLimits(smem.value, cl.value, tuple(active) if name in MC_PLANES else ())


def cluster_info(name: str, cpt: int, device_index: int, lib: str | None = None):
    """``(registers per thread, local bytes)`` of the cluster kernel of
    ``name`` at ``cpt`` cells per thread (``lib`` ``"{name}_mc"``: the
    multi-cluster kernel's)."""
    lib = lib or f"{name}_cl"
    fn = build.bind(lib, f"jrl_{lib}_info", [ctypes.c_int, _P, _P])
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(fn(int(cpt), ctypes.byref(regs), ctypes.byref(local)), lib)
    return regs.value, local.value


def mc_info(name: str, cpt: int, device_index: int):
    """``(registers per thread, local bytes)`` of the multi-cluster kernel
    of ``name`` at ``cpt`` cells per thread."""
    return cluster_info(name, cpt, device_index, lib=f"{name}_mc")


def mc_active(name: str, plan: McPlan, device_index: int) -> int:
    """Clusters of ``plan.cluster`` blocks of the multi-cluster kernel of
    ``name`` that the card holds at once at ``plan.smem`` bytes a block."""
    lib = f"{name}_mc"
    fn = build.bind(lib, f"jrl_{lib}_active", [ctypes.c_int] * 3 + [_P])
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(fn(int(plan.cpt), int(plan.cluster), int(plan.smem), ctypes.byref(out)), lib)
    return out.value


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _route(name: str, cfg, dev: torch.device, route) -> str:
    if route is None:
        H, W = cfg.eff_res
        return fused_route(name, H, W, card_limits(name, _index(dev)), sm_count(dev))
    routes = PHASE_ROUTES[name]
    if route not in routes:
        raise ValueError(f"route {route!r}: one of {routes}")
    return route


def _cluster_shape(name: str, cfg, dev: torch.device):
    """The cluster launch of ``name`` on the config's grid; raises, before
    any launch, where the state does not fit one cluster of the card."""
    H, W = cfg.eff_res
    limits = card_limits(name, _index(dev))
    shape = cluster_shape(name, H, W, limits)
    if shape is None:
        raise ValueError(f"{name}_cl: grid {H}x{W} is over the cluster limit of the card "
                         f"({limits.cluster} blocks, {limits.smem_optin} bytes of shared "
                         f"memory a block, bands of >= {CLUSTER_MIN_ROWS} rows)")
    return shape


def _mc_plan(name: str, cfg, dev: torch.device, plan) -> McPlan:
    """The multi-cluster launch of ``name`` on the config's grid (``plan``
    None: `mc_plan`'s); raises, before any launch, where the card holds no
    plan or the plan's clusters are not all resident at once."""
    H, W = cfg.eff_res
    index = _index(dev)
    if plan is None:
        limits = card_limits(name, index)
        plan = mc_plan(name, H, W, limits)
        if plan is None:
            raise ValueError(f"{name}_mc: grid {H}x{W} has no multi-cluster plan on the card "
                             f"(clusters of {MC_SIZES} blocks at once: {limits.active}, "
                             f"{limits.smem_optin} bytes of shared memory a block, bands of "
                             f">= {CLUSTER_MIN_ROWS} rows)")
    plan = McPlan(*plan)
    active = mc_active(name, plan, index)
    if not 1 <= plan.clusters <= active:
        raise ValueError(f"{name}_mc: {plan.clusters} clusters of {plan.cluster} blocks are "
                         f"over the co-resident limit of {active} at {plan.smem} bytes a block")
    return plan


def _mailbox(name: str, plan: McPlan, W: int, dev: torch.device, extra: int = 0):
    """The mailbox words of a launch of the multi-cluster kernel of ``name``
    (`csrc/cluster_grid.cuh`: two sides of two slots of
    ``MC_ROW_PLANES[name]`` rows a cluster) and ``extra`` words after them,
    zeroed: a word's pass number starts at 0, which no pass carries."""
    words = plan.clusters * 4 * MC_ROW_PLANES[name] * W
    return torch.zeros(words + extra, dtype=torch.int64, device=dev)


def _approach_box(plan: McPlan, W: int, dev: torch.device):
    """``(box, table, ticket)`` of a `fused_approach_mc` launch: the zeroed
    mailbox words, then the addresses after them of the table of each
    cluster's per-column sums (``[clusters][2][FUSED_BLOCK]`` floats, two to
    a word) and of the ticket."""
    extra = plan.clusters * FUSED_BLOCK + 1
    box = _mailbox("fused_approach", plan, W, dev, extra=extra)
    table = box.data_ptr() + 8 * (box.numel() - extra)
    return box, table, table + 8 * plan.clusters * FUSED_BLOCK


def _launch(name: str, cells: int, dev: torch.device, argtypes, args) -> None:
    index = _index(dev)
    cpt, grid = launch_shape(name, cells, index)
    check_coresident(name, cpt, FUSED_BLOCK, grid, index)
    fn = build.bind(name, f"jrl_{name}", argtypes + [ctypes.c_int, ctypes.c_int, _P])
    with torch.cuda.device(dev):
        err = fn(*args, cpt, grid, stream_of(dev))
    build.check(err, name)


def _ping_pong(out, n: int):
    """``(P, Q)`` buffer sets: step i writes P for even i, Q for odd i, so
    the last step (i = n - 1) writes ``out``."""
    tmp = [torch.empty_like(t) for t in out]
    return (out, tmp) if n % 2 == 1 else (tmp, out)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def fused_fluid(f, rho, vel, start: int, n: int, cfg, fields, route=None):
    """Fluid steps ``start .. start + n - 1`` in one launch; returns new
    ``(f, rho, vel)``. The kernel computes the tip geometry from ``cfg`` and
    the step; ``fields`` feed the twin. ``route`` (one of
    ``PHASE_ROUTES["fused_fluid"]``) forces a kernel; None takes
    `fused_route`'s."""
    if f.device.type == "cpu":
        return fused_fluid_ref(f, rho, vel, start, n, cfg, fields)
    dev = check_state(cfg, start, n, f=(f, (9,)), rho=(rho, ()), vel=(vel, (2,)))
    kind = _route("fused_fluid", cfg, dev, route)
    if kind == "cluster":
        return fused_fluid_cl(f, rho, vel, start, n, cfg, fields)
    if kind == "clusters":
        return fused_fluid_mc(f, rho, vel, start, n, cfg, fields)
    if kind == "tiles":
        return fused_fluid_tl(f, rho, vel, start, n, cfg, fields)
    out = (torch.empty_like(f), torch.empty_like(rho), torch.empty_like(vel))
    P, Q = _ping_pong(out, n)
    H, W = cfg.eff_res
    _launch("fused_fluid", H * W, dev, [_P] * 9 + [ctypes.c_int] * 2 + [_P, _P],
            [f.data_ptr(), rho.data_ptr(), vel.data_ptr(), *(t.data_ptr() for t in P),
             *(t.data_ptr() for t in Q), int(start), int(n), ctypes.byref(_a_params(cfg)),
             ctypes.byref(_b_params(cfg))])
    fused_fluid.launches += 1
    return out


def fused_balance(h, C, flags, n: int, cfg, fields, route=None):
    """``n`` balance steps in one launch; returns new ``(h, C)``.
    ``route`` as for `fused_fluid`."""
    if h.device.type == "cpu":
        return fused_balance_ref(h, C, flags, n, cfg, fields)
    dev = check_state(cfg, 0, n, h=(h, (9,)), C=(C, ()), flags=(flags, ()))
    kind = _route("fused_balance", cfg, dev, route)
    if kind == "cluster":
        return fused_balance_cl(h, C, flags, n, cfg, fields)
    if kind == "clusters":
        return fused_balance_mc(h, C, flags, n, cfg, fields)
    out = (torch.empty_like(h), torch.empty_like(C))
    P, Q = _ping_pong(out, n)
    H, W = cfg.eff_res
    _launch("fused_balance", H * W, dev, [_P] * 7 + [ctypes.c_int, _P],
            [flags.data_ptr(), h.data_ptr(), C.data_ptr(), *(t.data_ptr() for t in P),
             *(t.data_ptr() for t in Q), int(n), ctypes.byref(_balance_params(cfg))])
    fused_balance.launches += 1
    return out


def fused_fluid_cl(f, rho, vel, start: int, n: int, cfg, fields):
    """`fused_fluid` through the cluster kernel (the state in the shared
    memory of one cluster); raises before launch on a grid over the
    cluster limit."""
    if f.device.type == "cpu":
        return fused_fluid_ref(f, rho, vel, start, n, cfg, fields)
    dev = check_state(cfg, start, n, f=(f, (9,)), rho=(rho, ()), vel=(vel, (2,)))
    cluster, cpt, smem = _cluster_shape("fused_fluid", cfg, dev)
    out = (torch.empty_like(f), torch.empty_like(rho), torch.empty_like(vel))
    fn = build.bind("fused_fluid_cl", "jrl_fused_fluid_cl",
                    [_P] * 6 + [ctypes.c_int] * 2 + [_P, _P] + [ctypes.c_int] * 3 + [_P])
    with torch.cuda.device(dev):
        err = fn(f.data_ptr(), rho.data_ptr(), vel.data_ptr(), *(t.data_ptr() for t in out),
                 int(start), int(n), ctypes.byref(_a_params(cfg)), ctypes.byref(_b_params(cfg)),
                 cluster, cpt, smem, stream_of(dev))
    build.check(err, "fused_fluid_cl")
    fused_fluid_cl.launches += 1
    return out


def fused_balance_cl(h, C, flags, n: int, cfg, fields):
    """`fused_balance` through the cluster kernel; raises before launch on
    a grid over the cluster limit."""
    if h.device.type == "cpu":
        return fused_balance_ref(h, C, flags, n, cfg, fields)
    dev = check_state(cfg, 0, n, h=(h, (9,)), C=(C, ()), flags=(flags, ()))
    cluster, cpt, smem = _cluster_shape("fused_balance", cfg, dev)
    out = (torch.empty_like(h), torch.empty_like(C))
    fn = build.bind("fused_balance_cl", "jrl_fused_balance_cl",
                    [_P] * 5 + [ctypes.c_int, _P] + [ctypes.c_int] * 3 + [_P])
    with torch.cuda.device(dev):
        err = fn(flags.data_ptr(), h.data_ptr(), C.data_ptr(), *(t.data_ptr() for t in out),
                 int(n), ctypes.byref(_balance_params(cfg)), cluster, cpt, smem, stream_of(dev))
    build.check(err, "fused_balance_cl")
    fused_balance_cl.launches += 1
    return out


def fused_fluid_mc(f, rho, vel, start: int, n: int, cfg, fields, plan=None):
    """`fused_fluid` through the multi-cluster kernel (the state in the
    shared memory of every cluster the card holds at once); ``plan`` (a
    `McPlan`) forces a launch shape, None takes `mc_plan`'s. Raises before
    launch where the card holds no plan or not the plan's clusters at
    once."""
    if f.device.type == "cpu":
        return fused_fluid_ref(f, rho, vel, start, n, cfg, fields)
    dev = check_state(cfg, start, n, f=(f, (9,)), rho=(rho, ()), vel=(vel, (2,)))
    plan = _mc_plan("fused_fluid", cfg, dev, plan)
    out = (torch.empty_like(f), torch.empty_like(rho), torch.empty_like(vel))
    box = _mailbox("fused_fluid", plan, cfg.eff_res[1], dev)
    fn = build.bind("fused_fluid_mc", "jrl_fused_fluid_mc",
                    [_P] * 6 + [ctypes.c_int] * 2 + [_P] * 3 + [ctypes.c_int] * 4 + [_P])
    with torch.cuda.device(dev):
        err = fn(f.data_ptr(), rho.data_ptr(), vel.data_ptr(), *(t.data_ptr() for t in out),
                 int(start), int(n), ctypes.byref(_a_params(cfg)), ctypes.byref(_b_params(cfg)),
                 box.data_ptr(), *plan, stream_of(dev))
    build.check(err, "fused_fluid_mc")
    fused_fluid_mc.launches += 1
    return out


def fused_balance_mc(h, C, flags, n: int, cfg, fields, plan=None):
    """`fused_balance` through the multi-cluster kernel; ``plan`` and the
    checks as for `fused_fluid_mc`."""
    if h.device.type == "cpu":
        return fused_balance_ref(h, C, flags, n, cfg, fields)
    dev = check_state(cfg, 0, n, h=(h, (9,)), C=(C, ()), flags=(flags, ()))
    plan = _mc_plan("fused_balance", cfg, dev, plan)
    out = (torch.empty_like(h), torch.empty_like(C))
    box = _mailbox("fused_balance", plan, cfg.eff_res[1], dev)
    fn = build.bind("fused_balance_mc", "jrl_fused_balance_mc",
                    [_P] * 5 + [ctypes.c_int] + [_P] * 2 + [ctypes.c_int] * 4 + [_P])
    with torch.cuda.device(dev):
        err = fn(flags.data_ptr(), h.data_ptr(), C.data_ptr(), *(t.data_ptr() for t in out),
                 int(n), ctypes.byref(_balance_params(cfg)), box.data_ptr(), *plan,
                 stream_of(dev))
    build.check(err, "fused_balance_mc")
    fused_balance_mc.launches += 1
    return out


def _approach_ref_acc(h, C, vel_field, start, n, cfg, fields, acc):
    h, C, (inflow_sum, current_sum, rec_u, rec_v) = fused_approach_ref(
        h, C, vel_field, start, n, cfg, fields)
    acc[0] += inflow_sum
    acc[1] += current_sum
    acc[2] = rec_u
    acc[3] = rec_v
    return h, C


def _check_approach(h, C, vel_field, start, n, cfg, fields, acc) -> torch.device:
    base = fields["base_flags"]
    n_frames = int(vel_field.shape[0])
    dev = check_state(cfg, start, n, h=(h, (9,)), C=(C, ()), base_flags=(base, ()),
                      vel_field=(vel_field, (n_frames, 2)))
    rint = cfg.radius_obs_int
    area = fields["area"]
    if n_frames < 1:
        raise ValueError("vel_field holds no frame")
    if rint + 1 > cfg.eff_res[1] or rint > FUSED_BLOCK:
        raise ValueError(f"tip disk of {rint} cells does not fit the grid or one block")
    if tuple(area.shape) != (rint,) or area.dtype != torch.float32 or area.device != dev:
        raise ValueError("area must be a float32 [rint] tensor on the card")
    if tuple(acc.shape) != (4,) or acc.dtype != torch.float32 or acc.device != dev:
        raise ValueError("acc must be a float32 [4] tensor on the card")
    return dev


def fused_approach(h, C, vel_field, start: int, n: int, cfg, fields, acc, route=None):
    """Approach steps ``start .. start + n - 1`` in one launch on the
    stored velocity ``vel_field`` (float32 ``[N, 2, H, W]``); returns new
    ``(h, C)`` and updates ``acc`` (float32 ``[4]`` on the state's device)
    in place: ``acc[0] += inflow_sum``, ``acc[1] += current_sum``,
    ``acc[2] = rec_u``, ``acc[3] = rec_v`` of the last step. ``route`` as
    for `fused_fluid`."""
    if h.device.type == "cpu":
        return _approach_ref_acc(h, C, vel_field, start, n, cfg, fields, acc)
    dev = _check_approach(h, C, vel_field, start, n, cfg, fields, acc)
    kind = _route("fused_approach", cfg, dev, route)
    if kind == "cluster":
        return fused_approach_cl(h, C, vel_field, start, n, cfg, fields, acc)
    if kind == "clusters":
        return fused_approach_mc(h, C, vel_field, start, n, cfg, fields, acc)
    if kind == "rows":
        return fused_approach_rw(h, C, vel_field, start, n, cfg, fields, acc)
    base, area, n_frames = fields["base_flags"], fields["area"], int(vel_field.shape[0])
    out = (torch.empty_like(h), torch.empty_like(C))
    P, Q = _ping_pong(out, n)
    H, W = cfg.eff_res
    _launch("fused_approach", H * W, dev,
            [_P, _P, ctypes.c_int] + [_P] * 7 + [ctypes.c_int] * 2 + [_P],
            [base.data_ptr(), vel_field.data_ptr(), n_frames, area.data_ptr(), h.data_ptr(),
             *(t.data_ptr() for t in P), *(t.data_ptr() for t in Q), acc.data_ptr(),
             int(start), int(n), ctypes.byref(_approach_params(cfg))])
    fused_approach.launches += 1
    return out


def fused_approach_cl(h, C, vel_field, start: int, n: int, cfg, fields, acc):
    """`fused_approach` through the cluster kernel (the state in the shared
    memory of one cluster); raises before launch on a grid over the
    cluster limit. Reads no C: the old C is never used by the step."""
    if h.device.type == "cpu":
        return _approach_ref_acc(h, C, vel_field, start, n, cfg, fields, acc)
    dev = _check_approach(h, C, vel_field, start, n, cfg, fields, acc)
    base = fields["base_flags"]
    cluster, cpt, smem = _cluster_shape("fused_approach", cfg, dev)
    out = (torch.empty_like(h), torch.empty_like(C))
    fn = build.bind("fused_approach_cl", "jrl_fused_approach_cl",
                    [_P, _P, ctypes.c_int] + [_P] * 5 + [ctypes.c_int] * 2 + [_P]
                    + [ctypes.c_int] * 3 + [_P])
    with torch.cuda.device(dev):
        err = fn(base.data_ptr(), vel_field.data_ptr(), int(vel_field.shape[0]),
                 fields["area"].data_ptr(), h.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                 acc.data_ptr(), int(start), int(n), ctypes.byref(_approach_params(cfg)),
                 cluster, cpt, smem, stream_of(dev))
    build.check(err, "fused_approach_cl")
    fused_approach_cl.launches += 1
    return out


def fused_approach_mc(h, C, vel_field, start: int, n: int, cfg, fields, acc, plan=None):
    """`fused_approach` through the multi-cluster kernel (the state in the
    shared memory of every cluster the card holds at once); ``plan`` and
    the checks as for `fused_fluid_mc`. Reads no C. The integrals go through
    a table of each cluster's per-column sums and a ticket, both after the
    mailbox words: the last cluster to finish sums them and resets the
    ticket."""
    if h.device.type == "cpu":
        return _approach_ref_acc(h, C, vel_field, start, n, cfg, fields, acc)
    dev = _check_approach(h, C, vel_field, start, n, cfg, fields, acc)
    plan = _mc_plan("fused_approach", cfg, dev, plan)
    out = (torch.empty_like(h), torch.empty_like(C))
    box, table, ticket = _approach_box(plan, cfg.eff_res[1], dev)
    fn = build.bind("fused_approach_mc", "jrl_fused_approach_mc",
                    [_P, _P, ctypes.c_int] + [_P] * 5 + [ctypes.c_int] * 2 + [_P] * 4
                    + [ctypes.c_int] * 4 + [_P])
    with torch.cuda.device(dev):
        err = fn(fields["base_flags"].data_ptr(), vel_field.data_ptr(), int(vel_field.shape[0]),
                 fields["area"].data_ptr(), h.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                 acc.data_ptr(), int(start), int(n), ctypes.byref(_approach_params(cfg)),
                 box.data_ptr(), table, ticket, *plan, stream_of(dev))
    build.check(err, "fused_approach_mc")
    fused_approach_mc.launches += 1
    return out


# ---------------------------------------------------------------------------
# The fluid's tile kernel: n steps of the whole grid, one wave of tiles a step
# ---------------------------------------------------------------------------

def tl_plan(H: int, W: int, sms: int = _tl.PASS_SMS) -> _sh.TilePlan:
    """The tiles of a step of `fused_fluid_tl` on an ``H x W`` grid on a card
    of ``sms`` SMs: `jrl_sharded.pass_sh_plan`'s for the grid as a mesh of
    one row at k = 1 (``nty[0]`` row bands x ``ntx`` column strips, the
    largest tile ``rmax`` x ``smax`` B cells, ``grid`` blocks)."""
    return _sh.pass_sh_plan(_sh.Shard.of(int(H), int(W), (1, 1), (0, 0)), 1, int(sms))


def fused_fluid_tl_ref(f, rho, vel, start: int, n: int, cfg, fields, plan=None):
    """Twin of `fused_fluid_tl`: the launch played tile by tile (``plan``,
    `tl_plan`'s for an H100 when None), each step over the whole grid, each
    tile's A on its rows and columns one past its B cells and its B from a
    window of rows -2 .. R + 1 (mod H) and columns two past the tile, NaN
    beyond it; the class bodies of the tile kernels' twins
    (`jrl_tiled.py::_a_full`, ``_b_full``) on that window. Equals
    `fused_fluid_ref` bit for bit. Returns ``(f, rho, vel)``."""
    H, W = cfg.eff_res
    plan = plan or tl_plan(H, W)
    nan = float("nan")
    cur = (f, rho, vel)
    for i in range(int(n)):
        step = int(start) + i
        nxt = (torch.full_like(f, nan), torch.full_like(rho, nan), torch.full_like(vel, nan))
        for e0, e1, sx0, sx1, _, _ in plan.tiles(0, H, W):
            R = e1 - e0
            win = torch.arange(e0 - 2, e1 + 2, device=f.device) % H
            cols = torch.zeros(W, dtype=torch.bool, device=f.device)
            cols[max(sx0 - 2, 0):min(sx1 + 2, W)] = True

            def cut(x):
                return torch.where(cols, x.index_select(-2, win), nan)

            f1, rho1, vel1 = _tl._a_full(cfg, step, e0 - 1, R + 2, cut(cur[0]), cut(cur[2]),
                                         cut(cur[1])[1:-1])
            fo = _tl._b_full(cfg, step, e0, R, f1[:, 1:-1], rho1, vel1)
            nxt[0][:, e0:e1, sx0:sx1] = fo[:, :, sx0:sx1]
            nxt[1][e0:e1, sx0:sx1] = rho1[1:-1, sx0:sx1]
            nxt[2][:, e0:e1, sx0:sx1] = vel1[:, 1:-1, sx0:sx1]
        cur = nxt
    return cur


@functools.lru_cache(maxsize=64)
def _tl_args(cfg, plan: _sh.TilePlan):
    """The launch constants of `fused_fluid_tl`: step A's, step B's and the
    tiles' (`csrc/pass_sh.cuh::ShTilePlan`)."""
    return _a_params(cfg), _b_params(cfg), _sh._tile_plan_struct(plan)


def _check_tl(cfg, start: int, n: int, f, rho, vel) -> torch.device:
    """`check_state` of steps ``start .. start + n - 1``, and the rows the
    kernel copies: W % 4 == 0, each plane 16-byte aligned."""
    dev = check_state(cfg, start, n, f=(f, (9,)), rho=(rho, ()), vel=(vel, (2,)))
    if cfg.eff_res[1] % 4 or any(t.data_ptr() % 16 for t in (f, rho, vel)):
        raise ValueError("fused_fluid_tl copies rows of 16-byte aligned planes (W % 4 == 0)")
    return dev


def _tl_launch(f, rho, vel, start: int, n: int, cfg, dev: torch.device, plan: _sh.TilePlan):
    """One launch of `fused_fluid_tl`, its arguments checked by the caller;
    returns the new ``(f, rho, vel)``. The second buffer set (`_ping_pong`)
    lives here until the launch is queued."""
    out = (torch.empty_like(f), torch.empty_like(rho), torch.empty_like(vel))
    P, Q = _ping_pong(out, n)
    pa, pb, pt = _tl_args(cfg, plan)
    fn = build.bind("fused_fluid_tl", "jrl_fused_fluid_tl",
                    [_P] * 9 + [ctypes.c_int] * 2 + [_P] * 4)
    with torch.cuda.device(dev):
        err = fn(f.data_ptr(), rho.data_ptr(), vel.data_ptr(), *(t.data_ptr() for t in P),
                 *(t.data_ptr() for t in Q), int(start), int(n), ctypes.byref(pa),
                 ctypes.byref(pb), ctypes.byref(pt), stream_of(dev))
    build.check(err, "fused_fluid_tl")
    fused_fluid_tl.launches += 1
    return out


def fused_fluid_tl(f, rho, vel, start: int, n: int, cfg, fields, plan=None):
    """`fused_fluid` through the tile kernel: n steps of the whole grid in
    one cooperative launch, each step one wave of shared-memory tiles (A
    then B in each tile), one grid barrier a step; ``plan`` (a
    `jrl_sharded.TilePlan`) forces the tiles, None takes `tl_plan`'s for the
    card. Raises before launch on rows that are not 16-byte multiples and,
    from the launcher, on a plan over the card's co-resident limit."""
    if f.device.type == "cpu":
        return fused_fluid_tl_ref(f, rho, vel, start, n, cfg, fields, plan)
    dev = _check_tl(cfg, start, n, f, rho, vel)
    return _tl_launch(f, rho, vel, start, n, cfg, dev, plan or tl_plan(*cfg.eff_res,
                                                                       sm_count(dev)))


def tl_info(device_index: int = 0):
    """``(registers per thread, local bytes)`` of `fused_fluid_tl`."""
    fn = build.bind("fused_fluid_tl", "jrl_fused_fluid_tl_info", [_P, _P])
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(fn(ctypes.byref(regs), ctypes.byref(local)), "fused_fluid_tl")
    return regs.value, local.value


def tl_tile_shape(rmax: int, smax: int, device_index: int = 0):
    """The kernel's own ``(threads, shared memory cap, bytes of an rmax x
    smax tile, co-resident blocks at that size)``, which `tl_plan` mirrors
    (`jrl_sharded.TILE_THREADS`, ``TILE_SMEM_CAP``, ``tile_smem_bytes``)."""
    fn = build.bind("fused_fluid_tl", "jrl_fused_fluid_tl_tile_shape", [ctypes.c_int] * 2
                    + [_P] * 4)
    out = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device_index):
        build.check(fn(int(rmax), int(smax), *(ctypes.byref(x) for x in out)), "fused_fluid_tl")
    return tuple(x.value for x in out)


# ---------------------------------------------------------------------------
# The approach's row kernel: n steps of the whole grid, a run of rows a block
# ---------------------------------------------------------------------------

RW_CELLS = 1024  # the most cells of a run (csrc/fused_approach_rw.cu)
RW_COLS = 8      # floats of a column's terms in a block's shared memory
# the dynamic shared memory a block may take: the tiles' cap less the
# kernel's static reduction tree
RW_SMEM_CAP = _sh.TILE_SMEM_CAP - 16 * FUSED_BLOCK


class RwPlan(NamedTuple):
    """A launch of `fused_approach_rw`: ``nruns`` blocks, block b computing
    rows ``[b H // nruns, (b + 1) H // nruns)`` (`row_bands`), planes of
    ``wrows`` window rows (the longest run and one row a side), ``smem``
    bytes of shared memory a block."""

    nruns: int
    wrows: int
    smem: int


class RwParams(ctypes.Structure):
    _fields_ = [("a", CApproachParams), ("nruns", ctypes.c_int), ("wrows", ctypes.c_int),
                ("n_frames", ctypes.c_int)]


def rw_smem_bytes(wrows: int, W: int) -> int:
    """Dynamic shared memory of a block whose planes hold ``wrows`` rows
    (`csrc/fused_approach_rw.cu::rw_smem_bytes`): an mbarrier a row
    (16-byte aligned), h (9 planes), phi and the flag codes, the column
    terms and the run's cells' frame pair."""
    return -(-wrows * 8 // 16) * 16 + ((wrows * 11 + RW_COLS) * W + 4 * RW_CELLS) * 4


def rw_plan_of(H: int, W: int, nruns: int):
    """The `RwPlan` of ``nruns`` runs on an ``H x W`` grid, or None where the
    kernel cannot take it: runs of at least two rows (an OUTFLOW cell of row
    0 or H - 1 reads two rows inward, inside the first and last runs'
    windows), at most ``RW_CELLS`` cells, rows of 16 bytes' multiples (the
    bulk copies), the window within ``RW_SMEM_CAP``."""
    nruns = int(nruns)
    if W % 4 or nruns < 1 or H // nruns < 2:
        return None
    longest = -(-H // nruns)
    wrows = longest + 2
    if longest * W > RW_CELLS or rw_smem_bytes(wrows, W) > RW_SMEM_CAP:
        return None
    return RwPlan(nruns, wrows, rw_smem_bytes(wrows, W))


def rw_plan(H: int, W: int, sms: int = _tl.PASS_SMS):
    """The runs of `fused_approach_rw` on an ``H x W`` grid of a card with
    ``sms`` SMs, one block an SM at most, or None where they do not fit: runs
    of ``max(2, ceil(H / sms))`` rows as far as the rows go (512x256 on 132
    SMs: 128 runs of 4 rows, one cell a thread of 1024)."""
    rows = max(2, -(-int(H) // int(sms)))
    plan = rw_plan_of(H, W, max(1, min(-(-int(H) // rows), int(H) // 2)))
    return plan if plan is not None and plan.nruns <= int(sms) else None


def fused_approach_rw_ref(h, C, vel_field, start: int, n: int, cfg, fields, nruns=None):
    """Twin of `fused_approach_rw`: the launch played run by run (``nruns``
    runs, `rw_plan`'s for an H100 when None), each step of each run the
    approach step `c_approach_ref` on the run's window only (its rows and
    one a side, mod H, NaN elsewhere; no old C, which the step never reads),
    its rows kept; then the step's integrals from the new C of every run, as
    the kernel's block 0 adds them after the grid barrier. Equals
    `fused_approach_ref` bit for bit; returns ``(h, C, (inflow_sum,
    current_sum, rec_u, rec_v))``."""
    H, W = cfg.eff_res
    nruns = rw_plan(H, W).nruns if nruns is None else int(nruns)
    if not 1 <= nruns <= H // 2:
        raise ValueError(f"{nruns} runs of {H} rows: every run takes two rows or more")
    nan = float("nan")
    zero = torch.zeros((), dtype=torch.float32)
    inflow_sum = current_sum = rec_u = rec_v = zero
    v = cfg.vel_obs_conv
    for i in range(int(n)):
        s = int(start) + i
        vel = _jrl.stored_velocity(vel_field, s, v)
        h_new = torch.full_like(h, nan)
        C_new = torch.full_like(h[0], nan)
        for y0, y1 in row_bands(H, nruns):
            win = torch.arange(y0 - 1, y1 + 1, device=h.device) % H
            h_win = torch.full_like(h, nan)
            h_win[:, win] = h[:, win]
            ho, Co, _ = c_approach_ref(h_win, torch.zeros_like(C_new), vel, s, cfg, fields)
            h_new[:, y0:y1] = ho[:, y0:y1]
            C_new[y0:y1] = Co[y0:y1]
        h = h_new
        walks_int = _jrl.tip_walks(cfg.inflow_height, s, v)[1]
        inflow, current, rec_u, rec_v = disk_integrals(
            C_new, convection_velocity(vel, walks_int, cfg, v), walks_int, cfg, fields)
        inflow_sum = inflow_sum + inflow
        current_sum = current_sum + current
        C = C_new
    return h, C, (inflow_sum, current_sum, rec_u, rec_v)


@functools.lru_cache(maxsize=64)
def _rw_args(cfg, plan: RwPlan, n_frames: int) -> RwParams:
    """The launch constants of `fused_approach_rw` (`csrc/fused_approach_rw.cu::RwParams`)."""
    return RwParams(a=_approach_params(cfg), nruns=plan.nruns, wrows=plan.wrows,
                    n_frames=int(n_frames))


def _check_rw(h, C, vel_field, start: int, n: int, cfg, fields, acc) -> torch.device:
    """`_check_approach` of steps ``start .. start + n - 1``, and the rows
    the kernel copies: W % 4 == 0, h's planes 16-byte aligned."""
    dev = _check_approach(h, C, vel_field, start, n, cfg, fields, acc)
    if cfg.eff_res[1] % 4 or h.data_ptr() % 16:
        raise ValueError("fused_approach_rw copies rows of 16-byte aligned planes (W % 4 == 0)")
    return dev


def _rw_launch(h, vel_field, start: int, n: int, cfg, fields, acc, dev: torch.device,
               plan: RwPlan):
    """One launch of `fused_approach_rw`, its arguments checked by the
    caller; returns the new ``(h, C)`` and updates ``acc``. The second
    buffer set (`_ping_pong`) lives here until the launch is queued."""
    H, W = cfg.eff_res
    out = (torch.empty_like(h), torch.empty((H, W), dtype=torch.float32, device=dev))
    P, Q = _ping_pong(out, n)
    params = _rw_args(cfg, RwPlan(*plan), int(vel_field.shape[0]))
    fn = build.bind("fused_approach_rw", "jrl_fused_approach_rw",
                    [_P] * 9 + [ctypes.c_int] * 2 + [_P, _P])
    with torch.cuda.device(dev):
        err = fn(fields["base_flags"].data_ptr(), vel_field.data_ptr(), fields["area"].data_ptr(),
                 h.data_ptr(), *(t.data_ptr() for t in P), *(t.data_ptr() for t in Q),
                 acc.data_ptr(), int(start), int(n), ctypes.byref(params), stream_of(dev))
    build.check(err, "fused_approach_rw")
    fused_approach_rw.launches += 1
    return out


def fused_approach_rw(h, C, vel_field, start: int, n: int, cfg, fields, acc, plan=None):
    """`fused_approach` through the row kernel: n steps of the whole grid in
    one cooperative launch, a run of whole rows a block (one an SM), its
    window by bulk copies, the tip tabled once a window cell and step, one
    grid barrier a step; ``plan`` (an `RwPlan`) forces the runs, None takes
    `rw_plan`'s for the card. Reads no C. Raises before launch on rows that
    are not 16-byte multiples or a grid with no plan, and from the launcher
    on a plan over the card's co-resident limit."""
    if h.device.type == "cpu":
        nruns = None if plan is None else RwPlan(*plan).nruns
        h, C, (inflow_sum, current_sum, rec_u, rec_v) = fused_approach_rw_ref(
            h, C, vel_field, start, n, cfg, fields, nruns)
        acc[0] += inflow_sum
        acc[1] += current_sum
        acc[2] = rec_u
        acc[3] = rec_v
        return h, C
    dev = _check_rw(h, C, vel_field, start, n, cfg, fields, acc)
    if plan is None:
        plan = rw_plan(*cfg.eff_res, sm_count(dev))
        if plan is None:
            raise ValueError(f"fused_approach_rw: grid {cfg.eff_res} has no run plan on a card "
                             f"of {sm_count(dev)} SMs (runs of <= {RW_CELLS} cells, one an SM)")
    return _rw_launch(h, vel_field, start, n, cfg, fields, acc, dev, plan)


def rw_info(device_index: int = 0):
    """``(registers per thread, local bytes, threads a block, most cells a
    run)`` of `fused_approach_rw`."""
    fn = build.bind("fused_approach_rw", "jrl_fused_approach_rw_info", [_P] * 4)
    out = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device_index):
        build.check(fn(*(ctypes.byref(x) for x in out)), "fused_approach_rw")
    return tuple(x.value for x in out)


def rw_shape(wrows: int, W: int, device_index: int = 0):
    """The kernel's own ``(shared memory bytes of a block of wrows window
    rows, co-resident blocks at that size)``, which `rw_plan` mirrors."""
    fn = build.bind("fused_approach_rw", "jrl_fused_approach_rw_shape",
                    [ctypes.c_int] * 2 + [_P] * 2)
    out = [ctypes.c_int(0) for _ in range(2)]
    with torch.cuda.device(device_index):
        build.check(fn(int(wrows), int(W), *(ctypes.byref(x) for x in out)), "fused_approach_rw")
    return tuple(x.value for x in out)


def exact_div_count(ncols: int, device_index: int = 0, nfirst: int = 4):
    """The card's proof of `csrc/exact_div.cuh`'s RcpDiv: for CS2F, CS4F,
    sqrt(2) and r = x + 0.5 at each column x < ``ncols``, the float32
    numerators (all 2^32 bit patterns) whose RcpDiv quotient differs from
    ``__fdiv_rn``'s in any bit. Returns ``[(divisor, mismatches, reciprocal
    not __frcp_rn's, [first mismatching patterns]), ...]``, the constants
    first."""
    nd = 3 + int(ncols)
    dev = torch.device("cuda", device_index)
    out = torch.zeros(2 * nd, dtype=torch.int64, device=dev)
    first = torch.zeros(nd * nfirst, dtype=torch.int32, device=dev)
    nrec = torch.zeros(nd, dtype=torch.int32, device=dev)
    fn = build.bind("fused_approach_rw", "jrl_exact_div_count",
                    [ctypes.c_int, _P, _P, _P, ctypes.c_int, _P])
    with torch.cuda.device(dev):
        build.check(fn(int(ncols), out.data_ptr(), first.data_ptr(), nrec.data_ptr(),
                       int(nfirst), stream_of(dev)), "fused_approach_rw")
    out, first, nrec = out.cpu().tolist(), first.cpu().view(-1, nfirst), nrec.cpu().tolist()
    d32 = np.float32
    divisors = [d32(1.0 / 3.0), d32((1.0 / 3.0) * (1.0 / 3.0)), d32(1.4142135623730951)]
    divisors += [d32(x) + d32(0.5) for x in range(int(ncols))]
    return [(float(divisors[k]), out[2 * k], bool(out[2 * k + 1]),
             [f"{int(b) & 0xffffffff:#010x}" for b in first[k, :min(nrec[k], nfirst)]])
            for k in range(nd)]


# ---------------------------------------------------------------------------
# Lanes: the approach of many lanes in one launch, one cluster a lane
# ---------------------------------------------------------------------------

# the CApproachParams fields in which lanes may differ (a Pe sweep's lanes
# differ in the tip speed and tau_D, `C_ethaline:96-103`)
LANE_KEYS = ("v", "w_rate", "c_tau")


def lane_segments(cfg, dumps, n: int, start: int = 0):
    """``[(end, row), ...]``: where the serial approach of steps ``start ..
    start + n - 1`` (`jrl_main.run_approach` through
    `make_fused_approach_runner`) ends a launch: after each record step
    ``s`` of ``dumps`` (end ``s + 1``, row its index) and, within an interval
    longer than ``steps_per_launch(cfg, "fused_approach")``, every so many
    steps (row -1). Record steps from ``start + n`` on are dropped."""
    size = steps_per_launch(cfg, "fused_approach")
    out, cur = [], int(start)
    for row, s in enumerate(d for d in dumps if int(d) < int(start) + int(n)):
        while int(s) + 1 - cur > size:
            cur += size
            out.append((cur, -1))
        cur = int(s) + 1
        out.append((cur, row))
    return out


def fused_approach_lanes_ref(h, C, vel_field, start: int, ns, segs, n_rows: int, cfgs, fields):
    """`fused_approach_lanes`' twin: lane ``l`` (config ``cfgs[l]``) runs
    `fused_approach_ref` from ``start`` one segment of ``segs[l]``
    (`lane_segments`) after the other, adding each segment's sums into a
    running sum as the serial runner adds a launch into its ``acc``, then on
    to step ``start + ns[l]``. Returns ``(h [L, 9, H, W], C [L, H, W], rows
    [L, n_rows, 4])``: each record row's inflow and current sums since the
    previous record and the record velocities of its step."""
    rows = torch.zeros((len(cfgs), int(n_rows), 4), dtype=torch.float32, device=h.device)
    hs, Cs = [], []
    for lane, cfg in enumerate(cfgs):
        h_l, C_l, cur = h[lane], C[lane], int(start)
        acc = torch.zeros(4, dtype=torch.float32, device=h.device)
        for end, row in list(segs[lane]) + [(int(start) + int(ns[lane]), -1)]:
            if end > cur:
                h_l, C_l = _approach_ref_acc(h_l, C_l, vel_field, cur, end - cur, cfg, fields, acc)
            cur = end
            if row >= 0:
                rows[lane, row] = acc
                acc = torch.zeros(4, dtype=torch.float32, device=h.device)
        hs.append(h_l)
        Cs.append(C_l)
    return torch.stack(hs), torch.stack(Cs), rows


def _check_lanes(h, C, vel_field, start, ns, segs, n_rows, cfgs, fields) -> torch.device:
    L = len(cfgs)
    if L < 1 or len(ns) != L or len(segs) != L:
        raise ValueError(f"{L} lane configs, {len(ns)} step counts, {len(segs)} segment tables")
    p0 = _approach_params(cfgs[0])
    for cfg in cfgs[1:]:
        p = _approach_params(cfg)
        diff = [k for k, _ in CApproachParams._fields_ if k not in LANE_KEYS
                and getattr(p, k) != getattr(p0, k)]
        if diff or cfg.eff_res != cfgs[0].eff_res:
            raise ValueError(f"lanes differ in {diff or 'the grid'}: only {LANE_KEYS} may")
    if min(int(n) for n in ns) < 1:
        raise ValueError("every lane runs at least one step")
    n_frames = int(vel_field.shape[0])
    dev = check_state(cfgs[0], start, max(int(n) for n in ns), h=(h, (L, 9)), C=(C, (L,)),
                      base_flags=(fields["base_flags"], ()),
                      vel_field=(vel_field, (n_frames, 2)))
    area = fields["area"]
    if n_frames < 1:
        raise ValueError("vel_field holds no frame")
    if tuple(area.shape) != (p0.rint,) or area.dtype != torch.float32 or area.device != dev:
        raise ValueError("area must be a float32 [rint] tensor on the card")
    for lane, table in enumerate(segs):
        ends = [int(start)] + [int(e) for e, _ in table]
        rows = [int(r) for _, r in table if int(r) >= 0]
        if any(b <= a for a, b in zip(ends, ends[1:])) or ends[-1] > int(start) + int(ns[lane]):
            raise ValueError(f"lane {lane}: segment ends {ends[1:]} not increasing within "
                             f"steps {start} .. {int(start) + int(ns[lane])}")
        if any(b <= a for a, b in zip(rows, rows[1:])) or (rows and rows[-1] >= int(n_rows)):
            raise ValueError(f"lane {lane}: record rows {rows} not increasing below {n_rows}")
    H, W = cfgs[0].eff_res
    if fused_route("fused_approach", H, W, card_limits("fused_approach", _index(dev))) != "cluster":
        raise ValueError(f"fused_approach_lanes: grid {H}x{W} does not fit one cluster of the "
                         "card at one cell a thread")
    return dev


def fused_approach_lanes(h, C, vel_field, start: int, ns, segs, n_rows: int, cfgs, fields):
    """The approach of ``L = len(cfgs)`` lanes in one launch of the lanes
    instance of `fused_approach_cl`, one cluster a lane: lane ``l`` runs
    steps ``start .. start + ns[l] - 1`` of config ``cfgs[l]`` (the lanes
    may differ only in the tip speed and tau_D: `LANE_KEYS`) from its own
    ``h[l]``, on the shared ``vel_field``, base flags and area row; ``segs[l]``
    is its `lane_segments` table. Returns ``(h [L, 9, H, W], C [L, H, W],
    rows [L, n_rows, 4])`` as `fused_approach_lanes_ref` does; each lane
    equals the serial `fused_approach_cl` launches bit for bit. ``C`` feeds
    the twin (the kernel reads no C). Raises before launch where the grid
    does not fit one cluster at one cell a thread."""
    if h.device.type == "cpu":
        return fused_approach_lanes_ref(h, C, vel_field, start, ns, segs, n_rows, cfgs, fields)
    dev = _check_lanes(h, C, vel_field, start, ns, segs, n_rows, cfgs, fields)
    L, S = len(cfgs), max(1, max(len(t) for t in segs))
    H, W = cfgs[0].eff_res
    seg_np = np.full((L, S, 2), -1, np.int32)
    for lane, table in enumerate(segs):
        if table:
            seg_np[lane, :len(table)] = table
    params = (CApproachParams * L)(*(_approach_params(c) for c in cfgs))
    p_t = torch.frombuffer(bytearray(params), dtype=torch.uint8).to(dev)
    n_t = torch.tensor([int(n) for n in ns], dtype=torch.int32).to(dev)
    seg_t = torch.from_numpy(seg_np).to(dev)
    rows = torch.zeros((L, int(n_rows), 4), dtype=torch.float32, device=dev)
    h_out = torch.empty_like(h)
    C_out = torch.empty((L, H, W), dtype=torch.float32, device=dev)
    cluster, _, smem = _cluster_shape("fused_approach", cfgs[0], dev)
    fn = build.bind("fused_approach_cl", "jrl_fused_approach_lanes",
                    [_P, _P, ctypes.c_int] + [_P] * 4 + [ctypes.c_int] + [_P] * 3
                    + [ctypes.c_int, _P] + [ctypes.c_int] * 2 + [_P] + [ctypes.c_int] * 2 + [_P])
    with torch.cuda.device(dev):
        err = fn(fields["base_flags"].data_ptr(), vel_field.data_ptr(), int(vel_field.shape[0]),
                 fields["area"].data_ptr(), h.data_ptr(), h_out.data_ptr(), C_out.data_ptr(),
                 int(start), p_t.data_ptr(), n_t.data_ptr(), seg_t.data_ptr(), S,
                 rows.data_ptr(), max(1, int(n_rows)), L, ctypes.byref(params[0]), cluster, smem,
                 stream_of(dev))
    build.check(err, "fused_approach_cl")
    fused_approach_lanes.launches += 1
    return h_out, C_out, rows


def lanes_info(cfg, device_index: int):
    """``(clusters the card holds at once, registers a thread, local bytes)``
    of the lanes instance on the config's grid."""
    cluster, _, smem = _cluster_shape("fused_approach", cfg, torch.device("cuda", device_index))
    fn = build.bind("fused_approach_cl", "jrl_fused_approach_lanes_limits",
                    [ctypes.c_int, ctypes.c_int, _P, _P, _P])
    active, regs, local = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(fn(smem, cluster, ctypes.byref(active), ctypes.byref(regs),
                       ctypes.byref(local)), "fused_approach_cl")
    return active.value, regs.value, local.value


fused_fluid.launches = 0
fused_balance.launches = 0
fused_approach.launches = 0
fused_fluid_cl.launches = 0
fused_balance_cl.launches = 0
fused_fluid_mc.launches = 0
fused_fluid_tl.launches = 0
fused_balance_mc.launches = 0
fused_approach_cl.launches = 0
fused_approach_mc.launches = 0
fused_approach_rw.launches = 0
fused_approach_lanes.launches = 0


# ---------------------------------------------------------------------------
# Runners (the contracts of the JAX package's make_fused_*_runner)
# ---------------------------------------------------------------------------

def _require_fit(cfg) -> None:
    if cfg.shape not in _jrl.FLAT_SHAPES + _jrl.WEDGE_SHAPES:
        raise ValueError(f"unknown tip shape {cfg.shape}")
    if not fits(cfg):
        raise ValueError(f"grid {cfg.eff_res} exceeds the multi-step kernels' "
                         f"{MAX_FUSED_CELLS} cells")


def _chunks(n: int, cfg, name: str):
    left, size = int(n), steps_per_launch(cfg, name)
    while left > 0:
        m = min(left, size)
        yield m
        left -= m


def make_fused_fluid_runner(cfg):
    """``(state, fields, start_step, n) -> state`` through `fused_fluid`,
    one launch per ``steps_per_launch(cfg, "fused_fluid")`` steps. On the
    tile route (`fused_fluid_tl`) the state is checked once a run and the
    launches go out unchecked."""
    _require_fit(cfg)

    def run(state, fields, start_step: int, n: int):
        f, rho, vel = state["f"], state["rho"], state["vel"]
        s = int(start_step)
        tiles = None
        if f.device.type == "cuda" and int(n) > 0 \
                and _route("fused_fluid", cfg, f.device, None) == "tiles":
            dev = _check_tl(cfg, s, n, f, rho, vel)
            tiles = (dev, tl_plan(*cfg.eff_res, sm_count(dev)))
        for m in _chunks(n, cfg, "fused_fluid"):
            if tiles:
                f, rho, vel = _tl_launch(f, rho, vel, s, m, cfg, *tiles)
            else:
                f, rho, vel = fused_fluid(f, rho, vel, s, m, cfg, fields)
            s += m
        return {"f": f, "rho": rho, "vel": vel}

    return run


def make_fused_balance_runner(cfg, flags):
    """``(state, fields, n) -> state`` through `fused_balance` on the fixed
    balance ``flags``."""
    _require_fit(cfg)

    def run(state, fields, n: int):
        h, C = state["h"], state["C"]
        for m in _chunks(n, cfg, "fused_balance"):
            h, C = fused_balance(h, C, flags, m, cfg, fields)
        return {"C": C, "h": h}

    return run


def make_fused_approach_runner(cfg, vel_field):
    """``(state, fields, start_step, n) -> (state, acc)`` through
    `fused_approach` (`fused_route`'s kernel), with the stored velocity
    history ``vel_field`` ``[N, 2, H, W]`` bound here; ``acc`` as
    `models.jrl.make_approach_runner` returns it (sums over the n steps,
    record velocities of the last). On the row route (`fused_approach_rw`)
    the state, frames, area and acc are checked once a run and the launches
    go out unchecked."""
    _require_fit(cfg)
    frames = torch.as_tensor(vel_field, dtype=torch.float32).contiguous()

    def run(state, fields, start_step: int, n: int):
        h, C = state["h"], state["C"]
        acc = torch.zeros(4, dtype=torch.float32, device=h.device)
        s = int(start_step)
        rows = None
        if h.device.type == "cuda" and int(n) > 0 \
                and _route("fused_approach", cfg, h.device, None) == "rows":
            dev = _check_rw(h, C, frames, s, n, cfg, fields, acc)
            rows = (dev, rw_plan(*cfg.eff_res, sm_count(dev)))
        for m in _chunks(n, cfg, "fused_approach"):
            if rows:
                h, C = _rw_launch(h, frames, s, m, cfg, fields, acc, *rows)
            else:
                h, C = fused_approach(h, C, frames, s, m, cfg, fields, acc)
            s += m
        acc_d = {
            "inflow_sum": acc[0],
            "current_sum": acc[1],
            "count": torch.tensor(float(n), dtype=torch.float32),
            "rec_u": acc[2],
            "rec_v": acc[3],
        }
        return {"C": C, "h": h}, acc_d

    return run
