"""The fluid's tile kernel of the multi-step module (`kernels/fused_jrl.py::
fused_fluid_tl`, `csrc/fused_fluid_tl.cu`) on the CPU, where the wrapper
runs its plain twin `fused_fluid_tl_ref`: the launch played tile by tile
(each step one wave of tiles over the whole grid, rows wrapping; each
tile from its own window, NaN beyond it) against `fused_fluid_ref` bit
for bit over tile plans, tips, a tip-row crossing and step 2**24; against
the JAX package's jnp step and its ``_make_jrl_fluid_kernel`` in TPU
interpret mode; the route's choice by grid on an H100's limits; the
host plan's coverage and shared memory. The 100-step case is
`test_torch_fused_tiles_long.py`; the kernel against the cooperative
``fused_fluid``, on a card, is in `test_torch_cuda.py`.

Inputs come from the JAX init plus seeded numpy noise. Tolerances: the jnp
step f and rho 1e-5, vel 2e-4 over 12 steps (ROADMAP); the interpreted
Pallas kernel as `tests/test_torch_fused.py` holds the cooperative twin
(f, rho 2e-5, vel 2e-4: its bodies fold divides into reciprocals); the
twins against each other bit for bit (they share the arithmetic of the
port's whole-grid step).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)
from hypothesis import given, settings
from hypothesis import strategies as st

from jrl_lbm_tpu.models import jrl as J
from jrl_lbm_tpu.ops.pallas import fused_jrl as JF
from jrl_lbm_torch.kernels import fused_jrl as F
from jrl_lbm_torch.kernels import jrl_sharded as S
from jrl_lbm_torch.models import jrl as T

RES = (48, 32)
# an H100 SXM's limits as `tests/test_torch_fused_clusters.py` states them
H100 = F.ClusterLimits(smem_optin=232_432, cluster=16, active=(7, 15, 30, 66, 132))


def _kw(shape, res=RES, **kw):
    return dict(dict(res=res, Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8,
                     shape=shape), **kw)


@functools.lru_cache(maxsize=None)
def _case(shape, res=RES, seed=21, **kw):
    """``(jax cfg, torch cfg, numpy state, torch state, torch fields)``: the
    JAX init plus seeded noise."""
    jc, tc = J.JRLFluidConfig(**_kw(shape, res, **kw)), T.JRLFluidConfig(**_kw(shape, res, **kw))
    state, _ = J.fluid_init(jc)
    rng = np.random.default_rng(seed)
    state = {k: (np.asarray(v) + 1e-4 * rng.standard_normal(np.shape(v))).astype(np.float32)
             for k, v in state.items()}
    return jc, tc, state, T.state_from_numpy(state, "cpu"), T.fluid_init(tc, "cpu")[1]


def _plan(res, R, S_):
    return S.tile_plan(S.Shard.of(*res, (1, 1), (0, 0)), 1, R, S_)


def _equal(got, want, tag):
    for name, g, w in zip(("f", "rho", "vel"), got, want):
        assert torch.isfinite(g).all(), f"{tag} {name}: NaN reached"
        assert torch.equal(g, w), f"{tag} {name}"


def _crossing(tc, n):
    """A first step from which ``n`` steps cross a tip row."""
    _, row = T.tip_walks(tc.inflow_height, 0, tc.vel_obs)
    nxt = int(np.ceil((row + 0.5 - tc.inflow_height) / tc.vel_obs))
    return max(0, nxt - n // 2)


# --- the twin, played tile by tile, against the whole-grid twin ---

@settings(max_examples=12, deadline=None)
@given(R=st.integers(1, 43), S_=st.integers(4, 32), shape=st.sampled_from(
    ["45degree", "cylinder", "ethaline"]), when=st.sampled_from(["crossing", "2**24"]))
def test_tiles_equal_the_whole_grid_twin_on_any_plan(R, S_, shape, when):
    """Any plan of bands and strips the kernel takes at 48x32 (a tile's
    window of R + 5 rows inside the grid), wedge and flat tips, 4 steps
    across a tip row or across step 2**24 (Re small enough that the tip is
    inside the grid there): bit for bit `fused_fluid_ref`, finite."""
    plan = _plan(RES, R, S_)
    if when == "crossing":
        _, tc, _, s, fl = _case(shape)
        start = _crossing(tc, 4)
        rows = [T.tip_walks(tc.inflow_height, k, tc.vel_obs)[1] for k in (start, start + 3)]
        assert rows[1] > rows[0]
    else:
        _, tc, _, s, fl = _case(shape, Re=1.2e-5)
        start = 2**24 - 2
        assert 1 < T.tip_walks(tc.inflow_height, start + 3, tc.vel_obs)[1] < RES[0] - 1
    x = (s["f"], s["rho"], s["vel"])
    _equal(F.fused_fluid_tl_ref(*x, start, 4, tc, fl, plan),
           F.fused_fluid_ref(*x, start, 4, tc, fl), f"{shape} {plan} from {start}")


def test_wrapper_on_the_cpu_runs_the_twin():
    """`fused_fluid_tl` given CPU tensors runs its twin on `tl_plan`'s tiles
    (counting no launch), as `fused_fluid` runs its own."""
    _, tc, _, s, fl = _case("cylinder")
    x = (s["f"], s["rho"], s["vel"])
    n0 = F.fused_fluid_tl.launches
    _equal(F.fused_fluid_tl(*x, 5, 6, tc, fl),
           F.fused_fluid_tl_ref(*x, 5, 6, tc, fl, F.tl_plan(*RES)), "wrapper")
    _equal(F.fused_fluid_tl(*x, 5, 6, tc, fl), F.fused_fluid(*x, 5, 6, tc, fl, route="tiles"),
           "route tiles")
    assert F.fused_fluid_tl.launches == n0


# --- against the JAX package ---

@pytest.mark.parametrize("shape", ["45degree", "cylinder"])
def test_tiles_match_the_jnp_step(shape):
    """12 steps at 48x32 from a noisy state on tiles of about 9 x 12: the
    JAX package's jnp step within f, rho 1e-5 and vel 2e-4."""
    jc, tc, state, s, fl = _case(shape)
    _, jf = J.fluid_init(jc)
    step = jax.jit(J.make_fluid_step(jc))
    js = {k: jnp.asarray(v) for k, v in state.items()}
    for i in range(12):
        js = step(js, jf, jnp.asarray(i, jnp.int32))
    got = F.fused_fluid_tl_ref(s["f"], s["rho"], s["vel"], 0, 12, tc, fl, _plan(RES, 9, 12))
    for name, g, tol in zip(("f", "rho", "vel"), got, (1e-5, 1e-5, 2e-4)):
        np.testing.assert_allclose(g.numpy(), np.asarray(js[name]), rtol=tol, atol=tol,
                                   err_msg=f"{shape} {name}")


def test_tiles_match_the_interpreted_pallas_kernel():
    """The JAX package's whole-domain runner (``_make_jrl_fluid_kernel``) in
    TPU interpret mode, 12 steps of the wedge at 48x32, against the twin on
    tiles of about 7 x 8: f, rho 2e-5, vel 2e-4."""
    from jax.experimental.pallas import tpu as pltpu

    jc, tc, state, s, fl = _case("45degree")
    _, jf = J.fluid_init(jc)
    with pltpu.force_tpu_interpret_mode():
        out = JF.make_fused_fluid_runner(jc)({k: jnp.asarray(v) for k, v in state.items()}, jf,
                                             jnp.asarray(0, jnp.int32), 12)
        out = jax.tree.map(np.asarray, out)
    got = F.fused_fluid_tl_ref(s["f"], s["rho"], s["vel"], 0, 12, tc, fl, _plan(RES, 7, 8))
    for name, g, tol in zip(("f", "rho", "vel"), got, (2e-5, 2e-5, 2e-4)):
        np.testing.assert_allclose(g.numpy(), out[name], rtol=tol, atol=tol, err_msg=name)


# --- the route and the plan ---

@pytest.mark.parametrize("res,route", [
    ((128, 64), "cluster"),    # the default grid: one cluster, one cell a thread
    ((256, 128), "tiles"),     # refine 2: TILES_MIN_CELLS
    ((512, 256), "tiles"),     # refine 4
    ((1024, 512), "coop"),     # over MAX_FUSED_CELLS: no multi-step runner takes it
])
def test_fluid_route_by_grid_on_h100(res, route):
    """The fluid's route on an H100's limits: the tile kernel from
    ``TILES_MIN_CELLS`` cells up to ``MAX_FUSED_CELLS``, for the fluid
    only; the other phases keep theirs."""
    assert F.TILES_MIN_CELLS == {"fused_fluid": 256 * 128}
    assert F.fused_route("fused_fluid", *res, H100) == route
    assert F.fused_route("fused_balance", *res, H100) != "tiles"
    assert F.fused_route("fused_approach", *res, H100) != "tiles"
    assert F.tiles_take("fused_fluid", *res) == (route == "tiles")


def test_tiles_need_16_byte_rows_and_are_the_fluids_only():
    """Rows of a width that is not a multiple of 4 keep the grid off the
    tiles (the kernel's bulk copies); no phase but the fluid takes them,
    nor may a caller force them on one."""
    assert F.fused_route("fused_fluid", 256, 128, H100) == "tiles"
    assert F.fused_route("fused_fluid", 264, 126, H100) != "tiles"
    assert F.tiles_take("fused_fluid", 256, 128) and not F.tiles_take("fused_fluid", 264, 126)
    assert "tiles" in F.PHASE_ROUTES["fused_fluid"]
    assert all("tiles" not in F.PHASE_ROUTES[n] for n in ("fused_balance", "fused_approach"))
    cc = T.JRLCConfig(res=RES)
    with pytest.raises(ValueError, match="route 'tiles'"):
        F._route("fused_balance", cc, torch.device("cpu"), "tiles")


@pytest.mark.parametrize("res", [(128, 64), (256, 128), (512, 256), (1024, 512)])
def test_plan_covers_every_cell_once(res):
    """`tl_plan` for an H100 (132 SMs), one SM, and forced tiles: every cell
    of a step in exactly one tile, each tile within the plan's largest
    (``rmax`` x ``smax``, 16-byte window columns, its window of rmax + 5
    rows inside the grid), its tables within the shared memory a block
    may take, the grid within the SMs; at 512x256 one wave of tiles."""
    H, W = res
    plans = [F.tl_plan(H, W), F.tl_plan(H, W, 1), _plan(res, 13, 20), _plan(res, 40, 12)]
    for plan in plans:
        assert len(plan.nty) == 1 and 1 <= plan.grid <= 132
        assert plan.smax % 4 == 0 and plan.rmax + 5 <= H
        assert S.tile_smem_bytes(plan.rmax, plan.smax) <= S.TILE_SMEM_CAP
        cover = np.zeros((H, W), np.int32)
        for e0, e1, sx0, sx1, cx0, cx1 in plan.tiles(0, H, W):
            assert 0 <= e0 < e1 <= H and e1 - e0 <= plan.rmax and sx1 - sx0 <= plan.smax
            assert cx0 % 4 == 0 and cx1 % 4 == 0 and cx0 <= max(sx0 - 2, 0)
            assert cx1 >= min(sx1 + 2, W) and cx1 - cx0 <= plan.smax + 8
            cover[e0:e1, sx0:sx1] += 1
        assert (cover == 1).all(), f"{res} {plan}"
    if res == (512, 256):
        assert plans[0].nty[0] * plans[0].ntx <= 132 and plans[0].grid == \
            plans[0].nty[0] * plans[0].ntx
