"""The cluster route of the multi-step JRL kernels (`kernels/fused_jrl.py`,
`csrc/fused_fluid_cl.cu`, `csrc/fused_balance_cl.cu`) on the CPU: the
route choice and the row-band split as arithmetic on an H100's limits, the
premise of the kernels' one-row halo (every band's rows computed from the
band and one row a side, the rest of the grid NaN, equal the whole-grid
step bit for bit), and the cluster wrappers, which run their twins here,
against the JAX package's Pallas runners in TPU interpret mode. The
kernels themselves, against the cooperative ones and the twins, are in
`test_torch_cuda.py`.

Inputs come from numpy with a seed; JAX states enter the port through
`models/jrl.py::state_from_numpy`. Tolerances are those of
`tests/test_fused_jrl.py`: f and rho 2e-5, vel 2e-4, h and C 1e-5.
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

# an H100 SXM: 232,448 bytes of shared memory a block may opt in to, less
# the kernels' 16 bytes of static shared memory (two mbarriers), and
# clusters of 16 blocks
H100 = F.ClusterLimits(smem_optin=232_432, cluster=16)
# and the multi-cluster kernels' limits there: 7 clusters of 16 blocks at
# once, 15 of 8, 30 of 4, 66 of 2, 132 of 1 (one block an SM)
H100_MC = H100._replace(active=(7, 15, 30, 66, 132))


# --- the route and the bands: arithmetic on the card's limits ---

@pytest.mark.parametrize("res,refine,shape,route", [
    ((48, 32), 1, "cylinder", ("cluster", "cluster", "cluster")),
    ((128, 64), 1, "ethaline", ("cluster", "cluster", "cluster")),     # the default grid
    ((128, 64), 2, "ethaline", ("tiles", "clusters", "rows")),         # 256x128: 7 x 16
    ((128, 64), 4, "ethaline", ("tiles", "clusters", "rows")),         # 512x256: 66 x 2, two cells
    ((512, 256), 1, "45degree", ("tiles", "clusters", "rows")),
    ((512, 257), 1, "cylinder", ("coop", "clusters", "coop")),         # four cells a thread
    ((128, 64), 8, "ethaline", ("coop", "coop", "coop")),
])
def test_fused_route_by_grid_on_h100(res, refine, shape, route):
    """The grids of `test_torch_fused.py::test_fits_agrees_with_fits_vmem`
    and 256x128, as ``(fluid, balance, approach)``: the cluster route where
    the state fits one cluster at one cell per thread; the multi-cluster
    kernels where the clusters the card holds at once take the grid at
    most ``MC_MAX_CPT`` cells a thread (the fluid and the approach one, the
    balance four), but the fluid's tile kernel from ``TILES_MIN_CELLS``
    cells and the approach's row kernel from ``ROWS_MIN_CELLS`` (256x128
    both) up to the multi-step limit, rows of 16 bytes' multiples; the
    cooperative kernel elsewhere."""
    H, W = T.JRLFluidConfig(res=res, refine=refine, shape=shape).eff_res
    for name, want in zip(("fused_fluid", "fused_balance", "fused_approach"), route):
        assert F.fused_route(name, H, W, H100_MC) == want, (name, H, W)


@pytest.mark.parametrize("name,planes", [("fused_fluid", 23), ("fused_balance", 19)])
def test_cluster_shape_arithmetic(name, planes):
    """Blocks, cells per thread and shared memory a block: 128x64 is 16
    bands of 8 rows at one cell a thread; 256x128 fits at 4 cells a thread
    (2048 cells a block) and 512x256 does not; a card that holds no
    cluster of 16 takes 8 blocks at 2 cells a thread, which the route
    leaves to the cooperative kernel, and one with no cluster none."""
    assert F.CLUSTER_PLANES[name] == planes
    assert F.cluster_shape(name, 128, 64, H100) == (16, 1, planes * (8 + 2) * 64 * 4)
    assert F.cluster_shape(name, 256, 128, H100) == (16, 4, planes * (16 + 2) * 128 * 4)
    assert F.cluster_shape(name, 512, 256, H100) is None
    eight = H100._replace(cluster=8)
    assert F.cluster_shape(name, 128, 64, eight) == (8, 2, planes * (16 + 2) * 64 * 4)
    assert F.fused_route(name, 128, 64, eight) == "coop"
    assert F.cluster_shape(name, 128, 64, H100._replace(cluster=0)) is None
    # the shared memory decides: one byte under the 128x64 window refuses it
    tight = H100._replace(smem_optin=planes * 10 * 64 * 4 - 1)
    assert F.cluster_shape(name, 128, 64, tight) is None


@pytest.mark.parametrize("H,C", [(128, 16), (100, 16), (48, 16), (40, 16), (33, 16),
                                 (128, 8), (61, 8)])
def test_row_bands_cover_the_grid(H, C):
    """Bands of ``r H // C`` rows (H % C need not be 0) tile the rows in
    order, differ by at most one row, and a grid whose smallest band has
    fewer than two rows is refused."""
    bands = F.row_bands(H, C)
    assert len(bands) == C and bands[0][0] == 0 and bands[-1][1] == H
    assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
    rows = [y1 - y0 for y0, y1 in bands]
    assert max(rows) - min(rows) <= 1 and max(rows) == -(-H // C)
    fits = F.cluster_shape("fused_fluid", H, 64, H100._replace(cluster=C)) is not None
    assert fits == (min(rows) >= F.CLUSTER_MIN_ROWS)


# --- the one-row halo: each band from its rows and one row a side ---

def _poison(t, keep):
    """``t`` with every row outside ``keep`` (row indices) set to NaN."""
    out = torch.full_like(t, float("nan"))
    out[..., keep, :] = t[..., keep, :]
    return out


def _window(y0, y1, H, halo):
    return [y % H for y in range(y0 - halo, y1 + halo)]


def _bands_equal(got, want, y0, y1, tag):
    g, w = got[..., y0:y1, :], want[..., y0:y1, :]
    assert torch.isfinite(g).all(), f"{tag}: NaN reached rows {y0}..{y1 - 1}"
    torch.testing.assert_close(g, w, rtol=0, atol=0, msg=tag)


@pytest.mark.parametrize("shape", ["cylinder", "45degree"])
@pytest.mark.parametrize("H,C", [(48, 16), (44, 16)])
def test_fluid_band_needs_one_halo_row(shape, H, C):
    """Step A of a band from its f and vel with one row a side and its own
    rho, and step B from its f and the new rho and vel with one row a side
    (the two exchanges of fused_fluid_cl.cu), equal the whole-grid steps,
    with bands of 3 rows (48) and of 2 or 3 (44: row 0's OUTFLOW copy
    reads two rows in), over steps in which the tip crosses a row."""
    cfg = T.JRLFluidConfig(res=(H, 32), Re=4.0, vel_obs_real=0.2848,
                           gravity_strength_real=-9.8, shape=shape)
    s, fields = T.fluid_init(cfg, "cpu")
    rng = np.random.default_rng(9)
    s = {k: v + torch.as_tensor((1e-3 * rng.standard_normal(tuple(v.shape))).astype(np.float32))
         for k, v in s.items()}
    s = T.make_fluid_runner(cfg)(s, fields, 0, 4)
    n = int(1.5 / cfg.vel_obs)
    assert T.tip_walks(cfg.inflow_height, 4 + n, cfg.vel_obs)[1] > T.tip_walks(
        cfg.inflow_height, 4, cfg.vel_obs)[1]
    for k in range(4, 4 + n, 3):
        a = jrl_fluid.fluid_a_ref(s["f"], s["rho"], s["vel"], k, cfg, fields)
        b = jrl_fluid.fluid_b_ref(*a, k, cfg, fields)
        for y0, y1 in F.row_bands(H, C):
            own, win = list(range(y0, y1)), _window(y0, y1, H, 1)
            ab = jrl_fluid.fluid_a_ref(_poison(s["f"], win), _poison(s["rho"], own),
                                       _poison(s["vel"], win), k, cfg, fields)
            for name, g, w in zip(("f", "rho", "vel"), ab, a):
                _bands_equal(g, w, y0, y1, f"A step {k} rows {y0}..{y1 - 1} {name}")
            bb = jrl_fluid.fluid_b_ref(_poison(a[0], own), _poison(a[1], win),
                                       _poison(a[2], win), k, cfg, fields)
            _bands_equal(bb, b, y0, y1, f"B step {k} rows {y0}..{y1 - 1} f")
        s = {"f": b, "rho": a[1], "vel": a[2]}


@pytest.mark.parametrize("shape,is_negative", [("ethaline", True), ("ethaline", False),
                                               ("cylinder", True)])
@pytest.mark.parametrize("H,C", [(48, 16), (44, 16)])
def test_balance_band_needs_one_halo_row(shape, is_negative, H, C):
    """A balance step of a band from its h with one row a side and its own
    C (fused_balance_cl.cu) equals the whole-grid step: the OUTFLOW
    copies of rows 0 and H - 1 read two rows inward, inside the band."""
    cfg = T.JRLCConfig(res=(H, 32), Re=4.0, Pe=5.0, vel_obs_real=0.2848, shape=shape,
                       is_negative=is_negative)
    st, fields, flags = T.c_init(cfg, "cpu")
    rng = np.random.default_rng(10)
    st = {k: v + torch.as_tensor((1e-3 * rng.standard_normal(tuple(v.shape))).astype(np.float32))
          for k, v in st.items()}
    for _ in range(3):
        want = jrl_c.c_balance_ref(st["h"], st["C"], flags, cfg, fields)
        for y0, y1 in F.row_bands(H, C):
            got = jrl_c.c_balance_ref(_poison(st["h"], _window(y0, y1, H, 1)),
                                      _poison(st["C"], list(range(y0, y1))), flags, cfg, fields)
            for name, g, w in zip(("h", "C"), got, want):
                _bands_equal(g, w, y0, y1, f"balance rows {y0}..{y1 - 1} {name}")
        st = dict(zip(("h", "C"), want))


# --- the cluster wrappers on the CPU: their twins, against JAX ---

def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


def test_fused_fluid_cl_on_cpu_matches_pallas():
    kw = dict(res=(48, 32), Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8,
              shape="45degree")
    jc, tc = J.JRLFluidConfig(**kw), T.JRLFluidConfig(**kw)
    js, jf = J.fluid_init(jc)
    with _interpret():
        out = jax.tree.map(np.asarray,
                           JF.make_fused_fluid_runner(jc)(js, jf, jnp.asarray(0, jnp.int32), 9))
    _, tf = T.fluid_init(tc, "cpu")
    s = T.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    got = F.fused_fluid_cl(s["f"], s["rho"], s["vel"], 0, 9, tc, tf)
    twin = F.fused_fluid_ref(s["f"], s["rho"], s["vel"], 0, 9, tc, tf)
    for key, g, t, tol in zip(("f", "rho", "vel"), got, twin, (2e-5, 2e-5, 2e-4)):
        torch.testing.assert_close(g, t, rtol=0, atol=0)
        np.testing.assert_allclose(g.numpy(), out[key], rtol=tol, atol=tol, err_msg=key)


@pytest.mark.parametrize("is_negative", [True, False])
def test_fused_balance_cl_on_cpu_matches_pallas(is_negative):
    kw = dict(res=(48, 32), Re=4.0, Pe=5.0, vel_obs_real=0.2848, shape="ethaline",
              is_negative=is_negative)
    jc, tc = J.JRLCConfig(**kw), T.JRLCConfig(**kw)
    js, jf, jflags = J.c_init(jc)
    with _interpret():
        out = jax.tree.map(np.asarray, JF.make_fused_balance_runner(jc, jflags)(js, jf, 9))
    _, tf, tflags = T.c_init(tc, "cpu")
    s = T.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    got = F.fused_balance_cl(s["h"], s["C"], tflags, 9, tc, tf)
    twin = F.fused_balance_ref(s["h"], s["C"], tflags, 9, tc, tf)
    for key, g, t in zip(("h", "C"), got, twin):
        torch.testing.assert_close(g, t, rtol=0, atol=0)
        np.testing.assert_allclose(g.numpy(), out[key], rtol=1e-5, atol=1e-5, err_msg=key)
