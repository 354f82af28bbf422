"""The fluid's tile kernel's twin (`kernels/fused_jrl.py::fused_fluid_tl_ref`)
over a long launch on the CPU, the longest case of `test_torch_fused_tiles.py`
kept apart so that the suite's workers take the two files side by side:
100 steps of the wedge at 128x64 across tip rows, played tile by tile on a
plan whose first and last bands' windows wrap past the grid's rows and
whose outer strips meet both walls, bit for bit `fused_fluid_ref`. Inputs
and helpers are `test_torch_fused_tiles.py`'s.
"""

import torch_threads  # noqa: F401  (this worker's share of the cores)
from test_torch_fused_tiles import _case, _equal, _plan

from jrl_lbm_torch.kernels import fused_jrl as F
from jrl_lbm_torch.models import jrl as T


def test_tiles_over_100_steps_equal_the_whole_grid_twin():
    """128x64, the wedge, 100 steps across tip rows, tiles of about 13 x 20
    (10 bands x 4 strips: the first and last bands' windows wrap past the
    grid's rows, the outer strips meet both walls): bit for bit
    `fused_fluid_ref`, finite."""
    _, tc, _, s, fl = _case("45degree", (128, 64))
    plan = _plan((128, 64), 13, 20)
    assert plan.nty[0] > 2 and plan.ntx > 2
    rows = [T.tip_walks(tc.inflow_height, k, tc.vel_obs)[1] for k in (0, 99)]
    assert rows[1] > rows[0]
    x = (s["f"], s["rho"], s["vel"])
    _equal(F.fused_fluid_tl_ref(*x, 0, 100, tc, fl, plan),
           F.fused_fluid_ref(*x, 0, 100, tc, fl), "128x64 100 steps")
