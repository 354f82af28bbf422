"""The cylinder demo CLI of the port (`cylinder_main.py`) on the CPU,
where it runs the plain `models/cylinder.py::make_runner`: the goldens'
configuration (400x200, D 10) to step 1000, frame 1001 within a mean
|pixel difference| of 1.0 of the committed golden (the gate of
`tests/test_goldens.py:84`; frame 2001 is checked on the card by
`chip_smoke.py`); a tiny run whose final Tecplot zone is byte for byte
what the JAX package's `dump_2d_plt_file_single` writes from the same
final state; and ``--device cuda`` raising where there is no card.

The tiny run (80x40, D 2) stops at step 300: the demo's fixed Re 5000
gives tau 0.5024 there, and both packages' states turn non-finite between
steps 300 and 350.

About 80-95 s on one worker (one torch thread): the golden run 76-91 s,
the tiny run ~2 s.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from jrl_lbm_tpu.utils import grid as jgrid
from jrl_lbm_tpu.utils import io as jio
from jrl_lbm_torch import cylinder_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "validation", "goldens", "2d_LBM_cylinder")


def test_golden_configuration_frame_1001(tmp_path):
    from PIL import Image

    with open(os.path.join(GOLD, "signatures.json")) as fo:
        args = json.load(fo)["args"]
    assert args == ["--res", "400", "200", "--total_steps", "2000", "--D", "10"]
    args[args.index("--total_steps") + 1] = "1000"
    state, files = cylinder_main.main(args + ["--out", str(tmp_path), "--device", "cpu",
                                              "--no-video"])
    frame_dir = tmp_path / "demo_data_LBM_cylinder_2d"
    assert files == [str(frame_dir / "1001.png"), str(frame_dir / "1001.plt")]
    assert all(torch.isfinite(v).all() for v in state.values())
    a = np.asarray(Image.open(os.path.join(GOLD, "1001.png")), np.float64)
    b = np.asarray(Image.open(frame_dir / "1001.png"), np.float64)
    assert a.shape == b.shape == (400, 200)
    assert np.abs(a - b).mean() < 1.0


def test_tiny_run_tecplot_zone_equals_jax_writer(tmp_path):
    state, files = cylinder_main.main(["--res", "80", "40", "--D", "2", "--total_steps", "300",
                                       "--out", str(tmp_path), "--device", "cpu", "--no-video"])
    assert [os.path.basename(f) for f in files] == ["301.png", "301.plt"]
    assert all(torch.isfinite(v).all() for v in state.values())
    vel = jnp.asarray(state["vel"].numpy())
    u, v = jgrid.get_staggered(vel)
    want = str(tmp_path / "jax.plt")
    jio.dump_2d_plt_file_single(want, state["rho"].numpy(), np.asarray(u), np.asarray(v))
    with open(files[-1], "rb") as fo, open(want, "rb") as fw:
        got, ref = fo.read(), fw.read()
    assert len(got.splitlines()) == 80 * 40 + 4
    assert got == ref


def test_cuda_device_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cylinder_main.main(["--res", "80", "40", "--D", "2", "--total_steps", "4",
                            "--out", str(tmp_path), "--device", "cuda", "--no-video"])
    assert not os.listdir(tmp_path)
