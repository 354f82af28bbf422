#!/usr/bin/env python3
"""Drive the PyTorch port's JRL, cylinder-channel and shear-layer main
paths on one NVIDIA card and check them.

    python3 chip_smoke.py

1. Builds the thirty-eight CUDA libraries of ``jrl_lbm_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together) and checks that the
   multi-step JRL kernels' machine code has no read-only (non-coherent)
   global load, which could serve state written earlier in the launch
   (the cylinder kernels read only the previous step's buffers), and that
   ``fluid_pass``, ``fused_fluid_tl`` and ``fused_approach_rw`` spill
   nothing (``-Xptxas -v``), the tile kernel's launch shape the host plan's
   at 256x128 and 512x256, the row kernel's shared memory the host plan's
   at 512x256; prints
   ``c_approach_pass``'s and ``cyl_pass``'s registers and local bytes, the cluster kernels'
   limits on this card and the route choice at 128x64: the cluster shape,
   cells per thread, shared memory and registers per block; the
   multi-cluster kernels' plan at 256x128 and 512x256 (clusters, their
   size, cells a thread, shared memory, registers); ``fused_approach_mc``
   must spill nothing at the cells a thread of its plans.
0. The cylinder channel (``cylinder_phases``): each of its five kernels
   against its plain twin after one step (1e-5) on a split geometry
   (256x128) and a generic one (64x32), ``cyl_pass`` (the k-step pass in
   one launch) also bit for bit against the three launches it replaces
   (``cyl_interior_k``, ``cyl_band_k`` "cyl" and "edge") at k = 2, 4, and
   the kernel runner against the twin runner over 40, 41 and 43 steps (f,
   rho 2e-5; vel 2e-4); then the main path, ``make_fused_cylinder_runner``
   at ``bench.py``'s ``CylinderConfig(res=(2048, 2048), D=64, Re=5000)``:
   23 steps (``cyl_pass`` at k=4 and k=2, and the k=1 pair, all run)
   against the twin runner (all cells), the three-launch runner
   (``route="launches"``, bit for bit) and the jnp-equivalent
   ``models/cylinder.py::make_runner`` (non-OBSTACLE cells), 20 warm-up
   steps, three timed 600-step windows (``cyl_pass`` must carry each), a
   profiled window (busy share, device µs per launch), the same protocol
   through the three launches a pass as the yardstick, the k=2 and
   single-step paths, ``drag_lift`` of the final state, ``cyl_pass``
   against ``cyl_pass_ref`` at 2048² (its blocks' class twins on their
   windows), and each kernel alone beside its bound and twin. Counts are
   zeroed just before each main-path drive and read just after.
0e. The cylinder demo (``cylinder_demo_phases``):
   ``cylinder_main.run_cylinder`` at the goldens' configuration
   (``validation/goldens/2d_LBM_cylinder/signatures.json``: 400x200, D 10,
   2000 steps), frames 1001 and 2001 formed as ``save_img`` forms them
   (``utils/io.py::frame_pixels``) within a mean |pixel difference| of 1.0
   of the committed PNGs (read by ``utils/io.py::read_png_gray``), each
   pixel SHA printed beside the golden's (JAX on the CPU; not gated); the
   default configuration's first ``DEMO_CHECK_STEPS`` steps (800x400, D
   20; about a quarter of its first dump interval) against the plain
   ``models/cylinder.py::make_runner`` on the card
   (non-OBSTACLE cells; f, rho 2e-5, vel 2e-4); the demo's default run
   (50,000 steps) timed, its final state finite, ``drag_lift`` printed;
   counts zeroed just before each drive and read just after: every pass
   one float32 ``cyl_pass`` launch and nothing else; the final Tecplot
   zone through the native writer (``g++`` at first use:
   ``utils/native_io.py``), ``H*W + 4`` lines, finite values, RHO read
   back exactly, the same bytes as the Python writer; ``cyl_pass`` at
   800x400 (its own 260 blocks and row split) from the default run's
   final state against the three launches (bit for bit) and
   ``cyl_pass_ref`` (1e-5), and alone beside its bound and twin.
0b. The cylinder channel in bf16 deviation storage (``storage_phases``),
   round to nearest and stochastic rounding: (a) each kernel's instance
   against its twin after one launch (k = 1, 2, 4 on 256x128, cyl_full
   on 64x32; ``cyl_pass`` at k = 2, 4 also against the three launches)
   and the bf16 runner against the twin runner of the same
   seed over 40, 41 and 43 steps, bit for bit (stored patterns, rho,
   vel); (b) ``bench.py``'s 2048² scene in each mode: 23 steps against
   the twin runner and the three-launch runner (bit for bit), best of
   three 600-step windows after 20 warm-up steps (``cyl_pass`` must carry
   each) and the same through the three launches, profiled windows
   (busy share, device µs per launch), ``cyl_pass`` against
   ``cyl_pass_ref``, each instance alone beside its
   bound (f planes 2 bytes a cell) and twin; (c) the shedding gate
   through ``shedding.run_case``: ``mini`` (22,000 steps) within
   ``tests/test_shedding.py``'s bands of its anchor, ``lowblock``
   (float32, 1600x800, 200,000 steps) within St +-0.012, Cd +-4%,
   Cl_rms +-10% of JAX's committed run, ``b025_bf16sr`` within the same
   bands of the port's float32 run, ``b025_bf16`` printed beside JAX's
   committed run (no gate); a missed gate fails the script after all
   four ran; ``lowblock`` and ``b025_bf16sr`` cut to their first
   ``SHED_YARD_WARMUP`` + 50 ``SHED_YARD_SAMPLES`` steps through the three
   launches a pass and through ``cyl_pass``, the sampled Cl, Cd and probe
   series bit for bit. Each mode's launch
   counts are zeroed before each drive and run and read after; no other
   mode or kernel may launch.
0a. The shear layer (``shear_phases``): each of the seven instances of
   ``periodic`` (BGK, MRT, KBC in five types) against its twin after one
   launch at 130² and 2048² (1e-6), the kernel runner against the twin
   runner (130²: MRT and KBC_A 1000 steps, BGK and LBGK 400, the BGK demo
   turning chaotic past step 500; 2048²: 50 steps, all seven); the main
   path, ``shear_main.run_shear`` at the demo default 130² for 1000 steps
   (BGK, MRT, KBC_A; ``periodic`` exactly 1000 launches each and no other
   kernel; mass and finite fields); 2048² and 130² timed windows (best of
   three, busy share, device µs per launch beside the 84-byte-a-cell
   bound, the twin per call).
0c. The JRL case on a mesh of shards (``sharded_phases``): the ethaline
   grid at refine 8 (1024x512, Re 4, Pe 5) on the meshes (1, 1), (4, 1)
   and (2, 2), every shard on the one card: each sharded kernel
   (``fluid_a_sh``, ``fluid_b_sh`` with their lean instances on the (4, 1)
   shards above the tip, ``c_balance_sh``, ``c_approach_sh`` and its disk
   terms, ``halo_pack`` bit for bit) against its twin after one launch on
   every shard; ``fluid_pass_sh`` (its registers, spills and launch shape
   against the host plan first: sub-steps in turn over the whole shard,
   one wave of tiles, one cooperative launch) on every shard of (1, 1),
   (2, 1) and (4, 1) at k = 1..4, the lean class on the shard above the
   tip, and its column instance (2k lanes a side from the column blocks)
   on every shard of (2, 2) and (1, 2), bit for bit k steps of the A/B
   pair and, at k = 1 and 4, its twin run on the CPU;
   the C passes ``c_balance_pass_sh`` and ``c_approach_pass_sh`` (their
   registers, spills and launch shape against the host plan first, and
   those of their column instances) on every shard of (1, 1) and (4, 1)
   at k = 1..4, bit for bit k steps of ``c_balance_sh`` and of the lerp
   and ``c_approach_sh`` (h, C, the disk sums; the approach from a step
   whose k steps cross a tip row and a stored frame) and, at k = 1 and 4,
   their twins run on the CPU; their column instances on every shard of
   (2, 2) and (1, 2) at k = 1..4 likewise (the approach from step 8 and
   from 2**24 - 5), the twins at every k; the main path, the three
   sharded runners (``kernels/jrl_sharded.py``; each one pass launch a
   shard and k-step pass on every mesh, on (2, 2) the passes' column
   instances) over 200 steps each across tip rows and stored frames,
   counts zeroed just before each and read just after, bit for bit the
   unsharded per-step kernels (integrals rtol 2e-4 / atol 1e-4), µs/step,
   device µs/step, busy share, launches and exchanges a step beside the
   per-step kernels' and beside each phase's per-step route
   (``route="launches"``, the yardstick; on the row meshes the pass at the
   other of k = 1 and 4 too) (one card: the cost of the
   halo exchange and the launches, not multi-card scaling); the (1, 1)
   mesh once more through a one-rank NCCL process group (``psum`` by
   ``all_reduce``), bit for bit the local mesh; ``fluid_pass_sh`` alone
   (CUDA events, the L2 flushed, the median of three) on the (4, 1) and
   the (2, 2) shard with the tip and on the (1, 1) grid at k = 1..4, the C passes
   alone on the (4, 1) and (2, 2) shards with the tip at k = 1..4,
   the other kernels' device µs per launch on a 512x256 shard (by events
   behind a sleep kernel where the profiler records no device time), each
   beside its bound and twin.
0d. The cylinder channel on a mesh of shards (``cyl_sharded_phases``) at
   ``bench.py``'s 2048² scene, every shard on the one card, route by
   route: the lean split at k = 1 on (1, 1), (4, 1) and (2, 2) (its three
   x modes) and at k = 4 on (4, 1) and (2, 2) (x_ext 128, x_halo 8), PIECES
   (tile_rows 64) on (4, 1) and (2, 2), PADDED on (2, 2). Each kernel
   (``cyl_block_sh``, ``cyl_lean_sh``, ``cyl_window_sh``, ``cyl_pass_sh``)
   against its twin after one launch on the
   cylinder's shard (1e-5), ``cyl_pass_sh`` also against ``cyl_lean_sh`` +
   ``cyl_window_sh`` bit for bit, ``halo_pack``'s k-row and one-lane phases
   bit for bit; the runner over 23 steps (counts zeroed just before and
   read just after; the lean split one ``cyl_pass_sh`` launch a shard and
   pass): the full-boundary routes bit for bit the unsharded
   ``split=False`` runner, the lean split within f, rho 2e-5 and vel 2e-4
   of the unsharded default runner on non-OBSTACLE cells (k = 1 also set
   beside the unsharded k = 1 split steps) and bit for bit its yardstick
   ``route="launches"``; the lean routes timed (20 warm-up steps, best of
   three 600-step windows, busy share) beside ``route="launches"`` and the
   unsharded runner; each kernel alone at the main path's shapes (the L2
   flushed between launches, CUDA events, the median of three) beside its
   bound and twin.
2. Holds each per-step kernel to its plain PyTorch twin from the same
   state, after 1 step (f, rho, C, h at 1e-5; vel at 1e-4) and after 100
   steps through the per-step runners (2e-5; vel 2e-4; integrals rtol
   2e-4 / atol 1e-4), on the refine-8 ethaline grid (1024x512) and on the
   flat-tip cylinder at 128x64, where the 100 steps also go through
   ``pick_*_runner`` (the multi-step kernels); ``c_approach_pass`` also
   bit for bit the ``c_approach`` pair after PyTorch's lerp (h, C, the
   integrals), the per-step runner through both.
3. Holds each multi-step kernel to its twin (the loop of the per-step
   twins) over one launch of 200 steps (the fluid 100), at the same
   tolerances: at 128x64
   (ethaline wedge and cylinder, both ``is_negative``) through both routes
   of each phase (the cluster kernels ``fused_fluid_cl``,
   ``fused_balance_cl``, ``fused_approach_cl`` and the cooperative ones)
   and at the route's kernels of 256x128 and of 512x256 (both
   ``is_negative``; ``MC_ROUTE``: the multi-cluster balance and the
   fluid's tile kernel at both, the multi-cluster approach at 256x128 and
   the cooperative one at 512x256, the largest grid it serves;
   ``fused_approach_mc`` forced there); the approach once across
   stored-velocity frame boundaries and once across tip rows. The cluster
   kernels equal the cooperative ones bit for bit over a 1000-step launch
   of the default configurations (and the 45degree tip; the approach's
   integrals within rtol 2e-4 / atol 1e-4, whether also bit for bit
   printed), the approach also from step 2**24 - 500; the multi-cluster
   kernels equal them over a 1000-step launch at 256x128 and 512x256
   (both balances; the approach of the ethaline case from step 3000, and
   of the wedge and the flat tip across a handover of the disk row from
   one cluster to the next, h and C bit for bit, the integrals bit for bit
   where one block held the disk row, else within rtol 2e-4 / atol 1e-4;
   route="clusters" forced where the route is the cooperative one) and
   over steps 2**24 - 100 .. 2**24 + 99 at 256x128
   and 512x256 (flat tip and wedge), the fluid also against its twin over
   steps 2**24 - 5 .. 2**24 + 4 there. The fluid's tile kernel
   ``fused_fluid_tl`` equals ``fused_fluid`` bit for bit over a 1000-step
   launch at 256x128 and 512x256 with the ethaline, 45degree and cylinder
   tips, across a tip row and from step 2**24 - 5, and its twin (the
   launch played tile by tile on the card) in phase 7. The approach's
   division policy (``csrc/exact_div.cuh``: a correctly rounded
   reciprocal and one FMA correction) against ``__fdiv_rn`` over all 2^32
   float32 numerators for CS2F, CS4F, sqrt(2) and r = x + 0.5 at 512x256's
   256 columns (no difference may show); the approach's row kernel
   ``fused_approach_rw`` equals ``fused_approach`` bit for bit (h, C and
   the four sums) over a 1000-step launch at 256x128 and 512x256 with the
   ethaline, 45degree and cylinder tips, across a stored frame and from
   step 2**24 - 5, and its twin (the launch played run by run on the card)
   in phase 7. Then
   fluid steps 2**24 - 5 .. 2**24 + 4 through both routes (bit for
   bit each other) and through fluid_a / fluid_b against the twin.
3a. Holds each tile-class kernel (``fluid_k``, ``fluid_k_lean``,
   ``fluid_k_bt``) to its twin after one launch at k = 1, 2, 4 (1e-5) at
   1024x512: the refine-8 ethaline grid at step 0 (full and lean tiles)
   and a flat tip at a step with below-tip tiles; ``fluid_pass`` (the k =
   1 split pass in one launch) to its twin (1e-5) and to ``fluid_k`` +
   ``fluid_k_lean`` bit for bit on the same plans, on the default
   refine-8 case's plans of steps 0, 825,712,484 and 1,651,000,000, and
   at each step 2**24 - 5 .. 2**24 + 4; then the tiled runner
   (``kernels/jrl_tiled.py::make_tiled_fluid_runner``) against the same
   runner on the twins, against fluid_a / fluid_b and, at k = 1, against
   itself through the classes (bit for bit) over 110 steps that cross a
   tip row and a frontier change, on both grids, and over steps 2**24 - 5
   .. 2**24 + 4 at k = 1 and 4 (f, rho 2e-5; vel 2e-4).
4. Runs the main path at 1024x512 through the ``pick_*`` runners: 1000
   fluid steps of the refine-8 ethaline case through ``fluid_pass``
   (which must launch; ``fluid_k``, ``fluid_k_lean``, ``fluid_a`` and
   ``fluid_b`` must not), the same steps through the two tile classes
   (``route="classes"``) and through the per-step pair as yardsticks,
   1000 steps of the default refine-8 case from step 825,712,484 (full
   rows [(0,640),(960,1024)]) on a noisy state beside the same two
   yardsticks, 1000 steps of a flat tip from a step with below-tip tiles
   (``fluid_pass`` and ``fluid_k_bt``), 100 steps of the ethaline late
   travel from step 41,280 (no lean tile left: ``fluid_a`` / ``fluid_b``,
   as in JAX), then 1000 balance steps (per-step ``c_balance``); the
   approach's ``c_approach_pass`` against the pair (bit for bit) and its
   twin on the default refine-8 case's steps 0, 10,170,450, its last two
   (the last frame, no lerp) and 2**24 - 5 .. 2**24 + 4, from windows of
   its frame history; then 1000 approach steps through ``c_approach_pass``
   (one launch a step) from step 0 and from step 10,170,450 of the
   default refine-8 case on a noisy state with a two-frame window, each
   beside the ``c_approach`` pair after PyTorch's lerp (bit for bit the
   same result) and the pair alone; each phase's launch counts are zeroed
   just before it and read just after, and no kernel off the phase may
   launch. Times the phases (device and wall µs per step, busy share,
   device µs per launch), the host µs of a ``k_pass`` call through the
   checked class wrappers and through the runner's unchecked pass, and of
   an approach step through the checked pair, the checked pass and the
   runner's unchecked pass, each kernel per launch beside its bound and
   each twin per call.
5. Runs the 128x64 path of the default case (``JRLFluidConfig()``,
   ``JRLCConfig()``) through the ``pick_*`` runners in the chunks
   ``run_case`` uses: the fluid phase to its first record step, one
   balance interval (255,528 steps), the approach over its first dumps
   (>= 20,000 steps per phase). Counts zeroed before each phase and read
   after: each phase must have launched its cluster kernel and no
   cooperative or per-step kernel. Beside them, as yardsticks, the same
   chunks through the cooperative kernels (bit for bit the cluster
   phases' results; the approach's h and C) and each configuration
   through the per-step kernels. Then the grids the multi-cluster kernels
   serve on the main path, refine 2 (256x128) and refine 4 (512x256): 200
   fluid, 200 balance and 200 approach steps through ``pick_*``, which
   must launch the kernel of ``MC_ROUTE`` (``fused_balance_mc`` at both
   grids, the fluid's tile kernel ``fused_fluid_tl`` at both (the
   refine-2 and refine-4 fluid phases), the approach's row kernel
   ``fused_approach_rw`` at both (the refine-2 and refine-4 approach
   phases: at 512x256 the multi-cluster one, two cells a thread, loses to
   the cooperative one, and the rows beat both) and nothing else, each
   beside the same
   steps through the other route (the cooperative kernel beside the
   multi-cluster and tile ones; timed, bit for bit: h and C for the
   approach).
6. Runs one whole case through ``jrl_main.run_case`` at 128x64 twice:
   through the multi-step kernels (its default: the three cluster
   kernels) and through the per-step runners (``c_approach_pass`` for the
   approach); the record rows agree to rtol 2e-4 / atol 1e-4.
6a. The Pe sweep (``sweep_phases``): the water Re 1e-2 row at 128x64
   (seven Pe lanes) through ``batch_pe.run_re_row`` with the balance and
   the lanes cut (counts zeroed just before and read just after: the
   fluid and balance cluster kernels and one ``fused_approach_lanes``
   launch); the same lanes through the serial route (``fused_approach_cl``
   lane after lane, the records bit for bit equal), timed beside the
   lanes and one lane alone; the lanes kernel against its twin (h, C
   2e-5, the record sums rtol 2e-4 / atol 1e-4) beside its bound.
7. Prints ``{"kernels": [...]}`` (52 rows: each kernel once, the column
   instances of ``fluid_pass_sh``, ``c_balance_pass_sh`` and
   ``c_approach_pass_sh`` rows of their own, the five
   cylinder kernels also as ``<name>/bf16`` and ``<name>/bf16_sr``; the
   cluster kernels and ``fused_approach`` timed on a 200-step launch at
   128x64 (CUDA events), the cooperative fluid and balance on a 200-step
   launch at 512x256, the three multi-cluster ones at 256x128,
   ``fused_fluid_tl`` on a 2-step launch at 512x256 beside its twin (held
   to it at 2e-5, vel 2e-4), ``fused_approach_rw`` likewise (h, C 2e-5;
   the sums rtol 2e-4 / atol 1e-4); all
   eight printed at both grids with the plans and bounds, and each phase's
   steps and launches of the default case at refine 2 and 4), the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

Exits non-zero on any failure, and without printing a result when no
card is present or the package is missing.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import itertools
import json
import os
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))

# Least time for the bytes each kernel must move: each input read once,
# each output written once, at the card's memory rate. Rates from NVIDIA's
# data sheets; an unlisted card falls back to the H100 SXM figure.
MEM_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}
MEM_RATE_DEFAULT = 3.35e12  # H100 SXM (HBM3)
F32_PEAK = 67e12  # H100 SXM float32 outside the tensor cores
# float32 operations per cell away from the tip, counted by hand from the
# kernel sources (geometry at the neighbours, sums, equilibrium and
# collision; the cells next to the tip do more, but they are a few
# hundred of 524288). The operation bound stays far under the memory one.
FLOPS_PER_CELL = {"fluid_a": 250, "fluid_b": 400, "c_balance": 230, "c_approach": 330,
                  # per cell and step: A + B; the balance; the approach + the lerp
                  "fused_fluid": 650, "fused_balance": 230, "fused_approach": 335,
                  "fused_fluid_cl": 650, "fused_balance_cl": 230, "fused_approach_cl": 335,
                  "fused_fluid_mc": 650, "fused_balance_mc": 230, "fused_approach_mc": 335,
                  "fused_fluid_tl": 650, "fused_approach_rw": 335,
                  "fused_approach_lanes": 335,
                  "c_approach_pass": 335,
                  # per cell and step of a tile class (halo recompute not
                  # counted): A + B; the lean A (pulls, moments) + B
                  "fluid_k": 650, "fluid_k_lean": 420, "fluid_k_bt": 650,
                  # fluid_pass: the full class's on full rows, the lean one's on lean rows
                  # per shard cell: as the per-step kernels; a copy
                  "fluid_a_sh": 250, "fluid_b_sh": 400, "c_balance_sh": 230,
                  "c_approach_sh": 330, "halo_pack": 0,
                  # per shard cell and step: A + B (the 2k-row halo recompute not counted)
                  "fluid_pass_sh": 650, "fluid_pass_sh_cols": 650,
                  # per shard cell and step: the balance; the approach + the lerp
                  "c_balance_pass_sh": 230, "c_approach_pass_sh": 335,
                  "c_balance_pass_sh_cols": 230, "c_approach_pass_sh_cols": 335}
PER_STEP = ("fluid_a", "fluid_b", "c_balance", "c_approach")
# the kernels of a whole case through the per-step runners
PER_STEP_CASE = ("fluid_a", "fluid_b", "c_balance", "c_approach_pass")
FUSED = ("fused_fluid", "fused_balance", "fused_approach")
FUSED_CL = ("fused_fluid_cl", "fused_balance_cl", "fused_approach_cl")
# the multi-step kernels of the default 128x64 case
PATH128 = ("fused_fluid_cl", "fused_balance_cl", "fused_approach_cl")
# the multi-cluster kernels of 256x128 and 512x256 (refine 2 and 4)
MC = ("fused_fluid_mc", "fused_balance_mc", "fused_approach_mc")
SOURCE = {
    "fluid_a": ("jrl_lbm_torch/kernels/csrc/fluid_a.cu",
                "jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py:506"),
    "fluid_b": ("jrl_lbm_torch/kernels/csrc/fluid_b.cu",
                "jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py:598"),
    "c_balance": ("jrl_lbm_torch/kernels/csrc/c_balance.cu",
                  "jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py:1897"),
    "c_approach": ("jrl_lbm_torch/kernels/csrc/c_approach.cu",
                   "jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py:1998"),
    "c_approach_pass": ("jrl_lbm_torch/kernels/csrc/c_approach_pass.cu",
                        "jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py:1998"),
    "fused_fluid": ("jrl_lbm_torch/kernels/csrc/fused_fluid.cu",
                    "jrl_lbm_tpu/ops/pallas/fused_jrl.py:138"),
    "fused_balance": ("jrl_lbm_torch/kernels/csrc/fused_balance.cu",
                      "jrl_lbm_tpu/ops/pallas/fused_jrl.py:531"),
    "fused_approach": ("jrl_lbm_torch/kernels/csrc/fused_approach.cu",
                       "jrl_lbm_tpu/ops/pallas/fused_jrl.py:766"),
    "fused_fluid_cl": ("jrl_lbm_torch/kernels/csrc/fused_fluid_cl.cu",
                       "jrl_lbm_tpu/ops/pallas/fused_jrl.py:138"),
    "fused_balance_cl": ("jrl_lbm_torch/kernels/csrc/fused_balance_cl.cu",
                         "jrl_lbm_tpu/ops/pallas/fused_jrl.py:531"),
    "fused_approach_cl": ("jrl_lbm_torch/kernels/csrc/fused_approach_cl.cu",
                          "jrl_lbm_tpu/ops/pallas/fused_jrl.py:766"),
    "fused_fluid_mc": ("jrl_lbm_torch/kernels/csrc/fused_fluid_mc.cu",
                       "jrl_lbm_tpu/ops/pallas/fused_jrl.py:138"),
    "fused_balance_mc": ("jrl_lbm_torch/kernels/csrc/fused_balance_mc.cu",
                         "jrl_lbm_tpu/ops/pallas/fused_jrl.py:531"),
    "fused_approach_mc": ("jrl_lbm_torch/kernels/csrc/fused_approach_mc.cu",
                          "jrl_lbm_tpu/ops/pallas/fused_jrl.py:766"),
    "fused_fluid_tl": ("jrl_lbm_torch/kernels/csrc/fused_fluid_tl.cu",
                       "jrl_lbm_tpu/ops/pallas/fused_jrl.py:138"),
    "fused_approach_rw": ("jrl_lbm_torch/kernels/csrc/fused_approach_rw.cu",
                          "jrl_lbm_tpu/ops/pallas/fused_jrl.py:766"),
    "cyl_full": ("jrl_lbm_torch/kernels/csrc/cyl_full.cu",
                 "jrl_lbm_tpu/ops/pallas/fused_step.py:247"),
    "cyl_interior": ("jrl_lbm_torch/kernels/csrc/cyl_interior.cu",
                     "jrl_lbm_tpu/ops/pallas/fused_step.py:465"),
    "cyl_interior_k": ("jrl_lbm_torch/kernels/csrc/cyl_interior_k.cu",
                       "jrl_lbm_tpu/ops/pallas/fused_step.py:606"),
    "cyl_band_k": ("jrl_lbm_torch/kernels/csrc/cyl_band_k.cu",
                   "jrl_lbm_tpu/ops/pallas/fused_step.py:838"),
    # one launch for the three calls of _fused_step2_split_impl (:1196, :1275, :1292)
    "cyl_pass": ("jrl_lbm_torch/kernels/csrc/cyl_pass.cu",
                 "jrl_lbm_tpu/ops/pallas/fused_step.py:1196"),
    "fluid_k": ("jrl_lbm_torch/kernels/csrc/fluid_k.cu",
                "jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py:1349"),
    "fluid_k_lean": ("jrl_lbm_torch/kernels/csrc/fluid_k_lean.cu",
                     "jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py:1482"),
    "fluid_k_bt": ("jrl_lbm_torch/kernels/csrc/fluid_k_bt.cu",
                   "jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py:1522"),
    "fluid_pass": ("jrl_lbm_torch/kernels/csrc/fluid_pass.cu",
                   "jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py:1349"),
    "fluid_a_sh": ("jrl_lbm_torch/kernels/csrc/fluid_a_sh.cu",
                   "jrl_lbm_tpu/ops/pallas/fused_jrl_sharded.py:136"),
    "fluid_b_sh": ("jrl_lbm_torch/kernels/csrc/fluid_b_sh.cu",
                   "jrl_lbm_tpu/ops/pallas/fused_jrl_sharded.py:166"),
    # the shard=True mode of _make_fluid_k_kernel (its shard branch :1373-1383)
    "fluid_pass_sh": ("jrl_lbm_torch/kernels/csrc/fluid_pass_sh.cu",
                      "jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py:1349"),
    # its column instance: k steps of the 2D-mesh route's _step_a (:136,
    # its pallas_call :151) and _step_b (:166 -> :182) with their x windows
    # (_xblocks :75) in one
    "fluid_pass_sh_cols": ("jrl_lbm_torch/kernels/csrc/fluid_pass_sh.cu",
                           "jrl_lbm_tpu/ops/pallas/fused_jrl_sharded.py:136"),
    "c_balance_sh": ("jrl_lbm_torch/kernels/csrc/c_balance_sh.cu",
                     "jrl_lbm_tpu/ops/pallas/fused_jrl_sharded.py:411"),
    "c_approach_sh": ("jrl_lbm_torch/kernels/csrc/c_approach_sh.cu",
                      "jrl_lbm_tpu/ops/pallas/fused_jrl_sharded.py:513"),
    # k launches of _step_balance (called at :429) in one
    "c_balance_pass_sh": ("jrl_lbm_torch/kernels/csrc/c_balance_pass_sh.cu",
                          "jrl_lbm_tpu/ops/pallas/fused_jrl_sharded.py:411"),
    # k launches of _step_approach (called at :533) and the jnp lerp before each
    # (:593-607) in one
    "c_approach_pass_sh": ("jrl_lbm_torch/kernels/csrc/c_approach_pass_sh.cu",
                           "jrl_lbm_tpu/ops/pallas/fused_jrl_sharded.py:513"),
    # their column instances: k launches of _step_balance and _step_approach
    # with their x windows (xw, _xblocks :75) in one
    "c_balance_pass_sh_cols": ("jrl_lbm_torch/kernels/csrc/c_balance_pass_sh.cu",
                               "jrl_lbm_tpu/ops/pallas/fused_jrl_sharded.py:411"),
    "c_approach_pass_sh_cols": ("jrl_lbm_torch/kernels/csrc/c_approach_pass_sh.cu",
                                "jrl_lbm_tpu/ops/pallas/fused_jrl_sharded.py:513"),
    "halo_pack": ("jrl_lbm_torch/kernels/csrc/halo_pack.cu",
                  "jrl_lbm_tpu/ops/pallas/fused_sharded.py:409"),
    "cyl_block_sh": ("jrl_lbm_torch/kernels/csrc/cyl_block_sh.cu",
                     "jrl_lbm_tpu/ops/pallas/fused_sharded.py:330"),
    "cyl_lean_sh": ("jrl_lbm_torch/kernels/csrc/cyl_lean_sh.cu",
                    "jrl_lbm_tpu/ops/pallas/fused_sharded.py:760"),
    "cyl_window_sh": ("jrl_lbm_torch/kernels/csrc/cyl_window_sh.cu",
                      "jrl_lbm_tpu/ops/pallas/fused_sharded.py:886"),
    # one launch for _lean_tiled_step (:760, called at :863) and
    # _window_full_step (:886, called at :962)
    "cyl_pass_sh": ("jrl_lbm_torch/kernels/csrc/cyl_pass_sh.cu",
                    "jrl_lbm_tpu/ops/pallas/fused_sharded.py:760"),
    # the lanes instance: JAX's sweep vmaps the jnp step over the work of
    # _make_approach_kernel (called at :1101)
    "fused_approach_lanes": ("jrl_lbm_torch/kernels/csrc/fused_approach_cl.cu",
                             "jrl_lbm_tpu/ops/pallas/fused_jrl.py:766"),
}
TILED = ("fluid_k", "fluid_k_lean", "fluid_k_bt", "fluid_pass")
ROUTE_SUFFIX = {"cluster": "_cl", "clusters": "_mc", "coop": "", "tiles": "_tl", "rows": "_rw"}
# the tiles: the fluid's only; the rows: the approach's only
ROUTE_ONLY = {"tiles": "fused_fluid", "rows": "fused_approach"}
ROUTE_KERNEL = {(name, route): name + suffix for name in FUSED
                for route, suffix in ROUTE_SUFFIX.items()
                if ROUTE_ONLY.get(route, name) == name}
# the kernel each phase's route takes at refine 2 (256x128) and 4 (512x256)
# of the default case on an H100 (PERF.md §6)
MC_ROUTE = {2: {"fused_fluid": "fused_fluid_tl", "fused_balance": "fused_balance_mc",
                "fused_approach": "fused_approach_rw"},
            4: {"fused_fluid": "fused_fluid_tl", "fused_balance": "fused_balance_mc",
                "fused_approach": "fused_approach_rw"}}
# the fluid's tile kernel: the tips held to the cooperative kernel, and the
# steps of the launch its row times beside its twin (the twin plays the
# launch tile by tile)
TL_SHAPES = ("ethaline", "45degree", "cylinder")
TL_ROW_STEPS = 2
# the approach's row kernel: the columns of its division proof (512x256's),
# and the steps of the launch its row times beside its twin (the twin plays
# the launch run by run)
RW_PROOF_COLS = 256
RW_ROW_STEPS = 2


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check_close(name, got, want, tol, report):
    import torch

    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    report.append(err)
    print(f"  {name:28s} max|kernel - twin| = {err:.3e} (|twin| max {scale:.3e}, tol {tol:g})",
          flush=True)
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output not finite")
    if err > tol * (1.0 + scale):
        fail(f"{name}: deviation {err:.3e} above {tol:g} (scaled by 1 + |twin|)")


def check_ints(name, got, want):
    """The four tip-disk integrals, rtol 2e-4 / atol 1e-4."""
    for key, g, w in zip(("inflow", "current", "rec_u", "rec_v"), got, want):
        g, w = float(g), float(w)
        print(f"  {name} {key:8s} kernel {g:.7g} twin {w:.7g}", flush=True)
        if not abs(g - w) <= 1e-4 + 2e-4 * abs(w):
            fail(f"{name} {key}: {g} vs {w}")


def sass_check(build) -> dict:
    """Read-only (non-coherent) global loads in each multi-step library's
    and each sharded C pass's machine code; there must be none (a
    persistent kernel reads state that other blocks wrote in the same
    launch). And ``fluid_pass``'s, ``fused_fluid_tl``'s and
    ``fused_approach_rw``'s spills as ``-Xptxas -v`` reports them; there
    must be none."""
    import re
    import shutil

    from jrl_lbm_torch.kernels import jrl_c, jrl_tiled

    log = build.build_log.get("fluid_pass", "")
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", log)]
    regs, local = jrl_tiled.pass_info()
    print(f"  fluid_pass: {regs} registers, {local} local bytes; -Xptxas -v spills {spills}",
          flush=True)
    if local or any(spills):
        fail(f"fluid_pass spills: {local} local bytes, -Xptxas -v {spills}")
    from jrl_lbm_torch.kernels import fused_jrl

    log = build.build_log.get("fused_fluid_tl", "")
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", log)]
    regs, local = fused_jrl.tl_info()
    print(f"  fused_fluid_tl: {regs} registers, {local} local bytes; -Xptxas -v spills {spills}",
          flush=True)
    if local or any(spills):
        fail(f"fused_fluid_tl spills: {local} local bytes, -Xptxas -v {spills}")
    log = build.build_log.get("fused_approach_rw", "")
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", log)]
    regs, local, threads, _ = fused_jrl.rw_info()
    print(f"  fused_approach_rw ({threads} threads a block): {regs} registers, {local} local "
          f"bytes; -Xptxas -v spills {spills}", flush=True)
    if local or any(spills):
        fail(f"fused_approach_rw spills: {local} local bytes, -Xptxas -v {spills}")
    regs_p, local_p = jrl_c.pass_info()
    print(f"  c_approach_pass: {regs_p} registers, {local_p} local bytes", flush=True)
    from jrl_lbm_torch.kernels import cylinder

    print("  cyl_pass (k, storage): registers, local bytes " + ", ".join(
        f"({k}, {st}) {cylinder.cyl_pass_info(k, st)}" for k in (2, 4) for st in (0, 1, 2)),
        flush=True)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("  cuobjdump not found: SASS check not made", flush=True)
        return {}
    counts = {}
    libs = FUSED + MC + ("fused_fluid_tl", "fused_approach_rw", "c_balance_pass_sh",
                         "c_approach_pass_sh")
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:  # one cuobjdump each
        dumps = pool.map(lambda k: subprocess.run(
            [tool, "-sass", str(build._lib_file(k))], capture_output=True, text=True, check=True,
            timeout=120).stdout, libs)
    for k, sass in zip(libs, dumps):
        counts[k] = sum(1 for ln in sass.splitlines() if "LDG" in ln and "CONSTANT" in ln)
        print(f"  {k}: {counts[k]} LDG.E.CONSTANT in {len(sass.splitlines())} SASS lines",
              flush=True)
        if counts[k]:
            fail(f"{k}: read-only global loads in a persistent kernel")
    return counts


def cluster_choice(F, res) -> dict:
    """The cluster kernels' limits on this card and the route each phase
    takes on the ``res`` grid (the default 128x64): blocks, cells per
    thread, dynamic shared memory and registers per block."""
    out = {}
    for name in ("fused_fluid", "fused_balance", "fused_approach"):
        lim = F.card_limits(name, 0)
        shape = F.cluster_shape(name, *res, lim)
        route = F.fused_route(name, *res, lim)
        rec = {"limits": lim._asdict(), "route": route}
        if shape:
            blocks, cpt, smem = shape
            regs, local = F.cluster_info(name, cpt, 0)
            rec.update(blocks=blocks, threads=F.CLUSTER_THREADS, cells_per_thread=cpt,
                       smem_per_block=smem, registers=regs, local_bytes=local)
        out[name] = rec
        print(f"  {name}: card limits {lim.smem_optin} B dynamic shared memory a block, "
              f"clusters of {lim.cluster}; {res[0]}x{res[1]} route {route}"
              + (f": cluster of {blocks} blocks x {F.CLUSTER_THREADS} threads, {cpt} cell(s) a "
                 f"thread, {smem} B shared memory a block, {regs} registers, {local} B local"
                 if shape else ""), flush=True)
    for name in FUSED:
        lim = F.card_limits(name, 0)
        for H, W in ((256, 128), (512, 256)):
            plan = F.mc_plan(name, H, W, lim)
            regs, local = F.mc_info(name, plan.cpt, 0)
            if name == "fused_approach" and local:
                fail(f"fused_approach_mc spills at {plan.cpt} cells a thread: {local} local bytes")
            out[f"{name}_mc {H}x{W}"] = dict(plan._asdict(), registers=regs, local_bytes=local,
                                             route=F.fused_route(name, H, W, lim))
            print(f"  {name}_mc: card holds {lim.active} clusters of {F.MC_SIZES} blocks at "
                  f"once; {H}x{W} route "
                  f"{F.fused_route(name, H, W, lim)}: {plan.clusters} clusters of "
                  f"{plan.cluster} blocks x {F.CLUSTER_THREADS} threads, {plan.cpt} cell(s) a "
                  f"thread, {plan.smem} B shared memory a block, {regs} registers, {local} B "
                  f"local", flush=True)
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for H, W in ((256, 128), (512, 256)):
        plan = F.tl_plan(H, W, sms)
        shape = F.tl_tile_shape(plan.rmax, plan.smax)
        want = (F._sh.TILE_THREADS, F._sh.TILE_SMEM_CAP,
                F._sh.tile_smem_bytes(plan.rmax, plan.smax))
        out[f"fused_fluid_tl {H}x{W}"] = dict(dataclasses.asdict(plan), kernel_shape=shape)
        print(f"  fused_fluid_tl {H}x{W}: plan {plan}; the kernel's threads, shared memory cap, "
              f"bytes a tile, co-resident blocks {shape}", flush=True)
        if shape[:3] != want or plan.grid > shape[3]:
            fail(f"fused_fluid_tl {H}x{W}: the kernel's launch shape {shape} is not the host "
                 f"plan's {want}, grid {plan.grid}")
    plan = F.rw_plan(512, 256, sms)
    shape = F.rw_shape(plan.wrows, 256) if plan else None
    out["fused_approach_rw 512x256"] = dict(plan._asdict() if plan else {}, kernel_shape=shape)
    print(f"  fused_approach_rw 512x256: plan {plan}; the kernel's bytes a block, co-resident "
          f"blocks {shape}", flush=True)
    if plan is None or shape[0] != plan.smem or plan.nruns > shape[1]:
        fail(f"fused_approach_rw 512x256: the kernel's launch shape {shape} does not hold the "
             f"host plan {plan}")
    return out


def case_launches(F, T, refine: int) -> dict:
    """Steps and launches of the three phases of the default ethaline case
    at ``refine``, counted as `models/jrl.py::run_fluid_phase` (a runner
    call up to each record step, one for the step itself),
    `jrl_main.run_balance` (~100 intervals) and `jrl_main.run_approach` (a
    call up to each record step of `models/jrl.py::c_dump_steps`, then the
    rest) call the runners, which split a call into launches of
    `fused_jrl.steps_per_launch`."""
    fc = T.JRLFluidConfig(shape="ethaline", refine=refine)
    cc = T.JRLCConfig(shape="ethaline", refine=refine)
    size_f, size_b = F.steps_per_launch(fc, "fused_fluid"), F.steps_per_launch(cc, "fused_balance")
    cur, fluid = 0, 0
    for s in T.fluid_record_steps(fc, T.X_INTERVAL):
        fluid += -(-(s - cur) // size_f) + 1
        cur = s + 1
    fluid += -(-(fc.total_steps - cur) // size_f)
    interval, balance = max(1, cc.balance_steps // 100), 0
    for done in range(0, cc.balance_steps, interval):
        balance += -(-min(interval, cc.balance_steps - done) // size_b)
    size_a, cur, approach = F.steps_per_launch(cc, "fused_approach"), 0, 0
    for s in T.c_dump_steps(cc):
        approach += -(-(s + 1 - cur) // size_a)
        cur = s + 1
    approach += -(-(cc.total_steps - cur) // size_a)
    return {"fluid_steps": fc.total_steps, "fluid_launches": fluid,
            "balance_steps": cc.balance_steps, "balance_launches": balance,
            "approach_steps": cc.total_steps, "approach_launches": approach}


def disk_band(T, cfg, plan, step: int) -> int:
    """The block of a multi-cluster plan whose band holds the step's disk
    row (rows of block b from b H // B, B blocks)."""
    H = cfg.eff_res[0]
    B = plan.clusters * plan.cluster
    rin = min(max(T.tip_walks(cfg.inflow_height, step, cfg.vel_obs_conv)[1], 0), H - 1)
    return next(b for b in range(B) if b * H // B <= rin < (b + 1) * H // B)


def handover_start(T, cfg, plan, n: int) -> int:
    """A start from which an n-step launch's disk row enters rank 0 of a
    cluster of the plan from the cluster below half way (the first such
    edge above the tip's start)."""
    H = cfg.eff_res[0]
    B = plan.clusters * plan.cluster
    row0 = T.tip_walks(cfg.inflow_height, 0, cfg.vel_obs_conv)[1]
    edge = next(b * H // B for b in range(0, B, plan.cluster) if b * H // B > row0)
    lo, hi = 0, 10**9
    while lo < hi:
        m = (lo + hi) // 2
        if T.tip_walks(cfg.inflow_height, m, cfg.vel_obs_conv)[1] >= edge:
            hi = m
        else:
            lo = m + 1
    return max(0, lo - n // 2)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, n: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` over ``n`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def queued_ms(fn, n: int, warmup: int = 2, head_s: float = 0.05) -> float:
    """Mean milliseconds of ``fn()`` over ``n`` calls queued on the stream
    behind a sleep kernel of ~``head_s`` (cycles at ~2 GHz), so that the
    host's time per call (a wrapper's checks) opens no gap between them:
    CUDA events around the calls, the first one after the sleep."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(head_s * 2e9))
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    if host_s > head_s:
        print(f"  (queued_ms: the host took {host_s * 1e3:.1f} ms to queue {n} calls, longer "
              f"than the {head_s * 1e3:.0f} ms head start: gaps may be timed)", flush=True)
    return start.elapsed_time(end) / n


KERNEL_FUNCS = {  # CUDA functions each wrapper launches
    "fluid_a": ("fluid_a_kernel",),
    "fluid_b": ("fluid_b_kernel",),
    "c_balance": ("c_balance_kernel",),
    "c_approach": ("c_approach_kernel", "c_disk_kernel"),
    "fused_fluid": ("fused_fluid_kernel",),
    "fused_balance": ("fused_balance_kernel",),
    "fused_approach": ("fused_approach_kernel",),
    "fused_fluid_cl": ("fused_fluid_cl_kernel",),
    "fused_balance_cl": ("fused_balance_cl_kernel",),
    "fused_approach_cl": ("fused_approach_cl_kernel",),
    "fused_fluid_mc": ("fused_fluid_mc_kernel",),
    "fused_balance_mc": ("fused_balance_mc_kernel",),
    "fused_approach_mc": ("fused_approach_mc_kernel",),
    "fused_fluid_tl": ("fused_fluid_tl_kernel",),
    "fused_approach_rw": ("fused_approach_rw_kernel",),
    "fused_approach_lanes": ("fused_approach_lanes_kernel",),
    "c_approach_pass": ("c_approach_pass_kernel",),
    "cyl_full": ("cyl_full_kernel",),
    "cyl_interior": ("cyl_interior_kernel",),
    "cyl_interior_k": ("cyl_interior_k_kernel",),
    "cyl_band_k": ("cyl_band_k_kernel",),
    "cyl_pass": ("cyl_pass_kernel",),
    "fluid_k": ("fluid_k_kernel",),
    "fluid_k_lean": ("fluid_k_lean_kernel",),
    "fluid_k_bt": ("fluid_k_bt_kernel",),
    "fluid_pass": ("fluid_pass_kernel",),
    "periodic": ("periodic_kernel",),
    "fluid_a_sh": ("fluid_a_sh_kernel",),
    "fluid_b_sh": ("fluid_b_sh_kernel",),
    "fluid_pass_sh": ("fluid_pass_sh_tiles", "fluid_pass_sh_cols"),
    "fluid_pass_sh_cols": ("fluid_pass_sh_cols",),
    "c_balance_sh": ("c_balance_sh_kernel",),
    "c_approach_sh": ("c_approach_sh_kernel", "c_disk_sh_kernel"),
    "c_balance_pass_sh": ("c_balance_pass_sh_tiles", "c_balance_pass_sh_cols"),
    "c_approach_pass_sh": ("c_approach_pass_sh_tiles", "c_approach_pass_sh_cols"),
    "c_balance_pass_sh_cols": ("c_balance_pass_sh_cols",),
    "c_approach_pass_sh_cols": ("c_approach_pass_sh_cols",),
    "halo_pack": ("halo_rows_kernel", "halo_cols_kernel"),
    "cyl_block_sh": ("cyl_block_sh_kernel",),
    "cyl_lean_sh": ("cyl_lean_sh_kernel",),
    "cyl_window_sh": ("cyl_window_sh_kernel",),
    "cyl_pass_sh": ("cyl_pass_sh_kernel", "cyl_pass_sh_cells_kernel"),
}


def device_profile(fn, steps: int):
    """``(device µs by kernel name, wall s)`` of ``fn(steps)`` from a
    torch.profiler trace of the card; ``({}, wall)`` if the trace holds no
    device time (the profiler is a measurement, not a phase: the run
    itself must not depend on it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        times = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            events = prof.events()
        for ev in events:
            if ev.device_type == DeviceType.CUDA:
                times[ev.name] = times.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    except (RuntimeError, AttributeError) as e:
        print(f"  profiler gave no device times ({e!r})", flush=True)
        return {}, None
    return times, wall


# ---------------------------------------------------------------------------
# The cylinder channel (kernels/cylinder.py)
# ---------------------------------------------------------------------------

CYL = ("cyl_full", "cyl_interior", "cyl_interior_k", "cyl_band_k", "cyl_pass")
# the kernels of the cylinder's main path: each k-step pass one cyl_pass
# launch; cyl_interior_k and cyl_band_k are its yardstick
CYL_PATH = ("cyl_full", "cyl_interior", "cyl_pass")
CYL_YARD = ("cyl_interior_k", "cyl_band_k")
# float32 operations per cell and step, counted by hand from
# csrc/cyl_common.cuh: a plain-channel or uncoupled full cell (moments,
# equilibrium, paired MRT) and the extra of a coupled cell next to the
# cylinder (target velocity, 12-point gradient, reconstruction)
CYL_FLOPS, CYL_COUPLE_FLOPS = 170, 200
# runner against runner (twin or plain) over many steps: f, rho and vel
CYL_TOL = {"f": 2e-5, "rho": 2e-5, "vel": 2e-4}
# the scene of bench.py, and the small split and generic geometries the
# kernels are held to their twins on
CYL_MAIN = dict(res=(2048, 2048), D=64.0, Re=5000.0)
CYL_SMALL = {
    "split 256x128": (dict(res=(256, 128), D=16.0, Re=500.0, cylinder_center=(64.0, 128.0)),
                      dict(tile_rows=16, interior_rows=32)),
    "generic 64x32": (dict(res=(64, 32), D=8.0, Re=500.0, cylinder_center=(16.0, 32.0)),
                      dict(tile_rows=8, split=False)),
}


def cyl_twin_runner(K, run):
    """``run`` with every cylinder kernel call replaced by its plain twin.
    The callers give it a runner on the three-launch route: the three
    twins compute whole-grid steps, the same bits as ``cyl_pass_ref``'s
    block windows (`tests/test_torch_cyl_pass.py`) in one call a launch
    instead of one a block."""
    from unittest import mock

    twins = {"cyl_full": K.cyl_full_ref, "cyl_interior": K.cyl_interior_ref,
             "cyl_interior_k": K.cyl_interior_k_ref, "cyl_band_k": K.cyl_band_k_ref,
             "cyl_pass": K.cyl_pass_ref}

    def twin_run(state, fields, n):
        with mock.patch.multiple(K, **twins):
            return run(state, fields, n)

    return twin_run


def cyl_windows(drive, state, cells: int, tag: str = "", yard: bool = False):
    """Three 600-step windows of the cylinder main path through ``drive``
    (the k=4 passes must carry each: ``cyl_pass``, or with ``yard`` its
    three launches); ``(state, windows, best)``."""
    windows = []
    for w in range(3):
        state, ms, counts = drive(600, state)
        us = ms * 1e3 / 600
        windows.append({"us_per_step": us, "mlups": cells * 600 / (ms * 1e3), "launches": counts})
        print(f"  window {w + 1}/3: 600 steps {us:.3f} us/step {cells / us:.1f} MLUPS "
              f"launches {counts}", flush=True)
        want = dict.fromkeys(CYL, 0)
        want.update({"cyl_interior_k": 150, "cyl_band_k": 300} if yard else {"cyl_pass": 150})
        if counts != want:
            fail(f"{tag}the k=4 passes did not carry the window: {counts}")
    best = min(windows, key=lambda r: r["us_per_step"])
    print(f"  best of 3: {best['us_per_step']:.3f} us/step, {best['mlups']:.1f} MLUPS", flush=True)
    return state, windows, best


def cyl_profile(run, fl, state, best, names=("cyl_pass",)):
    """A profiled 600-step window of ``run``: ``(state, profile)`` with the
    busy share and the k-step kernels' (``names``) device µs per launch
    (an empty profile when the trace holds no device time)."""
    pstate = {"s": state}

    def prof_run(n):
        pstate["s"] = run(pstate["s"], fl, n)

    times, wall = device_profile(prof_run, 600)
    if not wall:
        return pstate["s"], {}
    busy = sum(times.values())
    per_launch = {k: sum(t for nm, t in times.items() if any(f in nm for f in KERNEL_FUNCS[k]))
                  / best["launches"][k] for k in names}
    print(f"  profiled window: device busy {busy / 600:.3f} us/step of "
          f"{wall * 1e6 / 600:.3f} us wall (busy {busy / (wall * 1e6):.1%}); "
          f"device us per launch {per_launch}", flush=True)
    return pstate["s"], {"busy_share": busy / (wall * 1e6), "device_us_per_step": busy / 600,
                         "wall_us_per_step": wall * 1e6 / 600, "kernel_us_per_launch": per_launch,
                         "device_us_by_function": times}


def cyl_alone(K, cfg, run, st, fl, rate, bf16_dev, key=None, names=CYL, plain=None):
    """Each cylinder kernel of ``names`` alone at the main path's shapes (the
    k=4 pass's rows for the k-step kernels, the k=1 split rows for the others) from
    the state ``st`` in the storage of ``bf16_dev``: device µs per launch
    (profiler, else events), the twin's ms per call (``plain[name]`` where
    given: the same twin call, timed where a check made it), and the bound: the
    bytes (each input plane once with its halo rows, each output once; f
    planes 4 bytes a cell in float32, 2 in bf16) at ``rate`` against the
    float32 operations at F32_PEAK (the Philox integer work of a
    stochastic-rounding store is not counted)."""
    import torch

    c = K.consts(cfg)
    H, W = cfg.res
    flags, phi = fl["flags"], fl["phi_obs"]
    obs = (flags == K.OBSTACLE).float()
    nbr_obs = torch.nn.functional.max_pool2d(obs[None, None], 3, 1, 1)[0, 0] > 0
    t_ok = (phi > -1e-10) & (phi <= 1.0)
    coupled_map = t_ok & nbr_obs & (obs == 0)
    out = {k: torch.empty_like(v) for k, v in st.items()}
    interior, band, edge = run.step4.rows
    int1, band1 = run.step.rows
    f_bytes = 4 if bf16_dev is False else 2

    def nrows(segs):
        return sum(y1 - y0 for y0, y1 in segs)

    def coupled(segs):
        return int(sum(int(coupled_map[y0:y1].sum()) for y0, y1 in segs))

    def bound(segs, k, in_other, out_other, full):
        """(bytes, operations): 9 f planes in and out, ``in_other`` and
        ``out_other`` float32 or int32 planes besides."""
        rows = nrows(segs)
        nbytes = ((9 * f_bytes + 4 * in_other) * (rows + 2 * k * len(segs))
                  + (9 * f_bytes + 4 * out_other) * rows) * W
        ops = (CYL_FLOPS * rows * W + (CYL_COUPLE_FLOPS * coupled(segs) if full else 0)) * k
        return nbytes, ops

    m = (bf16_dev, key)
    cases = {  # name: [(kernel call, twin call, bytes and operations)]
        "cyl_full": [(lambda fn: fn(st["f"], st["rho"], st["vel"], flags, phi, out, band1, c, *m),
                      K.cyl_full_ref, bound(band1, 1, 5, 3, True))],
        "cyl_interior": [(lambda fn: fn(st["f"], out, int1, c, False, *m), K.cyl_interior_ref,
                          bound(int1, 1, 0, 0, False))],
        "cyl_interior_k": [(lambda fn: fn(st["f"], out, interior, 4, c, False, *m),
                            K.cyl_interior_k_ref, bound(interior, 4, 0, 0, False))],
        "cyl_band_k": [(lambda fn: fn(st["f"], st["vel"], flags, phi, out, band, 4, False, c, *m),
                        K.cyl_band_k_ref, bound(band, 4, 4, 3, True)),
                       (lambda fn: fn(st["f"], st["vel"], flags, phi, out, edge, 4, True, c, *m),
                        K.cyl_band_k_ref, bound(edge, 4, 1, 3, False))],
        # the three launches' work in one: their bytes and operations added
        "cyl_pass": [(lambda fn: fn(st["f"], st["vel"], flags, phi, out, (interior, band, edge),
                                    4, c, False, bf16_dev, pass_keys(key)),
                      K.cyl_pass_ref,
                      tuple(map(sum, zip(bound(interior, 4, 0, 0, False),
                                         bound(band, 4, 4, 3, True),
                                         bound(edge, 4, 1, 3, False)))))],
    }
    res = {}
    for k in names:
        ms_l, plain_l, mem_l, ops_l = [], [], [], []
        for call, twin, (nbytes, ops) in cases[k]:
            kfn = getattr(K, k)
            times, wall = device_profile(lambda n: [call(kfn) for _ in range(n)], 20)
            us = sum(t for nm, t in times.items() if any(f in nm for f in KERNEL_FUNCS[k]))
            ms_l.append(us / 20 / 1e3 if us > 0 else cuda_ms(lambda: call(kfn), 20))
            plain_l.append((plain or {}).get(k) or cuda_ms(lambda: call(twin), 1, warmup=0))
            mem_l.append(nbytes / rate * 1e3)
            ops_l.append(ops / F32_PEAK * 1e3)
        n = len(ms_l)  # per launch, averaged over the band kernel's two variants
        ms, plain_ms = sum(ms_l) / n, sum(plain_l) / n
        mem_ms, ops_ms = sum(mem_l) / n, sum(ops_l) / n
        bound_ms = max(mem_ms, ops_ms)
        by = "bytes" if mem_ms >= ops_ms else "operations"
        print(f"  {k:14s} {ms * 1e3:10.2f} us/launch  bound {bound_ms * 1e3:8.2f} us ({by})  "
              f"{bound_ms / ms * 100:6.2f}% of bound  twin {plain_ms:.3f} ms  per-variant us "
              f"{[round(x * 1e3, 2) for x in ms_l]}", flush=True)
        res[k] = {"ms": ms, "ms_by_variant": ms_l, "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "mem_ms": mem_ms, "ops_ms": ops_ms, "bound_by": by}
    return res


def cylinder_phases(dev, rate, errs):
    """The cylinder-channel checks and the 2048² main path; returns the
    four ``kernels`` rows and a report."""
    import torch

    from jrl_lbm_torch import kernels
    from jrl_lbm_torch.kernels import cylinder as K
    from jrl_lbm_torch.models import cylinder as CY

    report = {}
    TOL = CYL_TOL

    def new_outs(s):
        return {k: torch.full_like(v, 7.0) for k, v in s.items()}

    def close3(tag, got, want, tol, names, mask=None):
        """f, rho and vel; the deviation counts for every kernel in names."""
        for nm in ("f", "rho", "vel"):
            g, w = got[nm], want[nm]
            if mask is not None:
                m = mask.expand_as(g)
                g, w = g[m], w[m]
            rep = []
            check_close(f"{tag} {nm}", g, w, tol if isinstance(tol, float) else tol[nm], rep)
            for k in names:
                errs[k].extend(rep)

    # ---- each cylinder kernel against its twin, small geometries ----
    for label, (ckw, rkw) in CYL_SMALL.items():
        cfg = CY.CylinderConfig(**ckw)
        c = K.consts(cfg)
        s, fl = CY.init(cfg, dev)
        s = CY.make_runner(cfg)(s, fl, 30)
        g = torch.Generator(device=dev).manual_seed(3)
        s = {k: v + 1e-4 * torch.randn(v.shape, generator=g, device=dev) for k, v in s.items()}
        flags, phi = fl["flags"], fl["phi_obs"]
        print(f"compare cylinder kernels with twins: {label}", flush=True)
        run = K.make_fused_cylinder_runner(cfg, **rkw)
        if run.step.split:
            interior, band, edge = run.step4.rows
            one = [("cyl_full", lambda o, fn: fn(s["f"], s["rho"], s["vel"], flags, phi, o,
                                                  run.step.rows[1], c), K.cyl_full_ref),
                   ("cyl_interior", lambda o, fn: fn(s["f"], o, run.step.rows[0], c, True),
                    K.cyl_interior_ref)]
            for k in (2, 4):
                one.append(("cyl_interior_k", lambda o, fn, k=k: fn(s["f"], o, interior, k, c,
                                                                     True), K.cyl_interior_k_ref))
                for e, segs in ((False, band), (True, edge)):
                    one.append(("cyl_band_k",
                                lambda o, fn, k=k, e=e, segs=segs: fn(s["f"], s["vel"], flags,
                                                                      phi, o, segs, k, e, c),
                                K.cyl_band_k_ref))
                one.append(("cyl_pass", lambda o, fn, k=k: fn(s["f"], s["vel"], flags, phi, o,
                                                              run.step4.rows, k, c, True),
                            K.cyl_pass_ref))
        else:
            one = [("cyl_full", lambda o, fn: fn(s["f"], s["rho"], s["vel"], flags, phi, o,
                                                  [(0, cfg.res[0])], c), K.cyl_full_ref)]
        for k, call, twin in one:
            got, want = new_outs(s), new_outs(s)
            call(got, getattr(K, k))
            call(want, twin)
            close3(f"{k} 1 step", got, want, 1e-5, (k,))
        if run.step.split:
            for k in (2, 4):
                errs["cyl_pass"].append(cyl_pass_equal(K, f"{label} k={k}", s, fl, run.step4.rows,
                                                       k, c, True))
        for n in (40, 41, 43):
            kernels.reset_launches()
            got = run(s, fl, n)
            torch.cuda.synchronize()
            used = tuple(k for k, v in kernels.launches().items() if v)
            want = cyl_twin_runner(K, K.make_fused_cylinder_runner(cfg, route="launches",
                                                                   **rkw))(s, fl, n)
            close3(f"runner {n} steps ({'+'.join(used)})", got, want, TOL, used)

    # ---- the main path at bench.py's 2048² ----
    cfg = CY.CylinderConfig(**CYL_MAIN)
    H, W = cfg.res
    cells = H * W
    c = K.consts(cfg)
    s0, fl = CY.init(cfg, dev)
    run = K.make_fused_cylinder_runner(cfg)
    yard_run = K.make_fused_cylinder_runner(cfg, route="launches")
    print(f"cylinder main path {H}x{W}, D {cfg.D:g}, Re {cfg.Re:g}, tau {cfg.tau:.6f}: "
          f"k=4 rows (interior, band, edge) {run.step4.rows}, one cyl_pass launch a pass "
          f"({len(K.cyl_pass_items(H, W, 4, *run.step4.rows))} blocks)", flush=True)
    path_launches = {k: 0 for k in CYL}

    def drive(n, state, runner=run, main=True):
        """``runner`` for n steps (the main path, else its three-launch
        yardstick), counts zeroed just before and read just after; no JRL
        kernel may launch."""
        torch.cuda.synchronize()
        kernels.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = runner(state, fl, n)
        end.record()
        torch.cuda.synchronize()
        counts = kernels.launches()
        off = {k: v for k, v in counts.items() if v and k not in CYL}
        if off:
            fail(f"cylinder path launched JRL kernels {off}")
        if main:
            for k in CYL:
                path_launches[k] += counts[k]
        return out, start.elapsed_time(end), {k: counts[k] for k in CYL}

    # 23 steps = 5 k=4 passes + 1 k=2 pass + 1 single step: every path kernel runs
    n_cmp = 23
    got, ms, counts = drive(n_cmp, s0)
    print(f"  {n_cmp} steps: launches {counts}", flush=True)
    if not all(counts[k] for k in CYL_PATH) or any(counts[k] for k in CYL_YARD):
        fail(f"cylinder path kernels not launched (or the yardstick's) on the {n_cmp}-step "
             f"drive: {counts}")
    want = cyl_twin_runner(K, yard_run)(s0, fl, n_cmp)
    close3(f"2048² {n_cmp} steps vs twin runner", got, want, TOL, CYL_PATH)
    yard, _, _ = drive(n_cmp, s0, yard_run, main=False)
    errs["cyl_pass"].append(cyl_equal(f"2048² {n_cmp} steps vs the three-launch runner", got,
                                      yard))
    ref = CY.make_runner(cfg)(s0, fl, n_cmp)
    fluid = fl["flags"] != int(CY.CellType.OBSTACLE)
    close3(f"2048² {n_cmp} steps vs jnp-equivalent (non-OBSTACLE)", got, ref, TOL, (),
           mask=fluid)
    del want, ref, yard

    state, windows, best = cyl_windows(drive, run(s0, fl, 20), cells)  # after 20 warm-up steps
    if not all(torch.isfinite(v).all() for v in state.values()):
        fail("2048² state not finite")
    state, prof = cyl_profile(run, fl, state, best)

    # yardsticks, not the main path: the same protocol through the three
    # launches a pass (route="launches"), then one window through k=2
    # passes (LBM_FUSED_K=2) and through single split steps (cyl_interior +
    # cyl_full)
    yard = {}
    ystate, ywin, ybest = cyl_windows(lambda n, st: drive(n, st, yard_run, False),
                                      yard_run(state, fl, 20), cells, "three launches: ", True)
    ystate, yprof = cyl_profile(yard_run, fl, ystate, ybest, CYL_YARD)
    yard["three launches a pass"] = {"windows": ywin, "best": ybest, "profile": yprof}
    del ystate
    old_k = os.environ.get("LBM_FUSED_K")
    os.environ["LBM_FUSED_K"] = "2"
    try:
        run_k2 = K.make_fused_cylinder_runner(cfg)
    finally:
        if old_k is None:
            del os.environ["LBM_FUSED_K"]
        else:
            os.environ["LBM_FUSED_K"] = old_k
    refresh = K.make_macro_refresh(cfg)

    def run_k1(st_, fl_, n):
        bufs = [{k: v.clone() for k, v in st_.items()} for _ in range(2)]
        for i in range(n):
            st_ = run.step(st_, fl_, bufs[i % 2])
        return refresh(st_, fl_)

    for label, fn in (("k=2 passes", run_k2), ("single split steps", run_k1)):
        fn(state, fl, 20)
        torch.cuda.synchronize()
        kernels.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(state, fl, 600)
        end.record()
        torch.cuda.synchronize()
        us = start.elapsed_time(end) * 1e3 / 600
        counts = {k: v for k, v in kernels.launches().items() if v}
        yard[label] = {"us_per_step": us, "mlups": cells / us, "launches": counts}
        print(f"  yardstick, {label}: 600 steps {us:.3f} us/step {cells / us:.1f} MLUPS "
              f"launches {counts}", flush=True)
    report["yardsticks"] = yard
    fx, fy = CY.drag_lift(state, fl, cfg)
    fx, fy = float(fx), float(fy)
    print(f"  drag_lift after {20 + 4 * 600} steps: Fx {fx:.6g} Fy {fy:.6g}", flush=True)
    if not (abs(fx) < float("inf") and abs(fy) < float("inf")):
        fail("drag_lift not finite")
    report.update({"windows": windows, "best": best, "profile": prof, "drag_lift": [fx, fy],
                   "rows": run.step4.rows})

    # ---- each kernel alone at the main path's shapes, and its twin ----
    plain = {}  # the twin's time of the check, the same call on the same state
    errs["cyl_pass"].append(cyl_pass_equal(K, "2048² k=4", state, fl, run.step4.rows, 4, c,
                                           False, twin=plain))
    print(f"cylinder kernels alone at {H}x{W} (memory rate {rate / 1e12:.2f} TB/s):", flush=True)
    alone = cyl_alone(K, cfg, run, state, fl, rate, False, plain=plain)
    rows = []
    for k in CYL:
        report.setdefault("per_launch", {})[k] = alone[k]
        src, rep = SOURCE[k]
        rows.append({
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": path_launches[k], "max_abs_err": max(errs[k]) if errs[k] else None,
            "ms": alone[k]["ms"], "plain_ms": alone[k]["plain_ms"],
            "bound_ms": alone[k]["bound_ms"], "bound_by": alone[k]["bound_by"],
            "library_ms": None,
        })
    return rows, report


# ---------------------------------------------------------------------------
# The cylinder demo (cylinder_main.py)
# ---------------------------------------------------------------------------

CYL_GOLD = os.path.join(HERE, "validation", "goldens", "2d_LBM_cylinder")


def pixel_sha(px) -> str:
    """``tests/test_goldens.py::_pixel_sha`` of a frame's pixels."""
    return hashlib.sha256(px.tobytes() + str(px.shape).encode()
                          + str(px.dtype).encode()).hexdigest()


def demo_drive(cfg, steps: int, dev):
    """``cylinder_main.run_cylinder`` on the card, counts zeroed just before
    and read just after: every pass of these multiples of 4 must be one
    ``cyl_pass`` launch in float32, and nothing else may launch;
    ``(state, dumps, wall s, cyl_pass launches)``."""
    import torch

    from jrl_lbm_torch import cylinder_main, kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, dumps = cylinder_main.run_cylinder(cfg, steps, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in kernels.launches().items() if v}
    modes = {k: v for k, v in kernels.launches_by_mode().items() if v}
    if counts != {"cyl_pass": steps // 4} or modes != {"cyl_pass/f32": steps // 4}:
        fail(f"run_cylinder {cfg.res[0]}x{cfg.res[1]}, {steps} steps: launches {counts} "
             f"({modes}), expected {steps // 4} cyl_pass (float32) and nothing else")
    return state, dumps, wall, steps // 4


DEMO_CHECK_STEPS = 256  # the default demo's steps held to make_runner (a multiple of 4)


def cylinder_demo_phases(dev, rate, errs):
    """The cylinder demo on the card: the goldens' run (frames
    within a mean |pixel difference| of 1.0 of the committed PNGs), about a
    quarter dump interval of the default configuration against the plain
    ``make_runner``, the demo's default run timed, its final Tecplot zone
    through the native writer, and ``cyl_pass`` at 800x400 against its
    twin (deviation into ``errs``) and alone beside its bound; returns
    ``(report, cyl_pass launches)``."""
    import numpy as np
    import torch

    from jrl_lbm_torch import cylinder_main
    from jrl_lbm_torch.kernels import cylinder as K
    from jrl_lbm_torch.models import cylinder as CY
    from jrl_lbm_torch.utils import io as uio
    from jrl_lbm_torch.utils import native_io
    from jrl_lbm_torch.utils.grid import get_staggered

    report, total = {}, 0
    with open(os.path.join(CYL_GOLD, "signatures.json")) as fo:
        golden = json.load(fo)
    cfg, opt = cylinder_main.parse(golden["args"])
    print(f"cylinder demo, the goldens' run {golden['args']}: {cfg.res[0]}x{cfg.res[1]}, "
          f"D {cfg.D:g}, tau {cfg.tau:.6f}", flush=True)
    state, dumps, wall, n = demo_drive(cfg, opt.total_steps, dev)
    total += n
    if len(dumps) != golden["n_frames"]:
        fail(f"{len(dumps)} frames, the goldens have {golden['n_frames']}")
    frames = {}
    for step, vort in dumps:
        name = "{:03}.png".format(step + 1)
        px = uio.frame_pixels(vort)
        want = uio.read_png_gray(os.path.join(CYL_GOLD, name))
        mean = float(np.abs(px.astype(np.float64) - want).mean()) if px.shape == want.shape \
            else float("inf")
        sha = pixel_sha(px)
        frames[name] = {"mean_abs_pixel_diff": mean, "pixel_sha": sha,
                        "golden_sha": golden["frames"][name]}
        print(f"  frame {name}: mean |pixel diff| {mean:.6f} against the committed golden "
              f"(gate < 1.0); pixel sha {sha[:16]}, golden's (JAX on the CPU) "
              f"{golden['frames'][name][:16]}, equal {sha == golden['frames'][name]}",
              flush=True)
        if not mean < 1.0:
            fail(f"cylinder demo frame {name} differs from the golden: mean {mean}")
    report["golden"] = {"args": golden["args"], "wall_s": wall, "cyl_pass": n, "frames": frames}
    print(f"  {opt.total_steps} steps in {wall:.3f} s wall, {n} cyl_pass launches", flush=True)

    cfg, opt = cylinder_main.parse([])
    H, W = cfg.res
    n_chunk = DEMO_CHECK_STEPS
    print(f"cylinder demo, the default configuration's first {n_chunk} steps against the "
          f"plain make_runner (non-OBSTACLE cells):", flush=True)
    chunk, _, _, n = demo_drive(cfg, n_chunk, dev)
    total += n
    s0, fl = CY.init(cfg, dev)
    plain = CY.make_runner(cfg)(s0, fl, n_chunk)
    fluid = fl["flags"] != int(CY.CellType.OBSTACLE)
    dev_plain = []
    for nm in ("f", "rho", "vel"):
        m = fluid.expand_as(chunk[nm])
        check_close(f"{H}x{W} {n_chunk} steps {nm}", chunk[nm][m], plain[nm][m], CYL_TOL[nm],
                    dev_plain)
    report["vs_make_runner"] = {"steps": n_chunk, "max_abs_dev": dev_plain, "tol": CYL_TOL}
    del chunk, plain, s0

    print(f"cylinder demo, the default run: {H}x{W}, D {cfg.D:g}, {opt.total_steps} steps, "
          f"tau {cfg.tau:.6f}", flush=True)
    state, dumps, wall, n = demo_drive(cfg, opt.total_steps, dev)
    total += n
    us = wall * 1e6 / opt.total_steps
    if not all(torch.isfinite(v).all() for v in state.values()):
        fail("the default cylinder demo run's final state is not finite")
    if len(dumps) != opt.total_steps // cylinder_main.DUMP_EVERY:
        fail(f"{len(dumps)} dumps of the default run")
    fx, fy = (float(x) for x in CY.drag_lift(state, fl, cfg))
    print(f"  {opt.total_steps} steps in {wall:.3f} s wall ({len(dumps)} vorticity dumps "
          f"to the host included): {us:.3f} us/step, {H * W / us:.1f} MLUPS; {n} cyl_pass "
          f"launches; drag_lift Fx {fx:.6g} Fy {fy:.6g}", flush=True)
    if not (abs(fx) < float("inf") and abs(fy) < float("inf")):
        fail("drag_lift of the default run not finite")
    report["default"] = {"res": [H, W], "steps": opt.total_steps, "wall_s": wall,
                         "us_per_step": us, "mlups": H * W / us, "cyl_pass": n,
                         "drag_lift": [fx, fy]}

    # the final Tecplot zone as main writes it, through the native writer,
    # then the Python writer on the same arrays (the same bytes)
    lib = native_io.get_lib()
    if lib is None:
        fail("the native Tecplot writer did not build (no g++)")
    out_dir = os.path.join(HERE, "chiprun_out", "cylinder_demo")
    os.makedirs(out_dir, exist_ok=True)
    plt = os.path.join(out_dir, "{:03}.plt".format(opt.total_steps + 1))
    rho = state["rho"].cpu().numpy()
    u, v = (a.cpu().numpy() for a in get_staggered(state["vel"]))
    t0 = time.perf_counter()
    uio.dump_2d_plt_file_single(plt, rho, u, v)
    t_native = time.perf_counter() - t0
    with open(plt, "rb") as fo:
        text = fo.read()
    lines = text.splitlines()
    vals = np.array([ln.split() for ln in lines[4:]], dtype=np.float64)
    if len(lines) != H * W + 4 or vals.shape != (H * W, 5) or not np.isfinite(vals).all():
        fail(f"{plt}: {len(lines)} lines (expected {H * W + 4}), values {vals.shape}, finite "
             f"{np.isfinite(vals).all()}")
    if not np.array_equal(vals[:, 2].astype(np.float32).reshape(H, W), rho):
        fail(f"{plt}: the RHO column does not read back as the state's rho")
    py = plt + ".py"
    real = native_io.get_lib
    native_io.get_lib = lambda: None
    try:
        t0 = time.perf_counter()
        uio.dump_2d_plt_file_single(py, rho, u, v)
        t_python = time.perf_counter() - t0
    finally:
        native_io.get_lib = real
    with open(py, "rb") as fo:
        same = fo.read() == text
    os.remove(py)
    os.remove(plt)
    print(f"  {os.path.basename(plt)}: {len(lines)} lines, {len(text)} bytes, values finite, "
          f"RHO reads back exactly; native writer {t_native * 1e3:.1f} ms, Python writer "
          f"{t_python * 1e3:.1f} ms (host), the same bytes: {same}", flush=True)
    if not same:
        fail("the native and Python Tecplot writers differ")
    report["plt"] = {"lines": len(lines), "bytes": len(text), "native_ms": t_native * 1e3,
                     "python_ms": t_python * 1e3}

    # the pass of the default run at its own grid and row split, from its
    # final state: against the three launches (bit for bit) and the twin
    run = K.make_fused_cylinder_runner(cfg)
    print(f"cyl_pass at the demo's {H}x{W}: k=4 rows (interior, band, edge) {run.step4.rows}, "
          f"{len(K.cyl_pass_items(H, W, 4, *run.step4.rows))} blocks (memory rate "
          f"{rate / 1e12:.2f} TB/s)", flush=True)
    plain = {}
    errs["cyl_pass"].append(cyl_pass_equal(K, f"{H}x{W} k=4", state, fl, run.step4.rows, 4,
                                           K.consts(cfg), False, twin=plain))
    report["per_launch"] = cyl_alone(K, cfg, run, state, fl, rate, False, names=("cyl_pass",),
                                     plain=plain)
    return report, total


# ---------------------------------------------------------------------------
# The cylinder channel in bf16 deviation storage
# ---------------------------------------------------------------------------

CYL_STORAGE = ((True, "bf16"), ("sr", "bf16_sr"))  # bf16_dev, mode name
RESULTS = os.path.join(HERE, "validation", "results")
# the shedding cases' yardstick run, cut: warm-up steps and samples (50
# steps apart)
SHED_YARD_WARMUP = 10_000
SHED_YARD_SAMPLES = 200


def cyl_equal(tag, got, want):
    """Bit for bit: the stored f patterns, rho and vel; returns the largest
    float32 deviation (0 when equal) after failing on any difference."""
    import torch

    from jrl_lbm_torch.kernels import cylinder as K

    err = 0.0
    for nm in ("f", "rho", "vel"):
        g, w = got[nm], want[nm]
        if g.dtype == torch.bfloat16:
            same = torch.equal(g.view(torch.int16), w.view(torch.int16))
            g, w = K.f_from_storage(g, True), K.f_from_storage(w, True)
        else:
            same = torch.equal(g, w)
        d = float((g - w).abs().max())
        err = max(err, d)
        if not torch.isfinite(g).all():
            fail(f"{tag} {nm}: kernel output not finite")
        if not same:
            fail(f"{tag} {nm}: kernel and twin differ (max {d:.3e}); the storage modes are "
                 "held bit for bit")
    print(f"  {tag:52s} bit for bit (stored f, rho, vel)", flush=True)
    return err


def pass_keys(key):
    """Three Philox keys of a stochastic-rounding pass from one (the
    launch numbers key[1] .. key[1] + 2), or None."""
    return None if key is None else tuple((key[0], key[1] + i) for i in range(3))


def cyl_pass_equal(K, tag, s, fl, rows, k, c, write_macro, bf16_dev=False, key=None,
                   twin=None):
    """One ``cyl_pass`` launch against the three launches it replaces
    (``cyl_interior_k``, ``cyl_band_k`` "cyl" and "edge") from the same
    state, keys and output buffers, bit for bit; with ``twin`` (a dict)
    also against ``cyl_pass_ref`` (the class twins item by item on their
    windows: 1e-5 in float32, bit for bit in bf16), the twin's ms (CUDA
    events) into ``twin["cyl_pass"]``. Returns the largest deviation."""
    import torch

    args = (s["f"], s["vel"], fl["flags"], fl["phi_obs"])
    keys = pass_keys(key)
    base = {n: torch.full_like(v, 7.0) for n, v in s.items()}
    got, want = ({n: v.clone() for n, v in base.items()} for _ in range(2))
    K.cyl_pass(*args, got, rows, k, c, write_macro, bf16_dev, keys)
    interior, cyl_rows, edge_rows = rows
    kk = keys or (None, None, None)
    K.cyl_interior_k(s["f"], want, interior, k, c, write_macro, bf16_dev, kk[0])
    K.cyl_band_k(*args, want, cyl_rows, k, False, c, bf16_dev, kk[1])
    K.cyl_band_k(*args, want, edge_rows, k, True, c, bf16_dev, kk[2])
    torch.cuda.synchronize()
    err = cyl_equal(f"cyl_pass {tag} vs the three launches", got, want)
    if twin is not None:
        ref = {n: v.clone() for n, v in base.items()}
        twin["cyl_pass"] = cuda_ms(
            lambda: K.cyl_pass_ref(*args, ref, rows, k, c, write_macro, bf16_dev, keys), 1,
            warmup=0)
        print(f"  cyl_pass_ref {tag}: {twin['cyl_pass'] / 1e3:.2f} s", flush=True)
        if bf16_dev is False:
            for nm in ("f", "rho", "vel"):
                rep = []
                check_close(f"cyl_pass {tag} vs twin {nm}", got[nm], ref[nm], 1e-5, rep)
                err = max(err, rep[0])
        else:
            err = max(err, cyl_equal(f"cyl_pass {tag} vs twin", got, ref))
    return err


def storage_phases(dev, rate, f32_report):
    """The cylinder channel in bf16 deviation storage (round to nearest and
    stochastic rounding): (a) each kernel instance against its twin after
    one launch and the runners against the twin runners, bit for bit;
    (b) the 2048² main path in each mode beside its three-launch
    yardstick; (c) the shedding gate, f32 and SR also through the
    yardstick. Returns the ten ``kernels`` rows (five kernels, two modes)
    and a report."""
    import json

    import numpy as np
    import torch

    from jrl_lbm_torch import kernels, shedding
    from jrl_lbm_torch.kernels import cylinder as K
    from jrl_lbm_torch.models import cylinder as CY

    report = {}
    errs = {(k, nm): [] for k in CYL for _, nm in CYL_STORAGE}
    path = {nm: {k: 0 for k in CYL} for _, nm in CYL_STORAGE}

    def new_outs(s):
        return {k: torch.full_like(v, 7.0) for k, v in s.items()}

    def mode_counts(nm):
        """This mode's launches by kernel; no other mode or kernel may launch."""
        by = kernels.launches_by_mode()
        off = {k: v for k, v in by.items() if v and not k.endswith("/" + nm)}
        off.update({k: v for k, v in kernels.launches().items() if v and k not in CYL})
        if off:
            fail(f"the {nm} path launched {off}")
        return {k: by[f"{k}/{nm}"] for k in CYL}

    # ---- (a) each instance against its twin, small geometries ----
    for label, (ckw, rkw) in CYL_SMALL.items():
        cfg = CY.CylinderConfig(**ckw)
        c = K.consts(cfg)
        s, fl = CY.init(cfg, dev)
        s = CY.make_runner(cfg)(s, fl, 30)
        g = torch.Generator(device=dev).manual_seed(3)
        s = {k: v + 1e-4 * torch.randn(v.shape, generator=g, device=dev) for k, v in s.items()}
        flags, phi = fl["flags"], fl["phi_obs"]
        for mode, nm in CYL_STORAGE:
            print(f"compare {nm} cylinder kernels with twins: {label}", flush=True)
            sm = dict(s, f=K.f_to_storage(s["f"], mode))
            m = (mode, (17, 5) if mode == "sr" else None)
            run = K.make_fused_cylinder_runner(cfg, bf16_dev=mode, seed=17, **rkw)
            if run.step.split:
                interior, band, edge = run.step4.rows
                one = [("cyl_full", lambda o, fn: fn(sm["f"], sm["rho"], sm["vel"], flags, phi,
                                                      o, run.step.rows[1], c, *m)),
                       ("cyl_interior", lambda o, fn: fn(sm["f"], o, run.step.rows[0], c, True,
                                                          *m))]
                for k in (1, 2, 4):
                    one.append((f"cyl_interior_k k={k}",
                                lambda o, fn, k=k: fn(sm["f"], o, interior, k, c, True, *m)))
                    for e, segs in ((False, band), (True, edge)):
                        one.append((f"cyl_band_k k={k} {'edge' if e else 'cyl'}",
                                    lambda o, fn, k=k, e=e, segs=segs: fn(
                                        sm["f"], sm["vel"], flags, phi, o, segs, k, e, c, *m)))
                    if k > 1:
                        one.append((f"cyl_pass k={k}", lambda o, fn, k=k: fn(
                            sm["f"], sm["vel"], flags, phi, o, run.step4.rows, k, c, True, mode,
                            pass_keys(m[1]))))
            else:
                one = [("cyl_full", lambda o, fn: fn(sm["f"], sm["rho"], sm["vel"], flags, phi,
                                                      o, [(0, cfg.res[0])], c, *m))]
            for tag, call in one:
                k = tag.split()[0]
                got, want = new_outs(sm), new_outs(sm)
                call(got, getattr(K, k))
                call(want, getattr(K, k + "_ref"))
                torch.cuda.synchronize()
                errs[k, nm].append(cyl_equal(f"{nm} {tag} 1 launch", got, want))
            if run.step.split:
                for k in (2, 4):
                    errs["cyl_pass", nm].append(cyl_pass_equal(
                        K, f"{nm} {label} k={k}", sm, fl, run.step4.rows, k, c, False, mode, m[1]))
            for n in (40, 41, 43):
                kernels.reset_launches()
                got = K.make_fused_cylinder_runner(cfg, bf16_dev=mode, seed=17, **rkw)(sm, fl, n)
                torch.cuda.synchronize()
                used = tuple(k for k, v in mode_counts(nm).items() if v)
                twin = cyl_twin_runner(K, K.make_fused_cylinder_runner(
                    cfg, bf16_dev=mode, seed=17, route="launches", **rkw))
                err = cyl_equal(f"{nm} runner {n} steps ({'+'.join(used)})", got,
                                twin(sm, fl, n))
                for k in used:
                    errs[k, nm].append(err)

    # ---- (b) the 2048² main path in each storage mode ----
    cfg = CY.CylinderConfig(**CYL_MAIN)
    H, W = cfg.res
    cells = H * W
    s0, fl = CY.init(cfg, dev)
    rows = []
    for mode, nm in CYL_STORAGE:
        run = K.make_fused_cylinder_runner(cfg, bf16_dev=mode, seed=1)
        yard_run = K.make_fused_cylinder_runner(cfg, bf16_dev=mode, seed=1, route="launches")
        st0 = dict(s0, f=K.f_to_storage(s0["f"], mode))

        def drive(n, state, run=run, nm=nm, main=True):
            torch.cuda.synchronize()
            kernels.reset_launches()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = run(state, fl, n)
            end.record()
            torch.cuda.synchronize()
            counts = mode_counts(nm)
            if main:
                for k in CYL:
                    path[nm][k] += counts[k]
            return out, start.elapsed_time(end), counts

        print(f"cylinder main path {H}x{W} in {nm} storage:", flush=True)
        got, _, counts = drive(23, st0)
        if not all(counts[k] for k in CYL_PATH) or any(counts[k] for k in CYL_YARD):
            fail(f"{nm}: cylinder path kernels not launched (or the yardstick's) on the 23-step "
                 f"drive: {counts}")
        want = cyl_twin_runner(K, K.make_fused_cylinder_runner(cfg, bf16_dev=mode, seed=1,
                                                               route="launches"))(st0, fl, 23)
        err = cyl_equal(f"{nm} 2048² 23 steps vs twin runner", got, want)
        yard, _, _ = drive(23, st0, yard_run, nm, False)
        err = max(err, cyl_equal(f"{nm} 2048² 23 steps vs the three-launch runner", got, yard))
        for k in CYL_PATH:
            errs[k, nm].append(err)
        del want, yard
        state, windows, best = cyl_windows(drive, run(got, fl, 20), cells, f"{nm}: ")
        if not all(torch.isfinite(v.float()).all() for v in state.values()):
            fail(f"{nm}: 2048² state not finite")
        state, prof = cyl_profile(run, fl, state, best)
        ystate, ywin, ybest = cyl_windows(lambda n, st: drive(n, st, yard_run, nm, False),
                                          yard_run(state, fl, 20), cells,
                                          f"{nm} three launches: ", True)
        ystate, yprof = cyl_profile(yard_run, fl, ystate, ybest, CYL_YARD)
        del ystate
        plain = {}
        errs["cyl_pass", nm].append(cyl_pass_equal(
            K, f"{nm} 2048² k=4", state, fl, run.step4.rows, 4, K.consts(cfg), False, mode,
            (1, 2 ** 31) if mode == "sr" else None, twin=plain))
        fx, fy = CY.drag_lift(dict(state, f=K.f_from_storage(state["f"], mode)), fl, cfg)
        print(f"  drag_lift after {23 + 20 + 4 * 600} steps: Fx {float(fx):.6g} "
              f"Fy {float(fy):.6g}", flush=True)
        if not (abs(float(fx)) < float("inf") and abs(float(fy)) < float("inf")):
            fail(f"{nm}: drag_lift not finite")
        print(f"cylinder kernels alone at {H}x{W} in {nm} storage:", flush=True)
        alone = cyl_alone(K, cfg, run, state, fl, rate, mode,
                          (1, 2 ** 31) if mode == "sr" else None, plain=plain)
        report[nm] = {"windows": windows, "best": best, "profile": prof,
                      "drag_lift": [float(fx), float(fy)], "per_launch": alone,
                      "yardstick": {"windows": ywin, "best": ybest, "profile": yprof}}
        for k in CYL:
            src, rep = SOURCE[k]
            e = errs[k, nm]
            rows.append({
                "name": f"{k}/{nm}", "route": "cuda", "source": src, "replaces": rep,
                "launches": path[nm][k], "max_abs_err": max(e) if e else None,
                "ms": alone[k]["ms"], "plain_ms": alone[k]["plain_ms"],
                "bound_ms": alone[k]["bound_ms"], "bound_by": alone[k]["bound_by"],
                "library_ms": None,
            })
        del state, got
    f32_best = f32_report["best"]["us_per_step"]
    print("2048² best us/step: f32 " + f"{f32_best:.3f}, " + ", ".join(
        f"{nm} {report[nm]['best']['us_per_step']:.3f}" for _, nm in CYL_STORAGE), flush=True)

    # ---- (c) the shedding gate ----
    def committed(name):
        with open(os.path.join(RESULTS, name)) as fo:
            return json.load(fo)

    anchor = committed("mini_shedding_anchor.json")
    jax_runs = {case: committed(f"cylinder_shedding_{case}.json")
                for case in ("lowblock", "b025_bf16", "b025_bf16sr")}
    gate = {}
    for case in ("mini", "lowblock", "b025_bf16sr", "b025_bf16"):
        mode = shedding.CASES[case]["bf16_dev"]
        nm = dict(CYL_STORAGE).get(mode, "f32")
        torch.cuda.synchronize()
        kernels.reset_launches()
        res = shedding.run_case(case, dev, seed=7)
        torch.cuda.synchronize()
        counts = mode_counts(nm) if nm != "f32" else {k: kernels.launches()[k] for k in CYL}
        if not counts["cyl_pass"] or any(counts[k] for k in CYL_YARD):
            fail(f"shedding {case}: the k-step passes did not run through cyl_pass: {counts}")
        if nm != "f32":
            for k in CYL:
                path[nm][k] += counts[k]
        series = res.pop("series")
        res["launches"] = counts
        gate[case] = res
        print(f"shedding {case} ({nm}, {res['steps']} steps in {res['wall_s']:.1f} s): "
              f"St {res['strouhal']:.4f} Cd {res['cd_mean']:.4f} Cl_rms {res['cl_rms']:.4f} "
              f"Cl_mean {res['cl_mean']:.4f} u_eff {res['u_eff']:.5f} "
              f"Re_eff {res['re_cylinder_effective']:.1f} launches {counts}", flush=True)
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        np.savez(os.path.join(HERE, "chiprun_out", f"cylinder_shedding_{case}_series.npz"),
                 **series)

    # the yardstick: f32 and SR through the three launches a pass and
    # through cyl_pass, each run cut to its first steps, the same sampled
    # series bit for bit
    cut = dict(warmup=SHED_YARD_WARMUP, n_samples=SHED_YARD_SAMPLES)
    for case in ("lowblock", "b025_bf16sr"):
        mine = shedding.run_case(case, dev, seed=7, **cut)
        torch.cuda.synchronize()
        kernels.reset_launches()
        res = shedding.run_case(case, dev, seed=7, route="launches", **cut)
        torch.cuda.synchronize()
        counts = {k: kernels.launches()[k] for k in CYL}
        if counts["cyl_pass"] or not all(counts[k] for k in CYL_YARD):
            fail(f"shedding {case} yardstick: not the three launches: {counts}")
        series, mine_series = res.pop("series"), mine.pop("series")
        res["launches"] = counts
        gate[f"{case} three launches"] = res
        same = all(np.array_equal(series[x], mine_series[x]) for x in ("cl", "cd", "u_probe"))
        print(f"shedding {case} cut to {res['steps']} steps through the three launches "
              f"({res['wall_s']:.1f} s, cyl_pass {mine['wall_s']:.1f} s): Cl, Cd and probe "
              f"series {'bit for bit' if same else 'DIFFERENT'}", flush=True)
        if not same:
            fail(f"shedding {case}: cyl_pass and the three launches give other series")

    def held(case, ref, tag, st_tol):
        r = gate[case]
        checks = {"St": (r["strouhal"], ref["St"], abs(r["strouhal"] - ref["St"]) <= st_tol),
                  "Cd": (r["cd_mean"], ref["Cd"], abs(r["cd_mean"] - ref["Cd"]) <= 0.04 * ref["Cd"]),
                  "Cl_rms": (r["cl_rms"], ref["Cl_rms"],
                             abs(r["cl_rms"] - ref["Cl_rms"]) <= 0.10 * ref["Cl_rms"])}
        for key, (v, want, ok) in checks.items():
            print(f"  gate {case} {key}: {v:.4f} vs {tag} {want:.4f} "
                  f"{'held' if ok else 'MISSED'}", flush=True)
        return [f"{case} {key}" for key, (_, _, ok) in checks.items() if not ok]

    def ref_of(r):
        return {"St": r["strouhal"], "Cd": r["cd_mean"], "Cl_rms": r["cl_rms"]}

    missed = held("mini", {"St": anchor["St"], "Cd": anchor["Cd_mean"],
                           "Cl_rms": anchor["Cl_rms"]}, "anchor", 0.01)
    if not abs(gate["mini"]["cl_mean"]) < 0.05:
        missed.append("mini Cl_mean")
    missed += held("lowblock", ref_of(jax_runs["lowblock"]), "JAX f32", 0.012)
    missed += held("b025_bf16sr", ref_of(gate["lowblock"]), "port f32", 0.012)
    rn, jrn = gate["b025_bf16"], jax_runs["b025_bf16"]
    print(f"  b025_bf16 (round to nearest, no gate): St {rn['strouhal']:.4f} Cd "
          f"{rn['cd_mean']:.4f} Cl_rms {rn['cl_rms']:.4f}; JAX's committed run St "
          f"{jrn['strouhal']:.4f} Cd {jrn['cd_mean']:.4f} Cl_rms {jrn['cl_rms']:.4f}; port f32 "
          f"Cl_rms {gate['lowblock']['cl_rms']:.4f}", flush=True)
    report["shedding"] = gate
    report["shedding_missed"] = missed
    if missed:
        fail(f"shedding gate missed: {missed}")
    for row in rows:  # the gate runs are on the main path too
        k, nm = row["name"].split("/")
        row["launches"] = path[nm][k]
    return rows, report


# ---------------------------------------------------------------------------
# The shear layer (kernels/periodic.py)
# ---------------------------------------------------------------------------

# (collision, kbc_type) of the seven kernel instances: BGK, MRT, and KBC
# in its five types (0 = LBGK, then KBC_A .. KBC_D)
SHEAR_RELAXES = (("bgk", None), ("mrt", None), ("kbc", 0), ("kbc", 0b10000101),
                 ("kbc", 0b10000110), ("kbc", 0b10001001), ("kbc", 0b10001010))
SHEAR_TIMED = (("bgk", None), ("mrt", None), ("kbc", 0b10000101))
# float32 operations per cell, counted by hand from csrc/periodic.cu
# (moments and equilibrium ~66, then the relaxation; a division as one)
SHEAR_FLOPS = {"bgk": 95, "mrt": 175, "kbc": 440}
SHEAR_BYTES_PER_CELL = 84  # 9 f planes in; 9 f, rho and 2 vel planes out
SHEAR_DEMO, SHEAR_MAIN = (130, 130), (2048, 2048)


def shear_label(collision, kbc_type):
    return collision if kbc_type is None else f"kbc {kbc_type:#b}"


def shear_phases(dev, rate, errs):
    """The shear layer: (a) each of the seven instances of ``periodic``
    against its twin after one launch from a seeded noisy state, at 130²
    and 2048² (1e-6); (b) the kernel runner against the twin runner at 130²
    (MRT and KBC_A 1000 steps; BGK and LBGK 400, or 1000 where 400 agree
    bit for bit) and at 2048² (50 steps, all seven): f and rho 2e-5, vel
    2e-4; (c) the main path, ``shear_main.run_shear`` at the demo default
    130² for 1000 steps with BGK (the demo), MRT (the reference "KBC" demo)
    and KBC_A, counts zeroed just before each and read just after:
    ``periodic`` exactly 1000 launches and no other kernel, mass within
    rtol 1e-4 of H W density, finite fields; (d) 2048² windows for BGK,
    MRT and KBC_A (20 warm-up steps, best of three 600-step windows by CUDA
    events, a profiled window: busy share, device µs per launch; the twin
    per call); (e) the same at 130² (host-bound). Returns the ``kernels``
    row and a report."""
    import torch
    from unittest import mock

    from jrl_lbm_torch import kernels, shear_main
    from jrl_lbm_torch.kernels import periodic as P
    from jrl_lbm_torch.models import shear_layer as SL
    from jrl_lbm_torch.utils import metrics

    report = {}
    TOL = {"f": 2e-5, "rho": 2e-5, "vel": 2e-4}

    def cfg_of(res, collision, kbc_type):
        return SL.ShearLayerConfig(res=res, collision=collision, kbc_type=kbc_type)

    def outs(s):
        return {k: torch.full_like(v, 7.0) for k, v in s.items()}

    def twin_run(run, s, fl, n):
        with mock.patch.object(P, "periodic", P.periodic_ref):
            return run(s, fl, n)

    # ---- (a) one launch of each instance against the twin ----
    for res in (SHEAR_DEMO, SHEAR_MAIN):
        print(f"compare periodic instances with the twin, one launch at {res[0]}x{res[1]}",
              flush=True)
        for collision, kt in SHEAR_RELAXES:
            cfg = cfg_of(res, collision, kt)
            s = noisy(SL.init(cfg, dev)[0], dev, 9, scale=1e-4)
            got, want = outs(s), outs(s)
            n0 = P.periodic.launches
            P.periodic(s["f"], got, P.consts(cfg))
            P.periodic_ref(s["f"], want, P.consts(cfg))
            torch.cuda.synchronize()
            if P.periodic.launches != n0 + 1:
                fail("periodic did not count its launch")
            for nm in ("f", "rho", "vel"):
                check_close(f"periodic {shear_label(collision, kt)} {nm}", got[nm], want[nm],
                            1e-6, errs["periodic"])

    # ---- (b) the runner against the twin runner ----
    def compare_runner(res, collision, kt, n, extend_if_exact=False):
        cfg = cfg_of(res, collision, kt)
        s, fl = SL.init(cfg, dev)
        run = P.make_fused_periodic_runner(cfg)
        got, want = run(s, fl, n), twin_run(run, s, fl, n)
        exact = all(torch.equal(got[k], want[k]) for k in got)
        if extend_if_exact and exact:
            got, want = run(got, fl, 1000 - n), twin_run(run, want, fl, 1000 - n)
            n = 1000
            exact = all(torch.equal(got[k], want[k]) for k in got)
        tag = f"{res[0]}x{res[1]} {shear_label(collision, kt)} {n} steps"
        for nm in ("f", "rho", "vel"):
            check_close(f"runner {tag} {nm}", got[nm], want[nm], TOL[nm], errs["periodic"])
        report.setdefault("runner", {})[tag] = {"steps": n, "bit_for_bit": exact}
        print(f"  runner {tag}: bit for bit {exact}", flush=True)

    print("periodic runner against the twin runner", flush=True)
    for collision, kt in (("mrt", None), ("kbc", 0b10000101)):
        compare_runner(SHEAR_DEMO, collision, kt, 1000)
    for collision, kt in (("bgk", None), ("kbc", 0)):
        # the BGK demo turns chaotic between steps 500 and 600: beyond
        # that, two codes that round differently part completely
        compare_runner(SHEAR_DEMO, collision, kt, 400, extend_if_exact=True)
    for collision, kt in SHEAR_RELAXES:
        compare_runner(SHEAR_MAIN, collision, kt, 50)

    # ---- (c) the main path: run_shear at the demo default ----
    H, W = SHEAR_DEMO
    path_launches = 0
    print(f"main path: shear_main.run_shear at {H}x{W}, 1000 steps, dump every 10", flush=True)
    for collision, kt in SHEAR_TIMED:
        cfg = cfg_of(SHEAR_DEMO, collision, kt)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, dumps = shear_main.run_shear(cfg, 1000, 10, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in kernels.launches().items() if v}
        if counts != {"periodic": 1000}:
            fail(f"run_shear {collision} launched {counts}, expected periodic 1000 times")
        path_launches += counts["periodic"]
        m = float(metrics.mass(state["f"]))
        stats = metrics.field_stats(state)
        rel = abs(m / (H * W * cfg.density) - 1.0)
        print(f"  {shear_label(collision, kt)}: {wall:.3f} s with {len(dumps)} vorticity dumps, "
              f"launches {counts}, mass {m:.7g} (rel {rel:.2e}), vel in "
              f"[{stats['vel_min']:.4f}, {stats['vel_max']:.4f}]", flush=True)
        if rel > 1e-4 or not all(v for k, v in stats.items() if k.endswith("_finite")):
            fail(f"run_shear {collision}: mass off by {rel:.2e} or fields not finite")
        report.setdefault("run_shear", {})[shear_label(collision, kt)] = {
            "s": wall, "launches": counts, "mass_rel": rel, "stats": stats}

    # ---- (d), (e) timed windows at 2048² and 130² ----
    timed = {}
    for res, n in ((SHEAR_MAIN, 600), (SHEAR_DEMO, 1000)):
        cells = res[0] * res[1]
        for collision, kt in SHEAR_TIMED:
            cfg = cfg_of(res, collision, kt)
            s, fl = SL.init(cfg, dev)
            run = P.make_fused_periodic_runner(cfg)
            s = run(s, fl, 20)  # warm-up
            windows = []
            for _ in range(3):
                torch.cuda.synchronize()
                kernels.reset_launches()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                s = run(s, fl, n)
                end.record()
                torch.cuda.synchronize()
                counts = {k: v for k, v in kernels.launches().items() if v}
                if counts != {"periodic": n}:
                    fail(f"{collision} window launched {counts}")
                windows.append(start.elapsed_time(end) * 1e3 / n)
            best = min(windows)
            box = {"s": s}

            def prof_run(k):
                box["s"] = run(box["s"], fl, k)

            times, wall = device_profile(prof_run, n)
            busy = sum(times.values())
            us_launch = (sum(t for nm, t in times.items() if KERNEL_FUNCS["periodic"][0] in nm)
                         / n if wall else None)
            c = P.consts(cfg)
            o = outs(s)
            plain_ms = cuda_ms(lambda: P.periodic_ref(s["f"], o, c), 3, warmup=1)
            mem_ms = SHEAR_BYTES_PER_CELL * cells / rate * 1e3
            ops_ms = SHEAR_FLOPS[collision] * cells / F32_PEAK * 1e3
            rec = {"us_per_step": best, "windows_us_per_step": windows,
                   "mlups": cells / best, "launches_per_window": n,
                   "busy_share": busy / (wall * 1e6) if wall else None,
                   "device_us_per_launch": us_launch, "plain_ms": plain_ms,
                   "mem_ms": mem_ms, "ops_ms": ops_ms}
            timed[f"{res[0]}x{res[1]} {shear_label(collision, kt)}"] = rec
            busy_s = f"{rec['busy_share']:.1%}" if wall else "not measured"
            if wall and rec["busy_share"] < 0.5:
                busy_s += ", host-bound"
            dev_s = f"{us_launch:.2f}" if us_launch else "not measured"
            print(f"  {res[0]}x{res[1]} {shear_label(collision, kt):4s}: best of 3 {best:.3f} "
                  f"us/step ({', '.join(f'{w:.3f}' for w in windows)}), {cells / best:.1f} MLUPS, "
                  f"busy {busy_s}, device {dev_s} us/launch, bound "
                  f"{max(mem_ms, ops_ms) * 1e3:.2f} us ({'bytes' if mem_ms >= ops_ms else 'operations'}), "
                  f"twin {plain_ms:.3f} ms/call", flush=True)
            if not all(torch.isfinite(v).all() for v in s.values()):
                fail(f"{res} {collision}: state not finite after the windows")
    report["timed"] = timed

    main_recs = [timed[f"{SHEAR_MAIN[0]}x{SHEAR_MAIN[1]} {shear_label(c_, k_)}"]
                 for c_, k_ in SHEAR_TIMED]
    n = len(main_recs)  # per launch at 2048², the mean of BGK, MRT and KBC_A
    # device time per launch from the profiler; where a trace holds none,
    # the CUDA-event time per step of the windows, and the row says so
    time_from = "profiler" if all(r["device_us_per_launch"] for r in main_recs) else "events"
    key = "device_us_per_launch" if time_from == "profiler" else "us_per_step"
    ms = sum(r[key] / 1e3 for r in main_recs) / n
    report["periodic_ms_from"] = time_from
    print(f"  periodic row: {ms * 1e3:.2f} us per launch at 2048² from the {time_from}", flush=True)
    mem_ms = sum(r["mem_ms"] for r in main_recs) / n
    ops_ms = sum(r["ops_ms"] for r in main_recs) / n
    row = {
        "name": "periodic", "route": "cuda", "source": "jrl_lbm_torch/kernels/csrc/periodic.cu",
        "replaces": "jrl_lbm_tpu/ops/pallas/fused_periodic.py:112", "launches": path_launches,
        "max_abs_err": max(errs["periodic"]) if errs["periodic"] else None, "ms": ms,
        "plain_ms": sum(r["plain_ms"] for r in main_recs) / n,
        "bound_ms": max(mem_ms, ops_ms), "bound_by": "bytes" if mem_ms >= ops_ms else "operations",
        "library_ms": None, "time_from": time_from,
    }
    return [row], report


# ---------------------------------------------------------------------------
# The JRL fluid phase above 131,072 cells: the tile classes (kernels/jrl_tiled.py)
# ---------------------------------------------------------------------------

TILE_KS = (1, 2, 4)


def tiled_twin_runner(run):
    """``run`` (a tiled runner) with every kernel call replaced by its twin."""
    from unittest import mock

    from jrl_lbm_torch.kernels import jrl_fluid
    from jrl_lbm_torch.kernels import jrl_tiled as JT

    twins = dict(fluid_k=JT.fluid_k_ref, fluid_k_lean=JT.fluid_k_lean_ref,
                 fluid_k_bt=JT.fluid_k_bt_ref, fluid_pass=JT.fluid_pass_ref,
                 fluid_a=jrl_fluid.fluid_a_ref, fluid_b=jrl_fluid.fluid_b_ref)

    def twin_run(state, fields, start, n):
        with mock.patch.multiple(JT, **twins):
            return run(state, fields, start, n)

    return twin_run


def noisy(state, dev, seed, scale=1e-3):
    """``state`` plus seeded noise, so that every cell differs from its
    neighbours."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return {k: v + scale * torch.randn(v.shape, generator=g, device=dev) for k, v in state.items()}


def split_step(JT, cfg, k: int, want_bt: bool):
    """``(step, fr, fb)``: the first step (a multiple of 8) whose k-step
    pass has lean tiles and, with ``want_bt``, below-tip tiles."""
    c = JT.tile_consts(cfg)
    TH = JT.pick_tile_rows(cfg)
    n = c["H"] // TH
    s = 0
    while True:
        fr = JT.frontier(c, TH, k, s + k)
        fb = min(JT.below(c, TH, k, s), fr)
        if fr < JT.lean_last(n, TH, k) and (fb >= 1 or not want_bt):
            return s, fr, fb
        s += 8
        if s > cfg.total_steps:
            fail(f"{cfg.shape} {c['H']}x{c['W']}: no step with the tile classes wanted")


def tile_bytes(name: str, segs, k: int, H: int, W: int):
    """``(bytes, cells)`` of one launch: each input row once (the rows of
    the segments and their 2k-row halos, mod H), each output row once."""
    read = set()
    for y0, y1 in segs:
        read.update(y % H for y in range(y0 - 2 * k, y1 + 2 * k))
    rows = sum(y1 - y0 for y0, y1 in segs)
    planes_in = 9 if name == "fluid_k_lean" else 12
    return 4 * W * (planes_in * len(read) + 12 * rows), rows * W


def pass_bytes(full, lean, H: int, W: int):
    """``(bytes, ops)`` of one ``fluid_pass`` launch: each input row
    once (12 planes where a full segment's 2-row halo window reaches it, 9
    where only a lean one's does), 12 planes out a written row; the
    operations of the full class's cells and of the lean class's."""
    reach = {}
    for segs, planes in ((lean, 9), (full, 12)):
        for y0, y1 in segs:
            for y in range(y0 - 2, y1 + 2):
                reach[y % H] = max(reach.get(y % H, 0), planes)
    nf, nl = (sum(y1 - y0 for y0, y1 in segs) for segs in (full, lean))
    ops = (FLOPS_PER_CELL["fluid_k"] * nf + FLOPS_PER_CELL["fluid_k_lean"] * nl) * W
    return 4 * W * (sum(reach.values()) + 12 * (nf + nl)), ops


def pass_equal(JT, tag, cfg, s, step: int, full, lean, errs):
    """One ``fluid_pass`` launch against its twin (1e-5) and against
    ``fluid_k`` + ``fluid_k_lean`` on the same rows, bit for bit."""
    import torch

    got, want, cls = ({key: torch.full_like(v, 7.0) for key, v in s.items()} for _ in range(3))
    n0 = JT.fluid_pass.launches
    JT.fluid_pass(s["f"], s["rho"], s["vel"], got, full, lean, step, cfg)
    JT.fluid_pass_ref(s["f"], s["rho"], s["vel"], want, full, lean, step, cfg)
    JT.fluid_k(s["f"], s["rho"], s["vel"], cls, full, step, 1, cfg)
    if lean:
        JT.fluid_k_lean(s["f"], cls, lean, 1, cfg)
    torch.cuda.synchronize()
    if JT.fluid_pass.launches != n0 + 1:
        fail("fluid_pass did not count its launch")
    for nm in ("f", "rho", "vel"):
        check_close(f"fluid_pass {tag} {nm}", got[nm], want[nm], 1e-5, errs["fluid_pass"])
    same = all(torch.equal(got[nm], cls[nm]) for nm in got)
    diff = max(float((got[nm] - cls[nm]).abs().max()) for nm in got)
    print(f"  fluid_pass {tag}: bit for bit fluid_k + fluid_k_lean: {same} (max |diff| "
          f"{diff:.3e})", flush=True)
    if not same:
        fail(f"fluid_pass {tag}: differs from fluid_k + fluid_k_lean")


# the default refine-8 case's split-pass plans: the travel's first step,
# its middle (825,712,484) and its last split steps (1,651,000,000)
PASS_PLAN_STEPS = (0, 825_712_484, 1_651_000_000)


def tiled_checks(dev, fluid_cfg, errs):
    """The tile-class kernels at 1024x512 against their twins: (a) each
    kernel after one launch at k = 1, 2, 4 on the refine-8 ethaline grid
    (step 0: full and lean tiles) and on a flat tip of the same size (a
    step with below-tip tiles too), 1e-5; ``fluid_pass`` against its twin
    (1e-5) and the two classes (bit for bit) on those plans, on the
    default refine-8 case's plans of ``PASS_PLAN_STEPS`` and at each step
    2**24 - 5 .. 2**24 + 4; (b) the tiled runner against the twin runner
    and the per-step kernels over 110 steps that cross a tip row and a
    frontier change (at k = 1 also against the runner through the
    classes, bit for bit), and over steps 2**24 - 5 .. 2**24 + 4 at k = 1
    and k = 4 (f, rho 2e-5; vel 2e-4). Returns a report."""
    import torch

    from jrl_lbm_torch import kernels
    from jrl_lbm_torch.kernels import jrl_tiled as JT
    from jrl_lbm_torch.models import jrl as T

    TOL = {"f": 2e-5, "rho": 2e-5, "vel": 2e-4}
    report = {}
    configs = {"ethaline 1024x512": fluid_cfg("ethaline", 8),
               "cylinder 1024x512": fluid_cfg("cylinder", 1, res=(1024, 512))}

    def compare_runs(tag, cfg, s, fields, start, n, k=1):
        run = JT.make_tiled_fluid_runner(cfg, k=k)
        torch.cuda.synchronize()
        kernels.reset_launches()
        got = run(s, fields, start, n)
        torch.cuda.synchronize()
        used = [name for name, c in kernels.launches().items() if c]
        want = tiled_twin_runner(run)(s, fields, start, n)
        per = T.make_per_step_fluid_runner(cfg)(s, fields, start, n)
        for nm in ("f", "rho", "vel"):
            rep = []
            check_close(f"{tag} vs twin runner {nm}", got[nm], want[nm], TOL[nm], rep)
            check_close(f"{tag} vs fluid_a/fluid_b {nm}", got[nm], per[nm], TOL[nm], [])
            for name in used:
                errs[name].extend(rep)
        print(f"  {tag}: launches {dict((k_, c) for k_, c in kernels.launches().items() if c)}",
              flush=True)
        return used, got

    for label, cfg in configs.items():
        H, W = cfg.eff_res
        flat = cfg.shape in T.FLAT_SHAPES
        s, fields = T.fluid_init(cfg, dev)
        s = noisy(s, dev, 11)
        for k in TILE_KS:
            step, fr, fb = split_step(JT, cfg, k, flat)
            full, bt, lean = JT.class_rows(H, JT.pick_tile_rows(cfg), k, fr, fb)
            print(f"compare tile kernels with twins: {label}, k={k}, step {step}: full rows "
                  f"{full}, below-tip {bt}, lean {lean}", flush=True)
            calls = [("fluid_k", lambda fn, o: fn(s["f"], s["rho"], s["vel"], o, full, step, k,
                                                  cfg), JT.fluid_k_ref),
                     ("fluid_k_lean", lambda fn, o: fn(s["f"], o, lean, k, cfg),
                      JT.fluid_k_lean_ref)]
            if bt:
                calls.append(("fluid_k_bt", lambda fn, o: fn(s["f"], s["rho"], s["vel"], o, bt,
                                                             k, cfg), JT.fluid_k_bt_ref))
            elif flat:
                fail(f"{label} k={k}: no below-tip tiles at step {step}")
            for name, call, twin in calls:
                got = {key: torch.full_like(v, 7.0) for key, v in s.items()}
                want = {key: torch.full_like(v, 7.0) for key, v in s.items()}
                n0 = getattr(JT, name).launches
                call(getattr(JT, name), got)
                call(twin, want)
                torch.cuda.synchronize()
                if getattr(JT, name).launches != n0 + 1:
                    fail(f"{name} did not count its launch")
                for nm in ("f", "rho", "vel"):
                    check_close(f"{name} k={k} 1 launch {nm}", got[nm], want[nm], 1e-5,
                                errs[name])
            if k == 1:
                pass_equal(JT, f"{label} step {step}", cfg, s, step, full, lean, errs)

        # (b) 110 steps across a tip row and a frontier change
        c, TH, n = JT.tile_consts(cfg), JT.pick_tile_rows(cfg), 110
        start = split_step(JT, cfg, 1, flat)[0]
        while JT.frontier(c, TH, 1, start + n) == JT.frontier(c, TH, 1, start):
            start += 50
        rows = [T.tip_walks(cfg.inflow_height, x, cfg.vel_obs)[1] for x in (start, start + n)]
        print(f"tiled runner {label}: steps {start} .. {start + n - 1}, tip row {rows[0]} -> "
              f"{rows[1]}, frontier tile {JT.frontier(c, TH, 1, start + 8)} -> "
              f"{JT.frontier(c, TH, 1, start + n)}", flush=True)
        if rows[1] <= rows[0]:
            fail(f"{label}: the runner check crosses no tip row")
        used, got = compare_runs(f"{label} {n} steps", cfg, s, fields, start, n)
        want_used = {"fluid_pass"} | ({"fluid_k_bt"} if flat else set())
        if set(used) - {"fluid_a", "fluid_b"} != want_used:
            fail(f"{label}: the runner launched {used}, expected {sorted(want_used)}")
        cls = JT.make_tiled_fluid_runner(cfg, route="classes")(s, fields, start, n)
        same = all(torch.equal(got[nm], cls[nm]) for nm in got)
        print(f"  {label} {n} steps: through fluid_pass = through the classes, bit for bit: "
              f"{same}", flush=True)
        if not same:
            fail(f"{label}: the runner through fluid_pass differs from it through the classes")
        report[label] = {"runner_start": start, "runner_steps": n, "launched": used}

    print("fluid_pass on the default refine-8 case's split plans", flush=True)
    cfg = T.JRLFluidConfig(shape="ethaline", refine=8)
    H, W = cfg.eff_res
    s = noisy(T.fluid_init(cfg, dev)[0], dev, 12)
    report["pass_plans"] = {}
    for step in PASS_PLAN_STEPS:
        kind, _, _, fr, fb = JT.chunk_plan(cfg, step, 8)[0]
        full, bt, lean = JT.class_rows(H, JT.pick_tile_rows(cfg), 1, fr, fb)
        if kind != "split" or bt or not lean:
            fail(f"step {step}: plan {kind} {full} {bt} {lean}, expected full and lean rows")
        pass_equal(JT, f"step {step} full {full} lean {lean}", cfg, s, step, full, lean, errs)
        nbytes, ops = pass_bytes(full, lean, H, W)
        report["pass_plans"][step] = {"full": full, "lean": lean, "bytes": nbytes, "ops": ops}

    print("tiled fluid steps 2**24 - 5 .. 2**24 + 4 at 1024x512", flush=True)
    cfg = fluid_cfg("ethaline", 8, Re=1.2e-5, vel_obs_real=28e-6)
    start = 2**24 - 5
    if not 1 < T.tip_walks(cfg.inflow_height, start + 10, cfg.vel_obs)[1] < cfg.eff_res[0] - 1:
        fail("the tip leaves the grid in the 2**24 check")
    s, fields = T.fluid_init(cfg, dev)
    s = noisy(s, dev, 24)
    for k in (1, 4):
        compare_runs(f"2**24 k={k}", cfg, s, fields, start, 10, k=k)
    H = cfg.eff_res[0]
    for step in range(start, start + 10):
        kind, _, _, fr, fb = JT.chunk_plan(cfg, step, 1)[0]
        full, _, lean = JT.class_rows(H, JT.pick_tile_rows(cfg), 1, fr, fb)
        pass_equal(JT, f"step {step}", cfg, s, step, full, lean, errs)
    return report


# ---------------------------------------------------------------------------
# The JRL case on a mesh of shards (kernels/jrl_sharded.py)
# ---------------------------------------------------------------------------

SHARDED = ("fluid_a_sh", "fluid_b_sh", "fluid_pass_sh", "fluid_pass_sh_cols", "c_balance_sh",
           "c_approach_sh", "c_balance_pass_sh", "c_approach_pass_sh", "c_balance_pass_sh_cols",
           "c_approach_pass_sh_cols", "halo_pack")
# the per-step kernels: the yardstick (route="launches") of every phase on
# every mesh since the C passes' column instances
SH_YARDSTICKS = ("fluid_a_sh", "fluid_b_sh", "c_balance_sh", "c_approach_sh")
# the kernels the main path must launch
SH_PATH = tuple(k for k in SHARDED if k not in SH_YARDSTICKS)
# the k-step passes of a shard: the kernel of each kind (jrl_sharded.PASS_LIBS)
# and its column instance, counted by the kind's wrapper: its launches on a
# column mesh (nx > 1) are the column instance's
SH_PASSES = ("fluid_pass_sh", "fluid_pass_sh_cols", "c_balance_pass_sh", "c_approach_pass_sh",
             "c_balance_pass_sh_cols", "c_approach_pass_sh_cols")
# the kernels each phase's route launches on every shard
SH_ROUTE_KERNELS = {("fluid", "pass"): {"fluid_pass_sh"},
                    ("fluid", "launches"): {"fluid_a_sh", "fluid_b_sh"},
                    ("balance", "pass"): {"c_balance_pass_sh"},
                    ("balance", "launches"): {"c_balance_sh"},
                    ("approach", "pass"): {"c_approach_pass_sh"},
                    ("approach", "launches"): {"c_approach_sh"}}
SH_MESHES = ((1, 1), (4, 1), (2, 2))
# the meshes whose every shard stage (a) holds to the pass's twin and the
# pair beside the main path's: (2, 1) and (1, 2)
SH_CHECK_MESHES = ((2, 1), (1, 2))
SH_STEPS = 200
# planes each sharded launch reads and writes in its shard's body, and the
# planes of its halo group (kernels/halo.py)
SH_PLANES = {"fluid_a_sh": (12, 12, 11), "fluid_b_sh": (12, 9, 3), "c_balance_sh": (11, 10, 10),
             "c_approach_sh": (12, 10, 10)}


def c_pass_bytes(kind: str, sh, k: int) -> int:
    """Bytes a k-step C pass of shard ``sh`` must move, whatever k: its
    planes in and out once (the balance h, C and the flags in, h and C out;
    the approach h, the base flags and the two frames' u and v in, h and C
    out), and the same input planes on its 2k-row pieces a side (a mesh of
    one row: none) and, on a column mesh, on its 2k lanes a side of the rows
    extended by 2k, cut to the grid (the blocks' lanes past 2k not counted;
    the approach's frame lanes among them)."""
    p_in, p_out = (11, 10) if kind == "balance" else (14, 10)
    rows = sh.h + 4 * k if sh.h < sh.H else sh.h
    lanes = min(sh.col0 + sh.w + 2 * k, sh.W) - max(sh.col0 - 2 * k, 0) if sh.w < sh.W else sh.w
    return 4 * (p_in * rows * lanes + p_out * sh.h * sh.w)


def sh_bytes(k: str, sh) -> int:
    """Bytes one launch of sharded kernel ``k`` must move on shard ``sh``:
    its body planes in and out once, and its halo pieces in (two rows a
    plane on a mesh of >1 row, two (h+2) x xh blocks on one of >1 column)."""
    p_in, p_out, p_halo = SH_PLANES[k]
    halo = p_halo * ((2 * sh.w if sh.h < sh.H else 0) + 2 * (sh.h + 2) * sh.xh)
    return 4 * ((p_in + p_out) * sh.h * sh.w + halo)


def cpu_halo(hx):
    """A shard's halo row pieces and column blocks copied to the CPU (a
    twin's inputs); None without either."""
    from jrl_lbm_torch.kernels import halo as HA

    if hx.top is None and hx.left is None:
        return None
    return HA.Halo(hx.P, *(None if t is None else t.cpu()
                           for t in (hx.top, hx.bot, hx.left, hx.right)), k=hx.k)


def inst_of(kname: str, nx: int) -> str:
    """The row a sharded wrapper's launches count to: a pass's on a column
    mesh (nx > 1) are its column instance's."""
    passes = ("fluid_pass_sh", "c_balance_pass_sh", "c_approach_pass_sh")
    return f"{kname}_cols" if kname in passes and nx > 1 else kname


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def kernel_us(fn, names, reps: int = 50):
    """Device µs per call of ``fn()`` in the CUDA functions ``names``, from
    a profiled run of ``reps`` calls (None without device times)."""
    times, _ = device_profile(lambda r: [fn() for _ in range(r)], reps)
    us = sum(t for nm, t in times.items() if any(x in nm for x in names))
    return us / reps if us > 0 else None


def sharded_phases(dev, rate, errs):
    """The JRL ethaline case at refine 8 (1024x512, Re 4, Pe 5) on the
    meshes (1, 1), (4, 1) and (2, 2) of the one card (a local mesh, every
    shard on ``dev``): (a) each sharded kernel and halo_pack against its
    twin, one launch on every shard (1e-5, vel 1e-4; the disk terms rtol
    2e-4 / atol 1e-4; halo_pack bit for bit), the lean pair on the (4, 1)
    shards above the tip; on these meshes and on (2, 1) and (1, 2)
    fluid_pass_sh at k = 1..4 (on a column mesh its column instance)
    bit for bit k steps of the pair (and at k = 1, 4 its twin); the C passes at
    k = 1..4 (on (2, 2) and (1, 2) their column instances) against k
    per-step launches and their twins (check_c_pass);
    (b) the main path: the three sharded runners over 200 steps each (the
    fluid across tip rows, the approach across stored-velocity frames and
    tip rows; each through its pass on every mesh),
    counts zeroed just before each and read just after, against the
    unsharded per-step runners: f, rho, vel, h, C bit for bit, the
    integrals at rtol 2e-4 / atol 1e-4; µs/step, busy share, launches and
    exchanges a step beside the per-step runners' and each phase's
    yardsticks (each phase's ``route="launches"`` on every mesh; on the row
    meshes each pass at the other of k = 1 and 4 too)
    through the same checks (on one card this measures the halo exchange
    and the launches, not multi-card scaling); (c) the (1, 1) mesh once
    more through a one-rank NCCL process group (psum through all_reduce),
    bit for bit the local mesh; (d) the passes alone at k = 1..4, L2
    flushed. Returns the eleven kernels' rows (each pass's column instance
    a row of its own, its launches those of its kind's wrapper on the (2,
    2) main path; the per-step kernels, yardsticks, with none) and a
    report."""
    for name in ("fluid_pass_sh_cols", "c_balance_pass_sh_cols", "c_approach_pass_sh_cols"):
        errs.setdefault(name, [])
    from unittest import mock

    import torch
    import torch.distributed as dist

    from jrl_lbm_torch import kernels
    from jrl_lbm_torch.kernels import halo as HA
    from jrl_lbm_torch.kernels import jrl_sharded as S
    from jrl_lbm_torch.models import jrl as T
    from jrl_lbm_torch.parallel import multihost
    from jrl_lbm_torch.parallel.mesh import make_mesh, process_mesh, split

    fc = T.JRLFluidConfig(res=(128, 64), Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8,
                          shape="ethaline", refine=8)
    cc = T.JRLCConfig(res=(128, 64), Re=4.0, Pe=5.0, vel_obs_real=0.2848, shape="ethaline",
                      refine=8)
    H, W = fc.eff_res
    cells = H * W
    n = SH_STEPS
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kind, pname_ in S.PASS_LIBS.items():
        for kp in range(1, 5):
            regs, local = S.pass_sh_info(kp, kind=kind)
            print(f"  {pname_} k={kp}: {regs} registers, {local} local bytes", flush=True)
            if local:
                fail(f"{pname_} k={kp} spills: {local} local bytes")
            for mshape, co in (((4, 1), (1, 0)), ((1, 1), (0, 0))):
                plan = S.pass_sh_plan(S.Shard.of(H, W, mshape, co), kp, sms, kind)
                shape_ = S.pass_sh_tile_shape(kp, plan.rmax, plan.smax, kind=kind)
                want = (S.TILE_THREADS, S.TILE_SMEM_CAP,
                        S.pass_tile_bytes(kind, plan.rmax, plan.smax))
                print(f"    {mshape}: {plan}; threads, shared memory cap, a tile's bytes, "
                      f"co-resident blocks {shape_}", flush=True)
                if shape_[:3] != want or plan.grid > shape_[3]:
                    fail(f"{pname_} {mshape} k={kp}: the kernel's shape {shape_} is not the host "
                         f"plan's {want} (grid {plan.grid})")
    for kind, pname_ in S.PASS_LIBS.items():  # the column instances on the (2, 2) shards
        for kp in range(1, 5):
            regs, local = S.pass_sh_info(kp, kind=kind, cols=True)
            print(f"  {pname_} column instance k={kp}: {regs} registers, {local} local bytes",
                  flush=True)
            if local:
                fail(f"{pname_} column instance k={kp} spills: {local} local bytes")
            for co in ((0, 0), (1, 1)):
                plan = S.pass_sh_plan(S.Shard.of(H, W, (2, 2), co), kp, sms, kind)
                shape_ = S.pass_sh_tile_shape(kp, plan.rmax, plan.smax, kind=kind, cols=True)
                print(f"    (2, 2) {co}: {plan}; threads, shared memory cap, a tile's bytes, "
                      f"co-resident blocks {shape_}", flush=True)
                if shape_[:3] != (S.TILE_THREADS, S.TILE_SMEM_CAP,
                                  S.pass_tile_bytes(kind, plan.rmax, plan.smax)) \
                        or plan.grid > shape_[3]:
                    fail(f"{pname_} column instance (2, 2) {co} k={kp}: the kernel's shape "
                         f"{shape_} is not the host plan's (grid {plan.grid})")
    s0, fl = T.fluid_init(fc, dev)
    s0 = noisy(s0, dev, 71, scale=1e-4)
    st0, cf, flags = T.c_init(cc, dev)
    st0 = T.make_per_step_balance_runner(cc, flags)(st0, cf, 20)
    g = torch.Generator(device=dev).manual_seed(72)
    vf = 0.5 * torch.randn((8, 2, H, W), generator=g, device=dev)
    rows_f = [T.tip_walks(fc.inflow_height, s, fc.vel_obs)[1] for s in (0, n - 1)]
    rows_c = [T.tip_walks(cc.inflow_height, s, cc.vel_obs_conv)[1] for s in (0, n - 1)]
    frames_c = int((n - 1) * cc.vel_obs_conv / T.X_INTERVAL)
    print(f"sharded JRL {H}x{W}: {n} steps a phase; fluid tip rows {rows_f}, approach tip "
          f"rows {rows_c} across {min(frames_c, 7)} stored-frame boundaries", flush=True)
    if rows_f[1] == rows_f[0] or rows_c[1] == rows_c[0] or frames_c < 1:
        fail("the sharded phases do not cross a tip row and a stored frame")

    # the unsharded per-step runners: reference and yardstick
    per_step = {
        "fluid": lambda k: T.make_per_step_fluid_runner(fc)(s0, fl, 0, k),
        "balance": lambda k: T.make_per_step_balance_runner(cc, flags)(st0, cf, k),
        "approach": lambda k: T.make_per_step_approach_runner(cc, vf)(st0, cf, 0, k),
    }
    ref = {p: fn(n) for p, fn in per_step.items()}
    report = {"res": [H, W], "steps": n, "meshes": {}}
    main_counts = {k: 0 for k in SHARDED}
    per_launch = {}  # (kernel, mesh, instance) -> device µs per launch, bytes, cells

    def timed(fn, steps):
        fn(10)  # warm-up
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(steps)
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b)
        times, wall = device_profile(fn, steps)
        busy = sum(times.values())
        rec = {"us_per_step": ms * 1e3 / steps, "mlups": cells * steps / (ms * 1e3)}
        if wall:
            rec.update({"device_us_per_step": busy / steps, "busy_share": busy / (wall * 1e6)})
        return rec, times

    for name, fn in per_step.items():
        rec, _ = timed(fn, n)
        report.setdefault("per_step", {})[name] = rec
        print(f"  per-step {name:9s} {rec['us_per_step']:9.3f} us/step  busy "
              f"{rec.get('busy_share', float('nan')):.1%}", flush=True)

    def check_pass(shape):
        """The k-step pass at k = 1..4 on every shard (a column mesh's
        through the column instance, from 2k-row pieces and `pass_xh`-lane
        blocks), both classes where `lean_pass` holds: bit for bit k steps
        of the A/B pair, and at k = 1 and 4 bit for bit its twin, run on the
        CPU from the same inputs (on the card PyTorch's reductions sum in
        another order: within 4e-7 there)."""
        k = 0
        mesh = make_mesh(shape, [dev] * (shape[0] * shape[1]))
        shards = [S.Shard.of(H, W, shape, c) for c in mesh.local]
        L = range(len(shards))
        f, rho, vel = (split(s0[x], mesh) for x in ("f", "rho", "vel"))
        cols = shape[1] > 1
        kname = "fluid_pass_sh_cols" if cols else "fluid_pass_sh"
        for kp in range(1, 5):
            hx = HA.exchange([[f[i], vel[i], rho[i]] for i in L], mesh,
                             S.pass_xh(kp) if cols else 0, rows=2 * kp)
            pair = S.make_sharded_tiled_fluid_runner(fc, mesh, route="launches")(s0, fl, k, kp)
            for i, sh in enumerate(shards):
                for lean in (False, True) if not cols and S.lean_pass(fc, sh, k, kp) else (False,):
                    tag = f"{shape} {mesh.local[i]} k={kp}{' lean' if lean else ''}"
                    got = S.fluid_pass_sh(f[i], rho[i], vel[i], hx[i], k, kp, fc, fl, sh, lean)
                    if kp in (1, 4):
                        want = S.fluid_pass_sh_ref(f[i].cpu(), rho[i].cpu(), vel[i].cpu(),
                                                   cpu_halo(hx[i]),
                                                   k, kp, fc, None, sh, lean)
                        for nm, x, y in zip(("f", "rho", "vel"), got, want):
                            check_close(f"{kname} {tag} {nm}", x.cpu(), y, 0.0, errs[kname])
                    if not all(torch.equal(x, sh.body(pair[nm]))
                               for x, nm in zip(got, ("f", "rho", "vel"))):
                        fail(f"{kname} {tag}: not bit for bit {kp} steps of the A/B pair")
                    print(f"  {kname} {tag}: bit for bit {'its twin and ' if kp in (1, 4) else ''}"
                          f"{kp} steps of the A/B pair", flush=True)

    ka = 27  # the approach pass's first step: k = 4 steps cross a tip row and a stored frame
    if not (T.tip_walks(cc.inflow_height, ka + 3, cc.vel_obs_conv)[1]
            > T.tip_walks(cc.inflow_height, ka, cc.vel_obs_conv)[1]
            and T.frame_pair(ka + 3, cc.vel_obs_conv, 8)[0] > T.frame_pair(ka, cc.vel_obs_conv,
                                                                              8)[0]):
        fail(f"the approach pass from step {ka} crosses no tip row or stored frame")
    cf_cpu = {x: y.cpu() for x, y in cf.items()}

    def check_c_pass(shape):
        """The C passes at k = 1..4 on every shard (a column mesh's through
        their column instances, from 2k-row pieces and `pass_xh`-lane blocks,
        the frames cut with their reach lanes): bit for bit k steps of the
        per-step kernels (`route="launches"`'s; for the approach its lerp and
        c_approach_sh, and the shard's disk sums; on a row mesh from step
        ka, on a column mesh from step 8 and from 2**24 - 5) and their twins
        run on the CPU from the same inputs (h and C bit for bit, the disk
        sums rtol 2e-4 / atol 1e-4; on a row mesh at k = 1 and 4)."""
        ny, nx = shape
        cols = nx > 1
        mesh = make_mesh(shape, [dev] * (ny * nx))
        shards = [S.Shard.of(H, W, shape, c) for c in mesh.local]
        L = range(len(shards))
        h, C, fls = split(st0["h"], mesh), split(st0["C"], mesh), split(flags, mesh)
        base, frames = split(cf["base_flags"], mesh), split(vf, mesh)
        hb1 = HA.exchange([[x] for x in base], mesh, S.XH)
        bname, aname = (inst_of(x, nx) for x in ("c_balance_pass_sh", "c_approach_pass_sh"))
        for kp in range(1, 5):
            xh = S.pass_xh(kp) if cols else S.XH
            hx = HA.exchange([[h[i], C[i]] for i in L], mesh, xh, rows=2 * kp)
            hxa = HA.exchange([[x] for x in h], mesh, xh, rows=2 * kp)
            hfl = HA.exchange([[x] for x in fls], mesh, xh, rows=2 * kp)
            hb = HA.exchange([[x] for x in base], mesh, xh, rows=2 * kp)
            twin = cols or kp in (1, 4)
            per = S.make_sharded_tiled_balance_runner(cc, flags, mesh, route="launches")(
                st0, cf, kp)
            for i, sh in enumerate(shards):
                tag = f"{shape} {mesh.local[i]} k={kp}"
                got = S.c_balance_pass_sh(h[i], C[i], fls[i], hx[i], hfl[i], kp, cc, cf, sh)
                if not all(torch.equal(x, sh.body(per[nm])) for x, nm in zip(got, ("h", "C"))):
                    fail(f"{bname} {tag}: not bit for bit {kp} steps of c_balance_sh")
                if twin:
                    want = S.c_balance_pass_sh_ref(
                        h[i].cpu(), C[i].cpu(), fls[i].cpu(), cpu_halo(hx[i]), cpu_halo(hfl[i]),
                        kp, cc, cf_cpu, sh)
                    for nm, x, y in zip(("h", "C"), got, want):
                        check_close(f"{bname} {tag} {nm}", x.cpu(), y, 0.0, errs[bname])
            for start in ((8, 2**24 - 5) if cols else (ka,)):
                ph, pC = h, C  # kp steps of the lerp and c_approach_sh, from step start
                pparts = [torch.zeros(4, device=dev) for _ in L]
                for step in range(start, start + kp):
                    vel = [T.stored_velocity(fr, step, cc.vel_obs_conv) for fr in frames]
                    hh = HA.exchange([[x] for x in ph], mesh, S.XH)
                    out = [S.c_approach_sh(ph[i], pC[i], vel[i], base[i], hh[i], hb1[i], step, cc,
                                           cf, sh, pparts[i]) for i, sh in enumerate(shards)]
                    ph, pC = [o[0] for o in out], [o[1] for o in out]
                for i, sh in enumerate(shards):
                    tag = f"{shape} {mesh.local[i]} k={kp} from {start}"
                    fr = S.shard_frames(vf, sh, 2 * kp)
                    part = torch.zeros(4, device=dev)
                    got = S.c_approach_pass_sh(h[i], base[i], fr, hxa[i], hb[i], start, kp, cc,
                                               cf, sh, part)
                    if not (torch.equal(got[0], ph[i]) and torch.equal(got[1], pC[i])
                            and torch.equal(part, pparts[i])):
                        fail(f"{aname} {tag}: not bit for bit {kp} steps of the lerp and "
                             f"c_approach_sh (h, C, disk sums)")
                    if twin:
                        wh, wC, wparts = S.c_approach_pass_sh_ref(
                            h[i].cpu(), base[i].cpu(),
                            S.ShardFrames(fr.t.cpu(), fr.row0, col0=fr.col0), cpu_halo(hxa[i]),
                            cpu_halo(hb[i]), start, kp, cc, cf_cpu, sh)
                        for nm, x, y in zip(("h", "C"), got, (wh, wC)):
                            check_close(f"{aname} {tag} {nm}", x.cpu(), y, 0.0, errs[aname])
                        acc_w = torch.zeros(4)
                        for p_ in wparts:
                            acc_w = torch.stack([acc_w[0] + p_[0], acc_w[1] + p_[1], p_[2],
                                                 p_[3]])
                        check_ints(f"{aname} {tag} disk sums", part, acc_w)
            print(f"  C passes {shape} k={kp}: bit for bit {kp} steps of the per-step kernels"
                  f"{' and the twins' if twin else ''} on every shard", flush=True)

    # the passes on the (2, 1) and (1, 2) meshes, which the main path below
    # does not take (the C passes' column instances on (1, 2))
    for shape in SH_CHECK_MESHES:
        print(f" mesh {shape}: fluid_pass_sh against its twin and the pair", flush=True)
        check_pass(shape)
        if shape[1] > 1:
            check_c_pass(shape)

    for shape in SH_MESHES:
        ny, nx = shape
        mesh = make_mesh(shape, [dev] * (ny * nx))
        shards = [S.Shard.of(H, W, shape, c) for c in mesh.local]
        L = range(len(shards))
        rep = report["meshes"][f"{ny}x{nx}"] = {"shard": [shards[0].h, shards[0].w]}
        print(f" mesh {shape}: shards of {shards[0].h}x{shards[0].w}", flush=True)

        # (a) each kernel against its twin, one launch on every shard
        k = 0
        f, rho, vel = (split(s0[x], mesh) for x in ("f", "rho", "vel"))
        ha = HA.exchange([[f[i], vel[i]] for i in L], mesh, S.XH)
        if ny > 1 or nx > 1:
            grp = [f[-1], vel[-1]]
            got, want = HA.halo_pack(grp), HA.halo_pack_ref(grp)
            if nx > 1:
                got = got + HA.halo_pack(grp, ha[-1].top, ha[-1].bot, S.XH)
                want = want + HA.halo_pack_ref(grp, ha[-1].top, ha[-1].bot, S.XH)
            for x, y in zip(got, want):
                check_close(f"halo_pack {shape}", x, y, 0.0, errs["halo_pack"])
        a_ref = [S.fluid_a_sh_ref(f[i], rho[i], vel[i], ha[i], k, fc, fl, shards[i]) for i in L]
        hb = HA.exchange([[x[1], x[2]] for x in a_ref], mesh, S.XH)
        for i, sh in enumerate(shards):
            leans = (False, True) if nx == 1 and S.lean_shard(fc, sh, k) else (False,)
            for lean in leans:
                tag = f"{shape} {mesh.local[i]}{' lean' if lean else ''}"
                a = S.fluid_a_sh(f[i], rho[i], vel[i], ha[i], k, fc, fl, sh, lean)
                want = S.fluid_a_sh_ref(f[i], rho[i], vel[i], ha[i], k, fc, fl, sh, lean)
                for nm, x, y, tol in zip(("f", "rho", "vel"), a, want, (1e-5, 1e-5, 1e-4)):
                    check_close(f"fluid_a_sh {tag} {nm}", x, y, tol, errs["fluid_a_sh"])
                check_close(f"fluid_b_sh {tag} f",
                            S.fluid_b_sh(*a_ref[i], hb[i], k, fc, fl, sh, lean),
                            S.fluid_b_sh_ref(*a_ref[i], hb[i], k, fc, fl, sh, lean), 1e-5,
                            errs["fluid_b_sh"])
        check_pass(shape)
        check_c_pass(shape)
        h, C, fls = split(st0["h"], mesh), split(st0["C"], mesh), split(flags, mesh)
        base, frames = split(cf["base_flags"], mesh), split(vf, mesh)
        hh = HA.exchange([[x] for x in h], mesh, S.XH)
        hfl = HA.exchange([[x] for x in fls], mesh, S.XH)
        hbase = HA.exchange([[x] for x in base], mesh, S.XH)
        step1 = 3  # the per-step approach's step
        for i, sh in enumerate(shards):
            got = S.c_balance_sh(h[i], C[i], fls[i], hh[i], hfl[i], cc, cf, sh)
            want = S.c_balance_sh_ref(h[i], C[i], fls[i], hh[i], hfl[i], cc, cf, sh)
            for nm, x, y in zip(("h", "C"), got, want):
                check_close(f"c_balance_sh {shape} {mesh.local[i]} {nm}", x, y, 1e-5,
                            errs["c_balance_sh"])
            v = T.stored_velocity(frames[i], step1, cc.vel_obs_conv)
            part = torch.zeros(4, device=dev)
            got = S.c_approach_sh(h[i], C[i], v, base[i], hh[i], hbase[i], step1, cc, cf, sh,
                                  part)
            *want, p_ref = S.c_approach_sh_ref(h[i], C[i], v, base[i], hh[i], hbase[i], step1, cc,
                                               cf, sh)
            for nm, x, y in zip(("h", "C"), got, want):
                check_close(f"c_approach_sh {shape} {mesh.local[i]} {nm}", x, y, 1e-5,
                            errs["c_approach_sh"])
            check_ints(f"c_approach_sh {shape} {mesh.local[i]} disk terms", part, p_ref)

        # (b) the main path: the three sharded runners, counts zeroed just
        # before each and read just after; each through its route (the passes
        # at their default k; on (2, 2) their column instances), and the
        # yardsticks: each phase's per-step kernels (route="launches"), on row
        # meshes each pass at the other of k = 1 and 4 too
        sh_runs = {"fluid": S.make_sharded_tiled_fluid_runner(fc, mesh),
                   "balance": S.make_sharded_tiled_balance_runner(cc, flags, mesh),
                   "approach": S.make_sharded_tiled_approach_runner(cc, vf, mesh)}
        if nx == 1:
            mk = {"fluid": lambda **kw: S.make_sharded_tiled_fluid_runner(fc, mesh, **kw),
                  "balance": lambda **kw: S.make_sharded_tiled_balance_runner(cc, flags, mesh,
                                                                              **kw),
                  "approach": lambda **kw: S.make_sharded_tiled_approach_runner(cc, vf, mesh,
                                                                                **kw)}
            for phase in ("fluid", "balance", "approach"):
                dk = sh_runs[phase].k
                alt = 1 if dk != 1 else S.PASS_SH_K
                sh_runs[f"{phase} launches"] = mk[phase](route="launches")
                sh_runs[f"{phase} k={alt}"] = mk[phase](k=alt)
        else:
            sh_runs["fluid launches"] = S.make_sharded_tiled_fluid_runner(fc, mesh,
                                                                          route="launches")
            sh_runs["balance launches"] = S.make_sharded_tiled_balance_runner(
                cc, flags, mesh, route="launches")
            sh_runs["approach launches"] = S.make_sharded_tiled_approach_runner(
                cc, vf, mesh, route="launches")
        runs = {}
        for p_, r in sh_runs.items():
            phase = p_.split()[0]
            runs[p_] = ((lambda kk, r=r: r(s0, fl, 0, kk)) if phase == "fluid" else
                        (lambda kk, r=r: r(st0, cf, kk)) if phase == "balance" else
                        (lambda kk, r=r: r(st0, cf, 0, kk)))
        want_k = {p_: SH_ROUTE_KERNELS[(p_.split()[0], r.route)] for p_, r in sh_runs.items()}
        for pname, fn in runs.items():
            run_ = sh_runs[pname]
            phase = pname.split()[0]
            fluid_run = run_ if phase == "fluid" else None
            torch.cuda.synchronize()
            if fluid_run:
                fluid_run.lean_steps.clear()
            kernels.reset_launches()
            with mock.patch.object(S, "exchange", wraps=S.exchange) as ex:
                out = fn(n)
            torch.cuda.synchronize()
            counts = {x: c for x, c in kernels.launches().items() if c}
            lean_steps = dict(fluid_run.lean_steps) if fluid_run else {}
            expect = want_k[pname] | ({"halo_pack"} if ny * nx > 1 else set())
            if set(counts) != expect:
                fail(f"sharded {pname} {shape}: launched {counts}, expected {sorted(expect)}")
            if pname == phase:  # the main path's launches, not the yardsticks'
                for x, c in counts.items():
                    main_counts[inst_of(x, nx)] += c
            if phase == "approach":
                out, acc = out
                _, acc_r = ref[phase]
                keys = ("inflow_sum", "current_sum", "rec_u", "rec_v")
                check_ints(f"sharded {pname} {shape} integrals", [acc[x] for x in keys],
                           [acc_r[x] for x in keys])
                want = ref[phase][0]
            else:
                want = ref[phase]
            for nm in want:
                if not torch.equal(out[nm], want[nm]):
                    d = float((out[nm] - want[nm]).abs().max())
                    fail(f"sharded {pname} {shape} {nm}: not bit for bit the per-step kernels "
                         f"(max |diff| {d:.3e})")
            rec, times = timed(fn, n)
            rec.update({"launches": counts, "bit_for_bit": True, "route": run_.route,
                        "k": run_.k if run_.route == "pass" else 1,
                        "launches_per_step": sum(c for x, c in counts.items()
                                                 if x != "halo_pack") / n,
                        # calls of halo.exchange a step (the fixed flags' once a run)
                        "exchanges_per_step": ex.call_count / n})
            if fluid_run:
                rec["lean_steps"] = {f"{c[0]},{c[1]}": s for c, s in lean_steps.items()}
                print(f"  {pname} lean steps {rec['lean_steps']} (shard: steps of {n})",
                      flush=True)
            print(f"  {pname} (route {rec['route']}, k={rec['k']}): device "
                  f"{rec.get('device_us_per_step', float('nan')):.3f} us/step; "
                  f"{rec['launches_per_step']:.3f} launches and {rec['exchanges_per_step']:.3f} "
                  f"exchanges a step", flush=True)
            base_rec = report["per_step"][phase]
            print(f"  sharded {pname:14s} {rec['us_per_step']:9.3f} us/step (per-step kernels "
                  f"{base_rec['us_per_step']:.3f}), busy {rec.get('busy_share', float('nan')):.1%}"
                  f" (per-step {base_rec.get('busy_share', float('nan')):.1%}); launches {counts};"
                  f" bit for bit", flush=True)
            rep[pname] = rec
            # device µs per launch of each instance on this mesh
            sh = shards[-1]
            for kname in want_k[pname] | ({"halo_pack"} if ny * nx > 1 else set()):
                insts = {"": KERNEL_FUNCS[kname]}
                if kname in ("fluid_a_sh", "fluid_b_sh"):
                    insts = {"": (f"{kname}_kernel<false>",), "lean": (f"{kname}_kernel<true>",)}
                elif kname in SH_PASSES:
                    insts = {f"k={run_.k}": (f"{KERNEL_FUNCS[inst_of(kname, nx)][0]}<{run_.k}>",)}
                for inst, names in insts.items():
                    us = sum(t for nm_, t in times.items() if any(x in nm_ for x in names))
                    lean_n = sum(lean_steps.values())
                    cnt = (lean_n if inst == "lean" else counts[kname] - lean_n) if kname in (
                        "fluid_a_sh", "fluid_b_sh") else counts[kname]
                    if cnt and us:
                        per_launch[(inst_of(kname, nx), f"{ny}x{nx}", inst)] = us / cnt
        # launches and bound of one step's launches on the last shard
        rep["bytes_per_launch"] = {x: sh_bytes(x, shards[-1]) for x in SH_PLANES}

    # (c) the (1, 1) mesh through a one-rank NCCL process group
    print(" mesh (1, 1) through a one-rank NCCL process group (psum by all_reduce)", flush=True)
    multihost.initialize(f"localhost:{free_port()}", 1, 0, backend="nccl")
    try:
        pm = process_mesh((1, 1), device=dev)
        lm = make_mesh((1, 1), [dev])
        kk = 20
        for pname, mk in (("fluid", lambda m: S.make_sharded_tiled_fluid_runner(fc, m)(
                              s0, fl, 0, kk)),
                          ("balance", lambda m: S.make_sharded_tiled_balance_runner(
                              cc, flags, m)(st0, cf, kk)),
                          ("approach", lambda m: S.make_sharded_tiled_approach_runner(
                              cc, vf, m)(st0, cf, 0, kk))):
            got, want = mk(pm), mk(lm)
            if pname == "approach":
                (got, ga), (want, wa) = got, want
                got, want = dict(got, **ga), dict(want, **wa)
            for nm in want:
                if not torch.equal(got[nm].to(dev), want[nm].to(dev)):
                    fail(f"NCCL (1, 1) {pname} {nm} differs from the local mesh")
            print(f"  {pname}: {kk} steps bit for bit the local mesh", flush=True)
        report["nccl_1x1"] = {"backend": dist.get_backend(), "steps": kk, "bit_for_bit": True}
    finally:
        dist.destroy_process_group()

    for x in SH_PATH:
        if main_counts[x] < 1:
            fail(f"sharded main path: {x} was not launched")
    report["main_launches"] = main_counts
    report["per_launch_us"] = {f"{k}/{m}{'/' + i if i else ''}": us
                               for (k, m, i), us in per_launch.items()}
    print(f"  sharded main path launches {main_counts}", flush=True)

    # one row per kernel: the (2, 2) mesh's shard (512x256), the lean
    # instances at (4, 1) in the report
    mesh22 = make_mesh((2, 2), [dev] * 4)
    sh = S.Shard.of(H, W, (2, 2), (1, 1))
    f, rho, vel = (split(s0[x], mesh22) for x in ("f", "rho", "vel"))
    ha = HA.exchange([[f[i], vel[i]] for i in range(4)], mesh22, S.XH)
    a_out = S.fluid_a_sh(f[3], rho[3], vel[3], ha[3], 0, fc, fl, sh)
    hb = HA.exchange([[x, y] for x, y in zip(split(s0["rho"], mesh22), split(s0["vel"], mesh22))],
                     mesh22, S.XH)
    h, C, fls = (split(x, mesh22) for x in (st0["h"], st0["C"], flags))
    base, frames = split(cf["base_flags"], mesh22), split(vf, mesh22)
    hh = HA.exchange([[x] for x in h], mesh22, S.XH)
    hfl = HA.exchange([[x] for x in fls], mesh22, S.XH)
    v3 = T.stored_velocity(frames[3], 0, cc.vel_obs_conv)
    part = torch.zeros(4, device=dev)
    grp = [f[3], vel[3]]
    calls = {
        "fluid_a_sh": (lambda: S.fluid_a_sh(f[3], rho[3], vel[3], ha[3], 0, fc, fl, sh),
                       lambda: S.fluid_a_sh_ref(f[3], rho[3], vel[3], ha[3], 0, fc, fl, sh)),
        "fluid_b_sh": (lambda: S.fluid_b_sh(*a_out, hb[3], 0, fc, fl, sh),
                       lambda: S.fluid_b_sh_ref(*a_out, hb[3], 0, fc, fl, sh)),
        "c_balance_sh": (lambda: S.c_balance_sh(h[3], C[3], fls[3], hh[3], hfl[3], cc, cf, sh),
                         lambda: S.c_balance_sh_ref(h[3], C[3], fls[3], hh[3], hfl[3], cc, cf,
                                                    sh)),
        "c_approach_sh": (lambda: S.c_approach_sh(h[3], C[3], v3, base[3], hh[3], hfl[3], 0, cc,
                                                  cf, sh, part),
                          lambda: S.c_approach_sh_ref(h[3], C[3], v3, base[3], hh[3], hfl[3], 0,
                                                      cc, cf, sh)),
        "halo_pack": (lambda: HA.halo_pack(grp, ha[3].top, ha[3].bot, S.XH),
                      lambda: HA.halo_pack_ref(grp, ha[3].top, ha[3].bot, S.XH)),
    }
    # (d) fluid_pass_sh alone at the main path's shapes: a pass on the (4, 1)
    # and the (2, 2) shard with the tip (the latter the column instance) and
    # on the (1, 1) grid, at k = 1..4;
    # CUDA events around 20 launches queued behind a sleep kernel, the L2
    # flushed before each (a 128 MB write, its own time taken off), the
    # median of three such pairs (the profiler reads low after the NCCL
    # part of this phase, PERF.md §7)
    print(f"fluid_pass_sh alone, L2 flushed (memory rate {rate / 1e12:.2f} TB/s):", flush=True)
    l2_flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    alone = {}
    co22 = (T.tip_walks(fc.inflow_height, 0, fc.vel_obs)[1] * 2 // H, 0)  # the tip's shard
    for mshape, co in (((4, 1), (1, 0)), ((2, 2), co22), ((1, 1), (0, 0))):
        mesh_ = make_mesh(mshape, [dev] * (mshape[0] * mshape[1]))
        psh = S.Shard.of(H, W, mshape, co)
        pf, prho, pvel = (split(s0[x], mesh_) for x in ("f", "rho", "vel"))
        pi = mesh_.local.index(co)
        cols = mshape[1] > 1
        for kp in range(1, 5):
            hx = HA.exchange([[pf[j], pvel[j], prho[j]] for j in range(len(pf))], mesh_,
                             S.pass_xh(kp) if cols else 0, rows=2 * kp)
            args = (pf[pi], prho[pi], pvel[pi], hx[pi], 0, kp, fc, fl, psh)
            scr = S.pass_sh_scratch(psh, kp, dev)  # the runner's, held across passes
            pairs = sorted(queued_ms(lambda: (l2_flush.zero_(),
                                              S.fluid_pass_sh(*args, scratch=scr)), 20)
                           - queued_ms(l2_flush.zero_, 20) for _ in range(3))
            ms = pairs[1]
            plain_ms = cuda_ms(lambda: S.fluid_pass_sh_ref(*args), 1, warmup=0)
            # the shard's f, rho, vel in and out once, its 2k-row pieces of 12
            # planes in, on a column mesh its 2k lanes a side of the rows
            # extended by 2k (the blocks' lanes past 2k not counted)
            nbytes = 4 * (24 * psh.h * psh.w + (2 * 12 * 2 * kp * psh.w if mshape[0] > 1 else 0)
                          + (2 * 12 * (psh.h + 4 * kp) * 2 * kp if cols else 0))
            mem_ms = nbytes / rate * 1e3
            ops_ms = FLOPS_PER_CELL["fluid_pass_sh"] * psh.h * psh.w * kp / F32_PEAK * 1e3
            bound_ms = max(mem_ms, ops_ms)
            by = "bytes" if mem_ms >= ops_ms else "operations"
            label = f"{mshape} k={kp}"
            print(f"  {label:14s} {ms * 1e3:9.2f} us a pass ({ms * 1e3 / kp:8.2f} a step)  bound "
                  f"{bound_ms * 1e3:7.2f} us ({by}; {nbytes / 1e6:.2f} MB)  "
                  f"{bound_ms / ms * 100:6.2f}% of bound  twin {plain_ms:.3f} ms  (shard "
                  f"{psh.h}x{psh.w}; {len(mesh_.local)} shards)", flush=True)
            alone[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
                            "bytes": nbytes, "shard": [psh.h, psh.w], "pairs_ms": pairs,
                            "plan": str(S.pass_sh_plan(psh, kp, sms)),
                            "time_from": "events behind a sleep kernel, less the L2 flush, the "
                                         "median of three"}
    # the C passes alone on the (4, 1) shard with the tip and on the (2, 2)
    # one (their column instances) at k = 1..4, as fluid_pass_sh; the bound:
    # c_pass_bytes at the memory rate, or the cell code's operations (k
    # steps) at the float32 peak
    ppart = torch.zeros(4, device=dev)
    for mshape, co in (((4, 1), (1, 0)), ((2, 2), co22)):
        mesh_ = make_mesh(mshape, [dev] * (mshape[0] * mshape[1]))
        psh = S.Shard.of(H, W, mshape, co)
        pi = mesh_.local.index(co)
        L_ = range(len(mesh_.local))
        ph_, pC_, pfl = (split(x, mesh_) for x in (st0["h"], st0["C"], flags))
        pbase = split(cf["base_flags"], mesh_)
        cols = mshape[1] > 1
        for kp in range(1, 5):
            xh = S.pass_xh(kp) if cols else S.XH
            c_hx = HA.exchange([[ph_[j], pC_[j]] for j in L_], mesh_, xh, rows=2 * kp)
            c_hxa = HA.exchange([[x] for x in ph_], mesh_, xh, rows=2 * kp)
            c_hfl = HA.exchange([[x] for x in pfl], mesh_, xh, rows=2 * kp)
            c_hb = HA.exchange([[x] for x in pbase], mesh_, xh, rows=2 * kp)
            c_fr = S.shard_frames(vf, psh, 2 * kp)
            c_scr = S.pass_sh_scratch(psh, kp, dev, 10)  # the runner's, held across passes
            c_args = {
                "c_balance_pass_sh": (
                    lambda: S.c_balance_pass_sh(ph_[pi], pC_[pi], pfl[pi], c_hx[pi], c_hfl[pi],
                                                kp, cc, cf, psh, scratch=c_scr),
                    lambda: S.c_balance_pass_sh_ref(ph_[pi], pC_[pi], pfl[pi], c_hx[pi],
                                                    c_hfl[pi], kp, cc, cf, psh), "balance"),
                "c_approach_pass_sh": (
                    lambda: S.c_approach_pass_sh(ph_[pi], pbase[pi], c_fr, c_hxa[pi], c_hb[pi], 0,
                                                 kp, cc, cf, psh, ppart, scratch=c_scr),
                    lambda: S.c_approach_pass_sh_ref(ph_[pi], pbase[pi], c_fr, c_hxa[pi],
                                                     c_hb[pi], 0, kp, cc, cf, psh), "approach"),
            }
            for name_, (kfn, tfn, kind) in c_args.items():
                pairs = sorted(queued_ms(lambda: (l2_flush.zero_(), kfn()), 20)
                               - queued_ms(l2_flush.zero_, 20) for _ in range(3))
                ms = pairs[1]
                plain_ms = cuda_ms(tfn, 1, warmup=0)
                nbytes = c_pass_bytes(kind, psh, kp)
                mem_ms = nbytes / rate * 1e3
                ops_ms = FLOPS_PER_CELL[name_] * psh.h * psh.w * kp / F32_PEAK * 1e3
                bound_ms = max(mem_ms, ops_ms)
                by = "bytes" if mem_ms >= ops_ms else "operations"
                label = f"{inst_of(name_, mshape[1])} {mshape} k={kp}"
                print(f"  {label:36s} {ms * 1e3:9.2f} us a pass ({ms * 1e3 / kp:8.2f} a step)  "
                      f"bound {bound_ms * 1e3:7.2f} us ({by}; {nbytes / 1e6:.2f} MB)  "
                      f"{bound_ms / ms * 100:6.2f}% of bound  twin {plain_ms:.3f} ms  (shard "
                      f"{psh.h}x{psh.w} at {co})", flush=True)
                alone[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": by, "bytes": nbytes, "shard": [psh.h, psh.w],
                                "pairs_ms": pairs, "plan": str(S.pass_sh_plan(psh, kp, sms, kind)),
                                "time_from": "events behind a sleep kernel, less the L2 flush, "
                                             "the median of three"}
    report["pass_alone"] = alone

    rows = []
    print(f"sharded kernels per launch on a 512x256 shard of the (2, 2) mesh (memory rate "
          f"{rate / 1e12:.2f} TB/s):", flush=True)
    for k in SHARDED:
        if k in SH_PASSES:  # its row: the (4, 1) or (2, 2) mesh's k on its shard with the tip
            k22 = S.default_k(S.Shard.of(H, W, (2, 2), co22))
            a = alone[f"(4, 1) k={S.PASS_SH_K}" if k == "fluid_pass_sh" else
                      f"(2, 2) k={k22}" if k == "fluid_pass_sh_cols" else
                      f"{k} (2, 2) k={k22}" if k.endswith("_cols") else
                      f"{k} (4, 1) k={S.PASS_SH_K}"]
            src, rep_ = SOURCE[k]
            rows.append({
                "name": k, "route": "cuda", "source": src, "replaces": rep_,
                "launches": main_counts[k], "max_abs_err": max(errs[k]) if errs[k] else None,
                "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
                "bound_by": a["bound_by"], "library_ms": None,
            })
            report.setdefault("rows", {})[k] = dict(rows[-1], time_from=a["time_from"])
            continue
        kfn, tfn = calls[k]
        call_ms = cuda_ms(kfn, 200)
        plain_ms = cuda_ms(tfn, 3, warmup=1)
        # the cols phase of f + vel: 2 blocks of 11 (h+2) x xh words read and written
        nbytes = 2 * 4 * 2 * 11 * (sh.h + 2) * S.XH if k == "halo_pack" else sh_bytes(k, sh)
        dev_us = kernel_us(kfn, KERNEL_FUNCS[k])
        mem_ms = nbytes / rate * 1e3
        ops_ms = FLOPS_PER_CELL[k] * sh.h * sh.w / F32_PEAK * 1e3
        # without the profiler's device time, events around launches queued
        # behind a sleep kernel (the wrapper's host time opens no gap)
        ms = dev_us / 1e3 if dev_us else queued_ms(kfn, 200)
        bound_ms = max(mem_ms, ops_ms)
        print(f"  {k:14s} {ms * 1e3:10.2f} us  bound {bound_ms * 1e3:8.2f} us "
              f"({'bytes' if mem_ms >= ops_ms else 'operations'}; {nbytes / 1e6:.3f} MB)  "
              f"{bound_ms / ms * 100:6.2f}% of bound  twin {plain_ms:.3f} ms  wrapper call "
              f"{call_ms * 1e3:.2f} us  (timed by "
              f"{'the profiler' if dev_us else 'events: the profiler recorded no device time'})",
              flush=True)
        src, rep_ = SOURCE[k]
        rows.append({
            "name": k, "route": "cuda", "source": src, "replaces": rep_,
            "launches": main_counts[k], "max_abs_err": max(errs[k]) if errs[k] else None,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if mem_ms >= ops_ms else "operations", "library_ms": None,
        })
        report.setdefault("rows", {})[k] = dict(
            rows[-1], wrapper_call_ms=call_ms, bytes=nbytes,
            time_from="profiler" if dev_us else "events behind a sleep kernel (the profiler "
                                                "recorded no device time)")
    # the lean instances alone, on the (4, 1) shard above the tip
    mesh41 = make_mesh((4, 1), [dev] * 4)
    sh = S.Shard.of(H, W, (4, 1), (2, 0))
    if not S.lean_shard(fc, sh, 0):
        fail("the (4, 1) shard 2 is not lean at step 0")
    f, rho, vel = (split(s0[x], mesh41) for x in ("f", "rho", "vel"))
    ha = HA.exchange([[f[i], vel[i]] for i in range(4)], mesh41, S.XH)
    hb = HA.exchange([[rho[i], vel[i]] for i in range(4)], mesh41, S.XH)
    lean_calls = {
        "fluid_a_sh": (lambda: S.fluid_a_sh(f[2], rho[2], vel[2], ha[2], 0, fc, fl, sh, True),
                       lambda: S.fluid_a_sh_ref(f[2], rho[2], vel[2], ha[2], 0, fc, fl, sh, True),
                       # the lean body reads f and its pieces, writes f, rho, vel
                       4 * (21 * sh.h * sh.w + 9 * 2 * sh.w)),
        "fluid_b_sh": (lambda: S.fluid_b_sh(f[2], rho[2], vel[2], hb[2], 0, fc, fl, sh, True),
                       lambda: S.fluid_b_sh_ref(f[2], rho[2], vel[2], hb[2], 0, fc, fl, sh, True),
                       sh_bytes("fluid_b_sh", sh)),
    }
    print("lean instances per launch on the 256x512 shard 2 of the (4, 1) mesh:", flush=True)
    for k, (kfn, tfn, nbytes) in lean_calls.items():
        dev_us = kernel_us(kfn, (f"{k}_kernel<true>",))
        mem_ms = nbytes / rate * 1e3
        ops_ms = FLOPS_PER_CELL[k] * sh.h * sh.w / F32_PEAK * 1e3
        plain_ms = cuda_ms(tfn, 3, warmup=1)
        ms = dev_us / 1e3 if dev_us else queued_ms(kfn, 200)
        print(f"  {k + ' lean':16s} {ms * 1e3:8.2f} us  bound {max(mem_ms, ops_ms) * 1e3:8.2f} us "
              f"({nbytes / 1e6:.3f} MB)  twin {plain_ms:.3f} ms; in the (4, 1) path "
              f"{per_launch.get((k, '4x1', 'lean'), float('nan')):.2f} us", flush=True)
        report.setdefault("lean_rows", {})[k] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(mem_ms, ops_ms), "bytes": nbytes,
            "time_from": "profiler" if dev_us else "events behind a sleep kernel (the profiler "
                                                   "recorded no device time)"}
    return rows, report


# ---------------------------------------------------------------------------
# The cylinder channel on a mesh of shards (kernels/cyl_sharded.py)
# ---------------------------------------------------------------------------

CYL_SH = ("cyl_block_sh", "cyl_lean_sh", "cyl_window_sh", "cyl_pass_sh")
# the kernels of the sharded cylinder's main path: the lean split one
# cyl_pass_sh launch a shard and pass; cyl_lean_sh and cyl_window_sh on
# each band window (route="launches") are its yardstick
CYL_SH_PATH = ("cyl_block_sh", "cyl_pass_sh")
# (label, mesh, runner arguments): the lean split at k = 1 in its three x
# modes and at k = 4, and the two full-boundary routes
CYL_SH_ROUTES = (
    ("lean k=1 (1, 1) x_whole", (1, 1), {}),
    ("lean k=1 (4, 1)", (4, 1), {}),
    ("lean k=1 (2, 2) column-patched", (2, 2), {}),
    ("lean k=4 (4, 1)", (4, 1), dict(lean_k=4)),
    ("lean k=4 (2, 2) x_ext 128 x_halo 8", (2, 2), dict(lean_k=4, lean_x_ext=128, lean_x_halo=8)),
    ("PIECES (4, 1) tile_rows 64", (4, 1), dict(lean_split=False, tile_rows=64)),
    ("PIECES (2, 2) tile_rows 64", (2, 2), dict(lean_split=False, tile_rows=64)),
    ("PADDED (2, 2)", (2, 2), dict(lean_split=False, tile_rows=None)),
)


def cyl_sharded_phases(dev, rate, errs, unsharded_us=None):
    """The cylinder channel on a mesh of shards at bench.py's scene
    (2048², D 64, Re 5000; every shard on ``dev``), route by route
    (`CYL_SH_ROUTES`): (a) each kernel against its twin after one launch
    on the shard that holds the cylinder (1e-5; halo_pack's k-row and
    one-lane phases bit for bit; ``cyl_pass_sh`` also bit for bit
    ``cyl_lean_sh`` + ``cyl_window_sh``); (b) the main path, the runner
    over 23 steps with the counts zeroed just before and read just after
    (the lean split through ``cyl_pass_sh``): the full-boundary routes bit
    for bit the unsharded ``split=False`` runner, the lean split within f,
    rho 2e-5 and vel 2e-4 of the unsharded default runner on non-OBSTACLE
    cells (k = 1 also set beside the unsharded k = 1 split steps) and bit
    for bit ``route="launches"`` (not counted); (c) the lean routes timed
    as bench.py times (20 warm-up steps, best of three 600-step windows, a
    profiled window for the busy share) beside ``route="launches"`` and the
    unsharded runner (on one card: the halo exchange, the extra launches
    and the host, not multi-card scaling); (d) each kernel alone at the
    main path's shapes. Returns the four kernels' rows, the halo_pack
    launches of the path and a report."""
    import torch

    from jrl_lbm_torch import kernels
    from jrl_lbm_torch.kernels import cyl_sharded as CS
    from jrl_lbm_torch.kernels import cylinder as K
    from jrl_lbm_torch.kernels import halo as HA
    from jrl_lbm_torch.models import cylinder as CY
    from jrl_lbm_torch.parallel.halo import pad_halo
    from jrl_lbm_torch.parallel.mesh import make_mesh, split

    cfg = CY.CylinderConfig(**CYL_MAIN)
    H, W = cfg.res
    cells = H * W
    c = K.consts(cfg)
    s0, fl = CY.init(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(81)
    s0 = {k: v + 1e-5 * torch.randn(v.shape, generator=g, device=dev) for k, v in s0.items()}
    n_cmp = 23
    refs = {"full": K.make_fused_cylinder_runner(cfg, split=False)(s0, fl, n_cmp),
            "default": K.make_fused_cylinder_runner(cfg)(s0, fl, n_cmp)}
    k1 = K.make_fused_step(cfg)
    st = s0
    for _ in range(n_cmp):
        st = k1(st, fl)
    refs["k1 split"] = st
    fluid = fl["flags"] != int(CY.CellType.OBSTACLE)
    cx, cy = (int(v) for v in cfg.center)

    def cyl_shard_of(shards):
        """The index of the shard that holds the cylinder's centre."""
        return next(j for j, sh in enumerate(shards)
                    if sh.row0 <= cy < sh.row0 + sh.h and sh.col0 <= cx < sh.col0 + sh.w)

    print(f"sharded cylinder {H}x{W}, D {cfg.D:g}, Re {cfg.Re:g}: band region at k=1 "
          f"{CS._fix_regions(cfg)}, at k=4 {CS._fix_regions(cfg, 7.0)}", flush=True)
    report = {"res": [H, W], "routes": {}}
    path_counts = {k: 0 for k in CYL_SH + ("halo_pack",)}

    def drive(run, n, state, main=True):
        """``run`` for n steps, counts zeroed just before and read just
        after; a yardstick (``main`` False) adds nothing to the path's."""
        torch.cuda.synchronize()
        kernels.reset_launches()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = run(state, fl, n)
        b.record()
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launches().items() if v}
        if main:
            for k in path_counts:
                path_counts[k] += counts.get(k, 0)
        return out, a.elapsed_time(b), counts

    for label, shape, kw in CYL_SH_ROUTES:
        ny, nx = shape
        mesh = make_mesh(shape, [dev] * (ny * nx))
        run = CS.make_sharded_fused_cylinder_runner(cfg, mesh, **kw)
        stepk = run.stepk
        k = stepk.k
        i = cyl_shard_of(stepk.shards)
        sh = stepk.shards[i]
        print(f" {label}: route {stepk.route}, k {k}, shards of {sh.h}x{sh.w}, pieces {sh.k} "
              f"rows / {sh.xh} lanes", flush=True)
        rep = report["routes"][label] = {"route": stepk.route, "k": k, "shard": [sh.h, sh.w]}

        # (a) each kernel against its twin, one launch on the cylinder's shard
        f, rho, vel = (split(s0[x], mesh) for x in ("f", "rho", "vel"))
        flags, phi = split(fl["flags"], mesh), split(fl["phi_obs"], mesh)
        L = range(ny * nx)

        def close3(tag, name, got, want):
            for nm, x, y in zip(("f", "rho", "vel"), got, want):
                check_close(f"{name} {tag} {nm}", x, y, 1e-5, errs[name])

        if stepk.route == "lean":
            grp = [CS.lean_group(f[j], rho[j], vel[j], flags[j], phi[j]) for j in L]
            halos = HA.exchange(grp, mesh, sh.xh, rows=k)
            if ny > 1:
                for x, y in zip(HA.halo_pack(grp[i], rows=k), HA.halo_pack_ref(grp[i], rows=k)):
                    check_close(f"halo_pack rows k={k} {label}", x, y, 0.0, errs["halo_pack"])
            if nx > 1:
                t_, b_ = halos[i].top, halos[i].bot
                for x, y in zip(HA.halo_pack(grp[i], t_, b_, sh.xh, k),
                                HA.halo_pack_ref(grp[i], t_, b_, sh.xh, k)):
                    check_close(f"halo_pack cols xh={sh.xh} {label}", x, y, 0.0,
                                errs["halo_pack"])
            got = CS.cyl_lean_sh(f[i], halos[i], k, c, sh)
            close3(label, "cyl_lean_sh", got, CS.cyl_lean_sh_ref(f[i], halos[i], k, c, sh))
            (gr0, gr1), = stepk.regions
            nb = gr1 - gr0
            b0 = min(max(gr0 - sh.row0, 0), sh.h - nb)
            outs = [[x.clone() for x in got] for _ in range(2)]
            CS.cyl_window_sh(f[i], rho[i], vel[i], flags[i], phi[i], halos[i], k, b0, nb,
                             outs[0], c, sh)
            CS.cyl_window_sh_ref(f[i], rho[i], vel[i], flags[i], phi[i], halos[i], k, b0, nb,
                                 outs[1], c, sh)
            close3(f"{label} rows {b0}..{b0 + nb}", "cyl_window_sh", outs[0], outs[1])
            # the pass: against its twin (blocks of the plan for one SM: the
            # same bits as any plan's) and against the two launches, bit for bit
            rows_i = CS.pass_sh_rows(sh, CS.band_windows(sh, stepk.regions))
            twin = CS.cyl_pass_sh_ref(f[i], rho[i], vel[i], flags[i], phi[i], halos[i], k, rows_i,
                                      c, sh, items=CS.cyl_pass_sh_items(sh, k, rows_i, sms=1))
            got_p = CS.cyl_pass_sh(f[i], rho[i], vel[i], flags[i], phi[i], halos[i], k, rows_i,
                                   c, sh)
            close3(label, "cyl_pass_sh", got_p, twin)
            same = all(torch.equal(x, y) for x, y in zip(got_p, outs[0]))
            print(f"  cyl_pass_sh: bit for bit cyl_lean_sh + cyl_window_sh: {same}", flush=True)
            if not same:
                fail(f"sharded cylinder {label}: cyl_pass_sh differs from the two launches")
            if k > 1:
                rep["pass_items"] = len(CS.pass_sh_context(c, sh, rows_i, k, dev).items_list)
            del twin, got_p
            want_k = {"cyl_pass_sh"}
        elif stepk.route == "pieces":
            halos = HA.exchange([CS.full_group(f[j], vel[j], flags[j]) for j in L], mesh, 1)
            if nx > 1:
                grp = CS.full_group(f[i], vel[i], flags[i])
                for x, y in zip(HA.halo_pack(grp, halos[i].top, halos[i].bot, 1),
                                HA.halo_pack_ref(grp, halos[i].top, halos[i].bot, 1)):
                    check_close(f"halo_pack one-lane cols {label}", x, y, 0.0,
                                errs["halo_pack"])
            close3(label, "cyl_block_sh",
                   CS.cyl_block_sh(f[i], rho[i], vel[i], flags[i], phi[i], halos[i], c, sh),
                   CS.cyl_block_sh_ref(f[i], rho[i], vel[i], flags[i], phi[i], halos[i], c, sh))
            want_k = {"cyl_block_sh"}
        else:
            fp, velp, flp = (pad_halo(x, mesh) for x in (f, vel, flags))
            close3(label, "cyl_block_sh",
                   CS.cyl_block_sh(fp[i], rho[i], velp[i], flp[i], phi[i], None, c, sh),
                   CS.cyl_block_sh_ref(fp[i], rho[i], velp[i], flp[i], phi[i], None, c, sh))
            want_k = {"cyl_block_sh"}
        if stepk.route != "padded" and ny * nx > 1:
            want_k = want_k | {"halo_pack"}
        del f, rho, vel, flags, phi

        # (b) the main path: 23 steps, counts zeroed just before and read just after
        got, _, counts = drive(run, n_cmp, s0)
        print(f"  {n_cmp} steps: launches {counts}", flush=True)
        if set(counts) != want_k:
            fail(f"sharded cylinder {label}: launched {counts}, expected {sorted(want_k)}")
        rep["launches_23"] = counts
        if stepk.route != "lean":
            for nm in ("f", "rho", "vel"):
                if not torch.equal(got[nm], refs["full"][nm]):
                    d = float((got[nm] - refs["full"][nm]).abs().max())
                    fail(f"sharded cylinder {label} {nm}: not bit for bit the unsharded "
                         f"split=False runner (max |diff| {d:.3e})")
            print(f"  {n_cmp} steps bit for bit the unsharded split=False runner", flush=True)
            rep["bit_for_bit_split_false"] = True
        else:
            dev_max = {}
            for nm, tol in (("f", 2e-5), ("rho", 2e-5), ("vel", 2e-4)):
                m = fluid.expand_as(got[nm])
                d = float((got[nm][m] - refs["default"][nm][m]).abs().max())
                dev_max[nm] = d
                print(f"  {n_cmp} steps vs the unsharded default runner, non-OBSTACLE {nm}: "
                      f"max |diff| {d:.3e} (tol {tol:g})", flush=True)
                if not d <= tol or not torch.isfinite(got[nm]).all():
                    fail(f"sharded cylinder {label} {nm}: {d:.3e} from the unsharded runner")
            rep["max_dev_vs_unsharded"] = dev_max
            # the yardstick: the same bits
            yrun = CS.make_sharded_fused_cylinder_runner(cfg, mesh, route="launches", **kw)
            yout, _, ycounts = drive(yrun, n_cmp, s0, main=False)
            same = all(torch.equal(got[nm], yout[nm]) for nm in ("f", "rho", "vel"))
            print(f"  {n_cmp} steps through route=launches ({ycounts}): bit for bit {same}",
                  flush=True)
            if not same:
                fail(f"sharded cylinder {label}: the pass differs from route=launches")
            rep["bit_for_bit_launches"] = same
            del yout
            if k == 1:
                ref1 = refs["k1 split"]
                same = {nm: bool(torch.equal(got[nm], ref1[nm])) for nm in ("f", "rho", "vel")}
                same_fluid = {nm: bool(torch.equal(got[nm][fluid.expand_as(got[nm])],
                                                   ref1[nm][fluid.expand_as(got[nm])]))
                              for nm in ("rho", "vel")}
                rows = torch.nonzero((got["f"] != ref1["f"]).any(0).any(1)).flatten().tolist()
                print(f"  vs the unsharded k=1 split steps: bit for bit {same}, on non-OBSTACLE "
                      f"cells {same_fluid}; f rows differing {rows[:8]}"
                      f"{'...' if len(rows) > 8 else ''}", flush=True)
                rep["vs_k1_split"] = {"equal": same, "equal_non_obstacle": same_fluid,
                                      "f_rows_differing": rows}
        del got

        # (c) bench.py's windows on the lean routes
        if stepk.route == "lean":
            state, _, _ = drive(run, 20, s0)
            windows = []
            for _ in range(3):
                state, ms, counts = drive(run, 600, state)
                windows.append({"us_per_step": ms * 1e3 / 600, "launches": counts})
            best = min(w_["us_per_step"] for w_ in windows)
            pst = {"s": state}

            def prof(nn):
                pst["s"] = run(pst["s"], fl, nn)

            times, wall = device_profile(prof, 600)
            busy = sum(times.values()) / (wall * 1e6) if wall else None
            if not all(torch.isfinite(v).all() for v in pst["s"].values()):
                fail(f"sharded cylinder {label}: state not finite after the windows")
            rep.update({"windows": windows, "best_us_per_step": best, "mlups": cells / best,
                        "busy_share": busy,
                        "device_us_per_step": sum(times.values()) / 600 if wall else None,
                        "device_us_by_function": times})
            print(f"  best of 3 600-step windows: {best:.3f} us/step ({cells / best:.1f} MLUPS)"
                  f", busy {busy if busy is None else f'{busy:.1%}'}, device "
                  f"{rep['device_us_per_step']} us/step; unsharded runner "
                  f"{unsharded_us if unsharded_us is None else f'{unsharded_us:.3f}'} us/step; "
                  f"launches a window {windows[0]['launches']}", flush=True)
            # beside it, not the main path: the two launches, by the same protocol
            yrun = CS.make_sharded_fused_cylinder_runner(cfg, mesh, route="launches", **kw)
            yst, _, _ = drive(yrun, 20, s0, main=False)
            ywin = []
            for _ in range(3):
                yst, ms, ycounts = drive(yrun, 600, yst, main=False)
                ywin.append(ms * 1e3 / 600)
            yp = {"s": yst}

            def yprof(nn):
                yp["s"] = yrun(yp["s"], fl, nn)

            ytimes, ywall = device_profile(yprof, 600)
            ydev = sum(ytimes.values()) / 600 if ywall else None
            rep["yardstick_launches"] = {
                "windows_us_per_step": ywin, "best_us_per_step": min(ywin),
                "device_us_per_step": ydev, "launches_600": ycounts,
                "device_us_by_function": ytimes}
            print(f"  beside it, route=launches: best {min(ywin):.3f} us/step, device {ydev} "
                  f"us/step, launches a window {ycounts}", flush=True)
            del state, pst, yst, yp

    for k in CYL_SH_PATH:
        if path_counts[k] < 1:
            fail(f"sharded cylinder main path: {k} was not launched")
    report["main_launches"] = path_counts

    # (d) each kernel alone at the main path's shapes: the lean pass and
    # the window of the default route (k = 1; k = 4 in the report) on the
    # (4, 1) shard with the band, PIECES on the (2, 2) shard with the
    # cylinder (PADDED and the one-lane columns of halo_pack in the report)
    obs = (fl["flags"] == int(CY.CellType.OBSTACLE)).float()
    nbr_obs = torch.nn.functional.max_pool2d(obs[None, None], 3, 1, 1)[0, 0] > 0
    coupled = (fl["phi_obs"] > -1e-10) & (fl["phi_obs"] <= 1.0) & nbr_obs & (obs == 0)
    meshes = {(4, 1): make_mesh((4, 1), [dev] * 4), (2, 2): make_mesh((2, 2), [dev] * 4),
              (1, 1): make_mesh((1, 1), [dev])}

    def case(label, shape, k):
        """``(kernel call, twin call, bytes, operations, shard)`` of one
        launch at the main path's shapes (bytes: each input once with its
        pieces, each output once)."""
        mesh = meshes[shape]
        co = (cy // (H // shape[0]), cx // (W // shape[1]))
        sh = CS.CylShard.of(H, W, shape, co, k, k)
        i = mesh.local.index(co)
        f, rho, vel = (split(s0[x], mesh) for x in ("f", "rho", "vel"))
        flags, phi = split(fl["flags"], mesh), split(fl["phi_obs"], mesh)
        L, hw = range(len(mesh.local)), sh.h * sh.w
        halo_words = 2 * sh.w * sh.k * (shape[0] > 1) + 2 * (sh.h + 2 * sh.k) * sh.xh
        if label.startswith("cyl_block_sh") or label.startswith("halo_pack"):
            halos = HA.exchange([CS.full_group(f[j], vel[j], flags[j]) for j in L], mesh, 1)
            if label.startswith("halo_pack"):
                grp = CS.full_group(f[i], vel[i], flags[i])
                t_, b_ = halos[i].top, halos[i].bot
                return (lambda: HA.halo_pack(grp, t_, b_, 1),
                        lambda: HA.halo_pack_ref(grp, t_, b_, 1),
                        4 * 2 * 2 * 12 * (sh.h + 2), 0, sh)
            args = (f[i], rho[i], vel[i], flags[i], phi[i], halos[i], c, sh)
            if "PADDED" in label:
                fp, velp, flp = (pad_halo(x, mesh) for x in (f, vel, flags))
                args = (fp[i], rho[i], velp[i], flp[i], phi[i], None, c, sh)
                halo_words = 2 * (sh.w + sh.h + 2)
            nc = int(sh.body(coupled).sum())
            return (lambda: CS.cyl_block_sh(*args), lambda: CS.cyl_block_sh_ref(*args),
                    4 * ((14 + 12) * hw + 12 * halo_words),
                    CYL_FLOPS * hw + CYL_COUPLE_FLOPS * nc, sh)
        halos = HA.exchange([CS.lean_group(f[j], rho[j], vel[j], flags[j], phi[j]) for j in L],
                            mesh, sh.xh, rows=k)
        if label.startswith("cyl_pass_sh"):
            # bytes: f with its k-row and k-lane halo in, 12 planes out; on the
            # band rows vel, flags and phi in with their halo rows, rho on
            # their OBSTACLE cells; operations: the lean and the full cells
            rows_i = CS.pass_sh_rows(sh, CS.band_windows(sh, CS._fix_regions(cfg, 4.0 + k - 1)))
            nbr = sum(y1 - y0 for y0, y1 in rows_i[1])
            b_ = rows_i[1][0] if rows_i[1] else (0, 0)
            n_obs = int((sh.body(fl["flags"])[b_[0]:b_[1]] == int(CY.CellType.OBSTACLE)).sum())
            nc = int(sh.body(coupled)[b_[0]:b_[1]].sum())
            halo_k = 2 * sh.w * k * (shape[0] > 1) + 2 * (sh.h + 2 * k) * k * (shape[1] > 1)
            args = (f[i], rho[i], vel[i], flags[i], phi[i], halos[i], k, rows_i, c, sh)
            return (lambda: CS.cyl_pass_sh(*args),
                    lambda: CS.cyl_pass_sh_ref(*args, items=CS.cyl_pass_sh_items(sh, k, rows_i,
                                                                                   sms=1)),
                    4 * (9 * (hw + halo_k) + 12 * hw + 4 * (nbr + 2 * k) * sh.w + n_obs),
                    (CYL_FLOPS * hw + CYL_COUPLE_FLOPS * nc) * k, sh)
        if label.startswith("cyl_lean_sh"):
            return (lambda: CS.cyl_lean_sh(f[i], halos[i], k, c, sh),
                    lambda: CS.cyl_lean_sh_ref(f[i], halos[i], k, c, sh),
                    4 * (9 * (hw + halo_words) + 12 * hw), CYL_FLOPS * hw * k, sh)
        (gr0, gr1), = CS._fix_regions(cfg, margin=4.0 + (k - 1))
        nb = gr1 - gr0
        b0 = min(max(gr0 - sh.row0, 0), sh.h - nb)
        outs = [torch.empty_like(f[i]), torch.empty_like(rho[i]), torch.empty_like(vel[i])]
        wargs = (f[i], rho[i], vel[i], flags[i], phi[i], halos[i], k, b0, nb, outs, c, sh)
        nc = int(sh.body(coupled)[b0:b0 + nb].sum())
        return (lambda: CS.cyl_window_sh(*wargs), lambda: CS.cyl_window_sh_ref(*wargs),
                4 * (14 * (nb + 2 * k) * sh.w + 12 * nb * sh.w),
                (CYL_FLOPS * nb * sh.w + CYL_COUPLE_FLOPS * nc) * k, sh)

    rows = []
    alone = {}
    l2_flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    for row, label, shape, k in (("cyl_pass_sh", "cyl_pass_sh k=1", (4, 1), 1),
                                 (None, "cyl_pass_sh k=1 (1, 1)", (1, 1), 1),
                                 (None, "cyl_pass_sh k=4", (4, 1), 4),
                                 (None, "cyl_pass_sh k=4 (2, 2)", (2, 2), 4),
                                 ("cyl_lean_sh", "cyl_lean_sh k=1", (4, 1), 1),
                                 (None, "cyl_lean_sh k=4", (4, 1), 4),
                                 ("cyl_window_sh", "cyl_window_sh k=1", (4, 1), 1),
                                 (None, "cyl_window_sh k=4", (4, 1), 4),
                                 ("cyl_block_sh", "cyl_block_sh PIECES", (2, 2), 1),
                                 (None, "cyl_block_sh PADDED", (2, 2), 1),
                                 (None, "halo_pack one-lane cols, 12 planes", (2, 2), 1)):
        kfn, tfn, nbytes, ops, sh = case(label, shape, k)
        name = label.split()[0]
        funcs = ("halo_cols_kernel",) if name == "halo_pack" else KERNEL_FUNCS[name]
        # each timed launch finds the 50 MB L2 cold, as in the path (four
        # shards' state is ~4x the L2): a 128 MB write between launches,
        # its own time taken off; the launches queued behind a sleep kernel
        # (CUDA events), the median of three such pairs. The profiler's
        # device µs are printed beside it: in a whole run of this script
        # they came out below the byte bound where this phase alone and the
        # route's profiled windows agree with the events
        pairs = sorted(queued_ms(lambda: (l2_flush.zero_(), kfn()), 20)
                       - queued_ms(l2_flush.zero_, 20) for _ in range(3))
        ms = pairs[1]
        dev_us = kernel_us(lambda: (l2_flush.zero_(), kfn()), funcs, reps=20)
        plain_ms = cuda_ms(tfn, 1, warmup=0)
        mem_ms, ops_ms = nbytes / rate * 1e3, ops / F32_PEAK * 1e3
        bound_ms = max(mem_ms, ops_ms)
        by = "bytes" if mem_ms >= ops_ms else "operations"
        print(f"  {label:36s} {ms * 1e3:10.2f} us/launch  bound {bound_ms * 1e3:8.2f} us ({by}; "
              f"{nbytes / 1e6:.2f} MB)  {bound_ms / ms * 100:6.2f}% of bound  twin "
              f"{plain_ms:.3f} ms  (shard {sh.h}x{sh.w}; profiler {dev_us} us)", flush=True)
        alone[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
                        "bytes": nbytes, "ops": ops, "shard": [sh.h, sh.w],
                        "time_from": "events behind a sleep kernel, less the L2 flush, the "
                                     "median of three", "pairs_ms": pairs,
                        "profiler_us": dev_us}
        if row:
            src, rep_ = SOURCE[row]
            rows.append({
                "name": row, "route": "cuda", "source": src, "replaces": rep_,
                "launches": path_counts[row], "max_abs_err": max(errs[row]) if errs[row] else None,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
                "library_ms": None,
            })
    report["per_launch"] = alone
    return rows, path_counts["halo_pack"], report


# ---------------------------------------------------------------------------
# The Pe sweep (parallel/sweep.py): a row's approach lanes in one launch
# ---------------------------------------------------------------------------

SWEEP_RE = 1e-2  # the water row of the committed sweep (validation/sweep_out)
SWEEP_STEPS = 20_000  # each lane's approach, cut
SWEEP_BALANCE = 200_000  # the shared balance, cut
SWEEP_TWIN_STEPS = 340  # the longest lane of the twin check (the shortest 100)


def sweep_phases(dev, rate, errs):
    """The water Re 1e-2 row at 128x64 (seven Pe lanes, the row of the
    committed records) through ``batch_pe.run_re_row``: the fluid phase
    (335,400 steps), the shared balance (cut to ``SWEEP_BALANCE`` steps) and
    the lanes, each cut to ``SWEEP_STEPS`` steps. Counts zeroed just before
    and read just after: ``fused_fluid_cl``, ``fused_balance_cl`` and one
    ``fused_approach_lanes`` launch, nothing else. The same lanes through
    the serial route (``fused_approach_cl`` lane after lane) and one lane
    alone through the lanes kernel, timed; the records of both routes bit
    for bit equal. The lanes kernel against its twin on the row's state
    (lanes of up to ``SWEEP_TWIN_STEPS`` steps, record rows every 97
    steps), beside its bound. Returns ``(rows, report)``."""
    import numpy as np
    import torch

    from jrl_lbm_torch import batch_pe, kernels
    from jrl_lbm_torch.kernels import fused_jrl as F
    from jrl_lbm_torch.models import jrl as T
    from jrl_lbm_torch.parallel import sweep

    Pes = batch_pe.PES
    vel = SWEEP_RE * batch_pe.viscs["water"] / batch_pe.RADIUS_OBS
    args = ("water", "45degree", (128, 64), SWEEP_RE, Pes, True, vel)
    print(f"Pe sweep: water Re {SWEEP_RE:g} at 128x64, {len(Pes)} lanes (Pe {Pes}), "
          f"balance {SWEEP_BALANCE} steps, lanes cut to {SWEEP_STEPS} steps", flush=True)
    rep = {}
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res, info = batch_pe.run_re_row(*args, balance_steps=SWEEP_BALANCE, device=dev,
                                    max_steps=SWEEP_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: c for k, c in kernels.launches().items() if c}
    print(f"  run_re_row: {wall:.3f} s (fluid {info['fluid_s']:.3f}, balance "
          f"{info['balance_s']:.3f}, lanes {info['approach_s']:.3f}); route {info['route']}; "
          f"launches {counts}; rows {res.n_dumps.tolist()}", flush=True)
    if set(counts) != {"fused_fluid_cl", "fused_balance_cl", "fused_approach_lanes"} \
            or counts["fused_approach_lanes"] != 1:
        fail(f"sweep row launched {counts}")
    n_dumps = res.n_dumps
    for k in range(len(Pes)):
        r = res.records[k, :n_dumps[k]]
        if not np.isfinite(res.records).all() or (len(r) and not (r[:, 1:3] > 0).all()):
            fail(f"sweep lane Pe {Pes[k]}: records not finite and positive")
    if n_dumps[-1] < 40:
        fail(f"the fastest lane wrote {n_dumps[-1]} records in {SWEEP_STEPS} steps")
    rep["main"] = {"s": wall, "launches": counts, "n_dumps": n_dumps.tolist(),
                   **{k: info[k] for k in ("fluid_s", "balance_s", "approach_s")}}

    cfg, states, fields, _ = batch_pe.row_inputs(*args, balance_steps=SWEEP_BALANCE, device=dev)
    timed = {}
    for route in ("lanes", "serial", "lanes", "serial"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sweep.pe_sweep_approach(cfg, Pes, states, fields, max_steps=SWEEP_STEPS,
                                      route=route)
        torch.cuda.synchronize()
        timed.setdefault(route, []).append(time.perf_counter() - t0)
        if not (np.array_equal(out.records, res.records)
                and np.array_equal(out.n_dumps, res.n_dumps)):
            fail(f"sweep through the {route} route differs from run_re_row's records")
    print("  records of the lanes and serial routes bit for bit equal run_re_row's: True",
          flush=True)
    # the kernels alone: the seven lanes in one launch, one lane alone, and
    # the serial launches of the seven
    cfgs = [dataclasses.replace(cfg, Pe=p) for p in Pes]
    ns = [min(c.total_steps, SWEEP_STEPS) for c in cfgs]
    dumps = [[s for s in T.c_dump_steps(c) if s < n] for c, n in zip(cfgs, ns)]
    segs = [F.lane_segments(c, d, n) for c, d, n in zip(cfgs, dumps, ns)]
    n_rows = max(len(d) for d in dumps)
    vf = fields["vel_field"]

    def lanes(idx):
        return lambda: F.fused_approach_lanes(
            states["h"][idx], states["C"][idx], vf, 0, [ns[i] for i in idx],
            [segs[i] for i in idx], n_rows, [cfgs[i] for i in idx], fields)

    def serial():
        for i, c in enumerate(cfgs):
            run = F.make_fused_approach_runner(c, vf)
            st, cur = {"h": states["h"][i], "C": states["C"][i]}, 0
            for s in dumps[i] + [ns[i] - 1]:
                if s + 1 > cur:
                    st, _ = run(st, fields, cur, s + 1 - cur)
                cur = s + 1

    every = list(range(len(Pes)))
    ms = {"7 lanes": cuda_ms(lanes(every), 3, warmup=1),
          "1 lane (Pe 1e-3)": cuda_ms(lanes([0]), 3, warmup=1),
          "serial": cuda_ms(serial, 2, warmup=1)}
    active, regs, local = F.lanes_info(cfg, 0)
    print(f"  lanes kernel: {active} clusters of 16 at once on this card, {regs} registers, "
          f"{local} local bytes", flush=True)
    print(f"  cut row ({SWEEP_STEPS} steps a lane, {sum(ns)} lane-steps): sweep wall lanes "
          f"{min(timed['lanes']):.4f} s, serial {min(timed['serial']):.4f} s; kernels alone: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
          + f"; 7 lanes / 1 lane {ms['7 lanes'] / ms['1 lane (Pe 1e-3)']:.3f}, serial / lanes "
          f"{ms['serial'] / ms['7 lanes']:.3f}; the launch {ms['7 lanes'] * 1e3 / max(ns):.3f} us "
          f"a step of its longest lane, {ms['7 lanes'] * 1e3 / sum(ns):.3f} us a lane-step",
          flush=True)
    rep.update(sweep_wall_s=timed, kernel_ms=ms, active_clusters=active, registers=regs,
               local_bytes=local, lane_steps=sum(ns))

    # the kernel against its twin on the row's state: lanes of unequal
    # length, a record row every 97 steps
    tn = [SWEEP_TWIN_STEPS - 40 * i for i in every]
    tdumps = [list(range(96, n - 3, 97)) for n in tn]
    tsegs = [F.lane_segments(c, d, n) for c, d, n in zip(cfgs, tdumps, tn)]
    t_rows = max(len(d) for d in tdumps)
    got = F.fused_approach_lanes(states["h"], states["C"], vf, 0, tn, tsegs, t_rows, cfgs, fields)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    want = F.fused_approach_lanes_ref(states["h"], states["C"], vf, 0, tn, tsegs, t_rows, cfgs,
                                      fields)
    ev[1].record()
    torch.cuda.synchronize()
    plain_ms = ev[0].elapsed_time(ev[1])
    check_close("fused_approach_lanes h", got[0], want[0], 2e-5, errs["fused_approach_lanes"])
    check_close("fused_approach_lanes C", got[1], want[1], 2e-5, errs["fused_approach_lanes"])
    g_rows, w_rows = got[2].cpu().numpy(), want[2].cpu().numpy()
    worst = float(np.max(np.abs(g_rows - w_rows) / (1e-4 + 2e-4 * np.abs(w_rows))))
    print(f"  fused_approach_lanes record sums ({t_rows} rows a lane): worst |diff| / (1e-4 + "
          f"2e-4 |twin|) = {worst:.3g}", flush=True)
    if not worst <= 1.0 or not np.abs(w_rows[:, :, :2]).sum() > 0:
        fail("fused_approach_lanes record sums differ from the twin's")

    def twin_call():
        return F.fused_approach_lanes(states["h"], states["C"], vf, 0, tn, tsegs, t_rows, cfgs,
                                      fields)

    k_ms = cuda_ms(twin_call, 5, warmup=1)
    H, W = cfg.eff_res
    b_last = max(T.frame_pair(n - 1, c.vel_obs_conv, int(vf.shape[0]))[0]
                 for c, n in zip(cfgs, tn))
    ins = [fields["base_flags"], vf[:b_last + 2], fields["area"], states["h"]]
    outs = list(got)
    nbytes = sum(t.numel() * t.element_size() for t in ins + outs)
    mem_ms = nbytes / rate * 1e3
    ops_ms = FLOPS_PER_CELL["fused_approach_lanes"] * H * W * sum(tn) / F32_PEAK * 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = F.card_limits("fused_approach", 0).cluster
    lane_ms = FLOPS_PER_CELL["fused_approach_lanes"] * H * W * max(tn) / F32_PEAK * 1e3 \
        * sms / blocks
    bound_ms = max(mem_ms, ops_ms)
    print(f"  fused_approach_lanes {k_ms * 1e3:10.2f} us ({len(tn)} lanes, {sum(tn)} lane-steps)"
          f"  bound {bound_ms * 1e3:.2f} us ({'bytes' if mem_ms >= ops_ms else 'operations'}; "
          f"{nbytes / 1e6:.2f} MB); the longest lane on {blocks} of {sms} SMs "
          f"{lane_ms * 1e3:.2f} us  twin {plain_ms:.3f} ms", flush=True)
    rep["per_launch"] = {"ms": k_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "mem_ms": mem_ms, "ops_ms": ops_ms, "cluster_bound_ms": lane_ms,
                         "lane_steps": sum(tn), "bytes": nbytes}
    src, replaces = SOURCE["fused_approach_lanes"]
    row = {"name": "fused_approach_lanes", "route": "cuda", "source": src, "replaces": replaces,
           "launches": counts["fused_approach_lanes"],
           "max_abs_err": max(errs["fused_approach_lanes"]), "ms": k_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": "bytes" if mem_ms >= ops_ms else "operations",
           "library_ms": None}
    return [row], rep


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from unittest import mock

    from jrl_lbm_torch import jrl_main, kernels
    from jrl_lbm_torch.kernels import build, fused_jrl, jrl_c, jrl_fluid
    from jrl_lbm_torch.kernels import jrl_tiled as JT
    from jrl_lbm_torch.models import jrl as T

    dev = torch.device("cuda")
    t_start, marks = time.perf_counter(), {}

    def stamp(label):
        """Print and keep the seconds from the start to the start of a phase."""
        marks[label] = time.perf_counter() - t_start
        print(f"[chip_smoke +{marks[label]:.1f} s] {label}", flush=True)

    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)
    t_build = build.build_all()
    print(f"built {len(build.NAMES)} kernels in {t_build:.1f} s; the slowest: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in sorted(build.build_seconds.items(), key=lambda x: -x[1])[:4]),
        flush=True)
    for k, log in build.build_log.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {k}: {'; '.join(regs)}", flush=True)
    sass = sass_check(build)
    rate = next((r for key, r in MEM_RATE.items() if key in name), MEM_RATE_DEFAULT)
    report = {"device": smi, "torch": torch.__version__, "build_s": t_build,
              "build_seconds": dict(build.build_seconds), "sass": sass,
              "cluster": cluster_choice(fused_jrl, T.JRLFluidConfig().eff_res)}

    errs = {k: [] for k in kernels.KERNELS}
    TOL = {"f": 2e-5, "rho": 2e-5, "vel": 2e-4, "h": 2e-5, "C": 2e-5}

    # ---- 0. the cylinder channel: kernels against twins, the 2048² path ----
    stamp("0. cylinder")
    cyl_rows, report["cylinder"] = cylinder_phases(dev, rate, errs)

    # ---- 0e. the cylinder demo: goldens, the default run, .plt ----
    stamp("0e. cylinder demo")
    report["cylinder_demo"], demo_launches = cylinder_demo_phases(dev, rate, errs)
    for r in cyl_rows:
        if r["name"] == "cyl_pass":
            r["launches"] += demo_launches
            r["max_abs_err"] = max(errs["cyl_pass"])

    # ---- 0b. the cylinder channel in bf16 storage, and the shedding gate ----
    stamp("0b. storage and shedding gate")
    storage_rows, report["cylinder_storage"] = storage_phases(dev, rate, report["cylinder"])

    # ---- 0a. the shear layer: the periodic kernel, run_shear, 2048² windows ----
    stamp("0a. shear layer")
    shear_rows, report["shear"] = shear_phases(dev, rate, errs)

    # ---- 0c. the JRL case on a mesh of shards: kernels, runners, NCCL ----
    stamp("0c. sharded JRL")
    sharded_rows, report["sharded"] = sharded_phases(dev, rate, errs)

    # ---- 0d. the cylinder channel on a mesh of shards: kernels, routes ----
    stamp("0d. sharded cylinder")
    cyl_sh_rows, cyl_sh_halo, report["cyl_sharded"] = cyl_sharded_phases(
        dev, rate, errs, report["cylinder"]["best"]["us_per_step"])
    for r in sharded_rows:  # halo_pack serves both sharded paths
        if r["name"] == "halo_pack":
            r["launches"] += cyl_sh_halo
            r["max_abs_err"] = max(errs["halo_pack"])

    def equal_bits(tag, got, want, must=True):
        """Whether ``got`` equals ``want`` bit for bit; fail if not and
        ``must``."""
        diff = max(float((g - w).abs().max()) for g, w in zip(got, want))
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"  {tag:44s} bit for bit: {same} (max |diff| {diff:.3e})", flush=True)
        if must and not same:
            fail(f"{tag}: not bit for bit")
        return same

    # ---- 1. each per-step kernel against its twin ----
    stamp("1. per-step kernels")
    def fluid_cfg(shape, refine, **kw):
        return T.JRLFluidConfig(**dict(dict(res=(128, 64), Re=4.0, vel_obs_real=0.2848,
                                            gravity_strength_real=-9.8, shape=shape,
                                            refine=refine), **kw))

    def c_cfg(shape, refine, **kw):
        return T.JRLCConfig(**dict(dict(res=(128, 64), Re=4.0, Pe=5.0, vel_obs_real=0.2848,
                                        shape=shape, refine=refine), **kw))

    def route_kernel(name, cfg):
        """The kernel `fused_jrl.fused_route` takes for phase ``name`` on the
        config's grid."""
        route = fused_jrl.fused_route(name, *cfg.eff_res, fused_jrl.card_limits(name, 0),
                                      jrl_fluid.sm_count(dev))
        return name + ROUTE_SUFFIX[route]

    cases = (("ethaline", 8), ("cylinder", 1))
    frames = {}
    for shape, refine in cases:
        fc, cc = fluid_cfg(shape, refine), c_cfg(shape, refine)
        H, W = fc.eff_res
        multi = fused_jrl.fits(fc)
        print(f"compare kernels with twins: {shape} {H}x{W}", flush=True)
        s, fl = T.fluid_init(fc, dev)
        s = T.make_fluid_runner(fc)(s, fl, 0, 20)
        k0 = 20
        a = jrl_fluid.fluid_a(s["f"], s["rho"], s["vel"], k0, fc, fl)
        ar = jrl_fluid.fluid_a_ref(s["f"], s["rho"], s["vel"], k0, fc, fl)
        for nm, g, w, tol in zip(("f", "rho", "vel"), a, ar, (1e-5, 1e-5, 1e-4)):
            check_close(f"fluid_a 1 step {nm}", g, w, tol, errs["fluid_a"])
        b = jrl_fluid.fluid_b(*ar, k0, fc, fl)
        br = jrl_fluid.fluid_b_ref(*ar, k0, fc, fl)
        check_close("fluid_b 1 step f", b, br, 1e-5, errs["fluid_b"])
        sk = T.make_per_step_fluid_runner(fc)(s, fl, k0, 100)
        sr = T.make_fluid_runner(fc)(s, fl, k0, 100)
        for nm in ("f", "rho", "vel"):
            check_close(f"fluid 100 steps {nm}", sk[nm], sr[nm], TOL[nm], errs["fluid_a"])
        if multi:
            sp = T.pick_fluid_runner(fc)(s, fl, k0, 100)
            for nm in ("f", "rho", "vel"):
                check_close(f"fluid 100 steps (pick) {nm}", sp[nm], sr[nm], TOL[nm],
                            errs[route_kernel("fused_fluid", fc)])
        # three stored frames from the fluid run, normalized as the
        # snapshots of run_fluid_phase
        frames[shape] = torch.stack([s["vel"], sr["vel"], sk["vel"]]) / fc.vel_obs

        st, cf, flags = T.c_init(cc, dev)
        st = T.make_balance_runner(cc, flags)(st, cf, 20)
        h, C = jrl_c.c_balance(st["h"], st["C"], flags, cc, cf)
        hr, Cr = jrl_c.c_balance_ref(st["h"], st["C"], flags, cc, cf)
        check_close("c_balance 1 step h", h, hr, 1e-5, errs["c_balance"])
        check_close("c_balance 1 step C", C, Cr, 1e-5, errs["c_balance"])
        bk = T.make_per_step_balance_runner(cc, flags)(st, cf, 100)
        br_ = T.make_balance_runner(cc, flags)(st, cf, 100)
        for nm in ("h", "C"):
            check_close(f"c_balance 100 steps {nm}", bk[nm], br_[nm], TOL[nm], errs["c_balance"])
        if multi:
            bp = T.pick_balance_runner(cc, flags)(st, cf, 100)
            for nm in ("h", "C"):
                check_close(f"balance 100 steps (pick) {nm}", bp[nm], br_[nm], TOL[nm],
                            errs[route_kernel("fused_balance", cc)])

        vf = frames[shape]
        vel = T.stored_velocity(vf, 5, cc.vel_obs_conv)
        acc = torch.zeros(4, device=dev)
        h, C = jrl_c.c_approach(bk["h"], bk["C"], vel, 5, cc, cf, acc)
        hr, Cr, ints = jrl_c.c_approach_ref(bk["h"], bk["C"], vel, 5, cc, cf)
        check_close("c_approach 1 step h", h, hr, 1e-5, errs["c_approach"])
        check_close("c_approach 1 step C", C, Cr, 1e-5, errs["c_approach"])
        check_close("c_approach 1 step integrals", acc,
                    torch.stack([ints[0], ints[1], ints[2], ints[3]]), 1e-4, [])
        acc_p = torch.zeros(4, device=dev)
        hp, Cp = jrl_c.c_approach_pass(bk["h"], vf, 5, cc, cf, acc_p)
        check_close("c_approach_pass 1 step h", hp, hr, 1e-5, errs["c_approach_pass"])
        check_close("c_approach_pass 1 step C", Cp, Cr, 1e-5, errs["c_approach_pass"])
        check_ints("c_approach_pass 1 step", acc_p, ints)
        equal_bits("c_approach_pass 1 step = the pair (h, C, ints)", [hp, Cp, acc_p], [h, C, acc])
        ar_, acc_r = T.make_approach_runner(cc)(bk, dict(cf, vel_field=vf), 0, 100)
        keys = ("inflow_sum", "current_sum", "rec_u", "rec_v")
        runs = [("c_approach_pass", T.make_per_step_approach_runner),
                ("c_approach", lambda c, v: T.make_per_step_approach_runner(c, v, route="pair"))]
        if multi:
            runs.append((route_kernel("fused_approach", cc), T.pick_approach_runner))
        for k, make in runs:
            ak, acc_k = make(cc, vf)(bk, cf, 0, 100)
            for nm in ("h", "C"):
                check_close(f"{k} 100 steps {nm}", ak[nm], ar_[nm], TOL[nm], errs[k])
            check_ints(f"{k} 100 steps", [acc_k[x] for x in keys], [acc_r[x] for x in keys])

    # ---- 2. each multi-step kernel against its twin, one launch ----
    stamp("2. multi-step kernels")
    def frame_field(H, W, n, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return 0.5 * torch.randn((n, 2, H, W), generator=g, device=dev)

    n_fused, n_fluid = 200, 100  # steps of a launch held to its twin (the fluid's the slowest)
    for shape, refine, negs in (("ethaline", 1, (True, False)), ("cylinder", 1, (True, False)),
                                ("ethaline", 2, (True, False)), ("ethaline", 4, (True,))):
        fc = fluid_cfg(shape, refine)
        H, W = fc.eff_res
        # both routes where the default grid takes the cluster kernels; the
        # route fused_route takes at 256x128 and 512x256 (MC_ROUTE)
        want_k = {p: p + "_cl" for p in FUSED} if refine == 1 else MC_ROUTE[refine]
        for phase in FUSED:
            if route_kernel(phase, fc) != want_k[phase]:
                fail(f"{phase} at {H}x{W}: route {route_kernel(phase, fc)}, expected "
                     f"{want_k[phase]}")
        routes = fused_jrl.ROUTES if refine == 1 else (None,)
        # the approach's multi-cluster kernel, forced where the route is another
        a_routes = routes if want_k["fused_approach"].endswith(("_cl", "_mc")) else (None,
                                                                                   "clusters")
        print(f"compare multi-step kernels with twins: {shape} {H}x{W}, {n_fused} steps (the "
              f"fluid {n_fluid}), routes {routes}", flush=True)
        s, fl = T.fluid_init(fc, dev)
        s = T.make_fluid_runner(fc)(s, fl, 0, 20)
        want = fused_jrl.fused_fluid_ref(s["f"], s["rho"], s["vel"], 20, n_fluid, fc, fl)
        for route in routes:
            k = want_k["fused_fluid"] if route is None else (
                "fused_fluid_cl" if route == "cluster" else "fused_fluid")
            got = fused_jrl.fused_fluid(s["f"], s["rho"], s["vel"], 20, n_fluid, fc, fl,
                                        route=route)
            for nm, g, w in zip(("f", "rho", "vel"), got, want):
                check_close(f"{k} {nm}", g, w, TOL[nm], errs[k])
        for neg in negs:
            cc = c_cfg(shape, refine, is_negative=neg)
            st, cf, flags = T.c_init(cc, dev)
            st = T.make_balance_runner(cc, flags)(st, cf, 20)
            want = fused_jrl.fused_balance_ref(st["h"], st["C"], flags, n_fused, cc, cf)
            for route in routes:
                k = want_k["fused_balance"] if route is None else (
                    "fused_balance_cl" if route == "cluster" else "fused_balance")
                got = fused_jrl.fused_balance(st["h"], st["C"], flags, n_fused, cc, cf,
                                              route=route)
                for nm, g, w in zip(("h", "C"), got, want):
                    check_close(f"{k} neg={neg} {nm}", g, w, TOL[nm], errs[k])
            # tip speed 0.0025 (a new frame every 40 steps), then Pe = 5
            # (the tip crosses rows)
            Pe_frames = 0.0025 * cc.radius_obs / (0.5 / 3.0)
            for label, ca in (("frames", c_cfg(shape, refine, is_negative=neg, Pe=Pe_frames)),
                              ("rows", cc)):
                sa, cfa, fla = T.c_init(ca, dev)
                sa = T.make_balance_runner(ca, fla)(sa, cfa, 20)
                vf = frame_field(H, W, 8, seed=refine)
                v = ca.vel_obs_conv
                n_frames_crossed = int((n_fused - 1) * v / 0.1)
                rows = T.tip_walks(ca.inflow_height, n_fused - 1, v)[1] - T.tip_walks(
                    ca.inflow_height, 0, v)[1]
                print(f"  approach ({label}): Pe {ca.Pe:.4g}, tip speed {v:.4g}, "
                      f"{n_frames_crossed} frame boundaries, {rows} tip rows", flush=True)
                if (label == "frames" and n_frames_crossed < 3) or (label == "rows" and rows < 1):
                    fail(f"approach ({label}) check does not cross what it should")
                hr, Cr, ints = fused_jrl.fused_approach_ref(sa["h"], sa["C"], vf, 0, n_fused,
                                                            ca, cfa)
                for route in a_routes:
                    k = want_k["fused_approach"] if route is None else ROUTE_KERNEL[
                        ("fused_approach", route)]
                    acc = torch.zeros(4, device=dev)
                    h, C = fused_jrl.fused_approach(sa["h"], sa["C"], vf, 0, n_fused, ca, cfa, acc,
                                                    route=route)
                    check_close(f"{k} {label} neg={neg} h", h, hr, TOL["h"], errs[k])
                    check_close(f"{k} {label} neg={neg} C", C, Cr, TOL["C"], errs[k])
                    check_ints(f"{k} {label}", acc, ints)

    stamp("2. cluster kernels against the cooperative ones")
    print("cluster kernels against the cooperative ones: one 1000-step launch at 128x64",
          flush=True)
    ints_bits = report.setdefault("fused_approach_cl_integrals_bit_for_bit", {})

    def approach_cl_equal(cc, st, cf, start, tag):
        """fused_approach_cl against fused_approach over one 1000-step
        launch from ``start`` (frames every ~390 steps at the default tip
        speed): h and C bit for bit; the integrals within rtol 2e-4 / atol
        1e-4, and whether they are bit for bit too."""
        H_, W_ = cc.eff_res
        n_fr = int((start + 1001) * cc.vel_obs_conv / T.X_INTERVAL) + 2
        vf_ = frame_field(H_, W_, n_fr, seed=11)
        out = {}
        for r in ("cluster", "coop"):
            acc_ = torch.zeros(4, device=dev)
            out[r] = list(fused_jrl.fused_approach(st["h"], st["C"], vf_, start, 1000, cc, cf,
                                                   acc_, route=r)) + [acc_]
        equal_bits(f"fused_approach_cl {tag} (h, C)", out["cluster"][:2], out["coop"][:2])
        check_ints(f"fused_approach_cl {tag} vs coop", out["cluster"][2], out["coop"][2])
        ints_bits[tag] = equal_bits(f"fused_approach_cl {tag} integrals", out["cluster"][2:],
                                    out["coop"][2:], must=False)
    for fc, cc in ((T.JRLFluidConfig(), T.JRLCConfig()),
                   (fluid_cfg("45degree", 1), c_cfg("45degree", 1, is_negative=False))):
        s, fl = T.fluid_init(fc, dev)
        s = T.make_fluid_runner(fc)(s, fl, 0, 20)
        equal_bits(f"fused_fluid_cl {fc.shape} Re {fc.Re:g}", *(
            fused_jrl.fused_fluid(s["f"], s["rho"], s["vel"], 20, 1000, fc, fl, route=r)
            for r in ("cluster", "coop")))
        st, cf, flags = T.c_init(cc, dev)
        st = T.make_balance_runner(cc, flags)(st, cf, 20)
        equal_bits(f"fused_balance_cl {cc.shape} neg={cc.is_negative}", *(
            fused_jrl.fused_balance(st["h"], st["C"], flags, 1000, cc, cf, route=r)
            for r in ("cluster", "coop")))
        approach_cl_equal(cc, st, cf, 0, f"{cc.shape} neg={cc.is_negative}")
    # across 2**24, at a tip speed that keeps the tip in the grid there
    cc = T.JRLCConfig(Pe=1e-5)
    st, cf, _ = T.c_init(cc, dev)
    approach_cl_equal(cc, noisy(st, dev, 24), cf, 2**24 - 500, "across 2**24")

    stamp("2. multi-cluster kernels against the cooperative ones")
    print("multi-cluster kernels against the cooperative ones: one 1000-step launch at "
          "256x128 and 512x256", flush=True)
    for refine in (2, 4):
        fc = fluid_cfg("ethaline", refine)
        H, W = fc.eff_res
        s, fl = T.fluid_init(fc, dev)
        s = noisy(s, dev, 40 + refine)
        equal_bits(f"fused_fluid_mc {H}x{W}", *(
            fused_jrl.fused_fluid(s["f"], s["rho"], s["vel"], 20, 1000, fc, fl, route=r)
            for r in ("clusters", "coop")))
        for neg in (True, False):
            cc = c_cfg("ethaline", refine, is_negative=neg)
            st, cf, flags = T.c_init(cc, dev)
            st = noisy(st, dev, 42 + refine)
            equal_bits(f"fused_balance_mc {H}x{W} neg={neg}", *(
                fused_jrl.fused_balance(st["h"], st["C"], flags, 1000, cc, cf, route=r)
                for r in ("clusters", "coop")))
        # the approach: the ethaline case's own tip speed from step 3000, and
        # the wedge and the flat tip at 0.005 rows a step across a handover
        # of the disk row from one cluster to the next
        for shape, res_, speed in (("ethaline", None, None), ("ethaline", None, 0.005),
                                   ("cylinder", (H, W), 0.005)):
            kw = dict(res=res_, refine=1) if res_ else dict(refine=refine)
            ca = T.JRLCConfig(shape=shape, **kw)
            if speed:
                ca = T.JRLCConfig(shape=shape, Re=4.0, Pe=speed * ca.radius_obs / (0.5 / 3.0), **kw)
            sa, cfa, _ = T.c_init(ca, dev)
            sa = noisy(sa, dev, 46 + refine)
            plan = fused_jrl.mc_plan("fused_approach", H, W,
                                     fused_jrl.card_limits("fused_approach", 0))
            start = handover_start(T, ca, plan, 1000) if speed else 3000
            vfa = frame_field(H, W, T.frame_pair(start + 1001, ca.vel_obs_conv, 2**31)[0] + 2,
                              seed=47)
            out = {}
            for r in ("clusters", "coop"):
                acc_ = torch.zeros(4, device=dev)
                out[r] = list(fused_jrl.fused_approach(sa["h"], sa["C"], vfa, start, 1000, ca,
                                                       cfa, acc_, route=r)) + [acc_]
            held = len({disk_band(T, ca, plan, x) for x in (start, start + 999)}) == 1
            tag = (f"fused_approach_mc {shape} {H}x{W} from {start} "
                   f"({'one block' if held else 'handover'})")
            equal_bits(f"{tag} (h, C)", out["clusters"][:2], out["coop"][:2])
            check_ints(f"{tag} vs coop", out["clusters"][2], out["coop"][2])
            equal_bits(f"{tag} integrals", out["clusters"][2:], out["coop"][2:], must=held)
    for shape, res in itertools.product(("45degree", "cylinder"), ((256, 128), (512, 256))):
        fc = fluid_cfg(shape, 1, res=res, Re=1.2e-5, vel_obs_real=28e-6)
        tag = f"{shape} fused_fluid_mc {res[0]}x{res[1]}"
        s, fl = T.fluid_init(fc, dev)
        s = noisy(s, dev, 44)
        equal_bits(f"{tag} across 2**24", *(
            fused_jrl.fused_fluid(s["f"], s["rho"], s["vel"], 2**24 - 100, 200, fc, fl, route=r)
            for r in ("clusters", "coop")))
        want_ = fused_jrl.fused_fluid_ref(s["f"], s["rho"], s["vel"], 2**24 - 5, 10, fc, fl)
        got_ = fused_jrl.fused_fluid_mc(s["f"], s["rho"], s["vel"], 2**24 - 5, 10, fc, fl)
        # the kernel row's error comes from the grid the main path runs it on
        for nm, g_, w in zip(("f", "rho", "vel"), got_, want_):
            check_close(f"{tag} {nm}", g_, w, TOL[nm],
                        errs["fused_fluid_mc"] if res == (256, 128) else [])

    stamp("2. the fluid's tiles against the cooperative kernel")
    print("fused_fluid_tl against fused_fluid: one 1000-step launch at 256x128 and 512x256 "
          "across a tip row and from step 2**24 - 5", flush=True)
    for (shape, res), small in itertools.product(
            itertools.product(TL_SHAPES, ((256, 128), (512, 256))), (False, True)):
        kw = dict(Re=1.2e-5, vel_obs_real=28e-6) if small else {}
        fc = fluid_cfg(shape, res[0] // 128, **kw) if shape == "ethaline" \
            else fluid_cfg(shape, 1, res=res, **kw)
        s, fl = T.fluid_init(fc, dev)
        s = noisy(s, dev, 60 + small)
        if small:
            start = 2**24 - 5
        else:  # a start from which the launch crosses a tip row
            row0 = T.tip_walks(fc.inflow_height, 0, fc.vel_obs)[1]
            start = max(0, int((row0 + 0.5 - fc.inflow_height) / fc.vel_obs) - 500)
        rows = [T.tip_walks(fc.inflow_height, x, fc.vel_obs)[1] for x in (start, start + 999)]
        if (not small and rows[1] == rows[0]) or not 1 < rows[1] < res[0] - 1:
            fail(f"fused_fluid_tl {shape} {res}: the launch from {start} crosses no tip row "
                 f"inside the grid ({rows})")
        x = (s["f"], s["rho"], s["vel"])
        equal_bits(f"fused_fluid_tl {shape} {res[0]}x{res[1]} from {start}",
                   fused_jrl.fused_fluid_tl(*x, start, 1000, fc, fl),
                   fused_jrl.fused_fluid(*x, start, 1000, fc, fl, route="coop"))

    stamp("2. the approach's rows against the cooperative kernel")
    t0 = time.perf_counter()
    proof = fused_jrl.exact_div_count(RW_PROOF_COLS)
    proof_s = time.perf_counter() - t0
    bad = [r for r in proof if r[1] or r[2]]
    report["exact_div_proof"] = {"divisors": len(proof), "seconds": proof_s, "bad": bad}
    print(f"RcpDiv against __fdiv_rn over all 2^32 float32 numerators: {len(proof)} divisors "
          f"(CS2F, CS4F, sqrt(2), r = x + 0.5 for x < {RW_PROOF_COLS}) in {proof_s:.2f} s; "
          f"{sum(r[1] for r in proof)} numerators differ", flush=True)
    if bad:
        fail(f"RcpDiv differs from __fdiv_rn: {bad[:4]}")
    print("fused_approach_rw against fused_approach: one 1000-step launch at 256x128 and "
          "512x256 across a stored frame and from step 2**24 - 5", flush=True)
    for (shape, res), small in itertools.product(
            itertools.product(TL_SHAPES, ((256, 128), (512, 256))), (False, True)):
        # the default case's approach at refine 2 or 4, the other tips at that grid
        kw = dict(Pe=1e-5) if small else {}
        ca = T.JRLCConfig(shape=shape, refine=res[0] // 128, **kw) if shape == "ethaline" \
            else T.JRLCConfig(res=res, shape=shape, **kw)
        v = ca.vel_obs_conv
        sa, cfa, _ = T.c_init(ca, dev)
        sa = noisy(sa, dev, 70 + small)
        # from 2**24 - 5, or from a start whose launch crosses a stored frame
        start = 2**24 - 5 if small else max(0, int(T.X_INTERVAL / v) - 500)
        b_end = T.frame_pair(start + 999, v, 2**31)[0]
        vfa = frame_field(*res, b_end + 2, seed=71)
        crossed = b_end - T.frame_pair(start, v, 2**31)[0]
        row_end = T.tip_walks(ca.inflow_height, start + 999, v)[1]
        if (not small and crossed < 1) or not 1 < row_end < res[0] - 1:
            fail(f"fused_approach_rw {shape} {res}: the launch from {start} crosses "
                 f"{crossed} frames, ends at tip row {row_end}")
        out = {}
        for r in ("rows", "coop"):
            acc_ = torch.zeros(4, device=dev)
            out[r] = list(fused_jrl.fused_approach(sa["h"], sa["C"], vfa, start, 1000, ca, cfa,
                                                   acc_, route=r)) + [acc_]
        equal_bits(f"fused_approach_rw {shape} {res[0]}x{res[1]} from {start} (h, C, sums)",
                   out["rows"], out["coop"])

    print("fluid steps 2**24 - 5 .. 2**24 + 4 at 128x64", flush=True)
    for shape in ("45degree", "cylinder"):
        fc = fluid_cfg(shape, 1, Re=1.2e-5, vel_obs_real=28e-6)
        start = 2**24 - 5
        s, fl = T.fluid_init(fc, dev)
        g = torch.Generator(device=dev).manual_seed(24)
        s = {k: v + 1e-3 * torch.randn(v.shape, generator=g, device=dev) for k, v in s.items()}
        want = fused_jrl.fused_fluid_ref(s["f"], s["rho"], s["vel"], start, 10, fc, fl)
        got = {r: fused_jrl.fused_fluid(s["f"], s["rho"], s["vel"], start, 10, fc, fl, route=r)
               for r in fused_jrl.ROUTES}
        per_step = T.make_per_step_fluid_runner(fc)(s, fl, start, 10)
        for nm, g_, gc, w in zip(("f", "rho", "vel"), got["cluster"], got["coop"], want):
            check_close(f"{shape} fused_fluid_cl {nm}", g_, w, TOL[nm], errs["fused_fluid_cl"])
            check_close(f"{shape} fused_fluid {nm}", gc, w, TOL[nm], errs["fused_fluid"])
            check_close(f"{shape} fluid_a/b {nm}", per_step[nm], w, TOL[nm], errs["fluid_a"])
        equal_bits(f"{shape} fused_fluid_cl across 2**24", got["cluster"], got["coop"])

    # ---- 2a. the tile-class kernels and the tiled runner at 1024x512 ----
    stamp("2a. tile classes")
    report["tiled"] = tiled_checks(dev, fluid_cfg, errs)

    # ---- 3. the main path at 1024x512 ----
    stamp("3. 1024x512 path")
    phases = {}

    def run_phase(pname, kernel_names, fn, n, cells, yardstick=False):
        """Run ``fn(n)`` with the launch counts zeroed just before and read
        just after; every kernel of ``kernel_names`` must have launched and
        no other. Then device time by kernel over a profiled repeat. A
        yardstick phase is timed beside the main path and is not part of
        it."""
        fn(10)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(n)
        end.record()
        torch.cuda.synchronize()
        counts = kernels.launches()
        ms = start.elapsed_time(end)
        rec = {"steps": n, "ms": ms, "ms_per_step": ms / n, "mlups": cells * n / (ms * 1e3),
               "launches": dict(counts), "yardstick": yardstick}
        phases[pname] = rec
        print(f"  {pname:18s} {n} steps {ms / n * 1e3:.3f} us/step  "
              f"{cells * n / (ms * 1e3):.1f} MLUPS  launches "
              f"{ {k: c for k, c in counts.items() if c} }", flush=True)
        for k in kernels.KERNELS:
            if k in kernel_names and counts[k] < 1:
                fail(f"{pname}: kernel {k} was not launched")
            if k not in kernel_names and counts[k]:
                fail(f"{pname}: kernel {k} launched {counts[k]} times off this path")
        times, wall = device_profile(fn, n)
        busy = sum(times.values())
        if wall:
            per_launch = {}
            for k in kernel_names:
                us = sum(t for nm, t in times.items() if any(f in nm for f in KERNEL_FUNCS[k]))
                per_launch[k] = us / counts[k] if us > 0 else None
            rec.update({
                "device_us_per_step": busy / n,
                "wall_us_per_step_profiled": wall * 1e6 / n,
                "busy_share": busy / (wall * 1e6),
                "kernel_us_per_launch": per_launch,
                "device_us_by_function": times,
            })
            print(f"    profiled repeat: device busy {busy / n:.3f} us/step of "
                  f"{wall * 1e6 / n:.3f} us wall (busy {busy / (wall * 1e6):.1%}); "
                  f"device us per launch {per_launch}", flush=True)
        return out

    fc, cc = fluid_cfg("ethaline", 8), c_cfg("ethaline", 8)
    H, W = fc.eff_res
    cells = H * W
    n = 1000
    print(f"main path {H}x{W}: {n} steps per phase (the fluid phase through fluid_pass, C "
          f"through the per-step kernels)", flush=True)

    def stepper(cfg, run, state, fields, cur):
        """``fn(k)``: k more steps of ``run`` from step ``cur``."""
        box = {"s": state, "cur": cur}

        def steps(k):
            box["s"] = run(box["s"], fields, box["cur"], k)
            box["cur"] += k
            return box["s"]

        return steps

    def fluid_phases(tag, cfg, state, fields, start):
        """The fluid phase from ``start`` through ``pick_fluid_runner``
        (``fluid_pass``), and as yardsticks through the two tile classes and
        through the per-step pair; returns the main path's state."""
        if JT.make_tiled_fluid_runner(cfg).route != "pass":
            fail(f"{tag}: the tiled runner does not take fluid_pass")
        out = run_phase(tag, ("fluid_pass",), stepper(cfg, T.pick_fluid_runner(cfg), state,
                                                      fields, start), n, cells)
        run_phase(f"{tag} classes", ("fluid_k", "fluid_k_lean"),
                  stepper(cfg, JT.make_tiled_fluid_runner(cfg, route="classes"), state, fields,
                          start), n, cells, yardstick=True)
        run_phase(f"{tag} per-step", ("fluid_a", "fluid_b"),
                  stepper(cfg, T.make_per_step_fluid_runner(cfg), state, fields, start), n,
                  cells, yardstick=True)
        for rest in ("classes", "per-step"):
            a, b = phases[tag], phases[f"{tag} {rest}"]
            print(f"  {tag}: fluid_pass {a.get('device_us_per_step', float('nan')):.3f} device / "
                  f"{a['ms_per_step'] * 1e3:.3f} wall us/step against {rest} "
                  f"{b.get('device_us_per_step', float('nan')):.3f} / {b['ms_per_step'] * 1e3:.3f}",
                  flush=True)
        if not all(torch.isfinite(v).all() for v in out.values()):
            fail(f"{tag}: state not finite")
        return out

    s, fl = T.fluid_init(fc, dev)
    sf = fluid_phases("fluid", fc, s, fl, 0)
    # the middle of the default refine-8 case's travel: full rows
    # [(0,640),(960,1024)], lean [(640,960)], on a noisy state
    fmid, mid = T.JRLFluidConfig(shape="ethaline", refine=8), PASS_PLAN_STEPS[1]
    mid_rows = {(c[0], str(JT.class_rows(H, 64, 1, *c[3:]) if c[0] == "split" else None))
                for c in JT.chunk_plan(fmid, mid, n)}
    if mid_rows != {("split", str(([(0, 640), (960, 1024)], [], [(640, 960)])))}:
        fail(f"the plan from step {mid}: {mid_rows}, expected full rows [(0,640),(960,1024)]")
    sm_, flm = T.fluid_init(fmid, dev)
    fluid_phases("fluid mid-travel", fmid, noisy(sm_, dev, 7), flm, mid)
    # a flat tip at 1024x512 from a step with below-tip tiles, through the
    # same pick: fluid_pass on the full and lean rows, fluid_k_bt below the tip
    fcyl = fluid_cfg("cylinder", 1, res=(1024, 512))
    sc, flc = T.fluid_init(fcyl, dev)
    s_bt = split_step(JT, fcyl, 1, True)[0]
    out = run_phase("fluid flat", ("fluid_pass", "fluid_k_bt"),
                    stepper(fcyl, T.pick_fluid_runner(fcyl), noisy(sc, dev, 5), flc, s_bt), n,
                    cells)
    if not all(torch.isfinite(v).all() for v in out.values()):
        fail("flat fluid state not finite")
    # the late travel of the ethaline case: no lean tile left, the JAX
    # runner's _tiled_chunk, here the per-step pair
    late = 41_280
    if any(kind != "ab" for kind, *_ in JT.chunk_plan(fc, late, 300)):
        fail(f"the ethaline plan still splits from step {late} on")
    out = run_phase("fluid late travel", ("fluid_a", "fluid_b"),
                    stepper(fc, T.pick_fluid_runner(fc), noisy(s, dev, 6), fl, late), 100, cells)
    if not all(torch.isfinite(v).all() for v in out.values()):
        fail("late-travel fluid state not finite")
    tiled_launch = {"ethaline": JT.class_rows(H, JT.pick_tile_rows(fc), 1,
                                               *JT.chunk_plan(fc, 0, 8)[0][3:]),
                    "cylinder": JT.class_rows(H, JT.pick_tile_rows(fcyl), 1,
                                              *JT.chunk_plan(fcyl, s_bt, 8)[0][3:])}
    vel_field = torch.stack([s["vel"], sf["vel"], sf["vel"]]) / fc.vel_obs

    st, cf, flags = T.c_init(cc, dev)
    bal_run = T.pick_balance_runner(cc, flags)
    bstate = {"s": st}

    def balance_steps(k):
        bstate["s"] = bal_run(bstate["s"], cf, k)
        return bstate["s"]

    sb = run_phase("balance", ("c_balance",), balance_steps, n, cells)

    def approach_stepper(run, state, fields, cur):
        """``fn(k)``: k more steps of the approach runner ``run`` from step
        ``cur``; its last acc in ``fn.acc``."""
        box = {"s": state, "cur": cur}

        def steps(k):
            box["s"], steps.acc = run(box["s"], fields, box["cur"], k)
            box["cur"] += k
            return box["s"]

        return steps

    def approach_phases(tag, cfg, state, fields, frames, start, b0=0, n_frames=None):
        """The approach from ``start`` through ``c_approach_pass`` once a
        step (the runner ``pick_approach_runner`` gives this grid, here with
        the frame window ``frames`` from frame ``b0`` of ``n_frames``), and
        as yardsticks through the c_approach pair after PyTorch's lerp and
        through the pair alone (the lerped velocity of ``start`` for every
        step). The pass and the pair with the lerp run the same steps and
        must end bit for bit alike (h, C, the integrals)."""
        if T.pick_approach_runner(cfg, frames).route != "pass":
            fail(f"{tag}: pick_approach_runner does not take c_approach_pass")
        main = approach_stepper(T.make_per_step_approach_runner(
            cfg, frames, b0=b0, n_frames=n_frames), state, fields, start)
        out = run_phase(tag, ("c_approach_pass",), main, n, cells)
        pair = approach_stepper(T.make_per_step_approach_runner(
            cfg, frames, route="pair", b0=b0, n_frames=n_frames), state, fields, start)
        out_pair = run_phase(f"{tag} pair", ("c_approach",), pair, n, cells, yardstick=True)
        keys = ("inflow_sum", "current_sum", "rec_u", "rec_v")
        equal_bits(f"{tag}: pass = pair (h, C, integrals)",
                   [out["h"], out["C"]] + [main.acc[k] for k in keys],
                   [out_pair["h"], out_pair["C"]] + [pair.acc[k] for k in keys])
        vel0 = T.stored_velocity(frames, start, cfg.vel_obs_conv, b0, n_frames)
        alone = {"s": state}

        def pair_alone(k):
            h_, C_ = alone["s"]["h"], alone["s"]["C"]
            acc_ = torch.zeros(4, device=dev)
            for i in range(k):
                h_, C_ = jrl_c.c_approach(h_, C_, vel0, start + i, cfg, fields, acc_)
            alone["s"] = {"h": h_, "C": C_}
            return alone["s"]

        run_phase(f"{tag} pair alone", ("c_approach",), pair_alone, n, cells, yardstick=True)
        for rest in ("pair", "pair alone"):
            a, b = phases[tag], phases[f"{tag} {rest}"]
            print(f"  {tag}: c_approach_pass {a.get('device_us_per_step', float('nan')):.3f} "
                  f"device / {a['ms_per_step'] * 1e3:.3f} wall us/step (busy "
                  f"{a.get('busy_share', float('nan')):.1%}) against {rest} "
                  f"{b.get('device_us_per_step', float('nan')):.3f} / "
                  f"{b['ms_per_step'] * 1e3:.3f} (busy {b.get('busy_share', float('nan')):.1%})",
                  flush=True)
        acc_ = main.acc
        print(f"  {tag} integrals: inflow_sum {float(acc_['inflow_sum']):.6g} "
              f"current_sum {float(acc_['current_sum']):.6g}", flush=True)
        if not (torch.isfinite(out["C"]).all() and float(acc_["inflow_sum"]) > 0):
            fail(f"{tag}: state not finite or inflow not positive")
        return out

    print(f"c_approach_pass against the pair (bit for bit) and its twin on the default "
          f"refine-8 case's plans", flush=True)
    c8 = T.JRLCConfig(shape="ethaline", refine=8)
    n_fr8 = T.frame_pair(c8.total_steps - 1, c8.vel_obs_conv, 2**31)[0] + 1
    st8, cf8, _ = T.c_init(c8, dev)
    for start, m in ((0, 2), (10_170_450, 2), (c8.total_steps - 2, 2), (2**24 - 5, 10)):
        bs = [T.frame_pair(x, c8.vel_obs_conv, n_fr8) for x in (start, start + m - 1)]
        b0, b1 = bs[0][0], bs[1][0] + int(bs[1][2])
        win = frame_field(H, W, b1 - b0 + 1, seed=start % 97)
        s_ = noisy(st8, dev, start % 89)
        h_, C_ = s_["h"], s_["C"]
        for x in range(start, start + m):
            acc_p, acc_q = torch.zeros(4, device=dev), torch.zeros(4, device=dev)
            hp, Cp = jrl_c.c_approach_pass(h_, win, x, c8, cf8, acc_p, b0=b0, n_frames=n_fr8)
            vel_ = T.stored_velocity(win, x, c8.vel_obs_conv, b0, n_fr8)
            hq, Cq = jrl_c.c_approach(h_, C_, vel_, x, c8, cf8, acc_q)
            equal_bits(f"c_approach_pass step {x} = the pair", [hp, Cp, acc_p], [hq, Cq, acc_q])
            hr, Cr, ints = jrl_c.c_approach_pass_ref(h_, win, x, c8, cf8, b0, n_fr8)
            check_close(f"c_approach_pass step {x} h", hp, hr, 1e-5, errs["c_approach_pass"])
            check_close(f"c_approach_pass step {x} C", Cp, Cr, 1e-5, errs["c_approach_pass"])
            check_ints(f"c_approach_pass step {x}", acc_p, ints)
            h_, C_ = hp, Cp

    approach_phases("approach", cc, sb, cf, vel_field, 0)
    # the middle of the default refine-8 case's travel, on a noisy state,
    # with a two-frame window of its history at that step's frame index
    mid8 = 10_170_450
    b8 = T.frame_pair(mid8, c8.vel_obs_conv, n_fr8)[0]
    if T.frame_pair(mid8 + 2 * n + 10, c8.vel_obs_conv, n_fr8)[0] != b8:
        fail("the mid-travel approach plan leaves its two-frame window")
    print(f"  approach mid-travel: the default refine-8 case ({c8.total_steps} steps) from step "
          f"{mid8}, frames {b8}, {b8 + 1} of {n_fr8}", flush=True)
    approach_phases("approach mid-travel", c8, noisy(st8, dev, 8), cf8,
                    frame_field(H, W, 2, seed=8), mid8, b8, n_fr8)
    report["approach_mid_plan"] = {"step": mid8, "b0": b8, "n_frames": n_fr8}

    # host µs a step of the approach (the enqueue, device work excluded):
    # the pair after PyTorch's lerp through its checked wrapper, the pass
    # through its checked wrapper and as the runner makes it, unchecked on
    # the context it checked once a run; 50 calls, fewer than the launches
    # the card queues, so that the host never waits on the device
    sa0 = noisy(sb, dev, 9)
    hp_bufs = [(torch.empty_like(sa0["h"]), torch.empty_like(sa0["C"])) for _ in range(2)]
    acc_h = torch.zeros(4, device=dev)
    pctx = jrl_c.approach_pass_ctx(sa0["h"], hp_bufs, vel_field, 0, 1, cc, cf, acc_h)
    host = {}
    for label, call in (
            ("pair + lerp, checked", lambda: jrl_c.c_approach(
                sa0["h"], sa0["C"], T.stored_velocity(vel_field, 0, cc.vel_obs_conv), 0, cc, cf,
                acc_h)),
            ("pass, checked", lambda: jrl_c.c_approach_pass(sa0["h"], vel_field, 0, cc, cf,
                                                            acc_h, out=hp_bufs[0])),
            ("pass, runner", lambda: jrl_c.c_approach_pass(sa0["h"], vel_field, 0, cc, cf, acc_h,
                                                           out=hp_bufs[0], ctx=pctx))):
        with torch.cuda.device(dev):
            call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                call()
            host[label] = (time.perf_counter() - t0) / 50 * 1e6
            torch.cuda.synchronize()
    report["approach_host_us"] = host
    print("  host us per approach step: " + ", ".join(f"{k} {v:.2f}" for k, v in host.items()),
          flush=True)

    # ---- 4. each per-step kernel alone, and its twin, at 1024x512 ----
    stamp("4. per-step kernels alone")
    rows, tiled_rows = [], []

    def row(k, ms, plain_ms, ins, outs, steps, cells_, launches, timed_from):
        nbytes = sum(t.numel() * t.element_size() for t in ins + outs)
        mem_ms = nbytes / rate * 1e3
        ops_ms = FLOPS_PER_CELL[k] * cells_ * steps / F32_PEAK * 1e3
        bound_ms = max(mem_ms, ops_ms)
        print(f"  {k:14s} {ms * 1e3:10.2f} us  bound {bound_ms * 1e3:8.2f} us "
              f"({'bytes' if mem_ms >= ops_ms else 'operations'}; {nbytes / 1e6:.2f} MB, "
              f"{steps} steps)  {bound_ms / ms * 100:6.2f}% of bound  twin {plain_ms:.3f} ms",
              flush=True)
        phases.setdefault("per_launch", {})[k] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "mem_ms": mem_ms,
            "ops_ms": ops_ms, "bytes": nbytes, "steps": steps, "time_from": timed_from}
        src, rep = SOURCE[k]
        rows.append({
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches, "max_abs_err": max(errs[k]) if errs[k] else None,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if mem_ms >= ops_ms else "operations",
            "library_ms": None,
        })

    s, fl = T.fluid_init(fc, dev)
    f, rho, vel = s["f"], s["rho"], s["vel"]
    a_out = jrl_fluid.fluid_a(f, rho, vel, 0, fc, fl)
    st, cf, flags = T.c_init(cc, dev)
    vel_c = T.stored_velocity(vel_field, 0, cc.vel_obs_conv)
    acc0 = torch.zeros(4, device=dev)
    runs = {
        "fluid_a": (lambda: jrl_fluid.fluid_a(f, rho, vel, 0, fc, fl),
                    lambda: jrl_fluid.fluid_a_ref(f, rho, vel, 0, fc, fl),
                    [f, rho, vel], list(a_out)),
        "fluid_b": (lambda: jrl_fluid.fluid_b(*a_out, 0, fc, fl),
                    lambda: jrl_fluid.fluid_b_ref(*a_out, 0, fc, fl),
                    list(a_out), [f]),
        "c_balance": (lambda: jrl_c.c_balance(st["h"], st["C"], flags, cc, cf),
                      lambda: jrl_c.c_balance_ref(st["h"], st["C"], flags, cc, cf),
                      [flags, st["h"], st["C"]], [st["h"], st["C"]]),
        "c_approach": (lambda: jrl_c.c_approach(st["h"], st["C"], vel_c, 0, cc, cf, acc0),
                       lambda: jrl_c.c_approach_ref(st["h"], st["C"], vel_c, 0, cc, cf),
                       [cf["base_flags"], st["h"], vel_c, cf["area"], acc0],
                       [st["h"], st["C"], acc0]),
        # the bytes: the two frames the step reads, not the lerped plane
        "c_approach_pass": (lambda: jrl_c.c_approach_pass(st["h"], vel_field, 0, cc, cf, acc0),
                            lambda: jrl_c.c_approach_pass_ref(st["h"], vel_field, 0, cc, cf),
                            [cf["base_flags"], st["h"], vel_field[:2], cf["area"], acc0],
                            [st["h"], st["C"], acc0]),
    }
    print(f"per launch at {H}x{W} (memory rate {rate / 1e12:.2f} TB/s):", flush=True)
    main_phases = [p for p in phases.values() if not p.get("yardstick")]
    main_launches = {k: sum(p["launches"].get(k, 0) for p in main_phases)
                     for k in PER_STEP + ("c_approach_pass",) + TILED}

    def main_us(k):
        """The kernel's device µs per launch on the main path (profiler),
        else in a yardstick phase (the tile classes since fluid_pass)."""
        return next((p["kernel_us_per_launch"][k] for p in main_phases + list(phases.values())
                     if (p.get("kernel_us_per_launch") or {}).get(k)), None)

    for k in PER_STEP + ("c_approach_pass",):
        kfn, tfn, ins, outs = runs[k]
        call_ms = cuda_ms(kfn, 200)
        # the kernel's device time on the main path (profiler), else the
        # event time of back-to-back wrapper calls (host time included)
        dev_us = main_us(k)
        ms = dev_us / 1e3 if dev_us else call_ms
        row(k, ms, cuda_ms(tfn, 5, warmup=1), ins, outs, 1, cells, main_launches[k],
            "profiler" if dev_us else "events")
        phases["per_launch"][k]["wrapper_call_ms"] = call_ms

    # the tile-class kernels and fluid_pass at the main path's first pass
    # (k = 1): the ethaline step 0 (full + lean) and the flat tip's
    # (full + below-tip + lean); device µs per launch from the profiled
    # phases (the main path's, else the classes' yardstick)
    s, fl = T.fluid_init(fc, dev)
    o = {key: torch.empty_like(v) for key, v in s.items()}
    sc = noisy(T.fluid_init(fcyl, dev)[0], dev, 5)
    full, _, lean = tiled_launch["ethaline"]
    _, bt, _ = tiled_launch["cylinder"]
    truns = {
        "fluid_k": (lambda fn: fn(s["f"], s["rho"], s["vel"], o, full, 0, 1, fc), JT.fluid_k_ref,
                    full),
        "fluid_k_lean": (lambda fn: fn(s["f"], o, lean, 1, fc), JT.fluid_k_lean_ref, lean),
        "fluid_k_bt": (lambda fn: fn(sc["f"], sc["rho"], sc["vel"], o, bt, 1, fcyl),
                       JT.fluid_k_bt_ref, bt),
        "fluid_pass": (lambda fn: fn(s["f"], s["rho"], s["vel"], o, full, lean, 0, fc),
                       JT.fluid_pass_ref, full + lean),
    }
    for k in TILED:
        call, twin, segs = truns[k]
        kfn = getattr(JT, k)
        call_ms = cuda_ms(lambda: call(kfn), 100)
        dev_us = main_us(k)
        if k == "fluid_pass":
            nbytes, ops = pass_bytes(full, lean, H, W)
            ops_ms = ops / F32_PEAK * 1e3
            for step, plan in report["tiled"]["pass_plans"].items():
                plan["bound_ms"] = max(plan["bytes"] / rate * 1e3, plan["ops"] / F32_PEAK * 1e3)
                print(f"  fluid_pass bound at the step-{step} plan: "
                      f"{plan['bound_ms'] * 1e3:.2f} us ({plan['bytes'] / 1e6:.2f} MB)", flush=True)
        else:
            nbytes, cells_l = tile_bytes(k, segs, 1, H, W)
            ops_ms = FLOPS_PER_CELL[k] * cells_l / F32_PEAK * 1e3
        mem_ms = nbytes / rate * 1e3
        row_tiled = dict(ms=dev_us / 1e3 if dev_us else call_ms,
                         plain_ms=cuda_ms(lambda: call(twin), 2, warmup=1),
                         bound_ms=max(mem_ms, ops_ms), mem_ms=mem_ms, ops_ms=ops_ms, bytes=nbytes,
                         rows=segs, wrapper_call_ms=call_ms,
                         time_from="profiler" if dev_us else "events")
        phases["per_launch"][k] = row_tiled
        print(f"  {k:14s} {row_tiled['ms'] * 1e3:10.2f} us  bound {row_tiled['bound_ms'] * 1e3:8.2f}"
              f" us ({'bytes' if mem_ms >= ops_ms else 'operations'}; {nbytes / 1e6:.2f} MB, rows "
              f"{segs})  {row_tiled['bound_ms'] / row_tiled['ms'] * 100:6.2f}% of bound  twin "
              f"{row_tiled['plain_ms']:.3f} ms", flush=True)
        src, rep_ = SOURCE[k]
        tiled_rows.append({
            "name": k, "route": "cuda", "source": src, "replaces": rep_,
            "launches": main_launches[k], "max_abs_err": max(errs[k]) if errs[k] else None,
            "ms": row_tiled["ms"], "plain_ms": row_tiled["plain_ms"],
            "bound_ms": row_tiled["bound_ms"],
            "bound_by": "bytes" if mem_ms >= ops_ms else "operations", "library_ms": None,
        })

    # host µs of one k_pass call (the enqueue, device work excluded): through
    # the checked wrappers (each call checks its tensors, enters the device
    # and looks up the stream), and as the runner makes it, unchecked on a
    # context it checked once a run
    segs, ctx, kp = (full, [], lean), JT._launch_ctx(dev), {}
    for label, route, c in (("classes, checked", "classes", None),
                            ("pass, checked", "pass", None),
                            ("classes, runner", "classes", ctx), ("pass, runner", "pass", ctx)):
        def k_pass(route=route, c=c):
            JT.k_pass(s, o, segs, 0, 1, fc, route, c)

        with torch.cuda.device(dev):
            k_pass()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                k_pass()
            kp[label] = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
    report["k_pass_host_us"] = kp
    print("  host us per k_pass call: " + ", ".join(f"{k} {v:.2f}" for k, v in kp.items()),
          flush=True)

    # ---- 5. the 128x64 path of the default case, multi-step kernels ----
    stamp("5. 128x64, 256x128, 512x256 paths")
    fc0, cc0 = T.JRLFluidConfig(), T.JRLCConfig()
    H, W = fc0.eff_res
    cells = H * W
    print(f"128x64 path, default case ({fc0.shape} fluid Re {fc0.Re:g}, {cc0.shape} C "
          f"Pe {cc0.Pe:g}): {fc0.total_steps} fluid, {cc0.balance_steps} balance, "
          f"{cc0.total_steps} approach steps per case", flush=True)
    first_rec = next(k for k in range(1, fc0.total_steps)
                     if int(k * fc0.vel_obs / T.X_INTERVAL) > 0)
    s0, fl0 = T.fluid_init(fc0, dev)
    frun = T.pick_fluid_runner(fc0)

    def fluid_chunks(_n):  # run_fluid_phase up to and through its first record step
        st_ = frun(s0, fl0, 0, first_rec)
        return frun(st_, fl0, first_rec, 1)

    st0, cf0, flags0 = T.c_init(cc0, dev)
    interval = max(1, cc0.balance_steps // 100)
    brun = T.pick_balance_runner(cc0, flags0)
    bal_rows = []

    def balance_chunk(_n):  # one interval of run_balance, with its host read
        out = brun(st0, cf0, interval)
        C_np = out["C"].cpu().numpy()
        bal_rows.append(float((C_np[cc0.inflow_height_int, :cc0.radius_obs_int]
                               * cc0.area_array).sum()))
        return out

    n_frames0 = fc0.total_steps // first_rec + 1
    vf0 = frame_field(H, W, n_frames0, seed=0)
    dumps, total = [], 0
    for k in T.c_dump_steps(cc0):
        dumps.append(k)
        total = k + 1
        if total >= 20000:
            break
    arun = T.pick_approach_runner(cc0, vf0)

    def approach_chunks(_n):  # run_approach over its first dumps, with its host reads
        st_, cur = st0, 0
        for k in dumps:
            st_, acc_ = arun(st_, cf0, cur, k + 1 - cur)
            cur = k + 1
            for x in ("count", "inflow_sum", "current_sum", "rec_u", "rec_v"):
                float(acc_[x])
        return st_

    path128, outs128 = {}, {}
    for pname, kname, fn, steps in (("fluid", "fused_fluid_cl", fluid_chunks, first_rec + 1),
                                    ("balance", "fused_balance_cl", balance_chunk, interval),
                                    ("approach", "fused_approach_cl", approach_chunks, total)):
        out = run_phase(f"128x64 {pname}", (kname,), fn, steps, cells)
        if not all(torch.isfinite(v).all() for v in out.values()):
            fail(f"128x64 {pname}: state not finite")
        path128[kname] = phases[f"128x64 {pname}"]
        outs128[pname] = out
    if not bal_rows[-1] > 0:
        fail("128x64 balance: inflow not positive")

    print("128x64 yardstick: the same chunks through the cooperative kernels", flush=True)

    def coop_fluid(_n):  # fluid_chunks on the cooperative kernel
        st_ = s0
        for a, m in ((0, first_rec), (first_rec, 1)):
            st_ = dict(zip(("f", "rho", "vel"), fused_jrl.fused_fluid(
                st_["f"], st_["rho"], st_["vel"], a, m, fc0, fl0, route="coop")))
        return st_

    def coop_balance(_n):  # balance_chunk on the cooperative kernel
        out = dict(zip(("h", "C"), fused_jrl.fused_balance(st0["h"], st0["C"], flags0, interval,
                                                          cc0, cf0, route="coop")))
        out["C"].cpu()
        return out

    def coop_approach(_n):  # approach_chunks on the cooperative kernel
        st_, cur = st0, 0
        for k in dumps:
            acc_ = torch.zeros(4, device=dev)
            st_ = dict(zip(("h", "C"), fused_jrl.fused_approach(
                st_["h"], st_["C"], vf0, cur, k + 1 - cur, cc0, cf0, acc_, route="coop")))
            cur = k + 1
            acc_.cpu()
        return st_

    for pname, kname, fn, steps in (("fluid", "fused_fluid", coop_fluid, first_rec + 1),
                                    ("balance", "fused_balance", coop_balance, interval),
                                    ("approach", "fused_approach", coop_approach, total)):
        out = run_phase(f"128x64 {pname} coop", (kname,), fn, steps, cells, yardstick=True)
        keys = ("f", "rho", "vel") if pname == "fluid" else ("h", "C")
        equal_bits(f"128x64 {pname} phase ({steps} steps), cluster vs coop",
                   [outs128[pname][k] for k in keys], [out[k] for k in keys])
        new, old = phases[f"128x64 {pname}"], phases[f"128x64 {pname} coop"]
        gain = old["ms_per_step"] / new["ms_per_step"]
        print(f"  {pname:9s} cluster {new['ms_per_step'] * 1e3:.3f} us/step vs cooperative "
              f"{old['ms_per_step'] * 1e3:.3f} us/step: {gain:.3f}x", flush=True)

    stamp("5. 256x128 and 512x256 paths")
    # the grids the multi-cluster kernels serve on the main path, refine 2
    # and 4: each phase through pick_* beside the other route as the
    # yardstick, bit for bit (MC_ROUTE: the route each phase must take)
    for refine in (2, 4):
        fcr, ccr = fluid_cfg("ethaline", refine), c_cfg("ethaline", refine)
        Hr, Wr = fcr.eff_res
        tag = f"{Hr}x{Wr}"
        print(f"{tag} (refine {refine}): fluid, balance and approach through pick_*, beside the "
              f"other route", flush=True)
        sr_, flr = T.fluid_init(fcr, dev)
        str_, cfr, flagsr = T.c_init(ccr, dev)
        vfr = frame_field(Hr, Wr, T.frame_pair(1000, ccr.vel_obs_conv, 2**31)[0] + 2, seed=48)

        def other(name, cfg):
            """The yardstick's route: the cooperative kernel beside the
            multi-cluster and tile kernels, the multi-cluster one beside the
            cooperative one."""
            return "coop" if route_kernel(name, cfg) != name else "clusters"

        def other_fluid_run(st_, fl_, start, k, cfg=fcr):
            return dict(zip(("f", "rho", "vel"), fused_jrl.fused_fluid(
                st_["f"], st_["rho"], st_["vel"], start, k, cfg, fl_,
                route=other("fused_fluid", cfg))))

        def balance_stepper(run, cf_=cfr, st0_=str_):
            box = {"s": st0_}

            def steps(k):
                box["s"] = run(box["s"], cf_, k)
                return box["s"]
            return steps

        def other_balance_run(st_, cf_, k, cfg=ccr, fl_=flagsr):
            return dict(zip(("h", "C"), fused_jrl.fused_balance(
                st_["h"], st_["C"], fl_, k, cfg, cf_, route=other("fused_balance", cfg))))

        def other_approach_run(st_, cf_, cur, k, cfg=ccr, vf_=vfr):
            acc_ = torch.zeros(4, device=dev)
            h_, C_ = fused_jrl.fused_approach(st_["h"], st_["C"], vf_, cur, k, cfg, cf_, acc_,
                                              route=other("fused_approach", cfg))
            return {"h": h_, "C": C_}, acc_

        for pname, kname, main, other_ in (
                ("fluid", "fused_fluid",
                 stepper(fcr, T.pick_fluid_runner(fcr), sr_, flr, 0),
                 stepper(fcr, other_fluid_run, sr_, flr, 0)),
                ("balance", "fused_balance",
                 balance_stepper(T.pick_balance_runner(ccr, flagsr)),
                 balance_stepper(other_balance_run)),
                ("approach", "fused_approach",
                 approach_stepper(T.pick_approach_runner(ccr, vfr), str_, cfr, 0),
                 approach_stepper(other_approach_run, str_, cfr, 0))):
            k_main = route_kernel(kname, ccr)
            if k_main != MC_ROUTE[refine][kname]:
                fail(f"{tag} {pname}: route {k_main}, expected {MC_ROUTE[refine][kname]}")
            k_other = ROUTE_KERNEL[(kname, other(kname, ccr))]
            out = run_phase(f"{tag} {pname}", (k_main,), main, 200, Hr * Wr)
            yard = run_phase(f"{tag} {pname} {k_other}", (k_other,), other_, 200, Hr * Wr,
                             yardstick=True)
            if not all(torch.isfinite(v).all() for v in out.values()):
                fail(f"{tag} {pname}: state not finite")
            keys = ("f", "rho", "vel") if pname == "fluid" else ("h", "C")
            equal_bits(f"{tag} {pname} phase, {k_main} vs {k_other}",
                       [out[k] for k in keys], [yard[k] for k in keys])
            new, old = phases[f"{tag} {pname}"], phases[f"{tag} {pname} {k_other}"]
            print(f"  {pname:9s} {k_main} {new['ms_per_step'] * 1e3:.3f} us/step (the path) vs "
                  f"{k_other} {old['ms_per_step'] * 1e3:.3f} us/step", flush=True)

    stamp("5. 128x64 per-step yardsticks")
    print("128x64 yardstick: the same configurations through the per-step kernels", flush=True)
    n_ps = 2000
    s_ps = {"s": s0, "cur": 0}

    def ps_fluid(k):
        f_, r_, v_ = s_ps["s"]["f"], s_ps["s"]["rho"], s_ps["s"]["vel"]
        for i in range(k):
            f_, r_, v_ = jrl_fluid.fluid_a(f_, r_, v_, s_ps["cur"] + i, fc0, fl0)
            f_ = jrl_fluid.fluid_b(f_, r_, v_, s_ps["cur"] + i, fc0, fl0)
        s_ps["cur"] += k
        s_ps["s"] = {"f": f_, "rho": r_, "vel": v_}
        return s_ps["s"]

    def ps_balance(k):
        h_, C_ = st0["h"], st0["C"]
        for _ in range(k):
            h_, C_ = jrl_c.c_balance(h_, C_, flags0, cc0, cf0)
        return {"h": h_, "C": C_}

    def ps_approach(k):
        h_, C_ = st0["h"], st0["C"]
        acc_ = torch.zeros(4, device=dev)
        for i in range(k):
            vel_ = T.stored_velocity(vf0, i, cc0.vel_obs_conv)
            h_, C_ = jrl_c.c_approach(h_, C_, vel_, i, cc0, cf0, acc_)
        return {"h": h_, "C": C_}

    run_phase("128x64 fluid per-step", ("fluid_a", "fluid_b"), ps_fluid, n_ps, cells)
    run_phase("128x64 balance per-step", ("c_balance",), ps_balance, n_ps, cells)
    run_phase("128x64 approach per-step", ("c_approach",), ps_approach, n_ps, cells)
    for pname in ("fluid", "balance", "approach"):
        new, old = phases[f"128x64 {pname}"], phases[f"128x64 {pname} per-step"]
        print(f"  {pname:9s} multi-step {new['ms_per_step'] * 1e3:.3f} us/step vs per-step "
              f"{old['ms_per_step'] * 1e3:.3f} us/step: {old['ms_per_step'] / new['ms_per_step']:.1f}x",
              flush=True)

    # ---- 6. one whole case at 128x64, multi-step and per-step ----
    stamp("6. whole case")
    fcase = T.JRLFluidConfig(res=(128, 64), Re=4.0, vel_obs_real=0.2848,
                             gravity_strength_real=0.0, shape="45degree")
    ccase = T.JRLCConfig(res=(128, 64), balance_time=0.01, Re=4.0, Pe=5.0,
                         vel_obs_real=0.2848, gravity_strength_real=0.0, shape="45degree")
    cases_out = {}
    per_step_picks = {"pick_fluid_runner": T.make_per_step_fluid_runner,
                      "pick_balance_runner": T.make_per_step_balance_runner,
                      "pick_approach_runner": T.make_per_step_approach_runner}
    for label in ("multi-step", "per-step"):
        patches = [mock.patch.object(T, k, v) for k, v in per_step_picks.items()] \
            if label == "per-step" else []
        for ptc in patches:
            ptc.start()
        try:
            kernels.reset_launches()
            t0 = time.perf_counter()
            res = jrl_main.run_case(fcase, ccase, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for ptc in patches:
                ptc.stop()
        counts = {k: c for k, c in kernels.launches().items() if c}
        want = set(PATH128 if label == "multi-step" else PER_STEP_CASE)
        if set(counts) != want:
            fail(f"whole case ({label}) launched {counts}")
        cases_out[label] = res
        print(f"whole case 128x64 ({label}): {fcase.total_steps} fluid + "
              f"{ccase.balance_steps} balance + {ccase.total_steps} approach steps in "
              f"{wall:.3f} s, {len(res.record_rows)} records, launches {counts}", flush=True)
        report.setdefault("whole_case", {})[label] = {"s": wall, "launches": counts}
        if not res.record_rows:
            fail("the case wrote no record rows")
        for r in res.record_rows:
            if not all(v == v and abs(v) != float("inf") for v in r) or r[1] <= 0 or r[2] <= 0:
                fail(f"record row not finite and positive: {r}")
    ra, rb = cases_out["multi-step"], cases_out["per-step"]
    print(f"  first record {ra.record_rows[0]}", flush=True)
    print(f"  last record  {ra.record_rows[-1]}", flush=True)
    if len(ra.record_rows) != len(rb.record_rows):
        fail("the two whole cases wrote different numbers of records")
    worst = 0.0
    for x, y in zip(ra.record_rows + ra.balance_rows, rb.record_rows + rb.balance_rows):
        for u, w in zip(x, y):
            worst = max(worst, abs(u - w) / (1e-4 + 2e-4 * abs(w)))
    print(f"  records and balance rows, multi-step vs per-step: worst |diff| / "
          f"(1e-4 + 2e-4 |per-step|) = {worst:.3g}", flush=True)
    if worst > 1.0:
        fail("the whole case differs between the multi-step and per-step kernels")
    report["whole_case"]["worst_rel"] = worst

    # ---- 6a. the Pe sweep: a row's approach lanes in one launch ----
    stamp("6a. Pe sweep")
    sweep_rows, report["sweep"] = sweep_phases(dev, rate, errs)

    stamp("7. multi-step kernels alone")
    # ---- 7. each multi-step kernel alone, and its twin: the cluster kernels
    # and the cooperative approach at 128x64, the cooperative fluid and
    # balance kernels at 512x256 ----
    n_row = 200
    print(f"multi-step kernels at {H}x{W}, one launch of {n_row} steps, and the twin "
          f"for the same steps (CUDA events):", flush=True)
    s0, fl0 = T.fluid_init(fc0, dev)
    f, rho, vel = s0["f"], s0["rho"], s0["vel"]
    fl_out = fused_jrl.fused_fluid_cl(f, rho, vel, 0, n_row, fc0, fl0)
    bl_out = fused_jrl.fused_balance_cl(st0["h"], st0["C"], flags0, n_row, cc0, cf0)
    acc1 = torch.zeros(4, device=dev)
    ap_out = fused_jrl.fused_approach(st0["h"], st0["C"], vf0, 0, n_row, cc0, cf0, acc1,
                                      route="coop")
    apc_out = fused_jrl.fused_approach_cl(st0["h"], st0["C"], vf0, 0, n_row, cc0, cf0, acc1)
    b_last = int((n_row - 1) * cc0.vel_obs_conv / T.X_INTERVAL)  # the frames the run reads
    frames_read = vf0[: min(b_last + 2, n_frames0)]
    fruns = {
        "fused_fluid_cl": (lambda: fused_jrl.fused_fluid_cl(f, rho, vel, 0, n_row, fc0, fl0),
                           lambda: fused_jrl.fused_fluid_ref(f, rho, vel, 0, n_row, fc0, fl0),
                           [f, rho, vel], list(fl_out)),
        "fused_balance_cl": (
            lambda: fused_jrl.fused_balance_cl(st0["h"], st0["C"], flags0, n_row, cc0, cf0),
            lambda: fused_jrl.fused_balance_ref(st0["h"], st0["C"], flags0, n_row, cc0, cf0),
            [flags0, st0["h"], st0["C"]], list(bl_out)),
        "fused_approach_cl": (
            lambda: fused_jrl.fused_approach_cl(st0["h"], st0["C"], vf0, 0, n_row, cc0, cf0,
                                                acc1),
            lambda: fused_jrl.fused_approach_ref(st0["h"], st0["C"], vf0, 0, n_row, cc0, cf0),
            [cf0["base_flags"], frames_read, cf0["area"], st0["h"]], list(apc_out) + [acc1]),
        "fused_approach": (
            lambda: fused_jrl.fused_approach(st0["h"], st0["C"], vf0, 0, n_row, cc0, cf0, acc1,
                                             route="coop"),
            lambda: fused_jrl.fused_approach_ref(st0["h"], st0["C"], vf0, 0, n_row, cc0, cf0),
            [cf0["base_flags"], frames_read, cf0["area"], st0["h"]], list(ap_out) + [acc1]),
    }
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # launches on the main path's phases (the yardsticks' not counted)
    launches_path = {k: sum(p_["launches"].get(k, 0) for p_ in phases.values()
                            if not p_.get("yardstick") and "launches" in p_)
                     for k in FUSED + MC + ("fused_fluid_tl", "fused_approach_rw")}
    for k in PATH128 + ("fused_approach",):
        kfn, tfn, ins, outs = fruns[k]
        row(k, cuda_ms(kfn, 5, warmup=1), cuda_ms(tfn, 1, warmup=0), ins, outs, n_row, cells,
            path128[k]["launches"][k] if k in path128 else launches_path[k], "events")
        if k in FUSED_CL:  # the operation bound of one cluster's SMs
            blocks = report["cluster"][k[:-3]]["blocks"]
            per = phases["per_launch"][k]
            per["cluster_bound_ms"] = per["ops_ms"] * sms / blocks
            print(f"    one-cluster operation bound ({blocks} of {sms} SMs): "
                  f"{per['cluster_bound_ms'] * 1e3:.2f} us", flush=True)
    n4 = 200
    grids = {}
    for refine in (2, 4):
        fcr, ccr = fluid_cfg("ethaline", refine), c_cfg("ethaline", refine)
        sr_, flr = T.fluid_init(fcr, dev)
        str_, cfr, flagsr = T.c_init(ccr, dev)
        # frames that cover the 200 steps from step 0
        vfr = frame_field(*fcr.eff_res, T.frame_pair(n4, ccr.vel_obs_conv, 2**31)[0] + 2, seed=49)
        grids[refine] = (fcr, ccr, sr_, flr, str_, cfr, flagsr, vfr)

    def fused_runs(k, refine):
        """(kernel, twin, inputs, outputs) of a 200-step launch of ``k`` at
        refine 2 or 4 (its route forced)."""
        fcr, ccr, sr_, flr, str_, cfr, flagsr, vfr = grids[refine]
        r = "clusters" if k in MC else {"fused_fluid_tl": "tiles",
                                        "fused_approach_rw": "rows"}.get(k, "coop")
        if k.startswith("fused_approach"):
            x, acc_, acc_c = (str_["h"], str_["C"]), torch.zeros(4, device=dev), \
                torch.zeros(4, device=dev)
            b_last = T.frame_pair(n4 - 1, ccr.vel_obs_conv, vfr.shape[0])[0]
            return (lambda: fused_jrl.fused_approach(*x, vfr, 0, n4, ccr, cfr, acc_, route=r),
                    lambda: fused_jrl.fused_approach_ref(*x, vfr, 0, n4, ccr, cfr),
                    [cfr["base_flags"], vfr[:b_last + 2], cfr["area"], x[0]],
                    list(fused_jrl.fused_approach(*x, vfr, 0, n4, ccr, cfr, acc_c, route="coop"))
                    + [acc_c])
        if k.startswith("fused_fluid"):
            x = (sr_["f"], sr_["rho"], sr_["vel"])
            return (lambda: fused_jrl.fused_fluid(*x, 0, n4, fcr, flr, route=r),
                    lambda: fused_jrl.fused_fluid_ref(*x, 0, n4, fcr, flr), list(x),
                    list(fused_jrl.fused_fluid(*x, 0, n4, fcr, flr, route="coop")))
        x = (str_["h"], str_["C"])
        return (lambda: fused_jrl.fused_balance(*x, flagsr, n4, ccr, cfr, route=r),
                lambda: fused_jrl.fused_balance_ref(*x, flagsr, n4, ccr, cfr),
                [flagsr] + list(x), list(fused_jrl.fused_balance(*x, flagsr, n4, ccr, cfr,
                                                                 route="coop")))

    # the rows: the cooperative fluid and balance at 512x256 (the yardsticks
    # of the tile and multi-cluster kernels there), the multi-cluster ones at
    # 256x128 (where the main path runs all three)
    print(f"the cooperative fluid and balance at 512x256 and the multi-cluster kernels at "
          f"256x128, one launch of {n4} steps, and the twin:", flush=True)
    for k, refine in (("fused_fluid", 4), ("fused_balance", 4), ("fused_fluid_mc", 2),
                      ("fused_balance_mc", 2), ("fused_approach_mc", 2)):
        kfn, tfn, ins, outs = fused_runs(k, refine)
        Hr, Wr = grids[refine][0].eff_res
        row(k, cuda_ms(kfn, 5, warmup=1), cuda_ms(tfn, 1, warmup=0), ins, outs, n4, Hr * Wr,
            launches_path[k], "events")
    # the fluid's tile kernel at 512x256, where the main path runs it: a
    # launch of TL_ROW_STEPS steps beside its twin, which plays the same
    # launch tile by tile on the card (one call, timed by events; ~4 s a
    # step there)
    fcr, _, sr_, flr = grids[4][:4]
    nz = noisy(sr_, dev, 62)
    x = (nz["f"], nz["rho"], nz["vel"])
    plan_tl = fused_jrl.tl_plan(*fcr.eff_res, sms)
    print(f"fused_fluid_tl at 512x256 ({plan_tl}), one launch of {TL_ROW_STEPS} steps, and the "
          f"twin:", flush=True)
    tl_out = list(fused_jrl.fused_fluid_tl(*x, 0, TL_ROW_STEPS, fcr, flr))
    twin_out = []
    twin_ms = cuda_ms(lambda: twin_out.extend(fused_jrl.fused_fluid_tl_ref(
        *x, 0, TL_ROW_STEPS, fcr, flr, plan_tl)), 1, warmup=0)
    for nm, g_, w in zip(("f", "rho", "vel"), tl_out, twin_out):
        check_close(f"fused_fluid_tl {TL_ROW_STEPS} steps {nm}", g_, w, TOL[nm],
                    errs["fused_fluid_tl"])
    row("fused_fluid_tl",
        cuda_ms(lambda: fused_jrl.fused_fluid_tl(*x, 0, TL_ROW_STEPS, fcr, flr), 5, warmup=1),
        twin_ms, list(x), tl_out, TL_ROW_STEPS, fcr.eff_res[0] * fcr.eff_res[1],
        launches_path["fused_fluid_tl"], "events")
    # the approach's row kernel at 512x256, where the main path runs it: a
    # launch of RW_ROW_STEPS steps beside its twin, which plays the same
    # launch run by run on the card
    _, ccr, _, _, str_, cfr, _, vfr = grids[4]
    nz = noisy(str_, dev, 72)
    plan_rw = fused_jrl.rw_plan(*ccr.eff_res, sms)
    print(f"fused_approach_rw at 512x256 ({plan_rw}), one launch of {RW_ROW_STEPS} steps, and "
          f"the twin:", flush=True)
    acc_rw = torch.zeros(4, device=dev)
    rw_out = list(fused_jrl.fused_approach_rw(nz["h"], nz["C"], vfr, 0, RW_ROW_STEPS, ccr, cfr,
                                              acc_rw))
    twin_out = []
    twin_ms = cuda_ms(lambda: twin_out.extend(fused_jrl.fused_approach_rw_ref(
        nz["h"], nz["C"], vfr, 0, RW_ROW_STEPS, ccr, cfr, plan_rw.nruns)), 1, warmup=0)
    for nm, g_, w in zip(("h", "C"), rw_out, twin_out[:2]):
        check_close(f"fused_approach_rw {RW_ROW_STEPS} steps {nm}", g_, w, TOL[nm],
                    errs["fused_approach_rw"])
    check_ints(f"fused_approach_rw {RW_ROW_STEPS} steps", acc_rw, twin_out[2])
    b_last = T.frame_pair(RW_ROW_STEPS - 1, ccr.vel_obs_conv, vfr.shape[0])[0]
    row("fused_approach_rw",
        cuda_ms(lambda: fused_jrl.fused_approach_rw(nz["h"], nz["C"], vfr, 0, RW_ROW_STEPS, ccr,
                                                    cfr, acc_rw), 5, warmup=1),
        twin_ms, [cfr["base_flags"], vfr[:b_last + 2], cfr["area"], nz["h"]],
        rw_out + [acc_rw], RW_ROW_STEPS, ccr.eff_res[0] * ccr.eff_res[1],
        launches_path["fused_approach_rw"], "events")
    # every kernel of the eight at both grids, and the plans: printed
    times = {}
    for refine in (2, 4):
        fcr = grids[refine][0]
        Hr, Wr = fcr.eff_res
        for k in FUSED + MC + ("fused_fluid_tl", "fused_approach_rw"):
            kfn = fused_runs(k, refine)[0]
            times[f"{k} {Hr}x{Wr}"] = cuda_ms(kfn, 5, warmup=1) * 1e3 / n4
        report[f"fused_approach_rw {Hr}x{Wr}"] = {
            "plan": fused_jrl.rw_plan(Hr, Wr, sms)._asdict(),
            "us_per_step": times[f"fused_approach_rw {Hr}x{Wr}"],
            "coop_us_per_step": times[f"fused_approach {Hr}x{Wr}"],
            "mc_us_per_step": times[f"fused_approach_mc {Hr}x{Wr}"],
            "route": fused_jrl.fused_route("fused_approach", Hr, Wr,
                                           fused_jrl.card_limits("fused_approach", 0), sms)}
        print(f"  fused_approach_rw {Hr}x{Wr} ({n4}-step launches): "
              f"{report[f'fused_approach_rw {Hr}x{Wr}']}", flush=True)
        report[f"fused_fluid_tl {Hr}x{Wr}"] = {
            "plan": dataclasses.asdict(fused_jrl.tl_plan(Hr, Wr, sms)),
            "us_per_step": times[f"fused_fluid_tl {Hr}x{Wr}"],
            "coop_us_per_step": times[f"fused_fluid {Hr}x{Wr}"],
            "mc_us_per_step": times[f"fused_fluid_mc {Hr}x{Wr}"],
            "route": fused_jrl.fused_route("fused_fluid", Hr, Wr,
                                           fused_jrl.card_limits("fused_fluid", 0))}
        print(f"  fused_fluid_tl {Hr}x{Wr} ({n4}-step launches): "
              f"{report[f'fused_fluid_tl {Hr}x{Wr}']}", flush=True)
        for name_ in FUSED:
            lim = fused_jrl.card_limits(name_, 0)
            plan = fused_jrl.mc_plan(name_, Hr, Wr, lim)
            blocks = plan.clusters * plan.cluster
            ops_ms = FLOPS_PER_CELL[name_] * Hr * Wr / F32_PEAK * 1e3
            report[f"{name_}_mc {Hr}x{Wr}"] = {
                "plan": plan._asdict(), "route": fused_jrl.fused_route(name_, Hr, Wr, lim),
                "us_per_step": times[f"{name_}_mc {Hr}x{Wr}"],
                "coop_us_per_step": times[f"{name_} {Hr}x{Wr}"],
                "ops_bound_us_per_step": ops_ms * 1e3,
                "sm_ops_bound_us_per_step": ops_ms * 1e3 * sms / blocks}
            print(f"  {name_}_mc {Hr}x{Wr}: {report[f'{name_}_mc {Hr}x{Wr}']}", flush=True)
    for refine in (2, 4):
        report[f"refine_{refine}_case"] = case_launches(fused_jrl, T, refine)
        print(f"  the default ethaline case at refine {refine}: "
              f"{report[f'refine_{refine}_case']}", flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    rows += cyl_rows + storage_rows + tiled_rows + shear_rows + sharded_rows + cyl_sh_rows \
        + sweep_rows
    if len(rows) != 52:
        fail(f"{len(rows)} kernel rows, expected 52")
    stamp("end")
    report.update({"phases": phases, "kernels": rows, "build_log": build.build_log,
                   "phase_start_s": marks})
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as fo:
        json.dump(report, fo, indent=1, default=str)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line(), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
