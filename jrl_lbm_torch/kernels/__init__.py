"""Hand-written CUDA kernels for Hopper (``sm_90a``), one per TPU kernel
of the JRL and cylinder-channel paths, each beside its plain PyTorch
twin: the per-step JRL kernels of every grid (`jrl_fluid.py`, `jrl_c.py`;
the approach in one launch a step with its frame lerp and integrals),
the multi-step JRL kernels of grids up to 131,072 cells (`fused_jrl.py`;
the three phases of grids that fit one thread-block cluster's
shared memory, such as the default 128x64, on cluster kernels of their
own; the balance of 256x128 and 512x256 and the approach of 256x128 on
every cluster of the card at once, their fluid as waves of shared-memory
tiles over the whole grid, a wave a step, the approach of 512x256 as runs
of whole rows, a run an SM; a Pe sweep's approach lanes in one launch, one
cluster a lane),
the k-step tile-class kernels of the JRL fluid phase on larger grids
and its k = 1 split pass in one launch (`jrl_tiled.py`), the kernels of the cylinder channel's fused step
(`cylinder.py`: the single steps, the k-step pass in one launch and the
three kernels it replaces; float32, bf16 or stochastically rounded bf16
storage of f, each a template instance, counted per name and per mode), the
shear layer's periodic step (`periodic.py`), and the JRL case and the
cylinder channel on a mesh of shards (`jrl_sharded.py`, `cyl_sharded.py`:
a k-step fluid pass, balance pass and approach pass and a lean-split
cylinder pass of a shard in one launch each; their halo pieces from
`halo.py`: on a mesh held on one card the whole exchange in one launch,
else packed a shard and phase).

The wrappers import without ``nvcc`` or a card; a kernel is built
(`build.py`) the first time it is launched.
"""

KERNELS = ("fluid_a", "fluid_b", "c_balance", "c_approach",
           "fused_fluid", "fused_balance", "fused_approach",
           "cyl_full", "cyl_interior", "cyl_interior_k", "cyl_band_k",
           "fluid_k", "fluid_k_lean", "fluid_k_bt", "periodic",
           "fluid_a_sh", "fluid_b_sh", "c_balance_sh", "c_approach_sh", "halo_pack",
           "cyl_block_sh", "cyl_lean_sh", "cyl_window_sh",
           "fused_fluid_cl", "fused_balance_cl", "fluid_pass",
           "c_approach_pass", "fused_approach_cl", "cyl_pass", "fused_approach_lanes",
           "fused_fluid_mc", "fused_balance_mc", "fused_approach_mc", "cyl_pass_sh",
           "fluid_pass_sh", "c_balance_pass_sh", "c_approach_pass_sh", "fused_fluid_tl",
           "fused_approach_rw", "halo_mesh")


def wrappers():
    """The kernel wrappers by name (each carries ``.launches``)."""
    from jrl_lbm_torch.kernels import cyl_sharded, cylinder, fused_jrl, halo, jrl_c, jrl_fluid, \
        jrl_sharded, jrl_tiled, periodic

    return {
        "fluid_a": jrl_fluid.fluid_a,
        "fluid_b": jrl_fluid.fluid_b,
        "c_balance": jrl_c.c_balance,
        "c_approach": jrl_c.c_approach,
        "fused_fluid": fused_jrl.fused_fluid,
        "fused_balance": fused_jrl.fused_balance,
        "fused_approach": fused_jrl.fused_approach,
        "cyl_full": cylinder.cyl_full,
        "cyl_interior": cylinder.cyl_interior,
        "cyl_interior_k": cylinder.cyl_interior_k,
        "cyl_band_k": cylinder.cyl_band_k,
        "fluid_k": jrl_tiled.fluid_k,
        "fluid_k_lean": jrl_tiled.fluid_k_lean,
        "fluid_k_bt": jrl_tiled.fluid_k_bt,
        "periodic": periodic.periodic,
        "fluid_a_sh": jrl_sharded.fluid_a_sh,
        "fluid_b_sh": jrl_sharded.fluid_b_sh,
        "c_balance_sh": jrl_sharded.c_balance_sh,
        "c_approach_sh": jrl_sharded.c_approach_sh,
        "halo_pack": halo.halo_pack,
        "cyl_block_sh": cyl_sharded.cyl_block_sh,
        "cyl_lean_sh": cyl_sharded.cyl_lean_sh,
        "cyl_window_sh": cyl_sharded.cyl_window_sh,
        "fused_fluid_cl": fused_jrl.fused_fluid_cl,
        "fused_balance_cl": fused_jrl.fused_balance_cl,
        "fluid_pass": jrl_tiled.fluid_pass,
        "c_approach_pass": jrl_c.c_approach_pass,
        "fused_approach_cl": fused_jrl.fused_approach_cl,
        "cyl_pass": cylinder.cyl_pass,
        "fused_approach_lanes": fused_jrl.fused_approach_lanes,
        "fused_fluid_mc": fused_jrl.fused_fluid_mc,
        "fused_balance_mc": fused_jrl.fused_balance_mc,
        "fused_approach_mc": fused_jrl.fused_approach_mc,
        "cyl_pass_sh": cyl_sharded.cyl_pass_sh,
        "fluid_pass_sh": jrl_sharded.fluid_pass_sh,
        "c_balance_pass_sh": jrl_sharded.c_balance_pass_sh,
        "c_approach_pass_sh": jrl_sharded.c_approach_pass_sh,
        "fused_fluid_tl": fused_jrl.fused_fluid_tl,
        "fused_approach_rw": fused_jrl.fused_approach_rw,
        "halo_mesh": halo.halo_mesh,
    }


def reset_launches():
    from jrl_lbm_torch.kernels import cyl_sharded, cylinder

    for fn in wrappers().values():
        fn.launches = 0
    cylinder.reset_launches()
    cyl_sharded.reset_launches()


def launches():
    """Launches per kernel name, every storage mode together."""
    return {name: fn.launches for name, fn in wrappers().items()}


def launches_by_mode():
    """Launches of the cylinder kernels per storage mode, as
    ``{"cyl_full/bf16": n, ...}`` (modes `cylinder.MODE_NAMES`)."""
    from jrl_lbm_torch.kernels import cylinder

    return {f"{fn.__name__}/{m}": n for fn in cylinder.WRAPPERS
            for m, n in fn.launches_by_mode.items()}
