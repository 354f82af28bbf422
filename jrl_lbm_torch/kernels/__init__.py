"""Hand-written CUDA kernels for Hopper (``sm_90a``), one per TPU kernel
of the JRL main path, each beside its plain PyTorch twin: the per-step
kernels of every grid (`jrl_fluid.py`, `jrl_c.py`) and the multi-step
kernels of grids up to 131,072 cells (`fused_jrl.py`).

The wrappers import without ``nvcc`` or a card; a kernel is built
(`build.py`) the first time it is launched.
"""

KERNELS = ("fluid_a", "fluid_b", "c_balance", "c_approach",
           "fused_fluid", "fused_balance", "fused_approach")


def wrappers():
    """The kernel wrappers by name (each carries ``.launches``)."""
    from jrl_lbm_torch.kernels import fused_jrl, jrl_c, jrl_fluid

    return {
        "fluid_a": jrl_fluid.fluid_a,
        "fluid_b": jrl_fluid.fluid_b,
        "c_balance": jrl_c.c_balance,
        "c_approach": jrl_c.c_approach,
        "fused_fluid": fused_jrl.fused_fluid,
        "fused_balance": fused_jrl.fused_balance,
        "fused_approach": fused_jrl.fused_approach,
    }


def reset_launches():
    for fn in wrappers().values():
        fn.launches = 0


def launches():
    return {name: fn.launches for name, fn in wrappers().items()}
