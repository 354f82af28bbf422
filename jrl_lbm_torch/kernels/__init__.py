"""Hand-written CUDA kernels for Hopper (``sm_90a``), one per TPU kernel
of the JRL main path, each beside its plain PyTorch twin.

The wrappers import without ``nvcc`` or a card; a kernel is built
(`build.py`) the first time it is launched.
"""

KERNELS = ("fluid_a", "fluid_b", "c_balance", "c_approach")


def wrappers():
    """The four kernel wrappers by name (each carries ``.launches``)."""
    from jrl_lbm_torch.kernels import jrl_c, jrl_fluid

    return {
        "fluid_a": jrl_fluid.fluid_a,
        "fluid_b": jrl_fluid.fluid_b,
        "c_balance": jrl_c.c_balance,
        "c_approach": jrl_c.c_approach,
    }


def reset_launches():
    for fn in wrappers().values():
        fn.launches = 0


def launches():
    return {name: fn.launches for name, fn in wrappers().items()}
