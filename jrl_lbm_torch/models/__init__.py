"""Scenes of the PyTorch port: the JRL tip approach, the cylinder channel
and the doubly-periodic shear layer."""

from jrl_lbm_torch.models import cylinder, jrl, shear_layer

__all__ = ["cylinder", "jrl", "shear_layer"]
