"""Scenes of the PyTorch port: the JRL tip approach, the cylinder channel
and the doubly-periodic shear layer."""
