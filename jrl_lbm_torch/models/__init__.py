"""Scenes of the PyTorch port: the JRL tip approach."""
