"""Enums, grids, SDFs, IO and device selection for the PyTorch port."""
