"""Plain PyTorch operator layer over batch-free ``[Q, H, W]`` states."""
