"""Raster kernels of the port (scx.ops) and their plain PyTorch versions."""
