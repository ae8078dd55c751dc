"""Rasterizer ops: projection, SH, binning, blend kernels, losses, Adam."""
