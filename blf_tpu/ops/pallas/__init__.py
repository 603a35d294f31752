"""Pallas kernels for the framework's hot ops (GPU, Triton route)."""
