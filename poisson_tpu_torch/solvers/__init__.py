"""Solvers: the plain PyTorch PCG loop."""
