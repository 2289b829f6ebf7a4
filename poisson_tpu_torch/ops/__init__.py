"""Operators: plain stencil ops and the fused CUDA canvas iteration."""
