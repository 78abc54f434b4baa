"""Spline operations: plain oracle, fused CUDA kernels, masks."""
