"""Tensor-network operations on complex torch tensors, and the CUDA kernels
that carry the MPS engine's two hot factorizations."""
