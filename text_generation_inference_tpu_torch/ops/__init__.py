"""Attention dispatch, linear layers and the CUDA kernel wrappers."""
