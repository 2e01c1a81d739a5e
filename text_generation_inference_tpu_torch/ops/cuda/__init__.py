"""Wrappers of the hand-written CUDA kernels in `csrc/` (counterparts of the
JAX package's `ops/pallas/` kernels), each beside its plain PyTorch version."""
