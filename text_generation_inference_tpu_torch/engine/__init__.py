"""Paged inference engine (PyTorch port of the JAX package's `engine/`):
host types, the paged KV pool and allocator, sampling and the engine."""
