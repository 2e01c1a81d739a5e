"""Llama decoder in PyTorch: `core.py` holds the layer math shared with the
paged forward passes in `paged_core.py`; `families.py` loads HF checkpoints
into the stacked parameter dict; `convert.py` carries JAX params across."""
