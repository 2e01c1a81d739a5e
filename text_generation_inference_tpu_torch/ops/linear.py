"""Linear-layer dispatch (port of the dense branch of the JAX package's
`ops/linear.py`).

This slice serves bf16 weights only: `matmul` is a plain `x @ w` on
[in, out] weights, which PyTorch hands to cuBLAS as the JAX package left
its dense products to XLA. Quantized weights (GPTQ-INT4, int8) are later
slices and raise NotImplementedError here. `prepare_params` and
`prepare_storage` are identities for dense weights.
"""

from __future__ import annotations

import torch


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a dense w. x: [..., in] → [..., out]."""
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(
            f"quantized linear weights ({type(w).__name__}) are not ported yet")
    return torch.matmul(x, w)


def prepare_params(params: dict, rows: int) -> dict:
    """Identity for dense weights (the JAX package converts int4 storage
    here)."""
    return params


def prepare_storage(params: dict) -> dict:
    """Identity for dense weights."""
    return params
