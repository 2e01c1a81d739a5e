"""Carry the JAX package's parameters across to the port.

`params_from_jax` takes the JAX param tree with every leaf turned into a
numpy array (`np.asarray(leaf)`; bf16 leaves arrive as ml_dtypes
bfloat16) and returns the port's param dict on `device`, with the same
keys and layouts, fused (`w_qkv`, `w_gu`) or not. It lets the tests give
both packages identical weights.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .core import DecoderSpec


def _tensor(a, device) -> torch.Tensor:
    if not isinstance(a, np.ndarray):
        raise NotImplementedError(
            f"parameter leaf of type {type(a).__name__} is not ported yet "
            "(quantized weights are a later slice)")
    a = np.array(a, copy=True, order="C")    # writable and contiguous
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(spec: DecoderSpec, params_np: dict,
                    device=None) -> dict:
    """Nested dict of numpy arrays → nested dict of torch tensors."""
    device = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return _tensor(tree, device)

    out = conv(params_np)
    lp = out["layers"]
    q_out = lp["w_qkv"].shape[-1] if "w_qkv" in lp else lp["wq"].shape[-1]
    if lp["ln1"]["scale"].shape[0] != spec.num_layers or q_out < spec.q_size:
        raise ValueError("params do not match the spec")
    return out
