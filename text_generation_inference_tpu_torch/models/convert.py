"""Carry the JAX package's parameters across to the port.

`params_from_jax` takes the JAX param tree with every leaf turned into a
numpy array (`np.asarray(leaf)`; bf16 leaves arrive as ml_dtypes
bfloat16) and returns the port's param dict on `device`, with the same
keys and layouts, fused (`w_qkv`, `w_gu`) or not. It lets the tests give
both packages identical weights.

A JAX `Int4Weight` arrives as a NamedTuple whose leaves are numpy arrays
or None; it is recognised and converted by its field names (nothing of the
JAX package is imported). Its TPU-only layouts (`q4`, `qlane`, blocked
scales) are not carried: a weight that holds only those raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.quant.int4 import Int4Weight
from .core import DecoderSpec


def _tensor(a, device) -> torch.Tensor:
    if not isinstance(a, np.ndarray):
        raise NotImplementedError(
            f"parameter leaf of type {type(a).__name__} is not ported yet")
    a = np.array(a, copy=True, order="C")    # writable and contiguous
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def int4_from_jax(w, device=None) -> Int4Weight:
    """A JAX Int4Weight (numpy leaves) → the port's, by field name."""
    device = resolve_device(device)
    if getattr(w, "qweight", None) is None or getattr(w, "zbias", None) is None:
        raise NotImplementedError(
            "only the GPTQ packing (qweight/qzeros/scales/zbias) of an "
            "Int4Weight is carried across, not its TPU-only layouts")
    return Int4Weight(**{f: None if getattr(w, f) is None
                         else _tensor(getattr(w, f), device)
                         for f in Int4Weight._fields})


def _out_features(w) -> int:
    return w.out_features if isinstance(w, Int4Weight) else w.shape[-1]


def params_from_jax(spec: DecoderSpec, params_np: dict,
                    device=None) -> dict:
    """Nested dict of numpy arrays (and Int4Weight tuples) → nested dict of
    torch tensors (and the port's Int4Weight)."""
    device = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, tuple) and "qweight" in getattr(tree, "_fields", ()):
            return int4_from_jax(tree, device)
        return _tensor(tree, device)

    out = conv(params_np)
    lp = out["layers"]
    q_out = _out_features(lp["w_qkv"] if "w_qkv" in lp else lp["wq"])
    if lp["ln1"]["scale"].shape[0] != spec.num_layers or q_out < spec.q_size:
        raise ValueError("params do not match the spec")
    return out
