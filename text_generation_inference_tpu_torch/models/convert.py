"""Carry the JAX package's parameters across to the port.

`params_from_jax` takes the JAX param tree with every leaf turned into a
numpy array (`np.asarray(leaf)`; bf16 leaves arrive as ml_dtypes
bfloat16) and returns the port's param dict on `device`, with the same
keys and layouts, fused (`w_qkv`, `w_gu`) or not: every key is carried,
the top-level ones of the learned-position and BLOOM families included
(`embed_positions`, `embed_ln`, OPT's `project_in` / `project_out`). It
lets the tests give both packages identical weights (and
`rank_params_from_jax` a tensor-parallel rank its shard of them); `speculator_params_from_jax`
and `t5_params_from_jax` do the same for a speculator's and a T5 model's.

A JAX `Int4Weight` arrives as a NamedTuple whose leaves are numpy arrays
or None; it is recognised and converted by its field names (nothing of the
JAX package is imported). Its TPU-only layouts (`q4`, `qlane`, blocked
scales) are not carried: a weight that holds only those raises. A JAX
`Int8Weight` / `Int8OutlierWeight` is recognised by its fields the same
way and carried field by field (`int8_from_jax`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.quant.int4 import Int4Weight
from ..ops.quant.int8 import Int8OutlierWeight, Int8Weight
from .core import DecoderSpec
from .t5 import T5Spec


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


def int8_from_jax(w, device=None):
    """A JAX Int8Weight / Int8OutlierWeight (numpy leaves) → the port's, by
    field name."""
    device = resolve_device(device)
    cls = (Int8OutlierWeight if "outlier_idx" in getattr(w, "_fields", ())
           else Int8Weight)
    return cls(**{f: _tensor(getattr(w, f), device) for f in cls._fields})


def _out_features(w) -> int:
    return (w.out_features
            if isinstance(w, (Int4Weight, Int8Weight, Int8OutlierWeight))
            else w.shape[-1])


def params_from_jax(spec: DecoderSpec, params_np: dict,
                    device=None) -> dict:
    """Nested dict of numpy arrays (and Int4Weight / Int8Weight /
    Int8OutlierWeight tuples) → nested dict of torch tensors (and the port's
    quantized weights)."""
    device = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, tuple) and "qweight" in getattr(tree, "_fields", ()):
            return int4_from_jax(tree, device)
        if isinstance(tree, tuple) and "scale" in getattr(tree, "_fields", ()):
            return int8_from_jax(tree, device)
        return _tensor(tree, device)

    out = conv(params_np)
    lp = out["layers"]
    q_out = _out_features(lp["w_qkv"] if "w_qkv" in lp else lp["wq"])
    if lp["ln1"]["scale"].shape[0] != spec.num_layers or q_out < spec.q_size:
        raise ValueError("params do not match the spec")
    return out


def rank_params_from_jax(spec: DecoderSpec, params_np: dict, rank: int,
                         world: int, device=None) -> dict:
    """Rank `rank` of `world`'s shard of the JAX package's params (numpy
    leaves, unfused), cut by the JAX sharding rules
    (`parallel.sharding.shard_params`): the port's params that JAX's
    device `rank` holds on a mesh of `world` model devices."""
    from ..parallel.sharding import shard_params

    return shard_params(spec, params_from_jax(spec, params_np, "cpu"), rank,
                        world, resolve_device(device))


def speculator_params_from_jax(sparams_np: dict, device=None) -> dict:
    """The JAX speculator params (per-position lists of numpy arrays) →
    the port's lists of tensors on `device`, key for key."""
    device = resolve_device(device)
    return {k: [_tensor(a, device) for a in v] for k, v in sparams_np.items()}


def t5_params_from_jax(spec: T5Spec, params_np: dict, device=None) -> dict:
    """The JAX T5 param tree (numpy leaves) → the port's T5 params on
    `device`, key for key."""
    device = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return _tensor(tree, device)

    out = conv(params_np)
    n_enc = out["encoder_layers"]["sa_q"].shape[0]
    n_dec = out["decoder_layers"]["sa_q"].shape[0]
    if (n_enc, n_dec) != (spec.num_encoder_layers, spec.num_decoder_layers) \
            or out["shared_embed"].shape != (spec.vocab_size, spec.d_model):
        raise ValueError("params do not match the spec")
    return out
