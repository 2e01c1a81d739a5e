"""Linear-layer dispatch: dense tensors or GPTQ-INT4 weights (port of the
dense and `Int4Weight` branches of the JAX package's `ops/linear.py`).

Dense weights: a plain `x @ w` on [in, out] weights, which PyTorch hands
to cuBLAS as the JAX package left its dense products to XLA.

GPTQ-INT4 weights (`quant.int4.Int4Weight`, layer-stacked by the loader)
go to the dequant-GEMM kernel K1 (`ops/cuda/int4_matmul.py`). Under
act-order the input is gathered by `perm` first. The entry name follows
the JAX route:

  * decode rows, after `prepare_params(params, rows)`: each layer-stacked
    weight is marked for the stacked route, `core.layer_params` picks the
    layer, and the product is `int4_matmul_s4_stacked` (the kernel reads
    the layer's slice of the stack in place);
  * prefill (no `prepare_params`): the layer's view goes to the
    packed-layout name `int4_matmul`;
  * a plain 2-D `Int4Weight` (not a layer of a stack) goes to
    `int4_matmul_s4`.

A view made for `ops.attention.PLAIN` (`int4_plain`) runs the plain
version instead, so a caller on the card can compare the two.

The fused GLU MLP (JAX `can_fuse_mlp` / `mlp_fused`, `INT4_FUSED_MLP=1`):
when the engine asks for it, `prepare_params` marks a stacked `w_gu` /
`w_down` pair with the route "fused", and `models.core._mlp` runs the pair
as one launch of kernel M1 (`ops/cuda/int4_mlp.py`) wherever
`can_fuse_mlp` holds. Each weight of the pair still serves `matmul` on the
stacked route. The engine reads the option once, when it is built.
`prepare_params` only wraps (no tensor work: PyTorch has no jit boundary to
amortize a relayout over, so one would be a cost on every dispatch), and
`prepare_storage` is the identity: the kernel reads the GPTQ packing as
stored.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .cuda.int4_matmul import (int4_matmul, int4_matmul_reference,
                               int4_matmul_s4, int4_matmul_s4_stacked)
from .cuda.int4_mlp import (ACTIVATIONS, MAX_ROWS, int4_mlp_reference,
                            int4_mlp_s4_stacked)
from .quant.int4 import Int4Weight


class Int4Stacked(NamedTuple):
    """Layer `layer` of a layer-stacked Int4Weight, and the route of its
    product: "stacked" (decode rows, marked by `prepare_params`), "fused"
    (the same, and one weight of a pair for the fused MLP) or "packed"
    (prefill). `layer_view` fills in the layer."""

    weight: Int4Weight       # the whole stack [L, ...]
    layer: int
    route: str
    plain: bool = False


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a dense or GPTQ-INT4 w. x: [..., in] → [..., out]."""
    if isinstance(w, Int4Stacked):
        wl = w.weight.layer(w.layer)
        x2 = _rows(x, wl)
        if w.plain:
            y2 = int4_matmul_reference(x2, wl)
        elif w.route in ("stacked", "fused"):
            y2 = int4_matmul_s4_stacked(x2, w.weight, w.layer)
        else:
            y2 = int4_matmul(x2, wl)
        return y2.reshape(*x.shape[:-1], wl.out_features)
    if isinstance(w, Int4Weight):
        if w.qweight.dim() != 2:
            raise ValueError("a layer-stacked Int4Weight is read one layer at "
                             "a time (models.core.layer_params)")
        y2 = int4_matmul_s4(_rows(x, w), w)
        return y2.reshape(*x.shape[:-1], w.out_features)
    return torch.matmul(x, w)


def _rows(x: torch.Tensor, w: Int4Weight) -> torch.Tensor:
    """x as the kernel's [M, in] operand: gathered by the act-order perm,
    contiguous and 16-byte aligned."""
    if w.perm is not None:
        x = x[..., w.perm.long()]
    x2 = x.reshape(-1, x.shape[-1])
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    return x2


def layer_view(w, i: int, plain: bool = False):
    """Layer i of a layer-stacked parameter (no copy): a tensor's slice, or
    an `Int4Stacked` view of an int4 stack."""
    if isinstance(w, Int4Stacked):
        return w._replace(layer=i, plain=plain)
    if isinstance(w, Int4Weight):
        return Int4Stacked(w, i, "packed", plain)
    return w[i]


def can_fuse_mlp(w_gu, w_down, activation: str, rows: int) -> bool:
    """True when the decode MLP pair runs as one M1 launch: both weights
    marked for the fused route by `prepare_params`, no act-order perm, a GLU
    the kernel computes (`silu_glu`, `gelu_glu`), at most 64 rows, and a
    w_gu of twice w_down's input width."""
    return (isinstance(w_gu, Int4Stacked) and isinstance(w_down, Int4Stacked)
            and w_gu.route == "fused" and w_down.route == "fused"
            and w_gu.weight.perm is None and w_down.weight.perm is None
            and activation in ACTIVATIONS and rows <= MAX_ROWS
            and w_gu.weight.out_features == 2 * w_down.weight.in_features)


def mlp_fused(x: torch.Tensor, w_gu: Int4Stacked, w_down: Int4Stacked,
              activation: str) -> torch.Tensor:
    """down(act(gate) * up) of one layer in one launch (M1), or by its plain
    version for a `PLAIN` view. x: [..., H] → [..., H]."""
    x2 = _rows(x, w_gu.weight)
    if w_gu.plain:
        y2 = int4_mlp_reference(x2, w_gu.weight.layer(w_gu.layer),
                                w_down.weight.layer(w_down.layer), activation)
    else:
        y2 = int4_mlp_s4_stacked(x2, w_gu.weight, w_down.weight, w_gu.layer,
                                 activation)
    return y2.reshape(x.shape)


def prepare_params(params: dict, rows: Optional[int] = None,
                   fuse_mlp: bool = False) -> dict:
    """Before a decode dispatch of `rows` rows: marks every layer-stacked
    Int4Weight in params["layers"] for the stacked route, and with
    `fuse_mlp` (the engine's INT4_FUSED_MLP) a w_gu / w_down pair without
    act-order perms for the fused route, when `rows` is at most 64.
    Identity for dense weights, and when `rows` is None."""
    layers = params.get("layers", {})
    if rows is None or not any(isinstance(v, Int4Weight)
                               for v in layers.values()):
        return params
    pair = (layers.get("w_gu"), layers.get("w_down"))
    fused = (fuse_mlp and rows <= MAX_ROWS
             and all(isinstance(w, Int4Weight) and w.qweight.dim() == 3
                     and w.perm is None for w in pair))
    out = dict(params)
    out["layers"] = {k: (Int4Stacked(v, -1, "fused" if fused and k in (
                             "w_gu", "w_down") else "stacked")
                         if isinstance(v, Int4Weight) else v)
                     for k, v in layers.items()}
    return out


def prepare_storage(params: dict) -> dict:
    """Identity: the kernel reads the GPTQ packing as the loader stores it."""
    return params
