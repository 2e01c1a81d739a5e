"""Fused GPTQ-INT4 GLU MLP: the wrapper of `csrc/int4_mlp.cu` (kernel M1)
and its plain PyTorch version.

Counterpart of the JAX package's `ops/pallas/int4_matmul.py
int4_mlp_s4_stacked`: for decode rows (S <= 64) and one layer of a
layer-stacked pair,

    y = dequant(w_down)[act(x @ dequant(w_gate)) * (x @ dequant(w_up))]

in one launch. Both weights are read as the loader stores them (the GPTQ
natural layout, `quant.int4.Int4Weight`): `w_gu` holds the gate columns
[0, I) and the up columns [I, 2I) (`models/fuse.py`), `w_down` is [I, H].
The JAX kernel's blocked, sublane-padded down scales are TPU tiling and are
not ported.

The activation is the model's: `silu_glu` is silu(g) * u and `gelu_glu`
is the exact (erf) GELU of g times u, as `models/core._activate` defines it.
The JAX kernel computes `gelu_glu` with the tanh approximation; the port
does not copy that (see ROADMAP Queue 3, the `gelu_glu` fault).

The wrapper takes the plain version only for a tensor that lies on the
CPU; for a CUDA tensor it launches the kernel or raises. It counts its
launches in `.launches`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..quant.int4 import Int4Weight
from . import build
from .int4_matmul import K_TILE, int4_matmul_reference

MAX_ROWS = 64          # decode rows the kernel takes (the JAX fusion limit)
ACTIVATIONS = {"silu_glu": 0, "gelu_glu": 1}


def glu(g: torch.Tensor, u: torch.Tensor, activation: str) -> torch.Tensor:
    """act(g) * u, computed in g's dtype."""
    if activation == "silu_glu":
        return F.silu(g) * u
    if activation == "gelu_glu":
        return F.gelu(g, approximate="none") * u
    raise ValueError(f"int4_mlp: activation {activation!r} does not fuse "
                     f"(one of {sorted(ACTIVATIONS)})")


def int4_mlp_reference(x: torch.Tensor, w_gu: Int4Weight, w_down: Int4Weight,
                       activation: str = "silu_glu") -> torch.Tensor:
    """Plain version, as the JAX kernel computes: gu dequantized and
    multiplied in f32, the activation in f32, `a` rounded to x's dtype (the
    compute dtype) before the down product, down in f32; returns x's
    dtype."""
    inter = w_down.in_features
    gu = int4_matmul_reference(x.to(torch.float32), w_gu)
    a = glu(gu[:, :inter], gu[:, inter:], activation).to(x.dtype)
    return int4_matmul_reference(a, w_down).to(x.dtype)


def _check_pair(x: torch.Tensor, w_gu: Int4Weight, w_down: Int4Weight,
                layer: int, activation: str) -> None:
    """What the fused route takes, on any device."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"int4_mlp: activation {activation!r} does not fuse "
                         f"(one of {sorted(ACTIVATIONS)})")
    for name, w in (("w_gu", w_gu), ("w_down", w_down)):
        if w.qweight.dim() != 3:
            raise ValueError(f"int4_mlp: {name} must be layer-stacked")
        if w.perm is not None:
            raise ValueError(f"int4_mlp: {name} has an act-order perm")
        if w.zbias is None:
            raise ValueError(f"int4_mlp: {name} has no zbias (compute_zbias)")
    layers = w_gu.qweight.shape[0]
    if w_down.qweight.shape[0] != layers or not 0 <= layer < layers:
        raise ValueError(f"int4_mlp: layer {layer} outside the {layers}-layer "
                         f"stack (w_down has {w_down.qweight.shape[0]})")
    h, inter = w_down.out_features, w_down.in_features
    if w_gu.in_features != h or w_gu.out_features != 2 * inter:
        raise ValueError(f"int4_mlp: w_gu [{w_gu.in_features}, "
                         f"{w_gu.out_features}] does not pair with w_down "
                         f"[{inter}, {h}]")
    if x.dim() != 2 or x.shape[1] != h:
        raise ValueError(f"int4_mlp: x must be [S, {h}], got {tuple(x.shape)}")
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"int4_mlp: {x.shape[0]} rows > {MAX_ROWS} (the "
                         "fused route is for decode rows)")


def _check_cuda(x: torch.Tensor, w_gu: Int4Weight, w_down: Int4Weight) -> None:
    """What the kernel takes on the card."""
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"int4_mlp: x must be a contiguous bfloat16 tensor, "
                         f"got {x.dtype}")
    if x.data_ptr() % 16:
        raise ValueError("int4_mlp: x must be 16-byte aligned")
    for name, w in (("w_gu", w_gu), ("w_down", w_down)):
        for field in ("qweight", "scales", "zbias"):
            t = getattr(w, field)
            if t.device != x.device or not t.is_contiguous():
                raise ValueError(f"int4_mlp: {name}.{field} must be contiguous "
                                 f"on {x.device}")
        if (w.qweight.dtype != torch.int32 or w.scales.dtype != torch.float32
                or w.zbias.dtype != torch.float32
                or w.scales.shape != w.zbias.shape):
            raise ValueError(f"int4_mlp: {name} must be int32 words with "
                             "float32 scales and zbias of one shape")
        if w.in_features % K_TILE or w.groupsize % K_TILE:
            raise ValueError(f"int4_mlp: {name} in {w.in_features} and group "
                             f"size {w.groupsize} must be multiples of "
                             f"{K_TILE}")
    if w_down.out_features % 64:
        raise ValueError("int4_mlp: the hidden size must be a multiple of 64")


def int4_mlp_s4_stacked(x: torch.Tensor, w_gu: Int4Weight, w_down: Int4Weight,
                        layer: int, activation: str = "silu_glu"
                        ) -> torch.Tensor:
    """The fused MLP of layer `layer` of the stacks w_gu [L, H, 2I] and
    w_down [L, I, H] (read in place) for x [S, H], S <= 64; returns [S, H]
    in x's dtype."""
    _check_pair(x, w_gu, w_down, layer, activation)
    wg, wd = w_gu.layer(layer), w_down.layer(layer)
    if x.device.type == "cpu":
        return int4_mlp_reference(x, wg, wd, activation)
    _check_cuda(x, wg, wd)
    m, h = x.shape
    inter = wd.in_features
    y = torch.empty((m, h), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    lib = build.library("int4_mlp")
    splits = lib.tgi_int4_mlp_splits(h, inter)
    abuf = torch.empty((m, inter), dtype=torch.bfloat16, device=x.device)
    partial = torch.empty((splits, m, h), dtype=torch.float32, device=x.device)
    counter = torch.empty((1,), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.tgi_int4_mlp(
            x.data_ptr(), wg.qweight.data_ptr(), wg.scales.data_ptr(),
            wg.zbias.data_ptr(), wd.qweight.data_ptr(), wd.scales.data_ptr(),
            wd.zbias.data_ptr(), abuf.data_ptr(), partial.data_ptr(),
            counter.data_ptr(), y.data_ptr(), m, h, inter, wg.groupsize,
            wd.groupsize, splits, ACTIVATIONS[activation], stream)
    build.check("int4_mlp", code)
    int4_mlp_s4_stacked.launches += 1
    return y


int4_mlp_s4_stacked.launches = 0
