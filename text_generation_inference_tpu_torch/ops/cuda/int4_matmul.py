"""GPTQ INT4 dequant-GEMM: wrappers of `csrc/int4_matmul.cu` (kernel K1)
and its plain PyTorch version.

Counterpart of the JAX package's `ops/pallas/int4_matmul.py`. The three
entry names keep their JAX meanings and all reach the one kernel:

  int4_matmul_s4_stacked(x, w, layer)  one layer of a layer-stacked weight
                                       (the decode route); the layer is a
                                       view of the stack, no copy
  int4_matmul_s4(x, w)                 an unstacked [in, out] weight
  int4_matmul(x, w)                    a weight in the packed [in/8, out]
                                       layout (the prefill route; the JAX
                                       kernel computed in f32 by default,
                                       this one in bf16 on the tensor cores
                                       with fp32 accumulation)

x is [M, in] and already gathered by the act-order `perm` (`ops/linear.py`
does that); g_idx must be sequential (`quant.int4.normalize_act_order`).
Returns [M, out] in x's dtype.

Each wrapper takes the plain version only for a tensor that lies on the
CPU; for a CUDA tensor it launches the kernel or raises. Each counts its
own launches in `.launches`.
"""

from __future__ import annotations

import torch

from ..quant.int4 import Int4Weight, unpack_rows
from . import build

K_TILE = 64    # the kernel's K tile: in_features and the group size are multiples


def int4_matmul_reference(x: torch.Tensor, w: Int4Weight) -> torch.Tensor:
    """Plain version: dequantize to f32 (q * scale - zbias, group = row //
    groupsize) and one f32 matmul; returns x's dtype."""
    gs = w.groupsize
    q = unpack_rows(w.qweight).to(torch.float32)
    s = w.scales.to(torch.float32).repeat_interleave(gs, dim=0)
    zb = w.zbias.to(torch.float32).repeat_interleave(gs, dim=0)
    return torch.matmul(x.to(torch.float32), q * s - zb).to(x.dtype)


def _check(fn: str, x: torch.Tensor, w: Int4Weight) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if w.zbias is None:
        raise ValueError(f"{fn}: the weight has no zbias (compute_zbias)")
    for name in ("qweight", "scales", "zbias"):
        t = getattr(w, name)
        if t.device != x.device:
            raise ValueError(f"{fn}: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if x.dtype != torch.bfloat16 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{fn}: x must be a contiguous [M, in] bfloat16 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError(f"{fn}: x must be 16-byte aligned")
    if w.qweight.dtype != torch.int32 or w.qweight.dim() != 2:
        raise ValueError(f"{fn}: qweight must be [in/8, out] int32")
    if (w.scales.dtype != torch.float32 or w.zbias.dtype != torch.float32
            or w.scales.shape != w.zbias.shape):
        raise ValueError(f"{fn}: scales and zbias must be float32 of one shape")
    m, k = x.shape
    n, gs = w.out_features, w.groupsize
    if k != w.in_features or w.scales.shape != (k // gs, n):
        raise ValueError(f"{fn}: x {tuple(x.shape)} does not match qweight "
                         f"{tuple(w.qweight.shape)} / scales "
                         f"{tuple(w.scales.shape)}")
    if k % K_TILE or gs % K_TILE or n % 8:
        raise ValueError(f"{fn}: in {k} and groupsize {gs} must be multiples "
                         f"of {K_TILE}, out {n} of 8")


def _launch(fn: str, x: torch.Tensor, w: Int4Weight) -> torch.Tensor:
    _check(fn, x, w)
    m, k = x.shape
    n = w.out_features
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    lib = build.library("int4_matmul")
    splits = lib.tgi_int4_matmul_splits(m, n, k)
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.tgi_int4_matmul(
            x.data_ptr(), w.qweight.data_ptr(), w.scales.data_ptr(),
            w.zbias.data_ptr(), y.data_ptr(),
            None if partial is None else partial.data_ptr(),
            m, n, k, w.groupsize, splits, stream)
    build.check("int4_matmul", code)
    return y


def int4_matmul(x: torch.Tensor, w: Int4Weight) -> torch.Tensor:
    """The packed-layout entry (JAX `int4_matmul`): the prefill route."""
    if x.device.type == "cpu":
        return int4_matmul_reference(x, w)
    y = _launch("int4_matmul", x, w)
    int4_matmul.launches += 1
    return y


def int4_matmul_s4(x: torch.Tensor, w: Int4Weight) -> torch.Tensor:
    """The unstacked entry (JAX `int4_matmul_s4`): a plain 2-D weight."""
    if x.device.type == "cpu":
        return int4_matmul_reference(x, w)
    y = _launch("int4_matmul_s4", x, w)
    int4_matmul_s4.launches += 1
    return y


def int4_matmul_s4_stacked(x: torch.Tensor, w: Int4Weight,
                           layer: int) -> torch.Tensor:
    """The stacked entry (JAX `int4_matmul_s4_stacked`): layer `layer` of
    a layer-stacked weight [L, ...], read in place (`w.layer(i)` is a view)."""
    wl = w.layer(layer)
    if x.device.type == "cpu":
        return int4_matmul_reference(x, wl)
    y = _launch("int4_matmul_s4_stacked", x, wl)
    int4_matmul_s4_stacked.launches += 1
    return y


int4_matmul.launches = 0
int4_matmul_s4.launches = 0
int4_matmul_s4_stacked.launches = 0
