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

x is bf16, fp16 or fp32 (`DTYPES`), and x's dtype is the compute dtype:
the kernel runs K1's decode schedule on both products (bf16 or fp16
operands, fp32 x and fp32 `a` as two bf16 terms), rounds `a` to x's dtype
before the down product and writes y in x's dtype. The weights enter the
tensor cores as the exact integers q - zero - 1 (zero points from
`qzeros`) and every group's product is scaled in fp32, as in K1. The plain
version (`int4_mlp_reference`) computes in f32 from x as it is;
`int4_mlp_split_reference` is the plain twin of the kernel's order: the
group-dot form, the split plans over H and I (`split_plan(2I, H)`,
`split_plan(H, I)`, from the shapes alone) summed in split order.

The wrapper takes the plain version only for a tensor that lies on the
CPU; for a CUDA tensor it launches the kernel or raises. It counts its
launches in `.launches`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..quant.int4 import Int4Weight, unpack_cols, unpack_rows
from . import build
from .int4_matmul import (DTYPES, K_TILE, int4_matmul_reference,
                          operand_terms, split_plan, split_tiles, workspace)
from .paged_attention import arrivals

MAX_ROWS = 64          # decode rows the kernel takes (the JAX fusion limit)
BLOCK_I = 128          # intermediate columns (gate and up each) of a work item
BLOCK_H = 256          # hidden columns of a down work item
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


def _split_group_dot(x: torch.Tensor, w: Int4Weight) -> torch.Tensor:
    """x @ W in the decode schedule's order, f32: for each split of
    `split_plan(out, in)` in turn, the f32 products of x's operand terms
    with the exact integers q - zero - 1 of each group's rows inside the
    split, times the group's scales, added in group order; then the splits
    added in split order."""
    gs = w.groupsize
    q = unpack_rows(w.qweight).to(torch.float32)
    z = (unpack_cols(w.qzeros) + 1).to(torch.float32)
    sc = w.scales.to(torch.float32)
    terms = operand_terms(x)
    y = torch.zeros((x.shape[0], w.out_features), dtype=torch.float32,
                    device=x.device)
    for t0, t1 in split_tiles(w.out_features, w.in_features):
        part = torch.zeros_like(y)
        k = t0 * K_TILE
        while k < t1 * K_TILE:
            g = k // gs
            end = min(t1 * K_TILE, (g + 1) * gs)
            wi = q[k:end] - z[g]
            part = part + sum(torch.matmul(t[:, k:end], wi)
                              for t in terms) * sc[g]
            k = end
        y = y + part
    return y


def int4_mlp_split_reference(x: torch.Tensor, w_gu: Int4Weight,
                             w_down: Int4Weight,
                             activation: str = "silu_glu") -> torch.Tensor:
    """Plain twin of the kernel's order: both products in the split
    group-dot form (`_split_group_dot`), the activation in f32, `a` rounded
    to x's dtype before the down product; returns x's dtype."""
    inter = w_down.in_features
    gu = _split_group_dot(x, w_gu)
    a = glu(gu[:, :inter], gu[:, inter:], activation).to(x.dtype)
    return _split_group_dot(a, w_down).to(x.dtype)


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
        groups = w.in_features // w.groupsize
        if (w.qzeros is None or w.qzeros.shape[1:]
                != (groups, w.out_features // 8)):
            raise ValueError(f"int4_mlp: {name} qzeros must be [L, {groups}, "
                             f"{w.out_features // 8}] (the kernel's zero "
                             "points)")
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
    if x.dtype not in DTYPES or not x.is_contiguous():
        raise ValueError(f"int4_mlp: x must be a contiguous tensor of one of "
                         f"{DTYPES}, got {x.dtype}")
    if x.data_ptr() % 16:
        raise ValueError("int4_mlp: x must be 16-byte aligned")
    for name, w in (("w_gu", w_gu), ("w_down", w_down)):
        for field in ("qweight", "qzeros", "scales"):
            t = getattr(w, field)
            if t.device != x.device or not t.is_contiguous():
                raise ValueError(f"int4_mlp: {name}.{field} must be contiguous "
                                 f"on {x.device}")
        if (w.qweight.dtype != torch.int32 or w.qzeros.dtype != torch.int32
                or w.scales.dtype != torch.float32
                or w.scales.shape != (w.in_features // w.groupsize,
                                      w.out_features)):
            raise ValueError(f"int4_mlp: {name} must be int32 words and zero "
                             "points with float32 scales [groups, out]")
        if any(t.data_ptr() % 16 for t in (w.qweight, w.scales)):
            raise ValueError(f"int4_mlp: {name} qweight and scales must be "
                             "16-byte aligned")
        if w.in_features % K_TILE or w.groupsize % K_TILE:
            raise ValueError(f"int4_mlp: {name} in {w.in_features} and group "
                             f"size {w.groupsize} must be multiples of "
                             f"{K_TILE}")


def scratch_need(h: int, inter: int, m: int = MAX_ROWS) -> tuple[int, int]:
    """(workspace floats, arrival counters) a launch of m rows on a [H, 2I]
    / [I, H] pair takes; m = MAX_ROWS gives the most any row count takes.
    The workspace holds the split partials of both products and `a`."""
    splits_gu, splits_down = split_plan(2 * inter, h), split_plan(h, inter)
    floats = ((splits_gu * m * 2 * inter if splits_gu > 1 else 0)
              + (splits_down * m * h if splits_down > 1 else 0) + m * inter)
    # per (column block, row tile): gate/up arrivals, ready flags, their
    # readers, down arrivals; then the kernel's ticket (counted for 16-row
    # tiles, the most row tiles any tiling of m rows has). The kernel
    # returns the ticket, the flags and every count to zero at the end of
    # each launch: a replayed decode graph relies on that, as it finds the
    # buffer as the launch before left it
    counters = (3 * -(-inter // BLOCK_I) + -(-h // BLOCK_H)) * -(-m // 16) + 1
    return floats, counters


def int4_mlp_s4_stacked(x: torch.Tensor, w_gu: Int4Weight, w_down: Int4Weight,
                        layer: int, activation: str = "silu_glu"
                        ) -> torch.Tensor:
    """The fused MLP of layer `layer` of the stacks w_gu [L, H, 2I] and
    w_down [L, I, H] (read in place) for x [S, H], S <= 64; returns [S, H]
    in x's dtype."""
    _check_pair(x, w_gu, w_down, layer, activation)
    wg, wd = w_gu.layer(layer), w_down.layer(layer)
    if x.device.type == "cpu":
        if wg.zbias is None or wd.zbias is None:
            raise ValueError("int4_mlp: the plain version needs zbias "
                             "(compute_zbias)")
        return int4_mlp_reference(x, wg, wd, activation)
    _check_cuda(x, wg, wd)
    m, h = x.shape
    inter = wd.in_features
    y = torch.empty((m, h), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    lib = build.library("int4_mlp")
    splits_gu, splits_down = split_plan(2 * inter, h), split_plan(h, inter)
    floats, n_counters = scratch_need(h, inter, m)
    ws = workspace(x.device, floats)
    counters = arrivals(x.device, n_counters)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.tgi_int4_mlp(
            x.data_ptr(), wg.qweight.data_ptr(), wg.qzeros.data_ptr(),
            wg.scales.data_ptr(), wd.qweight.data_ptr(), wd.qzeros.data_ptr(),
            wd.scales.data_ptr(), ws.data_ptr(), counters.data_ptr(),
            y.data_ptr(), m, h, inter, wg.groupsize, wd.groupsize, splits_gu,
            splits_down, ACTIVATIONS[activation], build.dtype_code(x.dtype),
            stream)
    build.check("int4_mlp", code)
    int4_mlp_s4_stacked.launches += 1
    return y


int4_mlp_s4_stacked.launches = 0
