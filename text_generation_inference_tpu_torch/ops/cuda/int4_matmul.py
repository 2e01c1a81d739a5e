"""GPTQ INT4 dequant-GEMM: wrappers of `csrc/int4_matmul.cu` (kernel K1)
and its plain PyTorch versions.

Counterpart of the JAX package's `ops/pallas/int4_matmul.py`. The three
entry names keep their JAX meanings and all reach the one kernel:

  int4_matmul_s4_stacked(x, w, layer)  one layer of a layer-stacked weight
                                       (the decode route); the layer is a
                                       view of the stack, no copy
  int4_matmul_s4(x, w)                 an unstacked [in, out] weight
  int4_matmul(x, w)                    a weight in the packed [in/8, out]
                                       layout (the prefill route)

x is [M, in] in bf16, fp16 or fp32 (`DTYPES`) and already gathered by the
act-order `perm` (`ops/linear.py` does that); g_idx must be sequential
(`quant.int4.normalize_act_order`). Returns [M, out] in x's dtype.

The kernel computes the group-dot form: each weight enters the tensor
cores as the exact integer q - zero - 1 (bf16 or fp16 operands; fp32 x as
two bf16 terms, hi + lo), each group's product is accumulated in fp32 and
scaled by the column's scale. `int4_matmul_group_dot_reference` is the
plain twin of that order; `int4_matmul_reference` (dequantize, one f32
matmul) stays the plain version the wrappers take on the CPU.

Two schedules, picked by the kernel from M (and fp32 x): the decode
schedule (M <= DECODE_ROWS, and fp32 x at any M) splits K over blocks by
`split_plan(N, K)`, which never depends on M, so every row's result is the
same bits at any batch size; the splits meet in a fixed per-device fp32
workspace (`workspace`) and the last block of a column block adds them in
split order, in the same launch. The prefill schedule (bf16 / fp16 x past
DECODE_ROWS rows) never splits. One launch a product, no allocation but
the output.

Each wrapper takes the plain version only for a tensor that lies on the
CPU; for a CUDA tensor it launches the kernel or raises. Each counts its
own launches in `.launches`.
"""

from __future__ import annotations

import torch

from ..quant.int4 import Int4Weight, unpack_cols, unpack_rows
from . import build
from .paged_attention import arrivals, grow_scratch

K_TILE = 64    # the kernel's K tile: in_features and the group size are multiples
BLOCK_N = 128  # W columns a block of either schedule
DECODE_ROWS = 64   # rows the decode schedule takes (fp32 x: any)
MAX_SPLITS = 16
SMS = 132      # the H100's SMs
# the decode grid aims at four blocks an SM (measured on the 7B products at
# M = 16 against one and two an SM: the schedule gains with more blocks in
# flight, PERF.md)
BLOCKS_PER_SM = 4
DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def split_plan(n: int, k: int) -> int:
    """The decode schedule's K splits for an [in k, out n] weight: 1 when
    the column blocks give every SM BLOCKS_PER_SM, else enough splits to
    do so, at most MAX_SPLITS and at most one a K tile. From (N, K) alone."""
    tiles = k // K_TILE
    blocks = -(-n // BLOCK_N)
    target = BLOCKS_PER_SM * SMS
    if tiles <= 1 or blocks >= target:
        return 1
    return max(1, min(-(-target // blocks), MAX_SPLITS, tiles))


def split_tiles(n: int, k: int) -> list[tuple[int, int]]:
    """The K tiles [t0, t1) each split of `split_plan(n, k)` covers, as the
    kernel divides them."""
    tiles, splits = k // K_TILE, split_plan(n, k)
    return [(tiles * s // splits, tiles * (s + 1) // splits)
            for s in range(splits)]


def int4_matmul_reference(x: torch.Tensor, w: Int4Weight) -> torch.Tensor:
    """Plain version: dequantize to f32 (q * scale - zbias, group = row //
    groupsize) and one f32 matmul; returns x's dtype."""
    gs = w.groupsize
    q = unpack_rows(w.qweight).to(torch.float32)
    s = w.scales.to(torch.float32).repeat_interleave(gs, dim=0)
    zb = w.zbias.to(torch.float32).repeat_interleave(gs, dim=0)
    return torch.matmul(x.to(torch.float32), q * s - zb).to(x.dtype)


def operand_terms(x: torch.Tensor) -> list[torch.Tensor]:
    """x as the kernel's tensor-core operands, in f32: bf16 and fp16 x as
    they are; fp32 x as hi = bf16(x) and lo = bf16(x - hi)."""
    if x.dtype != torch.float32:
        return [x.to(torch.float32)]
    hi = x.to(torch.bfloat16).to(torch.float32)
    return [hi, (x - hi).to(torch.bfloat16).to(torch.float32)]


def int4_matmul_group_dot_reference(x: torch.Tensor,
                                    w: Int4Weight) -> torch.Tensor:
    """Plain twin of the kernel's order: for each group g, the f32 product
    of x's operand terms with the exact integers q - zero - 1 of the group's
    rows, times the group's scales, summed over the groups in order;
    returns x's dtype."""
    gs = w.groupsize
    q = unpack_rows(w.qweight).to(torch.float32)
    z = (unpack_cols(w.qzeros) + 1).to(torch.float32)
    sc = w.scales.to(torch.float32)
    terms = operand_terms(x)
    y = torch.zeros((x.shape[0], w.out_features), dtype=torch.float32,
                    device=x.device)
    for g in range(w.in_features // gs):
        wi = q[g * gs:(g + 1) * gs] - z[g]
        part = sum(torch.matmul(t[:, g * gs:(g + 1) * gs], wi) for t in terms)
        y = y + part * sc[g]
    return y.to(x.dtype)


_WORKSPACE: dict[torch.device, torch.Tensor] = {}


def workspace(device: torch.device, numel: int) -> torch.Tensor:
    """The device's fp32 split workspace, at least `numel` floats; it grows
    (rarely: to the largest [splits, M, N] seen, never while captured decode
    programs pin it: `paged_attention.grow_scratch`) and is otherwise reused
    by every launch on the stream."""
    return grow_scratch(_WORKSPACE, device, numel, lambda n: torch.empty(
        max(n, 1 << 20), dtype=torch.float32, device=device))


def scratch_need(n: int, k: int, m: int = DECODE_ROWS) -> tuple[int, int]:
    """(workspace floats, arrival counters) a launch of m rows on an [in k,
    out n] weight takes; m = DECODE_ROWS gives the most any row count
    takes."""
    splits = split_plan(n, k) if m <= DECODE_ROWS else 1
    return (splits * m * n if splits > 1 else 0), -(-n // BLOCK_N)


def _check(fn: str, x: torch.Tensor, w: Int4Weight) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    for name in ("qweight", "qzeros", "scales"):
        t = getattr(w, name)
        if t.device != x.device:
            raise ValueError(f"{fn}: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if x.dtype not in DTYPES or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{fn}: x must be a contiguous [M, in] tensor of "
                         f"one of {DTYPES}, got {x.dtype} {tuple(x.shape)}")
    if any(t.data_ptr() % 16 for t in (x, w.qweight, w.scales)):
        raise ValueError(f"{fn}: x, qweight and scales must be 16-byte "
                         "aligned")
    if (w.qweight.dtype != torch.int32 or w.qweight.dim() != 2
            or w.qzeros.dtype != torch.int32):
        raise ValueError(f"{fn}: qweight [in/8, out] and qzeros must be int32")
    if w.scales.dtype != torch.float32:
        raise ValueError(f"{fn}: scales must be float32")
    m, k = x.shape
    n, gs = w.out_features, w.groupsize
    if (k != w.in_features or w.scales.shape != (k // gs, n)
            or w.qzeros.shape != (k // gs, n // 8)):
        raise ValueError(f"{fn}: x {tuple(x.shape)} does not match qweight "
                         f"{tuple(w.qweight.shape)} / qzeros "
                         f"{tuple(w.qzeros.shape)} / scales "
                         f"{tuple(w.scales.shape)}")
    if k % K_TILE or gs % K_TILE or n % 8:
        raise ValueError(f"{fn}: in {k} and groupsize {gs} must be multiples "
                         f"of {K_TILE}, out {n} of 8")


def _launch(fn: str, x: torch.Tensor, w: Int4Weight) -> torch.Tensor:
    _check(fn, x, w)
    m, k = x.shape
    n = w.out_features
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    lib = build.library("int4_matmul")
    splits = split_plan(n, k) if m <= DECODE_ROWS else 1
    floats, n_counters = scratch_need(n, k, m)
    partial = workspace(x.device, floats) if floats else None
    counters = arrivals(x.device, n_counters)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.tgi_int4_matmul(
            x.data_ptr(), w.qweight.data_ptr(), w.qzeros.data_ptr(),
            w.scales.data_ptr(), y.data_ptr(),
            None if partial is None else partial.data_ptr(),
            counters.data_ptr(), m, n, k, w.groupsize, splits,
            build.dtype_code(x.dtype), stream)
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
