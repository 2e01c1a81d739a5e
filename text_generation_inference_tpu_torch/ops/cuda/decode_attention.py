"""One-query decode attention over the slot KV cache: wrapper of
`csrc/slot_attention.cu` (entry `tgi_slot_decode`, kernel S1) and its plain
PyTorch version.

Counterpart of the JAX package's `ops/pallas/decode_attention.py`
(`decode_attention`, `decode_attention_reference`). Shapes:
  q:    [S, K, G, D]
  k, v: [S, K, T, D]   (one layer of the slot cache; any strides over S, K
                        and T, the head dim contiguous)
  ctx:  [S] int32      live cache rows per slot, the current token included
  lo:   [S] int32      optional: the first live row of each slot (a sliding
                       window W gives lo = ctx - W, the JAX model's decode
                       mask); rows below it are neither read nor counted
  slopes: [K, G] f32   optional ALiBi slopes: slope * j is added to the
                       scaled score of cache row j (the JAX model's decode
                       bias; query head k * G + g)
  out:  [S, K, G, D]   in q's dtype

q and the cache are bf16, fp16 or fp32 (`DTYPES`, fp32 on the split
body's 3xTF32 kernel); the kernel takes every head dim in `HEAD_DIMS` and
any group G, over the tile plan of `paged_attention.tile_plan`.

A slot with ctx == 0 gives 0, as the JAX kernel does (it clamps the softmax
denominator at 1e-30); the JAX reference gives NaN there. Rows at or past
ctx, and rows below lo, are never read: the plain version zeroes their
values before the value product, the kernel does not load them.

The kernel is the split body of `csrc/decode_split.cuh` over the slot
cache: fixed splits of SPLIT_ROWS cache rows (`split_plan`, from T alone,
so a slot's result does not depend on the batch), merged in split order in
the same launch by the last block to arrive at a per-(slot, kv head)
counter (the device's `paged_attention.arrivals`). With `lo`, a slot's
splits start at the one that holds row lo[s], and that split starts at
lo[s]: its plan covers only the live rows [lo, ctx).
`decode_attention_split_reference` is the plain twin of that schedule
(the kernel sums each warp's keys of a split, then merges its 4 warps: the
same fp32 sums in another order).

`decode_attention` takes the plain version only for CPU tensors; for a CUDA
tensor it launches the kernel or raises. `decode_attention.launches` counts
launches, `decode_attention.windowed` those given lower bounds,
`decode_attention.alibi` those given slopes. `check_cache` and
`_masked_scores` are shared with `ring_decode_attention.py`.
"""

from __future__ import annotations

import math

import torch

from . import build
from .paged_attention import (
    DTYPES,
    HEAD_DIMS,
    arrivals,
    merge_splits,
    scratch_blocks,
    tile_plan,
)

SPLIT_ROWS = 256    # cache rows a split of the kernel covers


def split_plan(t: int) -> tuple[int, int]:
    """(rows per split, splits) of S1's grid over a T-row cache: SPLIT_ROWS
    rows a split, from T alone, never from the number of slots."""
    return SPLIT_ROWS, max(1, -(-t // SPLIT_ROWS))


def _masked_scores(q, k, v, ctx, lo=None, slopes=None, row0: int = 0):
    """Scores [S, K, G, T] f32 (rows >= ctx, and rows < lo, at -inf; plus
    slope * (row0 + row) with `slopes`) and values [S, K, T, D] f32 (those
    rows zeroed)."""
    d = q.shape[-1]
    t = k.shape[2]
    rows = torch.arange(t, device=q.device)[None, :]
    live = rows < ctx.to(q.device)[:, None]
    if lo is not None:
        live = live & (rows >= lo.to(q.device)[:, None])
    scores = torch.einsum("skgd,sktd->skgt", q.to(torch.float32),
                          k.to(torch.float32)) * (1.0 / math.sqrt(d))
    if slopes is not None:
        pos = (rows[0] + row0).to(torch.float32)
        scores = scores + slopes.to(torch.float32)[None, :, :, None] * pos
    scores = scores.masked_fill(~live[:, None, None, :], -math.inf)
    vf = torch.where(live[:, None, :, None], v.to(torch.float32), 0.0)
    return scores, vf


def decode_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, ctx: torch.Tensor,
                               lo: torch.Tensor | None = None,
                               slopes: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Plain version: fp32 softmax over rows [lo, ctx) (plus slope * row
    with `slopes`), acc / max(l, 1e-30)."""
    scores, vf = _masked_scores(q, k, v, ctx, lo, slopes)
    m = torch.max(scores, dim=-1, keepdim=True).values
    m = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp(scores - m)                        # exp(-inf) = 0
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("skgt,sktd->skgd", p, vf) / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)


def split_parts(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                ctx: torch.Tensor, rows_per_split: int,
                lo: torch.Tensor | None = None,
                slopes: torch.Tensor | None = None) -> list:
    """(acc, m, l, used [S]) of every split of `rows_per_split` rows of k / v
    [S, K, T, D], in split order: fp32 softmax states over the split's rows
    in [lo, ctx) (plus slope * row with `slopes`); `used` marks the splits of
    a slot's plan, from the split that holds its first live row to the one
    that holds its last (at least one)."""
    t = k.shape[2]
    ctx = ctx.to(torch.int64).clamp(0, t)
    lo = (torch.zeros_like(ctx) if lo is None
          else torch.minimum(lo.to(torch.int64).clamp(min=0), ctx))
    first = lo // rows_per_split
    n_splits = torch.clamp(-(-ctx // rows_per_split) - first, min=1)
    parts = []
    for sp, r0 in enumerate(range(0, t, rows_per_split)):
        r1 = min(r0 + rows_per_split, t)
        scores, vf = _masked_scores(q, k[:, :, r0:r1], v[:, :, r0:r1],
                                    torch.clamp(ctx - r0, min=0),
                                    torch.clamp(lo - r0, min=0), slopes, r0)
        m = torch.max(scores, dim=-1).values                     # [S, K, G]
        m_safe = torch.where(torch.isneginf(m), 0.0, m)
        p = torch.exp(scores - m_safe[..., None])               # exp(-inf) = 0
        acc = torch.einsum("skgt,sktd->skgd", p, vf)
        parts.append((acc, m, p.sum(dim=-1),
                      (sp >= first) & (sp < first + n_splits)))
    return parts


def decode_attention_split_reference(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, ctx: torch.Tensor,
                                     rows_per_split=None,
                                     lo: torch.Tensor | None = None,
                                     slopes: torch.Tensor | None = None
                                     ) -> torch.Tensor:
    """Plain twin of the kernel's schedule: (acc, m, l) of every split of
    `rows_per_split` cache rows (default: `split_plan`'s), from the split
    that holds a slot's first live row (the rows below `lo` masked), the
    splits past a slot's rows left out, merged in split order, then
    normalized."""
    if rows_per_split is None:
        rows_per_split = split_plan(k.shape[2])[0]
    parts = split_parts(q, k, v, ctx, rows_per_split, lo, slopes)
    acc, _, l = merge_splits(parts, q.shape, q.device)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def check_cache(fn: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                ctx: torch.Tensor) -> None:
    """Raise unless q, the cache views and ctx are what the kernel takes."""
    s, kh, g, d = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    for name, x in (("k", k), ("v", v), ("ctx", ctx)):
        if x.device != q.device:
            raise ValueError(f"{fn}: {name} on {x.device}, q on {q.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{fn}: q, k, v must share one of {DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if ctx.dtype != torch.int32 or ctx.shape != (s,) or not ctx.is_contiguous():
        raise ValueError(f"{fn}: ctx must be a contiguous int32 [S] tensor")
    if not q.is_contiguous():
        raise ValueError(f"{fn}: q must be contiguous")
    if (k.dim() != 4 or k.shape[:2] != (s, kh) or k.shape[3] != d
            or v.shape != k.shape or k.shape[2] == 0):
        raise ValueError(f"{fn}: cache {tuple(k.shape)} / {tuple(v.shape)} "
                         f"does not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{fn}: head_dim {d} not in {HEAD_DIMS}")
    # 16-byte row loads: the head dim contiguous, rows 16-byte aligned
    if (k.stride() != v.stride() or k.stride(3) != 1
            or any(st % 8 for st in k.stride()[:3])
            or k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError(f"{fn}: k and v need equal strides, a contiguous "
                         "head dim and 16-byte aligned rows")


def check_slopes(fn: str, q: torch.Tensor, slopes) -> None:
    """Raise unless `slopes` is None or a contiguous f32 [K, G] tensor on
    q's device."""
    if slopes is not None and (
            slopes.device != q.device or slopes.dtype != torch.float32
            or slopes.shape != q.shape[1:3] or not slopes.is_contiguous()):
        raise ValueError(f"{fn}: slopes must be a contiguous float32 "
                         f"{tuple(q.shape[1:3])} tensor on {q.device}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     ctx: torch.Tensor,
                     lo: torch.Tensor | None = None,
                     slopes: torch.Tensor | None = None) -> torch.Tensor:
    """See module docstring. Returns [S, K, G, D] in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, ctx, lo, slopes)
    check_cache("decode_attention", q, k, v, ctx)
    if lo is not None and (lo.device != q.device or lo.dtype != torch.int32
                           or lo.shape != ctx.shape
                           or not lo.is_contiguous()):
        raise ValueError("decode_attention: lo must be a contiguous int32 "
                         "[S] tensor on q's device")
    check_slopes("decode_attention", q, slopes)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    s, kh, g, d = q.shape
    t = k.shape[2]
    rows, splits = split_plan(t)
    blocks, heads = scratch_blocks(s, kh, g)
    part = (torch.empty(blocks * splits * heads * (d + 2),
                        dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    counters = arrivals(q.device, blocks)
    lib = build.library("slot_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = lib.tgi_slot_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ctx.data_ptr(),
            None if lo is None else lo.data_ptr(),
            None if slopes is None else slopes.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            counters.data_ptr(), s, kh, g, d, t, *k.stride()[:3], rows,
            splits, *tile_plan(d, g, q.dtype), build.dtype_code(q.dtype),
            1.0 / math.sqrt(d), stream)
    build.check("slot_attention", code)
    decode_attention.launches += 1
    if lo is not None:
        decode_attention.windowed += 1
    if slopes is not None:
        decode_attention.alibi += 1
    return out


decode_attention.launches = 0
decode_attention.windowed = 0
decode_attention.alibi = 0
