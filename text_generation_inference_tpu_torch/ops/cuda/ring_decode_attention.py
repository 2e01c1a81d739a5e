"""Decode attention of the ring-buffer chunk scheme: wrapper of
`csrc/slot_attention.cu` (entry `tgi_ring_decode`, kernel S2) and its plain
PyTorch version.

Counterpart of the JAX package's `ops/pallas/ring_decode_attention.py`. One
softmax over three sources: the read-only slot cache (rows < ctx, the
chunk's start position), the in-chunk ring buffer (columns < step_idx) and
the current token's k/v. It computes what `models.core.decode_ring_step`
computes inline. Shapes:
  q:          [S, K, G, D]
  k/v cache:  [S, K, B, D]   (any strides over S, K and B, head dim contiguous)
  kbuf/vbuf:  [S, K, C, D]   contiguous
  k/v new:    [S, K, D]      contiguous
  ctx:        [S] int32      valid cache rows per slot
  step_idx:   int            valid ring columns (0 <= step_idx <= C)
  out:        [S, K, G, D]   in q's dtype

The JAX kernel pads S to a slot block of 8 and walks each group up to its
largest context; both are TPU tiling. Here each slot stops at its own ctx:
S2 is S1's split body in its ring mode, one launch. The cache rows are
split as S1 splits them (`decode_attention.split_plan` over the cache's
rows), the ring columns < step_idx as more splits of the same size after
them; the block that arrives last merges the cache's
splits, then the ring's, in split order, folds in the current token and
normalizes. `ring_decode_split_reference` is the plain twin of that
schedule. The dtypes and shapes are S1's (`decode_attention.check_cache`).

`ring_decode_attention` takes the plain version only for CPU tensors; for a
CUDA tensor it launches the kernel or raises.
`ring_decode_attention.launches` counts launches.
"""

from __future__ import annotations

import math

import torch

from . import build
from .decode_attention import (
    _masked_scores,
    check_cache,
    split_parts,
    split_plan,
)
from .paged_attention import arrivals, merge_splits, scratch_blocks, tile_plan

MAX_RING = 1024     # ring columns the kernel takes


def _launch(q, k, v, ctx, ring_args, c: int, step_idx: int):
    """Launch S2 on the current stream (checked inputs); returns out
    [S, K, G, D] in q's dtype. The split scratch is allocated here."""
    s, kh, g, d = q.shape
    t = k.shape[2]
    rows, cache_splits = split_plan(t)
    ring = -(-c // rows)            # the ring's splits, of `rows` columns
    blocks, heads = scratch_blocks(s, kh, g)
    part = torch.empty(blocks * (cache_splits + ring) * heads * (d + 2),
                       dtype=torch.float32, device=q.device)
    counters = arrivals(q.device, blocks)
    out = torch.empty_like(q)
    lib = build.library("slot_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = lib.tgi_ring_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ctx.data_ptr(),
            *[x.data_ptr() for x in ring_args], out.data_ptr(),
            part.data_ptr(), counters.data_ptr(), s, kh, g, d, t,
            *k.stride()[:3], rows, cache_splits, ring, c, step_idx,
            *tile_plan(d, g, q.dtype), build.dtype_code(q.dtype),
            1.0 / math.sqrt(d), stream)
    build.check("slot_attention", code)
    return out


def ring_decode_attention_reference(q, k_cache, v_cache, kbuf, vbuf, k_new,
                                    v_new, ctx, step_idx: int):
    """Plain version (fp32 math, output in q's dtype)."""
    d = q.shape[-1]
    c = kbuf.shape[2]
    qf = q.to(torch.float32)
    scores, vc = _masked_scores(q, k_cache, v_cache, ctx)
    live = torch.arange(c, device=q.device) < step_idx              # [C]
    bscores = torch.einsum("skgd,skcd->skgc", qf,
                           kbuf.to(torch.float32)) * (1.0 / math.sqrt(d))
    bscores = bscores.masked_fill(~live, -math.inf)
    vb = torch.where(live[:, None], vbuf.to(torch.float32), 0.0)
    s_new = torch.sum(qf * k_new.to(torch.float32)[:, :, None, :],
                      dim=-1) * (1.0 / math.sqrt(d))
    probs = torch.softmax(torch.cat([scores, bscores, s_new[..., None]], -1),
                          dim=-1)
    t = scores.shape[-1]
    out = (torch.einsum("skgt,sktd->skgd", probs[..., :t], vc)
           + torch.einsum("skgc,skcd->skgd", probs[..., t:t + c], vb)
           + probs[..., t + c:] * v_new.to(torch.float32)[:, :, None, :])
    return out.to(q.dtype)


def ring_decode_split_reference(q, k_cache, v_cache, kbuf, vbuf, k_new,
                                v_new, ctx, step_idx: int,
                                rows_per_split=None):
    """Plain twin of the kernel's schedule: (acc, m, l) of every split of
    the cache (`rows_per_split` rows, default `split_plan`'s), then of the
    ring's columns < step_idx in splits of the same size, then the current
    token (acc = its v, m = its score, l = 1), merged in that order, then
    normalized (fp32 math, output in q's dtype)."""
    s = q.shape[0]
    d = q.shape[-1]
    if rows_per_split is None:
        rows_per_split = split_plan(k_cache.shape[2])[0]
    parts = split_parts(q, k_cache, v_cache, ctx, rows_per_split)
    parts += split_parts(q, kbuf, vbuf,
                         torch.full((s,), int(step_idx), dtype=torch.int32,
                                    device=q.device),
                         rows_per_split)
    s_new = torch.einsum("skgd,skd->skg", q.to(torch.float32),
                         k_new.to(torch.float32)) * (1.0 / math.sqrt(d))
    parts.append((v_new.to(torch.float32)[:, :, None, :].expand(q.shape),
                  s_new, torch.ones_like(s_new),
                  torch.ones(s, dtype=torch.bool, device=q.device)))
    acc, _, l = merge_splits(parts, q.shape, q.device)
    return (acc / l[..., None]).to(q.dtype)


def ring_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, kbuf: torch.Tensor,
                          vbuf: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor, ctx: torch.Tensor,
                          step_idx: int) -> torch.Tensor:
    """See module docstring. Returns [S, K, G, D] in q's dtype."""
    if q.device.type == "cpu":
        return ring_decode_attention_reference(q, k_cache, v_cache, kbuf,
                                               vbuf, k_new, v_new, ctx,
                                               step_idx)
    fn = "ring_decode_attention"
    check_cache(fn, q, k_cache, v_cache, ctx)
    s, kh, g, d = q.shape
    c = kbuf.shape[2] if kbuf.dim() == 4 else 0
    for name, x, shape in (("kbuf", kbuf, (s, kh, c, d)),
                           ("vbuf", vbuf, (s, kh, c, d)),
                           ("k_new", k_new, (s, kh, d)),
                           ("v_new", v_new, (s, kh, d))):
        if (x.device != q.device or x.dtype != q.dtype or x.shape != shape
                or not x.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be a contiguous {q.dtype} "
                             f"{shape} tensor on {q.device}")
    if not 1 <= c <= MAX_RING or not 0 <= step_idx <= c:
        raise ValueError(f"{fn}: ring of {c} columns (want 1..{MAX_RING}) "
                         f"with step_idx {step_idx} not supported")
    if q.numel() == 0:
        return torch.empty_like(q)
    out = _launch(q, k_cache, v_cache, ctx, (kbuf, vbuf, k_new, v_new), c,
                  int(step_idx))
    ring_decode_attention.launches += 1
    return out


ring_decode_attention.launches = 0
