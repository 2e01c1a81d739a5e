"""Decode attention over a paged KV pool: wrappers of
`csrc/paged_attention.cu` (normalized and stats modes) and their plain
PyTorch versions.

Counterpart of the JAX package's `ops/pallas/paged_attention.py`. Shapes
(the JAX layouts):
  q:           [S, K, G, D]
  k/v pool:    [K, P * page_size, D]   (one layer's view of [L, K, R, D])
  block_table: [S, max_pages] i32; entries that are not mapped hold the
               sentinel P (`num_pages`)
  ctx:         [S] i32 live tokens per slot
  out:         [S, K, G, D] (normalized), or acc [S, K, G, D] f32 plus
               m, l [S, K, G] f32 (stats)

The plain versions gather each slot's pages with explicit masking: a key
position is live when it is below ctx and its page id lies in
[0, num_pages); sentinel pages contribute nothing (the kernel skips them).
The JAX reference clamps such gathers instead (`mode="clip"`), which gives
the same result wherever the sentinel lies past ctx.

Each wrapper takes the plain version only for CPU tensors; for a CUDA
tensor it launches the kernel or raises. `paged_decode_attention.launches`
and `paged_decode_attention_partial.launches` count launches.
"""

from __future__ import annotations

import math

import torch

from . import build

HEAD_DIMS = (64, 128)
MAX_GROUP = 8     # query heads per kv head the kernel handles


def _gather_pages(q, k_pool, v_pool, block_table, ctx, page_size):
    """Scores [S, K, G, T'] f32 (dead keys at -inf) and values
    [K, S, T', D] f32 (dead rows zeroed), T' = max_pages * page_size."""
    s, kh, g, d = q.shape
    pool_rows = k_pool.shape[1]
    num_pages = pool_rows // page_size
    bt = block_table.to(torch.int64)
    offs = torch.arange(page_size, device=q.device)
    rows = (bt[:, :, None] * page_size + offs[None, None, :]).reshape(s, -1)
    mapped = ((bt >= 0) & (bt < num_pages))[:, :, None].expand(
        -1, -1, page_size).reshape(s, -1)
    t = rows.shape[1]
    live = (torch.arange(t, device=q.device)[None, :]
            < ctx.to(q.device)[:, None]) & mapped
    rows = rows.clamp(0, pool_rows - 1)
    k = k_pool[:, rows].to(torch.float32)                      # [K, S, T', D]
    v = v_pool[:, rows].to(torch.float32)
    scores = torch.einsum("skgd,kstd->skgt", q.to(torch.float32),
                          k) * (1.0 / math.sqrt(d))
    scores = scores.masked_fill(~live[:, None, None, :], -math.inf)
    v = torch.where(live[None, :, :, None], v, 0.0)
    return scores, v


def paged_decode_attention_partial_reference(q, k_pool, v_pool, block_table,
                                             ctx, page_size):
    """Plain version of the stats mode: (acc f32, m f32, l f32)."""
    scores, v = _gather_pages(q, k_pool, v_pool, block_table, ctx, page_size)
    m = torch.max(scores, dim=-1).values                       # [S, K, G]
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp(scores - m_safe[..., None])
    p = torch.where(torch.isneginf(scores), 0.0, p)
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("skgt,kstd->skgd", p, v)
    return acc, m, l


def paged_decode_attention_reference(q, k_pool, v_pool, block_table, ctx,
                                     page_size):
    """Plain version of the normalized mode (acc / max(l, 1e-30), so a slot
    with ctx == 0 gives 0, as the kernel does)."""
    acc, _, l = paged_decode_attention_partial_reference(
        q, k_pool, v_pool, block_table, ctx, page_size)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def _check(fn, q, k_pool, v_pool, block_table, ctx, page_size):
    s, kh, g, d = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    for name, x in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("ctx", ctx)):
        if x.device != q.device:
            raise ValueError(f"{fn}: {name} on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError(f"{fn}: q must be contiguous")
    if (q.dtype != torch.bfloat16 or k_pool.dtype != q.dtype
            or v_pool.dtype != q.dtype):
        raise ValueError(f"{fn}: q and pools must be bfloat16, got {q.dtype}, "
                         f"{k_pool.dtype}, {v_pool.dtype}")
    if block_table.dtype != torch.int32 or ctx.dtype != torch.int32:
        raise ValueError(f"{fn}: block_table and ctx must be int32")
    if (k_pool.dim() != 3 or k_pool.shape[0] != kh or k_pool.shape[2] != d
            or v_pool.shape != k_pool.shape):
        raise ValueError(f"{fn}: pools {tuple(k_pool.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != s or ctx.shape != (s,):
        raise ValueError(f"{fn}: block_table [S, max_pages] and ctx [S] "
                         "expected")
    if d not in HEAD_DIMS or g > MAX_GROUP:
        raise ValueError(f"{fn}: head_dim {d} (want {HEAD_DIMS}) or group "
                         f"{g} (want <= {MAX_GROUP}) not supported")
    if k_pool.shape[1] % page_size:
        raise ValueError(f"{fn}: pool rows not a multiple of page_size")


def _launch(entry, q, k_pool, v_pool, block_table, ctx, page_size, outs):
    s, kh, g, d = q.shape
    lib = build.library("paged_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    pool_rows = k_pool.shape[1]
    with torch.cuda.device(q.device):
        code = getattr(lib, entry)(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), ctx.data_ptr(),
            *[o.data_ptr() for o in outs], s, kh, g, d, pool_rows, page_size,
            block_table.shape[1], pool_rows // page_size, 1.0 / math.sqrt(d),
            stream)
    build.check("paged_attention", code)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           ctx: torch.Tensor, page_size: int) -> torch.Tensor:
    """Normalized mode. Returns [S, K, G, D] in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_pool, v_pool,
                                                block_table, ctx, page_size)
    _check("paged_decode_attention", q, k_pool, v_pool, block_table, ctx,
           page_size)
    out = torch.empty_like(q)
    if q.numel() == 0 or block_table.shape[1] == 0:
        return out.zero_()
    _launch("tgi_paged_decode", q, k_pool, v_pool,
            block_table, ctx, page_size, [out])
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention_partial(q: torch.Tensor, k_pool: torch.Tensor,
                                   v_pool: torch.Tensor,
                                   block_table: torch.Tensor,
                                   ctx: torch.Tensor, page_size: int):
    """Stats mode: (acc [S,K,G,D] f32, m [S,K,G] f32, l [S,K,G] f32), with
    m = -inf, l = 0, acc = 0 for slots with ctx == 0."""
    if q.device.type == "cpu":
        return paged_decode_attention_partial_reference(
            q, k_pool, v_pool, block_table, ctx, page_size)
    _check("paged_decode_attention_partial", q, k_pool, v_pool, block_table,
           ctx, page_size)
    s, kh, g, d = q.shape
    acc = torch.empty((s, kh, g, d), dtype=torch.float32, device=q.device)
    m = torch.empty((s, kh, g), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if q.numel() == 0 or block_table.shape[1] == 0:
        return acc.zero_(), m.fill_(-math.inf), l.zero_()
    _launch("tgi_paged_decode_stats", q,
            k_pool, v_pool, block_table, ctx, page_size, [acc, m, l])
    paged_decode_attention_partial.launches += 1
    return acc, m, l


def paged_decode_attention_partial_stacked(q, k_pools, v_pools, block_table,
                                           ctx, layer_idx: int,
                                           page_size: int):
    """Stats mode over layer-stacked pools [L, K, R, D]: the layer's pool is
    a view (`pools[layer_idx]`, no copy), so this is the same kernel."""
    return paged_decode_attention_partial(q, k_pools[layer_idx],
                                          v_pools[layer_idx], block_table,
                                          ctx, page_size)


paged_decode_attention.launches = 0
paged_decode_attention_partial.launches = 0
