"""Decoder forward passes over the paged KV pool (port of the JAX package's
`models/paged_core.py`: float pools, and int8 pools with scale pools).

Same layer math as `models/core.py`; only the cache side differs: K/V rows
live in flat page pools [L, K, P*page, D] and every read and write goes
through the block table.

Writes update the pools IN PLACE (the JAX package donated the pools to
each jitted step instead). Writes that JAX routed out of bounds and dropped
(`.at[].set(mode="drop")`: inactive slots, padded prefill positions, ring
positions past max_seq, unmapped sentinel pages) are masked out explicitly
here: the valid rows are selected once per call, and only they are
written. Reads through the block table clamp (`gather_dense_view`) or skip
unmapped pages (the paged kernel).

int8 pools: rows are quantized as they are written (prefill scatter, ring
flush; `core.quantize_kv`), and the scale pools go through the same valid-row
selection as the value pools. The per-step `decode_paged` has no int8 write
path (the engine requires ring chunks for int8, as the JAX engine does).

Each function takes `attn`, the kernel implementation: `KERNELS` (the CUDA
kernels; on CPU tensors their plain versions) or `PLAIN`, for attention and
for the GPTQ-INT4 products.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..engine.paged_cache import PagedKVCache
from ..ops.attention import KERNELS, AttentionOps
from .core import (
    DecoderSpec,
    KVCache,
    _apply_rope,
    _attn_out,
    _embed,
    _norm,
    _qkv,
    _residual,
    _rope_freqs,
    _unembed,
    check_supported,
    layer_params,
    prefill_forward,
    quantize_kv,
)


def _valid_rows(rows: torch.Tensor, valid: torch.Tensor, pool_rows: int):
    """Flatten and select the write targets that JAX's mode="drop" would
    keep: (source indices, pool rows), both int64 1-D."""
    rows = rows.reshape(-1).to(torch.int64)
    keep = valid.reshape(-1) & (rows >= 0) & (rows < pool_rows)
    src = torch.nonzero(keep).squeeze(1)
    return src, rows[src]


def decode_paged(
    spec: DecoderSpec,
    params: dict,
    ids: torch.Tensor,          # [S]
    positions: torch.Tensor,    # [S] write position (= context_len - 1)
    cache: PagedKVCache,
    context_len: torch.Tensor,  # [S] = positions + 1 for active slots
    page_size: int,
    active: Optional[torch.Tensor] = None,   # [S] bool; inactive writes dropped
    attn: AttentionOps = KERNELS,
) -> tuple[torch.Tensor, PagedKVCache]:
    """One decode step over every slot via the page pool. Writes each slot's
    new k/v row into its page in place, then attends over the pool.
    Returns ([S, V] f32 logits, cache)."""
    check_supported(spec)
    if cache.quantized:
        raise ValueError("decode_paged has no int8 write path; int8 pools are "
                         "written by the ring chunks (paged_ring_flush)")
    s = ids.shape[0]
    bt = cache.block_table
    x = _embed(spec, params, ids, positions)
    cos, sin = _rope_freqs(spec, positions)

    # INACTIVE slots must not write at all: their block-table rows are
    # stale, and an in-bounds write would corrupt whichever live request
    # now owns those pool rows.
    pool_rows = cache.k.shape[2]
    page_idx = (positions // page_size).clamp(0, bt.shape[1] - 1).long()
    rows = (bt[torch.arange(s, device=bt.device), page_idx].to(torch.int64)
            * page_size + positions % page_size)
    valid = (torch.ones_like(rows, dtype=torch.bool) if active is None
             else active.to(torch.bool))
    src, dst = _valid_rows(rows, valid, pool_rows)
    ctx = context_len.to(torch.int32).contiguous()
    group = spec.num_heads // spec.num_kv_heads

    for li in range(spec.num_layers):
        lp = layer_params(params["layers"], li, attn.int4_plain)
        kp, vp = cache.k[li], cache.v[li]               # [K, P*page, D] views
        h = _norm(spec, lp["ln1"], x)
        q, k, v = _qkv(spec, lp, h)                     # q [S,H,Dh]; k/v [S,K,Dh]
        q = _apply_rope(spec, q, cos, sin)
        k = _apply_rope(spec, k, cos, sin)
        kp[:, dst] = k[src].transpose(0, 1).to(kp.dtype)
        vp[:, dst] = v[src].transpose(0, 1).to(vp.dtype)

        qg = q.reshape(s, spec.num_kv_heads, group, spec.head_dim).contiguous()
        a = attn.paged_decode(qg, kp, vp, bt, ctx, page_size)
        a = _attn_out(spec, lp, a.reshape(s, spec.num_heads, spec.head_dim))
        x = _residual(spec, lp, x, a)
    x = _norm(spec, params["final_norm"], x)
    return _unembed(spec, params, x), cache


def gather_dense_view(cache: PagedKVCache, live_pages: int,
                      page_size: int) -> KVCache:
    """Gather every slot's first `live_pages` pages into a dense
    slot-indexed KV view [L, S, K, R, D] (R = live_pages * page_size).

    Within a ring-decode chunk the pool is read-only and the block tables
    are fixed, so this ONE gather (amortized over the whole chunk) lets the
    chunk run the dense ring attention of `core.decode_ring_step`. Row r of
    the view is absolute position r (pages are allocated in position
    order). Gathers clamp to the pool (as JAX's mode="clip"): stale or
    sentinel entries read some pool row, and those positions are masked by
    context length or their outputs discarded. int8 pools bring their scale
    rows ([L, S, K, R]), so the view is a quantized `KVCache`.
    """
    bt = cache.block_table[:, :live_pages].to(torch.int64)      # [S, P']
    s = bt.shape[0]
    pool_rows = cache.k.shape[2]
    rows = (bt[:, :, None] * page_size
            + torch.arange(page_size, device=bt.device)[None, None, :]
            ).reshape(s, live_pages * page_size).clamp(0, pool_rows - 1)
    # pool [L, K, POOL_R, D] --index axis 2--> [L, K, S, R, D] -> [L,S,K,R,D]
    k = cache.k[:, :, rows].transpose(1, 2).contiguous()
    v = cache.v[:, :, rows].transpose(1, 2).contiguous()
    if cache.quantized:
        return KVCache(k=k, v=v,
                       k_scale=cache.k_scale[:, :, rows].transpose(1, 2),
                       v_scale=cache.v_scale[:, :, rows].transpose(1, 2))
    return KVCache(k=k, v=v)


def decode_paged_ring_step(
    spec: DecoderSpec,
    params: dict,
    ids: torch.Tensor,          # [S]
    positions: torch.Tensor,    # [S] position ids[s] will occupy
    cache: PagedKVCache,        # pool READ-ONLY this chunk
    kbuf: torch.Tensor,         # [L, S, K, C, D] in-chunk keys (cols < step_idx)
    vbuf: torch.Tensor,         # [L, S, K, C, D]
    step_idx: int,
    chunk_start: torch.Tensor,  # [S] i32: positions at chunk entry
    page_size: int = 128,
    live_pages: Optional[int] = None,
    attn: AttentionOps = KERNELS,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ring-buffer decode step over the paged pool (the paged counterpart
    of core.decode_ring_step): the pool is never written inside the chunk —
    the paged kernel's stats mode covers pre-chunk context and returns
    partial softmax stats, which are merged flash-decoding style with the
    in-chunk ring buffer and the current token.

    Returns (logits [S, V] f32, k_all [L, S, K, D], v_all [L, S, K, D]).
    """
    check_supported(spec)
    s = ids.shape[0]
    n_buf = kbuf.shape[3]
    bt = cache.block_table
    if live_pages is not None and live_pages < bt.shape[1]:
        # only the live-page bucket of the table is walked
        bt = bt[:, :live_pages].contiguous()
    x = _embed(spec, params, ids, positions)
    cos, sin = _rope_freqs(spec, positions)
    scale = 1.0 / math.sqrt(spec.head_dim)
    group = spec.num_heads // spec.num_kv_heads
    buf_mask = torch.arange(n_buf, device=ids.device)[None, :] < step_idx
    ctx = chunk_start.to(torch.int32).contiguous()

    k_all, v_all = [], []
    for li in range(spec.num_layers):
        lp = layer_params(params["layers"], li, attn.int4_plain)
        h = _norm(spec, lp["ln1"], x)
        q, k, v = _qkv(spec, lp, h)
        q = _apply_rope(spec, q, cos, sin)
        k = _apply_rope(spec, k, cos, sin)
        qg = q.reshape(s, spec.num_kv_heads, group, spec.head_dim).contiguous()

        # part 1: pool attention over pre-chunk context (partial stats); the
        # layer's pools are views of the stacked pools, no copy
        if cache.quantized:
            acc1, m1, l1 = attn.paged_decode_partial_i8(
                qg, cache.k[li], cache.v[li], cache.k_scale[li],
                cache.v_scale[li], bt, ctx, page_size)
        else:
            acc1, m1, l1 = attn.paged_decode_partial(
                qg, cache.k[li], cache.v[li], bt, ctx, page_size)

        # part 2: in-chunk ring + current token
        qf = qg.to(torch.float32)
        bscores = torch.einsum("skgd,skcd->skgc", qf,
                               kbuf[li].to(torch.float32)) * scale
        bscores = bscores.masked_fill(~buf_mask[:, None, None, :], -math.inf)
        score_new = torch.sum(qf * k[:, :, None, :].to(torch.float32),
                              dim=-1) * scale
        all_r = torch.cat([bscores, score_new[..., None]], dim=-1)
        m2 = torch.max(all_r, dim=-1).values                     # [S, K, G]
        p2 = torch.exp(all_r - m2[..., None])
        p2 = torch.where(torch.isneginf(all_r), 0.0, p2)
        l2 = torch.sum(p2, dim=-1)
        acc2 = (torch.einsum("skgc,skcd->skgd", p2[..., :n_buf],
                             vbuf[li].to(torch.float32))
                + p2[..., n_buf:] * v[:, :, None, :].to(torch.float32))

        # flash-decoding merge
        m = torch.maximum(m1, m2)
        a1 = torch.where(torch.isneginf(m1), 0.0, torch.exp(m1 - m))
        a2 = torch.where(torch.isneginf(m2), 0.0, torch.exp(m2 - m))
        denom = torch.clamp(l1 * a1 + l2 * a2, min=1e-30)
        a = (acc1 * a1[..., None] + acc2 * a2[..., None]) / denom[..., None]
        a = a.to(x.dtype).reshape(s, spec.num_heads, spec.head_dim)
        x = _residual(spec, lp, x, _attn_out(spec, lp, a))
        k_all.append(k)
        v_all.append(v)
    x = _norm(spec, params["final_norm"], x)
    return _unembed(spec, params, x), torch.stack(k_all), torch.stack(v_all)


def paged_ring_flush(cache: PagedKVCache, kbuf: torch.Tensor,
                     vbuf: torch.Tensor, chunk_start: torch.Tensor,
                     active: torch.Tensor, max_seq: int,
                     page_size: int) -> PagedKVCache:
    """Scatter a chunk's ring buffers into the page pool through the block
    table, in place: buffer col c of slot s lands at the pool row of
    position chunk_start[s] + c. Inactive slots, positions at or past
    max_seq and unmapped pages are dropped — their block-table rows are
    stale or the sentinel, and an in-bounds write would corrupt pages now
    owned by live requests. Over an int8 pool the full-precision ring is
    quantized here, once per chunk."""
    n_buf = kbuf.shape[3]
    s = kbuf.shape[1]
    pool_rows = cache.k.shape[2]
    bt = cache.block_table
    dev = bt.device
    wpos = (chunk_start.to(torch.int64)[None, :]
            + torch.arange(n_buf, device=dev)[:, None])            # [C, S]
    valid = active.to(torch.bool)[None, :] & (wpos < max_seq)
    page_idx = torch.clamp(wpos // page_size, 0, bt.shape[1] - 1)
    rows = (bt[torch.arange(s, device=dev)[None, :], page_idx].to(torch.int64)
            * page_size + wpos % page_size)                        # [C, S]
    src, dst = _valid_rows(rows, valid, pool_rows)
    # ring [L, S, K, C, D] -> [L, K, C, S, D] -> [L, K, C*S, D]
    L, kh, d = kbuf.shape[0], kbuf.shape[2], kbuf.shape[4]
    kr = kbuf.permute(0, 2, 3, 1, 4).reshape(L, kh, n_buf * s, d)[:, :, src]
    vr = vbuf.permute(0, 2, 3, 1, 4).reshape(L, kh, n_buf * s, d)[:, :, src]
    if cache.quantized:
        kr, ksc = quantize_kv(kr)
        vr, vsc = quantize_kv(vr)
        cache.k_scale[:, :, dst] = ksc
        cache.v_scale[:, :, dst] = vsc
    cache.k[:, :, dst] = kr.to(cache.k.dtype)
    cache.v[:, :, dst] = vr.to(cache.v.dtype)
    return cache


def prefill_paged(
    spec: DecoderSpec,
    params: dict,
    ids: torch.Tensor,        # [N, T] right-padded bucket
    lengths: torch.Tensor,    # [N]
    slots: torch.Tensor,      # [N]
    cache: PagedKVCache,
    page_size: int,
    attn: AttentionOps = KERNELS,
    prefix_embeds: Optional[torch.Tensor] = None,  # [N, T, D] soft prompts
    prefix_len: Optional[torch.Tensor] = None,     # [N] i32 prefix positions
):
    """Bucket prefill whose KV lands in the target slots' pages (in place).

    Attention within the bucket is self-contained (causal over the prompt,
    soft-prompt positions included: `core.prefill_forward`). Returns
    (all-position logits [N, T, V] f32, cache)."""
    n, t = ids.shape
    bt = cache.block_table
    positions = torch.arange(t, device=ids.device)[None, :].expand(n, t)
    key_valid = positions < lengths.to(ids.device)[:, None]

    # pool rows for every (row, position); padded positions are dropped
    pool_rows = cache.k.shape[2]
    page_idx = (positions // page_size).clamp(0, bt.shape[1] - 1).long()
    pages = bt[slots.long()[:, None], page_idx].to(torch.int64)   # [N, T]
    flat = pages * page_size + positions % page_size
    src, dst = _valid_rows(flat, key_valid, pool_rows)

    def write_kv(li, k, v):
        k_rows = k.reshape(-1, spec.num_kv_heads, spec.head_dim)[src]
        v_rows = v.reshape(-1, spec.num_kv_heads, spec.head_dim)[src]
        if cache.quantized:
            # quantize on the way in: [rows, K, D] int8 + [rows, K] scales
            k_rows, ksc = quantize_kv(k_rows)
            v_rows, vsc = quantize_kv(v_rows)
            cache.k_scale[li][:, dst] = ksc.transpose(0, 1)
            cache.v_scale[li][:, dst] = vsc.transpose(0, 1)
        cache.k[li][:, dst] = k_rows.transpose(0, 1).to(cache.k.dtype)
        cache.v[li][:, dst] = v_rows.transpose(0, 1).to(cache.v.dtype)

    return prefill_forward(spec, params, ids, lengths, attn, write_kv,
                           prefix_embeds, prefix_len), cache
