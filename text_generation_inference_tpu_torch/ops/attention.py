"""Attention dispatch: hand-written CUDA kernels vs the plain path (port of
the JAX package's `ops/attention.py`).

Each route of `KERNELS` keeps the JAX package's rule, decided from shapes
alone before any launch:

- `prefill_attention` (`ops/attention.py:40`): the flash kernel when the
  bucket is at least 128 and the head dim is a multiple of 64; otherwise
  the einsum path, the JAX rule's own route for those shapes.
- `decode_attention`, the slot engine's "scan" write mode
  (`ops/attention.py:67`): the slot-cache kernel (S1) when the cache holds
  at least 2048 rows and the head dim is a multiple of 64; otherwise the
  einsum path.
- the paged routes: the paged kernel at every shape, as the JAX paged
  forward passes call it (`models/paged_core.py:152,174-183`).

ALiBi reaches the kernels the rule takes. The JAX rule sends every ALiBi
call to its plain paths: a bias sends prefill and slot decode to the einsum
(`ops/attention.py:38,67`) and `spec.pos != "alibi"` sends paged decode to
the paged kernel's plain twin (`models/paged_core.py:152,276`). Here the
forward passes hand each route the slopes, a [K, G] f32 tensor (query head
k * G + g; None without ALiBi); the kernels add slope * j to the scaled
score of key position j (flash prefill: slope * (j - i) for query row i,
the same softmax), and the einsum paths add the JAX package's dense bias,
slope * j (`alibi_bias`). Which keys are visible does not change. This
differs from the JAX rule by design: its plain paths would write the
[N, K, G, T, T] f32 scores to device memory or gather every live page
each step.

A sliding window reaches the kernels the rule takes: flash prefill takes
`window` (0 is none) and masks key j for a real query row i unless
i - window < j <= i; S1 takes the lower bounds `lo` = max(ctx - window, 0),
which the decode step computes once for every layer, and reads only the
rows in [lo, ctx).
The JAX dispatch hands neither kernel the window (`ops/attention.py:40,67`),
so on a TPU a windowed model attends past its window there; the port
follows the JAX einsum path, which applies it. The einsum paths take the
window through `mask`, which the forward passes build.

Where the rule takes a kernel, the port calls the kernel's wrapper: on a
CUDA tensor it launches the kernel, which is built for bf16 and fp16, every
head dim the port's models use and any group (`HEAD_DIMS` and `DTYPES` of
each wrapper's module), and raises for anything else; it never gives way to
its plain version on the card.

The forward passes take an `AttentionOps` argument: `KERNELS` (the
default) or `PLAIN` (the plain PyTorch versions). Its `int4_plain` flag is
the same switch for the GPTQ-INT4 product (`ops/linear.py`): the per-layer
weight views of a forward pass carry it to `linear.matmul`. On CPU tensors
the wrappers use their plain versions themselves; `PLAIN` lets a caller on
the card run the same model without the kernels, to compare the two.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .cuda import decode_attention as slot_decode
from .cuda import flash_prefill as fp
from .cuda import paged_attention as pa
from .cuda.ring_decode_attention import (
    ring_decode_attention,
    ring_decode_attention_reference,
)

# the JAX package's threshold for the slot-cache kernel, kept as its rule;
# whether the card wants another one is for a measured change to decide
SLOT_KERNEL_MIN_ROWS = 2048


def alibi_bias(slopes: torch.Tensor, key_pos: torch.Tensor) -> torch.Tensor:
    """The JAX package's dense ALiBi bias: slopes [K, G] times the key
    positions [..., T] (as f32) gives [..., K, G, T]."""
    return slopes[..., None] * key_pos.to(torch.float32)[..., None, None, :]


def prefill_attention_einsum(q, k, v, lengths, slopes, mask, scale: float,
                             window: int = 0):
    """q [N, T, K, G, D]; k/v [N, T, K, D]; mask [N, T, T] bool (the
    window, if any, already in it); slopes [K, G] f32 or None; returns
    [N, T, K, G, D]. Scores and softmax in fp32 with the JAX package's
    ALiBi bias slope * j, probabilities cast to v's dtype for the value
    product (as the JAX package's XLA path)."""
    scores = torch.einsum("nqkgd,nvkd->nkgqv", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if slopes is not None:
        pos = torch.arange(q.shape[1], device=q.device)
        scores = scores + alibi_bias(slopes, pos)[None, :, :, None, :]
    scores = scores.masked_fill(~mask[:, None, None, :, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("nkgqv,nvkd->nqkgd", probs, v)


def prefill_attention(q, k, v, lengths, slopes, mask, scale: float,
                      window: int = 0):
    """q [N, T, K, G, D]; k/v [N, T, K, D]; returns [N, T, K, G, D].

    `mask` drives the einsum path; the kernel derives the causal, length
    and window mask itself. `slopes` ([K, G] f32, or None) reach both."""
    n, t, kh, g, d = q.shape
    if t >= 128 and d % 64 == 0:                        # the JAX rule
        return fp.flash_prefill(q.contiguous(), k.contiguous(),
                                v.contiguous(),
                                lengths.to(torch.int32).contiguous(),
                                window=window, slopes=slopes)
    return prefill_attention_einsum(q, k, v, lengths, slopes, mask, scale)


def decode_attention_einsum(q, k_cache, v_cache, context_len, slopes, mask,
                            scale: float, lo=None):
    """q [S, K, G, D]; caches [S, K, T, D]; mask [S, T] bool (the window,
    if any, already in it, so `lo` is not read); slopes [K, G] f32 or None;
    returns [S, K, G, D]. Scores and softmax in fp32 with the JAX package's
    ALiBi bias slope * j, probabilities cast to the cache's dtype for the
    value product (as the JAX package's XLA path)."""
    scores = torch.einsum("skgd,sktd->skgt", q.to(torch.float32),
                          k_cache.to(torch.float32)) * scale
    if slopes is not None:
        pos = torch.arange(k_cache.shape[2], device=q.device)
        scores = scores + alibi_bias(slopes, pos)[None]
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    return torch.einsum("skgt,sktd->skgd", probs, v_cache)


def decode_attention(q, k_cache, v_cache, context_len, slopes, mask,
                     scale: float, lo=None):
    """q [S, K, G, D]; caches [S, K, T, D] (one layer of the slot cache);
    returns [S, K, G, D]. `mask` drives the einsum path; the kernel reads
    the rows in [lo, context_len) itself (`lo`, a contiguous int32 [S]
    tensor, is max(context_len - window, 0) under a sliding window; None
    reads from row 0). `slopes` ([K, G] f32, or None) reach both."""
    d = q.shape[-1]
    if k_cache.shape[2] >= SLOT_KERNEL_MIN_ROWS and d % 64 == 0:  # JAX rule
        return slot_decode.decode_attention(
            q.contiguous(), k_cache, v_cache,
            context_len.to(torch.int32).contiguous(), lo, slopes=slopes)
    return decode_attention_einsum(q, k_cache, v_cache, context_len, slopes,
                                   mask, scale)


def _partial_i8_reference(q, k_pool, v_pool, k_scale_pool, v_scale_pool,
                          block_table, ctx, page_size, alibi_slopes_kg=None):
    return pa.paged_decode_attention_partial_reference(
        q, k_pool, v_pool, block_table, ctx, page_size,
        alibi_slopes_kg=alibi_slopes_kg, k_scale_pool=k_scale_pool,
        v_scale_pool=v_scale_pool)


class AttentionOps(NamedTuple):
    """The kernel functions a forward pass calls."""

    prefill: Callable          # (q, k, v, lengths, slopes, mask, scale, window)
    # slot cache, "scan" write mode: (q, k_cache, v_cache, ctx, slopes,
    # mask, scale, lo)
    slot_decode: Callable
    # the ring scheme's three sources in one softmax: (q, k_cache, v_cache,
    # kbuf, vbuf, k_new, v_new, ctx, step_idx); no ALiBi
    ring_decode: Callable
    # (q, k_pool, v_pool, block_table, ctx, page, alibi_slopes_kg=None)
    paged_decode: Callable
    paged_decode_partial: Callable  # same args -> (acc, m, l)
    # int8 pools: (q, k_pool, v_pool, k_scale_pool, v_scale_pool,
    # block_table, ctx, page, alibi_slopes_kg=None) -> (acc, m, l)
    paged_decode_partial_i8: Callable
    int4_plain: bool           # GPTQ-INT4 products by their plain version


KERNELS = AttentionOps(prefill_attention, decode_attention,
                       ring_decode_attention, pa.paged_decode_attention,
                       pa.paged_decode_attention_partial,
                       pa.paged_decode_attention_partial_i8, False)
PLAIN = AttentionOps(prefill_attention_einsum, decode_attention_einsum,
                     ring_decode_attention_reference,
                     pa.paged_decode_attention_reference,
                     pa.paged_decode_attention_partial_reference,
                     _partial_i8_reference, True)
