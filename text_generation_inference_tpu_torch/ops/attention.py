"""Attention dispatch: hand-written CUDA kernels vs the plain einsum path
(port of the JAX package's `ops/attention.py`).

`prefill_attention` keeps the JAX package's rule (`ops/attention.py:40`):
the flash kernel runs when there is no bias, the bucket is at least 128
and the head dim is one the kernel is built for (64 or 128, the multiples
of 64 the JAX rule admits that this port compiles); otherwise the einsum
path runs. The einsum path is the JAX package's own rule for those shapes,
not a fallback for a failing kernel.

The paged forward passes take an `AttentionOps` argument: `KERNELS` (the
default, the wrappers of `ops/cuda/`) or `PLAIN` (the plain PyTorch
versions). On CPU tensors the wrappers use their plain versions
themselves; `PLAIN` lets a caller on the card run the same model without
the kernels, to compare the two.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .cuda.flash_prefill import HEAD_DIMS, flash_prefill
from .cuda.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_partial,
    paged_decode_attention_partial_reference,
    paged_decode_attention_reference,
)


def prefill_attention_einsum(q, k, v, lengths, bias, mask, scale: float):
    """q [N, T, K, G, D]; k/v [N, T, K, D]; mask [N, T, T] bool; returns
    [N, T, K, G, D]. Scores and softmax in fp32, probabilities cast to v's
    dtype for the value product (as the JAX package's XLA path)."""
    scores = torch.einsum("nqkgd,nvkd->nkgqv", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if bias is not None:
        scores = scores + bias
    scores = scores.masked_fill(~mask[:, None, None, :, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("nkgqv,nvkd->nqkgd", probs, v)


def prefill_attention(q, k, v, lengths, bias, mask, scale: float):
    """q [N, T, K, G, D]; k/v [N, T, K, D]; returns [N, T, K, G, D].

    `bias`/`mask` drive the einsum path; the kernel derives the causal and
    length mask itself and has no bias."""
    n, t, kh, g, d = q.shape
    if bias is None and t >= 128 and d in HEAD_DIMS:
        return flash_prefill(q.contiguous(), k.contiguous(), v.contiguous(),
                             lengths.to(torch.int32).contiguous())
    return prefill_attention_einsum(q, k, v, lengths, bias, mask, scale)


class AttentionOps(NamedTuple):
    """The attention functions a paged forward pass calls."""

    prefill: Callable          # (q, k, v, lengths, bias, mask, scale)
    paged_decode: Callable     # (q, k_pool, v_pool, block_table, ctx, page)
    paged_decode_partial: Callable  # same args -> (acc, m, l)


KERNELS = AttentionOps(prefill_attention, paged_decode_attention,
                       paged_decode_attention_partial)
PLAIN = AttentionOps(prefill_attention_einsum,
                     paged_decode_attention_reference,
                     paged_decode_attention_partial_reference)
