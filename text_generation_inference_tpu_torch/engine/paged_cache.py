"""Paged KV cache: fixed-size pages on the device + host-side allocator
(port of the JAX package's `engine/paged_cache.py`).

The KV pool is [L, K, P * page, D]; each slot owns an ordered list of
pages recorded in a device block table [S, max_pages]. Capacity is tracked
in pages, so admission reserves exactly
ceil((input_len + max_new_tokens) / page_size) pages per request. The
allocator is host-side Python (pages are granted and freed at request
admission and completion, not per token).

The port updates the pools in place (the JAX package donated them to each
jitted step and got new ones back).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.core import DecoderSpec


class PagedKVCache(NamedTuple):
    """k/v pools: [L, K, P * page_size, D], head-major as in the JAX package.

    The model's float dtype, or int8: then the pool is symmetric
    per-row-per-head quantized and k_scale/v_scale are [L, K, P * page_size]
    f32 absmax/127 factors. Quantization happens at the write sites (prefill
    scatter, ring-chunk flush); the read paths fold the scale into the
    score and value products."""

    k: torch.Tensor
    v: torch.Tensor
    block_table: torch.Tensor    # [S, max_pages] i32 page ids
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8

    @classmethod
    def create(cls, spec: DecoderSpec, num_pages: int, page_size: int,
               num_slots: int, max_pages_per_slot: int, dtype,
               device) -> "PagedKVCache":
        shape = (spec.num_layers, spec.num_kv_heads,
                 num_pages * page_size, spec.head_dim)
        # unmapped block-table entries carry the out-of-bounds sentinel
        # `num_pages`, NOT 0: a write routed through an unmapped entry
        # (e.g. a decode chunk overrunning a finished slot's allocation)
        # must be dropped — page 0 is a real allocatable page and writing
        # it would corrupt whichever live request owns it. The paged kernel
        # skips sentinel pages on reads; the plain versions mask them.
        bt = torch.full((num_slots, max_pages_per_slot), num_pages,
                        dtype=torch.int32, device=device)
        scales = {}
        if dtype == torch.int8:
            scales = {name: torch.zeros(shape[:-1], dtype=torch.float32,
                                        device=device)
                      for name in ("k_scale", "v_scale")}
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   block_table=bt, **scales)

    def pool_bytes(self) -> int:
        """Bytes of the k/v pools and their scale pools."""
        return sum(t.numel() * t.element_size()
                   for t in (self.k, self.v, self.k_scale, self.v_scale)
                   if t is not None)


class PageAllocator:
    """Free-list page allocator with per-slot reservations."""

    def __init__(self, num_pages: int, page_size: int, max_pages_per_slot: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_slot = max_pages_per_slot
        self.free_pages: list[int] = list(range(num_pages))
        self.slot_pages: dict[int, list[int]] = {}

    @property
    def num_free(self) -> int:
        return len(self.free_pages)

    def pages_needed(self, total_tokens: int) -> int:
        return -(-total_tokens // self.page_size)

    def can_allocate(self, total_tokens: int) -> bool:
        n = self.pages_needed(total_tokens)
        return n <= len(self.free_pages) and n <= self.max_pages_per_slot

    def allocate(self, slot: int, total_tokens: int) -> list[int]:
        n = self.pages_needed(total_tokens)
        if n > len(self.free_pages):
            raise RuntimeError(
                f"out of KV pages: need {n}, free {len(self.free_pages)}")
        if n > self.max_pages_per_slot:
            raise RuntimeError(
                f"request needs {n} pages > max_pages_per_slot "
                f"{self.max_pages_per_slot}")
        pages = [self.free_pages.pop() for _ in range(n)]
        self.slot_pages[slot] = pages
        return pages

    def free(self, slot: int) -> None:
        pages = self.slot_pages.pop(slot, [])
        self.free_pages.extend(pages)

    def row_indices(self, pages: list[int], length: int) -> np.ndarray:
        """Flat pool-row index for each token position 0..length-1."""
        pos = np.arange(length)
        page_idx = pos // self.page_size
        return (np.asarray(pages, np.int64)[page_idx] * self.page_size
                + pos % self.page_size).astype(np.int32)
