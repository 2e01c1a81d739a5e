"""Paged-KV inference engine: page-pool capacity instead of slot-length
reservation (port of the JAX package's `engine/paged_engine.py`).

The KV pool is sized from the device memory budget, requests reserve
exactly ceil((input + max_new) / page_size) pages at admission, and the
scheduler's admission question becomes "are there enough free pages".

Programs: as the JAX engine compiles one program per decode key
(want_details, live pages, chunk) and one per prefill key (n, bucket,
want_prompt_details, has_prefix), and `warmup` compiles the decode grid
and the prefill grid, this engine on the card captures one CUDA graph per
key (`engine.programs`; the host side is `engine.SlotBatchEngine`'s) and
each dispatch replays one; a prefill key outside the warm grid is
captured at its first use. The host writes the block table before a
prefill replay reads it. The programs hold the addresses of the pool, the
block table and the state, so `warmup` resets them in place; `reset()`
after a device error rebuilds them and recaptures every program.
`eager_decode=True` runs every program eagerly on the card.

Other differences from the JAX engine, all of them mechanical:
  * Warmup takes out the prefill dispatches past `max_prefill_tokens`
    (the batcher never sends them) and, as the JAX engine, those too large
    for the pool.
  * The pools and the engine state are updated in place on the device
    (the JAX engine donated them to each step).
  * `decode_write_mode` "post" and "scan" both run chunks as a loop of
    single paged steps (each writes the pool), as the JAX engine's
    `_paged_decode_multi` does; "ring" chunks use the ring buffer.
  * Tensor parallelism is one process per rank (`tp`, as the slot
    engine's): the pool holds the rank's kv heads, and its page count is
    the smallest over the group, so that every rank's allocator takes the
    same decisions. Soft prompts are placed before their prompts, and
    pages are reserved for prefix + prompt + max_new + 1.
  * The host bookkeeping is `engine.SlotBatchEngine`'s, shared with the
    slot engine: every call selects the engine's CUDA device first and runs
    on that device's current stream, so device work stays in call order
    whichever thread of the batcher calls.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import ServingConfig
from ..device import resolve_device
from ..models import core, paged_core
from ..models.core import DecoderSpec
from ..ops import linear as linops
from ..parallel.sharding import shard_model
from .engine import (EngineState, PrefillResult, RequestParams,
                     SlotBatchEngine, _finish_prefill, _last_ids,
                     _sample_step, check_decode_config, fused_mlp_option)
from .memory import (MemoryPlan, activation_bytes, budget_bytes,
                     decode_bytes, kv_row_bytes, quant_transient_bytes,
                     tree_bytes)
from .paged_cache import PageAllocator, PagedKVCache

logger = logging.getLogger(__name__)


def _paged_decode_step(spec: DecoderSpec, eos_id: int, page_size: int,
                       params: dict, cache: PagedKVCache, state: EngineState,
                       want_details: bool = True, fuse_mlp: bool = False):
    """One decode step for every slot (decode_chunk == 1): writes the pool
    and the state in place; returns the packed step outputs."""
    params = linops.prepare_params(params, rows=state.history.shape[0],
                                   fuse_mlp=fuse_mlp)
    ids, pos = _last_ids(state)
    logits, cache = paged_core.decode_paged(
        spec, params, ids, pos, cache, pos + 1, page_size,
        active=state.active)
    return _sample_step(logits, state, eos_id, want_details)


def _paged_decode_multi(spec: DecoderSpec, eos_id: int, page_size: int,
                        num_steps: int, params: dict, cache: PagedKVCache,
                        state: EngineState, want_details: bool = True,
                        fuse_mlp: bool = False) -> torch.Tensor:
    """`num_steps` single paged steps back to back (write modes "post" and
    "scan"); returns [num_steps, S, W]."""
    params = linops.prepare_params(params, rows=state.history.shape[0],
                                   fuse_mlp=fuse_mlp)
    return torch.stack([
        _paged_decode_step(spec, eos_id, page_size, params, cache, state,
                           want_details) for _ in range(num_steps)])


def _paged_ring_multi(spec: DecoderSpec, eos_id: int, page_size: int,
                      num_steps: int, params: dict,
                      cache: PagedKVCache, state: EngineState,
                      want_details: bool = True,
                      live_pages: Optional[int] = None,
                      gather_ctx_max: int = 0, fuse_mlp: bool = False):
    """Ring-buffer chunk decode over the paged pool: the pool is read-only
    inside the chunk; ONE block-table scatter per chunk writes it.

    Two attention implementations, picked per live-page bucket:
    dense-gather (bucket <= gather_ctx_max tokens) collects the live pages
    into a dense [L,S,K,R,D] view once per chunk and runs
    `core.decode_ring_step`; bigger buckets run the paged kernel's stats
    mode + flash-decoding merge (`paged_core.decode_paged_ring_step`).
    Returns the packed outputs of every step, [num_steps, S, W]."""
    s, t_max = state.history.shape
    params = linops.prepare_params(params, rows=s, fuse_mlp=fuse_mlp)
    chunk_start = torch.clamp(state.history_len - 1, 0, t_max - 1)
    active0 = state.active.clone()   # constant within a chunk
    # in-chunk ring buffers stay in the model's float dtype over an int8
    # pool; the flush quantizes them once per chunk
    buf_dtype = (params["embed_tokens"].dtype if cache.quantized
                 else cache.k.dtype)
    kbuf = torch.zeros((spec.num_layers, s, spec.num_kv_heads, num_steps,
                        spec.head_dim), dtype=buf_dtype,
                       device=cache.k.device)
    vbuf = torch.zeros_like(kbuf)
    dense = (live_pages is not None
             and live_pages * page_size <= gather_ctx_max)
    dense_cache = (paged_core.gather_dense_view(cache, live_pages, page_size)
                   if dense else None)
    packed = []
    for i in range(num_steps):
        ids, pos = _last_ids(state)
        if dense:
            logits, k_all, v_all = core.decode_ring_step(
                spec, params, ids, pos, dense_cache, kbuf, vbuf, i,
                chunk_start)
        else:
            logits, k_all, v_all = paged_core.decode_paged_ring_step(
                spec, params, ids, pos, cache, kbuf, vbuf, i, chunk_start,
                page_size=page_size, live_pages=live_pages)
        kbuf[:, :, :, i] = k_all.to(kbuf.dtype)
        vbuf[:, :, :, i] = v_all.to(vbuf.dtype)
        packed.append(_sample_step(logits, state, eos_id, want_details))
    paged_core.paged_ring_flush(cache, kbuf, vbuf, chunk_start, active0,
                                t_max, page_size)
    return torch.stack(packed)


def _paged_prefill_step(spec: DecoderSpec, eos_id: int, page_size: int,
                        want_prompt_details: bool,
                        params: dict, cache: PagedKVCache, state: EngineState,
                        ids: torch.Tensor, lengths: torch.Tensor,
                        slots: torch.Tensor, prefix_len: torch.Tensor,
                        prefix_embeds: Optional[torch.Tensor] = None):
    """Prefill a bucket of prompts (after their soft prompts, if any) into
    their slots' pages; installs the slots' state in place. Returns (packed
    first-token outputs, prompt details or None)."""
    logits_all, cache = paged_core.prefill_paged(
        spec, params, ids, lengths, slots, cache, page_size,
        prefix_embeds=prefix_embeds, prefix_len=prefix_len)
    return _finish_prefill(eos_id, want_prompt_details, state, logits_all,
                           ids, lengths, slots, prefix_len)


class PagedInferenceEngine(SlotBatchEngine):
    """Slot batch + paged KV pool; admission is page accounting."""

    def __init__(self, spec: DecoderSpec, params: dict, config: ServingConfig,
                 eos_token_id: int, num_pages: Optional[int] = None,
                 device=None, eager_decode: bool = False, tp=None):
        self.device = resolve_device(device)
        check_decode_config(config)
        self.tp = tp
        if tp is not None:
            spec, params = shard_model(spec, params, tp, self.device)
        if spec.sliding_window is not None \
                and config.max_sequence_length > spec.sliding_window:
            # as the JAX engine: the paged passes take no window mask;
            # within the window the full-attention math is identical, so a
            # max_seq up to the window is exact
            raise ValueError(
                f"sliding-window attention (window={spec.sliding_window}) "
                f"with max_sequence_length={config.max_sequence_length} > "
                "window is only supported on the slot engine "
                "(PAGED_ATTENTION=0)")
        self.spec = spec
        if config.fuse_matmuls:
            from ..models.fuse import fuse_params

            params = fuse_params(spec, params)
        params = linops.prepare_storage(params)
        self.model_params = params
        self.config = config
        self.eos_token_id = eos_token_id
        self.num_slots = config.max_batch_slots
        self.max_seq = config.max_sequence_length
        self.page_size = config.kv_page_size

        self.fuse_mlp = fused_mlp_option()
        self._dtype = params["embed_tokens"].dtype
        self._cache_dtype = (torch.int8 if config.kv_cache_dtype == "int8"
                             else self._dtype)
        # the memory plan, which sizes the pool unless its pages are given
        num_pages = self._plan_pool(self._cache_dtype, num_pages)
        if tp is not None:
            # every rank's page allocator must take the same decisions
            num_pages = tp.min_int(num_pages)
        max_pages_per_slot = -(-self.max_seq // self.page_size)
        self.allocator = PageAllocator(num_pages, self.page_size,
                                       max_pages_per_slot)
        self._use_device()
        self.cache = PagedKVCache.create(
            spec, num_pages, self.page_size, self.num_slots,
            max_pages_per_slot, self._cache_dtype, self.device)
        self.state = EngineState.create(self.num_slots, self.max_seq,
                                        self.device)
        self.decode_chunk = max(1, config.decode_chunk)
        self._write_mode = config.decode_write_mode
        self._init_host(eager_decode)
        # host mirror of the block table; unmapped entries carry the
        # sentinel so overrun writes drop (see PagedKVCache.create)
        self._bt_host = np.full((self.num_slots, max_pages_per_slot),
                                num_pages, np.int32)

        logger.info("paged KV pool: %d pages x %d tokens (%s, %.2f GiB) on %s",
                    num_pages, self.page_size, self._cache_dtype,
                    self.cache.pool_bytes() / 1024 ** 3, self.device)

    def _page_bucket_grid(self) -> list:
        """Distinct live-page values decode may use: powers of two up to
        the per-slot table width (ring chunks only)."""
        mp = self.allocator.max_pages_per_slot
        if self._write_mode != "ring" or self.decode_chunk == 1:
            return [mp]
        grid, b = [], 1
        while b < mp:
            grid.append(b)
            b *= 2
        grid.append(mp)
        return grid

    def _pick_live_pages(self) -> int:
        """Smallest page bucket covering every live slot's pre-chunk
        context (host mirror; freed-slot staleness is read-only safe)."""
        mp = self.allocator.max_pages_per_slot
        if self._write_mode != "ring" or self.decode_chunk == 1:
            return mp
        need = -(-int(self._slot_ctx.max(initial=0)) // self.page_size)
        for b in self._page_bucket_grid():
            if b >= need:
                return b
        return mp

    _bucket_grid = _page_bucket_grid
    _pick_bucket = _pick_live_pages

    def reset(self) -> None:
        """Rebuild pool and state after an EngineDeviceError: all pages and
        slots become free. The programs were captured against the old
        tensors: they are dropped, and recaptured against the new ones
        (`_recapture`), as the JAX engine recompiles."""
        self._use_device()
        had_programs = len(self.programs) > 0
        self.programs.clear()
        num_pages = self.allocator.num_pages
        self.cache = self.state = None    # free the pool before reallocating
        self.cache = PagedKVCache.create(
            self.spec, num_pages, self.page_size, self.num_slots,
            self.allocator.max_pages_per_slot, self._cache_dtype, self.device)
        self.state = EngineState.create(self.num_slots, self.max_seq,
                                        self.device)
        self._clear_slots()
        self._recapture(had_programs)
        logger.warning("paged engine device state reset (all slots cleared)")

    def _clear_slots(self) -> None:
        """Free every page and slot, keeping the device tensors: the block
        table back to the sentinel and the state to `create`'s values, in
        place (the pool's rows are unreachable through the table)."""
        self.allocator = PageAllocator(self.allocator.num_pages,
                                       self.page_size,
                                       self.allocator.max_pages_per_slot)
        self.state.reset_()
        self._reset_host()
        self._bt_host[:] = self.allocator.num_pages
        self.cache.block_table.copy_(torch.from_numpy(self._bt_host))

    def warmup(self, batch_sizes: Optional[tuple[int, ...]] = None) -> None:
        """Make the prefill program of every (batch, bucket) shape of the
        grid (`_warm_prefill_grid`: one eager run, which builds the CUDA
        kernels and warms cuBLAS and the allocator, then the capture and its
        replay; as the JAX engine, a shape whose n full prompts exceed the
        pool warms with the shortest prompts of its bucket, or is skipped),
        free every page and slot in place, then make every decode program
        (live-page bucket x details x chunk: `precompile_decode`) and run
        each once."""
        if batch_sizes is None:
            batch_sizes = self._warmup_batch_grid()
        t0 = time.monotonic()

        def prefill(n, bucket):
            slots = list(range(n))
            prompt_len = min(bucket, self.max_seq - 2)
            pages_full = n * self.allocator.pages_needed(prompt_len + 2)
            if pages_full > self.allocator.num_free:
                smaller = [b for b in self.config.prefill_buckets
                           if b < bucket]
                prompt_len = (smaller[-1] + 1) if smaller else 1
                if n * self.allocator.pages_needed(prompt_len + 2) \
                        > self.allocator.num_free:
                    logger.info("warmup: skipping (n=%d, bucket=%d) — "
                                "exceeds pool", n, bucket)
                    return None
            ids = [[1] * prompt_len] * n
            rps = [RequestParams(max_new_tokens=1)] * n
            result = self.prefill(slots, ids, rps)
            for slot in slots:
                self.free(slot)
            return result

        n_runs = self._warm_prefill_grid(batch_sizes, prefill)
        # the pool is the largest allocation on the card: reset in place
        self._clear_slots()
        n_programs = self._warm_decode()
        logger.info("paged warmup made %d prefill programs and %d decode "
                    "programs in %.1fs", n_runs, n_programs,
                    time.monotonic() - t0)

    def _plan_pool(self, dtype, num_pages: Optional[int] = None) -> int:
        """Set `memory_plan` and return the pool's pages: `num_pages` when
        given, else what the device's memory holds beside everything else
        the plan sets aside (or PAGED_POOL_PAGES)."""
        hbm = budget_bytes(self.device)
        row_b = kv_row_bytes(self.spec, dtype)
        bytes_per_page = self.page_size * row_b
        params_b = tree_bytes(self.model_params)
        act = activation_bytes(self.spec, self.config)
        # dense-gather ring decode materializes a per-chunk KV view of up
        # to paged_gather_ctx_max tokens per slot (k + v): part of the
        # decode programs' working set
        gather_rows = min(self.config.paged_gather_ctx_max, self.max_seq)
        dec = decode_bytes(self.spec, self.config, self._dtype,
                           self.num_slots * gather_rows * row_b)
        spec_b = self._speculative_bytes()
        quant_b = quant_transient_bytes(self.model_params, self.config)
        usable = int(hbm * (1 - self.config.batch_safety_margin)) \
            - params_b - max(act, dec) - spec_b - quant_b
        pages = max(usable // bytes_per_page, self.num_slots * 2)
        # at least enough for one max-length sequence...
        pages = max(pages, -(-self.max_seq // self.page_size))
        # ...and never more than every slot's worst case can consume
        worst_case = self.num_slots * (-(-self.max_seq // self.page_size))
        pages = min(pages, worst_case)
        env = os.getenv("PAGED_POOL_PAGES")
        if num_pages is not None:
            pages = num_pages
        elif env:
            pages = int(env)
        self.memory_plan = MemoryPlan(
            param_bytes=params_b, kv_bytes_per_slot=self.max_seq * row_b,
            state_bytes=self.num_slots * self.max_seq * 4 * 4,
            activation_bytes=act, hbm_bytes=hbm, usable_bytes=max(usable, 0),
            max_slots=self.num_slots, pool_bytes=int(pages) * bytes_per_page,
            speculative_bytes=spec_b, quant_bytes=quant_b, decode_bytes=dec)
        logger.info("memory plan: %s", self.memory_plan.describe())
        return int(pages)

    # -- capacity -----------------------------------------------------------

    def free(self, slot: int) -> None:
        super().free(slot)
        self.allocator.free(slot)
        # stale page ids in the freed row must never be written through again
        self._bt_host[slot] = self.allocator.num_pages

    # -- steps --------------------------------------------------------------

    def prefill(self, slots, token_ids, request_params,
                want_prompt_details: bool = False,
                prefix_embeds=None) -> PrefillResult:
        self._use_device()
        self._apply_pending_frees()
        self._ensure_programs()
        _, prefix_lens = self._prefixes(prefix_embeds, len(slots))
        # allocate pages for the whole potential sequence of each request
        for slot, toks, rp, plen in zip(slots, token_ids, request_params,
                                        prefix_lens):
            pages = self.allocator.allocate(
                slot, plen + len(toks) + rp.max_new_tokens + 1)
            row = np.full((self.allocator.max_pages_per_slot,),
                          self.allocator.num_pages, np.int32)
            row[: len(pages)] = pages
            self._bt_host[slot] = row
            self.set_request_params(slot, rp)
        self.cache.block_table.copy_(torch.from_numpy(self._bt_host))
        return self._run_prefill(slots, token_ids, want_prompt_details,
                                 prefix_embeds)

    def _prefill_device(self, key: tuple, ids, lengths, slots, prefix_len,
                        embeds):
        """The eager prefill step of a key (n, bucket, want_prompt_details,
        has_prefix): its program's function."""
        return _paged_prefill_step(
            self.spec, self.eos_token_id, self.page_size, key[2],
            self.model_params, self.cache, self.state, ids, lengths, slots,
            prefix_len, embeds)

    def _decode_chunk(self, want_details: bool, live_pages: int,
                      chunk: int) -> torch.Tensor:
        """The eager decode step of a program key (want_details, live_pages,
        chunk): returns the packed outputs."""
        if chunk == 1:
            return _paged_decode_step(
                self.spec, self.eos_token_id, self.page_size,
                self.model_params, self.cache, self.state,
                want_details=want_details, fuse_mlp=self.fuse_mlp)
        if self._write_mode != "ring":
            return _paged_decode_multi(
                self.spec, self.eos_token_id, self.page_size, chunk,
                self.model_params, self.cache, self.state,
                want_details=want_details, fuse_mlp=self.fuse_mlp)
        return _paged_ring_multi(
            self.spec, self.eos_token_id, self.page_size, chunk,
            self.model_params, self.cache, self.state,
            want_details=want_details, live_pages=live_pages,
            gather_ctx_max=self.config.paged_gather_ctx_max,
            fuse_mlp=self.fuse_mlp)
