"""Paged-KV inference engine: page-pool capacity instead of slot-length
reservation (port of the JAX package's `engine/paged_engine.py`).

The KV pool is sized from the device memory budget, requests reserve
exactly ceil((input + max_new) / page_size) pages at admission, and the
scheduler's admission question becomes "are there enough free pages".

Differences from the JAX engine, all of them mechanical:
  * PyTorch runs eagerly, so there is no jit and no AOT
    `precompile_decode`; `warmup` runs each prefill and decode shape once
    (which also builds the CUDA kernels).
  * The pools and the engine state are updated in place on the device
    (the JAX engine donated them to each step).
  * `decode_write_mode` "post" / "scan", int8 KV, meshes, and soft-prompt
    prefixes are later slices and raise NotImplementedError.
  * The batcher calls the engine from its event-loop thread and from
    executor threads; every call selects the engine's CUDA device first and
    all of them run on that device's current (default) stream, so device
    work stays in call order.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..config import ServingConfig
from ..device import resolve_device
from ..models import core, paged_core
from ..models.core import DecoderSpec, check_supported
from ..ops import linear as linops
from . import sampling
from .engine import (EngineDeviceError, EngineState, PrefillResult,
                     RequestParams, StepResult)
from .memory import device_hbm_bytes, tree_bytes
from .paged_cache import PageAllocator, PagedKVCache

logger = logging.getLogger(__name__)

# memory budget assumed for a pool on the CPU (tests): the figure the JAX
# package assumes when its backend reports no device memory
CPU_POOL_BUDGET_BYTES = 16 * 1024 ** 3


def _advance(state: EngineState, next_ids: torch.Tensor) -> None:
    """Append each active slot's new token to its history, in place."""
    s, t_max = state.history.shape
    rows = torch.arange(s, device=next_ids.device)
    active = state.active
    write_pos = torch.clamp(state.history_len, 0, t_max - 1).long()
    state.history[rows, write_pos] = torch.where(
        active, next_ids, state.history[rows, write_pos])
    state.history_len.add_(active.to(torch.int32))
    state.gen_count.add_(active.to(torch.int32))


def _last_ids(state: EngineState):
    s, t_max = state.history.shape
    rows = torch.arange(s, device=state.history.device)
    pos = torch.clamp(state.history_len - 1, 0, t_max - 1)
    return state.history[rows, pos.long()], pos


def _paged_decode_step(spec: DecoderSpec, eos_id: int, page_size: int,
                       params: dict, cache: PagedKVCache, state: EngineState,
                       want_details: bool = True):
    """One decode step for every slot (decode_chunk == 1): writes the pool
    and the state in place; returns the packed step outputs."""
    params = linops.prepare_params(params, rows=state.history.shape[0])
    ids, pos = _last_ids(state)
    logits, cache = paged_core.decode_paged(
        spec, params, ids, pos, cache, pos + 1, page_size,
        active=state.active)
    next_ids, details = sampling.next_tokens(
        logits, state.params, state.gen_count, state.history,
        state.history_len, eos_id, history_start=state.hist_start,
        want_details=want_details)
    _advance(state, next_ids)
    return sampling.pack_step_outputs(next_ids, details)


def _paged_ring_multi(spec: DecoderSpec, eos_id: int, page_size: int,
                      num_steps: int, params: dict,
                      cache: PagedKVCache, state: EngineState,
                      want_details: bool = True,
                      live_pages: Optional[int] = None,
                      gather_ctx_max: int = 0):
    """Ring-buffer chunk decode over the paged pool: the pool is read-only
    inside the chunk; ONE block-table scatter per chunk writes it.

    Two attention implementations, picked per live-page bucket:
    dense-gather (bucket <= gather_ctx_max tokens) collects the live pages
    into a dense [L,S,K,R,D] view once per chunk and runs
    `core.decode_ring_step`; bigger buckets run the paged kernel's stats
    mode + flash-decoding merge (`paged_core.decode_paged_ring_step`).
    Returns the packed outputs of every step, [num_steps, S, W]."""
    s, t_max = state.history.shape
    params = linops.prepare_params(params, rows=s)
    chunk_start = torch.clamp(state.history_len - 1, 0, t_max - 1)
    active0 = state.active.clone()   # constant within a chunk
    kbuf = torch.zeros((spec.num_layers, s, spec.num_kv_heads, num_steps,
                        spec.head_dim), dtype=cache.k.dtype,
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
        next_ids, details = sampling.next_tokens(
            logits, state.params, state.gen_count, state.history,
            state.history_len, eos_id, history_start=state.hist_start,
            want_details=want_details)
        _advance(state, next_ids)
        packed.append(sampling.pack_step_outputs(next_ids, details))
    paged_core.paged_ring_flush(cache, kbuf, vbuf, chunk_start, active0,
                                t_max, page_size)
    return torch.stack(packed)


def _paged_prefill_step(spec: DecoderSpec, eos_id: int, page_size: int,
                        want_prompt_details: bool,
                        params: dict, cache: PagedKVCache, state: EngineState,
                        ids: torch.Tensor, lengths: torch.Tensor,
                        slots: torch.Tensor, prefix_len: torch.Tensor):
    """Prefill a bucket of prompts into their slots' pages; installs the
    slots' state in place. Returns (packed first-token outputs, prompt
    details or None)."""
    n, b = ids.shape
    t_max = state.history.shape[1]
    logits_all, cache = paged_core.prefill_paged(
        spec, params, ids, lengths, slots, cache, page_size)
    rows = torch.arange(n, device=ids.device)
    last_logits = logits_all[rows, (lengths - 1).long()]

    slots_l = slots.long()
    req_params = state.params.gather(slots_l)
    next_ids, details = sampling.next_tokens(
        last_logits, req_params, torch.zeros_like(lengths), ids, lengths,
        eos_id, history_start=prefix_len)

    cols = min(b, t_max)
    state.history[slots_l[:, None],
                  torch.arange(cols, device=ids.device)[None, :]] = ids[:, :cols]
    state.history[slots_l, torch.clamp(lengths, 0, t_max - 1).long()] = next_ids
    state.history_len[slots_l] = lengths + 1
    state.hist_start[slots_l] = prefix_len
    state.input_len[slots_l] = lengths
    state.gen_count[slots_l] = 1
    state.active[slots_l] = True
    pdet = (sampling.prompt_token_details(logits_all[:, :b - 1], ids)
            if want_prompt_details else None)
    return sampling.pack_step_outputs(next_ids, details), pdet


class PagedInferenceEngine:
    """Slot batch + paged KV pool; admission is page accounting."""

    # the batcher may dispatch chunk N+1 before fetching chunk N
    supports_decode_pipeline = True
    # the batcher may ask for a smaller chunk while a request streams
    supports_chunk_override = True

    def __init__(self, spec: DecoderSpec, params: dict, config: ServingConfig,
                 eos_token_id: int, num_pages: Optional[int] = None,
                 device=None):
        self.device = resolve_device(device)
        check_supported(spec)
        if config.kv_cache_dtype == "int8":
            raise NotImplementedError("int8 KV is not ported yet")
        if config.decode_write_mode != "ring":
            raise NotImplementedError(
                f"decode_write_mode={config.decode_write_mode!r} is not "
                "ported (ring only)")
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

        self._dtype = params["embed_tokens"].dtype
        if num_pages is None:
            num_pages = self._pool_size_from_hbm(self._dtype)
        max_pages_per_slot = -(-self.max_seq // self.page_size)
        self.allocator = PageAllocator(num_pages, self.page_size,
                                       max_pages_per_slot)
        self._use_device()
        self.cache = PagedKVCache.create(
            spec, num_pages, self.page_size, self.num_slots,
            max_pages_per_slot, self._dtype, self.device)
        self.state = EngineState.create(self.num_slots, self.max_seq,
                                        self.device)
        self.free_slots: list[int] = list(range(self.num_slots))
        # free() runs on the event-loop thread while decode runs on the
        # executor thread (pipelined decode) — guard the pending list
        self._free_lock = threading.Lock()
        self._pending_frees: list[int] = []
        # host mirror of the block table; unmapped entries carry the
        # sentinel so overrun writes drop (see PagedKVCache.create)
        self._bt_host = np.full((self.num_slots, max_pages_per_slot),
                                num_pages, np.int32)
        # host mirror of history_len (0 = free) for the live-page bucket
        # pick; mutated only on the engine-call thread
        self._slot_ctx = np.zeros(self.num_slots, np.int32)
        self._warmup_pages = None

        logger.info("paged KV pool: %d pages x %d tokens (%.2f GiB) on %s",
                    num_pages, self.page_size,
                    2 * tree_bytes(self.cache.k) / 1024 ** 3, self.device)

        self.decode_chunk = max(1, config.decode_chunk)
        self.last_forward_ns = 0
        self.last_n_emitted = None

    def _use_device(self) -> None:
        """Make the engine's CUDA device current on the calling thread (the
        batcher calls in from several threads)."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def _page_bucket_grid(self) -> list:
        """Distinct live-page values decode may use: powers of two up to
        the per-slot table width (chunks > 1 only)."""
        mp = self.allocator.max_pages_per_slot
        if self.decode_chunk == 1:
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
        if self._warmup_pages is not None:
            return self._warmup_pages
        mp = self.allocator.max_pages_per_slot
        if self.decode_chunk == 1:
            return mp
        need = -(-int(self._slot_ctx.max(initial=0)) // self.page_size)
        for b in self._page_bucket_grid():
            if b >= need:
                return b
        return mp

    def _chunk_grid(self) -> tuple:
        """Throughput chunk + optional small streaming chunk."""
        chunks = {self.decode_chunk}
        sc = self.config.stream_decode_chunk
        if sc and 1 <= sc < self.decode_chunk:
            chunks.add(sc)
        return tuple(sorted(chunks))

    def reset(self) -> None:
        """Rebuild pool and state after an EngineDeviceError: all pages and
        slots become free."""
        self._use_device()
        self.cache = PagedKVCache.create(
            self.spec, self.allocator.num_pages, self.page_size,
            self.num_slots, self.allocator.max_pages_per_slot, self._dtype,
            self.device)
        self.allocator = PageAllocator(self.allocator.num_pages,
                                       self.page_size,
                                       self.allocator.max_pages_per_slot)
        self.state = EngineState.create(self.num_slots, self.max_seq,
                                        self.device)
        self.free_slots = list(range(self.num_slots))
        with self._free_lock:
            self._pending_frees.clear()
        self._bt_host[:] = self.allocator.num_pages
        self._slot_ctx[:] = 0
        logger.warning("paged engine device state reset (all slots cleared)")

    def _warmup_batch_grid(self) -> tuple[int, ...]:
        cap = min(self.num_slots, self.config.max_prefill_batch)
        grid, n = [], 1
        while n <= cap:
            grid.append(n)
            n *= 2
        return tuple(grid)

    def warmup(self, batch_sizes: Optional[tuple[int, ...]] = None) -> None:
        """Run every prefill (batch, bucket) shape and every decode variant
        once, then reset. Eager PyTorch compiles nothing per shape, but the
        first call builds the CUDA kernels and warms cuBLAS and the
        allocator, which should not land on the first request."""
        if batch_sizes is None:
            batch_sizes = self._warmup_batch_grid()
        t0 = time.monotonic()
        n_runs = 0
        for bucket in self.config.prefill_buckets:
            if bucket > self.max_seq:
                continue
            for n in batch_sizes:
                if n > self.num_slots:
                    continue
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
                        continue
                ids = [[1] * prompt_len] * n
                rps = [RequestParams(max_new_tokens=1)] * n
                self.prefill(slots, ids, rps)
                n_runs += 1
                for slot in slots:
                    self.free(slot)
        try:
            for pages in self._page_bucket_grid():
                self._warmup_pages = pages
                for want_details in (False, True):
                    for chunk in self._chunk_grid():
                        self.decode_steps(want_details=want_details,
                                          chunk=chunk)
                        n_runs += 1
        finally:
            self._warmup_pages = None
        self.reset()
        logger.info("paged warmup ran %d shapes in %.1fs", n_runs,
                    time.monotonic() - t0)

    def _pool_size_from_hbm(self, dtype) -> int:
        hbm = (device_hbm_bytes(self.device) if self.device.type == "cuda"
               else CPU_POOL_BUDGET_BYTES)
        itemsize = torch.empty((), dtype=dtype).element_size()
        bytes_per_page = (self.spec.num_layers * 2 * self.page_size
                          * self.spec.num_kv_heads * self.spec.head_dim
                          * itemsize)
        params_b = tree_bytes(self.model_params)
        bucket = self.config.prefill_buckets[-1]
        act = bucket * (self.spec.hidden_size * 6
                        + self.spec.intermediate_size * 3) * 4
        act += bucket * self.spec.vocab_size * 4
        # dense-gather ring decode materializes a per-chunk KV view of up
        # to paged_gather_ctx_max tokens per slot (k + v) — reserve it
        gather_rows = min(self.config.paged_gather_ctx_max, self.max_seq)
        gather_b = (self.spec.num_layers * 2 * self.num_slots * gather_rows
                    * self.spec.num_kv_heads * self.spec.head_dim * itemsize)
        usable = int(hbm * (1 - self.config.batch_safety_margin)) \
            - params_b - act - gather_b
        pages = max(usable // bytes_per_page, self.num_slots * 2)
        # at least enough for one max-length sequence...
        pages = max(pages, -(-self.max_seq // self.page_size))
        # ...and never more than every slot's worst case can consume
        worst_case = self.num_slots * (-(-self.max_seq // self.page_size))
        pages = min(pages, worst_case)
        env = os.getenv("PAGED_POOL_PAGES")
        if env:
            pages = int(env)
        return int(pages)

    # -- capacity -----------------------------------------------------------

    def acquire_slot(self) -> Optional[int]:
        return self.free_slots.pop() if self.free_slots else None

    def free(self, slot: int) -> None:
        with self._free_lock:
            self._pending_frees.append(slot)
        self.free_slots.append(slot)
        self.allocator.free(slot)
        # stale page ids in the freed row must never be written through again
        self._bt_host[slot] = self.allocator.num_pages

    def _apply_pending_frees(self) -> None:
        with self._free_lock:
            pending, self._pending_frees = self._pending_frees, []
        if pending:
            self._slot_ctx[np.asarray(pending)] = 0
            idx = torch.as_tensor(pending, dtype=torch.long,
                                  device=self.device)
            self.state.active[idx] = False

    # -- steps --------------------------------------------------------------

    def set_request_params(self, slot: int, rp: RequestParams) -> None:
        self.state.params.write_slot(
            slot, temperature=rp.temperature, top_k=rp.top_k,
            top_p=rp.top_p, typical_p=rp.typical_p,
            repetition_penalty=rp.repetition_penalty,
            lp_start=rp.lp_start, lp_decay=rp.lp_decay,
            min_new_tokens=rp.min_new_tokens, seed=rp.seed)

    def prefill(self, slots, token_ids, request_params,
                want_prompt_details: bool = False,
                prefix_embeds=None) -> PrefillResult:
        if prefix_embeds is not None and any(p is not None
                                             for p in prefix_embeds):
            raise NotImplementedError("prompt-prefix injection is not ported "
                                      "yet")
        n = len(slots)
        self._use_device()
        self._apply_pending_frees()
        total_lens = [len(t) for t in token_ids]
        # allocate pages for the whole potential sequence of each request
        for slot, total, rp in zip(slots, total_lens, request_params):
            pages = self.allocator.allocate(
                slot, total + rp.max_new_tokens + 1)
            row = np.full((self.allocator.max_pages_per_slot,),
                          self.allocator.num_pages, np.int32)
            row[: len(pages)] = pages
            self._bt_host[slot] = row
            self.set_request_params(slot, rp)
        self.cache.block_table.copy_(torch.from_numpy(self._bt_host))

        bucket = self.config.bucket_for(max(total_lens))
        ids = np.zeros((n, bucket), np.int32)
        lengths = np.asarray(total_lens, np.int32)
        for i, toks in enumerate(token_ids):
            ids[i, : len(toks)] = toks

        def dev(a):
            return torch.as_tensor(a, dtype=torch.int32, device=self.device)

        t0 = time.monotonic_ns()
        try:
            packed, pdet = _paged_prefill_step(
                self.spec, self.eos_token_id, self.page_size,
                want_prompt_details, self.model_params, self.cache,
                self.state, dev(ids), dev(lengths), dev(slots),
                dev(np.zeros(n, np.int32)))
            packed = packed.cpu().numpy()
            if pdet is not None:
                pdet = sampling.PromptDetails(
                    *(t.cpu().numpy() for t in pdet))
        except Exception as e:
            raise EngineDeviceError(f"paged prefill failed: {e}") from e
        self._slot_ctx[np.asarray(slots)] = lengths + 1
        step = StepResult(*sampling.unpack_step_outputs(packed))
        self.last_forward_ns = time.monotonic_ns() - t0

        prompt_details = None
        if want_prompt_details:
            prompt_details = []
            for i in range(n):
                e0 = total_lens[i]
                lp = pdet.logprob[i, :e0].copy()
                rk = pdet.rank[i, :e0].copy()
                # the first prompt token never reports a prediction
                # (reference: tokens.py:441-449)
                lp[0] = np.nan
                rk[0] = 0
                prompt_details.append({
                    "logprob": lp,
                    "rank": rk,
                    "top_ids": pdet.top_ids[i, :e0],
                    "top_logprobs": pdet.top_logprobs[i, :e0],
                    "top_scores": pdet.top_scores[i, :e0],
                })
        return PrefillResult(first_token=step, prompt_details=prompt_details)

    def decode(self) -> StepResult:
        return self.decode_steps()[0]

    def decode_steps_begin(self, want_details: bool = True, chunk=None):
        """Enqueue one decode chunk on the device without fetching its
        outputs (two-phase pipelining contract: callers overlap chunk N+1's
        device work with chunk N's host fetch). `chunk` overrides this
        dispatch's step count (stream-aware chunking)."""
        chunk = self.decode_chunk if chunk is None else max(1, chunk)
        self.last_n_emitted = None
        self._use_device()
        self._apply_pending_frees()
        live_pages = self._pick_live_pages()
        t0 = time.monotonic_ns()
        try:
            if chunk == 1:
                packed = _paged_decode_step(
                    self.spec, self.eos_token_id, self.page_size,
                    self.model_params, self.cache, self.state,
                    want_details=want_details)
            else:
                packed = _paged_ring_multi(
                    self.spec, self.eos_token_id, self.page_size, chunk,
                    self.model_params, self.cache, self.state,
                    want_details=want_details, live_pages=live_pages,
                    gather_ctx_max=self.config.paged_gather_ctx_max)
        except Exception as e:
            raise EngineDeviceError(f"paged decode dispatch failed: {e}") from e
        np.minimum(np.where(self._slot_ctx > 0,
                            self._slot_ctx + chunk, 0),
                   self.max_seq, out=self._slot_ctx)
        return (packed, chunk, t0)

    def decode_steps_end(self, handle) -> list[StepResult]:
        packed, chunk, t0 = handle
        try:
            packed = packed.cpu().numpy()
        except Exception as e:
            raise EngineDeviceError(f"paged decode failed: {e}") from e
        if chunk == 1:
            results = [StepResult(*sampling.unpack_step_outputs(packed))]
        else:
            results = [StepResult(*sampling.unpack_step_outputs(packed[i]))
                       for i in range(chunk)]
        self.last_forward_ns = time.monotonic_ns() - t0
        return results

    def decode_steps(self, want_details: bool = True,
                     chunk=None) -> list[StepResult]:
        return self.decode_steps_end(
            self.decode_steps_begin(want_details, chunk=chunk))
