"""Slot-batch inference engine (port of the JAX package's
`engine/engine.py`): host-facing types, the host bookkeeping that the slot
and the paged engine share, and `InferenceEngine`, the slot engine
(`PAGED_ATTENTION=0`) over a `[L, S, K, max_seq, D]` KV cache:

  * `prefill(slots, ids, params)` pads the prompts to a length bucket, runs
    the causal forward (writing each slot's KV), samples the first token and
    installs the request's sampling parameters;
  * `decode_steps()` runs one decode chunk over every slot, in the
    configured write mode: "ring" (a per-chunk ring buffer, one cache write
    per chunk; the default), "post" (one write per step after the layer
    loop) or "scan" (a write in each layer, then the slot-cache attention
    dispatch, whose kernel runs at max_seq >= 2048); a chunk of 1 step runs
    "post" for "ring", as in the JAX package;
  * `free(slot)` is host bookkeeping; the device-side mask update is
    applied at the start of the next engine call.

Differences from the JAX engine, all of them mechanical: PyTorch runs
eagerly, so there is no jit, no AOT `precompile_decode`, and `warmup` runs
each prefill and decode shape once (which also builds the CUDA kernels);
the cache and the state are updated in place on the device (the JAX engine
donated them to each step); meshes are a later slice. Every call selects
the engine's CUDA device first and runs on its current stream, so device
work stays in call order whichever thread of the batcher calls.

Both engines take soft prompts (prompt tuning: `prefix_embeds` of
`prefill`, a `utils.prompt_cache.PrefixEntry` or a [P, D] array per
request), and both read `INT4_FUSED_MLP` once, when they are built: with
it, the decode steps run a GPTQ-INT4 model's MLP as one kernel
(`ops.linear.prepare_params`).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import ServingConfig
from ..device import resolve_device
from ..models import core
from ..models.core import DecoderSpec, KVCache, check_supported
from ..ops import linear as linops
from . import sampling
from .memory import budget_bytes, plan_memory
from .sampling import SlotSamplingParams

logger = logging.getLogger(__name__)


class EngineDeviceError(RuntimeError):
    """A device step failed: cache/state contents are undefined and the
    engine must be `reset()` before further use. The scheduler uses this to
    scope failure handling — host-side errors keep device state intact and
    fail only the affected requests (reference: batcher.rs:725-737 scopes
    failures to the affected batch segment)."""


class EngineState(NamedTuple):
    """Per-slot device state (all leading dims = num_slots)."""

    history: torch.Tensor      # [S, T] i32: prompt + generated token ids
    history_len: torch.Tensor  # [S] i32: valid ids in history
    hist_start: torch.Tensor   # [S] i32: first real token (after soft prompt)
    input_len: torch.Tensor    # [S] i32: prompt length (incl. prefix positions)
    gen_count: torch.Tensor    # [S] i32: generated tokens so far
    active: torch.Tensor       # [S] bool
    params: SlotSamplingParams

    @classmethod
    def create(cls, num_slots: int, max_seq: int,
               device: torch.device) -> "EngineState":
        def full(value, dtype, shape=(num_slots,)):
            return torch.full(shape, value, dtype=dtype, device=device)

        return cls(
            history=full(0, torch.int32, (num_slots, max_seq)),
            history_len=full(1, torch.int32),
            hist_start=full(0, torch.int32),
            input_len=full(1, torch.int32),
            gen_count=full(0, torch.int32),
            active=full(False, torch.bool),
            params=SlotSamplingParams.empty(num_slots, device),
        )


@dataclasses.dataclass
class RequestParams:
    """Per-request decoding parameters, validated upstream."""

    temperature: float = 0.0        # 0 => greedy
    top_k: int = 0
    top_p: float = 1.0
    typical_p: float = 1.0
    seed: int = 0
    repetition_penalty: float = 1.0
    lp_start: int = 0
    lp_decay: float = 0.0
    min_new_tokens: int = 0
    max_new_tokens: int = 20


class StepResult(NamedTuple):
    """Host-side view of one engine step for a set of rows."""

    next_ids: np.ndarray       # [N]
    logprob: np.ndarray        # [N]
    rank: np.ndarray           # [N]
    top_ids: np.ndarray        # [N, TOP_N_CAP]
    top_logprobs: np.ndarray   # [N, TOP_N_CAP]
    top_scores: np.ndarray     # [N, TOP_N_CAP]


class PrefillResult(NamedTuple):
    first_token: StepResult                    # rows == the prefilled seqs
    prompt_details: Optional[list[dict]]       # per seq, when requested


def fused_mlp_option() -> bool:
    """The JAX package's INT4_FUSED_MLP switch (default off)."""
    return os.getenv("INT4_FUSED_MLP", "0").lower() not in ("0", "false")


# ---------------------------------------------------------------------------
# step functions (shared by both engines' steps)
# ---------------------------------------------------------------------------


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
    """Each slot's last token and its position (clipped to max_seq - 1: an
    inactive slot recomputes into its own last row, harmlessly)."""
    s, t_max = state.history.shape
    rows = torch.arange(s, device=state.history.device)
    pos = torch.clamp(state.history_len - 1, 0, t_max - 1)
    return state.history[rows, pos.long()], pos


def _sample_step(logits, state: EngineState, eos_id: int,
                 want_details: bool) -> torch.Tensor:
    """Choose every slot's next token, advance the state, return the packed
    step outputs."""
    next_ids, details = sampling.next_tokens(
        logits, state.params, state.gen_count, state.history,
        state.history_len, eos_id, history_start=state.hist_start,
        want_details=want_details)
    _advance(state, next_ids)
    return sampling.pack_step_outputs(next_ids, details)


def _finish_prefill(eos_id: int, want_prompt_details: bool,
                    state: EngineState, logits_all: torch.Tensor,
                    ids: torch.Tensor, lengths: torch.Tensor,
                    slots: torch.Tensor, prefix_len: torch.Tensor):
    """Sample the first tokens of a prefilled bucket and install the slots'
    state in place. Returns (packed first-token outputs, prompt details or
    None)."""
    n, b = ids.shape
    t_max = state.history.shape[1]
    rows = torch.arange(n, device=ids.device)
    last_logits = logits_all[rows, (lengths - 1).long()]
    slots_l = slots.long()
    next_ids, details = sampling.next_tokens(
        last_logits, state.params.gather(slots_l), torch.zeros_like(lengths),
        ids, lengths, eos_id, history_start=prefix_len)
    # positions past max_seq are dropped, as JAX's mode="drop" drops them
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


def _decode_step(spec: DecoderSpec, eos_id: int, params: dict,
                 cache: KVCache, state: EngineState, write_mode: str = "post",
                 want_details: bool = True,
                 fuse_mlp: bool = False) -> torch.Tensor:
    """One decode step for every slot (cache and state in place); returns
    the packed step outputs [S, W]."""
    params = linops.prepare_params(params, rows=state.history.shape[0],
                                   fuse_mlp=fuse_mlp)
    ids, pos = _last_ids(state)
    logits, _ = core.decode(spec, params, ids, pos, cache, pos + 1,
                            write_mode=write_mode)
    return _sample_step(logits, state, eos_id, want_details)


def _decode_multi(spec: DecoderSpec, eos_id: int, num_steps: int,
                  params: dict, cache: KVCache, state: EngineState,
                  write_mode: str = "post", want_details: bool = True,
                  fuse_mlp: bool = False) -> torch.Tensor:
    """`num_steps` decode steps back to back; packed outputs stacked
    [num_steps, S, W]. Slots whose request stops mid-chunk compute
    (discarded) extra tokens, as in the JAX package."""
    params = linops.prepare_params(params, rows=state.history.shape[0],
                                   fuse_mlp=fuse_mlp)
    return torch.stack([
        _decode_step(spec, eos_id, params, cache, state, write_mode,
                     want_details) for _ in range(num_steps)])


def _decode_ring_multi(spec: DecoderSpec, eos_id: int, num_steps: int,
                       params: dict, cache: KVCache, state: EngineState,
                       want_details: bool = True,
                       cache_rows: Optional[int] = None,
                       fuse_mlp: bool = False) -> torch.Tensor:
    """`num_steps` decode steps with a per-chunk KV ring buffer and ONE
    cache write at chunk end (`core.decode_ring_step`, `core.ring_flush`).

    `cache_rows` narrows the READ side of the cache to its first rows (a
    context bucket covering every live slot's context at chunk entry;
    in-chunk tokens live in the ring): a view with the full cache's
    strides, no copy, where the JAX engine sliced a copy per chunk. The
    flush still targets the full cache. Returns [num_steps, S, W]."""
    s, t_max = state.history.shape
    params = linops.prepare_params(params, rows=s, fuse_mlp=fuse_mlp)
    chunk_start = torch.clamp(state.history_len - 1, 0, t_max - 1)
    read_cache = cache
    if cache_rows is not None and cache_rows < t_max:
        read_cache = KVCache(*(None if x is None else x.narrow(3, 0, cache_rows)
                               for x in cache))
    # in-chunk ring buffers stay in the model's float dtype over an int8
    # cache; the flush quantizes them once per chunk
    buf_dtype = (params["embed_tokens"].dtype if cache.quantized
                 else cache.k.dtype)
    kbuf = torch.zeros((spec.num_layers, s, spec.num_kv_heads, num_steps,
                        spec.head_dim), dtype=buf_dtype, device=cache.k.device)
    vbuf = torch.zeros_like(kbuf)
    packed = []
    for i in range(num_steps):
        ids, pos = _last_ids(state)
        logits, k_all, v_all = core.decode_ring_step(
            spec, params, ids, pos, read_cache, kbuf, vbuf, i, chunk_start)
        kbuf[:, :, :, i] = k_all.to(kbuf.dtype)
        vbuf[:, :, :, i] = v_all.to(vbuf.dtype)
        packed.append(_sample_step(logits, state, eos_id, want_details))
    core.ring_flush(cache, kbuf, vbuf, chunk_start)
    return torch.stack(packed)


def _prefill_step(spec: DecoderSpec, eos_id: int, want_prompt_details: bool,
                  params: dict, cache: KVCache, state: EngineState,
                  ids: torch.Tensor, lengths: torch.Tensor,
                  slots: torch.Tensor, prefix_len: torch.Tensor,
                  prefix_embeds: Optional[torch.Tensor] = None):
    """Prefill a bucket of prompts (after their soft prompts, if any) into
    their slots (cache and state in place). Returns (packed first-token
    outputs, prompt details or None)."""
    logits_all, _ = core.prefill(spec, params, ids, lengths, slots, cache,
                                 prefix_embeds=prefix_embeds,
                                 prefix_len=prefix_len)
    return _finish_prefill(eos_id, want_prompt_details, state, logits_all,
                           ids, lengths, slots, prefix_len)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


def check_decode_config(config: ServingConfig) -> None:
    """Raise ValueError for a decode configuration neither engine runs, as
    the JAX engines do."""
    if config.decode_write_mode not in ("ring", "post", "scan"):
        raise ValueError(
            f"unknown decode_write_mode {config.decode_write_mode!r}")
    if config.kv_cache_dtype == "int8":
        # int8 KV rides the ring-chunk scheme (quantize once at the chunk
        # flush); the per-step write path has no scale plumbing
        if config.decode_write_mode != "ring" or config.decode_chunk < 2:
            raise ValueError(
                "kv_cache_dtype=int8 requires the ring decode path "
                "(decode_write_mode=ring, decode_chunk > 1)")
        if config.stream_decode_chunk == 1:
            raise ValueError(
                "kv_cache_dtype=int8 requires stream_decode_chunk != 1 (the "
                "single-step decode has no int8 write path); use 0 or >= 2")


class SlotBatchEngine:
    """Host bookkeeping shared by the slot and the paged engine: the device,
    slots and deferred frees, request parameters, the prefill and decode
    chunk grids, and the host side of prefill and of the two-phase decode.

    A subclass sets spec, model_params, config, eos_token_id, device,
    num_slots, max_seq, decode_chunk and state, calls `_init_host()`, and
    implements `_decode_chunk(want_details, chunk)`."""

    # the batcher may dispatch chunk N+1 before fetching chunk N
    supports_decode_pipeline = True
    # the batcher may ask for a smaller chunk while a request streams
    supports_chunk_override = True

    def _init_host(self) -> None:
        self.free_slots: list[int] = list(range(self.num_slots))
        # free() runs on the event-loop thread while decode runs on the
        # executor thread (pipelined decode): guard the pending list
        self._free_lock = threading.Lock()
        self._pending_frees: list[int] = []
        # host mirror of each slot's history_len (0 = slot free), so decode
        # can pick a context bucket without a device fetch; mutated only on
        # the engine-call thread
        self._slot_ctx = np.zeros(self.num_slots, np.int32)
        self.last_forward_ns = 0
        self.last_n_emitted = None

    def _use_device(self) -> None:
        """Make the engine's CUDA device current on the calling thread (the
        batcher calls in from several threads)."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def _reset_host(self) -> None:
        self.free_slots = list(range(self.num_slots))
        with self._free_lock:
            self._pending_frees.clear()
        self._slot_ctx[:] = 0

    @property
    def num_active(self) -> int:
        return self.num_slots - len(self.free_slots)

    def acquire_slot(self) -> Optional[int]:
        return self.free_slots.pop() if self.free_slots else None

    def free(self, slot: int) -> None:
        """Release a slot (host bookkeeping; the device mask update is
        deferred to the next engine call)."""
        with self._free_lock:
            self._pending_frees.append(slot)
        self.free_slots.append(slot)

    def _apply_pending_frees(self) -> None:
        with self._free_lock:
            pending, self._pending_frees = self._pending_frees, []
        if pending:
            self._slot_ctx[np.asarray(pending)] = 0
            idx = torch.as_tensor(pending, dtype=torch.long,
                                  device=self.device)
            self.state.active[idx] = False

    def set_request_params(self, slot: int, rp: RequestParams) -> None:
        self.state.params.write_slot(
            slot, temperature=rp.temperature, top_k=rp.top_k,
            top_p=rp.top_p, typical_p=rp.typical_p,
            repetition_penalty=rp.repetition_penalty,
            lp_start=rp.lp_start, lp_decay=rp.lp_decay,
            min_new_tokens=rp.min_new_tokens, seed=rp.seed)

    def _warmup_batch_grid(self) -> tuple[int, ...]:
        """The power-of-two prefill batch sizes the scheduler can emit."""
        cap = min(self.num_slots, self.config.max_prefill_batch)
        grid, n = [], 1
        while n <= cap:
            grid.append(n)
            n *= 2
        return tuple(grid)

    def _chunk_grid(self) -> tuple[int, ...]:
        """The throughput chunk plus, when configured and smaller, the
        streaming chunk (see Batcher._decode_begin)."""
        chunks = {self.decode_chunk}
        sc = self.config.stream_decode_chunk
        if sc and 1 <= sc < self.decode_chunk:
            chunks.add(sc)
        return tuple(sorted(chunks))

    @staticmethod
    def _prefixes(prefix_embeds, n: int):
        """Each request's soft prompt ([P, D] array or None; a `PrefixEntry`
        gives its decoder tensor) and its length P (0 without one)."""
        pe_list = [getattr(pe, "decoder", pe)
                   for pe in (prefix_embeds or [None] * n)]
        return pe_list, [0 if pe is None else int(pe.shape[0])
                         for pe in pe_list]

    def _run_prefill(self, step, slots, token_ids, want_prompt_details: bool,
                     prefix_embeds=None) -> PrefillResult:
        """The host side of a prefill (JAX `InferenceEngine.prefill`): place
        each prompt after its soft prompt, pad to the bucket of the total
        length, run `step(ids, lengths, slots, prefix_len, embeds)` on the
        device (→ packed outputs, prompt details), fetch its outputs.
        `embeds` is the [N, T, D] f32 soft-prompt input, or None when no
        request has one; prompt details cover the prompt tokens only."""
        n = len(slots)
        pe_list, prefix_lens = self._prefixes(prefix_embeds, n)
        total_lens = [p + len(t) for p, t in zip(prefix_lens, token_ids)]
        bucket = self.config.bucket_for(max(total_lens))
        ids = np.zeros((n, bucket), np.int32)
        lengths = np.asarray(total_lens, np.int32)
        for i, toks in enumerate(token_ids):
            ids[i, prefix_lens[i]: prefix_lens[i] + len(toks)] = toks
        embeds = None
        if any(prefix_lens):
            host = np.zeros((n, bucket, self.spec.hidden_size), np.float32)
            for i, pe in enumerate(pe_list):
                if pe is not None:
                    host[i, : pe.shape[0]] = pe
            embeds = torch.from_numpy(host).to(self.device)

        def dev(a):
            return torch.as_tensor(a, dtype=torch.int32, device=self.device)

        t0 = time.monotonic_ns()
        try:
            packed, pdet = step(dev(ids), dev(lengths), dev(slots),
                                dev(np.asarray(prefix_lens, np.int32)), embeds)
            packed = packed.cpu().numpy()
            if pdet is not None:
                pdet = sampling.PromptDetails(*(t.cpu().numpy() for t in pdet))
        except Exception as e:
            raise EngineDeviceError(f"prefill step failed: {e}") from e
        self._slot_ctx[np.asarray(slots)] = lengths + 1
        first = StepResult(*sampling.unpack_step_outputs(packed))
        self.last_forward_ns = time.monotonic_ns() - t0

        prompt_details = None
        if want_prompt_details:
            prompt_details = []
            for i in range(n):
                s0, e0 = prefix_lens[i], total_lens[i]
                lp = pdet.logprob[i, s0:e0].copy()
                rk = pdet.rank[i, s0:e0].copy()
                # the first prompt token never reports a prediction, even
                # behind a soft prompt (reference: tokens.py:441-449)
                lp[0] = np.nan
                rk[0] = 0
                prompt_details.append({
                    "logprob": lp,
                    "rank": rk,
                    "top_ids": pdet.top_ids[i, s0:e0],
                    "top_logprobs": pdet.top_logprobs[i, s0:e0],
                    "top_scores": pdet.top_scores[i, s0:e0],
                })
        return PrefillResult(first_token=first, prompt_details=prompt_details)

    def decode(self) -> StepResult:
        """One decode step across all slots (inactive slots masked)."""
        return self.decode_steps()[0]

    def decode_steps_begin(self, want_details: bool = True, chunk=None):
        """Enqueue one decode chunk on the device without fetching its
        outputs (the two-phase pipelining contract: callers overlap chunk
        N+1's device work with chunk N's host fetch). `chunk` overrides this
        dispatch's step count (stream-aware chunking)."""
        chunk = self.decode_chunk if chunk is None else max(1, chunk)
        self.last_n_emitted = None   # every step row is valid for every slot
        self._use_device()
        self._apply_pending_frees()
        t0 = time.monotonic_ns()
        try:
            packed = self._decode_chunk(want_details, chunk)
        except Exception as e:
            raise EngineDeviceError(f"decode dispatch failed: {e}") from e
        np.minimum(np.where(self._slot_ctx > 0, self._slot_ctx + chunk, 0),
                   self.max_seq, out=self._slot_ctx)
        return (packed, chunk, t0)

    def decode_steps_end(self, handle) -> list[StepResult]:
        """Fetch the outputs of a chunk dispatched by decode_steps_begin;
        device-side failures of the chunk surface here."""
        packed, chunk, t0 = handle
        try:
            packed = packed.cpu().numpy()
        except Exception as e:
            raise EngineDeviceError(f"decode step failed: {e}") from e
        if chunk == 1:
            results = [StepResult(*sampling.unpack_step_outputs(packed))]
        else:
            results = [StepResult(*sampling.unpack_step_outputs(packed[i]))
                       for i in range(chunk)]
        self.last_forward_ns = time.monotonic_ns() - t0
        return results

    def decode_steps(self, want_details: bool = True,
                     chunk=None) -> list[StepResult]:
        """One decode chunk: dispatch plus one host fetch."""
        return self.decode_steps_end(
            self.decode_steps_begin(want_details, chunk=chunk))


class InferenceEngine(SlotBatchEngine):
    """The slot engine: model params, a `[L, S, K, max_seq, D]` KV cache
    and the slot state on one device; host-level prefill / decode / free."""

    def __init__(self, spec: DecoderSpec, params: dict, config: ServingConfig,
                 eos_token_id: int, device=None):
        self.device = resolve_device(device)
        check_supported(spec)
        check_decode_config(config)
        self.spec = spec
        if config.fuse_matmuls:
            from ..models.fuse import fuse_params

            params = fuse_params(spec, params)
        self.model_params = linops.prepare_storage(params)
        self.config = config
        self.eos_token_id = eos_token_id
        self._dtype = self.model_params["embed_tokens"].dtype
        self._cache_dtype = (torch.int8 if config.kv_cache_dtype == "int8"
                             else self._dtype)
        self.memory_plan = plan_memory(spec, config, self.model_params,
                                       self._cache_dtype,
                                       budget_bytes(self.device))
        self.fuse_mlp = fused_mlp_option()
        self.num_slots = config.max_batch_slots   # possibly shrunk by the plan
        self.max_seq = config.max_sequence_length
        self.decode_chunk = max(1, config.decode_chunk)
        self._write_mode = config.decode_write_mode
        self._use_device()
        self.cache = KVCache.create(spec, self.num_slots, self.max_seq,
                                    self._cache_dtype, self.device)
        self.state = EngineState.create(self.num_slots, self.max_seq,
                                        self.device)
        self._init_host()
        self._warmup_rows: Optional[int] = None
        logger.info("slot KV cache: %d slots x %d tokens (%s, %.2f GiB) on %s",
                    self.num_slots, self.max_seq, self._cache_dtype,
                    self.memory_plan.kv_bytes_per_slot * self.num_slots
                    / 1024 ** 3, self.device)

    def reset(self) -> None:
        """Rebuild the cache and the state after an EngineDeviceError: all
        slots become free; callers must have failed their in-flight requests
        first."""
        self._use_device()
        self.cache = KVCache.create(self.spec, self.num_slots, self.max_seq,
                                    self._cache_dtype, self.device)
        self.state = EngineState.create(self.num_slots, self.max_seq,
                                        self.device)
        self._reset_host()
        logger.warning("engine device state reset (all slots cleared)")

    def prefill(self, slots, token_ids, request_params,
                want_prompt_details: bool = False,
                prefix_embeds=None) -> PrefillResult:
        """Prefill one or more prompts into their slots; returns the first
        tokens (and per-prompt-token details when asked). `prefix_embeds[i]`,
        when given, is request i's soft prompt ([P_i, hidden] floats or a
        `PrefixEntry`), placed before its tokens."""
        assert len(slots) == len(token_ids) == len(request_params)
        self._use_device()
        self._apply_pending_frees()
        for slot, rp in zip(slots, request_params):
            self.set_request_params(slot, rp)

        def step(ids, lengths, slot_ids, prefix_len, embeds):
            return _prefill_step(self.spec, self.eos_token_id,
                                 want_prompt_details, self.model_params,
                                 self.cache, self.state, ids, lengths,
                                 slot_ids, prefix_len, embeds)

        return self._run_prefill(step, slots, token_ids, want_prompt_details,
                                 prefix_embeds)

    def warmup(self, batch_sizes: Optional[tuple[int, ...]] = None) -> None:
        """Run every prefill (batch, bucket) shape and every decode variant
        (context bucket x details x chunk) once, then reset the slot state.
        Eager PyTorch compiles nothing per shape, but the first call builds
        the CUDA kernels and warms cuBLAS and the allocator, which should
        not land on the first request."""
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
                ids = [[1] * min(bucket, self.max_seq - 2)] * n
                self.prefill(list(range(n)), ids, [RequestParams()] * n)
                n_runs += 1
        try:
            for rows in self._ctx_bucket_grid():
                self._warmup_rows = rows
                for want_details in (False, True):
                    for chunk in self._chunk_grid():
                        self.decode_steps(want_details=want_details,
                                          chunk=chunk)
                        n_runs += 1
        finally:
            self._warmup_rows = None
        # reset the slot state the dummy prefills polluted (the cache rows
        # they wrote are overwritten by the next prefill of each slot)
        self.state = EngineState.create(self.num_slots, self.max_seq,
                                        self.device)
        self._reset_host()
        logger.info("warmup ran %d shapes in %.1fs", n_runs,
                    time.monotonic() - t0)

    def _ctx_bucket_grid(self) -> list[int]:
        """Distinct cache_rows values decode may read (ring chunks only)."""
        if self._write_mode != "ring" or self.decode_chunk == 1:
            return [self.max_seq]
        return sorted({min(b, self.max_seq)
                       for b in (self.config.decode_ctx_buckets
                                 or [self.max_seq])})

    def _pick_cache_rows(self) -> int:
        """Smallest configured context bucket covering every live slot's
        history (host mirror, no device fetch). Slots freed while a
        pipelined chunk is in flight may read past the bucket on device;
        their outputs are discarded."""
        if self._warmup_rows is not None:
            return self._warmup_rows
        if self._write_mode != "ring" or self.decode_chunk == 1:
            return self.max_seq
        need = int(self._slot_ctx.max(initial=0))
        for b in self._ctx_bucket_grid():
            if b >= need:
                return b
        return self.max_seq

    def _decode_chunk(self, want_details: bool, chunk: int) -> torch.Tensor:
        mode = self._write_mode
        if chunk == 1:
            # ring is a chunk scheme; a single step writes "post"
            return _decode_step(self.spec, self.eos_token_id,
                                self.model_params, self.cache, self.state,
                                write_mode="post" if mode == "ring" else mode,
                                want_details=want_details,
                                fuse_mlp=self.fuse_mlp)
        if mode == "ring":
            return _decode_ring_multi(self.spec, self.eos_token_id, chunk,
                                      self.model_params, self.cache,
                                      self.state, want_details=want_details,
                                      cache_rows=self._pick_cache_rows(),
                                      fuse_mlp=self.fuse_mlp)
        return _decode_multi(self.spec, self.eos_token_id, chunk,
                             self.model_params, self.cache, self.state,
                             write_mode=mode, want_details=want_details,
                             fuse_mlp=self.fuse_mlp)
