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

Programs: as the JAX engines compile one program per decode key
(want_details, context rows, chunk) and `warmup` compiles them all
(`precompile_decode`), an engine on the card captures one CUDA graph per
key (`engine.programs`) and each decode dispatch replays one. Prefill
likewise: one graph per JAX prefill key (n, bucket, want_prompt_details,
has_prefix), with static input buffers; `warmup` captures the JAX warmup's
grid (buckets x `_warmup_batch_grid()`, no details, no soft prompt, less
the dispatches past `max_prefill_tokens`), and any other key is captured
at its first use. The programs are captured against the engine's own
cache and state tensors, so those are reset in place, never rebound,
while programs live; `reset()` after a device error rebuilds them and
recaptures every program. On the CPU the programs are the eager step
functions.

Tensor parallelism: built with `tp` (a `parallel.comm.TPGroup`), an
engine holds its rank's shard of the model (`parallel.sharding.
shard_model`, where the JAX engine shards its params over a mesh), a KV
cache of the rank's kv heads, and the slot count shared by every rank (the
smallest plan of the group). Every rank makes the same engine calls in the
same order (`parallel.multihost`), so their collectives meet.

Other differences from the JAX engine, all of them mechanical: the cache
and the state are updated in place on the device (the JAX engine donated
them to each step). Every call selects the
engine's CUDA device first and runs on its current stream, so device work
stays in call order whichever thread of the batcher calls.

Both engines take soft prompts (prompt tuning: `prefix_embeds` of
`prefill`, a `utils.prompt_cache.PrefixEntry` or a [P, D] array per
request), and both read `INT4_FUSED_MLP` once, when they are built: with
it, the decode steps run a GPTQ-INT4 model's MLP as one kernel
(`ops.linear.prepare_params`).
"""

from __future__ import annotations

import dataclasses
import functools
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
from ..models.core import DecoderSpec, KVCache
from ..ops import linear as linops
from ..parallel.sharding import shard_model
from . import sampling
from .memory import budget_bytes, plan_memory
from .programs import DecodePrograms
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

    def tensors(self) -> list[torch.Tensor]:
        return [*self[:-1], *self.params]

    def reset_(self) -> None:
        """Refill every tensor with `create`'s values, in place: captured
        decode programs hold these addresses."""
        fresh = EngineState.create(*self.history.shape, self.history.device)
        for dst, src in zip(self.tensors(), fresh.tensors()):
            dst.copy_(src)


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
    # index_fill_, not `x[idx] = 1`, which copies a host scalar (a capture
    # refuses the copy)
    state.gen_count.index_fill_(0, slots_l, 1)
    state.active.index_fill_(0, slots_l, True)
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
    num_slots, max_seq, decode_chunk and state, calls
    `_init_host(eager_decode)`, and implements `_decode_chunk(want_details,
    bucket, chunk)`, the eager decode step, `_bucket_grid()` and
    `_pick_bucket()` (context rows or live pages: the middle of a decode
    program's key), and `_prefill_device(key, *inputs)`, the eager prefill
    step of a prefill key."""

    # the batcher may dispatch chunk N+1 before fetching chunk N
    supports_decode_pipeline = True
    # the batcher may ask for a smaller chunk while a request streams
    supports_chunk_override = True
    # the tensor-parallel group of a sharded engine (`parallel.comm`)
    tp = None

    def _init_host(self, eager_decode: bool = False) -> None:
        # prefill and decode programs: CUDA graphs on the card unless
        # eager_decode (the eager reference tests compare with), the step
        # functions elsewhere
        self.programs = DecodePrograms(
            self.device, self.device.type == "cuda" and not eager_decode,
            self.tp)
        # the batch sizes of the last warmup (None before one): reset()
        # recaptures its grid
        self._warm_sizes: Optional[tuple[int, ...]] = None
        # set while warmup prefills: a new prefill program runs eagerly
        # once before its capture
        self._warming = False
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

    def _speculative_bytes(self) -> int:
        """What speculative decoding holds beside the plain engine (the
        speculator's weights and the verify step's working set): 0 here."""
        return 0

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

    def _clear_slots(self) -> None:
        """Free every slot, keeping the device tensors (the state back to
        `create`'s values, in place): captured programs stay valid."""
        self.state.reset_()
        self._reset_host()

    def _live(self) -> bool:
        """Whether a request is live on the device (prefilled, not freed)."""
        return bool(self._slot_ctx.any())

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

    def _run_prefill(self, slots, token_ids, want_prompt_details: bool,
                     prefix_embeds=None) -> PrefillResult:
        """The host side of a prefill (JAX `InferenceEngine.prefill`): place
        each prompt after its soft prompt, pad to the bucket of the total
        length, run the prefill program of the key (n, bucket,
        want_prompt_details, has_prefix) (`_prefill_key`) over (ids,
        lengths, slots, prefix_len, embeds), fetch its outputs (packed
        outputs, prompt details). `embeds` is the [N, T, D] f32 soft-prompt
        input, or None when no request has one; prompt details cover the
        prompt tokens only."""
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
            embeds = np.zeros((n, bucket, self.spec.hidden_size), np.float32)
            for i, pe in enumerate(pe_list):
                if pe is not None:
                    embeds[i, : pe.shape[0]] = pe
        key = self._prefill_key(n, bucket, want_prompt_details,
                                embeds is not None)
        arrays = (ids, lengths, np.asarray(slots, np.int32),
                  np.asarray(prefix_lens, np.int32), embeds)
        t0 = time.monotonic_ns()
        try:
            packed, pdet = self._prefill_program(key, arrays).run(arrays)
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

    # -- prefill programs ---------------------------------------------------

    def _prefill_key(self, n: int, bucket: int, want_prompt_details: bool,
                     has_prefix: bool) -> tuple:
        """The JAX engines' prefill key of a dispatch."""
        return (n, bucket, want_prompt_details, has_prefix)

    def _prefill_program(self, key: tuple, arrays: tuple):
        """The prefill program of `key`, made at its first use from this
        call's host arrays: with an eager run before its capture while
        warmup prefills, else captured alone, as JAX compiles a key at its
        first call (an eager run would hold a working set outside the
        graphs' pool, beside it, which the memory plan does not count)."""
        program = self.programs.prefill.get(key)
        if program is None:
            if self.programs.capture:
                # the programs pin the shared scratch: size it first
                linops.reserve_scratch(self.model_params, self.device,
                                       self.fuse_mlp)
            program = self.programs.build_prefill(
                key, functools.partial(self._prefill_device, key), arrays,
                warm=self._warming)
        return program

    def _warm_prefill_grid(self, batch_sizes, prefill,
                           max_len: Optional[int] = None) -> int:
        """warmup's prefill half: `prefill(n, bucket)` for every pair of the
        JAX warmup's grid (buckets up to `max_len`, by default max_seq, x
        batch sizes up to the slots) that the batcher can dispatch (at most
        max_prefill_tokens padded tokens), the largest dispatches first
        (their working set is the graphs' pool that the smaller ones
        reuse), each key's program made with an eager run before its
        capture. Returns the dispatches run."""
        max_len = self.max_seq if max_len is None else max_len
        pairs = [(n, bucket) for bucket in self.config.prefill_buckets
                 for n in batch_sizes
                 if bucket <= max_len and n <= self.num_slots
                 and n * bucket <= self.config.max_prefill_tokens]
        pairs.sort(key=lambda p: (p[0] * p[1], p[1]), reverse=True)
        self._warm_sizes = tuple(batch_sizes)
        self._warming = True
        try:
            return sum(bool(prefill(n, bucket)) for n, bucket in pairs)
        finally:
            self._warming = False

    def _recapture(self, had_programs: bool) -> None:
        """After reset() rebuilt the device state: the warm grid again if
        warmup had run (it recaptures every warm prefill key and the decode
        grid), else the decode grid if it had been made."""
        if self._warm_sizes is not None:
            self.warmup(self._warm_sizes)
        elif had_programs:
            self.precompile_decode()

    # -- decode programs ----------------------------------------------------

    def _decode_keys(self, details=(False, True)) -> list[tuple]:
        """The JAX engines' decode-program grid: bucket x details x chunk."""
        return [(want_details, bucket, chunk)
                for bucket in self._bucket_grid()
                for want_details in details
                for chunk in self._chunk_grid()]

    def precompile_decode(self, details=(False, True)) -> int:
        """Make every decode program of the grid (on the card: run each once
        eagerly, then capture it) and return how many keys the grid holds,
        the JAX engines' count. The eager runs write the engine's state, so
        on the card no request may be in flight (warmup and reset call this
        with none)."""
        self._use_device()
        self._apply_pending_frees()
        if self.programs.capture and self._live():
            raise RuntimeError("precompile_decode runs every decode program "
                               "once on the engine's state: call it with no "
                               "request in flight")
        fns = self._program_fns(details)
        if self.programs.capture:
            # the programs pin the shared scratch: size it for every row
            # count first, prefill's included
            linops.reserve_scratch(self.model_params, self.device,
                                   self.fuse_mlp)
        self.programs.build(fns)
        return len(fns)

    def _program_fns(self, details=(False, True)) -> dict:
        """Every program `precompile_decode` makes: key -> eager step
        function. The decode grid here; the speculative engines add (or
        take instead) their verify programs."""
        return {key: functools.partial(self._decode_chunk, *key)
                for key in self._decode_keys(details)}

    def _ensure_programs(self) -> None:
        """An engine that never made its decode programs makes the whole
        grid while no request is live, so while its eager runs are safe:
        before its first prefill installs a request (or its first
        dispatch)."""
        if not len(self.programs) and not self._live():
            self.precompile_decode()

    def _get_decode_fn(self, want_details: bool, bucket: int, chunk: int):
        """The decode program of a key; a key outside the grid (a chunk
        override) is captured alone at its first use, as JAX compiles one
        at its first call."""
        key = (want_details, bucket, chunk)
        if self.programs.get(key) is None:
            self._ensure_programs()
            self.programs.build(
                {key: functools.partial(self._decode_chunk, *key)},
                warm=False)
        return self.programs.get(key)

    def _warm_decode(self) -> int:
        """warmup's decode half, once the state it will serve with holds no
        request: make every program (`precompile_decode`) and run each once
        (the JAX engines run one chunk per program after compiling: a first
        run pays one-time costs). Returns the JAX count of programs."""
        n = self.precompile_decode()
        for program in self.programs.programs.values():
            program.run()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return n

    def _fetch(self, packed: torch.Tensor):
        """Start copying a dispatch's packed outputs to the host: into a
        pinned buffer of the handle's own, with an event, on the card (a
        replay's output is overwritten by the next replay, and the batcher
        dispatches chunk N+1 before it fetches chunk N); as they are on the
        CPU."""
        if packed.device.type != "cuda":
            return packed, None
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def decode(self) -> StepResult:
        """One decode step across all slots (inactive slots masked)."""
        return self.decode_steps()[0]

    def decode_steps_begin(self, want_details: bool = True, chunk=None):
        """Enqueue one decode chunk on the device without fetching its
        outputs (the two-phase pipelining contract: callers overlap chunk
        N+1's device work with chunk N's host fetch). `chunk` overrides this
        dispatch's step count (stream-aware chunking). On the card the
        dispatch is one replay of the key's program, and its outputs are
        copied out before this returns."""
        chunk = self.decode_chunk if chunk is None else max(1, chunk)
        self.last_n_emitted = None   # every step row is valid for every slot
        self._use_device()
        self._apply_pending_frees()
        t0 = time.monotonic_ns()
        try:
            program = self._get_decode_fn(want_details, self._pick_bucket(),
                                          chunk)
            fetched = self._fetch(program.run())
        except Exception as e:
            raise EngineDeviceError(f"decode dispatch failed: {e}") from e
        np.minimum(np.where(self._slot_ctx > 0, self._slot_ctx + chunk, 0),
                   self.max_seq, out=self._slot_ctx)
        return (fetched, chunk, t0)

    def decode_steps_end(self, handle) -> list[StepResult]:
        """Fetch the outputs of a chunk dispatched by decode_steps_begin;
        device-side failures of the chunk surface here."""
        (packed, done), chunk, t0 = handle
        try:
            if done is not None:
                done.synchronize()
            packed = packed.numpy()
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
    and the slot state on one device; host-level prefill / decode / free.
    `eager_decode=True` runs every program, prefill and decode, eagerly on
    the card (the reference replays are compared with; as on the CPU)."""

    def __init__(self, spec: DecoderSpec, params: dict, config: ServingConfig,
                 eos_token_id: int, device=None, eager_decode: bool = False,
                 tp=None):
        self.device = resolve_device(device)
        check_decode_config(config)
        self.tp = tp
        if tp is not None:
            spec, params = shard_model(spec, params, tp, self.device)
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
                                       budget_bytes(self.device),
                                       self._speculative_bytes())
        self.fuse_mlp = fused_mlp_option()
        if tp is not None:
            # every rank serves the same slots
            config.max_batch_slots = tp.min_int(config.max_batch_slots)
        self.num_slots = config.max_batch_slots   # possibly shrunk by the plan
        self.max_seq = config.max_sequence_length
        self.decode_chunk = max(1, config.decode_chunk)
        self._write_mode = config.decode_write_mode
        self._use_device()
        self.cache = KVCache.create(spec, self.num_slots, self.max_seq,
                                    self._cache_dtype, self.device)
        self.state = EngineState.create(self.num_slots, self.max_seq,
                                        self.device)
        self._init_host(eager_decode)
        logger.info("slot KV cache: %d slots x %d tokens (%s, %.2f GiB) on %s",
                    self.num_slots, self.max_seq, self._cache_dtype,
                    self.memory_plan.kv_bytes_per_slot * self.num_slots
                    / 1024 ** 3, self.device)

    def reset(self) -> None:
        """Rebuild the cache and the state after an EngineDeviceError: all
        slots become free; callers must have failed their in-flight requests
        first. The programs were captured against the old tensors: they are
        dropped, and recaptured against the new ones (`_recapture`: the warm
        grid, or the decode grid if only that was made), as the JAX engine
        recompiles against new buffers."""
        self._use_device()
        had_programs = len(self.programs) > 0
        self.programs.clear()
        self.cache = self.state = None    # free them before reallocating
        self.cache = KVCache.create(self.spec, self.num_slots, self.max_seq,
                                    self._cache_dtype, self.device)
        self.state = EngineState.create(self.num_slots, self.max_seq,
                                        self.device)
        self._reset_host()
        self._recapture(had_programs)
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
        self._ensure_programs()
        for slot, rp in zip(slots, request_params):
            self.set_request_params(slot, rp)
        return self._run_prefill(slots, token_ids, want_prompt_details,
                                 prefix_embeds)

    def _prefill_device(self, key: tuple, ids, lengths, slots, prefix_len,
                        embeds):
        """The eager prefill step of a key (n, bucket, want_prompt_details,
        has_prefix): its program's function."""
        return _prefill_step(self.spec, self.eos_token_id, key[2],
                             self.model_params, self.cache, self.state, ids,
                             lengths, slots, prefix_len, embeds)

    def warmup(self, batch_sizes: Optional[tuple[int, ...]] = None) -> None:
        """Make the prefill program of every (batch, bucket) shape of the
        grid (`_warm_prefill_grid`: one eager run, which builds the CUDA
        kernels and warms cuBLAS and the allocator, then the capture and its
        replay), reset the slot state in place, then make every decode
        program (context bucket x details x chunk: `precompile_decode`) and
        run each once."""
        if batch_sizes is None:
            batch_sizes = self._warmup_batch_grid()
        t0 = time.monotonic()

        def prefill(n, bucket):
            ids = [[1] * min(bucket, self.max_seq - 2)] * n
            return self.prefill(list(range(n)), ids, [RequestParams()] * n)

        n_runs = self._warm_prefill_grid(batch_sizes, prefill)
        # reset the slot state the dummy prefills polluted, in place (the
        # cache rows they wrote are overwritten by the next prefill of each
        # slot), before the decode programs run against it
        self._clear_slots()
        n_programs = self._warm_decode()
        logger.info("warmup made %d prefill programs and %d decode programs "
                    "in %.1fs", n_runs, n_programs, time.monotonic() - t0)

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
        if self._write_mode != "ring" or self.decode_chunk == 1:
            return self.max_seq
        need = int(self._slot_ctx.max(initial=0))
        for b in self._ctx_bucket_grid():
            if b >= need:
                return b
        return self.max_seq

    _bucket_grid = _ctx_bucket_grid
    _pick_bucket = _pick_cache_rows

    def _decode_chunk(self, want_details: bool, cache_rows: int,
                      chunk: int) -> torch.Tensor:
        """The eager decode step of a program key (want_details, cache_rows,
        chunk): returns the packed outputs."""
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
                                      cache_rows=cache_rows,
                                      fuse_mlp=self.fuse_mlp)
        return _decode_multi(self.spec, self.eos_token_id, chunk,
                             self.model_params, self.cache, self.state,
                             write_mode=mode, want_details=want_details,
                             fuse_mlp=self.fuse_mlp)
