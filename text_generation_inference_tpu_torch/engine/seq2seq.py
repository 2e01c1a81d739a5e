"""Slot-based engine for encoder-decoder models (T5 / mT5 / UMT5; port of
the JAX package's `engine/seq2seq.py`).

The same host-facing interface as the decoder engines (prefill / decode /
free), so the scheduler is agnostic to model kind, mirroring how the
reference's Seq2SeqLM implements the same `Model` / `Batch` contract as
CausalLM (reference: server/.../models/seq2seq_lm.py). It is built on
`engine.SlotBatchEngine`, so it shares their slots, deferred frees, host
fetches, two-phase decode and decode programs (`engine.programs`: one
captured CUDA graph per decode key on the card, the eager step function on
the CPU).

Differences from the decoder engines, all as in the JAX package:

  * prefill = encode the prompt + run the decoder over its start token
    (and a tuned decoder prefix), caching encoder cross-KV per slot: one
    prefill program (a captured graph on the card) per JAX key (n, bucket,
    dec_width, has_enc, has_dec), the warm grid captured at warmup;
  * the decode state is a `T5DecodeState` ([L, S, H, T, D] self- and
    cross-KV and each slot's encoder length) over a decoder budget of
    `min(1 + prefix budget + max_new_tokens, max_seq)` positions;
  * the sampling "token history" for repetition penalty holds decoder
    tokens only (the reference's seq2seq input_ids are decoder ids,
    seq2seq_lm.py:635-739);
  * per-prompt-token details are not supported (the external API documents
    input-token detail for decoder-only models, proto/generation.proto:141),
    nor is a chunk override, nor an int8 KV cache;
  * decode programs are keyed (want_details, cache_rows, chunk) with the
    chunk fixed at `decode_chunk`: the JAX engine's (want_details,
    cache_rows) grid and count.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from ..config import ServingConfig
from ..device import resolve_device
from ..models import t5
from ..models.t5 import T5DecodeState, T5Spec
from . import sampling
from .engine import (EngineDeviceError, EngineState, InferenceEngine,
                     PrefillResult, RequestParams, SlotBatchEngine,
                     StepResult, _last_ids, _sample_step, check_decode_config)

logger = logging.getLogger(__name__)


def _s2s_prefill_step(spec: T5Spec, eos_id: int, params: dict,
                      dstate: T5DecodeState, state: EngineState,
                      enc_ids: torch.Tensor, enc_lengths: torch.Tensor,
                      slots: torch.Tensor, dec_ids: torch.Tensor,
                      dec_lengths: torch.Tensor,                   # [N]
                      enc_prefix_embeds=None, enc_prefix_len=None,
                      dec_prefix_embeds=None,
                      dec_prefix_len=None) -> torch.Tensor:
    """Encode + decoder prompt (start token [+ tuned decoder prefix]) into
    the slots (decode state and engine state in place). `dec_ids` [N,
    dec_width] holds the start token in column 0; rows with shorter
    prefixes pad with placeholder zeros beyond their dec_lengths. Returns
    the packed first-token outputs."""
    n = enc_ids.shape[0]
    t_max = state.history.shape[1]
    dev = enc_ids.device
    enc_states = t5.encode(spec, params, enc_ids, enc_lengths,
                           prefix_embeds=enc_prefix_embeds,
                           prefix_len=enc_prefix_len)
    logits, _ = t5.decoder_prefill(
        spec, params, dec_ids, dec_lengths, enc_states, enc_lengths, slots,
        dstate, dec_prefix_embeds=dec_prefix_embeds,
        dec_prefix_len=dec_prefix_len,
        dec_prefix_start=torch.ones_like(dec_lengths)
        if dec_prefix_embeds is not None else None)
    rows = torch.arange(n, device=dev)
    last_logits = logits[rows, (dec_lengths - 1).long()]
    sl = slots.long()
    next_ids, details = sampling.next_tokens(
        last_logits, state.params.gather(sl),
        gen_count=torch.zeros_like(dec_lengths),
        token_history=dec_ids, history_len=dec_lengths,
        eos_token_id=eos_id,
        # penalty window starts after the decoder start token + tuned
        # prefix placeholders — same convention as the decode steps, and
        # matching the reference's pad-exclusion (T5's start token IS pad;
        # reference: utils/logits_process.py:93-140)
        history_start=dec_lengths)
    # positions past the decoder budget are dropped, as JAX's mode="drop"
    cols = min(dec_ids.shape[1], t_max)
    state.history[sl[:, None], torch.arange(cols, device=dev)[None, :]] = \
        dec_ids[:, :cols]
    state.history[sl, torch.clamp(dec_lengths, 0, t_max - 1).long()] = next_ids
    state.history_len[sl] = dec_lengths + 1
    state.hist_start[sl] = dec_lengths
    state.input_len[sl] = enc_lengths
    state.gen_count.index_fill_(0, sl, 1)
    state.active.index_fill_(0, sl, True)
    return sampling.pack_step_outputs(next_ids, details)


def _s2s_decode_step(spec: T5Spec, eos_id: int, params: dict,
                     dstate: T5DecodeState, state: EngineState,
                     want_details: bool = True) -> torch.Tensor:
    """One decoder step for every slot (self-KV written in each layer, state
    advanced in place); returns the packed step outputs [S, W]."""
    ids, pos = _last_ids(state)
    logits, _ = t5.decoder_step(spec, params, ids, pos, dstate)
    return _sample_step(logits, state, eos_id, want_details)


def _s2s_decode_multi(spec: T5Spec, eos_id: int, num_steps: int,
                      params: dict, dstate: T5DecodeState,
                      state: EngineState,
                      want_details: bool = True) -> torch.Tensor:
    """`num_steps` decoder steps back to back, every step writing its self-KV
    in place (tokens arrive in bursts of `decode_chunk`; host-side stopping
    applies per token afterwards). Returns [num_steps, S, W]."""
    return torch.stack([
        _s2s_decode_step(spec, eos_id, params, dstate, state, want_details)
        for _ in range(num_steps)])


def _s2s_ring_multi(spec: T5Spec, eos_id: int, num_steps: int,
                    params: dict, dstate: T5DecodeState, state: EngineState,
                    want_details: bool = True,
                    cache_rows: Optional[int] = None) -> torch.Tensor:
    """Ring-buffer chunk decode: the decoder self-KV slabs are read-only
    inside the chunk (in-chunk tokens live in ring buffers, one scatter a
    chunk: `t5.decoder_ring_step`, `t5.ring_flush_self_kv`).

    `cache_rows` narrows the READ side of the decoder self-KV to its first
    rows (a context bucket covering every live slot's decoder context at
    chunk entry): a view with the slabs' strides, no copy, where the JAX
    engine sliced a copy per chunk. The flush still targets the full
    state. Returns [num_steps, S, W]."""
    s, t_max = state.history.shape
    chunk_start = torch.clamp(state.history_len - 1, 0, t_max - 1)
    read_state = dstate
    if cache_rows is not None and cache_rows < dstate.self_k.shape[3]:
        read_state = dstate._replace(
            self_k=dstate.self_k.narrow(3, 0, cache_rows),
            self_v=dstate.self_v.narrow(3, 0, cache_rows))
    kbuf = torch.zeros((spec.num_decoder_layers, s, spec.num_heads,
                        num_steps, spec.d_kv), dtype=dstate.self_k.dtype,
                       device=dstate.self_k.device)
    vbuf = torch.zeros_like(kbuf)
    packed = []
    for i in range(num_steps):
        ids, pos = _last_ids(state)
        logits, k_all, v_all = t5.decoder_ring_step(
            spec, params, ids, pos, read_state, kbuf, vbuf, i, chunk_start)
        kbuf[:, :, :, i] = k_all.to(kbuf.dtype)
        vbuf[:, :, :, i] = v_all.to(vbuf.dtype)
        packed.append(_sample_step(logits, state, eos_id, want_details))
    t5.ring_flush_self_kv(dstate, kbuf, vbuf, chunk_start)
    return torch.stack(packed)


class Seq2SeqEngine(SlotBatchEngine):
    """The decoder engines' surface, backed by an encoder-decoder model: its
    params, a `T5DecodeState` (`cache`) and the slot state on one device."""

    # the batcher never asks for a smaller chunk (the JAX engine has none)
    supports_chunk_override = False

    def __init__(self, spec: T5Spec, params: dict, config: ServingConfig,
                 eos_token_id: int, device=None, eager_decode: bool = False):
        if config.kv_cache_dtype == "int8":
            raise ValueError(
                "kv_cache_dtype=int8 is not supported on the seq2seq engine")
        check_decode_config(config)
        self.device = resolve_device(device)
        placed = {p.device for p in _tensors(params)}
        if placed != {self.device}:
            raise ValueError(f"the params live on {sorted(map(str, placed))}, "
                             f"not on the engine's device {self.device}")
        self.spec = spec
        self.model_params = params
        self.config = config
        self.eos_token_id = eos_token_id
        self.fuse_mlp = False
        self.num_slots = config.max_batch_slots
        self.max_enc = config.max_sequence_length
        # decoder budget: start token + tuned decoder prefix + generated
        # tokens. A prefix longer than the slack would otherwise silently
        # clip history / self-KV writes at the tail of the generation.
        dec_prefix_budget = (config.max_prompt_prefix_length
                             if config.prefix_store_path else 0)
        self.max_dec = min(1 + dec_prefix_budget + config.max_new_tokens,
                           config.max_sequence_length)
        self.max_seq = self.max_dec       # the decoder history's length
        self.decode_chunk = max(1, config.decode_chunk)
        self._write_mode = config.decode_write_mode
        self._dtype = params["shared_embed"].dtype
        self._use_device()
        t5.bucket_tables(spec, self.device)
        self.cache = T5DecodeState.create(spec, self.num_slots, self.max_dec,
                                          self.max_enc, self._dtype,
                                          self.device)
        self.state = EngineState.create(self.num_slots, self.max_dec,
                                        self.device)
        self._init_host(eager_decode)
        logger.info("seq2seq decode state: %d slots x %d decoder + %d encoder "
                    "positions (%s, %.2f GiB) on %s", self.num_slots,
                    self.max_dec, self.max_enc, self._dtype,
                    sum(t.numel() * t.element_size() for t in self.cache)
                    / 1024 ** 3, self.device)

    def reset(self) -> None:
        """Rebuild the decode and slot state after an EngineDeviceError: all
        slots become free; callers must have failed their in-flight requests
        first. The programs were captured against the old tensors: they are
        dropped, and recaptured against the new ones (`_recapture`)."""
        self._use_device()
        had_programs = len(self.programs) > 0
        self.programs.clear()
        self.cache = self.state = None    # free them before reallocating
        self.cache = T5DecodeState.create(self.spec, self.num_slots,
                                          self.max_dec, self.max_enc,
                                          self._dtype, self.device)
        self.state = EngineState.create(self.num_slots, self.max_dec,
                                        self.device)
        self._reset_host()
        self._recapture(had_programs)
        logger.warning("seq2seq device state reset (all slots cleared)")

    def _clear_slots(self) -> None:
        """Free every slot and zero the decode state, in place (the JAX
        engine's `reset` after warmup): captured programs stay valid."""
        super()._clear_slots()
        self.cache.zero_()

    def warmup(self, batch_sizes: tuple[int, ...] = (1,)) -> None:
        """Make the prefill program of every (batch, bucket) shape of the
        grid (`_warm_prefill_grid` over encoder buckets up to max_seq, one
        row a dispatch by default, as the JAX seq2seq warmup; the batcher
        never emits more than max_prefill_tokens padded tokens a dispatch,
        so the larger pairs are skipped), zero the state in place, make
        every decode program (`precompile_decode`) and run each once, then
        zero the state again."""
        t0 = time.monotonic()

        def prefill(n, bucket):
            ids = [[1] * min(bucket, self.max_enc - 1)] * n
            return self.prefill(list(range(n)), ids, [RequestParams()] * n)

        n_runs = self._warm_prefill_grid(batch_sizes, prefill, self.max_enc)
        self._clear_slots()
        n_programs = self._warm_decode()
        self._clear_slots()
        logger.info("seq2seq warmup made %d prefill programs and %d decode "
                    "programs in %.1fs", n_runs, n_programs,
                    time.monotonic() - t0)

    def prefill(self, slots, token_ids, request_params,
                want_prompt_details: bool = False,
                prefix_embeds=None) -> PrefillResult:
        """Encode the prompts (after their encoder soft prompts) and run the
        decoder over the start token (and decoder soft prompts) into their
        slots; returns the first tokens. `prefix_embeds[i]` is request i's
        `PrefixEntry` (its `encoder` and `decoder` tensors) or None.
        Prompt-token details are not supported (None)."""
        assert len(slots) == len(token_ids) == len(request_params)
        n = len(slots)
        self._use_device()
        self._apply_pending_frees()
        self._ensure_programs()
        for slot, rp in zip(slots, request_params):
            self.set_request_params(slot, rp)
        entries = prefix_embeds or [None] * n
        enc_pre = [getattr(e, "encoder", None) for e in entries]
        dec_pre = [getattr(e, "decoder", None) for e in entries]
        enc_plens = [0 if p is None else int(p.shape[0]) for p in enc_pre]
        dec_plens = [0 if p is None else int(p.shape[0]) for p in dec_pre]

        enc_total = [pl + len(t) for pl, t in zip(enc_plens, token_ids)]
        bucket = self.config.bucket_for(max(enc_total))
        ids = np.zeros((n, bucket), np.int32)
        for i, toks in enumerate(token_ids):
            ids[i, enc_plens[i]: enc_plens[i] + len(toks)] = toks
        enc_lengths = np.asarray(enc_total, np.int32)
        dec_width = 1 + max(dec_plens + [0])
        dec_ids = np.zeros((n, dec_width), np.int32)
        dec_ids[:, 0] = self.spec.decoder_start_token_id
        dec_lengths = np.asarray([1 + p for p in dec_plens], np.int32)

        def embeds(pre, width, start):
            host = np.zeros((n, width, self.spec.d_model), np.float32)
            for i, p in enumerate(pre):
                if p is not None:
                    host[i, start: start + p.shape[0]] = p
            return host

        has_enc, has_dec = any(enc_plens), any(dec_plens)
        arrays = (ids, enc_lengths, np.asarray(slots, np.int32), dec_ids,
                  dec_lengths,
                  embeds(enc_pre, bucket, 0) if has_enc else None,
                  np.asarray(enc_plens, np.int32) if has_enc else None,
                  embeds(dec_pre, dec_width, 1) if has_dec else None,
                  np.asarray(dec_plens, np.int32) if has_dec else None)
        key = (n, bucket, dec_width, has_enc, has_dec)
        t0 = time.monotonic_ns()
        try:
            packed = self._prefill_program(key, arrays).run(arrays)
            packed = packed.cpu().numpy()
        except Exception as e:
            raise EngineDeviceError(f"seq2seq prefill failed: {e}") from e
        # decoder history after prefill: start token + tuned prefix + the
        # first sampled token (history_len = dec_lengths + 1)
        self._slot_ctx[np.asarray(slots)] = dec_lengths + 1
        first = StepResult(*sampling.unpack_step_outputs(packed))
        self.last_forward_ns = time.monotonic_ns() - t0
        return PrefillResult(first_token=first, prompt_details=None)

    def _prefill_device(self, key: tuple, enc_ids, enc_lengths, slots,
                        dec_ids, dec_lengths, enc_embeds, enc_plen,
                        dec_embeds, dec_plen) -> torch.Tensor:
        """The eager prefill step of a key (n, bucket, dec_width, has_enc,
        has_dec): its program's function; the soft-prompt inputs are None
        where the key has none."""
        return _s2s_prefill_step(
            self.spec, self.eos_token_id, self.model_params, self.cache,
            self.state, enc_ids, enc_lengths, slots, dec_ids, dec_lengths,
            enc_prefix_embeds=enc_embeds, enc_prefix_len=enc_plen,
            dec_prefix_embeds=dec_embeds, dec_prefix_len=dec_plen)

    # -- decode programs ------------------------------------------------------

    def _chunk_grid(self) -> tuple[int, ...]:
        return (self.decode_chunk,)

    # the slot engine's decoder-context buckets (ring chunks only), over the
    # decoder budget (`max_seq` here) and the host mirror `_slot_ctx`
    _ctx_bucket_grid = InferenceEngine._ctx_bucket_grid
    _pick_cache_rows = InferenceEngine._pick_cache_rows
    _bucket_grid = _ctx_bucket_grid
    _pick_bucket = _pick_cache_rows

    def _decode_chunk(self, want_details: bool, cache_rows: int,
                      chunk: int) -> torch.Tensor:
        """The eager decode step of a program key: returns the packed
        outputs."""
        if chunk == 1:
            return _s2s_decode_step(self.spec, self.eos_token_id,
                                    self.model_params, self.cache,
                                    self.state, want_details=want_details)
        if self._write_mode == "ring":
            return _s2s_ring_multi(self.spec, self.eos_token_id, chunk,
                                   self.model_params, self.cache, self.state,
                                   want_details=want_details,
                                   cache_rows=cache_rows)
        return _s2s_decode_multi(self.spec, self.eos_token_id, chunk,
                                 self.model_params, self.cache, self.state,
                                 want_details=want_details)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree
