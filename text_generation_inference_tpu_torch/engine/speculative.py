"""Speculative decoding: MLP-speculator drafts and batched verification
(port of the JAX package's `engine/speculative.py`; the reference's
paged speculative path, paged_causal_lm.py:481-563 + utils/paged.py).

A step drafts K = n_predict tokens per slot from the speculator's chain
state (`models.speculator.propose`), scores the C = K + 1 positions [last
token, draft_0..draft_{K-1}] in one verification forward (`core.
verify_chunk` on the slot engine, `paged_core.verify_chunk_paged` on the
paged one), runs every position through the full sampling pipeline, and
accepts the longest draft prefix the model agrees with: 1 to K + 1 tokens a
slot and a model call.

Exactness (tested): the emitted tokens are the ones plain decoding emits,
for any speculator. A draft is accepted only where it equals the token the
pipeline emits at its position, penalties included; a sampling row accepts
no draft and takes the token sampled at the chunk's first position, so
mixed batches stay exact. A bad speculator costs speed only.

`SpeculativeEngine` (the slot engine, `PAGED_ATTENTION=0`) always
speculates. `PagedSpeculativeEngine` speculates under the reference's gate
(paged_causal_lm.py:630-641): at most `SPECULATOR_MAX_BATCH_SIZE` active
rows (default 16), at least one greedy row, pool pressure at most 75%;
otherwise the step is a plain decode step of the paged engine's programs,
counted in `fallback_steps`. Both refuse int8 KV, as the JAX engines do.

Verify programs: as each decode key, each verify key is one captured CUDA
graph on the card (`engine.programs`), under the JAX engines' keys: one
program on the slot engine (its `_spec_decode_fn`), one per live-page
bucket on the paged engine (its `_spec_decode_fns`). The JAX engines
compile them at first use; these are captured at warmup with the decode
grid (`precompile_decode`), while no request is live, so that the eager
warm run is safe and no request waits on a capture. The graphs read the
speculator's chain state `spec_hidden` in place: it is reset in place,
never rebound. A replay's outputs, packed [C, S, W] and n_emit [S], are
copied to pinned memory, and the host advances each slot's context by its
n_emit, as the JAX engines do after their device_get.

Prefill programs: the slot engine's own prefill (which seeds the chain
state) is one program per JAX `_spec_prefill_fns` key (n, bucket); its
prefills with prompt details or a soft prompt take the plain engine's
keys, as the JAX engine routes them there. The paged engine's prefill is
the plain paged one, the slots' chain state zeroed in the same program,
under the paged keys.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import ServingConfig
from ..models import core, paged_core
from ..models import speculator as spec_mod
from ..models.core import DecoderSpec, KVCache
from ..models.speculator import SpeculatorSpec
from ..ops import linear as linops
from . import sampling
from .engine import (EngineDeviceError, EngineState, InferenceEngine,
                     StepResult, _finish_prefill, _last_ids)
from .memory import speculative_bytes
from .paged_engine import PagedInferenceEngine

# the seed of the random-init speculator an engine builds without one
DEFAULT_SPECULATOR_SEED = 7


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------


def _spec_prefill_step(spec: DecoderSpec, eos_id: int, params: dict,
                       cache: KVCache, state: EngineState,
                       spec_hidden: torch.Tensor, ids: torch.Tensor,
                       lengths: torch.Tensor, slots: torch.Tensor,
                       prefix_len: torch.Tensor):
    """Prefill a bucket into the slot cache, as the plain prefill, and seed
    each slot's speculator chain with the final-norm hidden state at its
    last prompt token. Returns (packed first-token outputs, None)."""
    logits_all, hidden_all, _ = core.prefill(spec, params, ids, lengths,
                                             slots, cache, return_hidden=True)
    rows = torch.arange(ids.shape[0], device=ids.device)
    last_hidden = hidden_all[rows, (lengths - 1).long()]
    packed, _ = _finish_prefill(eos_id, False, state, logits_all, ids,
                                lengths, slots, prefix_len)
    spec_hidden[slots.long()] = last_hidden.to(spec_hidden.dtype)
    return packed, None


def _accept_and_commit(eos_id: int, k: int, state: EngineState,
                       logits: torch.Tensor, hidden: torch.Tensor,
                       draft: torch.Tensor, spec_hidden: torch.Tensor):
    """The engine-agnostic half of a speculative step (state and
    spec_hidden in place): every chunk position through the full sampling
    pipeline over a tentative history (so that a later position's
    repetition penalty sees the earlier emissions), the longest draft
    prefix equal to the emitted tokens accepted (none for a sampling row),
    the accepted prefix committed to the history, and the chain state
    advanced to the hidden state at the last accepted position.

    Returns (packed [C, S, W], n_emit [S] int32)."""
    s, t_max = state.history.shape
    c = k + 1
    rows = torch.arange(s, device=logits.device)
    gen0 = state.gen_count.clone()
    hist_len = state.history_len.clone()
    tentative = state.history.clone()
    packed, emitted = [], []
    for j in range(c):
        ids_j, details_j = sampling.next_tokens(
            logits[:, j], state.params, gen0 + j, tentative, hist_len + j,
            eos_id, history_start=state.hist_start)
        packed.append(sampling.pack_step_outputs(ids_j, details_j))
        emitted.append(ids_j)
        tentative[rows, torch.clamp(hist_len + j, 0, t_max - 1).long()] = ids_j
    emitted_m = torch.stack(emitted, dim=1)                        # [S, C]

    # a draft is good iff it equals the token emitted at its position (the
    # penalized one), so the output is plain decoding's under penalties too
    n_accept = spec_mod.accept_longest_prefix(draft, emitted_m[:, :k])
    n_accept = torch.where(state.params.temperature != 0.0, 0, n_accept)
    n_emit = (n_accept + 1).to(torch.int32)

    # commit only the valid prefix of the tentative history
    for j in range(c):
        pos = torch.clamp(hist_len + j, 0, t_max - 1).long()
        valid = (j < n_emit) & state.active
        state.history[rows, pos] = torch.where(valid, emitted_m[:, j],
                                               state.history[rows, pos])
    adv = torch.where(state.active, n_emit, 0).to(torch.int32)
    state.history_len.add_(adv)
    state.gen_count.add_(adv)
    last = torch.clamp(n_emit - 1, 0, c - 1).long()
    new_hidden = hidden[rows, last].to(spec_hidden.dtype)
    spec_hidden.copy_(torch.where(state.active[:, None], new_hidden,
                                  spec_hidden))
    return torch.stack(packed), n_emit


def _draft(sspec: SpeculatorSpec, spec_params: dict, state: EngineState,
           spec_hidden: torch.Tensor):
    """Each slot's chunk: [last token, n_predict drafts] ([S, C]), the
    drafts ([S, K]) and the position of the last token ([S])."""
    last_ids, pos0 = _last_ids(state)
    draft = spec_mod.propose(sspec, spec_params, spec_hidden, last_ids)
    return torch.cat([last_ids[:, None], draft], dim=1), draft, pos0


def _spec_decode_step(spec: DecoderSpec, sspec: SpeculatorSpec, eos_id: int,
                      params: dict, spec_params: dict, cache: KVCache,
                      state: EngineState, spec_hidden: torch.Tensor):
    """One speculative step over the slot cache (cache, state and
    spec_hidden in place). Returns (packed [C, S, W], n_emit [S])."""
    chunk, draft, pos0 = _draft(sspec, spec_params, state, spec_hidden)
    logits, hidden, _ = core.verify_chunk(spec, params, chunk, pos0, cache)
    return _accept_and_commit(eos_id, sspec.n_predict, state, logits, hidden,
                              draft, spec_hidden)


def _paged_spec_decode_step(spec: DecoderSpec, sspec: SpeculatorSpec,
                            eos_id: int, page_size: int, max_seq: int,
                            live_pages: int, params: dict, spec_params: dict,
                            cache, state: EngineState,
                            spec_hidden: torch.Tensor,
                            fuse_mlp: bool = False):
    """One speculative step over the page pool: verification reads every
    slot's first `live_pages` pages and writes through the block table.
    The verify products take S x (1 + n_predict) rows (the decode route of
    a GPTQ model: K1's decode schedule, M1 under INT4_FUSED_MLP within 64
    rows). Returns (packed [C, S, W], n_emit [S])."""
    s = state.history.shape[0]
    params = linops.prepare_params(params, rows=s * (1 + sspec.n_predict),
                                   fuse_mlp=fuse_mlp)
    chunk, draft, pos0 = _draft(sspec, spec_params, state, spec_hidden)
    logits, hidden, _ = paged_core.verify_chunk_paged(
        spec, params, chunk, pos0, cache, page_size, active=state.active,
        max_seq=max_seq, live_pages=live_pages)
    return _accept_and_commit(eos_id, sspec.n_predict, state, logits, hidden,
                              draft, spec_hidden)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


def _refuse_int8(config: ServingConfig) -> None:
    if config.kv_cache_dtype == "int8":
        # verification reads and writes the cache at full precision
        raise ValueError(
            "speculative decoding does not support kv_cache_dtype=int8 (the "
            "verify-chunk forward has no quantized write path); unset "
            "SPECULATOR or use kv_cache_dtype=auto")


def _default_spec(spec: DecoderSpec, n_predict: int) -> SpeculatorSpec:
    """The random-init speculator's shape: inner_dim half the model's
    width (at least 64), as in the JAX engines."""
    return SpeculatorSpec(vocab_size=spec.vocab_size,
                          model_dim=spec.hidden_size,
                          inner_dim=max(spec.hidden_size // 2, 64),
                          n_predict=n_predict)


class _Speculation:
    """What both speculative engines add to their plain engine: the
    speculator and its chain state, the counters, and the dispatch of a
    verify program. Placed before the engine class in the bases."""

    # a step's n_emit drives the host bookkeeping before the next dispatch,
    # so the batcher must not use the two-phase pipeline (it would run plain
    # chunks), and a step already emits small bursts (1..n_predict + 1
    # tokens), so it takes no per-call chunk
    supports_decode_pipeline = False
    supports_chunk_override = False

    def _init_speculator(self, speculator_params: Optional[dict]) -> None:
        """After the engine: the speculator's weights (drawn from
        DEFAULT_SPECULATOR_SEED without any), the chain state, the
        counters. `self.sspec` is set before the engine, whose memory plan
        counts it."""
        dtype = self.model_params["embed_tokens"].dtype
        if speculator_params is None:
            gen = torch.Generator(device=self.device).manual_seed(
                DEFAULT_SPECULATOR_SEED)
            speculator_params = spec_mod.init_speculator(self.sspec, gen,
                                                         dtype)
        self.spec_params = speculator_params
        self.spec_hidden = torch.zeros(
            (self.num_slots, self.spec.hidden_size), dtype=dtype,
            device=self.device)
        self.accepted_histogram = np.zeros(self.sspec.n_predict + 2, np.int64)
        self.spec_steps = 0

    def _spec_working_bytes(self, gathered: bool) -> int:
        return speculative_bytes(self.spec, self.config, self.sspec,
                                 self.model_params["embed_tokens"].dtype,
                                 gathered)

    def _spec_dispatch(self, key: tuple) -> list[StepResult]:
        """One speculative step: replay (or run) the verify program of
        `key` (every verify key is in the grid), fetch its outputs, advance
        the host mirror of each slot's context by its n_emit and count the
        accepted drafts of the live slots."""
        self.spec_steps += 1
        self._ensure_programs()
        t0 = time.monotonic_ns()
        try:
            packed, n_emit = self.programs.get(key).run()
            packed, _ = self._fetch(packed)
            n_emit, done = self._fetch(n_emit)     # recorded after both
            if done is not None:
                done.synchronize()
            packed, n_emit = packed.numpy(), n_emit.numpy()
        except Exception as e:
            raise EngineDeviceError(f"speculative decode failed: {e}") from e
        self.last_n_emitted = n_emit
        live = self._slot_ctx > 0
        np.add.at(self.accepted_histogram, n_emit[live], 1)
        np.minimum(np.where(live, self._slot_ctx + n_emit, 0), self.max_seq,
                   out=self._slot_ctx)
        results = [StepResult(*sampling.unpack_step_outputs(packed[j]))
                   for j in range(packed.shape[0])]
        self.last_forward_ns = time.monotonic_ns() - t0
        return results


class SpeculativeEngine(_Speculation, InferenceEngine):
    """The slot engine (`PAGED_ATTENTION=0`) with speculative decoding: every
    decode step speculates (greedy rows; sampling rows take one token)."""

    def __init__(self, spec: DecoderSpec, params: dict, config: ServingConfig,
                 eos_token_id: int,
                 speculator_spec: Optional[SpeculatorSpec] = None,
                 speculator_params: Optional[dict] = None,
                 n_predict: int = 3, device=None, eager_decode: bool = False):
        _refuse_int8(config)
        self.sspec = speculator_spec or _default_spec(spec, n_predict)
        super().__init__(spec, params, config, eos_token_id, device=device,
                         eager_decode=eager_decode)
        self._init_speculator(speculator_params)

    def _speculative_bytes(self) -> int:
        return self._spec_working_bytes(gathered=False)

    def reset(self) -> None:
        super().reset()
        self.spec_hidden.zero_()

    def _clear_slots(self) -> None:
        super()._clear_slots()
        self.spec_hidden.zero_()

    def _program_fns(self, details=(False, True)) -> dict:
        """One verify program: this engine never runs a plain decode step."""
        return {("verify",): self._verify}

    def _verify(self):
        return _spec_decode_step(self.spec, self.sspec, self.eos_token_id,
                                 self.model_params, self.spec_params,
                                 self.cache, self.state, self.spec_hidden)

    def _prefill_key(self, n: int, bucket: int, want_prompt_details: bool,
                     has_prefix: bool) -> tuple:
        """(n, bucket) for its own prefill (JAX `_spec_prefill_fns`); the
        plain engine's key for one with prompt details or a soft prompt."""
        if want_prompt_details or has_prefix:
            return super()._prefill_key(n, bucket, want_prompt_details,
                                        has_prefix)
        return (n, bucket)

    def _prefill_device(self, key: tuple, ids, lengths, slots, prefix_len,
                        embeds):
        """Its own prefill (a key (n, bucket)), which captures each prompt's
        last hidden state for the speculator; prompt details and soft
        prompts take the plain prefill, as in the JAX engine, and their
        slots' chain state starts from zero (the JAX engine keeps the
        previous occupant's)."""
        if len(key) > 2:
            out = super()._prefill_device(key, ids, lengths, slots,
                                          prefix_len, embeds)
            self.spec_hidden.index_fill_(0, slots.long(), 0)
            return out
        return _spec_prefill_step(self.spec, self.eos_token_id,
                                  self.model_params, self.cache, self.state,
                                  self.spec_hidden, ids, lengths, slots,
                                  prefix_len)

    def decode_steps(self, want_details: bool = True,
                     chunk=None) -> list[StepResult]:
        """One speculative step → C StepResults (one per chunk position);
        slot s's first `last_n_emitted[s]` of them are real. Details are
        always computed, as in the JAX engine."""
        del want_details, chunk
        self._use_device()
        self._apply_pending_frees()
        return self._spec_dispatch(("verify",))


class PagedSpeculativeEngine(_Speculation, PagedInferenceEngine):
    """The paged engine with speculative decoding through the block table
    (the reference's configuration), under the reference's gate; a step
    that does not speculate is a plain decode step."""

    def __init__(self, spec: DecoderSpec, params: dict, config: ServingConfig,
                 eos_token_id: int, num_pages: Optional[int] = None,
                 speculator_spec: Optional[SpeculatorSpec] = None,
                 speculator_params: Optional[dict] = None,
                 n_predict: int = 3, max_spec_batch: Optional[int] = None,
                 device=None, eager_decode: bool = False, tp=None):
        _refuse_int8(config)
        self.sspec = speculator_spec or _default_spec(spec, n_predict)
        # under tensor parallelism the speculator and its chain state are
        # whole on every rank: each drafts the same tokens from the same
        # final-norm hidden state
        super().__init__(spec, params, config, eos_token_id,
                         num_pages=num_pages, device=device,
                         eager_decode=eager_decode, tp=tp)
        self._init_speculator(speculator_params)
        self.max_spec_batch = (max_spec_batch if max_spec_batch is not None
                               else int(os.getenv("SPECULATOR_MAX_BATCH_SIZE",
                                                  "16")))
        self._greedy = np.zeros(self.num_slots, bool)
        self.fallback_steps = 0

    def _speculative_bytes(self) -> int:
        return self._spec_working_bytes(gathered=True)

    # -- bookkeeping hooks ---------------------------------------------------

    def set_request_params(self, slot: int, rp) -> None:
        self._greedy[slot] = rp.temperature == 0.0
        super().set_request_params(slot, rp)

    def _clear_slots(self) -> None:
        """Also on `reset`: the chain state zeroed in place."""
        super()._clear_slots()
        self.spec_hidden.zero_()
        self._greedy[:] = False

    # -- programs ------------------------------------------------------------

    def _program_fns(self, details=(False, True)) -> dict:
        """The decode grid (the fallback steps) and one verify program per
        live-page bucket."""
        fns = super()._program_fns(details)
        fns.update({("verify", pages): functools.partial(self._verify, pages)
                    for pages in self._page_bucket_grid()})
        return fns

    def _verify(self, live_pages: int):
        return _paged_spec_decode_step(
            self.spec, self.sspec, self.eos_token_id, self.page_size,
            self.max_seq, live_pages, self.model_params, self.spec_params,
            self.cache, self.state, self.spec_hidden, self.fuse_mlp)

    # -- prefill -------------------------------------------------------------

    def _prefill_device(self, key: tuple, ids, lengths, slots, prefix_len,
                        embeds):
        """The plain paged prefill; the slots' chain state starts from zero
        (verify position 0 recomputes the true logits, so a cold chain only
        lowers the first step's acceptance), which also keeps a previous
        occupant's state out, as in the JAX engine."""
        out = super()._prefill_device(key, ids, lengths, slots, prefix_len,
                                      embeds)
        self.spec_hidden.index_fill_(0, slots.long(), 0)
        return out

    # -- speculative decode --------------------------------------------------

    def _should_speculate(self) -> bool:
        """The reference's gate: 1..max_spec_batch active rows, a greedy one
        among them, and at most 75% of the pool's pages in use."""
        if not 0 < self.num_active <= self.max_spec_batch:
            return False
        if not any(self._greedy[s] for s in range(self.num_slots)
                   if self._slot_ctx[s] > 0):
            return False
        used = self.allocator.num_pages - self.allocator.num_free
        return used / max(self.allocator.num_pages, 1) <= 0.75

    def _spec_live_pages(self) -> int:
        """The live-page bucket covering every context plus the chunk width
        (verification writes n_predict + 1 positions past the context)."""
        need = -(-(int(self._slot_ctx.max(initial=0))
                   + self.sspec.n_predict + 1) // self.page_size)
        for b in self._page_bucket_grid():
            if b >= need:
                return b
        return self.allocator.max_pages_per_slot

    def decode_steps(self, want_details: bool = True,
                     chunk=None) -> list[StepResult]:
        """A speculative step when the gate holds (C StepResults; slot s's
        first `last_n_emitted[s]` are real), else one plain decode dispatch
        (`last_n_emitted` None), counted in `fallback_steps`."""
        if not self._should_speculate():
            self.fallback_steps += 1
            return super().decode_steps(want_details=want_details,
                                        chunk=chunk)
        self._use_device()
        self._apply_pending_frees()
        return self._spec_dispatch(("verify", self._spec_live_pages()))
