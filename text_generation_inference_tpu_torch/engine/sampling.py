"""Vectorized next-token choosing: logits processing, warping, and sampling
(PyTorch port of the JAX package's `engine/sampling.py`).

Semantics match the reference's heterogeneous chooser stack
(reference: server/.../utils/tokens.py:161-384 and utils/logits_process.py):

  order of operations per step:
    1. min_new_tokens EOS suppression, else exponential length penalty on the
       EOS logit (reference: tokens.py:242-256)
    2. repetition penalty over previously seen tokens (reference:
       logits_process.py:93-141)
    3. warpers: temperature, top-k, top-p, typical-p (reference:
       tokens.py:261-263; only no-op for disabled values)
    4. greedy argmax when temperature == 0.0, else sample from the warped
       distribution (Gumbel-max, equivalent to the reference's
       exponential-race trick, tokens.py:36-41)
    5. logprob/rank/top-n token details are computed from the *warped*
       scores (reference: tokens.py:265-271, 388-425)

Everything is mask-driven over the whole slot batch. The JAX package gates
the repetition penalty and the warpers behind `lax.cond(any(...))`; here
they always run, because a device-side `any` read on the host would cost a
synchronisation per step. For rows whose parameters disable them they are
exact no-ops (division by 1.0, a -inf top-k threshold, disabled top-p and
typical-p masks), so greedy ids, logprobs, ranks and top-n equal the JAX
package's.

Seeded sampling: the JAX package folds (seed, step) into a threefry key.
Here the Gumbel noise comes from a counter-based integer hash of
(seed, step, token id) computed on the device, so the same seed gives the
same output whatever the slot or batch. The streams differ from JAX's by
design; only greedy output must agree across the two packages.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

NEG_INF = float("-inf")

# Cap on returned top-n candidates: API max is 5, ties may extend the list to
# at most 4*n (reference: tokens.py:412). 20 covers the worst case.
MAX_TOP_N = 5
TOP_N_CAP = 4 * MAX_TOP_N


class SlotSamplingParams(NamedTuple):
    """Per-slot sampling parameter vectors (all shape [num_slots])."""

    temperature: torch.Tensor        # f32; 0.0 => greedy
    top_k: torch.Tensor              # i32; 0 => disabled
    top_p: torch.Tensor              # f32; 1.0 => disabled
    typical_p: torch.Tensor          # f32; 1.0 => disabled
    repetition_penalty: torch.Tensor # f32; 1.0 => disabled
    lp_start: torch.Tensor           # i32; length-penalty start index
    lp_decay: torch.Tensor           # f32; <= 1.0 => disabled
    min_new_tokens: torch.Tensor     # i32
    seed: torch.Tensor               # i64 holding a u32 per-slot seed

    @classmethod
    def empty(cls, num_slots: int, device) -> "SlotSamplingParams":
        def full(value, dtype):
            return torch.full((num_slots,), value, dtype=dtype, device=device)

        return cls(
            temperature=full(0.0, torch.float32),
            top_k=full(0, torch.int32),
            top_p=full(1.0, torch.float32),
            typical_p=full(1.0, torch.float32),
            repetition_penalty=full(1.0, torch.float32),
            lp_start=full(0, torch.int32),
            lp_decay=full(0.0, torch.float32),
            min_new_tokens=full(0, torch.int32),
            seed=full(0, torch.int64),
        )

    def write_slot(
        self,
        slot: int,
        *,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        typical_p: float = 1.0,
        repetition_penalty: float = 1.0,
        lp_start: int = 0,
        lp_decay: float = 0.0,
        min_new_tokens: int = 0,
        seed: int = 0,
    ) -> "SlotSamplingParams":
        """Write one slot's parameters in place; returns self."""
        values = (temperature, top_k, top_p if top_p > 0 else 1.0,
                  typical_p if typical_p > 0 else 1.0,
                  repetition_penalty if repetition_penalty > 0 else 1.0,
                  lp_start, lp_decay, min_new_tokens, int(seed) & 0xFFFFFFFF)
        for arr, value in zip(self, values):
            arr[slot] = value
        return self

    def gather(self, idx: torch.Tensor) -> "SlotSamplingParams":
        """Select rows (e.g. the slots being prefilled)."""
        return SlotSamplingParams(*(a[idx] for a in self))


def apply_eos_penalties(
    scores: torch.Tensor,          # [N, V] f32
    gen_count: torch.Tensor,       # [N] i32: tokens generated so far
    min_new_tokens: torch.Tensor,  # [N]
    lp_start: torch.Tensor,        # [N]
    lp_decay: torch.Tensor,        # [N]
    eos_token_id: int,
) -> torch.Tensor:
    """min_new_tokens suppression / exponential length boost of the EOS logit.

    Reference: tokens.py:242-256 — suppression wins over the length penalty,
    and the boost adds |logit| * (decay^tokens_past - 1) so that negative
    logits are boosted toward zero and beyond.
    """
    eos = scores[:, eos_token_id]
    suppress = gen_count < min_new_tokens
    tokens_past = gen_count - lp_start
    boost_on = (lp_decay > 1.0) & (tokens_past > 0) & ~suppress
    # Clamp the exponent to avoid inf from very long generations; the boost is
    # monotone so the argmax is unaffected once it saturates.
    exponent = torch.clamp(tokens_past, 0, 512).to(torch.float32)
    boost = torch.abs(eos) * (torch.pow(lp_decay, exponent) - 1.0)
    new_eos = torch.where(suppress, torch.full_like(eos, NEG_INF),
                          torch.where(boost_on, eos + boost, eos))
    out = scores.clone()
    out[:, eos_token_id] = new_eos
    return out


def apply_repetition_penalty(
    scores: torch.Tensor,        # [N, V] f32
    token_history: torch.Tensor, # [N, T] i32: input + generated ids per row
    history_len: torch.Tensor,   # [N] i32: number of valid ids per row
    penalty: torch.Tensor,       # [N] f32; 1.0 => no-op
    history_start: Optional[torch.Tensor] = None,  # [N] i32: skip ids before
) -> torch.Tensor:
    """CTRL-style repetition penalty over all previously seen tokens.

    Reference: logits_process.py:112-134 — negative scores are multiplied by
    the penalty, positive ones divided, so the probability always decreases.
    `history_start` masks out soft-prompt placeholder positions.
    """
    n, v = scores.shape
    t = token_history.shape[1]
    pos = torch.arange(t, device=scores.device)[None, :]
    valid = pos < history_len[:, None]
    if history_start is not None:
        valid &= pos >= history_start[:, None]
    # ids outside the vocabulary are dropped, as the JAX scatter drops them
    valid &= (token_history >= 0) & (token_history < v)
    ids_safe = torch.where(valid, token_history, 0).long()
    counts = torch.zeros((n, v), dtype=torch.int32, device=scores.device)
    counts.scatter_add_(1, ids_safe, valid.to(torch.int32))
    seen = counts > 0
    p = penalty[:, None]
    penalized = torch.where(scores < 0, scores * p, scores / p)
    return torch.where(seen & (p != 1.0), penalized, scores)


def apply_warpers(
    scores: torch.Tensor,    # [N, V] f32
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    typical_p: torch.Tensor,
) -> torch.Tensor:
    """Temperature → top-k → top-p → typical-p, all vectorized and masked.

    The top-k and top-p warpers share a single ascending sort of the scores.
    """
    n, v = scores.shape

    # --- temperature (0 encodes greedy => treated as 1.0, tokens.py:202) ---
    temp = torch.where(temperature == 0.0, 1.0, temperature)
    scores = scores / temp[:, None]

    sorted_asc, order = torch.sort(scores, dim=-1, stable=True)

    # --- top-k: keep scores >= k-th highest (ties kept, logits_process.py:294) ---
    k = torch.clamp(top_k, 0, v)
    kth_pos = torch.clamp(v - k, 0, v - 1).long()
    kth_score = torch.gather(sorted_asc, 1, kth_pos[:, None])
    kth_score = torch.where((top_k > 0)[:, None], kth_score, NEG_INF)
    scores = torch.where(scores < kth_score, NEG_INF, scores)

    # --- top-p: drop the low-probability prefix of the ascending order whose
    # cumulative mass is <= 1 - top_p, always keeping the most likely token
    # (logits_process.py:206-224) ---
    probs_asc = torch.softmax(sorted_asc, dim=-1)
    cum_asc = torch.cumsum(probs_asc, dim=-1)
    remove_sorted = cum_asc <= (1.0 - top_p)[:, None]
    remove_sorted &= (top_p < 1.0)[:, None]
    remove_sorted[:, -1] = False
    remove = torch.zeros_like(remove_sorted).scatter(1, order, remove_sorted)
    scores = torch.where(remove, NEG_INF, scores)

    # --- typical-p: keep the smallest set of tokens (by closeness of their
    # surprisal to the entropy) whose mass reaches typical_p
    # (logits_process.py:353-387) ---
    normalized = torch.log_softmax(scores, dim=-1)
    p_full = torch.exp(normalized)
    ent = -torch.sum(torch.where(p_full > 0, normalized * p_full, 0.0),
                     dim=-1, keepdim=True)
    shifted = torch.abs((-normalized) - ent)        # -inf scores => +inf
    shifted_sorted, t_order = torch.sort(shifted, dim=-1, stable=True)
    sorted_probs = torch.gather(p_full, 1, t_order)
    cum_t = torch.cumsum(sorted_probs, dim=-1)
    last_ind = torch.sum(cum_t < typical_p[:, None], dim=-1)
    last_ind = torch.clamp(last_ind, 0, v - 1)
    last_ind = torch.where(typical_p >= 1.0, v - 1, last_ind)
    threshold = torch.gather(shifted_sorted, 1, last_ind[:, None])
    return torch.where(shifted > threshold, NEG_INF, scores)


_MASK32 = 0xFFFFFFFF


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """32-bit avalanche finalizer on int64 tensors holding u32 values. Both
    multipliers are below 2**31, so no product overflows int64."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _MASK32
    h = h ^ (h >> 15)
    h = (h * 0x5BD1E995) & _MASK32
    return h ^ (h >> 16)


def gumbel_noise(seeds: torch.Tensor, step: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """[N, V] f32 Gumbel noise from a counter-based hash of
    (seed, step, token id): the same triple always gives the same value, on
    any slot and any device."""
    seeds = seeds.to(torch.int64) & _MASK32
    step = step.to(torch.int64) & _MASK32
    key = _mix32(seeds ^ _mix32(step + 0x3C6EF372))
    idx = torch.arange(vocab, dtype=torch.int64, device=seeds.device)
    h = _mix32(_mix32(idx[None, :] ^ key[:, None]) ^ (key[:, None] >> 7))
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def choose_tokens(
    warped: torch.Tensor,       # [N, V] f32 (post-warp scores)
    do_sample: torch.Tensor,    # [N] bool
    seeds: torch.Tensor,        # [N] per-slot seeds
    step: torch.Tensor,         # [N] i32 per-slot step counter (generated count)
) -> torch.Tensor:
    """Greedy argmax or seeded categorical sample per row (Gumbel-max).

    The per-(seed, step) noise makes sampling deterministic regardless of
    which slot a request lands in or what else is in the batch — the same
    reproducibility contract as the reference's per-request generators
    (tokens.py:32-41)."""
    greedy_ids = torch.argmax(warped, dim=-1).to(torch.int32)
    noise = gumbel_noise(seeds, step, warped.shape[-1])
    sampled_ids = torch.argmax(warped + noise, dim=-1).to(torch.int32)
    return torch.where(do_sample, sampled_ids, greedy_ids)


class TokenDetails(NamedTuple):
    """Compact per-row token info shipped to the host each step."""

    logprob: torch.Tensor    # [N] f32: logprob of the chosen token (post-warp)
    rank: torch.Tensor       # [N] i32: 1-based rank of the chosen token
    top_ids: torch.Tensor    # [N, TOP_N_CAP] i32: highest-score candidate ids
    top_logprobs: torch.Tensor  # [N, TOP_N_CAP] f32
    top_scores: torch.Tensor    # [N, TOP_N_CAP] f32 (for host-side tie handling)


def _top_candidates(scores: torch.Tensor, logprobs: torch.Tensor):
    """Top TOP_N_CAP scores of the last axis, ties broken by lower index
    (stable descending sort, as jax.lax.top_k), padded to TOP_N_CAP."""
    v = scores.shape[-1]
    cap = min(TOP_N_CAP, v)
    top_scores, top_ids = torch.sort(scores, dim=-1, descending=True,
                                     stable=True)
    top_scores, top_ids = top_scores[..., :cap], top_ids[..., :cap]
    top_lps = torch.gather(logprobs, -1, top_ids)
    if cap < TOP_N_CAP:
        pad = (0, TOP_N_CAP - cap)
        top_scores = torch.nn.functional.pad(top_scores, pad, value=NEG_INF)
        top_lps = torch.nn.functional.pad(top_lps, pad, value=NEG_INF)
        top_ids = torch.nn.functional.pad(top_ids, pad, value=0)
    return top_ids.to(torch.int32), top_lps, top_scores


def token_details(warped: torch.Tensor,
                  next_ids: torch.Tensor) -> TokenDetails:
    """logprob / rank / top-n extraction from the warped scores.

    Reference: tokens.py:388-425 — logprobs are log_softmax over the warped
    scores; rank counts strictly-greater scores; top-n selects every score
    tied with the n-th highest, capped at 4n entries.
    """
    logprobs = torch.log_softmax(warped, dim=-1)
    idx = next_ids.long()[:, None]
    chosen_lp = torch.gather(logprobs, 1, idx)[:, 0]
    chosen_score = torch.gather(warped, 1, idx)
    rank = (torch.sum(warped > chosen_score, dim=-1) + 1).to(torch.int32)
    top_ids, top_lps, top_scores = _top_candidates(warped, logprobs)
    return TokenDetails(logprob=chosen_lp, rank=rank, top_ids=top_ids,
                        top_logprobs=top_lps, top_scores=top_scores)


def next_tokens(
    logits: torch.Tensor,       # [N, V] raw model logits (any float dtype)
    params: SlotSamplingParams, # rows aligned with logits
    gen_count: torch.Tensor,    # [N] i32 tokens generated so far per row
    token_history: torch.Tensor,  # [N, T] i32
    history_len: torch.Tensor,  # [N] i32
    eos_token_id: int,
    history_start: Optional[torch.Tensor] = None,
    want_details: bool = True,
) -> tuple[torch.Tensor, Optional[TokenDetails]]:
    """Full next-token pipeline. Returns (next_ids [N] i32, details)."""
    scores = logits.to(torch.float32)
    scores = apply_eos_penalties(
        scores, gen_count, params.min_new_tokens, params.lp_start,
        params.lp_decay, eos_token_id)
    scores = apply_repetition_penalty(
        scores, token_history, history_len, params.repetition_penalty,
        history_start)
    do_sample = params.temperature != 0.0
    warped = apply_warpers(scores, params.temperature, params.top_k,
                           params.top_p, params.typical_p)
    next_ids = choose_tokens(warped, do_sample, params.seed, gen_count)
    details = token_details(warped, next_ids) if want_details else None
    return next_ids, details


def pack_step_outputs(next_ids: torch.Tensor,
                      details: Optional[TokenDetails]) -> torch.Tensor:
    """Pack (ids, details) into ONE [N, 3 + 3*TOP_N_CAP] f32 tensor so the
    host fetches a single buffer per step. `details=None` (no active request
    asked for token info) packs just the ids: [N, 1]."""
    if details is None:
        return next_ids[:, None].to(torch.float32)
    return torch.cat([
        next_ids[:, None].to(torch.float32),
        details.logprob[:, None],
        details.rank[:, None].to(torch.float32),
        details.top_ids.to(torch.float32),
        details.top_logprobs,
        details.top_scores,
    ], dim=1)


def unpack_step_outputs(packed) -> tuple:
    """numpy inverse of pack_step_outputs → (next_ids, logprob, rank,
    top_ids, top_logprobs, top_scores). Ids-only payloads yield NaN/0/empty
    detail fields."""
    packed = np.asarray(packed)
    cap = TOP_N_CAP
    n = packed.shape[0]
    if packed.shape[1] == 1:
        return (
            packed[:, 0].astype(np.int32),
            np.full((n,), np.nan, np.float32),
            np.zeros((n,), np.int32),
            np.zeros((n, cap), np.int32),
            np.full((n, cap), NEG_INF, np.float32),
            np.full((n, cap), NEG_INF, np.float32),
        )
    return (
        packed[:, 0].astype(np.int32),
        packed[:, 1],
        packed[:, 2].astype(np.int32),
        packed[:, 3:3 + cap].astype(np.int32),
        packed[:, 3 + cap:3 + 2 * cap],
        packed[:, 3 + 2 * cap:3 + 3 * cap],
    )


class PromptDetails(NamedTuple):
    """Per-prompt-token info (reference: tokens.py:429-506)."""

    logprob: torch.Tensor    # [..., T] f32; NaN at position 0
    rank: torch.Tensor       # [..., T] i32; 0 at position 0
    top_ids: torch.Tensor    # [..., T, TOP_N_CAP] i32
    top_logprobs: torch.Tensor  # [..., T, TOP_N_CAP] f32
    top_scores: torch.Tensor    # [..., T, TOP_N_CAP] f32


# prompt positions one pass of `prompt_token_details` takes over all rows:
# its log-softmax and sort hold a few copies of [DETAILS_ROWS, V] at a time,
# not of every row's T positions (`engine.memory.activation_bytes` counts
# one pass)
DETAILS_ROWS = 128


def _prompt_rows(scores: torch.Tensor, targets: torch.Tensor):
    """(chosen logprob, rank, top ids, top logprobs, top scores) of a run
    of prompt positions: scores [..., R, V] f32, targets [..., R, 1]."""
    logprobs = torch.log_softmax(scores, dim=-1)
    chosen_lp = torch.gather(logprobs, -1, targets)[..., 0]
    chosen_score = torch.gather(scores, -1, targets)
    rank = (torch.sum(scores > chosen_score, dim=-1) + 1).to(torch.int32)
    return (chosen_lp, rank, *_top_candidates(scores, logprobs))


def prompt_token_details(
    prompt_logits: torch.Tensor,  # [..., T-1, V]: logits at positions 0..T-2
    prompt_ids: torch.Tensor,     # [..., T] i32: the prompt token ids
) -> PromptDetails:
    """Input-token logprobs/ranks/top-n from the prefill logits.

    Position i's details come from the logits at position i-1; the first
    prompt token has no prediction (NaN logprob / rank 0 / no top tokens),
    matching reference tokens.py:441-455. Ranks and top-n use the raw
    logits. Leading batch dimensions are allowed (the JAX package vmaps).
    A pass takes at most DETAILS_ROWS positions over all rows (each
    position's details depend on its own logits only): whole rows while
    they fit, else one row DETAILS_ROWS positions at a time, so that a
    batch of rows holds no more than one row does. The passes are views of
    the logits, no copy."""
    t, v = prompt_logits.shape[-2:]
    lead = prompt_logits.shape[:-2]
    # merging the leading dimensions only keeps this a view of a
    # [N, T, V] prefill's logits sliced to [:, :T-1]
    logits = prompt_logits.reshape(-1, t, v)
    targets = prompt_ids[..., 1:].long().reshape(-1, t, 1)
    rows = max(DETAILS_ROWS // max(t, 1), 1)
    groups = []
    for r in range(0, logits.shape[0], rows):
        parts = [_prompt_rows(logits[r:r + rows, c:c + DETAILS_ROWS]
                              .to(torch.float32),
                              targets[r:r + rows, c:c + DETAILS_ROWS])
                 for c in range(0, max(t, 1), DETAILS_ROWS)]
        groups.append([torch.cat([p[i] for p in parts], 1)
                       for i in range(5)])
    chosen_lp, rank, top_ids, top_lps, top_scores = (
        torch.cat([g[i] for g in groups]).reshape(*lead, t, *tail)
        for i, tail in enumerate(((), (), (TOP_N_CAP,), (TOP_N_CAP,),
                                  (TOP_N_CAP,))))
    dev = prompt_logits.device

    def first(value, dtype, *tail):
        return torch.full((*lead, 1, *tail), value, dtype=dtype, device=dev)

    return PromptDetails(
        logprob=torch.cat([first(float("nan"), torch.float32), chosen_lp], -1),
        rank=torch.cat([first(0, torch.int32), rank], -1),
        top_ids=torch.cat([first(0, torch.int32, TOP_N_CAP), top_ids], -2),
        top_logprobs=torch.cat(
            [first(NEG_INF, torch.float32, TOP_N_CAP), top_lps], -2),
        top_scores=torch.cat(
            [first(NEG_INF, torch.float32, TOP_N_CAP), top_scores], -2),
    )
