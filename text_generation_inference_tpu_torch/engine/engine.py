"""Host-facing engine types (counterpart of the JAX package's
`engine/engine.py:45-112`).

Only the types the scheduler, server and paged engine share live here; the
slot engine (`InferenceEngine`) is not ported yet. `EngineState` holds
torch tensors on the engine's device and is updated in place by the engine
(where the JAX engine donated and replaced its buffers).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .sampling import SlotSamplingParams


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
