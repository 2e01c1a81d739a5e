"""Per-request state: parameters, output accumulation, stream events.

Carries the roles of the reference's `Entry` (router/src/queue.rs:36-61) and
the response-assembly half of `TokenProcessor` (router/src/batcher.rs).
"""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import time
from typing import Optional

import numpy as np

from ..engine.engine import RequestParams
from ..utils.detokenizer import (IncrementalDecoder, StopSequenceState,
                                 make_incremental_decoder)


class StopReason(enum.IntEnum):
    """Mirrors fmaas.StopReason (proto/generation.proto:155-172)."""

    NOT_FINISHED = 0
    MAX_TOKENS = 1
    EOS_TOKEN = 2
    CANCELLED = 3
    TIME_LIMIT = 4
    STOP_SEQUENCE = 5
    TOKEN_LIMIT = 6
    ERROR = 7


@dataclasses.dataclass
class StoppingCriteria:
    max_new_tokens: int
    min_new_tokens: int = 0
    time_limit_millis: int = 0
    stop_sequences: list[str] = dataclasses.field(default_factory=list)
    include_stop_sequence: bool = True
    # set by validation when max_new_tokens was clamped to the sequence-length
    # budget, so the MAX_TOKENS stop becomes TOKEN_LIMIT
    # (reference: validation.rs:179-185)
    max_is_token_limit: bool = False


@dataclasses.dataclass
class ResponseOptions:
    input_text: bool = False
    generated_tokens: bool = False
    input_tokens: bool = False
    token_logprobs: bool = False
    token_ranks: bool = False
    top_n_tokens: int = 0

    @property
    def wants_details(self) -> bool:
        return self.generated_tokens or self.input_tokens


@dataclasses.dataclass
class TokenRecord:
    """One generated (or input) token with optional extra detail."""

    token_id: int
    logprob: float = float("nan")
    rank: int = 0
    top_tokens: list[tuple[int, float]] = dataclasses.field(default_factory=list)


class GenRequest:
    _next_id = 0

    def __init__(
        self,
        input_text: str,
        input_ids: list[int],
        params: RequestParams,
        stopping: StoppingCriteria,
        options: ResponseOptions,
        *,
        prefix_id: Optional[str] = None,
        prefix_length: int = 0,
        streaming: bool = False,
        truncated: bool = False,
    ):
        GenRequest._next_id += 1
        self.id = GenRequest._next_id
        self.input_text = input_text
        self.input_ids = input_ids
        self.input_length = len(input_ids)
        self.prefix_id = prefix_id
        self.prefix_length = prefix_length
        self.params = params
        self.stopping = stopping
        self.options = options
        self.truncated = truncated

        self.queue_time = time.monotonic()
        self.start_time: Optional[float] = None      # set at prefill
        self.end_time: Optional[float] = None        # set at finish
        # the time-limit clock starts at request arrival (post-validation),
        # NOT at prefill, so queue wait counts against time_limit_millis —
        # reference arms the deadline at parameter conversion
        # (grpc_server.rs:560-563)
        self.deadline: Optional[float] = None
        if stopping.time_limit_millis:
            self.deadline = (self.queue_time
                             + stopping.time_limit_millis / 1000.0)

        self.slot: Optional[int] = None
        self.generated: list[TokenRecord] = []
        self.input_token_records: list[TokenRecord] = []
        self.decoder: Optional[IncrementalDecoder] = None
        self.stop_state: Optional[StopSequenceState] = None
        self.stop_reason = StopReason.NOT_FINISHED
        self.matched_stop: Optional[tuple[str, int]] = None
        self.cancelled = False
        self.error: Optional[str] = None

        self.streaming = streaming
        self.streamed_chars = 0        # chars already pushed to the stream
        self.stream_queue: Optional[asyncio.Queue] = None
        self.result_future: Optional[asyncio.Future] = None

    def attach_loop(self, loop: asyncio.AbstractEventLoop) -> None:
        """Create the completion future/stream queue on the serving loop."""
        if self.streaming and self.stream_queue is None:
            self.stream_queue = asyncio.Queue()
        if self.result_future is None:
            self.result_future = loop.create_future()

    # -- output assembly ----------------------------------------------------

    @property
    def generated_count(self) -> int:
        return len(self.generated)

    def begin(self, tokenizer) -> None:
        """Called when the request is admitted (prefill). The time-limit
        deadline is already armed (at arrival, in __init__)."""
        self.start_time = time.monotonic()
        self.decoder = make_incremental_decoder(tokenizer)
        self.stop_state = self._make_stop_state()

    def _make_stop_state(self):
        """Prefer the native C++ matcher (byte-exact, like the reference's
        Rust implementation); fall back to pure Python."""
        if self.stopping.stop_sequences:
            try:
                from ..utils.native_tokenproc import NativeStopState, available

                if available():
                    return NativeStopState(
                        self.stopping.stop_sequences,
                        self.stopping.include_stop_sequence)
            except Exception:
                pass
        return StopSequenceState(
            self.stopping.stop_sequences, self.stopping.include_stop_sequence)

    def final_text(self) -> str:
        if self.stop_state is None:
            # never started generating (e.g. early TIME_LIMIT in the queue)
            return self.input_text if self.options.input_text else ""
        text = self.stop_state.final_text(self.matched_stop)
        if self.options.input_text:
            return self.input_text + text
        return text

    def unstreamed_text(self, final: bool) -> str:
        """Text not yet pushed to the stream, honoring stop-seq hold-back."""
        assert self.stop_state is not None
        text = self.stop_state.visible_text(self.matched_stop, final)
        delta = text[self.streamed_chars:]
        self.streamed_chars = max(self.streamed_chars, len(text))
        return delta
