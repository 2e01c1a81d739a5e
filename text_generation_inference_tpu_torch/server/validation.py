"""Request validation: parameter range checks, tokenization, length budget.

Faithful port of the reference's rules, limits, and error messages
(reference: router/src/validation.rs:57-218, 238-272) so existing clients
see identical failure behavior.
"""

from __future__ import annotations

import dataclasses
import secrets
from typing import Optional

from ..config import ServingConfig
from ..engine.engine import RequestParams
from ..scheduler.request import ResponseOptions, StoppingCriteria
from ..utils import metrics

MAX_STOP_SEQS = 6
MAX_STOP_SEQ_LENGTH = 240


class ValidationError(ValueError):
    pass


@dataclasses.dataclass
class ValidatedRequest:
    input_text: str
    input_ids: list[int]
    params: RequestParams
    stopping: StoppingCriteria
    options: ResponseOptions
    truncated: bool
    prefix_id: Optional[str] = None
    prefix_length: int = 0


def validate_params(pb_params, config: ServingConfig) -> tuple[
        RequestParams, StoppingCriteria, ResponseOptions]:
    """Range-check fmaas.Parameters and convert to internal structures.

    Conversion semantics follow reference grpc_server.rs:526-598: sampling
    parameters apply only in SAMPLE mode; zero values select defaults.
    """
    from ..pb import generation_pb2 as pb

    p = pb_params if pb_params is not None else pb.Parameters()
    sampling = p.sampling
    stopping = p.stopping
    decoding = p.decoding
    response = p.response

    is_sample = p.method == pb.SAMPLE
    temperature = sampling.temperature if is_sample else 0.0
    if is_sample and temperature == 0.0:
        temperature = 1.0
    top_k = sampling.top_k if is_sample else 0
    top_p = sampling.top_p if is_sample else 0.0
    typical_p = sampling.typical_p if is_sample else 0.0
    top_p = top_p if top_p > 0 else 1.0
    typical_p = typical_p if typical_p > 0 else 1.0

    if temperature != 0.0 and temperature < 0.05:
        raise ValidationError("temperature must be >= 0.05")
    if top_p <= 0.0 or top_p > 1.0:
        raise ValidationError("top_p must be > 0.0 and <= 1.0")
    if typical_p > 1.0:
        raise ValidationError("typical_p must be <= 1.0")
    if top_k < 0:
        raise ValidationError("top_k must be strictly positive")

    if not is_sample and (
        sampling.temperature or sampling.top_k or sampling.top_p
        or sampling.typical_p or sampling.HasField("seed")
    ):
        raise ValidationError(
            "sampling parameters aren't applicable in greedy decoding mode")

    max_new_tokens = stopping.max_new_tokens or config.default_max_new_tokens
    if max_new_tokens > config.max_new_tokens:
        raise ValidationError(f"max_new_tokens must be <= {config.max_new_tokens}")
    min_new_tokens = stopping.min_new_tokens
    if min_new_tokens > max_new_tokens:
        raise ValidationError("min_new_tokens must be <= max_new_tokens")

    repetition_penalty = decoding.repetition_penalty
    if repetition_penalty == 0.0:
        repetition_penalty = 1.0
    if repetition_penalty < 0.0:
        raise ValidationError("repetition_penalty must be > 0.0")

    lp_start, lp_decay = 0, 0.0
    if decoding.HasField("length_penalty"):
        lp_start = decoding.length_penalty.start_index
        lp_decay = decoding.length_penalty.decay_factor
        if not (1.0 <= lp_decay <= 10.0):
            raise ValidationError("length_penalty must be >= 1.0 and <= 10.0")

    if len(stopping.stop_sequences) > MAX_STOP_SEQS or any(
        (not s) or len(s.encode()) > MAX_STOP_SEQ_LENGTH
        for s in stopping.stop_sequences
    ):
        raise ValidationError(
            f"can specify at most {MAX_STOP_SEQS} non-empty stop sequences, "
            f"each not more than {MAX_STOP_SEQ_LENGTH} UTF8 bytes")

    if (response.token_logprobs or response.token_ranks or response.top_n_tokens) \
            and not (response.input_tokens or response.generated_tokens):
        raise ValidationError(
            "must request input and/or generated tokens to request extra token detail")
    top_n = min(response.top_n_tokens, 5)

    seed = 0
    if is_sample:
        seed = sampling.seed if sampling.HasField("seed") else secrets.randbits(32)

    params = RequestParams(
        temperature=temperature,
        top_k=top_k,
        top_p=top_p,
        typical_p=typical_p,
        seed=int(seed) & 0xFFFFFFFF,
        repetition_penalty=repetition_penalty,
        lp_start=lp_start,
        lp_decay=lp_decay,
        min_new_tokens=min_new_tokens,
        max_new_tokens=max_new_tokens,
    )
    include_stop = (
        stopping.include_stop_sequence
        if stopping.HasField("include_stop_sequence")
        else config.default_include_stop_seqs)
    stop = StoppingCriteria(
        max_new_tokens=max_new_tokens,
        min_new_tokens=min_new_tokens,
        time_limit_millis=stopping.time_limit_millis,
        stop_sequences=list(stopping.stop_sequences),
        include_stop_sequence=include_stop,
    )
    options = ResponseOptions(
        input_text=response.input_text,
        generated_tokens=response.generated_tokens,
        input_tokens=response.input_tokens,
        token_logprobs=response.token_logprobs,
        token_ranks=response.token_ranks,
        top_n_tokens=top_n,
    )
    return params, stop, options


class Validation:
    def __init__(self, tokenizer, config: ServingConfig, prompt_cache=None):
        self.tokenizer = tokenizer
        self.config = config
        self.prompt_cache = prompt_cache

    def prefix_length(self, prefix_id: Optional[str]) -> int:
        if not prefix_id:
            return 0
        if self.prompt_cache is None:
            raise ValidationError(
                f"can't retrieve prompt prefix with id '{prefix_id}': "
                "no prefix store configured")
        try:
            return self.prompt_cache.prefix_length(prefix_id)
        except Exception as e:
            raise ValidationError(
                f"can't retrieve prompt prefix with id '{prefix_id}': {e}")

    def validate(self, pb_params, texts: list[str],
                 prefix_id: Optional[str] = None) -> list[ValidatedRequest]:
        params, stopping, options = validate_params(pb_params, self.config)
        truncate = pb_params.truncate_input_tokens if pb_params is not None else 0
        prefix_length = self.prefix_length(prefix_id)
        out = []
        for text in texts:
            ids = self.tokenizer.encode(text, add_special_tokens=False)
            # raw length includes inputs that will fail the length check
            # below (reference: tgi_request_raw_input_length)
            metrics.observe("tgi_request_raw_input_length", len(ids))
            truncated = bool(truncate) and truncate < len(ids)
            if truncated:
                ids = ids[-truncate:]
            input_length = len(ids)
            effective = input_length + prefix_length
            max_seq = self.config.max_sequence_length
            if effective >= max_seq:
                raise ValidationError(
                    f"input tokens ({input_length}) plus prefix length "
                    f"({prefix_length}) must be < {max_seq}")
            if effective + stopping.min_new_tokens > max_seq:
                raise ValidationError(
                    f"input tokens ({input_length}) plus prefix length "
                    f"({prefix_length}) plus min_new_tokens "
                    f"({stopping.min_new_tokens}) must be <= {max_seq}")
            req_stopping = dataclasses.replace(stopping)
            req_params = dataclasses.replace(params)
            if effective + stopping.max_new_tokens > max_seq:
                req_stopping.max_new_tokens = max_seq - effective
                req_stopping.max_is_token_limit = True
                req_params.max_new_tokens = req_stopping.max_new_tokens
            # each request in a batch gets an independent random seed when
            # none was supplied (reference: test_server.py multi-input seed
            # uniqueness)
            if params.temperature != 0.0 and (
                pb_params is None or not pb_params.sampling.HasField("seed")):
                req_params.seed = secrets.randbits(32)
            metrics.observe("tgi_request_max_new_tokens",
                            req_stopping.max_new_tokens)
            out.append(ValidatedRequest(
                input_text=text,
                input_ids=list(ids),
                params=req_params,
                stopping=req_stopping,
                options=options,
                truncated=truncated,
                prefix_id=prefix_id,
                prefix_length=prefix_length,
            ))
        return out
