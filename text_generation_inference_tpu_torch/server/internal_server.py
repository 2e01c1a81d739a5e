"""generate.v1.TextGenerationService, the reference's internal router↔shard
API, over the port's engines (port of the JAX package's
`server/internal_server.py`).

The reference's Rust router speaks this wire surface (reference:
proto/generate.proto; server/text_generation_server/server.py:105-249).
Serving it makes the port a drop-in shard: the router drives the batch
state machine with explicit batch ids. Prefill creates a batch and returns
every request's first token; NextToken takes the surviving batches (their
finished requests named by `completed_ids` deltas), merges them and
advances one token; PruneBatch drops finished requests without generating.

Batch ids map onto engine slots:

  * a batch is a host-side list of requests, each with its slot and detail
    flags: the engine's slot state is the reference's cached Batch (KV
    included), so a merge is a list union and a prune frees slots;
  * NextToken runs one decode step (chunk=1) across all slots and reads
    out the rows of the batches' surviving requests, in the merged
    batches' order. On the card that step is one replay of the engine's
    captured program for (want_details, bucket, 1): the default decode
    chunk is 1, so warmup captures it for both detail flags.

It serves the slot, paged, speculative and seq2seq engines. Where the
port departs from the JAX service (ROADMAP.md, Queue 3):

  * a speculative engine emits up to n_predict + 1 tokens a step: NextToken
    returns each request's accepted tokens in order (the JAX service reads
    the first step only, and drops the rest);
  * ModelInfo's memory coefficients read a T5 spec under the decoder
    spec's names (decoder layers, heads, d_kv, d_model, d_ff), where the
    JAX service raises; `weight_limit` comes from `engine.memory.
    budget_bytes`, which is `CPU_BUDGET_BYTES` on the CPU;
  * an int8 KV cache is refused when the service is built
    (`refuse_int8_kv`): no engine has an int8 write on its single-step
    decode path.

Serve it with `INTERNAL_API=1` (`server/main.py`): the process then serves
generate.v1 instead of fmaas, as a reference shard process does.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

import grpc
import grpc.aio
import numpy as np

from ..config import ServingConfig
from ..engine.engine import EngineDeviceError, RequestParams
from ..pb import generate_pb2 as pb
from ..utils import metrics

logger = logging.getLogger(__name__)

_FULL_NAME = "generate.v1.TextGenerationService"


def refuse_int8_kv(config: ServingConfig) -> None:
    """The internal API decodes one step at a time, and an int8 KV cache is
    written only by the ring chunks' flush: refuse it up front. The JAX
    slot engine fails at the first NextToken; its paged engine writes the
    step's K/V into the int8 pool without scales and reads the codes back
    as values, so its tokens part from the ring-chunk run's at the second
    token."""
    if config.kv_cache_dtype == "int8":
        raise ValueError(
            "INTERNAL_API (generate.v1) decodes one step per NextToken, and "
            "kv_cache_dtype=int8 has no single-step write path (int8 KV is "
            "written by the ring chunks' flush only); unset KV_CACHE_DTYPE")


class _ReqState:
    __slots__ = ("req_id", "slot", "logprobs", "ranks", "top_n")

    def __init__(self, req_id: int, slot: int, logprobs: bool, ranks: bool,
                 top_n: int):
        self.req_id = req_id
        self.slot = slot
        self.logprobs = logprobs
        self.ranks = ranks
        self.top_n = top_n


def _kv_dims(spec) -> tuple[int, int, int, int, int]:
    """(layers, kv heads, head dim, hidden, intermediate) of a decoder spec,
    or of a T5 spec's decoder under the same names."""
    if hasattr(spec, "num_decoder_layers"):
        return (spec.num_decoder_layers, spec.num_heads, spec.d_kv,
                spec.d_model, spec.d_ff)
    return (spec.num_layers, spec.num_kv_heads, spec.head_dim,
            spec.hidden_size, getattr(spec, "intermediate_size", 0))


class InternalTextGenerationService:
    """grpc.aio servicer implementing generate.v1 over an engine."""

    def __init__(self, engine, tokenizer, config: ServingConfig,
                 prompt_cache=None, model_kind: str = "decoder"):
        refuse_int8_kv(config)
        self.engine = engine
        self.tokenizer = tokenizer
        self.config = config
        self.prompt_cache = prompt_cache
        self.model_kind = model_kind
        # the reference's batch cache: batch_id -> its requests, in order
        self.batches: dict[int, list[_ReqState]] = {}
        # engine calls are serialized (the reference shard is a
        # single-threaded asyncio servicer too)
        self._lock = asyncio.Lock()

    # -- helpers -----------------------------------------------------------

    def _request_params(self, p: pb.NextTokenChooserParameters,
                        max_new: int) -> RequestParams:
        lp = p.length_penalty if p.HasField("length_penalty") else None
        return RequestParams(
            temperature=p.temperature,
            top_k=p.top_k,
            top_p=p.top_p if p.top_p else 1.0,
            typical_p=p.typical_p if p.typical_p else 1.0,
            seed=p.seed if p.HasField("seed") else 0,
            repetition_penalty=(p.repetition_penalty
                                if p.HasField("repetition_penalty") else 1.0),
            lp_start=lp.start_index if lp else 0,
            lp_decay=lp.decay_factor if lp else 0.0,
            min_new_tokens=p.min_new_tokens,
            max_new_tokens=max_new,
        )

    def _token_pb(self, rs: _ReqState, step, row: int) -> pb.Token:
        t = pb.Token(request_id=rs.req_id, token_id=int(step.next_ids[row]))
        if rs.logprobs:
            lp = float(step.logprob[row])
            t.logprob = 0.0 if np.isnan(lp) else lp
        if rs.ranks:
            t.rank = int(step.rank[row])
        if rs.top_n:
            n = min(rs.top_n, len(step.top_ids[row]))
            nth = step.top_scores[row][n - 1]
            for i in range(min(len(step.top_ids[row]), 4 * n)):
                if step.top_scores[row][i] < nth \
                        or step.top_scores[row][i] == -np.inf:
                    break
                t.top_tokens.append(pb.TopToken(
                    token_id=int(step.top_ids[row][i]),
                    logprob=float(step.top_logprobs[row][i])))
        return t

    def _apply_status(self, batch_id: int,
                      status: Optional[pb.RequestsStatus]) -> list[_ReqState]:
        """Pop a cached batch, free its completed requests' slots and return
        the survivors in order (the reference's prune)."""
        reqs = self.batches.pop(batch_id, [])
        if status is None:
            return reqs
        done = set(status.completed_ids)
        keep = []
        for rs in reqs:
            if rs.req_id in done:
                self.engine.free(rs.slot)
            else:
                keep.append(rs)
        return keep

    # -- RPCs --------------------------------------------------------------

    async def ServiceDiscovery(self, request, context):
        return pb.ServiceDiscoveryResponse(urls=[])

    async def Health(self, request, context):
        return pb.HealthResponse()

    async def ClearCache(self, request, context):
        async with self._lock:
            for reqs in self.batches.values():
                for rs in reqs:
                    self.engine.free(rs.slot)
            self.batches.clear()
        return pb.ClearCacheResponse()

    async def ModelInfo(self, request, context):
        from ..engine.memory import budget_bytes, tree_bytes

        layers, kv_heads, head_dim, hidden, inter = _kv_dims(self.engine.spec)
        # the JAX service's closed-form memory scaling model (the reference
        # fits it at startup, memory_characterizer.py:496-539):
        #   next-token mem ≈ kv_per_token · b·in + kv_per_token · b·out
        #   prefill mem ≈ act_per_token · b·s (+ a quadratic scores term)
        item = 2  # bf16 activations
        kv_per_token = layers * 2 * kv_heads * head_dim * item
        act_per_token = (hidden * 6 + inter * 2) * item
        score_quad = self.engine.spec.num_heads * 4  # f32 scores per token²
        params_b = tree_bytes(self.engine.model_params)
        free_b = max(0, budget_bytes(self.engine.device) - params_b)
        msm = pb.MemoryScalingModel(
            prefill_linear_coef0=float(act_per_token),
            prefill_quadratic_coef0=float(act_per_token),
            prefill_quadratic_coef1=float(score_quad),
            nexttoken_linear_coef0=float(kv_per_token),
            nexttoken_linear_coef1=float(kv_per_token),
            weight_limit=int(free_b * (1 - self.config.batch_safety_margin)),
        )
        return pb.ModelInfoResponse(
            model_type=(pb.ModelInfoResponse.SEQ2SEQ_LM
                        if self.model_kind == "encoder_decoder"
                        else pb.ModelInfoResponse.CAUSAL_LM),
            eos_token=self.engine.eos_token_id,
            batch_padding=True,   # bucket-padded prefill
            memory_scaling_model=msm,
        )

    async def PrefixLookup(self, request, context):
        if self.prompt_cache is None:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                "no prefix store configured")
        try:
            entry = self.prompt_cache.get_entry(request.prefix_id)
        except Exception as e:  # noqa: BLE001 - surface as NOT_FOUND
            await context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        length = getattr(entry, "length", None)
        if length is None:
            dec = getattr(entry, "decoder", entry)
            length = int(dec.shape[0])
        return pb.PrefixLookupResponse(prefix_length=length)

    async def _guarded(self, what: str, fn, request, context):
        async with self._lock:
            try:
                return await fn(request, context)
            except EngineDeviceError:
                logger.exception("internal %s device failure; reset", what)
                self.batches.clear()
                self.engine.reset()
                await context.abort(grpc.StatusCode.INTERNAL,
                                    "device failure (engine reset)")

    async def Prefill(self, request, context):
        return await self._guarded("Prefill", self._prefill_locked, request,
                                   context)

    async def _prefill_locked(self, request, context):
        batch = request.batch
        for cached in request.to_prune:
            survivors = self._apply_status(
                cached.batch_id,
                cached.status if cached.HasField("status") else None)
            if survivors:
                self.batches[cached.batch_id] = survivors
        t0 = time.monotonic_ns()
        reqs = list(batch.requests)
        if not reqs:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                "empty batch")
        token_ids = []
        states: list[_ReqState] = []
        params: list[RequestParams] = []
        prefix_embeds = []
        any_prefix = False
        for r in reqs:
            ids = self.tokenizer.encode(r.inputs)
            if r.truncate and len(ids) > r.input_length:
                ids = ids[len(ids) - r.input_length:]  # keep the tail
            slot = self.engine.acquire_slot()
            if slot is None:
                for rs in states:
                    self.engine.free(rs.slot)
                await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                                    "no free slots")
            d = r.details
            states.append(_ReqState(r.id, slot, d.logprobs, d.ranks,
                                    d.top_n_toks))
            token_ids.append(ids)
            params.append(self._request_params(r.parameters,
                                               r.max_output_length))
            pe = None
            if r.prefix_id and self.prompt_cache is not None:
                pe = self.prompt_cache.get_entry(r.prefix_id)
                any_prefix = True
            prefix_embeds.append(pe)
        want_input = any(r.details.input_toks for r in reqs)
        result = self.engine.prefill(
            [rs.slot for rs in states], token_ids, params,
            want_prompt_details=want_input,
            prefix_embeds=prefix_embeds if any_prefix else None)
        self.batches[batch.id] = states
        metrics.increment("tgi_batch_inference_count", method="prefill")

        out = pb.PrefillResponse(result=pb.GenerateResult(
            batch_id=batch.id,
            forward_time_ns=self.engine.last_forward_ns or
            (time.monotonic_ns() - t0)))
        for i, rs in enumerate(states):
            out.result.output_tokens.append(
                self._token_pb(rs, result.first_token, i))
        if want_input and result.prompt_details is not None:
            for i, (r, rs) in enumerate(zip(reqs, states)):
                if not r.details.input_toks:
                    continue
                d = result.prompt_details[i]
                it = pb.InputTokens(request_id=rs.req_id)
                for j in range(len(d["logprob"])):
                    tok = pb.Token(request_id=rs.req_id,
                                   token_id=int(token_ids[i][j]))
                    if rs.logprobs:
                        lp = float(d["logprob"][j])
                        tok.logprob = 0.0 if np.isnan(lp) else lp
                    if rs.ranks:
                        tok.rank = int(d["rank"][j])
                    it.tokens.append(tok)
                out.input_tokens.append(it)
        return out

    async def NextToken(self, request, context):
        return await self._guarded("NextToken", self._next_token_locked,
                                   request, context)

    async def _next_token_locked(self, request, context):
        merged: list[_ReqState] = []
        first_id = None
        for cached in request.batches:
            survivors = self._apply_status(
                cached.batch_id,
                cached.status if cached.HasField("status") else None)
            if survivors and first_id is None:
                first_id = cached.batch_id
            merged.extend(survivors)
        if not merged:
            return pb.NextTokenResponse()
        if self.batches:
            # the engine advances every active slot each step, so a call
            # that leaves out a live batch would advance it unseen; the
            # reference router always passes every live batch
            stale = sorted(self.batches)
            self.batches[first_id] = merged   # restore before aborting
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"NextToken must include every live batch; missing {stale}")
        want = any(rs.logprobs or rs.ranks or rs.top_n for rs in merged)
        steps = self.engine.decode_steps(want_details=want, chunk=1)
        # a speculative step: slot s's first n_emit[s] rows are its tokens
        n_emit = getattr(self.engine, "last_n_emitted", None)
        self.batches[first_id] = merged
        metrics.increment("tgi_batch_inference_count", method="next_token")
        result = pb.GenerateResult(
            batch_id=first_id, forward_time_ns=self.engine.last_forward_ns)
        for rs in merged:
            n = 1 if n_emit is None else max(1, int(n_emit[rs.slot]))
            for step in steps[:n]:
                result.output_tokens.append(self._token_pb(rs, step, rs.slot))
        return pb.NextTokenResponse(result=result)

    async def PruneBatch(self, request, context):
        async with self._lock:
            cached = request.batch
            survivors = self._apply_status(
                cached.batch_id,
                cached.status if cached.HasField("status") else None)
            if not survivors:
                return pb.PruneBatchResponse()
            self.batches[cached.batch_id] = survivors
            return pb.PruneBatchResponse(batch_id=cached.batch_id)


def _add_servicer(server, servicer) -> None:
    """Register without generated service stubs (the raw-handler style of
    `server/grpc_server.py`)."""
    rpcs = {
        "ServiceDiscovery": (pb.ServiceDiscoveryRequest,
                             pb.ServiceDiscoveryResponse),
        "ClearCache": (pb.ClearCacheRequest, pb.ClearCacheResponse),
        "ModelInfo": (pb.ModelInfoRequest, pb.ModelInfoResponse),
        "Prefill": (pb.PrefillRequest, pb.PrefillResponse),
        "NextToken": (pb.NextTokenRequest, pb.NextTokenResponse),
        "PruneBatch": (pb.PruneBatchRequest, pb.PruneBatchResponse),
        "PrefixLookup": (pb.PrefixLookupRequest, pb.PrefixLookupResponse),
        "Health": (pb.HealthRequest, pb.HealthResponse),
    }
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            getattr(servicer, name),
            request_deserializer=req.FromString,
            response_serializer=resp.SerializeToString)
        for name, (req, resp) in rpcs.items()
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(_FULL_NAME, handlers),))


async def serve_internal_grpc(servicer: InternalTextGenerationService,
                              config: ServingConfig) -> grpc.aio.Server:
    """Start a grpc.aio server for `servicer` on `config.uds_path` (a unix
    socket) or, without one, on `config.grpc_port`."""
    server = grpc.aio.server()
    _add_servicer(server, servicer)
    if config.uds_path:
        addr = f"unix://{config.uds_path}"
    else:
        addr = f"[::]:{config.grpc_port}"
    server.add_insecure_port(addr)
    await server.start()
    logger.info("generate.v1 internal API listening on %s", addr)
    return server
