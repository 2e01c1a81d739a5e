"""fmaas.GenerationService on grpc.aio.

Implements the reference's external gRPC API surface (reference:
router/src/grpc_server.rs): batched unary Generate, server-streaming
GenerateStream with on-cancel cleanup, Tokenize with tokens/offsets, and
ModelInfo. Service wiring uses explicit generic method handlers (the
environment ships no grpc python codegen plugin; the surface is 4 methods).
"""

from __future__ import annotations

import asyncio
import logging
import time

import grpc

from ..config import ServingConfig
from ..pb import generation_pb2 as pb
from ..scheduler.batcher import Batcher, QueueFullError
from ..scheduler.request import GenRequest, StopReason, TokenRecord
from ..utils import metrics, tracing
from ..utils.tokenization import AsyncTokenizer, ServingTokenizer
from .validation import Validation, ValidationError

logger = logging.getLogger(__name__)

SERVICE_NAME = "fmaas.GenerationService"


class GenerationServicer:
    def __init__(
        self,
        config: ServingConfig,
        tokenizer: ServingTokenizer,
        batcher: Batcher,
        model_kind: str = "decoder",
    ):
        self.config = config
        self.tokenizer = tokenizer
        self.async_tokenizer = AsyncTokenizer(tokenizer, config.tokenizer_threads)
        self.batcher = batcher
        self.validation = Validation(tokenizer, config,
                                     prompt_cache=batcher.prompt_cache)
        self.model_kind = model_kind

    # -- helpers ------------------------------------------------------------

    async def _validate(self, params, texts, prefix_id, context):
        loop = asyncio.get_running_loop()
        t0 = time.monotonic()
        try:
            out = await loop.run_in_executor(
                self.async_tokenizer._pool,
                self.validation.validate, params, texts, prefix_id)
            metrics.observe("tgi_request_validation_duration",
                            time.monotonic() - t0)
            return out
        except ValidationError as e:
            metrics.increment("tgi_request_failure", reason="validation")
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))

    def _token_info(self, rec: TokenRecord) -> pb.TokenInfo:
        info = pb.TokenInfo(text=self.tokenizer.id_to_token(rec.token_id))
        if rec.logprob == rec.logprob:  # not NaN
            info.logprob = rec.logprob
        else:
            info.logprob = float("nan")
        if rec.rank:
            info.rank = rec.rank
        for tid, lp in rec.top_tokens:
            info.top_tokens.append(pb.TokenInfo.TopToken(
                text=self.tokenizer.id_to_token(tid), logprob=lp))
        return info

    def _log_response(self, req: GenRequest, kind: str,
                      rpc_start: float) -> None:
        """Per-request response log with the timing breakdown the reference
        records (reference: grpc_server.rs:442-514 log_response):
        validation = arrival - rpc start, queue = prefill - arrival,
        inference = finish - prefill."""
        now = req.end_time or time.monotonic()
        total_s = now - rpc_start
        validation_s = max(req.queue_time - rpc_start, 0.0)
        if req.start_time is not None:
            queue_s = req.start_time - req.queue_time
            inference_s = (req.end_time or now) - req.start_time
        else:
            queue_s = (req.end_time or now) - req.queue_time
            inference_s = 0.0
        tpt_s = inference_s / req.generated_count if req.generated_count else 0.0
        out = req.final_text()
        reason = req.stop_reason
        line = (
            f"{kind} request #{req.id} generated {req.generated_count} "
            f"tokens before {reason.name}, output {len(out.encode())} bytes: "
            f"{out[:32]!r} | input_toks={req.input_length} "
            f"validation={validation_s * 1e3:.1f}ms queue={queue_s * 1e3:.1f}ms "
            f"inference={inference_s * 1e3:.1f}ms "
            f"time_per_token={tpt_s * 1e3:.1f}ms total={total_s * 1e3:.1f}ms")
        if reason == StopReason.ERROR:
            logger.error(line)
        elif reason in (StopReason.CANCELLED, StopReason.TOKEN_LIMIT):
            logger.warning(line)
        else:
            logger.info(line)

    def _final_response(self, req: GenRequest) -> pb.GenerationResponse:
        resp = pb.GenerationResponse(
            input_token_count=req.input_length,
            generated_token_count=req.generated_count,
            text=req.final_text(),
            stop_reason=int(req.stop_reason),
        )
        if req.stop_reason == StopReason.STOP_SEQUENCE and req.matched_stop:
            resp.stop_sequence = req.matched_stop[0]
        if req.params.temperature != 0.0:
            resp.seed = req.params.seed
        if req.options.generated_tokens:
            resp.tokens.extend(self._token_info(r) for r in req.generated)
        if req.options.input_tokens:
            resp.input_tokens.extend(
                self._token_info(r) for r in req.input_token_records)
        return resp

    # -- RPCs ---------------------------------------------------------------

    async def Generate(self, request: pb.BatchedGenerationRequest,
                       context) -> pb.BatchedGenerationResponse:
        start = time.monotonic()
        otel_ctx = tracing.context_from_grpc_metadata(
            context.invocation_metadata())
        if not request.requests:
            return pb.BatchedGenerationResponse()
        if len(request.requests) > self.config.max_batch_size:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"batch size must be <= {self.config.max_batch_size}")
        texts = [r.text for r in request.requests]
        kind = "batch" if len(request.requests) > 1 else "single"
        validated = await self._validate(
            request.params, texts, request.prefix_id or None, context)
        metrics.increment("tgi_request_count", kind=kind)
        metrics.increment("tgi_request_input_count", len(validated))

        reqs = [
            GenRequest(
                input_text=v.input_text, input_ids=v.input_ids,
                params=v.params, stopping=v.stopping, options=v.options,
                prefix_id=v.prefix_id, prefix_length=v.prefix_length,
                streaming=False, truncated=v.truncated)
            for v in validated
        ]
        try:
            # all-or-nothing: capacity reserved for the whole batch upfront
            self.batcher.submit_all(reqs)
        except QueueFullError as e:
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))

        try:
            await asyncio.gather(*(self._await_request(r) for r in reqs))
        except asyncio.CancelledError:
            for r in reqs:
                r.cancelled = True
            raise
        for r in reqs:
            if r.stop_reason == StopReason.ERROR:
                metrics.increment("tgi_request_failure", reason="generate")
                await context.abort(grpc.StatusCode.INTERNAL,
                                    r.error or "generation failed")
        duration = time.monotonic() - start
        metrics.observe("tgi_request_duration", duration)
        for r in reqs:
            metrics.increment("tgi_request_success", kind=kind,
                              stop_reason=r.stop_reason.name)
            self._log_response(r, kind, start)
        with tracing.span("fmaas.Generate", context=otel_ctx,
                          batch_size=len(reqs)) as s:
            tracing.record(
                s, total_time_s=duration,
                generated_tokens=sum(r.generated_count for r in reqs))
        return pb.BatchedGenerationResponse(
            responses=[self._final_response(r) for r in reqs])

    async def _await_request(self, req: GenRequest):
        # submit_all attaches the future synchronously (batcher.py
        # submit_all -> attach_loop), so it is always present here —
        # no polling (round-2 review: 1ms poll loops were O(batch)
        # event-loop wakeups per ms under load)
        await req.result_future

    async def GenerateStream(self, request: pb.SingleGenerationRequest, context):
        start = time.monotonic()
        otel_ctx = tracing.context_from_grpc_metadata(
            context.invocation_metadata())
        validated = await self._validate(
            request.params, [request.request.text],
            request.prefix_id or None, context)
        v = validated[0]
        metrics.increment("tgi_request_count", kind="stream")
        metrics.increment("tgi_request_input_count")
        req = GenRequest(
            input_text=v.input_text, input_ids=v.input_ids,
            params=v.params, stopping=v.stopping, options=v.options,
            prefix_id=v.prefix_id, prefix_length=v.prefix_length,
            streaming=True, truncated=v.truncated)
        try:
            self.batcher.submit(req)
        except QueueFullError as e:
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))

        # first message: input token count (+ input text if requested),
        # mirroring reference batcher.rs:200-212
        first = pb.GenerationResponse(input_token_count=req.input_length)
        if req.options.input_text:
            first.text = req.input_text
        if req.params.temperature != 0.0:
            first.seed = req.params.seed
        yield first

        token_count = 0
        try:
            while True:
                # stream_queue attached synchronously by submit()
                event = await req.stream_queue.get()
                kind = event[0]
                if kind == "input_tokens":
                    msg = pb.GenerationResponse()
                    msg.input_tokens.extend(
                        self._token_info(r) for r in event[1])
                    yield msg
                elif kind == "token":
                    _, rec, text = event
                    token_count += 1
                    msg = pb.GenerationResponse(
                        generated_token_count=token_count, text=text,
                        stop_reason=int(StopReason.NOT_FINISHED))
                    if req.options.generated_tokens:
                        msg.tokens.append(self._token_info(rec))
                    if text or msg.tokens:
                        yield msg
                elif kind == "final":
                    _, rec, text, stop_reason = event
                    if stop_reason == StopReason.ERROR:
                        metrics.increment("tgi_request_failure", reason="generate_stream")
                        await context.abort(grpc.StatusCode.INTERNAL,
                                            req.error or "generation failed")
                    token_count = req.generated_count
                    msg = pb.GenerationResponse(
                        generated_token_count=token_count, text=text,
                        stop_reason=int(stop_reason))
                    if stop_reason == StopReason.STOP_SEQUENCE and req.matched_stop:
                        msg.stop_sequence = req.matched_stop[0]
                    if req.options.generated_tokens and rec is not None:
                        msg.tokens.append(self._token_info(rec))
                    yield msg
                    duration = time.monotonic() - start
                    metrics.observe("tgi_request_duration", duration)
                    metrics.increment("tgi_request_success", kind="stream",
                                      stop_reason=stop_reason.name)
                    self._log_response(req, "stream", start)
                    with tracing.span("fmaas.GenerateStream",
                                      context=otel_ctx) as s:
                        tracing.record(
                            s, total_time_s=duration,
                            generated_tokens=req.generated_count,
                            input_tokens=req.input_length,
                            stop_reason=stop_reason.name)
                    return
        except asyncio.CancelledError:
            req.cancelled = True
            metrics.increment("tgi_request_cancelled")
            raise

    async def Tokenize(self, request: pb.BatchedTokenizeRequest,
                       context) -> pb.BatchedTokenizeResponse:
        t0 = time.monotonic()
        # batch of n counts as 1 request, n inputs (reference metrics table)
        metrics.increment("tgi_tokenize_request_count")
        metrics.increment("tgi_tokenize_request_input_count",
                          len(request.requests))
        responses = []
        total_tokens = 0
        for r in request.requests:
            enc = await self.async_tokenizer.encode_full(r.text)
            ids = enc.ids
            tokens = enc.tokens
            offsets = enc.offsets
            if request.truncate_input_tokens and \
                    request.truncate_input_tokens < len(ids):
                keep = request.truncate_input_tokens
                ids = ids[-keep:]
                tokens = tokens[-keep:]
                offsets = offsets[-keep:]
            total_tokens += len(ids)
            resp = pb.TokenizeResponse(token_count=len(ids))
            if request.return_tokens:
                resp.tokens.extend(tokens)
                if request.return_offsets:
                    resp.offsets.extend(
                        pb.TokenizeResponse.Offset(start=s, end=e)
                        for s, e in offsets)
            responses.append(resp)
        metrics.observe("tgi_tokenize_request_tokens", total_tokens)
        metrics.observe("tgi_tokenize_request_duration",
                        time.monotonic() - t0)
        return pb.BatchedTokenizeResponse(responses=responses)

    async def ModelInfo(self, request: pb.ModelInfoRequest,
                        context) -> pb.ModelInfoResponse:
        kind = (pb.ModelInfoResponse.ModelKind.ENCODER_DECODER
                if self.model_kind == "encoder_decoder"
                else pb.ModelInfoResponse.ModelKind.DECODER_ONLY)
        return pb.ModelInfoResponse(
            model_kind=kind,
            max_sequence_length=self.config.max_sequence_length,
            max_new_tokens=self.config.max_new_tokens,
        )


def make_handler(servicer: GenerationServicer) -> grpc.GenericRpcHandler:
    methods = {
        "Generate": grpc.unary_unary_rpc_method_handler(
            servicer.Generate,
            request_deserializer=pb.BatchedGenerationRequest.FromString,
            response_serializer=pb.BatchedGenerationResponse.SerializeToString),
        "GenerateStream": grpc.unary_stream_rpc_method_handler(
            servicer.GenerateStream,
            request_deserializer=pb.SingleGenerationRequest.FromString,
            response_serializer=pb.GenerationResponse.SerializeToString),
        "Tokenize": grpc.unary_unary_rpc_method_handler(
            servicer.Tokenize,
            request_deserializer=pb.BatchedTokenizeRequest.FromString,
            response_serializer=pb.BatchedTokenizeResponse.SerializeToString),
        "ModelInfo": grpc.unary_unary_rpc_method_handler(
            servicer.ModelInfo,
            request_deserializer=pb.ModelInfoRequest.FromString,
            response_serializer=pb.ModelInfoResponse.SerializeToString),
    }
    return grpc.method_handlers_generic_handler(SERVICE_NAME, methods)


async def serve_grpc(servicer: GenerationServicer,
                     config: ServingConfig) -> grpc.aio.Server:
    server = grpc.aio.server()
    server.add_generic_rpc_handlers((make_handler(servicer),))
    if config.uds_path:
        address = f"unix://{config.uds_path}"
    else:
        address = f"[::]:{config.grpc_port}"
    if config.tls_cert_path and config.tls_key_path:
        creds = grpc.ssl_server_credentials([(
            open(config.tls_key_path, "rb").read(),
            open(config.tls_cert_path, "rb").read())])
        server.add_secure_port(address, creds)
    else:
        server.add_insecure_port(address)
    await server.start()
    logger.info("gRPC server listening on %s", address)
    return server
