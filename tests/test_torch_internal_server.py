"""The port's generate.v1 internal API (`server/internal_server.py`, the
reference's router↔shard surface) against the JAX package's, on the CPU.

The same request sequences, the scenarios of tests/test_internal_server.py
(the prefill and next-token loop with `completed_ids` deltas, add-on
merges, PruneBatch and ClearCache, input tokens, logprobs, ranks and
top-n, truncation, the "must include every live batch" abort, prefix
lookup and a soft-prompted prefill, the admin RPCs), go to the JAX
service over the JAX slot engine (fp32 served fixture, one engine for
every scenario) and to the port's service over its slot and paged engines,
through a `FakeContext`. The responses must agree field by field: ids,
ranks and flags exactly, logprobs within 5e-4 (the repo's golden
tolerance), `forward_time_ns` aside. ModelInfo's coefficients are equal,
and so is `weight_limit` here: on the CPU both budgets are 16 GiB.

Beyond the JAX tests: one round trip over a real grpc.aio server on
localhost, the entrypoint serving generate.v1 instead of fmaas, the
speculative engines (a speculative step's accepted tokens all reach the
response, in order, and equal the plain engine's greedy tokens), the
seq2seq engine, the int8-KV refusal, and both packages' `generate_pb2`
in one process.
"""

import asyncio
import os
import signal
import socket

import grpc
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from google.protobuf import json_format

from tests import fixtures
from text_generation_inference_tpu.config import ServingConfig as JConfig
from text_generation_inference_tpu.engine.engine import (
    InferenceEngine as JEngine)
from text_generation_inference_tpu.models import families as jfamilies
from text_generation_inference_tpu.pb import generate_pb2 as jpb
from text_generation_inference_tpu.server.internal_server import (
    InternalTextGenerationService as JService)
from text_generation_inference_tpu.utils.prompt_cache import (
    PrefixCache as JPrefixCache)
from text_generation_inference_tpu.utils.tokenization import (
    ServingTokenizer as JTokenizer)
from text_generation_inference_tpu_torch.config import ServingConfig
from text_generation_inference_tpu_torch.engine.engine import (
    InferenceEngine, RequestParams)
from text_generation_inference_tpu_torch.engine.paged_engine import (
    PagedInferenceEngine)
from text_generation_inference_tpu_torch.models import families
from text_generation_inference_tpu_torch.pb import generate_pb2 as pb
from text_generation_inference_tpu_torch.server import internal_server
from text_generation_inference_tpu_torch.server.internal_server import (
    InternalTextGenerationService, serve_internal_grpc)
from text_generation_inference_tpu_torch.utils.prompt_cache import PrefixCache
from text_generation_inference_tpu_torch.utils.tokenization import (
    ServingTokenizer)

LOGPROB_TOL = 5e-4
DIM = 64          # the served fixture's hidden size


class AbortError(Exception):
    def __init__(self, code, details):
        super().__init__(details)
        self.code, self.details = code, details


class FakeContext:
    async def abort(self, code, details):
        raise AbortError(code, details)


def make_config(cls, **kw):
    cfg = cls(max_sequence_length=64, max_new_tokens=32, max_batch_slots=4,
              prefill_buckets=[8, 16, 32], decode_chunk=1, **kw)
    cfg.validate()
    return cfg


@pytest.fixture(scope="module")
def prefix_store(tmp_path_factory):
    store = tmp_path_factory.mktemp("prefixes")
    (store / "pfx").mkdir()
    arr = np.random.default_rng(3).normal(size=(3, DIM)).astype(np.float32)
    torch.save(torch.tensor(arr) * 0.05, store / "pfx" / "decoder.pt")
    return str(store)


@pytest.fixture(scope="module")
def jax_side(prefix_store):
    model_dir = fixtures.tokenized_model_dir()
    spec, params = jfamilies.load_model(model_dir, dtype=jnp.float32)
    engine = JEngine(spec, params, make_config(JConfig), eos_token_id=2)
    return (engine, JTokenizer.load(model_dir),
            JPrefixCache(prefix_store, embed_dim=DIM))


@pytest.fixture(scope="module")
def port_model():
    model_dir = fixtures.tokenized_model_dir()
    spec, params = families.load_model(model_dir, dtype=torch.float32,
                                       device="cpu")
    return spec, params, ServingTokenizer.load(model_dir)


def port_engine(port_model, kind, **kw):
    spec, params, _ = port_model
    if kind == "slot":
        return InferenceEngine(spec, params, make_config(ServingConfig, **kw),
                               eos_token_id=2, device="cpu")
    return PagedInferenceEngine(spec, params, make_config(ServingConfig, **kw),
                                eos_token_id=2, device="cpu")


@pytest.fixture(scope="module")
def port_engines(port_model):
    return {kind: port_engine(port_model, kind) for kind in ("slot", "paged")}


# --- the scenarios ------------------------------------------------------------


def mkreq(m, rid, text, max_out=8, logprobs=False, input_toks=False, top_n=0,
          prefix_id="", **params):
    return m.Request(
        id=rid, inputs=text, max_output_length=max_out, prefix_id=prefix_id,
        parameters=m.NextTokenChooserParameters(**params),
        details=m.RequestedDetails(logprobs=logprobs, ranks=logprobs,
                                   input_toks=input_toks, top_n_toks=top_n))


def prefill_req(m, batch_id, reqs, to_prune=()):
    return m.PrefillRequest(batch=m.Batch(id=batch_id, requests=reqs),
                            to_prune=list(to_prune))


def cached(m, batch_id, completed=()):
    return m.CachedBatch(batch_id=batch_id,
                         status=m.RequestsStatus(completed_ids=list(completed)))


def next_token(m, *batches):
    return m.NextTokenRequest(batches=list(batches))


def sc_single_stream(m):
    yield "Prefill", prefill_req(m, 1, [mkreq(m, 10, "hello world this is")])
    for _ in range(7):
        yield "NextToken", next_token(m, cached(m, 1))


def sc_addon_merge_and_prune(m):
    yield "Prefill", prefill_req(m, 1, [mkreq(m, 100, "the quick brown")])
    for _ in range(2):
        yield "NextToken", next_token(m, cached(m, 1))
    yield "Prefill", prefill_req(m, 2, [mkreq(m, 200, "testing one two", 6)])
    yield "NextToken", next_token(m, cached(m, 1), cached(m, 2))
    for _ in range(4):
        yield "NextToken", next_token(m, cached(m, 1))
    yield "NextToken", next_token(m, cached(m, 1, [100]))
    # a prefill that prunes the cached batch on the way in
    yield "Prefill", prefill_req(m, 3, [mkreq(m, 300, "a b c d", 4)],
                                 to_prune=[cached(m, 1, [200])])
    yield "NextToken", next_token(m, cached(m, 3))


def sc_prune_batch(m):
    yield "Prefill", prefill_req(m, 7, [mkreq(m, 1, "a b", 4),
                                        mkreq(m, 2, "c d", 4)])
    yield "PruneBatch", m.PruneBatchRequest(batch=cached(m, 7, [1]))
    yield "NextToken", next_token(m, cached(m, 7))
    yield "PruneBatch", m.PruneBatchRequest(batch=cached(m, 7, [2]))
    yield "NextToken", next_token(m, cached(m, 7))


def sc_requires_all_live_batches(m):
    yield "Prefill", prefill_req(m, 1, [mkreq(m, 1, "a b", 4)])
    yield "Prefill", prefill_req(m, 2, [mkreq(m, 2, "c d", 4)])
    yield "NextToken", next_token(m, cached(m, 1))
    yield "NextToken", next_token(m, cached(m, 1), cached(m, 2))


def sc_details_and_input_tokens(m):
    yield "Prefill", prefill_req(m, 1, [
        mkreq(m, 5, "hello world", 6, logprobs=True, input_toks=True,
              top_n=2),
        mkreq(m, 6, "the lazy dog", 6, top_n=3),
        mkreq(m, 7, "one two", 6)])
    for _ in range(3):
        yield "NextToken", next_token(m, cached(m, 1))
    # a batch without details takes the no-details program
    yield "NextToken", next_token(m, cached(m, 1, [5, 6]))


def sc_truncation_keeps_tail(m):
    yield "Prefill", prefill_req(m, 1, [m.Request(
        id=1, inputs="hello world this is a test of the tokenizer",
        input_length=3, truncate=True, max_output_length=4,
        parameters=m.NextTokenChooserParameters(),
        details=m.RequestedDetails(logprobs=True, input_toks=True))])
    yield "NextToken", next_token(m, cached(m, 1))


def sc_prefix(m):
    yield "PrefixLookup", m.PrefixLookupRequest(prefix_id="pfx")
    yield "PrefixLookup", m.PrefixLookupRequest(prefix_id="missing")
    yield "Prefill", prefill_req(m, 1, [
        mkreq(m, 1, "hello world", 5, prefix_id="pfx"),
        mkreq(m, 2, "hello world", 5)])
    for _ in range(4):
        yield "NextToken", next_token(m, cached(m, 1))


def sc_admin(m):
    yield "Health", m.HealthRequest()
    yield "ServiceDiscovery", m.ServiceDiscoveryRequest()
    yield "ModelInfo", m.ModelInfoRequest()
    yield "Prefill", prefill_req(m, 1, [mkreq(m, 1, "a b", 4)])
    yield "ClearCache", m.ClearCacheRequest()
    yield "NextToken", next_token(m, cached(m, 1))
    yield "Prefill", prefill_req(m, 2, [])


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_single_stream, sc_addon_merge_and_prune, sc_prune_batch,
    sc_requires_all_live_batches, sc_details_and_input_tokens,
    sc_truncation_keeps_tail, sc_prefix, sc_admin)}


def drive(svc, scenario, m) -> list:
    """Run a scenario through a service; each step's response as a dict (or
    its abort's code and message). Ends with a ClearCache, so the engine
    is free for the next scenario."""
    ctx = FakeContext()

    async def go():
        out = []
        for rpc, req in scenario(m):
            try:
                resp = await getattr(svc, rpc)(req, ctx)
                out.append((rpc, json_format.MessageToDict(
                    resp, preserving_proto_field_name=True)))
            except AbortError as e:
                out.append((rpc, ("abort", e.code, e.details)))
        await svc.ClearCache(m.ClearCacheRequest(), ctx)
        return out

    return asyncio.run(go())


@pytest.fixture(scope="module")
def jax_results(jax_side):
    engine, tok, prompt_cache = jax_side
    results = {}
    for name, scenario in SCENARIOS.items():
        svc = JService(engine, tok, make_config(JConfig),
                       prompt_cache=prompt_cache)
        results[name] = drive(svc, scenario, jpb)
        assert engine.num_active == 0
    return results


def assert_same(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            if k != "forward_time_ns":
                assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= LOGPROB_TOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("engine", ["slot", "paged"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scenario_matches_jax(port_model, port_engines, prefix_store,
                              jax_results, scenario, engine):
    _, _, tok = port_model
    eng = port_engines[engine]
    svc = InternalTextGenerationService(
        eng, tok, make_config(ServingConfig),
        prompt_cache=PrefixCache(prefix_store, embed_dim=DIM))
    got = drive(svc, SCENARIOS[scenario], pb)
    want = jax_results[scenario]
    assert_same(got, want)
    assert eng.num_active == 0 and svc.batches == {}
    # the scenarios reach what they are about
    flat = repr(want)
    marks = {"requires_all_live_batches": "every live batch",
             "prefix": "NOT_FOUND", "admin": "empty batch",
             "details_and_input_tokens": "top_tokens",
             "truncation_keeps_tail": "input_tokens"}
    assert marks.get(scenario, "output_tokens") in flat


def test_no_prefix_store_aborts(port_engines, port_model):
    svc = InternalTextGenerationService(port_engines["slot"], port_model[2],
                                        make_config(ServingConfig))
    with pytest.raises(AbortError) as e:
        asyncio.run(svc.PrefixLookup(pb.PrefixLookupRequest(prefix_id="x"),
                                     FakeContext()))
    assert e.value.code == grpc.StatusCode.INVALID_ARGUMENT


# --- other engines ------------------------------------------------------------


def greedy_tokens(svc, texts, n_next):
    """Prefill every text as one batch, then n_next NextTokens; returns each
    request's tokens in order."""
    ctx = FakeContext()

    async def go():
        r = await svc.Prefill(prefill_req(pb, 1, [
            mkreq(pb, i + 1, t, 40, logprobs=True)
            for i, t in enumerate(texts)]), ctx)
        toks = {t.request_id: [t.token_id] for t in r.result.output_tokens}
        for _ in range(n_next):
            r = await svc.NextToken(next_token(pb, cached(pb, 1)), ctx)
            for t in r.result.output_tokens:
                toks[t.request_id].append(t.token_id)
        await svc.ClearCache(pb.ClearCacheRequest(), ctx)
        return toks

    return asyncio.run(go())


TEXTS = ["hello world this is", "the quick brown fox"]


@pytest.mark.parametrize("paged", [False, True])
def test_speculative_engine_emits_every_accepted_token(port_model, paged,
                                                       monkeypatch):
    from text_generation_inference_tpu_torch.engine.speculative import (
        PagedSpeculativeEngine, SpeculativeEngine)
    from text_generation_inference_tpu_torch.models import speculator

    spec, params, tok = port_model
    cfg = make_config(ServingConfig)
    plain = greedy_tokens(InternalTextGenerationService(
        port_engine(port_model, "paged" if paged else "slot"), tok, cfg),
        TEXTS, 9)
    cls = PagedSpeculativeEngine if paged else SpeculativeEngine
    eng = cls(spec, params, cfg, eos_token_id=2, n_predict=2, device="cpu")
    svc = InternalTextGenerationService(eng, tok, cfg)
    # an oracle speculator: each slot drafts the plain engine's greedy
    # continuation (slot s, with gen_count g, drafts continuation[g:g + K]),
    # so every draft is accepted and a step emits n_predict + 1 tokens
    continuation = {}

    def propose(sspec, sparams, hidden, first_token):
        gen = eng.state.gen_count.tolist()
        rows = [(continuation.get(s, []) + [0] * 64)[g:g + sspec.n_predict]
                for s, g in enumerate(gen)]
        return torch.tensor(rows, dtype=torch.int32)

    monkeypatch.setattr(speculator, "propose", propose)
    ctx = FakeContext()

    async def go():
        r = await svc.Prefill(prefill_req(pb, 1, [
            mkreq(pb, i + 1, t, 40) for i, t in enumerate(TEXTS)]), ctx)
        toks = {t.request_id: [t.token_id] for t in r.result.output_tokens}
        continuation.update((rs.slot, plain[rs.req_id])
                            for rs in svc.batches[1])
        per_step = []
        for _ in range(3):
            r = await svc.NextToken(next_token(pb, cached(pb, 1)), ctx)
            per_step.append(len(r.result.output_tokens))
            for t in r.result.output_tokens:
                toks[t.request_id].append(t.token_id)
        return toks, per_step

    got, per_step = asyncio.run(go())
    # every accepted token reached the response, in order: 3 a request
    assert per_step == [6, 6, 6]
    for rid, toks in got.items():
        assert toks == plain[rid], rid


def test_seq2seq_engine(tmp_path):
    from text_generation_inference_tpu_torch.engine.seq2seq import (
        Seq2SeqEngine)
    from text_generation_inference_tpu_torch.models import t5
    from text_generation_inference_tpu_torch.utils.weights import Weights

    model_dir = fixtures.golden_t5_dir()
    hf = families.load_hf_config(model_dir)
    spec = t5.spec_from_hf_config(hf)
    params = t5.load_params(Weights(model_dir), spec, torch.float32, "cpu")
    tok = ServingTokenizer.load(model_dir)
    cfg = make_config(ServingConfig)
    eng = Seq2SeqEngine(spec, params, cfg, eos_token_id=tok.eos_token_id,
                        device="cpu")
    svc = InternalTextGenerationService(eng, tok, cfg,
                                        model_kind="encoder_decoder")
    info = asyncio.run(svc.ModelInfo(pb.ModelInfoRequest(), FakeContext()))
    assert info.model_type == pb.ModelInfoResponse.SEQ2SEQ_LM
    kv = spec.num_decoder_layers * 2 * spec.num_heads * spec.d_kv * 2
    assert info.memory_scaling_model.nexttoken_linear_coef0 == kv
    got = greedy_tokens(svc, TEXTS, 4)
    # the oracle: the engine driven directly, one request at a time
    for rid, text in enumerate(TEXTS, start=1):
        s = eng.acquire_slot()
        res = eng.prefill([s], [tok.encode(text)],
                          [RequestParams(max_new_tokens=40)])
        want = [int(res.first_token.next_ids[0])]
        while len(want) < 5:
            want.append(int(eng.decode_steps(chunk=1)[0].next_ids[s]))
        eng.free(s)
        assert got[rid] == want, rid


def test_int8_kv_is_refused(port_model, monkeypatch):
    _, _, tok = port_model
    cfg = make_config(ServingConfig, kv_cache_dtype="int8",
                      decode_write_mode="ring", stream_decode_chunk=0)
    cfg.decode_chunk = 4
    with pytest.raises(ValueError, match="single-step"):
        InternalTextGenerationService(object(), tok, cfg)
    from text_generation_inference_tpu_torch.server import main

    monkeypatch.setenv("INTERNAL_API", "1")
    with pytest.raises(ValueError, match="single-step"):
        main.build_engine(cfg, device="cpu")
    # no refusal without the internal API, nor for a float cache
    monkeypatch.delenv("INTERNAL_API")
    assert not main.internal_api()
    internal_server.refuse_int8_kv(make_config(ServingConfig))


# --- the wire -----------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_grpc_roundtrip(port_engines, port_model, jax_results):
    """Prefill + NextToken over a real socket (the surface the reference's
    Rust router dials)."""
    _, _, tok = port_model
    cfg = make_config(ServingConfig, grpc_port=free_port())

    async def go():
        svc = InternalTextGenerationService(port_engines["slot"], tok, cfg)
        server = await serve_internal_grpc(svc, cfg)
        try:
            async with grpc.aio.insecure_channel(
                    f"localhost:{cfg.grpc_port}") as ch:
                def rpc(name, req, resp):
                    return ch.unary_unary(
                        f"/generate.v1.TextGenerationService/{name}",
                        request_serializer=req.SerializeToString,
                        response_deserializer=resp.FromString)
                out = []
                for name, req in sc_single_stream(pb):
                    resp_cls = getattr(pb, f"{name}Response")
                    r = await rpc(name, type(req), resp_cls)(req)
                    out.append((name, json_format.MessageToDict(
                        r, preserving_proto_field_name=True)))
                await rpc("ClearCache", pb.ClearCacheRequest,
                          pb.ClearCacheResponse)(pb.ClearCacheRequest())
                return out
        finally:
            await server.stop(grace=1)

    assert_same(asyncio.run(go()), jax_results["single_stream"])


def test_entrypoint_serves_generate_v1_instead_of_fmaas(monkeypatch):
    from text_generation_inference_tpu_torch.pb import generation_pb2
    from text_generation_inference_tpu_torch.server import main

    port = free_port()
    monkeypatch.setenv("INTERNAL_API", "1")
    monkeypatch.setenv("WARMUP", "0")
    cfg = ServingConfig(model_name=fixtures.tokenized_model_dir(),
                        grpc_port=port, http_port=free_port(),
                        max_sequence_length=64, max_new_tokens=32,
                        max_batch_slots=2, prefill_buckets=[8, 16],
                        dtype_str="float32")
    cfg.validate()

    async def go():
        task = asyncio.create_task(main.async_serve(cfg, device="cpu"))
        async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
            await asyncio.wait_for(ch.channel_ready(), 60)
            info = await ch.unary_unary(
                "/generate.v1.TextGenerationService/ModelInfo",
                request_serializer=pb.ModelInfoRequest.SerializeToString,
                response_deserializer=pb.ModelInfoResponse.FromString)(
                    pb.ModelInfoRequest())
            with pytest.raises(grpc.aio.AioRpcError) as e:
                await ch.unary_unary(
                    "/fmaas.GenerationService/Tokenize",
                    request_serializer=(generation_pb2.BatchedTokenizeRequest
                                        .SerializeToString),
                    response_deserializer=(generation_pb2
                                           .BatchedTokenizeResponse
                                           .FromString))(
                        generation_pb2.BatchedTokenizeRequest())
        os.kill(os.getpid(), signal.SIGINT)      # the entrypoint's stop
        await asyncio.wait_for(task, 30)
        return info, e.value.code()

    info, code = asyncio.run(go())
    assert info.eos_token == 2
    assert code == grpc.StatusCode.UNIMPLEMENTED


def test_both_generate_pb2_modules_load_in_one_process():
    assert pb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
    assert pb.DESCRIPTOR.name == "generate.proto"
    msg = pb.NextTokenRequest(batches=[pb.CachedBatch(batch_id=3)])
    back = jpb.NextTokenRequest.FromString(msg.SerializeToString())
    assert back.batches[0].batch_id == 3
