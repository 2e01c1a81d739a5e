"""The port's seq2seq engine (`engine/seq2seq.py`) against the JAX package's
`Seq2SeqEngine`, and the encoder-decoder serving path, fp32, CPU.

* Engine parity on a tiny gated-GELU T5 (weights carried across by
  `models/convert.py`): a staggered schedule (two requests, one freed, a
  third in its slot, a never-used slot free beside them) in the three
  decode modes: chunk 1, multi-step chunks writing in place ("scan") and
  ring chunks over context buckets. Greedy tokens are identical, logprobs
  within 5e-4 (the repo's golden tolerance), and every row of every step
  is finite.
* A never-used slot reused after ring chunks ran: the port gives the
  tokens the request gets alone on a fresh engine (JAX's fresh engine
  gives the same); the JAX engine in that slot does not (its free slot's
  NaN reached the slot's self-KV; a fault in the reference, pinned here).
* The decode programs through `tools/decode_replay` (lockstep with an
  eager engine, every program once, pipelined dispatch) at chunk 1 and on
  ring chunks over context buckets.
* Seeded sampling reproducible across write modes, slots and the
  no-details program; the decode program grid against the JAX engine's;
  warmup leaves the state as `create` made it; int8 KV and unknown write
  modes raise; the decoder budget (`max_dec`) equals JAX's; the engine
  refuses params on another device and defaults to CUDA.
* Soft prompts (encoder side, decoder side, both) change their request's
  tokens, equal to the JAX engine's, and leave their neighbours alone.
* `server.main.build_engine` sends t5 / mt5 / umt5 checkpoints to the
  seq2seq engine.
* The golden t5 and mt0 cases (tests/test_golden.py's oracle) through the
  port's Batcher and gRPC: unary, streaming, concurrent equals sequential
  (`test_golden.assert_approx`), and `ModelInfo` reports ENCODER_DECODER.
"""

import asyncio
import concurrent.futures
import json
import shutil
from pathlib import Path

import grpc
import numpy as np
import pytest
import torch
from google.protobuf import json_format

import jax
import jax.numpy as jnp

from tests import fixtures
from tests.test_golden import assert_approx
from tests.test_torch_server import (SEQ2SEQ_GOLDEN_DIRS, PortServer,
                                     golden_cases)
from text_generation_inference_tpu.config import ServingConfig as JConfig
from text_generation_inference_tpu.engine.engine import (
    RequestParams as JRequestParams)
from text_generation_inference_tpu.engine.seq2seq import (
    Seq2SeqEngine as JSeq2SeqEngine)
from text_generation_inference_tpu.models import t5 as jt5
from text_generation_inference_tpu.utils.prompt_cache import (
    PrefixEntry as JPrefixEntry)
from text_generation_inference_tpu.utils.weights import Weights as JWeights
from text_generation_inference_tpu_torch.config import ServingConfig
from text_generation_inference_tpu_torch.engine.engine import RequestParams
from text_generation_inference_tpu_torch.engine.seq2seq import Seq2SeqEngine
from text_generation_inference_tpu_torch.models import t5
from text_generation_inference_tpu_torch.models.convert import (
    t5_params_from_jax)
from text_generation_inference_tpu_torch.pb import generation_pb2 as pb
from text_generation_inference_tpu_torch.scheduler.batcher import Batcher
from text_generation_inference_tpu_torch.server import main
from text_generation_inference_tpu_torch.server.grpc_server import (
    GenerationServicer, make_handler)
from text_generation_inference_tpu_torch.utils.prompt_cache import PrefixEntry
from text_generation_inference_tpu_torch.utils.tokenization import (
    ServingTokenizer)

LOGPROB_TOL = 5e-4
EOS = 1
PROMPTS = [[5, 9, 23, 77, 41], [100, 3, 250, 17, 88, 91, 12], [7, 7, 7]]


def _fixture() -> str:
    """tests/test_server_seq2seq.py's tiny T5 shape (gated-GELU, untied),
    over a 256-token vocabulary."""
    from transformers import T5Config, T5ForConditionalGeneration

    torch.manual_seed(8)
    cfg = T5Config(vocab_size=256, d_model=64, d_kv=16, d_ff=128,
                   num_layers=2, num_decoder_layers=2, num_heads=4,
                   relative_attention_num_buckets=8,
                   relative_attention_max_distance=32,
                   feed_forward_proj="gated-gelu", tie_word_embeddings=False,
                   dropout_rate=0.0, decoder_start_token_id=0,
                   eos_token_id=EOS, pad_token_id=0)
    return fixtures._save(T5ForConditionalGeneration(cfg).eval(),
                          "torch_s2s_t5")


@pytest.fixture(scope="module")
def models():
    """(port spec, port params, JAX spec, JAX params) on the same weights."""
    d = _fixture()
    cfg = json.loads((Path(d) / "config.json").read_text())
    jspec = jt5.spec_from_hf_config(cfg)
    jparams = jt5.load_params(JWeights(d), jspec, jnp.float32)
    spec = t5.spec_from_hf_config(cfg)
    params = t5_params_from_jax(
        spec, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return spec, params, jspec, jparams


def make_config(cls=ServingConfig, **kw):
    cfg = cls(**{"max_sequence_length": 64, "max_new_tokens": 32,
                 "max_batch_slots": 3, "prefill_buckets": [8, 16], **kw})
    cfg.validate()
    return cfg


def engine(models, **kw):
    spec, params, _, _ = models
    return Seq2SeqEngine(spec, params, make_config(**kw), eos_token_id=EOS,
                         device="cpu")


def jax_engine(models, **kw):
    _, _, jspec, jparams = models
    return JSeq2SeqEngine(jspec, jparams, make_config(JConfig, **kw),
                          eos_token_id=EOS)


def staggered(eng, rp_cls, prefixes=(None, None, None)):
    """A and B admitted together, 8 steps, B freed, C admitted into the
    freed slot, 16 more steps; the third slot is never used. Returns
    {name: [(token, logprob), ...]}. On the port's engine every row of
    every step must be finite (the JAX engine's free slot is NaN)."""
    finite = isinstance(eng, Seq2SeqEngine)
    chunk = eng.decode_chunk
    out = {}

    def first(res, names):
        for i, n in enumerate(names):
            out[n] = [(int(res.first_token.next_ids[i]),
                       float(res.first_token.logprob[i]))]

    def decode(n_steps, slots):
        for _ in range(n_steps // chunk):
            for step in eng.decode_steps():
                assert np.isfinite(step.logprob).all() or not finite
                for name, s in slots.items():
                    out[name].append((int(step.next_ids[s]),
                                      float(step.logprob[s])))

    sa, sb = eng.acquire_slot(), eng.acquire_slot()
    first(eng.prefill([sa, sb], [PROMPTS[0], PROMPTS[1]],
                      [rp_cls(max_new_tokens=30)] * 2,
                      prefix_embeds=list(prefixes[:2])
                      if any(prefixes[:2]) else None), ["a", "b"])
    decode(8, {"a": sa, "b": sb})
    eng.free(sb)
    sc = eng.acquire_slot()
    assert sc == sb                                  # the freed slot again
    first(eng.prefill([sc], [PROMPTS[2]], [rp_cls(max_new_tokens=30)],
                      prefix_embeds=[prefixes[2]] if prefixes[2] is not None
                      else None), ["c"])
    decode(16, {"a": sa, "c": sc})
    eng.free(sa)
    eng.free(sc)
    return out


def assert_same_run(got, want):
    assert {k: [t for t, _ in v] for k, v in got.items()} == \
        {k: [t for t, _ in v] for k, v in want.items()}
    for k in want:
        np.testing.assert_allclose([lp for _, lp in got[k]],
                                   [lp for _, lp in want[k]],
                                   rtol=0, atol=LOGPROB_TOL, err_msg=k)


# the three decode modes of the JAX engine
MODES = {
    "chunk1": dict(),
    "scan_chunk4": dict(decode_chunk=4, decode_write_mode="scan"),
    "ring_chunk4_ctx_buckets": dict(decode_chunk=4,
                                    decode_ctx_buckets=[8, 16, 32]),
}


@pytest.fixture(scope="module")
def jax_runs(models):
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = staggered(jax_engine(models, **MODES[mode]),
                                    JRequestParams)
        return cache[mode]
    return get


@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_streams_match_jax(models, jax_runs, mode):
    eng = engine(models, **MODES[mode])
    want = jax_runs(mode)
    assert_same_run(staggered(eng, RequestParams), want)
    # again on the churned state: a reused slot leaks no stale KV
    assert_same_run(staggered(eng, RequestParams), want)
    assert len(eng.free_slots) == eng.num_slots
    # every mode gives the same greedy tokens
    assert_same_run(want, jax_runs("chunk1"))


def test_ring_chunks_leave_a_never_used_slot_clean(models):
    """A request placed in a slot that sat free through ring chunks."""
    kw = dict(decode_chunk=4)

    def run(eng, rp_cls, chunks_before):
        if chunks_before:
            other = eng.acquire_slot()
            eng.prefill([other], [PROMPTS[0]], [rp_cls(max_new_tokens=30)])
            for _ in range(chunks_before):
                eng.decode_steps()
        slot = eng.acquire_slot()
        res = eng.prefill([slot], [PROMPTS[1]], [rp_cls(max_new_tokens=30)])
        toks = [int(res.first_token.next_ids[0])]
        for _ in range(3):
            toks += [int(s.next_ids[slot]) for s in eng.decode_steps()]
        return toks

    alone = run(jax_engine(models, **kw), JRequestParams, 0)
    assert run(engine(models, **kw), RequestParams, 0) == alone
    assert run(engine(models, **kw), RequestParams, 2) == alone
    # the JAX engine's free slot turned NaN (its cross-attention has no
    # key) and the flush carried it into the slot's self-KV rows
    assert run(jax_engine(models, **kw), JRequestParams, 2) != alone


def test_seeded_sampling_and_no_details(models):
    def sample(kw, skip, seed):
        rp = RequestParams(temperature=1.5, top_k=50, seed=seed,
                           max_new_tokens=20)
        eng = engine(models, **kw)
        for _ in range(skip):                        # another slot
            eng.acquire_slot()
        slot = eng.acquire_slot()
        res = eng.prefill([slot], [PROMPTS[0]], [rp])
        toks = [int(res.first_token.next_ids[0])]
        for want in (True, False, True, False):
            for _ in range(4 // eng.decode_chunk):
                for step in eng.decode_steps(want_details=want):
                    toks.append(int(step.next_ids[slot]))
                    assert np.isnan(step.logprob[slot]) != want
        return toks

    runs = [sample(kw, skip, 7) for kw, skip in (
        (dict(decode_chunk=4), 0),
        (dict(decode_chunk=4, decode_write_mode="scan"), 1),
        (dict(), 2))]
    assert runs[0] == runs[1] == runs[2]
    assert sample(dict(), 0, 8) != runs[0]


def test_decode_program_grid_matches_jax(models):
    for kw in (dict(), dict(decode_chunk=4, decode_write_mode="scan"),
               dict(decode_chunk=4, decode_ctx_buckets=[8, 16]),
               dict(decode_chunk=4, stream_decode_chunk=2)):
        eng, jeng = engine(models, **kw), jax_engine(models, **kw)
        assert eng.max_dec == jeng.max_dec == 33
        assert eng._ctx_bucket_grid() == jeng._ctx_bucket_grid()
        n = eng.precompile_decode()
        assert n == len(jeng._ctx_bucket_grid()) * 2
        assert sorted(eng.programs.programs) == sorted(
            (w, rows, eng.decode_chunk) for rows in jeng._ctx_bucket_grid()
            for w in (False, True))
        assert eng.supports_chunk_override is False


@pytest.mark.parametrize("mode", ["chunk1", "ring_chunk4_ctx_buckets"])
def test_decode_programs_in_lockstep(models, mode):
    """`tools/decode_replay`'s checks on the CPU: a program engine and an
    eager one (`eager_decode=True`) equal through the staggered schedule,
    then every program of the grid once; pipelined equals sequential."""
    from text_generation_inference_tpu_torch.tools import decode_replay

    kw = dict(MODES[mode], max_batch_slots=6, max_sequence_length=256,
              max_new_tokens=200, prefill_buckets=[16, 64, 256])
    spec, params, _, _ = models

    def build(eager=False):
        return Seq2SeqEngine(spec, params, make_config(**kw),
                             eos_token_id=EOS, device="cpu",
                             eager_decode=eager)

    a, b = build(), build(eager=True)
    seen = decode_replay.lockstep(a, b, vocab=spec.vocab_size)
    assert seen["dispatches"] == 16 and seen["out_of_capture_order"]
    assert decode_replay.every_program(a, b) == len(a.programs) > 0
    assert decode_replay.pipelined_matches_sequential(
        build(), build(eager=True), vocab=spec.vocab_size) > 0


def test_cache_rows_follow_the_host_mirror(models):
    eng = engine(models, decode_chunk=4, decode_ctx_buckets=[8, 16])
    assert eng._ctx_bucket_grid() == [8, 16, 33]
    slot = eng.acquire_slot()
    eng.prefill([slot], [PROMPTS[1]], [RequestParams(max_new_tokens=30)])
    assert eng._pick_cache_rows() == 8             # decoder history 2
    eng.decode_steps()
    eng.decode_steps()                             # history 10
    assert eng._pick_cache_rows() == 16
    eng.free(slot)
    eng.decode_steps()
    assert eng._pick_cache_rows() == 8


def test_warmup_leaves_the_state_as_created(models):
    kw = dict(decode_chunk=4, decode_ctx_buckets=[16])
    eng = engine(models, **kw)
    eng.warmup()
    assert len(eng.free_slots) == eng.num_slots
    assert len(eng.programs) == 4
    fresh = engine(models, **kw)
    for x, y in zip((*eng.cache, *eng.state.tensors()),
                    (*fresh.cache, *fresh.state.tensors())):
        assert torch.equal(x, y)
    assert_same_run(staggered(eng, RequestParams),
                    staggered(fresh, RequestParams))
    eng.reset()
    assert len(eng.programs) == 4 and len(eng.free_slots) == eng.num_slots
    assert_same_run(staggered(eng, RequestParams),
                    staggered(engine(models, **kw), RequestParams))


def test_guards(models):
    spec, params, jspec, jparams = models
    for cls, p, cfg_cls, kw in ((Seq2SeqEngine, params, ServingConfig,
                                 dict(device="cpu")),
                                (JSeq2SeqEngine, jparams, JConfig, {})):
        sp = spec if cls is Seq2SeqEngine else jspec
        with pytest.raises(ValueError, match="int8"):
            cls(sp, p, make_config(cfg_cls, kv_cache_dtype="int8",
                                   decode_chunk=4), eos_token_id=EOS, **kw)
    with pytest.raises(ValueError, match="write_mode"):
        engine(models, decode_write_mode="bogus")
    with pytest.raises(ValueError, match="device"):
        Seq2SeqEngine(spec, params, make_config(), eos_token_id=EOS,
                      device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Seq2SeqEngine(spec, params, make_config(), eos_token_id=EOS)
    # the decoder budget: start token + prefix budget + new tokens
    for kw in (dict(), dict(prefix_store_path="/nonexistent",
                            max_prompt_prefix_length=8),
               dict(max_sequence_length=16, max_new_tokens=15)):
        assert engine(models, **kw).max_dec == jax_engine(models, **kw).max_dec
    # no prompt-token details on the seq2seq engine
    eng = engine(models)
    res = eng.prefill([eng.acquire_slot()], [PROMPTS[0]], [RequestParams()],
                      want_prompt_details=True)
    assert res.prompt_details is None


@pytest.mark.parametrize("sides", ["both", "encoder", "decoder"])
def test_soft_prompts_match_jax(models, sides):
    rng = np.random.default_rng(5)
    spec = models[0]
    dec = rng.normal(size=(3, spec.d_model)).astype(np.float32)
    enc = rng.normal(size=(4, spec.d_model)).astype(np.float32)
    parts = dict(decoder=dec if sides != "encoder" else None,
                 encoder=enc if sides != "decoder" else None)
    kw = dict(max_batch_slots=2, prefill_buckets=[16, 32],
              max_new_tokens=16)

    def runs(eng, rp_cls, entry, make_entry):
        def run(pe, n=6):
            slot = eng.acquire_slot()
            res = eng.prefill([slot], [PROMPTS[0]],
                              [rp_cls(max_new_tokens=n)], prefix_embeds=[pe])
            toks = [int(res.first_token.next_ids[0])]
            for _ in range(n - 1):
                toks.append(int(eng.decode().next_ids[slot]))
            eng.free(slot)
            return toks
        alone = run(None), run(entry), run(None), run(entry)
        # a prefixed request beside a plain one, and one behind a prefix
        # in a reused slot, in one staggered schedule
        pre = (make_entry(**parts), None, make_entry(**parts))
        return alone, staggered(eng, rp_cls, pre)

    got, got_staggered = runs(engine(models, **kw), RequestParams,
                              PrefixEntry(**parts), PrefixEntry)
    want, want_staggered = runs(jax_engine(models, **kw), JRequestParams,
                                JPrefixEntry(**parts), JPrefixEntry)
    assert got == want
    plain, with_prefix, plain2, with_prefix2 = got
    assert plain != with_prefix
    assert plain2 == plain and with_prefix2 == with_prefix
    assert_same_run(got_staggered, want_staggered)


@pytest.mark.parametrize("kind", ["t5", "mt5", "umt5"])
def test_build_engine_dispatches_seq2seq(tmp_path, kind):
    src = Path(fixtures.golden_mt0_dir() if kind == "mt5"
               else fixtures.golden_t5_dir())
    d = src
    if kind == "umt5":          # a t5 checkpoint under the umt5 type
        d = tmp_path / "umt5"
        shutil.copytree(src, d)
        cfg = json.loads((d / "config.json").read_text())
        cfg["model_type"] = "umt5"
        (d / "config.json").write_text(json.dumps(cfg))
    assert json.loads((d / "config.json").read_text())["model_type"] == kind
    cfg = ServingConfig(model_name=str(d), dtype_str="float32",
                        max_sequence_length=64, max_new_tokens=32,
                        max_batch_slots=2, prefill_buckets=[16])
    cfg.validate()
    eng, tokenizer, model_kind = main.build_engine(cfg, device="cpu")
    assert type(eng) is Seq2SeqEngine and model_kind == "encoder_decoder"
    assert eng.model_params["shared_embed"].dtype == torch.float32
    assert all(t.device.type == "cpu" for t in eng.cache)
    slot = eng.acquire_slot()
    res = eng.prefill([slot], [tokenizer.encode("hello world")],
                      [RequestParams()])
    assert 0 <= int(res.first_token.next_ids[0]) < eng.spec.vocab_size


# --- serving: the golden t5 and mt0 cases through the port's gRPC ----------


class Seq2SeqServer(PortServer):
    """`PortServer` serving a golden seq2seq fixture, its engine built by
    `server.main.build_engine`."""

    async def _setup(self):
        model_dir = SEQ2SEQ_GOLDEN_DIRS[self.family]()
        self.config = ServingConfig(
            model_name=model_dir, dtype_str="float32",
            max_sequence_length=64, max_new_tokens=32, max_batch_size=8,
            max_batch_slots=4, prefill_buckets=[16, 32],
            max_waiting_tokens=4, default_max_new_tokens=20)
        self.config.validate()
        engine, tokenizer, kind = main.build_engine(self.config,
                                                    device="cpu")
        assert isinstance(tokenizer, ServingTokenizer)
        self.batcher = Batcher(engine, tokenizer, self.config)
        self.batcher.start()
        servicer = GenerationServicer(self.config, tokenizer, self.batcher,
                                      model_kind=kind)
        self.server = grpc.aio.server()
        self.server.add_generic_rpc_handlers((make_handler(servicer),))
        self.port = self.server.add_insecure_port("127.0.0.1:0")
        await self.server.start()


@pytest.fixture(scope="module", params=["mt0", "t5"])
def golden(request):
    family = request.param
    server = Seq2SeqServer("seq2seq", family=family)
    channel = grpc.insecure_channel(f"127.0.0.1:{server.port}")
    stubs = dict(
        generate=channel.unary_unary(
            "/fmaas.GenerationService/Generate",
            request_serializer=pb.BatchedGenerationRequest.SerializeToString,
            response_deserializer=pb.BatchedGenerationResponse.FromString),
        stream=channel.unary_stream(
            "/fmaas.GenerationService/GenerateStream",
            request_serializer=pb.SingleGenerationRequest.SerializeToString,
            response_deserializer=pb.GenerationResponse.FromString),
        model_info=channel.unary_unary(
            "/fmaas.GenerationService/ModelInfo",
            request_serializer=pb.ModelInfoRequest.SerializeToString,
            response_deserializer=pb.ModelInfoResponse.FromString))
    yield family, golden_cases(family), stubs
    channel.close()
    server.close()


def _req(case):
    return json_format.ParseDict(case["request"], pb.BatchedGenerationRequest())


def test_model_info_reports_encoder_decoder(golden):
    _, _, stubs = golden
    r = stubs["model_info"](pb.ModelInfoRequest(model_id="m"))
    assert r.model_kind == pb.ModelInfoResponse.ModelKind.ENCODER_DECODER


def test_golden_unary(golden):
    family, cases, stubs = golden
    for case in cases:
        resp = json_format.MessageToDict(stubs["generate"](_req(case)))
        assert_approx(case["response"], resp, path=f"{family}:{case['name']}")


def test_golden_streaming_parity(golden):
    family, cases, stubs = golden
    for case in cases:
        breq = _req(case)
        for i, r in enumerate(breq.requests):
            msgs = list(stubs["stream"](pb.SingleGenerationRequest(
                model_id=breq.model_id, params=breq.params, request=r)))
            text = "".join(m.text for m in msgs[1:])    # [0] = input msg
            expected = case["response"]["responses"][i]
            assert text == expected.get("text", ""), \
                f"{family}:{case['name']}[{i}] stream text mismatch"
            assert pb.StopReason.Name(msgs[-1].stop_reason) == \
                expected["stopReason"]
            assert msgs[-1].generated_token_count == \
                expected["generatedTokenCount"]


def test_golden_concurrent_matches_sequential(golden):
    family, cases, stubs = golden
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        futures = [(case, ex.submit(stubs["generate"], _req(case)))
                   for case in cases for _ in range(2)]
        for case, fut in futures:
            assert_approx(case["response"],
                          json_format.MessageToDict(fut.result()),
                          path=f"{family}:{case['name']}:concurrent")
