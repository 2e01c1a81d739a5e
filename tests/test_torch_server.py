"""The llama and gpt2 golden cases (tests/golden/test_cases_{llama,gpt2}.yaml,
regenerated from the HF-torch oracle as tests/test_golden.py does) through
the PyTorch port's gRPC server on the CPU: the port's tokenizer,
validation, batcher and engine behind `fmaas.GenerationService`, once on
the paged engine and once on the slot engine (PAGED_ATTENTION=0), with the
repo's golden tolerances (`test_golden.assert_approx`).

Each case runs unary, streaming (the concatenated stream text must equal
the expected text) and concurrently.
"""

import asyncio
import concurrent.futures
import hashlib
import importlib.util
import threading
from pathlib import Path

import grpc
import pytest
import torch
import yaml
from google.protobuf import json_format

from tests import fixtures
from tests.test_golden import assert_approx
from text_generation_inference_tpu_torch.config import ServingConfig
from text_generation_inference_tpu_torch.engine.engine import InferenceEngine
from text_generation_inference_tpu_torch.engine.paged_engine import (
    PagedInferenceEngine)
from text_generation_inference_tpu_torch.models import families
from text_generation_inference_tpu_torch.pb import generation_pb2 as pb
from text_generation_inference_tpu_torch.scheduler.batcher import Batcher
from text_generation_inference_tpu_torch.server.grpc_server import (
    GenerationServicer,
    make_handler,
)
from text_generation_inference_tpu_torch.utils.tokenization import (
    ServingTokenizer)

REPO = Path(__file__).parents[1]


GOLDEN_DIRS = {"llama": fixtures.golden_llama_dir,
               "gpt2": fixtures.golden_gpt2_dir}
# the encoder-decoder goldens, served by tests/test_torch_seq2seq.py
SEQ2SEQ_GOLDEN_DIRS = {"t5": fixtures.golden_t5_dir,
                       "mt0": fixtures.golden_mt0_dir}


def golden_cases(family: str) -> list:
    """The oracle's expectations for a golden fixture: the cached file
    tests/test_golden.py writes when it exists, else generated here (and
    not written, so the two tests never race on the cache)."""
    model_dir = Path({**GOLDEN_DIRS, **SEQ2SEQ_GOLDEN_DIRS}[family]())
    gen_src = REPO / "scripts" / "gen_goldens.py"
    h = hashlib.sha256(gen_src.read_bytes())
    for f in sorted(model_dir.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    cache = (fixtures.FIXTURE_ROOT
             / f"golden_cases_{family}.{h.hexdigest()[:12]}.yaml")
    if cache.exists():
        cases = yaml.safe_load(cache.read_text())
        if cases:
            return cases
    spec = importlib.util.spec_from_file_location("gen_goldens", gen_src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.gen_family(family)


class PortServer:
    """The port's serving stack on an event loop in a background thread,
    on the paged (`kind="paged"`) or the slot engine (`kind="slot"`), with
    an optional prompt-prefix store, serving a golden fixture (`family`)."""

    ENGINES = {"paged": PagedInferenceEngine, "slot": InferenceEngine}

    def __init__(self, kind: str, prompt_cache=None, family: str = "llama"):
        self.kind = kind
        self.family = family
        self.prompt_cache = prompt_cache
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        asyncio.run_coroutine_threadsafe(self._setup(), self.loop).result(
            timeout=300)

    async def _setup(self):
        model_dir = GOLDEN_DIRS[self.family]()
        tokenizer = ServingTokenizer.load(model_dir)
        self.config = ServingConfig(
            model_name=model_dir, max_sequence_length=64, max_new_tokens=32,
            max_batch_size=8, max_batch_slots=4, prefill_buckets=[16, 32],
            max_waiting_tokens=4, default_max_new_tokens=20)
        self.config.validate()
        spec, params = families.load_model(model_dir, dtype=torch.float32,
                                           device="cpu")
        engine = self.ENGINES[self.kind](spec, params, self.config,
                                         eos_token_id=tokenizer.eos_token_id,
                                         device="cpu")
        self.batcher = Batcher(engine, tokenizer, self.config,
                               prompt_cache=self.prompt_cache)
        self.batcher.start()
        servicer = GenerationServicer(self.config, tokenizer, self.batcher,
                                      model_kind="decoder")
        self.server = grpc.aio.server()
        self.server.add_generic_rpc_handlers((make_handler(servicer),))
        self.port = self.server.add_insecure_port("127.0.0.1:0")
        await self.server.start()

    async def _stop(self):
        await self.server.stop(grace=1.0)
        await self.batcher.stop()

    def close(self):
        asyncio.run_coroutine_threadsafe(self._stop(), self.loop).result(
            timeout=60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)


@pytest.fixture(scope="module",
                params=[(family, kind) for family in sorted(GOLDEN_DIRS)
                        for kind in sorted(PortServer.ENGINES)],
                ids=lambda p: p[1] if p[0] == "llama" else "-".join(p))
def golden(request):
    family, kind = request.param
    server = PortServer(kind, family=family)
    channel = grpc.insecure_channel(f"127.0.0.1:{server.port}")
    generate = channel.unary_unary(
        "/fmaas.GenerationService/Generate",
        request_serializer=pb.BatchedGenerationRequest.SerializeToString,
        response_deserializer=pb.BatchedGenerationResponse.FromString)
    stream = channel.unary_stream(
        "/fmaas.GenerationService/GenerateStream",
        request_serializer=pb.SingleGenerationRequest.SerializeToString,
        response_deserializer=pb.GenerationResponse.FromString)
    yield family, golden_cases(family), generate, stream
    channel.close()
    server.close()


def _req(case):
    return json_format.ParseDict(case["request"], pb.BatchedGenerationRequest())


def test_unary_cases(golden):
    family, cases, generate, _ = golden
    for case in cases:
        resp = json_format.MessageToDict(generate(_req(case)))
        assert_approx(case["response"], resp, path=f"{family}:{case['name']}")


def test_streaming_parity(golden):
    family, cases, _, stream = golden
    for case in cases:
        breq = _req(case)
        for i, r in enumerate(breq.requests):
            sreq = pb.SingleGenerationRequest(model_id=breq.model_id,
                                              params=breq.params, request=r)
            msgs = list(stream(sreq))
            text = "".join(m.text for m in msgs[1:])    # [0] = input msg
            expected = case["response"]["responses"][i]
            assert text == expected.get("text", ""), \
                f"{family}:{case['name']}[{i}] stream text mismatch"
            assert pb.StopReason.Name(msgs[-1].stop_reason) == \
                expected["stopReason"]
            assert msgs[-1].generated_token_count == \
                expected["generatedTokenCount"]


def test_concurrent_matches_sequential(golden):
    family, cases, generate, _ = golden
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        futures = [(case, ex.submit(generate, _req(case)))
                   for case in cases for _ in range(2)]
        for case, fut in futures:
            assert_approx(case["response"],
                          json_format.MessageToDict(fut.result()),
                          path=f"{family}:{case['name']}:concurrent")
