"""Serving over several ranks in the PyTorch port (`parallel/multihost.py`,
`parallel/launch.py`), on gloo ranks on the CPU. Mirrors the JAX package's
tests/test_multihost.py, whose step channel pickles over TCP; the port's
op stream is tensors broadcast over a gloo group.

  * the op stream: every op, and every `RequestParams` field and soft
    prompt of a prefill, arrives as sent (hypothesis); ops sent from four
    threads at once never interleave;
  * `ReplicatedEngine` and `follower_loop`: ops replayed in rank 0's
    order, host-only calls passed through, the follower's handle queue
    bounded by the pipeline's depth, the keepalive of an idle rank 0;
  * a Batcher on rank 0 of two ranks, over the paged and the slot engine,
    and generate.v1's service (Prefill, NextToken, a merged Prefill that
    prunes), give the one-process outputs;
  * `serve` (the CLI verb) with TENSOR_PARALLEL=2 on the CPU: two ranks,
    rank 0 behind gRPC, answers a golden case as one process does;
  * the env contract (`launch.layout`) and the JAX entrypoint's refusals
    and routing: the slot speculative engine refuses TP, a t5 checkpoint
    is built whole.
"""

import functools
import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import grpc
import numpy as np
import pytest
import torch
from google.protobuf import json_format
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tests import fixtures
from tests.test_golden import assert_approx
from tests.test_torch_server import golden_cases
from tests.torch_tp_ranks import (RankPool, batcher_engine, run_batcher,
                                  run_internal)
from text_generation_inference_tpu_torch.engine.engine import RequestParams
from text_generation_inference_tpu_torch.parallel import launch, multihost
from text_generation_inference_tpu_torch.pb import generation_pb2 as pb
from text_generation_inference_tpu_torch.utils.prompt_cache import PrefixEntry

REPO = Path(__file__).parents[1]


@pytest.fixture(scope="module")
def pool():
    p = RankPool(2)
    yield p
    p.close()


# -- the op stream ---------------------------------------------------------

int64 = st.integers(-2 ** 63, 2 ** 63 - 1)
floats = st.floats(allow_nan=False, width=64)


@st.composite
def request_params(draw):
    return RequestParams(
        temperature=draw(floats), top_k=draw(int64), top_p=draw(floats),
        typical_p=draw(floats), seed=draw(int64),
        repetition_penalty=draw(floats), lp_start=draw(int64),
        lp_decay=draw(floats), min_new_tokens=draw(int64),
        max_new_tokens=draw(int64))


@st.composite
def soft_prompt(draw):
    rows = draw(st.integers(1, 4))
    values = draw(st.lists(st.floats(-4, 4, width=32), min_size=rows * 3,
                           max_size=rows * 3))
    a = np.asarray(values, np.float32).reshape(rows, 3)
    kind = draw(st.sampled_from(["numpy", "bfloat16", "float16"]))
    return a if kind == "numpy" else torch.from_numpy(a).to(
        getattr(torch, kind))


@st.composite
def prefill_op(draw):
    n = draw(st.integers(1, 4))
    slots = draw(st.lists(st.integers(0, 255), min_size=n, max_size=n,
                          unique=True))
    tokens = draw(st.lists(st.lists(st.integers(0, 2 ** 31 - 1),
                                    min_size=1, max_size=6),
                           min_size=n, max_size=n))
    params = draw(st.lists(request_params(), min_size=n, max_size=n))
    embeds = draw(st.one_of(st.none(), st.lists(st.one_of(
        st.none(), soft_prompt(),
        st.builds(PrefixEntry, decoder=st.one_of(st.none(), soft_prompt()),
                  encoder=st.one_of(st.none(), soft_prompt()))),
        min_size=n, max_size=n)))
    return (multihost.OP_PREFILL, slots, tokens, params,
            draw(st.booleans()), embeds)


chunk = st.one_of(st.none(), st.integers(1, 64))
ops = st.lists(st.one_of(
    prefill_op(),
    st.tuples(st.just(multihost.OP_DECODE_BEGIN), st.booleans(), chunk),
    st.tuples(st.just(multihost.OP_STEPS), st.booleans(), chunk),
    st.tuples(st.just(multihost.OP_FREE), st.integers(0, 255)),
    st.sampled_from([(multihost.OP_DECODE_END,), (multihost.OP_RESET,),
                     (multihost.OP_PING,), (multihost.OP_STOP,)])),
    min_size=1, max_size=6)


def _same(got, want) -> bool:
    if isinstance(want, np.ndarray):
        return (isinstance(got, np.ndarray) and got.dtype == want.dtype
                and np.array_equal(got, want))
    if isinstance(want, torch.Tensor):
        return (isinstance(got, torch.Tensor) and got.dtype == want.dtype
                and torch.equal(got, want))
    if isinstance(want, (list, tuple)):
        return (type(got) is type(want) and len(got) == len(want)
                and all(_same(g, w) for g, w in zip(got, want)))
    return got == want


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(stream=ops)
def test_op_stream_roundtrips_every_op_and_field(pool, stream):
    sent, got = pool.run("op_roundtrip", stream)
    assert len(got) == len(stream)
    for g, w in zip(got, stream):
        assert _same(tuple(g), tuple(w)), (g, w)


def test_op_stream_is_tensors_not_pickles():
    header, payload = multihost._encode(
        multihost.OP_PREFILL,
        ([0], [[1, 2]], [RequestParams()], False,
         [PrefixEntry(decoder=np.ones((2, 3), np.float32))]))
    assert header.dtype == torch.int64 and header.numel() == multihost.HEADER
    assert all(isinstance(t, torch.Tensor) for t in payload)
    source = Path(multihost.__file__).read_text()
    assert "import pickle" not in source and "pickle." not in source


def test_concurrent_senders_never_interleave(pool):
    n_threads, n_per = 4, 100
    alive, got = pool.run("concurrent_senders", n_threads, n_per)
    assert not any(alive)
    assert [op[0] for op in got] == [multihost.OP_FREE] * len(got)
    # every op arrives whole, each thread's in its order
    values = [op[1] for op in got]
    assert sorted(values) == list(range(n_threads * n_per))
    for tag in range(n_threads):
        mine = [v for v in values if v // n_per == tag]
        assert mine == sorted(mine)


# -- ReplicatedEngine and follower_loop ------------------------------------

def test_ops_published_and_replayed_in_order(pool):
    (calls0, free0, _), (calls1, free1, n) = pool.run("replicated_script",
                                                      "order")
    assert calls0 == [("prefill", (3,), ((5, 6),), False, (2,)),
                      ("begin", False, 4), ("end", 1), ("steps", True, None),
                      ("free", 3), ("reset",)]
    # the follower drops the handle without fetching
    assert calls1 == [c for c in calls0 if c[0] != "end"]
    assert n == 6
    # rank 0's host-only acquire reached the follower through the prefill
    assert free0 == free1 == [0, 1, 2, 3]


def test_follower_handle_queue_bounded(pool):
    _, (deepest, left) = pool.run("follower_handles")
    assert deepest <= 2 and left == 0


def test_keepalive_pings_an_idle_follower(pool):
    _, (n_ops, pings, calls) = pool.run("keepalive", 0.6, 0.1)
    assert n_ops == 1 and calls == [("free", 0)]
    assert pings >= 2


# -- the Batcher over two ranks ---------------------------------------------

REQUESTS = [("hello world this is a test", 8, False),
            ("the quick brown fox", 6, True),
            ("café naïve", 10, False),
            ("one two three four five six", 7, True)]


@functools.lru_cache(maxsize=None)
def one_rank_batcher(kind: str):
    engine, tokenizer, config = batcher_engine(fixtures.golden_llama_dir(),
                                               kind, {})
    return run_batcher(engine, tokenizer, config, REQUESTS)


@pytest.mark.parametrize("kind", ["paged", "slot"])
def test_two_rank_batcher_matches_one_rank(pool, kind):
    out, replayed = pool.run("batcher", fixtures.golden_llama_dir(), kind,
                             REQUESTS, {})
    assert out == one_rank_batcher(kind)
    assert [len(ids) for ids, _ in out] == [r[1] for r in REQUESTS]
    assert replayed > 0


def test_two_rank_generate_v1_matches_one_rank(pool):
    """generate.v1 (INTERNAL_API=1's service) on rank 0 of two: a Prefill
    and its NextTokens (one decode call each, `OP_STEPS` on the stream),
    as one process answers them."""
    from tests.test_torch_internal_server import sc_addon_merge_and_prune
    from text_generation_inference_tpu_torch.pb import generate_pb2

    model_dir = fixtures.golden_llama_dir()
    calls = [(name, req.SerializeToString())
             for name, req in sc_addon_merge_and_prune(generate_pb2)]
    engine, tokenizer, config = batcher_engine(
        model_dir, "paged", dict(grpc_port=_free_port()))
    want = run_internal(engine, tokenizer, config, calls)
    got, replayed = pool.run("internal", model_dir, calls, _free_port())

    def untimed(tree):
        if isinstance(tree, dict):
            return {k: untimed(v) for k, v in tree.items()
                    if k != "forward_time_ns"}
        if isinstance(tree, (list, tuple)):
            return [untimed(v) for v in tree]
        return tree

    assert untimed(got) == untimed(want)
    assert replayed > len(calls)


# -- refusals and routing ----------------------------------------------------

def test_build_engine_refusals_and_routing(pool):
    llama = fixtures.golden_llama_dir()
    refused = pool.run("build", llama, {"SPECULATOR": "1",
                                        "PAGED_ATTENTION": "0"})
    assert all(r[0] == "refused" and "TENSOR_PARALLEL" in r[1]
               for r in refused)
    paged_spec = pool.run("build", llama, {"SPECULATOR": "1"})
    assert {r[:3] for r in paged_spec} == {
        ("PagedSpeculativeEngine", "decoder", True)}
    t5 = pool.run("build", fixtures.golden_t5_dir(), {})
    # built whole on every rank, as the JAX entrypoint builds it
    assert {r[:3] for r in t5} == {("Seq2SeqEngine", "encoder_decoder",
                                    False)}


def test_layout_env_contract(monkeypatch):
    coord = {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:9999"}
    assert launch.layout("cpu", {}).world == 1
    lay = launch.layout("cpu", {"TENSOR_PARALLEL": "2"})
    assert (lay.world, lay.per_host, lay.host) == (2, 2, 0)
    assert lay.coordinator.startswith("localhost:")
    lay = launch.layout("cpu", {"TENSOR_PARALLEL": "4",
                                "JAX_NUM_PROCESSES": "2",
                                "JAX_PROCESS_ID": "1", **coord})
    assert (lay.world, lay.per_host, [lay.rank(i) for i in range(2)],
            lay.coordinator) == (4, 2, [2, 3], "10.0.0.1:9999")
    assert launch.layout("cpu", {"JAX_NUM_PROCESSES": "3", **coord}
                         ).world == 3
    # every local card of every host by default
    monkeypatch.setattr(launch, "local_cards", lambda kind: 8)
    lay = launch.layout("cuda", {"JAX_NUM_PROCESSES": "2", **coord})
    assert (lay.world, lay.per_host) == (16, 8)
    with pytest.raises(ValueError, match="multiple"):
        launch.layout("cpu", {"TENSOR_PARALLEL": "3",
                              "JAX_NUM_PROCESSES": "2", **coord})
    with pytest.raises(ValueError, match="COORDINATOR"):
        launch.layout("cpu", {"JAX_NUM_PROCESSES": "2"})
    with pytest.raises(ValueError, match="cards"):
        launch.layout("cuda", {"TENSOR_PARALLEL": "16"})


# -- serve with TENSOR_PARALLEL=2 -------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_tensor_parallel_over_grpc(tmp_path):
    model_dir = fixtures.golden_llama_dir()
    case = next(c for c in golden_cases("llama")
                if c["name"] == "Batch greedy, explicit max new tokens")
    port, http = _free_port(), _free_port()
    env = {**os.environ, "TENSOR_PARALLEL": "2", "MAX_SEQUENCE_LENGTH": "64",
           "MAX_NEW_TOKENS": "32", "MAX_BATCH_SIZE": "8",
           "MAX_BATCH_SLOTS": "4", "PREFILL_BUCKETS": "16,32",
           "KV_PAGE_SIZE": "8", "WARMUP": "0", "DTYPE_STR": "float32"}
    log = open(tmp_path / "serve.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "from text_generation_inference_tpu_torch.cli import main; main()",
         "serve", model_dir, "--device", "cpu", "--grpc-port", str(port),
         "--http-port", str(http)],
        env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        grpc.channel_ready_future(channel).result(timeout=180)
        generate = channel.unary_unary(
            "/fmaas.GenerationService/Generate",
            request_serializer=pb.BatchedGenerationRequest.SerializeToString,
            response_deserializer=pb.BatchedGenerationResponse.FromString)
        req = json_format.ParseDict(case["request"],
                                    pb.BatchedGenerationRequest())
        resp = json_format.MessageToDict(generate(req, timeout=120))
        assert_approx(case["response"], resp, path="serve TP=2")
    finally:
        channel.close()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
            log.close()
    text = (tmp_path / "serve.log").read_text()
    assert rc == 0, text[-4000:]
    assert "starting 2 of 2 ranks" in text
    assert "rank 1 replaying rank 0's engine ops" in text
    assert "multihost follower: stop after" in text
