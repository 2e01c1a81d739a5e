"""Tensor-parallel ranks for the CPU tests: a pool of processes joined in
a gloo group, as the reference tests TP with CPU shard processes over gloo
(reference: integration_tests/test_server.py:396-420).

`RankPool(world)` starts `world` processes once; `run(case, *args)` hands
every rank the same case (a function of this module, named) and returns
each rank's result, in rank order. The arguments travel as a
`torch.save` blob. A rank holds the tensor-parallel group
(`parallel.comm.TPGroup` over the default group) and the op stream's
channel (`parallel.multihost.OpChannel` over a second gloo group), as
`parallel.launch.init_rank` makes them for `serve`.

This module imports nothing of the JAX package: the ranks never load it.
The test files compute the JAX references in their own process.
"""

from __future__ import annotations

import asyncio
import datetime
import io
import multiprocessing
import socket
import threading
import traceback

import numpy as np
import torch

# a hung collective fails the test instead of the whole run
GROUP_TIMEOUT = datetime.timedelta(seconds=90)
RESULT_TIMEOUT = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankPool:
    def __init__(self, world: int):
        ctx = multiprocessing.get_context("spawn")
        port = _free_port()
        self.world = world
        self.inboxes = [ctx.Queue() for _ in range(world)]
        self.outbox = ctx.Queue()
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(r, world, port, self.inboxes[r],
                                        self.outbox), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, case: str, *args) -> list:
        buf = io.BytesIO()
        torch.save(args, buf)
        blob = buf.getvalue()
        for q in self.inboxes:
            q.put((case, blob))
        results = [None] * self.world
        errors = []
        for _ in range(self.world):
            rank, ok, value = self.outbox.get(timeout=RESULT_TIMEOUT)
            if ok:
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return results

    def close(self) -> None:
        for q in self.inboxes:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        assert not any(p.is_alive() for p in self.procs)


class Rank:
    """What a case gets: the rank's TP group and op channel."""

    def __init__(self, tp, channel):
        self.tp, self.channel = tp, channel
        self.rank, self.world = tp.rank, tp.world


def _rank_main(rank, world, port, inbox, outbox) -> None:
    import torch.distributed as dist

    from text_generation_inference_tpu_torch.parallel.comm import TPGroup
    from text_generation_inference_tpu_torch.parallel.multihost import (
        OpChannel)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)
    ops = dist.new_group(backend="gloo", timeout=GROUP_TIMEOUT)
    ctx = Rank(TPGroup(rank, world), OpChannel(ops))
    while True:
        item = inbox.get()
        if item is None:
            break
        case, blob = item
        try:
            args = torch.load(io.BytesIO(blob), weights_only=False)
            outbox.put((rank, True, CASES[case](ctx, *args)))
        except Exception:
            outbox.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# model runs
# ---------------------------------------------------------------------------

# two prompts of the logits runs, right-padded to a bucket of 8
PROMPTS = ([3, 1, 4, 1, 5, 9, 2, 6], [7, 11, 8])
DECODE_IDS = ([11, 12], [13, 14])     # teacher-forced decode steps


def model_logits(spec, params, paged: bool = False) -> dict:
    """Prefill PROMPTS into slots 0 and 1, then the DECODE_IDS steps,
    through the slot cache (`core.prefill`, `core.decode`) or the paged
    pool (`paged_core`), with the plain versions of the kernels (this is
    the CPU). Returns the prefill logits at every real position and each
    decode step's logits, numpy f32. `spec` and `params` are a rank's
    (`shard_model`) or a whole model's."""
    from text_generation_inference_tpu_torch.engine.paged_cache import (
        PagedKVCache)
    from text_generation_inference_tpu_torch.models import core, paged_core

    t = 8
    ids = torch.zeros((2, t), dtype=torch.int32)
    for i, p in enumerate(PROMPTS):
        ids[i, :len(p)] = torch.tensor(p)
    lengths = torch.tensor([len(p) for p in PROMPTS], dtype=torch.int32)
    slots = torch.tensor([0, 1], dtype=torch.int32)
    page = 8
    if paged:
        cache = PagedKVCache.create(spec, 8, page, 2, 4, torch.float32,
                                    "cpu")
        cache.block_table.copy_(torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]]))
        logits, cache = paged_core.prefill_paged(spec, params, ids, lengths,
                                                 slots, cache, page)
    else:
        cache = core.KVCache.create(spec, 2, 32, torch.float32, "cpu")
        logits, cache = core.prefill(spec, params, ids, lengths, slots,
                                     cache)
    out = {"prefill": [logits[i, :len(p)].numpy().copy()
                       for i, p in enumerate(PROMPTS)], "decode": []}
    pos = lengths.clone()
    for step in DECODE_IDS:
        step_ids = torch.tensor(step, dtype=torch.int32)
        if paged:
            d, cache = paged_core.decode_paged(spec, params, step_ids, pos,
                                               cache, pos + 1, page)
        else:
            d, cache = core.decode(spec, params, step_ids, pos, cache,
                                   pos + 1)
        out["decode"].append(d.numpy().copy())
        pos = pos + 1
    return out


def _logits(ctx: Rank, spec, params, paged: bool) -> dict:
    from text_generation_inference_tpu_torch.parallel.sharding import (
        shard_model)

    local, lp = shard_model(spec, params, ctx.tp, "cpu")
    out = model_logits(local, lp, paged)
    out["layout"] = (local.num_heads, local.num_kv_heads,
                     local.intermediate_size, local.tp.kv_index)
    return out


def make_engine(kind: str, spec, params, config_kw: dict, tp=None,
                num_pages: int = 48):
    """A CPU engine of `kind` ("slot", "paged" or "paged_spec") for a
    greedy run, on a rank's group (`tp`) or alone."""
    from text_generation_inference_tpu_torch.config import ServingConfig
    from text_generation_inference_tpu_torch.engine.engine import (
        InferenceEngine)
    from text_generation_inference_tpu_torch.engine.paged_engine import (
        PagedInferenceEngine)
    from text_generation_inference_tpu_torch.engine.speculative import (
        PagedSpeculativeEngine)

    cfg = ServingConfig(**{**dict(
        max_sequence_length=64, max_new_tokens=32, max_batch_slots=3,
        prefill_buckets=[8, 16], kv_page_size=8), **config_kw})
    cfg.validate()
    kw = dict(eos_token_id=-1, device="cpu", tp=tp)
    if kind == "slot":
        return InferenceEngine(spec, params, cfg, **kw)
    if kind == "paged":
        return PagedInferenceEngine(spec, params, cfg, num_pages=num_pages,
                                    **kw)
    return PagedSpeculativeEngine(spec, params, cfg, num_pages=num_pages,
                                  n_predict=3, **kw)


STREAM_PROMPTS = ([5, 9, 23, 77, 41], [100, 3, 250, 17, 88, 91, 12],
                  [7, 7, 7])


def greedy_streams(engine, n: int = 8) -> list:
    """Staggered greedy streams: prompt 0 alone for two calls, then prompts
    1 and 2 join; every call's emitted ids per slot (a speculative step
    emits 1..n_predict + 1). Returns each request's first n ids, and every
    decode call's next ids of every slot (the lockstep record)."""
    from text_generation_inference_tpu_torch.engine.engine import (
        RequestParams)

    toks = {i: [] for i in range(len(STREAM_PROMPTS))}
    slots, record = {}, []

    def admit(i):
        slot = engine.acquire_slot()
        res = engine.prefill([slot], [STREAM_PROMPTS[i]],
                             [RequestParams(max_new_tokens=n + 8)])
        slots[i] = slot
        toks[i].append(int(res.first_token.next_ids[0]))

    def decode():
        steps = engine.decode_steps()
        emitted = engine.last_n_emitted
        for i, slot in slots.items():
            k = len(steps) if emitted is None else int(emitted[slot])
            toks[i].extend(int(s.next_ids[slot]) for s in steps[:k])
        record.append([s.next_ids.tolist() for s in steps])

    admit(0)
    decode()
    decode()
    admit(1)
    admit(2)
    while min(len(t) for t in toks.values()) < n:
        decode()
    return [t[:n] for t in toks.values()], record


def _streams(ctx: Rank, kind: str, spec, params, config_kw: dict):
    engine = make_engine(kind, spec, params, config_kw, tp=ctx.tp)
    out, record = greedy_streams(engine)
    return {"tokens": out, "record": record,
            "pool_heads": engine.spec.num_kv_heads,
            "pages": (engine.allocator.num_pages
                      if hasattr(engine, "allocator") else None)}


# ---------------------------------------------------------------------------
# the op stream
# ---------------------------------------------------------------------------


def _op_roundtrip(ctx: Rank, ops: list):
    """Rank 0 publishes `ops` ((kind, *args) tuples); every rank returns
    the ops as it holds them after the stream (rank 0 its own)."""
    if ctx.rank == 0:
        for op in ops:
            ctx.channel.send(*op)
        return ops
    return [ctx.channel.recv() for _ in ops]


def _concurrent_senders(ctx: Rank, n_threads: int, n_per: int):
    """Rank 0 publishes OP_FREE (thread * n_per + i) from `n_threads`
    threads at once; the others return what they received."""
    from text_generation_inference_tpu_torch.parallel import multihost

    if ctx.rank == 0:
        def send_many(tag):
            for i in range(n_per):
                ctx.channel.send(multihost.OP_FREE, tag * n_per + i)

        threads = [threading.Thread(target=send_many, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        return [t.is_alive() for t in threads]
    return [ctx.channel.recv() for _ in range(n_threads * n_per)]


class RecordingEngine:
    """An engine double that records its calls (the JAX package's
    tests/test_multihost.py double)."""

    supports_decode_pipeline = True
    supports_chunk_override = True

    def __init__(self):
        self.calls = []
        self.free_slots = [0, 1, 2, 3]
        self._handles = 0

    def prefill(self, slots, token_ids, request_params,
                want_prompt_details=False, prefix_embeds=None):
        self.calls.append(("prefill", tuple(slots),
                           tuple(tuple(t) for t in token_ids),
                           want_prompt_details,
                           tuple(rp.max_new_tokens for rp in request_params)))
        return "prefill-result"

    def decode_steps_begin(self, want_details=True, chunk=None):
        self._handles += 1
        self.calls.append(("begin", want_details, chunk))
        return ("handle", self._handles)

    def decode_steps_end(self, handle):
        self.calls.append(("end", handle[1]))
        return ["steps"]

    def decode_steps(self, want_details=True, chunk=None):
        self.calls.append(("steps", want_details, chunk))
        return ["steps"]

    def free(self, slot):
        self.calls.append(("free", slot))
        self.free_slots.append(slot)

    def reset(self):
        self.calls.append(("reset",))


def _replicated_script(ctx: Rank, script: str):
    """Rank 0 drives a `ReplicatedEngine` over a `RecordingEngine`; the
    others run `follower_loop` on theirs. Returns (calls, free slots, the
    number of ops replayed or None)."""
    from text_generation_inference_tpu_torch.engine.engine import (
        RequestParams)
    from text_generation_inference_tpu_torch.parallel import multihost

    engine = RecordingEngine()
    if ctx.rank != 0:
        n = multihost.follower_loop(engine, ctx.channel)
        return engine.calls, sorted(engine.free_slots), n
    wrapped = multihost.ReplicatedEngine(engine, ctx.channel,
                                         keepalive_s=None)
    if script == "order":
        slot = wrapped.free_slots.pop()     # host-only: passes through
        wrapped.prefill([slot], [[5, 6]], [RequestParams(max_new_tokens=2)])
        h = wrapped.decode_steps_begin(want_details=False, chunk=4)
        wrapped.decode_steps_end(h)
        wrapped.decode_steps(want_details=True, chunk=None)
        wrapped.free(slot)
        wrapped.reset()
    elif script == "pipeline":
        # the batcher's two-deep pipeline: begin N+1 before end N
        handles = [wrapped.decode_steps_begin()]
        for _ in range(3):
            handles.append(wrapped.decode_steps_begin())
            wrapped.decode_steps_end(handles.pop(0))
        wrapped.decode_steps_end(handles.pop(0))
    wrapped.shutdown()
    return engine.calls, sorted(engine.free_slots), None


def _keepalive(ctx: Rank, idle_s: float, keepalive_s: float):
    """Rank 0 idles `idle_s` behind a ReplicatedEngine that pings every
    `keepalive_s`, then frees a slot and stops; the others return (ops
    replayed, pings received)."""
    from text_generation_inference_tpu_torch.parallel import multihost

    engine = RecordingEngine()
    if ctx.rank == 0:
        wrapped = multihost.ReplicatedEngine(engine, ctx.channel,
                                             keepalive_s=keepalive_s)
        threading.Event().wait(idle_s)
        wrapped.free(0)
        wrapped.shutdown()
        return None
    pings = [0]
    recv = ctx.channel.recv

    def counting_recv():
        op = recv()
        pings[0] += op[0] == multihost.OP_PING
        return op

    ctx.channel.recv = counting_recv
    try:
        n = multihost.follower_loop(engine, ctx.channel)
    finally:
        ctx.channel.recv = recv
    return n, pings[0], engine.calls


def _follower_handles(ctx: Rank):
    """The follower's outstanding handles, read at every op of the
    pipelined script: never more than the pipeline's depth."""
    from text_generation_inference_tpu_torch.parallel import multihost

    if ctx.rank == 0:
        return _replicated_script(ctx, "pipeline")
    engine = RecordingEngine()
    depth, seen = [0], []
    begin = engine.decode_steps_begin

    def counting_begin(**kw):
        depth[0] += 1
        seen.append(depth[0])
        return begin(**kw)

    recv = ctx.channel.recv

    def counting_recv():
        op = recv()
        if op[0] == multihost.OP_DECODE_END:
            depth[0] -= 1
        return op

    engine.decode_steps_begin = counting_begin
    ctx.channel.recv = counting_recv
    try:
        multihost.follower_loop(engine, ctx.channel)
    finally:
        ctx.channel.recv = recv
    return max(seen), depth[0]


def _batcher(ctx: Rank, model_dir: str, kind: str, requests: list,
             config_kw: dict):
    """Rank 0 serves `requests` ((text, max_new, streaming) tuples) through
    the port's Batcher over a `ReplicatedEngine`; the others replay.
    Returns rank 0's generated ids and texts; the others' op counts."""
    from text_generation_inference_tpu_torch.parallel import multihost

    engine, tokenizer, config = batcher_engine(model_dir, kind, config_kw,
                                               tp=ctx.tp)
    if ctx.rank != 0:
        return multihost.follower_loop(engine, ctx.channel)
    wrapped = multihost.ReplicatedEngine(engine, ctx.channel,
                                         keepalive_s=None)
    try:
        return run_batcher(wrapped, tokenizer, config, requests)
    finally:
        wrapped.shutdown()


def _internal(ctx: Rank, model_dir: str, calls: list, port: int):
    """Rank 0 serves generate.v1 (`INTERNAL_API=1`'s service) over a
    `ReplicatedEngine` on `port` and makes `calls` ((method, serialized
    request)) over gRPC; the others replay. Returns rank 0's responses as
    dicts; the others' op counts."""
    from text_generation_inference_tpu_torch.parallel import multihost

    engine, tokenizer, config = batcher_engine(model_dir, "paged",
                                               dict(grpc_port=port),
                                               tp=ctx.tp)
    if ctx.rank != 0:
        return multihost.follower_loop(engine, ctx.channel)
    wrapped = multihost.ReplicatedEngine(engine, ctx.channel,
                                         keepalive_s=None)
    try:
        return run_internal(wrapped, tokenizer, config, calls)
    finally:
        wrapped.shutdown()


def run_internal(engine, tokenizer, config, calls: list) -> list:
    """`calls` through a generate.v1 server on `engine`, over a socket (the
    surface the reference's router dials), then ClearCache."""
    import grpc
    from google.protobuf import json_format

    from text_generation_inference_tpu_torch.pb import generate_pb2 as pb
    from text_generation_inference_tpu_torch.server.internal_server import (
        InternalTextGenerationService, serve_internal_grpc)

    async def go():
        svc = InternalTextGenerationService(engine, tokenizer, config)
        server = await serve_internal_grpc(svc, config)
        try:
            async with grpc.aio.insecure_channel(
                    f"localhost:{config.grpc_port}") as ch:
                def rpc(name):
                    req = getattr(pb, f"{name}Request")
                    return ch.unary_unary(
                        f"/generate.v1.TextGenerationService/{name}",
                        request_serializer=req.SerializeToString,
                        response_deserializer=getattr(
                            pb, f"{name}Response").FromString), req

                out = []
                for name, blob in calls + [("ClearCache", b"")]:
                    call, req = rpc(name)
                    r = await call(req.FromString(blob))
                    out.append((name, json_format.MessageToDict(
                        r, preserving_proto_field_name=True)))
                return out
        finally:
            await server.stop(grace=1)

    return asyncio.run(go())


def batcher_engine(model_dir: str, kind: str, config_kw: dict, tp=None):
    """The engine (slot or paged), tokenizer and config of a Batcher run on
    the fixture checkpoint `model_dir`, on a rank's group or alone."""
    from text_generation_inference_tpu_torch.config import ServingConfig
    from text_generation_inference_tpu_torch.engine.engine import (
        InferenceEngine)
    from text_generation_inference_tpu_torch.engine.paged_engine import (
        PagedInferenceEngine)
    from text_generation_inference_tpu_torch.models import families
    from text_generation_inference_tpu_torch.utils.tokenization import (
        ServingTokenizer)

    tokenizer = ServingTokenizer.load(model_dir)
    config = ServingConfig(**{**dict(
        model_name=model_dir, max_sequence_length=64, max_new_tokens=32,
        max_batch_size=8, max_batch_slots=4, prefill_buckets=[16, 32],
        max_waiting_tokens=4, default_max_new_tokens=20, kv_page_size=8),
        **config_kw})
    config.validate()
    spec, params = families.load_model(model_dir, dtype=torch.float32,
                                       device="cpu")
    cls = InferenceEngine if kind == "slot" else PagedInferenceEngine
    kw = {} if kind == "slot" else dict(num_pages=64)
    engine = cls(spec, params, config, eos_token_id=tokenizer.eos_token_id,
                 device="cpu", tp=tp, **kw)
    return engine, tokenizer, config


def run_batcher(engine, tokenizer, config, requests: list) -> list:
    """Each request's (generated ids, text) through a Batcher on `engine`;
    the requests arrive in two waves, the second while the first decodes,
    some streaming."""
    from text_generation_inference_tpu_torch.engine.engine import (
        RequestParams)
    from text_generation_inference_tpu_torch.scheduler.batcher import Batcher
    from text_generation_inference_tpu_torch.scheduler.request import (
        GenRequest, ResponseOptions, StoppingCriteria)

    def make(text, new, streaming):
        return GenRequest(
            input_text=text, input_ids=tokenizer.encode(text),
            params=RequestParams(max_new_tokens=new, min_new_tokens=new),
            stopping=StoppingCriteria(max_new_tokens=new, min_new_tokens=new),
            options=ResponseOptions(generated_tokens=True),
            streaming=streaming)

    async def drive():
        batcher = Batcher(engine, tokenizer, config)
        batcher.start()
        try:
            reqs = [make(*r) for r in requests]
            half = len(reqs) // 2
            batcher.submit_all(reqs[:half])
            await asyncio.sleep(0.05)
            batcher.submit_all(reqs[half:])
            for r in reqs:
                if r.streaming:
                    while (await r.stream_queue.get())[0] != "final":
                        pass
            for r in reqs:
                await asyncio.wait_for(r.result_future, 120)
            return [([rec.token_id for rec in r.generated], r.final_text())
                    for r in reqs]
        finally:
            await batcher.stop()

    return asyncio.run(drive())


def _build(ctx: Rank, model_dir: str, env: dict):
    """`server.main.build_engine` on the rank's group under `env`: the
    engine's type, spec widths and whether it holds a rank's shard, or the
    error it raised."""
    import os

    from text_generation_inference_tpu_torch.config import ServingConfig
    from text_generation_inference_tpu_torch.server.main import build_engine

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        config = ServingConfig(model_name=model_dir, max_sequence_length=64,
                               max_new_tokens=16, max_batch_slots=2,
                               prefill_buckets=[16, 32], kv_page_size=8)
        config.validate()
        try:
            engine, _, kind = build_engine(config, "cpu", ctx.tp)
        except ValueError as e:
            return ("refused", str(e))
        spec = engine.spec
        return (type(engine).__name__, kind, getattr(spec, "tp", None)
                is not None, getattr(spec, "num_heads", None))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


CASES = {
    "logits": _logits,
    "streams": _streams,
    "op_roundtrip": _op_roundtrip,
    "concurrent_senders": _concurrent_senders,
    "replicated_script": _replicated_script,
    "follower_handles": _follower_handles,
    "keepalive": _keepalive,
    "batcher": _batcher,
    "internal": _internal,
    "build": _build,
}


def numpy_tree(tree):
    """A JAX param tree with numpy leaves (None kept)."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(None if f is None else np.asarray(f)
                            for f in tree))
    return np.asarray(tree)
