#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

  1. build   every kernel in text_generation_inference_tpu_torch/csrc/ with
             nvcc (one process per source, in parallel) and print the card's
             name and power limit (nvidia-smi).
  2. kernels hold each hand-written kernel against its plain PyTorch version
             at TinyLlama-1.1B widths in bf16 (flash prefill also at head
             dim 128), and time it, its plain version and one PyTorch
             library call on the same work (CUDA events, L2 flushed between
             launches), beside the least time the card could take.
  3. parity  one `prefill_paged` and a few `decode_paged` steps of the
             full-width model, with the kernels and with the plain attention
             functions (`ops.attention.PLAIN`); logits and greedy tokens are
             compared.
  4. serve   a PagedInferenceEngine at full TinyLlama-1.1B width (22 layers,
             random bf16 weights from a seeded generator on the card) behind
             the port's Batcher, twice: decode chunks of 8 with the
             dense-gather branch on (paged_gather_ctx_max=1024), then the
             default config (per-step decode, every streaming chunk through
             the paged kernel's stats mode). Launch counts are zeroed just
             before each run and read just after; every kernel must have run.
             When grpc imports, one Generate and one GenerateStream also go
             through the port's gRPC server on a local port.
  5. profile 16 per-step decodes of 8 live requests under torch.profiler:
             wall and device-busy time per step, and the top kernels.

The second-to-last line of output is the `kernels` JSON record, the last
line the device record. Exits non-zero without CUDA, or when the port's
package is not beside this script.
"""

from __future__ import annotations

import asyncio
import json
import math
import subprocess
import sys
import time

import numpy as np

SEED = 1234
DEVICE = "cuda"                 # the CPU only in a rehearsal at tiny widths
DTYPE = None                    # torch.bfloat16, set in main()
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores
# the JAX reference package's directory (named here, never imported)
JAX_PACKAGE_DIR = "text_generation_inference" + "_tpu"
PORT_DIR = "text_generation_inference_tpu_torch"

# TinyLlama-1.1B (config.json of TinyLlama/TinyLlama-1.1B-Chat-v1.0)
TINYLLAMA = dict(vocab_size=32000, hidden_size=2048, num_layers=22,
                 num_heads=32, num_kv_heads=4, head_dim=64,
                 intermediate_size=5632, rope_theta=10000.0, norm_eps=1e-5,
                 max_position_embeddings=2048)


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


# --- timing and bounds ------------------------------------------------------


class Timer:
    """Mean device time of a call with CUDA events, the L2 cache flushed
    (a 64 MiB write) before every launch and outside the timed span."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8,
                                     device="cuda")

    def __call__(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        events = []
        for _ in range(iters):
            self.flush_buf.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events) / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# --- phase 2: kernels -------------------------------------------------------


def check_flash_prefill(torch, timer, d: int, kh: int, g: int):
    from text_generation_inference_tpu_torch.ops.cuda import flash_prefill as fp

    gen = torch.Generator(device="cuda").manual_seed(SEED + d)
    n, t = 2, 2048
    lengths = torch.tensor([1500, 900], dtype=torch.int32, device="cuda")

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v = rnd(n, t, kh, g, d), rnd(n, t, kh, d), rnd(n, t, kh, d)
    got = fp.flash_prefill(q, k, v, lengths)
    want = fp.flash_prefill_reference(q, k, v, lengths)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    # the kernel rounds P to bf16 for the tensor-core value product (as
    # FlashAttention-2 does) and both round the output to bf16 once: allow
    # about two bf16 ulps, atol 2e-2 + rtol 1e-2
    atol, rtol = 2e-2, 1e-2
    tol = f"atol {atol} + rtol {rtol}"
    if not bool((diff <= atol + rtol * want.float().abs()).all()):
        raise AssertionError(f"flash_prefill D={d}: max abs err {err} "
                             f"outside {tol}")
    ms = timer(lambda: fp.flash_prefill(q, k, v, lengths))
    plain_ms = timer(lambda: fp.flash_prefill_reference(q, k, v, lengths),
                     iters=3, warmup=1)
    # yardstick: one causal SDPA call over the full bucket (no lengths)
    qh = q.reshape(n, t, kh * g, d).transpose(1, 2).contiguous()
    kx = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    vx = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = timer(lambda: sdpa(qh, kx, vx, is_causal=True))
    # work this run's data needs: query row i sees min(i+1, len) keys
    rows = torch.arange(1, t + 1, device="cuda")
    pairs = sum(int(torch.clamp(rows, max=int(ln)).sum()) for ln in lengths)
    flops = 4.0 * d * kh * g * pairs
    b_ms, b_by = bound(nbytes(q, k, v, got, lengths), flops)
    log(f"kernel flash_prefill D={d} N={n} T={t} H={kh * g} KV={kh}: "
        f"max_abs_err {err:.3e} (tol {tol}) ms {ms:.4f} plain_ms "
        f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms {b_ms:.4f} "
        f"({b_by})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


def paged_inputs(torch, s=16, kh=4, g=8, d=64, page=128, max_pages=16):
    """Decode inputs at TinyLlama widths: 16 slots with contexts mixed up to
    2048, pages scattered over a pool four times the live size."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rng = np.random.default_rng(SEED)
    ctx = np.concatenate([[1, 127, 128, 129, 2048],
                          rng.integers(1, 2049, size=s - 5)]).astype(np.int32)
    num_pages = 4 * s * max_pages
    perm = rng.permutation(num_pages)
    bt = np.full((s, max_pages), num_pages, np.int32)
    used = 0
    for i in range(s):
        need = -(-int(ctx[i]) // page)
        bt[i, :need] = perm[used:used + need]
        used += need

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    q = rnd(s, kh, g, d)
    kp = rnd(kh, num_pages * page, d)
    vp = rnd(kh, num_pages * page, d)
    return (q, kp, vp, torch.from_numpy(bt).cuda(), torch.from_numpy(ctx).cuda(),
            page)


def paged_library_call(torch, q, kp, vp, bt, ctx, page):
    """One SDPA call on the same work: the live pages gathered (outside the
    timing) into a dense [S, H, T, D] view with a length mask."""
    s, kh, g, d = q.shape
    t = int(ctx.max())
    rows = (bt.long()[:, :, None] * page
            + torch.arange(page, device="cuda")).reshape(s, -1)[:, :t]
    rows = rows.clamp(max=kp.shape[1] - 1)
    kd = kp[:, rows].permute(1, 0, 2, 3).repeat_interleave(g, dim=1)
    vd = vp[:, rows].permute(1, 0, 2, 3).repeat_interleave(g, dim=1)
    mask = (torch.arange(t, device="cuda")[None, :] < ctx[:, None])[:, None, None]
    qh = q.reshape(s, kh * g, 1, d)
    kd, vd = kd.contiguous(), vd.contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qh, kd, vd, attn_mask=mask)


def check_paged(torch, timer, stats: bool):
    from text_generation_inference_tpu_torch.ops.cuda import paged_attention as pa

    q, kp, vp, bt, ctx, page = paged_inputs(torch)
    s, kh, g, d = q.shape
    if stats:
        fn = lambda: pa.paged_decode_attention_partial(q, kp, vp, bt, ctx, page)
        ref = lambda: pa.paged_decode_attention_partial_reference(
            q, kp, vp, bt, ctx, page)
        got, want = fn(), ref()
        torch.cuda.synchronize()
        err = 0.0
        for a, b in zip(got, want):
            finite = torch.isfinite(b)
            if not torch.equal(finite, torch.isfinite(a)):
                raise AssertionError("paged stats: -inf pattern differs")
            err = max(err, (a[finite] - b[finite]).abs().max().item())
        scale = max(w.abs()[torch.isfinite(w)].max().item() for w in want)
        tol = 1e-3 * max(1.0, scale)
        out_bytes = nbytes(*got)
    else:
        fn = lambda: pa.paged_decode_attention(q, kp, vp, bt, ctx, page)
        ref = lambda: pa.paged_decode_attention_reference(
            q, kp, vp, bt, ctx, page)
        got, want = fn(), ref()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = 2e-2
        out_bytes = nbytes(got)
    if not err <= tol:
        raise AssertionError(f"paged decode (stats={stats}): max abs err "
                             f"{err} > {tol}")
    ms = timer(fn, iters=20)
    plain_ms = timer(ref, iters=3, warmup=1)
    library_ms = timer(paged_library_call(torch, q, kp, vp, bt, ctx, page))
    live = int(ctx.sum())
    kv_bytes = 2 * live * kh * d * kp.element_size()
    flops = 4.0 * live * kh * g * d
    b_ms, b_by = bound(nbytes(q, bt, ctx) + kv_bytes + out_bytes, flops)
    name = "paged_decode_attention_stats" if stats else "paged_decode_attention"
    log(f"kernel {name} S={s} KV={kh} G={g} D={d} page={page} ctx_max="
        f"{int(ctx.max())} live_tokens={live}: max_abs_err {err:.3e} (tol "
        f"{tol:.3e}) ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{library_ms:.4f} bound_ms {b_ms:.4f} ({b_by})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


# --- the model --------------------------------------------------------------


def tinyllama_spec():
    from text_generation_inference_tpu_torch.models.core import DecoderSpec

    return DecoderSpec(pos="rope", norm="rmsnorm", activation="silu_glu",
                       **TINYLLAMA)


def random_params(torch, spec):
    """Layer-stacked bf16 params drawn on the card from a seeded generator
    (scale 1/sqrt(fan_in), embeddings 0.02), the JAX package's init rule."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    L, D, F = spec.num_layers, spec.hidden_size, spec.intermediate_size
    Q, KV = spec.q_size, spec.kv_size

    def dense(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
        return (torch.randn(*shape, generator=gen, device=DEVICE) * scale
                ).to(DTYPE)

    ones = lambda *shape: torch.ones(*shape, dtype=DTYPE, device=DEVICE)
    return {
        "embed_tokens": dense(spec.vocab_size, D, scale=0.02),
        "layers": {
            "ln1": {"scale": ones(L, D)}, "ln2": {"scale": ones(L, D)},
            "wq": dense(L, D, Q), "wk": dense(L, D, KV), "wv": dense(L, D, KV),
            "wo": dense(L, Q, D), "w_gate": dense(L, D, F),
            "w_up": dense(L, D, F), "w_down": dense(L, F, D),
        },
        "final_norm": {"scale": ones(D)},
        "lm_head": dense(D, spec.vocab_size),
    }


def model_parity(torch, spec, params):
    """prefill_paged + 4 decode_paged steps with the kernels and with the
    plain attention functions; both fed the same (plain) greedy tokens."""
    from text_generation_inference_tpu_torch.engine.paged_cache import PagedKVCache
    from text_generation_inference_tpu_torch.models import paged_core
    from text_generation_inference_tpu_torch.models.fuse import fuse_params
    from text_generation_inference_tpu_torch.ops.attention import KERNELS, PLAIN

    params = fuse_params(spec, params)
    page, t, n = 128, 1024, 2
    lengths = torch.tensor([700, 300], dtype=torch.int32, device=DEVICE)
    slots = torch.tensor([0, 1], dtype=torch.int32, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    ids = torch.randint(3, spec.vocab_size, (n, t), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    max_pages = t // page + 1
    caches = {}
    for name in ("kernels", "plain"):
        c = PagedKVCache.create(spec, 2 * max_pages, page, n, max_pages,
                                DTYPE, DEVICE)
        c.block_table.copy_(torch.arange(2 * max_pages, dtype=torch.int32,
                                         device=DEVICE).reshape(n, max_pages))
        caches[name] = c
    logits, errs, agree, decided = {}, [], 0, 0
    for name, attn in (("kernels", KERNELS), ("plain", PLAIN)):
        lg, _ = paged_core.prefill_paged(spec, params, ids, lengths, slots,
                                         caches[name], page, attn=attn)
        logits[name] = [lg[torch.arange(n), lengths.long() - 1]]
    pos = lengths.clone()
    next_ids = logits["plain"][0].argmax(-1).to(torch.int32)
    for _ in range(4):
        for name, attn in (("kernels", KERNELS), ("plain", PLAIN)):
            lg, _ = paged_core.decode_paged(spec, params, next_ids, pos,
                                            caches[name], pos + 1, page,
                                            attn=attn)
            logits[name].append(lg)
        next_ids = logits["plain"][-1].argmax(-1).to(torch.int32)
        pos = pos + 1
    sync(torch)
    max_err = max((a - b).abs().max().item()
                  for a, b in zip(logits["kernels"], logits["plain"]))
    for a, b in zip(logits["kernels"], logits["plain"]):
        if not (torch.isfinite(a).all() and a.shape == (n, spec.vocab_size)):
            raise AssertionError("parity: kernel logits not finite / bad shape")
        top2 = b.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        clear = margin > 2 * max_err     # decisions outside the noise
        same = a.argmax(-1) == b.argmax(-1)
        if not bool(same[clear].all()):
            raise AssertionError("parity: greedy token differs where the "
                                 "plain top-2 margin exceeds the noise")
        agree += int(same.sum())
        decided += same.numel()
    tol = 0.25
    if not max_err <= tol:
        raise AssertionError(f"parity: logits max abs err {max_err} > {tol}")
    log(f"parity: prefill (N={n}, bucket {t}, lengths 700/300) + 4 decode "
        f"steps, {spec.num_layers} layers: logits max abs err {max_err:.4f} (tol {tol}), "
        f"greedy tokens equal {agree}/{decided}")


# --- phase 4: serving -------------------------------------------------------


class ByteTokenizer:
    """Byte-level tokenizer: id = byte + 3 (0 pad, 1 bos, 2 eos); ids past
    258 decode to nothing. Needs neither `tokenizers` nor a vocab file."""

    eos_token_id = 2
    decoder_type = None
    vocab_size = TINYLLAMA["vocab_size"]

    def encode(self, text, add_special_tokens=False):
        return [b + 3 for b in text.encode("utf-8")]

    def decode(self, ids, skip_special_tokens=True):
        data = bytes(i - 3 for i in ids if 3 <= i < 259)
        return data.decode("utf-8", errors="replace")

    def id_to_token(self, token_id):
        return self.decode([token_id])


PROMPT_LENS_A = [100, 180, 260, 400, 560, 720]      # wave A: unary
PROMPT_LENS_B = [1100, 1300, 1500, 1240]            # wave B: 2 streaming


def make_requests(lens, streaming_every, seed_base):
    from text_generation_inference_tpu_torch.engine.engine import RequestParams
    from text_generation_inference_tpu_torch.scheduler.request import (
        GenRequest, ResponseOptions, StoppingCriteria)

    rng = np.random.default_rng(SEED)
    reqs = []
    for i, n in enumerate(lens):
        sampled = i % 2 == 1
        new = 48
        rp = RequestParams(max_new_tokens=new,
                           temperature=0.8 if sampled else 0.0,
                           top_k=50 if sampled else 0,
                           seed=seed_base + i if sampled else 0)
        ids = [int(x) for x in rng.integers(3, 259, size=n)]
        reqs.append(GenRequest(
            input_text="", input_ids=ids, params=rp,
            stopping=StoppingCriteria(max_new_tokens=new),
            options=ResponseOptions(),
            streaming=bool(streaming_every) and i % streaming_every == 0))
    return reqs


async def run_wave(batcher, reqs):
    """Submit a wave, await every result; returns TTFT of streaming ones."""
    from text_generation_inference_tpu_torch.scheduler.request import StopReason

    t0 = time.monotonic()
    batcher.submit_all(reqs)
    ttft = []

    async def drain(req):
        first, pieces = None, []
        while True:
            ev = await req.stream_queue.get()
            if ev[0] == "token":
                if first is None:
                    first = time.monotonic() - t0
                pieces.append(ev[2])
            elif ev[0] == "final":
                pieces.append(ev[2])
                break
        ttft.append(first)
        return "".join(pieces)

    streams = {r.id: asyncio.ensure_future(drain(r)) for r in reqs
               if r.streaming}
    for r in reqs:
        await r.result_future
        if r.stop_reason not in (StopReason.MAX_TOKENS, StopReason.EOS_TOKEN):
            raise AssertionError(f"request {r.id} ended {r.stop_reason!r}: "
                                 f"{r.error}")
        toks = [rec.token_id for rec in r.generated]
        if not toks or not all(0 <= x < TINYLLAMA["vocab_size"] for x in toks):
            raise AssertionError(f"request {r.id}: bad tokens")
        if r.stop_reason == StopReason.MAX_TOKENS and \
                len(toks) != r.stopping.max_new_tokens:
            raise AssertionError(f"request {r.id}: {len(toks)} tokens")
    for r in reqs:
        if r.streaming:
            text = await streams[r.id]
            if text != r.final_text():
                raise AssertionError(f"request {r.id}: stream text differs "
                                     "from the final text")
    return ttft


async def grpc_roundtrip(batcher, config, tokenizer):
    import grpc

    from text_generation_inference_tpu_torch.pb import generation_pb2 as pb
    from text_generation_inference_tpu_torch.server.grpc_server import (
        GenerationServicer, make_handler)

    servicer = GenerationServicer(config, tokenizer, batcher)
    server = grpc.aio.server()
    server.add_generic_rpc_handlers((make_handler(servicer),))
    port = server.add_insecure_port("127.0.0.1:0")
    await server.start()
    try:
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            generate = ch.unary_unary(
                "/fmaas.GenerationService/Generate",
                request_serializer=pb.BatchedGenerationRequest.SerializeToString,
                response_deserializer=pb.BatchedGenerationResponse.FromString)
            stream = ch.unary_stream(
                "/fmaas.GenerationService/GenerateStream",
                request_serializer=pb.SingleGenerationRequest.SerializeToString,
                response_deserializer=pb.GenerationResponse.FromString)
            params = pb.Parameters(stopping=pb.StoppingCriteria(max_new_tokens=16))
            text = "The port serves this prompt over gRPC. " * 4
            resp = await generate(pb.BatchedGenerationRequest(
                requests=[pb.GenerationRequest(text=text)], params=params))
            r = resp.responses[0]
            if r.generated_token_count != 16 or r.input_token_count != len(text):
                raise AssertionError(f"gRPC Generate: {r}")
            msgs = [m async for m in stream(pb.SingleGenerationRequest(
                request=pb.GenerationRequest(text=text), params=params))]
            if msgs[-1].generated_token_count != 16 or \
                    "".join(m.text for m in msgs[1:]) != r.text:
                raise AssertionError("gRPC GenerateStream differs from Generate")
        log(f"grpc: Generate + GenerateStream on 127.0.0.1:{port}: 16 tokens "
            "each, stream text == unary text")
    finally:
        await server.stop(grace=1.0)
        servicer.async_tokenizer.shutdown()


def profile_decode(torch, spec, params, steps: int = 16):
    """Where a decode step's time goes: 8 live requests (512-token prompts)
    on the default engine, `steps` per-step decodes under torch.profiler.
    Prints the step's wall time, the card's busy time and share, and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from text_generation_inference_tpu_torch.config import ServingConfig
    from text_generation_inference_tpu_torch.engine.engine import RequestParams
    from text_generation_inference_tpu_torch.engine.paged_engine import (
        PagedInferenceEngine)

    config = ServingConfig(max_sequence_length=2048, max_new_tokens=256,
                           max_batch_slots=16, kv_page_size=128)
    config.validate()
    engine = PagedInferenceEngine(spec, params, config, eos_token_id=2,
                                  device=DEVICE)
    rng = np.random.default_rng(SEED + 11)
    slots = [engine.acquire_slot() for _ in range(8)]
    engine.prefill(slots, [[int(x) for x in rng.integers(3, 259, 512)]
                           for _ in slots],
                   [RequestParams(max_new_tokens=steps + 8)] * len(slots))
    for _ in range(3):
        engine.decode_steps(want_details=False)
    sync(torch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            engine.decode_steps(want_details=False)
        sync(torch)
        wall_ms = (time.monotonic() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0:
            kernels.append((dev_us / 1e3, evt.count, evt.key))
    busy_ms = sum(k[0] for k in kernels)
    kernels.sort(reverse=True)
    log(f"profile: {steps} decode steps (8 live slots, ctx ~520, chunk 1): "
        f"wall {wall_ms / steps:.3f} ms/step, device busy "
        f"{busy_ms / steps:.3f} ms/step ({100 * busy_ms / wall_ms:.1f}% "
        f"busy, {100 - 100 * busy_ms / wall_ms:.1f}% idle)")
    for ms, count, key in kernels[:8]:
        log(f"profile:   {ms / steps:8.4f} ms/step  {count // steps:4d} "
            f"launches/step  {key[:90]}")


def serve_run(torch, spec, params, name, overrides, counters, with_grpc):
    from text_generation_inference_tpu_torch.config import ServingConfig
    from text_generation_inference_tpu_torch.engine.paged_engine import (
        PagedInferenceEngine)
    from text_generation_inference_tpu_torch.scheduler.batcher import Batcher

    config = ServingConfig(max_sequence_length=2048, max_new_tokens=256,
                           max_batch_slots=16, kv_page_size=128,
                           **overrides)
    config.validate()
    engine = PagedInferenceEngine(spec, params, config,
                                  eos_token_id=ByteTokenizer.eos_token_id,
                                  device=DEVICE)
    engine.warmup(batch_sizes=(1,))
    tokenizer = ByteTokenizer()

    async def drive():
        batcher = Batcher(engine, tokenizer, config)
        batcher.start()
        try:
            t0 = time.monotonic()
            wave_a = make_requests(PROMPT_LENS_A, 0, 100)
            wave_b = make_requests(PROMPT_LENS_B, 2, 200)
            ttft = await run_wave(batcher, wave_a)
            ttft += await run_wave(batcher, wave_b)
            sync(torch)
            wall = time.monotonic() - t0
            reqs = wave_a + wave_b
            if with_grpc:
                await grpc_roundtrip(batcher, config, tokenizer)
            return reqs, wall, ttft
        finally:
            await batcher.stop()

    for c in counters.values():
        c.reset()
    reqs, wall, ttft = asyncio.run(drive())
    counts = {k: c.read() for k, c in counters.items()}
    tokens = sum(r.generated_count for r in reqs)
    log(f"serve[{name}] {overrides}: {len(reqs)} requests, prompts "
        f"{min(r.input_length for r in reqs)}..{max(r.input_length for r in reqs)}"
        f" tokens, {tokens} tokens generated in {wall:.2f}s wall "
        f"({tokens / wall:.1f} tok/s), streaming TTFT mean "
        f"{np.mean(ttft) * 1e3:.1f} ms max {np.max(ttft) * 1e3:.1f} ms; "
        f"launches {counts}")
    return counts


class Counter:
    """Reads and zeroes one launch counter (an attribute on a wrapper)."""

    def __init__(self, holder, attr="launches"):
        self.holder, self.attr = holder, attr

    def reset(self):
        setattr(self.holder, self.attr, 0)

    def read(self):
        return getattr(self.holder, self.attr)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        from text_generation_inference_tpu_torch.models import paged_core
        from text_generation_inference_tpu_torch.ops.cuda import build
        from text_generation_inference_tpu_torch.ops.cuda import flash_prefill as fp
        from text_generation_inference_tpu_torch.ops.cuda import paged_attention as pa
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script: {e}",
              file=sys.stderr)
        return 1
    global DTYPE
    DTYPE = torch.bfloat16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    t0 = time.monotonic()
    logs = build.build_all()
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas[{name}] {line.strip()}")
    log(f"build: {len(logs)} sources in {time.monotonic() - t0:.1f}s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)

    timer = Timer(torch)
    fp64 = check_flash_prefill(torch, timer, d=64, kh=4, g=8)
    fp128 = check_flash_prefill(torch, timer, d=128, kh=8, g=4)
    pn = check_paged(torch, timer, stats=False)
    ps = check_paged(torch, timer, stats=True)

    spec = tinyllama_spec()
    params = random_params(torch, spec)
    model_parity(torch, spec, params)

    # the dense-gather branch is not a kernel; count its calls to show run 1
    # reached it
    dense_gather = paged_core.gather_dense_view

    def counted_gather(*args, **kw):
        counted_gather.calls += 1
        return dense_gather(*args, **kw)

    counted_gather.calls = 0
    paged_core.gather_dense_view = counted_gather
    counters = {"flash_prefill": Counter(fp.flash_prefill),
                "paged_decode_attention": Counter(pa.paged_decode_attention),
                "paged_decode_attention_stats":
                    Counter(pa.paged_decode_attention_partial),
                "dense_gather_chunks": Counter(counted_gather, "calls")}
    try:
        import grpc  # noqa: F401
        import google.protobuf  # noqa: F401
        with_grpc = True
    except ImportError:
        with_grpc = False
        log("grpc / protobuf not installed: the gRPC surface is covered by "
            "the CPU tests only")
    run1 = serve_run(torch, spec, params, "dense-gather",
                     dict(decode_chunk=8, paged_gather_ctx_max=1024),
                     counters, with_grpc=False)
    run2 = serve_run(torch, spec, params, "default",
                     dict(paged_gather_ctx_max=0), counters,
                     with_grpc=with_grpc)
    required = [(run1, "flash_prefill"), (run1, "paged_decode_attention_stats"),
                (run1, "dense_gather_chunks"), (run2, "flash_prefill"),
                (run2, "paged_decode_attention"),
                (run2, "paged_decode_attention_stats")]
    for run, key in required:
        if run[key] <= 0:
            raise AssertionError(f"{key} never ran in a serving run: {run}")

    profile_decode(torch, spec, params)

    def record(name, source, replaces, res):
        return {"name": name, "route": "cuda",
                "source": f"{PORT_DIR}/csrc/{source}",
                "replaces": f"{JAX_PACKAGE_DIR}/ops/pallas/{replaces}",
                "launches": run1[name] + run2[name],
                "max_abs_err": res["err"], "ms": res["ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"], "library_ms": res["library_ms"]}

    kernels = [
        record("flash_prefill", "flash_prefill.cu", "flash_prefill.py:143",
               fp64),
        record("paged_decode_attention", "paged_attention.cu",
               "paged_attention.py:261", pn),
        record("paged_decode_attention_stats", "paged_attention.cu",
               "paged_attention.py:407", ps),
    ]
    log(f"flash_prefill at D=128 (H=32, KV=8): {json.dumps(fp128)}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
