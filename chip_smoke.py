#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

  1. build   every kernel in text_generation_inference_tpu_torch/csrc/ with
             nvcc (one process per source, in parallel) and print the card's
             name and power limit (nvidia-smi).
  2. kernels hold each hand-written kernel against its plain PyTorch version
             and time it, its plain version and one PyTorch library call on
             the same work (CUDA events, L2 flushed between launches),
             beside the least time the card could take: flash prefill and
             paged decode at TinyLlama-1.1B widths in bf16 (flash prefill
             also at head dim 128, G=4 and G=1); the int8 paged decode (K2)
             and the GPTQ-INT4 dequant-GEMM (K1, on a Llama-2-7B layer's four
             products at 16 and 2048 rows, and one act-order weight) at
             Llama-2-7B widths; the fused GPTQ-INT4 MLP (M1) on a 7B layer's
             MLP at 16 and 64 rows, silu and gelu_glu, also beside the two-K1
             route on the same work; the slot-cache decode kernel (S1) at
             TinyLlama and 7B decode widths over a 2048-row cache, and the
             ring-decode kernel (S2) at the decode probe's shapes (48 slots,
             1024 cache rows, a ring of 64) at ring steps 0, 32 and 63.
  3. parity  one prefill and a few decode steps with the kernels and with
             their plain versions (`ops.attention.PLAIN`); logits and
             greedy tokens are compared: the full-width bf16 TinyLlama
             (`decode_paged` steps), the same model on the slot cache
             (`core.prefill`, then scan-mode `core.decode` steps at
             max_seq 2048, through S1), then a 4-layer GPTQ-INT4 model at
             7B widths over an int8 pool (ring-decode steps and a flush),
             with K1 for every product and with the MLP through M1.
  4. serve   a PagedInferenceEngine behind the port's Batcher. Runs 1 and 2:
             full TinyLlama-1.1B width (22 layers, random bf16 weights from
             a seeded generator on the card), decode chunks of 8 with the
             dense-gather branch on (paged_gather_ctx_max=1024), then the
             default config (per-step decode, every streaming chunk through
             the paged kernel's stats mode). Run 3: Llama-2-7B widths (32
             layers, random GPTQ-INT4 weights made on the card), int8 KV,
             decode chunks of 8, every chunk through K2
             (paged_gather_ctx_max=0). Launch counts are zeroed just before
             each run and read just after; every kernel of the run's path
             must have run. When grpc imports, one Generate and one
             GenerateStream also go through the port's gRPC server on a
             local port (runs 2, 3 and 4). Runs 4 and 5 serve the same
             full-width TinyLlama on the slot engine (InferenceEngine, the
             server's PAGED_ATTENTION=0), 16 slots, max_seq 2048: run 4 in
             the "scan" write mode (every decode step attends through S1),
             run 5 with an int8 KV cache and ring chunks of 8. Run 6: run
             3's config under INT4_FUSED_MLP=1 with a soft-prompt store
             (16 and 128 vectors, a raw tensor and a PEFT file), four of
             the eight requests behind a soft prompt (+ gRPC with a
             prefix_id, and an unknown one refused); M1 must replace the two
             K1 launches of every decode layer's MLP.
  5. probe   the port's ring-decode probe (`tools/probe_decode.py`): one
             chunk of 64 ring-decode steps over 48 slots at full TinyLlama
             width, attention inline (the engine's formulation) or through
             S2, at context buckets of 256 and 1024 rows; ms per step, and
             whether the two formulations choose the same greedy ids.
  6. profile decode steps under torch.profiler, after run 2 (16 per-step
             decodes of 8 live requests), after run 3 (4 chunks of 8
             steps, 16 live requests), after run 4 (16 scan-mode steps
             of 8 live requests) and after run 6 (as run 3, INT4_FUSED_MLP=1):
             wall and device-busy time per step, and the top kernels.

The second-to-last line of output is the `kernels` JSON record, the last
line the device record. Exits non-zero without CUDA, or when the port's
package is not beside this script.
"""

from __future__ import annotations

import asyncio
import json
import math
import os
import subprocess
import sys
import tempfile
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
# Llama-2-7B (config.json of meta-llama/Llama-2-7b-hf), served as GPTQ-INT4
# with group size 128 (scripts/make_shaped_checkpoint.py preset llama7b)
LLAMA7B = dict(vocab_size=32000, hidden_size=4096, num_layers=32,
               num_heads=32, num_kv_heads=32, head_dim=128,
               intermediate_size=11008, rope_theta=10000.0, norm_eps=1e-5,
               max_position_embeddings=4096)
GPTQ_GROUP = 128


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


# --- timing and bounds ------------------------------------------------------


class Timer:
    """Mean device time of a call with CUDA events, the L2 cache flushed
    (a 64 MiB write) before every launch and outside the timed span. A
    ~1 ms device sleep queued before the start event keeps the card busy
    while the host enqueues the call, so the span holds the call's device
    time, not the host time of its Python wrapper (which exceeds the device
    time of a small kernel)."""

    SLEEP_CYCLES = 2_000_000        # ~1 ms at the H100's ~2 GHz SM clock

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
            torch.cuda._sleep(self.SLEEP_CYCLES)
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


def paged_inputs(torch, s=16, kh=4, g=8, d=64, page=128, max_pages=16,
                 first_ctx=1):
    """Decode inputs (TinyLlama widths by default): 16 slots with contexts
    mixed up to max_pages * page, pages scattered over a pool four times
    the live size."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rng = np.random.default_rng(SEED)
    ctx_max = max_pages * page
    ctx = np.concatenate([[first_ctx, 127, 128, 129, ctx_max],
                          rng.integers(1, ctx_max + 1, size=s - 5)]
                         ).astype(np.int32)
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
        err, tol = stats_error(torch, got, want, "paged stats")
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


def stats_error(torch, got, want, what):
    """Max abs error of (acc, m, l) over the finite entries; the -inf
    pattern of m must match."""
    err = 0.0
    for a, b in zip(got, want):
        finite = torch.isfinite(b)
        if not torch.equal(finite, torch.isfinite(a)):
            raise AssertionError(f"{what}: -inf pattern differs")
        err = max(err, (a[finite] - b[finite]).abs().max().item())
    scale = max(w.abs()[torch.isfinite(w)].max().item() for w in want)
    return err, 1e-3 * max(1.0, scale)


def check_paged_int8(torch, timer):
    """K2, the stats mode over int8 pools, at Llama-2-7B decode widths: 16
    slots, 32 kv heads, G = 1, D = 128, page 128, contexts up to 1024 and
    one ctx == 0 slot."""
    from text_generation_inference_tpu_torch.models.core import quantize_kv
    from text_generation_inference_tpu_torch.ops.cuda import paged_attention as pa

    q, kp, vp, bt, ctx, page = paged_inputs(torch, s=16, kh=32, g=1, d=128,
                                            max_pages=8, first_ctx=0)
    kq, ks = quantize_kv(kp)
    vq, vs = quantize_kv(vp)
    # the library call's input: the dequantized pools, made outside timing
    kd = (kq.float() * ks[..., None]).to(torch.bfloat16)
    vd = (vq.float() * vs[..., None]).to(torch.bfloat16)
    del kp, vp
    s, kh, g, d = q.shape
    fn = lambda: pa.paged_decode_attention_partial_i8(q, kq, vq, ks, vs, bt,
                                                      ctx, page)
    ref = lambda: pa.paged_decode_attention_partial_reference(
        q, kq, vq, bt, ctx, page, k_scale_pool=ks, v_scale_pool=vs)
    got, want = fn(), ref()
    torch.cuda.synchronize()
    err, tol = stats_error(torch, got, want, "paged int8 stats")
    if not err <= tol:
        raise AssertionError(f"paged decode int8: max abs err {err} > {tol}")
    if not (torch.isneginf(got[1][0]).all() and (got[2][0] == 0).all()):
        raise AssertionError("paged decode int8: ctx == 0 slot not empty")
    ms = timer(fn, iters=20)
    plain_ms = timer(ref, iters=3, warmup=1)
    library_ms = timer(paged_library_call(torch, q, kd, vd, bt, ctx, page))
    live = int(ctx.sum())
    # int8 k and v rows plus one f32 scale each per (row, kv head)
    kv_bytes = 2 * live * kh * (d * kq.element_size() + ks.element_size())
    flops = 4.0 * live * kh * g * d
    b_ms, b_by = bound(nbytes(q, bt, ctx, *got) + kv_bytes, flops)
    log(f"kernel paged_decode_attention_partial_i8 S={s} KV={kh} G={g} D={d} "
        f"page={page} ctx_max={int(ctx.max())} live_tokens={live}: "
        f"max_abs_err {err:.3e} (tol {tol:.3e}) ms {ms:.4f} plain_ms "
        f"{plain_ms:.4f} library_ms {library_ms:.4f} (SDPA on the gathered, "
        f"dequantized pages) bound_ms {b_ms:.4f} ({b_by})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


# --- S1 and S2: slot-cache decode and ring decode -------------------------


def spread_ctx(s: int, t: int, seed: int):
    """Contexts for s slots spread over 0..t: an empty slot, tile and split
    edges, a full one, the rest uniform."""
    rng = np.random.default_rng(SEED + seed)
    head = [0, 1, 31, 32, 33, 255, 256, t]
    return np.concatenate([head, rng.integers(1, t + 1, size=s - len(head))]
                          ).astype(np.int32)


def bf16_close(torch, got, want, what):
    """Both versions compute in fp32 and round the output to bf16 once:
    allow about two bf16 ulps, atol 2e-2 + rtol 2e-2."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    atol = rtol = 2e-2
    if not (torch.isfinite(got).all()
            and bool((diff <= atol + rtol * want.float().abs()).all())):
        raise AssertionError(f"{what}: max abs err {err} outside atol {atol} "
                             f"+ rtol {rtol}")
    return err, f"atol {atol} + rtol {rtol}"


def sdpa_call(torch, q, keys, values, live):
    """The yardstick: one SDPA call over [S, H, N, D] keys / values (the
    GQA heads repeated beforehand) with a boolean mask of the live ones."""
    s, kh, g, d = q.shape
    qh = q.reshape(s, kh * g, 1, d)
    kx = keys.repeat_interleave(g, dim=1).contiguous()
    vx = values.repeat_interleave(g, dim=1).contiguous()
    mask = live[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qh, kx, vx, attn_mask=mask)


def check_slot_decode(torch, timer, s, kh, g, d, t=2048):
    """S1 over one layer's slot cache [S, KV, T, D], ctx spread over
    0..T."""
    from text_generation_inference_tpu_torch.ops.cuda import decode_attention as da

    gen = torch.Generator(device="cuda").manual_seed(SEED + 31 + d)
    rnd = lambda *shape: torch.randn(*shape, generator=gen,
                                     device="cuda").to(torch.bfloat16)
    q, k, v = rnd(s, kh, g, d), rnd(s, kh, t, d), rnd(s, kh, t, d)
    ctx = torch.from_numpy(spread_ctx(s, t, d)).cuda()
    fn = lambda: da.decode_attention(q, k, v, ctx)
    ref = lambda: da.decode_attention_reference(q, k, v, ctx)
    got, want = fn(), ref()
    torch.cuda.synchronize()
    err, tol = bf16_close(torch, got, want, f"decode_attention D={d}")
    if not bool((got[ctx == 0] == 0).all()):
        raise AssertionError("decode_attention: a ctx == 0 slot is not 0")
    ms = timer(fn, iters=20)
    plain_ms = timer(ref, iters=3, warmup=1)
    live_rows = torch.arange(t, device="cuda")[None, :] < ctx[:, None]
    library_ms = timer(sdpa_call(torch, q, k, v, live_rows))
    live = int(ctx.sum())
    flops = 4.0 * live * kh * g * d
    b_ms, b_by = bound(nbytes(q, ctx, got) + 2 * live * kh * d * 2, flops)
    log(f"kernel decode_attention S={s} KV={kh} G={g} D={d} T={t} "
        f"live_tokens={live}: max_abs_err {err:.3e} (tol {tol}) ms {ms:.4f} "
        f"plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} (SDPA, mask "
        f"over the whole T) bound_ms {b_ms:.4f} ({b_by})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


def check_ring_decode(torch, timer, step, s=48, kh=4, g=8, d=64, rows=1024,
                      c=64):
    """S2 at the decode probe's shapes: cache rows < ctx (spread over
    0..rows), ring columns < step, and the current token."""
    from text_generation_inference_tpu_torch.ops.cuda import ring_decode_attention as rda

    gen = torch.Generator(device="cuda").manual_seed(SEED + 41 + step)
    rnd = lambda *shape: torch.randn(*shape, generator=gen,
                                     device="cuda").to(torch.bfloat16)
    q = rnd(s, kh, g, d)
    k, v = rnd(s, kh, rows, d), rnd(s, kh, rows, d)
    kb, vb = rnd(s, kh, c, d), rnd(s, kh, c, d)
    kn, vn = rnd(s, kh, d), rnd(s, kh, d)
    ctx = torch.from_numpy(spread_ctx(s, rows, step)).cuda()
    args = (q, k, v, kb, vb, kn, vn, ctx, step)
    fn = lambda: rda.ring_decode_attention(*args)
    ref = lambda: rda.ring_decode_attention_reference(*args)
    got, want = fn(), ref()
    torch.cuda.synchronize()
    err, tol = bf16_close(torch, got, want, f"ring_decode_attention step {step}")
    ms = timer(fn, iters=20)
    plain_ms = timer(ref, iters=3, warmup=1)
    keys = torch.cat([k, kb, kn[:, :, None]], dim=2)
    values = torch.cat([v, vb, vn[:, :, None]], dim=2)
    live_rows = torch.cat([
        torch.arange(rows, device="cuda")[None, :] < ctx[:, None],
        (torch.arange(c, device="cuda") < step)[None, :].expand(s, c),
        torch.ones(s, 1, dtype=torch.bool, device="cuda")], dim=1)
    library_ms = timer(sdpa_call(torch, q, keys, values, live_rows))
    live = int(ctx.sum()) + s * (step + 1)
    flops = 4.0 * live * kh * g * d
    b_ms, b_by = bound(nbytes(q, ctx, got) + 2 * live * kh * d * 2, flops)
    log(f"kernel ring_decode_attention S={s} KV={kh} G={g} D={d} rows={rows} "
        f"ring={c} step={step} live_tokens={live}: max_abs_err {err:.3e} (tol "
        f"{tol}) ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{library_ms:.4f} (SDPA over the concatenated sources) bound_ms "
        f"{b_ms:.4f} ({b_by})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


# --- K1: the GPTQ-INT4 dequant-GEMM ------------------------------------------

# the four products of a Llama-2-7B layer, [in, out], fused as the engine
# serves them (w_qkv = wq|wk|wv, w_gu = w_gate|w_up)
K1_SHAPES = {"w_qkv": (4096, 12288), "wo": (4096, 4096),
             "w_gu": (4096, 22016), "w_down": (11008, 4096)}


def random_gptq(torch, gen, layers, in_f, out_f):
    """A layer-stacked GPTQ-INT4 weight drawn on the card: random nibbles,
    scales around 0.6 / (4.6 * sqrt(in)) as scripts/make_shaped_checkpoint.py
    draws them (x @ W keeps unit-scale activations), and zero points 7 or 8
    (stored 6 or 7, GPTQ's -1 bias) at random, so that q - zero has mean 0:
    that script's fixed zero 8 gives every weight a mean of -scale / 2,
    which a random model amplifies layer after layer."""
    from text_generation_inference_tpu_torch.ops.quant import int4

    groups = in_f // GPTQ_GROUP
    qweight = torch.randint(-2 ** 31, 2 ** 31 - 1, (layers, in_f // 8, out_f),
                            generator=gen, device=DEVICE, dtype=torch.int32)
    zeros = torch.randint(6, 8, (layers * groups, out_f), generator=gen,
                          device=DEVICE, dtype=torch.int32)
    qzeros = int4.pack_cols(zeros).reshape(layers, groups, out_f // 8)
    scales = ((torch.rand(layers, groups, out_f, generator=gen, device=DEVICE)
               + 0.5) * (0.6 / (4.6 * math.sqrt(in_f))))
    g_idx = (torch.arange(in_f, dtype=torch.int32, device=DEVICE)
             // GPTQ_GROUP).repeat(layers, 1)
    return int4.compute_zbias(int4.Int4Weight(
        qweight=qweight, qzeros=qzeros, scales=scales, g_idx=g_idx))


def int4pack(torch, w):
    """w repacked for torch._weight_int4pack_mm (tinygemm) by
    torch._convert_weight_to_int4pack: (packed, group size, scale-and-zero).
    tinygemm computes w = (q - 8) * scale + zero, so zero = 8 * scale -
    zbias."""
    from text_generation_inference_tpu_torch.ops.quant import int4

    q = int4.unpack_rows(w.qweight).t().contiguous()              # [N, K]
    q8 = ((q[:, ::2] << 4) | q[:, 1::2]).to(torch.uint8)
    packed = torch._convert_weight_to_int4pack(q8, 8)
    sz = torch.stack([w.scales, 8 * w.scales - w.zbias],
                     dim=-1).to(torch.bfloat16).contiguous()      # [G, N, 2]
    return packed, w.groupsize, sz


LIBRARY_ERRORS = (AttributeError, RuntimeError, TypeError)


def int4_library_call(torch, x, w):
    """The yardstick for K1: torch._weight_int4pack_mm on the repacked
    weight (`int4pack`). Where this PyTorch lacks the pair or refuses the
    layout, torch.matmul on the dequantized bf16 weight. Returns (fn,
    which)."""
    from text_generation_inference_tpu_torch.ops.quant import int4

    try:
        args = int4pack(torch, w)
        fn = lambda: torch._weight_int4pack_mm(x, *args)
        fn()
        return fn, "torch._weight_int4pack_mm"
    except LIBRARY_ERRORS as e:
        wd = int4.dequantize(w, torch.bfloat16)
        return (lambda: torch.matmul(x, wd),
                f"torch.matmul on the dequantized bf16 weight "
                f"({type(e).__name__}: {str(e)[:80]})")


def check_int4(torch, timer, entry: str, key: str, m: int,
               act_order: bool = False):
    """K1 through one of its three entry names on one 7B product at m rows:
    the stacked name reads layer 1 of a 2-layer stack, the packed and the
    s4 names a layer's view. With act_order, g_idx is shuffled, normalized
    into a perm, and the product goes through `linear.matmul` (the perm
    gather, then the s4 name, as a 2-D weight takes)."""
    from text_generation_inference_tpu_torch.ops import linear
    from text_generation_inference_tpu_torch.ops.cuda import int4_matmul as im
    from text_generation_inference_tpu_torch.ops.quant import int4

    in_f, out_f = K1_SHAPES[key]
    gen = torch.Generator(device="cuda").manual_seed(SEED + m + in_f + out_f)
    stack = random_gptq(torch, gen, 2, in_f, out_f)
    w = stack.layer(1)
    x = torch.randn(m, in_f, generator=gen, device="cuda").to(torch.bfloat16)
    xk = x
    if act_order:
        g_idx = w.g_idx[torch.randperm(in_f, generator=gen, device="cuda")]
        w = int4.normalize_act_order(w.qweight, w.qzeros, w.scales, g_idx)
        xk = x[:, w.perm.long()].contiguous()
        fn = lambda: linear.matmul(x, w)
    elif entry == "int4_matmul_s4_stacked":
        fn = lambda: im.int4_matmul_s4_stacked(x, stack, 1)
    else:
        fn = lambda: getattr(im, entry)(x, w)
    ref = lambda: im.int4_matmul_reference(xk, w)
    got, want = fn(), ref()
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    # the kernel rounds each dequantized weight to bf16 for the tensor
    # cores (the plain version keeps it in f32); both round y to bf16 once
    atol, rtol = 2e-2, 1e-2
    if not bool((diff <= atol + rtol * want.float().abs()).all()):
        raise AssertionError(f"{entry} {key} M={m}: max abs err {err} outside "
                             f"atol {atol} + rtol {rtol}")
    kernel = (lambda: im.int4_matmul_s4(xk, w)) if act_order else fn
    ms = timer(kernel)
    plain_ms = timer(ref, iters=3, warmup=1)
    lib_fn, lib_name = int4_library_call(torch, xk, w)
    lib_err = (lib_fn().float() - want.float()).abs().max().item()
    library_ms = timer(lib_fn)
    b_ms, b_by = bound(nbytes(w.qweight, w.scales, w.zbias, x, got),
                       2.0 * m * in_f * out_f)
    log(f"kernel {entry} {key} [{in_f}, {out_f}] M={m}"
        f"{' act-order' if act_order else ''}: max_abs_err {err:.3e} (tol "
        f"atol {atol} + rtol {rtol}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms {library_ms:.4f} ({lib_name}, max abs diff from plain "
        f"{lib_err:.3e}) bound_ms {b_ms:.4f} ({b_by})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, library=lib_name)


# a Llama-2-7B layer's MLP: hidden, intermediate
M1_SHAPE = (4096, 11008)


def mlp_close(torch, got, want, what):
    """M1 rounds every dequantized weight and the GLU output `a` to bf16
    for the tensor cores (the plain version keeps the weights in f32): its
    error grows with the terms summed, not with each output. Allowed: 3e-2
    of the largest output plus 2e-2 relative."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    scale = max(1.0, want.float().abs().max().item())
    atol, rtol = 3e-2 * scale, 2e-2
    if not (torch.isfinite(got).all()
            and bool((diff <= atol + rtol * want.float().abs()).all())):
        raise AssertionError(f"{what}: max abs err {err} outside atol {atol} "
                             f"+ rtol {rtol}")
    return err, f"atol {atol:.3g} (3e-2 of max |y|) + rtol {rtol}"


def check_int4_mlp(torch, timer, m: int, activation: str):
    """M1 on a 7B layer's MLP (layer 1 of 2-layer stacks: w_gu [4096,
    22016], w_down [11008, 4096], group 128) at m rows, against its plain
    version; beside it the two-K1 route on the same work (K1 on w_gu, the
    activation, K1 on w_down) and the library yardstick
    (torch._weight_int4pack_mm on each weight, the activation between)."""
    from text_generation_inference_tpu_torch.ops.cuda import int4_matmul as im
    from text_generation_inference_tpu_torch.ops.cuda import int4_mlp as mlp

    h, inter = M1_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 61 + m)
    gu = random_gptq(torch, gen, 2, h, 2 * inter)
    down = random_gptq(torch, gen, 2, inter, h)
    x = torch.randn(m, h, generator=gen, device="cuda").to(torch.bfloat16)
    fn = lambda: mlp.int4_mlp_s4_stacked(x, gu, down, 1, activation)
    ref = lambda: mlp.int4_mlp_reference(x, gu.layer(1), down.layer(1),
                                         activation)
    got, want = fn(), ref()
    torch.cuda.synchronize()
    err, tol = mlp_close(torch, got, want, f"int4_mlp {activation} M={m}")
    if not torch.equal(got, fn()):
        raise AssertionError("int4_mlp: two launches differ")

    def two_k1():
        g_u = im.int4_matmul_s4_stacked(x, gu, 1)
        a = mlp.glu(g_u[:, :inter], g_u[:, inter:], activation)
        return im.int4_matmul_s4_stacked(a, down, 1)

    two_k1_err = (two_k1().float() - want.float()).abs().max().item()
    ms = timer(fn)
    plain_ms = timer(ref, iters=3, warmup=1)
    two_k1_ms = timer(two_k1)
    try:
        pg, pd = int4pack(torch, gu.layer(1)), int4pack(torch, down.layer(1))

        def library():
            g_u = torch._weight_int4pack_mm(x, *pg)
            a = mlp.glu(g_u[:, :inter], g_u[:, inter:], activation)
            return torch._weight_int4pack_mm(a, *pd)

        lib_name = "torch._weight_int4pack_mm twice, the activation between"
        library()
    except LIBRARY_ERRORS as e:
        from text_generation_inference_tpu_torch.ops.quant import int4

        dg = int4.dequantize(gu.layer(1), torch.bfloat16)
        dd = int4.dequantize(down.layer(1), torch.bfloat16)

        def library():
            g_u = torch.matmul(x, dg)
            return torch.matmul(mlp.glu(g_u[:, :inter], g_u[:, inter:],
                                        activation), dd)

        lib_name = (f"torch.matmul on the dequantized bf16 weights "
                    f"({type(e).__name__}: {str(e)[:80]})")
    lib_err = (library().float() - want.float()).abs().max().item()
    library_ms = timer(library)
    wl = (gu.layer(1), down.layer(1))
    b_ms, b_by = bound(nbytes(x, got, *(t for w in wl for t in
                                         (w.qweight, w.scales, w.zbias))),
                       2.0 * m * h * 2 * inter + 2.0 * m * inter * h)
    log(f"kernel int4_mlp_s4_stacked {activation} H={h} I={inter} M={m}: "
        f"max_abs_err {err:.3e} (tol {tol}) ms {ms:.4f} plain_ms "
        f"{plain_ms:.4f} library_ms {library_ms:.4f} ({lib_name}, max abs "
        f"diff from plain {lib_err:.3e}) bound_ms {b_ms:.4f} ({b_by})")
    log(f"two-K1 route {activation} M={m} (K1 w_gu, the activation, K1 "
        f"w_down): ms {two_k1_ms:.4f} against M1 {ms:.4f}; max abs diff from "
        f"plain {two_k1_err:.3e}")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, two_k1_ms=two_k1_ms)


def sum_results(results):
    """One record for a set of products run back to back (a layer's four
    products): times and bounds add, the error is the largest, and the
    bound is named by what bounds most of the summed bound."""
    out = dict(err=max(r["err"] for r in results))
    for k in ("ms", "plain_ms", "bound_ms", "library_ms"):
        out[k] = sum(r[k] for r in results)
    by_ops = sum(r["bound_ms"] for r in results if r["bound_by"] == "operations")
    out["bound_by"] = "operations" if 2 * by_ops > out["bound_ms"] else "bytes"
    return out


# --- the model --------------------------------------------------------------


def llama_spec(widths=None, **overrides):
    from text_generation_inference_tpu_torch.models.core import DecoderSpec

    return DecoderSpec(pos="rope", norm="rmsnorm", activation="silu_glu",
                       **{**(widths or TINYLLAMA), **overrides})


def random_params(torch, spec, gptq: bool = False):
    """Layer-stacked params drawn on the card from a seeded generator:
    bf16 (scale 1/sqrt(fan_in), embeddings 0.02, the JAX package's init
    rule), or with every layer linear a random GPTQ-INT4 weight
    (`random_gptq`; embeddings, norms and lm_head stay bf16, as in a GPTQ
    checkpoint)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + (21 if gptq else 0))
    L, D, F = spec.num_layers, spec.hidden_size, spec.intermediate_size
    Q, KV = spec.q_size, spec.kv_size

    def dense(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
        return (torch.randn(*shape, generator=gen, device=DEVICE) * scale
                ).to(DTYPE)

    linear = ((lambda l, i, o: random_gptq(torch, gen, l, i, o)) if gptq
              else dense)
    ones = lambda *shape: torch.ones(*shape, dtype=DTYPE, device=DEVICE)
    return {
        "embed_tokens": dense(spec.vocab_size, D, scale=0.02),
        "layers": {
            "ln1": {"scale": ones(L, D)}, "ln2": {"scale": ones(L, D)},
            "wq": linear(L, D, Q), "wk": linear(L, D, KV),
            "wv": linear(L, D, KV), "wo": linear(L, Q, D),
            "w_gate": linear(L, D, F), "w_up": linear(L, D, F),
            "w_down": linear(L, F, D),
        },
        "final_norm": {"scale": ones(D)},
        "lm_head": dense(D, spec.vocab_size),
    }


def compare_logits(torch, pairs, vocab, tol, what):
    """Kernel vs plain logits: finite, shaped, within tol, and the same
    greedy token wherever the plain top-2 margin exceeds twice the error.
    Returns (max abs err, greedy tokens equal, tokens compared)."""
    max_err = max((a - b).abs().max().item() for a, b in pairs)
    agree = decided = 0
    for a, b in pairs:
        if not (torch.isfinite(a).all() and a.shape == (b.shape[0], vocab)):
            raise AssertionError(f"{what}: kernel logits not finite / bad shape")
        top2 = b.topk(2, dim=-1).values
        clear = top2[:, 0] - top2[:, 1] > 2 * max_err  # outside the noise
        same = a.argmax(-1) == b.argmax(-1)
        if not bool(same[clear].all()):
            raise AssertionError(f"{what}: greedy token differs where the "
                                 "plain top-2 margin exceeds the noise")
        agree += int(same.sum())
        decided += same.numel()
    if not max_err <= tol:
        raise AssertionError(f"{what}: logits max abs err {max_err} > {tol}")
    return max_err, agree, decided


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
    logits = {}
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
    tol = 0.25
    max_err, agree, decided = compare_logits(
        torch, list(zip(logits["kernels"], logits["plain"])), spec.vocab_size,
        tol, "parity")
    log(f"parity: prefill (N={n}, bucket {t}, lengths 700/300) + 4 decode "
        f"steps, {spec.num_layers} layers: logits max abs err {max_err:.4f} (tol {tol}), "
        f"greedy tokens equal {agree}/{decided}")


def slot_parity(torch, spec, params, steps: int = 4):
    """The slot cache at max_seq 2048: `core.prefill` + `steps` scan-mode
    `core.decode` steps (every layer attends through S1) with the kernels
    and with their plain versions, both fed the same (plain) greedy
    tokens."""
    from text_generation_inference_tpu_torch.models import core
    from text_generation_inference_tpu_torch.models.fuse import fuse_params
    from text_generation_inference_tpu_torch.ops.attention import KERNELS, PLAIN

    params = fuse_params(spec, params)
    t, n, max_seq = 1024, 2, 2048
    lengths = torch.tensor([700, 300], dtype=torch.int32, device=DEVICE)
    slots = torch.tensor([1, 0], dtype=torch.int32, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    ids = torch.randint(3, spec.vocab_size, (n, t), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    runs = {"kernels": KERNELS, "plain": PLAIN}
    caches, logits = {}, {}
    for name, attn in runs.items():
        c = core.KVCache.create(spec, n, max_seq, DTYPE, DEVICE)
        lg, caches[name] = core.prefill(spec, params, ids, lengths, slots, c,
                                        attn=attn)
        logits[name] = [lg[torch.arange(n), lengths.long() - 1]]
    # decode rows are slots: slot 1 holds the 700-token prompt
    pos = lengths.flip(0).clone()
    next_ids = logits["plain"][0].argmax(-1).to(torch.int32).flip(0)
    for _ in range(steps):
        for name, attn in runs.items():
            lg, _ = core.decode(spec, params, next_ids, pos, caches[name],
                                pos + 1, write_mode="scan", attn=attn)
            logits[name].append(lg)
        next_ids = logits["plain"][-1].argmax(-1).to(torch.int32)
        pos = pos + 1
    sync(torch)
    tol = 0.25
    max_err, agree, decided = compare_logits(
        torch, list(zip(logits["kernels"], logits["plain"])), spec.vocab_size,
        tol, "slot parity")
    log(f"slot parity: core.prefill (N={n}, bucket {t}, lengths 700/300) + "
        f"{steps} scan-mode decode steps at max_seq {max_seq} through "
        f"decode_attention, {spec.num_layers} layers: logits max abs err "
        f"{max_err:.4f} (tol {tol}), greedy tokens equal {agree}/{decided}")


def quant_parity(torch, spec, params, steps: int = 4):
    """The quantized path three ways: with the kernels (K1, K2, flash
    prefill), with the kernels and the fused MLP (M1 in decode, as
    INT4_FUSED_MLP=1 routes it), and with their plain versions
    (`ops.attention.PLAIN`): a GPTQ-INT4 model over an int8 pool, one
    `prefill_paged`, then `steps` ring-decode steps
    (`decode_paged_ring_step` over the pool's pre-chunk context plus the
    in-chunk ring, weights routed as a decode dispatch routes them), all
    fed the same (plain) greedy tokens; one `paged_ring_flush` closes the
    chunk and the pools' int8 rows are compared."""
    from text_generation_inference_tpu_torch.engine.paged_cache import PagedKVCache
    from text_generation_inference_tpu_torch.models import paged_core
    from text_generation_inference_tpu_torch.models.fuse import fuse_params
    from text_generation_inference_tpu_torch.ops import linear
    from text_generation_inference_tpu_torch.ops.attention import KERNELS, PLAIN
    from text_generation_inference_tpu_torch.ops.cuda import int4_mlp as mlp

    params = fuse_params(spec, params)
    page, t, n = 128, 1024, 2
    lengths = torch.tensor([700, 300], dtype=torch.int32, device=DEVICE)
    slots = torch.tensor([0, 1], dtype=torch.int32, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    ids = torch.randint(3, spec.vocab_size, (n, t), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    max_pages = t // page + 1
    # name: (attention and int4 ops, fused MLP in decode)
    runs = {"kernels": (KERNELS, False), "fused": (KERNELS, True),
            "plain": (PLAIN, False)}
    caches, logits, rings = {}, {}, {}
    for name, (attn, _) in runs.items():
        c = PagedKVCache.create(spec, 2 * max_pages, page, n, max_pages,
                                torch.int8, DEVICE)
        c.block_table.copy_(torch.arange(2 * max_pages, dtype=torch.int32,
                                         device=DEVICE).reshape(n, max_pages))
        lg, caches[name] = paged_core.prefill_paged(
            spec, params, ids, lengths, slots, c, page, attn=attn)
        logits[name] = [lg[torch.arange(n), lengths.long() - 1]]
        kbuf = torch.zeros((spec.num_layers, n, spec.num_kv_heads, steps,
                            spec.head_dim), dtype=DTYPE, device=DEVICE)
        rings[name] = (kbuf, torch.zeros_like(kbuf))
    decode_params = {fuse: linear.prepare_params(params, rows=n, fuse_mlp=fuse)
                     for fuse in (False, True)}
    chunk_start = lengths.clone()
    next_ids = logits["plain"][0].argmax(-1).to(torch.int32)
    m1_before = mlp.int4_mlp_s4_stacked.launches
    for i in range(steps):
        for name, (attn, fuse) in runs.items():
            kbuf, vbuf = rings[name]
            lg, k_all, v_all = paged_core.decode_paged_ring_step(
                spec, decode_params[fuse], next_ids, chunk_start + i,
                caches[name], kbuf, vbuf, i, chunk_start, page_size=page,
                attn=attn)
            kbuf[:, :, :, i] = k_all.to(DTYPE)
            vbuf[:, :, :, i] = v_all.to(DTYPE)
            logits[name].append(lg)
        next_ids = logits["plain"][-1].argmax(-1).to(torch.int32)
    active = torch.ones(n, dtype=torch.bool, device=DEVICE)
    for name in runs:
        paged_core.paged_ring_flush(caches[name], *rings[name], chunk_start,
                                    active, t + steps, page)
    sync(torch)
    m1_launches = mlp.int4_mlp_s4_stacked.launches - m1_before
    if DEVICE == "cuda" and m1_launches != steps * spec.num_layers:
        raise AssertionError(f"quant parity: M1 launched {m1_launches} times, "
                             f"not once a layer a step")
    tol = 0.25
    # the pools: int8 entries more than one step apart (a last-ulp
    # difference of k may move a value to the next step, no more)
    k8 = {name: caches[name].k.to(torch.int16) for name in runs}
    written = caches["plain"].k_scale[..., None].expand_as(k8["plain"]) > 0
    for name, what in (("kernels", "K1 for every product"),
                       ("fused", "the MLP through M1")):
        max_err, agree, decided = compare_logits(
            torch, list(zip(logits[name], logits["plain"])), spec.vocab_size,
            tol, f"quant parity ({name})")
        far = ((k8[name] - k8["plain"]).abs() > 1)[written]
        log(f"quant parity [{name}: {what}]: GPTQ-INT4 + int8 KV, prefill "
            f"(N={n}, bucket {t}, lengths 700/300) + {steps} ring-decode "
            f"steps + flush, {spec.num_layers} layers at {spec.hidden_size} "
            f"wide, against the plain versions: logits max abs err "
            f"{max_err:.4f} (tol {tol}), greedy tokens equal {agree}/"
            f"{decided} ({agree / decided:.2f}); k pools: {int(far.sum())} of "
            f"{far.numel()} written int8 entries more than 1 apart")


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


# (prompt lengths, streaming every n-th request or 0) per wave, new tokens
TRAFFIC_TINYLLAMA = (([100, 180, 260, 400, 560, 720], 0),       # unary
                     ([1100, 1300, 1500, 1240], 2)), 48         # 2 streaming
TRAFFIC_7B = (([100, 250, 420, 600, 900], 0),
              ([150, 500, 820], 2)), 32
TRAFFIC_SLOT = (([100, 300, 600, 900, 1300, 1800], 0),      # unary
                ([1200, 1500, 1700, 1000], 2)), 48          # 2 streaming
# run 6: run 3's requests, four of them behind a soft prompt (one streams)
PREFIXES_7B = (["pt-short", "pt-long", None, "pt-short", None],
               ["pt-long", None, None])
SOFT_PROMPTS = {"pt-short": 16, "pt-long": 128}      # vectors


def write_prefix_store(root: str, hidden: int) -> None:
    """Two seeded soft prompts at embedding scale: `pt-short` as a raw
    `decoder.pt` tensor, `pt-long` as a PEFT `adapter_model.safetensors`
    under `prompt_embeddings`."""
    import torch
    from safetensors.numpy import save_file

    rng = np.random.default_rng(SEED + 71)
    for name, n in SOFT_PROMPTS.items():
        os.makedirs(os.path.join(root, name))
        arr = (rng.normal(size=(n, hidden)) * 0.02).astype(np.float32)
        if name == "pt-short":
            torch.save(torch.from_numpy(arr), os.path.join(root, name,
                                                           "decoder.pt"))
        else:
            save_file({"prompt_embeddings": arr},
                      os.path.join(root, name, "adapter_model.safetensors"))


def make_requests(lens, streaming_every, seed_base, new, prefixes=None,
                  prompt_cache=None):
    from text_generation_inference_tpu_torch.engine.engine import RequestParams
    from text_generation_inference_tpu_torch.scheduler.request import (
        GenRequest, ResponseOptions, StoppingCriteria)

    rng = np.random.default_rng(SEED)
    reqs = []
    for i, n in enumerate(lens):
        pid = prefixes[i] if prefixes else None
        sampled = i % 2 == 1
        rp = RequestParams(max_new_tokens=new,
                           temperature=0.8 if sampled else 0.0,
                           top_k=50 if sampled else 0,
                           seed=seed_base + i if sampled else 0)
        ids = [int(x) for x in rng.integers(3, 259, size=n)]
        reqs.append(GenRequest(
            input_text="", input_ids=ids, params=rp,
            stopping=StoppingCriteria(max_new_tokens=new),
            options=ResponseOptions(), prefix_id=pid,
            prefix_length=prompt_cache.prefix_length(pid) if pid else 0,
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


async def grpc_roundtrip(batcher, config, tokenizer, prefix_id=None):
    """Generate and GenerateStream through the port's gRPC server; with
    `prefix_id`, also a Generate behind that soft prompt and one with an
    unknown prefix id, which validation must refuse."""
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
            if prefix_id:
                resp = await generate(pb.BatchedGenerationRequest(
                    requests=[pb.GenerationRequest(text=text)], params=params,
                    prefix_id=prefix_id))
                if resp.responses[0].generated_token_count != 16:
                    raise AssertionError(f"gRPC Generate with prefix_id: {resp}")
                try:
                    await generate(pb.BatchedGenerationRequest(
                        requests=[pb.GenerationRequest(text=text)],
                        params=params, prefix_id="no-such-prompt"))
                except grpc.aio.AioRpcError as e:
                    if e.code() != grpc.StatusCode.INVALID_ARGUMENT:
                        raise
                else:
                    raise AssertionError("gRPC: an unknown prefix_id was served")
        log(f"grpc: Generate + GenerateStream on 127.0.0.1:{port}: 16 tokens "
            "each, stream text == unary text"
            + (f"; Generate with prefix_id {prefix_id!r} served, an unknown "
               "prefix_id refused (INVALID_ARGUMENT)" if prefix_id else ""))
    finally:
        await server.stop(grace=1.0)
        servicer.async_tokenizer.shutdown()


def make_engine(torch, spec, params, max_seq, overrides, slot=False,
                fused=False):
    """A PagedInferenceEngine with 16 slots and 128-token pages (the pool
    is sized from the card's memory, so the engines of earlier phases are
    collected first), or with `slot` the slot engine (InferenceEngine, the
    server's PAGED_ATTENTION=0) with 16 slots. `fused` builds it under
    INT4_FUSED_MLP=1, which the engine reads when it is built."""
    import gc

    from text_generation_inference_tpu_torch.config import ServingConfig
    from text_generation_inference_tpu_torch.engine.engine import InferenceEngine
    from text_generation_inference_tpu_torch.engine.paged_engine import (
        PagedInferenceEngine)

    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    config = ServingConfig(max_sequence_length=max_seq, max_new_tokens=256,
                           max_batch_slots=16, kv_page_size=128, **overrides)
    config.validate()
    cls = InferenceEngine if slot else PagedInferenceEngine
    before = os.environ.get("INT4_FUSED_MLP")
    os.environ["INT4_FUSED_MLP"] = "1" if fused else "0"
    try:
        engine = cls(spec, params, config,
                     eos_token_id=ByteTokenizer.eos_token_id, device=DEVICE)
    finally:
        if before is None:
            del os.environ["INT4_FUSED_MLP"]
        else:
            os.environ["INT4_FUSED_MLP"] = before
    if engine.fuse_mlp != fused:
        raise AssertionError("the engine did not take INT4_FUSED_MLP")
    return engine, config


def profile_decode(torch, spec, params, label, overrides=None,
                   max_seq=2048, live=8, calls=16, slot=False, fused=False,
                   focus=None):
    """Where a decode step's time goes: `live` requests (512-token prompts),
    `calls` decode dispatches (of decode_chunk steps each) under
    torch.profiler. Prints the step's wall time, the card's busy time and
    share, the kernels that take the most device time, and the share of
    the kernels whose name holds `focus`."""
    from torch.profiler import ProfilerActivity, profile

    from text_generation_inference_tpu_torch.engine.engine import RequestParams

    engine, _ = make_engine(torch, spec, params, max_seq, overrides or {},
                            slot=slot, fused=fused)
    steps = calls * engine.decode_chunk
    rng = np.random.default_rng(SEED + 11)
    slots = [engine.acquire_slot() for _ in range(live)]
    rp = RequestParams(max_new_tokens=steps + 4 * engine.decode_chunk)
    for i in range(0, live, 8):
        engine.prefill(slots[i:i + 8],
                       [[int(x) for x in rng.integers(3, 259, 512)]
                        for _ in slots[i:i + 8]], [rp] * len(slots[i:i + 8]))
    for _ in range(2):
        engine.decode_steps(want_details=False)
    sync(torch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(calls):
            engine.decode_steps(want_details=False)
        sync(torch)
        wall_ms = (time.monotonic() - t0) * 1e3
    # device-side events only: an operator's own "self device time" is the
    # time of the kernels it launched, which appear as events of their own
    from torch.autograd import DeviceType

    kernels = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0:
            kernels.append((dev_us / 1e3, evt.count, evt.key))
    if not kernels:
        log(f"profile[{label}]: the profiler recorded no device events")
        return None
    busy_ms = sum(k[0] for k in kernels)
    launches = sum(k[1] for k in kernels)
    kernels.sort(reverse=True)
    log(f"profile[{label}]: {steps} decode steps ({live} live slots, ctx "
        f"~{512 + 2 * engine.decode_chunk}, chunk {engine.decode_chunk}): "
        f"wall {wall_ms / steps:.3f} ms/step, device busy "
        f"{busy_ms / steps:.3f} ms/step ({100 * busy_ms / wall_ms:.1f}% "
        f"busy, {100 - 100 * busy_ms / wall_ms:.1f}% idle), "
        f"{launches / steps:.1f} kernel launches/step")
    for ms, count, key in kernels[:10]:
        log(f"profile[{label}]:   {ms / steps:8.4f} ms/step  "
            f"{count / steps:7.2f} launches/step  {key[:90]}")
    out = dict(wall_ms=wall_ms / steps, busy_ms=busy_ms / steps,
               launches=launches / steps)
    if focus:
        f_ms = sum(k[0] for k in kernels if focus in k[2])
        f_n = sum(k[1] for k in kernels if focus in k[2])
        log(f"profile[{label}]: {focus}: {f_ms / steps:.4f} ms/step "
            f"({100 * f_ms / busy_ms:.1f}% of the busy time), "
            f"{f_n / steps:.2f} launches/step")
        out.update(focus_ms=f_ms / steps, focus_launches=f_n / steps)
    return out


def serve_run(torch, spec, params, name, overrides, counters, with_grpc,
              traffic=TRAFFIC_TINYLLAMA, max_seq=2048, slot=False,
              fused=False, prefixes=None):
    """One serving run through the Batcher (+ gRPC). With `prefixes` (a
    prefix id or None per request, wave by wave), the config's
    prefix_store_path is served as the server serves it, and an unknown
    prefix id must fail validation."""
    from text_generation_inference_tpu_torch.scheduler.batcher import Batcher
    from text_generation_inference_tpu_torch.server.main import (
        build_prompt_cache)
    from text_generation_inference_tpu_torch.server.validation import (
        Validation, ValidationError)

    engine, config = make_engine(torch, spec, params, max_seq, overrides,
                                 slot=slot, fused=fused)
    engine.warmup(batch_sizes=(1,))
    tokenizer = ByteTokenizer()
    waves, new = traffic
    prompt_cache = build_prompt_cache(config, spec.hidden_size)
    if prefixes:
        try:
            Validation(tokenizer, config, prompt_cache).prefix_length(
                "no-such-prompt")
        except ValidationError:
            pass
        else:
            raise AssertionError("an unknown prefix id passed validation")

    async def drive():
        batcher = Batcher(engine, tokenizer, config, prompt_cache=prompt_cache)
        batcher.start()
        try:
            t0 = time.monotonic()
            reqs, ttft = [], []
            for i, (lens, streaming_every) in enumerate(waves):
                wave = make_requests(lens, streaming_every, 100 * (i + 1), new,
                                     prefixes[i] if prefixes else None,
                                     prompt_cache)
                ttft += await run_wave(batcher, wave)
                reqs += wave
            sync(torch)
            wall = time.monotonic() - t0
            if with_grpc:
                await grpc_roundtrip(batcher, config, tokenizer,
                                     "pt-short" if prefixes else None)
            return reqs, wall, ttft
        finally:
            await batcher.stop()

    for c in counters.values():
        c.reset()
    reqs, wall, ttft = asyncio.run(drive())
    counts = {k: c.read() for k, c in counters.items()}
    tokens = sum(r.generated_count for r in reqs)
    n_pre = sum(1 for r in reqs if r.prefix_id)
    log(f"serve[{name}] {type(engine).__name__} {overrides}"
        f"{', INT4_FUSED_MLP=1' if fused else ''}, "
        f"{spec.num_layers} layers at {spec.hidden_size} wide: {len(reqs)} "
        f"requests ({n_pre} behind a soft prompt), prompts "
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
        from text_generation_inference_tpu_torch.ops.cuda import decode_attention as da
        from text_generation_inference_tpu_torch.ops.cuda import flash_prefill as fp
        from text_generation_inference_tpu_torch.ops.cuda import int4_matmul as im
        from text_generation_inference_tpu_torch.ops.cuda import int4_mlp as mlp
        from text_generation_inference_tpu_torch.ops.cuda import paged_attention as pa
        from text_generation_inference_tpu_torch.ops.cuda import ring_decode_attention as rda
        from text_generation_inference_tpu_torch.tools import probe_decode
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
    fp128_g1 = check_flash_prefill(torch, timer, d=128, kh=32, g=1)
    pn = check_paged(torch, timer, stats=False)
    ps = check_paged(torch, timer, stats=True)
    pi8 = check_paged_int8(torch, timer)
    # K1 on a 7B layer's four products: decode rows through the stacked
    # name, prefill rows through the packed name; act-order through s4
    k1 = {entry: sum_results([check_int4(torch, timer, entry, key, m)
                              for key in K1_SHAPES])
          for m, entry in ((16, "int4_matmul_s4_stacked"),
                           (2048, "int4_matmul"))}
    k1["int4_matmul_s4"] = check_int4(torch, timer, "int4_matmul_s4", "wo",
                                      16, act_order=True)
    s1 = check_slot_decode(torch, timer, s=16, kh=4, g=8, d=64)
    s1_7b = check_slot_decode(torch, timer, s=16, kh=32, g=1, d=128)
    s2 = {step: check_ring_decode(torch, timer, step) for step in (0, 32, 63)}
    # M1 at a 7B layer's MLP: decode rows of run 6 (16 slots) and the
    # kernel's largest row tile, both activations
    m1 = {(m, act): check_int4_mlp(torch, timer, m, act)
          for m in (16, 64) for act in ("silu_glu", "gelu_glu")}

    spec = llama_spec()
    params = random_params(torch, spec)
    model_parity(torch, spec, params)
    slot_parity(torch, spec, params)

    # the dense-gather branch is not a kernel; count its calls to show run 1
    # reached it
    dense_gather = paged_core.gather_dense_view

    def counted_gather(*args, **kw):
        counted_gather.calls += 1
        return dense_gather(*args, **kw)

    counted_gather.calls = 0
    paged_core.gather_dense_view = counted_gather
    # paged decode steps (per-step and ring), to read launches per decode
    # layer-step of the GPTQ runs
    def counting(fn):
        def step(*args, **kw):
            counting.calls += 1
            return fn(*args, **kw)
        return step

    counting.calls = 0
    for fn_name in ("decode_paged", "decode_paged_ring_step"):
        setattr(paged_core, fn_name, counting(getattr(paged_core, fn_name)))
    counters = {"flash_prefill": Counter(fp.flash_prefill),
                "paged_decode_attention": Counter(pa.paged_decode_attention),
                "paged_decode_attention_stats":
                    Counter(pa.paged_decode_attention_partial),
                "paged_decode_attention_partial_i8":
                    Counter(pa.paged_decode_attention_partial_i8),
                "int4_matmul_s4_stacked": Counter(im.int4_matmul_s4_stacked),
                "int4_matmul_s4": Counter(im.int4_matmul_s4),
                "int4_matmul": Counter(im.int4_matmul),
                "int4_mlp_s4_stacked": Counter(mlp.int4_mlp_s4_stacked),
                "decode_attention": Counter(da.decode_attention),
                "ring_decode_attention": Counter(rda.ring_decode_attention),
                "dense_gather_chunks": Counter(counted_gather, "calls"),
                "paged_decode_steps": Counter(counting, "calls")}
    paged_kernels = ("paged_decode_attention", "paged_decode_attention_stats",
                     "paged_decode_attention_partial_i8")
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

    profile_decode(torch, spec, params, "tinyllama bf16")

    # the slot engine (PAGED_ATTENTION=0): run 4 in scan mode, every decode
    # step through S1; run 5 with int8 KV on ring chunks of 8
    scan = dict(decode_write_mode="scan")
    run4 = serve_run(torch, spec, params, "slot-scan", scan, counters,
                     with_grpc=with_grpc, traffic=TRAFFIC_SLOT, slot=True)
    if run4["flash_prefill"] <= 0 or run4["decode_attention"] <= 0:
        raise AssertionError(f"run 4 missed a slot-path kernel: {run4}")
    if any(run4[key] for key in paged_kernels):
        raise AssertionError(f"a paged kernel ran on the slot engine: {run4}")
    run5 = serve_run(torch, spec, params, "slot-int8-ring",
                     dict(kv_cache_dtype="int8", decode_chunk=8), counters,
                     with_grpc=False, slot=True)
    if run5["flash_prefill"] <= 0 or any(run5[key] for key in paged_kernels):
        raise AssertionError(f"run 5 left the slot ring path: {run5}")
    profile_decode(torch, spec, params, "tinyllama slot scan", scan,
                   slot=True)

    # the ring-decode probe: S2's caller, as in the JAX package
    for c in counters.values():
        c.reset()
    modes = ["ring_ctx256", "ring_ctx256_kernel", "ring_ctx1024",
             "ring_ctx1024_kernel"]
    probe = probe_decode.run_probe(modes, spec, params, DEVICE, log=log)
    probe_counts = {k: c.read() for k, c in counters.items()}
    if probe_counts["ring_decode_attention"] <= 0:
        raise AssertionError(f"the probe never launched S2: {probe_counts}")
    log(f"probe: {json.dumps(probe)}; launches {probe_counts}")
    del params

    # the quantized path at Llama-2-7B widths: GPTQ-INT4 weights, int8 KV
    spec4 = llama_spec(LLAMA7B, num_layers=4)
    quant_parity(torch, spec4, random_params(torch, spec4, gptq=True))
    spec7b = llama_spec(LLAMA7B)
    params7b = random_params(torch, spec7b, gptq=True)
    quantized = dict(kv_cache_dtype="int8", decode_chunk=8,
                     paged_gather_ctx_max=0)
    run3 = serve_run(torch, spec7b, params7b, "7b-gptq-int8kv", quantized,
                     counters, with_grpc=with_grpc, traffic=TRAFFIC_7B,
                     max_seq=1024)
    # K1 in prefill (the packed name) and in decode (the stacked name), K2
    # on every ring chunk; int4_matmul_s4 takes only a 2-D weight, which a
    # layer-stacked model never hands it
    for key in ("flash_prefill", "int4_matmul", "int4_matmul_s4_stacked",
                "paged_decode_attention_partial_i8"):
        if run3[key] <= 0:
            raise AssertionError(f"{key} never ran in serving run 3: {run3}")
    if run3["paged_decode_attention"] or run3["dense_gather_chunks"] \
            or run3["int4_mlp_s4_stacked"]:
        raise AssertionError(f"run 3 left the ring-chunk kernel path: {run3}")
    prof3 = profile_decode(torch, spec7b, params7b, "7b gptq int8kv",
                           quantized, max_seq=1024, live=16, calls=4,
                           focus="int4_matmul_kernel")

    # run 6: run 3's config under INT4_FUSED_MLP=1 with a soft-prompt store;
    # M1 takes the MLP of every decode layer, K1 keeps w_qkv and wo
    with tempfile.TemporaryDirectory() as store:
        write_prefix_store(store, spec7b.hidden_size)
        run6 = serve_run(torch, spec7b, params7b, "7b-gptq-fused-prefix",
                         dict(quantized, prefix_store_path=store), counters,
                         with_grpc=with_grpc, traffic=TRAFFIC_7B,
                         max_seq=1024, fused=True, prefixes=PREFIXES_7B)
    for key in ("flash_prefill", "int4_matmul", "int4_mlp_s4_stacked",
                "paged_decode_attention_partial_i8"):
        if run6[key] <= 0:
            raise AssertionError(f"{key} never ran in serving run 6: {run6}")
    layer_steps = {name: run["paged_decode_steps"] * spec7b.num_layers
                   for name, run in (("run 3", run3), ("run 6", run6))}
    k1_rate = {name: run["int4_matmul_s4_stacked"] / layer_steps[name]
               for name, run in (("run 3", run3), ("run 6", run6))}
    m1_rate = run6["int4_mlp_s4_stacked"] / layer_steps["run 6"]
    if k1_rate != {"run 3": 4.0, "run 6": 2.0} or m1_rate != 1.0:
        raise AssertionError(f"decode launches per layer-step: K1 {k1_rate}, "
                             f"M1 {m1_rate} (want K1 4 -> 2, M1 1)")
    log(f"decode launches per layer-step: K1 {k1_rate['run 3']:.0f} in run 3 "
        f"-> {k1_rate['run 6']:.0f} in run 6 (w_qkv, wo), M1 {m1_rate:.0f} "
        f"(w_gu + the GLU + w_down)")
    prof6 = profile_decode(torch, spec7b, params7b, "7b gptq int8kv fused",
                           quantized, max_seq=1024, live=16, calls=4,
                           fused=True, focus="int4_mlp_kernel")
    if prof3 and prof6:
        log(f"profile 7b: run 3's config {json.dumps(prof3)}; run 6's "
            f"(INT4_FUSED_MLP=1) {json.dumps(prof6)}")

    runs = (run1, run2, run3, run4, run5, run6, probe_counts)

    def record(name, source, replaces, res):
        return {"name": name, "route": "cuda",
                "source": f"{PORT_DIR}/csrc/{source}",
                "replaces": f"{JAX_PACKAGE_DIR}/ops/pallas/{replaces}",
                "launches": sum(run[name] for run in runs),
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
        record("paged_decode_attention_partial_i8", "paged_attention.cu",
               "paged_attention.py:153", pi8),
        record("int4_matmul_s4_stacked", "int4_matmul.cu",
               "int4_matmul.py:453", k1["int4_matmul_s4_stacked"]),
        record("int4_matmul_s4", "int4_matmul.cu", "int4_matmul.py:572",
               k1["int4_matmul_s4"]),
        record("int4_matmul", "int4_matmul.cu", "int4_matmul.py:637",
               k1["int4_matmul"]),
        record("decode_attention", "slot_attention.cu",
               "decode_attention.py:142", s1),
        record("ring_decode_attention", "slot_attention.cu",
               "ring_decode_attention.py:239", s2[32]),
        record("int4_mlp_s4_stacked", "int4_mlp.cu", "int4_matmul.py:366",
               m1[(16, "silu_glu")]),
    ]
    for (m, act), res in m1.items():
        log(f"int4_mlp_s4_stacked {act} M={m}: {json.dumps(res)}")
    log(f"flash_prefill at D=128 (H=32, KV=8): {json.dumps(fp128)}")
    log(f"flash_prefill at D=128 (H=32, KV=32, G=1): {json.dumps(fp128_g1)}")
    log(f"decode_attention at D=128 (KV=32, G=1): {json.dumps(s1_7b)}")
    for step in (0, 63):
        log(f"ring_decode_attention at step {step}: {json.dumps(s2[step])}")
    log("decode_attention record: TinyLlama widths; ring_decode_attention "
        "record: step 32; launches: decode_attention in the serving runs, "
        "ring_decode_attention in the probe")
    log("int4_matmul_s4_stacked and int4_matmul records: the sums over a 7B "
        "layer's four products (w_qkv, wo, w_gu, w_down) at M=16 and M=2048; "
        "int4_matmul_s4: wo at M=16 with act-order; int4_mlp_s4_stacked: a "
        "7B layer's MLP at M=16, silu, launches from run 6")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
