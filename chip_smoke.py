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
             also at head dim 128, G=4 and G=1, at 256 with gemma-7b's and
             gemma-2b's heads, at 192, and in fp32 on the 3xTF32 kernel at
             head dims 64, 128, 192 and 256, each with its achieved
             TFLOP/s; paged decode in both modes with its GB/s and share of
             the bytes bound); every decode entry in fp32 (the paged kernel
             in both modes, K2 with an fp32 q, S1, S2); the int8 paged
             decode (K2, at 7B widths and at TinyLlama's, a sentinel page
             inside a split and a ctx == 0 slot) and the GPTQ-INT4
             dequant-GEMM (K1, on a Llama-2-7B layer's four products at 16
             and 2048 rows beside tinygemm and the dense ceiling, at 1, 17,
             65 and 1000 rows, with fp16 and fp32 x on wo and w_down, every
             row of 16- and 64-row products bit-identical to the row alone,
             and one act-order weight) at Llama-2-7B widths; the fused
             GPTQ-INT4 MLP (M1) on a 7B layer's MLP at 16 and 64 rows, silu
             and gelu_glu, also beside the two-K1 route on the same work,
             and with fp16 and fp32 x; the slot-cache decode kernel (S1) at
             TinyLlama and 7B decode widths over a 2048-row cache, and the
             ring-decode kernel (S2) at the decode probe's shapes (48 slots,
             1024 cache rows, a ring of 64) at ring steps 0, 32 and 63. K2
             and S1 also show each slot alone bit-identical to the same
             slot in a batch of 40.
  3. parity  one prefill and a few decode steps with the kernels and with
             their plain versions (`ops.attention.PLAIN`); logits and
             greedy tokens are compared: the full-width bf16 TinyLlama
             (`decode_paged` steps), the same model on the slot cache
             (`core.prefill`, then scan-mode `core.decode` steps at
             max_seq 2048, through S1), a float32 model at the test
             fixtures' tiny_llama widths with head dim 64 (its prefill
             through flash prefill's 3xTF32 kernel, per-step and
             ring-chunk paged decode on the fp32 bodies, launches
             counted), then a 4-layer
             GPTQ-INT4 model at 7B widths over an int8 pool (ring-decode
             steps and a flush), with K1 for every product and with the MLP
             through M1, in bf16 and again in fp16.
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
             wall and device-busy time per step, the top kernels, and
             the ms and launches a step of the kernels each profile is
             about (the bf16 paged kernel after run 2, S1 after run 4, K1
             and K2 after run 3, M1 and K1 after run 6; no `sum_splits`
             kernel may run).

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
PEAK_FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
PEAK_TF32_FLOPS = 494.7e12      # H100 SXM dense TF32 tensor cores
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


def peak_flops(dtype) -> float:
    """The card's peak for flash prefill's operations: the bf16 tensor
    cores, or for fp32 what the card does for fp32-accurate products on its
    tensor cores: three TF32 products a product (3xTF32), a third of the
    TF32 peak."""
    if str(dtype) == "torch.float32":
        return PEAK_TF32_FLOPS / 3
    return PEAK_BF16_FLOPS


def bound(nbytes: float, flops: float, fp32: bool = False,
          peak: float | None = None) -> tuple[float, str]:
    """The least time (ms) for the bytes and operations, and which bounds
    it; operations over `peak`, else the fp32 CUDA-core peak (the fp32
    decode bodies) or the bf16 tensor cores."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / (peak or (PEAK_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS))
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# --- phase 2: kernels -------------------------------------------------------


def check_flash_prefill(torch, timer, d: int, kh: int, g: int, dtype=None):
    """Flash prefill over two right-padded sequences of a 2048 bucket at
    (D, KV heads, group), bf16 by default; fp32 runs the 3xTF32 tensor-core
    kernel, held to 1e-4 of the plain version (and its error against its
    twin, `flash_prefill_tf32x3_reference`, is logged)."""
    from text_generation_inference_tpu_torch.ops.cuda import flash_prefill as fp

    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + d)
    n, t = 2, 2048
    lengths = torch.tensor([1500, 900], dtype=torch.int32, device="cuda")

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v = rnd(n, t, kh, g, d), rnd(n, t, kh, d), rnd(n, t, kh, d)
    got = fp.flash_prefill(q, k, v, lengths)
    want = fp.flash_prefill_reference(q, k, v, lengths)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    # the kernel rounds P to bf16 for the tensor-core value product (as
    # FlashAttention-2 does) and both round the output to bf16 once: allow
    # about two bf16 ulps, atol 2e-2 + rtol 1e-2; fp32 computes in fp32
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1e-2)
    tol = f"atol {atol} + rtol {rtol}"
    if not bool((diff <= atol + rtol * want.float().abs()).all()):
        raise AssertionError(f"flash_prefill D={d}: max abs err {err} "
                             f"outside {tol}")
    if dtype == torch.float32:
        twin = fp.flash_prefill_tf32x3_reference(q, k, v, lengths)
        tol += (f"; against the 3xTF32 twin "
                f"{(got - twin).abs().max().item():.3e}")
        del twin
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
    b_ms, b_by = bound(nbytes(q, k, v, got, lengths), flops,
                       peak=peak_flops(dtype))
    tflops = flops / (ms * 1e-3) / 1e12
    log(f"kernel flash_prefill {str(dtype).split('.')[-1]} D={d} N={n} T={t} "
        f"H={kh * g} KV={kh}: "
        f"max_abs_err {err:.3e} (tol {tol}) ms {ms:.4f} plain_ms "
        f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms {b_ms:.4f} "
        f"({b_by}); {flops / 1e9:.1f} GFLOP at {tflops:.1f} TFLOP/s "
        f"({100 * tflops / (peak_flops(dtype) / 1e12):.1f}% of the "
        f"{'3xTF32' if dtype == torch.float32 else 'bf16'} peak)")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, tflops=tflops)


def paged_inputs(torch, s=16, kh=4, g=8, d=64, page=128, max_pages=16,
                 first_ctx=1, dtype=None):
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
        return torch.randn(*shape, generator=gen, device="cuda").to(
            dtype or torch.bfloat16)

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


def check_paged(torch, timer, stats: bool, dtype=None):
    from text_generation_inference_tpu_torch.ops.cuda import paged_attention as pa

    q, kp, vp, bt, ctx, page = paged_inputs(torch, dtype=dtype)
    fp32 = q.dtype == torch.float32
    s, kh, g, d = q.shape
    if stats:
        fn = lambda: pa.paged_decode_attention_partial(q, kp, vp, bt, ctx, page)
        ref = lambda: pa.paged_decode_attention_partial_reference(
            q, kp, vp, bt, ctx, page)
        got, want = fn(), ref()
        acc_abs = pa.paged_decode_attention_partial_reference(
            q, kp, vp.abs(), bt, ctx, page)[0]
        torch.cuda.synchronize()
        err, tol = stats_error(torch, got, want, acc_abs, "paged stats", fp32)
        out_bytes = nbytes(*got)
    else:
        fn = lambda: pa.paged_decode_attention(q, kp, vp, bt, ctx, page)
        ref = lambda: pa.paged_decode_attention_reference(
            q, kp, vp, bt, ctx, page)
        got, want = fn(), ref()
        torch.cuda.synchronize()
        err, tol = bf16_close(torch, got, want, "paged decode", fp32)
        out_bytes = nbytes(got)
    ms = timer(fn, iters=20)
    plain_ms = timer(ref, iters=3, warmup=1)
    library_ms = timer(paged_library_call(torch, q, kp, vp, bt, ctx, page))
    live = int(ctx.sum())
    kv_bytes = 2 * live * kh * d * kp.element_size()
    flops = 4.0 * live * kh * g * d
    moved = nbytes(q, bt, ctx) + kv_bytes + out_bytes
    b_ms, b_by = bound(moved, flops, fp32)
    gbps = moved / (ms * 1e-3) / 1e9
    name = "paged_decode_attention_stats" if stats else "paged_decode_attention"
    log(f"kernel {name} {str(q.dtype).split('.')[-1]} S={s} KV={kh} G={g} D={d} page={page} ctx_max="
        f"{int(ctx.max())} live_tokens={live}: max_abs_err {err:.3e} (tol "
        f"{tol}) ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{library_ms:.4f} bound_ms {b_ms:.4f} ({b_by}); {moved / 1e6:.2f} "
        f"MB at {gbps:.1f} GB/s, {100 * b_ms / ms:.1f}% of the bound")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, gbps=gbps)


def stats_error(torch, got, want, acc_abs, what, fp32=False):
    """Max abs error of (acc, m, l) over the finite entries, each stat held
    to its own tolerance (raises if one is outside it; the -inf pattern of
    m must match):
      acc  elementwise 2^-8 * acc_abs + 1e-4, acc_abs the plain version's
           accumulator over |v|: the kernel rounds p (times the v scale) to
           bf16 for its value product, at most 2^-9 of each term;
      m    1e-4 of max(1, |m|): both take the max of the same fp32 scores;
      l    1e-3 of max(1, max l): the same fp32 sum in another order.
    fp32 (`fp32`: the fp32 CUDA-core body, no rounding of p): acc within
    1e-5 of acc_abs + 1e-5, m and l as above. Returns (max abs error, a
    description of the tolerances)."""
    p_round = 1e-5 if fp32 else 2.0 ** -8
    names = ("acc", "m", "l")
    err = 0.0
    for name, a, b in zip(names, got, want):
        finite = torch.isfinite(b)
        if not torch.equal(finite, torch.isfinite(a)):
            raise AssertionError(f"{what}: {name}'s -inf pattern differs")
        diff = (a[finite] - b[finite]).abs()
        if name == "acc":
            tol = p_round * acc_abs[finite] + (1e-5 if fp32 else 1e-4)
        elif name == "m":
            tol = 1e-4 * torch.clamp(b[finite].abs(), min=1.0)
        else:
            tol = 1e-3 * max(1.0, b[finite].max().item())
        if not bool((diff <= tol).all()):
            raise AssertionError(f"{what}: {name} max abs err "
                                 f"{diff.max().item()} outside its tolerance")
        err = max(err, diff.max().item())
    return err, (f"acc {'1e-5' if fp32 else '2^-8'} of sum p|v| + "
                 f"{'1e-5' if fp32 else '1e-4'}, m 1e-4 of max(1, |m|), l "
                 "1e-3 of max(1, max l)")


def check_paged_int8(torch, timer, kh=32, g=1, d=128, dtype=None):
    """K2, the stats mode over int8 pools: at Llama-2-7B decode widths (16
    slots, 32 kv heads, G = 1, D = 128) or TinyLlama's (4 kv heads, G = 8,
    D = 64); page 128 (two pages a split), contexts up to 1024, a ctx == 0
    slot and a sentinel page inside slot 4's first split."""
    from text_generation_inference_tpu_torch.models.core import quantize_kv
    from text_generation_inference_tpu_torch.ops.cuda import paged_attention as pa

    q, kp, vp, bt, ctx, page = paged_inputs(torch, s=16, kh=kh, g=g, d=d,
                                            max_pages=8, first_ctx=0,
                                            dtype=dtype)
    fp32 = q.dtype == torch.float32
    bt[4, 1] = kp.shape[1] // page              # the sentinel, in split 0
    kq, ks = quantize_kv(kp)
    vq, vs = quantize_kv(vp)
    # the library call's input: the dequantized pools, made outside timing
    kd = (kq.float() * ks[..., None]).to(q.dtype)
    vd = (vq.float() * vs[..., None]).to(q.dtype)
    del kp, vp
    s = q.shape[0]
    fn = lambda: pa.paged_decode_attention_partial_i8(q, kq, vq, ks, vs, bt,
                                                      ctx, page)
    ref = lambda: pa.paged_decode_attention_partial_reference(
        q, kq, vq, bt, ctx, page, k_scale_pool=ks, v_scale_pool=vs)
    got, want = fn(), ref()
    acc_abs = pa.paged_decode_attention_partial_reference(
        q, kq, vq.abs(), bt, ctx, page, k_scale_pool=ks, v_scale_pool=vs)[0]
    torch.cuda.synchronize()
    err, tol = stats_error(torch, got, want, acc_abs, "paged int8 stats",
                           fp32)
    if not (torch.isneginf(got[1][0]).all() and (got[2][0] == 0).all()
            and (got[0][0] == 0).all()):
        raise AssertionError("paged decode int8: ctx == 0 slot not empty")
    same_slot_in_a_batch(
        torch, f"paged_decode_attention_partial_i8 D={d}",
        lambda idx: pa.paged_decode_attention_partial_i8(
            q[idx].contiguous(), kq, vq, ks, vs, bt[idx].contiguous(),
            ctx[idx].contiguous(), page)[0], s)
    ms = timer(fn, iters=20)
    plain_ms = timer(ref, iters=3, warmup=1)
    library_ms = timer(paged_library_call(torch, q, kd, vd, bt, ctx, page))
    # live keys: below ctx and not on the sentinel page
    live = int(ctx.sum()) - page
    # int8 k and v rows plus one f32 scale each per (row, kv head)
    kv_bytes = 2 * live * kh * (d * kq.element_size() + ks.element_size())
    flops = 4.0 * live * kh * g * d
    moved = nbytes(q, bt, ctx, *got) + kv_bytes
    b_ms, b_by = bound(moved, flops, fp32)
    gbps = moved / (ms * 1e-3) / 1e9
    log(f"kernel paged_decode_attention_partial_i8 q {str(q.dtype).split('.')[-1]} S={s} KV={kh} G={g} D={d} "
        f"page={page} ctx_max={int(ctx.max())} live_tokens={live}: "
        f"max_abs_err {err:.3e} (tol {tol}) ms {ms:.4f} plain_ms "
        f"{plain_ms:.4f} library_ms {library_ms:.4f} (SDPA on the gathered, "
        f"dequantized pages) bound_ms {b_ms:.4f} ({b_by}); "
        f"{moved / 1e6:.2f} MB at {gbps:.1f} GB/s, "
        f"{100 * b_ms / ms:.1f}% of the bound")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, gbps=gbps)


def same_slot_in_a_batch(torch, what, fn_at, s):
    """A slot's result alone (a batch of 1) and in a batch of 40 (the other
    rows drawn from the other slots) must be bit-identical: the kernels'
    splits never depend on the batch. Checks every slot; fn_at(idx) runs
    the kernel on the rows idx and returns a tensor whose first axis is
    them."""
    rng = np.random.default_rng(SEED + 5)
    for slot in range(s):
        alone = fn_at(torch.tensor([slot], device="cuda"))
        idx = torch.from_numpy(rng.integers(0, s, size=40)).cuda()
        idx[17] = slot
        batch = fn_at(idx)
        if not torch.equal(alone[0], batch[17]):
            raise AssertionError(f"{what}: slot {slot} alone differs from the "
                                 "same slot in a batch of 40")


# --- S1 and S2: slot-cache decode and ring decode -------------------------


def spread_ctx(s: int, t: int, seed: int):
    """Contexts for s slots spread over 0..t: an empty slot, tile and split
    edges, a full one, the rest uniform."""
    rng = np.random.default_rng(SEED + seed)
    head = [0, 1, 31, 32, 33, 255, 256, t]
    return np.concatenate([head, rng.integers(1, t + 1, size=s - len(head))]
                          ).astype(np.int32)


def bf16_close(torch, got, want, what, fp32=False):
    """Both versions compute in fp32 and round the output to bf16 once:
    allow about two bf16 ulps, atol 2e-2 + rtol 2e-2 (fp32 outputs of the
    fp32 bodies: 1e-4)."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    atol = rtol = 1e-4 if fp32 else 2e-2
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


def check_slot_decode(torch, timer, s, kh, g, d, t=2048, dtype=None):
    """S1 over one layer's slot cache [S, KV, T, D], ctx spread over
    0..T."""
    from text_generation_inference_tpu_torch.ops.cuda import decode_attention as da

    dtype = dtype or torch.bfloat16
    fp32 = dtype == torch.float32
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31 + d)
    rnd = lambda *shape: torch.randn(*shape, generator=gen,
                                     device="cuda").to(dtype)
    q, k, v = rnd(s, kh, g, d), rnd(s, kh, t, d), rnd(s, kh, t, d)
    ctx = torch.from_numpy(spread_ctx(s, t, d)).cuda()
    fn = lambda: da.decode_attention(q, k, v, ctx)
    ref = lambda: da.decode_attention_reference(q, k, v, ctx)
    got, want = fn(), ref()
    torch.cuda.synchronize()
    err, tol = bf16_close(torch, got, want, f"decode_attention D={d}", fp32)
    if not bool((got[ctx == 0] == 0).all()):
        raise AssertionError("decode_attention: a ctx == 0 slot is not 0")
    same_slot_in_a_batch(
        torch, f"decode_attention D={d}",
        lambda idx: da.decode_attention(q[idx].contiguous(), k[idx], v[idx],
                                        ctx[idx].contiguous()), s)
    ms = timer(fn, iters=20)
    plain_ms = timer(ref, iters=3, warmup=1)
    live_rows = torch.arange(t, device="cuda")[None, :] < ctx[:, None]
    library_ms = timer(sdpa_call(torch, q, k, v, live_rows))
    live = int(ctx.sum())
    flops = 4.0 * live * kh * g * d
    moved = nbytes(q, ctx, got) + 2 * live * kh * d * q.element_size()
    b_ms, b_by = bound(moved, flops, fp32)
    gbps = moved / (ms * 1e-3) / 1e9
    log(f"kernel decode_attention {str(dtype).split('.')[-1]} S={s} KV={kh} G={g} D={d} T={t} "
        f"live_tokens={live}: max_abs_err {err:.3e} (tol {tol}) ms {ms:.4f} "
        f"plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} (SDPA, mask "
        f"over the whole T) bound_ms {b_ms:.4f} ({b_by}); {moved / 1e6:.2f} "
        f"MB at {gbps:.1f} GB/s, {100 * b_ms / ms:.1f}% of the bound")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, gbps=gbps)


def check_ring_decode(torch, timer, step, s=48, kh=4, g=8, d=64, rows=1024,
                      c=64, dtype=None):
    """S2 at the decode probe's shapes: cache rows < ctx (spread over
    0..rows), ring columns < step, and the current token."""
    from text_generation_inference_tpu_torch.ops.cuda import ring_decode_attention as rda

    dtype = dtype or torch.bfloat16
    fp32 = dtype == torch.float32
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41 + step)
    rnd = lambda *shape: torch.randn(*shape, generator=gen,
                                     device="cuda").to(dtype)
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
    err, tol = bf16_close(torch, got, want,
                          f"ring_decode_attention step {step}", fp32)
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
    b_ms, b_by = bound(nbytes(q, ctx, got) + 2 * live * kh * d *
                       q.element_size(), flops, fp32)
    log(f"kernel ring_decode_attention {str(dtype).split('.')[-1]} S={s} KV={kh} G={g} D={d} rows={rows} "
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


# K1's tolerance against its plain version: the weights enter the tensor
# cores as exact integers and both versions sum in fp32, so the outputs
# differ by the rounding of y to x's dtype, one ulp (2^-7 relative in bf16,
# 2^-10 in fp16), plus 1e-3 for the summation order and fp32 x's hi + lo
# split (the earlier design rounded every weight to bf16: atol 2e-2 +
# rtol 1e-2)
K1_RTOL = {"torch.bfloat16": 2.0 ** -7, "torch.float16": 2.0 ** -10,
           "torch.float32": 1e-5}
K1_ATOL = 1e-3
K1_WEIGHTS = {}     # (in, out) -> a 2-layer stack, kept with keep=True


def k1_close(torch, got, want, what, loose=False):
    """Raises unless got is within K1's tolerance of want (with loose, the
    earlier design's, which tools/kernel_ab.py holds every version to);
    returns (max abs err, the tolerance)."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if loose:
        atol, rtol = 2e-2, 1e-2
    else:
        atol, rtol = K1_ATOL, K1_RTOL[str(want.dtype)]
    if not bool((diff <= atol + rtol * want.float().abs()).all()):
        raise AssertionError(f"{what}: max abs err {err} outside atol {atol} "
                             f"+ rtol {rtol}")
    return err, f"atol {atol} + rtol {rtol:.3g}"


def check_int4(torch, timer, entry: str, key: str, m: int,
               act_order: bool = False, dtype=None, light: bool = False,
               keep: bool = False, loose: bool = False):
    """K1 through one of its three entry names on one 7B product at m rows,
    x in `dtype` (bf16 by default): the stacked name reads layer 1 of a
    2-layer stack, the packed and the s4 names a layer's view. With
    act_order, g_idx is shuffled, normalized into a perm, and the product
    goes through `linear.matmul` (the perm gather, then the s4 name, as a
    2-D weight takes). `light` checks and times the kernel only, beside its
    bound; otherwise also the plain version, the library yardstick
    (tinygemm) and the dense ceiling: torch.matmul on the weight
    dequantized to bf16 beforehand, not the same function (it reads 4x the
    weight bytes) but what the card reaches on a dense product of the
    shape. `keep` reuses one weight per shape for the whole process."""
    from text_generation_inference_tpu_torch.ops import linear
    from text_generation_inference_tpu_torch.ops.cuda import int4_matmul as im
    from text_generation_inference_tpu_torch.ops.quant import int4

    dtype = dtype or torch.bfloat16
    in_f, out_f = K1_SHAPES[key]
    gen = torch.Generator(device="cuda").manual_seed(SEED + m + in_f + out_f)
    stack = K1_WEIGHTS.get((in_f, out_f)) if keep else None
    if stack is None:
        stack = random_gptq(torch, gen, 2, in_f, out_f)
        if keep:
            K1_WEIGHTS[(in_f, out_f)] = stack
    w = stack.layer(1)
    x = torch.randn(m, in_f, generator=gen, device="cuda").to(dtype)
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
    if got.dtype != dtype or got.shape != (m, out_f):
        raise AssertionError(f"{entry} {key} M={m}: {got.dtype} "
                             f"{tuple(got.shape)} from {dtype} x")
    err, tol = k1_close(torch, got, want, f"{entry} {key} M={m} {dtype}",
                        loose=loose)
    kernel = (lambda: im.int4_matmul_s4(xk, w)) if act_order else fn
    ms = timer(kernel)
    # what the kernel reads: the words, the scales, the zero points, x; y
    b_ms, b_by = bound(nbytes(w.qweight, w.scales, w.qzeros, x, got),
                       2.0 * m * in_f * out_f)
    label = (f"kernel {entry} {key} [{in_f}, {out_f}] M={m} "
             f"{str(dtype).split('.')[-1]}{' act-order' if act_order else ''}")
    if light:
        log(f"{label}: max_abs_err {err:.3e} (tol {tol}) ms {ms:.4f} bound_ms "
            f"{b_ms:.4f} ({b_by}), {100 * b_ms / ms:.1f}% of the bound")
        return dict(err=err, ms=ms, bound_ms=b_ms, bound_by=b_by)
    plain_ms = timer(ref, iters=3, warmup=1)
    lib_fn, lib_name = int4_library_call(torch, xk, w)
    lib_err = (lib_fn().float() - want.float()).abs().max().item()
    library_ms = timer(lib_fn)
    wd = int4.dequantize(w, dtype)
    dense_ms = timer(lambda: torch.matmul(xk, wd))
    del wd
    log(f"{label}: max_abs_err {err:.3e} (tol {tol}) ms {ms:.4f} plain_ms "
        f"{plain_ms:.4f} library_ms {library_ms:.4f} ({lib_name}, max abs "
        f"diff from plain {lib_err:.3e}) dense ceiling ms {dense_ms:.4f} "
        f"(torch.matmul on the dequantized weight) bound_ms {b_ms:.4f} "
        f"({b_by}), {100 * b_ms / ms:.1f}% of the bound")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, library=lib_name,
                dense_ms=dense_ms)


def check_int4_batch_invariance(torch, key: str):
    """Every row of an M = 16 and an M = 64 product (the decode schedule)
    bit-identical to the same row computed alone, in bf16 and fp32."""
    from text_generation_inference_tpu_torch.ops.cuda import int4_matmul as im

    in_f, out_f = K1_SHAPES[key]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 91)
    w = random_gptq(torch, gen, 1, in_f, out_f).layer(0)
    for dtype in (torch.bfloat16, torch.float32):
        for m in (16, 64):
            x = torch.randn(m, in_f, generator=gen, device="cuda").to(dtype)
            y = im.int4_matmul_s4(x, w)
            for r in range(m):
                alone = im.int4_matmul_s4(x[r:r + 1].contiguous(), w)
                if not torch.equal(alone[0], y[r]):
                    raise AssertionError(f"K1 {key} {dtype}: row {r} alone "
                                         f"differs from the same row in M={m}")
    log(f"K1 {key}: every row of M=16 and M=64 products (bf16, fp32) "
        f"bit-identical to the row alone (splits {im.split_plan(out_f, in_f)})")


# a Llama-2-7B layer's MLP: hidden, intermediate
M1_SHAPE = (4096, 11008)


def mlp_close(torch, got, want, what):
    """M1 rounds the GLU output `a` to x's dtype, and fp32 x and `a` enter
    the tensor cores as two bf16 terms (the plain version keeps them in
    f32): its error grows with the terms summed, not with each output.
    Allowed: 3e-2 of the largest output plus 2e-2 relative."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    scale = max(1.0, want.float().abs().max().item())
    atol, rtol = 3e-2 * scale, 2e-2
    if not (torch.isfinite(got).all()
            and bool((diff <= atol + rtol * want.float().abs()).all())):
        raise AssertionError(f"{what}: max abs err {err} outside atol {atol} "
                             f"+ rtol {rtol}")
    return err, f"atol {atol:.3g} (3e-2 of max |y|) + rtol {rtol}"


M1_WEIGHTS = []     # (w_gu, w_down) 2-layer stacks, kept with keep=True


def check_int4_mlp(torch, timer, m: int, activation: str, dtype=None,
                   keep: bool = False):
    """M1 on a 7B layer's MLP (layer 1 of 2-layer stacks: w_gu [4096,
    22016], w_down [11008, 4096], group 128) at m rows, against its plain
    version; beside it the two-K1 route on the same work (K1 on w_gu, the
    activation, K1 on w_down) and the library yardstick
    (torch._weight_int4pack_mm on each weight, the activation between).
    `keep` reuses one pair of weights for the whole process (a version
    under tools/kernel_ab.py may cache what it derives from a weight by
    its address)."""
    from text_generation_inference_tpu_torch.ops.cuda import int4_matmul as im
    from text_generation_inference_tpu_torch.ops.cuda import int4_mlp as mlp

    h, inter = M1_SHAPE
    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 61 + m)
    if keep and M1_WEIGHTS:
        gu, down = M1_WEIGHTS[0]
    else:
        gu = random_gptq(torch, gen, 2, h, 2 * inter)
        down = random_gptq(torch, gen, 2, inter, h)
        if keep:
            M1_WEIGHTS.append((gu, down))
    x = torch.randn(m, h, generator=gen, device="cuda").to(dtype)
    fn = lambda: mlp.int4_mlp_s4_stacked(x, gu, down, 1, activation)
    ref = lambda: mlp.int4_mlp_reference(x, gu.layer(1), down.layer(1),
                                         activation)
    got, want = fn(), ref()
    torch.cuda.synchronize()
    if got.dtype != dtype:
        raise AssertionError(f"int4_mlp: {got.dtype} from {dtype} x")
    err, tol = mlp_close(torch, got, want,
                         f"int4_mlp {activation} M={m} {dtype}")
    if not torch.equal(got, fn()):
        raise AssertionError("int4_mlp: two launches differ")
    # what the kernel reads: the words, scales and zero-point words of both
    # weights, x; y
    wl = (gu.layer(1), down.layer(1))
    b_ms, b_by = bound(nbytes(x, got, *(t for w in wl for t in
                                         (w.qweight, w.scales, w.qzeros))),
                       2.0 * m * h * 2 * inter + 2.0 * m * inter * h)
    if dtype != torch.bfloat16:
        ms = timer(fn)
        log(f"kernel int4_mlp_s4_stacked {activation} H={h} I={inter} M={m} "
            f"{str(dtype).split('.')[-1]} x: max_abs_err {err:.3e} (tol "
            f"{tol}) ms {ms:.4f} bound_ms {b_ms:.4f} ({b_by})")
        return dict(err=err, ms=ms, bound_ms=b_ms, bound_by=b_by)

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
    for k in ("ms", "plain_ms", "bound_ms", "library_ms", "dense_ms"):
        if all(k in r for r in results):
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


# the test fixtures' tiny_llama (tests/fixtures.py): 3 layers of 64, head
# dim 16 (the paged kernels' fp32 body at D = 16; prefill buckets of 128
# take the einsum path there by the JAX rule, d % 64 != 0)
TINY_FIXTURE = dict(vocab_size=256, hidden_size=64, num_layers=3,
                    num_heads=4, num_kv_heads=2, head_dim=16,
                    intermediate_size=128, rope_theta=10000.0, norm_eps=1e-5,
                    max_position_embeddings=256)


# the fixtures' tiny_llama at head dim 64 (4 heads over 2 kv heads), so
# that its prefill at a bucket of 128 takes flash prefill (the JAX rule:
# D % 64 == 0)
FP32_SPEC = dict(TINY_FIXTURE, hidden_size=256, head_dim=64,
                 intermediate_size=512)


def fp32_parity(torch, counters, steps: int = 4):
    """A float32 model (DTYPE_STR=float32) through KERNELS and PLAIN:
    FP32_SPEC's widths, one `prefill_paged` at a bucket of 128 (flash
    prefill's 3xTF32 kernel), `steps` per-step `decode_paged` steps (the
    paged kernel's normalized mode) and `steps` ring-chunk steps
    (`decode_paged_ring_step`, its stats mode), both runs fed the plain
    greedy tokens; the kernels' launches in the kernel run are counted
    (returned) and must be positive, and the logits agree within 1e-3
    (fp32 against fp32)."""
    global DTYPE
    from text_generation_inference_tpu_torch.engine.paged_cache import PagedKVCache
    from text_generation_inference_tpu_torch.models import paged_core
    from text_generation_inference_tpu_torch.models.fuse import fuse_params
    from text_generation_inference_tpu_torch.ops.attention import KERNELS, PLAIN

    saved, DTYPE = DTYPE, torch.float32
    try:
        spec = llama_spec(FP32_SPEC)
        params = fuse_params(spec, random_params(torch, spec))
    finally:
        DTYPE = saved
    page, t, n = 16, 128, 2
    lengths = torch.tensor([100, 37], dtype=torch.int32, device=DEVICE)
    slots = torch.tensor([0, 1], dtype=torch.int32, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    ids = torch.randint(3, spec.vocab_size, (n, t), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    max_pages = (t + 2 * steps) // page + 1
    runs = {"kernels": KERNELS, "plain": PLAIN}
    caches, logits = {}, {}
    kernel_counts = {k: 0 for k in counters}

    def count(fn):
        for c in counters.values():
            c.reset()
        out = fn()
        for k, c in counters.items():
            kernel_counts[k] += c.read()
        return out

    for name, attn in runs.items():
        cache = PagedKVCache.create(spec, n * max_pages, page, n, max_pages,
                                    torch.float32, DEVICE)
        cache.block_table.copy_(torch.arange(
            n * max_pages, dtype=torch.int32,
            device=DEVICE).reshape(n, max_pages))
        call = lambda: paged_core.prefill_paged(spec, params, ids, lengths,
                                                slots, cache, page, attn=attn)
        lg, cache = count(call) if name == "kernels" else call()
        logits[name] = [lg[torch.arange(n), lengths.long() - 1]]
        caches[name] = cache
    pos = lengths.clone()
    next_ids = logits["plain"][0].argmax(-1).to(torch.int32)
    for _ in range(steps):                     # per-step decode
        for name, attn in runs.items():
            call = lambda: paged_core.decode_paged(
                spec, params, next_ids, pos, caches[name], pos + 1, page,
                attn=attn)
            lg, _ = count(call) if name == "kernels" else call()
            logits[name].append(lg)
        next_ids = logits["plain"][-1].argmax(-1).to(torch.int32)
        pos = pos + 1
    rings = {name: tuple(torch.zeros((spec.num_layers, n, spec.num_kv_heads,
                                      steps, spec.head_dim),
                                     dtype=torch.float32, device=DEVICE)
                         for _ in range(2)) for name in runs}
    chunk_start = pos.clone()
    for i in range(steps):                     # one ring chunk
        for name, attn in runs.items():
            kbuf, vbuf = rings[name]
            call = lambda: paged_core.decode_paged_ring_step(
                spec, params, next_ids, chunk_start + i, caches[name], kbuf,
                vbuf, i, chunk_start, page_size=page, attn=attn)
            lg, k_all, v_all = count(call) if name == "kernels" else call()
            kbuf[:, :, :, i] = k_all
            vbuf[:, :, :, i] = v_all
            logits[name].append(lg)
        next_ids = logits["plain"][-1].argmax(-1).to(torch.int32)
    sync(torch)
    for key in ("flash_prefill", "paged_decode_attention",
                "paged_decode_attention_stats"):
        if DEVICE == "cuda" and kernel_counts[key] <= 0:
            raise AssertionError(f"fp32 parity: {key} never launched: "
                                 f"{kernel_counts}")
    tol = 1e-3
    max_err, agree, decided = compare_logits(
        torch, list(zip(logits["kernels"], logits["plain"])), spec.vocab_size,
        tol, "fp32 parity")
    log(f"fp32 parity: float32 model ({spec.num_layers} layers of "
        f"{spec.hidden_size}, head dim {spec.head_dim}), prefill (bucket {t}, "
        f"lengths 100/37) + {steps} per-step + {steps} ring-chunk decode steps "
        f"through KERNELS against PLAIN: logits max abs err {max_err:.3e} "
        f"(tol {tol}), greedy tokens equal {agree}/{decided}; launches "
        f"{ {k: v for k, v in kernel_counts.items() if v} }")
    return kernel_counts


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
                   focus=()):
    """Where a decode step's time goes: `live` requests (512-token prompts),
    `calls` decode dispatches (of decode_chunk steps each) under
    torch.profiler. Prints the step's wall time, the card's busy time and
    share, the kernels that take the most device time, and the share of
    the kernels whose name holds each string of `focus`."""
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
    for name in focus:
        f_ms = sum(k[0] for k in kernels if name in k[2])
        f_n = sum(k[1] for k in kernels if name in k[2])
        log(f"profile[{label}]: {name}: {f_ms / steps:.4f} ms/step "
            f"({100 * f_ms / busy_ms:.1f}% of the busy time), "
            f"{f_n / steps:.2f} launches/step")
        out.update({f"{name}_ms": f_ms / steps,
                    f"{name}_launches": f_n / steps})
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
    fp32 = torch.float32
    fp64 = check_flash_prefill(torch, timer, d=64, kh=4, g=8)
    fp128 = check_flash_prefill(torch, timer, d=128, kh=8, g=4)
    fp128_g1 = check_flash_prefill(torch, timer, d=128, kh=32, g=1)
    # F2: head dims 256 (config.json of google/gemma-7b: 16 heads over 16
    # kv heads; of google/gemma-2b: 8 over 1) and 192 (16 over 2), and fp32
    # at TinyLlama widths
    fp256 = check_flash_prefill(torch, timer, d=256, kh=16, g=1)
    fp256_g8 = check_flash_prefill(torch, timer, d=256, kh=1, g=8)
    fp192 = check_flash_prefill(torch, timer, d=192, kh=2, g=8)
    fp_f32 = check_flash_prefill(torch, timer, d=64, kh=4, g=8, dtype=fp32)
    # the 3xTF32 kernel at the other head dims (the shapes above)
    fp_f32_dims = {
        "D=128 (H=32, KV=8)": check_flash_prefill(torch, timer, d=128, kh=8,
                                                  g=4, dtype=fp32),
        "D=256 (H=16, KV=16)": check_flash_prefill(torch, timer, d=256,
                                                   kh=16, g=1, dtype=fp32),
        "D=192 (H=16, KV=2)": check_flash_prefill(torch, timer, d=192, kh=2,
                                                  g=8, dtype=fp32)}
    pn = check_paged(torch, timer, stats=False)
    ps = check_paged(torch, timer, stats=True)
    pi8 = check_paged_int8(torch, timer)
    pi8_64 = check_paged_int8(torch, timer, kh=4, g=8, d=64)
    # F2: fp32 through every decode entry, against its plain version
    f32_decode = {
        "paged_decode_attention": check_paged(torch, timer, False, fp32),
        "paged_decode_attention_stats": check_paged(torch, timer, True, fp32),
        "paged_decode_attention_partial_i8": check_paged_int8(
            torch, timer, kh=4, g=8, d=64, dtype=fp32),
        "decode_attention": check_slot_decode(torch, timer, s=16, kh=4, g=8,
                                              d=64, dtype=fp32),
        "ring_decode_attention": check_ring_decode(torch, timer, 32,
                                                   dtype=fp32)}
    # K1 on a 7B layer's four products: decode rows through the stacked
    # name, prefill rows through the packed name; act-order through s4
    k1 = {entry: sum_results([check_int4(torch, timer, entry, key, m)
                              for key in K1_SHAPES])
          for m, entry in ((16, "int4_matmul_s4_stacked"),
                           (2048, "int4_matmul"))}
    k1["int4_matmul_s4"] = check_int4(torch, timer, "int4_matmul_s4", "wo",
                                      16, act_order=True)
    # row counts off the tiles (1, 17, the first prefill 65, 1000), and
    # fp16 / fp32 x on wo and w_down (K = 11008: 172 K tiles) on both routes
    k1_edges = {(m, key): check_int4(torch, timer, "int4_matmul", key, m,
                                     light=True)
                for m in (1, 17, 65, 1000) for key in K1_SHAPES}
    k1_dtypes = {(m, key, str(dt)): check_int4(torch, timer, "int4_matmul",
                                               key, m, dtype=dt, light=True)
                 for dt in (torch.float16, fp32) for key in ("wo", "w_down")
                 for m in (16, 2048)}
    for key in ("wo", "w_down"):
        check_int4_batch_invariance(torch, key)
    s1 = check_slot_decode(torch, timer, s=16, kh=4, g=8, d=64)
    s1_7b = check_slot_decode(torch, timer, s=16, kh=32, g=1, d=128)
    s2 = {step: check_ring_decode(torch, timer, step) for step in (0, 32, 63)}
    # M1 at a 7B layer's MLP: decode rows of run 6 (16 slots) and the
    # kernel's largest row tile, both activations; fp16 / fp32 x (F3)
    m1 = {(m, act): check_int4_mlp(torch, timer, m, act)
          for m in (16, 64) for act in ("silu_glu", "gelu_glu")}
    m1_dtypes = {str(dt): check_int4_mlp(torch, timer, 16, "silu_glu", dt)
                 for dt in (torch.float16, fp32)}

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
    fp32_counts = fp32_parity(torch, counters)
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

    profile_decode(torch, spec, params, "tinyllama bf16",
                   focus=("split_kernel",))

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
                   slot=True, focus=("split_kernel",))

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
    # the same in fp16 (DTYPE_STR=float16 on a GPTQ model): K1 and M1 take
    # fp16 x and return fp16
    DTYPE = torch.float16
    quant_parity(torch, spec4, random_params(torch, spec4, gptq=True))
    DTYPE = torch.bfloat16
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
                           focus=("k1_", "split_kernel", "sum_splits"))
    if prof3 and prof3["sum_splits_launches"]:
        raise AssertionError(f"a sum_splits kernel ran: {prof3}")

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
                           fused=True,
                           focus=("int4_mlp_kernel", "k1_", "sum_splits"))
    if prof6 and prof6["sum_splits_launches"]:
        raise AssertionError(f"a sum_splits kernel ran: {prof6}")
    if prof3 and prof6:
        log(f"profile 7b: run 3's config {json.dumps(prof3)}; run 6's "
            f"(INT4_FUSED_MLP=1) {json.dumps(prof6)}")

    runs = (run1, run2, run3, run4, run5, run6, probe_counts)

    def record(name, source, replaces, res, shapes):
        out = {"name": name, "route": "cuda",
               "source": f"{PORT_DIR}/csrc/{source}",
               "replaces": f"{JAX_PACKAGE_DIR}/ops/pallas/{replaces}",
               "launches": sum(run[name] for run in runs),
               "max_abs_err": res["err"], "ms": res["ms"],
               "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
               "bound_by": res["bound_by"], "library_ms": res["library_ms"],
               "shapes": shapes}
        if "dense_ms" in res:
            out["dense_ceiling_ms"] = res["dense_ms"]
        return out

    kernels = [
        record("flash_prefill", "flash_prefill.cu", "flash_prefill.py:143",
               fp64, "bf16, N=2, T=2048, lengths 1500/900, H=32, KV=4, D=64"),
        record("paged_decode_attention", "paged_attention.cu",
               "paged_attention.py:261", pn,
               "bf16, S=16, KV=4, G=8, D=64, page 128, ctx up to 2048"),
        record("paged_decode_attention_stats", "paged_attention.cu",
               "paged_attention.py:407", ps,
               "bf16, S=16, KV=4, G=8, D=64, page 128, ctx up to 2048 "
               "(rows 3 and 4: the per-layer and the stacked pool view)"),
        record("paged_decode_attention_partial_i8", "paged_attention.cu",
               "paged_attention.py:153", pi8,
               "int8 pools, bf16 q, S=16, KV=32, G=1, D=128, page 128, ctx "
               "0 to 1024"),
        record("int4_matmul_s4_stacked", "int4_matmul.cu",
               "int4_matmul.py:453", k1["int4_matmul_s4_stacked"],
               "bf16, the sum over a 7B layer's 4 products (w_qkv, wo, w_gu, "
               "w_down) at M=16"),
        record("int4_matmul_s4", "int4_matmul.cu", "int4_matmul.py:572",
               k1["int4_matmul_s4"], "bf16, wo [4096, 4096], M=16, act-order"),
        record("int4_matmul", "int4_matmul.cu", "int4_matmul.py:637",
               k1["int4_matmul"],
               "bf16, the sum over a 7B layer's 4 products at M=2048"),
        record("decode_attention", "slot_attention.cu",
               "decode_attention.py:142", s1,
               "bf16, S=16, KV=4, G=8, D=64, T=2048"),
        record("ring_decode_attention", "slot_attention.cu",
               "ring_decode_attention.py:239", s2[32],
               "bf16, S=48, KV=4, G=8, D=64, 1024 cache rows, ring 64, "
               "step 32"),
        record("int4_mlp_s4_stacked", "int4_mlp.cu", "int4_matmul.py:366",
               m1[(16, "silu_glu")],
               "bf16, a 7B layer's MLP (H=4096, I=11008), silu, M=16"),
        # the 3xTF32 body of flash prefill: the float32 model's prefill
        # (the fp32 parity phase) is its path; launches counted there
        dict(record("flash_prefill", "flash_prefill.cu",
                    "flash_prefill.py:143", fp_f32,
                    "fp32, N=2, T=2048, lengths 1500/900, H=32, KV=4, D=64"),
             name="flash_prefill_f32",
             launches=fp32_counts["flash_prefill"]),
    ]
    for (m, act), res in m1.items():
        log(f"int4_mlp_s4_stacked {act} M={m}: {json.dumps(res)}")
    for dt, res in m1_dtypes.items():
        log(f"int4_mlp_s4_stacked silu M=16 {dt} x: {json.dumps(res)}")
    for label, res in (("D=128 (H=32, KV=8)", fp128),
                       ("D=128 (H=32, KV=32, G=1)", fp128_g1),
                       ("D=256 (gemma-7b: H=16, KV=16)", fp256),
                       ("D=256 (gemma-2b: H=8, KV=1)", fp256_g8),
                       ("D=192 (H=16, KV=2)", fp192),
                       ("fp32 D=64 (H=32, KV=4)", fp_f32),
                       *((f"fp32 {k}", r) for k, r in fp_f32_dims.items())):
        log(f"flash_prefill at {label}: {json.dumps(res)}")
    for name, res in f32_decode.items():
        log(f"{name} fp32: {json.dumps(res)}")
    log(f"int4 edges (M, product): "
        f"{json.dumps({f'{m} {k}': r for (m, k), r in k1_edges.items()})}")
    log(f"int4 fp16 / fp32 x: "
        f"{json.dumps({f'{m} {k} {d}': r for (m, k, d), r in k1_dtypes.items()})}")
    log(f"decode_attention at D=128 (KV=32, G=1): {json.dumps(s1_7b)}")
    log(f"paged_decode_attention_partial_i8 at D=64 (KV=4, G=8): "
        f"{json.dumps(pi8_64)}")
    for step in (0, 63):
        log(f"ring_decode_attention at step {step}: {json.dumps(s2[step])}")
    log("launches: decode_attention in the serving runs, "
        "ring_decode_attention in the probe, int4_mlp_s4_stacked in run 6, "
        "flash_prefill_f32 in the fp32 parity phase")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
