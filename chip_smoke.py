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
             the bytes bound); every decode entry in fp32 on the 3xTF32
             body (the paged kernel in both modes, K2 with an fp32 q, S1,
             S2; the paged kernel and S1 also at Llama-2-7B decode widths,
             S2 also at ring steps 0 and 63); the int8 paged
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
             slot in a batch of 40. Sliding windows at run 7's shapes:
             flash prefill at Mistral-7B's heads and window (4096) in a
             6144 bucket with prompts of 6000 and 4500 tokens (and a window
             of 512 in a 2048 bucket, bf16 and its fp32 body), S1 at run
             7's decode widths and contexts with lower bounds ctx - 4096
             over 8192 rows (and against its split twin); each check must
             also reject the plain version with the window's edge moved by
             one key. The split body at head dim 96 (gpt-neox-20b) in both
             paged modes. ALiBi: flash prefill at BLOOM-7b1's heads in a
             2048 bucket (and its fp32 body at falcon-rw-1b's), the split
             body at BLOOM-7b1's decode widths in both paged modes, K2
             over int8 pools and S1, each also timed without slopes and
             each rejecting the plain version without slopes and with the
             next head's slopes; multi-query flash prefill and paged decode
             at StarCoder's heads (48 over 1), flash prefill at
             Falcon-7B's (71 over 1, D 64). K1's rows and dtypes (1, 17,
             65, 1000 rows; fp16 / fp32 x) beside their library call.
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
             through M1, in bf16 and again in fp16; then the families
             beyond Llama (FAMILY_CONFIGS: Mistral-7B, Qwen2-7B, Gemma-7B,
             gpt-neox-20b, gpt-j-6b, codegen-6B-mono, phi-2, falcon-7b,
             gpt2-xl, opt-6.7b, StarCoder, BLOOM-7b1, mpt-7b,
             falcon-rw-1b) at their published widths and 2 layers, random
             weights, the paged prefill and 4 decode steps (Mistral: the
             slot cache at 8192 rows, prompts of 4600 and 1000 tokens past
             its window; BLOOM-7b1 also on a 2048-row slot cache, S1 with
             slopes), each family's launches counted (an ALiBi family's
             kernels must have taken its slopes).
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
             K1 launches of every decode layer's MLP. Run 7: Mistral-7B-v0.1
             at full width and depth (random bf16 weights) on the slot
             engine in scan mode, max_seq 8192, 8 slots, 8 prompts of
             300-6000 tokens (four past its window of 4096): flash prefill
             and S1 must both run cut at the window. Run 8: Gemma-7B at full
             width and depth on the default paged engine, max_seq 2048,
             two requests streaming, then eight prompts near max_seq at
             once, which the prefill cap (2048 padded tokens) takes a row
             at a time, one asking for its input tokens' details: flash
             prefill's D = 256 body and the split body at D = 256; its peak
             of allocated memory less params, pool and the graphs' pool
             must stay within the plan's graph-pool term (F4). Run 9:
             StarCoder-15.5B at full width and depth (multi-query), paged,
             max_seq 8192, prompts of 500-7500 tokens. Run 10: BLOOM-7b1
             at full width and depth (ALiBi), paged, run 8's traffic and
             memory check. Run 11: mt0-xxl (bigscience/mt0-xxl's widths:
             24 + 24 layers, d_model 4096, 64 heads, gated-GELU, vocab
             250112) at full width and depth on the seq2seq engine, max_seq
             1024, 16 slots, at the default chunk and on ring chunks of 8:
             12 requests, prompts 50-1000, 48 new (wave A 8 unary; B 4, two
             streaming, two behind a soft prompt with an `encoder.pt` and a
             `decoder.pt`), + gRPC with ModelInfo (ENCODER_DECODER); the T5
             path reaches no kernel of the port, so every counter must read
             0. All with gRPC. Every run logs its prefill batches and its
             peak of allocated device memory, and holds every prefill
             dispatch within the cap.
  5. probe   the port's ring-decode probe (`tools/probe_decode.py`): one
             chunk of 64 ring-decode steps over 48 slots at full TinyLlama
             width, attention inline (the engine's formulation) or through
             S2, at context buckets of 256 and 1024 rows; ms per step, and
             whether the two formulations choose the same greedy ids.
  6. graphs  the decode programs (one captured CUDA graph per decode key,
             `engine/programs.py`) in four configs, after run 2 (TinyLlama
             bf16 paged, per-step decode, 8 live requests), after run 4
             (the slot engine in scan mode, 8 live), after run 3 (7B GPTQ
             + int8 KV, ring chunks of 8, 16 live; the first
             GRAPHS_7B_LAYERS (4) of its 32 layers, to keep the script
             within its time limit) and
             after run 6 (as run 3, INT4_FUSED_MLP=1): (1) a graph engine and an eager one
             (`eager_decode=True`) built alike, in lockstep through a
             staggered schedule (`tools/decode_replay.py`): outputs, state
             and KV equal bit for bit, keys replayed out of their capture
             order, pipelined dispatch equal to sequential; (2) in turns
             eager, graphs, graphs, eager: wall ms a step by the host clock,
             device busy ms and idle share from torch.profiler (CUDA-event
             spans where CUPTI reports no kernel of a replay), host calls
             that enqueue device work a step, the programs captured, their
             capture seconds and the graphs' pool, beside the card's name
             and power limit; the kernels each config is about (the bf16
             paged kernel, S1, K1 and K2, M1 and K1; no `sum_splits` kernel
             may run). Then the seq2seq engine's programs in run 11's two
             configs at mt0-xxl's widths (GRAPHS_MT0_LAYERS, 4 + 4
             layers) and at google-t5/t5-large's (v1.0: ReLU, tied head;
             24 + 24): the same lockstep, then every program of the
             grid once on both engines (`decode_replay.every_program`); at
             mt0-xxl also the same timing.
  7. speculative decoding: fp32 exactness (TinyLlama widths, 4 layers:
             speculative tokens equal plain tokens on both engines, with a
             speculator that drafts the token the plain streams repeat
             most); the distilled measurement (`tools/spec_measure.py` at
             TinyLlama's full width and depth, made predictable: acceptance,
             tokens per model call, tok/s against plain, distilling for at
             most 30 s), then the bf16 streams of both engines against
             plain up to their first difference, allowed only where the
             plain top-2 margin is within FAMILY_ULPS bf16 ulps; replay ==
             eager bit for bit for every verify program
             (`decode_replay.spec_lockstep` + `every_program`: the paged
             engine on ring chunks of 8 with its gate at 3 rows, the slot
             engine); verify against plain decode on the same teacher-forced
             tokens at Llama-2-7B widths (16 layers, bf16, paged and slot:
             within FAMILY_ULPS bf16 ulps of the largest |logit|; and a
             4-layer GPTQ-INT4 model whose verify products run K1 at 64
             rows); serving run 12: Llama-2-7B at full width and depth on
             the paged speculative engine (SPECULATOR=1: a random-init
             speculator, n_predict 3, inner dim 2048;
             SPECULATOR_MAX_BATCH_SIZE=8), 16 slots, max_seq 2048, 6 greedy
             requests, then 8 more while they decode (a seeded sampling row
             and a repetition-penalty row among them; 14 active, so the gate
             takes plain steps), + gRPC: speculative and plain steps, flash
             prefill and the paged kernel must run, the peak less params,
             pool within the plan (the graph-pool term + speculative
             bytes); then the wall and busy ms of a verify step
             against a plain step at 8 live.
  8. int8    weights (QUANTIZE=int8 / int8-outliers / bitsandbytes; plain
             torch products, no kernel of their own): a 4-layer model at
             Llama-2-7B widths quantized on the card, through the kernels
             against the plain versions in bf16 ulps (`model_parity`);
             activation outliers planted in three features, which
             calibration on the card (flash prefill) must find exactly,
             and KL(bf16 || int8-outliers) below KL(bf16 || int8), both
             printed. Serving run 13: Llama-2-7B at full width and depth,
             random bf16 weights quantized to int8 on the card, the paged
             engine, max_seq 8192, driven through generate.v1 over gRPC on
             a local port (`server/internal_server.py`): a Prefill of 8
             prompts (64-1024 tokens, one asking for its input tokens and
             logprobs), NextToken with `completed_ids` deltas, a second
             Prefill of 4 merged in, PruneBatch, ModelInfo, ClearCache;
             every NextToken one replay of a captured chunk-1 program (both
             detail flags); the greedy tokens equal the Batcher's for the
             same prompts on the same engine; the params' bytes against the
             bf16 model's, the int8 decode step against the bf16 one at 8
             live, and the peak less params, pool and graphs' pool against
             the plan (activation + int8 transient bytes). Then the GPTQ
             solve (`ops/quant/gptq_quantize.py`) on the card against the
             CPU at [256, 512], and one 7B linear timed (act-order off and
             on) with a whole-7B estimate.

  9. tp      tensor parallelism (`parallel/`): the kernels at the shapes
             of a rank at world size 2 against their plain versions
             (Llama-2-7B's 16 query over 16 kv heads: flash prefill, the
             split body in both modes, K2; K1 on the four products'
             shards at 16 and 1024 rows; M1 on the MLP's shards, I 5504;
             StarCoder's 24 query heads over its one kv head: flash
             prefill, the split body); world size 1 over NCCL (a graph
             engine and an eager one on a group of one, in lockstep: each
             decode program captured with its collectives, replay ==
             eager bit for bit; then both timed); world size 2 on this
             card, two processes over gloo on CUDA tensors (NCCL refuses
             two ranks on one device; a gloo collective goes through the
             host, so decode is eager), each pool TP_PAGES pages:
             Llama-2-7B widths cut to TP_LAYERS layers in bf16, then
             GPTQ-INT4 with an int8 KV pool under INT4_FUSED_MLP=1, each
             with rank 0's logits within FAMILY_ULPS bf16 ulps of world
             size 1 (rank 0 runs the whole model too), greedy streams
             equal up to near-ties (`first_differences`), the step time at
             both world sizes, then served through the Batcher and gRPC on
             rank 0 over a `ReplicatedEngine` while rank 1 replays its ops;
             then StarCoder's widths cut to TP_STARCODER_LAYERS layers
             held to world size 1 the same way. Each rank must launch the
             run's kernels (TP_KERNELS) and pick rank 0's tokens.
             `--tp-only` runs the build and this phase alone.
 10. prefill the prefill programs (one captured CUDA graph per JAX prefill
             key, `engine/programs.py`), after the seq2seq graphs phases:
             for TinyLlama bf16 on the paged and on the slot engine (scan),
             Llama-2-7B widths with GPTQ-INT4 weights and int8 KV (8 of
             32 layers, max_seq 4096), the paged speculative engine at
             Llama-2-7B widths (8 layers) and the seq2seq engine at
             t5-large's widths: a graph engine and an eager one, both
             warmed up (the warm grid captured; capture time and the
             graphs' pool against the plan's graph-pool term printed), in
             lockstep through prefill dispatches of several row counts and
             buckets, a details key and a soft-prompt key run twice, keys
             captured at first use while a request is live
             (`decode_replay.prefill_lockstep`: first tokens, prompt
             details, state and KV equal bit for bit); then TinyLlama at
             1 x 64, 1 x 256, 1 x 1024 and 8 x 256 and the 7B at 1 x 512
             and 8 x 512 timed in turns eager, graphs, graphs, eager
             (`time_prefill`: wall ms by the host clock, busy ms and idle
             share from torch.profiler, host launches a dispatch), flash
             prefill and K1 launches equal in both modes.
             `--prefill-only` runs the build and this phase alone.

Serving runs 1-13 serve through the captured programs: every prefill and
every decode dispatch must be a graph replay (the warm grid captured at
warmup, other prefill keys at their first use), and a kernel's launches
count each replay of a graph times the launches its capture recorded.
Runs 8 and 10 hold the graphs' pool, and the peak less params and KV, to
the plan's one graph-pool term. The tp phase's world size 2 runs prefill
and decode eagerly.

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
# the depth of the 7B decode graphs phases (of 32 layers) and of the
# mt0-xxl seq2seq graphs phase (of 24 + 24), cut to keep the script within
# its time limit; the serving runs keep every layer
GRAPHS_7B_LAYERS = 4
GRAPHS_MT0_LAYERS = 4

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

# The RoPE families beyond Llama at their published widths: the fields of
# each config.json that the port's spec builders read (`models/families.py`
# FAMILIES), from the model repos named beside them.
FAMILY_CONFIGS = {
    # mistralai/Mistral-7B-v0.1
    "mistral": dict(model_type="mistral", vocab_size=32000,
                    hidden_size=4096, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8,
                    intermediate_size=14336, max_position_embeddings=32768,
                    rms_norm_eps=1e-5, rope_theta=10000.0,
                    sliding_window=4096, tie_word_embeddings=False),
    # Qwen/Qwen2-7B
    "qwen2": dict(model_type="qwen2", vocab_size=152064, hidden_size=3584,
                  num_hidden_layers=28, num_attention_heads=28,
                  num_key_value_heads=4, intermediate_size=18944,
                  max_position_embeddings=131072, rms_norm_eps=1e-6,
                  rope_theta=1000000.0, sliding_window=131072,
                  use_sliding_window=False, tie_word_embeddings=False),
    # google/gemma-7b
    "gemma": dict(model_type="gemma", vocab_size=256000, hidden_size=3072,
                  num_hidden_layers=28, num_attention_heads=16,
                  num_key_value_heads=16, head_dim=256,
                  intermediate_size=24576, max_position_embeddings=8192,
                  rms_norm_eps=1e-6, rope_theta=10000.0, hidden_act="gelu"),
    # EleutherAI/gpt-neox-20b
    "gpt_neox": dict(model_type="gpt_neox", vocab_size=50432,
                     hidden_size=6144, num_hidden_layers=44,
                     num_attention_heads=64, intermediate_size=24576,
                     rotary_pct=0.25, rotary_emb_base=10000,
                     max_position_embeddings=2048, layer_norm_eps=1e-5,
                     hidden_act="gelu_fast", use_parallel_residual=True),
    # EleutherAI/gpt-j-6b
    "gptj": dict(model_type="gptj", vocab_size=50400, n_embd=4096,
                 n_layer=28, n_head=16, rotary_dim=64, n_positions=2048,
                 n_inner=None, layer_norm_epsilon=1e-5,
                 activation_function="gelu_new"),
    # Salesforce/codegen-6B-mono
    "codegen": dict(model_type="codegen", vocab_size=51200, n_embd=4096,
                    n_layer=33, n_head=16, rotary_dim=64, n_positions=2048,
                    n_inner=None, layer_norm_epsilon=1e-5,
                    activation_function="gelu_new"),
    # microsoft/phi-2
    "phi": dict(model_type="phi", vocab_size=51200, hidden_size=2560,
                num_hidden_layers=32, num_attention_heads=32,
                intermediate_size=10240, partial_rotary_factor=0.4,
                max_position_embeddings=2048, layer_norm_eps=1e-5,
                hidden_act="gelu_new", rope_theta=10000.0,
                qk_layernorm=False),
    # tiiuae/falcon-7b
    "falcon": dict(model_type="falcon", vocab_size=65024, hidden_size=4544,
                   num_hidden_layers=32, num_attention_heads=71,
                   multi_query=True, parallel_attn=True,
                   new_decoder_architecture=False, alibi=False, bias=False,
                   layer_norm_epsilon=1e-5),
    # the learned-position families
    # openai-community/gpt2-xl
    "gpt2": dict(model_type="gpt2", vocab_size=50257, n_embd=1600,
                 n_layer=48, n_head=25, n_positions=1024, n_inner=None,
                 layer_norm_epsilon=1e-5, activation_function="gelu_new"),
    # facebook/opt-6.7b
    "opt": dict(model_type="opt", vocab_size=50272, hidden_size=4096,
                num_hidden_layers=32, num_attention_heads=32, ffn_dim=16384,
                max_position_embeddings=2048, do_layer_norm_before=True,
                word_embed_proj_dim=4096, activation_function="relu",
                enable_bias=True),
    # bigcode/starcoder
    "gpt_bigcode": dict(model_type="gpt_bigcode", vocab_size=49152,
                        n_embd=6144, n_layer=40, n_head=48,
                        n_positions=8192, n_inner=24576, multi_query=True,
                        layer_norm_epsilon=1e-5,
                        activation_function="gelu_pytorch_tanh"),
    # the ALiBi families
    # bigscience/bloom-7b1
    "bloom": dict(model_type="bloom", vocab_size=250880, hidden_size=4096,
                  n_layer=30, n_head=32, layer_norm_epsilon=1e-5),
    # mosaicml/mpt-7b
    "mpt": dict(model_type="mpt", vocab_size=50432, d_model=4096,
                n_layers=32, n_heads=32, expansion_ratio=4, max_seq_len=2048,
                attn_config=dict(alibi=True, clip_qkv=None,
                                 softmax_scale=None),
                no_bias=True),
    # tiiuae/falcon-rw-1b
    "falcon_rw": dict(model_type="falcon", vocab_size=50304,
                      hidden_size=2048, num_hidden_layers=24,
                      num_attention_heads=32, multi_query=False,
                      parallel_attn=False, new_decoder_architecture=False,
                      alibi=True, bias=True, layer_norm_epsilon=1e-5),
}
# the families whose LayerNorms have no bias (mpt-7b's no_bias)
NO_NORM_BIAS = ("mpt",)


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
    it; operations over `peak`, else the card's fp32 peak outside the
    tensor cores (fp32 decode: the lower rate, so the larger time) or the
    bf16 tensor cores."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / (peak or (PEAK_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS))
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# --- phase 2: kernels -------------------------------------------------------


def alibi_slopes(torch, kh: int, g: int):
    """The bloom-formula ALiBi slopes of kh * g heads as [KV, G] on the card
    (the port's own `alibi_slopes`)."""
    from text_generation_inference_tpu_torch.models.core import alibi_slopes as fn

    return torch.from_numpy(fn(kh * g)).reshape(kh, g).to(DEVICE)


def next_head(slopes):
    """Each head given the next head's slope: a kernel that misplaces the
    head of a row must be told from the right one."""
    return slopes.flatten().roll(-1).reshape(slopes.shape).contiguous()


def check_flash_prefill(torch, timer, d: int, kh: int, g: int, dtype=None,
                        window: int = 0, t: int = 2048, lens=(1500, 900),
                        alibi: bool = False):
    """Flash prefill over right-padded sequences of `lens` tokens in a
    bucket of t at (D, KV heads, group), bf16 by default; fp32 runs the
    3xTF32 tensor-core kernel, held to 1e-4 of the plain version (and its
    error against its twin, `flash_prefill_tf32x3_reference`, is logged).
    With `window`, a sliding window of that many keys (its library call:
    SDPA with the band as a boolean mask), q scaled by 4 (exact in bf16) so
    that a few keys carry each row, and the tolerance must reject the plain
    version at window - 1, window + 1 and without a window: the check
    tells a kernel that misplaces the window's edge by one key. With
    `alibi`, the bloom slopes of H heads: the tolerance must reject the
    plain version without slopes and with each head given the next head's
    slope; the kernel is also timed without slopes on the same inputs
    (`ms_no_slopes`), and its library call is SDPA with the causal ALiBi
    bias as a float mask."""
    from text_generation_inference_tpu_torch.ops.cuda import flash_prefill as fp

    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + d + window)
    n = len(lens)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v = rnd(n, t, kh, g, d), rnd(n, t, kh, d), rnd(n, t, kh, d)
    if window:
        q = q * 4
    slopes = alibi_slopes(torch, kh, g) if alibi else None
    got = fp.flash_prefill(q, k, v, lengths, window=window, slopes=slopes)
    want = fp.flash_prefill_reference(q, k, v, lengths, window, slopes)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    # the kernel rounds P to bf16 for the tensor-core value product (as
    # FlashAttention-2 does) and both round the output to bf16 once: allow
    # about two bf16 ulps, atol 2e-2 + rtol 1e-2; fp32 computes in fp32
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1e-2)
    tol = f"atol {atol} + rtol {rtol}"
    if not bool((diff <= atol + rtol * want.float().abs()).all()):
        raise AssertionError(f"flash_prefill D={d} window {window}: max abs "
                             f"err {err} outside {tol}")
    del diff
    if window:
        for other in (window - 1, window + 1, 0):
            wrong = fp.flash_prefill_reference(q, k, v, lengths, other)
            gap = (wrong.float() - want.float()).abs()
            if bool((gap <= atol + rtol * want.float().abs()).all()):
                raise AssertionError(
                    f"flash_prefill window {window}: {tol} does not reject "
                    f"the plain version at window {other}")
            tol += (f"; rejects window {other} (max gap "
                    f"{gap.max().item():.3e})")
            del wrong, gap
    if alibi:
        live = (torch.arange(t, device="cuda")[None, :]
                < lengths[:, None].long())

        def close(a, b):
            if not bool(((a.float() - b.float()).abs()
                         <= atol + rtol * b.float().abs()).all()):
                raise AssertionError(f"flash_prefill D={d}: outside {tol}")

        tol += alibi_rejections(
            torch, got[live], lambda sl: fp.flash_prefill_reference(
                q, k, v, lengths, window, sl)[live], slopes, close,
            f"flash_prefill D={d}")
    if dtype == torch.float32:
        twin = fp.flash_prefill_tf32x3_reference(q, k, v, lengths, window,
                                                 slopes)
        tol += (f"; against the 3xTF32 twin "
                f"{(got - twin).abs().max().item():.3e}")
        del twin
    ms = timer(lambda: fp.flash_prefill(q, k, v, lengths, window=window,
                                        slopes=slopes))
    ms_no_slopes = (timer(lambda: fp.flash_prefill(q, k, v, lengths,
                                                   window=window))
                    if alibi else None)
    plain_ms = timer(lambda: fp.flash_prefill_reference(q, k, v, lengths,
                                                        window, slopes),
                     iters=3, warmup=1)
    # yardstick: one causal SDPA call over the full bucket (no lengths;
    # with a window, its band as a boolean mask)
    qh = q.reshape(n, t, kh * g, d).transpose(1, 2).contiguous()
    kx = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    vx = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window:
        pos = torch.arange(t, device="cuda")
        band = ((pos[None, :] <= pos[:, None])
                & (pos[None, :] > pos[:, None] - window))
        library_ms = timer(lambda: sdpa(qh, kx, vx, attn_mask=band))
    elif alibi:
        pos = torch.arange(t, device="cuda")
        rel = (pos[None, :] - pos[:, None]).float()
        bias = torch.where(rel <= 0, slopes.reshape(-1, 1, 1) * rel,
                           float("-inf")).to(q.dtype)[None]
        library_ms = timer(lambda: sdpa(qh, kx, vx, attn_mask=bias))
        del bias
    else:
        library_ms = timer(lambda: sdpa(qh, kx, vx, is_causal=True))
    # work this run's data needs: query row i < len sees min(i+1, window)
    # keys, a padded row the len live ones
    rows = torch.arange(1, t + 1, device="cuda")
    pairs = sum(int(torch.where(rows <= int(ln),
                                torch.clamp(rows, max=window or t),
                                int(ln)).sum()) for ln in lengths)
    flops = 4.0 * d * kh * g * pairs
    b_ms, b_by = bound(nbytes(q, k, v, got, lengths), flops,
                       peak=peak_flops(dtype))
    tflops = flops / (ms * 1e-3) / 1e12
    log(f"kernel flash_prefill {str(dtype).split('.')[-1]} D={d} N={n} T={t} "
        f"lengths {list(lens)} H={kh * g} KV={kh}"
        f"{f' window {window}' if window else ''}"
        f"{f' ALiBi (without slopes {ms_no_slopes:.4f} ms)' if alibi else ''}"
        f": max_abs_err {err:.3e} (tol {tol}) ms {ms:.4f} plain_ms "
        f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms {b_ms:.4f} "
        f"({b_by}); {flops / 1e9:.1f} GFLOP at {tflops:.1f} TFLOP/s "
        f"({100 * tflops / (peak_flops(dtype) / 1e12):.1f}% of the "
        f"{'3xTF32' if dtype == torch.float32 else 'bf16'} peak)")
    out = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=library_ms, tflops=tflops)
    if alibi:
        out["ms_no_slopes"] = ms_no_slopes
    return out


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


def paged_library_call(torch, q, kp, vp, bt, ctx, page, slopes=None):
    """One SDPA call on the same work: the live pages gathered (outside the
    timing) into a dense [S, H, T, D] view with a length mask (with
    `slopes`, a float mask carrying the ALiBi bias)."""
    s, kh, g, d = q.shape
    t = int(ctx.max())
    rows = (bt.long()[:, :, None] * page
            + torch.arange(page, device="cuda")).reshape(s, -1)[:, :t]
    rows = rows.clamp(max=kp.shape[1] - 1)
    kd = kp[:, rows].permute(1, 0, 2, 3).repeat_interleave(g, dim=1)
    vd = vp[:, rows].permute(1, 0, 2, 3).repeat_interleave(g, dim=1)
    mask = (torch.arange(t, device="cuda")[None, :] < ctx[:, None])[:, None, None]
    if slopes is not None:
        pos = torch.arange(t, device="cuda").float()
        mask = torch.where(mask, slopes.reshape(1, -1, 1, 1) * pos,
                           float("-inf")).to(q.dtype)
    qh = q.reshape(s, kh * g, 1, d)
    kd, vd = kd.contiguous(), vd.contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qh, kd, vd, attn_mask=mask)


def alibi_rejections(torch, got, ref, slopes, check, what) -> str:
    """The plain version `ref(slopes)` without slopes and with each head
    given the next head's slope must fail `check(got, wrong)` (which raises
    AssertionError outside its tolerance); returns the largest gaps over
    finite entries, for the log."""
    out = ""
    for label, other in (("no slopes", None),
                         ("the next head's slopes", next_head(slopes))):
        wrong = ref(other)
        pairs = list(zip(*(x if isinstance(x, tuple) else (x,)
                           for x in (got, wrong))))
        try:
            check(got, wrong)
        except AssertionError:
            gap = max(torch.where(torch.isfinite(b), (a.float() - b.float())
                                  .abs(), 0.0).max().item() for a, b in pairs)
            out += f"; rejects {label} (max gap {gap:.3e})"
            continue
        raise AssertionError(f"{what} ALiBi: the tolerance does not reject "
                             f"the plain version with {label}")
    return out


def check_paged(torch, timer, stats: bool, dtype=None, kh=4, g=8, d=64,
                alibi: bool = False):
    """The paged kernel (normalized, or its stats mode) at TinyLlama decode
    widths by default. With `alibi`, the bloom slopes of its heads: the
    tolerances must reject the plain version without slopes and with the
    next head's slopes, and the kernel is also timed without slopes."""
    from text_generation_inference_tpu_torch.ops.cuda import paged_attention as pa

    q, kp, vp, bt, ctx, page = paged_inputs(torch, kh=kh, g=g, d=d,
                                            dtype=dtype)
    fp32 = q.dtype == torch.float32
    s, kh, g, d = q.shape
    slopes = alibi_slopes(torch, kh, g) if alibi else None
    name = "paged_decode_attention_stats" if stats else "paged_decode_attention"
    if stats:
        fn = lambda sl=slopes: pa.paged_decode_attention_partial(
            q, kp, vp, bt, ctx, page, sl)
        ref = lambda sl=slopes: pa.paged_decode_attention_partial_reference(
            q, kp, vp, bt, ctx, page, sl)
        got, want = fn(), ref()
        acc_abs = pa.paged_decode_attention_partial_reference(
            q, kp, vp.abs(), bt, ctx, page, slopes)[0]
        torch.cuda.synchronize()
        err, tol = stats_error(torch, got, want, acc_abs, "paged stats", fp32)
        out_bytes = nbytes(*got)
    else:
        fn = lambda sl=slopes: pa.paged_decode_attention(q, kp, vp, bt, ctx,
                                                         page, sl)
        ref = lambda sl=slopes: pa.paged_decode_attention_reference(
            q, kp, vp, bt, ctx, page, sl)
        got, want = fn(), ref()
        torch.cuda.synchronize()
        err, tol = bf16_close(torch, got, want, "paged decode", fp32)
        out_bytes = nbytes(got)
    if alibi:
        tol += alibi_rejections(
            torch, got, ref, slopes,
            (lambda a, b: stats_error(torch, a, b, acc_abs, name, fp32))
            if stats else (lambda a, b: bf16_close(torch, a, b, name, fp32)),
            name)
    ms = timer(fn, iters=20)
    ms_no_slopes = timer(lambda: fn(None), iters=20) if alibi else None
    plain_ms = timer(ref, iters=3, warmup=1)
    library_ms = timer(paged_library_call(torch, q, kp, vp, bt, ctx, page,
                                          slopes))
    live = int(ctx.sum())
    kv_bytes = 2 * live * kh * d * kp.element_size()
    flops = 4.0 * live * kh * g * d
    moved = nbytes(q, bt, ctx) + kv_bytes + out_bytes
    b_ms, b_by = bound(moved, flops, fp32)
    gbps = moved / (ms * 1e-3) / 1e9
    log(f"kernel {name} {str(q.dtype).split('.')[-1]} S={s} KV={kh} G={g} D={d} page={page} ctx_max="
        f"{int(ctx.max())} live_tokens={live}"
        f"{f' ALiBi (without slopes {ms_no_slopes:.4f} ms)' if alibi else ''}"
        f": max_abs_err {err:.3e} (tol "
        f"{tol}) ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{library_ms:.4f} bound_ms {b_ms:.4f} ({b_by}); {moved / 1e6:.2f} "
        f"MB at {gbps:.1f} GB/s, {100 * b_ms / ms:.1f}% of the bound")
    out = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=library_ms, gbps=gbps)
    if alibi:
        out["ms_no_slopes"] = ms_no_slopes
    return out


def stats_error(torch, got, want, acc_abs, what, fp32=False):
    """Max abs error of (acc, m, l) over the finite entries, each stat held
    to its own tolerance (raises if one is outside it; the -inf pattern of
    m must match):
      acc  elementwise 2^-8 * acc_abs + 1e-4, acc_abs the plain version's
           accumulator over |v|: the kernel rounds p (times the v scale) to
           bf16 for its value product, at most 2^-9 of each term;
      m    1e-4 of max(1, |m|): both take the max of the same fp32 scores;
      l    1e-3 of max(1, max l): the same fp32 sum in another order.
    fp32 (`fp32`: the 3xTF32 body, p split in two TF32 terms): acc within
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


def check_paged_int8(torch, timer, kh=32, g=1, d=128, dtype=None,
                     alibi: bool = False, max_pages: int = 8):
    """K2, the stats mode over int8 pools: at Llama-2-7B decode widths (16
    slots, 32 kv heads, G = 1, D = 128) or TinyLlama's (4 kv heads, G = 8,
    D = 64); page 128 (two pages a split), contexts up to 1024 (max_pages
    8), a ctx == 0 slot and a sentinel page inside slot 4's first split.
    With `alibi`, as `check_paged`."""
    from text_generation_inference_tpu_torch.models.core import quantize_kv
    from text_generation_inference_tpu_torch.ops.cuda import paged_attention as pa

    q, kp, vp, bt, ctx, page = paged_inputs(torch, s=16, kh=kh, g=g, d=d,
                                            max_pages=max_pages, first_ctx=0,
                                            dtype=dtype)
    fp32 = q.dtype == torch.float32
    slopes = alibi_slopes(torch, kh, g) if alibi else None
    bt[4, 1] = kp.shape[1] // page              # the sentinel, in split 0
    kq, ks = quantize_kv(kp)
    vq, vs = quantize_kv(vp)
    # the library call's input: the dequantized pools, made outside timing
    kd = (kq.float() * ks[..., None]).to(q.dtype)
    vd = (vq.float() * vs[..., None]).to(q.dtype)
    del kp, vp
    s = q.shape[0]
    fn = lambda sl=slopes: pa.paged_decode_attention_partial_i8(
        q, kq, vq, ks, vs, bt, ctx, page, sl)
    ref = lambda sl=slopes: pa.paged_decode_attention_partial_reference(
        q, kq, vq, bt, ctx, page, sl, k_scale_pool=ks, v_scale_pool=vs)
    got, want = fn(), ref()
    acc_abs = pa.paged_decode_attention_partial_reference(
        q, kq, vq.abs(), bt, ctx, page, slopes, k_scale_pool=ks,
        v_scale_pool=vs)[0]
    torch.cuda.synchronize()
    err, tol = stats_error(torch, got, want, acc_abs, "paged int8 stats",
                           fp32)
    if alibi:
        tol += alibi_rejections(
            torch, got, ref, slopes,
            lambda a, b: stats_error(torch, a, b, acc_abs, "K2", fp32), "K2")
    if not (torch.isneginf(got[1][0]).all() and (got[2][0] == 0).all()
            and (got[0][0] == 0).all()):
        raise AssertionError("paged decode int8: ctx == 0 slot not empty")
    same_slot_in_a_batch(
        torch, f"paged_decode_attention_partial_i8 D={d}",
        lambda idx: pa.paged_decode_attention_partial_i8(
            q[idx].contiguous(), kq, vq, ks, vs, bt[idx].contiguous(),
            ctx[idx].contiguous(), page, slopes)[0], s)
    ms = timer(fn, iters=20)
    ms_no_slopes = timer(lambda: fn(None), iters=20) if alibi else None
    plain_ms = timer(ref, iters=3, warmup=1)
    library_ms = timer(paged_library_call(torch, q, kd, vd, bt, ctx, page,
                                          slopes))
    # live keys: below ctx and not on the sentinel page
    live = int(ctx.sum()) - page
    # int8 k and v rows plus one f32 scale each per (row, kv head)
    kv_bytes = 2 * live * kh * (d * kq.element_size() + ks.element_size())
    flops = 4.0 * live * kh * g * d
    moved = nbytes(q, bt, ctx, *got) + kv_bytes
    b_ms, b_by = bound(moved, flops, fp32)
    gbps = moved / (ms * 1e-3) / 1e9
    log(f"kernel paged_decode_attention_partial_i8 q {str(q.dtype).split('.')[-1]} S={s} KV={kh} G={g} D={d} "
        f"page={page} ctx_max={int(ctx.max())} live_tokens={live}"
        f"{f' ALiBi (without slopes {ms_no_slopes:.4f} ms)' if alibi else ''}"
        f": max_abs_err {err:.3e} (tol {tol}) ms {ms:.4f} plain_ms "
        f"{plain_ms:.4f} library_ms {library_ms:.4f} (SDPA on the gathered, "
        f"dequantized pages) bound_ms {b_ms:.4f} ({b_by}); "
        f"{moved / 1e6:.2f} MB at {gbps:.1f} GB/s, "
        f"{100 * b_ms / ms:.1f}% of the bound")
    out = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=library_ms, gbps=gbps)
    if alibi:
        out["ms_no_slopes"] = ms_no_slopes
    return out


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


def sdpa_call(torch, q, keys, values, live, slopes=None):
    """The yardstick: one SDPA call over [S, H, N, D] keys / values (the
    GQA heads repeated beforehand) with a boolean mask of the live ones
    (with `slopes`, a float mask carrying the ALiBi bias of each row)."""
    s, kh, g, d = q.shape
    qh = q.reshape(s, kh * g, 1, d)
    kx = keys.repeat_interleave(g, dim=1).contiguous()
    vx = values.repeat_interleave(g, dim=1).contiguous()
    mask = live[:, None, None, :]
    if slopes is not None:
        pos = torch.arange(live.shape[1], device="cuda").float()
        mask = torch.where(mask, slopes.reshape(1, -1, 1, 1) * pos,
                           float("-inf")).to(q.dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qh, kx, vx, attn_mask=mask)


def check_slot_decode(torch, timer, s, kh, g, d, t=2048, dtype=None,
                      window=0, ctx=None, alibi: bool = False):
    """S1 over one layer's slot cache [S, KV, T, D], ctx spread over 0..T
    unless given; with `window`, the lower bounds lo = ctx - window (a
    sliding window). There the keys at lo - 1 (just outside) and lo (the
    first one inside) of every cut slot point along the slot's queries, the
    outer one harder, and the tolerance must reject the plain version at
    the bounds lo - 1 and lo + 1: the check tells a kernel that misplaces
    the bound by one row. With `alibi`, as `check_paged`."""
    from text_generation_inference_tpu_torch.ops.cuda import decode_attention as da

    dtype = dtype or torch.bfloat16
    fp32 = dtype == torch.float32
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31 + d + window)
    rnd = lambda *shape: torch.randn(*shape, generator=gen,
                                     device="cuda").to(dtype)
    q, k, v = rnd(s, kh, g, d), rnd(s, kh, t, d), rnd(s, kh, t, d)
    ctx = torch.from_numpy(spread_ctx(s, t, d) if ctx is None else
                           np.asarray(ctx, np.int32)).cuda()
    lo = (ctx - window).clamp(min=0).to(torch.int32) if window else None
    if window:
        # the queries' mean direction per (slot, kv head): scores of about
        # 30 (outer) and 20 (inner) against about 1 for a random key
        u = q.float().sum(2)
        u = u / u.norm(dim=-1, keepdim=True)
        for slot in torch.nonzero(lo > 0).flatten().tolist():
            b = int(lo[slot])
            k[slot, :, b - 1] = (60 * u[slot]).to(dtype)
            k[slot, :, b] = (40 * u[slot]).to(dtype)
    slopes = alibi_slopes(torch, kh, g) if alibi else None
    fn = lambda sl=slopes: da.decode_attention(q, k, v, ctx, lo, sl)
    ref = lambda sl=slopes: da.decode_attention_reference(q, k, v, ctx, lo,
                                                          sl)
    got, want = fn(), ref()
    torch.cuda.synchronize()
    err, tol = bf16_close(torch, got, want, f"decode_attention D={d}", fp32)
    if not bool((got[ctx == 0] == 0).all()):
        raise AssertionError("decode_attention: a ctx == 0 slot is not 0")
    if alibi:
        twin = da.decode_attention_split_reference(q, k, v, ctx, lo=lo,
                                                   slopes=slopes)
        bf16_close(torch, got, twin, f"decode_attention D={d} ALiBi against "
                   "its split twin", fp32)
        tol += alibi_rejections(
            torch, got, ref, slopes,
            lambda a, b: bf16_close(torch, a, b, "S1", fp32), "S1")
    if window:
        twin = da.decode_attention_split_reference(q, k, v, ctx, lo=lo)
        bf16_close(torch, got, twin, f"decode_attention D={d} window "
                   f"{window} against its split twin", fp32)
        cut = lo > 0
        for shift in (-1, 1):
            wrong = da.decode_attention_reference(
                q, k, v, ctx, torch.where(cut, lo + shift, lo))
            gap = (wrong.float() - want.float()).abs()
            atol = 1e-4 if fp32 else 2e-2
            if bool((gap <= atol + atol * want.float().abs()).all()):
                raise AssertionError(
                    f"decode_attention window {window}: {tol} does not "
                    f"reject the plain version at lo {shift:+d}")
            tol += f"; rejects lo {shift:+d} (max gap {gap.max().item():.3e})"
    same_slot_in_a_batch(
        torch, f"decode_attention D={d}",
        lambda idx: da.decode_attention(
            q[idx].contiguous(), k[idx], v[idx], ctx[idx].contiguous(),
            None if lo is None else lo[idx].contiguous(), slopes), s)
    ms = timer(fn, iters=20)
    ms_no_slopes = timer(lambda: fn(None), iters=20) if alibi else None
    plain_ms = timer(ref, iters=3, warmup=1)
    rows = torch.arange(t, device="cuda")[None, :]
    live_rows = rows < ctx[:, None]
    if window:
        live_rows = live_rows & (rows >= lo[:, None])
    library_ms = timer(sdpa_call(torch, q, k, v, live_rows, slopes))
    live = int(live_rows.sum())
    flops = 4.0 * live * kh * g * d
    moved = nbytes(q, ctx, got) + 2 * live * kh * d * q.element_size()
    b_ms, b_by = bound(moved, flops, fp32)
    gbps = moved / (ms * 1e-3) / 1e9
    log(f"kernel decode_attention {str(dtype).split('.')[-1]} S={s} KV={kh} G={g} D={d} T={t} "
        f"{f'window {window} ctx {ctx.tolist()} ' if window else ''}"
        f"{f'ALiBi (without slopes {ms_no_slopes:.4f} ms) ' if alibi else ''}"
        f"live_tokens={live}: max_abs_err {err:.3e} (tol {tol}) ms {ms:.4f} "
        f"plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} (SDPA, mask "
        f"over the whole T) bound_ms {b_ms:.4f} ({b_by}); {moved / 1e6:.2f} "
        f"MB at {gbps:.1f} GB/s, {100 * b_ms / ms:.1f}% of the bound")
    out = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=library_ms, gbps=gbps)
    if alibi:
        out["ms_no_slopes"] = ms_no_slopes
    return out


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
    moved = nbytes(q, ctx, got) + 2 * live * kh * d * q.element_size()
    b_ms, b_by = bound(moved, flops, fp32)
    gbps = moved / (ms * 1e-3) / 1e9
    log(f"kernel ring_decode_attention {str(dtype).split('.')[-1]} S={s} KV={kh} G={g} D={d} rows={rows} "
        f"ring={c} step={step} live_tokens={live}: max_abs_err {err:.3e} (tol "
        f"{tol}) ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{library_ms:.4f} (SDPA over the concatenated sources) bound_ms "
        f"{b_ms:.4f} ({b_by}); {moved / 1e6:.2f} MB at {gbps:.1f} GB/s, "
        f"{100 * b_ms / ms:.1f}% of the bound")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, gbps=gbps)


# --- K1: the GPTQ-INT4 dequant-GEMM ------------------------------------------

# the four products of a Llama-2-7B layer, [in, out], fused as the engine
# serves them (w_qkv = wq|wk|wv, w_gu = w_gate|w_up)
K1_SHAPES = {"w_qkv": (4096, 12288), "wo": (4096, 4096),
             "w_gu": (4096, 22016), "w_down": (11008, 4096)}
# a rank's shards of the same products at world size 2 (the tp phase):
# columns split for w_qkv and w_gu, rows for wo and w_down (5504 rows, 43
# groups of 128)
K1_TP_SHAPES = {"w_qkv/2": (4096, 6144), "wo/2": (2048, 4096),
                "w_gu/2": (4096, 11008), "w_down/2": (5504, 4096)}


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
        wd = int4.dequantize(w, x.dtype)
        return (lambda: torch.matmul(x, wd),
                f"torch.matmul on the weight dequantized to x's dtype "
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
               keep: bool = False, loose: bool = False,
               library: bool = False):
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
    shape. `keep` reuses one weight per shape for the whole process;
    `library` adds the library yardstick to a light check."""
    from text_generation_inference_tpu_torch.ops import linear
    from text_generation_inference_tpu_torch.ops.cuda import int4_matmul as im
    from text_generation_inference_tpu_torch.ops.quant import int4

    dtype = dtype or torch.bfloat16
    in_f, out_f = {**K1_SHAPES, **K1_TP_SHAPES}[key]
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
    if light and not library:
        log(f"{label}: max_abs_err {err:.3e} (tol {tol}) ms {ms:.4f} bound_ms "
            f"{b_ms:.4f} ({b_by}), {100 * b_ms / ms:.1f}% of the bound")
        return dict(err=err, ms=ms, bound_ms=b_ms, bound_by=b_by)
    lib_fn, lib_name = int4_library_call(torch, xk, w)
    lib_err = (lib_fn().float() - want.float()).abs().max().item()
    library_ms = timer(lib_fn)
    if light:
        log(f"{label}: max_abs_err {err:.3e} (tol {tol}) ms {ms:.4f} "
            f"library_ms {library_ms:.4f} ({lib_name}, max abs diff from "
            f"plain {lib_err:.3e}) bound_ms {b_ms:.4f} ({b_by}), "
            f"{100 * b_ms / ms:.1f}% of the bound")
        return dict(err=err, ms=ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=library_ms, library=lib_name)
    plain_ms = timer(ref, iters=3, warmup=1)
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
                   keep: bool = False, shape=None):
    """M1 on a 7B layer's MLP (layer 1 of 2-layer stacks: w_gu [4096,
    22016], w_down [11008, 4096], group 128) at m rows, against its plain
    version; beside it the two-K1 route on the same work (K1 on w_gu, the
    activation, K1 on w_down) and the library yardstick
    (torch._weight_int4pack_mm on each weight, the activation between).
    `keep` reuses one pair of weights for the whole process (a version
    under tools/kernel_ab.py may cache what it derives from a weight by
    its address). `shape` (H, I) replaces the 7B layer's (a rank's
    shard of it in the tp phase)."""
    from text_generation_inference_tpu_torch.ops.cuda import int4_matmul as im
    from text_generation_inference_tpu_torch.ops.cuda import int4_mlp as mlp

    h, inter = shape or M1_SHAPE
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


def first_layers(spec, params, n: int):
    """A decoder's first n layers: (spec, params) over views of the layer
    stacks (GPTQ stacks field by field), no copy."""
    import dataclasses

    from text_generation_inference_tpu_torch.ops.quant.int4 import Int4Weight

    def cut(w):
        if isinstance(w, dict):
            return {k: cut(v) for k, v in w.items()}
        if isinstance(w, Int4Weight):
            return Int4Weight(*(None if f is None else f[:n] for f in w))
        return w[:n]

    return (dataclasses.replace(spec, num_layers=n),
            dict(params, layers=cut(params["layers"])))


def depth(spec) -> int:
    """Layers of a decoder spec, or of a T5 spec's two stacks."""
    return getattr(spec, "num_layers", None) or (spec.num_encoder_layers
                                                 + spec.num_decoder_layers)


def t5_model(torch, name, seed, **overrides):
    """(spec, seeded random params made on the card) at T5_CONFIGS[name]."""
    from text_generation_inference_tpu_torch.models import t5

    spec = t5.T5Spec(**{**T5_CONFIGS[name], **overrides})
    return spec, t5.random_params(spec, DEVICE, DTYPE, seed)


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


def family_spec(name, **overrides):
    """The port's spec for a family's published config (its own spec
    builder), with `overrides` (depth)."""
    import dataclasses

    from text_generation_inference_tpu_torch.models import families

    spec = families.FAMILIES[FAMILY_CONFIGS[name]["model_type"]][0](
        FAMILY_CONFIGS[name])
    return dataclasses.replace(spec, **overrides)


# the families whose checkpoints carry an lm_head bias (their loaders read it)
LM_HEAD_BIAS = ("gptj", "codegen", "phi")


def family_model(torch, name, seed, **overrides):
    """(spec, random params) of a family at its published widths, fused as
    an engine fuses them (`fuse_params`), so that a serving run's engine
    shares the caller's weights instead of holding fused copies beside
    them (the memory checks count the weights once)."""
    from text_generation_inference_tpu_torch.models.fuse import fuse_params

    spec = family_spec(name, **overrides)
    return spec, fuse_params(spec, family_params(
        torch, spec, seed, name in LM_HEAD_BIAS,
        norm_bias=name not in NO_NORM_BIAS))


def family_params(torch, spec, seed=0, lm_head_bias=False, norm_bias=True):
    """Layer-stacked bf16 params of any served family's layout, drawn on
    the card from a seeded generator (the JAX package's init rule: scale
    1/sqrt(fan_in), embeddings 0.02; norm scales 1, biases 0.02): the GLU
    gate, the q/k/v, out and MLP biases, LayerNorm biases (unless
    `norm_bias` is False), learned positions, the embedding LayerNorm,
    lm_head and its bias exactly where the spec (and the family's loader)
    has them. Layer-stacked weights are drawn a layer at a time, so a
    15B model's fp32 draws never hold more than a layer."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 50 + seed)
    L, D, F = spec.num_layers, spec.hidden_size, spec.intermediate_size
    Q, KV = spec.q_size, spec.kv_size

    def draw(shape, scale):
        return (torch.randn(*shape, generator=gen, device=DEVICE) * scale
                ).to(DTYPE)

    def dense(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
        if len(shape) < 3:
            return draw(shape, scale)
        out = torch.empty(*shape, dtype=DTYPE, device=DEVICE)
        for i in range(shape[0]):
            out[i] = draw(shape[1:], scale)
        return out

    def norm(*lead):
        p = {"scale": torch.ones(*lead, D, dtype=DTYPE, device=DEVICE)}
        if spec.norm == "layernorm" and norm_bias:
            p["bias"] = dense(*lead, D, scale=0.02)
        return p

    layers = {"ln1": norm(L), "ln2": norm(L), "wq": dense(L, D, Q),
              "wk": dense(L, D, KV), "wv": dense(L, D, KV),
              "wo": dense(L, Q, D), "w_up": dense(L, D, F),
              "w_down": dense(L, F, D)}
    if spec.activation.endswith("_glu"):
        layers["w_gate"] = dense(L, D, F)
    if spec.qkv_bias:
        layers.update(bq=dense(L, Q, scale=0.02), bk=dense(L, KV, scale=0.02),
                      bv=dense(L, KV, scale=0.02))
    if spec.attn_out_bias:
        layers["bo"] = dense(L, D, scale=0.02)
    if spec.mlp_bias:
        layers.update(b_up=dense(L, F, scale=0.02),
                      b_down=dense(L, D, scale=0.02))
    params = {"embed_tokens": dense(spec.vocab_size, D, scale=0.02),
              "layers": layers, "final_norm": norm()}
    if spec.pos == "learned":
        params["embed_positions"] = dense(
            spec.max_position_embeddings + spec.pos_offset, D, scale=0.02)
    if spec.embed_norm:
        params["embed_ln"] = {"scale": torch.ones(D, dtype=DTYPE,
                                                  device=DEVICE),
                              "bias": dense(D, scale=0.02)}
    if not spec.tie_word_embeddings:
        params["lm_head"] = dense(D, spec.vocab_size)
    if lm_head_bias:
        params["lm_head_bias"] = dense(spec.vocab_size, scale=0.02)
    return params


# family parity holds the kernels' logits to their plain versions' within
# this many bf16 ulps of the case's largest plain |logit| (one ulp of the
# logits' own rounding at their peak; the readings it was set from are in
# PERF.md, section 6)
FAMILY_ULPS = 4


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude x (8 significant bits)."""
    return math.ldexp(1.0, math.frexp(x)[1] - 8)


def logit_tolerance(pairs, ulps):
    """(tol, largest plain |logit|): `ulps` bf16 ulps of that peak, or the
    absolute 0.25 without `ulps`."""
    peak = max(b.abs().max().item() for _, b in pairs)
    return (0.25 if ulps is None else ulps * bf16_ulp(peak)), peak


def describe_error(max_err, tol, peak, ulps):
    """The log's account of a logits comparison, in ulps of the peak."""
    return (f"logits max abs err {max_err:.4f} = "
            f"{max_err / bf16_ulp(peak):.2f} bf16 ulps of the largest "
            f"|logit| {peak:.2f} (tol {tol}"
            f"{f' = {ulps} ulps' if ulps is not None else ''})")


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


def model_parity(torch, spec, params, what="parity", ulps=None):
    """prefill_paged + 4 decode_paged steps with the kernels and with the
    plain attention functions; both fed the same (plain) greedy tokens.
    The logits agree within 0.25, or within `ulps` bf16 ulps of the
    largest plain |logit|."""
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
    pairs = list(zip(logits["kernels"], logits["plain"]))
    tol, peak = logit_tolerance(pairs, ulps)
    max_err, agree, decided = compare_logits(torch, pairs, spec.vocab_size,
                                             tol, what)
    log(f"{what}: prefill (N={n}, bucket {t}, lengths 700/300) + 4 decode "
        f"steps, {spec.num_layers} layers: "
        f"{describe_error(max_err, tol, peak, ulps)}, "
        f"greedy tokens equal {agree}/{decided}")


def slot_parity(torch, spec, params, steps: int = 4, t=1024, max_seq=2048,
                lens=(700, 300), what="slot parity", ulps=None):
    """The slot cache at max_seq 2048: `core.prefill` + `steps` scan-mode
    `core.decode` steps (every layer attends through S1) with the kernels
    and with their plain versions, both fed the same (plain) greedy
    tokens."""
    from text_generation_inference_tpu_torch.models import core
    from text_generation_inference_tpu_torch.models.fuse import fuse_params
    from text_generation_inference_tpu_torch.ops.attention import KERNELS, PLAIN

    params = fuse_params(spec, params)
    n = 2
    lengths = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
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
    # decode rows are slots: slot 1 holds the first prompt
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
    pairs = list(zip(logits["kernels"], logits["plain"]))
    tol, peak = logit_tolerance(pairs, ulps)
    max_err, agree, decided = compare_logits(torch, pairs, spec.vocab_size,
                                             tol, what)
    log(f"{what}: core.prefill (N={n}, bucket {t}, lengths "
        f"{lens[0]}/{lens[1]}) + "
        f"{steps} scan-mode decode steps at max_seq {max_seq} through "
        f"decode_attention, {spec.num_layers} layers: "
        f"{describe_error(max_err, tol, peak, ulps)}, greedy tokens equal "
        f"{agree}/{decided}")


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
    from text_generation_inference_tpu_torch.engine import programs
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
    m1_before = programs.launches(mlp.int4_mlp_s4_stacked)
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
    m1_launches = programs.launches(mlp.int4_mlp_s4_stacked) - m1_before
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


def family_parity(torch, counters):
    """The families beyond Llama (FAMILY_CONFIGS) at their published widths
    and 2 layers, random bf16 weights: `model_parity` (paged prefill at a
    bucket of 1024, 4 per-step paged decode steps), or for a windowed model
    `slot_parity` on a slot cache of 8192 rows with prompts of 4600 and
    1000 tokens (flash prefill and S1 cut at the window), kernels against
    `PLAIN`; then BLOOM-7b1 again on a slot cache of 2048 rows, so that S1
    takes ALiBi slopes. The logits agree within FAMILY_ULPS bf16 ulps of
    the case's largest plain |logit|. An ALiBi family's flash prefill and
    paged decode must have taken its slopes. Returns each case's
    launches."""
    out = {}
    cases = [(name, "slot" if family_spec(name).sliding_window else "paged")
             for name in FAMILY_CONFIGS] + [("bloom", "slot")]
    for i, (name, cache) in enumerate(cases):
        spec, params = family_model(torch, name, i, num_layers=2)
        for c in counters.values():
            c.reset()
        what = (f"family parity [{name}: D={spec.head_dim}, "
                f"H={spec.num_heads}, KV={spec.num_kv_heads}, {spec.pos}"
                f"{', slot cache' if cache == 'slot' else ''}]")
        if spec.sliding_window:
            slot_parity(torch, spec, params, t=5120, max_seq=8192,
                        lens=(4600, 1000), what=what, ulps=FAMILY_ULPS)
        elif cache == "slot":
            slot_parity(torch, spec, params, what=what, ulps=FAMILY_ULPS)
        else:
            model_parity(torch, spec, params, what=what, ulps=FAMILY_ULPS)
        counts = {k: c.read() for k, c in counters.items()}
        out[name if cache == "paged" or spec.sliding_window
            else f"{name}_slot"] = counts
        del params
        if spec.sliding_window:
            need = ["decode_attention", "decode_attention_windowed",
                    "flash_prefill_windowed"]
        elif cache == "slot":
            need = ["decode_attention", "decode_attention_alibi"]
        else:
            need = ["paged_decode_attention"]
            if spec.pos == "alibi":
                need.append("paged_decode_attention_alibi")
        if spec.head_dim % 64 == 0:
            need.append("flash_prefill")
            if spec.pos == "alibi":
                need.append("flash_prefill_alibi")
        missed = [k for k in need if counts[k] <= 0]
        if DEVICE == "cuda" and missed:
            raise AssertionError(f"{what}: {missed} never launched: {counts}")
        log(f"{what} launches {({k: v for k, v in counts.items() if v})}")
    return out


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
# run 7 (Mistral-7B, window 4096, max_seq 8192): four of the eight prompts
# past the window
TRAFFIC_MISTRAL = (([300, 1800, 4500, 6000], 0),
                   ([5000, 2600, 900, 4200], 2)), 32
# S1's windowed check: eight slots at run 7's decode contexts (its prompts
# a few steps in, one slot full); the lower bounds ctx - 4096 are 421,
# 1921, 921, 121, 4, 0, 0 and 4096: inside 256-row splits and 64-key tiles,
# one on their edges, two slots within the window
RUN7_CTX = [4517, 6017, 5017, 4217, 4100, 317, 1817, 8192]
# run 8 (Gemma-7B, paged, max_seq 2048) and run 10 (BLOOM-7b1): two
# streaming requests, then eight prompts near max_seq at once; the default
# max_prefill_batch of 8 would take them in one prefill at the bucket of
# 2048 (Gemma's all-position f32 logits: 16.8 GB), the prefill cap of 2048
# padded tokens takes them one at a time (F4); then eight prompts at the
# bucket of 256, which the cap lets through as one prefill of 8 rows
# (`F4_BATCH_WAVE`)
TRAFFIC_GEMMA = (([300, 900, 1500, 1900], 0), ([1200, 600, 1700], 2),
                 ([1950, 1960, 1970, 1980, 1990, 2000, 2010, 2020], 0),
                 ([200, 207, 214, 221, 228, 235, 242, 249], 0)), 24
# the waves of TRAFFIC_GEMMA whose first request asks for its input
# tokens' details: one near 2048 (a row a dispatch) and one in the batch
# of 8 rows at 256, whose details take all 8 rows' logits
F4_DETAILS_WAVES = (2, 3)
F4_BATCH_WAVE = 3
# run 9 (StarCoder-15.5B, paged, max_seq 8192): 10 requests, prompts of
# 500-7500 tokens, 32 new, two streaming
TRAFFIC_STARCODER = (([500, 1800, 3000, 4500, 6000, 7500], 0),
                     ([7000, 2500, 5200, 900], 2)), 32
# run 11 (mt0-xxl on the seq2seq engine, max_seq 1024, 16 slots): wave A 8
# unary requests, wave B 4 (two streaming, two behind the seq2seq soft
# prompt, one of each), prompts of 50-1000 tokens, 48 new tokens
TRAFFIC_MT0 = (([50, 180, 320, 470, 610, 760, 880, 1000], 0),
               ([300, 900, 640, 80], 2)), 48
PREFIXES_MT0 = ([None] * 8, ["pt-s2s", "pt-s2s", None, None])
S2S_PROMPT = {"encoder": 20, "decoder": 8}          # vectors
# the T5 widths of run 11 and its graphs phase, from the config.json of
# bigscience/mt0-xxl (gated-GELU, untied) and google-t5/t5-large (v1.0:
# ReLU, tied head)
T5_CONFIGS = {
    "mt0-xxl": dict(vocab_size=250112, d_model=4096, d_kv=64, d_ff=10240,
                    num_heads=64, num_encoder_layers=24,
                    num_decoder_layers=24, rel_buckets=32,
                    rel_max_distance=128, gated_act=True,
                    tie_word_embeddings=False),
    "t5-large": dict(vocab_size=32128, d_model=1024, d_kv=64, d_ff=4096,
                     num_heads=16, num_encoder_layers=24,
                     num_decoder_layers=24, rel_buckets=32,
                     rel_max_distance=128, gated_act=False,
                     tie_word_embeddings=True),
}


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


def write_s2s_prefix_store(root: str, hidden: int) -> None:
    """One seeded seq2seq soft prompt, `pt-s2s`: a raw `encoder.pt` and a
    raw `decoder.pt` tensor (S2S_PROMPT vectors each) at embedding scale."""
    import torch

    rng = np.random.default_rng(SEED + 73)
    os.makedirs(os.path.join(root, "pt-s2s"))
    for side, n in S2S_PROMPT.items():
        arr = rng.normal(size=(n, hidden)).astype(np.float32)
        torch.save(torch.from_numpy(arr),
                   os.path.join(root, "pt-s2s", f"{side}.pt"))


def make_requests(lens, streaming_every, seed_base, new, prefixes=None,
                  prompt_cache=None, details=False):
    """The wave's requests: greedy and sampled in turn, every
    `streaming_every`-th streaming; with `details`, the first asks for its
    input tokens' details (logprobs, ranks, top tokens of every prompt
    position: the prefill's largest working set)."""
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
            options=ResponseOptions(input_tokens=details and i == 0,
                                    token_logprobs=details and i == 0,
                                    token_ranks=details and i == 0,
                                    top_n_tokens=5 if details and i == 0
                                    else 0),
            prefix_id=pid,
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
        vocab = batcher.engine.spec.vocab_size
        if not toks or not all(0 <= x < vocab for x in toks):
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


async def grpc_roundtrip(batcher, config, tokenizer, prefix_id=None,
                         model_kind="decoder"):
    """Generate, GenerateStream and ModelInfo (which must report
    `model_kind`) through the port's gRPC server; with `prefix_id`, also a
    Generate behind that soft prompt and one with an unknown prefix id,
    which validation must refuse."""
    import grpc

    from text_generation_inference_tpu_torch.pb import generation_pb2 as pb
    from text_generation_inference_tpu_torch.server.grpc_server import (
        GenerationServicer, make_handler)

    servicer = GenerationServicer(config, tokenizer, batcher,
                                  model_kind=model_kind)
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
            info = await ch.unary_unary(
                "/fmaas.GenerationService/ModelInfo",
                request_serializer=pb.ModelInfoRequest.SerializeToString,
                response_deserializer=pb.ModelInfoResponse.FromString)(
                pb.ModelInfoRequest(model_id="m"))
            kinds = pb.ModelInfoResponse.ModelKind
            want = (kinds.ENCODER_DECODER if model_kind == "encoder_decoder"
                    else kinds.DECODER_ONLY)
            if info.model_kind != want:
                raise AssertionError(f"gRPC ModelInfo: {info}")
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
        log(f"grpc: ModelInfo ({kinds.Name(info.model_kind)}), Generate + "
            f"GenerateStream on 127.0.0.1:{port}: 16 tokens "
            "each, stream text == unary text"
            + (f"; Generate with prefix_id {prefix_id!r} served, an unknown "
               "prefix_id refused (INVALID_ARGUMENT)" if prefix_id else ""))
    finally:
        await server.stop(grace=1.0)
        servicer.async_tokenizer.shutdown()


def make_engine(torch, spec, params, max_seq, overrides, slot=False,
                fused=False, eager=False, num_pages=None, slots=16,
                seq2seq=False, speculative=None, tp=None):
    """A PagedInferenceEngine with `slots` slots and 128-token pages (the
    pool is sized from the card's memory unless `num_pages` is given, so the
    engines of earlier phases are collected first), or with `slot` the slot
    engine (InferenceEngine, the server's PAGED_ATTENTION=0), or with
    `seq2seq` the encoder-decoder engine (Seq2SeqEngine, a T5 spec). With
    `speculative` (the speculator's keyword arguments), the speculative
    engine of either kind (PagedSpeculativeEngine, SpeculativeEngine).
    `fused` builds it under INT4_FUSED_MLP=1, which the engine reads when it
    is built. Its decode dispatches replay captured CUDA graphs, or with
    `eager` run the step functions eagerly (the reference). With `tp` (a
    `parallel.comm.TPGroup`) it holds the rank's shard of the model."""
    import gc

    from text_generation_inference_tpu_torch.config import ServingConfig
    from text_generation_inference_tpu_torch.engine.engine import InferenceEngine
    from text_generation_inference_tpu_torch.engine.paged_engine import (
        PagedInferenceEngine)
    from text_generation_inference_tpu_torch.engine.seq2seq import (
        Seq2SeqEngine)
    from text_generation_inference_tpu_torch.engine.speculative import (
        PagedSpeculativeEngine, SpeculativeEngine)

    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    config = ServingConfig(max_sequence_length=max_seq, max_new_tokens=256,
                           max_batch_slots=slots, kv_page_size=128,
                           **overrides)
    config.validate()
    kw = dict(eager_decode=eager, **(speculative or {}))
    if tp is not None:
        kw["tp"] = tp
    if seq2seq:
        cls = Seq2SeqEngine
    elif slot:
        cls = SpeculativeEngine if speculative is not None else InferenceEngine
    else:
        cls = (PagedSpeculativeEngine if speculative is not None
               else PagedInferenceEngine)
        kw["num_pages"] = num_pages
    before = os.environ.get("INT4_FUSED_MLP")
    os.environ["INT4_FUSED_MLP"] = "1" if fused else "0"
    try:
        engine = cls(spec, params, config,
                     eos_token_id=ByteTokenizer.eos_token_id, device=DEVICE,
                     **kw)
    finally:
        if before is None:
            del os.environ["INT4_FUSED_MLP"]
        else:
            os.environ["INT4_FUSED_MLP"] = before
    if engine.fuse_mlp != fused:
        raise AssertionError("the engine did not take INT4_FUSED_MLP")
    return engine, config


# host-side CUDA runtime calls that enqueue device work (the profiler's
# CPU-side events): a kernel launch, a graph launch, a copy or a fill
HOST_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                 "cudaMemcpyAsync", "cudaMemsetAsync", "cudaLaunchCooperative")


def read_profile(prof):
    """A torch.profiler run's device kernels [(ms, count, name)], the most
    device time first, and the host calls that enqueue device work."""
    from torch.autograd import DeviceType

    kernels, host = [], 0
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) == DeviceType.CUDA:
            # device-side events only: an operator's own "self device time"
            # is the time of the kernels it launched, events of their own
            dev_us = getattr(evt, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(evt, "self_cuda_time_total", 0)
            if dev_us > 0:
                kernels.append((dev_us / 1e3, evt.count, evt.key))
        elif evt.key.startswith(HOST_LAUNCHES):
            host += evt.count
    kernels.sort(reverse=True)
    return kernels, host


def time_decode(torch, engine, label, live=8, calls=16, focus=()):
    """Where a decode dispatch's time goes on `engine` (its decode graphs,
    or its step functions when built with eager_decode): `live` requests
    (512-token prompts), then `calls` dispatches (of decode_chunk steps
    each) timed by the host clock ending in torch.cuda.synchronize() (and
    CUDA events around each dispatch), then `calls` more under
    torch.profiler: the card's busy time and idle share, the host calls
    that enqueue device work a step, the kernels that take the most device
    time, and the share of the kernels whose name holds each string of
    `focus`. Frees every slot again (in place) at the end."""
    from torch.profiler import ProfilerActivity, profile

    from text_generation_inference_tpu_torch.engine.engine import RequestParams

    eager = not engine.programs.capture
    chunk = engine.decode_chunk
    steps = calls * chunk
    rng = np.random.default_rng(SEED + 11)
    slots = [engine.acquire_slot() for _ in range(live)]
    rp = RequestParams(max_new_tokens=(2 * calls + 4) * chunk)
    t0 = time.monotonic()
    for i in range(0, live, 8):
        engine.prefill(slots[i:i + 8],
                       [[int(x) for x in rng.integers(3, 259, 512)]
                        for _ in slots[i:i + 8]], [rp] * len(slots[i:i + 8]))
    sync(torch)
    setup_s = time.monotonic() - t0
    for _ in range(2):
        engine.decode_steps(want_details=False)
    sync(torch)
    spans = []
    t0 = time.monotonic()
    for _ in range(calls):
        if DEVICE == "cuda":
            spans.append([torch.cuda.Event(enable_timing=True)
                          for _ in range(2)])
            spans[-1][0].record()
        engine.decode_steps(want_details=False)
        if spans:
            spans[-1][1].record()
    sync(torch)
    wall_ms = (time.monotonic() - t0) * 1e3 / steps
    span_ms = sum(a.elapsed_time(b) for a, b in spans) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            engine.decode_steps(want_details=False)
        sync(torch)
    kernels, host = read_profile(prof)
    progs = engine.programs
    out = dict(label=label, mode="eager" if eager else "graphs",
               wall_ms=wall_ms, dispatch_span_ms=span_ms,
               host_launches=host / steps, setup_s=setup_s,
               programs=len(progs), capture_s=progs.seconds,
               pool_mb=(progs.pool_bytes() or 0) / 2 ** 20,
               kernels_reported=bool(kernels))
    if kernels:
        busy_ms = sum(k[0] for k in kernels) / steps
        out.update(busy_ms=busy_ms, busy_from="cupti kernels",
                   launches=sum(k[1] for k in kernels) / steps)
    else:
        # CUPTI reported no kernel: the dispatches' CUDA-event spans
        busy_ms = span_ms
        out.update(busy_ms=busy_ms, busy_from="cuda events")
    out["idle"] = max(0.0, 1 - busy_ms / wall_ms)
    log(f"time[{label}, {out['mode']}]: {steps} decode steps ({live} live "
        f"slots, ctx 512..{512 + (2 * calls + 2) * chunk}, chunk {chunk}): wall "
        f"{wall_ms:.3f} ms/step, device busy {busy_ms:.3f} ms/step "
        f"({out['busy_from']}; dispatch span {span_ms:.3f} ms/step), "
        f"{100 * out['idle']:.1f}% idle, {host / steps:.1f} host launches/"
        f"step, {out.get('launches', 0):.1f} device kernel and copy events/"
        f"step; {len(progs)} programs captured in {progs.seconds:.1f}s, "
        f"graph pool {out['pool_mb']:.1f} MiB")
    for ms, count, key in kernels[:8]:
        log(f"time[{label}, {out['mode']}]:   {ms / steps:8.4f} ms/step  "
            f"{count / steps:7.2f} launches/step  {key[:90]}")
    shares = {}
    for name in focus:
        shares[f"{name}_ms"] = sum(k[0] for k in kernels if name in k[2]) / steps
        shares[f"{name}_launches"] = sum(k[1] for k in kernels
                                         if name in k[2]) / steps
    if focus:
        log(f"time[{label}, {out['mode']}]: kernels a step {json.dumps(shares)}")
    out.update(shares)
    engine._clear_slots()
    return out


def graphs(torch, spec, params, label, card, overrides=None, slot=False,
           fused=False, max_seq=2048, live=8, calls=16, focus=(),
           seq2seq=False, timing=True):
    """The graphs phase for one profile config: (1) a graph engine and an
    eager engine built alike (a small pool), driven in lockstep through a
    staggered schedule (`tools.decode_replay.lockstep`): every dispatch's
    outputs and the state and KV equal bit for bit, keys replayed out of
    their capture order; then pipelined dispatch on the graph engine equal
    to sequential dispatch on the eager one; (2) the time of a decode step
    in turns, eager, graphs, graphs, eager (`time_decode`) on the same two
    engines, unless `timing` is off. Returns the second graphs turn's record
    (and both modes' means), or without `timing` what (1) saw."""
    from text_generation_inference_tpu_torch.tools import decode_replay

    t0 = time.monotonic()
    # 128 pages: the lockstep's requests, then `live` timed ones
    engines = {mode: make_engine(torch, spec, params, max_seq,
                                 overrides or {}, slot=slot, fused=fused,
                                 eager=mode == "eager", num_pages=128,
                                 seq2seq=seq2seq)[0]
               for mode in ("graphs", "eager")}
    replayed, eager = engines["graphs"], engines["eager"]
    seen = decode_replay.lockstep(replayed, eager,
                                  vocab=TINYLLAMA["vocab_size"])
    if not seen["out_of_capture_order"]:
        raise AssertionError(f"graphs[{label}]: keys replayed in capture "
                             f"order: {seen}")
    if DEVICE == "cuda" and not all(
            p.graph is not None for p in replayed.programs.programs.values()):
        raise AssertionError(f"graphs[{label}]: a program is not a graph")
    if seq2seq:
        # the keys the schedule never reached too
        seen["every_program"] = decode_replay.every_program(replayed, eager)
    for e in (replayed, eager):
        e._clear_slots()
    tokens = decode_replay.pipelined_matches_sequential(
        replayed, eager, vocab=TINYLLAMA["vocab_size"])
    sync(torch)
    for e in (replayed, eager):
        e._clear_slots()
    log(f"graphs[{label}]: replay == eager bit for bit over "
        f"{seen['dispatches']} staggered dispatches (keys in first-use order "
        f"{seen['keys']}, captured as {seen['capture_order']}"
        + (f"; then each of the {seen['every_program']} programs once"
           if seq2seq else "") + "); pipelined "
        f"dispatch == sequential on {tokens} tokens "
        f"({time.monotonic() - t0:.1f}s)")
    if not timing:
        return dict(seen, keys=len(seen["keys"]), capture_order=None,
                    tokens=tokens)
    turns = [time_decode(torch, engines[mode], label, live, calls, focus)
             for mode in ("eager", "graphs", "graphs", "eager")]
    summary = {}
    for mode, runs in (("eager", turns[0::3]), ("graphs", turns[1:3])):
        summary[mode] = {k: float(np.mean([r[k] for r in runs]))
                         for k in ("wall_ms", "busy_ms", "idle",
                                   "host_launches", "dispatch_span_ms")}
    for turn in turns:
        if turn.get("sum_splits_launches"):
            raise AssertionError(f"a sum_splits kernel ran: {turn}")
    g = turns[2]
    summary["graphs"].update(programs=g["programs"], capture_s=g["capture_s"],
                             pool_mb=g["pool_mb"],
                             kernels_reported=g["kernels_reported"],
                             busy_from=g["busy_from"])
    log(f"graphs[{label}] on {card}: {json.dumps(summary)}")
    return dict(g, summary=summary)


# --- prefill programs ------------------------------------------------------

# (rows, bucket) of the timed prefill dispatches of the prefill phase
PREFILL_SHAPES_TINYLLAMA = ((1, 64), (1, 256), (1, 1024), (8, 256))
PREFILL_SHAPES_7B = ((1, 512), (8, 512))


def time_prefill(torch, engine, label, shapes, counters, calls=6):
    """Where a prefill dispatch's time goes on `engine` (its prefill
    graphs, or its step functions when built with eager_decode), for each
    (rows, bucket) of `shapes` (prompts 3 tokens short of the bucket, freed
    after each call): one call (a key outside the warm grid is captured
    there), then `calls` calls timed by the host clock ending in
    torch.cuda.synchronize(), then `calls` more under torch.profiler: the
    card's busy time and idle share, the host calls that enqueue device
    work a dispatch. The `counters` read over the timed calls (their
    launches a dispatch) go beside."""
    from torch.profiler import ProfilerActivity, profile

    from text_generation_inference_tpu_torch.engine.engine import RequestParams

    mode = "graphs" if engine.programs.capture else "eager"
    rng = np.random.default_rng(SEED + 17)
    out = {}
    for n, bucket in shapes:
        prompts = [[int(x) for x in rng.integers(3, 259, bucket - 3)]
                   for _ in range(n)]
        rps = [RequestParams(max_new_tokens=4)] * n

        def once():
            slots = [engine.acquire_slot() for _ in range(n)]
            engine.prefill(slots, prompts, rps)
            for slot in slots:
                engine.free(slot)

        once()
        sync(torch)
        for c in counters.values():
            c.reset()
        t0 = time.monotonic()
        for _ in range(calls):
            once()
        sync(torch)
        wall_ms = (time.monotonic() - t0) * 1e3 / calls
        counts = {k: c.read() / calls for k, c in counters.items()
                  if c.read()}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                once()
            sync(torch)
        kernels, host = read_profile(prof)
        busy_ms = sum(k[0] for k in kernels) / calls
        rec = dict(wall_ms=wall_ms, busy_ms=busy_ms,
                   idle=max(0.0, 1 - busy_ms / wall_ms),
                   host_launches=host / calls,
                   device_events=sum(k[1] for k in kernels) / calls,
                   kernels_reported=bool(kernels), launches=counts)
        out[f"{n}x{bucket}"] = rec
        log(f"prefill time[{label}, {mode}] {n} x {bucket}: wall "
            f"{wall_ms:.3f} ms, busy {busy_ms:.3f} ms, "
            f"{100 * rec['idle']:.1f}% idle, {rec['host_launches']:.1f} host "
            f"launches, {rec['device_events']:.1f} device events a dispatch; "
            f"kernel launches a dispatch {json.dumps(counts)}")
    return out


def prefill_programs(torch, label, spec, params, card, counters,
                     overrides=None, max_seq=2048, slot=False, seq2seq=False,
                     speculative=None, shapes=(), warm_sizes=None):
    """The prefill programs of one engine config: a graph engine and an
    eager one (`eager_decode=True`) built alike (128 pages), both warmed up
    (`warm_sizes`, default the engine's), the graph engine's warmup timed
    and its graphs' pool printed against the plan's graph-pool term; then
    `tools.decode_replay.prefill_lockstep` (replay == eager bit for bit:
    first tokens, prompt details, state and KV, over several row counts and
    buckets, a details key and a soft-prompt key run twice, keys captured at
    their first use while a request is live); then, for `shapes`, the time
    of a prefill dispatch in turns eager, graphs, graphs, eager
    (`time_prefill`), whose flash prefill and K1 launches must be equal in
    both modes."""
    from text_generation_inference_tpu_torch.tools import decode_replay

    t0 = time.monotonic()
    engines = {mode: make_engine(torch, spec, params, max_seq,
                                 overrides or {}, slot=slot,
                                 eager=mode == "eager", num_pages=128,
                                 seq2seq=seq2seq,
                                 speculative=speculative)[0]
               for mode in ("graphs", "eager")}
    replayed, eager = engines["graphs"], engines["eager"]
    warm = {}
    for mode, engine in engines.items():
        t1 = time.monotonic()
        if warm_sizes is None:
            engine.warmup()
        else:
            engine.warmup(warm_sizes)
        sync(torch)
        warm[mode] = time.monotonic() - t1
    progs = replayed.programs
    pool = progs.pool_bytes() or 0
    # the seq2seq engine makes no memory plan (as the JAX one)
    plan = getattr(replayed, "memory_plan", None)
    term = plan.graph_pool_bytes if plan is not None else None
    seen = decode_replay.prefill_lockstep(replayed, eager,
                                          vocab=TINYLLAMA["vocab_size"])
    sync(torch)
    if DEVICE == "cuda" and not all(p.graph is not None
                                    for p in progs.every_program()):
        raise AssertionError(f"prefill[{label}]: a program is not a graph")
    for e in engines.values():
        e._clear_slots()
    gib = 2 ** 30
    rec = dict(warm_prefill_programs=(len(progs.prefill)
                                      - len(seen["captured"])),
               prefill_capture_s=progs.prefill_seconds,
               warmup_s=warm["graphs"], eager_warmup_s=warm["eager"],
               pool_bytes=pool, graph_pool_term=term,
               pool_after_lockstep=progs.pool_bytes() or 0,
               keys=[str(k) for k in seen["keys"]])
    log(f"prefill[{label}] on {card}: replay == eager bit for bit over "
        f"{seen['dispatches']} prefill dispatches (keys {seen['keys']}; "
        f"captured at first use {seen['captured']}) and the decode dispatch "
        f"after them; warmup made {rec['warm_prefill_programs']} prefill "
        f"programs ({rec['prefill_capture_s']:.1f}s of capture, eager runs "
        f"included) and {len(progs)} decode programs in {warm['graphs']:.1f}s "
        f"(the eager engine's warmup {warm['eager']:.1f}s); graphs' pool "
        f"{pool / gib:.3f} GiB after warmup, "
        f"{rec['pool_after_lockstep'] / gib:.3f} GiB after the lockstep"
        + (f", against the plan's graph-pool term {term / gib:.3f} GiB ("
           f"prefill {plan.activation_bytes / gib:.3f}, decode "
           f"{plan.decode_bytes / gib:.3f})" if plan is not None else "")
        + f" ({time.monotonic() - t0:.1f}s)")
    if shapes:
        turns = [time_prefill(torch, engines[mode], label, shapes, counters)
                 for mode in ("eager", "graphs", "graphs", "eager")]
        summary = {}
        for shape in turns[0]:
            summary[shape] = {}
            for mode, runs in (("eager", turns[0::3]),
                               ("graphs", turns[1:3])):
                summary[shape][mode] = {
                    k: float(np.mean([r[shape][k] for r in runs]))
                    for k in ("wall_ms", "busy_ms", "idle", "host_launches")}
            for key in ("flash_prefill", "int4_matmul"):
                got = {turn[shape]["launches"].get(key, 0) for turn in turns}
                if len(got) != 1:
                    raise AssertionError(
                        f"prefill[{label}] {shape}: {key} launches a "
                        f"dispatch differ between eager and graphs: {got}")
                summary[shape][f"{key}_launches"] = got.pop()
        log(f"prefill[{label}] timing on {card}: {json.dumps(summary)}")
        rec["timing"] = summary
    for e in engines.values():
        e.programs.clear()
    return rec


def prefill_phase(torch, card, counters) -> dict:
    """The prefill programs (`prefill_programs`) at full width: TinyLlama
    bf16 on the paged engine (timed at PREFILL_SHAPES_TINYLLAMA) and on the
    slot engine (scan mode); Llama-2-7B widths with GPTQ-INT4 weights and
    int8 KV on ring chunks of 8 (8 of its 32 layers, max_seq 4096 so that
    8 rows of 512 fit the prefill cap; timed at PREFILL_SHAPES_7B); the
    paged speculative engine at Llama-2-7B widths (8 layers, bf16); the
    seq2seq engine at google-t5/t5-large's widths."""
    out = {}
    spec = llama_spec()
    params = random_params(torch, spec)
    out["tinyllama paged"] = prefill_programs(
        torch, "tinyllama bf16 paged", spec, params, card, counters,
        shapes=PREFILL_SHAPES_TINYLLAMA)
    out["tinyllama slot"] = prefill_programs(
        torch, "tinyllama bf16 slot scan", spec, params, card, counters,
        dict(decode_write_mode="scan"), slot=True)
    del params
    spec7b8 = llama_spec(LLAMA7B, num_layers=8)
    params = random_params(torch, spec7b8, gptq=True)
    out["7b gptq int8kv"] = prefill_programs(
        torch, "7b gptq int8kv", spec7b8, params, card, counters,
        dict(kv_cache_dtype="int8", decode_chunk=8, paged_gather_ctx_max=0),
        max_seq=4096, shapes=PREFILL_SHAPES_7B)
    del params
    from text_generation_inference_tpu_torch.models.fuse import fuse_params

    params = fuse_params(spec7b8, random_params(torch, spec7b8))
    out["7b speculative paged"] = prefill_programs(
        torch, "7b speculative paged", spec7b8, params, card, counters,
        speculative=dict(n_predict=SPEC_N_PREDICT, max_spec_batch=3),
        warm_sizes=(1,))
    del params
    spec_t5, params_t5 = t5_model(torch, "t5-large", 12)
    out["t5-large seq2seq"] = prefill_programs(
        torch, "t5-large seq2seq", spec_t5, params_t5, card, counters,
        max_seq=1024, seq2seq=True)
    del params_t5
    return out


def serve_run(torch, spec, params, name, overrides, counters, with_grpc,
              traffic=TRAFFIC_TINYLLAMA, max_seq=2048, slot=False,
              fused=False, prefixes=None, slots=16, details_waves=(),
              memory_check=False, seq2seq=False):
    """One serving run through the Batcher (+ gRPC). With `prefixes` (a
    prefix id or None per request, wave by wave), the config's
    prefix_store_path is served as the server serves it, and an unknown
    prefix id must fail validation. With `details_waves`, those waves'
    first requests ask for their input tokens' details. Every prefill
    dispatch must hold at most `max_prefill_tokens` padded tokens (rows x
    bucket). Every prefill and every decode dispatch must be a replay of a
    captured graph. With `memory_check` (F4), the graphs' pool (prefill and
    decode programs) must stay within the plan's one graph-pool term
    (`MemoryPlan.graph_pool_bytes`), and so must the run's peak of
    allocated memory less the params and the KV pool; the prefill cap must
    have refused a request, and wave `F4_BATCH_WAVE` must have prefilled
    as one dispatch of `max_prefill_batch` rows."""
    from text_generation_inference_tpu_torch.engine.memory import tree_bytes
    from text_generation_inference_tpu_torch.utils import metrics
    from text_generation_inference_tpu_torch.scheduler.batcher import Batcher
    from text_generation_inference_tpu_torch.server.main import (
        build_prompt_cache)
    from text_generation_inference_tpu_torch.server.validation import (
        Validation, ValidationError)

    engine, config = make_engine(torch, spec, params, max_seq, overrides,
                                 slot=slot, fused=fused, slots=slots,
                                 seq2seq=seq2seq)
    t0 = time.monotonic()
    engine.warmup(batch_sizes=(1,))
    warmup_s = time.monotonic() - t0
    progs = engine.programs
    captured = (len(progs), progs.seconds, (progs.pool_bytes() or 0) / 2 ** 20,
                len(progs.prefill), progs.prefill_seconds)
    # every decode dispatch of the run must be a replay of a captured graph
    begin = engine.decode_steps_begin

    def counted_begin(*args, **kw):
        counted_begin.calls += 1
        return begin(*args, **kw)

    counted_begin.calls = 0
    engine.decode_steps_begin = counted_begin
    # the rows of every prefill dispatch, and the run's peak of allocated
    # device memory
    prefill = engine.prefill
    prefill_rows, prefill_shapes = [], []

    def counted_prefill(slots, token_ids, *args, **kw):
        prefill_rows.append(len(slots))
        prefill_shapes.append((len(slots),
                               config.bucket_for(max(map(len, token_ids)))))
        return prefill(slots, token_ids, *args, **kw)

    engine.prefill = counted_prefill
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
    replays0 = sum(p.replays for p in progs.programs.values())
    prefill_replays0 = sum(p.replays for p in progs.prefill.values())
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
                                     prompt_cache,
                                     details=i in details_waves)
                ttft += await run_wave(batcher, wave)
                reqs += wave
            sync(torch)
            wall = time.monotonic() - t0
            if with_grpc:
                pid = next((p for wave in prefixes or () for p in wave if p),
                           None)
                await grpc_roundtrip(batcher, config, tokenizer, pid,
                                     "encoder_decoder" if seq2seq
                                     else "decoder")
            return reqs, wall, ttft
        finally:
            await batcher.stop()

    for c in counters.values():
        c.reset()
    refused = ("tgi_prefill_weight_limit_exceeded", ())
    refused0 = metrics._counters[refused]
    reqs, wall, ttft = asyncio.run(drive())
    counts = {k: c.read() for k, c in counters.items()}
    counts["max_prefill_rows"] = max(prefill_rows)
    counts["prefill_cap_refusals"] = metrics._counters[refused] - refused0
    over = [sh for sh in prefill_shapes
            if sh[0] * sh[1] > config.max_prefill_tokens]
    if over:
        raise AssertionError(f"serve[{name}]: prefill dispatches {over} "
                             f"hold more than {config.max_prefill_tokens} "
                             "padded tokens")
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    if memory_check:
        plan = engine.memory_plan
        params_b, pool_b = tree_bytes(engine.model_params), kv_bytes(engine)
        graphs_b = progs.pool_bytes() or 0
        transient = peak - params_b - pool_b - graphs_b
        term = plan.graph_pool_bytes
        gib = 2 ** 30
        log(f"serve[{name}] memory (F4): plan {plan.describe()}; peak "
            f"allocated {peak / gib:.2f} GiB = params {params_b / gib:.2f} + "
            f"pool {pool_b / gib:.2f} + graphs' pool {graphs_b / gib:.3f} + "
            f"transient {transient / gib:.2f} GiB (of it, allocated before "
            f"the traffic: {(resident - params_b - pool_b - graphs_b) / gib:.3f}"
            f" GiB) against the plan's graph-pool term {term / gib:.3f} GiB "
            f"(prefill {plan.activation_bytes / gib:.3f}, decode "
            f"{plan.decode_bytes / gib:.3f}); {len(progs.prefill)} prefill "
            f"programs; the prefill cap ({config.max_prefill_tokens} tokens) "
            f"refused {counts['prefill_cap_refusals']:.0f} times; prefill "
            f"(rows, bucket) {sorted(set(prefill_shapes))}")
        if DEVICE == "cuda" and (graphs_b > term
                                 or graphs_b + transient > term):
            raise AssertionError(f"serve[{name}]: the graphs' pool "
                                 f"{graphs_b} and transient {transient} "
                                 f"bytes exceed the plan's graph-pool term "
                                 f"{term}")
        if counts["prefill_cap_refusals"] <= 0:
            raise AssertionError(f"serve[{name}]: the prefill cap never "
                                 "refused a request")
        batch = (config.max_prefill_batch,
                 config.bucket_for(max(waves[F4_BATCH_WAVE][0])))
        if batch not in prefill_shapes:
            raise AssertionError(f"serve[{name}]: wave {F4_BATCH_WAVE} never "
                                 f"prefilled as one dispatch {batch}: "
                                 f"{sorted(set(prefill_shapes))}")
        counts["transient_bytes"] = transient
        counts["graph_pool_bytes"] = graphs_b
        counts["graph_pool_term"] = term
    replays = sum(p.replays for p in progs.programs.values()) - replays0
    prefill_replays = (sum(p.replays for p in progs.prefill.values())
                       - prefill_replays0)
    if DEVICE == "cuda" and (
            replays != counted_begin.calls or counted_begin.calls == 0
            or prefill_replays != len(prefill_rows)
            or not all(p.graph is not None for p in progs.every_program())):
        raise AssertionError(
            f"serve[{name}]: {counted_begin.calls} decode dispatches, "
            f"{replays} graph replays; {len(prefill_rows)} prefill "
            f"dispatches, {prefill_replays} prefill replays")
    tokens = sum(r.generated_count for r in reqs)
    n_pre = sum(1 for r in reqs if r.prefix_id)
    log(f"serve[{name}] {type(engine).__name__} {overrides}"
        f"{', INT4_FUSED_MLP=1' if fused else ''}, "
        f"{depth(spec)} layers at {spec.hidden_size} wide: {len(reqs)} "
        f"requests ({n_pre} behind a soft prompt), prompts "
        f"{min(r.input_length for r in reqs)}..{max(r.input_length for r in reqs)}"
        f" tokens, {tokens} tokens generated in {wall:.2f}s wall "
        f"({tokens / wall:.1f} tok/s), streaming TTFT mean "
        f"{np.mean(ttft) * 1e3:.1f} ms max {np.max(ttft) * 1e3:.1f} ms; "
        f"{counted_begin.calls} decode dispatches and {len(prefill_rows)} "
        f"prefill dispatches, each a graph replay ({captured[0]} decode "
        f"programs captured at warmup in {captured[1]:.1f}s and "
        f"{captured[3]} prefill programs in {captured[4]:.1f}s of "
        f"{warmup_s:.1f}s, graph pool {captured[2]:.1f} MiB; "
        f"{len(progs)} decode and {len(progs.prefill)} prefill programs at "
        f"the end); prefill batches of "
        f"{prefill_rows} rows; peak allocated {peak / 2 ** 30:.2f} GiB of "
        f"{torch.cuda.mem_get_info()[1] / 2 ** 30 if DEVICE == 'cuda' else 0:.2f}"
        f" GiB, KV {kv_bytes(engine) / 2 ** 30:.2f} GiB of it; launches "
        f"{counts}")
    return counts


# --- speculative decoding ---------------------------------------------------

SPEC_N_PREDICT = 3
# run 12 (Llama-2-7B, paged, SPECULATOR=1, SPECULATOR_MAX_BATCH_SIZE=8):
# wave A 6 greedy requests (every step speculates), then wave B 8 more while
# A decodes (14 active: the gate falls back until 8 or fewer are left), a
# seeded sampling row and a repetition-penalty row among them, two
# streaming
TRAFFIC_SPEC = ([100, 250, 420, 600, 900, 1300],
                [150, 500, 820, 300, 700, 1100, 220, 640]), 32
SPEC_KINDS = (("greedy",) * 6,
              ("greedy", "sampled", "greedy", "penalty", "greedy", "greedy",
               "greedy", "greedy"))
SPEC_MAX_BATCH = 8


def verify_parity(torch, spec, params, what, slot=False, counters=None,
                  s=16, t=1024, max_seq=2048, chunk=SPEC_N_PREDICT + 1):
    """Verification against plain decode on the same tokens: `s` prompts
    (lengths 100..t-9 from the seed) prefilled into a paged pool (with
    `slot`, a slot cache of max_seq rows); one copy of it takes `chunk`
    plain decode steps (`decode_paged`: the paged kernel; with `slot`,
    scan-mode `core.decode`: S1), each fed the previous step's greedy
    token, the other one `verify_chunk_paged` over every page
    (`verify_chunk`) on the same `chunk` tokens. The verify logits at
    position j must agree with decode step j's within FAMILY_ULPS bf16 ulps
    of the largest |logit|. The paged verify products take s x chunk rows
    (`prepare_params`: K1's decode route at 64 rows for a GPTQ model), the
    decode steps s rows. With `counters`, the verify call's launches are
    counted and returned."""
    from text_generation_inference_tpu_torch.engine.paged_cache import PagedKVCache
    from text_generation_inference_tpu_torch.models import core, paged_core
    from text_generation_inference_tpu_torch.models.fuse import fuse_params
    from text_generation_inference_tpu_torch.ops import linear as linops

    params = fuse_params(spec, params)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 41)
    lengths = torch.randint(100, t - 8, (s,), generator=gen, device=DEVICE,
                            dtype=torch.int32)
    ids = torch.randint(3, spec.vocab_size, (s, t), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    slots = torch.arange(s, dtype=torch.int32, device=DEVICE)
    page, max_pages = 128, max_seq // 128
    if slot:
        cache = core.KVCache.create(spec, s, max_seq, DTYPE, DEVICE)
        lg, _ = core.prefill(spec, params, ids, lengths, slots, cache)
    else:
        cache = PagedKVCache.create(spec, s * max_pages, page, s, max_pages,
                                    DTYPE, DEVICE)
        cache.block_table.copy_(torch.arange(
            s * max_pages, dtype=torch.int32, device=DEVICE).reshape(s, -1))
        lg, _ = paged_core.prefill_paged(spec, params, ids, lengths, slots,
                                         cache, page)
    toks = [lg[torch.arange(s), lengths.long() - 1].argmax(-1).to(torch.int32)]
    del lg
    copy = type(cache)(*(None if x is None else x.clone() for x in cache))
    step_params = linops.prepare_params(params, rows=s)
    pos, dec = lengths.clone(), []
    for _ in range(chunk):
        if slot:
            lg, _ = core.decode(spec, step_params, toks[-1], pos, cache,
                                pos + 1, write_mode="scan")
        else:
            lg, _ = paged_core.decode_paged(spec, step_params, toks[-1], pos,
                                            cache, pos + 1, page)
        dec.append(lg)
        toks.append(lg.argmax(-1).to(torch.int32))
        pos = pos + 1
    chunk_ids = torch.stack(toks[:chunk], dim=1)
    for c in (counters or {}).values():
        c.reset()
    if slot:
        vl, _, _ = core.verify_chunk(spec, params, chunk_ids, lengths, copy)
    else:
        vl, _, _ = paged_core.verify_chunk_paged(
            spec, linops.prepare_params(params, rows=s * chunk), chunk_ids,
            lengths, copy, page, torch.ones(s, dtype=torch.bool,
                                            device=DEVICE),
            max_seq, live_pages=max_pages)
    counts = {k: c.read() for k, c in (counters or {}).items()}
    sync(torch)
    pairs = [(vl[:, j], dec[j]) for j in range(chunk)]
    tol, peak = logit_tolerance(pairs, FAMILY_ULPS)
    max_err, agree, decided = compare_logits(torch, pairs, spec.vocab_size,
                                             tol, what)
    log(f"{what}: {s} slots, contexts {int(lengths.min())}.."
        f"{int(lengths.max())}, a chunk of {chunk} teacher-forced tokens, "
        f"{spec.num_layers} layers at {spec.hidden_size} wide: verify vs "
        f"{chunk} plain decode steps {describe_error(max_err, tol, peak, FAMILY_ULPS)}"
        f", greedy tokens equal {agree}/{decided}"
        + (f"; launches in the verify call {json.dumps({k: v for k, v in counts.items() if v})}"
           if counters else ""))
    return counts


def fixed_speculator(torch, spec, token: int, inner: int = 64):
    """A speculator that always drafts `token` (LayerNorm scale 0, bias 2:
    every state is gelu(2); only the head's `token` column is set)."""
    from text_generation_inference_tpu_torch.models.speculator import (
        SpeculatorSpec)

    n, v = SPEC_N_PREDICT, spec.vocab_size
    zeros = lambda *shape: torch.zeros(*shape, dtype=DTYPE, device=DEVICE)
    head = zeros(inner, v)
    head[:, token] = 1.0
    return SpeculatorSpec(v, spec.hidden_size, inner, n), {
        "emb": [zeros(v, inner)] * n,
        "w_state": [zeros(spec.hidden_size if i == 0 else inner, inner)
                    for i in range(n)],
        "ln_scale": [zeros(inner)] * n, "ln_bias": [zeros(inner) + 2.0] * n,
        "head": [head] * n}


def first_differences(plain, spec_toks, top2, what):
    """Speculative against plain token streams up to each one's first
    difference: a difference is allowed only where the plain engine's
    top-2 margin at that position is within FAMILY_ULPS bf16 ulps of its
    top score. Logs each difference's position and margin; returns how
    many streams differ."""
    diffs = []
    for r, (a, b, scores) in enumerate(zip(plain, spec_toks, top2)):
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            continue
        top1, second = scores[i]
        margin, bound = top1 - second, FAMILY_ULPS * bf16_ulp(abs(top1))
        if margin > bound:
            raise AssertionError(f"{what}: request {r} differs at token {i} "
                                 f"where the plain top-2 margin {margin} "
                                 f"exceeds {bound}")
        diffs.append(dict(request=r, token=i, margin=margin, bound=bound))
    log(f"{what}: {len(plain)} streams of {len(plain[0])} tokens, "
        f"{len(plain) - len(diffs)} equal throughout; first differences "
        f"(each within the plain top-2 margin bound): {json.dumps(diffs)}")
    return len(diffs)


def spec_exactness(torch):
    """fp32 at TinyLlama widths, 4 layers: on both engines, speculative
    tokens equal plain tokens exactly (8 greedy requests, one under a
    repetition penalty), with a speculator that drafts the token the plain
    streams repeat most, so drafts are accepted."""
    global DTYPE
    from text_generation_inference_tpu_torch.engine.engine import RequestParams
    from text_generation_inference_tpu_torch.tools.spec_measure import (
        decode_all)

    saved, DTYPE = DTYPE, torch.float32
    try:
        spec = llama_spec(TINYLLAMA, num_layers=4)
        params = random_params(torch, spec)
        rng = np.random.default_rng(SEED + 43)
        prompts = [[int(x) for x in rng.integers(3, 259, n)]
                   for n in (100, 230, 370, 480, 610, 750, 880, 960)]
        new = 48
        rps = [RequestParams(max_new_tokens=new + 8,
                             repetition_penalty=1.3 if i == 3 else 1.0)
               for i in range(len(prompts))]
        out = {}
        for slot in (False, True):
            kind = "slot" if slot else "paged"
            plain, _ = make_engine(torch, spec, params, 2048, {}, slot=slot,
                                   num_pages=128)
            want = decode_all(plain, prompts, new, rps=rps)[0]
            del plain
            vals, counts = np.unique(np.concatenate(want), return_counts=True)
            sspec, sparams = fixed_speculator(torch, spec,
                                              int(vals[np.argmax(counts)]))
            eng, _ = make_engine(torch, spec, params, 2048, {}, slot=slot,
                                 num_pages=128,
                                 speculative=dict(speculator_spec=sspec,
                                                  speculator_params=sparams))
            got = decode_all(eng, prompts, new, rps=rps)[0]
            if got != want:
                raise AssertionError(f"fp32 speculative tokens differ from "
                                     f"plain on the {kind} engine")
            out[kind] = dict(spec_steps=eng.spec_steps,
                             histogram=eng.accepted_histogram.tolist())
            del eng
    finally:
        DTYPE = saved
    log(f"spec exactness (fp32, TinyLlama widths, 4 layers, 8 requests of "
        f"{new} tokens, one under a repetition penalty): speculative tokens "
        f"== plain tokens on both engines; {json.dumps(out)}")
    return out


def spec_graphs(torch, spec, params, label, slot=False, overrides=None):
    """Replay == eager bit for bit for the speculative engines' programs:
    a graph engine and an eager one built alike go through
    `tools.decode_replay.spec_lockstep` (greedy, penalty and seeded rows;
    the paged engine's gate at 3 rows, so that plain steps are taken too),
    then every program of the grid once on both
    (`decode_replay.every_program`): the verify keys the schedule never
    reached included."""
    from text_generation_inference_tpu_torch.tools import decode_replay

    t0 = time.monotonic()
    extra = {} if slot else dict(max_spec_batch=3)
    engines = {mode: make_engine(torch, spec, params, 2048, overrides or {},
                                 slot=slot, eager=mode == "eager",
                                 num_pages=128, speculative=extra)[0]
               for mode in ("graphs", "eager")}
    replayed, eager = engines["graphs"], engines["eager"]
    seen = decode_replay.spec_lockstep(replayed, eager,
                                       vocab=TINYLLAMA["vocab_size"])
    if DEVICE == "cuda" and not all(
            p.graph is not None for p in replayed.programs.programs.values()):
        raise AssertionError(f"spec graphs[{label}]: a program is not a graph")
    seen["every_program"] = decode_replay.every_program(replayed, eager)
    verify_keys = [k for k in replayed.programs.programs if k[0] == "verify"]
    for e in (replayed, eager):
        e._clear_slots()
    if not slot and not (seen["spec_steps"] and seen["fallback_steps"]):
        raise AssertionError(f"spec graphs[{label}]: {seen}")
    log(f"spec graphs[{label}]: replay == eager bit for bit over "
        f"{seen['dispatches']} dispatches ({seen['spec_steps']} speculative, "
        f"{seen['fallback_steps']} plain; keys in first-use order "
        f"{seen['keys']}), then each of the {seen['every_program']} programs "
        f"once, the {len(verify_keys)} verify programs {verify_keys} among "
        f"them ({time.monotonic() - t0:.1f}s)")
    return seen


def spec_requests(lens, kinds, streaming_every, new, seed_base):
    """Run 12's requests: greedy, seeded sampling or repetition-penalty
    rows as `kinds` says, every `streaming_every`-th streaming."""
    from text_generation_inference_tpu_torch.engine.engine import RequestParams
    from text_generation_inference_tpu_torch.scheduler.request import (
        GenRequest, ResponseOptions, StoppingCriteria)

    rng = np.random.default_rng(SEED + seed_base)
    reqs = []
    for i, (n, kind) in enumerate(zip(lens, kinds)):
        rp = RequestParams(max_new_tokens=new)
        if kind == "sampled":
            rp = RequestParams(max_new_tokens=new, temperature=0.8, top_k=50,
                               seed=seed_base + i)
        elif kind == "penalty":
            rp = RequestParams(max_new_tokens=new, repetition_penalty=1.3)
        reqs.append(GenRequest(
            input_text="", input_ids=[int(x) for x in
                                      rng.integers(3, 259, size=n)],
            params=rp, stopping=StoppingCriteria(max_new_tokens=new),
            options=ResponseOptions(),
            streaming=bool(streaming_every) and i % streaming_every == 0))
    return reqs


def serve_spec(torch, spec, params, counters, with_grpc, card):
    """Serving run 12: Llama-2-7B on the paged speculative engine behind the
    Batcher (SPECULATOR=1: a random-init speculator, n_predict 3, inner
    dim 2048; SPECULATOR_MAX_BATCH_SIZE=8), 16 slots, max_seq 2048,
    TRAFFIC_SPEC (+ gRPC). Both the speculative and the plain (gated)
    steps must run, every dispatch a graph replay; flash prefill and the
    paged kernel must launch; the peak of allocated memory less params,
    pool must stay within the plan (the graph-pool term +
    speculative_bytes). Then the wall and busy ms of a verify step against
    a plain step at 8 live (`time_decode`, the gate closed for the plain
    one)."""
    from text_generation_inference_tpu_torch.engine.memory import tree_bytes
    from text_generation_inference_tpu_torch.scheduler.batcher import Batcher

    os.environ["SPECULATOR_MAX_BATCH_SIZE"] = str(SPEC_MAX_BATCH)
    try:
        engine, config = make_engine(
            torch, spec, params, 2048, {},
            speculative=dict(n_predict=SPEC_N_PREDICT))
    finally:
        del os.environ["SPECULATOR_MAX_BATCH_SIZE"]
    if (engine.max_spec_batch, engine.sspec.inner_dim) != (
            SPEC_MAX_BATCH, spec.hidden_size // 2):
        raise AssertionError(f"run 12's engine: {engine.sspec}")
    t0 = time.monotonic()
    engine.warmup(batch_sizes=(1,))
    warmup_s = time.monotonic() - t0
    progs = engine.programs
    replays0 = sum(p.replays for p in progs.programs.values())
    resident = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
    tokenizer = ByteTokenizer()
    (lens_a, lens_b), new = TRAFFIC_SPEC

    async def drive():
        batcher = Batcher(engine, tokenizer, config)
        batcher.start()
        try:
            t0 = time.monotonic()
            wave_a = spec_requests(lens_a, SPEC_KINDS[0], 0, new, 100)
            wave_b = spec_requests(lens_b, SPEC_KINDS[1], 4, new, 200)
            batcher.submit_all(wave_a)
            # wave B arrives while wave A decodes
            while sum(r.generated_count for r in wave_a) < 4 * len(wave_a):
                if time.monotonic() - t0 > 300:
                    raise AssertionError("run 12: wave A does not decode")
                await asyncio.sleep(0.005)
            ttft = await run_wave(batcher, wave_b)
            for r in wave_a:
                await r.result_future
                if r.generated_count != new:
                    raise AssertionError(f"run 12: request {r.id} ended "
                                         f"{r.stop_reason!r}: {r.error}")
            sync(torch)
            wall = time.monotonic() - t0
            if with_grpc:
                await grpc_roundtrip(batcher, config, tokenizer)
            return wave_a + wave_b, wall, ttft
        finally:
            await batcher.stop()

    for c in counters.values():
        c.reset()
    engine.spec_steps = engine.fallback_steps = 0
    engine.accepted_histogram[:] = 0
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reqs, wall, ttft = asyncio.run(drive())
    counts = {k: c.read() for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    replays = sum(p.replays for p in progs.programs.values()) - replays0
    steps = engine.spec_steps + engine.fallback_steps
    plan = engine.memory_plan
    params_b, pool_b = tree_bytes(engine.model_params), kv_bytes(engine)
    graphs_b = progs.pool_bytes() or 0
    transient = peak - params_b - pool_b - graphs_b
    planned = plan.graph_pool_bytes + plan.speculative_bytes
    gib = 2 ** 30
    tokens = sum(r.generated_count for r in reqs)
    log(f"serve[7b-speculative] {type(engine).__name__} SPECULATOR=1 "
        f"(n_predict {engine.sspec.n_predict}, inner_dim "
        f"{engine.sspec.inner_dim}), SPECULATOR_MAX_BATCH_SIZE="
        f"{engine.max_spec_batch}, {spec.num_layers} layers at "
        f"{spec.hidden_size} wide on {card}: {len(reqs)} requests, "
        f"{tokens} tokens in {wall:.2f}s wall ({tokens / wall:.1f} tok/s), "
        f"streaming TTFT mean {np.mean(ttft) * 1e3:.1f} ms; "
        f"{engine.spec_steps} speculative steps, {engine.fallback_steps} "
        f"plain (gated) steps, each a graph replay ({len(progs)} programs "
        f"captured at warmup, {warmup_s:.1f}s with the prefill shapes); "
        f"accepted histogram (by n_emit) "
        f"{engine.accepted_histogram.tolist()}; memory: plan "
        f"{plan.describe()}; peak allocated {peak / gib:.2f} GiB = params "
        f"{params_b / gib:.2f} + pool {pool_b / gib:.2f} + graphs' pool "
        f"{graphs_b / gib:.3f} + transient {transient / gib:.3f} GiB (of it, "
        f"allocated before the traffic: "
        f"{(resident - params_b - pool_b - graphs_b) / gib:.3f} GiB) against "
        f"the plan's graph pool + speculative {planned / gib:.3f} GiB "
        f"(speculative {plan.speculative_bytes / gib:.3f}); launches {counts}")
    if DEVICE == "cuda" and (replays != steps or not all(
            p.graph is not None for p in progs.programs.values())):
        raise AssertionError(f"run 12: {steps} decode dispatches, {replays} "
                             "graph replays")
    if not (engine.spec_steps and engine.fallback_steps):
        raise AssertionError(f"run 12: {engine.spec_steps} speculative, "
                             f"{engine.fallback_steps} plain steps")
    for key in ("flash_prefill", "paged_decode_attention"):
        if counts[key] <= 0:
            raise AssertionError(f"{key} never ran in serving run 12: {counts}")
    if DEVICE == "cuda" and graphs_b + transient > planned:
        raise AssertionError(f"run 12: the graphs' pool {graphs_b} and "
                             f"transient {transient} bytes exceed the "
                             f"plan's {planned}")
    turns = {}
    for label in ("verify", "plain"):
        engine.max_spec_batch = SPEC_MAX_BATCH if label == "verify" else 0
        turns[label] = time_decode(torch, engine, f"7b {label} step", live=8,
                                   calls=8, focus=("split_kernel",))
    engine.max_spec_batch = SPEC_MAX_BATCH
    counts.update(spec_steps=engine.spec_steps,
                  fallback_steps=engine.fallback_steps, tok_s=tokens / wall,
                  transient_bytes=transient, planned_bytes=planned)
    log(f"run 12 step at 8 live on {card}: verify "
        f"{json.dumps({k: turns['verify'][k] for k in ('wall_ms', 'busy_ms', 'idle')})}"
        f", plain {json.dumps({k: turns['plain'][k] for k in ('wall_ms', 'busy_ms', 'idle')})}")
    return counts, turns


def spec_measurement(torch):
    """The distilled measurement (`tools.spec_measure`) at TinyLlama's full
    width and depth, bf16, distilling for 30 s; then the bf16 streams of
    both engines against plain up to their first differences (the paged
    ones from the measurement, the slot engine's with the same distilled
    speculator)."""
    from text_generation_inference_tpu_torch.engine.engine import RequestParams
    from text_generation_inference_tpu_torch.tools import spec_measure

    spec = llama_spec()
    params = spec_measure.predictable_params(spec, DEVICE, DTYPE, SEED)
    report = spec_measure.measure(spec, params, DEVICE, seconds=30.0, log=log)
    streams = report.pop("streams")
    sspec, sparams = report.pop("speculator")
    log(f"spec_measure: {json.dumps(report)}")
    if report["acceptance_rate"] <= 0:
        raise AssertionError("the distilled speculator accepted nothing")
    diffs = {"paged": first_differences(
        streams["plain"], streams["speculative"], streams["plain_top2"],
        "bf16 streams, paged")}
    prompts = streams["prompts"]
    n = len(streams["plain"][0])
    rps = [RequestParams(max_new_tokens=n + 8)] * len(prompts)
    plain, _ = make_engine(torch, spec, params, 512, {}, slot=True,
                           slots=len(prompts))
    want, _, _, top2 = spec_measure.decode_all(plain, prompts, n,
                                               want_details=True, rps=rps)
    del plain
    eng, _ = make_engine(torch, spec, params, 512, {}, slot=True,
                         slots=len(prompts),
                         speculative=dict(speculator_spec=sspec,
                                          speculator_params=sparams))
    got = spec_measure.decode_all(eng, prompts, n, rps=rps)[0]
    diffs["slot"] = first_differences(want, got, top2, "bf16 streams, slot")
    return report, diffs


# --- int8 weights, the generate.v1 internal API, the GPTQ solve -------------

# planted residual-stream outliers at 7B width (as the JAX package's
# tests/test_quant_quality.py plants feature 13 in the embedding): +30 in
# every token's embedding, which RMSNorm leaves near 37 against ~0.03 for
# the other features
HOT_FEATURES = (13, 1000, 2777)
# the linears that read the normed residual stream: their crossers of the
# threshold are exactly the planted features
RESIDUAL_READERS = ("wq", "wk", "wv", "w_gate", "w_up")


def int8_parity(torch, counters):
    """int8 weights at Llama-2-7B widths, 4 layers, quantized on the card
    (`quantize_layer_params`) from seeded bf16 params: (1) the plain int8
    model through the kernels against the same model through the plain
    versions (`model_parity`, in bf16 ulps); (2) a copy with planted
    activation outliers: calibration on the card (`collect_linear_input_
    absmax`, its 128-token prompts through flash prefill) must find exactly
    the planted features in every residual-stream reader, and KL(bf16 ||
    int8-outliers) must be below KL(bf16 || int8) over a seeded corpus."""
    from text_generation_inference_tpu_torch.ops.cuda import flash_prefill as fp
    from text_generation_inference_tpu_torch.ops.quant import calibrate, quality
    from text_generation_inference_tpu_torch.ops.quant.int8 import (
        Int8OutlierWeight, Int8Weight, quantize_layer_params)

    spec = llama_spec(LLAMA7B, num_layers=4)
    params = random_params(torch, spec)
    sync(torch)
    t0 = time.monotonic()
    q8 = quantize_layer_params(params)
    sync(torch)
    quant_s = time.monotonic() - t0
    if not all(isinstance(q8["layers"][k], Int8Weight)
               for k in ("wq", "wo", "w_gate", "w_down")):
        raise AssertionError("int8 parity: a layer linear was not quantized")
    log(f"int8 parity: quantize_layer_params on the card, {spec.num_layers} "
        f"layers at 7B widths in {quant_s:.2f}s")
    model_parity(torch, spec, q8, "int8 parity", ulps=FAMILY_ULPS)
    del q8

    emb = params["embed_tokens"].clone()
    emb[:, list(HOT_FEATURES)] += 30.0
    planted = dict(params, embed_tokens=emb)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    calib = torch.randint(3, spec.vocab_size, (4, 128), generator=gen,
                          device=DEVICE, dtype=torch.int32)
    before = fp.flash_prefill.launches
    stats = calibrate.collect_linear_input_absmax(spec, planted, calib)
    flash = fp.flash_prefill.launches - before
    if DEVICE == "cuda" and flash != spec.num_layers:
        raise AssertionError(f"calibration: {flash} flash prefill launches, "
                             f"not one a layer")
    hot = sorted(HOT_FEATURES)
    for k in RESIDUAL_READERS:
        for li in range(spec.num_layers):
            crossers = np.flatnonzero(stats[k][li] > 6.0).tolist()
            if crossers != hot:
                raise AssertionError(f"calibration {k} layer {li}: features "
                                     f"past the threshold {crossers}, "
                                     f"planted {hot}")
        picked = np.sort(calibrate.pick_outlier_features(stats[k]), axis=1)
        if picked.tolist() != [hot] * spec.num_layers:
            raise AssertionError(f"calibration {k}: picked {picked.tolist()}")
    qo = quantize_layer_params(planted, outlier_stats=stats)
    if not isinstance(qo["layers"]["wq"], Int8OutlierWeight):
        raise AssertionError("int8-outliers: wq took no decomposition")
    k_of = {k: (w.outlier_idx.shape[-1] if isinstance(w, Int8OutlierWeight)
                else 0) for k, w in qo["layers"].items()
            if isinstance(w, (Int8Weight, Int8OutlierWeight))}
    rng = np.random.default_rng(SEED + 14)
    corpus = [rng.integers(3, spec.vocab_size, size=256).tolist()
              for _ in range(4)]
    kl_plain = quality.mean_token_kl(spec, planted,
                                     quantize_layer_params(planted), corpus)
    kl_out = quality.mean_token_kl(spec, planted, qo, corpus)
    log(f"int8 outliers: planted features {hot}, calibration (4 x 128 "
        f"tokens, {flash} flash prefill launches) found exactly them past "
        f"6.0 in {', '.join(RESIDUAL_READERS)} of every layer; outlier "
        f"features per linear {json.dumps(k_of)}; KL(bf16 || int8) "
        f"{kl_plain:.6g}, KL(bf16 || int8-outliers) {kl_out:.6g} over "
        f"4 x 256 tokens")
    if not kl_out < kl_plain:
        raise AssertionError(f"int8-outliers KL {kl_out} is not below plain "
                             f"int8's {kl_plain}")
    return dict(quant_s=quant_s, kl_int8=kl_plain, kl_int8_outliers=kl_out)


# run 13: generate.v1 over gRPC on the paged engine, Llama-2-7B int8 weights.
# (prompt tokens, new tokens) a request; batch 1 is prefilled at once, batch
# 2 merged in after RUN13_MERGE_AT NextTokens; request 1 asks for its input
# tokens and logprobs and ends first
RUN13_BATCH1 = [(64, 12), (200, 30), (350, 20), (512, 36), (640, 24),
                (777, 32), (900, 16), (1024, 28)]
RUN13_BATCH2 = [(100, 20), (300, 14), (600, 26), (1000, 18)]
RUN13_MERGE_AT = 6
RUN13_PRUNE = 7            # request 7 leaves by PruneBatch, not a delta
RUN13_OVERRIDES = dict(prefill_buckets=[64, 128, 256, 512, 1024, 2048, 4096,
                                        8192],
                       max_prefill_padding=1.0, paged_gather_ctx_max=0)
RUN13_MAX_SEQ = 8192       # max_prefill_tokens 8192: batch 1 at bucket 1024


def run13_requests():
    """[(request id, prompt text, new tokens)] of both batches; ASCII text
    the byte tokenizer encodes one token a character."""
    rng = np.random.default_rng(SEED + 13)
    out = []
    for rid, (n, new) in enumerate(RUN13_BATCH1 + RUN13_BATCH2, start=1):
        text = "".join(chr(c) for c in rng.integers(97, 123, size=n))
        out.append((rid, text, new))
    return out[:len(RUN13_BATCH1)], out[len(RUN13_BATCH1):]


async def drive_generate_v1(svc, config, batch1, batch2, want_input: int):
    """The reference router's flow over a real gRPC socket: Prefill batch 1,
    NextToken with `completed_ids` deltas, Prefill batch 2 and merge it,
    PruneBatch one request, until every request has its tokens; then
    ModelInfo and ClearCache. Returns ({request id: tokens}, counts)."""
    import grpc

    from text_generation_inference_tpu_torch.pb import generate_pb2 as gpb
    from text_generation_inference_tpu_torch.server.internal_server import (
        serve_internal_grpc)

    server = await serve_internal_grpc(svc, config)
    try:
        async with grpc.aio.insecure_channel(
                f"127.0.0.1:{config.grpc_port}") as ch:
            def rpc(name):
                req = getattr(gpb, f"{name}Request")
                resp = getattr(gpb, f"{name}Response")
                return ch.unary_unary(
                    f"/generate.v1.TextGenerationService/{name}",
                    request_serializer=req.SerializeToString,
                    response_deserializer=resp.FromString)

            def request(rid, text, new):
                details = rid == want_input
                return gpb.Request(
                    id=rid, inputs=text, max_output_length=new,
                    parameters=gpb.NextTokenChooserParameters(
                        min_new_tokens=new),
                    details=gpb.RequestedDetails(
                        input_toks=details, logprobs=details, ranks=details))

            want = {rid: new for rid, _, new in batch1 + batch2}
            toks = {rid: [] for rid in want}
            batch_of: dict[int, int] = {}
            live: set[int] = set()
            done: set[int] = set()          # finished, not yet reported
            calls = dict(prefill=0, next_token=0, prune_batch=0)

            def record(result):
                for t in result.output_tokens:
                    if len(toks[t.request_id]) < want[t.request_id]:
                        toks[t.request_id].append(t.token_id)
                finished = {rid for rid in live
                            if len(toks[rid]) == want[rid]}
                live.difference_update(finished)
                done.update(finished)

            async def prefill(bid, batch):
                r = await rpc("Prefill")(gpb.PrefillRequest(batch=gpb.Batch(
                    id=bid, requests=[request(*q) for q in batch])))
                calls["prefill"] += 1
                for rid, _, _ in batch:
                    batch_of[rid] = bid
                    live.add(rid)
                record(r.result)
                return r

            def report(bid):
                ids = sorted(rid for rid in done if batch_of[rid] == bid)
                done.difference_update(ids)
                return gpb.RequestsStatus(completed_ids=ids)

            r = await prefill(1, batch1)
            it = r.input_tokens[0]
            if (it.request_id != want_input
                    or len(it.tokens) != len(batch1[want_input - 1][1])
                    or not all(math.isfinite(t.logprob) for t in it.tokens)):
                raise AssertionError(f"run 13: input tokens {it}")
            cached = {1}
            while live:
                if calls["next_token"] == RUN13_MERGE_AT and calls[
                        "prefill"] == 1:
                    await prefill(2, batch2)
                    cached.add(2)
                if RUN13_PRUNE in done and not calls["prune_batch"]:
                    bid = batch_of[RUN13_PRUNE]
                    pr = await rpc("PruneBatch")(gpb.PruneBatchRequest(
                        batch=gpb.CachedBatch(batch_id=bid,
                                              status=report(bid))))
                    calls["prune_batch"] += 1
                    if not pr.HasField("batch_id"):
                        cached.discard(bid)
                if not live:
                    break
                batches = [gpb.CachedBatch(batch_id=b, status=report(b))
                           for b in sorted(cached)]
                r = await rpc("NextToken")(gpb.NextTokenRequest(
                    batches=batches))
                calls["next_token"] += 1
                merged = r.result.batch_id
                for rid in live | done:
                    batch_of[rid] = merged
                cached = {merged}
                record(r.result)
            info = await rpc("ModelInfo")(gpb.ModelInfoRequest())
            await rpc("ClearCache")(gpb.ClearCacheRequest())
    finally:
        await server.stop(grace=1.0)
    calls["model_info"] = info
    return toks, calls


def run_batcher(torch, engine, config, batches, want_input: int):
    """The fmaas path on the same engine: the same prompts as the
    GenRequests the Generate servicer submits, batch 1 as one wave, then
    batch 2; greedy, min_new_tokens = max_new_tokens. Returns {request id:
    tokens}."""
    from text_generation_inference_tpu_torch.engine.engine import RequestParams
    from text_generation_inference_tpu_torch.scheduler.batcher import Batcher
    from text_generation_inference_tpu_torch.scheduler.request import (
        GenRequest, ResponseOptions, StoppingCriteria)

    tokenizer = ByteTokenizer()

    def wave(batch):
        return [(rid, GenRequest(
            input_text=text, input_ids=tokenizer.encode(text),
            params=RequestParams(max_new_tokens=new, min_new_tokens=new),
            stopping=StoppingCriteria(max_new_tokens=new, min_new_tokens=new),
            options=ResponseOptions(input_tokens=rid == want_input,
                                    token_logprobs=rid == want_input,
                                    token_ranks=rid == want_input)))
            for rid, text, new in batch]

    async def drive():
        batcher = Batcher(engine, tokenizer, config)
        batcher.start()
        try:
            out = {}
            for batch in batches:
                reqs = wave(batch)
                await run_wave(batcher, [r for _, r in reqs])
                out.update((rid, [rec.token_id for rec in r.generated])
                           for rid, r in reqs)
            return out
        finally:
            await batcher.stop()

    return asyncio.run(drive())


def serve_internal(torch, counters, card):
    """Run 13: Llama-2-7B widths at full depth, random bf16 weights made
    on the card and quantized there to int8 (`QUANTIZE=int8`), on the paged
    engine with its decode captured as CUDA graphs, served through
    generate.v1 over gRPC on a local port (`drive_generate_v1`): every
    NextToken one replay of a captured chunk-1 program, for both detail
    flags. Checks: the greedy tokens equal the Batcher's (the fmaas path)
    for the same prompts on the same engine after its slots are cleared;
    the peak of allocated memory less params, pool and the graphs' pool
    within the plan's activation and int8 transient bytes. Times the int8
    decode step against the bf16 model's at 8 live requests."""
    import dataclasses
    import gc
    import socket

    from text_generation_inference_tpu_torch.engine.memory import tree_bytes
    from text_generation_inference_tpu_torch.models.fuse import fuse_params
    from text_generation_inference_tpu_torch.ops.quant.int8 import (
        Int8Weight, quantize_layer_params)
    from text_generation_inference_tpu_torch.server.internal_server import (
        InternalTextGenerationService)

    # the engine plans against the whole card: hand back what earlier
    # phases left in the allocator's cache before the weights are drawn, or
    # they land among its free blocks and leave it fragmented
    gc.collect()
    torch.cuda.empty_cache()
    spec = llama_spec(LLAMA7B)
    # fused as the engine fuses them: no unfused copy stays resident
    params = fuse_params(spec, random_params(torch, spec))
    bf16_bytes = tree_bytes(params)
    engine, _ = make_engine(torch, spec, params, RUN13_MAX_SEQ,
                            RUN13_OVERRIDES)
    engine.warmup(batch_sizes=(1,))
    step_bf16 = time_decode(torch, engine, "7b bf16 paged (run 13's model "
                            "before quantization)", live=8, calls=16)
    # free the bf16 engine's pool before the int8 codes are allocated, or
    # they land in its cached segment and the int8 engine's pool cannot
    del engine
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    q8 = quantize_layer_params(params)
    sync(torch)
    quant_s = time.monotonic() - t0
    del params
    if not isinstance(q8["layers"]["w_gu"], Int8Weight):
        raise AssertionError("run 13: w_gu was not quantized")
    int8_bytes = tree_bytes(q8)
    engine, config = make_engine(torch, spec, q8, RUN13_MAX_SEQ,
                                 RUN13_OVERRIDES)
    t0 = time.monotonic()
    engine.warmup(batch_sizes=(1,))
    warmup_s = time.monotonic() - t0
    progs = engine.programs
    keys = set(progs.programs)
    chunk1 = {k for k in keys if k[2] == 1}
    if DEVICE == "cuda" and ({k[0] for k in chunk1} != {False, True}
                             or not all(progs.get(k).graph is not None
                                        for k in keys)):
        raise AssertionError(f"run 13: warmup captured {sorted(keys)}")
    begin = engine.decode_steps_begin

    def counted_begin(*args, **kw):
        counted_begin.calls += 1
        return begin(*args, **kw)

    counted_begin.calls = 0
    engine.decode_steps_begin = counted_begin
    replays0 = {k: p.replays for k, p in progs.programs.items()}
    batch1, batch2 = run13_requests()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    served = dataclasses.replace(config, grpc_port=port, uds_path=None)
    svc = InternalTextGenerationService(engine, ByteTokenizer(), served)
    for c in counters.values():
        c.reset()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    toks, calls = asyncio.run(drive_generate_v1(svc, served, batch1, batch2,
                                                want_input=1))
    sync(torch)
    wall = time.monotonic() - t0
    counts = {k: c.read() for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    if engine.num_active:
        raise AssertionError("run 13: ClearCache left requests in flight")
    replayed = {k: p.replays - replays0.get(k, 0)
                for k, p in progs.programs.items()
                if p.replays > replays0.get(k, 0)}
    if set(progs.programs) != keys or counted_begin.calls != calls[
            "next_token"] or sum(replayed.values()) != calls["next_token"]:
        raise AssertionError(f"run 13: {calls['next_token']} NextTokens, "
                             f"{counted_begin.calls} dispatches, replays "
                             f"{replayed}")
    if {k[0] for k in replayed} != {False, True} or any(
            k[2] != 1 for k in replayed):
        raise AssertionError(f"run 13: replayed {replayed}")
    for key in ("flash_prefill", "paged_decode_attention"):
        if DEVICE == "cuda" and counts[key] <= 0:
            raise AssertionError(f"{key} never ran in serving run 13: {counts}")
    want = {rid: new for rid, _, new in batch1 + batch2}
    if {rid: len(t) for rid, t in toks.items()} != want:
        raise AssertionError(f"run 13: token counts {toks}")
    info = calls.pop("model_info")
    kv = spec.num_layers * 2 * spec.num_kv_heads * spec.head_dim * 2
    if (info.memory_scaling_model.nexttoken_linear_coef0 != kv
            or info.eos_token != ByteTokenizer.eos_token_id):
        raise AssertionError(f"run 13: ModelInfo {info}")
    plan = engine.memory_plan
    params_b, pool_b = tree_bytes(engine.model_params), kv_bytes(engine)
    graphs_b = progs.pool_bytes() or 0
    transient = peak - params_b - pool_b - graphs_b
    planned = plan.graph_pool_bytes + plan.quant_bytes
    gib = 2 ** 30
    log(f"serve[run 13, generate.v1] {card}: {spec.num_layers} layers at "
        f"7B widths, int8 weights quantized on the card in {quant_s:.1f}s "
        f"(params {int8_bytes / gib:.2f} GiB against the bf16 model's "
        f"{bf16_bytes / gib:.2f} GiB); warmup {warmup_s:.1f}s, "
        f"{len(keys)} programs; {len(toks)} requests over gRPC on "
        f"127.0.0.1:{port} in {wall:.2f}s: {calls} calls, each NextToken "
        f"one replay ({json.dumps({str(k): v for k, v in replayed.items()})}); "
        f"ModelInfo kv/token {kv}, weight_limit "
        f"{info.memory_scaling_model.weight_limit}; launches {counts}")
    log(f"serve[run 13] memory: plan {plan.describe()}; peak allocated "
        f"{peak / gib:.2f} GiB = params {params_b / gib:.2f} + pool "
        f"{pool_b / gib:.2f} + graphs' pool {graphs_b / gib:.3f} + transient "
        f"{transient / gib:.3f} GiB against the plan's graph pool + int8 "
        f"transient bytes {planned / gib:.3f} GiB")
    if DEVICE == "cuda" and graphs_b + transient > planned:
        raise AssertionError(f"run 13: the graphs' pool {graphs_b} and "
                             f"transient {transient} bytes exceed the "
                             f"plan's {planned}")
    # the fmaas path on the same engine, its slots cleared in place
    engine._clear_slots()
    engine.decode_steps_begin = begin
    fmaas = run_batcher(torch, engine, config, (batch1, batch2), want_input=1)
    diff = {rid: (toks[rid], fmaas[rid]) for rid in want
            if toks[rid] != fmaas[rid]}
    if diff:
        raise AssertionError(f"run 13: generate.v1 and the Batcher differ: "
                             f"{diff}")
    step_int8 = time_decode(torch, engine, "7b int8 paged (run 13)", live=8,
                            calls=16)
    ratio = step_int8["wall_ms"] / step_bf16["wall_ms"]
    log(f"run 13: greedy tokens of all {len(want)} requests equal the "
        f"Batcher's ({sum(want.values())} tokens); int8 decode step "
        f"{step_int8['wall_ms']:.3f} ms (busy {step_int8['busy_ms']:.3f}) "
        f"against bf16 {step_bf16['wall_ms']:.3f} ms (busy "
        f"{step_bf16['busy_ms']:.3f}) at 8 live: {ratio:.2f}x on {card}")
    del engine
    counts.update(int8_step_ms=step_int8["wall_ms"],
                  bf16_step_ms=step_bf16["wall_ms"],
                  int8_params_bytes=int8_bytes, bf16_params_bytes=bf16_bytes,
                  transient_bytes=transient, planned_bytes=planned)
    return counts


def gptq_solve(torch, card):
    """The GPTQ solve on the card (`gptq_quantize_weight`, float64): at
    [256, 512] against the same call on the CPU (codes equal in at least
    99.9% of entries and never more than one apart, scales within 1e-5
    relative, g_idx identical), then one 7B linear (4096 x 4096, the
    Hessian from 2048 random rows) timed with act-order off and on, and an
    estimate for a whole 7B model's solves."""
    from text_generation_inference_tpu_torch.ops.quant import int4
    from text_generation_inference_tpu_torch.ops.quant.gptq_quantize import (
        gptq_quantize_weight)

    rng = np.random.default_rng(SEED + 15)
    w = rng.normal(size=(256, 512)).astype(np.float32)
    x = rng.normal(size=(1024, 512)).astype(np.float32)
    h = 2.0 * (x.T @ x)
    for act_order in (False, True):
        got = gptq_quantize_weight(w, h, act_order=act_order, device=DEVICE)
        want = gptq_quantize_weight(w, h, act_order=act_order, device="cpu")
        qg, qw = (int4.unpack_rows(t[0].cpu()) for t in (got, want))
        same = (qg == qw).float().mean().item()
        far = (qg - qw).abs().max().item()
        scale_err = ((got[2].cpu() - want[2]).abs() / want[2].abs()).max().item()
        if same < 0.999 or far > 1 or scale_err > 1e-5 \
                or not torch.equal(got[3].cpu(), want[3]):
            raise AssertionError(f"gptq solve (act_order={act_order}): codes "
                                 f"equal {same}, max diff {far}, scales "
                                 f"{scale_err}")
        log(f"gptq solve [256, 512] act_order={act_order}: {DEVICE} against "
            f"the CPU: codes equal {same:.6f}, max diff {far}, scales max "
            f"rel err {scale_err:.2e}, g_idx identical")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 15)
    w7 = torch.randn(4096, 4096, generator=gen, device=DEVICE) / 64
    x7 = torch.randn(2048, 4096, generator=gen, device=DEVICE)
    h7 = 2.0 * (x7.T @ x7)
    times = {}
    for act_order in (False, True):
        sync(torch)
        t0 = time.monotonic()
        out = gptq_quantize_weight(w7, h7, act_order=act_order, device=DEVICE)
        sync(torch)
        times[act_order] = time.monotonic() - t0
        if out[0].shape != (512, 4096):
            raise AssertionError(f"gptq solve: qweight {out[0].shape}")
    # a 7B layer solves six linears of 4096 inputs (q, k, v, o, gate, up)
    # and one of 11008 (down); the column loop is the cost, so a solve
    # scales with its inputs
    per_layer = 6 + 11008 / 4096
    estimate = {ao: 32 * per_layer * t for ao, t in times.items()}
    log(f"gptq solve 4096 x 4096 (H from 2048 rows) on {card}: act_order "
        f"off {times[False]:.3f}s, on {times[True]:.3f}s; a 7B model's 224 "
        f"solves at about {estimate[False]:.0f}s / {estimate[True]:.0f}s "
        f"(32 layers x {per_layer:.2f} solves of 4096 inputs; the Hessians "
        f"not included)")
    return dict(solve_s=times[False], solve_act_order_s=times[True],
                estimate_7b_s=estimate[False],
                estimate_7b_act_order_s=estimate[True])


def kv_bytes(engine) -> int:
    """Bytes of an engine's KV cache or page pool (scale pools and the
    block table included)."""
    return sum(x.numel() * x.element_size() for x in engine.cache
               if x is not None)


# --- tensor parallelism (`parallel/`) ---------------------------------------

# world size 2 on the one card: each rank's KV pool (the two ranks share the
# card, so neither sizes its pool from the card's memory), the depth of the
# 7B-width runs and of the StarCoder-width one
TP_PAGES = 64
TP_LAYERS = 4
TP_STARCODER_LAYERS = 2
# the serving runs at world size 2: a wave of four unary requests, then
# three with one streaming, 24 new tokens each
TRAFFIC_TP = (([100, 250, 420, 600], 0), ([150, 500, 820], 2)), 24
# prompts of the token streams held to world size 1
TP_PROMPT_LENS = (700, 300, 520, 90)
TP_NEW = 24
# the kernels a tp run must launch on every rank
TP_KERNELS = {
    "bf16": ("flash_prefill", "paged_decode_attention",
             "paged_decode_attention_stats"),
    "gptq": ("flash_prefill", "int4_matmul", "int4_matmul_s4_stacked",
             "int4_mlp_s4_stacked", "paged_decode_attention_partial_i8"),
    "starcoder": ("flash_prefill", "paged_decode_attention"),
}


def tp_wrappers():
    """The kernel wrappers whose launches the tp phase reads, by name."""
    from text_generation_inference_tpu_torch.ops.cuda import flash_prefill as fp
    from text_generation_inference_tpu_torch.ops.cuda import int4_matmul as im
    from text_generation_inference_tpu_torch.ops.cuda import int4_mlp as mlp
    from text_generation_inference_tpu_torch.ops.cuda import paged_attention as pa

    return {"flash_prefill": fp.flash_prefill,
            "paged_decode_attention": pa.paged_decode_attention,
            "paged_decode_attention_stats": pa.paged_decode_attention_partial,
            "paged_decode_attention_partial_i8":
                pa.paged_decode_attention_partial_i8,
            "int4_matmul": im.int4_matmul,
            "int4_matmul_s4_stacked": im.int4_matmul_s4_stacked,
            "int4_mlp_s4_stacked": mlp.int4_mlp_s4_stacked}


def tp_logits(torch, spec, params, tp=None):
    """prefill_paged of two prompts (700 and 300 tokens, bucket 1024) and
    4 decode_paged steps of fixed seeded ids, through the kernels, on the
    whole model or (with `tp`) on the rank's shard: the logits at each
    prompt's last position and at each step."""
    from text_generation_inference_tpu_torch.engine.paged_cache import PagedKVCache
    from text_generation_inference_tpu_torch.models import paged_core
    from text_generation_inference_tpu_torch.models.fuse import fuse_params
    from text_generation_inference_tpu_torch.parallel.sharding import shard_model

    if tp is not None:
        spec, params = shard_model(spec, params, tp, DEVICE)
    params = fuse_params(spec, params)
    page, t, n = 128, 1024, 2
    lengths = torch.tensor([700, 300], dtype=torch.int32, device=DEVICE)
    slots = torch.tensor([0, 1], dtype=torch.int32, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    ids = torch.randint(3, spec.vocab_size, (n, t), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    steps = torch.randint(3, spec.vocab_size, (4, n), generator=gen,
                          device=DEVICE, dtype=torch.int32)
    max_pages = t // page + 1
    cache = PagedKVCache.create(spec, 2 * max_pages, page, n, max_pages,
                                DTYPE, DEVICE)
    cache.block_table.copy_(torch.arange(2 * max_pages, dtype=torch.int32,
                                         device=DEVICE).reshape(n, max_pages))
    lg, _ = paged_core.prefill_paged(spec, params, ids, lengths, slots, cache,
                                     page)
    out = [lg[torch.arange(n), lengths.long() - 1]]
    pos = lengths.clone()
    for step in steps:
        lg, _ = paged_core.decode_paged(spec, params, step, pos, cache,
                                        pos + 1, page)
        out.append(lg)
        pos = pos + 1
    sync(torch)
    return out, spec


def tp_prompts(seed: int):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(3, 259, size=n)]
            for n in TP_PROMPT_LENS]


def tp_rank(rank: int, world: int, port: int, out) -> None:
    """One rank of the world-size-2 runs: the card, a gloo group on CUDA
    tensors (NCCL refuses two ranks on one device) and the op stream's
    group; `tp_rank_runs`; the result or the traceback to `out`."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    from text_generation_inference_tpu_torch.parallel.comm import TPGroup
    from text_generation_inference_tpu_torch.parallel.multihost import OpChannel

    global DTYPE
    DTYPE = torch.bfloat16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    try:
        timeout = datetime.timedelta(minutes=5)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world, timeout=timeout)
        channel = OpChannel(dist.new_group(backend="gloo", timeout=timeout))
        out.put((rank, True, tp_rank_runs(torch, TPGroup(rank, world),
                                          channel)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def tp_rank_runs(torch, tp, channel) -> dict:
    """The runs of one rank at world size 2, the same calls on both ranks:
    Llama-2-7B widths (TP_LAYERS layers) in bf16, then GPTQ-INT4 with an
    int8 KV pool and INT4_FUSED_MLP=1, each held to world size 1 (rank 0
    runs the whole model alone first), then served through the Batcher with
    gRPC on rank 0 over a `ReplicatedEngine` while rank 1 replays; then
    StarCoder's widths (TP_STARCODER_LAYERS layers: 48 query heads over one
    kv head, so each rank attends with its 24 heads over the one kv head)
    held to world size 1."""
    out = {}
    spec = llama_spec(LLAMA7B, num_layers=TP_LAYERS)
    runs = (("bf16", random_params(torch, spec), False,
             dict(paged_gather_ctx_max=0)),
            ("gptq", random_params(torch, spec, gptq=True), True,
             dict(kv_cache_dtype="int8", decode_chunk=8,
                  paged_gather_ctx_max=0)))
    for label, params, fused, overrides in runs:
        out[label] = tp_run(torch, tp, channel, label, spec, params, fused,
                            overrides, serve=True)
        del params
    spec_sc = family_spec("gpt_bigcode", num_layers=TP_STARCODER_LAYERS)
    params_sc = family_params(torch, spec_sc, 9)
    out["starcoder"] = tp_run(torch, tp, channel, "starcoder", spec_sc,
                              params_sc, False, dict(paged_gather_ctx_max=0),
                              serve=False)
    return out


def tp_run(torch, tp, channel, label, spec, params, fused, overrides,
           serve: bool) -> dict:
    """One model at world size 2: logits and greedy token streams against
    world size 1 (on rank 0), the step time of both, and with `serve` a
    Batcher run (+ gRPC) on rank 0 over the op stream. Returns this rank's
    record: its local widths, the launches of the serving run (or of the
    token streams), and on rank 0 the comparisons."""
    from text_generation_inference_tpu_torch.parallel import multihost
    from text_generation_inference_tpu_torch.tools import spec_measure

    wrappers = tp_wrappers()
    rec = {}
    checksum = sum(float(p.float().sum()) for p in (
        params["embed_tokens"], params["final_norm"]["scale"]))
    rec["checksum"] = checksum
    if tp.rank == 0:
        want, _ = tp_logits(torch, spec, params)
    got, local = tp_logits(torch, spec, params, tp)
    rec["local"] = dict(heads=local.num_heads, kv_heads=local.num_kv_heads,
                        intermediate=local.intermediate_size,
                        kv_index=local.tp.kv_index,
                        vocab_split=local.tp.head_split)
    if tp.rank == 0:
        pairs = list(zip(got, want))
        tol, peak = logit_tolerance(pairs, FAMILY_ULPS)
        max_err, agree, decided = compare_logits(
            torch, pairs, spec.vocab_size, tol, f"tp {label} logits")
        rec["logits"] = dict(max_abs_err=max_err, tol=tol, peak=peak,
                             agree=agree, decided=decided)
        log(f"tp[{label}] rank 0 at world size 2 against world size 1: "
            f"{describe_error(max_err, tol, peak, FAMILY_ULPS)}, greedy "
            f"tokens equal {agree}/{decided}")
    del got
    prompts = tp_prompts(SEED + 17)
    if tp.rank == 0:
        alone, _ = make_engine(torch, spec, params, 2048, overrides,
                               fused=fused, eager=True, num_pages=TP_PAGES)
        plain, _, _, top2 = spec_measure.decode_all(alone, prompts, TP_NEW,
                                                    want_details=True)
        rec["step_world1"] = time_decode(torch, alone, f"tp {label} world 1",
                                         live=8, calls=8)
        del alone
    engine, config = make_engine(torch, spec, params, 2048, overrides,
                                 fused=fused, eager=True, num_pages=TP_PAGES,
                                 tp=tp)
    if engine.fuse_mlp != fused:
        raise AssertionError(f"tp[{label}]: INT4_FUSED_MLP not taken")
    for fn in wrappers.values():
        fn.launches = 0
    toks, _, _, _ = spec_measure.decode_all(engine, prompts, TP_NEW,
                                            want_details=True)
    rec["stream_launches"] = {k: fn.launches for k, fn in wrappers.items()}
    if tp.rank == 0:
        rec["streams_differing"] = first_differences(
            plain, toks, top2, f"tp {label} streams, world 2 vs 1")
    rec["tokens"] = toks
    rec["step_world2"] = time_decode(torch, engine, f"tp {label} world 2",
                                     live=8, calls=8)
    if serve:
        for fn in wrappers.values():
            fn.launches = 0
        if tp.rank == 0:
            rec["serve"] = tp_serve(torch, multihost.ReplicatedEngine(
                engine, channel, keepalive_s=None), config, label)
        else:
            rec["replayed_ops"] = multihost.follower_loop(engine, channel)
        rec["launches"] = {k: fn.launches for k, fn in wrappers.items()}
    else:
        rec["launches"] = rec["stream_launches"]
    del engine
    return rec


def tp_serve(torch, engine, config, label) -> dict:
    """Rank 0's serving run: TRAFFIC_TP through the Batcher and one
    Generate / GenerateStream / ModelInfo over gRPC, on a
    `ReplicatedEngine`; then the followers are released."""
    from text_generation_inference_tpu_torch.scheduler.batcher import Batcher

    tokenizer = ByteTokenizer()
    waves, new = TRAFFIC_TP

    async def drive():
        batcher = Batcher(engine, tokenizer, config)
        batcher.start()
        try:
            reqs = []
            t0 = time.monotonic()
            for i, (lens, streaming_every) in enumerate(waves):
                wave = make_requests(lens, streaming_every, 300 * (i + 1), new)
                await run_wave(batcher, wave)
                reqs += wave
            wall = time.monotonic() - t0
            await grpc_roundtrip(batcher, config, tokenizer)
            return reqs, wall
        finally:
            await batcher.stop()

    try:
        reqs, wall = asyncio.run(drive())
    finally:
        engine.shutdown()
    tokens = sum(r.generated_count for r in reqs)
    if any(r.generated_count != new for r in reqs):
        raise AssertionError(f"tp[{label}] serve: generated "
                             f"{[r.generated_count for r in reqs]}")
    log(f"tp[{label}] serve: {len(reqs)} requests + gRPC Generate / "
        f"GenerateStream / ModelInfo on rank 0 of 2, {tokens} tokens in "
        f"{wall:.2f}s wall")
    return dict(requests=len(reqs), tokens=tokens, wall_s=wall)


def tp_world1(torch, card) -> dict:
    """World size 1 over NCCL: the sharding and the collectives run (a
    group of one), and each decode program is captured with its NCCL
    collectives inside. A graph engine and an eager one, both on the
    group, in lockstep (`decode_replay.lockstep`: replay == eager bit for
    bit); then the step time of each, TP_LAYERS layers at 7B widths."""
    import torch.distributed as dist

    from text_generation_inference_tpu_torch.parallel.comm import TPGroup
    from text_generation_inference_tpu_torch.tools import decode_replay

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    try:
        tp = TPGroup(0, 1)
        spec = llama_spec(LLAMA7B, num_layers=TP_LAYERS)
        params = random_params(torch, spec)
        engines = {mode: make_engine(torch, spec, params, 2048,
                                     dict(paged_gather_ctx_max=0),
                                     eager=mode == "eager", num_pages=128,
                                     tp=tp)[0]
                   for mode in ("graphs", "eager")}
        seen = decode_replay.lockstep(engines["graphs"], engines["eager"],
                                      vocab=spec.vocab_size)
        progs = engines["graphs"].programs
        if not progs.capture or not all(
                p.graph is not None for p in progs.programs.values()):
            raise AssertionError("tp world 1: a decode program is not a graph")
        for e in engines.values():
            e._clear_slots()
        times = {mode: time_decode(torch, engines[mode],
                                   f"tp world 1 nccl {mode}", live=8,
                                   calls=8)
                 for mode in ("eager", "graphs")}
        log(f"tp world 1 over NCCL on {card}: replay == eager bit for bit "
            f"over {seen['dispatches']} dispatches, {len(progs)} programs "
            f"captured with their collectives; wall ms/step eager "
            f"{times['eager']['wall_ms']:.3f}, graphs "
            f"{times['graphs']['wall_ms']:.3f}")
        return dict(dispatches=seen["dispatches"], programs=len(progs),
                    wall_ms={m: t["wall_ms"] for m, t in times.items()},
                    busy_ms={m: t["busy_ms"] for m, t in times.items()})
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tp_world2(card) -> list:
    """The two ranks of `tp_rank` on this card, each its own process;
    returns their records (rank order), or raises with a rank's
    traceback."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=tp_rank, args=(r, 2, port, results))
             for r in range(2)]
    for p in procs:
        p.start()
    got, errors = [None, None], []
    try:
        for _ in procs:
            rank, ok, value = results.get(timeout=900)
            if ok:
                got[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    if errors:
        raise AssertionError("tp world 2 failed:\n" + "\n".join(errors))
    return got


def tp_phase(torch, timer, card) -> dict:
    """The tensor-parallel phase: (1) the kernels at the rank-local shapes
    of world size 2 against their plain versions (Llama-2-7B's 16 heads
    over 16 kv heads, K1 on the four products' shards, M1 on the MLP's
    shards; StarCoder's 24 query heads over its one kv head); (2) world
    size 1 over NCCL, decode captured with the collectives; (3) world size
    2 on this card (`tp_world2`): each rank's launches, rank 0 against
    world size 1. Gloo carries the collectives at world size 2, through
    the host."""
    import gc

    # the ranks share the card with this process: hand back what earlier
    # phases left in the allocator's cache
    gc.collect()
    torch.cuda.empty_cache()
    log(f"tp: this process holds {torch.cuda.memory_allocated() / 2 ** 30:.2f}"
        f" GiB allocated, {torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB "
        "reserved")
    kernels = {
        "flash_prefill": check_flash_prefill(torch, timer, d=128, kh=16, g=1),
        "paged_decode_attention": check_paged(torch, timer, stats=False,
                                              kh=16, g=1, d=128),
        "paged_decode_attention_stats": check_paged(torch, timer, stats=True,
                                                    kh=16, g=1, d=128),
        "paged_decode_attention_partial_i8": check_paged_int8(
            torch, timer, kh=16, g=1, d=128),
        "int4_matmul_s4_stacked": sum_results([
            check_int4(torch, timer, "int4_matmul_s4_stacked", key, 16)
            for key in K1_TP_SHAPES]),
        "int4_matmul": sum_results([
            check_int4(torch, timer, "int4_matmul", key, 1024)
            for key in K1_TP_SHAPES]),
        "int4_mlp_s4_stacked": check_int4_mlp(torch, timer, 16, "silu_glu",
                                              shape=(4096, 5504)),
        "flash_prefill_mqa": check_flash_prefill(torch, timer, d=128, kh=1,
                                                 g=24, lens=(2000, 1500)),
        "paged_decode_attention_mqa": check_paged(torch, timer, stats=False,
                                                  kh=1, g=24, d=128)}
    world1 = tp_world1(torch, card)
    ranks = tp_world2(card)
    for label, names in TP_KERNELS.items():
        for rank, rec in enumerate(ranks):
            missed = [k for k in names if rec[label]["launches"][k] <= 0]
            if missed:
                raise AssertionError(f"tp[{label}] rank {rank} never launched "
                                     f"{missed}: {rec[label]['launches']}")
        if len({rec[label]["checksum"] for rec in ranks}) != 1:
            raise AssertionError(f"tp[{label}]: the ranks' weights differ")
        if ranks[0][label]["tokens"] != ranks[1][label]["tokens"]:
            raise AssertionError(f"tp[{label}]: the ranks chose other tokens")
    want = {"bf16": dict(heads=16, kv_heads=16, intermediate=5504,
                         kv_index=None, vocab_split=True),
            "starcoder": dict(heads=24, kv_heads=1, intermediate=12288,
                              kv_index=(0,), vocab_split=True)}
    for label, local in want.items():
        for rec in ranks:
            if rec[label]["local"] != local:
                raise AssertionError(f"tp[{label}] local widths "
                                     f"{rec[label]['local']}, want {local}")
    steps = {label: dict(world1_ms=ranks[0][label]["step_world1"]["wall_ms"],
                         world2_ms=ranks[0][label]["step_world2"]["wall_ms"])
             for label in TP_KERNELS}
    log(f"tp steps (wall ms a decode step at 8 live, eager; world size 2 is "
        f"two ranks on one card whose gloo collectives go through the host) "
        f"on {card}: {json.dumps(steps)}; world size 1 over NCCL "
        f"{json.dumps(world1)}")
    for label in TP_KERNELS:
        log(f"tp[{label}] launches by rank: "
            f"{json.dumps([rec[label]['launches'] for rec in ranks])}; local "
            f"widths {ranks[0][label]['local']}; rank 0 {json.dumps({k: v for k, v in ranks[0][label].items() if k in ('logits', 'streams_differing', 'serve')})}")
    return dict(kernels=kernels, world1=world1, ranks=ranks, steps=steps)


class Counter:
    """Reads and zeroes one launch counter (an attribute on a wrapper). A
    captured decode graph's launches are counted once per replay
    (`engine.programs.replayed`: captured x replays), eager ones as the
    wrapper counts them."""

    def __init__(self, holder, attr="launches"):
        from text_generation_inference_tpu_torch.engine import programs

        self.programs = programs
        self.holder, self.attr = holder, attr
        programs.track(holder, attr)
        self.base = 0

    def reset(self):
        setattr(self.holder, self.attr, 0)
        self.base = self.programs.replayed(self.holder, self.attr)

    def read(self):
        return (getattr(self.holder, self.attr)
                + self.programs.replayed(self.holder, self.attr) - self.base)


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

    marks = [time.monotonic()]

    def mark(phase):
        marks.append(time.monotonic())
        log(f"phase {phase}: {marks[-1] - marks[-2]:.1f}s")

    mark("build")
    timer = Timer(torch)
    if "--tp-only" in sys.argv[1:]:
        # the tensor-parallel phase alone (a quick check of its own)
        tp = tp_phase(torch, timer, card)
        mark("tp")
        print(json.dumps({"tp_steps": tp["steps"], "world1": tp["world1"]}),
              flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--prefill-only" in sys.argv[1:]:
        # the prefill programs' phase alone (a quick check of its own)
        prefill = prefill_phase(torch, card, {
            "flash_prefill": Counter(fp.flash_prefill),
            "int4_matmul": Counter(im.int4_matmul)})
        mark("prefill programs")
        print(json.dumps({"prefill": prefill}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
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
                                                   dtype=fp32),
        # at Llama-2-7B decode widths (16 slots, 32 kv heads, G 1, D 128),
        # and S2 at its first and last ring steps
        "paged_decode_attention 7B": check_paged(torch, timer, False, fp32,
                                                 kh=32, g=1, d=128),
        "paged_decode_attention_stats 7B": check_paged(torch, timer, True,
                                                       fp32, kh=32, g=1,
                                                       d=128),
        "decode_attention 7B": check_slot_decode(torch, timer, s=16, kh=32,
                                                 g=1, d=128, dtype=fp32),
        **{f"ring_decode_attention step {step}": check_ring_decode(
            torch, timer, step, dtype=fp32) for step in (0, 63)}}
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
                                     light=True, library=True)
                for m in (1, 17, 65, 1000) for key in K1_SHAPES}
    k1_dtypes = {(m, key, str(dt)): check_int4(torch, timer, "int4_matmul",
                                               key, m, dtype=dt, light=True,
                                               library=True)
                 for dt in (torch.float16, fp32) for key in ("wo", "w_down")
                 for m in (16, 2048)}
    for key in ("wo", "w_down"):
        check_int4_batch_invariance(torch, key)
    s1 = check_slot_decode(torch, timer, s=16, kh=4, g=8, d=64)
    s1_7b = check_slot_decode(torch, timer, s=16, kh=32, g=1, d=128)
    s2 = {step: check_ring_decode(torch, timer, step) for step in (0, 32, 63)}
    # sliding windows at run 7's shapes: flash prefill at Mistral-7B's
    # heads (32 over 8, D 128) and window (4096) in run 7's bucket of 6144
    # with prompts of its lengths past the window; S1 at run 7's decode
    # widths (8 slots over 8192 rows) and contexts (RUN7_CTX). Extras: a
    # window of 512 in a 2048 bucket, bf16 and the fp32 body.
    fp_win = check_flash_prefill(torch, timer, d=128, kh=8, g=4,
                                 window=4096, t=6144, lens=(6000, 4500))
    fp_win512 = check_flash_prefill(torch, timer, d=128, kh=8, g=4,
                                    window=512)
    fp_win_f32 = check_flash_prefill(torch, timer, d=64, kh=4, g=8,
                                     dtype=fp32, window=512)
    s1_win = check_slot_decode(torch, timer, s=8, kh=8, g=4, d=128, t=8192,
                               window=4096, ctx=RUN7_CTX)
    # the split body at head dim 96 (gpt-neox-20b: 64 heads, no GQA)
    pn96 = check_paged(torch, timer, stats=False, kh=64, g=1, d=96)
    ps96 = check_paged(torch, timer, stats=True, kh=64, g=1, d=96)
    # ALiBi: flash prefill at BLOOM-7b1's heads (32 over 32, D 128)
    # in a 2048 bucket with prompts of 2000 and 1500 tokens, and the fp32
    # body at falcon-rw-1b's (32 over 32, D 64); the split body at
    # BLOOM-7b1's decode widths (16 slots, 32 kv heads, G 1, D 128, page
    # 128, contexts up to 2048) in both paged modes, K2 over int8 pools and
    # S1 over a 2048-row slot cache. Multi-query at StarCoder's heads (48
    # over 1, D 128): flash prefill and the split body.
    fp_alibi = check_flash_prefill(torch, timer, d=128, kh=32, g=1,
                                   lens=(2000, 1500), alibi=True)
    fp_alibi_f32 = check_flash_prefill(torch, timer, d=64, kh=32, g=1,
                                       dtype=fp32, lens=(2000, 1500),
                                       alibi=True)
    pn_alibi = check_paged(torch, timer, stats=False, kh=32, g=1, d=128,
                           alibi=True)
    ps_alibi = check_paged(torch, timer, stats=True, kh=32, g=1, d=128,
                           alibi=True)
    pi8_alibi = check_paged_int8(torch, timer, kh=32, g=1, d=128, alibi=True,
                                 max_pages=16)
    s1_alibi = check_slot_decode(torch, timer, s=16, kh=32, g=1, d=128,
                                 alibi=True)
    fp_mqa = check_flash_prefill(torch, timer, d=128, kh=1, g=48,
                                 lens=(2000, 1500))
    # Falcon-7B's heads (config.json of tiiuae/falcon-7b: 71 over 1, D 64)
    fp_falcon = check_flash_prefill(torch, timer, d=64, kh=1, g=71,
                                    lens=(2000, 1500))
    pn_mqa = check_paged(torch, timer, stats=False, kh=1, g=48, d=128)
    # M1 at a 7B layer's MLP: decode rows of run 6 (16 slots) and the
    # kernel's largest row tile, both activations; fp16 / fp32 x (F3)
    m1 = {(m, act): check_int4_mlp(torch, timer, m, act)
          for m in (16, 64) for act in ("silu_glu", "gelu_glu")}
    m1_dtypes = {str(dt): check_int4_mlp(torch, timer, 16, "silu_glu", dt)
                 for dt in (torch.float16, fp32)}

    mark("kernels")
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
                "flash_prefill_windowed": Counter(fp.flash_prefill,
                                                  "windowed"),
                "decode_attention_windowed": Counter(da.decode_attention,
                                                     "windowed"),
                # launches given ALiBi slopes
                "flash_prefill_alibi": Counter(fp.flash_prefill, "alibi"),
                "paged_decode_attention_alibi":
                    Counter(pa.paged_decode_attention, "alibi"),
                "paged_decode_attention_stats_alibi":
                    Counter(pa.paged_decode_attention_partial, "alibi"),
                "paged_decode_attention_partial_i8_alibi":
                    Counter(pa.paged_decode_attention_partial_i8, "alibi"),
                "decode_attention_alibi": Counter(da.decode_attention,
                                                  "alibi"),
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
    fam_counts = family_parity(torch, counters)
    mark("family parity")
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

    mark("parity, serving runs 1-2")
    graphs(torch, spec, params, "tinyllama bf16 paged", card,
           focus=("split_kernel",))
    mark("graphs: tinyllama bf16 paged")

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
    mark("serving runs 4-5")
    graphs(torch, spec, params, "tinyllama slot scan", card, scan, slot=True,
           focus=("split_kernel",))
    mark("graphs: tinyllama slot scan")

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
    mark("probe, quant parity, serving run 3")
    # the 7B graphs phases at the first GRAPHS_7B_LAYERS of the 32 layers,
    # to keep the script within its time limit (serving runs 3 and 6 keep
    # all 32)
    spec7b_cut, params7b_cut = first_layers(spec7b, params7b, GRAPHS_7B_LAYERS)
    prof3 = graphs(torch, spec7b_cut, params7b_cut, "7b gptq int8kv", card,
                   quantized, max_seq=1024, live=16, calls=4,
                   focus=("k1_", "split_kernel", "sum_splits"))

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
    mark("graphs: 7b gptq int8kv, serving run 6")
    prof6 = graphs(torch, spec7b_cut, params7b_cut, "7b gptq int8kv fused",
                   card, quantized, max_seq=1024, live=16, calls=4, fused=True,
                   focus=("int4_mlp_kernel", "k1_", "sum_splits"))
    mark("graphs: 7b gptq int8kv fused")
    log(f"profile 7b: run 3's config {json.dumps(prof3)}; run 6's "
        f"(INT4_FUSED_MLP=1) {json.dumps(prof6)}")
    del params7b, params7b_cut

    # run 7: Mistral-7B-v0.1 at full width and depth on the slot engine in
    # scan mode, max_seq 8192, 8 slots; prompts past its window of 4096 cut
    # flash prefill and S1 at the window
    spec_m, params_m = family_model(torch, "mistral", 7)
    run7 = serve_run(torch, spec_m, params_m, "mistral-7b-slot-scan",
                     dict(decode_write_mode="scan",
                          prefill_buckets=[128, 256, 512, 1024, 2048, 4096,
                                           6144, 8192]),
                     counters, with_grpc=with_grpc, traffic=TRAFFIC_MISTRAL,
                     max_seq=8192, slot=True, slots=8)
    past = [n for wave, _ in TRAFFIC_MISTRAL[0] for n in wave
            if n > spec_m.sliding_window]
    for key in ("flash_prefill", "flash_prefill_windowed", "decode_attention",
                "decode_attention_windowed"):
        if run7[key] <= 0:
            raise AssertionError(f"{key} never ran in serving run 7: {run7}")
    if any(run7[key] for key in paged_kernels):
        raise AssertionError(f"a paged kernel ran on the slot engine: {run7}")
    log(f"run 7: {len(past)} prompts past the window of "
        f"{spec_m.sliding_window} ({past}); flash prefill cut at the window "
        f"{run7['flash_prefill_windowed']} of {run7['flash_prefill']} "
        f"launches, S1 with lower bounds {run7['decode_attention_windowed']}"
        f" of {run7['decode_attention']}")
    mark("serving run 7")
    # run 8: Gemma-7B at full width and depth on the default paged engine,
    # max_seq 2048 (D = 256: the wgmma flash kernel's 64-key tiles and the
    # split body at 256 on a served path), the default prefill batch of 8,
    # which meets the prefill cap (F4): its third wave prefills a row at a
    # time, its fourth as one batch of 8 rows at 256, one prompt of each
    # asks for its input tokens' details, and the peak stays within the
    # plan
    del params_m
    spec_g, params_g = family_model(torch, "gemma", 8)
    run8 = serve_run(torch, spec_g, params_g, "gemma-7b-paged",
                     dict(paged_gather_ctx_max=0), counters,
                     with_grpc=with_grpc, traffic=TRAFFIC_GEMMA,
                     details_waves=F4_DETAILS_WAVES, memory_check=True)
    for key in ("flash_prefill", "paged_decode_attention",
                "paged_decode_attention_stats"):
        if run8[key] <= 0:
            raise AssertionError(f"{key} never ran in serving run 8: {run8}")
    del params_g
    mark("serving run 8")
    # run 9: StarCoder-15.5B at full width and depth on the default paged
    # engine, max_seq 8192 (multi-query: 48 query heads on one kv head)
    spec_sc, params_sc = family_model(torch, "gpt_bigcode", 9)
    run9 = serve_run(torch, spec_sc, params_sc, "starcoder-15.5b-paged",
                     dict(paged_gather_ctx_max=0), counters,
                     with_grpc=with_grpc, traffic=TRAFFIC_STARCODER,
                     max_seq=8192)
    for key in ("flash_prefill", "paged_decode_attention",
                "paged_decode_attention_stats"):
        if run9[key] <= 0:
            raise AssertionError(f"{key} never ran in serving run 9: {run9}")
    del params_sc
    mark("serving run 9")
    # run 10: BLOOM-7b1 at full width and depth on the default paged engine
    # (ALiBi through flash prefill and both paged modes; a vocabulary of
    # 250880), max_seq 2048, run 8's traffic and checks
    spec_bl, params_bl = family_model(torch, "bloom", 10)
    run10 = serve_run(torch, spec_bl, params_bl, "bloom-7b1-paged",
                      dict(paged_gather_ctx_max=0), counters,
                      with_grpc=with_grpc, traffic=TRAFFIC_GEMMA,
                      details_waves=F4_DETAILS_WAVES, memory_check=True)
    for key in ("flash_prefill_alibi", "paged_decode_attention_alibi",
                "paged_decode_attention_stats_alibi"):
        if run10[key] <= 0:
            raise AssertionError(f"{key} never ran in serving run 10: {run10}")
    del params_bl
    mark("serving run 10")
    # run 11: mt0-xxl at full width and depth (random bf16 weights made on
    # the card) on the seq2seq engine behind the Batcher and gRPC, max_seq
    # 1024, 16 slots, at the default chunk (1) and on ring chunks of 8;
    # wave B's soft prompt has an encoder and a decoder side. The T5 path
    # reaches no Pallas counterpart: every kernel counter must stay 0
    spec_t5, params_t5 = t5_model(torch, "mt0-xxl", 11)
    s2s_modes = {"default": {}, "ring8": dict(decode_chunk=8)}
    run11 = {}
    with tempfile.TemporaryDirectory() as store:
        write_s2s_prefix_store(store, spec_t5.d_model)
        for label, kw in s2s_modes.items():
            run11[label] = serve_run(
                torch, spec_t5, params_t5, f"mt0-xxl-seq2seq-{label}",
                dict(kw, prefix_store_path=store), counters,
                with_grpc=with_grpc, traffic=TRAFFIC_MT0, max_seq=1024,
                prefixes=PREFIXES_MT0, seq2seq=True)
    for label, run in run11.items():
        launched = {k: run[k] for k in counters if run[k]}
        if launched:
            raise AssertionError(f"run 11 ({label}) launched {launched}")
    log("run 11: no kernel of the port launched (the T5 path is einsum and "
        "matmul, as in the JAX package)")
    mark("serving run 11")
    # the seq2seq decode programs: replay == eager bit for bit, at mt0-xxl's
    # widths cut to GRAPHS_MT0_LAYERS + GRAPHS_MT0_LAYERS layers (the time
    # limit; run 11 keeps all 24 + 24) then eager / graphs timing, and at
    # t5-large (v1.0: ReLU, tied head)
    del params_t5
    prof11 = {}
    for name, seed, cut in (("mt0-xxl", 11, GRAPHS_MT0_LAYERS),
                            ("t5-large", 12, None)):
        layers = ({} if cut is None else
                  dict(num_encoder_layers=cut, num_decoder_layers=cut))
        spec_t5, params_t5 = t5_model(torch, name, seed, **layers)
        for label, kw in s2s_modes.items():
            prof11[f"{name} {label}"] = graphs(
                torch, spec_t5, params_t5, f"{name} seq2seq {label}", card,
                kw, max_seq=1024, live=16, calls=4, seq2seq=True,
                timing=name == "mt0-xxl")
        del params_t5
        mark(f"graphs: {name} seq2seq")
    log(f"profile seq2seq: {json.dumps(prof11)}")
    # the prefill programs: replay == eager for every engine kind, eager
    # against graphs prefill timing, the graphs' pool against the plan
    prefill_report = prefill_phase(torch, card, counters)
    mark("prefill programs")

    # speculative decoding: exactness in fp32, the distilled measurement
    # and the bf16 streams, replay == eager for every verify program, verify
    # against plain decode at 7B widths (bf16 paged and slot, GPTQ-INT4 with
    # K1 at 64 rows), serving run 12
    spec_exactness(torch)
    mark("spec exactness")
    spec_report, _ = spec_measurement(torch)
    mark("spec measurement")
    params = random_params(torch, spec)
    for label, slot, kw in (("tinyllama paged ring8", False,
                             dict(decode_chunk=8)),
                            ("tinyllama slot", True, {})):
        spec_graphs(torch, spec, params, label, slot=slot, overrides=kw)
    del params
    mark("spec graphs")
    from text_generation_inference_tpu_torch.models.fuse import fuse_params

    spec7b = llama_spec(LLAMA7B)
    # fused as the engine fuses them: no unfused copy stays resident in
    # run 12 (its memory check)
    params7b = fuse_params(spec7b, random_params(torch, spec7b))
    spec7b16, params7b16 = first_layers(spec7b, params7b, 16)
    verify_parity(torch, spec7b16, params7b16, "verify parity 7b paged")
    verify_parity(torch, spec7b16, params7b16, "verify parity 7b slot",
                  slot=True)
    del params7b16
    spec4 = llama_spec(LLAMA7B, num_layers=4)
    gptq_verify = verify_parity(torch, spec4,
                                random_params(torch, spec4, gptq=True),
                                "verify parity 7b gptq", counters=counters)
    if gptq_verify["int4_matmul_s4_stacked"] != 4 * spec4.num_layers:
        raise AssertionError(f"K1 launches in the GPTQ verify: {gptq_verify}")
    mark("verify parity")
    run12, prof12 = serve_spec(torch, spec7b, params7b, counters, with_grpc,
                               card)
    del params7b
    mark("serving run 12")

    # int8 weights: parity, calibration and the outlier decomposition at 7B
    # widths; run 13 through generate.v1 over gRPC; the GPTQ solve
    int8_report = int8_parity(torch, counters)
    mark("int8 parity")
    if not with_grpc:
        raise AssertionError("run 13 serves generate.v1 over gRPC: grpc is "
                             "not installed")
    run13 = serve_internal(torch, counters, card)
    mark("serving run 13")
    gptq_report = gptq_solve(torch, card)
    mark("gptq solve")
    # tensor parallelism: the kernels at the rank-local shapes, world size
    # 1 over NCCL (decode captured with its collectives), world size 2 on
    # this card over gloo
    tp = tp_phase(torch, timer, card)
    mark("tp")

    runs = (run1, run2, run3, run4, run5, run6, run7, run8, run9, run10,
            *run11.values(), probe_counts, run12, gptq_verify, run13)

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
        # the split body's 3xTF32 kernel: the float32 model's decode steps
        # (the fp32 parity phase: per-step and ring-chunk) are its path
        dict(record("paged_decode_attention", "paged_attention.cu",
                    "paged_attention.py:261",
                    f32_decode["paged_decode_attention"],
                    "fp32, S=16, KV=4, G=8, D=64, page 128, ctx up to 2048"),
             name="paged_decode_attention_f32",
             launches=fp32_counts["paged_decode_attention"]),
        dict(record("paged_decode_attention_stats", "paged_attention.cu",
                    "paged_attention.py:407",
                    f32_decode["paged_decode_attention_stats"],
                    "fp32, S=16, KV=4, G=8, D=64, page 128, ctx up to 2048"),
             name="paged_decode_attention_stats_f32",
             launches=fp32_counts["paged_decode_attention_stats"]),
        # the wgmma body at D = 256: run 8's prefills (Gemma-7B)
        dict(record("flash_prefill", "flash_prefill.cu",
                    "flash_prefill.py:143", fp256,
                    "bf16, N=2, T=2048, lengths 1500/900, H=16, KV=16, "
                    "D=256 (gemma-7b)"),
             name="flash_prefill_d256", launches=run8["flash_prefill"]),
        # the window: run 7's prefills past Mistral's window, its decode
        # steps (S1 with lower bounds)
        dict(record("flash_prefill", "flash_prefill.cu",
                    "flash_prefill.py:143", fp_win,
                    "bf16, N=2, T=6144, lengths 6000/4500, H=32, KV=8, D=128, "
                    "window 4096, q x 4 (Mistral-7B, run 7's bucket)"),
             name="flash_prefill_window",
             launches=run7["flash_prefill_windowed"]),
        dict(record("decode_attention", "slot_attention.cu",
                    "decode_attention.py:142", s1_win,
                    "bf16, S=8, KV=8, G=4, D=128, T=8192, window 4096, ctx "
                    "RUN7_CTX (lower bounds 0-4096, six slots cut)"),
             name="decode_attention_window",
             launches=run7["decode_attention_windowed"]),
        # the split body at D = 96: gpt-neox-20b's decode steps in the
        # family parity phase
        dict(record("paged_decode_attention", "paged_attention.cu",
                    "paged_attention.py:261", pn96,
                    "bf16, S=16, KV=64, G=1, D=96, page 128, ctx up to 2048"),
             name="paged_decode_attention_d96",
             launches=fam_counts["gpt_neox"]["paged_decode_attention"]),
        # ALiBi: run 10's prefills and decode steps (BLOOM-7b1); S1 with
        # slopes in the family parity phase's BLOOM slot case
        dict(record("flash_prefill", "flash_prefill.cu",
                    "flash_prefill.py:143", fp_alibi,
                    "bf16, N=2, T=2048, lengths 2000/1500, H=32, KV=32, "
                    "D=128, ALiBi (bloom-7b1)"),
             name="flash_prefill_alibi",
             launches=run10["flash_prefill_alibi"]),
        dict(record("paged_decode_attention", "paged_attention.cu",
                    "paged_attention.py:261", pn_alibi,
                    "bf16, S=16, KV=32, G=1, D=128, page 128, ctx up to "
                    "2048, ALiBi (bloom-7b1)"),
             name="paged_decode_attention_alibi",
             launches=run10["paged_decode_attention_alibi"]),
        dict(record("paged_decode_attention_stats", "paged_attention.cu",
                    "paged_attention.py:407", ps_alibi,
                    "bf16, S=16, KV=32, G=1, D=128, page 128, ctx up to "
                    "2048, ALiBi (bloom-7b1)"),
             name="paged_decode_attention_stats_alibi",
             launches=run10["paged_decode_attention_stats_alibi"]),
        dict(record("decode_attention", "slot_attention.cu",
                    "decode_attention.py:142", s1_alibi,
                    "bf16, S=16, KV=32, G=1, D=128, T=2048, ALiBi "
                    "(bloom-7b1)"),
             name="decode_attention_alibi",
             launches=fam_counts["bloom_slot"]["decode_attention_alibi"]),
        # multi-query: run 9's prefills and decode steps (StarCoder)
        dict(record("flash_prefill", "flash_prefill.cu",
                    "flash_prefill.py:143", fp_mqa,
                    "bf16, N=2, T=2048, lengths 2000/1500, H=48, KV=1, "
                    "D=128 (starcoder)"),
             name="flash_prefill_mqa", launches=run9["flash_prefill"]),
        # Falcon-7B's 71 query heads over one kv head: the family parity
        # phase's falcon prefill
        dict(record("flash_prefill", "flash_prefill.cu",
                    "flash_prefill.py:143", fp_falcon,
                    "bf16, N=2, T=2048, lengths 2000/1500, H=71, KV=1, "
                    "D=64 (falcon-7b)"),
             name="flash_prefill_falcon",
             launches=fam_counts["falcon"]["flash_prefill"]),
        dict(record("paged_decode_attention", "paged_attention.cu",
                    "paged_attention.py:261", pn_mqa,
                    "bf16, S=16, KV=1, G=48, D=128, page 128, ctx up to "
                    "2048 (starcoder)"),
             name="paged_decode_attention_mqa",
             launches=run9["paged_decode_attention"]),
    ]
    # the tp phase's rank-local shapes (world size 2): launches over both
    # ranks' serving runs (StarCoder's: their token streams)
    tp_launches = {label: {k: sum(rec[label]["launches"][k]
                                  for rec in tp["ranks"])
                           for k in tp["ranks"][0][label]["launches"]}
                   for label in TP_KERNELS}
    tp_rows = (
        ("flash_prefill", "flash_prefill.cu", "flash_prefill.py:143",
         "flash_prefill",
         "bf16, N=2, T=2048, lengths 1500/900, H=16, KV=16, D=128 (a rank "
         "of Llama-2-7B at world size 2)",
         tp_launches["bf16"]["flash_prefill"]
         + tp_launches["gptq"]["flash_prefill"]),
        ("paged_decode_attention", "paged_attention.cu",
         "paged_attention.py:261", "paged_decode_attention",
         "bf16, S=16, KV=16, G=1, D=128, page 128 (a rank of Llama-2-7B)",
         tp_launches["bf16"]["paged_decode_attention"]),
        ("paged_decode_attention_stats", "paged_attention.cu",
         "paged_attention.py:407", "paged_decode_attention_stats",
         "bf16, S=16, KV=16, G=1, D=128, page 128 (a rank of Llama-2-7B)",
         tp_launches["bf16"]["paged_decode_attention_stats"]),
        ("paged_decode_attention_partial_i8", "paged_attention.cu",
         "paged_attention.py:153", "paged_decode_attention_partial_i8",
         "int8 pools, bf16 q, S=16, KV=16, G=1, D=128 (a rank of "
         "Llama-2-7B)", tp_launches["gptq"]
         ["paged_decode_attention_partial_i8"]),
        ("int4_matmul_s4_stacked", "int4_matmul.cu", "int4_matmul.py:453",
         "int4_matmul_s4_stacked",
         "bf16, the sum over a rank's shards of a 7B layer's 4 products "
         "(N 6144 / 4096 / 11008 / 4096, K 4096 / 2048 / 4096 / 5504) at "
         "M=16", tp_launches["gptq"]["int4_matmul_s4_stacked"]),
        ("int4_matmul", "int4_matmul.cu", "int4_matmul.py:637",
         "int4_matmul", "bf16, the same 4 shards at M=1024",
         tp_launches["gptq"]["int4_matmul"]),
        ("int4_mlp_s4_stacked", "int4_mlp.cu", "int4_matmul.py:366",
         "int4_mlp_s4_stacked",
         "bf16, a rank's shard of a 7B layer's MLP (H=4096, I=5504), silu, "
         "M=16", tp_launches["gptq"]["int4_mlp_s4_stacked"]),
        ("flash_prefill", "flash_prefill.cu", "flash_prefill.py:143",
         "flash_prefill_mqa",
         "bf16, N=2, T=2048, lengths 2000/1500, H=24, KV=1, D=128 (a rank "
         "of StarCoder)", tp_launches["starcoder"]["flash_prefill"]),
        ("paged_decode_attention", "paged_attention.cu",
         "paged_attention.py:261", "paged_decode_attention_mqa",
         "bf16, S=16, KV=1, G=24, D=128 (a rank of StarCoder)",
         tp_launches["starcoder"]["paged_decode_attention"]))
    for name, source, replaces, key, shapes, launches in tp_rows:
        res = {"library_ms": None, **tp["kernels"][key]}
        kernels.append(dict(record(name, source, replaces, res, shapes),
                            name=f"{key}_tp", launches=launches))
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
    log(f"flash_prefill window 512 (T=2048, H=32, KV=8, D=128): "
        f"{json.dumps(fp_win512)}")
    log(f"flash_prefill fp32 window 512: {json.dumps(fp_win_f32)}")
    log(f"paged_decode_attention_stats at D=96: {json.dumps(ps96)}")
    log(f"flash_prefill fp32 ALiBi (falcon-rw-1b heads): "
        f"{json.dumps(fp_alibi_f32)}")
    log(f"paged_decode_attention_partial_i8 ALiBi (bloom-7b1 widths): "
        f"{json.dumps(pi8_alibi)}")
    log(f"F4: run 8 graphs' pool {run8['graph_pool_bytes']} + transient "
        f"{run8['transient_bytes']} of the {run8['graph_pool_term']} bytes "
        f"of the plan's graph-pool term; run 10 {run10['graph_pool_bytes']} "
        f"+ {run10['transient_bytes']} of {run10['graph_pool_term']}")
    log(f"int8: {json.dumps(int8_report)}; run 13 "
        f"{json.dumps({k: v for k, v in run13.items() if v})}; gptq solve "
        f"{json.dumps(gptq_report)} on {card}")
    log(f"prefill programs: {json.dumps(prefill_report)}")
    log(f"speculative: run 12 {json.dumps({k: v for k, v in run12.items() if v})}; "
        f"the GPTQ verify's launches {json.dumps({k: v for k, v in gptq_verify.items() if v})}; "
        f"the distilled measurement {json.dumps(spec_report)}")
    log("launches: decode_attention in the serving runs, "
        "ring_decode_attention in the probe, int4_mlp_s4_stacked in run 6, "
        "flash_prefill_f32 and the paged _f32 rows in the fp32 parity "
        "phase, flash_prefill_d256 in "
        "run 8, flash_prefill_window and decode_attention_window in run 7, "
        "paged_decode_attention_d96 in the family parity phase (gpt_neox), "
        "the _alibi rows in run 10 (decode_attention_alibi: the family "
        "parity phase's BLOOM slot case), the _mqa rows in run 9; runs 12 "
        "and 13 and the GPTQ verify count in the first rows")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
