"""Ring-decode probe: one chunk of the slot engine's ring decode, with its
attention computed inline (the engine's formulation) or by the ring-decode
kernel S2 (`ops.cuda.ring_decode_attention`).

Port of the `ring_ctx<N>` and `ring_ctx<N>_kernel` modes of the JAX
package's `scripts/probe_decode.py`, which is that kernel's one caller
there; the engines keep the inline formulation.

    python -m text_generation_inference_tpu_torch.tools.probe_decode \\
        ring_ctx256 ring_ctx256_kernel ring_ctx1024 ring_ctx1024_kernel

  ring_ctx<N>         attention reads the first N cache rows (a context
                      bucket), the ring and the current token inline
  ring_ctx<N>_kernel  the same chunk with attention through S2

Each mode runs at TinyLlama-1.1B widths (22 layers unless `--layers` cuts
the depth) with random bf16 weights and a random cache from `--seed`: 48
slots, max_seq 1024, chunks of 64 steps, every slot at history 128. One
chunk runs first (it builds the kernels); its greedy ids are compared
between a mode and its `_kernel` twin: at the first step, where both saw
the same inputs, and as the number of steps a slot's ids agree before the
first difference (after one, the two runs feed different tokens). Then
`--calls` chunks are timed on the host clock around work that ends in a
synchronize. Prints one line per mode and, last, a JSON object {mode: ms
per step}, plus "<N>_first_step_ids_equal" (fraction of slots) and
"<N>_steps_agreeing" (mean over slots) for each pair.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from ..device import resolve_device
from ..models import core
from ..models.core import DecoderSpec, KVCache
from ..ops.attention import KERNELS

# TinyLlama-1.1B (config.json of TinyLlama/TinyLlama-1.1B-Chat-v1.0)
TINYLLAMA = DecoderSpec(vocab_size=32000, hidden_size=2048, num_layers=22,
                        num_heads=32, num_kv_heads=4, head_dim=64,
                        intermediate_size=5632, norm_eps=1e-5)


def parse_mode(mode: str) -> tuple[int, bool]:
    """'ring_ctx<N>[_kernel]' → (N, through the kernel)."""
    body = mode[len("ring_ctx"):] if mode.startswith("ring_ctx") else ""
    kernel = body.endswith("_kernel")
    body = body[:-len("_kernel")] if kernel else body
    if not body.isdigit():
        raise ValueError(f"unknown probe mode {mode!r} (ring_ctx<N>[_kernel])")
    return int(body), kernel


def random_params(spec: DecoderSpec, device, dtype, seed: int) -> dict:
    """Layer-stacked weights, scale 1/sqrt(fan_in), embeddings 0.02."""
    gen = torch.Generator(device=device).manual_seed(seed)
    L, D, F = spec.num_layers, spec.hidden_size, spec.intermediate_size

    def dense(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
        return (torch.randn(*shape, generator=gen, device=device) * scale
                ).to(dtype)

    ones = lambda *shape: torch.ones(*shape, dtype=dtype, device=device)
    return {
        "embed_tokens": dense(spec.vocab_size, D, scale=0.02),
        "layers": {
            "ln1": {"scale": ones(L, D)}, "ln2": {"scale": ones(L, D)},
            "wq": dense(L, D, spec.q_size), "wk": dense(L, D, spec.kv_size),
            "wv": dense(L, D, spec.kv_size), "wo": dense(L, spec.q_size, D),
            "w_gate": dense(L, D, F), "w_up": dense(L, D, F),
            "w_down": dense(L, F, D),
        },
        "final_norm": {"scale": ones(D)},
        "lm_head": dense(D, spec.vocab_size),
    }


def ring_chunk(spec: DecoderSpec, params: dict, cache: KVCache,
               history: torch.Tensor, history_len: torch.Tensor,
               read_rows: int, chunk: int, ring_attention=None):
    """One chunk of ring decode over every slot, greedy (argmax) ids; the
    cache READ side narrowed to `read_rows` rows, one flush at the end.
    Updates history / history_len / the cache in place; returns the ids
    [chunk, S]."""
    s, t_max = history.shape
    rows = torch.arange(s, device=history.device)
    read = KVCache(cache.k.narrow(3, 0, read_rows),
                   cache.v.narrow(3, 0, read_rows))
    chunk_start = torch.clamp(history_len - 1, 0, t_max - 1)
    kbuf = torch.zeros((spec.num_layers, s, spec.num_kv_heads, chunk,
                        spec.head_dim), dtype=cache.k.dtype,
                       device=cache.k.device)
    vbuf = torch.zeros_like(kbuf)
    out = []
    for i in range(chunk):
        pos = torch.clamp(history_len - 1, 0, t_max - 1)
        logits, k_all, v_all = core.decode_ring_step(
            spec, params, history[rows, pos.long()], pos, read, kbuf, vbuf, i,
            chunk_start, ring_attention=ring_attention)
        kbuf[:, :, :, i] = k_all.to(kbuf.dtype)
        vbuf[:, :, :, i] = v_all.to(vbuf.dtype)
        next_ids = torch.argmax(logits, dim=-1).to(torch.int32)
        history[rows, torch.clamp(history_len, max=t_max - 1).long()] = next_ids
        history_len.add_(1)
        out.append(next_ids)
    core.ring_flush(cache, kbuf, vbuf, chunk_start)
    return torch.stack(out)


def run_probe(modes, spec: DecoderSpec, params: dict, device, slots: int = 48,
              max_seq: int = 1024, chunk: int = 64, history: int = 128,
              calls: int = 2, seed: int = 0, log=print) -> dict:
    """Run each mode on a fresh copy of one random cache and history; see
    the module docstring. Returns {mode: ms per step, "<N>_ids_equal":
    "<N>_first_step_ids_equal", "<N>_steps_agreeing"}: see the module
    docstring."""
    device = torch.device(device)
    dtype = params["embed_tokens"].dtype
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (spec.num_layers, slots, spec.num_kv_heads, max_seq, spec.head_dim)
    k0 = torch.randn(shape, generator=gen, device=device).to(dtype)
    v0 = torch.randn(shape, generator=gen, device=device).to(dtype)
    hist0 = torch.randint(3, spec.vocab_size, (slots, max_seq), generator=gen,
                          device=device, dtype=torch.int32)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    results, first_ids = {}, {}
    for mode in modes:
        read_rows, kernel = parse_mode(mode)
        if not history <= read_rows <= max_seq:
            raise ValueError(f"{mode}: the context bucket must hold the "
                             f"history ({history}) within max_seq {max_seq}")
        cache = KVCache(k0.clone(), v0.clone())
        hist = hist0.clone()
        hlen = torch.full((slots,), history, dtype=torch.int32, device=device)
        fused = KERNELS.ring_decode if kernel else None
        first_ids[mode] = ring_chunk(spec, params, cache, hist, hlen,
                                     read_rows, chunk, fused).cpu()
        ctx = history + chunk                  # every slot's history, on host
        sync()
        t0 = time.perf_counter()
        for _ in range(calls):
            if ctx + chunk > read_rows:        # keep the chunk in the bucket
                hlen.fill_(history)
                ctx = history
            ring_chunk(spec, params, cache, hist, hlen, read_rows, chunk,
                       fused)
            ctx += chunk
        sync()
        ms = (time.perf_counter() - t0) / (calls * chunk) * 1e3
        results[mode] = ms
        log(f"probe {mode}: {ms:.3f} ms/step ({slots} slots, {read_rows} "
            f"cache rows, chunk {chunk}, {spec.num_layers} layers)")
    for mode in modes:
        read_rows, kernel = parse_mode(mode)
        twin = f"ring_ctx{read_rows}"
        if kernel and twin in first_ids:
            same = first_ids[mode] == first_ids[twin]           # [chunk, S]
            first = same[0].float().mean().item()
            # steps each slot agrees before its first difference
            agreeing = torch.cumprod(same.int(), dim=0).sum(0)
            steps = agreeing.float().mean().item()
            results[f"{read_rows}_first_step_ids_equal"] = first
            results[f"{read_rows}_steps_agreeing"] = steps
            log(f"probe ring_ctx{read_rows}: inline vs kernel greedy ids "
                f"equal at the first step in {first:.4f} of the slots; a "
                f"slot agrees for {steps:.1f} of {chunk} steps on average")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("modes", nargs="+")
    ap.add_argument("--layers", type=int, default=TINYLLAMA.num_layers)
    ap.add_argument("--slots", type=int, default=48)
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--history", type=int, default=128)
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    spec = DecoderSpec(**{**TINYLLAMA.__dict__, "num_layers": args.layers})
    params = random_params(spec, device, dtype, args.seed)
    results = run_probe(args.modes, spec, params, device, slots=args.slots,
                        max_seq=args.max_seq, chunk=args.chunk,
                        history=args.history, calls=args.calls, seed=args.seed,
                        log=lambda m: print(m, file=sys.stderr))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
