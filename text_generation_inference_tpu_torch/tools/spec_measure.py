"""Speculative decoding with a distilled speculator: acceptance and speed.

The port's counterpart of the JAX package's `scripts/spec_measure.py`. A
random-init speculator accepts about nothing, so this makes one that the
model agrees with, on the spot, from the model alone (nothing is
downloaded), then measures it:

  1. greedy paths: the plain paged engine decodes 512 seeded prompts;
     one `core.prefill(return_hidden=True)` over each prompt + continuation
     gives the final-norm hidden state at every position of the greedy
     path (the states the speculator sees while serving);
  2. distill a 1-step MLPSpeculator (torch autograd, `torch.optim.Adam`,
     weights from a seeded generator) on (hidden at t, the token emitted
     at t) -> the token emitted at t + 1, the model's own next argmax (the
     fms_extras training objective), for at most `--seconds`;
  3. run the plain paged engine and `PagedSpeculativeEngine` with the
     distilled speculator on the same 8 held-out greedy prompts, all at
     once, in turns plain, speculative, speculative, plain.

    python -m text_generation_inference_tpu_torch.tools.spec_measure \\
        [--layers 22] [--seconds 60] [--device cuda]

Reports one JSON object: the acceptance rate (accepted drafts over the
drafts of the live slots' speculative steps), tokens per model call (a
request's decoded tokens over the dispatches), speculative and plain tok/s
(host clock around work that ends in a synchronize), their speedup, the
distillation's steps, seconds and agreement on held-out paths, and the
device.

The model is TinyLlama-1.1B's widths with random bf16 weights on the card
(fp32 on the CPU) from `--seed`, made predictable (`predictable_params`):
token embeddings at unit scale and the layers' output projections (wo,
w_down) scaled by 0.1, so that the residual stream is mostly
the current token's embedding and the next token depends mostly on it, as
a trained model's often does. At the usual random init (embeddings 0.02,
every linear 1/sqrt(fan_in)) the greedy next token is a chaotic function
of the whole context, and a speculator distilled as here agrees with it on
about 1% of held-out tokens (a 4-layer, 256-wide model on the CPU); at 22
layers a layer scale of 0.3 still leaves the context in charge (12% on an
NVIDIA H100 80GB HBM3, 700 W).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ServingConfig
from ..device import resolve_device
from ..engine.engine import RequestParams
from ..engine.paged_engine import PagedInferenceEngine
from ..engine.speculative import PagedSpeculativeEngine
from ..models import core
from ..models.core import DecoderSpec, KVCache
from ..models.speculator import SpeculatorSpec
from .probe_decode import TINYLLAMA, random_params


def predictable_params(spec: DecoderSpec, device, dtype, seed: int,
                       layer_scale: float = 0.1) -> dict:
    """`probe_decode.random_params` with unit-scale token embeddings and wo
    / w_down scaled by `layer_scale` (see the module docstring)."""
    params = random_params(spec, device, dtype, seed)
    params["embed_tokens"].mul_(50.0)                 # 0.02 -> 1.0
    params["layers"]["wo"].mul_(layer_scale)
    params["layers"]["w_down"].mul_(layer_scale)
    return params


def make_config(max_seq: int, slots: int) -> ServingConfig:
    cfg = ServingConfig(max_sequence_length=max_seq, max_new_tokens=max_seq,
                        max_batch_slots=slots, kv_page_size=128,
                        prefill_buckets=[128, 256, 512])
    cfg.validate()
    return cfg


def decode_all(engine, prompts, n: int, want_details: bool = False,
               rps=None):
    """Prefill every prompt at once (greedy, or with `rps`), decode until
    each has n tokens. Returns (token lists, dispatches, seconds, and with
    `want_details` each token's two highest scores, else None)."""
    slots = [engine.acquire_slot() for _ in prompts]
    rps = rps or [RequestParams(max_new_tokens=n)] * len(prompts)
    t0 = time.monotonic()
    res = engine.prefill(slots, prompts, rps)
    toks = {s: [int(res.first_token.next_ids[i])] for i, s in enumerate(slots)}
    top2 = {s: [res.first_token.top_scores[i, :2].tolist()]
            for i, s in enumerate(slots)}
    calls = 0
    while min(len(t) for t in toks.values()) < n:
        steps = engine.decode_steps(want_details=want_details)
        calls += 1
        ne = engine.last_n_emitted
        for s in slots:
            k = len(steps) if ne is None else int(ne[s])
            toks[s].extend(int(steps[j].next_ids[s]) for j in range(k))
            top2[s].extend(steps[j].top_scores[s, :2].tolist()
                           for j in range(k))
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    seconds = time.monotonic() - t0
    for s in slots:
        engine.free(s)
    return ([toks[s][:n] for s in slots], calls, seconds,
            [top2[s][:n] for s in slots] if want_details else None)


def greedy_paths(spec: DecoderSpec, params: dict, engine, prompts, n: int):
    """(hidden [P, D], emitted token [P], next token [P]) along the greedy
    paths of `prompts`, `engine.num_slots` prompts at a time: the hidden
    state after reading the token emitted at t, that token, and the token
    emitted at t + 1."""
    parts = [_greedy_pairs(spec, params, engine,
                           prompts[i:i + engine.num_slots], n)
             for i in range(0, len(prompts), engine.num_slots)]
    return tuple(torch.cat(x) for x in zip(*parts))


def _greedy_pairs(spec, params, engine, prompts, n):
    paths = decode_all(engine, prompts, n)[0]
    seqs = [p + t for p, t in zip(prompts, paths)]
    # a whole number of flash prefill's 128-row tiles
    length = -(-max(len(s) for s in seqs) // 128) * 128
    ids = torch.zeros((len(seqs), length), dtype=torch.int32,
                      device=engine.device)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = torch.tensor(s, dtype=torch.int32)
    lengths = torch.tensor([len(s) for s in seqs], dtype=torch.int32,
                           device=engine.device)
    cache = KVCache.create(spec, len(seqs), length, params["embed_tokens"].dtype,
                           engine.device)
    with torch.no_grad():
        _, hidden, _ = core.prefill(spec, params, ids, lengths,
                                    torch.arange(len(seqs), dtype=torch.int32,
                                                 device=engine.device),
                                    cache, return_hidden=True)
    h, tok, nxt = [], [], []
    for i, p in enumerate(prompts):
        # positions p-1 .. p+n-2 emit paths[i][0 .. n-1]
        lo, hi = len(p) - 1, len(p) + n - 2
        h.append(hidden[i, lo:hi])
        tok.append(torch.tensor(paths[i][:-1]))
        nxt.append(torch.tensor(paths[i][1:]))
    dev = engine.device
    return (torch.cat(h).to(torch.float32), torch.cat(tok).long().to(dev),
            torch.cat(nxt).long().to(dev))


def spec_logits(w: dict, h: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """The 1-step speculator's logits (`models.speculator.propose`'s math)."""
    z = h @ w["w_state"] + w["emb"][tok]
    z = F.layer_norm(z, z.shape[-1:], w["ln_scale"], w["ln_bias"], eps=1e-6)
    return F.gelu(z, approximate="tanh") @ w["head"]


def distill(spec: DecoderSpec, data, test_data, inner_dim: int,
            seconds: float, max_steps: int = 100000, batch: int = 1024,
            lr: float = 3e-3, seed: int = 0):
    """Train a 1-step speculator on `data` (see `greedy_paths`) for at most
    `seconds` or `max_steps`; its agreement with the model is measured on
    `test_data`, the paths of other prompts. Returns (SpeculatorSpec, f32
    params, {steps, seconds, heldout_agreement})."""
    h, tok, nxt = data
    dev = h.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, v = spec.hidden_size, spec.vocab_size

    def normal(*shape, scale):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                ).requires_grad_()

    w = {"emb": normal(v, inner_dim, scale=0.02),
         "w_state": normal(d, inner_dim, scale=1 / math.sqrt(d)),
         "ln_scale": torch.ones(inner_dim, device=dev, requires_grad=True),
         "ln_bias": torch.zeros(inner_dim, device=dev, requires_grad=True),
         "head": normal(inner_dim, v, scale=1 / math.sqrt(inner_dim))}
    opt = torch.optim.Adam(list(w.values()), lr=lr)
    t0 = time.monotonic()
    steps = 0
    while steps < max_steps and time.monotonic() - t0 < seconds:
        idx = torch.randint(h.shape[0], (batch,), generator=gen, device=dev)
        loss = F.cross_entropy(spec_logits(w, h[idx], tok[idx]), nxt[idx])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        steps += 1
    with torch.no_grad():
        th, ttok, tnxt = test_data
        agree = (spec_logits(w, th, ttok).argmax(-1)
                 == tnxt).float().mean().item()
    elapsed = time.monotonic() - t0
    sspec = SpeculatorSpec(vocab_size=v, model_dim=d, inner_dim=inner_dim,
                           n_predict=1)
    params = {k: [t.detach()] for k, t in w.items()}
    return sspec, params, dict(steps=steps, seconds=elapsed,
                               heldout_agreement=agree)


def measure(spec: DecoderSpec, params: dict, device, seconds: float = 60.0,
            paths: int = 512, path_tokens: int = 128, path_slots: int = 64,
            live: int = 8, new_tokens: int = 64, prompt_len: int = 64,
            seed: int = 0, log=print) -> dict:
    """Steps 1-3 of the module docstring; returns the report, with under
    "streams" the held-out prompts, the plain and the speculative token
    lists and the plain engine's two highest scores at each token (from one
    more plain run with details), and under "speculator" the distilled
    (SpeculatorSpec, params), for the caller's checks."""
    device = torch.device(device)
    dtype = params["embed_tokens"].dtype
    max_seq = 512
    rng = np.random.default_rng(seed)

    def prompts(k):
        return [[int(x) for x in rng.integers(3, spec.vocab_size, prompt_len)]
                for _ in range(k)]

    pages = -(-max_seq // 128) * max(path_slots, live)
    plain = PagedInferenceEngine(spec, params,
                                 make_config(max_seq, path_slots),
                                 eos_token_id=2, num_pages=pages,
                                 device=device)
    t0 = time.monotonic()
    data = greedy_paths(spec, params, plain, prompts(paths), path_tokens)
    test_data = greedy_paths(spec, params, plain,
                             prompts(max(1, paths // 8)), path_tokens)
    paths_s = time.monotonic() - t0
    sspec, f32_params, fit = distill(spec, data, test_data,
                                     max(spec.hidden_size // 2, 64), seconds,
                                     seed=seed)
    sparams = {k: [t.to(dtype) for t in v] for k, v in f32_params.items()}
    log(f"spec_measure: greedy paths {paths} x {path_tokens} tokens in "
        f"{paths_s:.1f}s; distilled {fit['steps']} steps in "
        f"{fit['seconds']:.1f}s, held-out agreement "
        f"{fit['heldout_agreement']:.4f}")
    del plain
    cfg = make_config(max_seq, live)
    engines = {
        "plain": PagedInferenceEngine(spec, params, cfg, eos_token_id=2,
                                      num_pages=pages, device=device),
        "speculative": PagedSpeculativeEngine(
            spec, params, make_config(max_seq, live), eos_token_id=2,
            num_pages=pages, speculator_spec=sspec, speculator_params=sparams,
            max_spec_batch=live, device=device)}
    for e in engines.values():
        e.warmup(batch_sizes=(1,))
    held_out = prompts(live)
    runs = {"plain": [], "speculative": []}
    streams = {}
    spec_engine = engines["speculative"]
    for turn in ("plain", "speculative", "speculative", "plain"):
        if turn == "speculative":
            spec_engine.accepted_histogram[:] = 0
            spec_engine.spec_steps = spec_engine.fallback_steps = 0
        toks, calls, secs, _ = decode_all(engines[turn], held_out,
                                          new_tokens)
        runs[turn].append((calls, secs))
        streams[turn] = toks
    streams["plain_top2"] = decode_all(engines["plain"], held_out,
                                       new_tokens, want_details=True)[3]
    streams["prompts"] = held_out
    hist = spec_engine.accepted_histogram
    steps_slots = int(hist.sum())
    accepted = int(sum(max(0, i - 1) * c for i, c in enumerate(hist)))
    decoded = live * (new_tokens - 1)
    plain_tps = decoded / np.mean([s for _, s in runs["plain"]])
    spec_tps = decoded / np.mean([s for _, s in runs["speculative"]])
    report = {
        "acceptance_rate": accepted / max(1, steps_slots * sspec.n_predict),
        "tokens_per_model_call": (new_tokens - 1) / np.mean(
            [c for c, _ in runs["speculative"]]),
        "speculative_tok_s": spec_tps, "plain_tok_s": plain_tps,
        "speedup": spec_tps / plain_tps,
        "accepted_histogram": hist.tolist(),
        "fallback_steps": spec_engine.fallback_steps,
        "distill": dict(fit, paths=paths, path_tokens=path_tokens,
                        paths_s=paths_s),
        "setup": dict(layers=spec.num_layers, hidden=spec.hidden_size,
                      live=live, prompt_len=prompt_len, new_tokens=new_tokens,
                      dtype=str(dtype), inner_dim=sspec.inner_dim),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    report["streams"] = streams
    report["speculator"] = (sspec, sparams)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=TINYLLAMA.num_layers)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    spec = DecoderSpec(**{**TINYLLAMA.__dict__, "num_layers": args.layers})
    params = predictable_params(spec, device, dtype, args.seed)
    report = measure(spec, params, device, seconds=args.seconds,
                     seed=args.seed, log=lambda m: print(m, file=sys.stderr))
    report.pop("streams")
    report.pop("speculator")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
