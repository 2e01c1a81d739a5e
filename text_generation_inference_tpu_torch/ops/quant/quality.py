"""Quantization-quality metrics over the port's own forward passes (port of
the JAX package's `ops/quant/quality.py`):

  * `perplexity(spec, params, corpus)`: exp(mean NLL) of the corpus,
    teacher-forced, all positions in one prefill pass;
  * `mean_token_kl(spec, params_fp, params_q, corpus)`: the mean over
    positions of KL(fp || quantized) between next-token distributions, a
    fidelity measure that means something even for random-weight models;
  * `kv_cache_kl(spec, params, corpus)`: the same KL between an fp32 KV
    cache and an int8 one, over teacher-forced ring-decode steps (the
    production int8 read path);
  * `gptq_quantize_params(spec, params, corpus)`: GPTQ on every stacked
    linear of an in-memory param dict, with Hessians from the corpus'
    activations (the model-level counterpart of `gptq_quantize.
    quantize_model`).

Every forward runs on the params' device through `models/core.py` and the
attention dispatch (`ops.attention.KERNELS`).
"""

from __future__ import annotations

import numpy as np
import torch

from ...models import core
from ...models.core import DecoderSpec, KVCache


def _padded(corpus: list[list[int]]) -> tuple[np.ndarray, np.ndarray]:
    n, t = len(corpus), max(len(c) for c in corpus)
    ids = np.zeros((n, t), np.int32)
    lengths = np.zeros((n,), np.int32)
    for i, c in enumerate(corpus):
        ids[i, : len(c)] = c
        lengths[i] = len(c)
    return ids, lengths


@torch.no_grad()
def _all_log_probs(spec: DecoderSpec, params: dict,
                   corpus: list[list[int]]) -> torch.Tensor:
    """Teacher-forced next-token log-probabilities [N, T, V] (f32) of every
    corpus row, in one padded prefill."""
    dev = params["embed_tokens"].device
    ids, lengths = _padded(corpus)
    n, t = ids.shape
    cache = KVCache.create(spec, n, t, torch.float32, dev)
    logits, _ = core.prefill(
        spec, params, torch.from_numpy(ids).to(dev),
        torch.from_numpy(lengths).to(dev),
        torch.arange(n, dtype=torch.int32, device=dev), cache)
    return torch.log_softmax(logits.to(torch.float32), dim=-1)


def perplexity(spec: DecoderSpec, params: dict,
               corpus: list[list[int]]) -> float:
    """exp(mean NLL) of next-token prediction over the corpus."""
    logp = _all_log_probs(spec, params, corpus).cpu().numpy()
    total, count = 0.0, 0
    for i, c in enumerate(corpus):
        for j in range(len(c) - 1):
            total += -logp[i, j, c[j + 1]]
            count += 1
    return float(np.exp(total / max(count, 1)))


def _mean_kl(lp_fp: torch.Tensor, lp_q: torch.Tensor,
             mask: torch.Tensor) -> float:
    kl = torch.sum(torch.exp(lp_fp) * (lp_fp - lp_q), dim=-1)
    return float(torch.sum(torch.where(mask, kl, 0.0)) / torch.sum(mask))


def mean_token_kl(spec: DecoderSpec, params_fp: dict, params_q: dict,
                  corpus: list[list[int]]) -> float:
    """Mean KL(fp || quantized) between next-token distributions, over all
    positions of the corpus."""
    lp_fp = _all_log_probs(spec, params_fp, corpus)
    lp_q = _all_log_probs(spec, params_q, corpus)
    _, lengths = _padded(corpus)
    pos = torch.arange(lp_fp.shape[1], device=lp_fp.device)
    mask = pos[None, :] < torch.from_numpy(lengths).to(lp_fp.device)[:, None] - 1
    return _mean_kl(lp_fp, lp_q, mask)


@torch.no_grad()
def kv_cache_kl(spec: DecoderSpec, params: dict,
                corpus: list[list[int]], split: float = 0.75) -> float:
    """Decode-path fidelity of the int8 KV cache: mean KL(fp-cache ||
    int8-cache) over teacher-forced decode logits.

    Each row's first `split` of the shortest row's length is prefilled
    (an int8 cache quantizes those K/V at the write), then the following
    tokens are decoded teacher-forced through the ring-decode step (the
    int8 read path folds the scales into the scores and values), against
    the same run over an fp32 cache."""
    n = len(corpus)
    t = max(len(c) for c in corpus)
    shortest = min(len(c) for c in corpus)
    cut = max(2, int(shortest * split))
    cut = min(cut, shortest - 1)     # always leave a teacher-forced step
    m = shortest - cut               # teacher-forced steps
    if m < 1:
        raise ValueError(
            f"kv_cache_kl: shortest corpus row ({shortest} tokens) leaves no "
            f"teacher-forced steps after the prefill split (cut={cut}); "
            "need rows of >= 3 tokens")
    dev = params["embed_tokens"].device
    ids, _ = _padded(corpus)
    ids_t = torch.from_numpy(ids).to(dev)
    slots = torch.arange(n, dtype=torch.int32, device=dev)
    lengths = torch.full((n,), cut, dtype=torch.int32, device=dev)

    def run(cache_dtype):
        cache = KVCache.create(spec, n, t, cache_dtype, dev)
        _, cache = core.prefill(spec, params, ids_t[:, :cut], lengths, slots,
                                cache)
        chunk_start = torch.full((n,), cut, dtype=torch.int32, device=dev)
        kbuf = torch.zeros((spec.num_layers, n, spec.num_kv_heads, m,
                            spec.head_dim), dtype=torch.float32, device=dev)
        vbuf = torch.zeros_like(kbuf)
        out = []
        for i in range(m):
            pos = cut + i     # the teacher token at pos; ring col i holds it
            logits, k_all, v_all = core.decode_ring_step(
                spec, params, ids_t[:, pos],
                torch.full((n,), pos, dtype=torch.int32, device=dev),
                cache, kbuf, vbuf, i, chunk_start)
            kbuf[:, :, :, i] = k_all.to(kbuf.dtype)
            vbuf[:, :, :, i] = v_all.to(vbuf.dtype)
            out.append(logits)
        return torch.log_softmax(torch.stack(out).to(torch.float32), dim=-1)

    lp_fp = run(torch.float32)
    lp_q = run(torch.int8)
    kl = torch.sum(torch.exp(lp_fp) * (lp_fp - lp_q), dim=-1)
    return float(torch.mean(kl))


def gptq_quantize_params(spec: DecoderSpec, params: dict,
                         corpus: list[list[int]], groupsize: int = 128,
                         act_order: bool = False) -> dict:
    """GPTQ-quantize every stacked linear tensor of a params dict with
    Hessians from the corpus' activations; the solves run on the params'
    device."""
    from . import int4 as q4
    from .gptq_quantize import gptq_quantize_weight
    from .int8 import LINEAR_KEYS

    dev = params["embed_tokens"].device
    lp = dict(params["layers"])
    acts = _capture_linear_inputs(spec, params, corpus)
    for name in list(lp):
        if name not in LINEAR_KEYS or not isinstance(lp[name], torch.Tensor):
            continue
        w = lp[name].to(torch.float32)                  # [L, in, out]
        per = []
        for li in range(spec.num_layers):
            x = acts[name][li]                          # [tokens, in] f32
            h = (2.0 * (x.T @ x)).to(torch.float64)
            qw, qz, sc, gi = gptq_quantize_weight(
                w[li].T, h, bits=4, groupsize=groupsize,
                act_order=act_order, device=dev)
            per.append(q4.normalize_act_order(qw, qz, sc, gi))
        perm = None
        if any(p.perm is not None for p in per):
            perm = torch.stack([
                p.perm if p.perm is not None
                else torch.arange(p.in_features, dtype=torch.int32,
                                  device=dev) for p in per])
        lp[name] = q4.Int4Weight(
            qweight=torch.stack([p.qweight for p in per]),
            qzeros=torch.stack([p.qzeros for p in per]),
            scales=torch.stack([p.scales for p in per]),
            g_idx=torch.stack([p.g_idx for p in per]),
            perm=perm,
            zbias=torch.stack([p.zbias for p in per]))
    return dict(params, layers=lp)


def _capture_linear_inputs(spec: DecoderSpec, params: dict,
                           corpus: list[list[int]]) -> dict:
    """Per linear key, per layer, the input activations at the corpus' real
    positions, [tokens, in] f32: the GPTQ Hessians' source (a teacher-
    forced pass through `calibrate.tapped_forward`)."""
    from .calibrate import tapped_forward

    ids, lengths = _padded(corpus)
    valid = torch.from_numpy(
        np.arange(ids.shape[1])[None, :] < lengths[:, None]).to(
            params["embed_tokens"].device)
    acts: dict[str, list] = {}

    def record(li, k, xin):
        acts.setdefault(k, [None] * spec.num_layers)[li] = \
            xin[valid].to(torch.float32)

    tapped_forward(spec, params, ids, lengths, record)
    return acts
