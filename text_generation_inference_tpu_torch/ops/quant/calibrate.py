"""Activation calibration for the static LLM.int8 decomposition (port of the
JAX package's `ops/quant/calibrate.py`).

bitsandbytes picks the matmul columns whose activation magnitude passes a
threshold (6.0) per batch; here a short calibration forward records each
linear's per-input-feature activation absmax once, at load time, and the
outlier features are fixed from it (`pick_outlier_features`; their weight
rows stay bf16 in `int8.Int8OutlierWeight`).

The collection (`tapped_forward`, which `quality.py` shares for its GPTQ
Hessians) runs the decoder one layer at a time with the port's
`ops.linear.matmul` tapped, so every linear's true input is observed (the
post-norm residual stream, the attention output, the activated MLP
hidden), as the JAX package taps `linops.matmul`. Attention goes through
the port's prefill dispatch (`ops.attention.KERNELS`), so on the card a
calibration prompt of 128 tokens or more with a head dim that is a
multiple of 64 runs flash prefill.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from .. import linear as linops
from .int8 import LINEAR_KEYS


@torch.no_grad()
def tapped_forward(spec, params: dict, ids, lengths,
                   record: Callable[[int, str, torch.Tensor], None]) -> None:
    """The decoder's causal forward over right-padded ids [N, T], one layer
    at a time, calling `record(layer, linear_key, x)` with the input of
    every linear of params["layers"] (x: [N, T, in]) as the product runs.
    `lengths` ([N], or None for full rows) masks the keys past each row's
    length."""
    from ...models import core
    from ..attention import KERNELS

    dev = params["embed_tokens"].device
    ids = torch.as_tensor(ids).to(device=dev, dtype=torch.int32)
    n, t = ids.shape
    if lengths is None:
        lengths = torch.full((n,), t, dtype=torch.int32, device=dev)
    lengths = torch.as_tensor(lengths).to(device=dev, dtype=torch.int32)
    positions = torch.arange(t, dtype=torch.int32, device=dev)[None].expand(n, t)
    x = core._embed(spec, params, ids, positions)
    rope = core._rotary(spec, positions)
    slopes = core.alibi_slopes_kg(spec, dev)
    causal = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
    key_valid = positions < lengths[:, None]
    mask = causal[None] & key_valid[:, None, :]
    scale = 1.0 / math.sqrt(spec.head_dim)
    group = spec.num_heads // spec.num_kv_heads

    # the tap knows a linear by the weight object the call used: each
    # layer's views are made once, so every weight of the layer has its own
    key_of: dict[int, str] = {}
    li = 0
    orig_matmul = linops.matmul

    def tap(xin, w):
        k = key_of.get(id(w))
        if k is not None:
            record(li, k, xin)
        return orig_matmul(xin, w)

    linops.matmul = tap
    try:
        for li in range(spec.num_layers):
            lp = core.layer_params(params["layers"], li)
            key_of.clear()
            key_of.update((id(lp[k]), k) for k in LINEAR_KEYS if k in lp)
            h = core._norm(spec, lp["ln1"], x)
            q, k_, v = core._qkv(spec, lp, h)
            q, k_ = core._rotate(spec, q, k_, rope)
            qg = q.reshape(n, t, spec.num_kv_heads, group, spec.head_dim)
            a = KERNELS.prefill(qg, k_, v, lengths, slopes, mask, scale, 0)
            a = core._attn_out(spec, lp, a.reshape(n, t, spec.num_heads,
                                                   spec.head_dim))
            x = core._residual(spec, lp, x, a)
    finally:
        linops.matmul = orig_matmul


def collect_linear_input_absmax(spec, params: dict, ids,
                                lengths=None) -> dict[str, np.ndarray]:
    """Run a calibration forward (full causal attention) and record, for
    every stacked linear key in params["layers"], the per-input-feature
    activation absmax.

    ids: [N, T] integer calibration prompts (right-padded; padding positions
    count in the stats, as in bitsandbytes' whole-batch view). Returns
    {linear_key: [L, in_features] float32}."""
    found: dict[str, list] = {}

    def record(li, k, xin):
        am = torch.amax(torch.abs(xin.to(torch.float32)).reshape(
            -1, xin.shape[-1]), dim=0)
        per = found.setdefault(k, [None] * spec.num_layers)
        per[li] = am if per[li] is None else torch.maximum(per[li], am)

    tapped_forward(spec, params, ids, lengths, record)
    return {k: torch.stack(per).cpu().numpy() for k, per in found.items()}


def pick_outlier_features(absmax: np.ndarray, threshold: float = 6.0,
                          min_k: int = 0, max_frac: float = 1 / 32,
                          k: Optional[int] = None) -> np.ndarray:
    """Each layer's outlier input features from the calibration absmax
    [L, in] (the JAX package's rule): a feature is an outlier when its
    absmax passes `threshold`; one K serves the whole stack, the largest
    per-layer count clamped to [min_k, max_frac * in], and layers with fewer
    outliers fill up with their next-largest features (the decomposition is
    exact for any feature set). A stable sort keeps JAX's pick among ties.
    Returns [L, K] int32; K == 0 means no decomposition."""
    absmax = np.asarray(absmax, np.float32)
    l, in_f = absmax.shape
    if k is None:
        counts = (absmax > threshold).sum(axis=1)
        k = int(counts.max(initial=0))
        k = max(k, min_k)
        k = min(k, max(1, int(in_f * max_frac)))
    if k <= 0:
        return np.zeros((l, 0), np.int32)
    idx = torch.sort(torch.from_numpy(-absmax), dim=1, stable=True).indices
    return np.ascontiguousarray(idx[:, :k].numpy().astype(np.int32))
