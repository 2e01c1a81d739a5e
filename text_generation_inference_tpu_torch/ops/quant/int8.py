"""INT8 weight-only quantization (port of the JAX package's
`ops/quant/int8.py`: the reference's bitsandbytes-int8 slot).

Weights are quantized at load time, per output channel, symmetric absmax:
`Int8Weight` holds int8 codes [(L,) in, out] and f32 scales [(L,) out].
`Int8OutlierWeight` is the static LLM.int8 decomposition: the input
features named by `outlier_idx` (fixed at load time by a calibration
forward, `calibrate.py`) keep their weight rows in bf16 in `outlier_w`,
those rows are zeroed in `q`, and the scales are computed on the
outlier-free rest, so x @ W == x @ (q * scale) + x[..., idx] @ outlier_w
for any feature set.

The product follows the JAX package's numerics exactly: x and the codes
are cast to bf16 whatever the model's dtype, the product accumulates in
f32, the scale multiplies the f32 result, and only then is it cast to x's
dtype (the outlier term is a bf16 x bf16 product into f32 too). So an fp32
model's int8 product rounds x to bf16, as in JAX. The two devices get
that f32 result differently:

  * on the card, the codes are converted to a bf16 copy of the layer's
    weight and `torch.mm(..., out_dtype=torch.float32)` returns the f32
    accumulator (a bf16 `torch.matmul` would round it to bf16 before the
    scale). XLA converts on read instead; this copy is the port's own
    transient, which `engine.memory.quant_transient_bytes` plans for;
  * on the CPU, `torch.mm` on f32 copies of the bf16 operands: each
    product of two bf16 values is exact in f32, so this is the same f32
    accumulation.

No hand-written kernel runs here: the JAX product is a plain XLA dot
outside any Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Int8Weight(NamedTuple):
    """Per-output-channel symmetric int8 weight, optionally layer-stacked:
    q [(L,) in, out] int8; scale [(L,) out] f32."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def in_features(self) -> int:
        return self.q.shape[-2]

    @property
    def out_features(self) -> int:
        return self.q.shape[-1]


class Int8OutlierWeight(NamedTuple):
    """Int8Weight plus the static mixed-precision outlier decomposition:
    q [(L,) in, out] int8 (outlier rows zero); scale [(L,) out] f32;
    outlier_idx [(L,) K] int32; outlier_w [(L,) K, out] bf16."""

    q: torch.Tensor
    scale: torch.Tensor
    outlier_idx: torch.Tensor
    outlier_w: torch.Tensor

    @property
    def in_features(self) -> int:
        return self.q.shape[-2]

    @property
    def out_features(self) -> int:
        return self.q.shape[-1]


def _quantize_f32(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[in, out] f32 → (int8 codes, [out] f32 scale). `torch.round` rounds
    half to even, as `jnp.round` does."""
    absmax = torch.amax(torch.abs(w), dim=-2, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0, :]


def quantize_int8(weight: torch.Tensor) -> Int8Weight:
    """[(L,) in, out] float → Int8Weight on weight's device. A stack
    converts to f32 one layer at a time (the whole f32 stack of a 7B fused
    w_gu would take 11.5 GB)."""
    if weight.dim() == 2:
        return Int8Weight(*_quantize_f32(weight.to(torch.float32)))
    parts = [_quantize_f32(w.to(torch.float32)) for w in weight]
    return Int8Weight(*(torch.stack(f) for f in zip(*parts)))


def dequantize_int8(w: Int8Weight, dtype=torch.bfloat16) -> torch.Tensor:
    return (w.q.to(torch.float32)
            * w.scale[..., None, :].to(torch.float32)).to(dtype)


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for bf16 a [M, in] and b [in, out] (b in bf16 or int8 codes,
    exact in bf16), accumulated and returned in f32."""
    if a.device.type == "cuda":
        return torch.mm(a, b.to(torch.bfloat16), out_dtype=torch.float32)
    return torch.mm(a.to(torch.float32), b.to(torch.bfloat16).to(torch.float32))


def matmul_int8(x: torch.Tensor, w: Int8Weight) -> torch.Tensor:
    """x @ dequant(w) with the scale applied on the f32 [.., out] result.
    x: [..., in] → [..., out] in x's dtype."""
    x2 = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
    y = _product_f32(x2, w.q) * w.scale.to(torch.float32)
    return y.to(x.dtype).reshape(*x.shape[:-1], w.out_features)


def quantize_int8_outliers(weight: torch.Tensor,
                           outlier_idx) -> Int8OutlierWeight:
    """[(L,) in, out] float + [(L,) K] outlier features → Int8OutlierWeight,
    a layer at a time. The scales are computed after the outlier rows are
    zeroed, so a hot feature's weight row no longer inflates every
    channel's scale."""
    idx = torch.as_tensor(outlier_idx, dtype=torch.int32,
                          device=weight.device)

    def one(w, rows):
        w, rows = w.to(torch.float32), rows.long()
        base = w.clone()
        base[rows] = 0.0
        return (*_quantize_f32(base), w[rows].to(torch.bfloat16))

    if weight.dim() == 2:
        q, scale, ow = one(weight, idx)
    else:
        q, scale, ow = (torch.stack(f) for f in zip(*map(one, weight, idx)))
    return Int8OutlierWeight(q=q, scale=scale, outlier_idx=idx, outlier_w=ow)


def dequantize_int8_outliers(w: Int8OutlierWeight,
                             dtype=torch.bfloat16) -> torch.Tensor:
    base = w.q.to(torch.float32) * w.scale[..., None, :].to(torch.float32)
    idx = w.outlier_idx.long()
    if base.dim() == 3:
        rows = torch.arange(base.shape[0], device=base.device)[:, None]
        base[rows, idx] = w.outlier_w.to(torch.float32)
    else:
        base[idx] = w.outlier_w.to(torch.float32)
    return base.to(dtype)


def matmul_int8_outliers(x: torch.Tensor, w: Int8OutlierWeight,
                         in_offset: Optional[int] = None) -> torch.Tensor:
    """x @ dequant(w): the int8 part as `matmul_int8`, plus a thin bf16
    product over the K outlier features, both into f32. With `in_offset`,
    x and q hold the input features from `in_offset` on (a tensor-parallel
    row split; `outlier_idx` and `outlier_w` stay whole): only the outlier
    features inside the block count, so the sum over the blocks is the
    whole product."""
    x2 = x.reshape(-1, x.shape[-1])
    y = _product_f32(x2.to(torch.bfloat16), w.q) * w.scale.to(torch.float32)
    if w.outlier_idx.shape[-1]:
        idx = w.outlier_idx.long()
        if in_offset is None:
            xo = x2[:, idx]
        else:
            local = idx - in_offset
            inside = (local >= 0) & (local < x2.shape[-1])
            xo = x2[:, local.clamp(0, x2.shape[-1] - 1)].masked_fill(
                ~inside, 0)
        y = y + _product_f32(xo.to(torch.bfloat16), w.outlier_w)  # [M, K]
    return y.to(x.dtype).reshape(*x.shape[:-1], w.out_features)


LINEAR_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "w_qkv", "w_gu", "wi", "wi_0", "wi_1")


def quantize_layer_params(params: dict, outlier_stats: dict | None = None,
                          threshold: float = 6.0) -> dict:
    """Quantize every stacked linear tensor in params["layers"] to
    Int8Weight (embeddings, lm_head and norms stay in full precision, as the
    reference's Linear8bitLt placement; GPTQ `Int4Weight`s stay as they
    are). With `outlier_stats` (linear key → [L, in] calibration absmax,
    `calibrate.collect_linear_input_absmax`), a linear whose activations
    cross `threshold` gets the Int8OutlierWeight instead."""
    from .calibrate import pick_outlier_features

    out = dict(params)
    lp = dict(params["layers"])
    for k in list(lp):
        if k in LINEAR_KEYS and isinstance(lp[k], torch.Tensor):
            stats = (outlier_stats or {}).get(k)
            if stats is not None:
                idx = pick_outlier_features(stats, threshold=threshold)
                if idx.shape[1] > 0:
                    lp[k] = quantize_int8_outliers(lp[k], idx)
                    continue
            lp[k] = quantize_int8(lp[k])
    out["layers"] = lp
    return out
