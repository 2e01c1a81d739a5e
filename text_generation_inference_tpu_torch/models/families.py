"""HF model-family loader: config.json → DecoderSpec, checkpoint → params
(port of the Llama part of the JAX package's `models/families.py`).

Layout conventions match the JAX package: linear weights are [in, out]
(activations are row vectors, `x @ W`); HF torch Linear stores [out, in]
and is transposed on load. Layer weights are stacked along a leading layer
axis. GPTQ checkpoints (AutoGPTQ `qweight/qzeros/scales/g_idx`, already
in x @ W orientation) load as layer-stacked `Int4Weight`s. This slice loads
the `llama` family; other families and the other `quantize` modes raise
NotImplementedError.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable

import torch

from ..device import resolve_device
from ..ops.quant.int4 import Int4Weight, normalize_act_order
from ..utils.weights import Weights
from .core import DecoderSpec


def load_hf_config(model_dir: str) -> dict:
    return json.loads((Path(model_dir) / "config.json").read_text())


def _llama_spec(c: dict) -> DecoderSpec:
    heads = c["num_attention_heads"]
    return DecoderSpec(
        vocab_size=c["vocab_size"],
        hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=c.get("num_key_value_heads") or heads,
        head_dim=c.get("head_dim") or c["hidden_size"] // heads,
        intermediate_size=c["intermediate_size"],
        pos="rope",
        rope_theta=c.get("rope_theta", 10000.0),
        rope_scaling=(c.get("rope_scaling") or {}).get("factor", 1.0),
        max_position_embeddings=c.get("max_position_embeddings", 2048),
        norm="rmsnorm",
        norm_eps=c.get("rms_norm_eps", 1e-6),
        activation="silu_glu",
        tie_word_embeddings=c.get("tie_word_embeddings", False),
    )


def _stack(ts: list[torch.Tensor], dtype, device) -> torch.Tensor:
    return torch.stack(ts).to(device=device, dtype=dtype)


def _stack_linear(w: Weights, fmt: str, n_layers: int, dtype, device):
    """Stack one linear across layers: dense `.weight` (transposed to
    [in, out]) or GPTQ `qweight/qzeros/scales/g_idx` → a layer-stacked
    Int4Weight (int32 words, f32 scales; act-order rows normalized into a
    per-layer input permutation, identity for layers without one)."""
    if w.has(fmt.format(i=0) + ".qweight"):
        per_layer = [
            normalize_act_order(
                w.get(fmt.format(i=i) + ".qweight").to(torch.int32),
                w.get(fmt.format(i=i) + ".qzeros").to(torch.int32),
                w.get(fmt.format(i=i) + ".scales").to(torch.float32),
                w.get(fmt.format(i=i) + ".g_idx"))
            for i in range(n_layers)]
        perm = None
        if any(p.perm is not None for p in per_layer):
            perm = torch.stack([
                p.perm if p.perm is not None
                else torch.arange(p.in_features, dtype=torch.int32)
                for p in per_layer]).to(device)
        stacked = {f: torch.stack([getattr(p, f) for p in per_layer]).to(device)
                   for f in ("qweight", "qzeros", "scales", "g_idx", "zbias")}
        return Int4Weight(perm=perm, **stacked)
    return _stack([w.get(fmt.format(i=i) + ".weight").t()
                   for i in range(n_layers)], dtype, device)


def _norm_stack(w: Weights, fmt: str, n_layers: int, dtype, device,
                bias: bool, offset: float = 0.0) -> dict:
    p = {"scale": _stack([w.get(fmt.format(i=i) + ".weight") + offset
                          for i in range(n_layers)], dtype, device)}
    if bias:
        p["bias"] = _stack([w.get(fmt.format(i=i) + ".bias")
                            for i in range(n_layers)], dtype, device)
    return p


def _load_llama(w: Weights, s: DecoderSpec, dtype, device) -> dict:
    """Llama tensor-name map."""
    L = s.num_layers
    pre = "model.layers.{i}"

    def lin(name):
        return _stack_linear(w, pre + name, L, dtype, device)

    layers = {
        "ln1": _norm_stack(w, pre + ".input_layernorm", L, dtype, device,
                           False),
        "ln2": _norm_stack(w, pre + ".post_attention_layernorm", L, dtype,
                           device, False),
        "wq": lin(".self_attn.q_proj"),
        "wk": lin(".self_attn.k_proj"),
        "wv": lin(".self_attn.v_proj"),
        "wo": lin(".self_attn.o_proj"),
        "w_gate": lin(".mlp.gate_proj"),
        "w_up": lin(".mlp.up_proj"),
        "w_down": lin(".mlp.down_proj"),
    }
    params = {
        "embed_tokens": w.get("model.embed_tokens.weight").to(device=device,
                                                             dtype=dtype),
        "layers": layers,
        "final_norm": {"scale": w.get("model.norm.weight").to(device=device,
                                                             dtype=dtype)},
    }
    if not s.tie_word_embeddings:
        params["lm_head"] = w.get("lm_head.weight").t().to(
            device=device, dtype=dtype).contiguous()
    return params


FAMILIES: dict[str, tuple[Callable[[dict], DecoderSpec], Callable]] = {
    "llama": (_llama_spec, _load_llama),
}


def load_model(model_dir: str, dtype=torch.bfloat16,
               quantize: str | None = None,
               device=None) -> tuple[DecoderSpec, dict]:
    """Load (spec, params) for a Llama-family HF checkpoint onto `device`
    (CUDA unless the caller asks for the CPU). GPTQ tensors load as
    Int4Weight whatever `quantize` says; quantize="gptq" is a requirement
    that the checkpoint carries them (GPTQ needs offline calibration, so
    it has no load-time path)."""
    device = resolve_device(device)
    if quantize not in (None, "gptq"):
        raise NotImplementedError(
            f"quantize={quantize!r} is not ported yet (gptq only)")
    config = load_hf_config(model_dir)
    model_type = config.get("model_type")
    if model_type not in FAMILIES:
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported yet (llama only)")
    spec_fn, load_fn = FAMILIES[model_type]
    spec = spec_fn(config)
    params = load_fn(Weights(model_dir), spec, dtype, device)
    if quantize == "gptq" and not any(isinstance(v, Int4Weight)
                                      for v in params["layers"].values()):
        # closes the trap where QUANTIZE=gptq on an fp checkpoint would
        # silently serve full-precision weights
        raise ValueError(
            "QUANTIZE=gptq but the checkpoint has no GPTQ tensors "
            "(qweight/qzeros/scales); quantize it offline first "
            "(`text-generation-inference-tpu quantize`) or unset QUANTIZE")
    return spec, params
