"""HF model-family loader: config.json → DecoderSpec, checkpoint → params
(port of the Llama part of the JAX package's `models/families.py`).

Layout conventions match the JAX package: linear weights are [in, out]
(activations are row vectors, `x @ W`); HF torch Linear stores [out, in]
and is transposed on load. Layer weights are stacked along a leading layer
axis. This slice loads the `llama` family with dense weights; other
families and quantized checkpoints raise NotImplementedError.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable

import torch

from ..device import resolve_device
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
    """Stack one dense linear across layers, transposed to [in, out]."""
    if w.has(fmt.format(i=0) + ".qweight"):
        raise NotImplementedError("GPTQ checkpoints are not ported yet")
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
    (CUDA unless the caller asks for the CPU)."""
    device = resolve_device(device)
    if quantize is not None:
        raise NotImplementedError(
            f"quantize={quantize!r} is not ported yet (bf16 slice)")
    config = load_hf_config(model_dir)
    model_type = config.get("model_type")
    if model_type not in FAMILIES:
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported yet (llama only)")
    spec_fn, load_fn = FAMILIES[model_type]
    spec = spec_fn(config)
    params = load_fn(Weights(model_dir), spec, dtype, device)
    return spec, params
