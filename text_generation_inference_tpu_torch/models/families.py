"""HF model-family loader: config.json → DecoderSpec, checkpoint → params
(port of the JAX package's `models/families.py`).

Layout conventions match the JAX package: linear weights are [in, out]
(activations are row vectors, `x @ W`); HF torch Linear stores [out, in]
and is transposed on load (GPT-2's Conv1D already stores [in, out]). Layer
weights are stacked along a leading layer axis. GPTQ checkpoints (AutoGPTQ
`qweight/qzeros/scales/g_idx`, already in x @ W orientation) load as
layer-stacked `Int4Weight`s wherever the JAX loader reads a linear through
`_stack_linear`; the fused projections it splits at load (CodeGen's, NeoX's,
BLOOM's, Falcon's, MPT's and GPT-2's / StarCoder's qkv, and the dense layers
of the families it reads densely) are read as dense weights there, and so
here.

Served: all sixteen model types of the JAX package's `FAMILIES`: the RoPE
decoders `llama`, `mistral`, `qwen2`, `gemma`, `gpt_neox`, `gptj`,
`codegen`, `phi` and `falcon` (`RefinedWeb`, `RefinedWebModel`); the
learned-position decoders `gpt2`, `opt` (with `project_in` / `project_out`)
and `gpt_bigcode` (multi-query); the ALiBi decoders `bloom` (with its
embedding LayerNorm), `mpt` and Falcon with `alibi: true`. Any other model
type goes through the structural fallback (`_load_fallback`,
FALLBACK_FAMILY=auto|<family>|off), as in the JAX package.

`load_model` takes every `quantize` mode of the JAX loader: "gptq" (a
requirement that the checkpoint carries GPTQ tensors), "int8" (every
layer linear quantized at load, `ops/quant/int8.py`) and "int8-outliers"
/ "bitsandbytes" (the static LLM.int8 decomposition: a calibration forward
over tokenized text, the built-in texts or the lines of
CALIBRATION_TEXT_PATH, picks each linear's outlier features first). As in
JAX only tensor leaves are quantized, so int8 on a GPTQ checkpoint leaves
its `Int4Weight`s as they are.

Falcon's loader also reads the q/k/v, out and MLP biases of a checkpoint
whose config sets `bias: true`, and the `post_attention_layernorm` of one
with `parallel_attn: false` (tiiuae/falcon-rw-1b has both). The JAX loader
reads neither: its forward pass then fails on the missing biases, and a
sequential Falcon would take the input LayerNorm twice.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..ops.quant.int4 import Int4Weight, normalize_act_order
from ..utils.weights import Weights
from .core import DecoderSpec

logger = logging.getLogger(__name__)

def load_hf_config(model_dir: str) -> dict:
    return json.loads((Path(model_dir) / "config.json").read_text())


# ---------------------------------------------------------------------------
# spec builders
# ---------------------------------------------------------------------------


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


def _neox_spec(c: dict) -> DecoderSpec:
    d = c["hidden_size"]
    h = c["num_attention_heads"]
    return DecoderSpec(
        vocab_size=c["vocab_size"],
        hidden_size=d,
        num_layers=c["num_hidden_layers"],
        num_heads=h,
        num_kv_heads=h,
        head_dim=d // h,
        intermediate_size=c["intermediate_size"],
        pos="rope",
        rope_theta=c.get("rotary_emb_base", 10000.0),
        rotary_pct=c.get("rotary_pct", 1.0),
        max_position_embeddings=c.get("max_position_embeddings", 2048),
        norm="layernorm",
        norm_eps=c.get("layer_norm_eps", 1e-5),
        activation=("gelu_tanh"
                    if c.get("hidden_act", "gelu") in ("gelu_new", "gelu_fast")
                    else "gelu"),
        parallel_residual=c.get("use_parallel_residual", True),
        qkv_bias=c.get("attention_bias", True),
        attn_out_bias=c.get("attention_bias", True),
        mlp_bias=True,
        tie_word_embeddings=False,
    )


def _gpt2_spec(c: dict) -> DecoderSpec:
    d = c["n_embd"]
    return DecoderSpec(
        vocab_size=c["vocab_size"],
        hidden_size=d,
        num_layers=c["n_layer"],
        num_heads=c["n_head"],
        num_kv_heads=c["n_head"],
        head_dim=d // c["n_head"],
        intermediate_size=c.get("n_inner") or 4 * d,
        pos="learned",
        max_position_embeddings=c["n_positions"],
        norm="layernorm",
        norm_eps=c.get("layer_norm_epsilon", 1e-5),
        activation="gelu_tanh",
        qkv_bias=True,
        attn_out_bias=True,
        mlp_bias=True,
        tie_word_embeddings=True,
    )


def _bloom_spec(c: dict) -> DecoderSpec:
    d = c.get("hidden_size") or c["n_embed"]
    h = c.get("n_head") or c["num_attention_heads"]
    return DecoderSpec(
        vocab_size=c["vocab_size"],
        hidden_size=d,
        num_layers=c.get("n_layer") or c["num_hidden_layers"],
        num_heads=h,
        num_kv_heads=h,
        head_dim=d // h,
        intermediate_size=4 * d,
        pos="alibi",
        norm="layernorm",
        norm_eps=c.get("layer_norm_epsilon", 1e-5),
        embed_norm=True,
        activation="gelu_tanh",
        qkv_bias=True,
        attn_out_bias=True,
        mlp_bias=True,
        tie_word_embeddings=True,
    )


def _opt_spec(c: dict) -> DecoderSpec:
    if not c.get("do_layer_norm_before", True):
        raise ValueError(
            "OPT with do_layer_norm_before=False (opt-350m style post-norm) "
            "is not supported")
    d = c["hidden_size"]
    h = c["num_attention_heads"]
    return DecoderSpec(
        vocab_size=c["vocab_size"],
        hidden_size=d,
        num_layers=c["num_hidden_layers"],
        num_heads=h,
        num_kv_heads=h,
        head_dim=d // h,
        intermediate_size=c["ffn_dim"],
        pos="learned",
        pos_offset=2,                # OPTLearnedPositionalEmbedding offset
        max_position_embeddings=c["max_position_embeddings"],
        norm="layernorm",
        activation=("relu" if c.get("activation_function", "relu") == "relu"
                    else "gelu"),
        qkv_bias=c.get("enable_bias", True),
        attn_out_bias=c.get("enable_bias", True),
        mlp_bias=c.get("enable_bias", True),
        tie_word_embeddings=c.get("tie_word_embeddings", True),
    )


def _mpt_spec(c: dict) -> DecoderSpec:
    d = c["d_model"]
    h = c["n_heads"]
    attn = c.get("attn_config") or {}
    if attn.get("softmax_scale") is not None:
        raise ValueError("MPT custom softmax_scale is not supported")
    return DecoderSpec(
        vocab_size=c["vocab_size"],
        hidden_size=d,
        num_layers=c["n_layers"],
        num_heads=h,
        num_kv_heads=h,
        head_dim=d // h,
        intermediate_size=c.get("expansion_ratio", 4) * d,
        pos="alibi" if attn.get("alibi", True) else "learned",
        alibi_impl="mpt",
        max_position_embeddings=c.get("max_seq_len", 2048),
        norm="layernorm",
        norm_eps=c.get("layer_norm_epsilon", 1e-5),
        activation="gelu",           # HF MptMLP: nn.GELU(approximate="none")
        qkv_clip=attn.get("clip_qkv"),
        qkv_bias=not c.get("no_bias", True),
        attn_out_bias=not c.get("no_bias", True),
        mlp_bias=False,              # HF MptMLP is always bias-free
        tie_word_embeddings=True,
    )


def _bigcode_spec(c: dict) -> DecoderSpec:
    d = c["n_embd"]
    h = c["n_head"]
    return DecoderSpec(
        vocab_size=c["vocab_size"],
        hidden_size=d,
        num_layers=c["n_layer"],
        num_heads=h,
        num_kv_heads=1 if c.get("multi_query", True) else h,
        head_dim=d // h,
        intermediate_size=c.get("n_inner") or 4 * d,
        pos="learned",
        max_position_embeddings=c["n_positions"],
        norm="layernorm",
        norm_eps=c.get("layer_norm_epsilon", 1e-5),
        activation="gelu_tanh",
        qkv_bias=True,
        attn_out_bias=True,
        mlp_bias=True,
        tie_word_embeddings=True,
    )


def _falcon_spec(c: dict) -> DecoderSpec:
    d = c["hidden_size"]
    h = c["num_attention_heads"]
    if c.get("new_decoder_architecture"):
        kv = c.get("num_kv_heads", 8)
    elif c.get("multi_query", True):
        kv = 1
    else:
        kv = h
    return DecoderSpec(
        vocab_size=c["vocab_size"],
        hidden_size=d,
        num_layers=c["num_hidden_layers"],
        num_heads=h,
        num_kv_heads=kv,
        head_dim=d // h,
        intermediate_size=4 * d,
        pos="alibi" if c.get("alibi") else "rope",
        rope_theta=c.get("rope_theta", 10000.0),
        norm="layernorm",
        norm_eps=c.get("layer_norm_epsilon", 1e-5),
        activation="gelu",
        parallel_residual=c.get("parallel_attn", True),
        qkv_bias=c.get("bias", False),
        attn_out_bias=c.get("bias", False),
        mlp_bias=c.get("bias", False),
        tie_word_embeddings=True,
    )


def _gptj_spec(c: dict) -> DecoderSpec:
    d = c["n_embd"]
    h = c["n_head"]
    dh = d // h
    return DecoderSpec(
        vocab_size=c["vocab_size"],
        hidden_size=d,
        num_layers=c["n_layer"],
        num_heads=h,
        num_kv_heads=h,
        head_dim=dh,
        intermediate_size=c.get("n_inner") or 4 * d,
        pos="rope",
        rotary_pct=(c.get("rotary_dim") or dh) / dh,
        rope_interleaved=True,
        max_position_embeddings=c["n_positions"],
        norm="layernorm",
        norm_eps=c.get("layer_norm_epsilon", 1e-5),
        activation="gelu_tanh",
        parallel_residual=True,      # single shared ln_1 (duplicated at load)
        mlp_bias=True,
        attn_out_bias=False,
        tie_word_embeddings=False,
    )


def _codegen_spec(c: dict) -> DecoderSpec:
    # CodeGen is GPT-J with a fused, mp_num-interleaved qkv projection
    s = _gptj_spec(c)
    return dataclasses.replace(
        s, rotary_pct=(c.get("rotary_dim") or s.head_dim) / s.head_dim)


def _phi_spec(c: dict) -> DecoderSpec:
    if c.get("qk_layernorm"):
        raise ValueError("phi qk_layernorm is not supported")
    d = c["hidden_size"]
    h = c["num_attention_heads"]
    dh = d // h
    return DecoderSpec(
        vocab_size=c["vocab_size"],
        hidden_size=d,
        num_layers=c["num_hidden_layers"],
        num_heads=h,
        num_kv_heads=c.get("num_key_value_heads") or h,
        head_dim=dh,
        intermediate_size=c["intermediate_size"],
        pos="rope",
        rope_theta=c.get("rope_theta", 10000.0),
        rotary_pct=c.get("partial_rotary_factor", 0.5),
        max_position_embeddings=c.get("max_position_embeddings", 2048),
        norm="layernorm",
        norm_eps=c.get("layer_norm_eps", 1e-5),
        activation=("gelu_tanh"
                    if c.get("hidden_act", "gelu_new")
                    in ("gelu_new", "gelu_fast", "gelu_pytorch_tanh")
                    else "gelu"),
        parallel_residual=True,      # shared input_layernorm (duplicated at load)
        qkv_bias=True,
        attn_out_bias=True,
        mlp_bias=True,
        tie_word_embeddings=False,
    )


def _mistral_spec(c: dict) -> DecoderSpec:
    s = _llama_spec(c)
    return dataclasses.replace(
        s,
        sliding_window=c.get("sliding_window"),
        norm_eps=c.get("rms_norm_eps", 1e-6),
    )


def _qwen2_spec(c: dict) -> DecoderSpec:
    s = _llama_spec(c)
    return dataclasses.replace(
        s,
        qkv_bias=True,               # Qwen2Attention: q/k/v have bias, o does not
        sliding_window=(c.get("sliding_window")
                        if c.get("use_sliding_window") else None),
    )


def _gemma_spec(c: dict) -> DecoderSpec:
    d = c["hidden_size"]
    heads = c["num_attention_heads"]
    act = (c.get("hidden_activation") or c.get("hidden_act")
           or "gelu_pytorch_tanh")
    return DecoderSpec(
        vocab_size=c["vocab_size"],
        hidden_size=d,
        num_layers=c["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=c.get("num_key_value_heads") or heads,
        head_dim=c.get("head_dim") or d // heads,
        intermediate_size=c["intermediate_size"],
        pos="rope",
        rope_theta=c.get("rope_theta", 10000.0),
        max_position_embeddings=c.get("max_position_embeddings", 8192),
        norm="rmsnorm",
        norm_eps=c.get("rms_norm_eps", 1e-6),
        activation=("gelu_tanh_glu"
                    if act in ("gelu_pytorch_tanh", "gelu_new", "gelu_fast")
                    else "gelu_glu"),
        embed_scale=d ** 0.5,
        tie_word_embeddings=True,
    )


# ---------------------------------------------------------------------------
# checkpoint loaders
# ---------------------------------------------------------------------------


def _stack(ts: list[torch.Tensor], dtype, device) -> torch.Tensor:
    return torch.stack(ts).to(device=device, dtype=dtype).contiguous()


def _one(t: torch.Tensor, dtype, device) -> torch.Tensor:
    return t.to(device=device, dtype=dtype).contiguous()


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


def _stack_bias(w: Weights, fmt: str, n_layers: int, dtype, device):
    return _stack([w.get(fmt.format(i=i) + ".bias") for i in range(n_layers)],
                  dtype, device)


def _norm_stack(w: Weights, fmt: str, n_layers: int, dtype, device,
                bias: bool, offset: float = 0.0) -> dict:
    """`offset` is added to the stored weight in f32 (gemma's RMSNorm
    computes x * (1 + weight); folding the +1 at load keeps `core._norm`
    generic)."""
    p = {"scale": _stack([w.get(fmt.format(i=i) + ".weight").float() + offset
                          for i in range(n_layers)], dtype, device)}
    if bias:
        p["bias"] = _stack_bias(w, fmt, n_layers, dtype, device)
    return p


def _shared_norm(ln1: dict) -> dict:
    """The parallel blocks that share one layernorm between attention and
    the MLP (GPT-J, CodeGen, Phi, Falcon): ln2 is a copy of ln1."""
    return {k: v.clone() for k, v in ln1.items()}


def _final_layernorm(w: Weights, name: str, dtype, device) -> dict:
    return {"scale": _one(w.get(name + ".weight"), dtype, device),
            "bias": _one(w.get(name + ".bias"), dtype, device)}


def _load_llama(w: Weights, s: DecoderSpec, dtype, device,
                norm_offset: float = 0.0) -> dict:
    """Llama tensor-name map; also loads mistral / qwen2 (identical names:
    qwen2 adds q/k/v biases, keyed off spec.qkv_bias) and, with
    norm_offset=1, gemma (the final norm takes the offset too)."""
    L = s.num_layers
    pre = "model.layers.{i}"

    def lin(name):
        return _stack_linear(w, pre + name, L, dtype, device)

    layers = {
        "ln1": _norm_stack(w, pre + ".input_layernorm", L, dtype, device,
                           False, offset=norm_offset),
        "ln2": _norm_stack(w, pre + ".post_attention_layernorm", L, dtype,
                           device, False, offset=norm_offset),
        "wq": lin(".self_attn.q_proj"),
        "wk": lin(".self_attn.k_proj"),
        "wv": lin(".self_attn.v_proj"),
        "wo": lin(".self_attn.o_proj"),
        "w_gate": lin(".mlp.gate_proj"),
        "w_up": lin(".mlp.up_proj"),
        "w_down": lin(".mlp.down_proj"),
    }
    if s.qkv_bias:
        for name, key in (("q_proj", "bq"), ("k_proj", "bk"), ("v_proj", "bv")):
            layers[key] = _stack_bias(w, pre + f".self_attn.{name}", L, dtype,
                                      device)
    params = {
        "embed_tokens": _one(w.get("model.embed_tokens.weight"), dtype, device),
        "layers": layers,
        "final_norm": {"scale": _one(
            w.get("model.norm.weight").float() + norm_offset, dtype, device)},
    }
    if not s.tie_word_embeddings:
        params["lm_head"] = _one(w.get("lm_head.weight").t(), dtype, device)
    return params


def _load_gemma(w: Weights, s: DecoderSpec, dtype, device) -> dict:
    return _load_llama(w, s, dtype, device, norm_offset=1.0)


def _gptj_layers(w: Weights, s: DecoderSpec, dtype, device) -> dict:
    """What GPT-J and CodeGen share: the one ln_1, the out projection and
    the MLP with its biases."""
    L = s.num_layers
    pre = "transformer.h.{i}"
    ln1 = _norm_stack(w, pre + ".ln_1", L, dtype, device, True)
    return {
        "ln1": ln1,
        "ln2": _shared_norm(ln1),
        "wo": _stack_linear(w, pre + ".attn.out_proj", L, dtype, device),
        "w_up": _stack_linear(w, pre + ".mlp.fc_in", L, dtype, device),
        "b_up": _stack_bias(w, pre + ".mlp.fc_in", L, dtype, device),
        "w_down": _stack_linear(w, pre + ".mlp.fc_out", L, dtype, device),
        "b_down": _stack_bias(w, pre + ".mlp.fc_out", L, dtype, device),
    }


def _gptj_params(w: Weights, layers: dict, dtype, device) -> dict:
    return {
        "embed_tokens": _one(w.get("transformer.wte.weight"), dtype, device),
        "layers": layers,
        "final_norm": _final_layernorm(w, "transformer.ln_f", dtype, device),
        "lm_head": _one(w.get("lm_head.weight").t(), dtype, device),
        "lm_head_bias": _one(w.get("lm_head.bias"), dtype, device),
    }


def _load_gptj(w: Weights, s: DecoderSpec, dtype, device) -> dict:
    L = s.num_layers
    pre = "transformer.h.{i}"
    layers = _gptj_layers(w, s, dtype, device)
    for name, key in (("q_proj", "wq"), ("k_proj", "wk"), ("v_proj", "wv")):
        layers[key] = _stack_linear(w, pre + f".attn.{name}", L, dtype, device)
    return _gptj_params(w, layers, dtype, device)


def _load_codegen(w: Weights, s: DecoderSpec, dtype, device) -> dict:
    """CodeGen = GPT-J with a fused qkv_proj whose out axis is mp_num=4
    blocks of [q_local | v_local | k_local] (HF CodeGenAttention mp_num
    sharding; heads are block-major, so concatenating the blocks restores
    natural head order)."""
    L, D = s.num_layers, s.hidden_size
    mp_num = 4
    local = D // mp_num
    qs, ks, vs = [], [], []
    for i in range(L):
        qkv = w.get(f"transformer.h.{i}.attn.qkv_proj.weight")   # [3D, D_in]
        blocks = qkv.reshape(mp_num, 3 * local, -1)
        qs.append(blocks[:, :local].reshape(D, -1).t())
        vs.append(blocks[:, local:2 * local].reshape(D, -1).t())
        ks.append(blocks[:, 2 * local:].reshape(D, -1).t())
    layers = _gptj_layers(w, s, dtype, device)
    layers.update(wq=_stack(qs, dtype, device), wk=_stack(ks, dtype, device),
                  wv=_stack(vs, dtype, device))
    return _gptj_params(w, layers, dtype, device)


def _load_phi(w: Weights, s: DecoderSpec, dtype, device) -> dict:
    L = s.num_layers
    pre = "model.layers.{i}"
    ln1 = _norm_stack(w, pre + ".input_layernorm", L, dtype, device, True)
    layers = {
        "ln1": ln1,
        # phi's parallel block shares input_layernorm between attn and mlp
        "ln2": _shared_norm(ln1),
        "w_up": _stack_linear(w, pre + ".mlp.fc1", L, dtype, device),
        "b_up": _stack_bias(w, pre + ".mlp.fc1", L, dtype, device),
        "w_down": _stack_linear(w, pre + ".mlp.fc2", L, dtype, device),
        "b_down": _stack_bias(w, pre + ".mlp.fc2", L, dtype, device),
    }
    for name, wkey, bkey in (("q_proj", "wq", "bq"), ("k_proj", "wk", "bk"),
                             ("v_proj", "wv", "bv"), ("dense", "wo", "bo")):
        layers[wkey] = _stack_linear(w, pre + f".self_attn.{name}", L, dtype,
                                     device)
        layers[bkey] = _stack_bias(w, pre + f".self_attn.{name}", L, dtype,
                                   device)
    return {
        "embed_tokens": _one(w.get("model.embed_tokens.weight"), dtype, device),
        "layers": layers,
        "final_norm": _final_layernorm(w, "model.final_layernorm", dtype,
                                       device),
        "lm_head": _one(w.get("lm_head.weight").t(), dtype, device),
        "lm_head_bias": _one(w.get("lm_head.bias"), dtype, device),
    }


def _split_fused_headmajor(qkv: torch.Tensor, h: int, dh: int
                           ) -> tuple[torch.Tensor, ...]:
    """NeoX (and BLOOM, multi-head Falcon) fused qkv layout: [(h, 3, dh),
    d_in] rows. Returns q / k / v as [d_in, h * dh]."""
    d_in = qkv.shape[-1]
    grouped = qkv.reshape(h, 3, dh, d_in)
    return tuple(grouped[:, j].reshape(h * dh, d_in).t() for j in range(3))


def _split_fused_bias_headmajor(b: torch.Tensor, h: int, dh: int
                                ) -> tuple[torch.Tensor, ...]:
    grouped = b.reshape(h, 3, dh)
    return tuple(grouped[:, j].reshape(h * dh) for j in range(3))


def _dense_t(w: Weights, fmt: str, n_layers: int, dtype, device):
    """A layer-stacked dense weight, transposed to [in, out] (the layers the
    JAX loader reads as dense weights)."""
    return _stack([w.get(fmt.format(i=i) + ".weight").t()
                   for i in range(n_layers)], dtype, device)


def _load_neox(w: Weights, s: DecoderSpec, dtype, device) -> dict:
    L, H, Dh = s.num_layers, s.num_heads, s.head_dim
    pre = "gpt_neox.layers.{i}"
    qs, ks, vs, bqs, bks, bvs = [], [], [], [], [], []
    for i in range(L):
        q, k, v = _split_fused_headmajor(
            w.get(f"gpt_neox.layers.{i}.attention.query_key_value.weight"),
            H, Dh)
        bq, bk, bv = _split_fused_bias_headmajor(
            w.get(f"gpt_neox.layers.{i}.attention.query_key_value.bias"),
            H, Dh)
        qs.append(q); ks.append(k); vs.append(v)
        bqs.append(bq); bks.append(bk); bvs.append(bv)
    layers = {
        "ln1": _norm_stack(w, pre + ".input_layernorm", L, dtype, device,
                           True),
        "ln2": _norm_stack(w, pre + ".post_attention_layernorm", L, dtype,
                           device, True),
        "wq": _stack(qs, dtype, device), "wk": _stack(ks, dtype, device),
        "wv": _stack(vs, dtype, device),
        "bq": _stack(bqs, dtype, device), "bk": _stack(bks, dtype, device),
        "bv": _stack(bvs, dtype, device),
        "wo": _dense_t(w, pre + ".attention.dense", L, dtype, device),
        "bo": _stack_bias(w, pre + ".attention.dense", L, dtype, device),
        "w_up": _dense_t(w, pre + ".mlp.dense_h_to_4h", L, dtype, device),
        "b_up": _stack_bias(w, pre + ".mlp.dense_h_to_4h", L, dtype, device),
        "w_down": _dense_t(w, pre + ".mlp.dense_4h_to_h", L, dtype, device),
        "b_down": _stack_bias(w, pre + ".mlp.dense_4h_to_h", L, dtype,
                              device),
    }
    return {
        "embed_tokens": _one(w.get("gpt_neox.embed_in.weight"), dtype, device),
        "layers": layers,
        "final_norm": _final_layernorm(w, "gpt_neox.final_layer_norm", dtype,
                                       device),
        "lm_head": _one(w.get("embed_out.weight").t(), dtype, device),
    }


def _split_falcon_qkv(qkv: torch.Tensor, h: int, k: int, dh: int):
    """Falcon's fused qkv rows ([out, ...]: a weight [out, d_in] or a bias
    [out]) in its three layouts: multi-query ([q (H*Dh) | k (Dh) | v (Dh)]),
    multi-head (head-major, as NeoX) and the new decoder architecture (K
    groups of H / K query heads, one k and one v). Returns the q, k and v
    rows, each [rows, ...]."""
    tail = qkv.shape[1:]
    if k == 1:
        return qkv[: h * dh], qkv[h * dh: (h + 1) * dh], qkv[(h + 1) * dh:]
    if k == h:
        grouped = qkv.reshape(h, 3, dh, *tail)
        return tuple(grouped[:, j].reshape(h * dh, *tail) for j in range(3))
    grouped = qkv.reshape(k, h // k + 2, dh, *tail)
    return (grouped[:, :-2].reshape(h * dh, *tail),
            grouped[:, -2].reshape(k * dh, *tail),
            grouped[:, -1].reshape(k * dh, *tail))


def _load_falcon(w: Weights, s: DecoderSpec, dtype, device) -> dict:
    """Falcon's fused qkv in its three layouts (`_split_falcon_qkv`); with
    `bias: true` its biases, and with `parallel_attn: false` its second
    LayerNorm (see the module docstring)."""
    L, H, K, Dh = s.num_layers, s.num_heads, s.num_kv_heads, s.head_dim
    pre = "transformer.h.{i}"
    qkv_name = pre + ".self_attention.query_key_value"
    qs, ks, vs = zip(*(
        (x.t() for x in _split_falcon_qkv(
            w.get(qkv_name.format(i=i) + ".weight"), H, K, Dh))
        for i in range(L)))
    ln1 = _norm_stack(w, pre + ".input_layernorm", L, dtype, device, True)
    # the parallel block shares one layernorm between attention and the MLP
    ln2 = (_norm_stack(w, pre + ".post_attention_layernorm", L, dtype,
                       device, True)
           if not s.parallel_residual
           and w.has("transformer.h.0.post_attention_layernorm.weight")
           else _shared_norm(ln1))
    layers = {
        "ln1": ln1,
        "ln2": ln2,
        "wq": _stack(list(qs), dtype, device),
        "wk": _stack(list(ks), dtype, device),
        "wv": _stack(list(vs), dtype, device),
        "wo": _dense_t(w, pre + ".self_attention.dense", L, dtype, device),
        "w_up": _dense_t(w, pre + ".mlp.dense_h_to_4h", L, dtype, device),
        "w_down": _dense_t(w, pre + ".mlp.dense_4h_to_h", L, dtype, device),
    }
    if s.qkv_bias and w.has(qkv_name.format(i=0) + ".bias"):
        bq, bk, bv = zip(*(_split_falcon_qkv(
            w.get(qkv_name.format(i=i) + ".bias"), H, K, Dh)
            for i in range(L)))
        layers.update(bq=_stack(list(bq), dtype, device),
                      bk=_stack(list(bk), dtype, device),
                      bv=_stack(list(bv), dtype, device))
    for key, name, on in (("bo", ".self_attention.dense", s.attn_out_bias),
                          ("b_up", ".mlp.dense_h_to_4h", s.mlp_bias),
                          ("b_down", ".mlp.dense_4h_to_h", s.mlp_bias)):
        if on and w.has((pre + name).format(i=0) + ".bias"):
            layers[key] = _stack_bias(w, pre + name, L, dtype, device)
    return {
        "embed_tokens": _one(w.get("transformer.word_embeddings.weight"),
                             dtype, device),
        "layers": layers,
        "final_norm": _final_layernorm(w, "transformer.ln_f", dtype, device),
    }


def _load_gpt2_like(w: Weights, s: DecoderSpec, dtype, device,
                    conv1d: bool) -> dict:
    """GPT-2 and StarCoder (gpt_bigcode): `h.{i}` blocks with an optional
    `transformer.` prefix, a fused c_attn of q | k | v blocks (GPT-2's
    Conv1D stores [in, out] with its out axis split; StarCoder's Linear
    [out, in] with [q (D) | k (K Dh) | v (K Dh)] rows), learned positions
    `wpe` and tied embeddings."""
    L, D = s.num_layers, s.hidden_size
    kv = s.num_kv_heads * s.head_dim
    prefix = "" if w.has("wte.weight") else "transformer."

    def g(name):
        return w.get(prefix + name)

    def lin(name):       # as [in, out]
        return g(name) if conv1d else g(name).t()

    qs, ks, vs, bqs, bks, bvs = [], [], [], [], [], []
    for i in range(L):
        qkv = lin(f"h.{i}.attn.c_attn.weight")          # [in, D + 2 kv]
        b = g(f"h.{i}.attn.c_attn.bias")
        qs.append(qkv[:, :D]); ks.append(qkv[:, D:D + kv])
        vs.append(qkv[:, D + kv:])
        bqs.append(b[:D]); bks.append(b[D:D + kv]); bvs.append(b[D + kv:])
    layers = {
        "ln1": _norm_stack(w, prefix + "h.{i}.ln_1", L, dtype, device, True),
        "ln2": _norm_stack(w, prefix + "h.{i}.ln_2", L, dtype, device, True),
        "wq": _stack(qs, dtype, device), "wk": _stack(ks, dtype, device),
        "wv": _stack(vs, dtype, device),
        "bq": _stack(bqs, dtype, device), "bk": _stack(bks, dtype, device),
        "bv": _stack(bvs, dtype, device),
    }
    for key, name in (("wo", "attn.c_proj"), ("w_up", "mlp.c_fc"),
                      ("w_down", "mlp.c_proj")):
        layers[key] = _stack([lin(f"h.{i}.{name}.weight") for i in range(L)],
                             dtype, device)
        layers["b" + key[1:]] = _stack(
            [g(f"h.{i}.{name}.bias") for i in range(L)], dtype, device)
    return {
        "embed_tokens": _one(g("wte.weight"), dtype, device),
        "embed_positions": _one(g("wpe.weight"), dtype, device),
        "layers": layers,
        "final_norm": _final_layernorm(w, prefix + "ln_f", dtype, device),
    }


def _load_gpt2(w: Weights, s: DecoderSpec, dtype, device) -> dict:
    return _load_gpt2_like(w, s, dtype, device, conv1d=True)


def _load_bigcode(w: Weights, s: DecoderSpec, dtype, device) -> dict:
    return _load_gpt2_like(w, s, dtype, device, conv1d=False)


def _load_opt(w: Weights, s: DecoderSpec, dtype, device) -> dict:
    L = s.num_layers
    pre = "model.decoder.layers.{i}"

    def lin(name):
        return _stack_linear(w, pre + name, L, dtype, device)

    def bias(name):
        return _stack_bias(w, pre + name, L, dtype, device)

    layers = {
        "ln1": _norm_stack(w, pre + ".self_attn_layer_norm", L, dtype, device,
                           True),
        "ln2": _norm_stack(w, pre + ".final_layer_norm", L, dtype, device,
                           True),
        "wq": lin(".self_attn.q_proj"), "wk": lin(".self_attn.k_proj"),
        "wv": lin(".self_attn.v_proj"), "wo": lin(".self_attn.out_proj"),
        "w_up": lin(".fc1"), "w_down": lin(".fc2"),
    }
    if s.qkv_bias:
        layers.update(bq=bias(".self_attn.q_proj"),
                      bk=bias(".self_attn.k_proj"),
                      bv=bias(".self_attn.v_proj"))
    if s.attn_out_bias:
        layers["bo"] = bias(".self_attn.out_proj")
    if s.mlp_bias:
        layers.update(b_up=bias(".fc1"), b_down=bias(".fc2"))
    params = {
        "embed_tokens": _one(w.get("model.decoder.embed_tokens.weight"),
                             dtype, device),
        "embed_positions": _one(w.get("model.decoder.embed_positions.weight"),
                                dtype, device),
        "layers": layers,
        "final_norm": _final_layernorm(w, "model.decoder.final_layer_norm",
                                       dtype, device),
    }
    if w.has("model.decoder.project_in.weight"):
        # word_embed_proj_dim != hidden_size (opt-350m)
        params["project_in"] = _one(
            w.get("model.decoder.project_in.weight").t(), dtype, device)
        params["project_out"] = _one(
            w.get("model.decoder.project_out.weight").t(), dtype, device)
    if not s.tie_word_embeddings:
        params["lm_head"] = _one(w.get("lm_head.weight").t(), dtype, device)
    return params


def _load_mpt(w: Weights, s: DecoderSpec, dtype, device) -> dict:
    L, D = s.num_layers, s.hidden_size
    pre = "transformer.blocks.{i}"
    has_ln_bias = w.has("transformer.blocks.0.norm_1.bias")
    qs, ks, vs, bqs, bks, bvs = [], [], [], [], [], []
    for i in range(L):
        qkv = w.get(f"transformer.blocks.{i}.attn.Wqkv.weight")   # [3D, D]
        qs.append(qkv[:D].t()); ks.append(qkv[D:2 * D].t())
        vs.append(qkv[2 * D:].t())
        if s.qkv_bias:
            b = w.get(f"transformer.blocks.{i}.attn.Wqkv.bias")
            bqs.append(b[:D]); bks.append(b[D:2 * D]); bvs.append(b[2 * D:])
    layers = {
        "ln1": _norm_stack(w, pre + ".norm_1", L, dtype, device, has_ln_bias),
        "ln2": _norm_stack(w, pre + ".norm_2", L, dtype, device, has_ln_bias),
        "wq": _stack(qs, dtype, device), "wk": _stack(ks, dtype, device),
        "wv": _stack(vs, dtype, device),
        "wo": _stack_linear(w, pre + ".attn.out_proj", L, dtype, device),
        "w_up": _stack_linear(w, pre + ".ffn.up_proj", L, dtype, device),
        "w_down": _stack_linear(w, pre + ".ffn.down_proj", L, dtype, device),
    }
    if s.qkv_bias:
        layers.update(bq=_stack(bqs, dtype, device),
                      bk=_stack(bks, dtype, device),
                      bv=_stack(bvs, dtype, device))
    if s.attn_out_bias:
        layers["bo"] = _stack_bias(w, pre + ".attn.out_proj", L, dtype,
                                   device)
    if s.mlp_bias:
        layers["b_up"] = _stack_bias(w, pre + ".ffn.up_proj", L, dtype,
                                     device)
        layers["b_down"] = _stack_bias(w, pre + ".ffn.down_proj", L, dtype,
                                       device)
    final_norm = {"scale": _one(w.get("transformer.norm_f.weight"), dtype,
                                device)}
    if w.has("transformer.norm_f.bias"):
        final_norm["bias"] = _one(w.get("transformer.norm_f.bias"), dtype,
                                  device)
    return {
        "embed_tokens": _one(w.get("transformer.wte.weight"), dtype, device),
        "layers": layers,
        "final_norm": final_norm,
    }


def _load_bloom(w: Weights, s: DecoderSpec, dtype, device) -> dict:
    L, H, Dh = s.num_layers, s.num_heads, s.head_dim
    pre = "transformer.h.{i}"
    qs, ks, vs, bqs, bks, bvs = [], [], [], [], [], []
    for i in range(L):
        q, k, v = _split_fused_headmajor(
            w.get(f"transformer.h.{i}.self_attention.query_key_value.weight"),
            H, Dh)
        bq, bk, bv = _split_fused_bias_headmajor(
            w.get(f"transformer.h.{i}.self_attention.query_key_value.bias"),
            H, Dh)
        qs.append(q); ks.append(k); vs.append(v)
        bqs.append(bq); bks.append(bk); bvs.append(bv)
    layers = {
        "ln1": _norm_stack(w, pre + ".input_layernorm", L, dtype, device,
                           True),
        "ln2": _norm_stack(w, pre + ".post_attention_layernorm", L, dtype,
                           device, True),
        "wq": _stack(qs, dtype, device), "wk": _stack(ks, dtype, device),
        "wv": _stack(vs, dtype, device),
        "bq": _stack(bqs, dtype, device), "bk": _stack(bks, dtype, device),
        "bv": _stack(bvs, dtype, device),
        "wo": _dense_t(w, pre + ".self_attention.dense", L, dtype, device),
        "bo": _stack_bias(w, pre + ".self_attention.dense", L, dtype, device),
        "w_up": _dense_t(w, pre + ".mlp.dense_h_to_4h", L, dtype, device),
        "b_up": _stack_bias(w, pre + ".mlp.dense_h_to_4h", L, dtype, device),
        "w_down": _dense_t(w, pre + ".mlp.dense_4h_to_h", L, dtype, device),
        "b_down": _stack_bias(w, pre + ".mlp.dense_4h_to_h", L, dtype,
                              device),
    }
    return {
        "embed_tokens": _one(w.get("transformer.word_embeddings.weight"),
                             dtype, device),
        "embed_ln": _final_layernorm(
            w, "transformer.word_embeddings_layernorm", dtype, device),
        "layers": layers,
        "final_norm": _final_layernorm(w, "transformer.ln_f", dtype, device),
    }


FAMILIES: dict[str, tuple[Callable[[dict], DecoderSpec], Callable]] = {
    "llama": (_llama_spec, _load_llama),
    "gpt2": (_gpt2_spec, _load_gpt2),
    "bloom": (_bloom_spec, _load_bloom),
    "gpt_neox": (_neox_spec, _load_neox),
    "falcon": (_falcon_spec, _load_falcon),
    "RefinedWeb": (_falcon_spec, _load_falcon),
    "RefinedWebModel": (_falcon_spec, _load_falcon),
    "gpt_bigcode": (_bigcode_spec, _load_bigcode),
    "gptj": (_gptj_spec, _load_gptj),
    "codegen": (_codegen_spec, _load_codegen),
    "opt": (_opt_spec, _load_opt),
    "mpt": (_mpt_spec, _load_mpt),
    "phi": (_phi_spec, _load_phi),
    "mistral": (_mistral_spec, _load_llama),
    "qwen2": (_qwen2_spec, _load_llama),
    "gemma": (_gemma_spec, _load_gemma),
}

# Signature tensors per family, as the JAX package's: a checkpoint that
# carries one names its layers as that family does. Ordered by how common
# the convention is among fine-tunes and clones; read only for model types
# outside FAMILIES.
_FALLBACK_SIGNATURES = [
    ("llama", "model.layers.0.self_attn.q_proj.weight"),
    ("gpt_neox", "gpt_neox.layers.0.attention.query_key_value.weight"),
    ("gptj", "transformer.h.0.attn.q_proj.weight"),
    ("gpt_bigcode", "transformer.h.0.attn.c_attn.weight"),
    ("gpt2", "transformer.h.0.attn.c_attn.weight"),
    ("opt", "model.decoder.layers.0.self_attn.q_proj.weight"),
    ("bloom", "transformer.h.0.self_attention.query_key_value.weight"),
    ("falcon", "transformer.h.0.self_attention.query_key_value.weight"),
    ("mpt", "transformer.blocks.0.attn.Wqkv.weight"),
]


def _load_fallback(model_dir: str, config: dict, model_type, dtype,
                   device) -> tuple[DecoderSpec, dict]:
    """The JAX package's structural fallback for model types outside
    FAMILIES: serve the checkpoint through the first family whose
    signature tensor it carries and whose spec builder and loader take it
    (most unknown model types are renamed clones of a known architecture).

    FALLBACK_FAMILY=auto (default) tries the signatures in order;
    =<family> forces one family's loader; =off raises, as does a checkpoint
    no family takes (ValueError, with the JAX package's message)."""
    mode = os.getenv("FALLBACK_FAMILY", "auto").strip()
    matrix = (f"unsupported model_type {model_type!r}; supported: "
              f"{sorted(FAMILIES)}. Unknown types are served via the "
              "structural fallback (FALLBACK_FAMILY=auto|<family>; "
              "currently: " + mode + ")")
    if mode.lower() in ("off", "0", "false"):
        raise ValueError(matrix)
    weights = Weights(model_dir)
    if mode.lower() != "auto":
        if mode not in FAMILIES:
            raise ValueError(
                f"FALLBACK_FAMILY={mode!r} is not a known family; "
                f"choose one of {sorted(FAMILIES)} or auto/off")
        candidates = [mode]
    else:
        candidates = list(dict.fromkeys(
            fam for fam, sig in _FALLBACK_SIGNATURES if weights.has(sig)))
    errors = []
    for fam in candidates:
        spec_fn, load_fn = FAMILIES[fam]
        try:
            spec = spec_fn(config)
            params = load_fn(weights, spec, dtype, device)
        except Exception as e:  # noqa: BLE001 - try the next convention
            errors.append(f"{fam}: {type(e).__name__}: {e}")
            continue
        logger.warning(
            "model_type %r is not natively supported; serving via the %r "
            "family's structural fallback (set FALLBACK_FAMILY=off to "
            "require native support)", model_type, fam)
        return spec, params
    raise ValueError(
        matrix + (f"; fallback attempts failed: {errors}" if errors
                  else "; no family signature tensor matched the checkpoint"))


# The default LLM.int8 calibration corpus (the JAX package's texts): short
# natural-language and code snippets. The threshold-6.0 outlier statistics
# are defined over real-text activations, and uniform random token ids
# light the wrong feature dims. CALIBRATION_TEXT_PATH supplies a
# deployment's own corpus, one prompt a line.
_CALIBRATION_TEXTS = [
    "The quick brown fox jumps over the lazy dog. Machine learning systems "
    "transform natural language into dense vector representations, and the "
    "resulting activations exhibit systematic outlier feature dimensions.",
    "def tokenize(text):\n    return [vocab[t] for t in text.split()]\n\n"
    "class Server:\n    def __init__(self, port=8033):\n        self.port "
    "= port",
    "In 1969, the Apollo 11 mission landed the first humans on the Moon; "
    "the guidance computer had 2048 words of RAM and ran at 0.043 MHz.",
    "Les mots étrangers, die Umlaute, and 漢字 exercise the multilingual "
    "token space; punctuation — em-dashes, ellipses… and “smart quotes” — "
    "exercises the byte fallback.",
]


def _calibration_token_ids(model_dir: str, spec: DecoderSpec,
                           calib_t: int) -> np.ndarray:
    """The tokenized calibration prompts [N, T] (each cut to `calib_t`
    tokens and padded by repeating its last token, so the stats stay on
    text), or uniform random ids from a seed when the checkpoint has no
    tokenizer."""
    texts = None
    path = os.getenv("CALIBRATION_TEXT_PATH")
    if path:
        texts = [ln for ln in Path(path).read_text().splitlines()
                 if ln.strip()]
    try:
        from ..utils.tokenization import ServingTokenizer

        tok = ServingTokenizer.load(model_dir)
        rows = []
        for text in texts or _CALIBRATION_TEXTS:
            ids = [i for i in tok.encode(text, add_special_tokens=True)
                   if i < spec.vocab_size]
            if ids:
                rows.append(ids[:calib_t])
        if rows:
            t = max(len(r) for r in rows)
            out = np.zeros((len(rows), t), np.int64)
            for i, r in enumerate(rows):
                out[i, : len(r)] = r
                out[i, len(r):] = r[-1]
            logger.info("int8-outlier calibration: %d tokenized prompts "
                        "(%s)", len(rows),
                        "CALIBRATION_TEXT_PATH" if texts else "built-in")
            return out
    except Exception:
        logger.warning(
            "int8-outlier calibration: tokenizer unavailable for %s; "
            "falling back to random token ids (outlier selection may be "
            "inaccurate — provide tokenizer files or CALIBRATION_TEXT_PATH)",
            model_dir, exc_info=True)
    rng = np.random.default_rng(0)
    return rng.integers(0, spec.vocab_size, size=(4, calib_t))


def _log_outlier_selection(params: dict) -> None:
    """Log which features the static LLM.int8 decomposition keeps in bf16."""
    from ..ops.quant.int8 import Int8OutlierWeight

    for k, w in params["layers"].items():
        if isinstance(w, Int8OutlierWeight):
            idx = w.outlier_idx.cpu().numpy()
            logger.info(
                "int8-outliers %s: %d/%d features bf16 (layer-0 dims: %s)",
                k, idx.shape[1], w.in_features,
                np.sort(idx[0])[:16].tolist())


def load_model(model_dir: str, dtype=torch.bfloat16,
               quantize: str | None = None,
               device=None) -> tuple[DecoderSpec, dict]:
    """Load (spec, params) for a checkpoint of a served family, or of any
    model type the structural fallback takes, onto `device` (CUDA unless
    the caller asks for the CPU). GPTQ tensors load as Int4Weight whatever
    `quantize` says.

    quantize="int8" quantizes every layer linear at load time (per output
    channel absmax, on `device`); "int8-outliers" (or the reference's flag
    name "bitsandbytes") calibrates first and keeps each linear's outlier
    feature rows in bf16; "gptq" requires the checkpoint to carry GPTQ
    tensors (GPTQ needs offline calibration, so it has no load-time path)."""
    device = resolve_device(device)
    if quantize not in (None, "gptq", "int8", "int8-outliers",
                        "bitsandbytes"):
        raise ValueError(f"unsupported quantize mode {quantize!r}; expected "
                         "'int8', 'int8-outliers', 'bitsandbytes' or 'gptq'")
    config = load_hf_config(model_dir)
    model_type = config.get("model_type")
    if model_type in FAMILIES:
        spec_fn, load_fn = FAMILIES[model_type]
        spec = spec_fn(config)
        params = load_fn(Weights(model_dir), spec, dtype, device)
    else:
        spec, params = _load_fallback(model_dir, config, model_type, dtype,
                                      device)
    if quantize == "int8":
        from ..ops.quant.int8 import quantize_layer_params

        params = quantize_layer_params(params)
    elif quantize in ("int8-outliers", "bitsandbytes"):
        from ..ops.quant.calibrate import collect_linear_input_absmax
        from ..ops.quant.int8 import quantize_layer_params

        calib_t = min(128, int(config.get("max_position_embeddings", 128)))
        calib_ids = _calibration_token_ids(model_dir, spec, calib_t)
        stats = collect_linear_input_absmax(spec, params, calib_ids)
        params = quantize_layer_params(params, outlier_stats=stats)
        _log_outlier_selection(params)
    elif quantize == "gptq" and not any(isinstance(v, Int4Weight)
                                        for v in params["layers"].values()):
        # closes the trap where QUANTIZE=gptq on an fp checkpoint would
        # silently serve full-precision weights
        raise ValueError(
            "QUANTIZE=gptq but the checkpoint has no GPTQ tensors "
            "(qweight/qzeros/scales); quantize it offline first "
            "(`text-generation-inference-tpu quantize`) or unset QUANTIZE")
    return spec, params
