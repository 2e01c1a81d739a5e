"""Decoder layer math in PyTorch (port of the JAX package's `models/core.py`).

The building blocks (`_norm`, `_rope_freqs`, `_apply_rope`, `_qkv`,
`_attn_out`, `_mlp`, `_embed`, `_unembed`) are shared with the paged
forward passes in `paged_core.py`. `DecoderSpec` is the same static
architecture description as in the JAX package; this slice runs the Llama
family (RoPE, RMSNorm, SiLU-GLU), and the forward passes raise
NotImplementedError for the position encodings and attention windows
that later slices port (ALiBi, learned positions, sliding windows).

Parameters are a plain dict of tensors with the JAX package's layout:
layer weights stacked along a leading layer axis, linear weights [in, out]
(`x @ W`). The JAX `lax.scan` over layers becomes a Python loop that takes
per-layer views (`layer_params`), which cost no copy in torch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..ops import linear as linops


@dataclasses.dataclass(frozen=True)
class DecoderSpec:
    """Static architecture description of a decoder-only model family."""

    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    # position encoding: "rope" | "alibi" | "learned"
    pos: str = "rope"
    rope_theta: float = 10000.0
    rope_scaling: float = 1.0     # linear position-interpolation factor
    rotary_pct: float = 1.0       # fraction of head_dim that rotates (neox)
    # True: GPT-J/CodeGen "rotate_every_two" pairing (even/odd lanes);
    # False: GPT-NeoX/Llama "rotate_half" (first/second half)
    rope_interleaved: bool = False
    pos_offset: int = 0           # learned-position lookup offset (OPT: 2)
    alibi_impl: str = "bloom"     # slope formula: "bloom" | "mpt"
    max_position_embeddings: int = 2048
    sliding_window: Optional[int] = None
    # norms
    norm: str = "rmsnorm"         # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-5
    embed_norm: bool = False      # extra LayerNorm after embedding (bloom)
    # mlp
    activation: str = "silu_glu"  # "silu_glu" | "gelu_glu" | "gelu" | "gelu_tanh"
    # structure
    parallel_residual: bool = False  # attn and mlp share the input (neox/falcon)
    embed_scale: float = 1.0      # multiply token embeddings (gemma: sqrt(D))
    qkv_clip: Optional[float] = None  # clamp q/k/v to [-clip, clip] (mpt)
    qkv_bias: bool = False
    attn_out_bias: bool = False
    mlp_bias: bool = False
    norm_bias: bool = False       # LayerNorm has bias (always true for layernorm)
    tie_word_embeddings: bool = False
    attn_softmax_in_f32: bool = True

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def rotary_dim(self) -> int:
        d = int(self.head_dim * self.rotary_pct)
        return d - d % 2


def check_supported(spec: DecoderSpec) -> None:
    """Raise NotImplementedError for architecture features this slice of
    the port does not run yet."""
    if spec.pos != "rope":
        raise NotImplementedError(
            f"position encoding {spec.pos!r} is not ported yet (rope only)")
    if spec.sliding_window is not None:
        raise NotImplementedError("sliding-window attention is not ported yet")
    if spec.embed_norm:
        raise NotImplementedError("embedding LayerNorm is not ported yet")


class KVCache(NamedTuple):
    """Slot-indexed dense KV view: k/v are [L, S, K, T, D] (bf16 or the
    model's float dtype; int8 KV is a later slice). The paged engine builds
    one per ring-decode chunk with `paged_core.gather_dense_view`."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]

    @property
    def num_slots(self) -> int:
        return self.k.shape[1]


def layer_params(layers: dict, i: int) -> dict:
    """Layer i's view of the layer-stacked parameter dict (no copy)."""
    return {k: (layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in layers.items()}


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _norm(spec: DecoderSpec, p: dict, x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    if spec.norm == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + spec.norm_eps)
    else:
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        out = (xf - mean) * torch.rsqrt(var + spec.norm_eps)
    out = out * p["scale"].to(torch.float32)
    if "bias" in p:
        out = out + p["bias"].to(torch.float32)
    return out.to(x.dtype)


def _activate(spec: DecoderSpec, up: torch.Tensor,
              gate: Optional[torch.Tensor]) -> torch.Tensor:
    act = spec.activation
    if act == "silu_glu":
        return F.silu(gate) * up
    if act == "gelu_glu":
        return F.gelu(gate, approximate="none") * up
    if act == "gelu_tanh_glu":
        return F.gelu(gate, approximate="tanh") * up
    if act == "gelu":
        return F.gelu(up, approximate="none")
    if act == "gelu_tanh":
        return F.gelu(up, approximate="tanh")
    if act == "relu":
        return F.relu(up)
    raise ValueError(f"unknown activation {act}")


def _rope_freqs(spec: DecoderSpec, positions: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for RoPE at the given positions ([..., rotary_dim]).

    Linear scaling divides positions by the scaling factor (reference:
    flash_llama_modeling.py LinearScaling rotary).
    """
    rd = spec.rotary_dim
    exps = torch.arange(0, rd, 2, dtype=torch.float32,
                        device=positions.device) / rd
    inv_freq = 1.0 / torch.pow(torch.tensor(spec.rope_theta, dtype=torch.float32,
                                            device=positions.device), exps)
    pos = positions.to(torch.float32) / spec.rope_scaling
    freqs = pos[..., None] * inv_freq
    if spec.rope_interleaved:
        emb = torch.repeat_interleave(freqs, 2, dim=-1)
    else:
        emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _apply_rope(spec: DecoderSpec, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    """x: [..., heads, head_dim]; cos/sin: [..., rotary_dim] (no head axis)."""
    rd = spec.rotary_dim
    x_rot, x_pass = x[..., :rd], x[..., rd:]
    if spec.rope_interleaved:
        x1 = x_rot[..., 0::2]
        x2 = x_rot[..., 1::2]
        rotated = torch.stack([-x2, x1], dim=-1).reshape(x_rot.shape)
    else:
        half = rd // 2
        x1, x2 = x_rot[..., :half], x_rot[..., half:]
        rotated = torch.cat([-x2, x1], dim=-1)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    x_rot = (x_rot.to(torch.float32) * cos
             + rotated.to(torch.float32) * sin).to(x.dtype)
    return torch.cat([x_rot, x_pass], dim=-1) if rd < x.shape[-1] else x_rot


def _embed(spec: DecoderSpec, params: dict, ids: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    x = params["embed_tokens"][ids.long()]
    if spec.embed_scale != 1.0:
        x = (x.to(torch.float32) * spec.embed_scale).to(x.dtype)
    return x


def _unembed(spec: DecoderSpec, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Final projection to [..., V] f32 logits."""
    if spec.tie_word_embeddings:
        logits = torch.matmul(x, params["embed_tokens"].t())
    else:
        logits = linops.matmul(x, params["lm_head"])
    return logits.to(torch.float32)


def _qkv(spec: DecoderSpec, lp: dict, x: torch.Tensor):
    """x: [..., D] -> q [..., H, Dh], k/v [..., K, Dh]."""
    if "w_qkv" in lp:
        qkv = linops.matmul(x, lp["w_qkv"])
        if "b_qkv" in lp:
            qkv = qkv + lp["b_qkv"]
        qs, ks = spec.q_size, spec.kv_size
        q = qkv[..., :qs]
        k = qkv[..., qs:qs + ks]
        v = qkv[..., qs + ks:]
    else:
        q = linops.matmul(x, lp["wq"])
        k = linops.matmul(x, lp["wk"])
        v = linops.matmul(x, lp["wv"])
        if spec.qkv_bias:
            q = q + lp["bq"]
            k = k + lp["bk"]
            v = v + lp["bv"]
    if spec.qkv_clip is not None:
        q = torch.clamp(q, -spec.qkv_clip, spec.qkv_clip)
        k = torch.clamp(k, -spec.qkv_clip, spec.qkv_clip)
        v = torch.clamp(v, -spec.qkv_clip, spec.qkv_clip)
    q = q.reshape(*x.shape[:-1], spec.num_heads, spec.head_dim)
    k = k.reshape(*x.shape[:-1], spec.num_kv_heads, spec.head_dim)
    v = v.reshape(*x.shape[:-1], spec.num_kv_heads, spec.head_dim)
    return q, k, v


def _attn_out(spec: DecoderSpec, lp: dict, attn: torch.Tensor) -> torch.Tensor:
    out = linops.matmul(attn.reshape(*attn.shape[:-2], spec.q_size), lp["wo"])
    if spec.attn_out_bias:
        out = out + lp["bo"]
    return out


def _mlp(spec: DecoderSpec, lp: dict, x: torch.Tensor) -> torch.Tensor:
    if "w_gu" in lp:
        gu = linops.matmul(x, lp["w_gu"])
        if "b_gu" in lp:
            gu = gu + lp["b_gu"]
        f = spec.intermediate_size
        gate, up = gu[..., :f], gu[..., f:]
    else:
        up = linops.matmul(x, lp["w_up"])
        if spec.mlp_bias:
            up = up + lp["b_up"]
        gate = None
        if spec.activation.endswith("_glu"):
            gate = linops.matmul(x, lp["w_gate"])
            if spec.mlp_bias:
                gate = gate + lp["b_gate"]
    h = _activate(spec, up, gate)
    out = linops.matmul(h, lp["w_down"])
    if spec.mlp_bias:
        out = out + lp["b_down"]
    return out


def _residual(spec: DecoderSpec, lp: dict, x: torch.Tensor,
              attn: torch.Tensor) -> torch.Tensor:
    """The post-attention half of a layer: residual add(s) and the MLP."""
    if spec.parallel_residual:
        h2 = _norm(spec, lp["ln2"], x)
        return x + attn + _mlp(spec, lp, h2)
    x = x + attn
    h2 = _norm(spec, lp["ln2"], x)
    return x + _mlp(spec, lp, h2)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def decode_ring_step(
    spec: DecoderSpec,
    params: dict,
    ids: torch.Tensor,          # [S] i32: last token per slot
    positions: torch.Tensor,    # [S] i32: position ids[s] will occupy
    cache: KVCache,             # read-only this chunk (holds pos < chunk_start)
    kbuf: torch.Tensor,         # [L, S, K, C, D] in-chunk keys (cols < step_idx valid)
    vbuf: torch.Tensor,         # [L, S, K, C, D]
    step_idx: int,              # step within the chunk
    chunk_start: torch.Tensor,  # [S] i32: positions[s] at chunk entry
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step of the ring-buffer chunk scheme: attention reads the
    read-only dense cache for pre-chunk context, the per-chunk ring buffer
    for in-chunk tokens, and the current token's k/v directly, as one
    softmax. The caller writes the ring into the pool once per chunk.

    Buffer col c of slot s holds the token at position chunk_start[s] + c;
    cols >= step_idx are invalid. Returns (logits [S, V] f32,
    k_all [L, S, K, D], v_all [L, S, K, D]) — the current token's per-layer
    k/v for the caller to write into the ring.
    """
    check_supported(spec)
    s = ids.shape[0]
    t_max = cache.max_seq
    n_buf = kbuf.shape[3]
    dev = ids.device
    x = _embed(spec, params, ids, positions)        # [S, D]
    cos, sin = _rope_freqs(spec, positions)

    key_pos = torch.arange(t_max, device=dev)
    cache_mask = key_pos[None, :] < chunk_start[:, None]           # [S, Tmax]
    buf_mask = torch.arange(n_buf, device=dev)[None, :] < step_idx  # [1, C]
    scale = 1.0 / math.sqrt(spec.head_dim)
    group = spec.num_heads // spec.num_kv_heads

    k_all, v_all = [], []
    for li in range(spec.num_layers):
        lp = layer_params(params["layers"], li)
        ck, cv = cache.k[li], cache.v[li]           # [S, K, Tmax, D]
        kb, vb = kbuf[li], vbuf[li]                 # [S, K, C, D]
        h = _norm(spec, lp["ln1"], x)
        q, k, v = _qkv(spec, lp, h)
        q = _apply_rope(spec, q, cos, sin)
        k = _apply_rope(spec, k, cos, sin)
        qg = q.reshape(s, spec.num_kv_heads, group, spec.head_dim)
        qf = qg.to(torch.float32)
        scores = torch.einsum("skgd,sktd->skgt", qf,
                              ck.to(torch.float32)) * scale
        scores = scores.masked_fill(~cache_mask[:, None, None, :], -math.inf)
        bscores = torch.einsum("skgd,skcd->skgc", qf,
                               kb.to(torch.float32)) * scale
        bscores = bscores.masked_fill(~buf_mask[:, None, None, :], -math.inf)
        score_new = torch.sum(qf * k[:, :, None, :].to(torch.float32),
                              dim=-1) * scale                 # [S, K, G]
        all_scores = torch.cat([scores, bscores, score_new[..., None]], -1)
        probs = torch.softmax(all_scores, dim=-1).to(v.dtype)
        attn = (torch.einsum("skgt,sktd->skgd", probs[..., :t_max],
                             cv.to(v.dtype))
                + torch.einsum("skgc,skcd->skgd",
                               probs[..., t_max:t_max + n_buf], vb.to(v.dtype))
                + probs[..., t_max + n_buf:] * v[:, :, None, :])
        attn = _attn_out(spec, lp, attn.reshape(s, spec.num_heads,
                                                spec.head_dim))
        x = _residual(spec, lp, x, attn)
        k_all.append(k)
        v_all.append(v)
    x = _norm(spec, params["final_norm"], x)
    logits = _unembed(spec, params, x)
    return logits, torch.stack(k_all), torch.stack(v_all)
