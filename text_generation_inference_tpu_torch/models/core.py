"""Decoder layer math in PyTorch (port of the JAX package's `models/core.py`).

The building blocks (`_norm`, `_rope_freqs`, `_apply_rope`, `_qkv`,
`_attn_out`, `_mlp`, `_embed`, `_unembed`, and the prefill layer loop
`prefill_forward`) are shared with the paged forward passes in
`paged_core.py`. The slot-cache passes (`prefill`, `decode` in its "post"
and "scan" write modes, `decode_ring_step`, `ring_flush`) write the
`KVCache` in place, where the JAX package donated it to each jitted step.
`DecoderSpec` is the same static architecture description as in the JAX
package; the port runs the Llama family (RoPE, RMSNorm, SiLU-GLU), and the
forward passes raise NotImplementedError for the position encodings and
attention windows that later slices port (ALiBi, learned positions,
sliding windows).

Parameters are a plain dict of tensors with the JAX package's layout:
layer weights stacked along a leading layer axis, linear weights [in, out]
(`x @ W`) or layer-stacked GPTQ `Int4Weight`s. The JAX `lax.scan` over
layers becomes a Python loop that takes per-layer views (`layer_params`),
which cost no copy in torch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..ops import linear as linops
from ..ops.attention import KERNELS, AttentionOps


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
    """Slot-indexed KV cache: k/v are [L, S, K, T, D] (the model's float
    dtype, or int8). The slot engine holds one for its whole batch; the
    paged engine builds a view per ring-decode chunk with
    `paged_core.gather_dense_view`.

    With int8 k/v, k_scale/v_scale are [L, S, K, T] f32 absmax/127 factors
    (symmetric per token per head, `quantize_kv`); the read path folds them
    into the scores and the probabilities (the scale factors out of the
    head_dim contraction)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, spec: DecoderSpec, num_slots: int, max_seq: int, dtype,
               device) -> "KVCache":
        shape = (spec.num_layers, num_slots, spec.num_kv_heads, max_seq,
                 spec.head_dim)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        if dtype == torch.int8:
            return cls(k=zeros(shape, dtype), v=zeros(shape, dtype),
                       k_scale=zeros(shape[:-1], torch.float32),
                       v_scale=zeros(shape[:-1], torch.float32))
        return cls(k=zeros(shape, dtype), v=zeros(shape, dtype))

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]

    @property
    def num_slots(self) -> int:
        return self.k.shape[1]


def layer_params(layers: dict, i: int, int4_plain: bool = False) -> dict:
    """Layer i's view of the layer-stacked parameter dict (no copy).
    `int4_plain` makes the GPTQ-INT4 views run their plain product
    (`ops.attention.PLAIN`)."""
    return {k: (layer_params(v, i, int4_plain) if isinstance(v, dict)
                else linops.layer_view(v, i, int4_plain))
            for k, v in layers.items()}


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., D] float → ([..., D] int8, [...] f32 scale): symmetric absmax
    over the head dim (per token per head). `torch.round` rounds half to
    even, as `jnp.round` does."""
    xf = x.to(torch.float32)
    sc = torch.clamp(torch.amax(torch.abs(xf), dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / sc[..., None]), -127, 127).to(torch.int8)
    return q, sc


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
        rows = x.numel() // x.shape[-1]
        if "b_gu" not in lp and not spec.mlp_bias and linops.can_fuse_mlp(
                lp["w_gu"], lp["w_down"], spec.activation, rows):
            # decode GPTQ-INT4 path under INT4_FUSED_MLP=1: gu product,
            # activation and down product as one launch (kernel M1)
            return linops.mlp_fused(x, lp["w_gu"], lp["w_down"],
                                    spec.activation)
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
# prefill
# ---------------------------------------------------------------------------


def prefill_forward(spec: DecoderSpec, params: dict, ids: torch.Tensor,
                    lengths: torch.Tensor, attn: AttentionOps,
                    write_kv: Callable[[int, torch.Tensor, torch.Tensor], None],
                    prefix_embeds: Optional[torch.Tensor] = None,
                    prefix_len: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The causal forward over a right-padded bucket ids [N, T]: attention
    within the bucket only, masked by `lengths`. Hands each layer's k/v
    ([N, T, K, D]) to `write_kv(layer, k, v)`, which stores them in the
    caller's cache. Returns [N, T, V] f32 logits at every position.

    Soft prompts (prompt tuning): with `prefix_embeds` [N, T, D], row n
    takes its first `prefix_len[n]` input vectors from `prefix_embeds`
    (cast to the activation dtype) instead of the token embeddings; the
    token ids there are placeholders."""
    check_supported(spec)
    n, t = ids.shape
    dev = ids.device
    positions = torch.arange(t, device=dev, dtype=torch.int32)[None, :].expand(n, t)
    x = _embed(spec, params, ids, positions)
    if prefix_embeds is not None:
        use_prefix = positions < prefix_len.to(dev)[:, None]
        x = torch.where(use_prefix[..., None], prefix_embeds.to(x.dtype), x)
    cos, sin = _rope_freqs(spec, positions)

    lengths = lengths.to(torch.int32)
    causal = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
    key_valid = positions < lengths[:, None]
    mask = causal[None, :, :] & key_valid[:, None, :]
    scale = 1.0 / math.sqrt(spec.head_dim)
    group = spec.num_heads // spec.num_kv_heads
    for li in range(spec.num_layers):
        lp = layer_params(params["layers"], li, attn.int4_plain)
        h = _norm(spec, lp["ln1"], x)
        q, k, v = _qkv(spec, lp, h)
        q = _apply_rope(spec, q, cos, sin)
        k = _apply_rope(spec, k, cos, sin)
        qg = q.reshape(n, t, spec.num_kv_heads, group, spec.head_dim)
        a = attn.prefill(qg, k, v, lengths, None, mask, scale)
        a = _attn_out(spec, lp, a.reshape(n, t, spec.num_heads, spec.head_dim))
        x = _residual(spec, lp, x, a)
        write_kv(li, k, v)
    x = _norm(spec, params["final_norm"], x)
    return _unembed(spec, params, x)


def prefill(
    spec: DecoderSpec,
    params: dict,
    ids: torch.Tensor,        # [N, T] i32, right-padded to the bucket length
    lengths: torch.Tensor,    # [N] i32 true lengths
    slots: torch.Tensor,      # [N] i32 target cache slots
    cache: KVCache,
    attn: AttentionOps = KERNELS,
    prefix_embeds: Optional[torch.Tensor] = None,  # [N, T, D] soft prompts
    prefix_len: Optional[torch.Tensor] = None,     # [N] i32 prefix positions
) -> tuple[torch.Tensor, KVCache]:
    """Full causal forward over a padded bucket; writes each layer's K/V
    into rows 0..T-1 of the `slots` of the cache, in place (quantized on the
    way in over an int8 cache). Rows past a prompt's length hold padding
    garbage that decode masks by context length, as in the JAX package.
    Rows with a soft prompt take its vectors at positions < prefix_len
    (`prefill_forward`). Returns ([N, T, V] f32 logits at every position,
    cache)."""
    rows = min(ids.shape[1], cache.max_seq)
    sl = slots.long()

    def write_kv(li, k, v):
        k_t = k[:, :rows].transpose(1, 2)               # [N, K, rows, D]
        v_t = v[:, :rows].transpose(1, 2)
        if cache.quantized:
            k_t, ksc = quantize_kv(k_t)
            v_t, vsc = quantize_kv(v_t)
            cache.k_scale[li][sl, :, :rows] = ksc
            cache.v_scale[li][sl, :, :rows] = vsc
        cache.k[li][sl, :, :rows] = k_t.to(cache.k.dtype)
        cache.v[li][sl, :, :rows] = v_t.to(cache.v.dtype)

    return prefill_forward(spec, params, ids, lengths, attn, write_kv,
                           prefix_embeds, prefix_len), cache


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
    ring_attention: Optional[Callable] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step of the ring-buffer chunk scheme: attention reads the
    read-only dense cache for pre-chunk context, the per-chunk ring buffer
    for in-chunk tokens, and the current token's k/v directly, as one
    softmax. The caller writes the ring into the cache once per chunk.

    The cache may be a view of the first rows of a longer cache (a context
    bucket): any strides are read as they are.

    Buffer col c of slot s holds the token at position chunk_start[s] + c;
    cols >= step_idx are invalid. Returns (logits [S, V] f32,
    k_all [L, S, K, D], v_all [L, S, K, D]) — the current token's per-layer
    k/v for the caller to write into the ring.

    Attention is computed inline (the engines' formulation, as in the JAX
    package), or, when `ring_attention` is given (`AttentionOps.ring_decode`
    over a float cache), by that one call per layer: the decode probe's
    kernel mode.
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
    if ring_attention is not None:
        if cache.quantized:
            raise ValueError("ring_attention reads a float cache")
        ctx = chunk_start.to(torch.int32).contiguous()

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
        if ring_attention is not None:
            attn = ring_attention(qg.contiguous(), ck, cv, kb, vb,
                                  k.contiguous(), v.contiguous(), ctx,
                                  step_idx)
        else:
            qf = qg.to(torch.float32)
            scores = torch.einsum("skgd,sktd->skgt", qf,
                                  ck.to(torch.float32)) * scale
            if cache.quantized:
                scores = scores * cache.k_scale[li][:, :, None, :]
            scores = scores.masked_fill(~cache_mask[:, None, None, :],
                                        -math.inf)
            bscores = torch.einsum("skgd,skcd->skgc", qf,
                                   kb.to(torch.float32)) * scale
            bscores = bscores.masked_fill(~buf_mask[:, None, None, :],
                                          -math.inf)
            score_new = torch.sum(qf * k[:, :, None, :].to(torch.float32),
                                  dim=-1) * scale                 # [S, K, G]
            all_scores = torch.cat([scores, bscores, score_new[..., None]],
                                   -1)
            probs = torch.softmax(all_scores, dim=-1).to(v.dtype)
            pc = probs[..., :t_max]
            if cache.quantized:
                pc = pc * cache.v_scale[li][:, :, None, :].to(pc.dtype)
            attn = (torch.einsum("skgt,sktd->skgd", pc, cv.to(v.dtype))
                    + torch.einsum("skgc,skcd->skgd",
                                   probs[..., t_max:t_max + n_buf],
                                   vb.to(v.dtype))
                    + probs[..., t_max + n_buf:] * v[:, :, None, :])
        attn = _attn_out(spec, lp, attn.reshape(s, spec.num_heads,
                                                spec.head_dim))
        x = _residual(spec, lp, x, attn)
        k_all.append(k)
        v_all.append(v)
    x = _norm(spec, params["final_norm"], x)
    logits = _unembed(spec, params, x)
    return logits, torch.stack(k_all), torch.stack(v_all)


def ring_flush(cache: KVCache, kbuf: torch.Tensor, vbuf: torch.Tensor,
               chunk_start: torch.Tensor) -> KVCache:
    """Scatter a chunk's ring buffers into the cache, in place: buffer col
    c of slot s lands at position chunk_start[s] + c. Positions at or past
    max_seq are dropped, as JAX's mode="drop" drops them (requests never
    legitimately reach them; slots past their end within a chunk do).
    Over an int8 cache the full-precision ring is quantized here, once per
    chunk.

    Without a host sync: a dropped (c, s) is redirected to col 0 of slot s
    (position chunk_start[s], always in range), which the kept write of col
    0 also targets with the same values, so the one scatter stays
    deterministic whichever duplicate lands last."""
    n_buf, s = kbuf.shape[3], kbuf.shape[1]
    t_max = cache.max_seq
    dev = kbuf.device
    start = chunk_start.to(torch.int64)[None, :]                   # [1, S]
    cols = torch.arange(n_buf, device=dev)[:, None]                # [C, 1]
    drop = start + cols >= t_max                                   # [C, S]
    wpos = torch.where(drop, start, start + cols)
    src_col = torch.where(drop, 0, cols)
    rows = torch.arange(s, device=dev)[None, :].expand(n_buf, s)
    pairs = [(cache.k, kbuf), (cache.v, vbuf)]
    if cache.quantized:
        kq, ksc = quantize_kv(kbuf)
        vq, vsc = quantize_kv(vbuf)
        pairs = [(cache.k, kq), (cache.v, vq), (cache.k_scale, ksc),
                 (cache.v_scale, vsc)]
    for dst, src in pairs:
        # advanced indices (C, S) at axes 1 and 3 move to the front: the
        # region is [C, S, L, K(, D)] on both sides
        dst[:, rows, :, wpos] = src[:, rows, :, src_col].to(dst.dtype)
    return cache


def decode(
    spec: DecoderSpec,
    params: dict,
    ids: torch.Tensor,          # [S] i32: last token per slot
    positions: torch.Tensor,    # [S] i32: position at which ids[s] is written
    cache: KVCache,
    context_len: torch.Tensor,  # [S] i32: = positions + 1
    write_mode: str = "post",
    attn: AttentionOps = KERNELS,
) -> tuple[torch.Tensor, KVCache]:
    """One decode step over every slot; writes the new k/v at `positions`
    in place. Returns ([S, V] f32 logits, cache). Inactive slots recompute
    garbage into their own slot (positions are clipped by the caller), which
    the next prefill overwrites, as in the JAX package.

    `write_mode`:
      * "post": attention is an explicit einsum over the read-only cache
        plus the new column; ONE write per step after the layer loop.
      * "scan": each layer writes its k/v first, then attends through
        `attn.slot_decode` (`ops.attention.decode_attention`: the
        slot-cache kernel S1 at T >= 2048, the einsum below).
    The float cache only: an int8 cache is written by `ring_flush`.
    """
    check_supported(spec)
    if cache.quantized:
        raise ValueError("decode has no int8 write path; int8 caches are "
                         "written by the ring chunks (ring_flush)")
    if write_mode not in ("post", "scan"):
        raise ValueError(f"unknown decode write_mode {write_mode!r}")
    s = ids.shape[0]
    t_max = cache.max_seq
    dev = ids.device
    x = _embed(spec, params, ids, positions)        # [S, D]
    cos, sin = _rope_freqs(spec, positions)
    key_pos = torch.arange(t_max, device=dev)
    scale = 1.0 / math.sqrt(spec.head_dim)
    group = spec.num_heads // spec.num_kv_heads
    rows = torch.arange(s, device=dev)
    pos = positions.long()
    old_mask = key_pos[None, :] < positions[:, None]        # current excluded
    mask = key_pos[None, :] < context_len[:, None]
    ctx = context_len.to(torch.int32).contiguous()

    k_all, v_all = [], []
    for li in range(spec.num_layers):
        lp = layer_params(params["layers"], li, attn.int4_plain)
        ck, cv = cache.k[li], cache.v[li]           # [S, K, Tmax, D] views
        h = _norm(spec, lp["ln1"], x)
        q, k, v = _qkv(spec, lp, h)
        q = _apply_rope(spec, q, cos, sin)
        k = _apply_rope(spec, k, cos, sin)
        qg = q.reshape(s, spec.num_kv_heads, group, spec.head_dim)
        if write_mode == "scan":
            ck[rows, :, pos] = k.to(ck.dtype)
            cv[rows, :, pos] = v.to(cv.dtype)
            a = attn.slot_decode(qg, ck, cv, ctx, None, mask, scale)
        else:
            qf = qg.to(torch.float32)
            scores = torch.einsum("skgd,sktd->skgt", qf,
                                  ck.to(torch.float32)) * scale
            scores = scores.masked_fill(~old_mask[:, None, None, :],
                                        -math.inf)
            score_new = torch.sum(qf * k[:, :, None, :].to(torch.float32),
                                  dim=-1) * scale             # [S, K, G]
            probs = torch.softmax(
                torch.cat([scores, score_new[..., None]], -1),
                dim=-1).to(cv.dtype)
            a = (torch.einsum("skgt,sktd->skgd", probs[..., :t_max], cv)
                 + probs[..., t_max:] * v[:, :, None, :].to(cv.dtype))
            k_all.append(k)
            v_all.append(v)
        a = _attn_out(spec, lp, a.reshape(s, spec.num_heads, spec.head_dim))
        x = _residual(spec, lp, x, a)
    if write_mode == "post":
        # advanced indices separated by a slice move to the front: the
        # region is [S, L, K, D]
        cache.k[:, rows, :, pos] = torch.stack(k_all, 1).to(cache.k.dtype)
        cache.v[:, rows, :, pos] = torch.stack(v_all, 1).to(cache.v.dtype)
    x = _norm(spec, params["final_norm"], x)
    return _unembed(spec, params, x), cache
