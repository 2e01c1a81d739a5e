"""Decoder layer math in PyTorch (port of the JAX package's `models/core.py`).

The building blocks (`_norm`, `_rope_freqs`, `_apply_rope`, `_qkv`,
`_attn_out`, `_mlp`, `_embed`, `_unembed`, and the prefill layer loop
`prefill_forward`, and the speculative verification's `verify_forward`)
are shared with the paged forward passes in `paged_core.py`. The
slot-cache passes (`prefill`, `decode` in its "post" and "scan" write
modes, `decode_ring_step`, `ring_flush`, `verify_chunk`) write the
`KVCache` in place, where the JAX package donated it to each jitted step.
`DecoderSpec` is the same static architecture description as in the JAX
package, and every position encoding it names runs: RoPE, learned
positions (with OPT's offset and its `project_in` / `project_out`) and
ALiBi, with BLOOM's embedding LayerNorm.

A sliding window of W keys masks what the JAX package's forward passes
mask: in prefill, key j is visible to a real query row i when
i - W < j <= i (rows past a prompt's length keep the causal mask), and in
decode the keys at or past context_len - W. The kernels that the JAX rule
routes a windowed model to take the window too (`ops/attention.py`).

ALiBi adds slope[h] * j to the scaled score of key position j, as the JAX
package's bias does (its `alibi_slopes`: the bloom and mpt formulas). The
forward passes hand the attention dispatch the slopes as one [K, G] f32
tensor a model (`alibi_slopes_kg`, built once per spec and device, so that
a captured decode graph reads a fixed address); the einsum paths build the
JAX package's dense bias from it and the kernels add the term themselves
(`ops/attention.py`). The ring step's inline attention adds the bias to
the cache part, the ring and the current token, as in the JAX package.

Tensor parallelism: on a rank's local spec (`spec.tp`, set by
`parallel.sharding.shard_model`) the head and MLP widths are the rank's,
and the building blocks place the collectives that GSPMD places in the
JAX package: the vocab-split embedding lookup and the row-parallel
products (wo, w_down) all-reduced, the vocab-split logits gathered, the
kv heads a rank attends with picked from a whole k / v product
(`_qkv`, `_row_linear`, `_embed`, `_unembed`).

Parameters are a plain dict of tensors with the JAX package's layout:
layer weights stacked along a leading layer axis, linear weights [in, out]
(`x @ W`) or layer-stacked GPTQ `Int4Weight`s. The JAX `lax.scan` over
layers becomes a Python loop that takes per-layer views (`layer_params`),
which cost no copy in torch.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import TYPE_CHECKING, Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import linear as linops
from ..ops.attention import KERNELS, AttentionOps, alibi_bias

if TYPE_CHECKING:
    from ..parallel.sharding import TPShard


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
    # a tensor-parallel rank's layout (`parallel.sharding.TPShard`), on the
    # rank's local spec (`parallel.sharding.shard_model`): its head and MLP
    # widths above are then the rank's own, and the layer code places the
    # collectives this layout calls for. None on an unsharded model.
    tp: Optional["TPShard"] = None

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


def _tp(spec) -> Optional["TPShard"]:
    """A rank's layout, or None (also for a spec without the field: the
    tests hand the layer code the JAX package's spec)."""
    return getattr(spec, "tp", None)


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
    # a Python scalar base: no host-to-device copy (a decode step is captured)
    inv_freq = 1.0 / torch.pow(float(spec.rope_theta), exps)
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


def alibi_slopes(num_heads: int, impl: str = "bloom") -> np.ndarray:
    """ALiBi head slopes, f32 [num_heads] (the JAX package's `alibi_slopes`,
    after the reference's bloom_modeling.py:104).

    impl="mpt" uses MPT's ceil-power-of-two formula with the even/odd
    reorder (HF MptModel.build_mpt_alibi_tensor, alibi_bias_max=8); for
    power-of-two head counts the two formulas coincide, otherwise the
    slope assignment differs per head."""
    if impl == "mpt":
        pow2 = 2 ** math.ceil(math.log2(num_heads))
        base = np.arange(1, pow2 + 1, dtype=np.float64) * (8.0 / pow2)
        slopes = 1.0 / np.exp2(base)
        if pow2 != num_heads:
            slopes = np.concatenate([slopes[1::2], slopes[0::2]])[:num_heads]
        return slopes.astype(np.float32)
    closest = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = [base ** i for i in range(1, closest + 1)]
    if closest < num_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        slopes += [extra_base ** i
                   for i in range(1, 2 * (num_heads - closest), 2)]
    return np.asarray(slopes, np.float32)


@functools.lru_cache(maxsize=None)
def alibi_slopes_kg(spec: DecoderSpec, device) -> Optional[torch.Tensor]:
    """The spec's ALiBi slopes as a [K, G] f32 tensor on `device` (query
    head h = k * G + g), or None for a spec without ALiBi. Built once per
    (spec, device) and kept, so that every forward pass, and every captured
    decode graph, reads the same tensor."""
    if spec.pos != "alibi":
        return None
    group = spec.num_heads // spec.num_kv_heads
    tp = _tp(spec)
    if tp is None:
        slopes = alibi_slopes(spec.num_heads, spec.alibi_impl)
    else:
        # a rank's query heads are the model's heads head_offset onwards:
        # their slopes, not those of heads 0.. of a smaller model
        slopes = alibi_slopes(tp.num_heads, spec.alibi_impl)[
            tp.head_offset:tp.head_offset + spec.num_heads]
    return torch.from_numpy(np.ascontiguousarray(slopes)).reshape(
        spec.num_kv_heads, group).to(device)


@functools.lru_cache(maxsize=None)
def _kv_index(tp: "TPShard", device) -> torch.Tensor:
    """A rank's `kv_index` as a tensor on `device`, built once (a captured
    decode graph reads a fixed address)."""
    return torch.tensor(tp.kv_index, dtype=torch.long).to(device)


def _embed(spec: DecoderSpec, params: dict, ids: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    """Token embeddings, projected up (OPT's `project_in`), scaled, plus
    learned positions at `positions + pos_offset`, then the embedding
    LayerNorm (BLOOM). A position past the table reads its last row (the
    JAX package's gather fills it; only dead slots reach it).

    On a rank with the vocab split (`spec.tp.embed_split`) each rank looks
    up the ids in its block of rows, zeros for the rest, and the sum over
    the ranks is every id's row, exactly (one rank adds it to zeros)."""
    table = params["embed_tokens"]
    tp = _tp(spec)
    if tp is not None and tp.embed_split:
        n = table.shape[0]
        local = ids.long() - tp.rank * n
        inside = (local >= 0) & (local < n)
        x = table[local.clamp(0, n - 1)].masked_fill(~inside[..., None], 0)
        x = tp.comm.all_reduce(x)
    else:
        x = table[ids.long()]
    if "project_in" in params:
        x = torch.matmul(x, params["project_in"])
    if spec.embed_scale != 1.0:
        x = (x.to(torch.float32) * spec.embed_scale).to(x.dtype)
    if spec.pos == "learned":
        table = params["embed_positions"]
        idx = (positions.long() + spec.pos_offset).clamp(0, table.shape[0] - 1)
        x = x + table[idx]
    if spec.embed_norm:
        p = params["embed_ln"]
        xf = x.to(torch.float32)
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        xf = (xf - mean) * torch.rsqrt(var + spec.norm_eps)
        x = (xf * p["scale"].to(torch.float32)
             + p["bias"].to(torch.float32)).to(x.dtype)
    return x


def _unembed(spec: DecoderSpec, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Final projection to [..., V] f32 logits (through OPT's
    `project_out` first where the model has one). A rank with the vocab
    split gathers every rank's block of the logits (the bias, whole on
    every rank, is added after)."""
    if "project_out" in params:
        x = torch.matmul(x, params["project_out"])
    if spec.tie_word_embeddings:
        logits = torch.matmul(x, params["embed_tokens"].t())
    else:
        logits = linops.matmul(x, params["lm_head"])
    logits = logits.to(torch.float32)
    tp = _tp(spec)
    if tp is not None and tp.head_split:
        logits = tp.comm.all_gather_last(logits)
    if "lm_head_bias" in params:
        logits = logits + params["lm_head_bias"].to(torch.float32)
    return logits


def _rotary(spec: DecoderSpec, positions: torch.Tensor):
    """(cos, sin) for a RoPE spec, or None: learned positions and ALiBi
    rotate nothing."""
    return _rope_freqs(spec, positions) if spec.pos == "rope" else None


def _rotate(spec: DecoderSpec, q: torch.Tensor, k: torch.Tensor, rope):
    if rope is None:
        return q, k
    cos, sin = rope
    return _apply_rope(spec, q, cos, sin), _apply_rope(spec, k, cos, sin)


def _qkv(spec: DecoderSpec, lp: dict, x: torch.Tensor):
    """x: [..., D] -> q [..., H, Dh], k/v [..., K, Dh]. On a rank whose
    query heads are split but whose wk / wv stayed whole, k and v are cut
    to the kv heads its query heads read (`TPShard.kv_index`)."""
    tp = _tp(spec)
    kv_heads = spec.num_kv_heads if tp is None else tp.kv_heads_in
    if "w_qkv" in lp:
        qkv = linops.matmul(x, lp["w_qkv"])
        if "b_qkv" in lp:
            qkv = qkv + lp["b_qkv"]
        qs, ks = spec.q_size, kv_heads * spec.head_dim
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
    k = k.reshape(*x.shape[:-1], kv_heads, spec.head_dim)
    v = v.reshape(*x.shape[:-1], kv_heads, spec.head_dim)
    if tp is not None and tp.kv_index is not None:
        idx = _kv_index(tp, k.device)
        k, v = k.index_select(-2, idx), v.index_select(-2, idx)
    return q, k, v


def _row_linear(spec: DecoderSpec, x: torch.Tensor, w,
                name: str) -> torch.Tensor:
    """x @ w for a row-parallel weight (`name` "wo" or "w_down"), whole on
    every rank. Unsharded, the product. On a rank (`spec.tp`), x may be the
    rank's block of the product's input (query heads or MLP columns split)
    and w the rank's block of rows. A split weight gives a partial sum,
    all-reduced; a whole weight (an INT4 fallback) takes the whole input,
    all-gathered, and reduces nothing. A split weight with a whole input
    takes the rank's block of it; under act-order the whole input is
    permuted first (the permutation is global: the rank's rows read
    features other ranks hold)."""
    tp = _tp(spec)
    if tp is None:
        return linops.matmul(x, w)
    split_in, row = ((tp.attn_split, tp.wo_row) if name == "wo"
                     else (tp.mlp_split, tp.down_row))
    if not row:
        if split_in:
            x = tp.comm.all_gather_last(x)
        return linops.matmul(x, w)
    perm = linops.input_perm(w)
    if perm is not None or not split_in:
        if split_in:
            x = tp.comm.all_gather_last(x)
        if perm is not None:
            x, w = x[..., perm.long()], linops.drop_perm(w)
        n = x.shape[-1] // tp.world
        x = x.narrow(-1, tp.rank * n, n)
    return tp.comm.all_reduce(
        linops.matmul(x, w, in_offset=tp.rank * x.shape[-1]))


def _attn_out(spec: DecoderSpec, lp: dict, attn: torch.Tensor) -> torch.Tensor:
    out = _row_linear(spec, attn.reshape(*attn.shape[:-2], spec.q_size),
                      lp["wo"], "wo")
    if spec.attn_out_bias:
        out = out + lp["bo"]
    return out


def _mlp(spec: DecoderSpec, lp: dict, x: torch.Tensor) -> torch.Tensor:
    tp = _tp(spec)
    if "w_gu" in lp:
        rows = x.numel() // x.shape[-1]
        if "b_gu" not in lp and not spec.mlp_bias and linops.can_fuse_mlp(
                lp["w_gu"], lp["w_down"], spec.activation, rows):
            # decode GPTQ-INT4 path under INT4_FUSED_MLP=1: gu product,
            # activation and down product as one launch (kernel M1); on a
            # rank whose pair is split, a partial sum
            out = linops.mlp_fused(x, lp["w_gu"], lp["w_down"],
                                   spec.activation)
            return (tp.comm.all_reduce(out) if tp is not None
                    and tp.down_row else out)
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
    out = _row_linear(spec, h, lp["w_down"], "w_down")
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
                    prefix_len: Optional[torch.Tensor] = None,
                    window: Optional[int] = None,
                    return_hidden: bool = False):
    """The causal forward over a right-padded bucket ids [N, T]: attention
    within the bucket only, masked by `lengths`. Hands each layer's k/v
    ([N, T, K, D]) to `write_kv(layer, k, v)`, which stores them in the
    caller's cache. Returns [N, T, V] f32 logits at every position, and
    with `return_hidden` also the final-norm hidden states [N, T, D] (they
    seed the speculator).

    Soft prompts (prompt tuning): with `prefix_embeds` [N, T, D], row n
    takes its first `prefix_len[n]` input vectors from `prefix_embeds`
    (cast to the activation dtype) instead of the token embeddings; the
    token ids there are placeholders.

    `window` (the spec's sliding window, or None): a real query row i sees
    keys i - window < j <= i; rows past a prompt's length keep the causal
    mask, as in the JAX package (an all-masked padded row would mint NaNs
    that reach later layers through 0 * NaN). The JAX slot-cache prefill
    applies the window, its paged prefill does not (the paged engine
    refuses max_seq > window, where the window masks nothing).

    An ALiBi spec hands the dispatch its slopes (`alibi_slopes_kg`)."""
    n, t = ids.shape
    dev = ids.device
    positions = torch.arange(t, device=dev, dtype=torch.int32)[None, :].expand(n, t)
    x = _embed(spec, params, ids, positions)
    if prefix_embeds is not None:
        use_prefix = positions < prefix_len.to(dev)[:, None]
        x = torch.where(use_prefix[..., None], prefix_embeds.to(x.dtype), x)
    rope = _rotary(spec, positions)
    slopes = alibi_slopes_kg(spec, dev)

    lengths = lengths.to(torch.int32)
    causal = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
    key_valid = positions < lengths[:, None]
    mask = causal[None, :, :] & key_valid[:, None, :]
    if window is not None:
        qi = torch.arange(t, device=dev)
        in_window = (qi[:, None] - qi[None, :]) < window
        mask = mask & (in_window[None, :, :] | ~key_valid[:, :, None])
    scale = 1.0 / math.sqrt(spec.head_dim)
    group = spec.num_heads // spec.num_kv_heads
    for li in range(spec.num_layers):
        lp = layer_params(params["layers"], li, attn.int4_plain)
        h = _norm(spec, lp["ln1"], x)
        q, k, v = _qkv(spec, lp, h)
        q, k = _rotate(spec, q, k, rope)
        qg = q.reshape(n, t, spec.num_kv_heads, group, spec.head_dim)
        a = attn.prefill(qg, k, v, lengths, slopes, mask, scale, window or 0)
        a = _attn_out(spec, lp, a.reshape(n, t, spec.num_heads, spec.head_dim))
        x = _residual(spec, lp, x, a)
        write_kv(li, k, v)
    x = _norm(spec, params["final_norm"], x)
    logits = _unembed(spec, params, x)
    return (logits, x) if return_hidden else logits


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
    return_hidden: bool = False,
):
    """Full causal forward over a padded bucket; writes each layer's K/V
    into rows 0..T-1 of the `slots` of the cache, in place (quantized on the
    way in over an int8 cache). Rows past a prompt's length hold padding
    garbage that decode masks by context length, as in the JAX package.
    Rows with a soft prompt take its vectors at positions < prefix_len
    (`prefill_forward`). Returns ([N, T, V] f32 logits at every position,
    cache), or with `return_hidden` (logits, the final-norm hidden states
    [N, T, D], cache)."""
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

    out = prefill_forward(spec, params, ids, lengths, attn, write_kv,
                          prefix_embeds, prefix_len, spec.sliding_window,
                          return_hidden)
    return (*out, cache) if return_hidden else (out, cache)


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
    s = ids.shape[0]
    t_max = cache.max_seq
    n_buf = kbuf.shape[3]
    dev = ids.device
    x = _embed(spec, params, ids, positions)        # [S, D]
    rope = _rotary(spec, positions)

    key_pos = torch.arange(t_max, device=dev)
    cache_mask = key_pos[None, :] < chunk_start[:, None]           # [S, Tmax]
    buf_mask = torch.arange(n_buf, device=dev)[None, :] < step_idx  # [1, C]
    if spec.sliding_window is not None:
        lo = positions[:, None] - spec.sliding_window              # exclusive
        cache_mask = cache_mask & (key_pos[None, :] > lo)
        buf_pos = chunk_start[:, None] + torch.arange(n_buf, device=dev)[None, :]
        buf_mask = buf_mask & (buf_pos > lo)                       # [S, C]
    scale = 1.0 / math.sqrt(spec.head_dim)
    group = spec.num_heads // spec.num_kv_heads
    slopes = alibi_slopes_kg(spec, dev)
    if slopes is not None:
        # the cache part, the ring and the current token each get their
        # bias, at the absolute positions of their keys
        cache_bias = alibi_bias(slopes, key_pos)[None]          # [1,K,G,T]
        buf_pos = chunk_start[:, None] + torch.arange(n_buf, device=dev)
        buf_bias = alibi_bias(slopes, buf_pos)                  # [S,K,G,C]
        new_bias = alibi_bias(slopes, positions[:, None])[..., 0]  # [S,K,G]
    if ring_attention is not None:
        if cache.quantized:
            raise ValueError("ring_attention reads a float cache")
        if spec.sliding_window is not None or slopes is not None:
            raise ValueError("ring_attention takes no sliding window and "
                             "no ALiBi")
        ctx = chunk_start.to(torch.int32).contiguous()

    k_all, v_all = [], []
    for li in range(spec.num_layers):
        lp = layer_params(params["layers"], li)
        ck, cv = cache.k[li], cache.v[li]           # [S, K, Tmax, D]
        kb, vb = kbuf[li], vbuf[li]                 # [S, K, C, D]
        h = _norm(spec, lp["ln1"], x)
        q, k, v = _qkv(spec, lp, h)
        q, k = _rotate(spec, q, k, rope)
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
            bscores = torch.einsum("skgd,skcd->skgc", qf,
                                   kb.to(torch.float32)) * scale
            score_new = torch.sum(qf * k[:, :, None, :].to(torch.float32),
                                  dim=-1) * scale                 # [S, K, G]
            if slopes is not None:
                scores = scores + cache_bias
                bscores = bscores + buf_bias
                score_new = score_new + new_bias
            scores = scores.masked_fill(~cache_mask[:, None, None, :],
                                        -math.inf)
            bscores = bscores.masked_fill(~buf_mask[:, None, None, :],
                                          -math.inf)
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
        slot-cache kernel S1 at T >= 2048, the einsum below), with the
        ALiBi slopes of an ALiBi spec.
    The float cache only: an int8 cache is written by `ring_flush`.
    """
    if cache.quantized:
        raise ValueError("decode has no int8 write path; int8 caches are "
                         "written by the ring chunks (ring_flush)")
    if write_mode not in ("post", "scan"):
        raise ValueError(f"unknown decode write_mode {write_mode!r}")
    s = ids.shape[0]
    t_max = cache.max_seq
    dev = ids.device
    x = _embed(spec, params, ids, positions)        # [S, D]
    rope = _rotary(spec, positions)
    key_pos = torch.arange(t_max, device=dev)
    scale = 1.0 / math.sqrt(spec.head_dim)
    group = spec.num_heads // spec.num_kv_heads
    rows = torch.arange(s, device=dev)
    pos = positions.long()
    old_mask = key_pos[None, :] < positions[:, None]        # current excluded
    mask = key_pos[None, :] < context_len[:, None]
    window = spec.sliding_window
    if window is not None:
        old_mask = old_mask & (key_pos[None, :] > positions[:, None] - window)
        mask = mask & (key_pos[None, :] >= context_len[:, None] - window)
    ctx = context_len.to(torch.int32).contiguous()
    # the slot kernel's lower bounds: the first row of each slot's window
    lo = (ctx - window).clamp(min=0) if window is not None else None
    slopes = alibi_slopes_kg(spec, dev)
    if slopes is not None and write_mode == "post":
        cache_bias = alibi_bias(slopes, key_pos)[None]          # [1,K,G,T]
        new_bias = alibi_bias(slopes, positions[:, None])[..., 0]  # [S,K,G]

    k_all, v_all = [], []
    for li in range(spec.num_layers):
        lp = layer_params(params["layers"], li, attn.int4_plain)
        ck, cv = cache.k[li], cache.v[li]           # [S, K, Tmax, D] views
        h = _norm(spec, lp["ln1"], x)
        q, k, v = _qkv(spec, lp, h)
        q, k = _rotate(spec, q, k, rope)
        qg = q.reshape(s, spec.num_kv_heads, group, spec.head_dim)
        if write_mode == "scan":
            ck[rows, :, pos] = k.to(ck.dtype)
            cv[rows, :, pos] = v.to(cv.dtype)
            a = attn.slot_decode(qg, ck, cv, ctx, slopes, mask, scale, lo)
        else:
            qf = qg.to(torch.float32)
            scores = torch.einsum("skgd,sktd->skgt", qf,
                                  ck.to(torch.float32)) * scale
            score_new = torch.sum(qf * k[:, :, None, :].to(torch.float32),
                                  dim=-1) * scale             # [S, K, G]
            if slopes is not None:
                scores = scores + cache_bias
                score_new = score_new + new_bias
            scores = scores.masked_fill(~old_mask[:, None, None, :],
                                        -math.inf)
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


# ---------------------------------------------------------------------------
# speculative verification
# ---------------------------------------------------------------------------


def write_chunk(ck: torch.Tensor, cv: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, positions: torch.Tensor,
                kv_major: bool = False) -> None:
    """Scatter C candidate rows per slot into one layer's keys and values,
    in place: k/v [S, C, K, D] land at rows positions [S, C] of ck/cv,
    [S, K, T, D] (or [K, S, T, D] with `kv_major`). Rows at or past T are
    dropped, as JAX's mode="drop" drops them, without a host sync: a
    dropped (s, c) is redirected to col 0 at positions[s, 0], which the
    kept write of col 0 also targets with the same values (a slot whose
    first row lies past T writes its col 0 into row T - 1 of its own keys;
    only a dead slot of a gathered view gets there, and its outputs are
    discarded)."""
    s, c = positions.shape
    t = ck.shape[2]
    pos = positions.to(torch.int64)
    drop = pos >= t
    dst = torch.where(drop, pos[:, :1].clamp(max=t - 1), pos)
    src = torch.where(drop, 0, torch.arange(c, device=pos.device)[None, :])
    rows = torch.arange(s, device=pos.device)[:, None]
    for cache, new in ((ck, k), (cv, v)):
        rows_new = new[rows, src].to(cache.dtype)               # [S, C, K, D]
        if kv_major:
            # adjacent advanced indices stay in place: [K, S, C, D]
            cache[:, rows, dst] = rows_new.permute(2, 0, 1, 3)
        else:
            # indices split by a slice move to the front: [S, C, K, D]
            cache[rows, :, dst] = rows_new


def verify_attention(spec: DecoderSpec, qg: torch.Tensor, ck: torch.Tensor,
                     cv: torch.Tensor, positions: torch.Tensor, scale: float,
                     kv_major: bool = False) -> torch.Tensor:
    """The JAX package's verify attention: qg [S, C, K, G, D] against one
    layer's keys and values ck/cv [S, K, T, D] (or [K, S, T, D] with
    `kv_major`: the product batches over the keys' own order, so no copy
    of them is made but their f32 upcast), the chunk's rows already
    written. Key j is visible to candidate c iff j <= positions[s, c] (and
    within the sliding window, where the spec has one); an ALiBi spec adds
    slope * j. Scores and softmax in f32, probabilities cast to the values'
    dtype for the value product. Returns [S, C, K, G, D]."""
    s, c, kh, g, d = qg.shape
    t = ck.shape[2]
    key_pos = torch.arange(t, device=qg.device)
    mask = key_pos[None, None, :] <= positions[:, :, None]          # [S, C, T]
    if spec.sliding_window is not None:
        mask = mask & (key_pos[None, None, :]
                       > positions[:, :, None] - spec.sliding_window)
    q = qg.permute(0, 2, 3, 1, 4)                                   # [S,K,G,C,D]
    mask = mask[:, None, None]                                      # [S,1,1,C,T]
    if kv_major:
        q, mask = q.transpose(0, 1), mask.transpose(0, 1)
    b0, b1 = q.shape[:2]
    scores = torch.matmul(q.reshape(b0, b1, g * c, d).to(torch.float32),
                          ck.to(torch.float32).transpose(-1, -2))
    scores = scores.view(b0, b1, g, c, t) * scale
    slopes = alibi_slopes_kg(spec, qg.device)
    if slopes is not None:
        bias = alibi_bias(slopes, key_pos)[:, :, None, :]           # [K,G,1,T]
        scores = scores + (bias[:, None] if kv_major else bias[None])
    scores = scores.masked_fill(~mask, -math.inf)
    probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = torch.matmul(probs.view(b0, b1, g * c, t), cv).view(b0, b1, g, c, d)
    if kv_major:
        out = out.transpose(0, 1)
    return out.permute(0, 3, 1, 2, 4)


def verify_forward(spec: DecoderSpec, params: dict, ids: torch.Tensor,
                   start_pos: torch.Tensor,
                   layer_kv: Callable[[int, torch.Tensor, torch.Tensor],
                                      tuple[torch.Tensor, torch.Tensor]],
                   attn: AttentionOps = KERNELS, kv_major: bool = False):
    """The layer loop of a verification forward over C candidate positions
    per slot (ids [S, C], ids[:, 0] at start_pos): `layer_kv(layer, k, v)`
    stores the chunk's k/v ([S, C, K, D]) in that layer's keys and values
    and returns them ([S, K, T, D], or [K, S, T, D] with `kv_major`) for
    `verify_attention`. Returns ([S, C, V] f32 logits, [S, C, D]
    final-norm hidden states)."""
    s, c = ids.shape
    positions = (start_pos.to(torch.int32)[:, None]
                 + torch.arange(c, device=ids.device, dtype=torch.int32))
    x = _embed(spec, params, ids, positions)            # [S, C, D]
    rope = _rotary(spec, positions)
    scale = 1.0 / math.sqrt(spec.head_dim)
    group = spec.num_heads // spec.num_kv_heads
    for li in range(spec.num_layers):
        lp = layer_params(params["layers"], li, attn.int4_plain)
        h = _norm(spec, lp["ln1"], x)
        q, k, v = _qkv(spec, lp, h)                     # q [S, C, H, Dh]
        q, k = _rotate(spec, q, k, rope)
        ck, cv = layer_kv(li, k, v)
        qg = q.reshape(s, c, spec.num_kv_heads, group, spec.head_dim)
        a = verify_attention(spec, qg, ck, cv, positions, scale, kv_major)
        a = _attn_out(spec, lp, a.reshape(s, c, spec.num_heads, spec.head_dim))
        x = _residual(spec, lp, x, a)
    x = _norm(spec, params["final_norm"], x)
    return _unembed(spec, params, x), x


def verify_chunk(
    spec: DecoderSpec,
    params: dict,
    ids: torch.Tensor,          # [S, C] i32: candidate tokens per slot
    start_pos: torch.Tensor,    # [S] i32: position of ids[:, 0]
    cache: KVCache,
    attn: AttentionOps = KERNELS,
):
    """Speculative-verification forward over the slot cache (the JAX
    package's `verify_chunk`; the model side of the reference's speculative
    decoding): C candidate positions per slot in one pass. Each layer
    writes the chunk's K/V into the cache in place first (positions past
    max_seq dropped), then candidate j attends over the slot's keys up to
    its own position (causal within the chunk). The caller rewinds a
    rejected position by not advancing the history: the next chunk
    overwrites its row. The float cache only (both speculative engines
    refuse int8 KV, as in the JAX package).

    Returns ([S, C, V] f32 logits, [S, C, D] hidden states, cache)."""
    if cache.quantized:
        raise ValueError("verify_chunk reads and writes a float cache")
    positions = (start_pos.to(torch.int64)[:, None]
                 + torch.arange(ids.shape[1], device=ids.device))

    def layer_kv(li, k, v):
        write_chunk(cache.k[li], cache.v[li], k, v, positions)
        return cache.k[li], cache.v[li]

    logits, hidden = verify_forward(spec, params, ids, start_pos, layer_kv,
                                    attn)
    return logits, hidden, cache
