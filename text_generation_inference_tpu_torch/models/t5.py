"""T5-family encoder-decoder (t5, t5 v1.1, mt5 / mt0, umt5, flan-t5) in
PyTorch (port of the JAX package's `models/t5.py`).

Architecture, as in the JAX package:

  * T5LayerNorm is RMS-style (no mean subtraction, no bias), computed in f32
    and cast to the model's dtype before the scale multiply;
  * attention has NO 1/sqrt(d) scaling (folded into initialization);
  * relative position bias: bucketed distances, embedded per head, from
    block 0's table, shared by all layers (encoder bidirectional, decoder
    causal);
  * cross-attention has no position bias; its K/V are computed once from
    the encoder output at prefill and reused every decode step;
  * v1.1 / mT5 use a gated tanh-GELU MLP and an untied lm_head; v1.0 uses
    ReLU and ties the head to the shared embedding, scaling the hidden
    state by d_model^-0.5 first.

Parameters are the JAX package's layout: layer weights stacked along a
leading layer axis, linear weights [in, out]. The JAX `lax.scan` over
layers is a Python loop over per-layer views; the passes write the decode
state (`T5DecodeState`) in place where the JAX package returned a new one.
Every product is a plain `torch.matmul` / `torch.einsum`: the JAX T5 path
reaches no Pallas kernel.

Two details the port adds, both invisible in a live slot's output:

  * Bucket ids come from a table of every relative position in
    [-2 * max_distance, 2 * max_distance] (`_bucket_table`), built once per
    configuration and device by `_relative_bucket` on the CPU, so the card
    and the CPU give the same ids and a captured decode graph reads a fixed
    address. Past that span every id has saturated, so clamping a relative
    position into it changes nothing.
  * A masked score is the f32 minimum, not -inf. Where a row has a visible
    key the softmax is the same (exp underflows to exactly 0); a row with
    none (a free slot's cross-attention: its encoder length is 0) averages
    its keys instead of turning NaN. In the JAX package that NaN reaches the
    free slot's self-KV through a ring chunk's flush and, with it, the next
    request placed in that slot.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device

MASKED = torch.finfo(torch.float32).min


@dataclasses.dataclass(frozen=True)
class T5Spec:
    vocab_size: int
    d_model: int
    d_kv: int
    d_ff: int
    num_heads: int
    num_encoder_layers: int
    num_decoder_layers: int
    rel_buckets: int = 32
    rel_max_distance: int = 128
    norm_eps: float = 1e-6
    gated_act: bool = True            # v1.1/mT5: gated-gelu; v1.0: relu
    tie_word_embeddings: bool = False
    decoder_start_token_id: int = 0

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv

    @property
    def hidden_size(self) -> int:
        """The embedding width (a soft prompt's vectors), under the
        decoder specs' name."""
        return self.d_model


def spec_from_hf_config(c: dict) -> T5Spec:
    act = c.get("feed_forward_proj", "relu")
    return T5Spec(
        vocab_size=c["vocab_size"],
        d_model=c["d_model"],
        d_kv=c["d_kv"],
        d_ff=c["d_ff"],
        num_heads=c["num_heads"],
        num_encoder_layers=c["num_layers"],
        num_decoder_layers=c.get("num_decoder_layers", c["num_layers"]),
        rel_buckets=c.get("relative_attention_num_buckets", 32),
        rel_max_distance=c.get("relative_attention_max_distance", 128),
        norm_eps=c.get("layer_norm_epsilon", 1e-6),
        gated_act=act.startswith("gated"),
        tie_word_embeddings=c.get("tie_word_embeddings", True),
        decoder_start_token_id=c.get("decoder_start_token_id", 0),
    )


class T5DecodeState(NamedTuple):
    """Per-slot device state for incremental decoding."""

    self_k: torch.Tensor   # [L, S, H, T_dec, Dkv]
    self_v: torch.Tensor
    cross_k: torch.Tensor  # [L, S, H, T_enc, Dkv]
    cross_v: torch.Tensor
    enc_len: torch.Tensor  # [S] i32

    @classmethod
    def create(cls, spec: T5Spec, num_slots: int, max_dec: int, max_enc: int,
               dtype, device=None) -> "T5DecodeState":
        device = resolve_device(device)
        L, H, Dkv = spec.num_decoder_layers, spec.num_heads, spec.d_kv

        def zeros(t):
            return torch.zeros((L, num_slots, H, t, Dkv), dtype=dtype,
                               device=device)

        return cls(self_k=zeros(max_dec), self_v=zeros(max_dec),
                   cross_k=zeros(max_enc), cross_v=zeros(max_enc),
                   enc_len=torch.zeros(num_slots, dtype=torch.int32,
                                       device=device))

    def zero_(self) -> None:
        """Back to `create`'s zeros, in place (captured decode programs
        hold these addresses)."""
        for t in self:
            t.zero_()


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _layer(layers: dict, i: int) -> dict:
    """Layer i's view of the layer-stacked parameter dict (no copy)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def _t5_norm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]


def _relative_bucket(rel_pos: torch.Tensor, bidirectional: bool,
                     num_buckets: int, max_distance: int) -> torch.Tensor:
    """HF T5 _relative_position_bucket, vectorized, in the JAX package's f32
    arithmetic."""
    ret = torch.zeros_like(rel_pos)
    n = num_buckets
    if bidirectional:
        n = n // 2
        ret = ret + (rel_pos > 0).to(rel_pos.dtype) * n
        rel = torch.abs(rel_pos)
    else:
        rel = -torch.clamp(rel_pos, max=0)
    max_exact = n // 2
    is_small = rel < max_exact
    # the JAX package divides by np.log(...), an f64 that JAX rounds to f32
    denom = torch.tensor(math.log(max_distance / max_exact),
                         dtype=torch.float32)
    log_ratio = torch.log(rel.to(torch.float32) / max_exact + 1e-9) / denom
    large = max_exact + (log_ratio * (n - max_exact)).to(rel_pos.dtype)
    large = torch.clamp(large, max=n - 1)
    return ret + torch.where(is_small, rel, large)


@functools.cache
def _bucket_table(bidirectional: bool, num_buckets: int, max_distance: int,
                  device: torch.device) -> torch.Tensor:
    """[4 * max_distance + 1] int64: the bucket of relative position
    r - 2 * max_distance at index r (see the module docstring)."""
    span = 2 * max_distance
    rel = torch.arange(-span, span + 1, dtype=torch.int32)
    return _relative_bucket(rel, bidirectional, num_buckets,
                            max_distance).to(device=device, dtype=torch.int64)


def bucket_tables(spec: T5Spec, device) -> None:
    """Build both `_bucket_table`s of a spec on `device` ahead of use (an
    engine does this when it is built, so that no decode capture makes one
    and no decode step copies one from the host)."""
    for bidirectional in (True, False):
        _bucket_table(bidirectional, spec.rel_buckets, spec.rel_max_distance,
                      torch.device(device))


def relative_buckets(rel_pos: torch.Tensor, bidirectional: bool,
                     num_buckets: int, max_distance: int) -> torch.Tensor:
    """`_relative_bucket` of every element, by a lookup in `_bucket_table`
    (int64, on rel_pos's device)."""
    span = 2 * max_distance
    table = _bucket_table(bidirectional, num_buckets, max_distance,
                          rel_pos.device)
    return table[(rel_pos.long().clamp(-span, span) + span)]


def _position_bias(table: torch.Tensor, q_pos: torch.Tensor,
                   k_pos: torch.Tensor, bidirectional: bool, num_buckets: int,
                   max_distance: int) -> torch.Tensor:
    """[..., H, Q, K] f32 bias from the layer-0 relative embedding table
    [B, H]."""
    rel = k_pos[..., None, :] - q_pos[..., :, None]       # [..., Q, K]
    buckets = relative_buckets(rel, bidirectional, num_buckets, max_distance)
    return torch.movedim(table[buckets], -1, -3)          # [..., H, Q, K]


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: Optional[torch.Tensor],
               mask: torch.Tensor) -> torch.Tensor:
    """q [..., Q, H, D]; k / v [..., H, K, D] (the cache layout); no sqrt
    scaling (T5). f32 scores, probabilities in v's dtype; returns
    [..., Q, H, D]."""
    scores = torch.einsum("...qhd,...hkd->...hqk", q.to(torch.float32),
                          k.to(torch.float32))
    if bias is not None:
        scores = scores + bias
    scores = scores.masked_fill(~mask, MASKED)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("...hqk,...hkd->...qhd", probs, v)


def _mlp(spec: T5Spec, lp: dict, x: torch.Tensor) -> torch.Tensor:
    if spec.gated_act:
        h = F.gelu(torch.matmul(x, lp["wi0"]), approximate="tanh") * \
            torch.matmul(x, lp["wi1"])
    else:
        h = F.relu(torch.matmul(x, lp["wi0"]))
    return torch.matmul(h, lp["wo"])


def _proj_qkv(lp: dict, x: torch.Tensor, h: int, dkv: int, prefix: str):
    out_shape = (*x.shape[:-1], h, dkv)
    q = torch.matmul(x, lp[f"{prefix}_q"]).reshape(out_shape)
    k = torch.matmul(x, lp[f"{prefix}_k"]).reshape(out_shape)
    v = torch.matmul(x, lp[f"{prefix}_v"]).reshape(out_shape)
    return q, k, v


def _out(lp: dict, name: str, attn: torch.Tensor) -> torch.Tensor:
    """The attention output projection of [..., H, D] heads."""
    return torch.matmul(attn.reshape(*attn.shape[:-2], -1), lp[name])


def _embed(params: dict, ids: torch.Tensor) -> torch.Tensor:
    return params["shared_embed"][ids.long()]


def _inject(x: torch.Tensor, embeds: torch.Tensor, start: torch.Tensor,
            length: torch.Tensor) -> torch.Tensor:
    """Soft-prompt vectors at positions [start, start + length) of each
    row of x [N, T, D]."""
    posn = torch.arange(x.shape[1], device=x.device)[None, :]
    use = (posn >= start[:, None]) & (posn < (start + length)[:, None])
    return torch.where(use[..., None], embeds.to(x.dtype), x)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def encode(spec: T5Spec, params: dict, ids: torch.Tensor,
           lengths: torch.Tensor,
           prefix_embeds: Optional[torch.Tensor] = None,
           prefix_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ids [N, T_enc] right-padded; returns [N, T_enc, D] encoder states.
    With a tuned prompt, the first prefix_len positions take their
    embeddings from prefix_embeds [N, T_enc, D]."""
    n, t = ids.shape
    x = _embed(params, ids)
    if prefix_embeds is not None:
        x = _inject(x, prefix_embeds, torch.zeros_like(prefix_len),
                    prefix_len)
    pos = torch.arange(t, device=ids.device)
    bias = _position_bias(params["enc_rel_bias"], pos, pos, True,
                          spec.rel_buckets, spec.rel_max_distance)[None]
    mask = (pos[None, :] < lengths[:, None])[:, None, None, :]   # [N,1,1,T]
    layers = params["encoder_layers"]
    for li in range(spec.num_encoder_layers):
        lp = _layer(layers, li)
        h = _t5_norm(lp["ln1"], x, spec.norm_eps)
        q, k, v = _proj_qkv(lp, h, spec.num_heads, spec.d_kv, "sa")
        attn = _attention(q, k.transpose(1, 2), v.transpose(1, 2), bias,
                          mask)
        x = x + _out(lp, "sa_o", attn)
        h = _t5_norm(lp["ln2"], x, spec.norm_eps)
        x = x + _mlp(spec, lp, h)
    return _t5_norm(params["enc_final_norm"], x, spec.norm_eps)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


def decoder_prefill(
    spec: T5Spec, params: dict,
    dec_ids: torch.Tensor,       # [N, T_dec] right-padded decoder input ids
    dec_lengths: torch.Tensor,   # [N]
    enc_states: torch.Tensor,    # [N, T_enc, D]
    enc_lengths: torch.Tensor,   # [N]
    slots: torch.Tensor,         # [N]
    state: T5DecodeState,
    dec_prefix_embeds: Optional[torch.Tensor] = None,  # [N, T_dec, D]
    dec_prefix_len: Optional[torch.Tensor] = None,
    dec_prefix_start: Optional[torch.Tensor] = None,   # [N]; default 0
) -> tuple[torch.Tensor, T5DecodeState]:
    """Run the decoder over its prompt (usually just the start token),
    writing the slots' self- and cross-KV in place. Returns ([N, T_dec, V]
    f32 logits, state)."""
    n, t = dec_ids.shape
    t_enc = enc_states.shape[1]
    dev = dec_ids.device
    x = _embed(params, dec_ids)
    if dec_prefix_embeds is not None:
        start = (dec_prefix_start if dec_prefix_start is not None
                 else torch.zeros_like(dec_prefix_len))
        x = _inject(x, dec_prefix_embeds, start, dec_prefix_len)
    pos = torch.arange(t, device=dev)
    bias = _position_bias(params["dec_rel_bias"], pos, pos, False,
                          spec.rel_buckets, spec.rel_max_distance)[None]
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=dev))
    self_valid = pos[None, :] < dec_lengths[:, None]
    self_mask = (causal[None] & self_valid[:, None, :])[:, None]  # [N,1,T,T]
    enc_pos = torch.arange(t_enc, device=dev)
    cross_mask = (enc_pos[None, :] < enc_lengths[:, None])[:, None, None, :]
    sl = slots.long()
    layers = params["decoder_layers"]
    for li in range(spec.num_decoder_layers):
        lp = _layer(layers, li)
        # self attention
        h = _t5_norm(lp["ln1"], x, spec.norm_eps)
        q, k, v = _proj_qkv(lp, h, spec.num_heads, spec.d_kv, "sa")
        k, v = k.transpose(1, 2), v.transpose(1, 2)         # [N, H, T, D]
        x = x + _out(lp, "sa_o", _attention(q, k, v, bias, self_mask))
        # cross attention (K/V from encoder states, cached for decode)
        h = _t5_norm(lp["ln_x"], x, spec.norm_eps)
        qx = torch.matmul(h, lp["xa_q"]).reshape(n, t, spec.num_heads,
                                                 spec.d_kv)
        kx = torch.matmul(enc_states, lp["xa_k"]).reshape(
            n, t_enc, spec.num_heads, spec.d_kv).transpose(1, 2)
        vx = torch.matmul(enc_states, lp["xa_v"]).reshape(
            n, t_enc, spec.num_heads, spec.d_kv).transpose(1, 2)
        x = x + _out(lp, "xa_o", _attention(qx, kx, vx, None, cross_mask))
        # mlp
        h = _t5_norm(lp["ln2"], x, spec.norm_eps)
        x = x + _mlp(spec, lp, h)
        # cache writes at the target slots
        state.self_k[li][sl, :, :t] = k.to(state.self_k.dtype)
        state.self_v[li][sl, :, :t] = v.to(state.self_v.dtype)
        state.cross_k[li][sl, :, :t_enc] = kx.to(state.cross_k.dtype)
        state.cross_v[li][sl, :, :t_enc] = vx.to(state.cross_v.dtype)
    x = _t5_norm(params["dec_final_norm"], x, spec.norm_eps)
    state.enc_len[sl] = enc_lengths.to(torch.int32)
    return _unembed(spec, params, x), state


def decoder_step(
    spec: T5Spec, params: dict,
    ids: torch.Tensor,        # [S] last decoder token per slot
    positions: torch.Tensor,  # [S] decoder position to write
    state: T5DecodeState,
) -> tuple[torch.Tensor, T5DecodeState]:
    """One incremental decoder step across all slots (each layer writes its
    k / v at `positions` in place, then attends). Returns ([S, V] f32
    logits, state)."""
    s = ids.shape[0]
    t_dec = state.self_k.shape[3]
    t_enc = state.cross_k.shape[3]
    dev = ids.device
    x = _embed(params, ids)                                  # [S, D]
    dec_pos = torch.arange(t_dec, device=dev)
    bias = _position_bias(params["dec_rel_bias"], positions[:, None],
                          dec_pos[None, :], False, spec.rel_buckets,
                          spec.rel_max_distance)             # [S, H, 1, T]
    self_mask = (dec_pos[None, :] <= positions[:, None])[:, None, None, :]
    enc_pos = torch.arange(t_enc, device=dev)
    cross_mask = (enc_pos[None, :] < state.enc_len[:, None])[:, None, None, :]
    rows = torch.arange(s, device=dev)
    pos = positions.long()
    layers = params["decoder_layers"]
    for li in range(spec.num_decoder_layers):
        lp = _layer(layers, li)
        sk, sv = state.self_k[li], state.self_v[li]          # [S, H, T, D]
        h = _t5_norm(lp["ln1"], x, spec.norm_eps)
        q, k, v = _proj_qkv(lp, h, spec.num_heads, spec.d_kv, "sa")
        sk[rows, :, pos] = k.to(sk.dtype)
        sv[rows, :, pos] = v.to(sv.dtype)
        attn = _attention(q[:, None], sk, sv, bias, self_mask)
        x = x + _out(lp, "sa_o", attn[:, 0])

        h = _t5_norm(lp["ln_x"], x, spec.norm_eps)
        qx = torch.matmul(h, lp["xa_q"]).reshape(s, 1, spec.num_heads,
                                                 spec.d_kv)
        attn = _attention(qx, state.cross_k[li], state.cross_v[li], None,
                          cross_mask)
        x = x + _out(lp, "xa_o", attn[:, 0])

        h = _t5_norm(lp["ln2"], x, spec.norm_eps)
        x = x + _mlp(spec, lp, h)
    x = _t5_norm(params["dec_final_norm"], x, spec.norm_eps)
    return _unembed(spec, params, x), state


def decoder_ring_step(
    spec: T5Spec, params: dict,
    ids: torch.Tensor,          # [S] last decoder token per slot
    positions: torch.Tensor,    # [S] decoder position ids[s] will occupy
    state: T5DecodeState,       # self-KV READ-ONLY this chunk
    kbuf: torch.Tensor,         # [L, S, H, C, Dkv] in-chunk keys (cols < step_idx)
    vbuf: torch.Tensor,         # [L, S, H, C, Dkv]
    step_idx: int,
    chunk_start: torch.Tensor,  # [S] positions at chunk entry
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ring-buffer decoder step (the seq2seq counterpart of
    `core.decode_ring_step`): the self-KV slabs are not written inside a
    decode chunk; in-chunk tokens live in the ring buffers, and ONE scatter
    a chunk (`ring_flush_self_kv`) replaces the per-step writes. `state`
    may be a view of the first cache rows (a context bucket).

    Returns (logits [S, V] f32, k_all [L, S, H, Dkv], v_all likewise)."""
    s = ids.shape[0]
    t_dec = state.self_k.shape[3]
    t_enc = state.cross_k.shape[3]
    n_buf = kbuf.shape[3]
    dev = ids.device
    x = _embed(params, ids)                                  # [S, D]

    def bias(k_pos):
        return _position_bias(params["dec_rel_bias"], positions[:, None],
                              k_pos, False, spec.rel_buckets,
                              spec.rel_max_distance)[:, :, 0, :]

    dec_pos = torch.arange(t_dec, device=dev)
    # cache part: only pre-chunk positions are valid
    cache_mask = (dec_pos[None, :] < chunk_start[:, None])[:, None, :]
    cache_bias = bias(dec_pos[None, :])                      # [S, H, T]
    # ring part: col c holds position chunk_start + c
    cols = torch.arange(n_buf, device=dev)
    buf_bias = bias(chunk_start[:, None] + cols[None])       # [S, H, C]
    buf_mask = (cols < step_idx)[None, None, :]              # [1, 1, C]
    # current token: relative distance 0
    new_bias = bias(positions[:, None])                      # [S, H, 1]
    enc_pos = torch.arange(t_enc, device=dev)
    cross_mask = (enc_pos[None, :] < state.enc_len[:, None])[:, None, None, :]

    k_all, v_all = [], []
    layers = params["decoder_layers"]
    for li in range(spec.num_decoder_layers):
        lp = _layer(layers, li)
        sk, sv = state.self_k[li], state.self_v[li]          # READ-ONLY
        kb, vb = kbuf[li], vbuf[li]
        h = _t5_norm(lp["ln1"], x, spec.norm_eps)
        q, k, v = _proj_qkv(lp, h, spec.num_heads, spec.d_kv, "sa")  # [S,H,D]
        qf = q.to(torch.float32)
        scores = torch.einsum("shd,shtd->sht", qf,
                              sk.to(torch.float32)) + cache_bias
        scores = scores.masked_fill(~cache_mask, MASKED)
        bscores = torch.einsum("shd,shcd->shc", qf,
                               kb.to(torch.float32)) + buf_bias
        bscores = bscores.masked_fill(~buf_mask, MASKED)
        score_new = torch.sum(qf * k.to(torch.float32), dim=-1,
                              keepdim=True) + new_bias
        probs = torch.softmax(torch.cat([scores, bscores, score_new], -1),
                              dim=-1).to(sv.dtype)
        attn = (torch.einsum("sht,shtd->shd", probs[..., :t_dec], sv)
                + torch.einsum("shc,shcd->shd",
                               probs[..., t_dec:t_dec + n_buf], vb)
                + probs[..., t_dec + n_buf:] * v)
        x = x + _out(lp, "sa_o", attn)

        h = _t5_norm(lp["ln_x"], x, spec.norm_eps)
        qx = torch.matmul(h, lp["xa_q"]).reshape(s, 1, spec.num_heads,
                                                 spec.d_kv)
        xattn = _attention(qx, state.cross_k[li], state.cross_v[li], None,
                           cross_mask)
        x = x + _out(lp, "xa_o", xattn[:, 0])

        h = _t5_norm(lp["ln2"], x, spec.norm_eps)
        x = x + _mlp(spec, lp, h)
        k_all.append(k)
        v_all.append(v)
    x = _t5_norm(params["dec_final_norm"], x, spec.norm_eps)
    return (_unembed(spec, params, x), torch.stack(k_all),
            torch.stack(v_all))


def ring_flush_self_kv(state: T5DecodeState, kbuf: torch.Tensor,
                       vbuf: torch.Tensor,
                       chunk_start: torch.Tensor) -> T5DecodeState:
    """Scatter a chunk's decoder self-KV ring into the slabs, in place: col
    c of slot s lands at position chunk_start[s] + c; positions at or past
    T_dec are dropped, as JAX's mode="drop" drops them. Slot rows are
    private, so no active-masking is needed.

    Without a host sync (`core.ring_flush`'s rule): a dropped (c, s) is
    redirected to col 0 of slot s (position chunk_start[s], always in
    range), which the kept write of col 0 also targets with the same
    values."""
    n_buf, s = kbuf.shape[3], kbuf.shape[1]
    t_dec = state.self_k.shape[3]
    dev = kbuf.device
    start = chunk_start.to(torch.int64)[None, :]                   # [1, S]
    cols = torch.arange(n_buf, device=dev)[:, None]                # [C, 1]
    drop = start + cols >= t_dec
    wpos = torch.where(drop, start, start + cols)
    src_col = torch.where(drop, 0, cols)
    rows = torch.arange(s, device=dev)[None, :].expand(n_buf, s)
    for dst, src in ((state.self_k, kbuf), (state.self_v, vbuf)):
        # advanced indices (C, S) at axes 1 and 3 move to the front: the
        # region is [C, S, L, H, D] on both sides
        dst[:, rows, :, wpos] = src[:, rows, :, src_col].to(dst.dtype)
    return state


def _unembed(spec: T5Spec, params: dict, x: torch.Tensor) -> torch.Tensor:
    """[..., V] f32 logits: the product in the model's dtype, then f32, as
    the port's decoders do."""
    if spec.tie_word_embeddings:
        x = x * (spec.d_model ** -0.5)
        logits = torch.matmul(x, params["shared_embed"].t())
    else:
        logits = torch.matmul(x, params["lm_head"])
    return logits.to(torch.float32)


# ---------------------------------------------------------------------------
# checkpoint loading
# ---------------------------------------------------------------------------


def load_params(weights, spec: T5Spec, dtype=torch.bfloat16,
                device=None) -> dict:
    """Map HF T5 checkpoint names to the stacked param dict on `device`
    (CUDA unless the caller asks for the CPU). As the JAX loader, the
    relative-bias tables come from block 0 of each stack only."""
    device = resolve_device(device)

    def one(t, dt=dtype):
        return t.to(device=device, dtype=dt).contiguous()

    def stack(fmt, n, linear=True):
        ts = [weights.get(fmt.format(i=i)) for i in range(n)]
        return one(torch.stack([t.t() if linear else t for t in ts]))

    def side(prefix, n, subs):
        """One stack's layer dict: name -> (layer index of the block's
        sub-layer, HF name)."""
        out = {}
        for name, (kind, sub) in subs.items():
            fmt = f"{prefix}.block.{{i}}.layer.{kind}.{sub}.weight"
            if name.startswith("ln"):
                out[name] = {"scale": stack(fmt, n, linear=False)}
            else:
                out[name] = stack(fmt, n)
        return out

    mlp_at = {"enc": 1, "dec": 2}

    def mlp(where):
        k = mlp_at[where]
        subs = {"wo": (k, "DenseReluDense.wo")}
        if spec.gated_act:
            subs.update(wi0=(k, "DenseReluDense.wi_0"),
                        wi1=(k, "DenseReluDense.wi_1"))
        else:
            subs["wi0"] = (k, "DenseReluDense.wi")
        return subs

    self_attn = {"ln1": (0, "layer_norm"), "sa_q": (0, "SelfAttention.q"),
                 "sa_k": (0, "SelfAttention.k"),
                 "sa_v": (0, "SelfAttention.v"),
                 "sa_o": (0, "SelfAttention.o")}
    enc = {**self_attn, "ln2": (1, "layer_norm"), **mlp("enc")}
    dec = {**self_attn, "ln_x": (1, "layer_norm"),
           "xa_q": (1, "EncDecAttention.q"), "xa_k": (1, "EncDecAttention.k"),
           "xa_v": (1, "EncDecAttention.v"), "xa_o": (1, "EncDecAttention.o"),
           "ln2": (2, "layer_norm"), **mlp("dec")}
    rel = "block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    params = {
        "shared_embed": one(weights.get("shared.weight")),
        "enc_rel_bias": one(weights.get(f"encoder.{rel}"), torch.float32),
        "dec_rel_bias": one(weights.get(f"decoder.{rel}"), torch.float32),
        "encoder_layers": side("encoder", spec.num_encoder_layers, enc),
        "decoder_layers": side("decoder", spec.num_decoder_layers, dec),
        "enc_final_norm": {"scale": one(
            weights.get("encoder.final_layer_norm.weight"))},
        "dec_final_norm": {"scale": one(
            weights.get("decoder.final_layer_norm.weight"))},
    }
    if not spec.tie_word_embeddings:
        params["lm_head"] = one(weights.get("lm_head.weight").t())
    return params


def random_params(spec: T5Spec, device, dtype, seed: int) -> dict:
    """Seeded random weights at a spec's widths, made on `device` in
    `load_params`'s layout (the card checks serve them; no checkpoint is
    read): linears scale 1/sqrt(fan_in), embeddings and norms 1,
    relative-bias tables 0.5 (f32)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    D, F, I = spec.d_model, spec.d_ff, spec.inner_dim

    def dense(*shape, scale=None, dt=dtype):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
        return (torch.randn(*shape, generator=gen, device=device) * scale
                ).to(dt)

    def stack(n, cross: bool) -> dict:
        def ones():
            return {"scale": torch.ones(n, D, dtype=dtype, device=device)}

        out = {"ln1": ones(), "ln2": ones(), "sa_q": dense(n, D, I),
               "sa_k": dense(n, D, I), "sa_v": dense(n, D, I),
               "sa_o": dense(n, I, D), "wi0": dense(n, D, F),
               "wo": dense(n, F, D)}
        if spec.gated_act:
            out["wi1"] = dense(n, D, F)
        if cross:
            out.update(ln_x=ones(), xa_q=dense(n, D, I), xa_k=dense(n, D, I),
                       xa_v=dense(n, D, I), xa_o=dense(n, I, D))
        return out

    params = {
        "shared_embed": dense(spec.vocab_size, D, scale=1.0),
        "enc_rel_bias": dense(spec.rel_buckets, spec.num_heads, scale=0.5,
                              dt=torch.float32),
        "dec_rel_bias": dense(spec.rel_buckets, spec.num_heads, scale=0.5,
                              dt=torch.float32),
        "encoder_layers": stack(spec.num_encoder_layers, cross=False),
        "decoder_layers": stack(spec.num_decoder_layers, cross=True),
        "enc_final_norm": {"scale": torch.ones(D, dtype=dtype, device=device)},
        "dec_final_norm": {"scale": torch.ones(D, dtype=dtype, device=device)},
    }
    if not spec.tie_word_embeddings:
        params["lm_head"] = dense(D, spec.vocab_size)
    return params
