"""Tensor-parallel sharding: the JAX package's rules, cut per rank (port of
its `parallel/sharding.py`).

The JAX package gives every leaf a PartitionSpec over a mesh with a
"model" axis and lets GSPMD place the collectives. The port keeps the same
rules, leaf for leaf (JAX `param_specs`, `_quant_leaf_specs`), and cuts
the full params into rank r's shard (`shard_params`): rank r of `world`
holds block r of a leaf's split dim, or the whole leaf where JAX
replicates it.

  wq, w_gate, w_up      column-parallel (the out dim), wq only when the
                        query heads divide the world
  wk, wv                column-parallel on whole kv heads, when they divide
  wo                    row-parallel (the in dim) when the query heads
                        divide; w_down row-parallel
  embed_tokens, lm_head vocab-parallel
  bq, b_gate, b_up,     follow their weight's out dim; bo, b_down, norms
  bk, bv                and every other leaf replicated
  KV pools              kv heads split when they divide (JAX
                        `cache_spec`, `paged_pool_spec`: the int8 scale
                        pools on the same axis, the block table whole)

A leaf whose split dim does not divide stays whole: a dense leaf whose dim
is not a multiple of the world, an INT4 column split unless out % (8 *
world) == 0, an INT4 row split unless groups % world == 0 and (in / 8) %
world == 0, an INT8 split unless its dim divides. g_idx and the act-order
`perm` stay whole (the perm gathers the global input); an
`Int8OutlierWeight`'s outlier rows stay whole under a row split.

There is no "data" axis: the JAX engines never shard on it (its
`cache_spec` leaves the slot dim whole, whatever its docstring says).

Where the port leaves GSPMD. JAX decides each leaf on its own and GSPMD
makes any mix of shardings exact. A process per rank has to place each
collective itself, so `shard_model` also returns the rank's local spec:
the `DecoderSpec` with the rank's own head and MLP widths, and in its `tp`
field the rank's layout (`TPShard`), which `models/core.py` reads:

  * a row-parallel product (wo, w_down) whose input is the rank's block
    is all-reduced after the product; its bias is added once, after the
    sum. When its weight stayed whole (an INT4 fallback) the input is
    all-gathered first and nothing is reduced; when its input is whole
    and its weight split, the rank takes its block of the input;
  * an act-order INT4 weight under a row split needs features other
    ranks hold: the whole input is permuted, then the rank's block taken;
  * when the kv heads do not divide the world but the query heads do,
    wk and wv stay whole and the rank attends with the kv heads its query
    heads read (`TPShard.kv_index`), each repeated where its query heads
    span part of a group: the kernels get that subset with the local
    group size, and the KV pools hold it (the JAX package sends this case
    to its plain path and keeps every kv head in the pool);
  * a bias is split exactly where its weight is (JAX splits b_gate / b_up
    by their own width, which differs only where an INT4 weight falls
    back to whole).

Each rank fuses its own q|k|v and gate|up shards after sharding
(`models/fuse.py`): a fused matrix is never column-split.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..models.core import DecoderSpec
from ..ops.quant.int4 import Int4Weight
from ..ops.quant.int8 import Int8OutlierWeight, Int8Weight
from .comm import TPGroup

QUANT = (Int4Weight, Int8Weight, Int8OutlierWeight)


@dataclasses.dataclass(frozen=True)
class TPShard:
    """What rank `rank` of `world` holds of a decoder, as the layer code
    needs it. Hashable without its group (`comm`), so a local spec can key
    the caches that `models/core.py` keeps per spec and device."""

    rank: int
    world: int
    num_heads: int            # the model's query heads
    head_offset: int          # the first of the rank's query heads
    kv_heads_in: int          # kv heads the rank's k / v product returns
    # the kv heads (of the product's) the rank attends with, or None: all
    kv_index: Optional[tuple] = None
    attn_split: bool = False  # the rank computes its block of query heads
    wo_row: bool = False      # wo row-parallel
    mlp_split: bool = False   # w_gate / w_up column-parallel
    down_row: bool = False    # w_down row-parallel
    embed_split: bool = False  # embed_tokens vocab-parallel
    head_split: bool = False  # the unembedding gives the rank's vocab block
    comm: Optional[TPGroup] = dataclasses.field(
        default=None, compare=False, hash=False, repr=False)


# ---------------------------------------------------------------------------
# the JAX rules: which dim of which field each leaf splits
# ---------------------------------------------------------------------------


def _quant_split(w, kind: str, world: int):
    """{field: split dim or None} of a quantized leaf under JAX
    `_quant_leaf_specs` for `kind` "col" / "row" / "repl": the dim counted
    from the end (-1 the out dim, -2 the in dim), or None (whole)."""
    fields = w._fields
    if isinstance(w, Int4Weight):
        groups = w.scales.shape[-2]
        col_ok = kind == "col" and w.out_features % (8 * world) == 0
        row_ok = (kind == "row" and groups % world == 0
                  and (w.in_features // 8) % world == 0)
        dim = -1 if col_ok else -2 if row_ok else None
        whole = ("g_idx", "perm")
        return {f: None if f in whole else dim for f in fields}
    col_ok = kind == "col" and w.out_features % world == 0
    row_ok = kind == "row" and w.in_features % world == 0
    if col_ok:
        return {f: None if f == "outlier_idx" else -1 for f in fields}
    if row_ok:
        return {f: -2 if f == "q" else None for f in fields}
    return {f: None for f in fields}


def _kind(leaf) -> str:
    """The split a leaf took: "col", "row" or "repl" (from its fields'
    dims, or a dense leaf's)."""
    if isinstance(leaf, dict):
        dims = set(leaf.values())
        return "col" if -1 in dims else "row" if -2 in dims else "repl"
    return {-1: "col", -2: "row", None: "repl"}[leaf]


def param_splits(spec: DecoderSpec, params: dict, world: int) -> dict:
    """The split of every leaf under the JAX rules (`param_specs`): for a
    dense leaf its split dim from the end (or None: whole), for a quantized
    leaf a {field: dim} dict, for a norm a {key: None} dict. Keyed like
    `params`."""
    def dense(arr, dim: int):
        return dim if arr.shape[dim] % world == 0 else None

    def col_or_repl(arr):
        if isinstance(arr, QUANT):
            return _quant_split(arr, "col", world)
        return dense(arr, -1)

    def row_or_repl(arr):
        if isinstance(arr, QUANT):
            return _quant_split(arr, "row", world)
        # JAX tests shape[1] of the [L, in, out] stack
        return -2 if arr.shape[1] % world == 0 else None

    def whole(arr):
        if isinstance(arr, QUANT):
            return _quant_split(arr, "repl", world)
        if isinstance(arr, dict):
            return {k: None for k in arr}
        return None

    q_ok = spec.num_heads % world == 0
    kv_ok = spec.num_kv_heads % world == 0
    layers = {}
    for name, arr in params["layers"].items():
        if name in ("wq", "w_gate", "w_up"):
            layers[name] = (col_or_repl(arr) if name != "wq" or q_ok
                            else whole(arr))
        elif name in ("wk", "wv"):
            layers[name] = col_or_repl(arr) if kv_ok else whole(arr)
        elif name == "wo":
            layers[name] = row_or_repl(arr) if q_ok else whole(arr)
        elif name == "w_down":
            layers[name] = row_or_repl(arr)
        elif name in ("bq", "bk", "bv", "b_gate", "b_up"):
            ok = {"bq": q_ok, "bk": kv_ok, "bv": kv_ok}.get(
                name, arr.shape[-1] % world == 0)
            layers[name] = -1 if ok else None
        else:
            layers[name] = whole(arr)
    out = {k: whole(v) for k, v in params.items() if k != "layers"}
    out["layers"] = layers
    out["embed_tokens"] = (-2 if params["embed_tokens"].shape[0] % world == 0
                           else None)
    if "lm_head" in params and not isinstance(params["lm_head"], QUANT):
        out["lm_head"] = dense(params["lm_head"], -1)
    return out


def _cut(x: torch.Tensor, dim: Optional[int], rank: int, world: int,
         device) -> torch.Tensor:
    """Block `rank` of `world` along `dim` (or all of x), as a contiguous
    copy on `device` (the full tensor can then be freed)."""
    if dim is not None:
        n = x.shape[dim] // world
        x = x.narrow(dim, rank * n, n)
    return x.to(device=device, copy=True).contiguous()


def _apply(tree, splits, rank: int, world: int, device):
    if isinstance(tree, QUANT):
        return type(tree)(*(None if f is None
                            else _cut(f, splits[name], rank, world, device)
                            for name, f in zip(tree._fields, tree)))
    if isinstance(tree, dict):
        return {k: _apply(v, splits[k], rank, world, device)
                for k, v in tree.items()}
    return _cut(tree, splits, rank, world, device)


def shard_params(spec: DecoderSpec, params: dict, rank: int, world: int,
                 device=None) -> dict:
    """Rank `rank`'s shard of the (unfused) params under the JAX rules,
    leaf for leaf: JAX's device-`rank` shard on a mesh of `world` model
    devices. Contiguous copies on `device` (default: the params')."""
    if "w_qkv" in params["layers"] or "w_gu" in params["layers"]:
        raise ValueError("shard the unfused params: a fused matrix is never "
                         "column-split (each rank fuses its own shards)")
    device = params["embed_tokens"].device if device is None else device
    return _apply(params, param_splits(spec, params, world), rank, world,
                  device)


# ---------------------------------------------------------------------------
# the rank's layout and local spec
# ---------------------------------------------------------------------------


def _bias_follows_weight(splits: dict) -> dict:
    """A bias split exactly where its weight is."""
    layers = dict(splits["layers"])
    for bias, weight in (("bq", "wq"), ("bk", "wk"), ("bv", "wv"),
                         ("b_gate", "w_gate"), ("b_up", "w_up")):
        if bias in layers and weight in layers:
            layers[bias] = -1 if _kind(layers[weight]) == "col" else None
    return dict(splits, layers=layers)


def _layout(spec: DecoderSpec, splits: dict, tp: TPGroup) -> TPShard:
    world, rank = tp.world, tp.rank
    lay = {k: _kind(v) for k, v in splits["layers"].items()}
    attn_split = lay.get("wq") == "col"
    kv_split = lay.get("wk") == "col"
    if kv_split and not attn_split:
        raise ValueError("wk / wv split on kv heads beside a whole wq (an "
                         "INT4 column fallback of wq alone) is not supported")
    h, k = spec.num_heads, spec.num_kv_heads
    h_local = h // world if attn_split else h
    kv_index = None
    kv_in = k // world if kv_split else k
    if attn_split and not kv_split:
        # the kv heads the rank's query heads read, in runs of g' query
        # heads that lie inside one group (g' divides both the group size
        # and the rank's head count)
        group = h // k
        g_local = math.gcd(group, h_local)
        offset = rank * h_local
        kv_index = tuple((offset + j * g_local) // group
                         for j in range(h_local // g_local))
    if lay.get("w_gate", lay.get("w_up")) != lay.get("w_up"):
        raise ValueError("w_gate and w_up split differently")
    embed_split = splits["embed_tokens"] is not None
    head_split = (embed_split if spec.tie_word_embeddings
                  else splits.get("lm_head") is not None)
    return TPShard(rank=rank, world=world, num_heads=h,
                   head_offset=rank * h_local if attn_split else 0,
                   kv_heads_in=kv_in, kv_index=kv_index,
                   attn_split=attn_split, wo_row=lay.get("wo") == "row",
                   mlp_split=lay.get("w_up") == "col",
                   down_row=lay.get("w_down") == "row",
                   embed_split=embed_split, head_split=head_split, comm=tp)


def local_spec(spec: DecoderSpec, shard: TPShard) -> DecoderSpec:
    """The rank's spec: its own query and kv heads (the attention and the
    KV pools take these) and MLP width, and its layout in `tp`."""
    h_local = (spec.num_heads // shard.world if shard.attn_split
               else spec.num_heads)
    kv_local = (len(shard.kv_index) if shard.kv_index is not None
                else shard.kv_heads_in)
    f_local = (spec.intermediate_size // shard.world if shard.mlp_split
               else spec.intermediate_size)
    return dataclasses.replace(spec, num_heads=h_local,
                               num_kv_heads=kv_local,
                               intermediate_size=f_local, tp=shard)


def shard_model(spec: DecoderSpec, params: dict, tp: TPGroup, device):
    """The rank's (local spec, params on `device`) of a full unfused model:
    the JAX rules' shard with each bias split where its weight is, and the
    rank's layout in the spec's `tp`. Any world size, 1 included: a group
    of one runs the same code and collectives."""
    if spec.tp is not None:
        raise ValueError("the spec is already a rank's")
    splits = _bias_follows_weight(param_splits(spec, params, tp.world))
    shard = _layout(spec, splits, tp)
    local = _apply(params, splits, tp.rank, tp.world, device)
    return local_spec(spec, shard), local

