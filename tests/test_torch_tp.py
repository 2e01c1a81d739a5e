"""Tensor parallelism of the PyTorch port on gloo ranks (CPU processes):
each rank holds its shard of the model (`parallel.sharding.shard_model`)
and runs the layer code's collectives (`parallel.comm`). Mirrors the JAX
package's tests/test_sharding.py, where a GSPMD mesh must match the
single-device run.

Logits: the prefill and two teacher-forced decode steps of every model
below, on 2 and 4 ranks, are held to the JAX package's single-device run
and to the port's one-process run at rtol = atol = 1e-5 in f32 (int8
weights: a bf16 ulp, `INT8_RTOL`), and every rank's logits equal rank 0's
bit for bit. The models cover each place where
a process per rank leaves GSPMD: mixed shard pairs (an INT4 w_up split
beside a whole w_down; wq split beside a whole INT4 wo; query heads that do
not divide the world, with a split MLP), act-order INT4 under a row split,
int8 and int8 outlier rows under a row split, kv heads that do not divide
the world (multi-query, and query heads that span part of a group), a
vocabulary that does not divide, tied embeddings with every bias, ALiBi
(bloom) and the parallel residual (gpt_neox).

Greedy token streams: the slot engine, the paged engine at chunk 1 and
chunk 4, GPTQ-INT4 with act-order, int8 weights, an int8 KV pool and the
paged speculative engine, on 2 (and some on 4) ranks, equal the port's
one-process engine, and every rank's next ids equal rank 0's at every call.

Each world's ranks start once for the module (`tests/torch_tp_ranks.py`).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_tp_ranks import (DECODE_IDS, PROMPTS, RankPool,
                                  greedy_streams, make_engine, model_logits,
                                  numpy_tree)
from text_generation_inference_tpu.models import core as jcore
from text_generation_inference_tpu.ops.quant import int4 as jint4
from text_generation_inference_tpu.ops.quant import int8 as jint8
from text_generation_inference_tpu_torch.models import core
from text_generation_inference_tpu_torch.models.convert import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
# int8 weights: both packages round the activations to bf16 before each
# product (JAX `ops/quant/int8.py`), so a last-bit difference of the f32
# sums upstream (a rank's partial sums, or another summation order) can
# move one bf16 rounding downstream: logits agree to a bf16 ulp of the
# largest logit, the repo's bf16 tolerance for the int8 product (2^-8)
INT8_RTOL = 2.0 ** -8

BASE = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=8,
            num_kv_heads=4, head_dim=16, intermediate_size=192,
            max_position_embeddings=64)
BIASES = dict(qkv_bias=True, attn_out_bias=True, mlp_bias=True)
LAYERNORM = dict(norm="layernorm", activation="gelu", **BIASES)

# name -> (spec fields, weights): "f32", ("int4", groupsize, act_order),
# ("int8", outlier features or None)
MODELS = {
    "gqa": (BASE, "f32"),
    "mqa": (dict(BASE, num_kv_heads=1), "f32"),
    # 6 query heads over 3 kv heads: on 2 ranks each rank's 3 query heads
    # span one and a half groups; on 4 the heads do not divide, so the
    # attention stays whole while the MLP is split
    "partial_groups": (dict(BASE, num_heads=6, num_kv_heads=3), "f32"),
    # groupsize 64: w_down's 3 groups never divide, so it stays whole
    # beside the split w_gate / w_up; wo's 2 groups stay whole on 4 ranks
    "int4_mixed": (BASE, ("int4", 64, False)),
    # act-order wo and w_down, row-split (w_down's 4 groups divide)
    "int4_act_order": (dict(BASE, intermediate_size=256), ("int4", 64, True)),
    "int8": (BASE, ("int8", None)),
    # two hot input features a linear (the JAX CPU product takes two),
    # in the first and the last rank's block of wo's and w_down's rows
    "int8_outliers": (BASE, ("int8", {"wo": [17, 100], "w_down": [17, 150],
                                      "*": [17, 40]})),
    "vocab_odd": (dict(BASE, vocab_size=509), "f32"),
    "tied": (dict(BASE, num_kv_heads=8, pos="learned",
                  tie_word_embeddings=True, **LAYERNORM), "f32"),
    "bloom": (dict(BASE, num_kv_heads=8, pos="alibi", embed_norm=True,
                   **LAYERNORM), "f32"),
    "gpt_neox": (dict(BASE, num_kv_heads=8, parallel_residual=True,
                      rotary_pct=0.25, **LAYERNORM), "f32"),
}


def _randomize(params, rng):
    """Biases and norm parameters drawn at random (JAX `init_params` gives
    zeros and ones, which would hide a bias added on every rank)."""
    def walk(tree, key=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        a = np.asarray(tree)
        if key in ("bias", "bq", "bk", "bv", "bo", "b_up", "b_gate",
                   "b_down"):
            return a + rng.normal(0, 0.1, a.shape).astype(a.dtype)
        if key == "scale":
            return a + rng.normal(0, 0.1, a.shape).astype(a.dtype)
        return a
    return walk(params)


@functools.lru_cache(maxsize=None)
def model(name: str):
    """(JAX spec, JAX params, port spec, the port's whole params)."""
    fields, weights = MODELS[name]
    jspec = jcore.DecoderSpec(**fields)
    rng = np.random.default_rng(sum(map(ord, name)))
    params = _randomize(jcore.init_params(jspec, jax.random.key(0)), rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    if weights != "f32" and weights[0] == "int4":
        _, groupsize, act_order = weights
        jparams = jint4.quantize_layer_params_int4(jparams,
                                                   groupsize=groupsize)
        if act_order:
            lp = dict(jparams["layers"])
            for key in ("wo", "w_down"):
                w = lp[key]
                perm = np.stack([rng.permutation(w.in_features)
                                 for _ in range(w.qweight.shape[0])])
                lp[key] = w._replace(perm=jnp.asarray(perm, jnp.int32))
            jparams = dict(jparams, layers=lp)
    elif weights != "f32":
        hot = weights[1]
        stats = None
        if hot is not None:
            stats = {}
            for k, w in params["layers"].items():
                if k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
                    am = np.ones(w.shape[:2], np.float32)
                    am[:, hot.get(k, hot["*"])] = 9.0
                    stats[k] = am
        jparams = jint8.quantize_layer_params(jparams, outlier_stats=stats)
    spec = core.DecoderSpec(**vars(jspec))
    tparams = params_from_jax(spec, numpy_tree(jparams), device="cpu")
    return jspec, jparams, spec, tparams


@functools.lru_cache(maxsize=None)
def jax_logits(name: str) -> dict:
    """The JAX package's single-device run of `model_logits`' inputs."""
    jspec, jparams, _, _ = model(name)
    ids = np.zeros((2, 8), np.int32)
    for i, p in enumerate(PROMPTS):
        ids[i, :len(p)] = p
    lengths = np.asarray([len(p) for p in PROMPTS], np.int32)
    cache = jcore.KVCache.create(jspec, 2, 32, jnp.float32)
    logits, cache = jcore.prefill(jspec, jparams, jnp.asarray(ids),
                                  jnp.asarray(lengths),
                                  jnp.asarray([0, 1], jnp.int32), cache)
    out = {"prefill": [np.asarray(logits[i, :len(p)])
                       for i, p in enumerate(PROMPTS)], "decode": []}
    pos = lengths.copy()
    for step in DECODE_IDS:
        d, cache = jcore.decode(jspec, jparams, jnp.asarray(step, jnp.int32),
                                jnp.asarray(pos), cache,
                                context_len=jnp.asarray(pos + 1))
        out["decode"].append(np.asarray(d))
        pos = pos + 1
    return out


@functools.lru_cache(maxsize=None)
def one_rank_logits(name: str, paged: bool) -> dict:
    _, _, spec, params = model(name)
    return model_logits(spec, params, paged)


@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(world):
        if world not in made:
            made[world] = RankPool(world)
        return made[world]

    yield get
    for pool in made.values():
        pool.close()


def _close(got: dict, want: dict, name: str) -> None:
    pairs = list(zip(got["prefill"] + got["decode"],
                     want["prefill"] + want["decode"]))
    tol = TOL
    if MODELS[name][1] != "f32" and MODELS[name][1][0] == "int8":
        peak = max(float(np.abs(w).max()) for _, w in pairs)
        tol = dict(rtol=INT8_RTOL, atol=INT8_RTOL * peak)
    for g, w in pairs:
        np.testing.assert_allclose(g, w, **tol)


def _same_on_every_rank(results: list) -> None:
    for r in results[1:]:
        for key in ("prefill", "decode"):
            for a, b in zip(r[key], results[0][key]):
                assert np.array_equal(a, b)


LOGIT_CASES = [(name, world, False) for name in MODELS for world in (2, 4)]
LOGIT_CASES += [("gqa", 2, True), ("partial_groups", 2, True),
                ("mqa", 4, True), ("bloom", 4, True)]


@pytest.mark.parametrize("name,world,paged", LOGIT_CASES,
                         ids=[f"{n}-w{w}{'-paged' if p else ''}"
                              for n, w, p in LOGIT_CASES])
def test_rank_logits_match_jax_and_one_rank(pools, name, world, paged):
    _, _, spec, params = model(name)
    results = pools(world).run("logits", spec, params, paged)
    _same_on_every_rank(results)
    _close(results[0], jax_logits(name), name)
    _close(results[0], one_rank_logits(name, paged), name)


def test_layouts_place_each_hazard(pools):
    """The layouts the logits cases run: the rank-local widths and the kv
    heads each rank attends with."""
    def layouts(name, world):
        _, _, spec, params = model(name)
        return [r["layout"] for r in
                pools(world).run("logits", spec, params, False)]

    # (query heads, kv heads, MLP width, kv_index) per rank
    assert layouts("gqa", 2) == [(4, 2, 96, None)] * 2
    assert layouts("mqa", 4) == [(2, 1, 48, (0,))] * 4
    assert layouts("partial_groups", 2) == [(3, 3, 96, (0, 0, 1)),
                                            (3, 3, 96, (1, 2, 2))]
    assert layouts("partial_groups", 4) == [(6, 3, 48, None)] * 4


STREAM_CASES = [
    ("slot", "gqa", {}, 2), ("slot", "gqa", {}, 4),
    ("slot", "partial_groups", dict(decode_chunk=4), 2),
    ("paged", "gqa", {}, 2),
    ("paged", "gqa", dict(decode_chunk=4), 2),
    ("paged", "mqa", dict(decode_chunk=4), 4),
    ("paged", "int4_act_order", {}, 2),
    ("paged", "int4_mixed", dict(decode_chunk=4), 4),
    ("paged", "int8", {}, 2), ("paged", "int8_outliers", {}, 4),
    ("paged", "gqa", dict(kv_cache_dtype="int8", decode_chunk=4), 2),
    ("paged", "bloom", dict(kv_cache_dtype="int8", decode_chunk=4), 4),
    ("paged_spec", "gqa", {}, 2), ("paged_spec", "partial_groups", {}, 4),
]


@functools.lru_cache(maxsize=None)
def one_rank_streams(kind: str, name: str, kw: tuple):
    _, _, spec, params = model(name)
    return greedy_streams(make_engine(kind, spec, params, dict(kw)))


@pytest.mark.parametrize("kind,name,kw,world", STREAM_CASES,
                         ids=[f"{k}-{n}-{'-'.join(map(str, c.values())) or 'default'}-w{w}"
                              for k, n, c, w in STREAM_CASES])
def test_greedy_streams_match_one_rank(pools, kind, name, kw, world):
    _, _, spec, params = model(name)
    results = pools(world).run("streams", kind, spec, params, kw)
    want_tokens, want_record = one_rank_streams(kind, name,
                                                tuple(sorted(kw.items())))
    for r in results:
        # every rank picks rank 0's ids at every call: lockstep
        assert r["record"] == results[0]["record"]
    assert results[0]["tokens"] == want_tokens
    assert results[0]["record"] == want_record
    if kind != "slot":
        assert len({r["pages"] for r in results}) == 1


def test_decode_programs_refuse_to_capture_host_collectives():
    """A gloo group's collectives on CUDA tensors go through the host: an
    engine on the card over such a group must be built eager, and asking
    its programs to capture raises (no silent fallback)."""
    from text_generation_inference_tpu_torch.engine.programs import (
        DecodePrograms)

    class Gloo:
        capturable = False

    with pytest.raises(ValueError, match="eager_decode=True"):
        DecodePrograms(torch.device("cuda"), capture=True, tp=Gloo())
    assert not DecodePrograms(torch.device("cuda"), capture=False,
                              tp=Gloo()).capture
