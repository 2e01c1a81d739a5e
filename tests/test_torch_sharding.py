"""The port's sharding rules (`parallel/sharding.py`) against the JAX
package's on its virtual 8-device CPU mesh, with no processes: for 2, 4
and 8 model devices, rank r's shard of every leaf, cut by the port, equals
the data of JAX's device-r shard from `shard_params`, bit for bit, field
by field for quantized leaves. Models: dense f32 (the JAX test's spec),
GPTQ-INT4 with both fallbacks (wo's groups and w_down's groups do not
divide; w_up's out dim not a multiple of 8 * world), int8, int8 with
outlier rows, multi-query, and a vocabulary that does not divide.

Also the rank's layout and local spec (`shard_model` on a one-process
stand-in group): the kv heads of its KV pool against JAX `cache_spec`,
and the kv heads each rank attends with where JAX keeps them whole.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from tests.torch_tp_ranks import numpy_tree
from text_generation_inference_tpu.models import core as jcore
from text_generation_inference_tpu.ops.quant import int4 as jint4
from text_generation_inference_tpu.ops.quant import int8 as jint8
from text_generation_inference_tpu.parallel import sharding as jshd
from text_generation_inference_tpu_torch.models import core
from text_generation_inference_tpu_torch.models.convert import (
    params_from_jax, rank_params_from_jax)
from text_generation_inference_tpu_torch.parallel import sharding

SPEC = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=8,
            num_kv_heads=4, head_dim=16, intermediate_size=256)


def _int4(params, groupsize):
    return jint4.quantize_layer_params_int4(params, groupsize=groupsize)


def _outliers(params):
    stats = {}
    for k, w in params["layers"].items():
        if k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            am = np.ones(w.shape[:2], np.float32)
            am[:, [3, 17]] = 9.0
            stats[k] = am
    return jint8.quantize_layer_params(params, outlier_stats=stats)


# name -> (spec fields, quantizer)
MODELS = {
    "dense": (SPEC, None),
    # groupsize 32: wo has 4 groups (whole on 8 devices); with F = 96,
    # w_down's 3 groups never divide and w_up's 96 columns are not a
    # multiple of 64 on 8 devices
    "int4_fallbacks": (dict(SPEC, intermediate_size=96),
                       functools.partial(_int4, groupsize=32)),
    "int4": (SPEC, functools.partial(_int4, groupsize=32)),
    "int8": (SPEC, jint8.quantize_layer_params),
    "int8_outliers": (SPEC, _outliers),
    "mqa": (dict(SPEC, num_kv_heads=1, qkv_bias=True, attn_out_bias=True,
                 mlp_bias=True), None),
    "vocab_odd": (dict(SPEC, vocab_size=509, tie_word_embeddings=True),
                  None),
}


@functools.lru_cache(maxsize=None)
def model(name):
    fields, quantize = MODELS[name]
    jspec = jcore.DecoderSpec(**fields)
    jparams = jcore.init_params(jspec, jax.random.key(3))
    if quantize is not None:
        jparams = quantize(jparams)
    spec = core.DecoderSpec(**vars(jspec))
    return jspec, jparams, spec, params_from_jax(spec, numpy_tree(jparams),
                                                 device="cpu")


def _device_shards(jspec, jparams, ms):
    """JAX's shard of every leaf on each model device: a list (by device)
    of numpy trees."""
    mesh = jshd.make_mesh(model_parallel=ms)
    sharded = jshd.shard_params(jparams, jshd.param_specs(jspec, jparams,
                                                          mesh), mesh)
    devices = list(mesh.devices[0])

    def on(arr, r):
        for s in arr.addressable_shards:
            if s.device == devices[r]:
                return np.asarray(s.data)
        raise AssertionError("no shard on the device")

    return [jax.tree_util.tree_map(functools.partial(on, r=r), sharded)
            for r in range(ms)]


def _assert_same(port, jax_tree, path=""):
    if isinstance(port, dict):
        assert set(port) == set(jax_tree), path
        for k in port:
            _assert_same(port[k], jax_tree[k], f"{path}/{k}")
        return
    if isinstance(port, tuple):
        for field, value in zip(port._fields, port):
            want = getattr(jax_tree, field)
            assert (value is None) == (want is None), f"{path}.{field}"
            if value is not None:
                _assert_same(value, want, f"{path}.{field}")
        return
    if port.dtype == torch.bfloat16:
        # compare the bits
        got, jax_tree = port.view(torch.int16).numpy(), jax_tree.view(
            np.int16)
    else:
        got = port.numpy()
    assert got.shape == jax_tree.shape, (path, got.shape, jax_tree.shape)
    assert np.array_equal(got, jax_tree), path


CASES = [(name, ms) for name in MODELS for ms in (2, 4, 8)]


@pytest.mark.parametrize("name,ms", CASES,
                         ids=[f"{n}-ms{m}" for n, m in CASES])
def test_rank_shards_equal_jax_device_shards(name, ms):
    jspec, jparams, spec, _ = model(name)
    want = _device_shards(jspec, jparams, ms)
    params_np = numpy_tree(jparams)
    for r in range(ms):
        _assert_same(rank_params_from_jax(spec, params_np, r, ms, "cpu"),
                     want[r], f"rank {r}")


def test_fallbacks_are_the_jax_ones():
    """The INT4 fallbacks the equality cases cover, read from the rules."""
    _, _, spec, params = model("int4_fallbacks")
    splits = sharding.param_splits(spec, params, 8)["layers"]
    assert splits["wo"]["qweight"] is None          # 4 groups on 8
    assert splits["w_down"]["qweight"] is None      # 3 groups
    assert splits["w_up"]["qweight"] is None        # 96 % 64
    assert splits["wq"]["qweight"] == -1
    assert splits["wq"]["g_idx"] is None
    splits = sharding.param_splits(spec, params, 4)["layers"]
    assert splits["w_up"]["scales"] == -1           # 96 % 32 == 0
    assert splits["w_down"]["scales"] is None       # 3 groups on 4


class _Group:
    """A stand-in for `parallel.comm.TPGroup`: the layout reads only the
    rank and the world."""

    def __init__(self, rank, world):
        self.rank, self.world = rank, world


@pytest.mark.parametrize("name,ms", [("dense", 2), ("dense", 8),
                                     ("mqa", 4), ("vocab_odd", 4)])
def test_local_spec_and_pool_heads(name, ms):
    jspec, _, spec, params = model(name)
    mesh = jshd.make_mesh(model_parallel=ms)
    kv_split = jshd.cache_spec(jspec, mesh)[2] == "model"
    assert jshd.paged_pool_spec(jspec, mesh)[1] == jshd.cache_spec(
        jspec, mesh)[2]
    for r in range(ms):
        local, lp = sharding.shard_model(spec, params, _Group(r, ms), "cpu")
        shard = local.tp
        if kv_split:
            # JAX splits the pool's kv heads: so does the port
            assert local.num_kv_heads == spec.num_kv_heads // ms
            assert shard.kv_index is None
        else:
            # JAX keeps every kv head in the pool; the port keeps the
            # ones this rank's query heads read
            group = spec.num_heads // spec.num_kv_heads
            heads = range(r * local.num_heads, (r + 1) * local.num_heads)
            assert sorted(set(shard.kv_index)) == sorted(
                {h // group for h in heads})
        assert local.num_heads == spec.num_heads // ms
        assert shard.head_offset == r * local.num_heads
        assert shard.embed_split == (spec.vocab_size % ms == 0)
        assert lp["layers"]["wq"].shape[-1] == local.q_size
    assert torch.equal(lp["final_norm"]["scale"], params["final_norm"]["scale"])


def test_a_fused_matrix_is_never_column_split():
    from text_generation_inference_tpu_torch.models.fuse import fuse_params

    _, _, spec, params = model("dense")
    with pytest.raises(ValueError, match="fused"):
        sharding.shard_params(spec, fuse_params(spec, params), 0, 2)
