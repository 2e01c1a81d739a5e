"""The port's GPTQ-INT4 module and the plain version of its dequant-GEMM
kernel against the JAX package (fp32, CPU).

The same seeded numpy inputs go through both packages. Packing, unpacking,
zbias and act-order normalization must match exactly; products within atol
1e-4 + rtol 1e-4 (the same f32 sums in another order; the kernel's form
q*scale - zbias rounds differently from the JAX dequant's (q - zero)*scale
by an ulp). The JAX side runs its packed kernel `int4_matmul` in interpret
mode (as tests/test_int4.py does) and its XLA `matmul_dequant`; its s4
kernels may not run in interpret mode, so the port is held against
`matmul_dequant` for those names.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_generation_inference_tpu.models import families as jfamilies
from text_generation_inference_tpu.models.fuse import fuse_params as jfuse
from text_generation_inference_tpu.ops import linear as jlinear
from text_generation_inference_tpu.ops.pallas import int4_matmul as jim
from text_generation_inference_tpu.ops.quant import int4 as jint4
from text_generation_inference_tpu_torch.engine.memory import tree_bytes
from text_generation_inference_tpu_torch.engine.paged_cache import PagedKVCache
from text_generation_inference_tpu_torch.engine.paged_engine import kv_row_bytes
from text_generation_inference_tpu_torch.models import families
from text_generation_inference_tpu_torch.models.convert import params_from_jax
from text_generation_inference_tpu_torch.models.core import (DecoderSpec,
                                                             layer_params)
from text_generation_inference_tpu_torch.models.fuse import fuse_params
from text_generation_inference_tpu_torch.ops import linear
from text_generation_inference_tpu_torch.ops.cuda import int4_matmul as tim
from text_generation_inference_tpu_torch.ops.quant import int4
from tests import fixtures

TOL = 1e-4


def close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def both(rng, in_f, out_f, gs=128, act_order=False):
    """One random GPTQ weight in both packages (the JAX one normalized by its
    own `normalize_act_order`, the port's by its own)."""
    qweight = int4.pack_rows(torch.from_numpy(
        rng.integers(0, 16, (in_f, out_f)).astype(np.int32))).numpy()
    qzeros = int4.pack_cols(torch.from_numpy(
        rng.integers(0, 16, (in_f // gs, out_f)).astype(np.int32))).numpy()
    scales = rng.uniform(0.005, 0.02, (in_f // gs, out_f)).astype(np.float32)
    g_idx = (np.arange(in_f) // gs).astype(np.int32)
    if act_order:
        g_idx = rng.permutation(g_idx).astype(np.int32)
    jw = jint4.normalize_act_order(qweight, qzeros, scales, g_idx)
    tw = int4.normalize_act_order(*(torch.from_numpy(a) for a in
                                    (qweight, qzeros, scales, g_idx)))
    return jw, tw


@pytest.mark.parametrize("shape", [(64, 32), (8, 1536)])
def test_pack_unpack_match_jax(shape):
    rng = np.random.default_rng(0)
    q = rng.integers(0, 16, size=shape).astype(np.int32)
    rows = int4.pack_rows(torch.from_numpy(q))
    cols = int4.pack_cols(torch.from_numpy(q))
    np.testing.assert_array_equal(rows.numpy(), jint4.pack_rows(q))
    np.testing.assert_array_equal(cols.numpy(), jint4.pack_cols(q))
    np.testing.assert_array_equal(int4.unpack_rows(rows).numpy(), q)
    np.testing.assert_array_equal(int4.unpack_cols(cols).numpy(), q)
    # the top nibble set makes the word negative; it still reads unsigned
    assert (rows < 0).any()


@pytest.mark.parametrize("act_order", [False, True], ids=["sequential", "act_order"])
def test_normalize_and_zbias_match_jax(act_order):
    jw, tw = both(np.random.default_rng(1), 256, 256, act_order=act_order)
    for f in ("qweight", "qzeros", "scales", "g_idx", "perm", "zbias"):
        a, b = getattr(tw, f), getattr(jw, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    assert int4.is_sequential_gidx(tw) and jim.is_sequential_gidx(jw)
    shuffled = tw._replace(g_idx=tw.g_idx.flip(0))
    assert not int4.is_sequential_gidx(shuffled)
    close(int4.dequantize(tw), jint4.dequantize(jw, jnp.float32), 0)


# the `mini` preset widths: hidden 256, intermediate 512, fused qkv 256 +
# 2 * 128 (4 kv heads of 32) and fused gate/up 1024; plus 1536 wide
@pytest.mark.parametrize("in_f,out_f", [(256, 256), (256, 512), (512, 256),
                                        (256, 1536)])
def test_products_match_jax(in_f, out_f):
    rng = np.random.default_rng(in_f + out_f)
    jw, tw = both(rng, in_f, out_f)
    x = rng.normal(size=(16, in_f)).astype(np.float32)
    want = jint4.matmul_dequant(jnp.asarray(x), jw)
    packed = jim.int4_matmul(jnp.asarray(x), jw, interpret=True)
    close(packed, want)
    xt = torch.from_numpy(x)
    stacked = int4.Int4Weight(*(None if f is None else f[None] for f in tw))
    for got in (tim.int4_matmul(xt, tw), tim.int4_matmul_s4(xt, tw),
                tim.int4_matmul_s4_stacked(xt, stacked, 0),
                tim.int4_matmul_reference(xt, tw), int4.matmul_dequant(xt, tw)):
        close(got, want)
        close(got, packed)


def test_act_order_product_matches_jax_linear():
    """The act-order perm gathers x before the product, on every route."""
    rng = np.random.default_rng(7)
    jw, tw = both(rng, 256, 512, act_order=True)
    x = rng.normal(size=(2, 3, 256)).astype(np.float32)
    want = jlinear.matmul(jnp.asarray(x), jw)
    xt = torch.from_numpy(x)
    close(linear.matmul(xt, tw), want)
    stack = int4.Int4Weight(*(None if f is None else torch.stack([f, f])
                              for f in tw))
    layers = {"w": stack}
    for lp in (layer_params(layers, 1),
               layer_params(linear.prepare_params({"layers": layers}, rows=6)
                            ["layers"], 1),
               layer_params(layers, 1, int4_plain=True)):
        close(linear.matmul(xt, lp["w"]), want)


def test_routes_and_launch_counts_on_cpu():
    """prepare_params(rows) marks stacked weights for the stacked route,
    prefill views take the packed route; on CPU tensors no kernel launches."""
    rng = np.random.default_rng(8)
    _, tw = both(rng, 256, 256)
    stack = int4.Int4Weight(*(None if f is None else torch.stack([f, f])
                              for f in tw))
    params = {"layers": {"w": stack, "ln": {"scale": torch.ones(2, 4)}}}
    assert linear.prepare_params(params) is params
    decode = layer_params(linear.prepare_params(params, rows=16)["layers"], 0)
    prefill = layer_params(params["layers"], 0)
    assert (decode["w"].route, prefill["w"].route) == ("stacked", "packed")
    assert decode["w"].layer == prefill["w"].layer == 0
    assert decode["ln"]["scale"].shape == (4,)
    before = (tim.int4_matmul.launches, tim.int4_matmul_s4.launches,
              tim.int4_matmul_s4_stacked.launches)
    x = torch.from_numpy(rng.normal(size=(4, 256)).astype(np.float32))
    close(linear.matmul(x, decode["w"]), linear.matmul(x, prefill["w"]), 0)
    with pytest.raises(ValueError, match="one layer at a time"):
        linear.matmul(x, stack)
    assert (tim.int4_matmul.launches, tim.int4_matmul_s4.launches,
            tim.int4_matmul_s4_stacked.launches) == before


def test_quantize_rtn_matches_jax():
    w = np.random.default_rng(9).normal(size=(3, 256, 64)).astype(np.float32)
    jw = jint4.quantize_stacked_rtn(w, groupsize=128)
    tw = int4.quantize_stacked_rtn(w, groupsize=128)
    for f in ("qweight", "qzeros", "scales", "g_idx", "zbias"):
        np.testing.assert_array_equal(getattr(tw, f).numpy(),
                                      np.asarray(getattr(jw, f)), err_msg=f)


@pytest.fixture(scope="module")
def rtn_llama():
    """tiny_llama with every layer linear RTN-quantized by the JAX package
    (group 32), in both packages."""
    spec, jparams = jfamilies.load_model(fixtures.tiny_llama(),
                                         dtype=jnp.float32)
    jparams = jint4.quantize_layer_params_int4(jparams, groupsize=32)
    return spec, jparams


def test_fused_int4_matches_jax(rtn_llama):
    spec, jparams = rtn_llama
    jf = jfuse(spec, jparams)
    tp = params_from_jax(spec, jax.tree_util.tree_map(np.asarray, jparams),
                         device="cpu")
    tf = fuse_params(spec, tp)
    for key in ("w_qkv", "w_gu"):
        for f in ("qweight", "qzeros", "scales", "zbias"):
            np.testing.assert_array_equal(
                getattr(tf["layers"][key], f).numpy(),
                np.asarray(getattr(jf["layers"][key], f)))
    # never under act-order: the projections stay separate
    lp = dict(tp["layers"])
    perm = torch.arange(64, dtype=torch.int32).repeat(spec.num_layers, 1)
    lp["wq"] = lp["wq"]._replace(perm=perm)
    kept = fuse_params(spec, dict(tp, layers=lp))["layers"]
    assert "wq" in kept and "w_qkv" not in kept and "w_gu" in kept


def test_carried_int4_tree_gives_jax_prefill_logits(rtn_llama):
    """A JAX Int4Weight tree converts by field name and gives the JAX
    package's prefill_paged logits (int8 pool)."""
    from text_generation_inference_tpu.engine.paged_cache import (
        PagedKVCache as JCache)
    from text_generation_inference_tpu.models import paged_core as jpaged
    from text_generation_inference_tpu_torch.models import paged_core

    spec, jparams = rtn_llama
    jparams = jfuse(spec, jparams)
    tparams = params_from_jax(spec, jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    assert isinstance(tparams["layers"]["w_qkv"], int4.Int4Weight)
    bt = np.asarray([[3, 1, 6, 8], [0, 2, 8, 8]], np.int32)
    jc = JCache.create(spec, 8, 8, 2, 4, jnp.int8)._replace(
        block_table=jnp.asarray(bt))
    tc = PagedKVCache.create(spec, 8, 8, 2, 4, torch.int8, "cpu")._replace(
        block_table=torch.from_numpy(bt))
    ids = np.random.default_rng(10).integers(0, spec.vocab_size, (2, 16))
    ids = ids.astype(np.int32)
    lengths = np.asarray([16, 11], np.int32)
    slots = np.asarray([0, 1], np.int32)
    jl, jc = jpaged.prefill_paged(spec, jparams, jnp.asarray(ids),
                                  jnp.asarray(lengths), jnp.asarray(slots),
                                  jc, 8)
    tl, tc = paged_core.prefill_paged(spec, tparams, torch.from_numpy(ids),
                                      torch.from_numpy(lengths),
                                      torch.from_numpy(slots), tc, 8)
    for row, n in enumerate(lengths):
        close(tl[row, :n], jl[row, :n])
    close(tc.k_scale, jc.k_scale, 1e-6)
    assert np.abs(tc.k.numpy().astype(int) - np.asarray(jc.k, int)).max() <= 1


def test_tree_bytes_counts_int4():
    _, tw = both(np.random.default_rng(11), 256, 512, act_order=True)
    want = sum(t.numel() * t.element_size() for t in tw if t is not None)
    assert tree_bytes({"layers": {"w": tw}}) == want > 256 * 512 // 2


LLAMA7B = DecoderSpec(vocab_size=32000, hidden_size=4096, num_layers=32,
                      num_heads=32, num_kv_heads=32, head_dim=128,
                      intermediate_size=11008)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
def test_pool_estimate_matches_allocation_at_7b_widths(dtype):
    """The engine's pool sizing (bytes per token row, scale rows counted for
    int8) is within 1% of the tensors a 7B-width pool allocates."""
    num_pages, page = 2, 16
    cache = PagedKVCache.create(LLAMA7B, num_pages, page, 4, 2, dtype, "cpu")
    estimate = num_pages * page * kv_row_bytes(LLAMA7B, dtype)
    assert abs(estimate - cache.pool_bytes()) <= 0.01 * cache.pool_bytes()
    per_row = 32 * 2 * 32 * (128 * (1 if dtype == torch.int8 else 2))
    assert cache.pool_bytes() >= num_pages * page * per_row


@pytest.fixture(scope="module")
def mini_gptq(tmp_path_factory):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    from make_shaped_checkpoint import PRESETS, write_checkpoint

    out = str(tmp_path_factory.mktemp("gptq") / "mini_gptq")
    write_checkpoint(out, PRESETS["mini"], quantize="gptq")
    return out


def test_gptq_loader_matches_jax_loader(mini_gptq):
    """Mirrors tests/test_gptq.py: quantize="gptq" loads a GPTQ checkpoint,
    fails on a dense one; quantize="int8" on a GPTQ checkpoint leaves its
    Int4Weights as they are (only tensor leaves quantize), as in JAX."""
    tspec, tparams = families.load_model(mini_gptq, dtype=torch.float32,
                                         quantize="gptq", device="cpu")
    jspec, jparams = jfamilies.load_model(mini_gptq, dtype=jnp.float32,
                                          quantize="gptq")
    assert tspec == DecoderSpec(**vars(jspec))
    for key in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tw, jw = tparams["layers"][key], jparams["layers"][key]
        assert isinstance(tw, int4.Int4Weight) and tw.perm is None
        for f in ("qweight", "qzeros", "scales", "g_idx", "zbias"):
            np.testing.assert_array_equal(getattr(tw, f).numpy(),
                                          np.asarray(getattr(jw, f)))
    with pytest.raises(ValueError, match="no GPTQ tensors"):
        families.load_model(fixtures.tiny_llama(), dtype=torch.float32,
                            quantize="gptq", device="cpu")
    _, t8params = families.load_model(mini_gptq, dtype=torch.float32,
                                      quantize="int8", device="cpu")
    _, j8params = jfamilies.load_model(mini_gptq, dtype=jnp.float32,
                                       quantize="int8")
    assert set(t8params["layers"]) == set(j8params["layers"])
    for key, tw in t8params["layers"].items():
        jw = j8params["layers"][key]
        if isinstance(jw, jint4.Int4Weight):
            assert isinstance(tw, int4.Int4Weight), key
            for f in ("qweight", "qzeros", "scales", "g_idx", "zbias"):
                np.testing.assert_array_equal(getattr(tw, f).numpy(),
                                              np.asarray(getattr(jw, f)))
        elif key in ("ln1", "ln2"):
            np.testing.assert_array_equal(tw["scale"].numpy(),
                                          np.asarray(jw["scale"]))
        else:
            assert isinstance(tw, torch.Tensor), key
            np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
