"""The PyTorch port's paged forward passes against the JAX package's, on
identical weights carried across by `models/convert.py::params_from_jax`.

fp32 on the CPU, tiny_llama fixture (3 layers, hidden 64, 4 heads / 2 kv
heads). Logits agree within atol 1e-4 and the KV pools within 1e-5 (the
same matmuls in another library's summation order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_generation_inference_tpu.engine.paged_cache import (
    PagedKVCache as JPagedKVCache)
from text_generation_inference_tpu.models import core as jcore
from text_generation_inference_tpu.models import families as jfamilies
from text_generation_inference_tpu.models import paged_core as jpaged
from text_generation_inference_tpu.models.fuse import fuse_params as jfuse
from text_generation_inference_tpu_torch.engine.paged_cache import PagedKVCache
from text_generation_inference_tpu_torch.models import core as tcore
from text_generation_inference_tpu_torch.models import families as tfamilies
from text_generation_inference_tpu_torch.models import paged_core as tpaged
from text_generation_inference_tpu_torch.models.convert import params_from_jax
from text_generation_inference_tpu_torch.models.core import KVCache
from text_generation_inference_tpu_torch.ops.attention import PLAIN
from tests import fixtures

LOGIT_TOL = 1e-4
POOL_TOL = 1e-5
PAGE = 8
NUM_PAGES = 10
MAX_PAGES = 4   # max_seq 32
SLOTS = 3


@pytest.fixture(scope="module")
def jax_model():
    return jfamilies.load_model(fixtures.tiny_llama(), dtype=jnp.float32)


def carry(spec, jparams, fused):
    if fused:
        jparams = jfuse(spec, jparams)
    tparams = params_from_jax(spec, jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return spec, jparams, tparams


@pytest.fixture(scope="module", params=["unfused", "fused"])
def both_layouts(request, jax_model):
    """Params carried across in both layouts (the engine fuses)."""
    return carry(*jax_model, request.param == "fused")


@pytest.fixture(scope="module")
def models(jax_model):
    return carry(*jax_model, fused=True)


def np_(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x)


def close(got, want, tol):
    np.testing.assert_allclose(np_(got), np_(want), rtol=tol, atol=tol)


def make_caches(spec, bt, seed=0):
    """JAX and port caches holding the same random pool contents."""
    rng = np.random.default_rng(seed)
    shape = (spec.num_layers, spec.num_kv_heads, NUM_PAGES * PAGE,
             spec.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    jc = JPagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                       block_table=jnp.asarray(bt))
    tc = PagedKVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()),
                      block_table=torch.from_numpy(bt.copy()))
    return jc, tc


# slot 0: pages 7, 2, 9 ; slot 1: pages 4, 0 ; slot 2: unmapped (sentinel)
BT = np.asarray([[7, 2, 9, NUM_PAGES], [4, 0, NUM_PAGES, NUM_PAGES],
                 [NUM_PAGES] * MAX_PAGES], np.int32)


def test_prefill_paged(both_layouts):
    spec, jparams, tparams = both_layouts
    jc, tc = make_caches(spec, BT)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, spec.vocab_size, size=(2, 16)).astype(np.int32)
    lengths = np.asarray([16, 9], np.int32)
    slots = np.asarray([0, 1], np.int32)
    jl, jc = jpaged.prefill_paged(spec, jparams, jnp.asarray(ids),
                                  jnp.asarray(lengths), jnp.asarray(slots),
                                  jc, PAGE)
    tl, tc = tpaged.prefill_paged(spec, tparams, torch.from_numpy(ids),
                                  torch.from_numpy(lengths),
                                  torch.from_numpy(slots), tc, PAGE)
    for row, n in enumerate(lengths):
        close(tl[row, :n], jl[row, :n], LOGIT_TOL)
    close(tc.k, jc.k, POOL_TOL)
    close(tc.v, jc.v, POOL_TOL)


def test_decode_paged_drops_inactive_and_unmapped_writes(models):
    spec, jparams, tparams = models
    jc, tc = make_caches(spec, BT, seed=2)
    ids = np.asarray([5, 17, 99], np.int32)
    # slot 0 live at position 19; slot 1 INACTIVE with a stale table;
    # slot 2 active but its page is the sentinel (an overrun)
    pos = np.asarray([19, 11, 3], np.int32)
    active = np.asarray([True, False, True])
    jl, jc = jpaged.decode_paged(spec, jparams, jnp.asarray(ids),
                                 jnp.asarray(pos), jc, jnp.asarray(pos + 1),
                                 PAGE, active=jnp.asarray(active))
    tl, tc = tpaged.decode_paged(spec, tparams, torch.from_numpy(ids),
                                 torch.from_numpy(pos), tc,
                                 torch.from_numpy(pos + 1), PAGE,
                                 active=torch.from_numpy(active))
    # slot 2's context is all sentinel pages: the port's kernel semantics
    # skip them where JAX clamps, so only the mapped slots are compared
    close(tl[:2], jl[:2], LOGIT_TOL)
    close(tc.k, jc.k, POOL_TOL)
    close(tc.v, jc.v, POOL_TOL)


def test_ring_steps_and_flush(models):
    spec, jparams, tparams = models
    jc, tc = make_caches(spec, BT, seed=3)
    rng = np.random.default_rng(4)
    C = 4
    buf_shape = (spec.num_layers, SLOTS, spec.num_kv_heads, C, spec.head_dim)
    kbuf = rng.normal(size=buf_shape).astype(np.float32)
    vbuf = rng.normal(size=buf_shape).astype(np.float32)
    chunk_start = np.asarray([17, 9, 0], np.int32)
    step = 2
    pos = chunk_start + step
    ids = np.asarray([3, 44, 200], np.int32)

    # paged kernel path (stats mode + merge)
    jl, jk, jv = jpaged.decode_paged_ring_step(
        spec, jparams, jnp.asarray(ids), jnp.asarray(pos), jc,
        jnp.asarray(kbuf), jnp.asarray(vbuf), jnp.int32(step),
        jnp.asarray(chunk_start), page_size=PAGE, live_pages=3)
    tl, tk, tv = tpaged.decode_paged_ring_step(
        spec, tparams, torch.from_numpy(ids), torch.from_numpy(pos), tc,
        torch.from_numpy(kbuf), torch.from_numpy(vbuf), step,
        torch.from_numpy(chunk_start), page_size=PAGE, live_pages=3)
    close(tl, jl, LOGIT_TOL)
    close(tk, jk, LOGIT_TOL)
    close(tv, jv, LOGIT_TOL)

    # dense-gather path: gathered view + core.decode_ring_step
    jd = jpaged.gather_dense_view(jc, 3, PAGE)
    td = tpaged.gather_dense_view(tc, 3, PAGE)
    close(td.k, jd.k, 0)
    dl, _, _ = jcore.decode_ring_step(
        spec, jparams, jnp.asarray(ids), jnp.asarray(pos), jd,
        jnp.asarray(kbuf), jnp.asarray(vbuf), jnp.int32(step),
        jnp.asarray(chunk_start))
    tdl, _, _ = tcore.decode_ring_step(
        spec, tparams, torch.from_numpy(ids), torch.from_numpy(pos),
        KVCache(td.k, td.v), torch.from_numpy(kbuf), torch.from_numpy(vbuf),
        step, torch.from_numpy(chunk_start))
    close(tdl, dl, LOGIT_TOL)
    # both attention paths see the same keys for the mapped slots
    close(tdl[:2], tl[:2], LOGIT_TOL)

    # flush: slot 1 inactive; slot 0's ring runs past max_seq=24
    active = np.asarray([True, False, True])
    jc = jpaged.paged_ring_flush(jc, jnp.asarray(kbuf), jnp.asarray(vbuf),
                                 jnp.asarray(chunk_start + 5),
                                 jnp.asarray(active), 24, PAGE)
    tc = tpaged.paged_ring_flush(tc, torch.from_numpy(kbuf),
                                 torch.from_numpy(vbuf),
                                 torch.from_numpy(chunk_start + 5),
                                 torch.from_numpy(active), 24, PAGE)
    close(tc.k, jc.k, 0)
    close(tc.v, jc.v, 0)


def test_plain_ops_match_kernel_dispatch(models):
    """`PLAIN` and `KERNELS` give the same model on the CPU (where the
    wrappers run their plain versions)."""
    spec, _, tparams = models
    _, tc1 = make_caches(spec, BT, seed=5)
    _, tc2 = make_caches(spec, BT, seed=5)
    ids = torch.tensor([5, 17, 99], dtype=torch.int32)
    pos = torch.tensor([19, 11, 3], dtype=torch.int32)
    a, _ = tpaged.decode_paged(spec, tparams, ids, pos, tc1, pos + 1, PAGE)
    b, _ = tpaged.decode_paged(spec, tparams, ids, pos, tc2, pos + 1, PAGE,
                               attn=PLAIN)
    close(a, b, 0)


@pytest.fixture(scope="module")
def wide_model():
    """Head dim 64 and a 128 bucket: the port's prefill dispatch takes the
    flash-kernel branch (its plain version on the CPU); JAX takes its
    einsum path."""
    spec = jcore.DecoderSpec(vocab_size=97, hidden_size=128, num_layers=2,
                             num_heads=2, num_kv_heads=1, head_dim=64,
                             intermediate_size=96)
    jparams = jcore.init_params(spec, jax.random.key(0))
    tparams = params_from_jax(spec, jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return spec, jparams, tparams


def test_prefill_kernel_branch_matches_jax(wide_model):
    spec, jparams, tparams = wide_model
    bt = np.asarray([[3, 5], [0, 8]], np.int32)
    shape = (spec.num_layers, spec.num_kv_heads, NUM_PAGES * 64, spec.head_dim)
    jc = JPagedKVCache(k=jnp.zeros(shape), v=jnp.zeros(shape),
                       block_table=jnp.asarray(bt))
    tc = PagedKVCache(k=torch.zeros(shape), v=torch.zeros(shape),
                      block_table=torch.from_numpy(bt))
    ids = np.random.default_rng(6).integers(0, 97, (2, 128)).astype(np.int32)
    lengths = np.asarray([128, 70], np.int32)
    slots = np.asarray([0, 1], np.int32)
    jl, jc = jpaged.prefill_paged(spec, jparams, jnp.asarray(ids),
                                  jnp.asarray(lengths), jnp.asarray(slots),
                                  jc, 64)
    tl, tc = tpaged.prefill_paged(spec, tparams, torch.from_numpy(ids),
                                  torch.from_numpy(lengths),
                                  torch.from_numpy(slots), tc, 64)
    for row, n in enumerate(lengths):
        close(tl[row, :n], jl[row, :n], LOGIT_TOL)
    close(tc.k, jc.k, POOL_TOL)


def test_loader_matches_jax_loader(jax_model):
    spec, jparams = jax_model
    tspec, tparams = tfamilies.load_model(fixtures.tiny_llama(),
                                          dtype=torch.float32, device="cpu")
    assert tspec == tcore.DecoderSpec(**vars(spec))
    close(tparams["layers"]["wq"], jparams["layers"]["wq"], 0)
    close(tparams["lm_head"], jparams["lm_head"], 0)
    close(tparams["layers"]["ln2"]["scale"], jparams["layers"]["ln2"]["scale"], 0)
