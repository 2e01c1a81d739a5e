"""The PyTorch port's attention kernels against the JAX package's Pallas
kernels (run in interpret mode on the CPU, as tests/test_pallas_kernels.py
does).

On the CPU the port's wrappers take their plain PyTorch versions; the same
seeded numpy inputs go through both packages in fp32 and must agree within
1e-5. tests/test_torch_cuda.py holds the CUDA kernels against those plain
versions on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_generation_inference_tpu.ops.pallas import flash_prefill as jfp
from text_generation_inference_tpu.ops.pallas import paged_attention as jpa
from text_generation_inference_tpu_torch.device import resolve_device
from text_generation_inference_tpu_torch.ops.cuda import flash_prefill as tfp
from text_generation_inference_tpu_torch.ops.cuda import paged_attention as tpa

TOL = 1e-5


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


# --- flash prefill ----------------------------------------------------------


def prefill_inputs(n=3, t=64, kh=2, g=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, t, kh, g, d)).astype(np.float32)
    k = rng.normal(size=(n, t, kh, d)).astype(np.float32)
    v = rng.normal(size=(n, t, kh, d)).astype(np.float32)
    return q, k, v


class TestFlashPrefill:
    @pytest.mark.parametrize("lengths", [[64, 37, 1], [5, 64, 0]],
                             ids=["ragged", "zero_length"])
    def test_matches_pallas_interpret(self, lengths):
        q, k, v = prefill_inputs()
        lens = np.asarray(lengths, np.int32)
        want = jfp.flash_prefill(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lens),
                                 block_q=32, block_k=16, interpret=True)
        got = tfp.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), torch.from_numpy(lens))
        close(got, want)

    def test_padded_rows_see_all_valid_keys(self):
        q, k, v = prefill_inputs(n=1, t=32, seed=1)
        lens = np.asarray([10], np.int32)
        want = jfp.flash_prefill_reference(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), jnp.asarray(lens))
        got = tfp.flash_prefill_reference(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(lens))
        close(got, want)

    def test_cpu_wrapper_counts_no_launch(self):
        q, k, v = prefill_inputs(n=1, t=16)
        before = tfp.flash_prefill.launches
        tfp.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), torch.tensor([16], dtype=torch.int32))
        assert tfp.flash_prefill.launches == before


# --- paged decode attention -------------------------------------------------

PAGE = 8
NUM_PAGES = 12


def paged_inputs(s=4, kh=2, g=2, d=16, max_pages=4, seed=0):
    """Pools [K, P*page, D]; a block table that is not the identity (pages
    drawn without replacement across slots), the sentinel NUM_PAGES past
    each slot's live pages, and ctx covering 0, partial and full tables."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(s, kh, g, d)).astype(np.float32)
    kp = rng.normal(size=(kh, NUM_PAGES * PAGE, d)).astype(np.float32)
    vp = rng.normal(size=(kh, NUM_PAGES * PAGE, d)).astype(np.float32)
    ctx = np.asarray([0, 5, 17, max_pages * PAGE][:s], np.int32)
    perm = rng.permutation(NUM_PAGES)
    bt = np.full((s, max_pages), NUM_PAGES, np.int32)
    used = 0
    for i in range(s):
        n = -(-int(ctx[i]) // PAGE)
        bt[i, :n] = perm[used:used + n]
        used += n
    return q, kp, vp, bt, ctx


def t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def j(*arrays):
    return [jnp.asarray(a) for a in arrays]


class TestPagedDecode:
    def test_normalized_matches_pallas_interpret(self):
        q, kp, vp, bt, ctx = paged_inputs()
        want = jpa.paged_decode_attention(*j(q, kp, vp, bt, ctx), PAGE,
                                          interpret=True)
        got = tpa.paged_decode_attention(*t(q, kp, vp, bt, ctx), PAGE)
        close(got, want)

    def test_stats_matches_pallas_interpret(self):
        q, kp, vp, bt, ctx = paged_inputs(seed=1)
        want = jpa.paged_decode_attention_partial(*j(q, kp, vp, bt, ctx),
                                                  PAGE, interpret=True)
        got = tpa.paged_decode_attention_partial(*t(q, kp, vp, bt, ctx), PAGE)
        for a, b in zip(got, want):
            close(a, b)

    def test_stats_matches_jax_reference(self):
        q, kp, vp, bt, ctx = paged_inputs(seed=2)
        want = jpa.paged_decode_attention_partial_reference(
            *j(q, kp, vp, bt, ctx), PAGE)
        got = tpa.paged_decode_attention_partial_reference(
            *t(q, kp, vp, bt, ctx), PAGE)
        for a, b in zip(got, want):
            close(a, b)

    def test_zero_context_stats(self):
        q, kp, vp, bt, ctx = paged_inputs(seed=3)
        acc, m, l = tpa.paged_decode_attention_partial(*t(q, kp, vp, bt, ctx),
                                                       PAGE)
        assert np.all(np.isneginf(m[0].numpy()))
        assert np.all(l[0].numpy() == 0) and np.all(acc[0].numpy() == 0)
        out = tpa.paged_decode_attention(*t(q, kp, vp, bt, ctx), PAGE)
        assert np.all(out[0].numpy() == 0)

    def test_stacked_matches_pallas_interpret(self):
        q, kp, vp, bt, ctx = paged_inputs(seed=4)
        rng = np.random.default_rng(5)
        kps = np.stack([kp, rng.normal(size=kp.shape).astype(np.float32)])
        vps = np.stack([vp, rng.normal(size=vp.shape).astype(np.float32)])
        for li in range(2):
            want = jpa.paged_decode_attention_partial_stacked(
                *j(q, kps, vps, bt, ctx), jnp.int32(li), PAGE, interpret=True)
            got = tpa.paged_decode_attention_partial_stacked(
                *t(q, kps, vps, bt, ctx), li, PAGE)
            for a, b in zip(got, want):
                close(a, b)

    def test_sentinel_page_inside_context_is_skipped(self):
        """A sentinel entry inside ctx contributes no keys (the kernel skips
        it): the result equals attention over the mapped pages alone."""
        q, kp, vp, _, _ = paged_inputs(s=1, seed=6)
        bt = np.asarray([[3, NUM_PAGES, 7]], np.int32)
        ctx = np.asarray([3 * PAGE], np.int32)
        got = tpa.paged_decode_attention(*t(q, kp, vp, bt, ctx), PAGE)
        want = jpa.paged_decode_attention_reference(
            *j(q, kp, vp, np.asarray([[3, 7]], np.int32),
               np.asarray([2 * PAGE], np.int32)), PAGE)
        close(got, want)

    def test_table_order_is_position_order(self):
        """Shuffling which pages hold a slot's keys (with the table
        following) changes nothing."""
        q, kp, vp, bt, ctx = paged_inputs(seed=7)
        a = tpa.paged_decode_attention(*t(q, kp, vp, bt, ctx), PAGE)
        remap = np.random.default_rng(8).permutation(NUM_PAGES)
        inv = np.argsort(remap)
        kp2 = kp.reshape(2, NUM_PAGES, PAGE, -1)[:, inv].reshape(kp.shape)
        vp2 = vp.reshape(2, NUM_PAGES, PAGE, -1)[:, inv].reshape(vp.shape)
        bt2 = np.where(bt < NUM_PAGES, remap[np.minimum(bt, NUM_PAGES - 1)],
                       NUM_PAGES).astype(np.int32)
        b = tpa.paged_decode_attention(*t(q, kp2, vp2, bt2, ctx), PAGE)
        close(a, b)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
