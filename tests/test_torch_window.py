"""Sliding windows on the port's kernel routes and in the kernels' plain
versions, against the JAX package (fp32, CPU).

* A windowed model at head dim 64 (the families' fixtures have 16, which
  no kernel route takes) at a bucket of 128 and max_seq 2048: flash
  prefill's and S1's routes (their plain versions on CPU tensors) take the
  window, and the logits equal the JAX package's.
* The flash plain versions (`flash_prefill_reference`, the tiled twin of the
  wgmma kernel's schedule and the 3xTF32 twin of the fp32 kernel) with
  `window` against the JAX einsum prefill with the JAX model's window mask,
  at head dims 64 / 128 / 256, windows shorter and longer than the bucket.
* S1's plain version and its split twin with the lower bound ctx - W
  against the JAX einsum decode under the window mask, at head dims 64 and
  96 (the split body's new head dim, gpt-neox-20b's).

The kernels themselves against these plain versions: tests/test_torch_cuda.py
(on the card).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_generation_inference_tpu.models import core as jcore
from text_generation_inference_tpu.ops import attention as jattention
from text_generation_inference_tpu_torch.models import core
from text_generation_inference_tpu_torch.models.convert import params_from_jax
from text_generation_inference_tpu_torch.ops.cuda import decode_attention as da
from text_generation_inference_tpu_torch.ops.cuda import flash_prefill as fp

LOGIT_TOL = 1e-4


def np_(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def close(got, want, tol, what=""):
    np.testing.assert_allclose(np_(got), np_(want), rtol=tol, atol=tol,
                               err_msg=what)


def t_(a):
    return torch.from_numpy(np.array(a, copy=True))


WINDOWED = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4,
                num_kv_heads=2, head_dim=64, intermediate_size=192,
                sliding_window=24)


def test_windowed_model_takes_the_kernel_routes(monkeypatch):
    """A mistral-like 2-layer model at head dim 64 (window 24, weights from
    the JAX package's `init_params`): `core.prefill` at a bucket of 128
    routes every layer to flash prefill with the window, and scan-mode
    decode at max_seq 2048 to S1 with the lower bound ctx - 24 (their plain
    versions on CPU tensors); logits equal the JAX package's."""
    jspec = jcore.DecoderSpec(**WINDOWED)
    jparams = jcore.init_params(jspec, jax.random.key(5), jnp.float32)
    spec = core.DecoderSpec(**WINDOWED)
    params = params_from_jax(spec, jax.tree_util.tree_map(np.asarray,
                                                          jparams),
                             device="cpu")
    windows, bounds = [], []
    flash, slot = fp.flash_prefill, da.decode_attention
    monkeypatch.setattr(fp, "flash_prefill", lambda *a, window=0, **kw: (
        windows.append(window), flash(*a, window=window, **kw))[1])
    monkeypatch.setattr(da, "decode_attention",
                        lambda q, k, v, ctx, lo=None, **kw: (
                            bounds.append(lo), slot(q, k, v, ctx, lo, **kw))[1])
    rng = np.random.default_rng(9)
    ids = rng.integers(3, 250, size=(2, 128)).astype(np.int32)
    lengths = np.asarray([100, 37], np.int32)
    slots = np.asarray([0, 1], np.int32)
    t_max = 2048
    jc = jcore.KVCache.create(jspec, 2, t_max, jnp.float32)
    tc = core.KVCache.create(spec, 2, t_max, torch.float32, "cpu")
    jl, jc = jcore.prefill(jspec, jparams, jnp.asarray(ids),
                           jnp.asarray(lengths), jnp.asarray(slots), jc)
    tl, tc = core.prefill(spec, params, t_(ids), t_(lengths), t_(slots), tc)
    for r, ln in enumerate(lengths):
        close(tl[r, :ln], np.asarray(jl)[r, :ln], LOGIT_TOL, "prefill")
    assert windows == [24] * spec.num_layers
    pos = lengths.copy()
    step_ids = np.asarray([5, 6], np.int32)
    for i in range(3):
        jl, jc = jcore.decode(jspec, jparams, jnp.asarray(step_ids),
                              jnp.asarray(pos), jc, jnp.asarray(pos + 1),
                              write_mode="scan")
        tl, tc = core.decode(spec, params, t_(step_ids), t_(pos), tc,
                             t_(pos + 1), write_mode="scan")
        close(tl, jl, LOGIT_TOL, f"scan step {i}")
        step_ids = np.asarray(jnp.argmax(jl, -1), np.int32)
        pos = pos + 1
    assert len(bounds) == 3 * spec.num_layers
    np.testing.assert_array_equal(bounds[-1].numpy(), pos - 24)


def jax_prefill_einsum(q, k, v, lengths, window):
    """The JAX package's einsum prefill (`ops/attention.py` on the CPU) with
    the JAX model's window mask (`models/core.py` prefill)."""
    n, t = q.shape[:2]
    positions = jnp.broadcast_to(jnp.arange(t), (n, t))
    causal = jnp.tril(jnp.ones((t, t), jnp.bool_))
    key_valid = positions < jnp.asarray(lengths)[:, None]
    mask = causal[None] & key_valid[:, None, :]
    if window:
        qi = jnp.arange(t)
        in_window = (qi[:, None] - qi[None, :]) < window
        mask = mask & (in_window[None] | ~key_valid[:, :, None])
    return np.asarray(jattention.prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths), None, mask, 1.0 / math.sqrt(q.shape[-1])))


@pytest.mark.parametrize("d,kh,g", [(64, 2, 4), (128, 1, 2), (256, 2, 1)])
@pytest.mark.parametrize("window", [5, 40, 300])
def test_flash_plain_versions_take_the_window(d, kh, g, window):
    """The three flash plain versions with `window` against the JAX einsum
    prefill with its window mask (1e-5; the padded rows, past the length,
    are compared too: they keep the causal mask) and the tiled twin at
    64-row tiles (both halves' window floors differ), over a bucket of 160:
    windows of 5 and 40 cut inside it, 300 is past it."""
    rng = np.random.default_rng(d + window)
    n, t = 2, 160
    lengths = np.asarray([150, 61], np.int32)
    q = rng.normal(size=(n, t, kh, g, d)).astype(np.float32)
    k = rng.normal(size=(n, t, kh, d)).astype(np.float32)
    v = rng.normal(size=(n, t, kh, d)).astype(np.float32)
    want = jax_prefill_einsum(q, k, v, lengths, window)
    args = (t_(q), t_(k), t_(v), t_(lengths))
    close(fp.flash_prefill_reference(*args, window), want, 1e-5, "reference")
    close(fp.flash_prefill(*args, window=window), want, 1e-5, "wrapper")
    close(fp.flash_prefill_tf32x3_reference(*args, window), want, 1e-5,
          "3xTF32 twin")
    close(fp.flash_prefill_tiled_reference(*args, window=window), want,
          1e-5, "tiled twin")
    close(fp.flash_prefill_tiled_reference(*args, block_m=64, block_n=32,
                                           window=window), want, 1e-5,
          "tiled twin, small tiles")


def test_flash_window_past_the_bucket_changes_nothing():
    rng = np.random.default_rng(1)
    q = t_(rng.normal(size=(1, 130, 2, 2, 64)).astype(np.float32))
    k = t_(rng.normal(size=(1, 130, 2, 64)).astype(np.float32))
    v = t_(rng.normal(size=(1, 130, 2, 64)).astype(np.float32))
    lengths = torch.tensor([129], dtype=torch.int32)
    close(fp.flash_prefill_tiled_reference(q, k, v, lengths, window=130),
          fp.flash_prefill_tiled_reference(q, k, v, lengths), 0)


def jax_decode_einsum(q, k, v, ctx, window):
    """The JAX package's einsum decode (`ops/attention.py`) with the JAX
    model's scan-mode mask (`models/core.py` decode)."""
    t = k.shape[2]
    key_pos = jnp.arange(t)
    ctx = jnp.asarray(ctx)
    mask = key_pos[None, :] < ctx[:, None]
    if window:
        mask = mask & (key_pos[None, :] >= ctx[:, None] - window)
    return np.asarray(jattention.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), ctx, None, mask,
        1.0 / math.sqrt(q.shape[-1])))


@pytest.mark.parametrize("d", [64, 96])
@pytest.mark.parametrize("window", [7, 300, 1000])
def test_slot_plain_versions_take_the_lower_bound(d, window):
    """S1's plain version and its split twin (256-row splits, and 64-row
    ones so that the bound falls inside a split) with lo = ctx - W against
    the JAX einsum decode under the window mask: contexts at split edges,
    one past the window, one within it (the bound clamps at 0)."""
    rng = np.random.default_rng(d + window)
    s, kh, g, t = 6, 2, 4, 768
    ctx = np.asarray([1, 255, 256, 257, 700, 768], np.int32)
    q = rng.normal(size=(s, kh, g, d)).astype(np.float32)
    k = rng.normal(size=(s, kh, t, d)).astype(np.float32)
    v = rng.normal(size=(s, kh, t, d)).astype(np.float32)
    want = jax_decode_einsum(q, k, v, ctx, window)
    lo = t_(np.maximum(ctx - window, 0).astype(np.int32))
    args = (t_(q), t_(k), t_(v), t_(ctx))
    close(da.decode_attention_reference(*args, lo), want, 1e-5, "reference")
    close(da.decode_attention(*args, lo), want, 1e-5, "wrapper")
    close(da.decode_attention_split_reference(*args, lo=lo), want, 1e-5,
          "split twin")
    close(da.decode_attention_split_reference(*args, rows_per_split=64,
                                              lo=lo), want, 1e-5,
          "split twin, 64-row splits")
