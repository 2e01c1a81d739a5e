"""F2 on the CPU: the attention wrappers' float32 plain paths and the flash
kernel's short key tiles at head dims 192 and 256, against the JAX package.

On the card a float32 call runs the 3xTF32 bodies (flash prefill's
`flash_prefill_f32_kernel`, the split body's `split_kernel_f32`) and the
flash kernel tiles 80 keys at D 192 / 256 (tests/test_torch_cuda.py holds
them against these plain versions there). Here:

- `flash_prefill_tiled_reference` at `key_tile(d)` = 80 keys, D 192 and
  256, and at 64-key tiles, against the Pallas `flash_prefill` in
  interpret mode;
- every attention wrapper on float32 CPU tensors at head dim 192 (flash
  prefill, the paged kernel in both modes, K2's int8 pools with an fp32 q,
  S1 and S2) against the JAX Pallas kernel in interpret mode.

Both sides compute in fp32: within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_generation_inference_tpu.models.core import quantize_kv
from text_generation_inference_tpu.ops.pallas import decode_attention as jda
from text_generation_inference_tpu.ops.pallas import flash_prefill as jfp
from text_generation_inference_tpu.ops.pallas import paged_attention as jpa
from text_generation_inference_tpu.ops.pallas import ring_decode_attention as jrda
from text_generation_inference_tpu_torch.ops.cuda import decode_attention as tda
from text_generation_inference_tpu_torch.ops.cuda import flash_prefill as tfp
from text_generation_inference_tpu_torch.ops.cuda import paged_attention as tpa
from text_generation_inference_tpu_torch.ops.cuda import ring_decode_attention as trda

TOL = 1e-5


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_key_tiles_follow_the_head_dim():
    assert [tfp.key_tile(d) for d in (64, 128, 192, 256)] == [128, 128, 80, 80]
    assert set(tfp.HEAD_DIMS) >= {192, 256}
    assert torch.float32 in tfp.DTYPES and torch.float32 in tpa.DTYPES
    assert 192 in tpa.HEAD_DIMS


# lengths on and off the 64- and 80-key tile edges, a zero length, the
# whole T; the twin at the kernel's key tile and at 64 keys
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("d", [192, 256])
def test_flash_twin_64_key_tiles_matches_pallas(d, g):
    rng = np.random.default_rng(d + g)
    n, t_len, kh = 7, 160, 1
    q, k, v = (normal(rng, n, t_len, kh, g, d), normal(rng, n, t_len, kh, d),
               normal(rng, n, t_len, kh, d))
    lens = np.asarray([0, 1, 64, 65, 80, 81, t_len], np.int32)
    want = jfp.flash_prefill(*j(q, k, v, lens), interpret=True)
    for block_n in (None, 64):
        got = tfp.flash_prefill_tiled_reference(*t(q, k, v, lens),
                                                block_n=block_n)
        close(got, want)
    # the wrapper's fp32 plain path (what a CPU tensor takes)
    close(tfp.flash_prefill(*t(q, k, v, lens)), want)


D = 192
PAGE = 8


def paged_inputs(rng, s=4, kh=2, g=4, max_pages=5, num_pages=24):
    ctx = np.asarray([0, 1, 17, max_pages * PAGE][:s], np.int32)
    perm = rng.permutation(num_pages)
    bt = np.full((s, max_pages), num_pages, np.int32)
    used = 0
    for i in range(s):
        need = -(-int(ctx[i]) // PAGE)
        bt[i, :need] = perm[used:used + need]
        used += need
    return (normal(rng, s, kh, g, D), normal(rng, kh, num_pages * PAGE, D),
            normal(rng, kh, num_pages * PAGE, D), bt, ctx)


def test_paged_float32_at_d192_matches_pallas():
    q, kp, vp, bt, ctx = paged_inputs(np.random.default_rng(1))
    want = jpa.paged_decode_attention(*j(q, kp, vp, bt, ctx), PAGE,
                                      interpret=True)
    close(tpa.paged_decode_attention(*t(q, kp, vp, bt, ctx), PAGE), want)
    want = jpa.paged_decode_attention_partial(*j(q, kp, vp, bt, ctx), PAGE,
                                              interpret=True)
    got = tpa.paged_decode_attention_partial(*t(q, kp, vp, bt, ctx), PAGE)
    for a, b in zip(got, want):
        close(a, b)


def test_int8_pools_with_a_float32_q_match_pallas():
    """K2 with an fp32 q over int8 pools and their scale pools."""
    q, kp, vp, bt, ctx = paged_inputs(np.random.default_rng(2))
    kq, ks = (np.array(a) for a in quantize_kv(jnp.asarray(kp[None])))
    vq, vs = (np.array(a) for a in quantize_kv(jnp.asarray(vp[None])))
    want = jpa.paged_decode_attention_partial_stacked(
        *j(q, kq, vq, bt, ctx), jnp.int32(0), PAGE, interpret=True,
        k_scale_pools=jnp.asarray(ks), v_scale_pools=jnp.asarray(vs))
    got = tpa.paged_decode_attention_partial_i8(
        *t(q, kq[0], vq[0], ks[0], vs[0], bt, ctx), PAGE)
    for a, b in zip(got, want):
        close(a, b)


def test_slot_and_ring_float32_at_d192_match_pallas():
    rng = np.random.default_rng(3)
    s, kh, g, tt, c, step = 4, 2, 4, 256, 8, 5
    q, k, v = (normal(rng, s, kh, g, D), normal(rng, s, kh, tt, D),
               normal(rng, s, kh, tt, D))
    ctx = np.asarray([0, 1, 129, tt], np.int32)
    want = jda.decode_attention(*j(q, k, v, ctx), block_t=128, interpret=True)
    close(tda.decode_attention(*t(q, k, v, ctx)), want)
    kb, vb = normal(rng, s, kh, c, D), normal(rng, s, kh, c, D)
    kn, vn = normal(rng, s, kh, D), normal(rng, s, kh, D)
    want = jrda.ring_decode_attention(*j(q, k, v, kb, vb, kn, vn, ctx),
                                      jnp.int32(step), block_t=128,
                                      interpret=True)
    close(trda.ring_decode_attention(*t(q, k, v, kb, vb, kn, vn, ctx), step),
          want)
