"""K1's group-dot order and split plan, and F3 (the int4 wrappers take
bf16, fp16 and fp32 x), on the CPU against the JAX package.

- `int4_matmul_group_dot_reference` is the plain twin of the redesigned
  kernel's arithmetic: per group, x's tensor-core operand terms (bf16 or
  fp16 x as they are; fp32 x as hi = bf16(x) plus lo = bf16(x - hi))
  times the exact integers q - zero - 1, in f32, scaled by the group's
  scales. It is held against the JAX packed kernel in interpret mode
  (f32 compute) and against `matmul_dequant` in f32, on the same seeded
  x rounded to each dtype. Tolerance: for bf16 and fp16 x both sides see
  the same x exactly, so they differ by the f32 summation order and the
  twin's rounding of y to x's dtype: one ulp of that dtype (2^-7 relative
  in bf16, 2^-10 in fp16) plus 1e-5. For fp32 x the hi + lo split leaves
  at most 2^-17 of each |x_k| out, so the bound is 2^-16 of sum |x| |W|
  plus 1e-5.
- `split_plan(N, K)` and `split_tiles`: every K tile once, at most one
  split a tile, at most MAX_SPLITS, from (N, K) alone.
- The K1 names and M1 return x's dtype for each of the three dtypes on
  CPU tensors (the plain versions).
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_generation_inference_tpu.ops.pallas import int4_matmul as jim
from text_generation_inference_tpu.ops.quant import int4 as jint4
from text_generation_inference_tpu_torch.ops.cuda import int4_matmul as tim
from text_generation_inference_tpu_torch.ops.cuda import int4_mlp as tmlp
from text_generation_inference_tpu_torch.ops.quant import int4

DTYPES = [torch.bfloat16, torch.float16, torch.float32]
ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


def both(rng, in_f, out_f, gs):
    """One random GPTQ weight (random zero points) in both packages."""
    qweight = int4.pack_rows(torch.from_numpy(
        rng.integers(0, 16, (in_f, out_f)).astype(np.int32))).numpy()
    qzeros = int4.pack_cols(torch.from_numpy(
        rng.integers(0, 16, (in_f // gs, out_f)).astype(np.int32))).numpy()
    scales = rng.uniform(0.005, 0.02, (in_f // gs, out_f)).astype(np.float32)
    g_idx = (np.arange(in_f) // gs).astype(np.int32)
    jw = jint4.normalize_act_order(qweight, qzeros, scales, g_idx)
    tw = int4.normalize_act_order(*(torch.from_numpy(a) for a in
                                    (qweight, qzeros, scales, g_idx)))
    return jw, tw


def assert_within(got, want, tol, what):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(diff <= tol), (what, float(diff.max()))


# the `mini` widths (hidden 256, intermediate 512, fused gate/up 1024) at
# 2 to 4 groups: K = 256 in 2 groups of 128, 512 in 4, 256 in 4 of 64
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("in_f,out_f,gs", [(256, 256, 128), (512, 256, 128),
                                           (256, 1024, 64)])
def test_group_dot_twin_matches_jax(in_f, out_f, gs, dtype):
    rng = np.random.default_rng(in_f + out_f + gs)
    jw, tw = both(rng, in_f, out_f, gs)
    xt = torch.from_numpy(rng.normal(size=(16, in_f)).astype(np.float32)
                          ).to(dtype)
    x = xt.to(torch.float32).numpy()          # the same values in f32
    packed = np.asarray(jim.int4_matmul(jnp.asarray(x), jw, interpret=True))
    dequant = np.asarray(jint4.matmul_dequant(jnp.asarray(x), jw))
    got = tim.int4_matmul_group_dot_reference(xt, tw)
    assert got.dtype == dtype and got.shape == (16, out_f)
    if dtype == torch.float32:
        w_abs = np.abs(np.asarray(jint4.dequantize(jw, jnp.float32)))
        tol = 2.0 ** -16 * (np.abs(x) @ w_abs) + 1e-5
    else:
        tol = ULP[dtype] * np.abs(packed) + 1e-5
    for want, what in ((packed, "int4_matmul interpret"),
                       (dequant, "matmul_dequant")):
        assert_within(got.float().numpy(), want, tol, what)


def test_group_dot_twin_agrees_with_the_plain_version():
    """In fp32 the twin (integers, then scales) and the plain version
    (dequantized weights, one matmul) compute the same product."""
    rng = np.random.default_rng(3)
    _, tw = both(rng, 512, 384, 128)
    x = torch.from_numpy(rng.normal(size=(5, 512)).astype(np.float32))
    hi = x.to(torch.bfloat16).to(torch.float32)
    for xx in (hi, x):
        a = tim.int4_matmul_group_dot_reference(xx, tw)
        b = tim.int4_matmul_reference(xx, tw)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_operand_terms_split_fp32_exactly_enough():
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(64,)).astype(
        np.float32)) * 1000
    hi, lo = tim.operand_terms(x)
    assert torch.equal(hi, x.to(torch.bfloat16).float())
    assert torch.equal(lo, lo.to(torch.bfloat16).float())
    assert float(((hi + lo) - x).abs().max()) <= 2.0 ** -16 * float(
        x.abs().max())
    (only,) = tim.operand_terms(x.to(torch.float16))
    assert only.dtype == torch.float32


@pytest.mark.parametrize("n,k", [(4096, 4096), (12288, 4096), (22016, 4096),
                                 (4096, 11008), (256, 256), (64, 64),
                                 (1536, 128), (100000, 8192)])
def test_split_plan_covers_every_tile_once(n, k):
    splits = tim.split_plan(n, k)
    tiles = k // tim.K_TILE
    ranges = tim.split_tiles(n, k)
    assert len(ranges) == splits
    assert 1 <= splits <= min(tim.MAX_SPLITS, tiles)
    assert ranges[0][0] == 0 and ranges[-1][1] == tiles
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    assert all(t1 > t0 for t0, t1 in ranges)
    blocks = -(-n // tim.BLOCK_N)
    if blocks >= tim.BLOCKS_PER_SM * tim.SMS:
        assert splits == 1


def test_split_plan_ignores_the_number_of_rows():
    """The plan is a function of (N, K) alone: no row count reaches it,
    so a row's fp32 summation order is the same at any batch size."""
    assert list(inspect.signature(tim.split_plan).parameters) == ["n", "k"]
    src = inspect.getsource(tim._launch)
    assert "split_plan(n, k)" in src


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_k1_names_return_x_dtype(dtype):
    rng = np.random.default_rng(5)
    _, tw = both(rng, 256, 512, 128)
    x = torch.from_numpy(rng.normal(size=(3, 256)).astype(np.float32)
                         ).to(dtype)
    stacked = int4.Int4Weight(*(None if f is None else f[None] for f in tw))
    want = tim.int4_matmul_reference(x, tw)
    for got in (tim.int4_matmul(x, tw), tim.int4_matmul_s4(x, tw),
                tim.int4_matmul_s4_stacked(x, stacked, 0)):
        assert got.dtype == dtype and got.shape == (3, 512)
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_m1_returns_x_dtype(dtype):
    rng = np.random.default_rng(6)
    _, gu = both(rng, 256, 768, 128)
    _, down = both(rng, 384, 256, 128)
    stack = lambda w: int4.Int4Weight(*(None if f is None else f[None]
                                        for f in w))
    x = torch.from_numpy(rng.normal(size=(4, 256)).astype(np.float32)
                         ).to(dtype)
    got = tmlp.int4_mlp_s4_stacked(x, stack(gu), stack(down), 0)
    assert got.dtype == dtype and got.shape == (4, 256)
    assert torch.equal(got, tmlp.int4_mlp_reference(x, gu, down))
