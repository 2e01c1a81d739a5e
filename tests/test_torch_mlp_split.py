"""The fused GPTQ-INT4 MLP kernel's order (M1 on K1's decode schedule) on
the CPU, against the JAX package.

On the card M1 runs both products on K1's decode schedule: the weights as
the exact integers q - zero - 1 (zero points from `qzeros`, never zbias),
each group's product scaled in fp32, K split over blocks by
`split_plan(2I, H)` for gate/up and `split_plan(H, I)` for down (from the
shapes alone, never the row count) and the splits added in split order,
the activation in fp32 and `a` rounded to x's dtype between the products
(tests/test_torch_cuda.py holds it against the plain version there).
`int4_mlp_split_reference` is the plain twin of that order. Here it is held:

- against the JAX Pallas kernel `int4_mlp_s4_stacked` in interpret mode
  (f32 compute) for silu, 3 layers, S 1 / 5 / 17 / 64, within 2e-4
  absolute and relative (the JAX suite's own tolerance, tests/test_int4.py;
  the twin's fp32 x enters as bf16 hi + lo terms, which leaves about 2^-17
  of each |x| out);
- against the JAX model's unfused math for `gelu_glu` (`core._activate`,
  the erf GELU; the JAX kernel's tanh form is the recorded reference fault)
  within 2e-4;
- against the plain version in bf16 and fp16 x: `a` and y are rounded to
  x's dtype on both sides, so they differ by at most two ulps of that dtype
  (one from `a`, one from y) relative to the largest output;
- at widths where both split plans are above 1, so the split order is
  exercised (a 7B layer's plans are 4 and 16).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_generation_inference_tpu.models import core as jcore
from text_generation_inference_tpu.ops.pallas import int4_matmul as jim
from text_generation_inference_tpu.ops.quant import int4 as jint4
from text_generation_inference_tpu_torch.models.convert import int4_from_jax
from text_generation_inference_tpu_torch.ops.cuda import int4_matmul as tim
from text_generation_inference_tpu_torch.ops.cuda import int4_mlp as mlp

TOL = 2e-4
LAYERS, H, INTER, GS = 3, 256, 384, 128
ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


def pack_rows(q):
    """[L, in, out] nibbles -> [L, in/8, out] int32 (eight rows a word)."""
    q = q.astype(np.uint32).reshape(q.shape[0], -1, 8, q.shape[2])
    words = sum(q[:, :, k] << np.uint32(4 * k) for k in range(8))
    return words.astype(np.uint32).view(np.int32)


def pack_cols(z):
    """[L, groups, out] nibbles -> [L, groups, out/8] int32."""
    z = z.astype(np.uint32).reshape(z.shape[0], z.shape[1], -1, 8)
    words = sum(z[..., k] << np.uint32(4 * k) for k in range(8))
    return words.astype(np.uint32).view(np.int32)


def gptq_stack(rng, in_f, out_f, gs=GS, layers=LAYERS):
    """A layer-stacked JAX Int4Weight (numpy leaves, zbias set), random zero
    points, x @ W of O(1) for x ~ N(0, 1)."""
    q = rng.integers(0, 16, (layers, in_f, out_f))
    stored = rng.integers(6, 9, (layers, in_f // gs, out_f))   # zero - 1
    scales = (rng.uniform(0.5, 1.5, (layers, in_f // gs, out_f))
              * (0.6 / np.sqrt(in_f) / 4.6)).astype(np.float32)
    g_idx = np.tile((np.arange(in_f) // gs).astype(np.int32), (layers, 1))
    return jint4.Int4Weight(
        qweight=pack_rows(q), qzeros=pack_cols(stored), scales=scales,
        g_idx=g_idx, zbias=((stored + 1) * scales).astype(np.float32))


def to_jax(w):
    return w._replace(**{f: jnp.asarray(getattr(w, f))
                         for f in ("qweight", "qzeros", "scales", "g_idx",
                                   "zbias")})


def layer_of(w, li):
    return w._replace(**{f: getattr(w, f)[li]
                         for f in ("qweight", "qzeros", "scales", "g_idx",
                                   "zbias")})


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(80)
    return gptq_stack(rng, H, 2 * INTER), gptq_stack(rng, INTER, H)


def port(pair):
    return tuple(int4_from_jax(w, "cpu") for w in pair)


def test_the_split_plans_are_above_one_here_and_at_7b():
    assert tim.split_plan(2 * INTER, H) > 1 and tim.split_plan(H, INTER) > 1
    assert (tim.split_plan(2 * 11008, 4096), tim.split_plan(4096, 11008)) \
        == (4, 16)


@pytest.mark.parametrize("s", [1, 5, 17, 64])
def test_twin_matches_jax_kernel_silu(pair, s):
    gu, down = pair
    w_gu, w_down = port(pair)
    jgu, jdown = jint4.populate_q4(to_jax(gu)), jint4.populate_q4(to_jax(down))
    s_pad = max(8, -(-s // 8) * 8)
    bi = jim.mlp_block_i(INTER, H, GS, s_pad)
    d_sc, d_zb = jim.prep_stacked_scales(jdown.scales, jdown.zbias, INTER, bi,
                                         GS, compute_dtype=jnp.float32)
    x = np.random.default_rng(s).normal(size=(s, H)).astype(np.float32)
    for li in range(LAYERS):
        want = np.asarray(jim.int4_mlp_s4_stacked(
            jnp.asarray(x), jgu.q4, jgu.scales, jgu.zbias, jdown.q4, d_sc,
            d_zb, jnp.asarray([li], jnp.int32), inter=INTER,
            groupsize_down=GS, activation="silu_glu",
            compute_dtype=jnp.float32, interpret=True))
        got = mlp.int4_mlp_split_reference(
            torch.from_numpy(x), w_gu.layer(li), w_down.layer(li), "silu_glu")
        assert got.dtype == torch.float32 and got.shape == (s, H)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_twin_gelu_glu_matches_jax_model_math(pair):
    gu, down = pair
    w_gu, w_down = port(pair)
    jgu, jdown = to_jax(gu), to_jax(down)
    spec = type("Spec", (), {"activation": "gelu_glu"})()
    x = np.random.default_rng(9).normal(size=(5, H)).astype(np.float32)
    for li in (0, LAYERS - 1):
        g_u = jint4.matmul_dequant(jnp.asarray(x), layer_of(jgu, li))
        a = jcore._activate(spec, g_u[:, INTER:], g_u[:, :INTER])
        want = np.asarray(jint4.matmul_dequant(a, layer_of(jdown, li)))
        got = mlp.int4_mlp_split_reference(
            torch.from_numpy(x), w_gu.layer(li), w_down.layer(li), "gelu_glu")
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_twin_in_half_dtypes_matches_the_plain_version(pair, dtype):
    w_gu, w_down = port(pair)
    x = torch.from_numpy(np.random.default_rng(11).normal(
        size=(16, H)).astype(np.float32)).to(dtype)
    for activation in ("silu_glu", "gelu_glu"):
        got = mlp.int4_mlp_split_reference(x, w_gu.layer(1), w_down.layer(1),
                                           activation)
        want = mlp.int4_mlp_reference(x, w_gu.layer(1), w_down.layer(1),
                                      activation)
        assert got.dtype == dtype
        bound = 2 * ULP[dtype] * max(1.0, float(want.float().abs().max()))
        assert float((got.float() - want.float()).abs().max()) <= bound


def test_twin_reads_qzeros_not_zbias(pair):
    """The twin (like the kernel) takes the zero points from qzeros: a
    zbias that disagrees with them changes the plain version, not the
    twin."""
    w_gu, w_down = port(pair)
    x = torch.from_numpy(np.random.default_rng(12).normal(
        size=(3, H)).astype(np.float32))
    want = mlp.int4_mlp_split_reference(x, w_gu.layer(0), w_down.layer(0))
    off = w_gu._replace(zbias=w_gu.zbias + 1.0)
    assert torch.equal(mlp.int4_mlp_split_reference(
        x, off.layer(0), w_down.layer(0)), want)
    assert not torch.equal(mlp.int4_mlp_reference(
        x, off.layer(0), w_down.layer(0)), mlp.int4_mlp_reference(
        x, w_gu.layer(0), w_down.layer(0)))
