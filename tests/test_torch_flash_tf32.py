"""The fp32 flash prefill kernel's arithmetic (3xTF32 on the tensor cores) on
the CPU, against the JAX package.

On the card a float32 `flash_prefill` runs `flash_prefill_f32_kernel`:
mma.sync in .tf32 with every operand split into two TF32 terms, hi =
rna(x) and lo = rna(x - hi), each product lo.hi + hi.lo + hi.hi with fp32
sums, over key tiles of `f32_key_tile(d)` keys (tests/test_torch_cuda.py
holds it against the plain version there). Here:

- `tf32_round` is round to nearest, ties away from zero, at 10 mantissa
  bits (what `cvt.rna.tf32.f32` does);
- `flash_prefill_tf32x3_reference`, the plain twin of that arithmetic, is
  held against the Pallas `flash_prefill` in interpret mode (f32) at head
  dims 64 / 128 / 192 / 256 and groups 1 / 4 / 8, with a padded tail, a
  zero length and a length on a key-tile edge. Tolerance 1e-5 absolute and
  relative: the split leaves about 2^-22 of each product out and both
  sides sum in fp32 (observed ~2e-6); the card is held to 1e-4;
- NaN in K and V past the lengths is never read into the output;
- one TF32 pass alone (hi.hi) misses 1e-4 on the same inputs, which is why
  the kernel takes three.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_generation_inference_tpu.ops.pallas import flash_prefill as jfp
from text_generation_inference_tpu_torch.ops.cuda import flash_prefill as tfp

TOL = 1e-5


def normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def case(d, g, seed, n=3, t=160, kh=2):
    rng = np.random.default_rng(seed)
    q, k, v = (normal(rng, n, t, kh, g, d), normal(rng, n, t, kh, d),
               normal(rng, n, t, kh, d))
    # a padded tail, a zero length, a length on a key-tile edge
    lens = np.asarray([t - 23, 0, tfp.f32_key_tile(d)], np.int32)[:n]
    return q, k, v, lens


def test_tf32_round_is_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one + 2 ** -11, -(one + 2 ** -11), one + 2 ** -12,
                      one + 3 * 2 ** -12, 3.0, 0.0, -0.0],
                     dtype=torch.float32)
    want = [one + 2 ** -10, -(one + 2 ** -10), one, one + 2 ** -10, 3.0,
            0.0, 0.0]
    assert tfp.tf32_round(x).tolist() == want
    # 10 mantissa bits: the low 13 bits of every result are zero
    y = torch.from_numpy(normal(np.random.default_rng(0), 1000))
    assert not bool((tfp.tf32_round(y).view(torch.int32) & 0x1FFF).any())
    assert float((tfp.tf32_round(y) - y).abs().max()) <= 2.0 ** -11 * float(
        y.abs().max())


def test_f32_key_tiles_follow_the_head_dim():
    assert [tfp.f32_key_tile(d) for d in tfp.HEAD_DIMS] == [64, 64, 32, 32]


@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_tf32x3_twin_matches_pallas(d, g):
    q, k, v, lens = case(d, g, seed=10 * d + g)
    want = np.asarray(jfp.flash_prefill(
        *(jnp.asarray(a) for a in (q, k, v, lens)), interpret=True))
    got = tfp.flash_prefill_tf32x3_reference(
        *(torch.from_numpy(a) for a in (q, k, v, lens)))
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert np.all(got.numpy()[1] == 0)            # lengths[1] == 0


def test_tf32x3_twin_never_reads_the_padding():
    q, k, v, lens = case(128, 4, seed=3)
    args = [torch.from_numpy(a) for a in (q, k, v, lens)]
    want = tfp.flash_prefill_tf32x3_reference(*args)
    for x in args[1:3]:
        x[0, int(lens[0]):] = float("nan")
        x[2, int(lens[2]):] = float("nan")
    got = tfp.flash_prefill_tf32x3_reference(*args)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_one_tf32_pass_is_not_enough():
    """hi.hi alone (one TF32 product) against the f32 plain version misses
    the 1e-4 tolerance the fp32 kernel is held to; the three-product split
    meets it with room to spare."""
    q, k, v, lens = (torch.from_numpy(a) for a in case(64, 8, seed=5))
    want = tfp.flash_prefill_reference(q, k, v, lens)
    r = tfp.tf32_round
    d = q.shape[-1]
    s = torch.einsum("nqkgd,nvkd->nkgqv", r(q), r(k)) / math.sqrt(d)
    t = q.shape[1]
    pos = torch.arange(t)
    mask = ((pos[None, :] <= pos[:, None])[None]
            & (pos[None, :] < lens[:, None])[:, None, :])
    s = s.masked_fill(~mask[:, None, None], -math.inf)
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    one_pass = torch.einsum("nkgqv,nvkd->nqkgd", r(p), r(v))
    assert float((one_pass - want).abs().max()) > 1e-4
    twin = tfp.flash_prefill_tf32x3_reference(q, k, v, lens)
    assert float((twin - want).abs().max()) < TOL
