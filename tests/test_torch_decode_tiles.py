"""The split body's tile plan and S2's schedule, on the CPU.

* `ops/cuda/paged_attention.py::tile_plan`: for every head dim the fp32
  body takes (16 to 256 in steps of 16) and every group up to 16 (and past
  it), over fp32 rows and over int8 rows under an fp32 q, the ring of tiles
  fits a block's 227 KB of shared memory, holds the warp merge, and its
  tiles divide the split plans (256 keys of a paged split, 256 rows of a
  slot-cache split); bf16 / fp16 keep the mma body's fixed ring.
* `ops/cuda/ring_decode_attention.py::ring_decode_split_reference`, the
  plain twin of S2's one-launch schedule (the cache's splits, then the
  ring's columns as splits of their own, then the current token, merged in
  that order), against the JAX package's Pallas `ring_decode_attention`
  run in interpret mode as tests/test_pallas_kernels.py runs it: bf16 and
  fp32, ring steps 0, 1 and C (the whole ring), a ctx == 0 slot, with the
  kernel's split plan and with splits of 5 rows (several ring splits).

Tolerances: 1e-5 in fp32 (the same fp32 sums in another order), 2e-2 in
bf16 (both round the output to bf16 once).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_generation_inference_tpu.ops.pallas import ring_decode_attention as jrda
from text_generation_inference_tpu_torch.ops.cuda import decode_attention as da
from text_generation_inference_tpu_torch.ops.cuda import paged_attention as pa
from text_generation_inference_tpu_torch.ops.cuda import ring_decode_attention as rda

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("d", range(16, 257, 16))
def test_tile_plan_fits_and_divides_the_splits(d):
    rows = da.split_plan(4096)[0]
    for int8 in (False, True):
        for g in list(range(1, 17)) + [20, 48]:
            tile, stages = pa.tile_plan(d, g, torch.float32, int8)
            assert tile in (32, 64) and stages in (2, 3)
            assert not int8 or tile == 64      # the int8 instances
            assert pa.SPLIT_KEYS % tile == 0 and rows % tile == 0
            smem = pa.f32_smem(d, g, tile, stages, int8)
            assert smem <= pa.SMEM_BLOCK - pa.SMEM_STATIC
            # the ring holds its stages (int8: and scales) and the 4 warps'
            # merge (16 rows of d floats); q_s one row a query head
            stage_bytes = tile * ((2 * d + 32) if int8 else (8 * d + 48))
            ring = smem - min(g, 16) * (2 * d + 16) * 4
            assert ring >= stages * (stage_bytes + (2 * tile * 4 if int8
                                                    else 0))
            assert ring >= 4 * 16 * d * 4
            # two stages of 64 keys where two blocks fit an SM, else of 32
            two = pa.SMEM_SM // 2 - 1024 - pa.SMEM_STATIC
            if pa.f32_smem(d, g, 64, 2, int8) <= two:
                assert (tile, stages) == (64, 2), (d, g, int8)
            elif not int8 and pa.f32_smem(d, g, 32, 2) <= two:
                assert (tile, stages) == (32, 2), (d, g)
            else:
                assert smem > two
        for dtype in (torch.bfloat16, torch.float16):
            assert pa.tile_plan(d, 8, dtype, int8) == (pa.MMA_TILE,
                                                       pa.MMA_STAGES)


def test_tile_plan_takes_two_blocks_where_they_fit():
    """TinyLlama's decode widths (D 64, G 8) and Llama-2-7B's (D 128, G 1)
    fit two blocks an SM; D 256 at G 16 takes one."""
    two = pa.SMEM_SM // 2 - 1024 - pa.SMEM_STATIC
    for d, g in ((64, 8), (128, 1), (80, 1), (96, 4)):
        plan = pa.tile_plan(d, g, torch.float32)
        assert pa.f32_smem(d, g, *plan) <= two, (d, g, plan)
    assert pa.tile_plan(64, 8, torch.float32) == (64, 2)
    assert pa.tile_plan(128, 1, torch.float32) == (32, 2)
    assert pa.f32_smem(256, 16, *pa.tile_plan(256, 16, torch.float32)) > two


def ring_inputs(rng, s, kh, g, d, t, c, ctx):
    return (rng.normal(size=(s, kh, g, d)), rng.normal(size=(s, kh, t, d)),
            rng.normal(size=(s, kh, t, d)), rng.normal(size=(s, kh, c, d)),
            rng.normal(size=(s, kh, c, d)), rng.normal(size=(s, kh, d)),
            rng.normal(size=(s, kh, d)), np.asarray(ctx, np.int32))


# (s, kh, g, d, t, c, ctx): a ctx == 0 slot, split edges, a full cache
S2_CASES = {
    "g8_d64": (5, 2, 8, 64, 512, 12, [0, 1, 256, 257, 512]),
    "g1_d128": (3, 2, 1, 128, 300, 16, [200, 0, 300]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("where", ["first", "second", "last"])
@pytest.mark.parametrize("case", sorted(S2_CASES))
def test_ring_split_twin_matches_pallas(case, where, dtype):
    s, kh, g, d, t, c, ctx = S2_CASES[case]
    step = {"first": 0, "second": 1, "last": c}[where]
    args = ring_inputs(np.random.default_rng(c + d + step), s, kh, g, d, t,
                       c, ctx)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jrda.ring_decode_attention(
        *(jnp.asarray(np.asarray(a, np.float32), jdt) for a in args[:7]),
        jnp.asarray(args[7]), jnp.int32(step), block_t=128, interpret=True),
        np.float32)
    tdt = getattr(torch, dtype)
    targs = [torch.from_numpy(np.asarray(a, np.float32)).to(tdt)
             for a in args[:7]]
    ctx_t = torch.from_numpy(args[7])
    for rows in (None, 5):
        got = rda.ring_decode_split_reference(*targs, ctx_t, step,
                                              rows_per_split=rows)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=TOL[dtype], atol=TOL[dtype])
    if step == 0:
        # slot with ctx == 0 at step 0: the current token's v alone
        zero = int(np.flatnonzero(args[7] == 0)[0])
        np.testing.assert_allclose(
            got[zero].float().numpy(),
            np.broadcast_to(targs[6][zero].float().numpy()[:, None],
                            (kh, g, d)), rtol=TOL[dtype], atol=TOL[dtype])
