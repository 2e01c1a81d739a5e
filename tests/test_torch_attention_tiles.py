"""The schedules of the port's two redesigned attention kernels, as plain
PyTorch twins, against the JAX package's Pallas kernels (interpret mode on
the CPU, as tests/test_torch_kernels.py runs them).

- Paged decode: `paged_decode_split_reference` computes (acc, m, l) for
  every split of a fixed number of pages and merges them in split order,
  as `csrc/paged_attention.cu`'s kernel does in one launch, over float
  pools and over int8 pools with their scale pools (K2's schedule).
- Flash prefill: `flash_prefill_tiled_reference` walks the kernel's row
  tiles (`row_tile(G)`: tokens x a sub-group of the query heads, in
  warpgroups of 64 rows) and 128-key tiles, masking only the tiles that
  cross a warpgroup's diagonal or the length, as `csrc/flash_prefill.cu`.

Inputs are seeded numpy arrays; both packages compute in fp32 and must
agree within 1e-5. tests/test_torch_cuda.py holds the kernels themselves
against the plain versions on a card.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_generation_inference_tpu.models.core import quantize_kv
from text_generation_inference_tpu.ops.pallas import flash_prefill as jfp
from text_generation_inference_tpu.ops.pallas import paged_attention as jpa
from text_generation_inference_tpu_torch.ops.cuda import flash_prefill as tfp
from text_generation_inference_tpu_torch.ops.cuda import paged_attention as tpa

TOL = 1e-5


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


# --- paged decode: splits of whole pages, merged in split order -------------

PAGE = 8
NUM_PAGES = 40


def paged_case(ctx, max_pages=7, kh=2, g=4, d=16, seed=0, sentinel=None):
    """Pools [K, P*page, D]; each slot's pages drawn without replacement,
    the sentinel NUM_PAGES past its live pages; `sentinel` = (slot, page
    index) puts one inside the context."""
    rng = np.random.default_rng(seed)
    s = len(ctx)
    q = rng.normal(size=(s, kh, g, d)).astype(np.float32)
    kp = rng.normal(size=(kh, NUM_PAGES * PAGE, d)).astype(np.float32)
    vp = rng.normal(size=(kh, NUM_PAGES * PAGE, d)).astype(np.float32)
    ctx = np.asarray(ctx, np.int32)
    perm = rng.permutation(NUM_PAGES)
    bt = np.full((s, max_pages), NUM_PAGES, np.int32)
    used = 0
    for i in range(s):
        need = min(-(-int(ctx[i]) // PAGE), max_pages)
        bt[i, :need] = perm[used:used + need]
        used += need
    if sentinel is not None:
        bt[sentinel] = NUM_PAGES
    return q, kp, vp, bt, ctx


def t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# contexts: 0, one key, on page boundaries, on split boundaries (at 1, 2
# and 3 pages a split: 24 = 3 pages, 48 = 6 pages) and one past them, the
# full table; 7 pages at 3 a split leaves a short last split
CTX = [0, 1, PAGE, PAGE + 1, 2 * PAGE, 24, 25, 48, 49, 7 * PAGE]


@pytest.mark.parametrize("pages_per_split", [1, 2, 3])
def test_split_twin_normalized_matches_pallas(pages_per_split):
    q, kp, vp, bt, ctx = paged_case(CTX)
    want = jpa.paged_decode_attention(*j(q, kp, vp, bt, ctx), PAGE,
                                      interpret=True)
    got = tpa.paged_decode_split_reference(*t(q, kp, vp, bt, ctx), PAGE,
                                           pages_per_split=pages_per_split)
    close(got, want)


def int8_pools(*pools):
    """Quantize float pools as the int8 KV path does: (int8 pools, f32
    scale pools), numpy."""
    out = []
    for x in pools:
        qv, sc = quantize_kv(jnp.asarray(x))
        out += [np.array(qv), np.array(sc)]
    return out


@pytest.mark.parametrize("pool", ["float", "int8"])
@pytest.mark.parametrize("pages_per_split", [1, 2, 3])
def test_split_twin_stats_matches_stacked_pallas(pages_per_split, pool):
    q, kp, vp, bt, ctx = paged_case(CTX, seed=1)
    rng = np.random.default_rng(2)
    kps = np.stack([rng.normal(size=kp.shape).astype(np.float32), kp])
    vps = np.stack([rng.normal(size=vp.shape).astype(np.float32), vp])
    jscales, tscales = {}, {}
    if pool == "int8":
        kps, ksc, vps, vsc = int8_pools(kps, vps)
        jscales = dict(k_scale_pools=jnp.asarray(ksc),
                       v_scale_pools=jnp.asarray(vsc))
        tscales = dict(zip(("k_scale_pool", "v_scale_pool"),
                           t(ksc[1], vsc[1])))
    want = jpa.paged_decode_attention_partial_stacked(
        *j(q, kps, vps, bt, ctx), jnp.int32(1), PAGE, interpret=True,
        **jscales)
    got = tpa.paged_decode_split_reference(*t(q, kps[1], vps[1], bt, ctx),
                                           PAGE,
                                           pages_per_split=pages_per_split,
                                           stats=True, **tscales)
    for a, b in zip(got, want):
        close(a, b)
    assert np.all(np.isneginf(got[1][0].numpy()))          # ctx == 0
    assert np.all(got[2][0].numpy() == 0) and np.all(got[0][0].numpy() == 0)


@pytest.mark.parametrize("pool", ["float", "int8"])
@pytest.mark.parametrize("pages_per_split", [1, 2, 3])
@pytest.mark.parametrize("where", [(5, 0), (5, 2), (8, 3), (9, 6)],
                         ids=["split_start", "split_end", "mid", "last_page"])
def test_split_twin_skips_a_sentinel_inside_a_split(pages_per_split, where,
                                                    pool):
    """A sentinel page inside the context contributes no keys: the result
    equals the Pallas kernel on the table with that page's keys dropped
    (the slot's later pages moved up, its context shortened by a page);
    over int8 pools, the stats of the stacked kernel with scale pools."""
    slot, col = where
    q, kp, vp, bt, ctx = paged_case(CTX, seed=3, sentinel=where)
    row = [p for i, p in enumerate(bt[slot]) if i != col] + [NUM_PAGES]
    bt2 = bt[slot:slot + 1].copy()
    bt2[0] = row
    ctx2 = np.asarray([ctx[slot] - PAGE], np.int32)
    if pool == "float":
        got = tpa.paged_decode_split_reference(
            *t(q, kp, vp, bt, ctx), PAGE, pages_per_split=pages_per_split)
        want = jpa.paged_decode_attention(
            *j(q[slot:slot + 1], kp, vp, bt2, ctx2), PAGE, interpret=True)
        close(got[slot:slot + 1], want)
        return
    kq, ksc, vq, vsc = int8_pools(kp, vp)
    got = tpa.paged_decode_split_reference(
        *t(q, kq, vq, bt, ctx), PAGE, pages_per_split=pages_per_split,
        stats=True, k_scale_pool=t(ksc)[0], v_scale_pool=t(vsc)[0])
    want = jpa.paged_decode_attention_partial_stacked(
        *j(q[slot:slot + 1], kq[None], vq[None], bt2, ctx2), jnp.int32(0),
        PAGE, k_scale_pools=jnp.asarray(ksc[None]),
        v_scale_pools=jnp.asarray(vsc[None]), interpret=True)
    for a, b in zip(got, want):
        close(a[slot:slot + 1], b)


@pytest.mark.parametrize("pages_per_split", [1, 2, 3])
def test_split_twin_with_more_splits_than_pages(pages_per_split):
    """A wide table (24 pages) and short contexts: most splits lie past
    every slot's pages and must leave the result unchanged."""
    q, kp, vp, bt, ctx = paged_case([0, 3, 17, 30], max_pages=24, seed=4)
    want = jpa.paged_decode_attention_partial(*j(q, kp, vp, bt, ctx), PAGE,
                                              interpret=True)
    got = tpa.paged_decode_split_reference(*t(q, kp, vp, bt, ctx), PAGE,
                                           pages_per_split=pages_per_split,
                                           stats=True)
    for a, b in zip(got, want):
        close(a, b)


@pytest.mark.parametrize("pages_per_split", [1, 2, 3, None])
def test_split_twin_matches_the_plain_version(pages_per_split):
    q, kp, vp, bt, ctx = paged_case(CTX, seed=5)
    args = t(q, kp, vp, bt, ctx)
    close(tpa.paged_decode_split_reference(*args, PAGE,
                                           pages_per_split=pages_per_split),
          tpa.paged_decode_attention_reference(*args, PAGE))


@pytest.mark.parametrize("max_pages,page,want", [
    (16, 128, (2, 8)), (8, 128, (2, 4)), (1, 128, (2, 1)), (64, 16, (16, 4)),
    (7, 8, (32, 1)), (5, 512, (1, 5))])
def test_split_plan(max_pages, page, want):
    assert tpa.split_plan(max_pages, page) == want
    pages_per_split, splits = want
    assert pages_per_split * splits >= max_pages
    assert pages_per_split * page >= min(page, tpa.SPLIT_KEYS)


def test_split_plan_ignores_the_number_of_slots():
    """The plan reads the table's width and the page size only, so a slot
    keeps its splits, and its result, at any batch size."""
    assert list(inspect.signature(tpa.split_plan).parameters) == [
        "max_pages", "page_size"]
    q, kp, vp, bt, ctx = paged_case(CTX, seed=6)
    rng = np.random.default_rng(7)
    results = []
    for s in (3, 40):
        idx = rng.integers(0, len(CTX), size=s)
        idx[1] = 7                                   # the slot under test
        args = t(q[idx], kp, vp, bt[idx], ctx[idx])
        results.append(tpa.paged_decode_split_reference(*args, PAGE,
                                                        stats=True))
    for a, b in zip(results[0], results[1]):
        close(a[1], b[1], tol=1e-6)


# --- flash prefill: the kernel's row and key tiles --------------------------

T = 300                                   # not a multiple of the 128 tile
LENGTHS = [0, 1, 127, 128, 129, T]


def prefill_case(n, t_len, g, kh=2, d=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, t_len, kh, g, d)).astype(np.float32)
    k = rng.normal(size=(n, t_len, kh, d)).astype(np.float32)
    v = rng.normal(size=(n, t_len, kh, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("g", [1, 4, 8])
def test_tiled_twin_matches_pallas_interpret(g):
    q, k, v = prefill_case(len(LENGTHS), T, g, seed=g)
    lens = np.asarray(LENGTHS, np.int32)
    want = jfp.flash_prefill(*j(q, k, v, lens), interpret=True)
    got = tfp.flash_prefill_tiled_reference(*t(q, k, v, lens))
    close(got, want)


@pytest.mark.parametrize("g", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("t_len", [128, 200, 300])
def test_tiled_twin_matches_the_plain_version(g, t_len):
    q, k, v = prefill_case(3, t_len, g, seed=10 + g)
    lens = np.asarray([t_len, t_len // 2 + 1, 64], np.int32)
    close(tfp.flash_prefill_tiled_reference(*t(q, k, v, lens)),
          tfp.flash_prefill_reference(*t(q, k, v, lens)))


@pytest.mark.parametrize("g", [1, 4, 8])
def test_tiled_twin_ignores_nan_padding(g):
    """Keys and values at or past the length may hold NaN: the masked
    scores and the zeroed value rows keep them out of every row, padded
    query rows included."""
    q, k, v = prefill_case(2, 200, g, seed=20 + g)
    lens = np.asarray([130, 7], np.int32)
    want = tfp.flash_prefill_reference(*t(q, k, v, lens))
    for b, ln in enumerate(lens):
        k[b, ln:] = np.nan
        v[b, ln:] = np.nan
    got = tfp.flash_prefill_tiled_reference(*t(q, k, v, lens))
    assert torch.isfinite(got).all()
    close(got, want)


@pytest.mark.parametrize("block_m,block_n", [(64, 32), (32, 64)])
def test_tiled_twin_other_tiles_match_pallas(block_m, block_n):
    """The schedule at other tile sizes (diagonal tiles that are not
    square) still gives the Pallas kernel's result."""
    q, k, v = prefill_case(len(LENGTHS), T, 4, seed=30)
    lens = np.asarray(LENGTHS, np.int32)
    want = jfp.flash_prefill(*j(q, k, v, lens), block_q=64, block_k=64,
                             interpret=True)
    got = tfp.flash_prefill_tiled_reference(*t(q, k, v, lens),
                                            block_m=block_m, block_n=block_n)
    close(got, want)


# the query groups of the served families: Llama / Mistral (1, 4, 8),
# Qwen2 (6, 7), Llama-2-70B (8), 16, StarCoder's rank (24), StarCoder (48),
# 64, Falcon-7B (71), 128
SERVED_GROUPS = [1, 2, 4, 6, 7, 8, 16, 24, 48, 64, 71, 128]


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("g", SERVED_GROUPS)
def test_row_tile_fills_every_row(g, d):
    """A row tile holds gs query heads of the group x tpb tokens: gs
    divides G, and the tile's rows (192 at D = 64, else 128) are all used;
    a G that divides them keeps its whole group."""
    rows = tfp.block_rows(d)
    assert rows == (192 if d == 64 else tfp.BLOCK_M)
    gs, tpb = tfp.row_tile(g, rows)
    assert g % gs == 0 and gs * tpb == rows
    if rows % g == 0:
        assert gs == g


@pytest.mark.parametrize("g", [48, 71])
def test_tiled_twin_sub_groups_match_pallas_interpret(g):
    """Multi-query groups that do not divide the row tile (at D = 32, 128
    rows: StarCoder's 48 in 16 heads x 8 tokens, three sub-groups;
    Falcon-7B's 71 in one head x 128 tokens, 71 sub-groups), lengths of 0,
    inside the first key tile and past it, NaN in the keys and values past
    each length."""
    t_len = 130
    q, k, v = prefill_case(3, t_len, g, kh=1, seed=40 + g)
    lens = np.asarray([0, 100, t_len - 1], np.int32)
    want = jfp.flash_prefill(*j(q, k, v, lens), interpret=True)
    for b, ln in enumerate(lens):
        k[b, ln:] = np.nan
        v[b, ln:] = np.nan
    got = tfp.flash_prefill_tiled_reference(*t(q, k, v, lens))
    assert torch.isfinite(got).all()
    assert torch.all(got[0] == 0)                       # length 0
    close(got, want)
