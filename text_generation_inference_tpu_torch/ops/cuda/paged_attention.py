"""Decode attention over a paged KV pool: wrappers of
`csrc/paged_attention.cu` (normalized and stats modes, and the stats mode
over int8 pools) and their plain PyTorch versions.

Counterpart of the JAX package's `ops/pallas/paged_attention.py`. Shapes
(the JAX layouts):
  q:           [S, K, G, D]
  k/v pool:    [K, P * page_size, D]   (one layer's view of [L, K, R, D])
  block_table: [S, max_pages] i32; entries that are not mapped hold the
               sentinel P (`num_pages`)
  ctx:         [S] i32 live tokens per slot
  out:         [S, K, G, D] (normalized), or acc [S, K, G, D] f32 plus
               m, l [S, K, G] f32 (stats)
  alibi_slopes_kg: optional [K, G] f32 ALiBi slopes (query head k * G +
               g): slope * p is added to the scaled score of the key at
               position p of the slot's sequence (not its pool row), as the
               JAX references add it; the stats mode's m carries the bias,
               in natural-log units, for the ring merge
  int8 pools:  k/v pools int8 plus k_scale/v_scale pools [K, P * page_size]
               f32, one dequant factor per (kv head, pool row): the k scale
               multiplies the scores, the v scale folds into the
               probabilities before the value product, and l sums the
               unscaled probabilities (JAX `_flash_page_update` with ks/vs)

q, and pools that are not int8, are bf16, fp16 or fp32 (`DTYPES`; fp32
runs on the split body's 3xTF32 kernel, to fp32 accuracy, as the JAX
kernels compute in f32; K2 takes fp32 q over its int8 pools); the kernel
takes every head dim in `HEAD_DIMS` and any group G (a block takes the
query heads of a kv head GROUP_BLOCK at a time). `tile_plan` gives the keys
a tile and the stages of its ring of tiles, from D, G and the element type.

The plain versions gather each slot's pages with explicit masking: a key
position is live when it is below ctx and its page id lies in
[0, num_pages); sentinel pages contribute nothing (the kernel skips them).
The JAX reference clamps such gathers instead (`mode="clip"`), which gives
the same result wherever the sentinel lies past ctx.

All three entries run one kernel body (`csrc/decode_split.cuh`): it splits
each slot's pages across blocks, a fixed number of pages a split
(`split_plan`, from the page size alone), and merges the splits' (acc, m,
l) in split order inside the same launch: the block that arrives last at a
per-(slot, kv head) counter merges. The counters live in one zeroed int32
buffer per device (`arrivals`, shared with the slot-cache kernel), which
the kernel leaves zeroed; launches that share it run one after another on
one stream. `paged_decode_split_reference` is the plain twin of that
schedule, over bf16 or int8 pools (it sums a split's keys in one pass; the
kernel sums each warp's keys of a split, then merges the 4 warps: the same
fp32 sums in another order).

Each wrapper takes the plain version only for CPU tensors; for a CUDA
tensor it launches the kernel or raises. `paged_decode_attention.launches`,
`paged_decode_attention_partial.launches` and
`paged_decode_attention_partial_i8.launches` count launches, their `alibi`
attributes those given slopes.
"""

from __future__ import annotations

import math
import weakref

import torch

from . import build

# head dims the kernel is built for: the JAX package's families (64, 80 for
# phi-2, 96 for gpt-neox-20b, 128, 192, 256 for gemma) and the test
# fixtures' 16
HEAD_DIMS = (16, 64, 80, 96, 128, 192, 256)
# element types it is built for
DTYPES = (torch.bfloat16, torch.float16, torch.float32)
GROUP_BLOCK = 16  # query heads a block of the split kernel takes
SPLIT_KEYS = 256  # keys a split of the paged kernel covers (whole pages)


def split_plan(max_pages: int, page_size: int) -> tuple[int, int]:
    """(pages per split, splits) of the paged kernel's grid. A split covers
    whole pages, SPLIT_KEYS keys or one page if a page is longer; the plan
    depends on the block table's width and the page size only, never on the
    number of slots, so a slot's result does not depend on the batch."""
    pages_per_split = max(1, SPLIT_KEYS // page_size)
    return pages_per_split, max(1, -(-max_pages // pages_per_split))


# shared memory on an H100: the most a block may use (227 KB) and an SM's
# (228 KB; 1 KB of it reserved for each resident block); the split body's
# static arrays take under 1 KB
SMEM_BLOCK = 232448
SMEM_SM = 233472
SMEM_STATIC = 1024
# the mma body's ring (bf16 / fp16): 64-key tiles in 3 stages
MMA_TILE, MMA_STAGES = 64, 3


def f32_smem(d: int, g: int, tile: int, stages: int,
             int8: bool = False) -> int:
    """Dynamic shared memory (bytes) of the fp32 body at head dim d and
    group g with `tile`-key tiles in `stages` stages, as csrc/decode_split.cuh
    `F32Smem` lays it out: K rows strided d + 8 floats, V rows d + 4 (int8
    rows d + 16 bytes each, and the tile's k and v scales), the warp merge
    reusing the ring, then q's hi / lo fragments for a block's query heads
    (at most GROUP_BLOCK)."""
    elem = 1 if int8 else 4
    ldk, ldv = (d + 16, d + 16) if int8 else (d + 8, d + 4)
    stage = tile * (ldk + ldv) * elem + (2 * tile * 4 if int8 else 0)
    ring = max(stages * stage, 4 * GROUP_BLOCK * d * 4)
    return ring + min(g, GROUP_BLOCK) * (2 * d + 16) * 4


def tile_plan(d: int, g: int, dtype, int8: bool = False) -> tuple[int, int]:
    """(keys a tile, stages) of the split body's ring of tiles. bf16 / fp16:
    the mma body's fixed 64 keys in 3 stages. fp32 (rows of 4 bytes, or int8
    rows under an fp32 q): two stages of 64 keys, else of 32, where two
    blocks fit an SM (its registers hold two); else the first of 64 then 32
    keys in 3 then 2 stages that fits one block. int8 rows take 64-key
    tiles only."""
    if dtype != torch.float32:
        return MMA_TILE, MMA_STAGES
    keys = (64,) if int8 else (64, 32)
    two_blocks = SMEM_SM // 2 - 1024 - SMEM_STATIC
    for limit, options in (
            (two_blocks, [(t, 2) for t in keys]),
            (SMEM_BLOCK - SMEM_STATIC, [(t, st) for t in keys
                                        for st in (3, 2)])):
        for tile, stages in options:
            if f32_smem(d, g, tile, stages, int8) <= limit:
                return tile, stages
    raise ValueError(f"no fp32 tile plan fits head dim {d}, group {g}")


def _gather_pages(q, k_pool, v_pool, block_table, ctx, page_size,
                  k_scale_pool=None, alibi_slopes_kg=None, pos0: int = 0):
    """Scores [S, K, G, T'] f32 (dead keys at -inf; times the k scale for
    int8 pools; plus slope * (pos0 + t) with slopes), values [K, S, T', D]
    f32 (dead rows zeroed) and the pool rows [S, T'] each key came from,
    T' = max_pages * page_size."""
    s, kh, g, d = q.shape
    pool_rows = k_pool.shape[1]
    num_pages = pool_rows // page_size
    bt = block_table.to(torch.int64)
    offs = torch.arange(page_size, device=q.device)
    rows = (bt[:, :, None] * page_size + offs[None, None, :]).reshape(s, -1)
    mapped = ((bt >= 0) & (bt < num_pages))[:, :, None].expand(
        -1, -1, page_size).reshape(s, -1)
    t = rows.shape[1]
    live = (torch.arange(t, device=q.device)[None, :]
            < ctx.to(q.device)[:, None]) & mapped
    rows = rows.clamp(0, pool_rows - 1)
    k = k_pool[:, rows].to(torch.float32)                      # [K, S, T', D]
    v = v_pool[:, rows].to(torch.float32)
    scores = torch.einsum("skgd,kstd->skgt", q.to(torch.float32),
                          k) * (1.0 / math.sqrt(d))
    if k_scale_pool is not None:
        scores = scores * k_scale_pool[:, rows].transpose(0, 1)[:, :, None, :]
    if alibi_slopes_kg is not None:
        pos = torch.arange(pos0, pos0 + t, device=q.device,
                           dtype=torch.float32)
        scores = scores + (alibi_slopes_kg.to(torch.float32)[None, :, :, None]
                           * pos)
    scores = scores.masked_fill(~live[:, None, None, :], -math.inf)
    v = torch.where(live[None, :, :, None], v, 0.0)
    return scores, v, rows


def paged_decode_attention_partial_reference(q, k_pool, v_pool, block_table,
                                             ctx, page_size,
                                             alibi_slopes_kg=None,
                                             k_scale_pool=None,
                                             v_scale_pool=None, pos0=0):
    """Plain version of the stats mode: (acc f32, m f32, l f32). With int8
    pools, k_scale_pool/v_scale_pool [K, P * page_size] f32 carry each row's
    dequant factor; `alibi_slopes_kg` as the JAX reference takes it (the
    key at table position t is at sequence position pos0 + t)."""
    scores, v, rows = _gather_pages(q, k_pool, v_pool, block_table, ctx,
                                    page_size, k_scale_pool,
                                    alibi_slopes_kg, pos0)
    m = torch.max(scores, dim=-1).values                       # [S, K, G]
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp(scores - m_safe[..., None])
    p = torch.where(torch.isneginf(scores), 0.0, p)
    l = torch.sum(p, dim=-1)
    if v_scale_pool is not None:
        p = p * v_scale_pool[:, rows].transpose(0, 1)[:, :, None, :]
    acc = torch.einsum("skgt,kstd->skgd", p, v)
    return acc, m, l


def paged_decode_attention_reference(q, k_pool, v_pool, block_table, ctx,
                                     page_size, alibi_slopes_kg=None):
    """Plain version of the normalized mode (acc / max(l, 1e-30), so a slot
    with ctx == 0 gives 0, as the kernel does)."""
    acc, _, l = paged_decode_attention_partial_reference(
        q, k_pool, v_pool, block_table, ctx, page_size, alibi_slopes_kg)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def merge_splits(parts, shape, device):
    """Merge per-split (acc, m, l, used [S]) in split order, as the kernels'
    last block does: (acc [S, K, G, D], m [S, K, G], l [S, K, G]) f32; the
    splits a slot does not use (used False) are left out."""
    s, kh, g, d = shape
    m_all = torch.full((s, kh, g), -math.inf, device=device)
    for _, m, _, used in parts:
        m_all = torch.where(used[:, None, None], torch.maximum(m_all, m), m_all)
    m_safe = torch.where(torch.isneginf(m_all), 0.0, m_all)
    acc_all = torch.zeros((s, kh, g, d), device=device)
    l_all = torch.zeros((s, kh, g), device=device)
    for acc, m, l, used in parts:          # in split order
        w = torch.where(torch.isneginf(m) | ~used[:, None, None], 0.0,
                        torch.exp(m - m_safe))
        acc_all = acc_all + w[..., None] * acc
        l_all = l_all + w * l
    return acc_all, m_all, l_all


def paged_decode_split_reference(q, k_pool, v_pool, block_table, ctx,
                                 page_size, pages_per_split=None,
                                 stats=False, k_scale_pool=None,
                                 v_scale_pool=None, alibi_slopes_kg=None):
    """Plain twin of the kernel's schedule: (acc, m, l) of every split of
    `pages_per_split` pages (default: `split_plan`'s), the splits past a
    slot's pages left out, then merged in split order. Returns the stats
    mode's (acc, m, l) or, with stats=False, the normalized output. With
    int8 pools, their scale pools as in the plain version (K2's twin)."""
    max_pages = block_table.shape[1]
    if pages_per_split is None:
        pages_per_split = split_plan(max_pages, page_size)[0]
    splits = -(-max_pages // pages_per_split)
    ctx = ctx.to(torch.int64).clamp(min=0)
    n_pages = torch.clamp(-(-ctx // page_size), max=max_pages)
    n_splits = torch.clamp(-(-n_pages // pages_per_split), min=1)
    parts = []
    for sp in range(splits):
        first = sp * pages_per_split
        cols = slice(first, min(first + pages_per_split, max_pages))
        # the split's positions start at `first` pages: shift ctx so that
        # the plain version's position test covers this split's keys only
        split_ctx = torch.clamp(ctx - first * page_size, min=0)
        acc, m, l = paged_decode_attention_partial_reference(
            q, k_pool, v_pool, block_table[:, cols].contiguous(),
            split_ctx.to(torch.int32), page_size, alibi_slopes_kg,
            k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool,
            pos0=first * page_size)
        parts.append((acc, m, l, sp < n_splits))
    acc, m, l = merge_splits(parts, q.shape, q.device)
    if stats:
        return acc, m, l
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def scratch_blocks(s: int, kh: int, g: int) -> tuple[int, int]:
    """(blocks, heads) of the split kernel's grid over one split: S * KH *
    ceil(G / GROUP_BLOCK) blocks of at most GROUP_BLOCK query heads; the
    fp32 scratch holds heads = min(G, GROUP_BLOCK) rows of D + 2 per block
    and split, and the arrival counters one per block."""
    return s * kh * -(-g // GROUP_BLOCK), min(g, GROUP_BLOCK)


_ARRIVALS: dict[torch.device, torch.Tensor] = {}
# owners of captured CUDA graphs (engine.programs.DecodePrograms) -> their
# device: a graph holds the raw addresses of the shared scratch below and
# of K1's workspace, so neither may be replaced on that device while one
# lives
_PINS: "weakref.WeakKeyDictionary[object, torch.device]" = (
    weakref.WeakKeyDictionary())


def pin_scratch(owner, device: torch.device) -> None:
    """Freeze the device's shared scratch while `owner` lives (or until
    `unpin_scratch`): growing it then raises."""
    _PINS[owner] = torch.device(device)


def unpin_scratch(owner) -> None:
    _PINS.pop(owner, None)


def grow_scratch(cache: dict, device: torch.device, numel: int, make):
    """The cached scratch tensor of `device` with at least `numel` elements,
    replaced by `make(numel)` when it is smaller. Raises instead while a
    captured graph on the device pins the scratch: the replaced tensor would
    be freed under the graph's writes."""
    buf = cache.get(device)
    if buf is None or buf.numel() < numel:
        if buf is not None and torch.device(device) in _PINS.values():
            raise RuntimeError(
                f"the shared kernel scratch on {device} must grow to {numel} "
                f"elements while captured decode programs hold its address; "
                "size it before the first capture (an eager run of every "
                "program first)")
        buf = make(numel)
        cache[device] = buf
    return buf


def arrivals(device: torch.device, n: int) -> torch.Tensor:
    """The device's arrival counters, at least n of them, all zero (each
    launch leaves them zero, so a replayed graph finds them zero too)."""
    return grow_scratch(_ARRIVALS, device, n, lambda k: torch.zeros(
        max(k, 64), dtype=torch.int32, device=device))


def _check(fn, q, k_pool, v_pool, block_table, ctx, page_size,
           pool_dtype=None, slopes=None):
    s, kh, g, d = q.shape
    if slopes is not None and (
            slopes.device != q.device or slopes.dtype != torch.float32
            or slopes.shape != (kh, g) or not slopes.is_contiguous()):
        raise ValueError(f"{fn}: alibi_slopes_kg must be a contiguous "
                         f"float32 [{kh}, {g}] tensor on {q.device}")
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    for name, x in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("ctx", ctx)):
        if x.device != q.device:
            raise ValueError(f"{fn}: {name} on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError(f"{fn}: q must be contiguous")
    pool_dtype = pool_dtype or q.dtype
    if (q.dtype not in DTYPES or k_pool.dtype != pool_dtype
            or v_pool.dtype != pool_dtype):
        raise ValueError(f"{fn}: q must be one of {DTYPES} and the pools "
                         f"{pool_dtype}, got {q.dtype}, {k_pool.dtype}, "
                         f"{v_pool.dtype}")
    if block_table.dtype != torch.int32 or ctx.dtype != torch.int32:
        raise ValueError(f"{fn}: block_table and ctx must be int32")
    if (k_pool.dim() != 3 or k_pool.shape[0] != kh or k_pool.shape[2] != d
            or v_pool.shape != k_pool.shape):
        raise ValueError(f"{fn}: pools {tuple(k_pool.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != s or ctx.shape != (s,):
        raise ValueError(f"{fn}: block_table [S, max_pages] and ctx [S] "
                         "expected")
    if d not in HEAD_DIMS:
        raise ValueError(f"{fn}: head_dim {d} not in {HEAD_DIMS}")
    if k_pool.shape[1] % page_size:
        raise ValueError(f"{fn}: pool rows not a multiple of page_size")


def _launch(entry, q, k_pool, v_pool, block_table, ctx, page_size, outs,
            scale_pools=(), slopes=None):
    """Launch one entry with the split plan, the fp32 split scratch, the
    arrival counters and the ALiBi slopes (null for none)."""
    s, kh, g, d = q.shape
    lib = build.library("paged_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    pool_rows = k_pool.shape[1]
    max_pages = block_table.shape[1]
    pages_per_split, splits = split_plan(max_pages, page_size)
    blocks, heads = scratch_blocks(s, kh, g)
    part = (torch.empty(blocks * splits * heads * (d + 2),
                        dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    counters = arrivals(q.device, blocks)
    plan = tile_plan(d, g, q.dtype, int8=bool(scale_pools))
    with torch.cuda.device(q.device):
        code = getattr(lib, entry)(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            *[p.data_ptr() for p in scale_pools],
            block_table.data_ptr(), ctx.data_ptr(),
            None if slopes is None else slopes.data_ptr(),
            *[o.data_ptr() for o in outs],
            None if part is None else part.data_ptr(), counters.data_ptr(),
            s, kh, g, d, pool_rows, page_size, max_pages,
            pool_rows // page_size, pages_per_split, splits, *plan,
            build.dtype_code(q.dtype), 1.0 / math.sqrt(d), stream)
    build.check("paged_attention", code)


def _count(wrapper, slopes) -> None:
    wrapper.launches += 1
    if slopes is not None:
        wrapper.alibi += 1


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           ctx: torch.Tensor, page_size: int,
                           alibi_slopes_kg: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Normalized mode. Returns [S, K, G, D] in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_pool, v_pool,
                                                block_table, ctx, page_size,
                                                alibi_slopes_kg)
    _check("paged_decode_attention", q, k_pool, v_pool, block_table, ctx,
           page_size, slopes=alibi_slopes_kg)
    out = torch.empty_like(q)
    if q.numel() == 0 or block_table.shape[1] == 0:
        return out.zero_()
    _launch("tgi_paged_decode", q, k_pool, v_pool,
            block_table, ctx, page_size, [out], slopes=alibi_slopes_kg)
    _count(paged_decode_attention, alibi_slopes_kg)
    return out


def paged_decode_attention_partial(q: torch.Tensor, k_pool: torch.Tensor,
                                   v_pool: torch.Tensor,
                                   block_table: torch.Tensor,
                                   ctx: torch.Tensor, page_size: int,
                                   alibi_slopes_kg: torch.Tensor | None = None):
    """Stats mode: (acc [S,K,G,D] f32, m [S,K,G] f32, l [S,K,G] f32), with
    m = -inf, l = 0, acc = 0 for slots with ctx == 0."""
    if q.device.type == "cpu":
        return paged_decode_attention_partial_reference(
            q, k_pool, v_pool, block_table, ctx, page_size, alibi_slopes_kg)
    _check("paged_decode_attention_partial", q, k_pool, v_pool, block_table,
           ctx, page_size, slopes=alibi_slopes_kg)
    s, kh, g, d = q.shape
    acc = torch.empty((s, kh, g, d), dtype=torch.float32, device=q.device)
    m = torch.empty((s, kh, g), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if q.numel() == 0 or block_table.shape[1] == 0:
        return acc.zero_(), m.fill_(-math.inf), l.zero_()
    _launch("tgi_paged_decode_stats", q,
            k_pool, v_pool, block_table, ctx, page_size, [acc, m, l],
            slopes=alibi_slopes_kg)
    _count(paged_decode_attention_partial, alibi_slopes_kg)
    return acc, m, l


def paged_decode_attention_partial_i8(q: torch.Tensor, k_pool: torch.Tensor,
                                      v_pool: torch.Tensor,
                                      k_scale_pool: torch.Tensor,
                                      v_scale_pool: torch.Tensor,
                                      block_table: torch.Tensor,
                                      ctx: torch.Tensor, page_size: int,
                                      alibi_slopes_kg: torch.Tensor | None
                                      = None):
    """Stats mode over int8 pools with their [K, P * page_size] f32 scale
    pools: (acc, m, l) as `paged_decode_attention_partial`."""
    if q.device.type == "cpu":
        return paged_decode_attention_partial_reference(
            q, k_pool, v_pool, block_table, ctx, page_size, alibi_slopes_kg,
            k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool)
    fn = "paged_decode_attention_partial_i8"
    _check(fn, q, k_pool, v_pool, block_table, ctx, page_size,
           pool_dtype=torch.int8, slopes=alibi_slopes_kg)
    for name, p in (("k_scale_pool", k_scale_pool),
                    ("v_scale_pool", v_scale_pool)):
        if (p.device != q.device or p.dtype != torch.float32
                or p.shape != k_pool.shape[:2] or not p.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be a contiguous float32 "
                             f"{tuple(k_pool.shape[:2])} tensor on {q.device}")
    s, kh, g, d = q.shape
    acc = torch.empty((s, kh, g, d), dtype=torch.float32, device=q.device)
    m = torch.empty((s, kh, g), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if q.numel() == 0 or block_table.shape[1] == 0:
        return acc.zero_(), m.fill_(-math.inf), l.zero_()
    _launch("tgi_paged_decode_stats_i8", q, k_pool, v_pool, block_table, ctx,
            page_size, [acc, m, l], scale_pools=(k_scale_pool, v_scale_pool),
            slopes=alibi_slopes_kg)
    _count(paged_decode_attention_partial_i8, alibi_slopes_kg)
    return acc, m, l


def paged_decode_attention_partial_stacked(q, k_pools, v_pools, block_table,
                                           ctx, layer_idx: int,
                                           page_size: int, *,
                                           alibi_slopes_kg=None,
                                           k_scale_pools=None,
                                           v_scale_pools=None):
    """Stats mode over layer-stacked pools [L, K, R, D] (int8 pools with
    their [L, K, R] scale pools): the layer's pools are views
    (`pools[layer_idx]`, no copy), so this is the same kernel."""
    if k_scale_pools is not None:
        return paged_decode_attention_partial_i8(
            q, k_pools[layer_idx], v_pools[layer_idx],
            k_scale_pools[layer_idx], v_scale_pools[layer_idx], block_table,
            ctx, page_size, alibi_slopes_kg)
    return paged_decode_attention_partial(q, k_pools[layer_idx],
                                          v_pools[layer_idx], block_table,
                                          ctx, page_size, alibi_slopes_kg)


paged_decode_attention.launches = paged_decode_attention.alibi = 0
paged_decode_attention_partial.launches = 0
paged_decode_attention_partial.alibi = 0
paged_decode_attention_partial_i8.launches = 0
paged_decode_attention_partial_i8.alibi = 0
