"""Causal flash attention for prefill buckets: wrapper of
`csrc/flash_prefill.cu` and its plain PyTorch version.

Counterpart of the JAX package's `ops/pallas/flash_prefill.py`
(`flash_prefill`, `flash_prefill_reference`). Shapes: q [N, T, K, G, D],
k/v [N, T, K, D], lengths [N] → out like q. Keys j are visible to query i
when j <= i and j < lengths[n]; rows with lengths[n] == 0 give 0. With a
sliding window W (`window` > 0; 0 is none) a query row i < lengths[n] sees
only the keys i - W < j <= i; rows past the length keep the causal mask,
as the JAX model's mask does (`models/core.py` prefill: a padded row could
otherwise see no key at all).

`flash_prefill_tiled_reference` is the plain twin of the kernel's schedule:
row tiles of `block_rows(d)` rows (192 at head dim 64, else 128), each
`row_tile(G, rows)` = (gs, tpb): tpb tokens x gs query heads of one kv head
(row = token * gs + head, from head g0 of the tile's sub-group), in
warpgroups of 64 rows, key tiles of `key_tile(d)` keys (128, or 80 at
head dims 192 and 256), each warpgroup walking key tiles up to its causal and
length limit and masking only the tiles that cross its diagonal or the
length; with a window, each warpgroup starts at the tile that holds its
first visible key (the tiles wholly below its window are released unread)
and also masks the tiles that cross the window's lower edge.

bf16 and fp16 run on the wgmma kernel; fp32 runs on the source's fp32
kernel, mma.sync on the tensor cores in 3xTF32 (the JAX kernel computes in
f32): every operand is split into two TF32 terms, hi = rna(x) and lo =
rna(x - hi), and each product is lo.hi + hi.lo + hi.hi with fp32 sums.
`flash_prefill_tf32x3_reference` is the plain twin of that arithmetic over
its key tiles (`f32_key_tile(d)`: 64 keys, 32 at head dims 192 and 256).
`visible` is the one mask every plain version applies.

ALiBi (`slopes`, a [K, G] f32 tensor, query head k * G + g; None for
none): the kernels and every plain version here add slope * (j - i) to the
scaled score of key j for query row i. The JAX package's bias is slope * j
(`models/core.py`); the two differ by a constant a row, which the softmax
cancels, and the relative form keeps the added term small where the
probabilities are large, so fp32 rounding of the term stays far below the
tolerances at long buckets. Which keys are visible does not change.

`flash_prefill` takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises. `flash_prefill.launches`
counts kernel launches, `flash_prefill.windowed` those whose window is
shorter than the bucket, `flash_prefill.alibi` those given slopes.
"""

from __future__ import annotations

import itertools
import math

import torch

from . import build

HEAD_DIMS = (64, 128, 192, 256)   # head dims the kernel is compiled for
# element types it is built for
DTYPES = (torch.bfloat16, torch.float16, torch.float32)
BLOCK_M = 128           # rows (token * gs + head) a block takes past D = 64
BLOCK_N = 128           # keys a tile of the kernel up to head dim 128
WG_ROWS = 64            # rows a consumer warpgroup of the kernel takes


def block_rows(d: int) -> int:
    """Rows a block of the wgmma kernel takes at head dim d: three
    warpgroups of 64 at D = 64 (a warpgroup's softmax outlasts another's
    products there), two above (a third's registers do not hold its
    accumulators and scores)."""
    return 3 * WG_ROWS if d == 64 else BLOCK_M


def row_tile(g: int, block_m: int = BLOCK_M) -> tuple[int, int]:
    """(gs, tpb): a row tile of block_m rows of the wgmma kernel holds tpb
    tokens x gs of the G query heads of one kv head. gs is the largest
    divisor of g that also divides block_m, so gs * tpb == block_m and no
    row of a tile is idle (at 128 rows: G = 48 takes 16 heads x 8 tokens,
    G = 71 one head x 128 tokens; a G that divides block_m keeps all its
    heads, gs = G). The G / gs sub-groups of a kv head are tiles of their
    own."""
    gs = math.gcd(g, block_m)
    return gs, block_m // gs


def key_tile(d: int) -> int:
    """Keys a tile of the wgmma kernel at head dim d: 80 past 128, where
    the Q tile leaves room for two stages of 80-key K and V tiles, not of
    128-key ones."""
    return BLOCK_N if d <= 128 else 80


def f32_key_tile(d: int) -> int:
    """Keys a tile of the fp32 kernel at head dim d."""
    return 64 if d <= 128 else 32


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero (`cvt.rna.tf32.f32`)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def visible(q_tok: torch.Tensor, keys: torch.Tensor, length,
            window: int) -> torch.Tensor:
    """Which keys a query token sees: q_tok [..., R] and keys [J] give
    [..., R, J]; `length` is an int or a tensor that broadcasts against
    q_tok (a batch's lengths as [N, 1])."""
    qt = q_tok[..., :, None]
    ln = length[..., None] if torch.is_tensor(length) else length
    vis = (keys <= qt) & (keys < ln)
    if window:
        vis = vis & ((keys > qt - window) | (qt >= ln))
    return vis


def _product_3xtf32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum(eq, a, b) as the fp32 kernel computes it: a and b split into
    TF32 hi and lo terms, lo.hi + hi.lo + hi.hi."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def row_bias(slopes, rows: torch.Tensor, g: int,
             keys: torch.Tensor) -> torch.Tensor:
    """ALiBi in exp2 units for the rows `rows` [R] (row = token * G + g):
    slope * log2(e) * (key - token), [K, R, J] for keys [J]; 0 without
    slopes."""
    if slopes is None:
        return torch.zeros((), device=rows.device)
    sl = slopes.to(torch.float32)[:, rows % g]                    # [K, R]
    rel = (keys[None, :] - rows[:, None] // g).to(torch.float32)  # [R, J]
    return (sl * math.log2(math.e))[:, :, None] * rel[None]


def flash_prefill_tf32x3_reference(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, lengths: torch.Tensor,
                                   window: int = 0,
                                   slopes: torch.Tensor | None = None
                                   ) -> torch.Tensor:
    """Plain twin of the fp32 kernel's arithmetic (f32 inputs and output):
    rows token * G + g, key tiles of `f32_key_tile(d)` keys in order, both
    products in 3xTF32, the online softmax in exp2 units, keys at or past
    the length read as 0. A tile the kernel skips for a row (wholly above
    its diagonal, past the length or wholly below its window) is fully
    masked here, which leaves the row's state as it was. With `slopes`,
    the score in exp2 units is the scaled product plus `row_bias`."""
    n, t, kh, g, d = q.shape
    tile = f32_key_tile(d)
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    qf = q.to(torch.float32).permute(0, 2, 1, 3, 4).reshape(n, kh, t * g, d)
    live = (torch.arange(t, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])                    # [N, T]
    pad = (-t) % tile
    kf, vf = (torch.nn.functional.pad(
        torch.where(live[:, :, None, None], x.to(torch.float32), 0.0)
        .permute(0, 2, 1, 3), (0, 0, 0, pad)) for x in (k, v))  # [N, K, T', D]
    rows = torch.arange(t * g, device=q.device)
    tok = rows // g
    m = torch.full((n, kh, t * g), -math.inf, device=q.device)
    l = torch.zeros((n, kh, t * g), device=q.device)
    o = torch.zeros((n, kh, t * g, d), device=q.device)
    ln = lengths.to(q.device).clamp(0, t)
    for key0 in range(0, int(ln.max()) if n else 0, tile):
        keys = torch.arange(key0, key0 + tile, device=q.device)
        sc = _product_3xtf32("nkrd,nkjd->nkrj", qf,
                             kf[:, :, key0:key0 + tile]) * scale_log2
        sc = sc + row_bias(slopes, rows, g, keys)
        vis = visible(tok[None, :], keys, ln[:, None], window)  # [N, R, J]
        sc = torch.where(vis[:, None], sc, -math.inf)
        m_new = torch.maximum(m, sc.max(dim=-1).values)
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        alpha = torch.exp2(m - m_safe)
        p = torch.exp2(sc - m_safe[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + _product_3xtf32(
            "nkrj,nkjd->nkrd", p, vf[:, :, key0:key0 + tile])
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(n, kh, t, g, d).permute(0, 2, 1, 3, 4).contiguous()


def flash_prefill_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lengths: torch.Tensor,
                            window: int = 0,
                            slopes: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Plain PyTorch version (fp32 math, output in q's dtype); with
    `slopes`, the scaled scores plus slope * (j - i)."""
    n, t, kh, g, d = q.shape
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("nqkgd,nvkd->nkgqv", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    pos = torch.arange(t, device=q.device)
    if slopes is not None:
        rel = (pos[None, :] - pos[:, None]).to(torch.float32)   # [Tq, Tk]
        scores = scores + slopes.to(torch.float32)[None, :, :, None, None] \
            * rel

    key_valid = pos[None, :] < lengths.to(q.device)[:, None]    # [N, Tk]
    mask = visible(pos[None, :], pos,
                   lengths.to(q.device)[:, None], window)       # [N, Tq, Tk]
    scores = scores.masked_fill(~mask[:, None, None], -math.inf)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)    # rows with no visible key
    vf = torch.where(key_valid[:, :, None, None], v.to(torch.float32), 0.0)
    out = torch.einsum("nkgqv,nvkd->nqkgd", probs, vf)
    return out.to(q.dtype)


def window_floor(first_tok: int, last_tok: int, length: int,
                 window: int) -> int:
    """The first key any row of tokens first_tok..last_tok sees: 0 without
    a window or when a row lies past the length (its causal mask has no
    lower edge), else first_tok - window + 1 (at least 0)."""
    if not window or last_tok >= length:
        return 0
    return max(0, first_tok - window + 1)


def flash_prefill_tiled_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, lengths: torch.Tensor,
                                  block_m: int | None = None,
                                  block_n: int | None = None,
                                  window: int = 0,
                                  slopes: torch.Tensor | None = None
                                  ) -> torch.Tensor:
    """Plain twin of the kernel's schedule (fp32 math, output in q's dtype):
    row tiles of `row_tile(G, block_m)` (block_m: `block_rows(d)` unless
    given), online softmax in exp2 units over the key tiles a warpgroup of
    WG_ROWS rows walks (from the tile of its `window_floor` to its diagonal
    and the length), masks only on the tiles that cross the warpgroup's
    diagonal, the length or its window's lower edge,
    dead value rows zeroed on the length-edge tile. With `slopes`, the row
    max is taken on the biased scores (`row_bias`); without them, on the
    scaled scores as before."""
    n, t, kh, g, d = q.shape
    block_m = block_m or block_rows(d)
    block_n = block_n or key_tile(d)
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    # [N, K, T, G, D]: a tile's rows are (token, head of its sub-group)
    rows_q = q.to(torch.float32).permute(0, 2, 1, 3, 4)
    kf = k.to(torch.float32).permute(0, 2, 1, 3)                # [N, K, T, D]
    vf = v.to(torch.float32).permute(0, 2, 1, 3)
    pad = (-t) % block_n            # tiles past T read zeros
    kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
    vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
    out = torch.zeros_like(rows_q)
    gs, tpb = row_tile(g, block_m)  # heads and tokens a row tile
    for b in range(n):
        ln = max(0, min(int(lengths[b]), t))
        for tok0, g0 in itertools.product(range(0, t, tpb), range(0, g, gs)):
            rows = tpb * gs
            tok_last = min(tok0 + tpb - 1, t - 1)
            last_tile = min(tok_last // block_n, -(-ln // block_n) - 1)
            for r_wg in range(0, block_m, WG_ROWS):
                r = torch.arange(r_wg, min(r_wg + WG_ROWS, rows))
                if r.numel() == 0:
                    continue
                first_tok = tok0 + r_wg // gs
                last_tok = tok0 + int(r[-1]) // gs
                tok = tok0 + r // gs
                keep = tok < t
                r, tok = r[keep], tok[keep]
                head = g0 + r % gs
                first_kt = window_floor(first_tok, last_tok, ln,
                                        window) // block_n
                # the largest first visible key of the warpgroup's real rows
                edge = min(last_tok, ln - 1) - window + 1 if window else 0
                qs = rows_q[b, :, tok, head]                    # [K, R, D]
                m = torch.full((kh, r.numel()), -math.inf)
                l = torch.zeros((kh, r.numel()))
                o = torch.zeros((kh, r.numel(), d))
                for kt in range(first_kt, last_tile + 1):
                    key0 = kt * block_n
                    if key0 > last_tok:      # wholly above the diagonal
                        continue
                    keys = torch.arange(key0, key0 + block_n)
                    kt_k = kf[b, :, key0:key0 + block_n]
                    kt_v = vf[b, :, key0:key0 + block_n]
                    if key0 + block_n > ln:  # the length-edge tile
                        kt_v = torch.where((keys < ln)[:, None], kt_v, 0.0)
                    sc = (torch.einsum("krd,kjd->krj", qs, kt_k) * scale_log2
                          + row_bias(slopes, tok * g + head, g, keys))
                    if key0 + block_n > min(first_tok + 1, ln) or key0 < edge:
                        vis = visible(tok, keys, ln, window)
                        sc = torch.where(vis, sc, -math.inf)
                    m_new = torch.maximum(m, sc.max(dim=-1).values)
                    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
                    alpha = torch.where(torch.isneginf(m), 0.0,
                                        torch.exp2(m - m_safe))
                    p = torch.where(torch.isneginf(sc), 0.0,
                                    torch.exp2(sc - m_safe[..., None]))
                    l = l * alpha + p.sum(dim=-1)
                    o = o * alpha[..., None] + torch.einsum("krj,kjd->krd",
                                                            p, kt_v)
                    m = m_new
                out[b, :, tok, head] = o / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3, 4).to(q.dtype)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths: torch.Tensor, window: int = 0,
                  slopes: torch.Tensor | None = None) -> torch.Tensor:
    """See module docstring. Returns [N, T, K, G, D] in q's dtype."""
    if window < 0:
        raise ValueError(f"flash_prefill: window {window} < 0")
    if q.device.type == "cpu":
        return flash_prefill_reference(q, k, v, lengths, window, slopes)
    n, t, kh, g, d = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    for name, x in (("k", k), ("v", v), ("lengths", lengths)):
        if x.device != q.device:
            raise ValueError(f"flash_prefill: {name} on {x.device}, q on "
                             f"{q.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_prefill: q, k, v must share one of {DTYPES}, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if lengths.dtype != torch.int32 or lengths.shape != (n,):
        raise ValueError("flash_prefill: lengths must be int32 [N]")
    if k.shape != (n, t, kh, d) or v.shape != k.shape:
        raise ValueError(f"flash_prefill: k/v shape {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_prefill: head_dim {d} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and lengths.is_contiguous()):
        raise ValueError("flash_prefill: inputs must be contiguous")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_prefill: q, k, v must start on 16-byte "
                         "boundaries (the kernel's TMA loads)")
    if g > BLOCK_M:
        raise ValueError(f"flash_prefill: group {g} > {BLOCK_M}")
    gs, _ = row_tile(g, block_rows(d))
    if slopes is not None and (
            slopes.device != q.device or slopes.dtype != torch.float32
            or slopes.shape != (kh, g) or not slopes.is_contiguous()):
        raise ValueError(f"flash_prefill: slopes must be a contiguous "
                         f"float32 [{kh}, {g}] tensor on {q.device}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.library("flash_prefill")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = lib.tgi_flash_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            None if slopes is None else slopes.data_ptr(),
            out.data_ptr(), n, t, kh, g, gs, d, min(window, t),
            build.dtype_code(q.dtype), 1.0 / math.sqrt(d), stream)
    build.check("flash_prefill", code)
    flash_prefill.launches += 1
    if 0 < window < t:
        flash_prefill.windowed += 1
    if slopes is not None:
        flash_prefill.alibi += 1
    return out


flash_prefill.launches = 0
flash_prefill.windowed = 0
flash_prefill.alibi = 0
