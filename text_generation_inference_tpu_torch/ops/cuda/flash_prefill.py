"""Causal flash attention for prefill buckets: wrapper of
`csrc/flash_prefill.cu` and its plain PyTorch version.

Counterpart of the JAX package's `ops/pallas/flash_prefill.py`
(`flash_prefill`, `flash_prefill_reference`). Shapes: q [N, T, K, G, D],
k/v [N, T, K, D], lengths [N] → out like q. Keys j are visible to query i
when j <= i and j < lengths[n]; rows with lengths[n] == 0 give 0.

`flash_prefill_tiled_reference` is the plain twin of the kernel's schedule:
row tiles of BLOCK_M rows (row = token * G + g) in two halves of 64 (the
kernel's consumer warpgroups), key tiles of `key_tile(d)` keys (128, or 64
at head dims 192 and 256), each half walking key tiles up to its causal and
length limit and masking only the tiles that cross its diagonal or the
length.

bf16 and fp16 run on the wgmma kernel; fp32 runs on the source's fp32
kernel, mma.sync on the tensor cores in 3xTF32 (the JAX kernel computes in
f32): every operand is split into two TF32 terms, hi = rna(x) and lo =
rna(x - hi), and each product is lo.hi + hi.lo + hi.hi with fp32 sums.
`flash_prefill_tf32x3_reference` is the plain twin of that arithmetic over
its key tiles (`f32_key_tile(d)`: 64 keys, 32 at head dims 192 and 256).

`flash_prefill` takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises. `flash_prefill.launches`
counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from . import build

HEAD_DIMS = (64, 128, 192, 256)   # head dims the kernel is compiled for
# element types it is built for
DTYPES = (torch.bfloat16, torch.float16, torch.float32)
BLOCK_M = 128           # rows (token * G + g) a block of the kernel takes
BLOCK_N = 128           # keys a tile of the kernel up to head dim 128


def key_tile(d: int) -> int:
    """Keys a tile of the wgmma kernel at head dim d: 64 past 128, where
    the Q tile leaves no room for two stages of 128-key K and V tiles."""
    return BLOCK_N if d <= 128 else 64


def f32_key_tile(d: int) -> int:
    """Keys a tile of the fp32 kernel at head dim d."""
    return 64 if d <= 128 else 32


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero (`cvt.rna.tf32.f32`)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _product_3xtf32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum(eq, a, b) as the fp32 kernel computes it: a and b split into
    TF32 hi and lo terms, lo.hi + hi.lo + hi.hi."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def flash_prefill_tf32x3_reference(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor,
                                   lengths: torch.Tensor) -> torch.Tensor:
    """Plain twin of the fp32 kernel's arithmetic (f32 inputs and output):
    rows token * G + g, key tiles of `f32_key_tile(d)` keys in order, both
    products in 3xTF32, the online softmax in exp2 units, keys at or past
    the length read as 0. A tile the kernel skips for a row (wholly above
    its diagonal or past the length) is fully masked here, which leaves the
    row's state as it was."""
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
    tok = torch.arange(t * g, device=q.device) // g
    m = torch.full((n, kh, t * g), -math.inf, device=q.device)
    l = torch.zeros((n, kh, t * g), device=q.device)
    o = torch.zeros((n, kh, t * g, d), device=q.device)
    ln = lengths.to(q.device).clamp(0, t)
    for key0 in range(0, int(ln.max()) if n else 0, tile):
        keys = torch.arange(key0, key0 + tile, device=q.device)
        sc = _product_3xtf32("nkrd,nkjd->nkrj", qf,
                             kf[:, :, key0:key0 + tile])
        vis = ((keys[None, :] <= tok[:, None])[None]
               & (keys[None, None, :] < ln[:, None, None]))     # [N, R, J]
        sc = torch.where(vis[:, None], sc, -math.inf)
        m_new = torch.maximum(m, sc.max(dim=-1).values * scale_log2)
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        alpha = torch.exp2(m - m_safe)
        p = torch.exp2(sc * scale_log2 - m_safe[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + _product_3xtf32(
            "nkrj,nkjd->nkrd", p, vf[:, :, key0:key0 + tile])
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(n, kh, t, g, d).permute(0, 2, 1, 3, 4).contiguous()


def flash_prefill_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (fp32 math, output in q's dtype)."""
    n, t, kh, g, d = q.shape
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("nqkgd,nvkd->nkgqv", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    pos = torch.arange(t, device=q.device)
    causal = pos[None, :] <= pos[:, None]                       # [Tq, Tk]
    key_valid = pos[None, :] < lengths.to(q.device)[:, None]    # [N, Tk]
    mask = causal[None] & key_valid[:, None, :]                 # [N, Tq, Tk]
    scores = scores.masked_fill(~mask[:, None, None], -math.inf)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)    # rows with no visible key
    vf = torch.where(key_valid[:, :, None, None], v.to(torch.float32), 0.0)
    out = torch.einsum("nkgqv,nvkd->nqkgd", probs, vf)
    return out.to(q.dtype)


def flash_prefill_tiled_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, lengths: torch.Tensor,
                                  block_m: int = BLOCK_M,
                                  block_n: int | None = None) -> torch.Tensor:
    """Plain twin of the kernel's schedule (fp32 math, output in q's dtype):
    online softmax in exp2 units over the key tiles a half row tile walks,
    masks only on the tiles that cross the half's diagonal or the length,
    dead value rows zeroed on the length-edge tile."""
    n, t, kh, g, d = q.shape
    block_n = block_n or key_tile(d)
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    rows_q = q.to(torch.float32).permute(0, 2, 1, 3, 4).reshape(n, kh, t * g, d)
    kf = k.to(torch.float32).permute(0, 2, 1, 3)                # [N, K, T, D]
    vf = v.to(torch.float32).permute(0, 2, 1, 3)
    pad = (-t) % block_n            # tiles past T read zeros
    kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
    vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
    out = torch.zeros_like(rows_q)
    tpb = block_m // g              # tokens a row tile
    half = block_m // 2
    for b in range(n):
        ln = max(0, min(int(lengths[b]), t))
        for tok0 in range(0, t, tpb):
            rows = tpb * g
            tok_last = min(tok0 + tpb - 1, t - 1)
            last_tile = min(tok_last // block_n, -(-ln // block_n) - 1)
            for r_wg in range(0, block_m, half):
                r = torch.arange(r_wg, min(r_wg + half, rows))
                if r.numel() == 0:
                    continue
                first_tok = tok0 + r_wg // g
                last_tok = tok0 + int(r[-1]) // g
                tok = tok0 + r // g
                keep = tok < t
                r, tok = r[keep], tok[keep]
                qs = rows_q[b, :, tok0 * g + r]                 # [K, R, D]
                m = torch.full((kh, r.numel()), -math.inf)
                l = torch.zeros((kh, r.numel()))
                o = torch.zeros((kh, r.numel(), d))
                for kt in range(last_tile + 1):
                    key0 = kt * block_n
                    if key0 > last_tok:      # wholly above the diagonal
                        continue
                    keys = torch.arange(key0, key0 + block_n)
                    kt_k = kf[b, :, key0:key0 + block_n]
                    kt_v = vf[b, :, key0:key0 + block_n]
                    if key0 + block_n > ln:  # the length-edge tile
                        kt_v = torch.where((keys < ln)[:, None], kt_v, 0.0)
                    sc = torch.einsum("krd,kjd->krj", qs, kt_k) * scale_log2
                    if key0 + block_n > min(first_tok + 1, ln):
                        vis = (keys[None, :] <= tok[:, None]) & (keys < ln)
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
                out[b, :, tok0 * g + r] = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(n, kh, t, g, d).permute(0, 2, 1, 3, 4).to(q.dtype)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """See module docstring. Returns [N, T, K, G, D] in q's dtype."""
    if q.device.type == "cpu":
        return flash_prefill_reference(q, k, v, lengths)
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
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.library("flash_prefill")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = lib.tgi_flash_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), n, t, kh, g, d, build.dtype_code(q.dtype),
            1.0 / math.sqrt(d), stream)
    build.check("flash_prefill", code)
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
