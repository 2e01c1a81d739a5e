"""One-query decode attention over the slot KV cache: wrapper of
`csrc/slot_attention.cu` (entry `tgi_slot_decode`, kernel S1) and its plain
PyTorch version.

Counterpart of the JAX package's `ops/pallas/decode_attention.py`
(`decode_attention`, `decode_attention_reference`). Shapes:
  q:    [S, K, G, D]
  k, v: [S, K, T, D]   (one layer of the slot cache; any strides over S, K
                        and T, the head dim contiguous)
  ctx:  [S] int32      live cache rows per slot, the current token included
  out:  [S, K, G, D]   in q's dtype

A slot with ctx == 0 gives 0, as the JAX kernel does (it clamps the softmax
denominator at 1e-30); the JAX reference gives NaN there. Rows at or past
ctx are never read: the plain version zeroes their values before the value
product, the kernel does not load them.

`decode_attention` takes the plain version only for CPU tensors; for a CUDA
tensor it launches the kernel or raises. `decode_attention.launches` counts
launches. `launch_slot` is shared with `ring_decode_attention.py`.
"""

from __future__ import annotations

import math

import torch

from . import build

HEAD_DIMS = (64, 128)
MAX_GROUP = 8       # query heads per kv head the kernel handles
MAX_SPLITS = 32     # splits of T per (slot, kv head)
TILE_ROWS = 32      # cache rows a block stages at a time
_sm_count: dict = {}


def _masked_scores(q, k, v, ctx):
    """Scores [S, K, G, T] f32 (rows >= ctx at -inf) and values [S, K, T, D]
    f32 (rows >= ctx zeroed)."""
    d = q.shape[-1]
    t = k.shape[2]
    live = torch.arange(t, device=q.device)[None, :] < ctx.to(q.device)[:, None]
    scores = torch.einsum("skgd,sktd->skgt", q.to(torch.float32),
                          k.to(torch.float32)) * (1.0 / math.sqrt(d))
    scores = scores.masked_fill(~live[:, None, None, :], -math.inf)
    vf = torch.where(live[:, None, :, None], v.to(torch.float32), 0.0)
    return scores, vf


def decode_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               ctx: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 softmax over rows < ctx, acc / max(l, 1e-30)."""
    scores, vf = _masked_scores(q, k, v, ctx)
    m = torch.max(scores, dim=-1, keepdim=True).values
    m = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp(scores - m)                        # exp(-inf) = 0
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("skgt,sktd->skgd", p, vf) / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)


def check_cache(fn: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                ctx: torch.Tensor) -> None:
    """Raise unless q, the cache views and ctx are what the kernel takes."""
    s, kh, g, d = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    for name, x in (("k", k), ("v", v), ("ctx", ctx)):
        if x.device != q.device:
            raise ValueError(f"{fn}: {name} on {x.device}, q on {q.device}")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{fn}: q, k, v must be bfloat16, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if ctx.dtype != torch.int32 or ctx.shape != (s,) or not ctx.is_contiguous():
        raise ValueError(f"{fn}: ctx must be a contiguous int32 [S] tensor")
    if not q.is_contiguous():
        raise ValueError(f"{fn}: q must be contiguous")
    if (k.dim() != 4 or k.shape[:2] != (s, kh) or k.shape[3] != d
            or v.shape != k.shape or k.shape[2] == 0):
        raise ValueError(f"{fn}: cache {tuple(k.shape)} / {tuple(v.shape)} "
                         f"does not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS or g > MAX_GROUP:
        raise ValueError(f"{fn}: head_dim {d} (want {HEAD_DIMS}) or group {g} "
                         f"(want <= {MAX_GROUP}) not supported")
    # 16-byte row loads: the head dim contiguous, rows 16-byte aligned
    if (k.stride() != v.stride() or k.stride(3) != 1
            or any(st % 8 for st in k.stride()[:3])
            or k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError(f"{fn}: k and v need equal strides, a contiguous "
                         "head dim and 16-byte aligned rows")


def _splits(device: torch.device, blocks: int, t: int) -> tuple[int, int]:
    """(splits of T, rows per split): enough blocks for two per SM, no
    split under 256 rows; rows per split a multiple of the tile."""
    if device not in _sm_count:
        _sm_count[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    want = -(-2 * _sm_count[device] // blocks)
    splits = max(1, min(want, -(-t // 256), MAX_SPLITS))
    rows = -(-t // splits)
    rows = -(-rows // TILE_ROWS) * TILE_ROWS
    return -(-t // rows), rows


def launch_slot(entry: str, q, k, v, ctx, ring_args=(), ring_dims=()):
    """Launch one entry of `csrc/slot_attention.cu` on the current stream
    (checked inputs); returns out [S, K, G, D] bf16. The split scratch is
    allocated here."""
    s, kh, g, d = q.shape
    t = k.shape[2]
    splits, rows = _splits(q.device, s * kh, t)
    acc = torch.empty((s, kh, splits, g, d), dtype=torch.float32,
                      device=q.device)
    m = torch.empty((s, kh, splits, g), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    out = torch.empty_like(q)
    lib = build.library("slot_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ctx.data_ptr(),
            *[x.data_ptr() for x in ring_args], acc.data_ptr(), m.data_ptr(),
            l.data_ptr(), out.data_ptr(), s, kh, g, d, t, *k.stride()[:3],
            splits, rows, *ring_dims, 1.0 / math.sqrt(d), stream)
    build.check("slot_attention", code)
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     ctx: torch.Tensor) -> torch.Tensor:
    """See module docstring. Returns [S, K, G, D] in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, ctx)
    check_cache("decode_attention", q, k, v, ctx)
    if q.numel() == 0:
        return torch.empty_like(q)
    out = launch_slot("tgi_slot_decode", q, k, v, ctx)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
