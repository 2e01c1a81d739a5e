"""Causal flash attention for prefill buckets: wrapper of
`csrc/flash_prefill.cu` and its plain PyTorch version.

Counterpart of the JAX package's `ops/pallas/flash_prefill.py`
(`flash_prefill`, `flash_prefill_reference`). Shapes: q [N, T, K, G, D],
k/v [N, T, K, D], lengths [N] → out like q. Keys j are visible to query i
when j <= i and j < lengths[n]; rows with lengths[n] == 0 give 0.

`flash_prefill` takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises. `flash_prefill.launches`
counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from . import build

HEAD_DIMS = (64, 128)   # head dims the kernel is compiled for


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
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_prefill: q, k, v must be bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
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
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.library("flash_prefill")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = lib.tgi_flash_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), n, t, kh, g, d, 1.0 / math.sqrt(d), stream)
    build.check("flash_prefill", code)
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
