"""GPTQ INT4 weight representation and its plain dequant path (port of the
JAX package's `ops/quant/int4.py`).

Storage layout is the GPTQ checkpoint format (AutoGPTQ / exllama):

  qweight [in/8, out] int32 — eight 4-bit rows packed little-endian per word
  qzeros  [groups, out/8] int32 — packed 4-bit zero-points, stored with the
          GPTQ "-1" bias: the true zero-point is packed + 1
  scales  [groups, out] f32
  g_idx   [in] int32 — row → group map (non-trivial under act-order)

dequant: W[i, j] = scales[g_idx[i], j] * (unpack(qweight)[i, j]
                                          - unpack(qzeros)[g_idx[i], j] - 1)
       = q * scale - zbias, with zbias = (zero + 1) * scale precomputed.

Layer-stacked weights carry a leading layer axis on every field. The TPU-only
layouts of the JAX package (native s4 `q4`, lane-major `qlane`, blocked
`sc_b`/`zb_b`, `mlp_sc_b`/`mlp_zb_b`) are not ported: the CUDA kernel
(`ops/cuda/int4_matmul.py`) reads the GPTQ packing directly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class Int4Weight(NamedTuple):
    """A NamedTuple of tensors, so `engine.memory.tree_bytes` counts it."""

    qweight: torch.Tensor            # [(L,) in/8, out] int32, group-sequential rows
    qzeros: torch.Tensor             # [(L,) groups, out/8] int32
    scales: torch.Tensor             # [(L,) groups, out] f32
    g_idx: torch.Tensor              # [(L,) in] int32 (sequential after normalization)
    # act-order input permutation: x is gathered as x[..., perm] before the
    # product; None for checkpoints without act-order
    perm: Optional[torch.Tensor] = None
    zbias: Optional[torch.Tensor] = None   # (zero + 1) * scale, [(L,) groups, out] f32

    @property
    def in_features(self) -> int:
        return self.qweight.shape[-2] * 8

    @property
    def out_features(self) -> int:
        return self.qweight.shape[-1]

    @property
    def groupsize(self) -> int:
        return self.in_features // self.scales.shape[-2]

    def layer(self, i: int) -> "Int4Weight":
        """Layer i of a layer-stacked weight: views, no copy."""
        return Int4Weight(*(None if f is None else f[i] for f in self))


_SHIFTS = 4 * torch.arange(8, dtype=torch.int32)


def unpack_rows(packed: torch.Tensor) -> torch.Tensor:
    """[..., n/8, m] int32 → [..., n, m] int32 of 4-bit values (row-packed).
    Masking after the (arithmetic) shift reads each nibble unsigned."""
    u = (packed.unsqueeze(-2) >> _SHIFTS.to(packed.device)[:, None]) & 0xF
    return u.reshape(*packed.shape[:-2], packed.shape[-2] * 8, packed.shape[-1])


def unpack_cols(packed: torch.Tensor) -> torch.Tensor:
    """[..., n, m/8] int32 → [..., n, m] int32 of 4-bit values (column-packed)."""
    u = (packed.unsqueeze(-1) >> _SHIFTS.to(packed.device)) & 0xF
    return u.reshape(*packed.shape[:-1], packed.shape[-1] * 8)


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit words held in int64 → int32 with two's-complement wrap."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def pack_rows(q: torch.Tensor) -> torch.Tensor:
    """[in, out] 4-bit values → [in/8, out] int32."""
    in_f, out_f = q.shape
    q = (q.to(torch.int64) & 0xF).reshape(in_f // 8, 8, out_f)
    shifts = _SHIFTS.to(device=q.device, dtype=torch.int64)[None, :, None]
    return _to_int32((q << shifts).sum(dim=1))


def pack_cols(q: torch.Tensor) -> torch.Tensor:
    """[groups, out] 4-bit values → [groups, out/8] int32."""
    g, out_f = q.shape
    q = (q.to(torch.int64) & 0xF).reshape(g, out_f // 8, 8)
    shifts = _SHIFTS.to(device=q.device, dtype=torch.int64)[None, None, :]
    return _to_int32((q << shifts).sum(dim=2))


def compute_zbias(w: Int4Weight) -> Int4Weight:
    """Populate zbias = (zero + 1) * scale, the kernel's zero term."""
    zeros = unpack_cols(w.qzeros) + 1
    return w._replace(zbias=zeros.to(torch.float32) * w.scales.to(torch.float32))


def normalize_act_order(qweight: torch.Tensor, qzeros: torch.Tensor,
                        scales: torch.Tensor, g_idx: torch.Tensor) -> Int4Weight:
    """Convert a raw GPTQ checkpoint (possibly act-order) into the
    group-sequential layout the kernel expects, hoisting the row shuffle
    into a one-time input permutation."""
    in_f = g_idx.shape[0]
    groupsize = in_f // scales.shape[0]
    expected = (torch.arange(in_f, device=g_idx.device) // groupsize).to(torch.int32)
    g_idx = g_idx.to(torch.int32)
    if torch.equal(g_idx, expected):
        return compute_zbias(Int4Weight(qweight=qweight, qzeros=qzeros,
                                        scales=scales, g_idx=g_idx))
    # stable sort of the rows by group: perm[r] = original row index
    perm = torch.argsort(g_idx, stable=True).to(torch.int32)
    q = unpack_rows(qweight)[perm.long()]
    return compute_zbias(Int4Weight(qweight=pack_rows(q), qzeros=qzeros,
                                    scales=scales, g_idx=expected, perm=perm))


def is_sequential_gidx(w: Int4Weight) -> bool:
    """True when every row's group is row // groupsize (no act-order
    shuffle left in g_idx)."""
    expected = torch.arange(w.in_features, device=w.g_idx.device) // w.groupsize
    return bool(torch.all(w.g_idx == expected))


def dequantize(w: Int4Weight, dtype=torch.float32) -> torch.Tensor:
    """Full-precision [in, out] weight: (q - zero - 1) * scale, as the JAX
    package's `dequantize`."""
    q = unpack_rows(w.qweight)
    zeros = unpack_cols(w.qzeros) + 1
    g = w.g_idx.long()
    z = zeros[g]
    s = w.scales.to(torch.float32)[g]
    return ((q - z).to(torch.float32) * s).to(dtype)


def matmul_dequant(x: torch.Tensor, w: Int4Weight) -> torch.Tensor:
    """x @ dequant(w) in x's dtype (the JAX package's XLA path)."""
    return torch.matmul(x, dequantize(w, x.dtype))


def quantize_rtn(weight, groupsize: int = 128) -> Int4Weight:
    """Round-to-nearest groupwise INT4 quantization of a [in, out] float
    weight (numpy or torch; for the tests)."""
    w = np.asarray(weight, np.float32)
    in_f, out_f = w.shape
    if in_f % groupsize or in_f % 8 or out_f % 8:
        raise ValueError(f"shape {w.shape} does not pack with groupsize "
                         f"{groupsize}")
    groups = in_f // groupsize
    w = w.reshape(groups, groupsize, out_f)
    wmax = w.max(axis=1)
    wmin = w.min(axis=1)
    scale = np.maximum((wmax - wmin) / 15.0, 1e-8)          # [groups, out]
    zero = np.clip(np.round(-wmin / scale), 0, 15).astype(np.int32)
    q = np.round(w / scale[:, None, :]) + zero[:, None, :]
    q = np.clip(q, 0, 15).astype(np.int32).reshape(in_f, out_f)
    return compute_zbias(Int4Weight(
        qweight=pack_rows(torch.from_numpy(q)),
        qzeros=pack_cols(torch.from_numpy(zero - 1)),
        scales=torch.from_numpy(scale.astype(np.float32)),
        g_idx=torch.from_numpy((np.arange(in_f) // groupsize).astype(np.int32))))


def quantize_stacked_rtn(weight, groupsize: int = 128) -> Int4Weight:
    """[(L,) in, out] float → (layer-stacked) Int4Weight, per-layer RTN."""
    w = np.asarray(weight, np.float32)
    if w.ndim == 2:
        return quantize_rtn(w, groupsize)
    per = [quantize_rtn(w[i], groupsize) for i in range(w.shape[0])]
    return Int4Weight(*(torch.stack([p[f] for p in per]) if per[0][f] is not None
                        else None for f in range(len(Int4Weight._fields))))
