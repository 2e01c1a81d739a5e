"""Load-time matmul fusion: wq|wk|wv → w_qkv, w_gate|w_up → w_gu (port of
the JAX package's `models/fuse.py`: dense, GPTQ-INT4 and INT8 weights).

Fewer, larger matmuls read weights in longer contiguous runs and halve the
kernel launches of the decode step (reference: flash_llama_modeling.py
fused gate_up). GPTQ-INT4 weights fuse too: qweight, qzeros, scales and
zbias all concatenate along the output axis. Never under act-order, where
the projections' input permutations may differ: those stay separate. INT8
weights concatenate their codes and scales (and outlier rows); outlier
weights fuse only where their `outlier_idx` agree (co-located projections
share their input, so calibration gives them the same set, but fusing
different sets would mis-route features), as the JAX package decides.
"""

from __future__ import annotations

import torch

from ..ops.quant.int4 import Int4Weight
from ..ops.quant.int8 import Int8OutlierWeight, Int8Weight
from .core import DecoderSpec


def _can_fuse(ws: list) -> bool:
    if len({type(w) for w in ws}) != 1:
        return False
    if isinstance(ws[0], Int8OutlierWeight):
        return all(w.q.shape[:-1] == ws[0].q.shape[:-1]
                   and torch.equal(w.outlier_idx, ws[0].outlier_idx)
                   for w in ws)
    if isinstance(ws[0], Int8Weight):
        return all(w.q.shape[:-1] == ws[0].q.shape[:-1] for w in ws)
    if isinstance(ws[0], Int4Weight):
        g = ws[0]
        return all(w.perm is None and w.zbias is not None
                   and w.qweight.shape[:-1] == g.qweight.shape[:-1]
                   and w.scales.shape[:-1] == g.scales.shape[:-1]
                   for w in ws)
    return isinstance(ws[0], torch.Tensor)


def _cat_out(ws: list):
    """Concatenate along the output axis (last dim; the layer stack leads)."""
    if isinstance(ws[0], Int8OutlierWeight):
        return Int8OutlierWeight(
            q=torch.cat([w.q for w in ws], dim=-1),
            scale=torch.cat([w.scale for w in ws], dim=-1),
            outlier_idx=ws[0].outlier_idx,
            outlier_w=torch.cat([w.outlier_w for w in ws], dim=-1))
    if isinstance(ws[0], Int8Weight):
        return Int8Weight(q=torch.cat([w.q for w in ws], dim=-1),
                          scale=torch.cat([w.scale for w in ws], dim=-1))
    if isinstance(ws[0], Int4Weight):
        return Int4Weight(
            qweight=torch.cat([w.qweight for w in ws], dim=-1),
            qzeros=torch.cat([w.qzeros for w in ws], dim=-1),
            scales=torch.cat([w.scales for w in ws], dim=-1),
            g_idx=ws[0].g_idx,
            zbias=torch.cat([w.zbias for w in ws], dim=-1))
    return torch.cat(ws, dim=-1)


def fuse_params(spec: DecoderSpec, params: dict) -> dict:
    """Returns params with fused attention/MLP input projections (original
    keys removed). No-op when already fused or not fusable."""
    lp = dict(params["layers"])
    if "wq" in lp and _can_fuse([lp["wq"], lp["wk"], lp["wv"]]):
        lp["w_qkv"] = _cat_out([lp.pop("wq"), lp.pop("wk"), lp.pop("wv")])
        if "bq" in lp:
            lp["b_qkv"] = torch.cat([lp.pop("bq"), lp.pop("bk"), lp.pop("bv")],
                                    dim=-1)
    if "w_gate" in lp and _can_fuse([lp["w_gate"], lp["w_up"]]):
        lp["w_gu"] = _cat_out([lp.pop("w_gate"), lp.pop("w_up")])
        if "b_gate" in lp:
            lp["b_gu"] = torch.cat([lp.pop("b_gate"), lp.pop("b_up")], dim=-1)
    out = dict(params)
    out["layers"] = lp
    return out
