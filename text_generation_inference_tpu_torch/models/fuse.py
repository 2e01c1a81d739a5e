"""Load-time matmul fusion: wq|wk|wv → w_qkv, w_gate|w_up → w_gu (port of
the dense branch of the JAX package's `models/fuse.py`).

Fewer, larger matmuls read weights in longer contiguous runs and halve the
kernel launches of the decode step (reference: flash_llama_modeling.py
fused gate_up). Quantized weights are a later slice.
"""

from __future__ import annotations

import torch

from .core import DecoderSpec


def _cat_out(ws: list) -> torch.Tensor:
    """Concatenate along the output axis (last dim; the layer stack leads)."""
    for w in ws:
        if not isinstance(w, torch.Tensor):
            raise NotImplementedError(
                f"fusing quantized weights ({type(w).__name__}) is not ported yet")
    return torch.cat(ws, dim=-1)


def fuse_params(spec: DecoderSpec, params: dict) -> dict:
    """Returns params with fused attention/MLP input projections (original
    keys removed). No-op when already fused."""
    lp = dict(params["layers"])
    if "wq" in lp:
        lp["w_qkv"] = _cat_out([lp.pop("wq"), lp.pop("wk"), lp.pop("wv")])
        if "bq" in lp:
            lp["b_qkv"] = torch.cat([lp.pop("bq"), lp.pop("bk"), lp.pop("bv")],
                                    dim=-1)
    if "w_gate" in lp:
        lp["w_gu"] = _cat_out([lp.pop("w_gate"), lp.pop("w_up")])
        if "b_gate" in lp:
            lp["b_gu"] = torch.cat([lp.pop("b_gate"), lp.pop("b_up")], dim=-1)
    out = dict(params)
    out["layers"] = lp
    return out
