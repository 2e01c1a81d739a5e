"""MLP speculator: the draft-token proposer of speculative decoding (port of
the JAX package's `models/speculator.py`).

IBM's MLPSpeculator, the one the reference's paged speculative path uses
(weights from fms_extras): for each of `n_predict` draft positions the
state is updated from the previous state and the embedding of the previous
(drafted) token, then a head gives logits:

  state_0   = the model's final-norm hidden state at the last token
  state_i+1 = GELU_tanh( LN( state_i @ W_state_i + emb_i[tok_i] ) )
  logits_i  = state_i+1 @ head_i

Parameters are a dict of per-position lists (`emb`, `w_state`, `ln_scale`,
`ln_bias`, `head`), the JAX package's layout. `load_speculator` reads an
fms_extras checkpoint; `init_speculator` draws random weights from an
explicit `torch.Generator` (tests, benches, `SPECULATOR=1`).

The head product runs in the speculator's dtype, then f32, as the port's
decoders compute their logits (the JAX package asks for an f32 product;
equal in fp32). A draft only changes how many tokens a step accepts,
never which tokens are emitted.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import torch
import torch.nn.functional as F

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class SpeculatorSpec:
    vocab_size: int
    model_dim: int          # hidden size of the base model
    inner_dim: int
    n_predict: int = 3


def init_speculator(spec: SpeculatorSpec, generator: torch.Generator,
                    dtype=torch.float32) -> dict:
    """Random weights on the generator's device: normal draws scaled by
    1/sqrt(fan_in) (embeddings 0.02), unit LayerNorm scales, zero biases,
    the JAX package's init rule."""
    device = generator.device

    def dense(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    n = spec.n_predict
    return {
        "emb": [dense((spec.vocab_size, spec.inner_dim), 0.02)
                for _ in range(n)],
        "w_state": [dense((spec.model_dim if i == 0 else spec.inner_dim,
                           spec.inner_dim)) for i in range(n)],
        "ln_scale": [torch.ones(spec.inner_dim, dtype=dtype, device=device)
                     for _ in range(n)],
        "ln_bias": [torch.zeros(spec.inner_dim, dtype=dtype, device=device)
                    for _ in range(n)],
        "head": [dense((spec.inner_dim, spec.vocab_size)) for _ in range(n)],
    }


def propose(spec: SpeculatorSpec, params: dict, hidden: torch.Tensor,
            first_token: torch.Tensor) -> torch.Tensor:
    """Greedy draft proposals: hidden [S, model_dim], first_token [S] →
    [S, n_predict] int32 draft ids. No host synchronisation (a speculative
    step is captured)."""
    state = hidden
    tok = first_token.long()
    out = []
    for i in range(spec.n_predict):
        z = torch.matmul(state, params["w_state"][i]) + params["emb"][i][tok]
        zf = z.to(torch.float32)
        mean = torch.mean(zf, dim=-1, keepdim=True)
        var = torch.var(zf, dim=-1, keepdim=True, unbiased=False)
        zf = (zf - mean) * torch.rsqrt(var + 1e-6)
        z = (zf * params["ln_scale"][i].to(torch.float32)
             + params["ln_bias"][i].to(torch.float32)).to(z.dtype)
        state = F.gelu(z, approximate="tanh")
        logits = torch.matmul(state, params["head"][i]).to(torch.float32)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    return torch.stack(out, dim=1).to(torch.int32)


def load_speculator(path: str, dtype=torch.bfloat16, device=None
                    ) -> tuple[SpeculatorSpec, dict]:
    """Load an fms_extras MLPSpeculator checkpoint (the weights the
    reference consumes): tensors `emb.{i}.weight`, `proj.{i}.weight` and
    `head.{i}.weight` (both [out, in], transposed here), `ln.{i}.weight` /
    `.bias`, and a config.json with `n_predict`, `inner_dim` and `emb_dim`
    or `model_dim`."""
    from ..utils.weights import Weights

    device = resolve_device(device)
    p = Path(path)
    cfg = json.loads((p / "config.json").read_text())
    w = Weights(p)
    n_predict = cfg.get("n_predict", 3)
    spec = SpeculatorSpec(
        vocab_size=cfg["vocab_size"],
        model_dim=cfg.get("emb_dim") or cfg["model_dim"],
        inner_dim=int(cfg.get("inner_dim") or cfg["model_dim"]),
        n_predict=n_predict,
    )

    def get(name, transpose=False):
        t = w.get(name)
        if transpose:
            t = t.t()
        return t.contiguous().to(device=device, dtype=dtype)

    n = range(n_predict)
    params = {
        "emb": [get(f"emb.{i}.weight") for i in n],
        "w_state": [get(f"proj.{i}.weight", True) for i in n],
        "ln_scale": [get(f"ln.{i}.weight") for i in n],
        "ln_bias": [get(f"ln.{i}.bias") for i in n],
        "head": [get(f"head.{i}.weight", True) for i in n],
    }
    return spec, params


def accept_longest_prefix(draft: torch.Tensor, verified: torch.Tensor
                          ) -> torch.Tensor:
    """Accepted draft tokens per slot: draft [S, K] against the model's own
    choice at each draft position, verified [S, K]; the longest agreeing
    prefix (the reference's accept-longest-match). Returns [S] int32."""
    agree = (draft == verified).to(torch.int32)
    return torch.cumprod(agree, dim=1).sum(dim=1).to(torch.int32)
