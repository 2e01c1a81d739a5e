"""Offline GPTQ quantization (port of the JAX package's
`ops/quant/gptq_quantize.py`, the `quantize` CLI verb's backend).

GPTQ (Frantar et al. 2022) with the reference quantizer's artifact format
(reference: server/.../utils/gptq/quantize.py:152-359, 591-862): per-layer
Hessians from calibration activations, column-wise quantization with error
feedback through the upper Cholesky factor of the inverse Hessian,
optional act-order, and packed qweight / qzeros / scales / g_idx tensors
plus quantize_config.json.

`gptq_quantize_weight` is the JAX package's numpy solve in torch float64
on a `device` (the card by default; the CPU when asked): the same
operations in the same order, so the codes agree with the JAX package's
wherever float64 rounding does. `collect_hessians` and `quantize_model`
load the Hugging Face model through `transformers` (imported inside them)
and run it on the CPU, as the JAX package does. Calibration text comes
from a local file (one sample a line) or, failing that, random token
sequences from a seed: the machine has no network to fetch a dataset.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ...device import resolve_device
from .int4 import pack_cols, pack_rows


def gptq_quantize_weight(
    weight,                   # [out, in] float (torch layout)
    hessian,                  # [in, in] float: 2 * sum x x^T
    bits: int = 4,
    groupsize: int = 128,
    act_order: bool = False,
    percdamp: float = 0.01,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run GPTQ on one linear layer, in float64 on `device`.

    Returns (qweight_packed [in/8, out] int32, qzeros_packed [groups, out/8]
    int32, scales [groups, out] f32, g_idx [in] int32), on `device`."""
    device = resolve_device(device)
    f64 = torch.float64
    W = torch.as_tensor(weight).to(device=device, dtype=f64).clone()
    H = torch.as_tensor(hessian).to(device=device, dtype=f64).clone()
    out_f, in_f = W.shape
    maxq = (1 << bits) - 1

    dead = torch.diagonal(H) == 0
    H[dead, dead] = 1.0
    W[:, dead] = 0.0

    perm = None
    if act_order:
        perm = torch.argsort(-torch.diagonal(H), stable=True)
        W = W[:, perm]
        H = H[perm][:, perm]

    damp = percdamp * torch.mean(torch.diagonal(H))
    idx = torch.arange(in_f, device=device)
    H[idx, idx] += damp
    # upper Cholesky factor of H^-1 (as in the paper's implementation)
    Hinv = torch.linalg.cholesky(torch.linalg.inv(H)).T

    groups = in_f // groupsize
    scales = torch.zeros((groups, out_f), dtype=torch.float32, device=device)
    zeros = torch.zeros((groups, out_f), dtype=torch.int32, device=device)
    Q = torch.zeros_like(W)

    for g in range(groups):
        s, e = g * groupsize, (g + 1) * groupsize
        block = W[:, s:e]
        # per-group asymmetric scale / zero from the error-updated block
        wmax = torch.clamp(block.max(dim=1).values, min=0)
        wmin = torch.clamp(block.min(dim=1).values, max=0)
        scale = torch.clamp((wmax - wmin) / maxq, min=1e-8)
        zero = torch.clamp(torch.round(-wmin / scale), 0, maxq)
        scales[g] = scale.to(torch.float32)
        zeros[g] = zero.to(torch.int32)

        err_block = torch.zeros_like(block)
        for j in range(groupsize):
            col = s + j
            w = W[:, col]
            d = Hinv[col, col]
            q = torch.clamp(torch.round(w / scale) + zero, 0, maxq)
            Q[:, col] = q
            dq = (q - zero) * scale
            err = (w - dq) / d
            # error feedback into the rest of this group's columns
            W[:, col + 1:e] -= torch.outer(err, Hinv[col, col + 1:e])
            err_block[:, j] = err
        # the block's accumulated error into the later groups
        if e < in_f:
            W[:, e:] -= err_block @ Hinv[s:e, e:]

    g_idx = (torch.arange(in_f, device=device) // groupsize).to(torch.int32)
    if act_order:
        # back to the original column order; g_idx records the group of
        # each original input row (the checkpoint convention)
        inv = torch.argsort(perm)
        Q = Q[:, inv]
        g_idx = g_idx[inv]

    qweight = pack_rows(Q.T.to(torch.int32))           # [in/8, out]
    qzeros = pack_cols(zeros - 1)                      # [groups, out/8]
    return qweight, qzeros, scales, g_idx


def collect_hessians(model, samples: list[list[int]],
                     target_names: list[str]) -> dict[str, np.ndarray]:
    """H = 2 Σ x xᵀ for each target linear of a transformers model over the
    calibration samples (the model runs on the CPU)."""
    hessians: dict[str, np.ndarray] = {}
    hooks = []

    def make_hook(name):
        def hook(mod, inputs, output):
            x = inputs[0].detach().reshape(-1, inputs[0].shape[-1]).float()
            h = (2.0 * (x.T @ x)).numpy()
            if name in hessians:
                hessians[name] += h
            else:
                hessians[name] = h
        return hook

    mods = dict(model.named_modules())
    for name in target_names:
        hooks.append(mods[name].register_forward_hook(make_hook(name)))
    with torch.no_grad():
        for ids in samples:
            model(torch.tensor([ids], dtype=torch.long))
    for h in hooks:
        h.remove()
    return hessians


def quantize_model(model_path: str, output_dir: str, bits: int = 4,
                   groupsize: int = 128, calibration: str = "synthetic",
                   num_samples: int = 16, seq_len: int = 512,
                   act_order: bool = False, device=None) -> None:
    """Quantize every decoder linear layer of a Hugging Face causal LM to
    GPTQ INT4 and save a checkpoint the loaders read (and AutoGPTQ does).
    The model and its Hessians run on the CPU; each linear's solve runs on
    `device` (the card unless the caller asks for the CPU)."""
    from safetensors.torch import save_file
    from transformers import AutoModelForCausalLM, AutoTokenizer

    model = AutoModelForCausalLM.from_pretrained(
        model_path, torch_dtype=torch.float32).eval()
    cfg = model.config

    rng = np.random.default_rng(0)
    cal_path = Path(calibration)
    samples: list[list[int]] = []
    if cal_path.is_file():
        tok = AutoTokenizer.from_pretrained(model_path)
        for line in cal_path.read_text().splitlines()[:num_samples]:
            ids = tok.encode(line)[:seq_len]
            if len(ids) >= 8:
                samples.append(ids)
    if not samples:
        samples = [rng.integers(0, cfg.vocab_size, size=seq_len).tolist()
                   for _ in range(num_samples)]

    target_names = [
        name for name, mod in model.named_modules()
        if isinstance(mod, torch.nn.Linear) and "lm_head" not in name
        and mod.in_features % groupsize == 0 and mod.in_features % 8 == 0
        and mod.out_features % 8 == 0
    ]
    hessians = collect_hessians(model, samples, target_names)

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    state: dict = {}
    mods = dict(model.named_modules())
    quant_prefixes = set(target_names)
    for name, tensor in model.state_dict().items():
        owner = name.rsplit(".", 1)[0]
        if owner in quant_prefixes and name.endswith(".weight"):
            continue
        state[name] = tensor.contiguous()

    for name in target_names:
        w = mods[name].weight.detach()
        qweight, qzeros, scales, g_idx = gptq_quantize_weight(
            w, hessians[name], bits=bits, groupsize=groupsize,
            act_order=act_order, device=device)
        state[f"{name}.qweight"] = qweight.cpu()
        state[f"{name}.qzeros"] = qzeros.cpu()
        state[f"{name}.scales"] = scales.cpu()
        state[f"{name}.g_idx"] = g_idx.cpu()
        print(f"quantized {name}: {tuple(w.shape)}")

    save_file(state, out / "model.safetensors")
    (out / "quantize_config.json").write_text(json.dumps({
        "bits": bits, "group_size": groupsize, "desc_act": act_order,
        "quant_method": "gptq", "sym": False,
    }, indent=2))
    src = Path(model_path)
    for f in ("config.json", "tokenizer.json", "tokenizer_config.json",
              "special_tokens_map.json"):
        if (src / f).exists():
            (out / f).write_bytes((src / f).read_bytes())
    print(f"wrote GPTQ checkpoint to {out}")
