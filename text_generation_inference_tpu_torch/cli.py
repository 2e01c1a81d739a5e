"""Command-line interface of the PyTorch port (the JAX package's verbs
but `download-weights`, which only fetches from the hub):

    python -m text_generation_inference_tpu_torch.cli serve MODEL_DIR [--device cuda]
    python -m text_generation_inference_tpu_torch.cli quantize MODEL_DIR OUT_DIR [--device cuda]
    python -m text_generation_inference_tpu_torch.cli convert-to-safetensors MODEL_DIR
    python -m text_generation_inference_tpu_torch.cli convert-to-fast-tokenizer MODEL_DIR

`serve` starts one process per rank when `TENSOR_PARALLEL` (default: every
local CUDA card; 1 on the CPU) or the multi-host env asks for more than one
(`parallel/launch.py`).

`quantize` (GPTQ, `ops/quant/gptq_quantize.py`) and
`convert-to-fast-tokenizer` import `transformers`; `quantize` runs the
model on the CPU and each linear's solve on `--device`.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def cmd_serve(args) -> None:
    from .config import ServingConfig
    from .server.main import serve

    config = ServingConfig.from_env(
        **{k: v for k, v in {
            "model_name": args.model_name,
            "grpc_port": args.grpc_port,
            "http_port": args.http_port,
            "uds_path": args.uds_path,
            "dtype_str": args.dtype,
        }.items() if v is not None})
    if not config.model_name:
        sys.exit("error: MODEL_NAME or positional model_name required")
    serve(config, device=args.device)


def cmd_convert_to_safetensors(args) -> None:
    """Convert torch .bin checkpoints to safetensors, keeping the first name
    of tensors that share storage (reference: server/.../utils/convert.py:
    13-60)."""
    import torch
    from safetensors.torch import save_file

    model_dir = Path(args.model_path)
    bins = sorted(model_dir.glob("pytorch_model*.bin"))
    if not bins:
        sys.exit(f"no pytorch_model*.bin files in {model_dir}")
    for b in bins:
        state = torch.load(b, map_location="cpu", weights_only=True)
        seen: dict[int, str] = {}
        out = {}
        for name, tensor in state.items():
            ptr = tensor.data_ptr()
            if ptr in seen and tensor.numel() > 0:
                continue
            seen[ptr] = name
            out[name] = tensor.contiguous()
        target = b.with_name(b.name.replace("pytorch_model", "model")
                             .replace(".bin", ".safetensors"))
        save_file(out, target)
        print(f"wrote {target}")


def cmd_convert_to_fast_tokenizer(args) -> None:
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(args.model_path, use_fast=True)
    out = Path(args.output_path or args.model_path)
    tok.save_pretrained(out)
    print(f"wrote fast tokenizer to {out}")


def cmd_quantize(args) -> None:
    from .ops.quant.gptq_quantize import quantize_model

    quantize_model(
        model_path=args.model_path,
        output_dir=args.output_dir,
        bits=args.bits,
        groupsize=args.groupsize,
        calibration=args.dataset,
        num_samples=args.num_samples,
        device=args.device,
    )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="text-generation-server-torch")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("serve", help="start the serving process")
    s.add_argument("model_name", nargs="?", default=None)
    s.add_argument("--grpc-port", type=int, default=None)
    s.add_argument("--http-port", type=int, default=None)
    s.add_argument("--uds-path", default=None)
    s.add_argument("--dtype", default=None,
                   choices=["bfloat16", "float16", "float32"])
    s.add_argument("--device", default="cuda",
                   help="torch device to serve on (default: cuda)")
    s.set_defaults(fn=cmd_serve)

    c = sub.add_parser("convert-to-safetensors",
                       help="convert .bin checkpoints to .safetensors")
    c.add_argument("model_path")
    c.set_defaults(fn=cmd_convert_to_safetensors)

    t = sub.add_parser("convert-to-fast-tokenizer")
    t.add_argument("model_path")
    t.add_argument("--output-path", default=None)
    t.set_defaults(fn=cmd_convert_to_fast_tokenizer)

    q = sub.add_parser("quantize", help="GPTQ-quantize a model offline")
    q.add_argument("model_path")
    q.add_argument("output_dir")
    q.add_argument("--bits", type=int, default=4)
    q.add_argument("--groupsize", type=int, default=128)
    q.add_argument("--dataset", default="wikitext2")
    q.add_argument("--num-samples", type=int, default=128)
    q.add_argument("--device", default="cuda",
                   help="torch device for the GPTQ solve (default: cuda)")
    q.set_defaults(fn=cmd_quantize)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
