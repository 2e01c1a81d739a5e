"""Command-line interface of the PyTorch port: `serve` (the other verbs of
the JAX package's CLI are later slices).

    python -m text_generation_inference_tpu_torch.cli serve MODEL_DIR [--device cuda]
"""

from __future__ import annotations

import argparse
import sys


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

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
