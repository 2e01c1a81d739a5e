"""Serving entrypoint: load model → build engine → start batcher + servers
(port of the JAX package's `server/main.py`: a Llama-family decoder on the
paged engine, or on the slot engine with PAGED_ATTENTION=0; one device, no
speculator). A prompt-prefix store (PREFIX_STORE_PATH) serves soft prompts
by `prefix_id`; INT4_FUSED_MLP=1 runs a GPTQ model's decode MLP as one
kernel (the engines read it).

The other engine choices of the JAX entrypoint (speculative decoding,
tensor parallelism, multi-host, the internal `generate.v1` API, seq2seq
models) are later slices and raise NotImplementedError here.
"""

from __future__ import annotations

import asyncio
import logging
import os
import signal
from typing import Optional

import torch

from ..config import ServingConfig
from ..device import resolve_device
from ..engine.engine import InferenceEngine
from ..engine.paged_engine import PagedInferenceEngine
from ..models import families
from ..scheduler.batcher import Batcher
from ..utils.prompt_cache import PrefixCache
from ..utils.tokenization import ServingTokenizer
from .grpc_server import GenerationServicer, serve_grpc
from .http_server import serve_http

logger = logging.getLogger(__name__)

DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
}


def _not_ported(config: ServingConfig) -> None:
    """Raise for every serving option this slice does not run."""
    checks = [
        (bool(os.getenv("SPECULATOR_PATH"))
         or os.getenv("SPECULATOR", "").lower() in ("1", "true"),
         "speculative decoding"),
        (int(os.getenv("TENSOR_PARALLEL", "1")) > 1, "TENSOR_PARALLEL > 1"),
        (os.getenv("INTERNAL_API", "").lower() in ("1", "true"),
         "INTERNAL_API (generate.v1)"),
    ]
    for hit, what in checks:
        if hit:
            raise NotImplementedError(f"{what} is not ported yet")


def build_engine(config: ServingConfig, device=None):
    """Returns (engine, tokenizer, model_kind) on `device` (CUDA unless the
    caller asks for the CPU)."""
    _not_ported(config)
    device = resolve_device(device)
    dtype = DTYPES[config.dtype_str]
    logger.info("loading model %s (dtype=%s, device=%s)", config.model_name,
                config.dtype_str, device)
    hf_config = families.load_hf_config(config.model_name)
    tokenizer = ServingTokenizer.load(config.model_name)
    eos = tokenizer.eos_token_id
    if eos is None:
        eos = hf_config.get("eos_token_id")
    if eos is None:
        raise ValueError("cannot determine eos_token_id for model")
    spec, params = families.load_model(
        config.model_name, dtype=dtype, quantize=config.quantize,
        device=device)
    if os.getenv("PAGED_ATTENTION", "1").lower() in ("1", "true"):
        engine = PagedInferenceEngine(spec, params, config, eos_token_id=eos,
                                      device=device)
    else:
        engine = InferenceEngine(spec, params, config, eos_token_id=eos,
                                 device=device)
    return engine, tokenizer, "decoder"


def build_prompt_cache(config: ServingConfig,
                       hidden_size: int) -> Optional[PrefixCache]:
    """The soft-prompt store of PREFIX_STORE_PATH, or None without one."""
    if not config.prefix_store_path:
        return None
    return PrefixCache(config.prefix_store_path, embed_dim=hidden_size,
                       max_size_mb=config.prompt_cache_size_mb,
                       max_prefix_length=config.max_prompt_prefix_length)


async def async_serve(config: ServingConfig, device=None) -> None:
    from ..utils import tracing

    tracing.configure(config.otlp_endpoint, config.otlp_service_name)
    engine, tokenizer, model_kind = build_engine(config, device)
    prompt_cache = build_prompt_cache(config, engine.spec.hidden_size)
    if os.getenv("WARMUP", "1").lower() not in ("0", "false"):
        logger.info("warming up (set WARMUP=0 to skip)")
        engine.warmup()

    batcher = Batcher(engine, tokenizer, config, prompt_cache=prompt_cache)
    batcher.start()

    servicer = GenerationServicer(config, tokenizer, batcher, model_kind=model_kind)
    grpc_server = await serve_grpc(servicer, config)
    http_server = await serve_http(batcher, config.http_port)

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError):
            # RuntimeError when serving off the main thread (embedded use)
            pass
    logger.info("serving model=%s on gRPC :%d HTTP :%d (slots=%d, max_seq=%d)",
                config.model_name, config.grpc_port, config.http_port,
                config.max_batch_slots, config.max_sequence_length)
    await stop.wait()
    logger.info("shutting down")
    await grpc_server.stop(grace=5.0)
    http_server.close()
    await batcher.stop()


def serve(config: ServingConfig, device=None) -> None:
    logging.basicConfig(
        level=getattr(logging, config.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    try:
        asyncio.run(async_serve(config, device))
    except Exception as e:
        from ..utils.termination import write_termination_log

        write_termination_log(f"serving failed: {type(e).__name__}: {e}")
        raise
