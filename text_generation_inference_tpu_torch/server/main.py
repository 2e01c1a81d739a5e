"""Serving entrypoint: load model → build engine → start batcher + servers
(port of the JAX package's `server/main.py`: a t5 / mt5 / umt5 checkpoint on
the seq2seq engine; any decoder family of `models/families.py`, or a model
type its structural fallback takes, on the paged engine, or on the slot
engine with PAGED_ATTENTION=0; one device). SPECULATOR=1 (a random-init
speculator) or SPECULATOR_PATH (an fms_extras MLPSpeculator checkpoint)
serves a decoder with speculative decoding, on the paged engine
(`PagedSpeculativeEngine`) or with PAGED_ATTENTION=0 on the slot engine
(`SpeculativeEngine`); SPECULATOR_N_PREDICT sets a random speculator's
draft count. A prompt-prefix store (PREFIX_STORE_PATH) serves soft
prompts by `prefix_id` (encoder- and decoder-side for seq2seq models);
INT4_FUSED_MLP=1 runs a GPTQ model's decode MLP as one kernel (the engines
read it). QUANTIZE=int8, int8-outliers or bitsandbytes quantizes a decoder's
layer linears at load (`models/families.py`), gptq requires GPTQ tensors.

INTERNAL_API=1 serves the reference's internal router↔shard API,
generate.v1 (`server/internal_server.py`), instead of fmaas, on UDS_PATH
or GRPC_PORT, with the prompt-prefix store; it refuses an int8 KV cache.

Tensor parallelism and multi-host serving (`parallel/`): TENSOR_PARALLEL
ranks (default: every local card of every host; 1 on the CPU) under the
JAX package's multi-host env (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
JAX_PROCESS_ID; `parallel/launch.py`). `serve` starts one process per
local card; each loads the model, keeps its shard, and warms up. Rank 0
serves, on either gRPC surface, through a `ReplicatedEngine`; the other
ranks replay its engine ops (`parallel/multihost.py`). As in the JAX
entrypoint, a t5 checkpoint is served unsharded (one rank a host), and the
slot engine's speculative decoding refuses TENSOR_PARALLEL > 1.
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


SEQ2SEQ_TYPES = ("t5", "mt5", "umt5")


def internal_api() -> bool:
    return os.getenv("INTERNAL_API", "").lower() in ("1", "true")


def build_engine(config: ServingConfig, device=None, tp=None):
    """Returns (engine, tokenizer, model_kind) on `device` (CUDA unless the
    caller asks for the CPU); dispatches decoder-only vs encoder-decoder
    (the reference's get_model dispatch, models/__init__.py:48-136). With
    `tp` (a `parallel.comm.TPGroup`) a decoder's engine holds the rank's
    shard: the model loads on the CPU and the engine moves its shard to
    `device`; a t5 checkpoint is built whole, as the JAX entrypoint builds
    it before making its mesh."""
    if internal_api():
        from .internal_server import refuse_int8_kv

        refuse_int8_kv(config)
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
    if hf_config.get("model_type") in SEQ2SEQ_TYPES:
        from ..engine.seq2seq import Seq2SeqEngine
        from ..models import t5
        from ..utils.weights import Weights

        spec = t5.spec_from_hf_config(hf_config)
        params = t5.load_params(Weights(config.model_name), spec, dtype,
                                device)
        engine = Seq2SeqEngine(spec, params, config, eos_token_id=eos,
                               device=device)
        return engine, tokenizer, "encoder_decoder"
    paged = os.getenv("PAGED_ATTENTION", "1").lower() in ("1", "true")
    spec_path = os.getenv("SPECULATOR_PATH")
    speculate = spec_path or os.getenv("SPECULATOR", "").lower() in (
        "1", "true")
    if speculate and not paged and tp is not None and tp.world > 1:
        raise ValueError(
            "SPECULATOR with PAGED_ATTENTION=0 (slot engine) does not "
            "support TENSOR_PARALLEL>1; use the paged speculative engine or "
            "TENSOR_PARALLEL=1")
    spec, params = families.load_model(
        config.model_name, dtype=dtype, quantize=config.quantize,
        device="cpu" if tp is not None else device)
    if speculate:
        engine = _speculative_engine(spec, params, config, eos, dtype, device,
                                     paged, spec_path, tp)
    elif paged:
        engine = PagedInferenceEngine(spec, params, config, eos_token_id=eos,
                                      device=device, tp=tp)
    else:
        engine = InferenceEngine(spec, params, config, eos_token_id=eos,
                                 device=device, tp=tp)
    return engine, tokenizer, "decoder"


def _speculative_engine(spec, params, config: ServingConfig, eos: int, dtype,
                        device, paged: bool, spec_path: Optional[str],
                        tp=None):
    """The JAX entrypoint's speculator dispatch: SPECULATOR_PATH loads a
    trained fms_extras MLPSpeculator (the weights the reference consumes)
    and must match the model's width and vocabulary; bare SPECULATOR=1
    builds a random-init one, which by the exactness invariant can only
    slow serving. Under `tp` the paged engine shards the model and keeps
    the speculator whole on every rank."""
    from ..engine.speculative import (PagedSpeculativeEngine,
                                      SpeculativeEngine)

    n_predict = int(os.getenv("SPECULATOR_N_PREDICT", "3"))
    sspec = sparams = None
    if spec_path:
        from ..models.speculator import load_speculator

        sspec, sparams = load_speculator(spec_path, dtype=dtype,
                                         device=device)
        if sspec.model_dim != spec.hidden_size \
                or sspec.vocab_size != spec.vocab_size:
            raise ValueError(
                f"speculator at {spec_path} does not match the model: "
                f"model_dim {sspec.model_dim} vs hidden {spec.hidden_size}, "
                f"vocab {sspec.vocab_size} vs {spec.vocab_size}")
        n_predict = sspec.n_predict
        logger.info("loaded speculator from %s (n_predict=%d, inner_dim=%d)",
                    spec_path, n_predict, sspec.inner_dim)
    else:
        logger.warning(
            "SPECULATOR=1 without SPECULATOR_PATH builds a RANDOM-INIT "
            "speculator: output stays exact but acceptance will be ~zero, "
            "making serving strictly slower. Point SPECULATOR_PATH at a "
            "trained MLPSpeculator checkpoint.")
    kw = dict(eos_token_id=eos, speculator_spec=sspec,
              speculator_params=sparams, n_predict=n_predict, device=device)
    if paged:
        return PagedSpeculativeEngine(spec, params, config, tp=tp, **kw)
    return SpeculativeEngine(spec, params, config, **kw)


def build_prompt_cache(config: ServingConfig,
                       hidden_size: int) -> Optional[PrefixCache]:
    """The soft-prompt store of PREFIX_STORE_PATH, or None without one."""
    if not config.prefix_store_path:
        return None
    return PrefixCache(config.prefix_store_path, embed_dim=hidden_size,
                       max_size_mb=config.prompt_cache_size_mb,
                       max_prefix_length=config.max_prompt_prefix_length)


async def async_serve(config: ServingConfig, device=None, tp=None,
                      channel=None) -> None:
    """Serve until SIGINT / SIGTERM. With `tp` and `channel` (a rank's
    groups, `parallel.launch.init_rank`), rank 0 serves through a
    `ReplicatedEngine` and every other rank replays its ops until it
    stops."""
    from ..utils import tracing

    tracing.configure(config.otlp_endpoint, config.otlp_service_name)
    engine, tokenizer, model_kind = build_engine(config, device, tp)
    prompt_cache = build_prompt_cache(config, engine.spec.hidden_size)
    if os.getenv("WARMUP", "1").lower() not in ("0", "false"):
        logger.info("warming up (set WARMUP=0 to skip)")
        engine.warmup()
        # the JAX server logs its compiles here; on the card each decode
        # program is one captured CUDA graph (with WARMUP=0 they are
        # captured before the first prefill instead)
        programs = engine.programs
        logger.info("decode programs: %d %s in %.1fs", len(programs),
                    "captured as CUDA graphs" if programs.capture
                    else "made (eager step functions)", programs.seconds)
    if channel is not None and channel.world > 1:
        from ..parallel import multihost

        if channel.rank != 0:
            logger.info("rank %d replaying rank 0's engine ops",
                        channel.rank)
            await asyncio.get_running_loop().run_in_executor(
                None, multihost.follower_loop, engine, channel)
            return
        engine = multihost.ReplicatedEngine(engine, channel)
        logger.info("rank 0 serving for %d ranks", channel.world)
    try:
        await _serve_surfaces(config, engine, tokenizer, model_kind,
                              prompt_cache)
    finally:
        if hasattr(engine, "shutdown"):
            engine.shutdown()   # release the followers (OP_STOP)


async def _serve_surfaces(config: ServingConfig, engine, tokenizer,
                          model_kind: str, prompt_cache) -> None:
    """fmaas (the Batcher, gRPC and HTTP) or, with INTERNAL_API=1,
    generate.v1 over `engine`, until SIGINT / SIGTERM."""
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError):
            # RuntimeError when serving off the main thread (embedded use)
            pass

    if internal_api():
        # the reference's internal router↔shard surface instead of fmaas:
        # this process is then a drop-in shard for the reference's router
        from .internal_server import (InternalTextGenerationService,
                                      serve_internal_grpc)

        servicer = InternalTextGenerationService(
            engine, tokenizer, config, prompt_cache=prompt_cache,
            model_kind=model_kind)
        grpc_server = await serve_internal_grpc(servicer, config)
        logger.info("serving generate.v1 internal API for model=%s",
                    config.model_name)
        await stop.wait()
        await grpc_server.stop(grace=5.0)
        return

    batcher = Batcher(engine, tokenizer, config, prompt_cache=prompt_cache)
    batcher.start()

    servicer = GenerationServicer(config, tokenizer, batcher, model_kind=model_kind)
    grpc_server = await serve_grpc(servicer, config)
    http_server = await serve_http(batcher, config.http_port)

    logger.info("serving model=%s on gRPC :%d HTTP :%d (slots=%d, max_seq=%d)",
                config.model_name, config.grpc_port, config.http_port,
                config.max_batch_slots, config.max_sequence_length)
    await stop.wait()
    logger.info("shutting down")
    await grpc_server.stop(grace=5.0)
    http_server.close()
    await batcher.stop()


def serve(config: ServingConfig, device=None) -> None:
    """Serve on `device`, or with TENSOR_PARALLEL > 1 (or a multi-host env)
    one process per card of this host (`parallel.launch`)."""
    from ..parallel import launch

    _logging(config)
    dev_type = resolve_device(device).type
    lay = launch.layout(dev_type)
    if families.load_hf_config(config.model_name).get("model_type") \
            in SEQ2SEQ_TYPES and lay.per_host > 1:
        # served whole, as the JAX entrypoint serves it: one rank a host
        logger.info("a t5 checkpoint is served unsharded: one rank a host")
        lay = launch.Layout(world=lay.world // lay.per_host, per_host=1,
                            host=lay.host, coordinator=lay.coordinator)
    if lay.world == 1:
        _run(config, device)
        return
    logger.info("starting %d of %d ranks (host %d, group at %s)",
                lay.per_host, lay.world, lay.host, lay.coordinator)
    launch.spawn(_serve_rank, lay, config, dev_type)


def _serve_rank(rank: int, local: int, lay, config: ServingConfig,
                dev_type: str) -> None:
    """One rank of `serve`: its card, its groups, then `async_serve`."""
    from ..parallel import launch

    _logging(config)
    device = torch.device("cuda", local) if dev_type == "cuda" else "cpu"
    if dev_type == "cuda":
        torch.cuda.set_device(device)
    tp, channel = launch.init_rank(rank, lay.world, lay.coordinator,
                                   "nccl" if dev_type == "cuda" else "gloo")
    _run(config, device, tp, channel)


def _logging(config: ServingConfig) -> None:
    logging.basicConfig(
        level=getattr(logging, config.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(processName)s %(name)s "
               "%(message)s")


def _run(config: ServingConfig, device, tp=None, channel=None) -> None:
    try:
        asyncio.run(async_serve(config, device, tp, channel))
    except Exception as e:
        from ..utils.termination import write_termination_log

        write_termination_log(f"serving failed: {type(e).__name__}: {e}")
        raise
