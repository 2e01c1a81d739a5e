"""Serving configuration (the PyTorch port's own copy of the JAX package's
`config.py`; the port imports nothing from that package).

Every field is overridable from the environment, keeping the reference's
flag/env contract where it still makes sense on TPU (reference:
launcher/src/main.rs:36-96 defines the CLI/env surface; the python shard
reads ~40 plain env vars). Defaults follow the reference's defaults
(reference: launcher/src/main.rs:53-67, server/text_generation_server/cli.py:25-28).

TPU-specific knobs (slot count, prefill buckets, KV page size) replace the
reference's GPU memory-characterization machinery: HBM use on TPU is
analytically predictable from static shapes, so capacity planning is exact
rather than empirically fitted.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env_int(name: str, default: int) -> int:
    v = os.getenv(name)
    return int(v) if v not in (None, "") else default


def _env_float(name: str, default: float) -> float:
    v = os.getenv(name)
    return float(v) if v not in (None, "") else default


def _env_str(name: str, default: str) -> str:
    v = os.getenv(name)
    return v if v not in (None, "") else default


def _env_bool(name: str, default: bool) -> bool:
    v = os.getenv(name)
    if v in (None, ""):
        return default
    return v.lower() in ("1", "true", "yes", "on")


def _env_int_list(name: str, default: list[int]) -> list[int]:
    v = os.getenv(name)
    if v in (None, ""):
        return list(default)
    return [int(x) for x in v.split(",") if x.strip()]


# Default prefill length buckets: powers of two. Each distinct bucket is one
# XLA compilation of the prefill step; the scheduler pads prompts up to the
# smallest bucket that fits (the TPU replacement for the reference's
# PT2-compile shape-grid warmup, reference: server/.../utils/warmup.py).
_DEFAULT_PREFILL_BUCKETS = [16, 32, 64, 128, 256, 512, 1024, 2048]


@dataclass
class ServingConfig:
    # --- model ---
    model_name: str = ""                      # path or HF id of the model
    revision: str | None = None
    dtype_str: str = "bfloat16"               # compute dtype on TPU
    quantize: str | None = None               # None | "gptq" | "int8" |
                                              # "int8-outliers"/"bitsandbytes"
                                              # (LLM.int8 static decomposition)
    model_kind: str = "decoder"               # "decoder" | "encoder_decoder"

    # --- request/API limits (reference: launcher/src/main.rs:53-67) ---
    max_sequence_length: int = 2048           # prompt + output tokens
    max_new_tokens: int = 1024
    max_batch_size: int = 12                  # max per client Generate call
    max_concurrent_requests: int = 512
    max_waiting_tokens: int = 24              # decode steps to wait before
                                              # forcing an add-on prefill
    max_prefill_padding: float = 0.2          # max wasted fraction in a
                                              # prefill bucket batch
    default_include_stop_seqs: bool = True
    default_max_new_tokens: int = 20          # when request leaves it 0

    # --- engine shape budget (TPU static-shape plan) ---
    max_batch_slots: int = 16                 # decode-step width; one
                                              # compilation serves all loads
    max_prefill_batch: int = 8                # max requests per prefill
                                              # dispatch, and the warmup
                                              # grid's rows; rows x bucket is
                                              # capped at max_prefill_tokens
                                              # (the largest bucket), which
                                              # bounds the activation peak
    decode_chunk: int = 1                     # decode steps per device
                                              # dispatch; >1 amortizes host
                                              # sync (tokens arrive in bursts
                                              # of this size when streaming)
    stream_decode_chunk: int = 8              # chunk used while any active
                                              # request is streaming (keeps
                                              # inter-token latency ~chunk
                                              # steps instead of decode_chunk;
                                              # 0 disables the adaptation)
    fuse_matmuls: bool = True                 # fuse qkv / gate-up projections
                                              # (single-device model axis only)
    decode_write_mode: str = "ring"           # "ring" | "post" | "scan" KV
                                              # write strategy; ring = per-
                                              # chunk buffer + one scatter
                                              # (fastest, models/core.py)
    prefill_buckets: list[int] = field(
        default_factory=lambda: list(_DEFAULT_PREFILL_BUCKETS))
    decode_ctx_buckets: list[int] | None = None
                                              # context buckets for ring
                                              # decode: each chunk reads only
                                              # the smallest bucket covering
                                              # every live context (dead-KV
                                              # DMA skipped); None = derive
                                              # 256,512,... up to max_seq
    kv_cache_dtype: str = "auto"              # "auto" (param dtype) | "int8"
                                              # int8 = symmetric per-token-
                                              # per-head KV quantization:
                                              # halves decode attention's HBM
                                              # reads AND doubles KV capacity
                                              # (ring decode path only)
    kv_page_size: int = 128                   # tokens per KV page (paged cache)
    paged_gather_ctx_max: int = 1024          # paged ring decode: context
                                              # buckets up to this many tokens
                                              # gather their live pages into a
                                              # dense per-chunk view and run
                                              # the slot engine's XLA
                                              # attention (no per-layer kernel
                                              # launches); larger buckets use
                                              # the Pallas paged kernel.
                                              # 0 = kernel always. Costs a
                                              # transient dense KV copy,
                                              # budgeted by the pool sizer.
    hbm_memory_fraction: float = 0.9          # cap of free HBM given to KV
    batch_safety_margin: float = 0.2          # reference default 20%

    # --- prompt-tuning prefix store (reference: prompt_cache.py) ---
    prefix_store_path: str | None = None
    prompt_cache_size_mb: int = 512
    max_prompt_prefix_length: int = 256

    # --- serving endpoints ---
    grpc_port: int = 8033
    http_port: int = 3000
    uds_path: str | None = None               # serve on unix socket instead
    tls_cert_path: str | None = None
    tls_key_path: str | None = None

    # --- observability ---
    metrics_enabled: bool = True
    log_level: str = "INFO"
    otlp_endpoint: str | None = None          # OTLP/HTTP collector base URL
                                              # (reference: --otlp-endpoint)
    otlp_service_name: str = "text-generation-inference-tpu"

    # --- misc ---
    seed_bits: int = 32                       # random seeds are 32-bit like
                                              # the reference (validation.rs:168-177)
    tokenizer_threads: int = 4

    @classmethod
    def from_env(cls, **overrides) -> "ServingConfig":
        cfg = cls(
            model_name=_env_str("MODEL_NAME", ""),
            revision=os.getenv("REVISION") or None,
            dtype_str=_env_str("DTYPE_STR", "bfloat16"),
            quantize=os.getenv("QUANTIZE") or None,
            max_sequence_length=_env_int("MAX_SEQUENCE_LENGTH", 2048),
            max_new_tokens=_env_int("MAX_NEW_TOKENS", 1024),
            max_batch_size=_env_int("MAX_BATCH_SIZE", 12),
            max_concurrent_requests=_env_int("MAX_CONCURRENT_REQUESTS", 512),
            max_waiting_tokens=_env_int("MAX_WAITING_TOKENS", 24),
            max_prefill_padding=_env_float("MAX_PREFILL_PADDING", 0.2),
            default_include_stop_seqs=_env_bool("DEFAULT_INCLUDE_STOP_SEQS", True),
            max_batch_slots=_env_int("MAX_BATCH_SLOTS", 16),
            max_prefill_batch=_env_int("MAX_PREFILL_BATCH", 8),
            decode_chunk=_env_int("DECODE_CHUNK", 1),
            stream_decode_chunk=_env_int("STREAM_DECODE_CHUNK", 8),
            fuse_matmuls=_env_bool("FUSE_MATMULS", True),
            decode_write_mode=_env_str("DECODE_WRITE_MODE", "ring"),
            prefill_buckets=_env_int_list("PREFILL_BUCKETS", _DEFAULT_PREFILL_BUCKETS),
            decode_ctx_buckets=(
                _env_int_list("DECODE_CTX_BUCKETS", [])
                if os.getenv("DECODE_CTX_BUCKETS") else None),
            kv_cache_dtype=_env_str("KV_CACHE_DTYPE", "auto"),
            kv_page_size=_env_int("KV_PAGE_SIZE", 128),
            paged_gather_ctx_max=_env_int("PAGED_GATHER_CTX_MAX", 1024),
            hbm_memory_fraction=_env_float("HBM_MEMORY_FRACTION", 0.9),
            batch_safety_margin=_env_float("BATCH_SAFETY_MARGIN", 0.2),
            prefix_store_path=os.getenv("PREFIX_STORE_PATH") or None,
            prompt_cache_size_mb=_env_int("PROMPT_CACHE_SIZE_MB", 512),
            max_prompt_prefix_length=_env_int("MAX_PROMPT_PREFIX_LENGTH", 256),
            grpc_port=_env_int("GRPC_PORT", 8033),
            http_port=_env_int("HTTP_PORT", 3000),
            uds_path=os.getenv("UDS_PATH") or None,
            tls_cert_path=os.getenv("TLS_CERT_PATH") or None,
            tls_key_path=os.getenv("TLS_KEY_PATH") or None,
            metrics_enabled=_env_bool("METRICS_ENABLED", True),
            log_level=_env_str("LOG_LEVEL", "INFO"),
            otlp_endpoint=os.getenv("OTLP_ENDPOINT") or None,
            otlp_service_name=_env_str(
                "OTLP_SERVICE_NAME", "text-generation-inference-tpu"),
            tokenizer_threads=_env_int("TOKENIZER_THREADS", 4),
        )
        for k, v in overrides.items():
            setattr(cfg, k, v)
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if self.max_new_tokens > self.max_sequence_length:
            raise ValueError("max_new_tokens cannot exceed max_sequence_length")
        if not self.prefill_buckets:
            raise ValueError("prefill_buckets must be non-empty")
        self.prefill_buckets = sorted(set(self.prefill_buckets))
        if self.prefill_buckets[-1] < self.max_sequence_length:
            self.prefill_buckets.append(self.max_sequence_length)
        if self.decode_ctx_buckets is None:
            # derive the ring-decode context ladder: 128, 256, 512, ...
            # capped by max_seq (one compiled decode program per bucket ×
            # details-variant; 128 keeps the program count small while the
            # sub-128 regime is already near the compute floor)
            ladder, b = [], 128
            while b < self.max_sequence_length:
                ladder.append(b)
                b *= 2
            ladder.append(self.max_sequence_length)
            self.decode_ctx_buckets = ladder
        else:
            self.decode_ctx_buckets = sorted(
                {min(b, self.max_sequence_length)
                 for b in self.decode_ctx_buckets if b > 0})
            if (not self.decode_ctx_buckets
                    or self.decode_ctx_buckets[-1] < self.max_sequence_length):
                self.decode_ctx_buckets.append(self.max_sequence_length)
        if self.kv_cache_dtype not in ("auto", "int8"):
            raise ValueError("kv_cache_dtype must be 'auto' or 'int8'")
        if self.kv_page_size < 8 or self.kv_page_size % 8:
            # pages are the paged-attention kernel's KV block rows: TPU
            # tiling needs a multiple of the 8-row sublane
            raise ValueError("kv_page_size must be a positive multiple of 8")
        if not 0.0 <= self.max_prefill_padding <= 1.0:
            raise ValueError("max_prefill_padding must be in [0, 1]")
        if self.max_batch_slots < 1:
            raise ValueError("max_batch_slots must be >= 1")

    @property
    def max_prefill_tokens(self) -> int:
        """Padded tokens (rows x bucket) one prefill dispatch may hold: one
        row at the largest bucket, the working set the memory plan counts
        (`engine.memory.activation_bytes`). The batcher caps each dispatch
        at it, and warmup skips the (rows, bucket) pairs past it."""
        return self.prefill_buckets[-1]

    def bucket_for(self, length: int) -> int:
        """Smallest prefill bucket that holds `length` tokens."""
        for b in self.prefill_buckets:
            if b >= length:
                return b
        raise ValueError(
            f"length {length} exceeds largest prefill bucket {self.prefill_buckets[-1]}")
