"""text_generation_inference_tpu_torch — the PyTorch / CUDA port of the
serving framework, for NVIDIA Hopper (H100).

It mirrors the module layout of the JAX package (which stays the
reference) so each counterpart sits at the same relative
path. The port imports `torch` and never `jax`, and nothing of the JAX
package: it keeps its own copies of the host-side modules.

  server/     gRPC (fmaas, and generate.v1 under INTERNAL_API) + HTTP
              front-end, request validation
  scheduler/  continuous-batching queue and batcher loop
  engine/     paged inference engine, paged KV pool, sampling
  models/     the RoPE decoders (`core.py`, `paged_core.py`), loader
  ops/        attention dispatch, linear layers (dense, GPTQ-INT4, int8),
              quantization and calibration tools, CUDA kernel wrappers
  csrc/       hand-written CUDA C++ kernels for sm_90a
  utils/      detokenizer, tokenizer, metrics, tracing, weights loader

Entry points run on `cuda` unless the caller passes `device="cpu"`; they
raise when CUDA is missing rather than fall back silently (`device.py`).
"""

__version__ = "0.1.0"
