"""Device memory accounting (port of the JAX package's `engine/memory.py`).

`budget_bytes` is the memory an engine plans against: the card's total
memory from `torch.cuda.mem_get_info`, or `CPU_BUDGET_BYTES` for an engine
on the CPU (tests). The paged engine sizes its KV pool from it
(`MemoryPlan` with `pool_bytes`); `plan_memory` sizes the slot engine's
batch (closed-form accounting: every serving buffer has a static shape, so
capacity is arithmetic, not measurement). Both set aside the engine's one
graph pool (`MemoryPlan.graph_pool_bytes`): on the card every prefill and
decode program is a CUDA graph whose working set lives in one memory pool
that the engine keeps for good, at most the larger of `activation_bytes`,
the prefill working set of one dispatch, and `decode_bytes`, the working
set of the largest decode program (eager, the same term bounds the
transient, since prefill and decode dispatches run one at a time). A
speculative engine also sets aside `speculative_bytes`, its speculator's
weights and the working set of one verify step. Int8 weights add
`quant_transient_bytes`: the port converts a layer's int8 codes to a bf16
copy for each product, which XLA never materializes (it converts on
read).

ESTIMATE_MEMORY=off disables the slot engine's slot shrinking (reference
env contract).
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch

from ..config import ServingConfig
from ..models.core import DecoderSpec
from ..ops.quant.int8 import Int8OutlierWeight, Int8Weight
from .sampling import DETAILS_ROWS, TOP_N_CAP

logger = logging.getLogger(__name__)

# memory assumed for an engine on the CPU: the figure the JAX package
# assumes when its backend reports no device memory
CPU_BUDGET_BYTES = 16 * 1024 ** 3


def tree_bytes(tree) -> int:
    """Bytes held by every tensor in a nested dict / list / tuple. NamedTuple
    leaves such as `Int4Weight` are tuples, so their packed words, scales,
    zero terms and permutations count (None fields count 0)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def device_hbm_bytes(device=None) -> int:
    """Total memory of the target CUDA device. Raises on a machine without
    CUDA: there is no device memory to plan against."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"device_hbm_bytes: {device} is not a CUDA device")
    _free, total = torch.cuda.mem_get_info(device)
    return int(total)


def budget_bytes(device: torch.device) -> int:
    """The memory an engine on `device` plans against."""
    if device.type == "cuda":
        return device_hbm_bytes(device)
    return CPU_BUDGET_BYTES


def kv_row_bytes(spec: DecoderSpec, dtype) -> int:
    """KV bytes of one token position across layers, kv heads, k and v:
    head_dim values, plus 4 scale bytes per (layer, kv head) for k and for
    v when the cache is int8."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    scale_b = 4 if dtype == torch.int8 else 0
    return (spec.num_layers * 2 * spec.num_kv_heads
            * (spec.head_dim * itemsize + scale_b))


# bytes a (position, vocab entry) of a prefill holds at its peak: the f32
# logits (4) beside the bf16 product they are cast from (2) or one f32 copy
# of them (4: the lm_head bias add, or prompt details' log-softmax)
LOGIT_BYTES = 10
# bytes a (position, vocab entry) of one pass of `sampling.
# prompt_token_details` holds: log-softmax (4), a rank mask (1) and the
# stable sort's values, int64 indices and scratch (12 + 12), rounded up
DETAILS_BYTES = 32


def activation_bytes(spec: DecoderSpec, config: ServingConfig) -> int:
    """Transient prefill working set of one dispatch: `max_prefill_tokens`
    padded tokens (the batcher's cap: one row at the largest bucket, or
    several at smaller buckets), with
      - the activations, as the JAX plan counts them: hidden and MLP
        intermediates in f32, T * (6 D + 3 I) * 4 bytes;
      - the all-position logits: T * V * LOGIT_BYTES (the f32 logits and
        the copy `prefill_forward` or `_finish_prefill` makes of them);
      - one pass of prompt details, `DETAILS_ROWS` positions at a time
        over all rows of the dispatch: DETAILS_ROWS * V * DETAILS_BYTES;
      - where prefill attention takes the einsum (a head dim that is not a
        multiple of 64), its f32 scores, masked copy, probabilities and
        their cast: T * T * H * 14.
    The JAX plan counts T * V * 4 bytes of logits for one row at the
    largest bucket and no more; its batcher then sends up to
    max_prefill_batch such rows. The port counts what a dispatch holds and
    caps the dispatch (by design: see ROADMAP.md, Queue 3, F4)."""
    t = config.max_prefill_tokens
    act = t * (spec.hidden_size * 6 + spec.intermediate_size * 3) * 4
    act += t * spec.vocab_size * LOGIT_BYTES
    act += min(t, DETAILS_ROWS) * spec.vocab_size * DETAILS_BYTES
    if spec.head_dim % 64:
        act += t * t * spec.num_heads * 14
    return act


def quant_transient_bytes(params: dict, config: ServingConfig) -> int:
    """What the largest int8 product of a dispatch holds beside the
    activations: the bf16 copy of one layer's codes that `quant.int8`
    converts for the product (in * out * 2), and for an outlier weight the
    gather of its K outlier features over `max_prefill_tokens` rows (in x's
    dtype and its bf16 cast) and that product's f32 term [T, out]. 0 for a
    model without int8 weights."""
    t = config.max_prefill_tokens
    x_item = params["embed_tokens"].element_size()
    need = 0
    for w in params.get("layers", {}).values():
        if not isinstance(w, (Int8Weight, Int8OutlierWeight)):
            continue
        b = w.in_features * w.out_features * 2
        if isinstance(w, Int8OutlierWeight):
            b += (t * w.outlier_idx.shape[-1] * (x_item + 2)
                  + t * w.out_features * 4)
        need = max(need, b)
    return need


@dataclasses.dataclass
class MemoryPlan:
    param_bytes: int
    kv_bytes_per_slot: int
    state_bytes: int
    activation_bytes: int       # transient prefill working set estimate
    hbm_bytes: int
    usable_bytes: int
    max_slots: int
    pool_bytes: int | None = None   # the paged engine's page pool
    # a speculative engine's speculator weights and verify working set
    speculative_bytes: int = 0
    # the largest int8 product's transient (`quant_transient_bytes`)
    quant_bytes: int = 0
    # the largest decode program's working set (`decode_bytes`)
    decode_bytes: int = 0

    @property
    def graph_pool_bytes(self) -> int:
        """The engine's one graph pool (prefill and decode programs), or on
        an eager engine the transient of one dispatch: the larger working
        set of the two."""
        return max(self.activation_bytes, self.decode_bytes)

    def describe(self) -> str:
        gb = 1024 ** 3
        kv = (f"pool {self.pool_bytes / gb:.2f}GiB" if self.pool_bytes
              is not None else f"kv/slot {self.kv_bytes_per_slot / gb:.3f}"
              f"GiB x {self.max_slots}")
        spec = (f" + speculative {self.speculative_bytes / gb:.2f}GiB"
                if self.speculative_bytes else "")
        quant = (f" + int8 transient {self.quant_bytes / gb:.2f}GiB"
                 if self.quant_bytes else "")
        return (f"params {self.param_bytes / gb:.2f}GiB + {kv} + graph pool "
                f"{self.graph_pool_bytes / gb:.2f}GiB (the larger of prefill "
                f"{self.activation_bytes / gb:.2f}GiB and decode "
                f"{self.decode_bytes / gb:.2f}GiB){spec}{quant} of "
                f"{self.hbm_bytes / gb:.1f}GiB")


# bytes a (slot, vocab entry) of one sampling pass (`sampling.next_tokens`)
# holds at its peak: the f32 scores and their penalized and warped copies
# (12), the sort's values, int64 indices and scratch (4 + 8 + 12), the
# softmax and its cumulative sum (8), rounded up
SAMPLING_BYTES = 48


def decode_bytes(spec: DecoderSpec, config: ServingConfig,
                 dtype: torch.dtype, gather_bytes: int = 0) -> int:
    """The working set of the largest decode program: a chunk of
    `decode_chunk` steps over `max_batch_slots` slots S, each step's
    activations freed before the next, with
      - one step's activations in f32, S * (6 D + 3 I) * 4 bytes (the
        prefill count at S rows);
      - one step's logits and sampling pass: S * V * (LOGIT_BYTES +
        SAMPLING_BYTES);
      - the chunk's k and v ring buffers, [L, S, K, chunk, D] each in
        `dtype` (the model's), and its packed outputs, [chunk, S, 3 + 3
        TOP_N_CAP] f32 (`sampling.pack_step_outputs`);
      - `gather_bytes`: the paged engine's dense-gather view of the live
        pages (k and v of `paged_gather_ctx_max` rows a slot)."""
    s, chunk = config.max_batch_slots, max(1, config.decode_chunk)
    item = torch.empty((), dtype=dtype).element_size()
    work = s * (spec.hidden_size * 6 + spec.intermediate_size * 3) * 4
    work += s * spec.vocab_size * (LOGIT_BYTES + SAMPLING_BYTES)
    work += 2 * (spec.num_layers * s * spec.num_kv_heads * chunk
                 * spec.head_dim * item)
    work += chunk * s * (3 + 3 * TOP_N_CAP) * 4
    return work + gather_bytes


def speculative_bytes(spec: DecoderSpec, config: ServingConfig,
                      sspec, dtype: torch.dtype, gathered: bool) -> int:
    """What a speculative engine holds beside the plain one: the
    speculator's weights (`sspec`, in `dtype`) and the working set of one
    verify step over `config.max_batch_slots` slots and C = n_predict + 1
    candidates, at max_seq rows (whole pages of them with `gathered`):
      - with `gathered` (the paged engine), one layer's K and V gathered
        from the pool, the chunk's rows written into them;
      - the f32 keys the f32 scores read, counted twice (the upcast, and
        as much again for the allocator's rounding and the products'
        workspace);
      - the scores [S, H, C, rows] in f32, their masked copy, the f32
        probabilities and their cast;
      - the [S, C, V] f32 logits beside the product they are cast from,
        and one sampling pass over [S, V] (the C passes run in turn)."""
    item = torch.empty((), dtype=dtype).element_size()
    i, v, n = sspec.inner_dim, sspec.vocab_size, sspec.n_predict
    weights = (2 * n * v * i + sspec.model_dim * i + (n - 1) * i * i
               + 2 * n * i) * item
    s, c = config.max_batch_slots, n + 1
    rows = config.max_sequence_length
    if gathered:
        rows = -(-rows // config.kv_page_size) * config.kv_page_size
    kv = s * spec.num_kv_heads * rows * spec.head_dim
    work = 2 * kv * 4
    if gathered:
        work += 2 * kv * item
    work += s * spec.num_heads * c * rows * (3 * 4 + item)
    work += s * c * spec.vocab_size * (4 + item)
    work += s * spec.vocab_size * SAMPLING_BYTES
    return weights + work


def plan_memory(spec: DecoderSpec, config: ServingConfig, params,
                cache_dtype: torch.dtype, hbm_bytes: int,
                spec_bytes: int = 0) -> MemoryPlan:
    """The slot engine's memory plan: unless ESTIMATE_MEMORY=off, shrink
    `config.max_batch_slots` in place to the slots whose full-length KV
    cache fits beside the weights, the graph pool (the larger of the
    prefill working set and the decode programs'), the slot state,
    `spec_bytes` (a speculative engine's `speculative_bytes`) and the int8
    product's transient (`quant_transient_bytes`), with the configured
    safety margin (reference default 20%, cli.py:28). An int8 cache counts
    its scale bytes."""
    param_bytes = tree_bytes(params)
    kv_per_slot = config.max_sequence_length * kv_row_bytes(spec, cache_dtype)
    act = activation_bytes(spec, config)
    dec = decode_bytes(spec, config, params["embed_tokens"].dtype)
    quant = quant_transient_bytes(params, config)
    state = config.max_batch_slots * config.max_sequence_length * 4 * 4
    usable = int(hbm_bytes * (1.0 - config.batch_safety_margin)) \
        - param_bytes - max(act, dec) - state - spec_bytes - quant
    max_slots = config.max_batch_slots
    if os.getenv("ESTIMATE_MEMORY", "auto").lower() != "off":
        fit = max(1, usable // max(kv_per_slot, 1))
        if fit < max_slots:
            logger.warning("shrinking batch slots %d -> %d to fit device "
                           "memory", max_slots, fit)
            max_slots = int(fit)
            config.max_batch_slots = max_slots
    plan = MemoryPlan(param_bytes=param_bytes, kv_bytes_per_slot=kv_per_slot,
                      state_bytes=state, activation_bytes=act,
                      hbm_bytes=hbm_bytes, usable_bytes=max(usable, 0),
                      max_slots=max_slots, speculative_bytes=spec_bytes,
                      quant_bytes=quant, decode_bytes=dec)
    logger.info("memory plan: %s", plan.describe())
    return plan
