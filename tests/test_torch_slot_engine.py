"""The port's slot engine (`InferenceEngine`, PAGED_ATTENTION=0) and its
forward passes against the JAX package's, on the same checkpoint
(tiny_llama, fp32, CPU).

* `core.prefill`, `core.decode` ("post" and "scan") and `core.ring_flush`
  against the JAX functions on weights carried across by
  `models/convert.py`: logits within 1e-4, caches within 1e-5, int8 cache
  entries bit for bit.
* The engine against the JAX `InferenceEngine` (mirrors
  tests/test_engine.py's write-mode, context-bucket and int8 suites):
  staggered slots with a free and a slot reused, in write modes post /
  scan / ring, decode_chunk 1 and 4, a streaming chunk of 8 over the
  default chunk of 1, context buckets, int8 KV on the ring path, and one
  case at max_seq 2048 where scan mode takes the slot-cache kernel's route.
  Greedy tokens are identical and logprobs agree within 5e-4, the repo's
  golden tolerance.
* The slot engine against the port's paged engine on the same prompts.
* Memory planning against the JAX `plan_memory`, the engine guards,
  warmup / reset, prompt details, and the server's PAGED_ATTENTION=0 switch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_generation_inference_tpu.config import ServingConfig as JConfig
from text_generation_inference_tpu.engine import memory as jmemory
from text_generation_inference_tpu.engine.engine import (
    InferenceEngine as JEngine, RequestParams as JRequestParams)
from text_generation_inference_tpu.models import core as jcore
from text_generation_inference_tpu.models import families as jfamilies
from text_generation_inference_tpu.models.fuse import fuse_params as jfuse
from text_generation_inference_tpu_torch.config import ServingConfig
from text_generation_inference_tpu_torch.engine import memory
from text_generation_inference_tpu_torch.engine.engine import (
    InferenceEngine, RequestParams)
from text_generation_inference_tpu_torch.engine.paged_engine import (
    PagedInferenceEngine)
from text_generation_inference_tpu_torch.engine.sampling import DETAILS_ROWS
from text_generation_inference_tpu_torch.models import core, families
from text_generation_inference_tpu_torch.models.convert import params_from_jax
from text_generation_inference_tpu_torch.ops.cuda import decode_attention as da
from tests import fixtures

LOGPROB_TOL = 5e-4
LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
PROMPTS = [
    [5, 9, 23, 77, 41],
    [100, 3, 250, 17, 88, 91, 12],
    [7, 7, 7],
]


def make_config(cls=ServingConfig, max_seq=64, **kw):
    kw = {"max_batch_slots": 3, **kw}
    cfg = cls(max_sequence_length=max_seq, max_new_tokens=32,
              prefill_buckets=[8, 16], **kw)
    cfg.validate()
    return cfg


@pytest.fixture(scope="module")
def llama():
    return families.load_model(fixtures.tiny_llama(), dtype=torch.float32,
                               device="cpu")


@pytest.fixture(scope="module")
def jax_llama():
    return jfamilies.load_model(fixtures.tiny_llama(), dtype=jnp.float32)


def engine(llama, max_seq=64, **kw):
    spec, params = llama
    return InferenceEngine(spec, params, make_config(max_seq=max_seq, **kw),
                           eos_token_id=2, device="cpu")


def staggered(eng, rp_cls, chunk=None):
    """A and B admitted together, 8 steps, B freed, C admitted into the
    freed slot, 16 more steps. Returns {name: [(token, logprob), ...]}."""
    steps = chunk or eng.decode_chunk
    out = {}

    def first(res, names):
        for i, n in enumerate(names):
            out[n] = [(int(res.first_token.next_ids[i]),
                       float(res.first_token.logprob[i]))]

    def decode(n_steps, slots):
        for _ in range(n_steps // steps):
            for step in eng.decode_steps(chunk=chunk):
                for name, s in slots.items():
                    out[name].append((int(step.next_ids[s]),
                                      float(step.logprob[s])))

    sa, sb = eng.acquire_slot(), eng.acquire_slot()
    first(eng.prefill([sa, sb], [PROMPTS[0], PROMPTS[1]],
                      [rp_cls(max_new_tokens=30)] * 2), ["a", "b"])
    decode(8, {"a": sa, "b": sb})
    eng.free(sb)
    sc = eng.acquire_slot()
    assert sc == sb                                  # the freed slot again
    first(eng.prefill([sc], [PROMPTS[2]], [rp_cls(max_new_tokens=30)]), ["c"])
    decode(16, {"a": sa, "c": sc})
    eng.free(sa)
    eng.free(sc)
    return out


def assert_same_run(got, want):
    assert {k: [t for t, _ in v] for k, v in got.items()} == \
        {k: [t for t, _ in v] for k, v in want.items()}
    for k in want:
        np.testing.assert_allclose([lp for _, lp in got[k]],
                                   [lp for _, lp in want[k]],
                                   rtol=0, atol=LOGPROB_TOL, err_msg=k)


# case -> (engine config, chunk override); each runs on both engines
CASES = {
    "post_chunk1": (dict(decode_write_mode="post"), None),
    "post_chunk4": (dict(decode_write_mode="post", decode_chunk=4), None),
    "scan_chunk1": (dict(decode_write_mode="scan"), None),
    "scan_chunk4": (dict(decode_write_mode="scan", decode_chunk=4), None),
    "ring_chunk1": (dict(), None),
    "ring_chunk4": (dict(decode_chunk=4), None),
    "ring_chunk4_ctx_buckets": (dict(decode_chunk=4,
                                     decode_ctx_buckets=[8, 16, 32, 64]), None),
    "ring_stream_chunk8": (dict(), 8),
    "ring_chunk4_int8": (dict(decode_chunk=4, kv_cache_dtype="int8"), None),
    "ring_chunk4_int8_ctx_buckets": (dict(decode_chunk=4, kv_cache_dtype="int8",
                                          decode_ctx_buckets=[8, 16, 32, 64]),
                                     None),
}


@pytest.fixture(scope="module")
def jax_runs(jax_llama):
    cache = {}

    def get(case):
        if case not in cache:
            kw, chunk = CASES[case]
            spec, params = jax_llama
            eng = JEngine(spec, params, make_config(JConfig, **kw),
                          eos_token_id=2)
            cache[case] = staggered(eng, JRequestParams, chunk)
        return cache[case]
    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_staggered_matches_jax(llama, jax_runs, case):
    kw, chunk = CASES[case]
    eng = engine(llama, **kw)
    want = jax_runs(case)
    assert_same_run(staggered(eng, RequestParams, chunk), want)
    # again on the churned cache: a reused slot leaks no stale KV
    assert_same_run(staggered(eng, RequestParams, chunk), want)
    assert len(eng.free_slots) == eng.num_slots


def test_scan_at_max_seq_2048_takes_the_kernel_route(monkeypatch):
    """Scan mode at max_seq 2048 with head dim 64 (the fixture's is 16, which
    the kernel is not built for): every layer of every step attends through
    the slot-cache kernel's route, on CPU tensors its plain version, and
    the engine still equals the JAX engine (its einsum on the CPU). A
    2-layer model with random weights made by the JAX package's
    `init_params`, carried across."""
    kw = dict(decode_write_mode="scan", decode_chunk=4, max_seq=2048)
    fields = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4,
                  num_kv_heads=2, head_dim=64, intermediate_size=192)
    jspec = jcore.DecoderSpec(**fields)
    jparams = jcore.init_params(jspec, jax.random.key(3), jnp.float32)
    want = staggered(JEngine(jspec, jparams, make_config(JConfig, **kw),
                             eos_token_id=2), JRequestParams)
    spec = core.DecoderSpec(**fields)
    params = params_from_jax(spec, jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    routed = []
    kernel = da.decode_attention
    monkeypatch.setattr(da, "decode_attention",
                        lambda *a, **kw: routed.append(1) or kernel(*a, **kw))
    eng = engine((spec, params), **kw)
    assert_same_run(staggered(eng, RequestParams), want)
    assert len(routed) == 24 * spec.num_layers


@pytest.mark.parametrize("kw", [dict(), dict(decode_chunk=4),
                                dict(decode_chunk=4, decode_write_mode="scan")],
                         ids=["chunk1", "ring_chunk4", "scan_chunk4"])
def test_slot_engine_matches_paged_engine(llama, kw):
    spec, params = llama
    paged = PagedInferenceEngine(spec, params, make_config(kv_page_size=8, **kw),
                                 eos_token_id=2, num_pages=24, device="cpu")
    assert_same_run(staggered(engine(llama, **kw), RequestParams),
                    staggered(paged, RequestParams))


# --- the forward passes -------------------------------------------------------


@pytest.fixture(scope="module")
def carried(jax_llama):
    spec, jparams = jax_llama
    jparams = jfuse(spec, jparams)
    return spec, jparams, params_from_jax(
        spec, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def np_(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def close(got, want, tol):
    np.testing.assert_allclose(np_(got), np_(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", ["post", "scan"])
def test_prefill_and_decode_match_jax(carried, mode):
    """core.prefill into slots 2 and 0, then three decode steps."""
    spec, jparams, tparams = carried
    slots_n, t_max = 3, 32
    rng = np.random.default_rng(7)
    ids = rng.integers(3, 250, size=(2, 16)).astype(np.int32)
    lengths = np.asarray([11, 16], np.int32)
    slots = np.asarray([2, 0], np.int32)
    jc = jcore.KVCache.create(spec, slots_n, t_max, jnp.float32)
    tc = core.KVCache.create(spec, slots_n, t_max, torch.float32, "cpu")
    jl, jc = jcore.prefill(spec, jparams, jnp.asarray(ids),
                           jnp.asarray(lengths), jnp.asarray(slots), jc)
    tl, tc = core.prefill(spec, tparams, torch.from_numpy(ids),
                          torch.from_numpy(lengths), torch.from_numpy(slots),
                          tc)
    rows = np.arange(2)
    close(tl[rows, lengths - 1], np.asarray(jl)[rows, lengths - 1], LOGIT_TOL)
    close(tc.k, jc.k, CACHE_TOL)
    pos = np.asarray([3, 0, 11], np.int32)            # slot 1 is idle
    step_ids = np.asarray([5, 6, 7], np.int32)
    for _ in range(3):
        step_ids = step_ids.copy()
        jl, jc = jcore.decode(spec, jparams, jnp.asarray(step_ids),
                              jnp.asarray(pos), jc, jnp.asarray(pos + 1),
                              write_mode=mode)
        tl, tc = core.decode(spec, tparams, torch.from_numpy(step_ids),
                             torch.from_numpy(pos), tc,
                             torch.from_numpy(pos + 1), write_mode=mode)
        close(tl, jl, LOGIT_TOL)
        step_ids = np.asarray(jnp.argmax(jl, -1), np.int32)
        pos = pos + 1
    close(tc.k, jc.k, CACHE_TOL)
    close(tc.v, jc.v, CACHE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_ring_flush_matches_jax_and_drops_past_max_seq(dtype):
    """Slots whose chunk runs past max_seq: those columns are dropped, the
    rest land at chunk_start + c; int8 caches take the quantized ring."""
    rng = np.random.default_rng(11)
    L, S, K, T, D, C = 2, 4, 2, 16, 8, 6
    kbuf = rng.normal(size=(L, S, K, C, D)).astype(np.float32)
    vbuf = rng.normal(size=(L, S, K, C, D)).astype(np.float32)
    start = np.asarray([0, 12, 15, 7], np.int32)
    spec = jcore.DecoderSpec(vocab_size=8, hidden_size=8, num_layers=L,
                             num_heads=K, num_kv_heads=K, head_dim=D,
                             intermediate_size=8)
    jdt, tdt = ((jnp.int8, torch.int8) if dtype == "int8"
                else (jnp.float32, torch.float32))
    jc = jcore.ring_flush(jcore.KVCache.create(spec, S, T, jdt),
                          jnp.asarray(kbuf), jnp.asarray(vbuf),
                          jnp.asarray(start))
    tc = core.ring_flush(core.KVCache.create(spec, S, T, tdt, "cpu"),
                         torch.from_numpy(kbuf), torch.from_numpy(vbuf),
                         torch.from_numpy(start))
    if dtype == "int8":
        np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
        np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
        close(tc.k_scale, jc.k_scale, 1e-6)
        close(tc.v_scale, jc.v_scale, 1e-6)
    else:
        close(tc.k, jc.k, 0)
        close(tc.v, jc.v, 0)
    # slot 2 starts at the last row: only its column 0 landed
    np.testing.assert_array_equal(
        tc.k_scale[:, 2, :, 15].numpy() if dtype == "int8"
        else tc.k[:, 2, :, 15].numpy(),
        np.asarray(jc.k_scale[:, 2, :, 15]) if dtype == "int8"
        else kbuf[:, 2, :, 0])


# --- engine host logic ---------------------------------------------------------


def test_memory_plan_matches_jax(llama, jax_llama, monkeypatch):
    spec, params = llama
    # the port's plan sets aside the einsum's prefill scores at head dim 16
    # (about 236 MiB at a bucket of 2048), so its budget here is larger
    # than the 64 MiB at which the JAX plan shrinks too
    hbm = 400 * 1024 ** 2
    plans = []
    for plan_fn, cfg_cls, kw in ((memory.plan_memory, ServingConfig,
                                  dict(cache_dtype=torch.float32)),
                                 (jmemory.plan_memory, JConfig,
                                  dict(cache_dtype_itemsize=4))):
        cfg = cfg_cls(max_sequence_length=2048, max_new_tokens=32,
                      max_batch_slots=64, prefill_buckets=[8, 16])
        cfg.validate()
        p = params if cfg_cls is ServingConfig else jax_llama[1]
        plans.append((plan_fn(spec, cfg, p, hbm_bytes=hbm, **kw),
                      cfg.max_batch_slots))
    (tp, t_slots), (jp, j_slots) = plans
    assert (tp.param_bytes, tp.kv_bytes_per_slot) == (jp.param_bytes,
                                                      jp.kv_bytes_per_slot)
    # by design (F4) the port's prefill working set is what one dispatch of
    # max_prefill_tokens padded tokens holds: the JAX plan's activations,
    # f32 logits with one copy beside them, a pass of prompt details (at
    # most DETAILS_ROWS positions) and, at head dim 16, the einsum's scores
    # (validate() appends max_seq, 2048, to the buckets [8, 16])
    t, d, f, v = 2048, spec.hidden_size, spec.intermediate_size, \
        spec.vocab_size
    assert jp.activation_bytes == t * (6 * d + 3 * f) * 4 + t * v * 4
    assert tp.activation_bytes == (
        t * (6 * d + 3 * f) * 4 + t * v * memory.LOGIT_BYTES
        + min(t, DETAILS_ROWS) * v * memory.DETAILS_BYTES
        + t * t * spec.num_heads * 14)
    assert tp.usable_bytes == jp.usable_bytes - (tp.activation_bytes
                                                 - jp.activation_bytes)
    assert t_slots == tp.max_slots == tp.usable_bytes // tp.kv_bytes_per_slot
    assert t_slots < 64 and j_slots == jp.max_slots   # shrunk in place
    # the engine plans against the CPU budget, and ESTIMATE_MEMORY=off
    # keeps the configured slots
    monkeypatch.setattr(memory, "CPU_BUDGET_BYTES", hbm)
    assert engine(llama, max_seq=2048, max_batch_slots=64).num_slots == t_slots
    monkeypatch.setenv("ESTIMATE_MEMORY", "off")
    eng = engine(llama, max_seq=2048, max_batch_slots=5)
    assert eng.num_slots == 5 and eng.cache.k.shape[1] == 5
    # an int8 cache counts its scale bytes: 2 x (L x K) x (D + 4) a token
    monkeypatch.delenv("ESTIMATE_MEMORY")
    cfg = make_config(kv_cache_dtype="int8", decode_chunk=2)
    plan = memory.plan_memory(spec, cfg, params, torch.int8, hbm)
    assert plan.kv_bytes_per_slot == 64 * 2 * spec.num_layers \
        * spec.num_kv_heads * (spec.head_dim + 4)


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_dispatch_is_capped_at_the_planned_tokens(llama, paged):
    """F4: a prefill dispatch holds at most max_prefill_tokens padded
    tokens (rows x bucket; the largest bucket, 64 at max_seq 64): eight
    queued prompts near it go one at a time, each refusal counted under
    tgi_prefill_weight_limit_exceeded, while eight short ones still form
    one prefill; warmup runs only the (rows, bucket) pairs within it."""
    from text_generation_inference_tpu_torch.scheduler.batcher import Batcher
    from text_generation_inference_tpu_torch.scheduler.request import (
        GenRequest, ResponseOptions, StoppingCriteria)
    from text_generation_inference_tpu_torch.utils import metrics

    spec, params = llama
    cfg = make_config(max_batch_slots=8)
    eng = (PagedInferenceEngine(spec, params, cfg, eos_token_id=2,
                                num_pages=64, device="cpu") if paged
           else InferenceEngine(spec, params, cfg, eos_token_id=2,
                                device="cpu"))
    assert cfg.prefill_buckets == [8, 16, 64] and cfg.max_prefill_tokens == 64
    batcher = Batcher(eng, None, cfg)
    refused = ("tgi_prefill_weight_limit_exceeded", ())

    def pick(length):
        batcher.queue.clear()
        batcher.queue.extend(
            GenRequest("", [5] * length, RequestParams(max_new_tokens=4),
                       StoppingCriteria(max_new_tokens=4), ResponseOptions())
            for _ in range(8))
        before = metrics._counters[refused]
        n = len(batcher._pick_prefill_batch())
        return n, metrics._counters[refused] - before

    assert pick(6) == (8, 0)            # 8 rows x bucket 8
    assert pick(12) == (4, 4)           # 4 rows x bucket 16
    assert pick(50) == (1, 7)           # 1 row x bucket 64
    shapes = []
    run = eng.prefill
    eng.prefill = lambda slots, ids, *a, **kw: (
        shapes.append((len(slots), cfg.bucket_for(max(map(len, ids)))))
        or run(slots, ids, *a, **kw))
    eng.warmup(batch_sizes=(1, 2, 4, 8))
    assert sorted(shapes) == [(1, 8), (1, 16), (1, 64), (2, 8), (2, 16),
                              (4, 8), (4, 16), (8, 8)]


def test_guards(llama):
    for kw, match in ((dict(kv_cache_dtype="int8"), "ring"),
                      (dict(kv_cache_dtype="int8", decode_chunk=4,
                            decode_write_mode="post"), "ring"),
                      (dict(kv_cache_dtype="int8", decode_chunk=4,
                            stream_decode_chunk=1), "stream_decode_chunk"),
                      (dict(decode_write_mode="bogus"), "write_mode")):
        with pytest.raises(ValueError, match=match):
            engine(llama, **kw)
    # a soft prompt is served: its positions precede the prompt's, and the
    # repetition penalty starts after it
    eng = engine(llama)
    slot = eng.acquire_slot()
    res = eng.prefill([slot], [PROMPTS[0]], [RequestParams()],
                      prefix_embeds=[np.zeros((2, 64), np.float32)])
    assert res.first_token.next_ids.shape == (1,)
    assert int(eng.state.input_len[slot]) == 2 + len(PROMPTS[0])
    assert int(eng.state.hist_start[slot]) == 2
    with pytest.raises(ValueError, match="int8"):
        core.decode(eng.spec, eng.model_params, torch.zeros(3, dtype=torch.int32),
                    torch.zeros(3, dtype=torch.int32),
                    core.KVCache.create(eng.spec, 3, 8, torch.int8, "cpu"),
                    torch.ones(3, dtype=torch.int32))


def test_warmup_reset_and_ctx_buckets(llama):
    eng = engine(llama, decode_chunk=4, decode_ctx_buckets=[8, 16, 32])
    assert eng._ctx_bucket_grid() == [8, 16, 32, 64]
    eng.warmup()
    assert len(eng.free_slots) == eng.num_slots
    baseline = staggered(engine(llama, decode_chunk=4), RequestParams)
    assert_same_run(staggered(eng, RequestParams), baseline)
    slot = eng.acquire_slot()
    eng.prefill([slot], [PROMPTS[1]], [RequestParams(max_new_tokens=30)])
    assert eng._pick_cache_rows() == 8            # history 8
    eng.decode_steps()                            # history 12
    assert eng._pick_cache_rows() == 16
    eng.reset()
    assert eng._pick_cache_rows() == 8 and len(eng.free_slots) == 3
    assert_same_run(staggered(eng, RequestParams), baseline)
    # post and scan read the whole cache
    assert engine(llama, decode_chunk=4, decode_write_mode="scan",
                  decode_ctx_buckets=[8])._ctx_bucket_grid() == [64]


def test_prompt_details_match_jax(llama, jax_llama):
    outs = {}
    spec, jparams = jax_llama
    for name, eng, rp in (("jax", JEngine(spec, jparams, make_config(JConfig),
                                          eos_token_id=2), JRequestParams),
                          ("torch", engine(llama), RequestParams)):
        slot = eng.acquire_slot()
        res = eng.prefill([slot], [PROMPTS[1]], [rp(max_new_tokens=4)],
                          want_prompt_details=True)
        outs[name] = res.prompt_details[0]
    np.testing.assert_allclose(outs["torch"]["logprob"][1:],
                               outs["jax"]["logprob"][1:], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(outs["torch"]["rank"], outs["jax"]["rank"])
    np.testing.assert_array_equal(outs["torch"]["top_ids"][1:],
                                  outs["jax"]["top_ids"][1:])
    assert np.isnan(outs["torch"]["logprob"][0])


def test_seeded_sampling_and_no_details(llama):
    rp = RequestParams(temperature=0.9, top_p=0.9, seed=7, max_new_tokens=10)
    runs = []
    for mode in ("ring", "scan"):
        eng = engine(llama, decode_chunk=4, decode_write_mode=mode)
        slot = eng.acquire_slot()
        res = eng.prefill([slot], [PROMPTS[0]], [rp])
        toks = [int(res.first_token.next_ids[0])]
        for want in (True, False):
            for step in eng.decode_steps(want_details=want):
                toks.append(int(step.next_ids[slot]))
                assert np.isnan(step.logprob[slot]) != want
        runs.append(toks)
    assert runs[0] == runs[1]


def test_server_builds_the_slot_engine(monkeypatch):
    from text_generation_inference_tpu_torch.server import main

    cfg = ServingConfig(model_name=fixtures.golden_llama_dir(),
                        dtype_str="float32", max_sequence_length=64,
                        max_new_tokens=32, max_batch_slots=2,
                        prefill_buckets=[16])
    cfg.validate()
    monkeypatch.setenv("PAGED_ATTENTION", "0")
    eng, _, kind = main.build_engine(cfg, device="cpu")
    assert type(eng) is InferenceEngine and kind == "decoder"
    monkeypatch.setenv("PAGED_ATTENTION", "1")
    assert type(main.build_engine(cfg, device="cpu")[0]) is PagedInferenceEngine
