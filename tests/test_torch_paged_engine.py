"""The PyTorch port's PagedInferenceEngine against the JAX package's, on
the same checkpoint (tiny_llama, fp32, CPU): greedy tokens must be
identical on staggered multi-slot runs with page reuse, per-step decode
(chunk 1), ring chunks of 8 through both the dense-gather and the
paged-kernel branch, and chunks of 4 in the "post" and "scan" write modes
(a loop of single paged steps). Mirrors tests/test_paged_engine.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_generation_inference_tpu.config import ServingConfig as JConfig
from text_generation_inference_tpu.engine.engine import (
    RequestParams as JRequestParams)
from text_generation_inference_tpu.engine.paged_engine import (
    PagedInferenceEngine as JEngine)
from text_generation_inference_tpu.models import families as jfamilies
from text_generation_inference_tpu_torch.config import ServingConfig
from text_generation_inference_tpu_torch.engine.engine import RequestParams
from text_generation_inference_tpu_torch.engine.paged_cache import PageAllocator
from text_generation_inference_tpu_torch.engine.paged_engine import (
    PagedInferenceEngine)
from text_generation_inference_tpu_torch.models import families
from tests import fixtures

PROMPTS = [
    [5, 9, 23, 77, 41],
    [100, 3, 250, 17, 88, 91, 12],
    [7, 7, 7],
]


def make_config(cls=ServingConfig, **kw):
    cfg = cls(max_sequence_length=64, max_new_tokens=32, max_batch_slots=3,
              prefill_buckets=[8, 16], kv_page_size=8, **kw)
    cfg.validate()
    return cfg


@pytest.fixture(scope="module")
def llama():
    return families.load_model(fixtures.tiny_llama(), dtype=torch.float32,
                               device="cpu")


@pytest.fixture(scope="module")
def jax_llama():
    return jfamilies.load_model(fixtures.tiny_llama(), dtype=jnp.float32)


def engine(llama, num_pages=64, **kw):
    spec, params = llama
    return PagedInferenceEngine(spec, params, make_config(**kw),
                                eos_token_id=2, num_pages=num_pages,
                                device="cpu")


def jax_engine(jax_llama, num_pages=64, **kw):
    spec, params = jax_llama
    return JEngine(spec, params, make_config(JConfig, **kw), eos_token_id=2,
                   num_pages=num_pages)


def run_engine(eng, prompt, n_tokens, rp=None):
    slot = eng.acquire_slot()
    res = eng.prefill([slot], [prompt], [rp or RequestParams(max_new_tokens=n_tokens)])
    toks = [int(res.first_token.next_ids[0])]
    while len(toks) < n_tokens:
        for step in eng.decode_steps():
            toks.append(int(step.next_ids[slot]))
    eng.free(slot)
    return toks[:n_tokens]


def staggered(eng, rp_cls, chunk=None):
    """Two requests, a free, a third request reusing the freed pages; the
    decode count stays within every request's page reservation."""
    steps = chunk or eng.decode_chunk

    def decode(n_steps, slots, out):
        for _ in range(n_steps // steps):
            for step in eng.decode_steps(chunk=chunk):
                for name, s in slots.items():
                    out[name].append(int(step.next_ids[s]))

    out = {}
    sa, sb = eng.acquire_slot(), eng.acquire_slot()
    res = eng.prefill([sa, sb], [PROMPTS[0], PROMPTS[1]],
                      [rp_cls(max_new_tokens=30)] * 2)
    out["a"] = [int(res.first_token.next_ids[0])]
    out["b"] = [int(res.first_token.next_ids[1])]
    decode(8, {"a": sa, "b": sb}, out)
    eng.free(sb)
    sc = eng.acquire_slot()
    res = eng.prefill([sc], [PROMPTS[2]], [rp_cls(max_new_tokens=30)])
    out["c"] = [int(res.first_token.next_ids[0])]
    decode(16, {"a": sa, "c": sc}, out)
    eng.free(sa)
    eng.free(sc)
    return out


# case -> (engine config, chunk override, the JAX run it must equal)
CASES = {
    "chunk1": (dict(), None, "chunk1"),
    "chunk8_dense_gather": (dict(decode_chunk=8, paged_gather_ctx_max=64),
                            None, "chunk8"),
    "chunk8_paged_kernel": (dict(decode_chunk=8, paged_gather_ctx_max=0),
                            None, "chunk8"),
    "stream_chunk8": (dict(paged_gather_ctx_max=0), 8, "chunk1"),
    "post_chunk4": (dict(decode_chunk=4, decode_write_mode="post"), None,
                    "post4"),
    "scan_chunk4": (dict(decode_chunk=4, decode_write_mode="scan"), None,
                    "scan4"),
}
# the JAX engine's runs: its per-step path, and ring chunks of 8 through its
# paged-kernel branch (its own tests show the dense-gather branch and chunked
# decode give the same greedy tokens)
JAX_RUNS = {"chunk1": (dict(), None),
            "chunk8": (dict(decode_chunk=8, paged_gather_ctx_max=0), None),
            "post4": (dict(decode_chunk=4, decode_write_mode="post"), None),
            "scan4": (dict(decode_chunk=4, decode_write_mode="scan"), None)}


@pytest.fixture(scope="module")
def jax_staggered(jax_llama):
    cache = {}

    def get(name):
        if name not in cache:
            kw, chunk = JAX_RUNS[name]
            cache[name] = staggered(jax_engine(jax_llama, num_pages=16, **kw),
                                    JRequestParams, chunk)
        return cache[name]
    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_staggered_greedy_matches_jax(llama, jax_staggered, case):
    kw, chunk, jax_run = CASES[case]
    want = jax_staggered(jax_run)
    eng = engine(llama, num_pages=16, **kw)
    assert staggered(eng, RequestParams, chunk) == want
    # and again on the churned pool: freed pages leak no stale KV
    assert staggered(eng, RequestParams, chunk) == want
    assert eng.allocator.num_free == 16


@pytest.mark.parametrize("kw", [dict(), dict(decode_chunk=4),
                                dict(decode_chunk=4, kv_cache_dtype="int8")],
                         ids=["chunk1", "chunk4", "chunk4_int8"])
def test_inactive_slots_do_not_corrupt_live_pages(llama, kw):
    """With a pool of exactly the request's 3 pages, every inactive slot's
    stale or sentinel table row points at or past the live allocation;
    dropped writes keep the live request's KV intact (same tokens as with
    a roomy pool). Over an int8 pool the scale pools' writes drop too."""
    want = run_engine(engine(llama, **kw), PROMPTS[1], 14)
    assert run_engine(engine(llama, num_pages=3, **kw), PROMPTS[1], 14) == want


def test_prompt_details_match_jax(llama, jax_llama):
    outs = {}
    for name, eng, rp in (("jax", jax_engine(jax_llama), JRequestParams),
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


def test_seeded_sampling_repeats_whatever_the_slot(llama):
    rp = RequestParams(temperature=0.9, top_p=0.9, seed=7, max_new_tokens=10)
    eng = engine(llama)
    first = run_engine(eng, PROMPTS[0], 10, rp)
    # occupy slot 2 so the same request lands in another slot
    other = eng.acquire_slot()
    eng.prefill([other], [PROMPTS[2]], [RequestParams(max_new_tokens=20)])
    assert run_engine(eng, PROMPTS[0], 10, rp) == first
    rp2 = RequestParams(temperature=0.9, top_p=0.9, seed=8, max_new_tokens=10)
    assert run_engine(engine(llama), PROMPTS[0], 10, rp2) != first


def test_no_details_variant_same_ids(llama):
    eng = engine(llama, decode_chunk=4)
    runs = []
    for want in (True, False):
        slot = eng.acquire_slot()
        res = eng.prefill([slot], [PROMPTS[0]], [RequestParams(max_new_tokens=12)])
        toks = [int(res.first_token.next_ids[0])]
        for step in eng.decode_steps(want_details=want):
            toks.append(int(step.next_ids[slot]))
            assert np.isnan(step.logprob[slot]) != want
        eng.free(slot)
        runs.append(toks)
    assert runs[0] == runs[1]


def test_warmup_reset_and_buckets(llama):
    eng = engine(llama, decode_chunk=4)
    assert eng._page_bucket_grid() == [1, 2, 4, 8]
    eng.warmup()
    assert len(eng.free_slots) == eng.num_slots
    assert eng.allocator.num_free == 64
    baseline = run_engine(engine(llama, decode_chunk=4), PROMPTS[0], 8)
    assert run_engine(eng, PROMPTS[0], 8) == baseline
    slot = eng.acquire_slot()
    eng.prefill([slot], [PROMPTS[1]], [RequestParams(max_new_tokens=30)])
    assert eng._pick_live_pages() == 1            # hist 8 -> 1 page
    eng.decode_steps()                            # hist 12 -> 2 pages
    assert eng._pick_live_pages() == 2
    eng.reset()
    assert eng.allocator.num_free == 64 and eng._pick_live_pages() == 1
    assert run_engine(eng, PROMPTS[0], 8) == baseline


def test_allocator():
    a = PageAllocator(num_pages=10, page_size=8, max_pages_per_slot=5)
    assert a.pages_needed(8) == 1 and a.pages_needed(9) == 2
    assert len(a.allocate(0, 20)) == 3 and a.num_free == 7
    assert not a.can_allocate(41)
    a.free(0)
    assert a.num_free == 10
    np.testing.assert_array_equal(
        PageAllocator(10, 4, 5).row_indices([7, 2], 6), [28, 29, 30, 31, 8, 9])
    with pytest.raises(RuntimeError):
        PageAllocator(2, 8, 4).allocate(0, 24)


def test_options_not_ported_raise(llama):
    # every decode write mode is ported; prompt-prefix injection is not
    eng = engine(llama, decode_write_mode="post", decode_chunk=4)
    assert eng._page_bucket_grid() == [8]       # live pages: ring only
    with pytest.raises(NotImplementedError):
        eng.prefill([eng.acquire_slot()], [PROMPTS[0]], [RequestParams()],
                    prefix_embeds=[np.zeros((2, 64), np.float32)])
    # int8 KV is ported, on the ring-chunk path only (as in the JAX engine)
    with pytest.raises(ValueError, match="ring"):
        engine(llama, kv_cache_dtype="int8", decode_write_mode="post",
               decode_chunk=4)
    assert engine(llama, kv_cache_dtype="int8",
                  decode_chunk=4).cache.k.dtype == torch.int8


def test_default_device_is_cuda(llama):
    spec, params = llama
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedInferenceEngine(spec, params, make_config(), eos_token_id=2,
                             num_pages=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        families.load_model(fixtures.tiny_llama())
