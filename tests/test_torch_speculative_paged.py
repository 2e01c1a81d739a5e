"""Speculative decoding on the port's paged engine against the JAX package
(CPU, fp32; the helpers are `tests/test_torch_speculative.py`'s):

* `paged_core.verify_chunk_paged` against JAX's on the same pool and block
  table (llama, the mistral fixture's sliding window, bloom's ALiBi), with
  an inactive slot, a sentinel page in a slot's chunk and positions past
  max_seq: logits and hidden states of the live slots within 1e-4, the
  pool after the call within 1e-5 (the port gathers one layer at a time;
  the outputs are the same).
* `PagedSpeculativeEngine` against the JAX one with the same speculator:
  greedy and repetition-penalty tokens and every step's n_emit equal.
  Against the port's plain paged engine: greedy, penalties, a mixed batch
  with a seeded sampling row; an oracle speculator accepted at every step;
  the gate (more than `max_spec_batch` active rows, no greedy row, pool
  pressure over 75%) falls back to plain steps with the same tokens.
  Programs, the memory plan, and the Batcher's streamed and unary results.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from text_generation_inference_tpu.config import ServingConfig as JConfig
from text_generation_inference_tpu.engine.engine import (
    RequestParams as JRequestParams)
from text_generation_inference_tpu.engine.paged_cache import (
    PagedKVCache as JPagedKVCache)
from text_generation_inference_tpu.engine.speculative import (
    PagedSpeculativeEngine as JPagedSpeculativeEngine)
from text_generation_inference_tpu.models import paged_core as jpaged
from text_generation_inference_tpu_torch.engine.engine import RequestParams
from text_generation_inference_tpu_torch.engine.paged_cache import PagedKVCache
from text_generation_inference_tpu_torch.engine.paged_engine import (
    PagedInferenceEngine)
from text_generation_inference_tpu_torch.engine.speculative import (
    PagedSpeculativeEngine)
from text_generation_inference_tpu_torch.models import paged_core
from tests.test_torch_speculative import (CACHE_TOL, LOGIT_TOL, N_TOKENS,
                                          PROMPTS, batcher_results,
                                          both_speculators, close, drive,
                                          family, fixed_speculator, llama,
                                          make_config, np_, oracle,
                                          plain_greedy, random_speculator,
                                          rp_cases, t_)

__all__ = ["family", "llama"]     # module fixtures, used here by name

PAGE = 8
NUM_PAGES = 12
MAX_SEQ = 30             # not a multiple of the page: the view holds 32 rows
VERIFY = jax.jit(jpaged.verify_chunk_paged, static_argnums=(0, 5, 7, 8))


def paged_plain(llama, **kw):
    spec, params = llama[2:]
    return PagedInferenceEngine(spec, params, make_config(**kw), 2,
                                num_pages=64, device="cpu")


def paged_spec(llama, sp_np=None, num_pages=64, config=None, **kw):
    spec, params = llama[2:]
    if sp_np is not None:
        _, _, ts, tp = both_speculators(sp_np, spec.vocab_size,
                                        spec.hidden_size)
        kw.update(speculator_spec=ts, speculator_params=tp)
    return PagedSpeculativeEngine(spec, params, config or make_config(), 2,
                                  num_pages=num_pages, device="cpu", **kw)


@pytest.fixture(scope="module")
def plain_tokens(llama):
    return drive(paged_plain(llama), PROMPTS, rp_cases(RequestParams))[0]


@pytest.fixture(scope="module")
def repeated_token(plain_tokens):
    vals, counts = np.unique(np.concatenate(plain_tokens), return_counts=True)
    return int(vals[np.argmax(counts)])


# --- verify_chunk_paged -------------------------------------------------------


def test_verify_chunk_paged_matches_jax(family):
    """Slots 0 and 1 live, slot 2 inactive. Slot 0's chunk (positions 13-16)
    crosses into a sentinel page at 16 (its write dropped), slot 1's starts
    at 6, slot 2 writes nothing; slot 1 is then moved to MAX_SEQ - 2, so its
    last two positions lie past max_seq."""
    name, jspec, jparams, spec, params = family
    rng = np.random.default_rng(6)
    shape = (spec.num_layers, spec.num_kv_heads, NUM_PAGES * PAGE,
             spec.head_dim)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    bt = np.asarray([[3, 7, NUM_PAGES, NUM_PAGES],
                     [5, 0, 9, 2],
                     [1, 4, NUM_PAGES, NUM_PAGES]], np.int32)
    ids = rng.integers(3, spec.vocab_size, (3, 4)).astype(np.int32)
    active = np.asarray([True, True, False])
    for start in ([13, 6, 9], [13, MAX_SEQ - 2, 9]):
        start = np.asarray(start, np.int32)
        jl, jh, jc = VERIFY(jspec, jparams, jnp.asarray(ids),
                            jnp.asarray(start),
                            JPagedKVCache(jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(bt)),
                            PAGE, jnp.asarray(active), MAX_SEQ, 4)
        tc = PagedKVCache(t_(k), t_(v), t_(bt))
        tl, th, tc = paged_core.verify_chunk_paged(
            spec, params, t_(ids), t_(start), tc, PAGE, t_(active), MAX_SEQ,
            live_pages=4)
        close(tl, jl, LOGIT_TOL, f"{name} logits")
        close(th, jh, LOGIT_TOL, f"{name} hidden")
        close(tc.k, jc.k, CACHE_TOL, f"{name} keys")
        close(tc.v, jc.v, CACHE_TOL, f"{name} values")
        # written: slot 0's rows 13-15 (page 7); not: its position 16
        # (sentinel page), slot 2's pages (inactive)
        rows = lambda page, a, b: slice(page * PAGE + a, page * PAGE + b)
        assert not np.allclose(np_(tc.k[:, :, rows(7, 5, 8)]),
                               k[:, :, rows(7, 5, 8)])
        for page in (1, 4):
            np.testing.assert_array_equal(np_(tc.k[:, :, rows(page, 0, 8)]),
                                          k[:, :, rows(page, 0, 8)])
    # slot 1 at 28-31: rows 28 and 29 written (page 2), 30 and 31 dropped
    np.testing.assert_array_equal(np_(tc.k[:, :, rows(2, 6, 8)]),
                                  k[:, :, rows(2, 6, 8)])
    assert not np.allclose(np_(tc.k[:, :, rows(2, 4, 6)]),
                           k[:, :, rows(2, 4, 6)])


# --- the paged engine -------------------------------------------------------------


def test_paged_engine_matches_jax_step_by_step(llama, repeated_token,
                                               plain_tokens):
    jspec_m, jparams_m, spec, _ = llama
    sp = fixed_speculator(spec.vocab_size, spec.hidden_size, repeated_token)
    js, jp, _, _ = both_speculators(sp, spec.vocab_size, spec.hidden_size)
    jeng = JPagedSpeculativeEngine(jspec_m, jparams_m, make_config(JConfig),
                                   2, num_pages=64, speculator_spec=js,
                                   speculator_params=jp)
    jtoks, jemits = drive(jeng, PROMPTS, rp_cases(JRequestParams))
    eng = paged_spec(llama, sp)
    toks, emits = drive(eng, PROMPTS, rp_cases(RequestParams))
    assert toks == jtoks == plain_tokens
    assert emits == jemits
    np.testing.assert_array_equal(eng.accepted_histogram,
                                  jeng.accepted_histogram)
    assert max(max(e) for e in emits) > 1
    assert (eng.spec_steps, eng.fallback_steps) == (jeng.spec_steps,
                                                    jeng.fallback_steps)


def test_paged_engine_matches_plain(llama):
    """Greedy and penalties; then a mixed batch, greedy and a seeded
    sampling row (the gate speculates: one row is greedy)."""
    spec = llama[2]
    mixed = [RequestParams(max_new_tokens=24),
             RequestParams(temperature=0.8, top_p=0.9, seed=99,
                           max_new_tokens=24)]
    for case in (rp_cases(RequestParams), mixed):
        plain = drive(paged_plain(llama), PROMPTS, case)[0]
        eng = paged_spec(llama, random_speculator(spec.vocab_size,
                                                  spec.hidden_size))
        got, emits = drive(eng, PROMPTS, case)
        assert got == plain
        assert eng.spec_steps == len(emits) and eng.fallback_steps == 0
    assert all(e[1] == 1 for e in emits)        # the sampled row: no draft


def test_oracle_speculator_is_always_accepted(llama, plain_tokens,
                                              monkeypatch):
    eng = paged_spec(llama)
    n = 13
    oracle(monkeypatch, eng, {1: plain_tokens[0], 0: plain_tokens[1]})
    toks, emits = drive(eng, PROMPTS, rp_cases(RequestParams), n=n)
    assert toks == [t[:n] for t in plain_tokens]
    assert emits == [[4, 4]] * 3


@pytest.mark.parametrize("gate", ["batch", "no_greedy", "pool_pressure"])
def test_gate_falls_back_to_plain_steps(llama, gate):
    """Each gate case takes plain steps (`last_n_emitted` None, counted in
    `fallback_steps`) with the plain engine's tokens."""
    rps = rp_cases(RequestParams)
    kw = {}
    if gate == "batch":
        kw = dict(max_spec_batch=1)              # two rows are active
    elif gate == "no_greedy":
        rps = [RequestParams(temperature=0.8, top_k=20, seed=7 + i,
                             max_new_tokens=N_TOKENS + 8) for i in range(2)]
    else:
        kw = dict(num_pages=10)                  # the two requests take 8
    plain = drive(paged_plain(llama), PROMPTS, rps)[0]
    eng = paged_spec(llama, **kw)
    got, emits = drive(eng, PROMPTS, rps)
    assert got == plain
    assert eng.spec_steps == 0 and eng.fallback_steps == len(emits) > 0
    assert all(e is None for e in emits)


def test_pool_pressure_gate_lifts(llama):
    """At 75% of the pool or less the engine speculates."""
    eng = paged_spec(llama, num_pages=11)        # 8 of 11 pages: 72.7%
    drive(eng, PROMPTS, rp_cases(RequestParams))
    assert eng.spec_steps > 0 and eng.fallback_steps == 0


def test_programs_and_plan(llama):
    """The decode grid plus one verify program per live-page bucket; the
    pool sized from the budget leaves room for the speculator and the
    verify working set."""
    spec, params = llama[2:]
    eng = paged_spec(llama)
    mp = eng.allocator.max_pages_per_slot
    assert eng.precompile_decode() == 2 + 1
    assert ("verify", mp) in eng.programs.programs
    ring = paged_spec(llama, config=make_config(decode_chunk=4))
    assert ring.precompile_decode() == 2 * 4 + 4     # buckets 1, 2, 4, 8
    assert {k for k in ring.programs.programs if k[0] == "verify"} == {
        ("verify", b) for b in (1, 2, 4, 8)}
    sized = PagedSpeculativeEngine(spec, params, make_config(), 2,
                                   device="cpu")
    plain = PagedInferenceEngine(spec, params, make_config(), 2, device="cpu")
    assert sized.memory_plan.speculative_bytes > 0
    assert (sized.memory_plan.usable_bytes
            + sized.memory_plan.speculative_bytes
            == plain.memory_plan.usable_bytes)


def test_batcher_serves_the_plain_tokens(llama):
    want = plain_greedy(paged_plain(llama))
    got, stream_ok = batcher_results(paged_spec(llama))
    assert got == want and stream_ok


@pytest.mark.parametrize("slot", [False, True], ids=["paged", "slot"])
def test_spec_lockstep_and_every_program(llama, slot):
    """`tools.decode_replay`'s speculative lockstep and `every_program`
    (with the verify programs' two outputs) on two engines built alike; on
    the card one replays graphs (`tests/test_torch_cuda.py -k
    speculative`), here both run their step functions."""
    from text_generation_inference_tpu_torch.config import ServingConfig
    from text_generation_inference_tpu_torch.engine.speculative import (
        SpeculativeEngine)
    from text_generation_inference_tpu_torch.tools import decode_replay

    spec, params = llama[2:]
    cfg = ServingConfig(max_sequence_length=512, max_new_tokens=256,
                        max_batch_slots=6, prefill_buckets=[16, 64, 256],
                        kv_page_size=16, decode_chunk=1 if slot else 4)
    cfg.validate()
    if slot:
        build = lambda: SpeculativeEngine(spec, params, cfg, 2, device="cpu")
    else:
        build = lambda: PagedSpeculativeEngine(spec, params, cfg, 2,
                                               num_pages=128, max_spec_batch=3,
                                               device="cpu")
    a, b = build(), build()
    seen = decode_replay.spec_lockstep(a, b, vocab=spec.vocab_size)
    assert seen["spec_steps"] > 0
    assert (seen["fallback_steps"] > 0) is not slot
    assert decode_replay.every_program(a, b) == len(a.programs)
    assert len(a.programs) == (1 if slot else 2 * 6 + 6)   # 1..32 pages
