"""Speculative decoding in the PyTorch port against the JAX package (CPU,
fp32): the speculator functions and the model functions, then the slot
engine (`SpeculativeEngine`, PAGED_ATTENTION=0). The paged side is
`tests/test_torch_speculative_paged.py`, which imports this file's helpers.

* `propose` gives the JAX draft ids exactly; `accept_longest_prefix`
  agrees with JAX; `load_speculator` reads an fms_extras checkpoint written
  from seeded numpy into the same arrays as JAX's loader.
* `core.prefill(return_hidden=True)` and `core.verify_chunk` against JAX's
  on the same inputs (llama, the mistral fixture's sliding window, bloom's
  ALiBi): logits and hidden states within 1e-4, the cache after the call
  within 1e-5 (positions past max_seq dropped).
* The slot engine against the JAX `SpeculativeEngine` with the same
  speculator: greedy tokens, a repetition-penalty row, and every step's
  n_emit (so the accepted histogram) equal. A speculator that always
  drafts one token the model repeats gets drafts accepted, so n_emit
  varies. Against the port's plain slot engine (the reference for sampled
  rows: the port's seeded sampling is not threefry): greedy, penalties, a
  seeded sampling row, a mixed batch; an oracle speculator (the plain
  continuation) accepted at every step. int8 KV refused; `build_engine`
  dispatch; the Batcher's streamed and unary results.
"""

import asyncio
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_generation_inference_tpu.config import ServingConfig as JConfig
from text_generation_inference_tpu.engine.engine import (
    RequestParams as JRequestParams)
from text_generation_inference_tpu.engine.speculative import (
    SpeculativeEngine as JSpeculativeEngine)
from text_generation_inference_tpu.models import core as jcore
from text_generation_inference_tpu.models import families as jfamilies
from text_generation_inference_tpu.models import speculator as jspeculator
from text_generation_inference_tpu_torch.config import ServingConfig
from text_generation_inference_tpu_torch.engine.engine import (
    InferenceEngine, RequestParams)
from text_generation_inference_tpu_torch.engine.seq2seq import Seq2SeqEngine
from text_generation_inference_tpu_torch.engine.speculative import (
    PagedSpeculativeEngine, SpeculativeEngine)
from text_generation_inference_tpu_torch.models import core, families
from text_generation_inference_tpu_torch.models import speculator
from text_generation_inference_tpu_torch.models.convert import (
    speculator_params_from_jax)
from text_generation_inference_tpu_torch.server import main
from tests import fixtures

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
PROMPTS = [[5, 9, 23, 77, 41], [100, 3, 250, 17, 88, 91, 12]]
N_TOKENS = 16
# the JAX functions, compiled once per family
J = {"prefill": jax.jit(jcore.prefill, static_argnums=(0,),
                        static_argnames=("return_hidden",)),
     "verify_chunk": jax.jit(jcore.verify_chunk, static_argnums=(0,))}


def np_(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def t_(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(got, want, tol, what=""):
    np.testing.assert_allclose(np_(got), np_(want), rtol=tol, atol=tol,
                               err_msg=what)


# --- speculators, carried into both packages ---------------------------------


def random_speculator(vocab, d, inner=32, n_predict=3, seed=0):
    """Seeded numpy weights in the JAX layout (per-position lists)."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {
        "emb": [normal(vocab, inner, scale=0.5) for _ in range(n_predict)],
        "w_state": [normal(d if i == 0 else inner, inner, scale=0.5)
                    for i in range(n_predict)],
        "ln_scale": [1 + normal(inner, scale=0.1) for _ in range(n_predict)],
        "ln_bias": [normal(inner, scale=0.1) for _ in range(n_predict)],
        "head": [normal(inner, vocab, scale=0.5) for _ in range(n_predict)],
    }


def fixed_speculator(vocab, d, token, inner=32, n_predict=3):
    """A speculator that always drafts `token`: LayerNorm scale 0 and bias
    2 make every state gelu(2), and only the head's `token` column is set."""
    sp = random_speculator(vocab, d, inner, n_predict, seed=5)
    for i in range(n_predict):
        sp["ln_scale"][i][:] = 0.0
        sp["ln_bias"][i][:] = 2.0
        sp["head"][i][:] = 0.0
        sp["head"][i][:, token] = 1.0
    return sp


def both_speculators(sp_np, vocab, d):
    """(JAX spec, JAX params, port spec, port params) of numpy weights."""
    inner = sp_np["emb"][0].shape[1]
    n = len(sp_np["emb"])
    jspec = jspeculator.SpeculatorSpec(vocab, d, inner, n)
    jparams = {k: [jnp.asarray(a) for a in v] for k, v in sp_np.items()}
    return (jspec, jparams, speculator.SpeculatorSpec(vocab, d, inner, n),
            speculator_params_from_jax(sp_np, device="cpu"))


def write_speculator(root: Path, vocab, d, inner=32, n_predict=2,
                     model_dim_key="model_dim") -> str:
    """An fms_extras-style checkpoint from seeded numpy: [out, in] proj
    and head weights, LayerNorm weight / bias, config.json."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(3)
    tensors = {}
    for i in range(n_predict):
        in_dim = d if i == 0 else inner
        tensors[f"emb.{i}.weight"] = rng.normal(
            scale=0.02, size=(vocab, inner)).astype(np.float32)
        tensors[f"proj.{i}.weight"] = rng.normal(
            scale=0.02, size=(inner, in_dim)).astype(np.float32)
        tensors[f"head.{i}.weight"] = rng.normal(
            scale=0.02, size=(vocab, inner)).astype(np.float32)
        tensors[f"ln.{i}.weight"] = (1 + rng.normal(
            scale=0.1, size=inner)).astype(np.float32)
        tensors[f"ln.{i}.bias"] = rng.normal(
            scale=0.1, size=inner).astype(np.float32)
    out = root / "speculator"
    out.mkdir()
    save_file(tensors, out / "model.safetensors")
    (out / "config.json").write_text(json.dumps({
        "vocab_size": vocab, model_dim_key: d, "inner_dim": inner,
        "n_predict": n_predict}))
    return str(out)


# --- models and engines --------------------------------------------------------


@pytest.fixture(scope="module")
def llama():
    """(JAX spec, JAX params, port spec, port params) of tiny_llama."""
    d = fixtures.tiny_llama()
    return (*jfamilies.load_model(d, dtype=jnp.float32),
            *families.load_model(d, dtype=torch.float32, device="cpu"))


def make_config(cls=ServingConfig, **kw):
    cfg = cls(max_sequence_length=64, max_new_tokens=32, max_batch_slots=2,
              prefill_buckets=[8, 16], kv_page_size=8, **kw)
    cfg.validate()
    return cfg


def drive(engine, prompts, rps, n=N_TOKENS):
    """Prefill every prompt at once, then decode until each has n tokens.
    Returns (tokens per request, each step's n_emit per request or None
    for a plain step)."""
    slots = [engine.acquire_slot() for _ in prompts]
    res = engine.prefill(slots, prompts, rps)
    toks = {s: [int(res.first_token.next_ids[i])] for i, s in enumerate(slots)}
    emits = []
    while min(len(t) for t in toks.values()) < n:
        steps = engine.decode_steps()
        ne = engine.last_n_emitted
        emits.append(None if ne is None else [int(ne[s]) for s in slots])
        for s in slots:
            k = len(steps) if ne is None else int(ne[s])
            toks[s].extend(int(steps[j].next_ids[s]) for j in range(k))
    for s in slots:
        engine.free(s)
    return [toks[s][:n] for s in slots], emits


def rp_cases(cls):
    """A greedy row and a repetition-penalty row (both greedy)."""
    return [cls(max_new_tokens=N_TOKENS + 8),
            cls(repetition_penalty=1.3, min_new_tokens=4,
                max_new_tokens=N_TOKENS + 8)]


@pytest.fixture(scope="module")
def plain_tokens(llama):
    """The port's plain slot engine on both prompts (greedy, penalties)."""
    spec, params = llama[2:]
    eng = InferenceEngine(spec, params, make_config(), 2, device="cpu")
    return drive(eng, PROMPTS, rp_cases(RequestParams))[0]


@pytest.fixture(scope="module")
def repeated_token(plain_tokens):
    """The token the plain greedy continuations repeat most."""
    vals, counts = np.unique(np.concatenate(plain_tokens), return_counts=True)
    return int(vals[np.argmax(counts)])


# --- the speculator functions --------------------------------------------------


def test_propose_matches_jax(llama):
    jspec_m = llama[0]
    vocab, d = jspec_m.vocab_size, jspec_m.hidden_size
    js, jp, ts, tp = both_speculators(random_speculator(vocab, d), vocab, d)
    rng = np.random.default_rng(1)
    hidden = rng.normal(size=(6, d)).astype(np.float32)
    first = rng.integers(0, vocab, 6).astype(np.int32)
    want = np.asarray(jspeculator.propose(js, jp, jnp.asarray(hidden),
                                          jnp.asarray(first)))
    got = speculator.propose(ts, tp, t_(hidden), t_(first))
    assert got.dtype == torch.int32 and got.shape == (6, 3)
    np.testing.assert_array_equal(np_(got), want)
    assert len(np.unique(want)) > 3           # not a constant draft


def test_accept_longest_prefix_matches_jax():
    draft = np.asarray([[1, 2, 3], [1, 9, 3], [7, 7, 7], [4, 5, 9]], np.int32)
    verified = np.asarray([[1, 2, 3], [1, 2, 3], [1, 2, 3], [4, 5, 6]],
                          np.int32)
    want = np.asarray(jspeculator.accept_longest_prefix(
        jnp.asarray(draft), jnp.asarray(verified)))
    got = speculator.accept_longest_prefix(t_(draft), t_(verified))
    np.testing.assert_array_equal(np_(got), want)
    assert np_(got).tolist() == [3, 1, 0, 2]


@pytest.mark.parametrize("model_dim_key", ["model_dim", "emb_dim"])
def test_load_speculator_matches_jax(tmp_path, model_dim_key):
    path = write_speculator(tmp_path, 256, 64, model_dim_key=model_dim_key)
    jspec, jparams = jspeculator.load_speculator(path, dtype=jnp.float32)
    tspec, tparams = speculator.load_speculator(path, dtype=torch.float32,
                                                device="cpu")
    assert dataclasses_equal(tspec, jspec)
    assert tparams["w_state"][0].shape == (64, 32)
    assert tparams["head"][1].shape == (32, 256)
    for key, arrays in jparams.items():
        assert len(tparams[key]) == len(arrays) == 2
        for got, want in zip(tparams[key], arrays):
            np.testing.assert_array_equal(np_(got), np.asarray(want))


def dataclasses_equal(a, b) -> bool:
    return ((a.vocab_size, a.model_dim, a.inner_dim, a.n_predict)
            == (b.vocab_size, b.model_dim, b.inner_dim, b.n_predict))


# --- the model functions --------------------------------------------------------


@pytest.fixture(scope="module", params=["llama", "mistral", "bloom"])
def family(request):
    """(name, JAX spec and params, port spec and params): tiny_llama, the
    mistral fixture (sliding window 8) and bloom (ALiBi)."""
    d = fixtures.ALL_DECODER_FIXTURES[request.param]()
    return (request.param, *jfamilies.load_model(d, dtype=jnp.float32),
            *families.load_model(d, dtype=torch.float32, device="cpu"))


def test_prefill_return_hidden_matches_jax(family):
    name, jspec, jparams, spec, params = family
    rng = np.random.default_rng(2)
    ids = rng.integers(3, spec.vocab_size, (2, 16)).astype(np.int32)
    lengths = np.asarray([13, 6], np.int32)
    slots = np.asarray([1, 0], np.int32)
    jl, jh, jc = J["prefill"](jspec, jparams, jnp.asarray(ids),
                              jnp.asarray(lengths), jnp.asarray(slots),
                              jcore.KVCache.create(jspec, 2, 32, jnp.float32),
                              return_hidden=True)
    tl, th, tc = core.prefill(spec, params, t_(ids), t_(lengths), t_(slots),
                              core.KVCache.create(spec, 2, 32, torch.float32,
                                                  "cpu"), return_hidden=True)
    assert th.shape == (2, 16, spec.hidden_size)
    for r, ln in enumerate(lengths):
        close(tl[r, :ln], np.asarray(jl)[r, :ln], LOGIT_TOL, f"{name} logits")
        close(th[r, :ln], np.asarray(jh)[r, :ln], LOGIT_TOL, f"{name} hidden")
    close(tc.k, jc.k, CACHE_TOL, f"{name} cache")


def verify_inputs(spec, t_max, seed=4):
    """A filled cache [L, 3, K, t_max, D], 4 candidates per slot at starts
    13 and 6, and one at t_max - 2 whose last two positions lie past
    max_seq (dropped)."""
    rng = np.random.default_rng(seed)
    shape = (spec.num_layers, 3, spec.num_kv_heads, t_max, spec.head_dim)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    ids = rng.integers(3, spec.vocab_size, (3, 4)).astype(np.int32)
    start = np.asarray([13, 6, t_max - 2], np.int32)
    return k, v, ids, start


def test_verify_chunk_matches_jax(family):
    name, jspec, jparams, spec, params = family
    k, v, ids, start = verify_inputs(spec, 32)
    jl, jh, jc = J["verify_chunk"](jspec, jparams, jnp.asarray(ids),
                                   jnp.asarray(start),
                                   jcore.KVCache(jnp.asarray(k),
                                                 jnp.asarray(v)))
    tc = core.KVCache(t_(k), t_(v))
    tl, th, tc = core.verify_chunk(spec, params, t_(ids), t_(start), tc)
    assert tl.shape == (3, 4, spec.vocab_size) and tl.dtype == torch.float32
    close(tl, jl, LOGIT_TOL, f"{name} logits")
    close(th, jh, LOGIT_TOL, f"{name} hidden")
    close(tc.k, jc.k, CACHE_TOL, f"{name} keys")
    close(tc.v, jc.v, CACHE_TOL, f"{name} values")
    # the chunk's rows were written, the ones past max_seq dropped
    assert not np.allclose(np_(tc.k[:, 0, :, 13:17]), k[:, 0, :, 13:17])
    np.testing.assert_array_equal(np_(tc.k[:, 0, :, :13]), k[:, 0, :, :13])
    assert np.isfinite(np_(tl)).all()


# --- the slot engine --------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_slot_run(llama, repeated_token):
    """The JAX SpeculativeEngine with the fixed-token speculator: a greedy
    and a repetition-penalty request (one compile of its step)."""
    jspec_m, jparams_m, spec, _ = llama
    sp = fixed_speculator(spec.vocab_size, spec.hidden_size, repeated_token)
    js, jp, _, _ = both_speculators(sp, spec.vocab_size, spec.hidden_size)
    eng = JSpeculativeEngine(jspec_m, jparams_m, make_config(JConfig), 2,
                             speculator_spec=js, speculator_params=jp)
    toks, emits = drive(eng, PROMPTS, rp_cases(JRequestParams))
    return toks, emits, eng.accepted_histogram.copy()


def spec_engine(llama, sp_np=None, cls=SpeculativeEngine, **kw):
    spec, params = llama[2:]
    if sp_np is None:
        return cls(spec, params, make_config(), 2, device="cpu", **kw)
    _, _, ts, tp = both_speculators(sp_np, spec.vocab_size, spec.hidden_size)
    return cls(spec, params, make_config(), 2, speculator_spec=ts,
               speculator_params=tp, device="cpu", **kw)


def test_slot_engine_matches_jax_step_by_step(llama, repeated_token,
                                              jax_slot_run, plain_tokens):
    spec = llama[2]
    eng = spec_engine(llama, fixed_speculator(spec.vocab_size,
                                              spec.hidden_size,
                                              repeated_token))
    toks, emits = drive(eng, PROMPTS, rp_cases(RequestParams))
    jtoks, jemits, jhist = jax_slot_run
    assert toks == jtoks == plain_tokens
    assert emits == jemits
    np.testing.assert_array_equal(eng.accepted_histogram, jhist)
    # drafts were accepted: the commit path past the first position ran
    assert max(max(e) for e in emits) > 1
    assert eng.spec_steps == len(emits)


def test_slot_engine_matches_plain(llama):
    """Greedy, penalties, a seeded sampling row and a mixed batch, with a
    random speculator, against the port's plain slot engine."""
    spec, params = llama[2:]
    rps = [RequestParams(max_new_tokens=24),
           RequestParams(temperature=0.8, top_p=0.9, seed=99,
                         max_new_tokens=24)]
    for case in (rp_cases(RequestParams), rps):
        plain = drive(InferenceEngine(spec, params, make_config(), 2,
                                      device="cpu"), PROMPTS, case)[0]
        sp = random_speculator(spec.vocab_size, spec.hidden_size)
        eng = spec_engine(llama, sp)
        got, emits = drive(eng, PROMPTS, case)
        assert got == plain
        assert all(e is not None for e in emits)
    # the sampled row accepted no draft
    assert all(e[1] == 1 for e in emits)


def oracle(monkeypatch, engine, continuations):
    """Make `propose` draft each slot's plain continuation: slot s, with
    gen_count g, drafts continuations[s][g : g + K]."""
    def propose(sspec, params, hidden, first_token):
        gen = engine.state.gen_count.tolist()
        rows = [(continuations.get(s, []) + [0] * 64)[g:g + sspec.n_predict]
                for s, g in enumerate(gen)]
        return torch.tensor(rows, dtype=torch.int32)

    monkeypatch.setattr(speculator, "propose", propose)


def test_oracle_speculator_is_always_accepted(llama, plain_tokens,
                                              monkeypatch):
    eng = spec_engine(llama)
    n = 13                                 # 1 + 3 steps of 4 tokens
    oracle(monkeypatch, eng, {1: plain_tokens[0], 0: plain_tokens[1]})
    toks, emits = drive(eng, PROMPTS, rp_cases(RequestParams), n=n)
    assert toks == [t[:n] for t in plain_tokens]
    assert emits == [[4, 4]] * 3
    assert eng.accepted_histogram.tolist() == [0, 0, 0, 0, 6]


def test_int8_kv_is_refused(llama):
    spec, params = llama[2:]
    for cls, kw in ((SpeculativeEngine, {}),
                    (PagedSpeculativeEngine, dict(num_pages=16))):
        with pytest.raises(ValueError, match="int8"):
            cls(spec, params, make_config(kv_cache_dtype="int8",
                                          decode_chunk=4), 2, device="cpu",
                **kw)


def test_fallback_prefill_starts_the_chain_from_zero(llama):
    """A prefill with prompt details goes through the plain prefill; the
    slot's chain state starts from zero, not from its previous occupant's,
    which the JAX engine keeps (pinned here: ROADMAP Queue 3)."""
    jspec_m, jparams_m, spec, _ = llama
    js, jp, ts, tp = both_speculators(
        random_speculator(spec.vocab_size, spec.hidden_size),
        spec.vocab_size, spec.hidden_size)
    engines = {
        "jax": JSpeculativeEngine(jspec_m, jparams_m, make_config(JConfig), 2,
                                  speculator_spec=js, speculator_params=jp),
        "port": SpeculativeEngine(spec, llama[3], make_config(), 2,
                                  speculator_spec=ts, speculator_params=tp,
                                  device="cpu")}
    left = {}
    for name, eng in engines.items():
        rp = JRequestParams() if name == "jax" else RequestParams()
        slot = eng.acquire_slot()
        eng.prefill([slot], [PROMPTS[0]], [rp])
        eng.decode_steps()
        occupant = np.abs(np_(eng.spec_hidden)[slot]).sum()
        assert occupant > 0
        eng.free(slot)
        assert eng.acquire_slot() == slot
        res = eng.prefill([slot], [PROMPTS[1]], [rp],
                          want_prompt_details=True)
        assert res.prompt_details is not None
        left[name] = np.abs(np_(eng.spec_hidden)[slot]).sum() / occupant
    assert left == {"jax": 1.0, "port": 0.0}


def test_programs_and_plan(llama):
    """One verify program on the slot engine; the memory plan counts the
    speculator and the verify working set."""
    spec, params = llama[2:]
    eng = spec_engine(llama)
    assert eng.precompile_decode() == 1
    assert list(eng.programs.programs) == [("verify",)]
    plain = InferenceEngine(spec, params, make_config(), 2, device="cpu")
    assert plain.memory_plan.speculative_bytes == 0
    assert eng.memory_plan.speculative_bytes > 0
    assert (eng.memory_plan.usable_bytes + eng.memory_plan.speculative_bytes
            == plain.memory_plan.usable_bytes)
    assert eng.supports_decode_pipeline is False
    assert eng.supports_chunk_override is False


# --- the server's dispatch and the Batcher ----------------------------------------


def served_config(**kw):
    cfg = ServingConfig(model_name=fixtures.tokenized_model_dir(),
                        max_sequence_length=64, max_new_tokens=32,
                        max_batch_slots=2, prefill_buckets=[8, 16],
                        dtype_str="float32", kv_page_size=8, **kw)
    cfg.validate()
    return cfg


@pytest.mark.parametrize("paged", ["1", "0"])
def test_build_engine_dispatches_speculator(tmp_path, monkeypatch, paged):
    spec, _ = families.load_model(fixtures.tokenized_model_dir(),
                                  dtype=torch.float32, device="cpu")
    monkeypatch.setenv("PAGED_ATTENTION", paged)
    want = PagedSpeculativeEngine if paged == "1" else SpeculativeEngine
    monkeypatch.setenv("SPECULATOR", "1")
    monkeypatch.setenv("SPECULATOR_N_PREDICT", "2")
    eng, _, kind = main.build_engine(served_config(), device="cpu")
    assert type(eng) is want and kind == "decoder"
    assert eng.sspec.n_predict == 2
    assert eng.sspec.inner_dim == max(spec.hidden_size // 2, 64)
    monkeypatch.delenv("SPECULATOR")
    path = write_speculator(tmp_path, spec.vocab_size, spec.hidden_size)
    monkeypatch.setenv("SPECULATOR_PATH", path)
    eng, _, _ = main.build_engine(served_config(), device="cpu")
    assert type(eng) is want
    assert (eng.sspec.n_predict, eng.sspec.inner_dim) == (2, 32)
    s = eng.acquire_slot()
    res = eng.prefill([s], [[5, 9, 23]], [RequestParams(max_new_tokens=8)])
    assert 0 <= int(res.first_token.next_ids[0]) < spec.vocab_size
    assert len(eng.decode_steps()) in (1, 3)


def test_mismatched_speculator_is_refused(tmp_path, monkeypatch):
    spec, _ = families.load_model(fixtures.tokenized_model_dir(),
                                  dtype=torch.float32, device="cpu")
    path = write_speculator(tmp_path, spec.vocab_size, spec.hidden_size * 2)
    monkeypatch.setenv("SPECULATOR_PATH", path)
    with pytest.raises(ValueError, match="does not match"):
        main.build_engine(served_config(), device="cpu")


def test_t5_with_speculator_builds_the_seq2seq_engine(monkeypatch):
    monkeypatch.setenv("SPECULATOR", "1")
    cfg = ServingConfig(model_name=fixtures.golden_t5_dir(),
                        dtype_str="float32", max_sequence_length=64,
                        max_new_tokens=32, max_batch_slots=2,
                        prefill_buckets=[16])
    cfg.validate()
    eng, _, kind = main.build_engine(cfg, device="cpu")
    assert type(eng) is Seq2SeqEngine and kind == "encoder_decoder"


class TinyTok:
    eos_token_id = 2

    def decode(self, ids, skip_special_tokens=True):
        return "".join(f"<{i}>" for i in ids)

    def id_to_token(self, i):
        return f"<{i}>"


def batcher_results(engine, n=10):
    """Two requests through the port's Batcher, one streaming: (unary
    tokens, streamed tokens, streamed text == final text)."""
    from text_generation_inference_tpu_torch.scheduler.batcher import Batcher
    from text_generation_inference_tpu_torch.scheduler.request import (
        GenRequest, ResponseOptions, StoppingCriteria)

    async def go():
        b = Batcher(engine, TinyTok(), engine.config)
        b.start()
        reqs = [GenRequest(input_text="x", input_ids=p,
                           params=RequestParams(max_new_tokens=n),
                           stopping=StoppingCriteria(max_new_tokens=n),
                           options=ResponseOptions(), streaming=i == 1)
                for i, p in enumerate(PROMPTS)]
        b.submit_all(reqs)
        pieces = []
        while True:
            ev = await asyncio.wait_for(reqs[1].stream_queue.get(), 30)
            if ev[0] in ("token", "final"):
                pieces.append(ev[2])
            if ev[0] == "final":
                break
        for r in reqs:
            await asyncio.wait_for(r.result_future, timeout=30)
        await b.stop()
        return ([[g.token_id for g in r.generated] for r in reqs],
                "".join(pieces) == reqs[1].final_text())

    return asyncio.run(go())


def plain_greedy(engine, n=10):
    return drive(engine, PROMPTS, [RequestParams(max_new_tokens=n)] * 2, n)[0]


def test_batcher_serves_the_plain_tokens(llama):
    spec, params = llama[2:]
    want = plain_greedy(InferenceEngine(spec, params, make_config(), 2,
                                        device="cpu"))
    got, stream_ok = batcher_results(spec_engine(llama))
    assert got == want and stream_ok
