"""The port's RoPE families beyond Llama against the JAX package's, on the
test fixtures' tiny checkpoints (fp32, CPU).

Families: mistral (sliding window 8), qwen2 (q/k/v biases), gemma (norm
offset, embed scale, gelu-tanh GLU, tied embeddings), gpt_neox (partial
rotary 0.25, fused head-major qkv, parallel residual with two norms), gptj
and codegen (interleaved rotary over 8 of 16 lanes, CodeGen's mp_num = 4
qkv, the shared ln_1, lm_head bias), phi (partial rotary 0.5, biases
everywhere, shared norm) and falcon (multi-query, RoPE, no biases).

* The port's spec equals the JAX `*_spec` field by field, and its loader
  gives the JAX loader's params (carried across by `models/convert.py`),
  exactly.
* Logits of a prefill and 4 decode steps agree within 1e-4 of the JAX
  package's, on the slot cache's three write modes ("post", "scan", and the
  ring chunk with its flush) and on the paged passes (per-step decode and a
  ring chunk); the caches within 1e-5. Prompts of 13 and 6 tokens, so
  mistral's window of 8 cuts both the prefill and every decode step. The
  JAX package runs on the CPU, where it takes its einsum paths.
* Both port engines serve every family; the paged engine refuses a window
  shorter than max_seq with the JAX engine's message; the server builds
  every family. The learned-position and ALiBi families are held to the
  JAX package in `test_torch_families_alibi.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_generation_inference_tpu.config import ServingConfig as JConfig
from text_generation_inference_tpu.engine.paged_cache import (
    PagedKVCache as JPagedKVCache)
from text_generation_inference_tpu.engine.paged_engine import (
    PagedInferenceEngine as JPagedEngine)
from text_generation_inference_tpu.models import core as jcore
from text_generation_inference_tpu.models import families as jfamilies
from text_generation_inference_tpu.models import paged_core as jpaged
from text_generation_inference_tpu_torch.config import ServingConfig
from text_generation_inference_tpu_torch.engine.engine import (
    InferenceEngine, RequestParams)
from text_generation_inference_tpu_torch.engine.paged_cache import PagedKVCache
from text_generation_inference_tpu_torch.engine.paged_engine import (
    PagedInferenceEngine)
from text_generation_inference_tpu_torch.models import core, families
from text_generation_inference_tpu_torch.models import paged_core as tpaged
from text_generation_inference_tpu_torch.models.convert import params_from_jax
from tests import fixtures

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
FAMILIES = {
    "mistral": fixtures.tiny_mistral,
    "qwen2": fixtures.tiny_qwen2,
    "gemma": fixtures.tiny_gemma,
    "gpt_neox": fixtures.tiny_neox,
    "gptj": fixtures.tiny_gptj,
    "codegen": fixtures.tiny_codegen,
    "phi": fixtures.tiny_phi,
    "falcon": fixtures.tiny_falcon,
}
LENGTHS = np.asarray([13, 6], np.int32)   # a bucket of 16; window 8 cuts both
SLOTS = np.asarray([1, 0], np.int32)
STEPS = 4

# the JAX functions compiled once per family (the spec is static), so that
# the 4 steps of a mode reuse one program; on the CPU they take the einsum
# paths
J = {
    "prefill": jax.jit(jcore.prefill, static_argnums=(0,)),
    "decode": jax.jit(jcore.decode, static_argnums=(0,),
                      static_argnames=("write_mode",)),
    "ring_step": jax.jit(jcore.decode_ring_step, static_argnums=(0,)),
    "ring_flush": jax.jit(jcore.ring_flush),
    "prefill_paged": jax.jit(jpaged.prefill_paged, static_argnums=(0, 6)),
    "decode_paged": jax.jit(jpaged.decode_paged, static_argnums=(0, 6)),
    "paged_ring_step": jax.jit(jpaged.decode_paged_ring_step,
                               static_argnums=(0,),
                               static_argnames=("page_size",)),
    "paged_ring_flush": jax.jit(jpaged.paged_ring_flush,
                                static_argnums=(5, 6)),
}


def np_(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def close(got, want, tol, what=""):
    np.testing.assert_allclose(np_(got), np_(want), rtol=tol, atol=tol,
                               err_msg=what)


def t_(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(name, JAX spec and params, port spec, port params loaded by the
    port's loader)."""
    model_dir = FAMILIES[request.param]()
    jspec, jparams = jfamilies.load_model(model_dir, dtype=jnp.float32)
    spec, params = families.load_model(model_dir, dtype=torch.float32,
                                       device="cpu")
    return request.param, jspec, jparams, spec, params


def test_spec_and_params_match_jax(family):
    name, jspec, jparams, spec, params = family
    assert spec == core.DecoderSpec(**vars(jspec))
    assert spec.pos == "rope"
    if name == "mistral":
        assert spec.sliding_window == 8
    carried = params_from_jax(spec, jax.tree_util.tree_map(np.asarray,
                                                           jparams),
                              device="cpu")

    def same(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), (path, set(a) ^ set(b))
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path

    same(params, carried, name)


def prompts(spec):
    rng = np.random.default_rng(7)
    return rng.integers(3, spec.vocab_size - 1,
                        size=(2, 16)).astype(np.int32)


@pytest.mark.parametrize("mode", ["post", "scan", "ring"])
def test_slot_cache_logits_match_jax(family, mode):
    """`core.prefill` into slots 1 and 0, then 4 decode steps in `mode`
    (ring: one chunk of 4 ring steps and its flush), every logit and the
    caches against the JAX functions."""
    name, jspec, jparams, spec, params = family
    ids = prompts(spec)
    t_max, n = 32, 2
    jc = jcore.KVCache.create(jspec, n, t_max, jnp.float32)
    tc = core.KVCache.create(spec, n, t_max, torch.float32, "cpu")
    jl, jc = J["prefill"](jspec, jparams, jnp.asarray(ids),
                          jnp.asarray(LENGTHS), jnp.asarray(SLOTS), jc)
    tl, tc = core.prefill(spec, params, t_(ids), t_(LENGTHS), t_(SLOTS), tc)
    for r, ln in enumerate(LENGTHS):
        close(tl[r, :ln], np.asarray(jl)[r, :ln], LOGIT_TOL, f"{name} prefill")
    # decode rows are slots: slot 1 holds the 13-token prompt
    pos = LENGTHS[::-1].copy()
    step_ids = np.asarray(jnp.argmax(jl[np.arange(n), LENGTHS - 1], -1),
                          np.int32)[::-1].copy()
    if mode == "ring":
        shape = (spec.num_layers, n, spec.num_kv_heads, STEPS, spec.head_dim)
        jk, jv = jnp.zeros(shape), jnp.zeros(shape)
        tk, tv = torch.zeros(shape), torch.zeros(shape)
        start = pos.copy()
    for i in range(STEPS):
        if mode == "ring":
            jl, jka, jva = J["ring_step"](
                jspec, jparams, jnp.asarray(step_ids), jnp.asarray(pos), jc,
                jk, jv, jnp.int32(i), jnp.asarray(start))
            tl, tka, tva = core.decode_ring_step(
                spec, params, t_(step_ids), t_(pos), tc, tk, tv, i,
                t_(start))
            jk = jk.at[:, :, :, i].set(jka)
            jv = jv.at[:, :, :, i].set(jva)
            tk[:, :, :, i] = tka
            tv[:, :, :, i] = tva
        else:
            jl, jc = J["decode"](jspec, jparams, jnp.asarray(step_ids),
                                 jnp.asarray(pos), jc, jnp.asarray(pos + 1),
                                 write_mode=mode)
            tl, tc = core.decode(spec, params, t_(step_ids), t_(pos), tc,
                                 t_(pos + 1), write_mode=mode)
        close(tl, jl, LOGIT_TOL, f"{name} {mode} step {i}")
        step_ids = np.asarray(jnp.argmax(jl, -1), np.int32)
        pos = pos + 1
    if mode == "ring":
        jc = J["ring_flush"](jc, jk, jv, jnp.asarray(start))
        tc = core.ring_flush(tc, tk, tv, t_(start))
    close(tc.k, jc.k, CACHE_TOL, f"{name} {mode} k cache")
    close(tc.v, jc.v, CACHE_TOL, f"{name} {mode} v cache")


PAGE, NUM_PAGES, MAX_PAGES = 8, 10, 4
BT = np.asarray([[4, 0, 7, NUM_PAGES], [9, 2, 5, NUM_PAGES]], np.int32)


def test_paged_logits_match_jax(family):
    """`prefill_paged` into slots 1 and 0, 4 per-step `decode_paged` steps,
    then a ring chunk of 2 steps and its flush, against the JAX paged
    passes (no window there: the paged engine serves a windowed model only
    up to max_seq <= window)."""
    name, jspec, jparams, spec, params = family
    ids = prompts(spec)
    n = 2
    shape = (spec.num_layers, spec.num_kv_heads, NUM_PAGES * PAGE,
             spec.head_dim)
    jc = JPagedKVCache(k=jnp.zeros(shape), v=jnp.zeros(shape),
                       block_table=jnp.asarray(BT))
    tc = PagedKVCache(k=torch.zeros(shape), v=torch.zeros(shape),
                      block_table=t_(BT))
    jl, jc = J["prefill_paged"](jspec, jparams, jnp.asarray(ids),
                                jnp.asarray(LENGTHS), jnp.asarray(SLOTS),
                                jc, PAGE)
    tl, tc = tpaged.prefill_paged(spec, params, t_(ids), t_(LENGTHS),
                                  t_(SLOTS), tc, PAGE)
    for r, ln in enumerate(LENGTHS):
        close(tl[r, :ln], np.asarray(jl)[r, :ln], LOGIT_TOL, f"{name} prefill")
    pos = LENGTHS[::-1].copy()
    step_ids = np.asarray(jnp.argmax(jl[np.arange(n), LENGTHS - 1], -1),
                          np.int32)[::-1].copy()
    for i in range(STEPS):
        jl, jc = J["decode_paged"](jspec, jparams, jnp.asarray(step_ids),
                                   jnp.asarray(pos), jc,
                                   jnp.asarray(pos + 1), PAGE)
        tl, tc = tpaged.decode_paged(spec, params, t_(step_ids), t_(pos), tc,
                                     t_(pos + 1), PAGE)
        close(tl, jl, LOGIT_TOL, f"{name} paged step {i}")
        step_ids = np.asarray(jnp.argmax(jl, -1), np.int32)
        pos = pos + 1
    chunk = 2
    buf = (spec.num_layers, n, spec.num_kv_heads, chunk, spec.head_dim)
    jk, jv = jnp.zeros(buf), jnp.zeros(buf)
    tk, tv = torch.zeros(buf), torch.zeros(buf)
    start = pos.copy()
    for i in range(chunk):
        jl, jka, jva = J["paged_ring_step"](
            jspec, jparams, jnp.asarray(step_ids), jnp.asarray(pos), jc, jk,
            jv, jnp.int32(i), jnp.asarray(start), page_size=PAGE)
        tl, tka, tva = tpaged.decode_paged_ring_step(
            spec, params, t_(step_ids), t_(pos), tc, tk, tv, i, t_(start),
            page_size=PAGE)
        close(tl, jl, LOGIT_TOL, f"{name} paged ring step {i}")
        jk, jv = jk.at[:, :, :, i].set(jka), jv.at[:, :, :, i].set(jva)
        tk[:, :, :, i], tv[:, :, :, i] = tka, tva
        step_ids = np.asarray(jnp.argmax(jl, -1), np.int32)
        pos = pos + 1
    active = np.ones(n, bool)
    jc = J["paged_ring_flush"](jc, jk, jv, jnp.asarray(start),
                               jnp.asarray(active), MAX_PAGES * PAGE, PAGE)
    tc = tpaged.paged_ring_flush(tc, tk, tv, t_(start), t_(active),
                                 MAX_PAGES * PAGE, PAGE)
    close(tc.k, jc.k, CACHE_TOL, f"{name} paged k pool")
    close(tc.v, jc.v, CACHE_TOL, f"{name} paged v pool")


# --- engines and the server ---------------------------------------------------


def serve_greedy(eng, spec, lens, steps):
    """Two prompts prefilled together, then `steps` decode steps; greedy
    tokens."""
    rng = np.random.default_rng(3)
    ps = [[int(x) for x in rng.integers(3, spec.vocab_size - 1, size=n)]
          for n in lens]
    slots = [eng.acquire_slot(), eng.acquire_slot()]
    res = eng.prefill(slots, ps, [RequestParams(max_new_tokens=steps + 1)] * 2)
    toks = [[int(res.first_token.next_ids[i])] for i in range(2)]
    while len(toks[0]) <= steps:
        for step in eng.decode_steps():
            for i, s in enumerate(slots):
                toks[i].append(int(step.next_ids[s]))
    for s in slots:
        eng.free(s)
    return [t[:steps + 1] for t in toks]


def make_config(max_seq, **kw):
    cfg = ServingConfig(max_sequence_length=max_seq,
                        max_new_tokens=min(20, max_seq),
                        max_batch_slots=2, prefill_buckets=[8, 16],
                        kv_page_size=8, **kw)
    cfg.validate()
    return cfg


def test_both_engines_serve_the_family(family):
    """The slot engine in its three write modes and the paged engine give
    the same greedy tokens: prompts of 11 and 5 tokens and 6 decode steps
    at max_seq 32 (mistral's window of 8 cuts them on the slot engine);
    mistral's paged engine at max_seq 8, its window, against the slot
    engine there (prompts of 4 and 2 tokens, 2 steps)."""
    name, _, _, spec, params = family
    runs = {}
    for mode, kw in (("post", {}), ("scan", dict(decode_write_mode="scan")),
                     ("ring", dict(decode_chunk=2))):
        eng = InferenceEngine(spec, params, make_config(32, **kw),
                              eos_token_id=-1, device="cpu")
        runs[mode] = serve_greedy(eng, spec, (11, 5), 6)
    assert runs["post"] == runs["scan"] == runs["ring"], name
    max_seq, lens, steps = (8, (4, 2), 2) if spec.sliding_window else (
        32, (11, 5), 6)
    paged = PagedInferenceEngine(spec, params, make_config(max_seq),
                                 eos_token_id=-1, num_pages=16, device="cpu")
    want = (runs["post"] if max_seq == 32 else serve_greedy(
        InferenceEngine(spec, params, make_config(max_seq), eos_token_id=-1,
                        device="cpu"), spec, lens, steps))
    assert serve_greedy(paged, spec, lens, steps) == want, name


def test_paged_engine_refuses_a_short_window_as_jax():
    model_dir = fixtures.tiny_mistral()
    jspec, jparams = jfamilies.load_model(model_dir, dtype=jnp.float32)
    spec, params = families.load_model(model_dir, dtype=torch.float32,
                                       device="cpu")
    jcfg = JConfig(max_sequence_length=64, max_new_tokens=16,
                   max_batch_slots=2, prefill_buckets=[16], kv_page_size=8)
    jcfg.validate()
    with pytest.raises(ValueError) as want:
        JPagedEngine(jspec, jparams, jcfg, eos_token_id=2, num_pages=16)
    with pytest.raises(ValueError) as got:
        PagedInferenceEngine(spec, params, make_config(64), eos_token_id=2,
                             num_pages=16, device="cpu")
    assert str(got.value) == str(want.value)
    assert "window=8" in str(got.value)
    # within the window the paged engine serves it
    PagedInferenceEngine(spec, params, make_config(8), eos_token_id=2,
                         num_pages=16, device="cpu")


class _Tokenizer:
    def __init__(self, eos):
        self.eos_token_id = eos


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_server_builds_every_family(monkeypatch, name):
    """`server.main.build_engine` loads each family on both engines and
    picks the eos id as the JAX entrypoint does: the tokenizer's, else
    config.json's, else it raises (the fixtures carry no tokenizer; qwen2's
    config has no eos id)."""
    from text_generation_inference_tpu_torch.server import main

    model_dir = FAMILIES[name]()
    cfg = ServingConfig(model_name=model_dir, dtype_str="float32",
                        max_sequence_length=8, max_new_tokens=4,
                        max_batch_slots=2, prefill_buckets=[8],
                        kv_page_size=8)
    cfg.validate()
    config_eos = families.load_hf_config(model_dir).get("eos_token_id")
    for tok_eos in (None, 5):
        monkeypatch.setattr(main.ServingTokenizer, "load",
                            staticmethod(lambda path: _Tokenizer(tok_eos)))
        eos = config_eos if tok_eos is None else tok_eos
        for paged, cls in (("1", PagedInferenceEngine),
                           ("0", InferenceEngine)):
            monkeypatch.setenv("PAGED_ATTENTION", paged)
            if eos is None:
                with pytest.raises(ValueError, match="eos_token_id"):
                    main.build_engine(cfg, device="cpu")
                continue
            eng, _, kind = main.build_engine(cfg, device="cpu")
            assert type(eng) is cls and kind == "decoder"
            assert eng.eos_token_id == eos
