"""The port's prefill programs (`engine/programs.py`, `DecodePrograms.
prefill`) on the CPU, against the JAX engines' `_prefill_fns` (tiny_llama
fixture, fp32 weights; buckets 16 and 32, max_seq 64, up to 4 slots).

* Keys: after the same warmup and the same prefills (1, 2 and 3 rows at
  both buckets, a prefill asking for prompt details, one behind a soft
  prompt), the port's prefill-program keys are the JAX engine's prefill
  keys on the slot, the paged, both speculative and the seq2seq engine.
  The JAX engines are live; only their compiled programs are stand-ins
  that record their keys and return zeros (no XLA compile). The one
  exception by design: the JAX warmup also compiles the (rows, bucket)
  pairs past `max_prefill_tokens` padded tokens, which the port's batcher
  never dispatches (F4), and the port's warmup leaves out.
* Staging: one soft-prompt key run twice, the soft prompt on row 0 and
  then on row 1 only, equals a fresh engine's call each time, bit for
  bit (every input buffer is written whole).
* After `warmup()`, a Batcher serving the warm grid makes no new prefill
  program (the port's counterpart of JAX tests/test_engine.py:415-456).
* `reset()` remakes the prefill programs; the memory plan's graph-pool
  term equals a hand count; `decode_replay.prefill_lockstep` runs on the
  CPU, where both engines are eager, as it runs on the card.
"""

import asyncio
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_generation_inference_tpu.config import ServingConfig as JConfig
from text_generation_inference_tpu.engine.engine import (
    InferenceEngine as JSlotEngine)
from text_generation_inference_tpu.engine.engine import (
    RequestParams as JRequestParams)
from text_generation_inference_tpu.engine.paged_engine import (
    PagedInferenceEngine as JPagedEngine)
from text_generation_inference_tpu.engine.seq2seq import (
    Seq2SeqEngine as JSeq2SeqEngine)
from text_generation_inference_tpu.engine.speculative import (
    PagedSpeculativeEngine as JPagedSpecEngine)
from text_generation_inference_tpu.engine.speculative import (
    SpeculativeEngine as JSpecEngine)
from text_generation_inference_tpu.models import families as jfamilies
from text_generation_inference_tpu.models import t5 as jt5
from text_generation_inference_tpu.models.fuse import fuse_params as jfuse
from text_generation_inference_tpu_torch.config import ServingConfig
from text_generation_inference_tpu_torch.engine.engine import (
    InferenceEngine, RequestParams)
from text_generation_inference_tpu_torch.engine.paged_engine import (
    PagedInferenceEngine)
from text_generation_inference_tpu_torch.engine.sampling import TOP_N_CAP
from text_generation_inference_tpu_torch.engine.seq2seq import Seq2SeqEngine
from text_generation_inference_tpu_torch.engine.speculative import (
    PagedSpeculativeEngine, SpeculativeEngine)
from text_generation_inference_tpu_torch.models import paged_core, t5
from text_generation_inference_tpu_torch.models.convert import params_from_jax
from text_generation_inference_tpu_torch.scheduler.batcher import Batcher
from text_generation_inference_tpu_torch.scheduler.request import (
    GenRequest, ResponseOptions, StoppingCriteria)
from text_generation_inference_tpu_torch.tools import decode_replay
from text_generation_inference_tpu_torch.utils.prompt_cache import PrefixEntry
from tests import fixtures

CONFIG = dict(max_sequence_length=64, max_new_tokens=16, max_batch_slots=4,
              prefill_buckets=[16, 32], kv_page_size=8)
PAGES = 64
# a tiny T5 (tests/test_torch_seq2seq.py's shape), random weights
T5_CONFIG = dict(vocab_size=256, d_model=64, d_kv=16, d_ff=128, num_layers=2,
                 num_decoder_layers=2, num_heads=4,
                 relative_attention_num_buckets=8,
                 relative_attention_max_distance=32,
                 feed_forward_proj="gated-gelu", tie_word_embeddings=False,
                 decoder_start_token_id=0, eos_token_id=1, pad_token_id=0,
                 layer_norm_epsilon=1e-6)


@pytest.fixture(scope="module")
def models():
    """The fixture's tiny_llama in both packages, weights carried across."""
    spec, jparams = jfamilies.load_model(fixtures.tiny_llama(),
                                         dtype=jnp.float32)
    jparams = jfuse(spec, jparams)
    tparams = params_from_jax(spec, jax.tree_util.tree_map(np.asarray,
                                                           jparams),
                              device="cpu")
    return spec, jparams, tparams


def _config(cls, **kw):
    cfg = cls(**{**CONFIG, **kw})
    cfg.validate()
    return cfg


class Recorded(dict):
    """Stands in for a JAX engine's dict of compiled prefill programs: a key
    it is asked for gets a stand-in program at once (no compile), which
    hands back the engine's buffers it was given and zero outputs."""

    def __init__(self, kind: str):
        super().__init__()
        self.kind = kind

    def get(self, key, default=None):
        if key not in self:
            self[key] = self._program(key)
        return self[key]

    def _program(self, key):
        n, bucket = key[:2]
        packed = np.zeros((n, 1), np.float32)
        if self.kind == "spec":          # (params, cache, state, hidden, ...)
            return lambda _, cache, state, hidden, *a: (cache, state, hidden,
                                                        packed)
        if self.kind == "seq2seq":       # (params, dstate, state, ...)
            return lambda _, dstate, state, *a, **kw: (dstate, state, packed)
        zeros = np.zeros((n, bucket, 8), np.float32)
        pdet = SimpleNamespace(logprob=zeros[..., 0], rank=zeros[..., 0],
                               top_ids=zeros, top_logprobs=zeros,
                               top_scores=zeros) if key[2] else None
        return lambda _, cache, state, *a: (cache, state, packed, pdet)


def _jax_keys(jeng) -> set:
    return set(jeng._prefill_fns) | set(getattr(jeng, "_spec_prefill_fns",
                                                {}))


def _engine(models, kind, pages=PAGES, **kw):
    """The port's engine of `kind` on the CPU (CONFIG with `kw`)."""
    spec, _, tparams = models
    cfg = _config(ServingConfig, **kw)
    if kind == "slot":
        return InferenceEngine(spec, tparams, cfg, eos_token_id=2,
                               device="cpu")
    if kind == "paged":
        return PagedInferenceEngine(spec, tparams, cfg, eos_token_id=2,
                                    num_pages=pages, device="cpu")
    if kind == "spec-slot":
        return SpeculativeEngine(spec, tparams, cfg, eos_token_id=2,
                                 device="cpu")
    if kind == "spec-paged":
        return PagedSpeculativeEngine(spec, tparams, cfg, eos_token_id=2,
                                      num_pages=pages, device="cpu")
    spec = t5.spec_from_hf_config(T5_CONFIG)
    return Seq2SeqEngine(spec, t5.random_params(spec, "cpu", torch.float32,
                                                seed=3),
                         cfg, eos_token_id=1, device="cpu")


def _jax_engine(models, kind):
    """The JAX engine of `kind` (CONFIG), its programs stand-ins."""
    spec, jparams, _ = models
    cfg = _config(JConfig)
    if kind == "slot":
        jeng = JSlotEngine(spec, jparams, cfg, eos_token_id=2)
    elif kind == "paged":
        jeng = JPagedEngine(spec, jparams, cfg, eos_token_id=2,
                            num_pages=PAGES)
    elif kind == "spec-slot":
        jeng = JSpecEngine(spec, jparams, cfg, eos_token_id=2)
        jeng._spec_prefill_fns = Recorded("spec")
    elif kind == "spec-paged":
        jeng = JPagedSpecEngine(spec, jparams, cfg, eos_token_id=2,
                                num_pages=PAGES)
    else:
        t5_spec = t5.spec_from_hf_config(T5_CONFIG)
        params = t5.random_params(t5_spec, "cpu", torch.float32, seed=3)
        jeng = JSeq2SeqEngine(jt5.spec_from_hf_config(T5_CONFIG),
                              jax.tree_util.tree_map(
                                  lambda x: jnp.asarray(x.numpy()), params),
                              cfg, eos_token_id=1)
    jeng._prefill_fns = Recorded("seq2seq" if kind == "seq2seq"
                                 else "plain")
    jeng.precompile_decode = lambda *a, **kw: 0
    jeng.decode_steps = lambda *a, **kw: []
    return jeng


def _same_prefills(engines, hidden: int) -> None:
    """The same prefills on the JAX engine and the port's: 1, 2 and 3 rows
    at both buckets, one asking for prompt details, one with a soft prompt
    on its first row (a decoder-side and, for seq2seq, an encoder-side
    one)."""
    rng = np.random.default_rng(0)
    vec = rng.normal(size=(5, hidden)).astype(np.float32)
    calls = [(n, length, False, False) for n in (1, 2, 3)
             for length in (10, 20)]
    calls += [(1, 12, True, False), (2, 9, False, True)]
    for n, length, details, prefixed in calls:
        for eng, rp in zip(engines, (JRequestParams, RequestParams)):
            prefixes = None
            if prefixed:
                entry = PrefixEntry(decoder=vec, encoder=vec)
                prefixes = [entry] + [None] * (n - 1)
            slots = [eng.acquire_slot() for _ in range(n)]
            eng.prefill(slots, [[5] * length] * n,
                        [rp(max_new_tokens=4)] * n,
                        want_prompt_details=details, prefix_embeds=prefixes)
            for slot in slots:
                eng.free(slot)


@pytest.mark.parametrize("kind", ["slot", "paged", "spec-slot", "spec-paged",
                                  "seq2seq"])
def test_prefill_keys_are_the_jax_engines_keys(models, kind):
    jeng, eng = _jax_engine(models, kind), _engine(models, kind)
    jeng.warmup()
    eng.warmup()
    jax_warm, warm = _jax_keys(jeng), set(eng.programs.prefill)
    # by design (F4): the JAX warmup compiles the pairs past
    # max_prefill_tokens (64) padded tokens too; the port's warmup leaves
    # them out, as its batcher never dispatches them
    f4 = {k for k in jax_warm if k[0] * k[1] > eng.config.max_prefill_tokens}
    if kind == "seq2seq":
        # the JAX seq2seq warmup takes one row a dispatch (batch_sizes=(1,))
        assert f4 == set() and warm == jax_warm
        assert warm == {(1, b, 1, False, False) for b in (16, 32, 64)}
    else:
        assert {k[:2] for k in f4} == {(4, 32), (2, 64), (4, 64)}
        assert warm == jax_warm - f4
        n_keys = len(warm)
        assert n_keys == 6 and all(len(k) == (2 if kind == "spec-slot"
                                              else 4) for k in warm)
    hidden = getattr(eng.spec, "d_model", None) or eng.spec.hidden_size
    _same_prefills((jeng, eng), hidden)
    assert set(eng.programs.prefill) == _jax_keys(jeng) - f4
    # the keys the prefills met outside the warm grid: 3 rows at both
    # buckets, details (not a key of seq2seq's, whose 2-row dispatches
    # are new), a soft prompt (under the plain engine's keys on the
    # speculative one)
    assert len(set(eng.programs.prefill) - warm) == (
        5 if kind == "seq2seq" else 4)
    # on the CPU a program is the eager step over its static buffers
    assert all(p.graph is None and p.replays >= 1
               for p in eng.programs.prefill.values())


def _prefixed(eng, row: int, seed: int, slots=(1, 2)):
    """A two-row prefill into `slots`, the soft prompt on `row` only: the
    key (2, 32, True, True) whichever the row."""
    rng = np.random.default_rng(seed)
    prompts = [list(rng.integers(3, 250, 12)), list(rng.integers(3, 250, 11))]
    prefixes = [None, None]
    prefixes[row] = rng.normal(size=(6, eng.spec.hidden_size)).astype(
        np.float32)
    out = eng.prefill(list(slots), prompts,
                      [RequestParams(max_new_tokens=4)] * 2,
                      want_prompt_details=True, prefix_embeds=prefixes)
    for slot in slots:
        eng.free(slot)
    return out


def _kv_rows(eng, slot: int) -> list:
    """The k and v rows a prefill wrote for a request in `slot`: its
    prompt's (through the block table of a paged engine; the next row is
    the first decode step's to write)."""
    cache = eng.cache
    if hasattr(cache, "block_table"):
        cache = paged_core.gather_dense_view(
            cache, eng.allocator.max_pages_per_slot, eng.page_size)
    rows = int(eng.state.input_len[slot])
    return [t[:, slot, :, :rows] for t in (cache.k, cache.v)]


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_a_key_run_twice_rewrites_every_input(models, kind):
    eng = _engine(models, kind)
    for i, row in enumerate((0, 1)):
        got = _prefixed(eng, row, seed=i)
        fresh = _engine(models, kind)
        want = _prefixed(fresh, row, seed=i)
        decode_replay._same_rows(got.first_token, want.first_token, [0, 1],
                                 f"call {i}")
        decode_replay._same_details(got.prompt_details, want.prompt_details,
                                    f"call {i}")
        for x, y in zip(eng.state.tensors(), fresh.state.tensors()):
            assert torch.equal(x[[1, 2]], y[[1, 2]])
        for slot in (1, 2):
            for x, y in zip(_kv_rows(eng, slot), _kv_rows(fresh, slot)):
                assert torch.equal(x, y)
    (key,) = eng.programs.prefill
    assert key[2:] == (True, True) and eng.programs.prefill[key].replays == 2


class TinyTok:
    eos_token_id = 2

    def decode(self, ids, skip_special_tokens=True):
        return "".join(f"<{i}>" for i in ids)

    def id_to_token(self, i):
        return f"<{i}>"


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_serving_the_warm_grid_makes_no_prefill_program(models, kind):
    eng = _engine(models, kind)
    eng.warmup()
    warm = {k: p for k, p in eng.programs.prefill.items()}
    assert eng._warmup_batch_grid() == (1, 2, 4)
    replays = sum(p.replays for p in warm.values())

    async def go():
        b = Batcher(eng, TinyTok(), eng.config)
        b.start()
        reqs = []
        # staggered submissions of 1, 2 and 4 rows at both buckets, some
        # prefilled while others decode
        for lens in ([5, 5, 5, 5], [12, 12], [20], [3, 3]):
            for ln in lens:
                reqs.append(GenRequest(
                    input_text="x", input_ids=list(range(1, ln + 1)),
                    params=RequestParams(max_new_tokens=6),
                    stopping=StoppingCriteria(max_new_tokens=6),
                    options=ResponseOptions()))
            for r in reqs[-len(lens):]:
                b.submit(r)
            await asyncio.sleep(0.05)
        for r in reqs:
            await asyncio.wait_for(r.result_future, timeout=60)
        await b.stop()

    asyncio.run(go())
    assert eng.programs.prefill == warm, \
        f"made while serving: {set(eng.programs.prefill) - set(warm)}"
    assert sum(p.replays for p in warm.values()) > replays


def test_reset_remakes_the_prefill_programs(models):
    eng = _engine(models, "paged")
    eng.warmup()
    old = dict(eng.programs.prefill)
    n_decode = len(eng.programs)
    eng.reset()
    assert set(eng.programs.prefill) == set(old)
    assert all(eng.programs.prefill[k] is not old[k] for k in old)
    assert len(eng.programs) == n_decode
    assert len(eng.free_slots) == eng.num_slots


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_the_plan_counts_one_graph_pool(models, kind):
    spec = models[0]
    plan = _engine(models, kind, pages=None, decode_chunk=4,
                   paged_gather_ctx_max=32).memory_plan
    t, s, d, f = 64, 4, spec.hidden_size, spec.intermediate_size
    v, layers, kh, hd = (spec.vocab_size, spec.num_layers, spec.num_kv_heads,
                         spec.head_dim)
    act = (t * (6 * d + 3 * f) * 4 + t * v * 10 + t * v * 32
           + t * t * spec.num_heads * 14)
    # one step's activations, logits and sampling pass; the chunk's k and v
    # rings (f32 model) and packed outputs; the paged engine's dense view of
    # 32 rows a slot (k and v: L x K x D f32 a row)
    dec = (s * (6 * d + 3 * f) * 4 + s * v * (10 + 48)
           + 2 * layers * s * kh * 4 * hd * 4
           + 4 * s * (3 + 3 * TOP_N_CAP) * 4)
    if kind == "paged":
        dec += s * 32 * layers * 2 * kh * hd * 4
    assert plan.activation_bytes == act
    assert plan.decode_bytes == dec
    assert plan.graph_pool_bytes == max(act, dec)
    assert "graph pool" in plan.describe()


@pytest.mark.parametrize("kind", ["slot", "paged", "spec-slot", "spec-paged",
                                  "seq2seq"])
def test_prefill_lockstep_on_the_cpu(models, kind):
    replayed, eager = (_engine(models, kind, pages=256,
                               max_sequence_length=512,
                               prefill_buckets=[64, 128]) for _ in range(2))
    seen = decode_replay.prefill_lockstep(replayed, eager, vocab=256,
                                          max_new=8)
    assert seen["dispatches"] == len(decode_replay.PREFILL_DISPATCHES)
    # the soft-prompt key ran twice
    assert seen["keys"][4] == seen["keys"][5]
    assert replayed.programs.prefill[seen["keys"][4]].replays == 2
