"""The port's learned-position and ALiBi families against the JAX package's,
on the test fixtures' tiny checkpoints (fp32, CPU), and the structural
fallback.

Families: gpt2 (learned positions, Conv1D weights), opt (learned positions
at offset 2, `project_in` / `project_out` at a word dim of 32, relu),
gpt_bigcode (multi-query, learned positions), bloom (ALiBi, embedding
LayerNorm, head-major fused qkv), mpt (ALiBi over 6 heads: MPT's
ceil-and-reorder slopes, no biases) and falcon with `alibi: true` (a copy of
the falcon fixture with the flag set: multi-query, ALiBi).

* The port's spec equals the JAX `*_spec` field by field, and its loader
  gives the JAX loader's params (carried across by `models/convert.py`),
  exactly.
* Logits of a prefill and 4 decode steps agree within 1e-4 of the JAX
  package's, on the slot cache's three write modes and on the paged passes
  (per-step decode and a ring chunk); the caches within 1e-5. The JAX
  package runs on the CPU, where it takes its einsum paths and, for paged
  ALiBi decode, the paged kernel's plain twin.
* The plain versions with slopes (flash prefill's three, S1's two, the
  paged kernel's three, and the dispatch's routes) match the JAX einsum
  and `paged_decode_attention(_partial)_reference(..., alibi_slopes_kg=)`
  within 1e-5.
* Both engines serve every family; `build_engine` builds each.
* The structural fallback: `auto` picks a family by its signature tensor,
  `FALLBACK_FAMILY=<family>` forces one, `off` raises the JAX package's
  ValueError, and a checkpoint no family takes raises.
"""

import json
import math
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_generation_inference_tpu.engine.paged_cache import (
    PagedKVCache as JPagedKVCache)
from text_generation_inference_tpu.models import core as jcore
from text_generation_inference_tpu.models import families as jfamilies
from text_generation_inference_tpu.models import paged_core as jpaged
from text_generation_inference_tpu.ops import attention as jattention
from text_generation_inference_tpu.ops.pallas import paged_attention as jpa
from text_generation_inference_tpu_torch.config import ServingConfig
from text_generation_inference_tpu_torch.engine.engine import (
    InferenceEngine, RequestParams)
from text_generation_inference_tpu_torch.engine.paged_cache import PagedKVCache
from text_generation_inference_tpu_torch.engine.paged_engine import (
    PagedInferenceEngine)
from text_generation_inference_tpu_torch.models import core, families
from text_generation_inference_tpu_torch.models import paged_core as tpaged
from text_generation_inference_tpu_torch.models.convert import params_from_jax
from text_generation_inference_tpu_torch.ops import attention
from text_generation_inference_tpu_torch.ops.cuda import decode_attention as da
from text_generation_inference_tpu_torch.ops.cuda import flash_prefill as fp
from text_generation_inference_tpu_torch.ops.cuda import paged_attention as pa
from tests import fixtures

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
PLAIN_TOL = 1e-5
NAMES = ["gpt2", "opt", "gpt_bigcode", "bloom", "mpt", "falcon_alibi"]
LENGTHS = np.asarray([13, 6], np.int32)
SLOTS = np.asarray([1, 0], np.int32)
STEPS = 4

# the JAX functions compiled once per family (the spec is static)
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


def edited_copy(src: str, dst, **config) -> str:
    """A copy of a fixture checkpoint with config.json fields changed."""
    shutil.copytree(src, dst)
    path = dst / "config.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **config}))
    return str(dst)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    dirs = {name: fixtures.ALL_DECODER_FIXTURES[name]()
            for name in NAMES if name != "falcon_alibi"}
    dirs["falcon_alibi"] = edited_copy(
        fixtures.tiny_falcon(), tmp_path_factory.mktemp("falcon") / "m",
        alibi=True)
    return dirs


@pytest.fixture(scope="module", params=NAMES)
def family(request, model_dirs):
    """(name, JAX spec and params, port spec, port params loaded by the
    port's loader)."""
    model_dir = model_dirs[request.param]
    jspec, jparams = jfamilies.load_model(model_dir, dtype=jnp.float32)
    spec, params = families.load_model(model_dir, dtype=torch.float32,
                                       device="cpu")
    return request.param, jspec, jparams, spec, params


def test_spec_and_params_match_jax(family):
    name, jspec, jparams, spec, params = family
    assert spec == core.DecoderSpec(**vars(jspec))
    assert spec.pos == ("learned" if name in ("gpt2", "opt", "gpt_bigcode")
                        else "alibi")
    if name == "mpt":
        assert spec.alibi_impl == "mpt" and spec.num_heads == 6
    if name == "opt":
        assert "project_in" in params and spec.pos_offset == 2
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


@pytest.mark.parametrize("heads", [6, 8, 12, 32, 48])
@pytest.mark.parametrize("impl", ["bloom", "mpt"])
def test_alibi_slopes_match_jax(heads, impl):
    np.testing.assert_array_equal(core.alibi_slopes(heads, impl),
                                  jcore.alibi_slopes(heads, impl))


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
    passes (which send ALiBi to the paged kernel's plain twin)."""
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


# --- the plain versions with slopes -----------------------------------------


def slopes_kg(kh, g, impl="bloom"):
    return core.alibi_slopes(kh * g, impl).reshape(kh, g)


def normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("kh,g,d", [(2, 3, 64), (1, 4, 128)])
def test_flash_plain_versions_with_slopes_match_jax(kh, g, d):
    """Flash prefill's three plain versions (the kernel's twins at their
    tiles, fp32) and the prefill route (flash at a bucket of 128), given
    slopes, against the JAX einsum with its bias slope * j; without slopes
    they miss it."""
    rng = np.random.default_rng(d + g)
    n, t = 2, 128
    q, k, v = normal(rng, n, t, kh, g, d), normal(rng, n, t, kh, d), \
        normal(rng, n, t, kh, d)
    lengths = np.asarray([128, 77], np.int32)
    sl = slopes_kg(kh, g, "mpt") * 4          # steep: the bias decides
    pos = np.arange(t)
    mask = ((pos[None, :] <= pos[:, None])[None]
            & (pos[None, None, :] < lengths[:, None, None]))
    bias = (sl[:, :, None] * pos[None, None, :].astype(np.float32))[
        None, :, :, None, :]
    want = np.asarray(jattention.prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        jnp.asarray(bias), jnp.asarray(mask), d ** -0.5))
    args = (t_(q), t_(k), t_(v), t_(lengths))
    live = np.arange(t)[None, :] < lengths[:, None]
    for what, got in (
            ("reference", fp.flash_prefill_reference(*args, slopes=t_(sl))),
            ("tiled", fp.flash_prefill_tiled_reference(*args,
                                                       slopes=t_(sl))),
            ("3xtf32", fp.flash_prefill_tf32x3_reference(*args,
                                                         slopes=t_(sl))),
            ("route", attention.prefill_attention(
                *args, t_(sl), t_(mask), d ** -0.5)),
            ("PLAIN", attention.PLAIN.prefill(*args, t_(sl), t_(mask),
                                              d ** -0.5))):
        close(np_(got)[live], want[live], PLAIN_TOL, what)
    unbiased = np_(fp.flash_prefill_reference(*args))[live]
    assert np.abs(unbiased - want[live]).max() > 100 * PLAIN_TOL


@pytest.mark.parametrize("t", [64, 2048])
def test_slot_decode_plain_versions_with_slopes_match_jax(t):
    """The slot decode route (the einsum below 2048 rows, S1's route at
    2048: its plain version and its split twin) given slopes, against the
    JAX dispatch's einsum with its bias."""
    rng = np.random.default_rng(t)
    s, kh, g, d = 3, 2, 4, 64
    q, k, v = normal(rng, s, kh, g, d), normal(rng, s, kh, t, d), \
        normal(rng, s, kh, t, d)
    ctx = np.asarray([1, t // 2 + 3, t], np.int32)
    mask = np.arange(t)[None, :] < ctx[:, None]
    sl = slopes_kg(kh, g) * (64.0 / t)
    bias = sl[None, :, :, None] * np.arange(t, dtype=np.float32)
    want = np.asarray(jattention.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ctx),
        jnp.asarray(bias), jnp.asarray(mask), d ** -0.5))
    args = (t_(q), t_(k), t_(v), t_(ctx))
    got = attention.decode_attention(*args, t_(sl), t_(mask), d ** -0.5)
    close(got, want, PLAIN_TOL, "route")
    close(da.decode_attention_reference(*args, slopes=t_(sl)), want,
          PLAIN_TOL, "reference")
    close(da.decode_attention_split_reference(*args, slopes=t_(sl)), want,
          PLAIN_TOL, "split twin")
    assert np.abs(np_(da.decode_attention_reference(*args)) - want).max() \
        > 100 * PLAIN_TOL


def test_paged_plain_versions_with_slopes_match_jax():
    """The paged kernel's plain versions (normalized, stats, the int8 stats
    over scale pools and the split twin in both modes) given
    `alibi_slopes_kg`, against the JAX references given the same."""
    rng = np.random.default_rng(11)
    s, kh, g, d, page, num_pages = 2, 2, 3, 16, 8, 12
    q = normal(rng, s, kh, g, d)
    kp, vp = normal(rng, kh, num_pages * page, d), \
        normal(rng, kh, num_pages * page, d)
    bt = np.asarray([[3, 0, 7, 9, 11], [5, 2, 1, num_pages, num_pages]],
                    np.int32)
    ctx = np.asarray([37, 21], np.int32)
    sl = slopes_kg(kh, g)
    j = lambda *a: tuple(jnp.asarray(x) for x in a)
    args = (t_(q), t_(kp), t_(vp), t_(bt), t_(ctx))
    want = np.asarray(jpa.paged_decode_attention_reference(
        *j(q, kp, vp, bt, ctx), page, alibi_slopes_kg=jnp.asarray(sl)))
    close(pa.paged_decode_attention_reference(*args, page,
                                              alibi_slopes_kg=t_(sl)),
          want, PLAIN_TOL, "normalized")
    close(pa.paged_decode_split_reference(*args, page, pages_per_split=2,
                                          alibi_slopes_kg=t_(sl)),
          want, PLAIN_TOL, "split twin")
    want = jpa.paged_decode_attention_partial_reference(
        *j(q, kp, vp, bt, ctx), page, alibi_slopes_kg=jnp.asarray(sl))
    for name, got in (
            ("stats", pa.paged_decode_attention_partial_reference(
                *args, page, t_(sl))),
            ("split twin stats", pa.paged_decode_split_reference(
                *args, page, pages_per_split=2, stats=True,
                alibi_slopes_kg=t_(sl)))):
        for a, b in zip(got, want):
            close(a, b, PLAIN_TOL, name)
    k8, ks = core.quantize_kv(t_(kp))
    v8, vs = core.quantize_kv(t_(vp))
    want = jpa.paged_decode_attention_partial_reference(
        *j(q, k8.numpy(), v8.numpy(), bt, ctx), page,
        alibi_slopes_kg=jnp.asarray(sl), k_scale_pool=jnp.asarray(ks.numpy()),
        v_scale_pool=jnp.asarray(vs.numpy()))
    got = attention.PLAIN.paged_decode_partial_i8(
        t_(q), k8, v8, ks, vs, t_(bt), t_(ctx), page, alibi_slopes_kg=t_(sl))
    for a, b in zip(got, want):
        close(a, b, PLAIN_TOL, "int8 stats")


# --- engines, the server and the fallback -------------------------------------


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
    """The slot engine in its three write modes and the paged engine in
    per-step and ring-chunk decode give the same greedy tokens: prompts of
    11 and 5 tokens and 6 decode steps at max_seq 32."""
    name, _, _, spec, params = family
    runs = {}
    for mode, kw in (("post", {}), ("scan", dict(decode_write_mode="scan")),
                     ("ring", dict(decode_chunk=2))):
        eng = InferenceEngine(spec, params, make_config(32, **kw),
                              eos_token_id=-1, device="cpu")
        runs[mode] = serve_greedy(eng, spec, (11, 5), 6)
    for mode, kw in (("paged", {}), ("paged ring", dict(decode_chunk=2))):
        eng = PagedInferenceEngine(spec, params, make_config(32, **kw),
                                   eos_token_id=-1, num_pages=16,
                                   device="cpu")
        runs[mode] = serve_greedy(eng, spec, (11, 5), 6)
    assert len({json.dumps(r) for r in runs.values()}) == 1, (name, runs)


class _Tokenizer:
    eos_token_id = 5


@pytest.mark.parametrize("name", NAMES)
def test_server_builds_every_family(monkeypatch, model_dirs, name):
    """`server.main.build_engine` loads each family on both engines."""
    from text_generation_inference_tpu_torch.server import main

    cfg = ServingConfig(model_name=model_dirs[name], dtype_str="float32",
                        max_sequence_length=8, max_new_tokens=4,
                        max_batch_slots=2, prefill_buckets=[8],
                        kv_page_size=8)
    cfg.validate()
    monkeypatch.setattr(main.ServingTokenizer, "load",
                        staticmethod(lambda path: _Tokenizer()))
    for paged, cls in (("1", PagedInferenceEngine), ("0", InferenceEngine)):
        monkeypatch.setenv("PAGED_ATTENTION", paged)
        eng, _, kind = main.build_engine(cfg, device="cpu")
        assert type(eng) is cls and kind == "decoder" and eng.eos_token_id == 5


def renamed(tmp_path, src, model_type="my_custom_lm", **config):
    return edited_copy(src, tmp_path / "m", model_type=model_type, **config)


@pytest.mark.parametrize("source,family_name", [
    ("llama", "llama"), ("bloom", "bloom"), ("mpt", "mpt"),
    ("gpt2", "gpt_bigcode")])
def test_fallback_auto_picks_by_signature(monkeypatch, tmp_path, source,
                                          family_name):
    """An unknown model type with a family's tensor names loads as that
    family, as the JAX fallback loads it: the same spec and params. A GPT-2
    clone matches gpt_bigcode's signature first, as in the JAX order (its
    Conv1D weights then load transposed, in both packages)."""
    monkeypatch.delenv("FALLBACK_FAMILY", raising=False)
    model_dir = renamed(tmp_path, fixtures.ALL_DECODER_FIXTURES[source]())
    jspec, jparams = jfamilies.load_model(model_dir, dtype=jnp.float32)
    spec, params = families.load_model(model_dir, dtype=torch.float32,
                                       device="cpu")
    assert spec == core.DecoderSpec(**vars(jspec))
    assert spec == families.FAMILIES[family_name][0](
        families.load_hf_config(model_dir))
    carried = params_from_jax(spec, jax.tree_util.tree_map(np.asarray,
                                                           jparams),
                              device="cpu")
    assert set(params) == set(carried)
    for key in ("embed_tokens", "final_norm"):
        for a, b in zip(jax.tree_util.tree_leaves(params[key]),
                        jax.tree_util.tree_leaves(carried[key])):
            assert torch.equal(a, b), key
    for key, w in params["layers"].items():
        if isinstance(w, torch.Tensor):
            assert torch.equal(w, carried["layers"][key]), key


def test_fallback_family_forced(monkeypatch, tmp_path):
    """FALLBACK_FAMILY=<family> loads through that family only; a name that
    is not a family raises."""
    model_dir = renamed(tmp_path, fixtures.tiny_opt())
    monkeypatch.setenv("FALLBACK_FAMILY", "opt")
    spec, params = families.load_model(model_dir, dtype=torch.float32,
                                       device="cpu")
    assert spec.pos_offset == 2 and "project_in" in params
    monkeypatch.setenv("FALLBACK_FAMILY", "llama")
    with pytest.raises(ValueError, match="fallback attempts failed"):
        families.load_model(model_dir, dtype=torch.float32, device="cpu")
    monkeypatch.setenv("FALLBACK_FAMILY", "no_such_family")
    with pytest.raises(ValueError, match="is not a known family"):
        families.load_model(model_dir, dtype=torch.float32, device="cpu")


def test_fallback_off_raises_as_jax(monkeypatch, tmp_path):
    model_dir = renamed(tmp_path, fixtures.tiny_llama())
    monkeypatch.setenv("FALLBACK_FAMILY", "off")
    with pytest.raises(ValueError) as want:
        jfamilies.load_model(model_dir, dtype=jnp.float32)
    with pytest.raises(ValueError) as got:
        families.load_model(model_dir, dtype=torch.float32, device="cpu")
    assert str(got.value) == str(want.value)
    assert "unsupported model_type 'my_custom_lm'" in str(got.value)


def test_fallback_without_a_signature_raises(monkeypatch, tmp_path):
    """A checkpoint whose tensors follow no family's names: both packages
    raise that no signature matched."""
    from safetensors.torch import save_file

    monkeypatch.delenv("FALLBACK_FAMILY", raising=False)
    model_dir = tmp_path / "m"
    model_dir.mkdir()
    (model_dir / "config.json").write_text(json.dumps(
        {"model_type": "my_custom_lm", "vocab_size": 16}))
    save_file({"encoder.blocks.0.weight": torch.zeros(4, 4)},
              str(model_dir / "model.safetensors"))
    for load in (lambda: jfamilies.load_model(str(model_dir)),
                 lambda: families.load_model(str(model_dir),
                                             dtype=torch.float32,
                                             device="cpu")):
        with pytest.raises(ValueError, match="no family signature tensor"):
            load()


def test_falcon_loader_reads_biases_and_the_second_norm(tmp_path):
    """Falcon with `bias: true` and `parallel_attn: false` (falcon-rw-1b's
    layout, written by transformers; RoPE, since transformers scales
    Falcon's ALiBi bias by 1 / sqrt(D) where the JAX package, which the
    port follows, does not): the port's loader reads the q/k/v, out and MLP
    biases and `post_attention_layernorm`, and its prefill logits match
    transformers' forward pass."""
    from transformers import FalconConfig, FalconForCausalLM

    torch.manual_seed(12)
    cfg = FalconConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, multi_query=False, parallel_attn=False,
        new_decoder_architecture=False, alibi=False, bias=True,
        attention_dropout=0.0, hidden_dropout=0.0)
    hf = FalconForCausalLM(cfg).eval()
    with torch.no_grad():
        for p in hf.parameters():
            p.add_(torch.randn_like(p) * 0.02)   # nonzero biases and norms
    hf.save_pretrained(tmp_path, safe_serialization=True)
    spec, params = families.load_model(str(tmp_path), dtype=torch.float32,
                                       device="cpu")
    assert not spec.parallel_residual
    for key in ("bq", "bk", "bv", "bo", "b_up", "b_down"):
        assert key in params["layers"], key
    assert not torch.equal(params["layers"]["ln1"]["scale"],
                           params["layers"]["ln2"]["scale"])
    ids = torch.tensor([[5, 9, 17, 3, 22, 41, 7]])
    with torch.no_grad():
        want = hf(ids).logits
    cache = core.KVCache.create(spec, 1, 8, torch.float32, "cpu")
    got, _ = core.prefill(spec, params, ids.to(torch.int32),
                          torch.tensor([7], dtype=torch.int32),
                          torch.tensor([0], dtype=torch.int32), cache)
    close(got, want, 1e-4, "falcon-rw layout")


def test_learned_positions_clamp_past_the_table():
    """A dead slot's position past the learned-position table reads its
    last row instead of indexing out of bounds."""
    spec = core.DecoderSpec(vocab_size=8, hidden_size=4, num_layers=1,
                            num_heads=1, num_kv_heads=1, head_dim=4,
                            intermediate_size=8, pos="learned",
                            pos_offset=2, norm="layernorm")
    params = {"embed_tokens": torch.zeros(8, 4),
              "embed_positions": torch.arange(24.0).reshape(6, 4)}
    x = core._embed(spec, params, torch.tensor([1, 2]), torch.tensor([0, 9]))
    assert torch.equal(x, params["embed_positions"][[2, 5]])
    assert math.isfinite(float(x.sum()))
