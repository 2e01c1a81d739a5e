"""The port's prompt-prefix (PEFT soft-prompt) store and its injection into
prefill, against the JAX package (fp32, CPU).

* `utils/prompt_cache.py`, the port's own copy: the store cases of
  tests/test_prompt_cache.py (raw `decoder.pt`, PEFT safetensors and
  `adapter_model.bin`, missing, bad dim, too long, path traversal, eviction
  by size, cache-hit identity); every loaded tensor equals the JAX store's.
* Engine parity on tiny_llama, paged and slot engine: a staggered batch
  mixes a prefixed and an unprefixed request, then a second prefix lands
  on the freed slot (and pages). Greedy tokens equal the JAX engine's with
  the same store, logprobs within 5e-4 (the repo's golden tolerance), and
  prompt details cover the prompt tokens only (offset by the prefix).
* The soft prompt changes its own request's output and nothing else: the
  unprefixed neighbour generates what it generates alone (isolation, as
  tests/test_prompt_cache.py checks for the JAX engine).
* One gRPC Generate with a `prefix_id` through the port's server, and one
  with an unknown id, which the validation refuses.
"""

import grpc
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests import fixtures
from tests.test_torch_server import PortServer
from text_generation_inference_tpu.config import ServingConfig as JConfig
from text_generation_inference_tpu.engine.engine import (
    InferenceEngine as JSlotEngine, RequestParams as JRequestParams)
from text_generation_inference_tpu.engine.paged_engine import (
    PagedInferenceEngine as JPagedEngine)
from text_generation_inference_tpu.models import families as jfamilies
from text_generation_inference_tpu.utils.prompt_cache import (
    PrefixCache as JPrefixCache)
from text_generation_inference_tpu_torch.config import ServingConfig
from text_generation_inference_tpu_torch.engine.engine import (
    InferenceEngine, RequestParams)
from text_generation_inference_tpu_torch.engine.paged_engine import (
    PagedInferenceEngine)
from text_generation_inference_tpu_torch.models import families
from text_generation_inference_tpu_torch.pb import generation_pb2 as pb
from text_generation_inference_tpu_torch.utils.prompt_cache import (
    InvalidPrefix, PrefixCache, PrefixEntry, PrefixNotFound)

DIM = 64
LOGPROB_TOL = 5e-4


def write_raw_prefix(root, name, arr, file="decoder.pt"):
    d = root / name
    d.mkdir(parents=True, exist_ok=True)
    torch.save(torch.tensor(arr), d / file)


def write_peft_prefix(root, name, arr):
    from safetensors.numpy import save_file

    d = root / name
    d.mkdir(parents=True, exist_ok=True)
    save_file({"prompt_embeddings": arr}, d / "adapter_model.safetensors")


@pytest.fixture
def store(tmp_path):
    rng = np.random.default_rng(0)
    write_raw_prefix(tmp_path, "raw1", rng.normal(size=(4, DIM)).astype(np.float32))
    write_peft_prefix(tmp_path, "peft1", rng.normal(size=(6, DIM)).astype(np.float32))
    d = tmp_path / "peft_bin"
    d.mkdir()
    torch.save({"prompt_embeddings": torch.tensor(
        rng.normal(size=(3, DIM)).astype(np.float32))}, d / "adapter_model.bin")
    write_raw_prefix(tmp_path, "bad_dim", rng.normal(size=(4, DIM + 1)).astype(np.float32))
    write_raw_prefix(tmp_path, "too_long", rng.normal(size=(300, DIM)).astype(np.float32))
    return tmp_path


# --- the store -------------------------------------------------------------------


class TestLoading:
    @pytest.mark.parametrize("name,length", [("raw1", 4), ("peft1", 6),
                                             ("peft_bin", 3)])
    def test_formats_match_jax(self, store, name, length):
        pc = PrefixCache(store, embed_dim=DIM)
        entry = pc.get_entry(name)
        assert isinstance(entry, PrefixEntry)
        assert entry.decoder.shape == (length, DIM)
        assert entry.decoder.dtype == np.float32
        assert pc.prefix_length(name) == length
        np.testing.assert_array_equal(
            pc.get(name), JPrefixCache(store, embed_dim=DIM).get(name))

    def test_missing(self, store):
        pc = PrefixCache(store, embed_dim=DIM)
        with pytest.raises(PrefixNotFound):
            pc.get("nope")
        (store / "empty").mkdir()
        with pytest.raises(PrefixNotFound):
            pc.get("empty")

    def test_bad_dim(self, store):
        with pytest.raises(InvalidPrefix):
            PrefixCache(store, embed_dim=DIM).get("bad_dim")

    def test_too_long(self, store):
        with pytest.raises(InvalidPrefix):
            PrefixCache(store, embed_dim=DIM, max_prefix_length=256).get(
                "too_long")

    @pytest.mark.parametrize("bad_id", ["../evil", "/abs/path", "a/../../b", ""])
    def test_path_traversal_rejected(self, store, bad_id):
        with pytest.raises(InvalidPrefix):
            PrefixCache(store, embed_dim=DIM).get(bad_id)


class TestLru:
    def test_eviction_by_size(self, store):
        # each prefix is 4*64*4 = 1KB; cap the cache at ~2 entries
        rng = np.random.default_rng(1)
        for i in range(5):
            write_raw_prefix(store, f"p{i}",
                             rng.normal(size=(4, DIM)).astype(np.float32))
        pc = PrefixCache(store, embed_dim=DIM, max_size_mb=1)
        pc.max_bytes = 2 * 4 * DIM * 4 + 1
        for i in range(5):
            pc.get(f"p{i}")
        assert len(pc) <= 3
        assert "p4" in pc._cache and "p0" not in pc._cache
        pc.clear()
        assert len(pc) == 0

    def test_cache_hit_identity(self, store):
        pc = PrefixCache(store, embed_dim=DIM)
        assert pc.get("raw1") is pc.get("raw1")

    def test_encoder_decoder_entry(self, store):
        """tests/test_prompt_cache.py's seq2seq entry: `decoder.pt` beside
        `encoder.pt`, both equal to the JAX store's; an encoder-only entry
        has no decoder tensor to `get`."""
        rng = np.random.default_rng(3)
        write_raw_prefix(store, "s2s", rng.normal(size=(4, DIM)).astype(np.float32))
        write_raw_prefix(store, "s2s", rng.normal(size=(6, DIM)).astype(np.float32),
                         file="encoder.pt")
        write_raw_prefix(store, "enc_only",
                         rng.normal(size=(5, DIM)).astype(np.float32),
                         file="encoder.pt")
        pc, jpc = PrefixCache(store, embed_dim=DIM), JPrefixCache(store, embed_dim=DIM)
        entry, jentry = pc.get_entry("s2s"), jpc.get_entry("s2s")
        assert entry.decoder.shape == (4, DIM)
        assert entry.encoder.shape == (6, DIM)
        assert pc.prefix_length("s2s") == jpc.prefix_length("s2s") == 10
        np.testing.assert_array_equal(entry.decoder, jentry.decoder)
        np.testing.assert_array_equal(entry.encoder, jentry.encoder)
        assert pc._bytes == 10 * DIM * 4
        assert pc.get_entry("enc_only").decoder is None
        assert pc.prefix_length("enc_only") == 5
        with pytest.raises(InvalidPrefix):
            pc.get("enc_only")


# --- the engines ---------------------------------------------------------------

PROMPT_A = [5, 9, 23, 77]
PROMPT_B = [100, 3, 250, 17, 88, 91, 12]
PROMPT_C = [7, 7, 7, 40]
ENGINES = {"paged": (PagedInferenceEngine, JPagedEngine),
           "slot": (InferenceEngine, JSlotEngine)}


def make_engine(kind, jax_side, spec, params, **kw):
    cls = ENGINES[kind][1 if jax_side else 0]
    cfg = (JConfig if jax_side else ServingConfig)(
        max_sequence_length=64, max_new_tokens=32, max_batch_slots=2,
        prefill_buckets=[8, 16], kv_page_size=8, decode_chunk=4, **kw)
    cfg.validate()
    extra = {} if jax_side else {"device": "cpu"}
    if kind == "paged":
        extra["num_pages"] = 10
    return cls(spec, params, cfg, eos_token_id=2, **extra)


def staggered(eng, rp_cls, prefix_a, prefix_c):
    """A (behind prefix_a) and B (none) prefilled together with prompt
    details, 8 steps; A freed; C (behind prefix_c) on A's slot and pages,
    8 more steps. Returns ({name: [(token, logprob), ...]}, details)."""
    out = {}

    def first(res, names):
        for i, n in enumerate(names):
            out[n] = [(int(res.first_token.next_ids[i]),
                       float(res.first_token.logprob[i]))]

    def decode(n_steps, slots):
        for _ in range(n_steps // eng.decode_chunk):
            for step in eng.decode_steps():
                for name, s in slots.items():
                    out[name].append((int(step.next_ids[s]),
                                      float(step.logprob[s])))

    sa, sb = eng.acquire_slot(), eng.acquire_slot()
    res = eng.prefill([sa, sb], [PROMPT_A, PROMPT_B],
                      [rp_cls(max_new_tokens=20)] * 2,
                      want_prompt_details=True,
                      prefix_embeds=[prefix_a, None])
    first(res, ["a", "b"])
    decode(8, {"a": sa, "b": sb})
    eng.free(sa)
    sc = eng.acquire_slot()
    first(eng.prefill([sc], [PROMPT_C], [rp_cls(max_new_tokens=20)],
                      prefix_embeds=[prefix_c]), ["c"])
    decode(8, {"b": sb, "c": sc})
    eng.free(sb)
    eng.free(sc)
    return out, res.prompt_details


def assert_same_run(got, want):
    assert {k: [t for t, _ in v] for k, v in got.items()} == \
        {k: [t for t, _ in v] for k, v in want.items()}
    for k in want:
        np.testing.assert_allclose([lp for _, lp in got[k]],
                                   [lp for _, lp in want[k]],
                                   rtol=0, atol=LOGPROB_TOL, err_msg=k)


@pytest.fixture(scope="module")
def models():
    model_dir = fixtures.tiny_llama()
    return (families.load_model(model_dir, dtype=torch.float32, device="cpu"),
            jfamilies.load_model(model_dir, dtype=jnp.float32))


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_prefixed_batch_matches_jax(store, models, kind):
    (spec, params), (jspec, jparams) = models
    pc = PrefixCache(store, embed_dim=DIM)
    entry_a, entry_c = pc.get_entry("raw1"), pc.get_entry("peft1")
    want, want_det = staggered(make_engine(kind, True, jspec, jparams),
                               JRequestParams, entry_a.decoder,
                               entry_c.decoder)
    eng = make_engine(kind, False, spec, params)
    got, got_det = staggered(eng, RequestParams, entry_a, entry_c)
    assert_same_run(got, want)
    # prompt details: the prompt tokens only, the soft prompt's positions
    # skipped (the first prompt token reports no prediction)
    for g, w, prompt in zip(got_det, want_det, (PROMPT_A, PROMPT_B)):
        assert len(g["logprob"]) == len(prompt)
        assert np.isnan(g["logprob"][0]) and g["rank"][0] == 0
        np.testing.assert_allclose(g["logprob"][1:], w["logprob"][1:],
                                   rtol=0, atol=LOGPROB_TOL)
        np.testing.assert_array_equal(g["rank"], w["rank"])
        np.testing.assert_array_equal(g["top_ids"], w["top_ids"])
    # the churned pool / slots leak nothing: the same run again
    assert_same_run(staggered(eng, RequestParams, entry_a, entry_c)[0], want)
    if kind == "paged":
        assert eng.allocator.num_free == 10


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_prefix_changes_its_request_only(store, models, kind):
    (spec, params), _ = models
    eng = make_engine(kind, False, spec, params)
    prefix = PrefixCache(store, embed_dim=DIM).get_entry("raw1")

    def alone(prompt, pe, n=8):
        slot = eng.acquire_slot()
        res = eng.prefill([slot], [prompt], [RequestParams(max_new_tokens=n)],
                          prefix_embeds=[pe])
        toks = [int(res.first_token.next_ids[0])]
        while len(toks) < n:
            toks += [int(s.next_ids[slot]) for s in eng.decode_steps()]
        eng.free(slot)
        return toks[:n]

    mixed, _ = staggered(eng, RequestParams, prefix, prefix)
    plain_a = alone(PROMPT_A, None)
    assert [t for t, _ in mixed["a"]][:8] != plain_a, "soft prompt had no effect"
    assert [t for t, _ in mixed["a"]][:8] == alone(PROMPT_A, prefix)
    # B ran beside a prefixed request and then beside C: unchanged
    assert [t for t, _ in mixed["b"]][:8] == alone(PROMPT_B, None)
    assert alone(PROMPT_A, None) == plain_a, "prefix leaked into a later request"


# --- the gRPC surface ------------------------------------------------------------


@pytest.fixture(scope="module")
def prefix_server(tmp_path_factory):
    root = tmp_path_factory.mktemp("prefix_store")
    spec, _ = families.load_model(fixtures.golden_llama_dir(),
                                  dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(2)
    write_raw_prefix(root, "tuned", rng.normal(
        size=(5, spec.hidden_size)).astype(np.float32))
    server = PortServer("paged", prompt_cache=PrefixCache(
        root, embed_dim=spec.hidden_size))
    channel = grpc.insecure_channel(f"127.0.0.1:{server.port}")
    generate = channel.unary_unary(
        "/fmaas.GenerationService/Generate",
        request_serializer=pb.BatchedGenerationRequest.SerializeToString,
        response_deserializer=pb.BatchedGenerationResponse.FromString)
    yield generate
    channel.close()
    server.close()


def test_grpc_generate_with_prefix_id(prefix_server):
    generate = prefix_server
    params = pb.Parameters(stopping=pb.StoppingCriteria(max_new_tokens=6,
                                                        min_new_tokens=6))

    def ask(prefix_id=""):
        return generate(pb.BatchedGenerationRequest(
            requests=[pb.GenerationRequest(text="Hello there, friend")],
            params=params, prefix_id=prefix_id)).responses[0]

    plain, tuned = ask(), ask("tuned")
    assert tuned.generated_token_count == 6
    assert tuned.input_token_count == plain.input_token_count
    assert tuned.text != plain.text
    assert ask("tuned").text == tuned.text
    with pytest.raises(grpc.RpcError) as e:
        ask("no_such_prefix")
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert "no_such_prefix" in e.value.details()
