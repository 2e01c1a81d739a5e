"""The port's T5 model (`models/t5.py`) against the JAX package's, on the same
weights (`models/convert.py: t5_params_from_jax`), fp32, CPU.

Three configurations at a few layers and narrow widths, each a seeded
transformers checkpoint: the tests/test_t5.py shape (gated-GELU, untied,
3 decoder layers beside 2 encoder layers), a v1.0 shape (ReLU, tied head,
scaled by d_model^-0.5) and an mt5 config.

* The spec and the loader equal JAX's (every key, every value).
* Relative bucket ids are EQUAL to the JAX `_relative_bucket`'s for every
  relative position in [-2048, 2048], both directions, at (32, 128) and at
  the fixtures' (8, 32).
* One JAX jit per configuration runs the whole scenario (`_scenario`):
  `encode` with and without an encoder prefix, `decoder_prefill` with a
  decoder prefix into 3 of 4 slots, 4 `decoder_step`s, then 4
  `decoder_ring_step`s (one slot's chunk crossing T_dec) and
  `ring_flush_self_kv`. The port runs the same scenario; logits agree
  within 1e-4 (the slot engine tests' tolerance; logits reach ~20),
  encoder states and the written KV within 2e-5 (fp32, a few layers).
* A free slot (encoder length 0) beside the live ones: JAX's logits there
  are NaN, the port's finite, and the live rows agree.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import fixtures
from text_generation_inference_tpu.models import t5 as jt5
from text_generation_inference_tpu.utils.weights import Weights as JWeights
from text_generation_inference_tpu_torch.models import t5
from text_generation_inference_tpu_torch.models.convert import (
    t5_params_from_jax)
from text_generation_inference_tpu_torch.utils.weights import Weights

LOGIT_TOL = 1e-4     # the slot engine tests' logit tolerance
TOL = 2e-5           # encoder states and KV
SLOTS, MAX_DEC, MAX_ENC, STEPS, CHUNK = 4, 12, 16, 4, 4
LIVE = [2, 0, 1]            # prefilled slots; slot 3 stays free
ENC_LENS = [11, 16, 5]
ENC_PREFIX = [3, 0, 2]
DEC_PREFIX = [2, 0, 1]
RING_START = [10, 3, 1, 0]  # by slot: slot 0's chunk writes past MAX_DEC


def _small(**kw):
    return dict(vocab_size=256, d_model=64, d_kv=16, d_ff=128, num_layers=2,
                num_decoder_layers=2, num_heads=4,
                relative_attention_num_buckets=8,
                relative_attention_max_distance=32, dropout_rate=0.0,
                decoder_start_token_id=0, eos_token_id=1, pad_token_id=0, **kw)


def _build(name: str) -> str:
    from transformers import (MT5Config, MT5ForConditionalGeneration,
                              T5Config, T5ForConditionalGeneration)

    if name == "gated":          # tests/test_t5.py's shape
        torch.manual_seed(6)
        cfg = T5Config(**{**_small(feed_forward_proj="gated-gelu",
                                   tie_word_embeddings=False),
                          "num_decoder_layers": 3})
        model = T5ForConditionalGeneration(cfg)
    elif name == "v10":          # t5 v1.0: relu, tied head
        torch.manual_seed(9)
        model = T5ForConditionalGeneration(T5Config(**_small(
            feed_forward_proj="relu", tie_word_embeddings=True)))
    else:                        # mt5 / mt0
        torch.manual_seed(10)
        model = MT5ForConditionalGeneration(MT5Config(**_small(
            tie_word_embeddings=False)))
    return fixtures._save(model.eval(), f"torch_t5_{name}")


CONFIGS = ("gated", "v10", "mt5")


def _arrays(spec, seed=0):
    """The scenario's inputs, from a numpy seed."""
    rng = np.random.default_rng(seed)
    n, d = len(LIVE), spec.d_model
    enc_ids = np.zeros((n, MAX_ENC), np.int32)
    for i, ln in enumerate(ENC_LENS):
        enc_ids[i, :ln] = rng.integers(2, spec.vocab_size, ln)
    dec_width = 1 + max(DEC_PREFIX)
    dec_ids = np.zeros((n, dec_width), np.int32)
    return dict(
        enc_ids=enc_ids, enc_lens=np.asarray(ENC_LENS, np.int32),
        enc_pre=rng.normal(size=(n, MAX_ENC, d)).astype(np.float32),
        enc_plen=np.asarray(ENC_PREFIX, np.int32),
        dec_ids=dec_ids, dec_lens=1 + np.asarray(DEC_PREFIX, np.int32),
        dec_pre=rng.normal(size=(n, dec_width, d)).astype(np.float32),
        dec_plen=np.asarray(DEC_PREFIX, np.int32),
        slots=np.asarray(LIVE, np.int32),
        step_ids=rng.integers(2, spec.vocab_size,
                              (STEPS, SLOTS)).astype(np.int32),
        ring_ids=rng.integers(2, spec.vocab_size,
                              (CHUNK, SLOTS)).astype(np.int32),
        ring_start=np.asarray(RING_START, np.int32))


def _positions(a):
    """Each slot's decoder position before the first step (its history
    length - 1 after prefill: the decoder prompt's length; 0 when free)."""
    pos = np.zeros(SLOTS, np.int32)
    pos[a["slots"]] = a["dec_lens"]
    return pos


def _jax_scenario(spec, params, a):
    """Every JAX function of the scenario in one jit."""
    pos0 = _positions(a)

    @jax.jit
    def run(params, a):
        enc0 = jt5.encode(spec, params, a["enc_ids"], a["enc_lens"])
        enc1 = jt5.encode(spec, params, a["enc_ids"], a["enc_lens"],
                          prefix_embeds=a["enc_pre"],
                          prefix_len=a["enc_plen"])
        state = jt5.T5DecodeState.create(spec, SLOTS, MAX_DEC, MAX_ENC,
                                         jnp.float32)
        n = a["dec_ids"].shape[0]
        pf_logits, state = jt5.decoder_prefill(
            spec, params, a["dec_ids"], a["dec_lens"], enc1, a["enc_lens"],
            a["slots"], state, dec_prefix_embeds=a["dec_pre"],
            dec_prefix_len=a["dec_plen"],
            dec_prefix_start=jnp.ones((n,), jnp.int32))
        st, step_logits = state, []
        for k in range(STEPS):
            lg, st = jt5.decoder_step(spec, params, a["step_ids"][k],
                                      jnp.asarray(pos0) + k, st)
            step_logits.append(lg)
        L = spec.num_decoder_layers
        kbuf = jnp.zeros((L, SLOTS, spec.num_heads, CHUNK, spec.d_kv),
                         jnp.float32)
        vbuf, ring_logits = kbuf, []
        for i in range(CHUNK):
            p = jnp.minimum(a["ring_start"] + i, MAX_DEC - 1)
            lg, k_all, v_all = jt5.decoder_ring_step(
                spec, params, a["ring_ids"][i], p, state, kbuf, vbuf,
                jnp.int32(i), a["ring_start"])
            kbuf = kbuf.at[:, :, :, i].set(k_all)
            vbuf = vbuf.at[:, :, :, i].set(v_all)
            ring_logits.append(lg)
        flushed = jt5.ring_flush_self_kv(state, kbuf, vbuf, a["ring_start"])
        return dict(enc0=enc0, enc1=enc1, pf_logits=pf_logits,
                    pf_state=state._asdict(),
                    step_logits=jnp.stack(step_logits),
                    step_state=st._asdict(),
                    ring_logits=jnp.stack(ring_logits), kbuf=kbuf,
                    flushed=flushed._asdict())

    out = run(params, {k: jnp.asarray(v) for k, v in a.items()})
    return jax.tree_util.tree_map(np.asarray, out)


def _clone(state):
    return t5.T5DecodeState(*(x.clone() for x in state))


def _torch_scenario(spec, params, a):
    a = {k: torch.from_numpy(v) for k, v in a.items()}
    pos0 = torch.from_numpy(_positions({k: v.numpy() for k, v in a.items()}))
    enc0 = t5.encode(spec, params, a["enc_ids"], a["enc_lens"])
    enc1 = t5.encode(spec, params, a["enc_ids"], a["enc_lens"],
                     prefix_embeds=a["enc_pre"], prefix_len=a["enc_plen"])
    state = t5.T5DecodeState.create(spec, SLOTS, MAX_DEC, MAX_ENC,
                                    torch.float32, "cpu")
    pf_logits, state = t5.decoder_prefill(
        spec, params, a["dec_ids"], a["dec_lens"], enc1, a["enc_lens"],
        a["slots"], state, dec_prefix_embeds=a["dec_pre"],
        dec_prefix_len=a["dec_plen"],
        dec_prefix_start=torch.ones(len(LIVE), dtype=torch.int32))
    st, step_logits = _clone(state), []
    for k in range(STEPS):
        lg, st = t5.decoder_step(spec, params, a["step_ids"][k], pos0 + k, st)
        step_logits.append(lg)
    L = spec.num_decoder_layers
    kbuf = torch.zeros((L, SLOTS, spec.num_heads, CHUNK, spec.d_kv))
    vbuf, ring_logits = torch.zeros_like(kbuf), []
    for i in range(CHUNK):
        p = torch.clamp(a["ring_start"] + i, max=MAX_DEC - 1)
        lg, k_all, v_all = t5.decoder_ring_step(
            spec, params, a["ring_ids"][i], p, state, kbuf, vbuf, i,
            a["ring_start"])
        kbuf[:, :, :, i] = k_all
        vbuf[:, :, :, i] = v_all
        ring_logits.append(lg)
    flushed = t5.ring_flush_self_kv(_clone(state), kbuf, vbuf,
                                    a["ring_start"])

    def np_state(s):
        return {k: v.numpy() for k, v in s._asdict().items()}

    return dict(enc0=enc0.numpy(), enc1=enc1.numpy(),
                pf_logits=pf_logits.numpy(), pf_state=np_state(state),
                step_logits=torch.stack(step_logits).numpy(),
                step_state=np_state(st),
                ring_logits=torch.stack(ring_logits).numpy(),
                kbuf=kbuf.numpy(), flushed=np_state(flushed))


@pytest.fixture(scope="module", params=CONFIGS)
def model(request):
    """(name, port spec, port params, JAX spec, JAX params) of a config."""
    d = _build(request.param)
    cfg = json.loads((Path(d) / "config.json").read_text())
    jspec = jt5.spec_from_hf_config(cfg)
    jparams = jt5.load_params(JWeights(d), jspec, jnp.float32)
    spec = t5.spec_from_hf_config(cfg)
    params = t5_params_from_jax(
        spec, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return request.param, d, spec, params, jspec, jparams


@pytest.fixture(scope="module")
def runs(model):
    _, _, spec, params, jspec, jparams = model
    a = _arrays(spec)
    return _jax_scenario(jspec, jparams, a), _torch_scenario(spec, params, a)


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def test_spec_and_loader_match_jax(model):
    name, d, spec, params, jspec, jparams = model
    assert t5.dataclasses.asdict(spec) == jt5.dataclasses.asdict(jspec)
    assert spec.gated_act == (name != "v10")
    assert spec.tie_word_embeddings == (name == "v10")
    loaded = t5.load_params(Weights(d), spec, torch.float32, "cpu")

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, f"{prefix}/{k}")
        else:
            yield prefix, tree

    got, want = dict(flat(loaded)), dict(flat(params))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("buckets,distance", [(32, 128), (8, 32)])
@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["encoder", "decoder"])
def test_relative_buckets_equal_jax(buckets, distance, bidirectional):
    rel = np.arange(-2048, 2049, dtype=np.int32)
    want = np.asarray(jt5._relative_bucket(jnp.asarray(rel), bidirectional,
                                           buckets, distance))
    direct = t5._relative_bucket(torch.from_numpy(rel), bidirectional,
                                 buckets, distance).numpy()
    table = t5.relative_buckets(torch.from_numpy(rel), bidirectional,
                                buckets, distance).numpy()
    np.testing.assert_array_equal(direct, want)
    np.testing.assert_array_equal(table, want)


@pytest.mark.parametrize("prefixed", [False, True], ids=["plain", "prefix"])
def test_encode_matches_jax(runs, prefixed):
    want, got = runs
    key = "enc1" if prefixed else "enc0"
    for i, ln in enumerate(ENC_LENS):
        _close(got[key][i, :ln], want[key][i, :ln], f"{key} row {i}")
    assert not np.allclose(got["enc0"], got["enc1"])


def test_decoder_prefill_matches_jax(runs):
    want, got = runs
    dec_lens = 1 + np.asarray(DEC_PREFIX)
    for i, ln in enumerate(dec_lens):
        _close(got["pf_logits"][i, :ln], want["pf_logits"][i, :ln],
               f"prefill logits row {i}", LOGIT_TOL)
    for i, (s, ln) in enumerate(zip(LIVE, dec_lens)):
        for key in ("self_k", "self_v"):
            _close(got["pf_state"][key][:, s, :, :ln],
                   want["pf_state"][key][:, s, :, :ln], f"{key} slot {s}")
        for key in ("cross_k", "cross_v"):
            _close(got["pf_state"][key][:, s, :, :ENC_LENS[i]],
                   want["pf_state"][key][:, s, :, :ENC_LENS[i]],
                   f"{key} slot {s}")
    np.testing.assert_array_equal(got["pf_state"]["enc_len"],
                                  want["pf_state"]["enc_len"])


def test_decoder_steps_match_jax(runs):
    want, got = runs
    _close(got["step_logits"][:, LIVE], want["step_logits"][:, LIVE],
           "decode step logits", LOGIT_TOL)
    end = 1 + np.asarray(DEC_PREFIX) + STEPS
    for s, ln in zip(LIVE, end):
        for key in ("self_k", "self_v"):
            _close(got["step_state"][key][:, s, :, :ln],
                   want["step_state"][key][:, s, :, :ln], f"{key} slot {s}")


def test_ring_steps_and_flush_match_jax(runs):
    want, got = runs
    _close(got["ring_logits"][:, LIVE], want["ring_logits"][:, LIVE],
           "ring step logits", LOGIT_TOL)
    _close(got["kbuf"][:, LIVE], want["kbuf"][:, LIVE], "ring keys")
    for key in ("self_k", "self_v"):
        _close(got["flushed"][key][:, LIVE], want["flushed"][key][:, LIVE],
               f"flushed {key}")
    # slot 0's chunk starts at 10: columns 0 and 1 land at 10 and 11, the
    # writes at 12 and 13 are dropped
    np.testing.assert_array_equal(got["flushed"]["self_k"][:, 0, :, 10:12],
                                  got["kbuf"][:, 0, :, :2])


def test_free_slot_stays_finite_beside_live_ones(runs):
    want, got = runs
    free = [s for s in range(SLOTS) if s not in LIVE]
    # JAX: the free slot's cross-attention masks every key (encoder length
    # 0), so its softmax and its logits are NaN; the port's are finite
    assert np.isnan(want["step_logits"][:, free]).all()
    assert np.isfinite(got["step_logits"]).all()
    assert np.isfinite(got["ring_logits"]).all()
    assert np.isfinite(got["flushed"]["self_k"]).all()
    _close(got["step_logits"][:, LIVE], want["step_logits"][:, LIVE],
           "live rows beside a free slot", LOGIT_TOL)
