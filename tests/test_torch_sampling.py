"""The PyTorch port's sampling against the JAX package's
`engine/sampling.py` on the same seeded numpy logits.

Greedy ids, logprobs, ranks, top-n, the EOS and repetition penalties and
the warpers must match (fp32, 1e-5). Seeded sampling streams differ from
JAX's by design (threefry vs the port's counter hash); the port's own
guarantee is checked instead: the same seed and step give the same token
whatever the slot or the rest of the batch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_generation_inference_tpu.engine import sampling as J
from text_generation_inference_tpu_torch.engine import sampling as T

V = 97
N = 6
TOL = 1e-5
EOS = 3


def logits(seed=0, n=N, v=V):
    return (np.random.default_rng(seed).normal(size=(n, v)) * 3.0
            ).astype(np.float32)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def params_pair(n=N, **kw):
    """SlotSamplingParams for both packages with the given per-row values."""
    vals = dict(temperature=[0.0] * n, top_k=[0] * n, top_p=[1.0] * n,
                typical_p=[1.0] * n, repetition_penalty=[1.0] * n,
                lp_start=[0] * n, lp_decay=[0.0] * n, min_new_tokens=[0] * n,
                seed=[0] * n)
    vals.update(kw)
    jp = J.SlotSamplingParams.empty(n)
    tp = T.SlotSamplingParams.empty(n, "cpu")
    for i in range(n):
        row = {k: v[i] for k, v in vals.items()}
        jp = jp.write_slot(i, **row)
        tp.write_slot(i, **row)
    return jp, tp


def history(n=N, t=12, seed=1):
    rng = np.random.default_rng(seed)
    h = rng.integers(0, V, size=(n, t)).astype(np.int32)
    hl = rng.integers(1, t + 1, size=(n,)).astype(np.int32)
    return h, hl


def run_both(lg, jp, tp, gen, h, hl, want_details=True):
    jids, jdet = J.next_tokens(jnp.asarray(lg), jp, jnp.asarray(gen),
                               jnp.asarray(h), jnp.asarray(hl), EOS,
                               want_details=want_details)
    tids, tdet = T.next_tokens(torch.from_numpy(lg), tp, torch.from_numpy(gen),
                               torch.from_numpy(h), torch.from_numpy(hl), EOS,
                               want_details=want_details)
    return (jids, jdet), (tids, tdet)


def assert_details(jdet, tdet):
    close(tdet.logprob, jdet.logprob)
    np.testing.assert_array_equal(tdet.rank.numpy(), np.asarray(jdet.rank))
    np.testing.assert_array_equal(tdet.top_ids.numpy(), np.asarray(jdet.top_ids))
    close(tdet.top_logprobs, jdet.top_logprobs)
    close(tdet.top_scores, jdet.top_scores)


def test_greedy_ids_and_details():
    lg = logits()
    jp, tp = params_pair()
    gen = np.zeros(N, np.int32)
    h, hl = history()
    (jids, jdet), (tids, tdet) = run_both(lg, jp, tp, gen, h, hl)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert_details(jdet, tdet)


def test_eos_and_repetition_penalties():
    lg = logits(seed=2)
    jp, tp = params_pair(min_new_tokens=[5, 0, 0, 0, 0, 0],
                         lp_start=[0, 1, 0, 0, 0, 0],
                         lp_decay=[0.0, 1.5, 0.0, 0.0, 0.0, 0.0],
                         repetition_penalty=[1.0, 1.0, 2.0, 0.5, 1.3, 1.0])
    gen = np.asarray([2, 4, 0, 0, 1, 0], np.int32)
    h, hl = history(seed=3)
    (jids, jdet), (tids, tdet) = run_both(lg, jp, tp, gen, h, hl)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert_details(jdet, tdet)


@pytest.mark.parametrize("kw", [
    dict(temperature=[0.7] * N),
    dict(temperature=[1.0] * N, top_k=[1, 5, 20, 0, 3, 97]),
    dict(temperature=[1.3] * N, top_p=[0.1, 0.5, 0.9, 0.99, 1.0, 0.3]),
    dict(temperature=[1.0] * N, typical_p=[0.2, 0.5, 0.9, 1.0, 0.95, 0.7]),
    dict(temperature=[0.0, 0.9, 0.0, 1.2, 0.5, 0.0], top_k=[0, 4, 0, 10, 0, 0],
         top_p=[1.0, 0.8, 1.0, 1.0, 0.6, 1.0]),
], ids=["temperature", "top_k", "top_p", "typical_p", "mixed"])
def test_warpers_and_details(kw):
    lg = logits(seed=4)
    jp, tp = params_pair(**kw)
    jw = J.apply_warpers(jnp.asarray(lg), jp.temperature, jp.top_k, jp.top_p,
                         jp.typical_p)
    tw = T.apply_warpers(torch.from_numpy(lg), tp.temperature, tp.top_k,
                         tp.top_p, tp.typical_p)
    np.testing.assert_array_equal(np.isneginf(tw.numpy()),
                                  np.isneginf(np.asarray(jw)))
    finite = ~np.isneginf(np.asarray(jw))
    close(tw.numpy()[finite], np.asarray(jw)[finite])
    # details of the same chosen ids come from the same warped scores
    ids = np.asarray(jnp.argmax(jw, axis=-1)).astype(np.int32)
    jdet = J.token_details(jw, jnp.asarray(ids))
    tdet = T.token_details(tw, torch.from_numpy(ids))
    assert_details(jdet, tdet)
    # greedy rows pick the same token in both packages
    (jids, _), (tids, _) = run_both(lg, jp, tp, np.zeros(N, np.int32),
                                    *history(seed=5))
    greedy = np.asarray(kw["temperature"]) == 0.0
    np.testing.assert_array_equal(tids.numpy()[greedy],
                                  np.asarray(jids)[greedy])


def test_prompt_token_details():
    rng = np.random.default_rng(6)
    lg = rng.normal(size=(2, 7, V)).astype(np.float32)
    ids = rng.integers(0, V, size=(2, 8)).astype(np.int32)
    tdet = T.prompt_token_details(torch.from_numpy(lg), torch.from_numpy(ids))
    for row in range(2):
        jdet = J.prompt_token_details(jnp.asarray(lg[row]), jnp.asarray(ids[row]))
        close(tdet.logprob[row, 1:], jdet.logprob[1:])
        assert np.isnan(tdet.logprob[row, 0].item())
        np.testing.assert_array_equal(tdet.rank[row].numpy(),
                                      np.asarray(jdet.rank))
        np.testing.assert_array_equal(tdet.top_ids[row].numpy(),
                                      np.asarray(jdet.top_ids))
        close(tdet.top_logprobs[row], jdet.top_logprobs)


def test_pack_unpack_roundtrip():
    lg = logits(seed=7)
    jp, tp = params_pair()
    h, hl = history()
    (jids, jdet), (tids, tdet) = run_both(lg, jp, tp, np.zeros(N, np.int32),
                                          h, hl)
    tpk = T.pack_step_outputs(tids, tdet).numpy()
    jpk = np.asarray(J.pack_step_outputs(jids, jdet))
    close(tpk, jpk)
    for a, b in zip(T.unpack_step_outputs(tpk), J.unpack_step_outputs(jpk)):
        close(a, b)
    ids_only = T.pack_step_outputs(tids, None).numpy()
    assert ids_only.shape == (N, 1)
    assert np.all(np.isnan(T.unpack_step_outputs(ids_only)[1]))


def test_small_vocab_pads_top_n():
    lg = logits(seed=8, v=7)
    ids = np.zeros(N, np.int32)
    jdet = J.token_details(jnp.asarray(lg), jnp.asarray(ids))
    tdet = T.token_details(torch.from_numpy(lg), torch.from_numpy(ids))
    assert_details(jdet, tdet)


def sample_slot(seed, step, slot, n=N, base_seed=1):
    """Sample with (seed, step) in `slot` of a batch whose other rows carry
    other seeds and steps; returns that slot's token."""
    lg = logits(seed=9)
    seeds = np.arange(n) + 1000 * base_seed
    steps = np.arange(n) * 3 + base_seed
    seeds[slot], steps[slot] = seed, step
    jp, tp = params_pair(temperature=[1.0] * n, seed=list(seeds))
    row_logits = np.tile(lg[:1], (n, 1))
    warped = T.apply_warpers(torch.from_numpy(row_logits), tp.temperature,
                             tp.top_k, tp.top_p, tp.typical_p)
    ids = T.choose_tokens(warped, torch.ones(n, dtype=torch.bool), tp.seed,
                          torch.from_numpy(steps.astype(np.int32)))
    return int(ids[slot])


def test_seeded_sampling_repeats_whatever_the_slot():
    picks = {sample_slot(1234, 5, slot, base_seed=b)
             for slot in range(N) for b in (1, 2)}
    assert len(picks) == 1
    # and the stream moves with the seed and the step
    draws = {sample_slot(s, st, 0) for s in range(20) for st in range(3)}
    assert len(draws) > 5


def test_sampling_follows_the_distribution():
    lg = np.log(np.asarray([[0.7, 0.2, 0.1]], np.float32))
    n = 4000
    seeds = torch.arange(n)
    warped = torch.from_numpy(np.tile(lg, (n, 1)))
    ids = T.choose_tokens(warped, torch.ones(n, dtype=torch.bool), seeds,
                          torch.zeros(n, dtype=torch.int32))
    freq = np.bincount(ids.numpy(), minlength=3) / n
    close(freq, [0.7, 0.2, 0.1], tol=0.03)
