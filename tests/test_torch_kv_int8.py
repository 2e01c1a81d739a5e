"""The port's int8 KV path and its quantized serving slice against the JAX
package (fp32, CPU).

* `quantize_kv`: int8 values bit for bit, scales to rtol 1e-6 (both round
  half to even).
* The plain version of the int8 paged-decode kernel (K2) against the JAX
  Pallas kernel `paged_decode_attention_partial_stacked` with scale pools,
  run in interpret mode as tests/test_pallas_kernels.py does: atol 1e-5.
* The slice as a whole: a `mini` GPTQ-INT4 checkpoint served with
  kv_cache_dtype=int8 on both PagedInferenceEngines, on staggered slots
  with frees and page reuse, through the dense-gather branch and the
  partial (kernel) branch. Greedy tokens are identical and logprobs agree
  within 5e-4, the repo's golden tolerance. Mirrors the int8 paged suite
  of tests/test_paged_engine.py and the GPTQ load-and-generate tests of
  tests/test_gptq.py.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_generation_inference_tpu.config import ServingConfig as JConfig
from text_generation_inference_tpu.engine.engine import (
    RequestParams as JRequestParams)
from text_generation_inference_tpu.engine.paged_engine import (
    PagedInferenceEngine as JEngine)
from text_generation_inference_tpu.models import core as jcore
from text_generation_inference_tpu.models import families as jfamilies
from text_generation_inference_tpu.ops.pallas import paged_attention as jpa
from text_generation_inference_tpu_torch.config import ServingConfig
from text_generation_inference_tpu_torch.engine.engine import RequestParams
from text_generation_inference_tpu_torch.engine.paged_engine import (
    PagedInferenceEngine)
from text_generation_inference_tpu_torch.models import core, families
from text_generation_inference_tpu_torch.ops import attention
from text_generation_inference_tpu_torch.ops.cuda import paged_attention as tpa
from text_generation_inference_tpu_torch.ops.quant.int4 import Int4Weight

LOGPROB_TOL = 5e-4
PAGE = 8
NUM_PAGES = 12
PROMPTS = [
    [5, 9, 23, 77, 41],
    [100, 3, 250, 17, 88, 91, 12],
    [7, 7, 7],
]


# --- quantize_kv ------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 4, 32), (2, 5, 2, 128)])
def test_quantize_kv_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.normal(size=shape) * rng.uniform(0.1, 10, shape[:-1])[..., None]
         ).astype(np.float32)
    x[0, 0] = 0.0                       # an all-zero row: the 1e-8 floor
    q, s = core.quantize_kv(torch.from_numpy(x))
    jq, js = jcore.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6, atol=0)


# --- plain K2 against the JAX kernel -----------------------------------------


def int8_stacked_inputs(layers=2, s=4, kh=2, g=2, d=16, max_pages=4, seed=0):
    """int8 pools [L, K, P*page, D] with f32 scale pools [L, K, P*page], the
    sentinel past each slot's live pages, and a ctx == 0 slot."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(s, kh, g, d)).astype(np.float32)
    pools = []
    for _ in range(2):
        x = rng.normal(size=(layers, kh, NUM_PAGES * PAGE, d)).astype(np.float32)
        qv, sc = jcore.quantize_kv(jnp.asarray(x))
        pools += [np.array(qv), np.array(sc)]
    ctx = np.asarray([0, 5, 17, max_pages * PAGE][:s], np.int32)
    perm = rng.permutation(NUM_PAGES)
    bt = np.full((s, max_pages), NUM_PAGES, np.int32)
    used = 0
    for i in range(s):
        n = -(-int(ctx[i]) // PAGE)
        bt[i, :n] = perm[used:used + n]
        used += n
    kq, ks, vq, vs = pools
    return q, kq, vq, ks, vs, bt, ctx


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_partial_matches_pallas_interpret(seed):
    q, kq, vq, ks, vs, bt, ctx = int8_stacked_inputs(seed=seed)
    tt = [torch.from_numpy(a) for a in (q, kq, vq, ks, vs, bt, ctx)]
    for li in range(kq.shape[0]):
        want = jpa.paged_decode_attention_partial_stacked(
            jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(bt),
            jnp.asarray(ctx), jnp.asarray([li], jnp.int32), PAGE,
            k_scale_pools=jnp.asarray(ks), v_scale_pools=jnp.asarray(vs),
            interpret=True)
        got = tpa.paged_decode_attention_partial_stacked(
            tt[0], tt[1], tt[2], tt[5], tt[6], li, PAGE,
            k_scale_pools=tt[3], v_scale_pools=tt[4])
        direct = tpa.paged_decode_attention_partial_i8(
            tt[0], tt[1][li], tt[2][li], tt[3][li], tt[4][li], tt[5], tt[6],
            PAGE)
        for a, b, c in zip(got, want, direct):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-5)
            assert torch.equal(a, c)
        m, l = got[1], got[2]
        assert torch.all(torch.isneginf(m[0])) and torch.all(l[0] == 0)


def test_int8_plain_switch_and_cpu_launch_count():
    """`PLAIN` and `KERNELS` give the same int8 partial on the CPU, and the
    CPU wrapper launches nothing."""
    q, kq, vq, ks, vs, bt, ctx = int8_stacked_inputs(seed=2)
    args = [torch.from_numpy(a) for a in (q, kq[0], vq[0], ks[0], vs[0], bt,
                                          ctx)]
    before = tpa.paged_decode_attention_partial_i8.launches
    a = attention.KERNELS.paged_decode_partial_i8(*args, PAGE)
    b = attention.PLAIN.paged_decode_partial_i8(*args, PAGE)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert tpa.paged_decode_attention_partial_i8.launches == before
    assert attention.PLAIN.int4_plain and not attention.KERNELS.int4_plain


# --- the quantized slice: GPTQ weights + int8 KV on the paged engine ----------


@pytest.fixture(scope="module")
def mini_gptq(tmp_path_factory):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    from make_shaped_checkpoint import PRESETS, write_checkpoint

    out = str(tmp_path_factory.mktemp("gptq_int8") / "mini_gptq")
    write_checkpoint(out, PRESETS["mini"], quantize="gptq")
    return out


def make_config(cls, **kw):
    cfg = cls(max_sequence_length=64, max_new_tokens=32, max_batch_slots=3,
              prefill_buckets=[8, 16], kv_page_size=8, kv_cache_dtype="int8",
              **kw)
    cfg.validate()
    return cfg


def staggered(eng, rp_cls):
    """Two requests, a free, a third request on the freed pages. Returns
    {name: [(token, logprob), ...]}."""
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
    first(eng.prefill([sa, sb], [PROMPTS[0], PROMPTS[1]],
                      [rp_cls(max_new_tokens=30)] * 2), ["a", "b"])
    decode(8, {"a": sa, "b": sb})
    eng.free(sb)
    sc = eng.acquire_slot()
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


BRANCHES = {"dense_gather": dict(decode_chunk=4, paged_gather_ctx_max=64),
            "partial_kernel": dict(decode_chunk=4, paged_gather_ctx_max=0)}


@pytest.fixture(scope="module")
def jax_runs(mini_gptq):
    spec, params = jfamilies.load_model(mini_gptq, dtype=jnp.float32,
                                        quantize="gptq")
    return {name: staggered(JEngine(spec, params, make_config(JConfig, **kw),
                                    eos_token_id=2, num_pages=16),
                            JRequestParams)
            for name, kw in BRANCHES.items()}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_gptq_int8_staggered_matches_jax(mini_gptq, jax_runs, branch):
    spec, params = families.load_model(mini_gptq, dtype=torch.float32,
                                       quantize="gptq", device="cpu")
    assert isinstance(params["layers"]["wq"], Int4Weight)
    eng = PagedInferenceEngine(spec, params,
                               make_config(ServingConfig, **BRANCHES[branch]),
                               eos_token_id=2, num_pages=16, device="cpu")
    assert eng.cache.k.dtype == torch.int8
    assert isinstance(eng.model_params["layers"]["w_qkv"], Int4Weight)
    want = jax_runs[branch]
    assert_same_run(staggered(eng, RequestParams), want)
    # again on the churned pool: reused pages and scale rows leak nothing
    assert_same_run(staggered(eng, RequestParams), want)
    assert eng.allocator.num_free == 16
    eng.reset()
    assert_same_run(staggered(eng, RequestParams), want)


def test_int8_guards_match_jax(mini_gptq):
    spec, params = families.load_model(mini_gptq, dtype=torch.float32,
                                       device="cpu")
    for kw, match in ((dict(decode_chunk=1), "ring"),
                      (dict(decode_chunk=4, stream_decode_chunk=1),
                       "stream_decode_chunk")):
        with pytest.raises(ValueError, match=match):
            PagedInferenceEngine(spec, params, make_config(ServingConfig, **kw),
                                 eos_token_id=2, num_pages=16, device="cpu")
