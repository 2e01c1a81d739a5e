"""The port's INT8 weights (`QUANTIZE=int8`, `int8-outliers`,
`bitsandbytes`) against the JAX package on the CPU.

The same seeded numpy inputs and the same checkpoints go through both
packages:

  * the quantizers: codes identical, scales within 1e-6 relative;
  * the products, fp32 and bf16 x: both round x and the codes to bf16 and
    accumulate in f32, so the f32 results agree to summation order (1e-5
    relative) and the bf16 ones to one bf16 ulp;
  * fusion, `convert`, the linear dispatch and the memory plan's int8
    term;
  * calibration: absmax within 1e-4 relative; the outlier features picked
    on a planted model identical;
  * `load_model` in all three modes against JAX's params, on a copy of the
    served fixture with a planted outlier feature (hot in every token's
    residual stream, as real >6.7B checkpoints are);
  * greedy serving on the slot and paged engines under int8 and
    bitsandbytes against the JAX engines: token ids identical, logprobs
    within 5e-4 (the repo's golden tolerance). The JAX side builds one slot
    engine (int8) and one paged engine (bitsandbytes); on the CPU the two
    JAX engines give the same tokens, so each port engine is held to the
    JAX run of its mode.
"""

import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from text_generation_inference_tpu.config import ServingConfig as JConfig
from text_generation_inference_tpu.engine.engine import (
    InferenceEngine as JSlotEngine, RequestParams as JRequestParams)
from text_generation_inference_tpu.engine.paged_engine import (
    PagedInferenceEngine as JPagedEngine)
from text_generation_inference_tpu.models import families as jfamilies
from text_generation_inference_tpu.models.fuse import fuse_params as jfuse
from text_generation_inference_tpu.ops.quant import calibrate as jcal
from text_generation_inference_tpu.ops.quant import int8 as j8
from text_generation_inference_tpu_torch.config import ServingConfig
from text_generation_inference_tpu_torch.engine import memory
from text_generation_inference_tpu_torch.engine.engine import (
    InferenceEngine, RequestParams)
from text_generation_inference_tpu_torch.engine.paged_engine import (
    PagedInferenceEngine)
from text_generation_inference_tpu_torch.models import families
from text_generation_inference_tpu_torch.models.convert import params_from_jax
from text_generation_inference_tpu_torch.models.core import DecoderSpec
from text_generation_inference_tpu_torch.models.fuse import fuse_params
from text_generation_inference_tpu_torch.ops import linear
from text_generation_inference_tpu_torch.ops.quant import calibrate as tcal
from text_generation_inference_tpu_torch.ops.quant import int8 as t8
from tests import fixtures

LOGPROB_TOL = 5e-4
HOT = 13          # the planted residual-stream feature
PROMPTS = [[5, 9, 23, 77, 41], [100, 3, 150, 17, 88, 91, 12], [7, 7, 7]]


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == ml_dtypes.bfloat16 else x


def weight(rng, shape, hot=()):
    w = rng.normal(size=shape).astype(np.float32)
    for h in hot:
        w[..., h, :] *= 40.0
    return w


# --- quantizers and products --------------------------------------------------


@pytest.mark.parametrize("shape", [(96, 160), (3, 64, 128)])
def test_quantize_int8_matches_jax(shape):
    w = weight(np.random.default_rng(0), shape, hot=(5,))
    jq, tq = j8.quantize_int8(w), t8.quantize_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale),
                               rtol=1e-6, atol=0)
    assert tq.q.dtype == torch.int8 and tq.scale.dtype == torch.float32
    np.testing.assert_array_equal(
        t8.dequantize_int8(tq, torch.float32).numpy(),
        np.asarray(j8.dequantize_int8(jq, jnp.float32)))


@pytest.mark.parametrize("shape", [(96, 160), (3, 64, 128)])
def test_quantize_int8_outliers_matches_jax(shape):
    rng = np.random.default_rng(1)
    w = weight(rng, shape, hot=(5, 40))
    idx = (np.array([5, 40, 7], np.int32) if len(shape) == 2 else
           np.stack([rng.permutation(shape[1])[:3] for _ in range(shape[0])]
                    ).astype(np.int32))
    jq = j8.quantize_int8_outliers(w, idx)
    tq = t8.quantize_int8_outliers(torch.from_numpy(w), idx)
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tq.outlier_idx.numpy(),
                                  np.asarray(jq.outlier_idx))
    assert tq.outlier_w.dtype == torch.bfloat16
    np.testing.assert_array_equal(np_(tq.outlier_w), np_(jq.outlier_w))
    np.testing.assert_array_equal(
        t8.dequantize_int8_outliers(tq, torch.float32).numpy(),
        np.asarray(j8.dequantize_int8_outliers(jq, jnp.float32)))


@pytest.mark.parametrize("outliers", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_int8_matches_jax(outliers, dtype):
    rng = np.random.default_rng(2)
    w = weight(rng, (256, 192), hot=(3, 77))
    x = rng.normal(size=(2, 5, 256)).astype(np.float32)
    x[..., 3] *= 20.0
    if outliers:
        idx = np.array([3, 77], np.int32)
        jw, jf = j8.quantize_int8_outliers(w, idx), j8.matmul_int8_outliers
        tw, tf = (t8.quantize_int8_outliers(torch.from_numpy(w), idx),
                  t8.matmul_int8_outliers)
    else:
        jw, jf = j8.quantize_int8(w), j8.matmul_int8
        tw, tf = t8.quantize_int8(torch.from_numpy(w)), t8.matmul_int8
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np_(jf(jx, jw))
    got = tf(tx, tw)
    assert got.dtype == tx.dtype and got.shape == (2, 5, 192)
    rtol = 1e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(np_(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())
    # the decomposition is exact: the same product through the dense
    # dequantized weight, with x rounded to bf16
    xb = tx.to(torch.bfloat16).to(torch.float32)
    dq = (t8.dequantize_int8_outliers if outliers else t8.dequantize_int8)(
        tw, torch.float32)
    np.testing.assert_allclose(np_(got), (xb @ dq).numpy(), rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_linear_dispatch_and_stacked_views():
    rng = np.random.default_rng(3)
    w = weight(rng, (2, 64, 96), hot=(9,))
    x = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
    plain = t8.quantize_int8(torch.from_numpy(w))
    outl = t8.quantize_int8_outliers(torch.from_numpy(w),
                                     np.array([[9, 1], [9, 2]], np.int32))
    for stack, fn in ((plain, t8.matmul_int8),
                      (outl, t8.matmul_int8_outliers)):
        assert linear.is_quantized(stack)
        for i in range(2):
            view = linear.layer_view(stack, i)
            assert type(view) is type(stack)
            assert all(f.data_ptr() == g[i].data_ptr()
                       for f, g in zip(view, stack))      # no copy
            assert torch.equal(linear.matmul(x, view),
                               fn(x, type(stack)(*(f[i] for f in stack))))
            assert torch.equal(linear.layer_view(stack, i, plain=True).q,
                               view.q)
    assert not linear.is_quantized(torch.zeros(2, 2))
    params = {"embed_tokens": torch.zeros(4, 64),
              "layers": {"w_gu": plain, "w_down": plain}}
    # no kernel route for int8: the params pass through untouched, the
    # scratch is not grown, and M1 (INT4-only) never takes the pair
    assert linear.prepare_params(params, rows=8, fuse_mlp=True) is params
    linear.reserve_scratch(params, torch.device("cpu"), fuse_mlp=True)
    assert not linear.can_fuse_mlp(linear.layer_view(plain, 0),
                                   linear.layer_view(plain, 0), "silu_glu", 8)


# --- fusion, convert ----------------------------------------------------------


@pytest.fixture(scope="module")
def llama_jax():
    return jfamilies.load_model(fixtures.tiny_llama(), dtype=jnp.float32)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_params_equal(tparams, jparams_np):
    def walk(t, j, path):
        if isinstance(t, dict):
            assert set(t) == set(j), path
            for k in t:
                walk(t[k], j[k], f"{path}/{k}")
        elif isinstance(t, tuple):
            assert type(t).__name__ == type(j).__name__, path
            assert t._fields == j._fields, path
            for f in t._fields:
                walk(getattr(t, f), getattr(j, f), f"{path}.{f}")
        else:
            np.testing.assert_array_equal(np_(t), np_(j), err_msg=path)

    walk(tparams, jparams_np, "")


@pytest.mark.parametrize("mode", ["int8", "outliers"])
def test_fuse_and_convert_match_jax(llama_jax, mode):
    jspec, jparams = llama_jax
    spec = DecoderSpec(**vars(jspec))
    if mode == "outliers":
        # seeded stand-ins for calibration stats, one feature of each layer
        # past the threshold (every linear takes the decomposition), shared
        # by the projections that read the same input
        rng = np.random.default_rng(4)
        stats = {}
        for group in (("wq", "wk", "wv"), ("wo",), ("w_gate", "w_up"),
                      ("w_down",)):
            in_f = jparams["layers"][group[0]].shape[1]
            a = rng.uniform(0, 1, (jspec.num_layers, in_f)).astype(np.float32)
            a[np.arange(jspec.num_layers), rng.integers(in_f, size=3)] = 9.0
            stats.update((k, a) for k in group)
        jq = j8.quantize_layer_params(jparams, outlier_stats=stats)
    else:
        jq = j8.quantize_layer_params(jparams)
    tq = params_from_jax(spec, to_np(jq), device="cpu")
    kind = t8.Int8OutlierWeight if mode == "outliers" else t8.Int8Weight
    assert isinstance(tq["layers"]["wq"], kind)
    assert isinstance(tq["embed_tokens"], torch.Tensor)
    assert_params_equal(tq, to_np(jq))
    jf, tf = jfuse(jspec, jq), fuse_params(spec, tq)
    assert isinstance(tf["layers"]["w_qkv"], kind)
    assert isinstance(tf["layers"]["w_gu"], kind)
    assert "wq" not in tf["layers"] and "w_gate" not in tf["layers"]
    assert_params_equal(tf, to_np(jf))


def test_outlier_fusion_needs_equal_feature_sets():
    rng = np.random.default_rng(5)
    ws = [weight(rng, (2, 64, 32)) for _ in range(3)]
    idx = [np.array([[1, 2], [3, 4]], np.int32)] * 2 + \
        [np.array([[1, 2], [3, 5]], np.int32)]
    for same in (True, False):
        use = idx[:2] + [idx[0] if same else idx[2]]
        jl = {k: j8.quantize_int8_outliers(w, i)
              for k, w, i in zip(("wq", "wk", "wv"), ws, use)}
        tl = {k: t8.quantize_int8_outliers(torch.from_numpy(w), i)
              for k, w, i in zip(("wq", "wk", "wv"), ws, use)}
        jf = jfuse(None, {"layers": jl})["layers"]
        tf = fuse_params(None, {"layers": tl})["layers"]
        assert ("w_qkv" in tf) == ("w_qkv" in jf) == same


# --- calibration ---------------------------------------------------------------


@pytest.fixture(scope="module")
def planted_dir(tmp_path_factory):
    """A copy of the served fixture (tiny llama + tokenizer) whose embedding
    carries a hot feature in every token, as LLM.int8's outlier dims."""
    from safetensors.torch import load_file, save_file

    src = fixtures.tokenized_model_dir()
    out = tmp_path_factory.mktemp("int8") / "planted"
    shutil.copytree(src, out)
    f = out / "model.safetensors"
    state = load_file(f)
    state["model.embed_tokens.weight"][:, HOT] += 30.0
    save_file(state, f, metadata={"format": "pt"})
    return str(out)


def test_calibration_matches_jax(planted_dir):
    jspec, jparams = jfamilies.load_model(planted_dir, dtype=jnp.float32)
    tspec, tparams = families.load_model(planted_dir, dtype=torch.float32,
                                         device="cpu")
    ids = np.random.default_rng(6).integers(0, jspec.vocab_size, (3, 24))
    want = jcal.collect_linear_input_absmax(jspec, jparams, ids)
    got = tcal.collect_linear_input_absmax(tspec, tparams, ids)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
        picked = tcal.pick_outlier_features(got[k])
        np.testing.assert_array_equal(picked,
                                      jcal.pick_outlier_features(want[k]))
        # the residual stream's readers take the planted feature
        if k in ("wq", "w_gate"):
            assert (picked == HOT).any(axis=1).all(), k
    # ties and fill: K beyond the crossers, equal values in input order
    flat = np.zeros((2, 64), np.float32)
    flat[:, [8, 30]] = 9.0
    for kw in ({}, {"k": 5}, {"min_k": 3}):
        np.testing.assert_array_equal(
            tcal.pick_outlier_features(flat, **kw),
            jcal.pick_outlier_features(flat, **kw))


@pytest.mark.parametrize("mode", ["int8", "int8-outliers", "bitsandbytes"])
def test_load_model_matches_jax(planted_dir, mode):
    jspec, jparams = jfamilies.load_model(planted_dir, dtype=jnp.float32,
                                          quantize=mode)
    tspec, tparams = families.load_model(planted_dir, dtype=torch.float32,
                                         quantize=mode, device="cpu")
    assert tspec == DecoderSpec(**vars(jspec))
    kind = t8.Int8Weight if mode == "int8" else t8.Int8OutlierWeight
    assert isinstance(tparams["layers"]["wq"], kind)
    assert isinstance(tparams["lm_head"], torch.Tensor)
    jnp_params = to_np(jparams)
    for key, tw in tparams["layers"].items():
        jw = jnp_params["layers"][key]
        if isinstance(tw, tuple):
            assert type(tw).__name__ == type(jw).__name__, key
            np.testing.assert_array_equal(tw.q.numpy(), jw.q, err_msg=key)
            np.testing.assert_allclose(tw.scale.numpy(), jw.scale, rtol=1e-6,
                                       atol=0, err_msg=key)
            if isinstance(tw, t8.Int8OutlierWeight):
                np.testing.assert_array_equal(tw.outlier_idx.numpy(),
                                              jw.outlier_idx, err_msg=key)
                np.testing.assert_array_equal(np_(tw.outlier_w),
                                              np_(jw.outlier_w), err_msg=key)
        else:
            assert_params_equal(tw, jw)


def test_calibration_text_path(planted_dir, tmp_path, monkeypatch):
    spec = families._llama_spec(families.load_hf_config(planted_dir))
    builtin = families._calibration_token_ids(planted_dir, spec, 16)
    assert builtin.shape[0] == len(families._CALIBRATION_TEXTS)
    assert builtin.shape[1] <= 16
    corpus = tmp_path / "calib.txt"
    corpus.write_text("hello world this is a test\n\nthe quick brown fox\n")
    monkeypatch.setenv("CALIBRATION_TEXT_PATH", str(corpus))
    ids = families._calibration_token_ids(planted_dir, spec, 16)
    assert ids.shape[0] == 2
    from text_generation_inference_tpu_torch.utils.tokenization import (
        ServingTokenizer)

    tok = ServingTokenizer.load(planted_dir)
    first = tok.encode("hello world this is a test", add_special_tokens=True)
    np.testing.assert_array_equal(ids[0, :len(first)], first)
    # repeat-padding keeps the short row on text
    second = tok.encode("the quick brown fox", add_special_tokens=True)
    assert (ids[1, len(second):] == second[-1]).all()
    # no tokenizer: uniform ids from a seed, as JAX
    np.testing.assert_array_equal(
        families._calibration_token_ids(fixtures.tiny_llama(), spec, 8),
        jfamilies._calibration_token_ids(fixtures.tiny_llama(), spec, 8))


# --- serving ------------------------------------------------------------------


def staggered(eng, rp_cls, chunk_steps=6):
    """Two requests, a free, a third request. Returns {name: [(token,
    logprob), ...]}."""
    out = {}

    def first(res, names):
        for i, n in enumerate(names):
            out[n] = [(int(res.first_token.next_ids[i]),
                       float(res.first_token.logprob[i]))]

    def decode(slots):
        for _ in range(chunk_steps):
            for step in eng.decode_steps():
                for name, s in slots.items():
                    out[name].append((int(step.next_ids[s]),
                                      float(step.logprob[s])))

    sa, sb = eng.acquire_slot(), eng.acquire_slot()
    first(eng.prefill([sa, sb], PROMPTS[:2], [rp_cls(max_new_tokens=20)] * 2),
          ["a", "b"])
    decode({"a": sa, "b": sb})
    eng.free(sb)
    sc = eng.acquire_slot()
    first(eng.prefill([sc], [PROMPTS[2]], [rp_cls(max_new_tokens=20)]), ["c"])
    decode({"a": sa, "c": sc})
    return out


def make_config(cls):
    cfg = cls(max_sequence_length=64, max_new_tokens=32, max_batch_slots=3,
              prefill_buckets=[8, 16], kv_page_size=8)
    cfg.validate()
    return cfg


JAX_ENGINE = {"int8": JSlotEngine, "bitsandbytes": JPagedEngine}


@pytest.fixture(scope="module")
def jax_runs(planted_dir):
    runs = {}
    for mode, cls in JAX_ENGINE.items():
        spec, params = jfamilies.load_model(planted_dir, dtype=jnp.float32,
                                            quantize=mode)
        kw = {"num_pages": 16} if cls is JPagedEngine else {}
        runs[mode] = staggered(cls(spec, params, make_config(JConfig),
                                   eos_token_id=2, **kw), JRequestParams)
    return runs


@pytest.mark.parametrize("engine", ["slot", "paged"])
@pytest.mark.parametrize("mode", ["int8", "bitsandbytes"])
def test_greedy_serving_matches_jax(planted_dir, jax_runs, engine, mode):
    spec, params = families.load_model(planted_dir, dtype=torch.float32,
                                       quantize=mode, device="cpu")
    if engine == "slot":
        eng = InferenceEngine(spec, params, make_config(ServingConfig),
                              eos_token_id=2, device="cpu")
    else:
        eng = PagedInferenceEngine(spec, params, make_config(ServingConfig),
                                   eos_token_id=2, num_pages=16, device="cpu")
    kind = t8.Int8Weight if mode == "int8" else t8.Int8OutlierWeight
    assert isinstance(eng.model_params["layers"]["w_qkv"], kind)
    got, want = staggered(eng, RequestParams), jax_runs[mode]
    assert {k: [t for t, _ in v] for k, v in got.items()} == \
        {k: [t for t, _ in v] for k, v in want.items()}
    for k in want:
        np.testing.assert_allclose([lp for _, lp in got[k]],
                                   [lp for _, lp in want[k]],
                                   rtol=0, atol=LOGPROB_TOL, err_msg=k)


# --- memory -------------------------------------------------------------------


def test_memory_plan_counts_the_int8_transient(planted_dir):
    cfg = make_config(ServingConfig)
    dense = families.load_model(planted_dir, dtype=torch.float32,
                                device="cpu")[1]
    spec, q8 = families.load_model(planted_dir, dtype=torch.float32,
                                   quantize="int8", device="cpu")
    _, qo = families.load_model(planted_dir, dtype=torch.float32,
                                quantize="bitsandbytes", device="cpu")
    # the int8 leaves count: codes (1 byte) and f32 scales
    lin = [k for k in dense["layers"] if k in t8.LINEAR_KEYS]
    shrink = sum(dense["layers"][k].numel() * 3
                 - dense["layers"][k].shape[0] * dense["layers"][k].shape[-1]
                 * 4 for k in lin)
    assert memory.tree_bytes(dense) - memory.tree_bytes(q8) == shrink
    assert memory.quant_transient_bytes(dense, cfg) == 0
    # the largest linear's bf16 copy: w_up / w_gate [64, 128] or w_down
    # [128, 64], one layer each
    assert memory.quant_transient_bytes(q8, cfg) == 64 * 128 * 2
    wo = qo["layers"]["w_gate"]
    k = wo.outlier_idx.shape[-1]
    assert k > 0
    t = cfg.max_prefill_tokens
    assert memory.quant_transient_bytes(qo, cfg) == \
        64 * 128 * 2 + t * k * (4 + 2) + t * 128 * 4
    # both engines' plans hold the term (fused: w_gu is [64, 256])
    slot = InferenceEngine(spec, q8, make_config(ServingConfig),
                           eos_token_id=2, device="cpu")
    assert slot.memory_plan.quant_bytes == 64 * 256 * 2
    paged = PagedInferenceEngine(spec, q8, make_config(ServingConfig),
                                 eos_token_id=2, device="cpu")
    assert paged.memory_plan.quant_bytes == 64 * 256 * 2
    assert "int8 transient" in paged.memory_plan.describe()
    plain = PagedInferenceEngine(spec, dense, make_config(ServingConfig),
                                 eos_token_id=2, device="cpu")
    assert plain.memory_plan.quant_bytes == 0
