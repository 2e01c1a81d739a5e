"""The port's offline quantization tools against the JAX package on the CPU:
the GPTQ solve (`ops/quant/gptq_quantize.py`), the quality metrics
(`ops/quant/quality.py`) and the CLI verbs `quantize`,
`convert-to-safetensors` and `convert-to-fast-tokenizer`.

Tolerances:

  * the GPTQ solve runs the JAX package's numpy algorithm in torch
    float64: codes equal in at least 99.9% of entries and never more than
    one apart, scales within 1e-5 relative, g_idx identical (in practice
    all equal; the bound allows float64 rounding to flip a code sitting on
    a rounding edge);
  * perplexity and the KL of models far from the reference (RTN INT4) within
    1e-4 relative; the KLs of int8 weights, the int8 KV cache and GPTQ sit
    at 1e-8 to 1e-4, near the f32 noise of two forward passes that sum in
    another order (where x's bf16 rounding in the int8 product can also
    flip an ulp), so those are held to 1e-4 relative plus 1e-7 absolute.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text_generation_inference_tpu.models import families as jfamilies
from text_generation_inference_tpu.ops.quant import gptq_quantize as jg
from text_generation_inference_tpu.ops.quant import int8 as j8
from text_generation_inference_tpu.ops.quant import quality as jq
from text_generation_inference_tpu.ops.quant.int4 import (
    quantize_layer_params_int4 as jrtn)
from text_generation_inference_tpu_torch import cli
from text_generation_inference_tpu_torch.models import families
from text_generation_inference_tpu_torch.models.convert import params_from_jax
from text_generation_inference_tpu_torch.models.core import DecoderSpec
from text_generation_inference_tpu_torch.ops.quant import gptq_quantize as tg
from text_generation_inference_tpu_torch.ops.quant import int4
from text_generation_inference_tpu_torch.ops.quant import int8 as t8
from text_generation_inference_tpu_torch.ops.quant import quality as tq
from tests import fixtures


def codes(qweight) -> np.ndarray:
    return int4.unpack_rows(torch.as_tensor(np.array(qweight))).numpy()


def assert_codes_close(got, want):
    """At least 99.9% of the 4-bit codes equal, none more than one apart."""
    g, w = codes(got), codes(want)
    assert (g == w).mean() >= 0.999, (g == w).mean()
    assert np.abs(g - w).max() <= 1


def assert_solve_close(got, want):
    qw, qz, sc, gi = (t.cpu().numpy() for t in got)
    jqw, jqz, jsc, jgi = want
    assert_codes_close(qw, jqw)
    np.testing.assert_array_equal(gi, jgi)
    np.testing.assert_allclose(sc, jsc, rtol=1e-5, atol=0)
    zg = int4.unpack_cols(torch.from_numpy(qz)).numpy()
    zw = int4.unpack_cols(torch.from_numpy(np.asarray(jqz))).numpy()
    assert (zg == zw).mean() >= 0.999


# --- the GPTQ solve -----------------------------------------------------------


@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("act_order", [False, True])
def test_gptq_solve_matches_jax(act_order, dead):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(256, 512)).astype(np.float32)
    x = rng.normal(size=(1024, 512)).astype(np.float32)
    x[:, ::7] *= 3.0                       # uneven Hessian diagonal
    if dead:
        x[:, 100:104] = 0.0                # dead input features
    h = 2.0 * (x.T @ x)
    want = jg.gptq_quantize_weight(w, h, groupsize=128, act_order=act_order)
    got = tg.gptq_quantize_weight(w, h, groupsize=128, act_order=act_order,
                                  device="cpu")
    assert [t.dtype for t in got] == [torch.int32, torch.int32,
                                      torch.float32, torch.int32]
    assert [tuple(t.shape) for t in got] == [a.shape for a in want]
    assert_solve_close(got, want)
    if act_order:
        assert sorted(np.bincount(got[3].numpy()).tolist()) == [128] * 4


def test_gptq_solve_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tg.gptq_quantize_weight(np.zeros((8, 128), np.float32),
                                np.eye(128, dtype=np.float32))


# --- quality metrics ----------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    jspec, jparams = jfamilies.load_model(fixtures.tiny_llama(),
                                          dtype=jnp.float32)
    spec = DecoderSpec(**vars(jspec))
    tparams = params_from_jax(spec, jax.tree_util.tree_map(np.asarray,
                                                           jparams),
                              device="cpu")
    rng = np.random.default_rng(7)
    corpus = [rng.integers(1, spec.vocab_size, size=int(n)).tolist()
              for n in rng.integers(12, 48, size=8)]
    return jspec, jparams, spec, tparams, corpus


def close(got, want, atol=0.0):
    assert abs(got - want) <= 1e-4 * abs(want) + atol, (got, want)


def test_perplexity_matches_jax(setup):
    jspec, jparams, spec, tparams, corpus = setup
    close(tq.perplexity(spec, tparams, corpus),
          jq.perplexity(jspec, jparams, corpus))
    jint8 = j8.quantize_layer_params(jparams)
    close(tq.perplexity(spec, t8.quantize_layer_params(tparams), corpus),
          jq.perplexity(jspec, jint8, corpus))


@pytest.mark.parametrize("quant", ["rtn4", "int8"])
def test_mean_token_kl_matches_jax(setup, quant):
    jspec, jparams, spec, tparams, corpus = setup
    if quant == "rtn4":
        jqp = jrtn(jparams, groupsize=32)
        tqp = params_from_jax(spec, jax.tree_util.tree_map(np.asarray, jqp),
                              device="cpu")
        atol = 0.0
    else:
        jqp = j8.quantize_layer_params(jparams)
        tqp = t8.quantize_layer_params(tparams)
        atol = 1e-7
    want = jq.mean_token_kl(jspec, jparams, jqp, corpus)
    got = tq.mean_token_kl(spec, tparams, tqp, corpus)
    assert got > 0
    close(got, want, atol)


def test_kv_cache_kl_matches_jax(setup):
    jspec, jparams, spec, tparams, corpus = setup
    want = jq.kv_cache_kl(jspec, jparams, corpus, split=0.5)
    got = tq.kv_cache_kl(spec, tparams, corpus, split=0.5)
    assert 0 < got < 1e-3
    close(got, want, 1e-7)


@pytest.mark.parametrize("act_order", [False, True])
def test_gptq_quantize_params_matches_jax(setup, act_order):
    jspec, jparams, spec, tparams, corpus = setup
    jqp = jq.gptq_quantize_params(jspec, jparams, corpus, groupsize=32,
                                  act_order=act_order)
    tqp = tq.gptq_quantize_params(spec, tparams, corpus, groupsize=32,
                                  act_order=act_order)
    for key, jw in jqp["layers"].items():
        tw = tqp["layers"][key]
        if not isinstance(tw, int4.Int4Weight):
            continue
        assert_codes_close(tw.qweight, jw.qweight)
        np.testing.assert_allclose(tw.scales.numpy(), np.asarray(jw.scales),
                                   rtol=1e-5, atol=0, err_msg=key)
        np.testing.assert_array_equal(tw.g_idx.numpy(), np.asarray(jw.g_idx))
        assert (tw.perm is None) == (jw.perm is None), key
        if tw.perm is not None:
            np.testing.assert_array_equal(tw.perm.numpy(),
                                          np.asarray(jw.perm))
    close(tq.mean_token_kl(spec, tparams, tqp, corpus),
          jq.mean_token_kl(jspec, jparams, jqp, corpus), 1e-7)


# --- CLI verbs ----------------------------------------------------------------


def test_convert_to_safetensors_round_trip(tmp_path):
    from safetensors.torch import load_file

    w = torch.randn(8, 4)
    state = {"a.weight": w, "tied.weight": w, "b.weight": torch.randn(4, 2),
             "c.bias": torch.arange(6, dtype=torch.int64)}
    torch.save(state, tmp_path / "pytorch_model.bin")
    cli.main(["convert-to-safetensors", str(tmp_path)])
    out = load_file(tmp_path / "model.safetensors")
    # shared storage kept once, under its first name
    assert set(out) == {"a.weight", "b.weight", "c.bias"}
    for k, v in out.items():
        assert torch.equal(v, state[k])


def test_convert_to_fast_tokenizer(tmp_path):
    pytest.importorskip("transformers")
    src = fixtures.tokenized_model_dir()
    cli.main(["convert-to-fast-tokenizer", src, "--output-path",
              str(tmp_path)])
    assert (tmp_path / "tokenizer.json").exists()


def test_cli_verbs_and_flags(monkeypatch):
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    with pytest.raises(SystemExit):
        cli.main(["download-weights", "x"])    # hub-only: not a port verb
    seen = {}
    monkeypatch.setattr(tg, "quantize_model", lambda **kw: seen.update(kw))
    cli.main(["quantize", "in", "out", "--bits", "4", "--groupsize", "64",
              "--dataset", "cal.txt", "--num-samples", "3", "--device",
              "cpu"])
    assert seen == dict(model_path="in", output_dir="out", bits=4,
                        groupsize=64, calibration="cal.txt", num_samples=3,
                        device="cpu")


@pytest.fixture(scope="module")
def quantized_dirs(tmp_path_factory):
    pytest.importorskip("transformers")
    model_dir = fixtures.tiny_llama()
    root = tmp_path_factory.mktemp("gptq_tools")
    jout, tout = root / "jax", root / "torch"
    kw = dict(bits=4, groupsize=32, num_samples=4, seq_len=64)
    jg.quantize_model(model_dir, str(jout), **kw)
    tg.quantize_model(model_dir, str(tout), device="cpu", **kw)
    return jout, tout


def test_quantize_model_matches_jax(quantized_dirs):
    from safetensors.torch import load_file

    jout, tout = quantized_dirs
    want, got = (load_file(d / "model.safetensors") for d in quantized_dirs)
    assert set(got) == set(want)
    for name, t in got.items():
        w = want[name]
        assert t.dtype == w.dtype and t.shape == w.shape, name
        if name.endswith(".qweight"):
            assert_codes_close(t, w)
        elif name.endswith(".qzeros"):
            assert (int4.unpack_cols(t) == int4.unpack_cols(w)).float().mean() \
                >= 0.999, name
        elif name.endswith(".scales"):
            np.testing.assert_allclose(t.numpy(), w.numpy(), rtol=1e-5,
                                       atol=0, err_msg=name)
        else:
            assert torch.equal(t, w), name
    assert json.loads((tout / "quantize_config.json").read_text()) == \
        json.loads((jout / "quantize_config.json").read_text())
    assert (tout / "config.json").read_bytes() == \
        (Path(fixtures.tiny_llama()) / "config.json").read_bytes()
    # the port's loader reads its own artifact as GPTQ
    _, params = families.load_model(str(tout), dtype=torch.float32,
                                    quantize="gptq", device="cpu")
    assert isinstance(params["layers"]["wq"], int4.Int4Weight)
