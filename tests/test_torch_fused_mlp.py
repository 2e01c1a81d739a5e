"""The port's fused GPTQ-INT4 GLU MLP (kernel M1's plain version and the
`INT4_FUSED_MLP=1` route) against the JAX package, on the CPU.

* `int4_mlp_reference` (what the M1 wrapper runs on a CPU tensor) against
  the JAX Pallas kernel `int4_mlp_s4_stacked` in interpret mode, f32
  compute, for silu: 3 layers, S in {1, 5, 16, 64}, H=256, I=384, group
  128, a traced layer index per layer; within 2e-4 absolute and relative,
  the JAX suite's own tolerance (tests/test_int4.py).
* `gelu_glu`: the port computes the model's exact (erf) GELU, held against
  the JAX model's unfused math (`core._activate`) within 2e-4; and one case
  pins the reference fault recorded in ROADMAP Queue 3 (`gelu_glu`): the JAX
  kernel's `gelu_glu` is the tanh approximation, 4.7e-4 away from erf at a
  gate of -2.70 and an up of 1.0.
* `ops.linear.can_fuse_mlp` and `models.core._mlp`: the fused route is
  refused for an act-order perm, an MLP bias, a non-GLU activation,
  `gelu_tanh_glu`, more than 64 rows, and with the option off.
* The slice as a whole: a `mini` GPTQ checkpoint served with
  INT4_FUSED_MLP=1 on the port's paged and slot engines, float KV and int8
  ring chunks, against the JAX engines with the same option. Greedy tokens
  are identical and logprobs agree within 5e-4 (the repo's golden
  tolerance); the decode MLP goes through the fused wrapper and never
  through the K1 name for w_gu or w_down.

GPTQ words are packed once, in numpy, and carried to both packages: the JAX
side as its own `Int4Weight` and `populate_q4`, the port through
`models/convert.py`.
"""

import math
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_generation_inference_tpu.config import ServingConfig as JConfig
from text_generation_inference_tpu.engine.engine import (
    InferenceEngine as JSlotEngine, RequestParams as JRequestParams)
from text_generation_inference_tpu.engine.paged_engine import (
    PagedInferenceEngine as JPagedEngine)
from text_generation_inference_tpu.models import core as jcore
from text_generation_inference_tpu.models import families as jfamilies
from text_generation_inference_tpu.ops.pallas import int4_matmul as jim
from text_generation_inference_tpu.ops.quant import int4 as jint4
from text_generation_inference_tpu_torch.config import ServingConfig
from text_generation_inference_tpu_torch.engine.engine import (
    InferenceEngine, RequestParams)
from text_generation_inference_tpu_torch.engine.paged_engine import (
    PagedInferenceEngine)
from text_generation_inference_tpu_torch.models import core, families
from text_generation_inference_tpu_torch.models.convert import int4_from_jax
from text_generation_inference_tpu_torch.ops import linear
from text_generation_inference_tpu_torch.ops.cuda import int4_mlp as mlp
from text_generation_inference_tpu_torch.ops.quant import int4

TOL = 2e-4
LOGPROB_TOL = 5e-4
LAYERS, H, INTER, GS = 3, 256, 384, 128


# --- GPTQ words, packed once ---------------------------------------------------


def pack_rows(q):
    """[L, in, out] nibbles → [L, in/8, out] int32 (eight rows a word)."""
    q = q.astype(np.uint32).reshape(q.shape[0], -1, 8, q.shape[2])
    words = sum(q[:, :, k] << np.uint32(4 * k) for k in range(8))
    return words.astype(np.uint32).view(np.int32)


def pack_cols(z):
    """[L, groups, out] nibbles → [L, groups, out/8] int32."""
    z = z.astype(np.uint32).reshape(z.shape[0], z.shape[1], -1, 8)
    words = sum(z[..., k] << np.uint32(4 * k) for k in range(8))
    return words.astype(np.uint32).view(np.int32)


def gptq_stack(rng, in_f, out_f, gs=GS, layers=LAYERS):
    """A layer-stacked JAX Int4Weight (numpy leaves, zbias set) with the
    test suite's scaling: x @ W is O(1) for x ~ N(0, 1)."""
    q = rng.integers(0, 16, (layers, in_f, out_f))
    stored = rng.integers(6, 9, (layers, in_f // gs, out_f))   # zero - 1
    scales = (rng.uniform(0.5, 1.5, (layers, in_f // gs, out_f))
              * (0.6 / np.sqrt(in_f) / 4.6)).astype(np.float32)
    g_idx = np.tile((np.arange(in_f) // gs).astype(np.int32), (layers, 1))
    return jint4.Int4Weight(
        qweight=pack_rows(q), qzeros=pack_cols(stored), scales=scales,
        g_idx=g_idx, zbias=((stored + 1) * scales).astype(np.float32))


def to_jax(w):
    return w._replace(**{f: jnp.asarray(getattr(w, f))
                         for f in ("qweight", "qzeros", "scales", "g_idx",
                                   "zbias")})


def layer_of(w, li):
    """Layer li of a stacked JAX Int4Weight (jnp leaves)."""
    return w._replace(**{f: getattr(w, f)[li]
                         for f in ("qweight", "qzeros", "scales", "g_idx",
                                   "zbias")})


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    gu, down = gptq_stack(rng, H, 2 * INTER), gptq_stack(rng, INTER, H)
    return gu, down


def jax_kernel(x, gu, down, li, activation):
    """The JAX Pallas kernel in interpret mode, f32 compute and f32 scales."""
    jgu, jdown = jint4.populate_q4(to_jax(gu)), jint4.populate_q4(to_jax(down))
    s_pad = max(8, -(-x.shape[0] // 8) * 8)
    bi = jim.mlp_block_i(INTER, H, GS, s_pad)
    d_sc, d_zb = jim.prep_stacked_scales(jdown.scales, jdown.zbias, INTER, bi,
                                         GS, compute_dtype=jnp.float32)
    return np.asarray(jim.int4_mlp_s4_stacked(
        jnp.asarray(x), jgu.q4, jgu.scales, jgu.zbias, jdown.q4, d_sc, d_zb,
        jnp.asarray([li], jnp.int32), inter=INTER, groupsize_down=GS,
        activation=activation, compute_dtype=jnp.float32, interpret=True))


# --- the plain version against the JAX kernel and model ---------------------------


def test_port_weights_carry_the_same_words(pair):
    gu, _ = pair
    w = int4_from_jax(gu, "cpu")
    assert w.qweight.shape == (LAYERS, H // 8, 2 * INTER)
    np.testing.assert_array_equal(
        int4.unpack_rows(w.qweight[1]).numpy(),
        np.asarray(jint4.unpack_rows(jnp.asarray(gu.qweight[1]))))
    np.testing.assert_allclose(int4.compute_zbias(w).zbias.numpy(), gu.zbias,
                               rtol=1e-6)


@pytest.mark.parametrize("s", [1, 5, 16, 64])
def test_reference_matches_jax_kernel_silu(pair, s):
    gu, down = pair
    x = np.random.default_rng(s).normal(size=(s, H)).astype(np.float32)
    w_gu, w_down = int4_from_jax(gu, "cpu"), int4_from_jax(down, "cpu")
    for li in range(LAYERS):
        got = mlp.int4_mlp_s4_stacked(torch.from_numpy(x), w_gu, w_down, li,
                                      "silu_glu")
        want = jax_kernel(x, gu, down, li, "silu_glu")
        assert got.dtype == torch.float32 and got.shape == (s, H)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_reference_gelu_glu_matches_jax_model_math(pair):
    """gelu_glu as the JAX model defines it (`core._activate`, erf), on the
    unfused product of the same dequantized weights."""
    gu, down = pair
    x = np.random.default_rng(7).normal(size=(5, H)).astype(np.float32)
    w_gu, w_down = int4_from_jax(gu, "cpu"), int4_from_jax(down, "cpu")
    jgu, jdown = to_jax(gu), to_jax(down)
    spec = types.SimpleNamespace(activation="gelu_glu")
    for li in (0, LAYERS - 1):
        g_u = jint4.matmul_dequant(jnp.asarray(x), layer_of(jgu, li))
        a = jcore._activate(spec, g_u[:, INTER:], g_u[:, :INTER])
        want = np.asarray(jint4.matmul_dequant(a, layer_of(jdown, li)))
        got = mlp.int4_mlp_s4_stacked(torch.from_numpy(x), w_gu, w_down, li,
                                      "gelu_glu")
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_jax_kernel_gelu_glu_is_tanh_not_erf():
    """The reference fault (ROADMAP Queue 3, `gelu_glu`): x = e0 and weights
    that give the gate column 0 the value -2.70 and the up column 1.0; the
    down product reads a[0] back. The JAX kernel returns tanh-GELU(-2.7),
    4.7e-4 from the erf GELU the model defines (2e-4 is the JAX suite's
    kernel tolerance); the port returns the erf value."""
    inter = 128
    q_gu = np.zeros((1, H, 2 * inter), np.int64)
    q_gu[0, 0, inter] = 1
    sc_gu = np.ones((1, H // GS, 2 * inter), np.float32)
    zb_gu = np.zeros_like(sc_gu)
    zb_gu[0, 0, 0] = 2.7                   # gate[0] = 0 * 1 - 2.7
    q_d = np.zeros((1, inter, H), np.int64)
    q_d[0, 0, 0] = 1                       # y[0] = a[0]
    sc_d = np.ones((1, inter // GS, H), np.float32)
    zb_d = np.zeros_like(sc_d)
    x = np.zeros((1, H), np.float32)
    x[0, 0] = 1.0

    d_sc, d_zb = jim.prep_stacked_scales(jnp.asarray(sc_d), jnp.asarray(zb_d),
                                         inter, inter, GS,
                                         compute_dtype=jnp.float32)
    jax_y = float(np.asarray(jim.int4_mlp_s4_stacked(
        jnp.asarray(x), jnp.asarray(q_gu - 8, jnp.int4), jnp.asarray(sc_gu),
        jnp.asarray(zb_gu), jnp.asarray(q_d - 8, jnp.int4), d_sc, d_zb,
        jnp.asarray([0], jnp.int32), inter=inter, groupsize_down=GS,
        activation="gelu_glu", compute_dtype=jnp.float32,
        interpret=True))[0, 0])

    def port_weight(q, sc, zb):
        return int4.Int4Weight(
            qweight=torch.from_numpy(pack_rows(q)),
            qzeros=torch.zeros(1, sc.shape[1], sc.shape[2] // 8,
                               dtype=torch.int32),
            scales=torch.from_numpy(sc),
            g_idx=torch.zeros(1, q.shape[1], dtype=torch.int32),
            zbias=torch.from_numpy(zb))

    port_y = float(mlp.int4_mlp_s4_stacked(
        torch.from_numpy(x), port_weight(q_gu, sc_gu, zb_gu),
        port_weight(q_d, sc_d, zb_d), 0, "gelu_glu")[0, 0])
    g = np.float32(-2.7)
    erf_gelu = 0.5 * float(g) * (1.0 + math.erf(float(g) / math.sqrt(2.0)))
    assert abs(jax_y - erf_gelu) > 4e-4            # observed 4.7e-4
    assert abs(jax_y - erf_gelu) > TOL
    assert abs(port_y - erf_gelu) < 1e-6


# --- the route's rule -----------------------------------------------------------


def routed(pair, fuse_mlp=True, rows=16, **replace):
    w_gu, w_down = (int4_from_jax(w, "cpu") for w in pair)
    w_down = w_down._replace(**replace)
    params = {"layers": {"w_gu": w_gu, "w_down": w_down,
                         "wo": int4_from_jax(pair[1], "cpu")}}
    lp = linear.prepare_params(params, rows=rows, fuse_mlp=fuse_mlp)["layers"]
    return core.layer_params(lp, 1)


def test_can_fuse_mlp_takes_a_marked_glu_pair(pair):
    lp = routed(pair)
    assert lp["w_gu"].route == lp["w_down"].route == "fused"
    assert lp["wo"].route == "stacked"
    for act in ("silu_glu", "gelu_glu"):
        assert linear.can_fuse_mlp(lp["w_gu"], lp["w_down"], act, 64)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 3, H)).astype(np.float32))
    fused = linear.mlp_fused(x, lp["w_gu"], lp["w_down"], "silu_glu")
    plain = core.layer_params({"w_gu": lp["w_gu"], "w_down": lp["w_down"]}, 1,
                              int4_plain=True)
    assert torch.equal(fused, linear.mlp_fused(x, plain["w_gu"],
                                               plain["w_down"], "silu_glu"))
    # each weight of the pair still serves the unfused product
    h = linear.matmul(x, lp["w_gu"])
    want = linear.matmul(h[..., INTER:] * torch.nn.functional.silu(
        h[..., :INTER]), lp["w_down"])
    np.testing.assert_allclose(fused.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_can_fuse_mlp_refusals(pair):
    lp = routed(pair)
    perm = torch.arange(INTER, dtype=torch.int32).repeat(LAYERS, 1)
    refusals = {
        "perm": routed(pair, perm=perm),
        "rows > 64": routed(pair, rows=65),
        "option off": routed(pair, fuse_mlp=False),
    }
    for name, r in refusals.items():
        assert not linear.can_fuse_mlp(r["w_gu"], r["w_down"], "silu_glu",
                                       16), name
    assert not linear.can_fuse_mlp(lp["w_gu"], lp["w_down"], "silu_glu", 65)
    assert not linear.can_fuse_mlp(lp["w_gu"], lp["w_down"], "gelu_tanh_glu",
                                   16)
    assert not linear.can_fuse_mlp(lp["w_gu"], lp["w_down"], "gelu", 16)
    # a perm on a pair marked by hand is refused too
    marked = lp["w_down"]._replace(weight=lp["w_down"].weight._replace(
        perm=perm))
    assert not linear.can_fuse_mlp(lp["w_gu"], marked, "silu_glu", 16)


def test_mlp_takes_the_fused_route_without_bias_only(pair, monkeypatch):
    calls = []
    real = linear.mlp_fused

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(linear, "mlp_fused", spy)
    lp = routed(pair)
    spec = types.SimpleNamespace(activation="silu_glu", mlp_bias=False,
                                 intermediate_size=INTER)
    x = torch.ones(4, H)
    core._mlp(spec, lp, x)
    assert len(calls) == 1
    core._mlp(spec, {**lp, "b_gu": torch.zeros(2 * INTER)}, x)
    core._mlp(types.SimpleNamespace(**{**vars(spec), "mlp_bias": True}),
              {**lp, "b_gu": torch.zeros(2 * INTER),
               "b_down": torch.zeros(H)}, x)
    core._mlp(types.SimpleNamespace(**{**vars(spec),
                                       "activation": "gelu_tanh_glu"}), lp, x)
    core._mlp(spec, lp, torch.ones(65, H))
    assert len(calls) == 1


def test_wrapper_refuses_what_the_kernel_does_not_take(pair):
    w_gu, w_down = (int4_from_jax(w, "cpu") for w in pair)
    x = torch.zeros(4, H)
    with pytest.raises(ValueError, match="rows"):
        mlp.int4_mlp_s4_stacked(torch.zeros(65, H), w_gu, w_down, 0)
    with pytest.raises(ValueError, match="layer"):
        mlp.int4_mlp_s4_stacked(x, w_gu, w_down, LAYERS)
    with pytest.raises(ValueError, match="perm"):
        mlp.int4_mlp_s4_stacked(x, w_gu._replace(
            perm=torch.arange(H, dtype=torch.int32).repeat(LAYERS, 1)),
            w_down, 0)
    with pytest.raises(ValueError, match="fuse"):
        mlp.int4_mlp_s4_stacked(x, w_gu, w_down, 0, "gelu_tanh_glu")
    with pytest.raises(ValueError, match="pair"):
        mlp.int4_mlp_s4_stacked(x, w_down, w_gu, 0)
    # the kernel reads the zero points from qzeros: one of another shape
    # is refused on any device
    with pytest.raises(ValueError, match="qzeros"):
        mlp.int4_mlp_s4_stacked(x, w_gu, w_down._replace(
            qzeros=w_down.qzeros[:, :1].contiguous()), 0)
    assert mlp.int4_mlp_s4_stacked.launches == 0      # the CPU launches nothing


# --- the slice: INT4_FUSED_MLP=1 on both engines ----------------------------------


@pytest.fixture(scope="module")
def mini_gptq(tmp_path_factory):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    from make_shaped_checkpoint import PRESETS, write_checkpoint

    out = str(tmp_path_factory.mktemp("gptq_fused") / "mini_gptq")
    write_checkpoint(out, PRESETS["mini"], quantize="gptq")
    return out


PROMPTS = [[5, 9, 23, 77, 41], [100, 3, 250, 17, 88, 91, 12], [7, 7, 7]]
CASES = {
    "paged-float-step": ("paged", dict(decode_chunk=1)),
    "paged-int8-ring": ("paged", dict(kv_cache_dtype="int8", decode_chunk=4,
                                      paged_gather_ctx_max=0)),
    "slot-float-scan": ("slot", dict(decode_chunk=4,
                                     decode_write_mode="scan")),
    "slot-int8-ring": ("slot", dict(kv_cache_dtype="int8", decode_chunk=4)),
}


def run(eng, rp_cls):
    """A and B prefilled together, 8 steps, B freed, C on the freed slot,
    8 more. Returns {name: [(token, logprob), ...]}."""
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
    first(eng.prefill([sa, sb], PROMPTS[:2], [rp_cls(max_new_tokens=24)] * 2),
          ["a", "b"])
    decode(8, {"a": sa, "b": sb})
    eng.free(sb)
    sc = eng.acquire_slot()
    first(eng.prefill([sc], PROMPTS[2:], [rp_cls(max_new_tokens=24)]), ["c"])
    decode(8, {"a": sa, "c": sc})
    return out


def make_engine(kind, cls_paged, cls_slot, cfg_cls, spec, params, kw, **extra):
    cfg = cfg_cls(max_sequence_length=64, max_new_tokens=32, max_batch_slots=3,
                  prefill_buckets=[8, 16], kv_page_size=8, **kw)
    cfg.validate()
    if kind == "paged":
        return cls_paged(spec, params, cfg, eos_token_id=2, num_pages=16,
                         **extra)
    return cls_slot(spec, params, cfg, eos_token_id=2, **extra)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_engines_match_jax(mini_gptq, case, monkeypatch):
    kind, kw = CASES[case]
    monkeypatch.setenv("INT4_FUSED_MLP", "1")
    jspec, jparams = jfamilies.load_model(mini_gptq, dtype=jnp.float32,
                                          quantize="gptq")
    want = run(make_engine(kind, JPagedEngine, JSlotEngine, JConfig, jspec,
                           jparams, kw), JRequestParams)

    fused, k1_shapes = [], []
    real_fused, real_k1 = linear.int4_mlp_s4_stacked, linear.int4_matmul_s4_stacked

    def spy_fused(x, w_gu, w_down, layer, activation):
        fused.append(x.shape[0])
        return real_fused(x, w_gu, w_down, layer, activation)

    def spy_k1(x, w, layer):
        k1_shapes.append((w.in_features, w.out_features))
        return real_k1(x, w, layer)

    monkeypatch.setattr(linear, "int4_mlp_s4_stacked", spy_fused)
    monkeypatch.setattr(linear, "int4_matmul_s4_stacked", spy_k1)
    spec, params = families.load_model(mini_gptq, dtype=torch.float32,
                                       quantize="gptq", device="cpu")
    eng = make_engine(kind, PagedInferenceEngine, InferenceEngine,
                      ServingConfig, spec, params, kw, device="cpu")
    assert eng.fuse_mlp
    got = run(eng, RequestParams)
    assert {k: [t for t, _ in v] for k, v in got.items()} == \
        {k: [t for t, _ in v] for k, v in want.items()}
    for k in want:
        np.testing.assert_allclose([lp for _, lp in got[k]],
                                   [lp for _, lp in want[k]],
                                   rtol=0, atol=LOGPROB_TOL, err_msg=k)
    # 16 decode steps of the 4 layers, 3 slot rows each
    assert len(fused) == 16 * spec.num_layers and set(fused) == {3}
    inter, hidden = spec.intermediate_size, spec.hidden_size
    assert k1_shapes and (hidden, 2 * inter) not in k1_shapes
    assert (inter, hidden) not in k1_shapes


def test_option_off_keeps_the_two_products(mini_gptq, monkeypatch):
    monkeypatch.delenv("INT4_FUSED_MLP", raising=False)
    spec, params = families.load_model(mini_gptq, dtype=torch.float32,
                                       quantize="gptq", device="cpu")
    eng = make_engine("paged", PagedInferenceEngine, InferenceEngine,
                      ServingConfig, spec, params, {}, device="cpu")
    assert not eng.fuse_mlp
    calls = []
    monkeypatch.setattr(linear, "int4_mlp_s4_stacked",
                        lambda *a: calls.append(1))
    slot = eng.acquire_slot()
    eng.prefill([slot], [PROMPTS[0]], [RequestParams(max_new_tokens=4)])
    eng.decode_steps()
    assert not calls
