"""The plain versions of the port's slot-cache kernels against the JAX
package's Pallas kernels, run in interpret mode as
tests/test_pallas_kernels.py runs them, and the port's slot decode
attention dispatch.

* S1, `ops/cuda/decode_attention.py::decode_attention_reference`, against
  `ops/pallas/decode_attention.py::decode_attention`: mixed contexts with
  ctx == 0 (the JAX kernel gives 0 there, as the port does) and contexts on
  the Pallas kernel's block edges, G = 1 and 8, D = 64 and 128.
* S2, `ops/cuda/ring_decode_attention.py::ring_decode_attention_reference`,
  against `ops/pallas/ring_decode_attention.py::ring_decode_attention`:
  ring steps 0, a middle one and the last (the whole ring), ctx == 0 slots.
* S1's schedule, `decode_attention_split_reference` (fixed row splits
  merged in split order), against the same Pallas kernel.
* `ops.attention.decode_attention`: the einsum below 2048 cache rows, the
  kernel's route at 2048 and above for bf16 (on CPU tensors the wrapper's
  plain version) and a counted plain route for other dtypes, against the
  JAX dispatch; every route of `KERNELS` against the JAX rule it mirrors
  (F1: head dims 16 / 64 / 128, G 1 / 8 / 16, three dtypes).

Tolerances: 1e-5 in fp32 (the same fp32 sums in another order), 2e-2 in
bf16 (both round the output to bf16 once; a bf16 ulp is 7.8e-3 at 1-2).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_generation_inference_tpu.ops import attention as jattention
from text_generation_inference_tpu.ops.pallas import decode_attention as jda
from text_generation_inference_tpu.ops.pallas import ring_decode_attention as jrda
from text_generation_inference_tpu_torch.ops import attention
from text_generation_inference_tpu_torch.ops.cuda import decode_attention as da
from text_generation_inference_tpu_torch.ops.cuda import ring_decode_attention as rda

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def to_torch(a, dtype):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def to_jax(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32),
                       jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def slot_inputs(rng, s, kh, g, d, t, ctx):
    q = rng.normal(size=(s, kh, g, d))
    k = rng.normal(size=(s, kh, t, d))
    v = rng.normal(size=(s, kh, t, d))
    return q, k, v, np.asarray(ctx, np.int32)


# (s, kh, g, d, t, ctx, block_t): ctx 0, one row, block edges, full
S1_CASES = {
    "g8_d64": (5, 2, 8, 64, 512, [0, 1, 128, 129, 512], 128),
    "g1_d128": (4, 4, 1, 128, 384, [255, 256, 257, 0], 128),
    "g8_d128_short": (3, 1, 8, 128, 256, [3, 0, 200], 128),
    "g4_d64_random": (6, 2, 4, 64, 640, None, 256),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(S1_CASES))
def test_slot_decode_plain_matches_pallas(case, dtype):
    s, kh, g, d, t, ctx, block_t = S1_CASES[case]
    rng = np.random.default_rng(len(case) + d)
    if ctx is None:
        ctx = rng.integers(0, t + 1, size=s)
    q, k, v, ctx = slot_inputs(rng, s, kh, g, d, t, ctx)
    want = jda.decode_attention(to_jax(q, dtype), to_jax(k, dtype),
                                to_jax(v, dtype), jnp.asarray(ctx),
                                block_t=block_t, interpret=True)
    got = da.decode_attention(to_torch(q, dtype), to_torch(k, dtype),
                              to_torch(v, dtype), torch.from_numpy(ctx))
    assert got.dtype == to_torch(q, dtype).dtype
    close(got, want, dtype)
    assert torch.all(got[torch.from_numpy(ctx) == 0] == 0)


@pytest.mark.parametrize("rows_per_split", [48, None], ids=["rows48",
                                                          "plan"])
@pytest.mark.parametrize("case", sorted(S1_CASES))
def test_slot_split_twin_matches_pallas(case, rows_per_split):
    """S1's schedule: fixed splits of cache rows (48, or the kernel's plan
    of 256), each split's (acc, m, l) merged in split order, against the
    Pallas kernel in fp32; a ctx == 0 slot gives 0."""
    s, kh, g, d, t, ctx, block_t = S1_CASES[case]
    rng = np.random.default_rng(len(case) + d + 1)
    if ctx is None:
        ctx = rng.integers(0, t + 1, size=s)
    q, k, v, ctx = slot_inputs(rng, s, kh, g, d, t, ctx)
    want = jda.decode_attention(*(to_jax(x, "float32") for x in (q, k, v)),
                                jnp.asarray(ctx), block_t=block_t,
                                interpret=True)
    got = da.decode_attention_split_reference(
        *(to_torch(x, "float32") for x in (q, k, v)), torch.from_numpy(ctx),
        rows_per_split)
    close(got, want, "float32")
    assert torch.all(got[torch.from_numpy(ctx) == 0] == 0)


def test_slot_split_plan_ignores_the_number_of_slots():
    """S1's plan reads the cache's rows only, so a slot keeps its splits,
    and its result, at any batch size."""
    import inspect

    assert list(inspect.signature(da.split_plan).parameters) == ["t"]
    assert da.split_plan(2048) == (256, 8) and da.split_plan(100) == (256, 1)
    rng = np.random.default_rng(12)
    q, k, v, ctx = slot_inputs(rng, 5, 2, 4, 64, 600, [0, 1, 256, 257, 600])
    args = [torch.from_numpy(x.astype(np.float32)) for x in (q, k, v)]
    ctx = torch.from_numpy(ctx)
    outs = []
    for idx in ([3, 4, 1], [0, 4] + [2, 3] * 19):    # slot 4 second
        idx = torch.tensor(idx)
        outs.append(da.decode_attention_split_reference(
            *(x[idx] for x in args), ctx[idx])[1])
    assert torch.equal(outs[0], outs[1])


def test_slot_decode_plain_never_reads_dead_rows():
    """Rows at or past ctx may hold anything (NaN included)."""
    rng = np.random.default_rng(3)
    q, k, v, ctx = slot_inputs(rng, 3, 2, 4, 64, 64, [0, 5, 64])
    k[1, :, 5:] = np.nan
    v[1, :, 5:] = np.nan
    got = da.decode_attention(*(torch.from_numpy(x.astype(np.float32))
                                for x in (q, k, v)), torch.from_numpy(ctx))
    assert torch.isfinite(got).all()


def ring_inputs(rng, s, kh, g, d, t, c, ctx):
    return (rng.normal(size=(s, kh, g, d)), rng.normal(size=(s, kh, t, d)),
            rng.normal(size=(s, kh, t, d)), rng.normal(size=(s, kh, c, d)),
            rng.normal(size=(s, kh, c, d)), rng.normal(size=(s, kh, d)),
            rng.normal(size=(s, kh, d)), np.asarray(ctx, np.int32))


# (s, kh, g, d, t, c, ctx)
S2_CASES = {
    "g8_d64": (5, 2, 8, 64, 256, 8, [0, 1, 128, 129, 256]),
    "g1_d128": (3, 4, 1, 128, 256, 16, [200, 0, 256]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("case", sorted(S2_CASES))
def test_ring_decode_plain_matches_pallas(case, where, dtype):
    s, kh, g, d, t, c, ctx = S2_CASES[case]
    step = {"first": 0, "middle": c // 2, "last": c}[where]
    args = ring_inputs(np.random.default_rng(c + d), s, kh, g, d, t, c, ctx)
    want = jrda.ring_decode_attention(
        *(to_jax(a, dtype) for a in args[:7]), jnp.asarray(args[7]),
        jnp.int32(step), block_t=128, interpret=True)
    got = rda.ring_decode_attention(*(to_torch(a, dtype) for a in args[:7]),
                                    torch.from_numpy(args[7]), step)
    close(got, want, dtype)


def test_ring_decode_ops_switch_and_cpu_launch_count():
    """KERNELS and PLAIN give the same ring attention on the CPU, and the
    CPU wrappers launch nothing."""
    rng = np.random.default_rng(5)
    args = [torch.from_numpy(a.astype(np.float32)) for a in
            ring_inputs(rng, 2, 2, 4, 64, 32, 4, [3, 0])[:7]]
    ctx = torch.tensor([3, 0], dtype=torch.int32)
    before = (rda.ring_decode_attention.launches, da.decode_attention.launches)
    a = attention.KERNELS.ring_decode(*args, ctx, 2)
    b = attention.PLAIN.ring_decode(*args, ctx, 2)
    assert torch.equal(a, b)
    assert (rda.ring_decode_attention.launches,
            da.decode_attention.launches) == before


@pytest.mark.parametrize("t", [64, 2048])
def test_decode_dispatch_matches_jax(t, monkeypatch):
    """Below 2048 cache rows the einsum runs; at 2048 the kernel's route,
    which on CPU tensors is the plain version, in every dtype. Both equal
    the JAX dispatch (its einsum on the CPU)."""
    rng = np.random.default_rng(t)
    s, kh, g, d = 3, 2, 4, 64
    q, k, v, ctx = slot_inputs(rng, s, kh, g, d, t, [1, t // 2, t])
    mask = np.arange(t)[None, :] < ctx[:, None]
    routed = []
    kernel = da.decode_attention
    monkeypatch.setattr(da, "decode_attention",
                        lambda *a, **kw: routed.append(1) or kernel(*a, **kw))
    for dtype in ("float32", "bfloat16"):
        routed.clear()
        got = attention.decode_attention(
            *(to_torch(x, dtype) for x in (q, k, v)), torch.from_numpy(ctx),
            None, torch.from_numpy(mask), d ** -0.5)
        want = jattention.decode_attention(
            *(to_jax(x, dtype) for x in (q, k, v)), jnp.asarray(ctx), None,
            jnp.asarray(mask), d ** -0.5)
        assert len(routed) == (1 if t >= attention.SLOT_KERNEL_MIN_ROWS
                               else 0)
        close(got, want, dtype)
        plain = attention.PLAIN.slot_decode(
            *(to_torch(x, dtype) for x in (q, k, v)), torch.from_numpy(ctx),
            None, torch.from_numpy(mask), d ** -0.5)
        close(plain, want, dtype)


def _recorder(monkeypatch, module, name):
    """Replace module.name by a wrapper that records its calls."""
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    return calls


def _stub(monkeypatch, module, name, out):
    """Replace module.name by a stub that records its calls and returns
    `out` (the JAX Pallas kernels cannot run here outside interpret mode)."""
    calls = []
    monkeypatch.setattr(module, name, lambda *a, **kw: calls.append(1) or out)
    return calls


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("g", [1, 8, 16])
@pytest.mark.parametrize("d", [16, 64, 128, 192, 256])
def test_attention_routes_mirror_the_jax_rule(d, g, dtype, monkeypatch):
    """F1: each route of `KERNELS` calls its kernel's wrapper exactly when
    the JAX rule calls its kernel (the prefill and slot rules with their
    kernels made available; the paged forward passes always), at every
    head dim, group and dtype: nothing is sent to a plain version before
    the wrapper. On CPU tensors the wrapper's result is its plain version;
    where the rule takes the einsum path, the result is PLAIN's."""
    from text_generation_inference_tpu.ops.pallas import flash_prefill as jfp

    from text_generation_inference_tpu_torch.ops.cuda import flash_prefill as fp
    from text_generation_inference_tpu_torch.ops.cuda import paged_attention as pa

    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    rng = np.random.default_rng(d + g)
    monkeypatch.setattr(jattention, "_kernels_available", lambda: True)

    def tt(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(tdt)

    # prefill, bucket 128
    t = 128
    q, k, v = tt(1, t, 1, g, d), tt(1, t, 1, d), tt(1, t, 1, d)
    lengths = torch.tensor([100], dtype=torch.int32)
    mask = torch.tril(torch.ones(t, t, dtype=torch.bool))[None] & (
        torch.arange(t) < 100)[None, None, :]
    jcalls = _stub(monkeypatch, jfp, "flash_prefill", jnp.zeros(q.shape, jdt))
    jattention.prefill_attention(
        *(jnp.asarray(x.float().numpy(), jdt) for x in (q, k, v)),
        jnp.asarray(lengths.numpy()), None, jnp.asarray(mask.numpy()),
        d ** -0.5)
    calls = _recorder(monkeypatch, fp, "flash_prefill")
    got = attention.prefill_attention(q, k, v, lengths, None, mask, d ** -0.5)
    assert len(jcalls) == (d % 64 == 0)
    assert len(calls) == len(jcalls)
    want = (fp.flash_prefill_reference(q, k, v, lengths) if calls else
            attention.PLAIN.prefill(q, k, v, lengths, None, mask, d ** -0.5))
    assert torch.equal(got, want)

    # slot decode over a 2048-row cache
    t = 2048
    q, kc, vc = tt(1, 1, g, d), tt(1, 1, t, d), tt(1, 1, t, d)
    ctx = torch.tensor([1500], dtype=torch.int32)
    mask = torch.arange(t)[None, :] < 1500
    jcalls = _stub(monkeypatch, jda, "decode_attention",
                   jnp.zeros(q.shape, jdt))
    jattention.decode_attention(
        *(jnp.asarray(x.float().numpy(), jdt) for x in (q, kc, vc)),
        jnp.asarray(ctx.numpy()), None, jnp.asarray(mask.numpy()), d ** -0.5)
    calls = _recorder(monkeypatch, da, "decode_attention")
    got = attention.decode_attention(q, kc, vc, ctx, None, mask, d ** -0.5)
    assert len(jcalls) == (d % 64 == 0)
    assert len(calls) == len(jcalls)
    want = (da.decode_attention_reference(q, kc, vc, ctx) if calls else
            attention.PLAIN.slot_decode(q, kc, vc, ctx, None, mask,
                                        d ** -0.5))
    assert torch.equal(got, want)

    # the three paged routes: the JAX paged passes always take the kernel
    page = 8
    q = tt(2, 1, g, d)
    kp, vp = tt(1, 8 * page, d), tt(1, 8 * page, d)
    bt = torch.tensor([[0, 1, 2, 8], [3, 4, 8, 8]], dtype=torch.int32)
    ctx = torch.tensor([20, 9], dtype=torch.int32)
    k8, v8 = (x.float().clamp(-1, 1).mul(127).round().to(torch.int8)
              for x in (kp, vp))
    ks = vs = torch.full((1, 8 * page), 1 / 127.0)
    cases = [("paged_decode", "paged_decode_attention", (q, kp, vp), ()),
             ("paged_decode_partial", "paged_decode_attention_partial",
              (q, kp, vp), ()),
             ("paged_decode_partial_i8", "paged_decode_attention_partial_i8",
              (q, k8, v8), (ks, vs))]
    for route, wrapper, (qq, kk, vv), scales in cases:
        # the route is the wrapper itself: nothing stands in front of it
        assert getattr(attention.KERNELS, route) is getattr(pa, wrapper)
        got = getattr(attention.KERNELS, route)(qq, kk, vv, *scales, bt, ctx,
                                                page)
        want = getattr(attention.PLAIN, route)(qq, kk, vv, *scales, bt, ctx,
                                               page)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b)


def test_probe_modes_agree_on_cpu():
    """The decode probe's two formulations, inline and through S2's route
    (on CPU tensors its plain version), give the same greedy ids in fp32;
    its modes parse as ring_ctx<N>[_kernel]."""
    from text_generation_inference_tpu_torch.models.core import DecoderSpec
    from text_generation_inference_tpu_torch.tools import probe_decode

    spec = DecoderSpec(vocab_size=64, hidden_size=32, num_layers=2,
                       num_heads=4, num_kv_heads=2, head_dim=8,
                       intermediate_size=48)
    params = probe_decode.random_params(spec, torch.device("cpu"),
                                        torch.float32, seed=1)
    before = rda.ring_decode_attention.launches
    res = probe_decode.run_probe(["ring_ctx16", "ring_ctx16_kernel"], spec,
                                 params, "cpu", slots=3, max_seq=32, chunk=4,
                                 history=8, calls=2, log=lambda m: None)
    assert res["16_first_step_ids_equal"] == 1.0
    assert res["16_steps_agreeing"] == 4.0
    assert rda.ring_decode_attention.launches == before
    assert probe_decode.parse_mode("ring_ctx1024_kernel") == (1024, True)
    with pytest.raises(ValueError):
        probe_decode.parse_mode("ring_ctxfoo")
