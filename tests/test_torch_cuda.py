"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips on a machine without CUDA. The
file imports neither JAX nor the JAX package, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: bf16 outputs within atol 2e-2 + rtol 2e-2 (a bf16 ulp is
7.8e-3 at 1-2; both versions round the output once, and the flash kernel
also rounds P to bf16 for its tensor-core value product); fp32 stats
within 2e-3 relative (the same fp32 sums in another order); the fused
MLP, two chained products over bf16-rounded weights, within 3e-2 of its
largest output plus 2e-2 relative.
"""

import math

import numpy as np
import pytest
import torch

from text_generation_inference_tpu_torch.ops.cuda import flash_prefill as fp
from text_generation_inference_tpu_torch.ops.cuda import int4_matmul as im
from text_generation_inference_tpu_torch.ops.cuda import paged_attention as pa
from text_generation_inference_tpu_torch.ops.quant import int4

PAGE = 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def bf16(rng, *shape, device):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device, torch.bfloat16)


def close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("lengths", [[200, 77, 0], [129, 1, 200]],
                         ids=["ragged", "short"])
def test_flash_prefill_kernel(cuda_device, d, lengths):
    rng = np.random.default_rng(d)
    n, t, kh, g = 3, 200, 2, 4
    q = bf16(rng, n, t, kh, g, d, device=cuda_device)
    k = bf16(rng, n, t, kh, d, device=cuda_device)
    v = bf16(rng, n, t, kh, d, device=cuda_device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = fp.flash_prefill.launches
    got = fp.flash_prefill(q, k, v, lens)
    torch.cuda.synchronize()
    assert fp.flash_prefill.launches == before + 1
    close(got, fp.flash_prefill_reference(q, k, v, lens), 2e-2)
    zero_rows = got[lens == 0]
    assert torch.all(zero_rows == 0)


def paged_case(rng, device, d, s=5, kh=2, g=8, max_pages=6, num_pages=40):
    ctx = np.asarray([0, 1, PAGE, PAGE + 1, max_pages * PAGE][:s], np.int32)
    perm = rng.permutation(num_pages)
    bt = np.full((s, max_pages), num_pages, np.int32)    # sentinel
    used = 0
    for i in range(s):
        need = -(-int(ctx[i]) // PAGE)
        bt[i, :need] = perm[used:used + need]
        used += need
    bt[3, 5] = perm[-1]          # a mapped page past ctx is never read
    q = bf16(rng, s, kh, g, d, device=device)
    kp = bf16(rng, kh, num_pages * PAGE, d, device=device)
    vp = bf16(rng, kh, num_pages * PAGE, d, device=device)
    return (q, kp, vp, torch.from_numpy(bt).to(device),
            torch.from_numpy(ctx).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_paged_decode_kernels(cuda_device, d):
    rng = np.random.default_rng(100 + d)
    args = paged_case(rng, cuda_device, d)
    got = pa.paged_decode_attention(*args, PAGE)
    close(got, pa.paged_decode_attention_reference(*args, PAGE), 2e-2)
    assert torch.all(got[0] == 0)                       # ctx == 0
    acc, m, l = pa.paged_decode_attention_partial(*args, PAGE)
    racc, rm, rl = pa.paged_decode_attention_partial_reference(*args, PAGE)
    torch.cuda.synchronize()
    assert torch.all(torch.isneginf(m[0])) and torch.all(l[0] == 0)
    live = ~torch.isneginf(rm)
    assert torch.equal(live, ~torch.isneginf(m))
    close(m[live], rm[live], 2e-3)
    close(l, rl, 2e-3 * max(1.0, float(rl.max())))
    close(acc, racc, 2e-3 * max(1.0, float(racc.abs().max())))


@pytest.mark.cuda
def test_stacked_pool_view_is_the_same_kernel(cuda_device):
    rng = np.random.default_rng(7)
    q, kp, vp, bt, ctx = paged_case(rng, cuda_device, 64)
    kps = torch.stack([bf16(rng, *kp.shape, device=cuda_device), kp])
    vps = torch.stack([bf16(rng, *vp.shape, device=cuda_device), vp])
    a = pa.paged_decode_attention_partial_stacked(q, kps, vps, bt, ctx, 1, PAGE)
    b = pa.paged_decode_attention_partial(q, kp, vp, bt, ctx, PAGE)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def int4_weight(rng, in_f, out_f, device, gs=128, act_order=False):
    """A random GPTQ weight, scaled so that x @ W is O(1) for x ~ N(0, 1)."""
    qweight = int4.pack_rows(torch.from_numpy(
        rng.integers(0, 16, (in_f, out_f)).astype(np.int32)))
    qzeros = int4.pack_cols(torch.from_numpy(
        rng.integers(0, 16, (in_f // gs, out_f)).astype(np.int32)))
    scales = torch.from_numpy(rng.uniform(0.5, 1.5, (in_f // gs, out_f)).astype(
        np.float32) / (4.6 * math.sqrt(in_f)))
    g_idx = (np.arange(in_f) // gs).astype(np.int32)
    if act_order:
        g_idx = rng.permutation(g_idx).astype(np.int32)
    w = int4.normalize_act_order(qweight, qzeros, scales,
                                 torch.from_numpy(g_idx))
    return int4.Int4Weight(*(None if f is None else f.to(device) for f in w))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 16, 40, 300])
@pytest.mark.parametrize("in_f,out_f", [(256, 512), (1408, 64), (512, 1536)])
def test_int4_matmul_kernel(cuda_device, m, in_f, out_f):
    """K1 on decode and prefill row counts, split-K and not, a K with 11
    groups (not a power of two) and an N of one column tile; the three
    entry names reach the same kernel."""
    rng = np.random.default_rng(m + in_f + out_f)
    w = int4_weight(rng, in_f, out_f, cuda_device)
    x = bf16(rng, m, in_f, device=cuda_device)
    want = im.int4_matmul_reference(x, w)
    stack = int4.Int4Weight(*(None if f is None else torch.stack([f, f])
                              for f in w))
    before = (im.int4_matmul.launches, im.int4_matmul_s4.launches,
              im.int4_matmul_s4_stacked.launches)
    outs = [im.int4_matmul(x, w), im.int4_matmul_s4(x, w),
            im.int4_matmul_s4_stacked(x, stack, 1)]
    torch.cuda.synchronize()
    assert (im.int4_matmul.launches, im.int4_matmul_s4.launches,
            im.int4_matmul_s4_stacked.launches) == tuple(b + 1 for b in before)
    for got in outs:
        assert got.shape == (m, out_f) and got.dtype == torch.bfloat16
        close(got, want, 2e-2)
        assert torch.equal(got, outs[0])


@pytest.mark.cuda
def test_int4_act_order_through_linear(cuda_device):
    from text_generation_inference_tpu_torch.models.core import layer_params
    from text_generation_inference_tpu_torch.ops import linear

    rng = np.random.default_rng(5)
    w = int4_weight(rng, 512, 256, cuda_device, act_order=True)
    assert w.perm is not None
    x = bf16(rng, 3, 7, 512, device=cuda_device)
    want = linear.matmul(x, w)     # the unstacked route
    stack = int4.Int4Weight(*(None if f is None else torch.stack([f, f])
                              for f in w))
    ref = int4.matmul_dequant(x.float()[..., w.perm.long()], w)
    close(want, ref, 2e-2)
    layers = {"w": stack}
    for lp in (layer_params(layers, 0),
               layer_params(linear.prepare_params({"layers": layers}, rows=21)
                            ["layers"], 0),
               layer_params(layers, 0, int4_plain=True)):
        close(linear.matmul(x, lp["w"]), ref, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_paged_decode_int8_kernel(cuda_device, d):
    from text_generation_inference_tpu_torch.models.core import quantize_kv

    rng = np.random.default_rng(200 + d)
    q, kp, vp, bt, ctx = paged_case(rng, cuda_device, d, g=1 if d == 128 else 8)
    kq, ks = quantize_kv(kp)
    vq, vs = quantize_kv(vp)
    before = pa.paged_decode_attention_partial_i8.launches
    acc, m, l = pa.paged_decode_attention_partial_i8(q, kq, vq, ks, vs, bt,
                                                     ctx, PAGE)
    racc, rm, rl = pa.paged_decode_attention_partial_reference(
        q, kq, vq, bt, ctx, PAGE, k_scale_pool=ks, v_scale_pool=vs)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention_partial_i8.launches == before + 1
    assert torch.all(torch.isneginf(m[0])) and torch.all(l[0] == 0)
    live = ~torch.isneginf(rm)
    assert torch.equal(live, ~torch.isneginf(m))
    close(m[live], rm[live], 2e-3)
    close(l, rl, 2e-3 * max(1.0, float(rl.max())))
    close(acc, racc, 2e-3 * max(1.0, float(racc.abs().max())))
    stacked = pa.paged_decode_attention_partial_stacked(
        q, kq[None], vq[None], bt, ctx, 0, PAGE, k_scale_pools=ks[None],
        v_scale_pools=vs[None])
    for a, b in zip(stacked, (acc, m, l)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda_device):
    rng = np.random.default_rng(8)
    q, kp, vp, bt, ctx = paged_case(rng, cuda_device, 64)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q.float(), kp, vp, bt, ctx, PAGE)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q, kp, vp, bt.long(), ctx, PAGE)
    qq = bf16(rng, 1, 128, 1, 1, 96, device=cuda_device)
    kk = bf16(rng, 1, 128, 1, 96, device=cuda_device)
    with pytest.raises(ValueError):
        fp.flash_prefill(qq, kk, kk, torch.tensor([128], dtype=torch.int32,
                                                  device=cuda_device))
    # the int8 entry wants int8 pools and float32 [K, R] scale pools
    ks = torch.ones(kp.shape[:2], device=cuda_device)
    with pytest.raises(ValueError):
        pa.paged_decode_attention_partial_i8(q, kp, vp, ks, ks, bt, ctx, PAGE)
    k8 = kp.to(torch.int8)
    with pytest.raises(ValueError):
        pa.paged_decode_attention_partial_i8(q, k8, k8, ks.half(), ks, bt, ctx,
                                             PAGE)
    w = int4_weight(rng, 256, 64, cuda_device)
    with pytest.raises(ValueError):
        im.int4_matmul(bf16(rng, 4, 128, device=cuda_device), w)
    with pytest.raises(ValueError):
        im.int4_matmul(bf16(rng, 4, 256, device=cuda_device).float(), w)
    assert math.isfinite(float(q.float().sum()))


def slot_case(rng, device, d, g, s=6, kh=2, t=2048, block=32):
    """A slot cache with a ctx == 0 slot, contexts on tile and split edges,
    and a full one; the cache rows past ctx hold NaN, which must never be
    read."""
    ctx = np.asarray([0, 1, block, block + 1, 256, t][:s], np.int32)
    q = bf16(rng, s, kh, g, d, device=device)
    k = bf16(rng, s, kh, t, d, device=device)
    v = bf16(rng, s, kh, t, d, device=device)
    for i, c in enumerate(ctx):
        k[i, :, c:] = float("nan")
        v[i, :, c:] = float("nan")
    return q, k, v, torch.from_numpy(ctx).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("d,g", [(64, 8), (128, 1), (128, 4)])
def test_slot_decode_kernel(cuda_device, d, g):
    from text_generation_inference_tpu_torch.ops.cuda import decode_attention as da

    rng = np.random.default_rng(300 + d + g)
    q, k, v, ctx = slot_case(rng, cuda_device, d, g)
    before = da.decode_attention.launches
    got = da.decode_attention(q, k, v, ctx)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    want = da.decode_attention_reference(q, k, v, ctx)
    assert torch.all(got[0] == 0)                       # ctx == 0
    assert torch.isfinite(got).all()
    close(got, want, 2e-2)
    # a view of the first rows of a longer cache (a layer of [L, S, K, T, D]
    # narrowed along T) is read through its strides, with no copy
    big_k = torch.stack([k, k]).narrow(3, 0, 1024)[1]
    big_v = torch.stack([v, v]).narrow(3, 0, 1024)[1]
    ctx_n = torch.clamp(ctx, max=1024)
    close(da.decode_attention(q, big_k, big_v, ctx_n),
          da.decode_attention_reference(q, big_k, big_v, ctx_n), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("step", [0, 5, 16])
def test_ring_decode_kernel(cuda_device, step):
    from text_generation_inference_tpu_torch.ops.cuda import ring_decode_attention as rda

    rng = np.random.default_rng(400 + step)
    q, k, v, ctx = slot_case(rng, cuda_device, 64, 8, t=512)
    c = 16
    kb = bf16(rng, 6, 2, c, 64, device=cuda_device)
    vb = bf16(rng, 6, 2, c, 64, device=cuda_device)
    kb[:, :, step:] = float("nan")          # dead ring columns are not read
    vb[:, :, step:] = float("nan")
    kn = bf16(rng, 6, 2, 64, device=cuda_device)
    vn = bf16(rng, 6, 2, 64, device=cuda_device)
    before = rda.ring_decode_attention.launches
    got = rda.ring_decode_attention(q, k, v, kb, vb, kn, vn, ctx, step)
    torch.cuda.synchronize()
    assert rda.ring_decode_attention.launches == before + 1
    want = rda.ring_decode_attention_reference(q, k, v, kb, vb, kn, vn, ctx,
                                               step)
    assert torch.isfinite(got).all()
    close(got, want, 2e-2)


@pytest.mark.cuda
def test_slot_wrappers_reject_bad_inputs(cuda_device):
    from text_generation_inference_tpu_torch.ops.cuda import decode_attention as da
    from text_generation_inference_tpu_torch.ops.cuda import ring_decode_attention as rda

    rng = np.random.default_rng(9)
    q, k, v, ctx = slot_case(rng, cuda_device, 64, 8, t=256)
    with pytest.raises(ValueError):
        da.decode_attention(q.float(), k, v, ctx)
    with pytest.raises(ValueError):
        da.decode_attention(q, k, v, ctx.long())
    with pytest.raises(ValueError):                      # head dim 96
        da.decode_attention(q[..., :48].contiguous(), k[..., :48], v[..., :48],
                            ctx)
    with pytest.raises(ValueError):                      # G > 8
        da.decode_attention(torch.cat([q, q], 2), k, v, ctx)
    kb = bf16(rng, 6, 2, 4, 64, device=cuda_device)
    kn = bf16(rng, 6, 2, 64, device=cuda_device)
    with pytest.raises(ValueError):                      # step past the ring
        rda.ring_decode_attention(q, k, v, kb, kb, kn, kn, ctx, 5)
    with pytest.raises(ValueError):
        rda.ring_decode_attention(q, k, v, kb.float(), kb, kn, kn, ctx, 2)


@pytest.mark.cuda
def test_slot_decode_dispatch(cuda_device):
    """ops.attention.decode_attention takes S1 at T >= 2048 and the einsum
    below it."""
    from text_generation_inference_tpu_torch.ops import attention
    from text_generation_inference_tpu_torch.ops.cuda import decode_attention as da

    rng = np.random.default_rng(11)
    for t, launched in ((1024, 0), (2048, 1)):
        q, k, v, ctx = slot_case(rng, cuda_device, 64, 8, t=t)
        k, v = torch.nan_to_num(k), torch.nan_to_num(v)
        ctx = torch.clamp(ctx, min=1)
        mask = torch.arange(t, device=cuda_device)[None, :] < ctx[:, None]
        before = da.decode_attention.launches
        got = attention.decode_attention(q, k, v, ctx, None, mask, 0.125)
        torch.cuda.synchronize()
        assert da.decode_attention.launches == before + launched
        close(got, da.decode_attention_reference(q, k, v, ctx), 2e-2)


def int4_stack(rng, layers, in_f, out_f, device, gs=128):
    """A layer-stacked GPTQ weight [L, in, out] of independent layers."""
    per = [int4_weight(rng, in_f, out_f, device, gs=gs) for _ in range(layers)]
    return int4.Int4Weight(*(None if per[0][f] is None
                             else torch.stack([p[f] for p in per])
                             for f in range(len(int4.Int4Weight._fields))))


def mlp_case(rng, device, gs_gu=128, gs_down=128, layers=3, h=256, inter=384):
    """A fused w_gu [L, H, 2I] (gate columns, then up) and w_down [L, I, H]."""
    return (int4_stack(rng, layers, h, 2 * inter, device, gs=gs_gu),
            int4_stack(rng, layers, inter, h, device, gs=gs_down))


def close_mlp(got, want):
    """M1 rounds every dequantized weight and the GLU output `a` to bf16
    for the tensor cores (the plain version keeps the weights in f32), so
    its error grows with the terms summed, not with each output: within
    3e-2 of the largest output plus 2e-2 relative."""
    scale = max(1.0, float(want.float().abs().max()))
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=2e-2,
                               atol=3e-2 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 5, 16, 64])
@pytest.mark.parametrize("activation", ["silu_glu", "gelu_glu"])
@pytest.mark.parametrize("gs_down", [128, 64], ids=["gs128", "gs_down64"])
def test_int4_mlp_kernel(cuda_device, s, activation, gs_down):
    """M1 on the first and the last layer of a 3-layer stack against its
    plain version; two launches are bit-identical."""
    from text_generation_inference_tpu_torch.ops.cuda import int4_mlp as mlp

    rng = np.random.default_rng(500 + s + gs_down)
    w_gu, w_down = mlp_case(rng, cuda_device, gs_down=gs_down)
    x = bf16(rng, s, 256, device=cuda_device)
    for layer in (0, 2):
        before = mlp.int4_mlp_s4_stacked.launches
        got = mlp.int4_mlp_s4_stacked(x, w_gu, w_down, layer, activation)
        again = mlp.int4_mlp_s4_stacked(x, w_gu, w_down, layer, activation)
        torch.cuda.synchronize()
        assert mlp.int4_mlp_s4_stacked.launches == before + 2
        want = mlp.int4_mlp_reference(x, w_gu.layer(layer),
                                      w_down.layer(layer), activation)
        assert got.shape == (s, 256) and got.dtype == torch.bfloat16
        assert torch.isfinite(got).all()
        close_mlp(got, want)
        assert torch.equal(got, again)


@pytest.mark.cuda
def test_int4_mlp_rows_are_independent(cuda_device):
    """A row's output does not change when the other rows of the batch, or
    their number, change (fixed summation order, no atomics)."""
    from text_generation_inference_tpu_torch.ops.cuda import int4_mlp as mlp

    rng = np.random.default_rng(510)
    w_gu, w_down = mlp_case(rng, cuda_device)
    x = bf16(rng, 40, 256, device=cuda_device)
    y = mlp.int4_mlp_s4_stacked(x, w_gu, w_down, 1)
    x2 = x.clone()
    x2[3:] = bf16(rng, 37, 256, device=cuda_device)
    y2 = mlp.int4_mlp_s4_stacked(x2, w_gu, w_down, 1)
    y3 = mlp.int4_mlp_s4_stacked(x[:3].contiguous(), w_gu, w_down, 1)
    torch.cuda.synchronize()
    assert torch.equal(y[:3], y2[:3])
    assert torch.equal(y[:3], y3)


@pytest.mark.cuda
def test_int4_mlp_rejects_bad_inputs(cuda_device):
    from text_generation_inference_tpu_torch.ops.cuda import int4_mlp as mlp

    rng = np.random.default_rng(520)
    w_gu, w_down = mlp_case(rng, cuda_device)
    x = bf16(rng, 4, 256, device=cuda_device)
    with pytest.raises(ValueError, match="rows"):
        mlp.int4_mlp_s4_stacked(bf16(rng, 65, 256, device=cuda_device), w_gu,
                                w_down, 0)
    perm = torch.arange(384, dtype=torch.int32, device=cuda_device).repeat(3, 1)
    with pytest.raises(ValueError, match="perm"):
        mlp.int4_mlp_s4_stacked(x, w_gu, w_down._replace(perm=perm), 0)
    with pytest.raises(ValueError, match="aligned"):
        buf = torch.zeros(4 * 256 + 1, dtype=torch.bfloat16, device=cuda_device)
        mlp.int4_mlp_s4_stacked(buf[1:].view(4, 256), w_gu, w_down, 0)
    with pytest.raises(ValueError, match="layer"):
        mlp.int4_mlp_s4_stacked(x, w_gu, w_down, 3)
    with pytest.raises(ValueError, match="fuse"):
        mlp.int4_mlp_s4_stacked(x, w_gu, w_down, 0, "gelu_tanh_glu")
    with pytest.raises(ValueError):
        mlp.int4_mlp_s4_stacked(x.float(), w_gu, w_down, 0)
