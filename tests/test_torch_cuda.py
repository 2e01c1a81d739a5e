"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips on a machine without CUDA. The
file imports neither JAX nor the JAX package, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: bf16 outputs within atol 2e-2 + rtol 2e-2 (a bf16 ulp is
7.8e-3 at 1-2; both versions round the output once, and the flash and
bf16 paged kernels also round P to bf16 for their tensor-core value
products); fp32 stats within 2e-3 relative (the same sums in another
order, with P rounded to bf16 in the bf16 paged kernel); the fused
MLP, two chained products over bf16-rounded weights, within 3e-2 of its
largest output plus 2e-2 relative, and within two ulps of x's dtype of
its largest output against its twin (`int4_mlp_split_reference`: `a` and y
are each rounded once on both sides). float32 attention (the fp32
CUDA-core decode bodies, flash prefill's 3xTF32 kernel) within 1e-4; the
flash kernel also within 1e-5 of its twin. K1 (`close_k1`): the weights enter the tensor cores
as exact integers and both versions sum in fp32, so the outputs differ by
the rounding of y to x's dtype, one ulp (2^-7 relative in bf16, 2^-10 in
fp16), plus 1e-3 for the summation order and fp32 x's hi + lo split.
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


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 4, 6, 8])
@pytest.mark.parametrize("t", [128, 2048])
def test_flash_prefill_tile_edges(cuda_device, d, g, t):
    """The smallest bucket and the largest, lengths on the 128-key tile
    edges, NaN in k and v past each length (P = 0 does not cancel NaN: the
    kernel must mask those scores and zero those value rows); G = 6 leaves
    rows of the 128-row tile unused (21 tokens a tile)."""
    rng = np.random.default_rng(10 * d + g + t)
    lengths = sorted({0, 1, 127, min(128, t), min(129, t), t})
    n, kh = len(lengths), 1
    q = bf16(rng, n, t, kh, g, d, device=cuda_device)
    k = bf16(rng, n, t, kh, d, device=cuda_device)
    v = bf16(rng, n, t, kh, d, device=cuda_device)
    for i, ln in enumerate(lengths):
        k[i, ln:] = float("nan")
        v[i, ln:] = float("nan")
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = fp.flash_prefill.launches
    got = fp.flash_prefill(q, k, v, lens)
    torch.cuda.synchronize()
    assert fp.flash_prefill.launches == before + 1
    assert torch.isfinite(got).all()
    assert torch.all(got[0] == 0)                       # length 0
    close(got, fp.flash_prefill_reference(q, k, v, lens), 2e-2)


def split_case(rng, device, d, g, s=6, kh=2, page=128, max_pages=9,
               num_pages=64):
    """Contexts across the bf16 kernel's split boundaries (256 keys a
    split), a sentinel page inside slot 4's context, and NaN in every pool
    row that no slot reads."""
    ctx = np.asarray([0, 1, 256, 257, 900, max_pages * page][:s], np.int32)
    perm = rng.permutation(num_pages)
    bt = np.full((s, max_pages), num_pages, np.int32)
    used = 0
    for i in range(s):
        need = -(-int(ctx[i]) // page)
        bt[i, :need] = perm[used:used + need]
        used += need
    bt[4, 3] = num_pages          # page 3: in split 1 at page 128, 0 at 16
    q = bf16(rng, s, kh, g, d, device=device)
    kp = bf16(rng, kh, num_pages * page, d, device=device)
    vp = bf16(rng, kh, num_pages * page, d, device=device)
    live = np.zeros(num_pages * page, bool)
    for i in range(s):
        for pos in range(int(ctx[i])):
            pid = bt[i, pos // page]
            if pid < num_pages:
                live[pid * page + pos % page] = True
    dead = torch.from_numpy(~live).to(device)
    kp[:, dead] = float("nan")
    vp[:, dead] = float("nan")
    return (q, kp, vp, torch.from_numpy(bt).to(device),
            torch.from_numpy(ctx).to(device), page)


@pytest.mark.cuda
@pytest.mark.parametrize("d,g,page", [(64, 8, 128), (128, 1, 128),
                                      (128, 4, 128), (64, 8, 16)])
def test_paged_decode_split_kernel(cuda_device, d, g, page):
    """Page 128 (2 pages a split) and page 16 (16 pages a split: a 64-key
    tile spans 4 pages)."""
    rng = np.random.default_rng(500 + d + g + page)
    wide = dict(max_pages=72, num_pages=200) if page == 16 else {}
    q, kp, vp, bt, ctx, page = split_case(rng, cuda_device, d, g, page=page,
                                          **wide)
    assert pa.split_plan(bt.shape[1], page)[1] > 1
    before = (pa.paged_decode_attention.launches,
              pa.paged_decode_attention_partial.launches)
    got = pa.paged_decode_attention(q, kp, vp, bt, ctx, page)
    acc, m, l = pa.paged_decode_attention_partial(q, kp, vp, bt, ctx, page)
    torch.cuda.synchronize()
    assert (pa.paged_decode_attention.launches,
            pa.paged_decode_attention_partial.launches) == tuple(
                b + 1 for b in before)
    assert torch.isfinite(got).all() and torch.all(got[0] == 0)
    close(got, pa.paged_decode_attention_reference(q, kp, vp, bt, ctx, page),
          2e-2)
    racc, rm, rl = pa.paged_decode_attention_partial_reference(
        q, kp, vp, bt, ctx, page)
    assert torch.all(torch.isneginf(m[0])) and torch.all(l[0] == 0)
    live = ~torch.isneginf(rm)
    assert torch.equal(live, ~torch.isneginf(m))
    close(m[live], rm[live], 2e-3)
    close(l, rl, 2e-3 * max(1.0, float(rl.max())))
    close(acc, racc, 2e-3 * max(1.0, float(racc.abs().max())))


@pytest.mark.cuda
def test_paged_decode_split_kernel_is_batch_invariant(cuda_device):
    """A slot's output is bit-identical whatever the other slots hold (3
    or 40 of them) and from one launch to the next: the split plan reads
    the table's width and the page size only, and the splits merge in
    split order."""
    rng = np.random.default_rng(9)
    q, kp, vp, bt, ctx, page = split_case(rng, cuda_device, 64, 8)
    outs = []
    for s in (3, 40):
        idx = torch.from_numpy(rng.integers(0, 6, size=s)).to(cuda_device)
        idx[1] = 5                                   # the full-table slot
        args = (q[idx].contiguous(), kp, vp, bt[idx].contiguous(),
                ctx[idx].contiguous(), page)
        for _ in range(2):
            outs.append((pa.paged_decode_attention(*args)[1],
                         pa.paged_decode_attention_partial(*args)[0][1]))
    torch.cuda.synchronize()
    for out, acc in outs[1:]:
        assert torch.equal(out, outs[0][0])
        assert torch.equal(acc, outs[0][1])


@pytest.mark.cuda
def test_redesigned_wrappers_reject_bad_inputs(cuda_device):
    rng = np.random.default_rng(11)
    buf = bf16(rng, 1 + 128 * 64, device=cuda_device)
    q = buf[1:].view(1, 128, 1, 1, 64)       # 2 bytes past a 16-byte boundary
    k = bf16(rng, 1, 128, 1, 64, device=cuda_device)
    lens = torch.tensor([128], dtype=torch.int32, device=cuda_device)
    before = fp.flash_prefill.launches
    with pytest.raises(ValueError):
        fp.flash_prefill(q, k, k, lens)
    with pytest.raises(ValueError):
        fp.flash_prefill(q.clone(), k, k, lens.long())
    assert fp.flash_prefill.launches == before
    qd, kp, vp, bt, ctx, page = split_case(rng, cuda_device, 64, 8)
    before = pa.paged_decode_attention.launches
    with pytest.raises(ValueError):                 # pool rows % page != 0
        pa.paged_decode_attention(qd, kp[:, :-1].contiguous(),
                                  vp[:, :-1].contiguous(), bt, ctx, page)
    with pytest.raises(ValueError):                 # q and pools differ
        pa.paged_decode_attention(qd.half(), kp, vp, bt, ctx, page)
    assert pa.paged_decode_attention.launches == before


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


K1_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
           torch.float32: 1e-5}


def close_k1(got, want):
    """K1 against its plain version (see the module docstring): one ulp of
    x's dtype relative plus 1e-3."""
    diff = (got.float() - want.float()).abs()
    tol = 1e-3 + K1_RTOL[want.dtype] * want.float().abs()
    assert bool((diff <= tol).all()), float(diff.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("m", [1, 16, 40, 65, 300])
@pytest.mark.parametrize("in_f,out_f", [(256, 512), (1408, 64), (512, 1536),
                                        (768, 264)])
def test_int4_matmul_kernel(cuda_device, m, in_f, out_f, dtype):
    """K1 on decode and prefill row counts (both schedules), split-K and
    not, a K with 11 groups (not a power of two), an N of one column tile
    and one of a part tile, x in bf16, fp16 and fp32; the three entry names
    reach the same kernel and return x's dtype."""
    rng = np.random.default_rng(m + in_f + out_f)
    w = int4_weight(rng, in_f, out_f, cuda_device)
    x = bf16(rng, m, in_f, device=cuda_device).to(dtype)
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
        assert got.shape == (m, out_f) and got.dtype == dtype
        close_k1(got, want)
        assert torch.equal(got, outs[0])
    close_k1(outs[0], im.int4_matmul_group_dot_reference(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int4_matmul_rows_are_batch_invariant(cuda_device, dtype):
    """Within the decode schedule every row of an M = 16 and an M = 64
    product is bit-identical to the same row computed alone (the K splits
    come from (N, K) alone); the workspace and counters serve the next
    launch."""
    rng = np.random.default_rng(77)
    w = int4_weight(rng, 2048, 1024, cuda_device)
    assert im.split_plan(1024, 2048) > 1
    for m in (16, 64):
        x = bf16(rng, m, 2048, device=cuda_device).to(dtype)
        y = im.int4_matmul_s4(x, w)
        for r in range(m):
            alone = im.int4_matmul_s4(x[r:r + 1].contiguous(), w)
            assert torch.equal(alone[0], y[r]), (m, r)


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
    # K2, like the other entries, takes the head dims of HEAD_DIMS and q in
    # bf16, fp16 or fp32; a head dim of 48 and a float64 q are refused
    k8 = kp.to(torch.int8)
    for qbad in (bf16(rng, 5, 2, 8, 64, device=cuda_device).double(),
                 bf16(rng, 5, 2, 8, 48, device=cuda_device)):
        pk = k8 if qbad.shape[-1] == 64 else torch.zeros(
            2, kp.shape[1], 48, dtype=torch.int8, device=cuda_device)
        with pytest.raises(ValueError):
            pa.paged_decode_attention_partial_i8(qbad, pk, pk, ks, ks, bt, ctx,
                                                 PAGE)
    with pytest.raises(ValueError):                 # pool rows % page != 0
        pa.paged_decode_attention_partial_i8(
            q, k8[:, :-1].contiguous(), k8[:, :-1].contiguous(),
            ks[:, :-1].contiguous(), ks[:, :-1].contiguous(), bt, ctx, PAGE)
    w = int4_weight(rng, 256, 64, cuda_device)
    with pytest.raises(ValueError):
        im.int4_matmul(bf16(rng, 4, 128, device=cuda_device), w)
    with pytest.raises(ValueError):
        im.int4_matmul(bf16(rng, 4, 256, device=cuda_device).double(), w)
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
    before = da.decode_attention.launches
    with pytest.raises(ValueError):
        da.decode_attention(q.float(), k, v, ctx)
    with pytest.raises(ValueError):
        da.decode_attention(q, k, v, ctx.long())
    with pytest.raises(ValueError):                      # head dim 96
        da.decode_attention(q[..., :48].contiguous(), k[..., :48], v[..., :48],
                            ctx)
    with pytest.raises(ValueError):                      # mixed dtypes
        da.decode_attention(q.half(), k, v, ctx)
    with pytest.raises(ValueError):                      # rows 2 bytes apart
        wide = bf16(rng, 6, 2, 256, 65, device=cuda_device)[..., :64]
        da.decode_attention(q, wide, wide, ctx)
    assert da.decode_attention.launches == before
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
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_int4_mlp_takes_every_dtype(cuda_device, dtype):
    """F3: M1 takes fp16 and fp32 x (converted to bf16 as it is staged, as
    the JAX kernel casts x to its bf16 compute dtype) and returns x's
    dtype, within close_mlp of its plain version."""
    from text_generation_inference_tpu_torch.ops.cuda import int4_mlp as mlp

    rng = np.random.default_rng(530)
    w_gu, w_down = mlp_case(rng, cuda_device)
    x = bf16(rng, 16, 256, device=cuda_device).to(dtype)
    got = mlp.int4_mlp_s4_stacked(x, w_gu, w_down, 1)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (16, 256)
    close_mlp(got, mlp.int4_mlp_reference(x, w_gu.layer(1), w_down.layer(1)))


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
        mlp.int4_mlp_s4_stacked(x.double(), w_gu, w_down, 0)


# --- K2 and S1 on the split body; the attention routes (F1) ----------------


def int8_split_case(rng, device, d, g, page, s=6, kh=2):
    """split_case's table and contexts over int8 pools: dead pool rows hold
    random int8 values and NaN scales (never read); the reference gets the
    same pools with those scales zeroed."""
    from text_generation_inference_tpu_torch.models.core import quantize_kv

    wide = dict(max_pages=72, num_pages=200) if page == 16 else {}
    q, kp, vp, bt, ctx, page = split_case(rng, device, d, g, s=s, kh=kh,
                                          page=page, **wide)
    dead = torch.isnan(kp[0, :, 0])
    kq, ks = quantize_kv(torch.nan_to_num(kp))
    vq, vs = quantize_kv(torch.nan_to_num(vp))
    ks_ref, vs_ref = ks.clone(), vs.clone()
    ks_ref[:, dead] = 0.0
    vs_ref[:, dead] = 0.0
    ks[:, dead] = float("nan")
    vs[:, dead] = float("nan")
    return q, kq, vq, ks, vs, ks_ref, vs_ref, bt, ctx, page


@pytest.mark.cuda
@pytest.mark.parametrize("page", [16, 128])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_decode_int8_split_kernel(cuda_device, d, g, page):
    """K2 on the split body: contexts on split edges (256 keys a split), a
    sentinel page inside slot 4's context (in split 1 at page 128, split 0
    at page 16), a ctx == 0 slot, NaN scales on every row no slot reads."""
    rng = np.random.default_rng(600 + d + g + page)
    q, kq, vq, ks, vs, ks_ref, vs_ref, bt, ctx, page = int8_split_case(
        rng, cuda_device, d, g, page)
    assert pa.split_plan(bt.shape[1], page)[1] > 1
    before = pa.paged_decode_attention_partial_i8.launches
    acc, m, l = pa.paged_decode_attention_partial_i8(q, kq, vq, ks, vs, bt,
                                                     ctx, page)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention_partial_i8.launches == before + 1
    racc, rm, rl = pa.paged_decode_attention_partial_reference(
        q, kq, vq, bt, ctx, page, k_scale_pool=ks_ref, v_scale_pool=vs_ref)
    assert torch.isfinite(acc).all() and torch.isfinite(l).all()
    assert torch.all(torch.isneginf(m[0])) and torch.all(l[0] == 0)
    assert torch.all(acc[0] == 0)
    live = ~torch.isneginf(rm)
    assert torch.equal(live, ~torch.isneginf(m))
    close(m[live], rm[live], 2e-3)
    close(l, rl, 2e-3 * max(1.0, float(rl.max())))
    close(acc, racc, 2e-3 * max(1.0, float(racc.abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [128, 2048])
@pytest.mark.parametrize("g", [1, 4, 8])
def test_slot_decode_split_kernel(cuda_device, g, t):
    """S1 on the split body over a narrowed view of a longer cache (strides
    over S, K and T that are not contiguous), contexts on the 64-key tile
    and 256-row split edges, a ctx == 0 slot, NaN past every context."""
    from text_generation_inference_tpu_torch.ops.cuda import decode_attention as da

    rng = np.random.default_rng(700 + g + t)
    s, kh, d = 7, 2, 128 if g == 1 else 64
    ctx = np.asarray([0, 1, 63, 64, 65, 256, 257, t][-s:], np.int32)
    ctx = np.minimum(ctx, t)
    ctx[0] = 0
    big_k = bf16(rng, 2, s, kh, t + 64, d, device=cuda_device)
    big_v = bf16(rng, 2, s, kh, t + 64, d, device=cuda_device)
    for i, c in enumerate(ctx):
        big_k[:, i, :, c:] = float("nan")
        big_v[:, i, :, c:] = float("nan")
    k = big_k[1].narrow(2, 0, t)
    v = big_v[1].narrow(2, 0, t)
    assert not k.is_contiguous()
    q = bf16(rng, s, kh, g, d, device=cuda_device)
    ctx_t = torch.from_numpy(ctx).to(cuda_device)
    before = da.decode_attention.launches
    got = da.decode_attention(q, k, v, ctx_t)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    assert torch.isfinite(got).all() and torch.all(got[0] == 0)
    close(got, da.decode_attention_reference(q, k, v, ctx_t), 2e-2)


@pytest.mark.cuda
def test_int8_and_slot_kernels_are_batch_invariant(cuda_device):
    """K2 and S1: a slot's result is bit-identical whatever the other slots
    hold (3 or 40 of them) and from one launch to the next."""
    from text_generation_inference_tpu_torch.ops.cuda import decode_attention as da

    rng = np.random.default_rng(13)
    q, kq, vq, ks, vs, _, _, bt, ctx, page = int8_split_case(
        rng, cuda_device, 128, 1, 128)
    sq, sk, sv, sctx = slot_case(rng, cuda_device, 64, 8)
    outs = []
    for n in (3, 40):
        idx = torch.from_numpy(rng.integers(0, 6, size=n)).to(cuda_device)
        idx[1] = 5                                   # the full slot
        for _ in range(2):
            acc = pa.paged_decode_attention_partial_i8(
                q[idx].contiguous(), kq, vq, ks, vs, bt[idx].contiguous(),
                ctx[idx].contiguous(), page)[0][1]
            out = da.decode_attention(sq[idx].contiguous(), sk[idx], sv[idx],
                                      sctx[idx].contiguous())[1]
            outs.append((acc, out))
    torch.cuda.synchronize()
    for acc, out in outs[1:]:
        assert torch.equal(acc, outs[0][0])
        assert torch.equal(out, outs[0][1])


# (hidden, heads, kv heads, head dim, dtype): the fixtures' tiny_llama widths
# (D = 16), a group of 16, and DTYPE_STR=float16
F1_CASES = {"d16": (64, 4, 2, 16, torch.bfloat16),
            "g16": (256, 16, 1, 64, torch.bfloat16),
            "float16": (256, 4, 2, 64, torch.float16)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(F1_CASES))
def test_f1_shapes_are_served_by_the_kernels(cuda_device, case):
    """F1: a model at the tiny_llama fixture's head dim, at a group of 16 or
    in float16 is served on the card by the kernels (the paged engine, a
    prefill bucket of 128, per-step and ring-chunk decode), and its forward
    passes agree with PLAIN's."""
    from text_generation_inference_tpu_torch.config import ServingConfig
    from text_generation_inference_tpu_torch.engine.engine import RequestParams
    from text_generation_inference_tpu_torch.engine.paged_cache import PagedKVCache
    from text_generation_inference_tpu_torch.engine.paged_engine import (
        PagedInferenceEngine)
    from text_generation_inference_tpu_torch.models import paged_core
    from text_generation_inference_tpu_torch.models.core import DecoderSpec
    from text_generation_inference_tpu_torch.ops import attention
    from text_generation_inference_tpu_torch.tools.probe_decode import random_params

    hidden, heads, kv, d, dtype = F1_CASES[case]
    spec = DecoderSpec(vocab_size=256, hidden_size=hidden, num_layers=2,
                       num_heads=heads, num_kv_heads=kv, head_dim=d,
                       intermediate_size=2 * hidden)
    params = random_params(spec, cuda_device, dtype, seed=5)
    page, t, n, max_pages = 16, 128, 2, 12
    lengths = torch.tensor([100, 37], dtype=torch.int32, device=cuda_device)
    slots = torch.tensor([0, 1], dtype=torch.int32, device=cuda_device)
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        3, 256, (n, t)).astype(np.int32)).to(cuda_device)
    before = (fp.flash_prefill.launches, pa.paged_decode_attention.launches)
    logits = {}
    for name, attn in (("kernels", attention.KERNELS),
                       ("plain", attention.PLAIN)):
        cache = PagedKVCache.create(spec, n * max_pages, page, n, max_pages,
                                    dtype, cuda_device)
        cache.block_table.copy_(torch.arange(
            n * max_pages, dtype=torch.int32,
            device=cuda_device).reshape(n, max_pages))
        lg, _ = paged_core.prefill_paged(spec, params, ids, lengths, slots,
                                         cache, page, attn=attn)
        out = [lg[torch.arange(n), lengths.long() - 1]]
        pos = lengths.clone()
        nxt = out[0].argmax(-1).to(torch.int32)
        for _ in range(3):
            lg, _ = paged_core.decode_paged(spec, params, nxt, pos, cache,
                                            pos + 1, page, attn=attn)
            out.append(lg)
            nxt, pos = lg.argmax(-1).to(torch.int32), pos + 1
        logits[name] = out
    torch.cuda.synchronize()
    # prefill: the JAX rule takes the flash route at d % 64 == 0 (one launch
    # a layer); every decode layer runs the paged kernel
    assert fp.flash_prefill.launches - before[0] == (
        spec.num_layers if d % 64 == 0 else 0)
    assert (pa.paged_decode_attention.launches - before[1]
            == 3 * spec.num_layers)
    for a, b in zip(logits["kernels"], logits["plain"]):
        assert torch.isfinite(a).all()
        close(a, b, 5e-2)

    config = ServingConfig(max_sequence_length=256, max_new_tokens=16,
                           max_batch_slots=2, prefill_buckets=[128],
                           kv_page_size=page, dtype_str={
                               torch.bfloat16: "bfloat16",
                               torch.float16: "float16"}[dtype])
    config.validate()
    for chunk in (1, 8):
        config.decode_chunk = chunk
        engine = PagedInferenceEngine(spec, params, config, eos_token_id=2,
                                      device=cuda_device)
        rp = RequestParams(max_new_tokens=12)
        first = engine.prefill([0, 1], [list(range(3, 103)),
                                        list(range(5, 42))], [rp, rp])
        steps = [engine.decode_steps(want_details=False) for _ in range(2)]
        torch.cuda.synchronize()
        assert len(first[0].next_ids) == 2 and all(steps)


def _dtype_case(rng, shape, dtype, device):
    return bf16(rng, *shape, device=device).to(dtype)


# (head dim, group, dtype): the head dims the split body is built for
# beyond 64 / 128, groups past one block of 16 query heads, and fp16
SHAPE_CASES = [(16, 4, torch.bfloat16), (80, 1, torch.bfloat16),
               (80, 16, torch.float16), (256, 8, torch.bfloat16),
               (64, 20, torch.bfloat16), (128, 16, torch.float16),
               (64, 8, torch.float16), (192, 8, torch.bfloat16),
               (192, 16, torch.float16), (64, 8, torch.float32),
               (128, 1, torch.float32), (192, 20, torch.float32),
               (16, 4, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,g,dtype", SHAPE_CASES)
def test_split_body_takes_every_shape(cuda_device, d, g, dtype):
    """The paged kernel in both modes, K2, S1 and S2 at the head dims, groups
    and dtypes past PR 5's set, against their plain versions: contexts on
    split edges, a sentinel page, a ctx == 0 slot."""
    from text_generation_inference_tpu_torch.models.core import quantize_kv
    from text_generation_inference_tpu_torch.ops.cuda import decode_attention as da
    from text_generation_inference_tpu_torch.ops.cuda import ring_decode_attention as rda

    rng = np.random.default_rng(900 + d + g)
    # fp32 runs on the fp32 CUDA-core body: fp32 accuracy
    tol, mtol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 2e-3)
    q, kp, vp, bt, ctx, page = split_case(rng, cuda_device, d, g)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    dead = torch.isnan(kp[0, :, 0])
    kz, vz = torch.nan_to_num(kp), torch.nan_to_num(vp)
    out = pa.paged_decode_attention(q, kp, vp, bt, ctx, page)
    assert out.dtype == dtype and torch.all(out[0] == 0)
    close(out, pa.paged_decode_attention_reference(q, kz, vz, bt, ctx, page),
          tol)
    acc, m, l = pa.paged_decode_attention_partial(q, kp, vp, bt, ctx, page)
    racc, rm, rl = pa.paged_decode_attention_partial_reference(
        q, kz, vz, bt, ctx, page)
    live = ~torch.isneginf(rm)
    assert torch.equal(live, ~torch.isneginf(m))
    close(m[live], rm[live], mtol)
    close(l, rl, tol * max(1.0, float(rl.max())))
    close(acc, racc, tol * max(1.0, float(racc.abs().max())))
    kq, ks = quantize_kv(kz)
    vq, vs = quantize_kv(vz)
    ks[:, dead] = vs[:, dead] = 0.0
    acc, m, l = pa.paged_decode_attention_partial_i8(q, kq, vq, ks, vs, bt,
                                                     ctx, page)
    racc, rm, rl = pa.paged_decode_attention_partial_reference(
        q, kq, vq, bt, ctx, page, k_scale_pool=ks, v_scale_pool=vs)
    assert torch.all(torch.isneginf(m[0])) and torch.all(l[0] == 0)
    close(m[live], rm[live], mtol)
    close(l, rl, tol * max(1.0, float(rl.max())))
    close(acc, racc, tol * max(1.0, float(racc.abs().max())))

    # S1 and S2 over a narrowed slot cache
    s, kh, t, c, step = 5, 2, 512, 8, 5
    sctx = torch.tensor([0, 1, 64, 257, t], dtype=torch.int32,
                        device=cuda_device)
    big = _dtype_case(rng, (2, s, kh, t + 64, d), dtype, cuda_device)
    k, v = big[0].narrow(2, 0, t), big[1].narrow(2, 0, t)
    sq = _dtype_case(rng, (s, kh, g, d), dtype, cuda_device)
    got = da.decode_attention(sq, k, v, sctx)
    assert got.dtype == dtype and torch.all(got[0] == 0)
    close(got, da.decode_attention_reference(sq, k, v, sctx), tol)
    kb, vb = (_dtype_case(rng, (s, kh, c, d), dtype, cuda_device)
              for _ in range(2))
    kn, vn = (_dtype_case(rng, (s, kh, d), dtype, cuda_device)
              for _ in range(2))
    close(rda.ring_decode_attention(sq, k, v, kb, vb, kn, vn, sctx, step),
          rda.ring_decode_attention_reference(sq, k, v, kb, vb, kn, vn, sctx,
                                              step), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d,g", [(64, 8), (128, 1), (128, 16)])
def test_flash_prefill_kernel_float16(cuda_device, d, g):
    rng = np.random.default_rng(950 + d + g)
    n, t, kh = 2, 256, 2
    q = bf16(rng, n, t, kh, g, d, device=cuda_device).half()
    k = bf16(rng, n, t, kh, d, device=cuda_device).half()
    v = bf16(rng, n, t, kh, d, device=cuda_device).half()
    lengths = torch.tensor([200, 129], dtype=torch.int32, device=cuda_device)
    got = fp.flash_prefill(q, k, v, lengths)
    assert got.dtype == torch.float16
    close(got, fp.flash_prefill_reference(q, k, v, lengths), 2e-2)


# (head dim, group, dtype): the wgmma kernel's 64-key tiles at head dims
# 192 and 256 (gemma-7b: 16 heads of 256 over 16 kv heads; gemma-2b: 8 over
# 1), and the fp32 CUDA-core kernel
FLASH_CASES = [(192, 8, torch.bfloat16), (256, 1, torch.bfloat16),
               (256, 8, torch.float16), (192, 1, torch.float16),
               (64, 8, torch.float32), (128, 1, torch.float32),
               (256, 4, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,g,dtype", FLASH_CASES)
def test_flash_prefill_large_head_dims_and_float32(cuda_device, d, g, dtype):
    """F2: flash prefill at D 192 / 256 and in fp32 against its plain
    version, lengths on and off the 64-key tile edges, a length-0 row and
    NaN past the lengths (never read into the output)."""
    rng = np.random.default_rng(970 + d + g)
    n, t, kh = 3, 300, 2
    q = bf16(rng, n, t, kh, g, d, device=cuda_device).to(dtype)
    k = bf16(rng, n, t, kh, d, device=cuda_device).to(dtype)
    v = bf16(rng, n, t, kh, d, device=cuda_device).to(dtype)
    lengths = torch.tensor([257, 0, 64], dtype=torch.int32, device=cuda_device)
    want = fp.flash_prefill_reference(q, k, v, lengths)
    k[2, 64:] = float("nan")
    v[2, 64:] = float("nan")
    before = fp.flash_prefill.launches
    got = fp.flash_prefill(q, k, v, lengths)
    torch.cuda.synchronize()
    assert fp.flash_prefill.launches == before + 1
    assert got.dtype == dtype and torch.all(got[1] == 0)
    close(got, want, 1e-4 if dtype == torch.float32 else 2e-2)


# --- the fp32 flash body on the tensor cores (3xTF32) -----------------------


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 4, 12, 16])
@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_flash_prefill_float32_3xtf32(cuda_device, d, g):
    """The fp32 kernel (mma.sync in 3xTF32) at every head dim, groups up to
    16 (12: row tiles that split a token's heads), lengths on and off its
    key-tile edges, a length-0 row and NaN past the lengths, against the
    plain version at 1e-4 and its twin at 1e-5."""
    rng = np.random.default_rng(1100 + d + g)
    n, t, kh = 4, 200, 2
    tile = fp.f32_key_tile(d)

    def f32(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            cuda_device)

    q, k, v = f32(n, t, kh, g, d), f32(n, t, kh, d), f32(n, t, kh, d)
    lengths = torch.tensor([t - 7, 0, tile, tile + 1], dtype=torch.int32,
                           device=cuda_device)
    want = fp.flash_prefill_reference(q, k, v, lengths)
    twin = fp.flash_prefill_tf32x3_reference(q, k, v, lengths)
    for i, ln in enumerate(lengths.tolist()):
        k[i, ln:] = float("nan")
        v[i, ln:] = float("nan")
    before = fp.flash_prefill.launches
    got = fp.flash_prefill(q, k, v, lengths)
    torch.cuda.synchronize()
    assert fp.flash_prefill.launches == before + 1
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert torch.all(got[1] == 0)
    close(got, want, 1e-4)
    close(got, twin, 1e-5)


# --- M1 on K1's decode schedule ----------------------------------------------


def ulps_of_max(got, want, dtype, n):
    """got within n ulps of x's dtype (fp32: 1e-5) of the largest output."""
    ulp = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
           torch.float32: 1e-5}[dtype]
    bound = n * ulp * max(1.0, float(want.float().abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= bound, (err, bound)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("activation", ["silu_glu", "gelu_glu"])
@pytest.mark.parametrize("m", [1, 16, 17, 64])
def test_int4_mlp_redesign(cuda_device, m, activation, dtype):
    """M1 at row counts on and off its 16-, 32- and 64-row tiles, both
    activations, three dtypes: within close_mlp of the plain version and
    within two ulps of the largest output of its twin (`a` and y each
    rounded once on both sides); every row bit-identical to the same row
    alone; two launches bit-identical."""
    from text_generation_inference_tpu_torch.ops.cuda import int4_mlp as mlp

    rng = np.random.default_rng(1200 + m)
    w_gu, w_down = mlp_case(rng, cuda_device)
    x = bf16(rng, m, 256, device=cuda_device).to(dtype)
    got = mlp.int4_mlp_s4_stacked(x, w_gu, w_down, 2, activation)
    again = mlp.int4_mlp_s4_stacked(x, w_gu, w_down, 2, activation)
    rows = [mlp.int4_mlp_s4_stacked(x[r:r + 1].contiguous(), w_gu, w_down, 2,
                                    activation) for r in range(m)]
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (m, 256)
    assert torch.isfinite(got).all() and torch.equal(got, again)
    close_mlp(got, mlp.int4_mlp_reference(x, w_gu.layer(2), w_down.layer(2),
                                          activation))
    ulps_of_max(got, mlp.int4_mlp_split_reference(
        x, w_gu.layer(2), w_down.layer(2), activation), dtype, 2)
    for r in range(m):
        assert torch.equal(rows[r][0], got[r]), r


@pytest.mark.cuda
def test_int4_mlp_partial_slices_and_unsplit_plans(cuda_device):
    """An intermediate size off the 128-column blocks (I = 320, groups of
    64: the last slice has one K tile), a width whose gate/up plan is one
    split (the activation straight from the accumulators: H = 64) and one
    whose down plan is one split (I = 64); 40 rows (a 64-row tile)."""
    from text_generation_inference_tpu_torch.ops.cuda import int4_mlp as mlp

    rng = np.random.default_rng(1300)
    for h, inter in ((256, 320), (64, 256), (256, 64)):
        w_gu = int4_stack(rng, 2, h, 2 * inter, cuda_device, gs=64)
        w_down = int4_stack(rng, 2, inter, h, cuda_device, gs=64)
        x = bf16(rng, 40, h, device=cuda_device)
        got = mlp.int4_mlp_s4_stacked(x, w_gu, w_down, 1)
        torch.cuda.synchronize()
        close_mlp(got, mlp.int4_mlp_reference(x, w_gu.layer(1),
                                              w_down.layer(1)))
        ulps_of_max(got, mlp.int4_mlp_split_reference(
            x, w_gu.layer(1), w_down.layer(1)), torch.bfloat16, 2)
    assert im.split_plan(2 * 256, 64) == 1 and im.split_plan(256, 64) == 1
