"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips on a machine without CUDA. The
file imports neither JAX nor the JAX package, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: bf16 outputs within atol 2e-2 + rtol 2e-2 (a bf16 ulp is
7.8e-3 at 1-2; both versions round the output once, and the flash kernel
also rounds P to bf16 for its tensor-core value product); fp32 stats
within 2e-3 relative (the same fp32 sums in another order).
"""

import math

import numpy as np
import pytest
import torch

from text_generation_inference_tpu_torch.ops.cuda import flash_prefill as fp
from text_generation_inference_tpu_torch.ops.cuda import paged_attention as pa

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
    assert math.isfinite(float(q.float().sum()))
