"""The port's decode programs (`engine/programs.py`) on the CPU, against the
JAX package (tiny_llama fixture, fp32 weights).

* The sync-free write plan of `models/paged_core.py` (`_write_plan`): static
  shapes whatever the mask, the same pool as a write of the kept rows
  alone, and the JAX engine's pools after a paged step (bf16 pool) and a
  ring flush (bf16 and int8 pools) with an inactive slot, a sentinel page
  and positions past max_seq: bf16 entries within one bf16 ulp of JAX's
  and every entry JAX leaves unwritten bit for bit; int8 entries at most
  one step apart, scales within 1e-6 relative.
* `precompile_decode()` of both engines, for each write mode, chunk grid
  and context / page buckets, returns the JAX engine's count for the same
  ServingConfig, and its program keys are the keys the JAX engine
  compiles.
* Pipelined dispatch (begin N+1 before end N) equals sequential dispatch,
  token for token, on both engines; the lockstep check of a replaying and
  an eager engine runs on the CPU (where both are eager) as on the card.
* The shared kernel scratch refuses to grow while a program set pins it
  (a stand-in owner: the check does not depend on the device), and the
  launch accounting multiplies captured launches by replays.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_generation_inference_tpu.config import ServingConfig as JConfig
from text_generation_inference_tpu.engine.engine import (
    InferenceEngine as JSlotEngine)
from text_generation_inference_tpu.engine.paged_cache import (
    PagedKVCache as JPagedKVCache)
from text_generation_inference_tpu.engine.paged_engine import (
    PagedInferenceEngine as JPagedEngine)
from text_generation_inference_tpu.models import families as jfamilies
from text_generation_inference_tpu.models import paged_core as jpaged
from text_generation_inference_tpu.models.fuse import fuse_params as jfuse
from text_generation_inference_tpu_torch.config import ServingConfig
from text_generation_inference_tpu_torch.engine import programs
from text_generation_inference_tpu_torch.engine.engine import (
    InferenceEngine, RequestParams)
from text_generation_inference_tpu_torch.engine.paged_cache import PagedKVCache
from text_generation_inference_tpu_torch.engine.paged_engine import (
    PagedInferenceEngine)
from text_generation_inference_tpu_torch.models import paged_core
from text_generation_inference_tpu_torch.models.convert import params_from_jax
from text_generation_inference_tpu_torch.ops.cuda import int4_matmul as im
from text_generation_inference_tpu_torch.ops.cuda import paged_attention as pa
from text_generation_inference_tpu_torch.tools import decode_replay
from tests import fixtures

PAGE = 8
NUM_PAGES = 10
MAX_PAGES = 4
SLOTS = 3
# slot 0: pages 7, 2, 9; slot 1: pages 4, 0 (its request is inactive);
# slot 2: unmapped (the sentinel)
BT = np.asarray([[7, 2, 9, NUM_PAGES], [4, 0, NUM_PAGES, NUM_PAGES],
                 [NUM_PAGES] * MAX_PAGES], np.int32)
BF16_ULP = 2.0 ** -7     # relative, at most


@pytest.fixture(scope="module")
def models():
    """The fixture's tiny_llama in both packages, weights carried across."""
    spec, jparams = jfamilies.load_model(fixtures.tiny_llama(),
                                         dtype=jnp.float32)
    jparams = jfuse(spec, jparams)
    tparams = params_from_jax(spec, jax.tree_util.tree_map(np.asarray,
                                                           jparams),
                              device="cpu")
    return spec, jparams, tparams


# --- the write plan --------------------------------------------------------

MASKS = {
    "all kept": ([3, 9, 14, 2], [1, 1, 1, 1]),
    "none kept": ([3, 9, 14, 2], [0, 0, 0, 0]),
    "mixed": ([3, 9, 14, 2, 7], [0, 1, 0, 1, 1]),
    "out of range": ([3, 40, -1, 16, 5], [1, 1, 1, 1, 1]),
    "dropped first": ([40, 9, 3, 11], [1, 1, 0, 1]),
}


@pytest.mark.parametrize("case", sorted(MASKS))
def test_write_plan_has_static_shapes_and_drops(case):
    rows, valid = MASKS[case]
    pool_rows = 16
    rows = torch.tensor(rows)
    valid = torch.tensor(valid, dtype=torch.bool)
    src, dst, kept = paged_core._write_plan(rows, valid, pool_rows)
    assert src.shape == dst.shape == (rows.numel(),)
    assert kept.shape == ()
    assert int(dst.min()) >= 0 and int(dst.max()) < pool_rows
    rng = np.random.default_rng(0)
    pool = torch.from_numpy(rng.normal(size=(2, pool_rows, 4)).astype(
        np.float32))
    vals = torch.from_numpy(rng.normal(size=(2, rows.numel(), 4)).astype(
        np.float32))
    want = pool.clone()
    keep = valid & (rows >= 0) & (rows < pool_rows)
    want[:, rows[keep]] = vals[:, keep]
    got = pool.clone()
    paged_core._put_rows(got, 1, dst, vals[:, src], kept)
    assert torch.equal(got, want)


def _caches(spec, dtype, seed):
    rng = np.random.default_rng(seed)
    jc = JPagedKVCache.create(spec, NUM_PAGES, PAGE, SLOTS, MAX_PAGES,
                              {torch.bfloat16: jnp.bfloat16,
                               torch.int8: jnp.int8}[dtype])
    tc = PagedKVCache.create(spec, NUM_PAGES, PAGE, SLOTS, MAX_PAGES, dtype,
                             "cpu")
    if dtype == torch.bfloat16:
        k = rng.normal(size=tuple(tc.k.shape)).astype(np.float32)
        v = rng.normal(size=tuple(tc.v.shape)).astype(np.float32)
        jc = jc._replace(k=jnp.asarray(k, jnp.bfloat16),
                         v=jnp.asarray(v, jnp.bfloat16))
        tc = tc._replace(k=torch.from_numpy(k).to(dtype),
                         v=torch.from_numpy(v).to(dtype))
    jc = jc._replace(block_table=jnp.asarray(BT))
    tc = tc._replace(block_table=torch.from_numpy(BT.copy()))
    return jc, tc


def _same_pools(tc, jc, before):
    """bf16 entries within one ulp of JAX's, and bit for bit wherever JAX
    left the pool as it was; int8 entries at most one step apart and zero
    in every row JAX left unwritten (scale 0), scales within 1e-6
    relative."""
    for name in ("k", "v"):
        got = getattr(tc, name).float().numpy()
        want = np.asarray(getattr(jc, name)).astype(np.float32)
        if tc.quantized:
            written = np.asarray(getattr(jc, name + "_scale")) > 0
            assert np.abs(got - want).max() <= 1
            assert not got[~written].any() and written.any()
            np.testing.assert_allclose(
                getattr(tc, name + "_scale").numpy(),
                np.asarray(getattr(jc, name + "_scale")), rtol=1e-6, atol=0)
            continue
        old = before[name].float().numpy()
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=1e-6)
        untouched = want == old
        assert np.array_equal(got[untouched], old[untouched])
        assert untouched.any() and not untouched.all()


@pytest.mark.parametrize("what,dtype", [("step", torch.bfloat16),
                                        ("flush", torch.bfloat16),
                                        ("flush", torch.int8)],
                         ids=["step-bf16", "flush-bf16", "flush-int8"])
def test_dropped_writes_leave_the_jax_pool(models, what, dtype):
    spec, jparams, tparams = models
    jc, tc = _caches(spec, dtype, seed=3)
    before = {name: getattr(tc, name).clone() for name in ("k", "v")}
    # slot 0 live, slot 1 inactive (stale table), slot 2 on the sentinel
    active = np.asarray([True, False, True])
    if what == "step":
        ids = np.asarray([5, 17, 99], np.int32)
        pos = np.asarray([19, 11, 3], np.int32)
        _, jc = jpaged.decode_paged(spec, jparams, jnp.asarray(ids),
                                    jnp.asarray(pos), jc,
                                    jnp.asarray(pos + 1), PAGE,
                                    active=jnp.asarray(active))
        paged_core.decode_paged(spec, tparams, torch.from_numpy(ids),
                                torch.from_numpy(pos), tc,
                                torch.from_numpy(pos + 1), PAGE,
                                active=torch.from_numpy(active))
    else:
        rng = np.random.default_rng(4)
        shape = (spec.num_layers, SLOTS, spec.num_kv_heads, 4, spec.head_dim)
        kbuf = rng.normal(size=shape).astype(np.float32)
        vbuf = rng.normal(size=shape).astype(np.float32)
        # slot 0's ring runs past max_seq = 24 (positions 22..25)
        start = np.asarray([22, 9, 0], np.int32)
        jc = jpaged.paged_ring_flush(jc, jnp.asarray(kbuf), jnp.asarray(vbuf),
                                     jnp.asarray(start), jnp.asarray(active),
                                     24, PAGE)
        paged_core.paged_ring_flush(tc, torch.from_numpy(kbuf),
                                    torch.from_numpy(vbuf),
                                    torch.from_numpy(start),
                                    torch.from_numpy(active), 24, PAGE)
    _same_pools(tc, jc, before)


def test_write_plan_with_nothing_kept_changes_nothing(models):
    """Every slot inactive: the one clamped row gets its own contents."""
    spec, _, tparams = models
    _, tc = _caches(spec, torch.bfloat16, seed=5)
    before = tc.k.clone()
    ids = torch.tensor([5, 17, 99], dtype=torch.int32)
    pos = torch.tensor([19, 11, 3], dtype=torch.int32)
    paged_core.decode_paged(spec, tparams, ids, pos, tc, pos + 1, PAGE,
                            active=torch.zeros(3, dtype=torch.bool))
    assert torch.equal(tc.k, before)


# --- precompile_decode: the JAX engines' grid ------------------------------

# (engine, config): write modes, chunk grids (a streaming chunk below the
# chunk, one above it, none), context buckets and live-page buckets
GRIDS = {
    "slot-ring-chunk8-stream2": ("slot", dict(decode_chunk=8,
                                              stream_decode_chunk=2)),
    "slot-ring-buckets": ("slot", dict(decode_chunk=4,
                                       decode_ctx_buckets=[16, 32, 128])),
    "slot-ring-chunk1": ("slot", dict(decode_chunk=1)),
    "slot-post-chunk4": ("slot", dict(decode_chunk=4,
                                      decode_write_mode="post",
                                      stream_decode_chunk=0)),
    "slot-scan-chunk1": ("slot", dict(decode_write_mode="scan")),
    "paged-ring-chunk8": ("paged", dict(decode_chunk=8)),
    "paged-ring-chunk4-stream2": ("paged", dict(decode_chunk=4,
                                                stream_decode_chunk=2)),
    "paged-chunk1": ("paged", dict()),
    "paged-post-chunk4": ("paged", dict(decode_chunk=4,
                                        decode_write_mode="post")),
    "paged-scan-chunk2": ("paged", dict(decode_chunk=2,
                                        decode_write_mode="scan",
                                        stream_decode_chunk=1)),
}


def _config(cls, **kw):
    cfg = cls(**{"max_sequence_length": 64, "max_new_tokens": 32,
                 "max_batch_slots": 3, "prefill_buckets": [8, 16],
                 "kv_page_size": 8, **kw})
    cfg.validate()
    return cfg


@pytest.mark.parametrize("case", sorted(GRIDS))
def test_precompile_decode_counts_the_jax_grid(models, case):
    kind, kw = GRIDS[case]
    spec, jparams, tparams = models
    if kind == "slot":
        jeng = JSlotEngine(spec, jparams, _config(JConfig, **kw),
                           eos_token_id=2)
        eng = InferenceEngine(spec, tparams, _config(ServingConfig, **kw),
                              eos_token_id=2, device="cpu")
    else:
        jeng = JPagedEngine(spec, jparams, _config(JConfig, **kw),
                            eos_token_id=2, num_pages=32)
        eng = PagedInferenceEngine(spec, tparams, _config(ServingConfig, **kw),
                                   eos_token_id=2, num_pages=32, device="cpu")
    jax_keys = []
    # record the keys the JAX engine compiles, without compiling them
    jeng._get_decode_fn = lambda *key: jax_keys.append(key)
    n_jax = jeng.precompile_decode()
    assert eng.precompile_decode() == n_jax == len(jax_keys)
    assert list(eng.programs.programs) == jax_keys
    # on the CPU the programs are the eager step functions
    assert all(p.graph is None for p in eng.programs.programs.values())
    # a dispatch replays the program of its key
    slot = eng.acquire_slot()
    eng.prefill([slot], [[5, 9, 23, 77, 41]],
                [RequestParams(max_new_tokens=8)])
    key = (False, eng._pick_bucket(), eng.decode_chunk)
    eng.decode_steps(want_details=False)
    assert eng.programs.get(key).replays == 1
    assert sum(p.replays for p in eng.programs.programs.values()) == 1


# --- dispatch order ---------------------------------------------------------

ENGINES = {
    "slot-chunk1": ("slot", dict(decode_write_mode="post")),
    "slot-ring4": ("slot", dict(decode_chunk=4)),
    "paged-chunk1": ("paged", dict()),
    "paged-ring4": ("paged", dict(decode_chunk=4, paged_gather_ctx_max=0)),
}
# the lockstep's state check also walks the int8 scale pools, whose
# layout differs from the KV's
LOCKSTEP_ENGINES = {**ENGINES, "paged-ring4-int8": (
    "paged", dict(decode_chunk=4, kv_cache_dtype="int8",
                  paged_gather_ctx_max=0))}


def _engine(models, kind, kw, eager=False):
    spec, _, tparams = models
    cfg = _config(ServingConfig, max_sequence_length=512, max_new_tokens=256,
                  max_batch_slots=6, prefill_buckets=[16, 64, 256], **kw)
    if kind == "slot":
        return InferenceEngine(spec, tparams, cfg, eos_token_id=2,
                               device="cpu", eager_decode=eager)
    return PagedInferenceEngine(spec, tparams, cfg, eos_token_id=2,
                                num_pages=6 * 64, device="cpu",
                                eager_decode=eager)


@pytest.mark.parametrize("case", sorted(ENGINES))
def test_pipelined_dispatch_equals_sequential(models, case):
    kind, kw = ENGINES[case]
    n = decode_replay.pipelined_matches_sequential(
        _engine(models, kind, kw), _engine(models, kind, kw),
        vocab=models[0].vocab_size, dispatches=6)
    assert n > 0


@pytest.mark.parametrize("case", sorted(LOCKSTEP_ENGINES))
def test_lockstep_replayed_and_eager_engines(models, case):
    kind, kw = LOCKSTEP_ENGINES[case]
    seen = decode_replay.lockstep(_engine(models, kind, kw),
                                  _engine(models, kind, kw, eager=True),
                                  vocab=models[0].vocab_size, dispatches=14)
    assert seen["dispatches"] == 14 and seen["keys"]


def test_reset_remakes_the_programs(models):
    eng = _engine(models, "paged", dict(decode_chunk=4))
    n = eng.precompile_decode()
    old = dict(eng.programs.programs)
    eng.reset()
    assert len(eng.programs) == n
    assert all(eng.programs.programs[k] is not old[k] for k in old)


# --- scratch and launch accounting ------------------------------------------


class Owner:
    """Stands in for a set of captured programs."""


@pytest.mark.parametrize("grow", ["workspace", "arrivals"])
def test_scratch_growth_raises_while_pinned(grow):
    device = torch.device("cpu")
    fn = {"workspace": im.workspace, "arrivals": pa.arrivals}[grow]
    size = fn(device, 10).numel()
    owner = Owner()
    pa.pin_scratch(owner, device)
    try:
        assert fn(device, size).numel() == size       # no growth: fine
        with pytest.raises(RuntimeError, match="captured decode programs"):
            fn(device, size + 1)
    finally:
        pa.unpin_scratch(owner)
    assert fn(device, size + 1).numel() >= size + 1
    pa.pin_scratch(owner, device)
    del owner                                         # the pin dies with it
    assert fn(device, 2 * size + 2).numel() >= 2 * size + 2


def test_launches_count_captured_times_replays():
    def kernel():
        pass

    kernel.launches = 2                  # two eager launches
    programs.track(kernel)
    progs = programs.DecodePrograms(torch.device("cpu"), capture=False)
    progs.programs["k"] = programs.DecodeProgram(
        fn=lambda: None, launches={(kernel, "launches"): 3})
    for _ in range(4):
        progs.programs["k"].run()
    assert programs.replayed(kernel) == 12
    assert programs.launches(kernel) == 14
    progs.clear()
    assert programs.launches(kernel) == 2
