"""Checks of the engines' decode programs (`engine/programs.py`), shared by
the card tests (`tests/test_torch_cuda.py`), the CPU tests and
`chip_smoke.py`'s graphs phase:

  * `lockstep(replayed, eager)`: two engines built alike, one dispatching
    its decode programs (CUDA graphs on the card) and one built with
    `eager_decode=True`, go through the same staggered schedule: requests
    prefilled at different dispatches, greedy and seeded ones, details on
    and off, a slot freed while its chunk is in flight and its slot reused.
    Every dispatch's outputs for the slots live at its start, and at the
    end the engine state and the KV rows of every slot that held a request
    (the whole pools of a paged engine), must be equal bit for bit. The
    keys are dispatched in another order than they were captured.
  * `every_program(replayed, eager)`: after `lockstep`, every program of
    the grid (the keys the schedule never reached too) dispatched once on
    both engines from their equal state: the same outputs for the live
    slots, bit for bit.
  * `pipelined_matches_sequential(a, b)`: the same requests on two engines
    built alike, one dispatching chunk N+1 before it fetches chunk N
    (`decode_steps_begin` twice, then `decode_steps_end`), as the batcher
    does, and one dispatching and fetching in turn: the same outputs.
  * `prefill_lockstep(replayed, eager)`: the prefill programs' check: the
    same prefill dispatches on both engines (several row counts and
    buckets, a dispatch asking for prompt details, one soft-prompt key run
    twice with the soft prompt on another row; the first dispatch's rows
    stay live while the later keys are captured at their first use). Each
    dispatch's first tokens and prompt details, and the state and KV rows
    (pages) it wrote (and a speculative engine's chain state), must be
    equal bit for bit, and exactly one prefill program must have run on
    the replaying engine; then one decode dispatch on both engines over
    the live rows.
  * `spec_lockstep(replayed, eager)`: the speculative engines' counterpart
    of `lockstep` (they dispatch and fetch in one `decode_steps`, so a slot
    is freed between dispatches): greedy, repetition-penalty and seeded
    rows arriving and leaving; every dispatch's outputs for the live slots
    and its n_emit (or None, a gated plain step), then the state, the KV
    and the speculator's chain state, equal bit for bit. `every_program`
    then runs every verify program (and the paged engine's decode grid).

Both return what they saw (dispatches, keys, the order of first use), for
the caller to print.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.engine import RequestParams
from ..utils.prompt_cache import PrefixEntry

# prompt lengths of the requests, in the order they arrive
PROMPT_LENS = (40, 95, 17, 130, 61, 8)


def _prompt(rng, vocab: int, n: int) -> list[int]:
    return [int(x) for x in rng.integers(3, vocab, size=n)]


def _params(i: int, max_new: int) -> RequestParams:
    """Even requests greedy, odd ones seeded samples (top-k, top-p)."""
    if i % 2 == 0:
        return RequestParams(max_new_tokens=max_new)
    return RequestParams(max_new_tokens=max_new, temperature=0.8, top_k=40,
                         top_p=0.95, seed=1000 + i)


def _spec_params(i: int, max_new: int) -> RequestParams:
    """Greedy, greedy under a repetition penalty, a seeded sample, in turn."""
    if i % 3 == 1:
        return RequestParams(max_new_tokens=max_new, repetition_penalty=1.3)
    return _params(0 if i % 3 == 0 else 1, max_new)


def _same_rows(a, b, rows, what: str) -> None:
    """Every field of two StepResults equal (NaN equal to NaN) on `rows`."""
    for name, x, y in zip(a._fields, a, b):
        if not np.array_equal(np.asarray(x)[rows], np.asarray(y)[rows],
                              equal_nan=True):
            raise AssertionError(f"{what}: {name} differs on rows {rows}")


def _used_rows_equal(a, b, used: list[int], written: bool = False) -> None:
    """The engine state, and the KV a request may read, equal bit for bit:
    the whole pools of a paged engine (its eager warm-up runs drop every
    write), the rows below each used slot's history of a slot engine (its
    warm-up writes only rows no request has reached yet; a seq2seq
    engine's `cache` is its decode state, [L, S, H, T, D] slabs and the
    per-slot encoder lengths). With `written`, right after a prefill, the
    rows it wrote: those below the history less its last (sampled) token,
    whose KV row the next decode step writes."""
    idx = torch.as_tensor(used, dtype=torch.long, device=a.state.history.device)
    for x, y in zip(a.state.tensors(), b.state.tensors()):
        if not torch.equal(x[idx], y[idx]):
            raise AssertionError("engine state differs")
    pools = [t for t in a.cache if isinstance(t, torch.Tensor)]
    others = [t for t in b.cache if isinstance(t, torch.Tensor)]
    paged = hasattr(a.cache, "block_table")
    hist = a.state.history_len.cpu().numpy() - (1 if written else 0)
    for x, y in zip(pools, others):
        if paged:
            if not torch.equal(x, y):
                raise AssertionError("the paged pools differ")
            continue
        if x.dim() == 1:         # per-slot values (a seq2seq encoder length)
            if not torch.equal(x[idx], y[idx]):
                raise AssertionError("the per-slot cache values differ")
            continue
        for s in used:           # slot cache [L, S, K, T(, D)]
            if not torch.equal(x[:, s, :, :hist[s]], y[:, s, :, :hist[s]]):
                raise AssertionError(f"slot {s}'s KV rows differ")


def lockstep(replayed, eager, vocab: int, dispatches: int = 16,
             seed: int = 0, max_new: int = 200) -> dict:
    """Drive both engines through one staggered schedule (see the module
    docstring) and hold them equal. Returns {dispatches, keys (first-use
    order), capture order}."""
    rng = np.random.default_rng(seed)
    engines = (replayed, eager)
    # before dispatch i: (prompts to prefill); while dispatch i is in
    # flight: the index into the live slots of the one to free
    arrive = {0: [0, 1], 2: [2], 5: [3], 9: [4], 11: [5]}
    free_mid = {4: 0, 8: 1, 12: 0}
    live: list[int] = []
    used: set[int] = set()
    first_use: list[tuple] = []
    n_req = 0
    for i in range(dispatches):
        for j in arrive.get(i, []):
            ids = _prompt(rng, vocab, PROMPT_LENS[j])
            slots = [e.acquire_slot() for e in engines]
            if slots[0] is None or slots[0] != slots[1]:
                raise AssertionError(f"slots differ: {slots}")
            rp = _params(n_req, max_new)
            n_req += 1
            firsts = [e.prefill([slots[0]], [ids], [rp]).first_token
                      for e in engines]
            _same_rows(*firsts, [0], f"prefill of request {n_req}")
            live.append(slots[0])
            used.add(slots[0])
        want = i % 3 != 1
        rows = sorted(live)
        before = {k: p.replays for k, p in replayed.programs.programs.items()}
        handles = [e.decode_steps_begin(want_details=want) for e in engines]
        ran = [k for k, p in replayed.programs.programs.items()
               if p.replays != before.get(k, 0)]
        if len(ran) != 1:
            raise AssertionError(f"dispatch {i} ran programs {ran}")
        if ran[0] not in first_use:
            first_use.append(ran[0])
        if i in free_mid and live:
            slot = live.pop(free_mid[i])
            for e in engines:
                e.free(slot)
        outs = [e.decode_steps_end(h) for e, h in zip(engines, handles)]
        for step, (a, b) in enumerate(zip(*outs)):
            _same_rows(a, b, rows, f"dispatch {i} step {step}")
    _used_rows_equal(replayed, eager, sorted(used))
    capture_order = list(replayed.programs.programs)
    order = [capture_order.index(k) for k in first_use if k in capture_order]
    return dict(dispatches=dispatches, keys=first_use,
                capture_order=capture_order,
                out_of_capture_order=order != sorted(order))


def every_program(replayed, eager) -> int:
    """Dispatch every program of `replayed` once on both engines, in
    capture order, and hold their outputs equal on the slots live in both
    (call after `lockstep`, which leaves them in equal state). The host
    mirrors are not advanced: clear both engines' slots afterwards.
    Returns the programs compared."""
    rows = sorted(np.flatnonzero(replayed.state.active.cpu().numpy()))
    if not np.array_equal(rows, np.flatnonzero(
            eager.state.active.cpu().numpy())):
        raise AssertionError("the engines' live slots differ")
    for key, program in replayed.programs.programs.items():
        got = _slot_rows(program.run(), rows)
        want = _slot_rows(eager.programs.get(key).run(), rows)
        if not all(np.array_equal(a, b, equal_nan=True)
                   for a, b in zip(got, want)):
            raise AssertionError(f"program {key} differs from its eager step")
    return len(replayed.programs)


def _slot_rows(output, rows) -> list[np.ndarray]:
    """A program's output (a tensor, or a verify program's packed outputs
    and n_emit) on the slots `rows`: the slot axis is the second to last
    of packed outputs, the last of n_emit."""
    outs = output if isinstance(output, tuple) else (output,)
    return [o.cpu().numpy()[..., rows, :] if o.dim() >= 2
            else o.cpu().numpy()[rows] for o in outs]


def spec_lockstep(replayed, eager, vocab: int, dispatches: int = 14,
                  seed: int = 2, max_new: int = 200) -> dict:
    """Drive two speculative engines built alike (see the module
    docstring) through one staggered schedule and hold them equal. Returns
    {dispatches, keys (first-use order), spec_steps, fallback_steps}."""
    rng = np.random.default_rng(seed)
    engines = (replayed, eager)
    arrive = {0: [0, 1], 2: [2], 4: [3], 7: [4], 9: [5]}
    free_before = {6: 0, 11: 1}
    live: list[int] = []
    used: set[int] = set()
    first_use: list[tuple] = []
    fallback = 0
    for i in range(dispatches):
        if i in free_before and live:
            slot = live.pop(free_before[i])
            for e in engines:
                e.free(slot)
        for j in arrive.get(i, []):
            ids = _prompt(rng, vocab, PROMPT_LENS[j])
            slots = [e.acquire_slot() for e in engines]
            if slots[0] is None or slots[0] != slots[1]:
                raise AssertionError(f"slots differ: {slots}")
            rp = _spec_params(j, max_new)
            firsts = [e.prefill([slots[0]], [ids], [rp]).first_token
                      for e in engines]
            _same_rows(*firsts, [0], f"prefill of request {j}")
            live.append(slots[0])
            used.add(slots[0])
        rows = sorted(live)
        before = {k: p.replays for k, p in replayed.programs.programs.items()}
        outs = [e.decode_steps() for e in engines]
        ran = [k for k, p in replayed.programs.programs.items()
               if p.replays != before.get(k, 0)]
        if len(ran) != 1:
            raise AssertionError(f"dispatch {i} ran programs {ran}")
        if ran[0] not in first_use:
            first_use.append(ran[0])
        emits = [e.last_n_emitted for e in engines]
        if emits[0] is None or emits[1] is None:
            if emits[0] is not emits[1]:
                raise AssertionError(f"dispatch {i}: one engine speculated")
            fallback += 1
        elif not np.array_equal(emits[0][rows], emits[1][rows]):
            raise AssertionError(f"dispatch {i}: n_emit differs")
        for step, (a, b) in enumerate(zip(*outs)):
            _same_rows(a, b, rows, f"dispatch {i} position {step}")
    _used_rows_equal(replayed, eager, sorted(used))
    if not torch.equal(replayed.spec_hidden, eager.spec_hidden):
        raise AssertionError("the speculator's chain state differs")
    return dict(dispatches=dispatches, keys=first_use,
                spec_steps=dispatches - fallback, fallback_steps=fallback)


# (rows, longest prompt, prompt details, rows behind a soft prompt) of each
# dispatch of `prefill_lockstep`: row r's prompt is 13 r tokens shorter
PREFILL_DISPATCHES = ((1, 40, False, ()), (2, 100, False, ()),
                      (3, 230, False, ()), (1, 60, True, ()),
                      (2, 50, False, (0,)), (2, 50, False, (1,)),
                      (1, 40, False, ()))
SOFT_PROMPT = 8            # vectors of a soft prompt


def _same_details(a, b, what: str) -> None:
    """Two prefills' prompt details (None, or a dict of arrays a row) equal,
    NaN equal to NaN."""
    if (a is None) != (b is None):
        raise AssertionError(f"{what}: prompt details on one engine only")
    for r, (x, y) in enumerate(zip(a or (), b or ())):
        for name in x:
            if not np.array_equal(x[name], y[name], equal_nan=True):
                raise AssertionError(f"{what}: row {r}'s {name} differs")


def prefill_lockstep(replayed, eager, vocab: int,
                     dispatches=PREFILL_DISPATCHES, seed: int = 3,
                     max_new: int = 64) -> dict:
    """Drive both engines through the same prefill dispatches (see the
    module docstring) and hold them equal. Returns {dispatches, keys (of
    each dispatch, in order), captured (the keys made during the run)}."""
    rng = np.random.default_rng(seed)
    engines = (replayed, eager)
    hidden = getattr(replayed.spec, "d_model", None) or \
        replayed.spec.hidden_size
    seq2seq = hasattr(replayed.spec, "d_model")
    before_keys = set(replayed.programs.prefill)
    keys, live, used = [], [], set()
    for i, (n, longest, details, prefixed) in enumerate(dispatches):
        prompts = [_prompt(rng, vocab, max(1, longest - 13 * r))
                   for r in range(n)]
        rps = [_params(r, max_new) for r in range(n)]
        prefixes = None
        if prefixed:
            prefixes = [None] * n
            for r in prefixed:
                vec = rng.normal(size=(SOFT_PROMPT, hidden)).astype(
                    np.float32)
                prefixes[r] = PrefixEntry(decoder=vec,
                                          encoder=vec if seq2seq else None)
        slots = [[e.acquire_slot() for _ in range(n)] for e in engines]
        if None in slots[0] or slots[0] != slots[1]:
            raise AssertionError(f"slots differ: {slots}")
        replays = {k: p.replays for k, p in replayed.programs.prefill.items()}
        outs = [e.prefill(slots[0], prompts, rps, want_prompt_details=details,
                          prefix_embeds=prefixes) for e in engines]
        ran = [k for k, p in replayed.programs.prefill.items()
               if p.replays != replays.get(k, 0)]
        if len(ran) != 1:
            raise AssertionError(f"prefill {i} ran programs {ran}")
        keys.append(ran[0])
        what = f"prefill {i} {ran[0]}"
        _same_rows(outs[0].first_token, outs[1].first_token, list(range(n)),
                   what)
        _same_details(outs[0].prompt_details, outs[1].prompt_details, what)
        _used_rows_equal(replayed, eager, slots[0], written=True)
        if hasattr(replayed, "spec_hidden") and not torch.equal(
                replayed.spec_hidden, eager.spec_hidden):
            raise AssertionError(f"{what}: the chain state differs")
        used.update(slots[0])
        if i == 0:
            live = slots[0]
            continue
        for slot in slots[0]:
            for e in engines:
                e.free(slot)
    outs = [e.decode_steps(want_details=True) for e in engines]
    for step, (a, b) in enumerate(zip(*outs)):
        _same_rows(a, b, sorted(live), f"decode step {step} after the "
                   "prefills")
    _used_rows_equal(replayed, eager, sorted(live))
    return dict(dispatches=len(dispatches), keys=keys,
                captured=[k for k in replayed.programs.prefill
                          if k not in before_keys])


def pipelined_matches_sequential(pipelined, sequential, vocab: int,
                                 dispatches: int = 8, seed: int = 1,
                                 max_new: int = 200) -> int:
    """The same four requests on both engines; `pipelined` dispatches chunk
    N+1 before it fetches chunk N. Returns the tokens compared."""
    rng = np.random.default_rng(seed)
    prompts = [_prompt(rng, vocab, n) for n in PROMPT_LENS[:4]]
    rps = [_params(i, max_new) for i in range(4)]
    for e in (pipelined, sequential):
        slots = [e.acquire_slot() for _ in prompts]
        e.prefill(slots, prompts, rps)
    seq = [sequential.decode_steps(want_details=True)
           for _ in range(dispatches)]
    pipe = []
    handle = pipelined.decode_steps_begin(want_details=True)
    for _ in range(dispatches - 1):
        nxt = pipelined.decode_steps_begin(want_details=True)
        pipe.append(pipelined.decode_steps_end(handle))
        handle = nxt
    pipe.append(pipelined.decode_steps_end(handle))
    rows = sorted(slots)
    n = 0
    for i, (a_steps, b_steps) in enumerate(zip(pipe, seq)):
        for a, b in zip(a_steps, b_steps):
            _same_rows(a, b, rows, f"pipelined dispatch {i}")
            n += len(rows)
    return n
