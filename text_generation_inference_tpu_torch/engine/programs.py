"""Engine programs: the counterpart of the JAX engines' compiled decode
steps (their `_decode_fns` dict and `.lower().compile()`) and compiled
prefill steps (their `_prefill_fns`, and the speculative engines'
`_spec_prefill_fns`).

The JAX engines build one program per decode dispatch shape, keyed by
(want_details, context rows or live pages, chunk), and compile every key
ahead of time at warmup (`precompile_decode`), so serving dispatches one
compiled program a chunk. Here a program is one `torch.cuda.CUDAGraph`
captured from the engine's eager step function. Its inputs are the
engine's own state, cache and params tensors, which the step updates in
place (no staging copies), and its output is the static tensor the capture
allocated (the packed step outputs, [chunk, S, W] or [S, W]). A dispatch
is one replay.

Prefill programs sit beside them (`DecodePrograms.prefill`), under the JAX
engines' prefill keys ((n, bucket, want_details, has_prefix) on the slot
and paged engines, (n, bucket) for the slot speculative engine's own
prefill, (n, bucket, dec_width, has_enc, has_dec) on the seq2seq engine).
A prefill program also holds static input buffers (the padded ids, the
lengths, the slots, the prefix lengths, the soft-prompt embeds where the
key has them): `PrefillProgram.run` writes every buffer whole from the
call's host arrays, then replays, and its outputs (the packed first-token
outputs, and the prompt details where the key asks for them) are the
static tensors of the capture, which the engine copies to the host before
any other replay.

`DecodePrograms.build` follows the PyTorch recipe: every new program runs
once eagerly on a side stream first (building the kernels, warming cuBLAS
and the allocator, and growing the kernels' shared scratch to the largest
size any program needs), then the scratch is pinned and each program is
captured on that stream. All of an engine's graphs, prefill and decode,
share one memory pool: they replay one at a time on one stream, in any
order, and the engine copies a replay's output out before the next replay
may reuse the pool. `engine.memory` reserves that pool once in the plan.
The eager runs write the engine's state and cache, and hold their working
set outside the graphs' pool, so `build` runs them only at warmup; a
program added later (a chunk override outside the grid, a prefill key
outside the warm grid, as JAX compiles one lazily) is captured without
one, after the calling thread's cuBLAS handles are made (`_prime_blas`:
a capture cannot make them, and the batcher calls from an executor
thread). Python's garbage collector is off during a capture.

On the CPU a program is the eager step function itself (over the same
static buffers for a prefill), under the same keys and counts: the CPU is
asked for explicitly, so this is its path, not a fallback. An engine built
with `eager_decode=True` runs its programs, prefill and decode, eagerly on
the card too: the reference that tests and `chip_smoke.py` compare replays
with. A capture that fails raises; nothing falls back to eager.

Launch counts. The kernel wrappers count their Python calls in
`.launches`: a capture calls each wrapper once per launch it records, a
replay calls none. So a capture's calls are taken out of the counters and
recorded per program, and each program counts its replays; `launches`
reports a counter's own count plus, over every live program, captured x
replays. `track` adds another counter (a function attribute) to that
accounting.
"""

from __future__ import annotations

import functools
import gc
import time
import weakref
from typing import Callable, Optional

import torch

from ..ops.cuda import paged_attention as scratch

# every DecodePrograms alive, for the launch accounting
_SETS: "weakref.WeakSet[DecodePrograms]" = weakref.WeakSet()
# counters beyond the kernel wrappers' (see `track`)
_TRACKED: list[tuple[object, str]] = []


@functools.cache
def _kernel_wrappers() -> tuple:
    from ..ops.cuda import decode_attention, flash_prefill, int4_matmul
    from ..ops.cuda import int4_mlp, paged_attention, ring_decode_attention

    return (flash_prefill.flash_prefill,
            paged_attention.paged_decode_attention,
            paged_attention.paged_decode_attention_partial,
            paged_attention.paged_decode_attention_partial_i8,
            int4_matmul.int4_matmul, int4_matmul.int4_matmul_s4,
            int4_matmul.int4_matmul_s4_stacked,
            int4_mlp.int4_mlp_s4_stacked, decode_attention.decode_attention,
            ring_decode_attention.ring_decode_attention)


def track(holder, attr: str = "launches") -> None:
    """Count `holder.attr` (an int attribute the caller increments) the way
    the kernel wrappers' launches are counted: captures record it, replays
    multiply it."""
    if (holder, attr) not in _counters():
        _TRACKED.append((holder, attr))


def _counters() -> list[tuple[object, str]]:
    return [(fn, "launches") for fn in _kernel_wrappers()] + _TRACKED


def _read() -> dict:
    return {key: getattr(*key) for key in _counters()}


def replayed(holder, attr: str = "launches") -> int:
    """The increments of `holder.attr` that the replays of every live
    program stand for: captured x replays, summed over the programs."""
    key = (holder, attr)
    return sum(p.replays * p.launches.get(key, 0)
               for progs in list(_SETS) for p in progs.every_program())


def launches(holder, attr: str = "launches") -> int:
    """A counter's launches: its eager calls plus its replayed ones."""
    return getattr(holder, attr) + replayed(holder, attr)


def _prime_blas(device: torch.device) -> None:
    """Make the calling thread's cuBLAS and cuBLASLt handles and their
    workspaces on the current stream, as a capture cannot: a small product
    through each (a plain one, one with a bias epilogue, one in f32)."""
    a = torch.ones((16, 16), dtype=torch.bfloat16, device=device)
    torch.mm(a, a)
    torch.addmm(a[0], a, a)
    torch.mm(a.float(), a.float())


class DecodeProgram:
    """One decode program: a captured graph and its static output, or (on
    the CPU, or eager on the card) the step function itself."""

    def __init__(self, fn: Optional[Callable] = None,
                 graph: Optional["torch.cuda.CUDAGraph"] = None,
                 output=None, launches: Optional[dict] = None,
                 seconds: float = 0.0):
        self.fn, self.graph, self.output = fn, graph, output
        self.launches = launches or {}   # (holder, attr) -> per replay
        self.seconds = seconds           # capture time
        self.replays = 0

    def run(self):
        """One dispatch: a replay (the static output, valid until the next
        replay of any program of its set) or an eager call."""
        self.replays += 1
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        return self.output


class PrefillProgram(DecodeProgram):
    """One prefill program: its static input buffers (a tensor, or None
    where the key takes no such input) and the step over them, captured or
    eager."""

    def __init__(self, inputs: tuple, **kw):
        super().__init__(**kw)
        self.inputs = inputs

    def stage(self, arrays) -> None:
        """Write every input buffer whole from the call's host arrays, on
        the current stream (the engine's), so that nothing of the previous
        call of the key is left behind."""
        if len(arrays) != len(self.inputs):
            raise ValueError(f"{len(arrays)} inputs for a program of "
                             f"{len(self.inputs)}")
        for buf, a in zip(self.inputs, arrays):
            if (buf is None) != (a is None) or (
                    buf is not None and tuple(buf.shape) != a.shape):
                raise ValueError(
                    "prefill input does not fit its program's buffer: "
                    f"{None if a is None else a.shape} for "
                    f"{None if buf is None else tuple(buf.shape)}")
            if buf is not None:
                buf.copy_(torch.from_numpy(a))

    def run(self, arrays):
        """Stage the call's host arrays, then one dispatch."""
        self.stage(arrays)
        return super().run()


class DecodePrograms:
    """An engine's programs: decode programs by key (`programs`) and
    prefill programs by key (`prefill`), with one graph pool; `capture`
    is whether they are CUDA graphs (an engine on the card, unless built
    with eager_decode). A tensor-parallel engine's programs hold its
    group's collectives: an NCCL group's are captured with the step, every
    rank capturing the same programs in the same order; a gloo group's
    cannot be captured (`tp.capturable`), and asking for that raises."""

    def __init__(self, device: torch.device, capture: bool, tp=None):
        if capture and tp is not None and not tp.capturable:
            raise ValueError(
                f"{tp}: its collectives go through the host and cannot be "
                "captured into a CUDA graph; build the engine with "
                "eager_decode=True")
        self.device = device
        self.capture = capture
        self.programs: dict[tuple, DecodeProgram] = {}
        self.prefill: dict[tuple, PrefillProgram] = {}
        self._pool = None
        self._stream = None
        _SETS.add(self)

    def __len__(self) -> int:
        """The decode programs (the JAX engines' decode count)."""
        return len(self.programs)

    def get(self, key: tuple) -> Optional[DecodeProgram]:
        return self.programs.get(key)

    def every_program(self) -> list[DecodeProgram]:
        return [*self.programs.values(), *self.prefill.values()]

    @property
    def seconds(self) -> float:
        """Seconds spent making the decode programs (capturing, eager runs
        included)."""
        return sum(p.seconds for p in self.programs.values())

    @property
    def prefill_seconds(self) -> float:
        """Seconds spent making the prefill programs."""
        return sum(p.seconds for p in self.prefill.values())

    def build(self, fns: dict, warm: bool = True) -> None:
        """Make a decode program for every key of `fns` (key -> step
        function) that has none. With `warm`, each new program first runs
        eagerly on the capture stream (it writes the engine's state and
        cache: no request may be in flight); without, the capture alone
        runs, which executes nothing."""
        new = {k: fn for k, fn in fns.items() if k not in self.programs}
        self.programs.update(self._make(new, warm, DecodeProgram))

    def build_prefill(self, key: tuple, step: Callable, arrays: tuple,
                      warm: bool) -> PrefillProgram:
        """Make the prefill program of `key`: static input buffers on the
        device, shaped and typed as this call's host `arrays` (None where
        the key takes no such input) and holding them, and `step(*inputs)`
        -> (packed outputs, prompt details or None) over them, run once on
        the capture stream first with `warm` (as `build`)."""
        inputs = tuple(None if a is None else
                       torch.from_numpy(a).to(self.device) for a in arrays)
        fn = functools.partial(step, *inputs)
        program = self._make({key: fn}, warm, PrefillProgram,
                             inputs=inputs)[key]
        self.prefill[key] = program
        return program

    def _make(self, fns: dict, warm: bool, cls, **extra) -> dict:
        """Programs of class `cls` for `fns` (key -> step function): the
        step functions themselves without capture, else graphs."""
        if not self.capture:
            return {k: cls(fn=fn, **extra) for k, fn in fns.items()}
        if not fns:
            return {}
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        if self._pool is None:        # the first capture, or after clear()
            self._pool = torch.cuda.graph_pool_handle()
        main = torch.cuda.current_stream(self.device)
        t0 = time.monotonic()
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            _prime_blas(self.device)
            for fn in fns.values() if warm else ():
                fn()
        main.wait_stream(self._stream)
        warm_s = (time.monotonic() - t0) / len(fns)
        # the eager runs grew the scratch to every program's size
        scratch.pin_scratch(self, self.device)
        return {key: cls(fn=fn, **extra, **self._capture(fn, warm_s))
                for key, fn in fns.items()}

    def _capture(self, fn: Callable, warm_s: float) -> dict:
        before = _read()
        graph = torch.cuda.CUDAGraph()
        t0 = time.monotonic()
        # no garbage collection inside the capture (torch.cuda.graph
        # collects before it begins): a collection there runs the
        # finalizers of earlier dispatches' pinned buffers and events on
        # this thread, and the CUDA calls they make invalidate the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream):
                output = fn()
            after = _read()
        finally:
            if collecting:
                gc.enable()
            # a capture launches nothing: take its calls out of the counters
            for (holder, attr), n in before.items():
                setattr(holder, attr, n)
        counted = {k: after[k] - n for k, n in before.items()
                   if after[k] != n}
        return dict(graph=graph, output=output, launches=counted,
                    seconds=warm_s + time.monotonic() - t0)

    def clear(self) -> None:
        """Drop every program, prefill and decode (and with them the
        graphs' pool)."""
        self.programs.clear()
        self.prefill.clear()
        self._pool = None
        scratch.unpin_scratch(self)

    def pool_bytes(self) -> Optional[int]:
        """Bytes of the graphs' memory pool (the allocator's segments of
        this pool), or None when no graph is captured or the allocator's
        snapshot names no pools."""
        if self._pool is None:
            return None
        pool = tuple(self._pool)
        segments = torch.cuda.memory_snapshot()
        if not segments or "segment_pool_id" not in segments[0]:
            return None
        return sum(s["total_size"] for s in segments
                   if tuple(s["segment_pool_id"]) == pool)
