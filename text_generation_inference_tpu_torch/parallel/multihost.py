"""Serving from one rank over many: rank 0 serves, the other ranks replay
its engine ops (port of the JAX package's `parallel/multihost.py`).

Every rank holds its shard of the model, and every engine call runs the
group's collectives, so every rank must make the same engine calls in the
same order. Only rank 0 runs the gRPC front end and the Batcher, so only
rank 0 knows what the next call is. As in the JAX package, rank 0 wraps
its engine in `ReplicatedEngine`, which publishes every call that touches
the device (prefill, decode dispatch and fetch, a whole decode call, slot
free, reset) just before it makes it, under one lock, and the other ranks
run `follower_loop`, which replays each call on their own engine. An
engine's host state (slots, page allocator, context mirrors) is a function
of the op stream, so the followers stay in lockstep. Host-only calls
(acquire_slot, has_capacity, reads of the allocator) pass through; a
follower takes the slots of each prefill itself.

The transport is not the JAX package's: where it pickles each descriptor
over a TCP socket of its own (MULTIHOST_STEP_PORT), the port broadcasts
tensors from rank 0 over a gloo group on CPU tensors (`OpChannel`), kept
apart from the tensor-parallel group, so that the op stream never waits
on the card's stream. Nothing is pickled. An op is a fixed int64 header
(`HEADER`: the op code and its sizes) and payload tensors that follow it:
the slots, the token ids, every `RequestParams` field (ints as int64,
floats as float64, both exact), want_details, the chunk, and each soft
prompt with its dtype and shape. A follower waiting for the next op is
bounded by the group's timeout; an idle rank 0 sends a keepalive op
(`OP_PING`) well inside it.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..engine.engine import EngineDeviceError, RequestParams
from .comm import TPGroup

logger = logging.getLogger(__name__)

# the op codes (JAX `multihost.py` names its kinds with strings): the ops
# that change device state reach the followers in rank 0's order
OP_PREFILL = 1
OP_DECODE_BEGIN = 2
OP_DECODE_END = 3
OP_FREE = 4
OP_RESET = 5
OP_STOP = 6
# a whole `decode_steps` call (dispatch and fetch): the speculative
# engines' steps and generate.v1's NextToken
OP_STEPS = 7
# nothing to replay: keeps an idle follower inside the group's timeout
OP_PING = 8

HEADER = 8   # int64 words of an op's header

# RequestParams fields by payload: ints go as int64, floats as float64
_INT_FIELDS = tuple(f.name for f in dataclasses.fields(RequestParams)
                    if isinstance(f.default, int))
_FLOAT_FIELDS = tuple(f.name for f in dataclasses.fields(RequestParams)
                      if isinstance(f.default, float))
# soft-prompt dtypes by code
_DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.float64)
# soft-prompt kinds: none, an array, a `PrefixEntry` (decoder, encoder)
_NO_PREFIX, _ARRAY, _ENTRY = 0, 1, 2
_META = 8   # int64 words describing one soft-prompt array: present, dtype,
            # numpy or torch, ndim, then up to 4 dims


def _ints(values) -> torch.Tensor:
    return torch.tensor(list(values), dtype=torch.int64)


class OpChannel:
    """The op stream over a CPU process group (a gloo group of its own):
    rank 0 `send`s, every other rank `recv`s the same ops in the same
    order. `send` is locked, so ops from several threads never
    interleave."""

    def __init__(self, group=None):
        self.comm = TPGroup(dist.get_rank(group), dist.get_world_size(group),
                            group)
        self.rank, self.world = self.comm.rank, self.comm.world
        self._lock = threading.Lock()

    def _bcast(self, t: torch.Tensor) -> torch.Tensor:
        return self.comm.broadcast(t, src=0)

    # -- rank 0 ----------------------------------------------------------

    def send(self, kind: int, *args) -> None:
        """Publish one op: (kind, *args) as `recv` returns it."""
        header, payload = _encode(kind, args)
        with self._lock:
            self._bcast(header)
            for t in payload:
                self._bcast(t)

    # -- followers -------------------------------------------------------

    def recv(self) -> tuple:
        header = self._bcast(torch.zeros(HEADER, dtype=torch.int64))
        return _decode(header.tolist(), self._bcast)


def _header(*words) -> torch.Tensor:
    out = torch.zeros(HEADER, dtype=torch.int64)
    out[:len(words)] = _ints(words)
    return out


def _array_meta(a) -> list[int]:
    if a is None:
        return [0] * _META
    is_np = isinstance(a, np.ndarray)
    t = torch.from_numpy(a) if is_np else a
    if t.dim() > _META - 4:
        raise ValueError(f"a soft prompt of {t.dim()} dims")
    return ([1, _DTYPES.index(t.dtype), int(is_np), t.dim()]
            + list(t.shape) + [0] * (_META - 4 - t.dim()))


def _encode(kind: int, args: tuple) -> tuple[torch.Tensor, list]:
    if kind == OP_PREFILL:
        slots, token_ids, params, want_details, prefix_embeds = args
        n = len(slots)
        lens = [len(t) for t in token_ids]
        ints = _ints(v for s, ln, rp in zip(slots, lens, params)
                     for v in (s, ln, *(getattr(rp, f)
                                        for f in _INT_FIELDS)))
        floats = torch.tensor([float(getattr(rp, f)) for rp in params
                               for f in _FLOAT_FIELDS], dtype=torch.float64)
        tokens = _ints(t for toks in token_ids for t in toks)
        payload = [ints, floats, tokens]
        if prefix_embeds is not None:
            kinds, sides = [], []
            for pe in prefix_embeds:
                if pe is None:
                    kinds.append(_NO_PREFIX)
                    sides += [None, None]
                elif hasattr(pe, "decoder"):
                    kinds.append(_ENTRY)
                    sides += [pe.decoder, pe.encoder]
                else:
                    kinds.append(_ARRAY)
                    sides += [pe, None]
            meta = _ints(v for a in sides for v in _array_meta(a))
            payload += [_ints(kinds), meta]
            payload += [torch.as_tensor(a).contiguous() for a in sides
                        if a is not None]
        return (_header(kind, n, sum(lens), int(want_details),
                        int(prefix_embeds is not None)), payload)
    if kind in (OP_DECODE_BEGIN, OP_STEPS):
        want_details, chunk = args
        return _header(kind, int(want_details),
                       -1 if chunk is None else int(chunk)), []
    if kind == OP_FREE:
        return _header(kind, int(args[0])), []
    if kind in (OP_DECODE_END, OP_RESET, OP_STOP, OP_PING):
        return _header(kind), []
    raise ValueError(f"unknown multihost op {kind!r}")


def _decode(h: list, bcast) -> tuple:
    kind = h[0]
    if kind == OP_PREFILL:
        n, n_tokens, want_details, has_prefix = h[1:5]
        per = 2 + len(_INT_FIELDS)
        ints = bcast(torch.zeros(n * per, dtype=torch.int64)).view(n, per)
        floats = bcast(torch.zeros(n * len(_FLOAT_FIELDS),
                                   dtype=torch.float64)).view(n, -1)
        tokens = bcast(torch.zeros(n_tokens, dtype=torch.int64)).tolist()
        slots, token_ids, params, at = [], [], [], 0
        for row, frow in zip(ints.tolist(), floats.tolist()):
            slots.append(row[0])
            token_ids.append(tokens[at:at + row[1]])
            at += row[1]
            params.append(RequestParams(
                **dict(zip(_INT_FIELDS, row[2:])),
                **dict(zip(_FLOAT_FIELDS, frow))))
        prefix_embeds = None
        if has_prefix:
            kinds = bcast(torch.zeros(n, dtype=torch.int64)).tolist()
            meta = bcast(torch.zeros(2 * n * _META, dtype=torch.int64)
                         ).view(2 * n, _META).tolist()
            sides = []
            for present, code, is_np, ndim, *dims in meta:
                if not present:
                    sides.append(None)
                    continue
                t = bcast(torch.zeros(dims[:ndim], dtype=_DTYPES[code]))
                sides.append(t.numpy() if is_np else t)
            from ..utils.prompt_cache import PrefixEntry

            prefix_embeds = [
                None if k == _NO_PREFIX else sides[2 * i] if k == _ARRAY
                else PrefixEntry(decoder=sides[2 * i],
                                 encoder=sides[2 * i + 1])
                for i, k in enumerate(kinds)]
        return (kind, slots, token_ids, params, bool(want_details),
                prefix_embeds)
    if kind in (OP_DECODE_BEGIN, OP_STEPS):
        return (kind, bool(h[1]), None if h[2] < 0 else h[2])
    if kind == OP_FREE:
        return (kind, h[1])
    if kind in (OP_DECODE_END, OP_RESET, OP_STOP, OP_PING):
        return (kind,)
    raise ValueError(f"unknown multihost op {kind!r}")


class ReplicatedEngine:
    """Rank 0's engine: every call that touches the device is published to
    the followers just before the local call, under one lock, so the op
    stream's order is rank 0's dispatch order and every rank makes the same
    calls (the lockstep of the reference's ShardedClient broadcast,
    sharded_client.rs:34-52). Anything else passes straight through. An
    idle engine sends `OP_PING` every `keepalive_s` seconds."""

    def __init__(self, engine, channel: OpChannel,
                 keepalive_s: Optional[float] = 60.0):
        self._engine = engine
        self._channel = channel
        # serializes (publish + dispatch) of the order-critical ops
        self._order = threading.Lock()
        self._last = time.monotonic()
        self._closed = threading.Event()
        self._keepalive = None
        if keepalive_s:
            self._keepalive = threading.Thread(
                target=self._ping, args=(keepalive_s,), daemon=True,
                name="multihost-keepalive")
            self._keepalive.start()

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def _send(self, kind: int, *args) -> None:
        self._channel.send(kind, *args)
        self._last = time.monotonic()

    def _ping(self, interval: float) -> None:
        while not self._closed.wait(interval / 2):
            with self._order:
                if (not self._closed.is_set()
                        and time.monotonic() - self._last >= interval):
                    self._send(OP_PING)

    # -- broadcast ops ------------------------------------------------------

    def prefill(self, slots, token_ids, request_params,
                want_prompt_details=False, prefix_embeds=None):
        with self._order:
            self._send(OP_PREFILL, slots, token_ids, request_params,
                       want_prompt_details, prefix_embeds)
            return self._engine.prefill(
                slots, token_ids, request_params,
                want_prompt_details=want_prompt_details,
                prefix_embeds=prefix_embeds)

    def decode_steps_begin(self, want_details=True, chunk=None):
        with self._order:
            self._send(OP_DECODE_BEGIN, want_details, chunk)
            return self._engine.decode_steps_begin(
                want_details=want_details, chunk=chunk)

    def decode_steps_end(self, handle):
        # a fetch; the op keeps the followers' handle queues bounded
        self._send(OP_DECODE_END)
        return self._engine.decode_steps_end(handle)

    def decode_steps(self, want_details=True, chunk=None):
        """One whole decode call, the engine's own: a speculative engine's
        step, whose emitted counts drive its host state, on every rank."""
        with self._order:
            self._send(OP_STEPS, want_details, chunk)
            return self._engine.decode_steps(want_details=want_details,
                                             chunk=chunk)

    def decode(self):
        return self.decode_steps()[0]

    def free(self, slot: int) -> None:
        # a free reaches the device at the NEXT engine call (the pending
        # frees); in stream order, every rank applies it at the same call
        with self._order:
            self._send(OP_FREE, slot)
            self._engine.free(slot)

    def reset(self) -> None:
        with self._order:
            self._send(OP_RESET)
            self._engine.reset()

    def shutdown(self) -> None:
        """Release the followers (`OP_STOP`) and stop the keepalive."""
        self._closed.set()
        with self._order:
            self._send(OP_STOP)
        if self._keepalive is not None:
            self._keepalive.join(timeout=5)


def _replay(fn, *args, **kwargs):
    """One replayed engine call. A device failure here also failed the same
    call on rank 0, which publishes OP_RESET next: survive it, so that the
    reset can be received and applied."""
    try:
        return fn(*args, **kwargs)
    except EngineDeviceError:
        logger.exception("multihost follower: device step failed; awaiting "
                         "rank-0 reset")
        return None


def follower_loop(engine, channel: OpChannel) -> int:
    """Ranks 1..N-1: replay rank 0's op stream on the local engine until
    OP_STOP; returns the number of ops replayed. Outputs are discarded: a
    follower is there to meet rank 0 in every collective."""
    handles: deque = deque()
    n_ops = 0
    while True:
        op = channel.recv()
        kind = op[0]
        if kind == OP_STOP:
            logger.info("multihost follower: stop after %d ops", n_ops)
            return n_ops
        if kind == OP_PING:
            continue
        n_ops += 1
        if kind == OP_PREFILL:
            _, slots, token_ids, request_params, want_details, embeds = op
            # rank 0 acquired these slots (a host-only call)
            for slot in slots:
                if slot in engine.free_slots:
                    engine.free_slots.remove(slot)
            _replay(engine.prefill, slots, token_ids, request_params,
                    want_prompt_details=want_details, prefix_embeds=embeds)
        elif kind == OP_DECODE_BEGIN:
            _, want_details, chunk = op
            h = _replay(engine.decode_steps_begin,
                        want_details=want_details, chunk=chunk)
            if h is not None:
                handles.append(h)
        elif kind == OP_DECODE_END:
            # drop the oldest handle without fetching: rank 0 has the
            # outputs, and a fetch would hold the follower back
            if handles:
                handles.popleft()
        elif kind == OP_STEPS:
            _, want_details, chunk = op
            _replay(engine.decode_steps, want_details=want_details,
                    chunk=chunk)
        elif kind == OP_FREE:
            engine.free(op[1])
        elif kind == OP_RESET:
            handles.clear()
            engine.reset()
