"""ctypes bindings for the native stop-sequence matcher (native/tokenproc.cpp).

Exposes `NativeStopState` with the same semantics as the pure-Python
`StopSequenceState` (utils/detokenizer.py) but byte-exact matching in C++ —
the reference also matches stop sequences on bytes, not chars (reference:
router/src/batcher.rs:792 "compare byte subslices to avoid utf8 boundary
problem"). Falls back transparently when the shared library is absent.
"""

from __future__ import annotations

import ctypes
import logging
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

_LIB_PATHS = [
    Path(__file__).resolve().parents[2] / "native" / "libtokenproc.so",
    Path(__file__).resolve().parent / "libtokenproc.so",
]

_lib = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    for p in _LIB_PATHS:
        if p.exists():
            lib = ctypes.CDLL(str(p))
            lib.tp_create.restype = ctypes.c_void_p
            lib.tp_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
            lib.tp_destroy.argtypes = [ctypes.c_void_p]
            lib.tp_feed.restype = ctypes.c_int32
            lib.tp_feed.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint64)]
            lib.tp_held_back.restype = ctypes.c_int32
            lib.tp_held_back.argtypes = [ctypes.c_void_p]
            lib.tp_text_len.restype = ctypes.c_uint64
            lib.tp_text_len.argtypes = [ctypes.c_void_p]
            lib.tp_final_text.restype = ctypes.c_uint64
            lib.tp_final_text.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p]
            _lib = lib
            return lib
    return None


def available() -> bool:
    return _load() is not None


from .detokenizer import StopStateBase


class NativeStopState(StopStateBase):
    """Byte-exact stop-sequence state backed by native/tokenproc.cpp.

    Matching and hold-back run in C++; output assembly (final/visible text,
    grapheme-safe streaming cut) is shared with the Python fallback via
    StopStateBase, so both paths have identical semantics.
    """

    def __init__(self, stop_sequences: list[str], include_stop_sequence: bool):
        lib = _load()
        if lib is None:
            raise RuntimeError("libtokenproc.so not built (make -C native)")
        super().__init__(stop_sequences, include_stop_sequence)
        self._lib = lib
        encoded = [s.encode() for s in stop_sequences]
        arr = (ctypes.c_char_p * len(encoded))(*encoded)
        lens = (ctypes.c_int32 * len(encoded))(*[len(e) for e in encoded])
        self._h = lib.tp_create(arr, lens, len(encoded))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.tp_destroy(h)
            self._h = None

    def feed(self, delta: str) -> Optional[tuple[str, int]]:
        if self._matched is not None:
            return self._matched
        data = delta.encode()
        self._buf.extend(data)
        end = ctypes.c_uint64()
        idx = self._lib.tp_feed(self._h, data, len(data), ctypes.byref(end))
        if idx >= 0:
            self._matched = (self.stop_sequences[idx], int(end.value))
            return self._matched
        return None

    def held_back_len(self) -> int:
        return int(self._lib.tp_held_back(self._h))

    @property
    def text_bytes_len(self) -> int:
        return int(self._lib.tp_text_len(self._h))
