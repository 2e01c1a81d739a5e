"""Tuned-prompt (PEFT soft-prompt) prefix store with LRU caching (the port's
copy of the JAX package's `utils/prompt_cache.py`, for decoder-only models).

Port of the reference's PrefixCache (reference:
server/text_generation_server/prompt_cache.py:175-350): prefixes live under
`PREFIX_STORE_PATH/<prefix_id>/` as either a raw `decoder.pt` tensor or a
PEFT checkpoint (`adapter_model.safetensors` / `adapter_model.bin` with key
"prompt_embeddings"); entries are LRU-evicted against a size cap in MB;
prefix ids are checked against path traversal (prompt_cache.py:206-215) and
tensors are sanitized for dtype/shape (prompt_cache.py:310). The
encoder-side tensors of seq2seq models (`encoder.pt`) come with the seq2seq
slice of the port.

Embeddings are held as host numpy arrays: the engine injects them into the
prefill input embedding stream, so they only travel to the device with the
prefill that uses them.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from pathlib import Path, PurePath
from typing import NamedTuple

import numpy as np


class PrefixEntry(NamedTuple):
    """A tuned prompt: its decoder-side embeddings [P, hidden] f32."""

    decoder: np.ndarray

    @property
    def total_length(self) -> int:
        return self.decoder.shape[0]


class PrefixNotFound(Exception):
    pass


class InvalidPrefix(Exception):
    pass


class PrefixCache:
    def __init__(self, store_path: str, embed_dim: int,
                 max_size_mb: int = 512, max_prefix_length: int = 256):
        self.store_path = Path(store_path)
        self.embed_dim = embed_dim
        self.max_bytes = max_size_mb * 1024 * 1024
        self.max_prefix_length = max_prefix_length
        self._lock = threading.Lock()
        self._cache: OrderedDict[str, PrefixEntry] = OrderedDict()
        self._bytes = 0

    # -- public API ---------------------------------------------------------

    def get_entry(self, prefix_id: str) -> PrefixEntry:
        with self._lock:
            entry = self._cache.get(prefix_id)
            if entry is not None:
                self._cache.move_to_end(prefix_id)
                return entry
        from . import metrics

        t0 = time.monotonic()
        try:
            entry = self._load(prefix_id)
        except Exception:
            metrics.increment("tgi_prompt_load_failure")
            raise
        # reference: tgi_prompt_load_duration counts cache-miss loads
        metrics.observe("tgi_prompt_load_duration", time.monotonic() - t0)
        with self._lock:
            if prefix_id not in self._cache:
                self._cache[prefix_id] = entry
                self._bytes += entry.decoder.nbytes
                while self._bytes > self.max_bytes and len(self._cache) > 1:
                    _, evicted = self._cache.popitem(last=False)
                    self._bytes -= evicted.decoder.nbytes
            self._cache.move_to_end(prefix_id)
            return self._cache[prefix_id]

    def get(self, prefix_id: str) -> np.ndarray:
        """Decoder-side [prefix_len, embed_dim] f32 embeddings."""
        return self.get_entry(prefix_id).decoder

    def prefix_length(self, prefix_id: str) -> int:
        return self.get_entry(prefix_id).total_length

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()
            self._bytes = 0

    def __len__(self) -> int:
        return len(self._cache)

    # -- loading ------------------------------------------------------------

    def _dir_for(self, prefix_id: str) -> Path:
        if not prefix_id:
            raise InvalidPrefix("empty prefix id")
        # path traversal guard (reference: prompt_cache.py:206-215)
        pp = PurePath(prefix_id)
        if pp.is_absolute() or ".." in pp.parts:
            raise InvalidPrefix(f"invalid prefix id {prefix_id!r}")
        d = self.store_path / pp
        try:
            d.resolve().relative_to(self.store_path.resolve())
        except ValueError:
            raise InvalidPrefix(f"invalid prefix id {prefix_id!r}")
        return d

    def _load_pt(self, prefix_id: str, path: Path) -> np.ndarray:
        import torch

        obj = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(obj, dict):
            if "prompt_embeddings" not in obj:
                raise InvalidPrefix(
                    f"prefix {prefix_id!r}: no prompt_embeddings tensor")
            obj = obj["prompt_embeddings"]
        return self._sanitize(prefix_id, obj.to(torch.float32).numpy())

    def _load(self, prefix_id: str) -> PrefixEntry:
        d = self._dir_for(prefix_id)
        if not d.is_dir():
            raise PrefixNotFound(f"prefix {prefix_id!r} not found")
        peft_st = d / "adapter_model.safetensors"
        peft_bin = d / "adapter_model.bin"
        dec_pt = d / "decoder.pt"
        if peft_st.exists():
            from safetensors import safe_open

            with safe_open(peft_st, framework="np") as f:
                if "prompt_embeddings" not in f.keys():
                    raise InvalidPrefix(
                        f"prefix {prefix_id!r}: no prompt_embeddings tensor")
                arr = f.get_tensor("prompt_embeddings")
            return PrefixEntry(self._sanitize(prefix_id, np.asarray(arr)))
        if peft_bin.exists():
            return PrefixEntry(self._load_pt(prefix_id, peft_bin))
        if dec_pt.exists():
            return PrefixEntry(self._load_pt(prefix_id, dec_pt))
        raise PrefixNotFound(f"prefix {prefix_id!r} has no known tensor file")

    def _sanitize(self, prefix_id: str, arr: np.ndarray) -> np.ndarray:
        """dtype/shape checks (reference: prompt_cache.py:310)."""
        if arr.ndim != 2:
            raise InvalidPrefix(
                f"prefix {prefix_id!r}: expected 2D tensor, got shape {arr.shape}")
        if arr.shape[1] != self.embed_dim:
            raise InvalidPrefix(
                f"prefix {prefix_id!r}: embed dim {arr.shape[1]} != model "
                f"hidden size {self.embed_dim}")
        if not (1 <= arr.shape[0] <= self.max_prefix_length):
            raise InvalidPrefix(
                f"prefix {prefix_id!r}: length {arr.shape[0]} outside "
                f"[1, {self.max_prefix_length}]")
        if not np.issubdtype(arr.dtype, np.floating):
            raise InvalidPrefix(f"prefix {prefix_id!r}: non-float dtype {arr.dtype}")
        arr = arr.astype(np.float32)
        if not np.isfinite(arr).all():
            raise InvalidPrefix(f"prefix {prefix_id!r}: non-finite values")
        return arr
