"""Lazy safetensors checkpoint reader (port of the JAX package's
`utils/weights.py`).

Multi-file routing via the index file (or by scanning shards). Tensors load as torch CPU tensors (which keeps
bf16 checkpoints intact); the loader moves them to the device.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import torch


class Weights:
    def __init__(self, model_dir: str | os.PathLike):
        from safetensors import safe_open

        self._safe_open = safe_open
        self.model_dir = Path(model_dir)
        files = sorted(self.model_dir.glob("*.safetensors"))
        if not files:
            raise FileNotFoundError(f"no .safetensors files under {self.model_dir}")
        self._routing: dict[str, Path] = {}
        index_file = self.model_dir / "model.safetensors.index.json"
        if index_file.exists():
            index = json.loads(index_file.read_text())
            for name, fname in index["weight_map"].items():
                self._routing[name] = self.model_dir / fname
        else:
            for f in files:
                with safe_open(f, framework="pt") as sf:
                    for name in sf.keys():
                        self._routing[name] = f
        self._handles: dict[Path, object] = {}

    def _handle(self, path: Path):
        h = self._handles.get(path)
        if h is None:
            h = self._safe_open(path, framework="pt")
            self._handles[path] = h
        return h

    def has(self, name: str) -> bool:
        return name in self._routing

    def get(self, name: str) -> torch.Tensor:
        if name not in self._routing:
            raise KeyError(f"tensor {name!r} not found in {self.model_dir}")
        return self._handle(self._routing[name]).get_tensor(name)

    def names(self) -> list[str]:
        return sorted(self._routing)
