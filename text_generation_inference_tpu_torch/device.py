"""Device selection for the port's entry points.

Every entry point takes an explicit `device`. The default is CUDA; a
machine without CUDA raises instead of silently running on the CPU. Tests
and tools that want the CPU ask for it with `device="cpu"`.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """Return the torch device to run on: `device` if given, else `cuda`
    (a CUDA device without an index becomes the current one).

    Raises RuntimeError when a CUDA device is asked for (explicitly or by
    default) and `torch.cuda.is_available()` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
