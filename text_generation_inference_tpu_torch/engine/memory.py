"""Device memory accounting (port of the parts of the JAX package's
`engine/memory.py` that the paged engine uses).

`device_hbm_bytes` reads the card's total memory from
`torch.cuda.mem_get_info`; the paged engine sizes its KV pool from it.
"""

from __future__ import annotations

import torch


def tree_bytes(tree) -> int:
    """Bytes held by every tensor in a nested dict / list / tuple. NamedTuple
    leaves such as `Int4Weight` are tuples, so their packed words, scales,
    zero terms and permutations count (None fields count 0)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def device_hbm_bytes(device=None) -> int:
    """Total memory of the target CUDA device. Raises on a machine without
    CUDA: there is no device memory to plan against."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"device_hbm_bytes: {device} is not a CUDA device")
    _free, total = torch.cuda.mem_get_info(device)
    return int(total)
