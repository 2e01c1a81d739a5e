"""A tensor-parallel rank's process group and its collectives.

Every collective of the layer code goes through one `TPGroup`: the sum of
row-parallel partial products (`all_reduce`), the vocab-sharded logits put
back together (`all_gather_last`), and `broadcast`, which the op stream of
`multihost.py` uses on its own CPU group.

NCCL takes CUDA tensors and records its kernels on the current stream, so
a decode step with its collectives inside is captured as one CUDA graph
(`capturable`). gloo runs on the host: it takes CPU tensors, and a CUDA
tensor is staged through the host around each collective (`staged`). The
choice follows from the group's backend, never from a caught error. A
staged collective synchronises with the card, so a gloo group on CUDA
tensors cannot be captured: the engines then run their decode steps
eagerly (`eager_decode=True`), and `engine.programs.DecodePrograms` raises
when asked to capture them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class TPGroup:
    """Rank `rank` of `world` over the process group `group` (None: the
    default group)."""

    def __init__(self, rank: int, world: int, group=None):
        self.rank, self.world, self.group = rank, world, group
        self.backend = str(dist.get_backend(group))
        if dist.get_world_size(group) != world or dist.get_rank(group) != rank:
            raise ValueError(
                f"TPGroup({rank}, {world}) does not match its process group "
                f"(rank {dist.get_rank(group)} of "
                f"{dist.get_world_size(group)})")

    def __repr__(self) -> str:
        return f"TPGroup(rank={self.rank}, world={self.world}, {self.backend})"

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can record this group's collectives."""
        return self.backend == "nccl"

    def staged(self, x: torch.Tensor) -> bool:
        """Whether a collective on `x` goes through a host copy: gloo on a
        CUDA tensor."""
        return self.backend == "gloo" and x.is_cuda

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's `x` (a partial product), on every rank.
        Reduces a contiguous `x` in place and returns it."""
        x = x.contiguous()
        if self.staged(x):
            host = x.cpu()
            dist.all_reduce(host, group=self.group)
            x.copy_(host)
        else:
            dist.all_reduce(x, group=self.group)
        return x

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """[..., n] on every rank -> [..., world * n]: the ranks' blocks
        side by side in rank order (a column-parallel product's full
        output)."""
        x = x.contiguous()
        src = x.cpu() if self.staged(x) else x
        if self.backend == "nccl":
            out = torch.empty((self.world, *x.shape), dtype=x.dtype,
                              device=x.device)
            dist.all_gather_into_tensor(out, src, group=self.group)
        else:
            parts = [torch.empty_like(src) for _ in range(self.world)]
            dist.all_gather(parts, src, group=self.group)
            out = torch.stack(parts).to(x.device)
        return out.movedim(0, -2).reshape(*x.shape[:-1],
                                          self.world * x.shape[-1])

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s `x` (`src` a rank of this group) on every rank, in
        place."""
        if self.world == 1:
            return x
        if self.group is not None:
            src = dist.get_global_rank(self.group, src)
        if self.staged(x):
            host = x.cpu()
            dist.broadcast(host, src, group=self.group)
            x.copy_(host)
        else:
            dist.broadcast(x, src, group=self.group)
        return x

    def min_int(self, value: int) -> int:
        """The smallest `value` over the group (a host integer)."""
        device = "cuda" if self.backend == "nccl" else "cpu"
        t = torch.tensor([int(value)], dtype=torch.int64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
        return int(t.item())
