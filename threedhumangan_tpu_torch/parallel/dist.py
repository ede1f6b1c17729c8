"""Data parallelism across processes: the port's counterpart of what
threedhumangan_tpu/parallel/mesh.py does for the data axis.

The JAX package runs one program over a device mesh (``shard_map``, the
batch split over the ``data`` axis, ``pmean``/``psum`` over it).  The port
runs one process a device, as the original repo did with DDP over NCCL, and
reduces over the default ``torch.distributed`` process group that its
caller initialised (``apps/train.py``: NCCL on CUDA, gloo on the CPU).
Nothing here picks a backend or starts a group.

What crosses ranks, and where:
  * the sync-BN moments, ``mean_across_ranks`` (``models/synthesis.py::
    batch_moments``), differentiable: its backward all-reduces the
    cotangent, the transpose of JAX's ``pmean``;
  * the D and G gradients, ``all_reduce_mean_`` (``trainers/
    phase_trainer.py``), one flat buffer a dtype;
  * the summed training statistics, ``sum_across_ranks`` (the trainer's
    pull every 10 steps);
  * the trainer's start-up checksum of the weights (``check_replicas``) and
    its gather of every rank's random state into a checkpoint
    (``all_gather``).

With no group initialised ``rank()`` is 0, ``world_size()`` 1, and every
function returns its input without a collective, so a run without a group
is the one-process path bit for bit.  With a group, the collectives run at
any world size (at world size 1 they return their input's values).
``collectives`` counts the collectives issued, for tests and for
``chip_smoke.py``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

collectives = 0


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def _count():
    global collectives
    collectives += 1


def _sum_mean(x: torch.Tensor) -> torch.Tensor:
    y = x.detach().clone(memory_format=torch.contiguous_format)
    _count()
    dist.all_reduce(y)
    return y / world_size()


class _MeanAcrossRanks(torch.autograd.Function):
    """The forward and the backward are each a sum over ranks divided by the
    world size: ``pmean`` is linear and its transpose is itself."""

    @staticmethod
    def forward(ctx, x):
        return _sum_mean(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_mean(grad)


def mean_across_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over ranks (JAX ``pmean``), differentiable: its
    backward all-reduces the cotangent and divides it by the world size."""
    if not initialized():
        return x
    return _MeanAcrossRanks.apply(x)


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over ranks, in place: the tensors of a
    dtype are packed into one flat buffer and reduced by one collective."""
    if not initialized() or not tensors:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    n = world_size()
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            _count()
            dist.all_reduce(flat)
            flat /= n
            offset = 0
            for t in ts:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def sum_across_ranks(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` summed over ranks (JAX ``psum``); no gradient."""
    if not initialized():
        return x
    x = x.detach().clone()
    _count()
    dist.all_reduce(x)
    return x


def all_gather(x: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``x`` (same shape and dtype on each rank), by rank."""
    if not initialized():
        return [x]
    out = [torch.empty_like(x) for _ in range(world_size())]
    _count()
    dist.all_gather(out, x.contiguous())
    return out


def barrier() -> None:
    if initialized():
        _count()
        dist.barrier()


def tensor_checksum(t: torch.Tensor) -> torch.Tensor:
    """An int64 checksum of every bit of ``t``: its elements read as
    integers of their width, weighted by position (wrapping on overflow)."""
    x = t.detach().contiguous().reshape(-1)
    if x.is_floating_point():
        x = x.view({8: torch.int64, 4: torch.int32, 2: torch.int16}[x.element_size()])
    x = x.to(torch.int64)
    weight = torch.arange(x.numel(), device=x.device, dtype=torch.int64) % 997 + 1
    return (x * weight).sum()


def check_replicas(named: Dict[str, torch.Tensor], device) -> None:
    """Raise unless every rank holds the same ``named`` tensors: one
    all-reduce (max) of each tensor's checksum and its negation.  Ranks whose
    weights differ are reported, never overwritten (a broadcast would hide
    the difference)."""
    if not initialized():
        return
    names = sorted(named)
    local = torch.stack([tensor_checksum(named[k]).to(device) for k in names])
    both = torch.cat([local, -local])
    _count()
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    hi, lo = both[:len(names)], -both[len(names):]
    bad = [k for k, h, l in zip(names, hi.tolist(), lo.tolist()) if h != l]
    if bad:
        raise RuntimeError(f"rank {rank()}: the ranks start from different weights in "
                           f"{len(bad)} tensors, e.g. {bad[:4]}")
