"""Collectives over one mesh axis, plain and differentiable.

Every helper takes the axis's process group.  A group of one rank (or
None) makes each of them the identity, so world size 1 computes exactly
what a single device does.  Where the group's backend is gloo and the
tensor lives on a CUDA device (several ranks sharing one card), the
tensor crosses the host: copied to the CPU, reduced or exchanged there,
and copied back.  That staging is read off the group's backend; it is
not a reaction to any failure.

The differentiable forms treat the ranks' programs as one graph whose
objective is the sum of the ranks' losses, so each backward is the
transposed collective: ``all_to_all`` of the cotangent, ``all_reduce``
SUM of the cotangents, and for ``all_gather`` the rank's slice of the
summed cotangent.  Averaging the parameter gradients over the ranks then
gives the gradient of the mean loss (parallel/dist.py).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def dist_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(group, t: torch.Tensor) -> bool:
    """Whether ``t`` must cross the host for ``group``'s backend."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _wire(group, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the group's backend can reach it, contiguous."""
    return (t.cpu() if _staged(group, t) else t).contiguous()


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over the group in place; returns it."""
    if group_size(group) == 1:
        return t
    if _staged(group, t):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def gather_objects(obj, group) -> List:
    """``obj`` of every rank of the group, in rank order."""
    n = group_size(group)
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out


def barrier(group) -> None:
    if group_size(group) > 1:
        dist.barrier(group=group)


def or_bitmaps_(bitmap: torch.Tensor, group) -> torch.Tensor:
    """A bool bitmap OR-ed over the group in place (MAX over its bytes):
    the collective form of the candidate-set union."""
    all_reduce_(bitmap.view(torch.uint8), group, op=dist.ReduceOp.MAX)
    return bitmap


def or_words_(words: torch.Tensor, group) -> torch.Tensor:
    """Bit-packed bitmaps (int32 words, ops/union_bitmap.py) OR-ed over
    the group in place, exactly: every rank's words are all-gathered and
    OR-ed here, word by word.  A MAX over the words' bytes would not be
    an OR of packed bits, and NCCL has no bitwise-OR reduction."""
    n = group_size(group)
    if n == 1:
        return words
    parts = all_gather_rows(words, group).view(n, *words.shape)
    for part in parts:
        words |= part
    return words


def union_candidates(cands: List, group) -> List:
    """Per query vertex, the sorted union of every rank's sorted
    candidate ids (exact whatever the shard order)."""
    if group_size(group) == 1:
        return cands
    parts = gather_objects(cands, group)
    return [np.unique(np.concatenate([p[i] for p in parts]))
            for i in range(len(cands))]


class _Exchange:
    """An ``all_to_all_single`` in flight: ``wait()`` returns the
    received tensor on the sender's device.  The send buffer is kept
    alive until then."""

    def __init__(self, send: torch.Tensor, group):
        self._device = send.device
        self._send = _wire(group, send)
        self._recv = torch.empty_like(self._send)
        self._work = dist.all_to_all_single(self._recv, self._send,
                                            group=group, async_op=True)

    def wait(self) -> torch.Tensor:
        self._work.wait()
        self._send = None
        return self._recv.to(self._device)


class _Done:
    def __init__(self, t):
        self._t = t

    def wait(self):
        return self._t


def all_to_all_start(send: torch.Tensor, group):
    """Start the exchange of ``send`` [n·k, ...] (k rows to each of the n
    ranks, equal splits); ``.wait()`` gives [n·k, ...], k rows from
    each."""
    if group_size(group) == 1:
        return _Done(send)
    return _Exchange(send, group)


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """[n·r, ...]: every rank's [r, ...] rows, in rank order."""
    n = group_size(group)
    if n == 1:
        return t
    send = _wire(group, t)
    parts = [torch.empty_like(send) for _ in range(n)]
    dist.all_gather(parts, send, group=group)
    return torch.cat(parts).to(t.device)


class AllToAll(torch.autograd.Function):
    """``all_to_all_start`` whose handle is waited on in ``finish``; the
    backward is the all-to-all of the cotangent.  Use as
    ``h = AllToAll.start(x, group)`` … ``AllToAll.finish(x, h, group)``
    so that work placed between the two overlaps the exchange."""

    @staticmethod
    def start(send: torch.Tensor, group):
        return all_to_all_start(send.detach(), group)

    @staticmethod
    def forward(ctx, send, handle, group):
        ctx.group = group
        return handle.wait()

    @staticmethod
    def backward(ctx, g):
        return (all_to_all_start(g.contiguous(), ctx.group).wait(), None,
                None)

    @classmethod
    def finish(cls, send, handle, group):
        return cls.apply(send, handle, group)


class AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class AllGatherRows(torch.autograd.Function):
    """``all_gather_rows``; the backward is this rank's slice of the
    cotangents summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce_(g.clone(), ctx.group)
        r = dist_rank(ctx.group)
        return total[r * ctx.rows:(r + 1) * ctx.rows], None
