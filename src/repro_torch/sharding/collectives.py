"""The rank mesh's collectives: the client axis over the default
``torch.distributed`` group (the caller starts it: NCCL on cards, gloo on
the CPU).  Every row movement of a round under a rank mesh goes through
this module:

* :func:`all_gather_rows` -- each rank's block of a row list, all blocks to
  every rank in row order (the per-row eval terms, the wire messages);
* :func:`exchange_rows` -- an all-to-all of row counts known to every rank
  (residual rows to the rank that works on them and back, a fleet's
  sampled rows);
* :func:`broadcast` -- one rank's tensor to all (a scalar metric).

Gloo takes no 16-bit integer and no unsigned 32-bit type (``all_gather``
of a ``uint16``, ``int16`` or ``uint32`` tensor fails with "Invalid scalar
type"), and NCCL no 16-bit integer, so every tensor crosses ranks as
``uint8`` rows (``[rows, row bytes]``) and is viewed back on arrival.
Under gloo a CUDA tensor is staged through the host: copied out into
pinned memory, moved as a CPU tensor, copied back from pinned memory (the
caching host allocator keeps the pinned blocks for the next round).  NCCL
takes CUDA tensors as they are.

:func:`stats` counts what crossed since :func:`reset_stats`: the calls, the
bytes this rank sent to other ranks and received from them (padding
included; its own block not), the host seconds spent in this module (the
wait for the slowest rank included) and, of those, the seconds of the
staging copies.
"""
from __future__ import annotations

import time

import torch

_STATS = {"calls": 0, "bytes_out": 0, "bytes_in": 0, "seconds": 0.0,
          "stage_seconds": 0.0}


def stats() -> dict:
    """The counters since the last :func:`reset_stats`."""
    return dict(_STATS)


def reset_stats() -> None:
    _STATS.update(calls=0, bytes_out=0, bytes_in=0, seconds=0.0,
                  stage_seconds=0.0)


def _dist():
    import torch.distributed as dist
    return dist


def _staged(x: torch.Tensor) -> bool:
    """Whether ``x`` crosses ranks through the host (a CUDA tensor under
    gloo)."""
    return x.is_cuda and _dist().get_backend() == "gloo"


def _row_elems(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """``[rows, ...]`` -> ``[rows, row bytes]`` uint8 (contiguous)."""
    rows, per = x.shape[0], _row_elems(x.shape[1:])
    if per == 0:
        return torch.empty((rows, 0), dtype=torch.uint8, device=x.device)
    flat = x.contiguous().reshape(rows, per)
    return flat if flat.dtype == torch.uint8 else flat.view(torch.uint8)


def _buffer(shape, b: torch.Tensor) -> torch.Tensor:
    """A ``uint8`` buffer beside ``b`` (pinned host memory for a CPU
    tensor that stages a CUDA one: ``b`` is then pinned itself)."""
    return torch.empty(shape, dtype=torch.uint8, device=b.device,
                       pin_memory=b.is_pinned())


def _to_host(b: torch.Tensor) -> torch.Tensor:
    """A CUDA ``uint8`` tensor copied into pinned host memory."""
    t0 = time.perf_counter()
    out = torch.empty(b.shape, dtype=torch.uint8, pin_memory=True).copy_(b)
    _STATS["stage_seconds"] += time.perf_counter() - t0
    return out


def _from_bytes(b: torch.Tensor, like: torch.Tensor, device) -> torch.Tensor:
    """Inverse of :func:`_as_bytes` for rows shaped like ``like``'s, moved
    to ``device``."""
    rows, tail = b.shape[0], tuple(like.shape[1:])
    if b.device != torch.device(device):
        t0 = time.perf_counter()
        b = b.to(device)
        _STATS["stage_seconds"] += time.perf_counter() - t0
    if _row_elems(tail) == 0:
        return torch.empty((rows,) + tail, dtype=like.dtype, device=device)
    return b.view(like.dtype).reshape((rows,) + tail)


class _Timed:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _STATS["seconds"] += time.perf_counter() - self.t0
        _STATS["calls"] += 1


def all_gather_rows(x: torch.Tensor, counts) -> torch.Tensor:
    """Every rank's block of a row list, in rank order: ``x`` is this
    rank's ``[counts[rank], ...]`` block, the result ``[sum(counts),
    ...]`` on ``x``'s device, the same on every rank.  Blocks are padded to
    the largest for the collective; where a block is empty, every rank
    takes rank 0's dtype."""
    dist = _dist()
    W, me = dist.get_world_size(), dist.get_rank()
    counts = [int(c) for c in counts]
    if x.shape[0] != counts[me]:
        raise ValueError(f"rank {me} holds {x.shape[0]} rows, its block "
                         f"has {counts[me]}")
    with _Timed():
        if 0 in counts and sum(counts):
            # a rank with no rows cannot know their dtype (the eval's
            # losses): rank 0, which holds the first and longest block,
            # says it
            dtype = [x.dtype]
            dist.broadcast_object_list(dtype, src=0)
            x = x.to(dtype[0])
        b = _as_bytes(x)
        top, B = max(counts), b.shape[1]
        if top == 0 or B == 0:
            return _from_bytes(torch.empty((sum(counts), B),
                                           dtype=torch.uint8), x, x.device)
        if b.shape[0] < top:
            b = torch.cat([b, b.new_zeros((top - b.shape[0], B))])
        if _staged(b):
            b = _to_host(b)
        outs = [_buffer((top, B), b) for _ in range(W)]
        dist.all_gather(outs, b)
        full = torch.cat([o[:c] for o, c in zip(outs, counts)],
                         out=_buffer((sum(counts), B), b))
        _STATS["bytes_out"] += top * B * (W - 1)
        _STATS["bytes_in"] += top * B * (W - 1)
        return _from_bytes(full, x, x.device)


def exchange_rows(x: torch.Tensor, send_counts, recv_counts
                  ) -> torch.Tensor:
    """All-to-all of rows: ``x`` holds the rows this rank sends, grouped by
    destination rank in rank order (``send_counts[r]`` rows to rank r); the
    result holds the rows received, grouped by source rank in rank order
    (``recv_counts[r]`` from rank r), on ``x``'s device."""
    dist = _dist()
    me = dist.get_rank()
    send = [int(c) for c in send_counts]
    recv = [int(c) for c in recv_counts]
    with _Timed():
        b = _as_bytes(x)
        B = b.shape[1]
        if B == 0:
            return _from_bytes(torch.empty((sum(recv), 0),
                                           dtype=torch.uint8), x, x.device)
        if _staged(b):
            b = _to_host(b)
        out = _buffer((sum(recv), B), b)
        dist.all_to_all_single(out, b, recv, send)
        _STATS["bytes_out"] += (sum(send) - send[me]) * B
        _STATS["bytes_in"] += (sum(recv) - recv[me]) * B
        return _from_bytes(out, x, x.device)


def broadcast(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank (a new tensor of ``x``'s shape,
    dtype and device)."""
    dist = _dist()
    with _Timed():
        b = _as_bytes(x.reshape(1, -1))
        b = _to_host(b) if _staged(b) else b.clone()
        dist.broadcast(b, src)
        nbytes = b.numel() * (dist.get_world_size() - 1)
        if dist.get_rank() == src:
            _STATS["bytes_out"] += nbytes
        else:
            _STATS["bytes_in"] += b.numel()
        return _from_bytes(b, x.reshape(1, -1), x.device).reshape(x.shape)
