"""The rank mesh's collectives, over the ``torch.distributed`` group of
one mesh axis (the caller starts the default group: NCCL on cards, gloo on
the CPU).  Every function takes ``axis``, ``"client"`` (the default) or
``"model"``, and runs over ``partition.axis_group(axis)``: the ranks that
share this rank's coordinate on the other axis, or the default group
itself where the axis holds every rank (so on a ``(W, 1)`` mesh every call
is the default group's).  Ranks, counts and sources are coordinates on the
axis.  Every row or column movement of a round under a rank mesh goes
through this module:

* :func:`all_gather_rows` -- each rank's block of a row list, all blocks to
  every rank in row order (the per-row eval terms, the wire messages; a
  norm's per-leaf partials over the model axis);
* :func:`all_gather_cols` -- each model rank's column block, all blocks to
  every rank in column order (the new ``w`` every round);
* :func:`exchange_rows` -- an all-to-all of row counts known to every rank
  (residual rows to the rank that works on them and back, a fleet's
  sampled rows);
* :func:`broadcast` -- one rank's tensor to all (a scalar metric);
* the tensor-parallel layers' three (``models.transformer``,
  ``models.common``), each a ``torch.autograd.Function``:
  :func:`reduce_sum` ("g" in Megatron's terms: the sum over the axis's
  ranks, whose backward is the identity; after a row-parallel product),
  :func:`copy_in` ("f": the identity, whose backward is that sum; where a
  replicated activation enters a split region) and :func:`reduce_max`
  (the maximum, no gradient: the logsumexp's shift).  Each all-gathers the
  ranks' tensors and folds them in rank order, so every rank holds the
  same bits, added in one fixed order at any number of ranks; without the
  axis each is the identity.  One ``all_reduce`` would move less at four
  ranks (a ring's 1.5 copies of the tensor each way against the gather's
  3) and also hands every rank the same bits, but gloo's adds at four
  ranks in an order of its own, and under it the reduced smollm-360m's
  pallas-quant rounds on a ``(1, 4)`` mesh end their residual rows 12-32%
  of their norm from one process's, beyond the 5% that
  ``tests/test_torch_tensor_parallel.py`` holds and rank order meets (one
  step's gradient meets that file's law under either order: quant levels
  flipped at near-ties cascade over the rounds, more under some orders
  than others).

Gloo takes no 16-bit integer and no unsigned 32-bit type (``all_gather``
of a ``uint16``, ``int16`` or ``uint32`` tensor fails with "Invalid scalar
type"), and NCCL no 16-bit integer, so every tensor of the row and column
movements crosses ranks as ``uint8`` rows (``[rows, row bytes]``) and is
viewed back on arrival; the layers' float activations cross as they are.
Under gloo a CUDA tensor is staged through the host: copied out into
pinned memory, moved as a CPU tensor, copied back from pinned memory (the
caching host allocator keeps the pinned blocks for the next round).  NCCL
takes CUDA tensors as they are.

:func:`stats` counts what crossed since :func:`reset_stats`: the calls, the
bytes this rank sent to other ranks and received from them (padding
included; its own block not), the host seconds spent in this module (the
wait for the slowest rank included) and, of those, the seconds of the
staging copies; :func:`stats_by_axis` the same for each axis's group.
"""
from __future__ import annotations

import time

import torch

AXES = ("client", "model")
_ZERO = {"calls": 0, "bytes_out": 0, "bytes_in": 0, "seconds": 0.0,
         "stage_seconds": 0.0}
_STATS = {axis: dict(_ZERO) for axis in AXES}


def stats() -> dict:
    """The counters since the last :func:`reset_stats`, both axes
    together."""
    return {k: sum(_STATS[a][k] for a in AXES) for k in _ZERO}


def stats_by_axis() -> dict:
    """The counters since the last :func:`reset_stats`, per axis."""
    return {a: dict(_STATS[a]) for a in AXES}


def reset_stats() -> None:
    for a in AXES:
        _STATS[a].update(_ZERO)


def _dist():
    import torch.distributed as dist
    return dist


def _group(axis: str):
    """``axis``'s group (None: the default group), its size and this
    rank's coordinate in it."""
    from repro_torch.sharding import partition
    dist = _dist()
    group = partition.axis_group(axis)
    if group is None:
        return None, dist.get_world_size(), dist.get_rank()
    return group, dist.get_world_size(group), dist.get_rank(group)


def _global(group, src: int) -> int:
    """The default group's rank of coordinate ``src`` of ``group``."""
    return src if group is None else _dist().get_global_rank(group, src)


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


def _to_host(b: torch.Tensor, st: dict) -> torch.Tensor:
    """A CUDA ``uint8`` tensor copied into pinned host memory."""
    t0 = time.perf_counter()
    out = torch.empty(b.shape, dtype=torch.uint8, pin_memory=True).copy_(b)
    st["stage_seconds"] += time.perf_counter() - t0
    return out


def _from_bytes(b: torch.Tensor, like: torch.Tensor, device,
                st: dict) -> torch.Tensor:
    """Inverse of :func:`_as_bytes` for rows shaped like ``like``'s, moved
    to ``device``."""
    rows, tail = b.shape[0], tuple(like.shape[1:])
    if b.device != torch.device(device):
        t0 = time.perf_counter()
        b = b.to(device)
        st["stage_seconds"] += time.perf_counter() - t0
    if _row_elems(tail) == 0:
        return torch.empty((rows,) + tail, dtype=like.dtype, device=device)
    return b.view(like.dtype).reshape((rows,) + tail)


class _Timed:
    """One call's host seconds into the counters of its axis."""

    def __init__(self, axis: str):
        self.st = _STATS[axis]

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self.st

    def __exit__(self, *exc):
        self.st["seconds"] += time.perf_counter() - self.t0
        self.st["calls"] += 1


def all_gather_rows(x: torch.Tensor, counts, axis: str = "client"
                    ) -> torch.Tensor:
    """Every rank's block of a row list, in rank order: ``x`` is this
    rank's ``[counts[rank], ...]`` block, the result ``[sum(counts),
    ...]`` on ``x``'s device, the same on every rank of ``axis``.  Blocks
    are padded to the largest for the collective; where a block is empty,
    every rank takes rank 0's dtype."""
    dist = _dist()
    group, W, me = _group(axis)
    counts = [int(c) for c in counts]
    if x.shape[0] != counts[me]:
        raise ValueError(f"rank {me} holds {x.shape[0]} rows, its block "
                         f"has {counts[me]}")
    with _Timed(axis) as st:
        if 0 in counts and sum(counts):
            # a rank with no rows cannot know their dtype (the eval's
            # losses): rank 0, which holds the first and longest block,
            # says it
            dtype = [x.dtype]
            dist.broadcast_object_list(dtype, src=_global(group, 0),
                                       group=group)
            x = x.to(dtype[0])
        b = _as_bytes(x)
        top, B = max(counts), b.shape[1]
        if top == 0 or B == 0:
            return _from_bytes(torch.empty((sum(counts), B),
                                           dtype=torch.uint8), x, x.device,
                               st)
        if b.shape[0] < top:
            b = torch.cat([b, b.new_zeros((top - b.shape[0], B))])
        if _staged(b):
            b = _to_host(b, st)
        outs = [_buffer((top, B), b) for _ in range(W)]
        dist.all_gather(outs, b, group=group)
        full = torch.cat([o[:c] for o, c in zip(outs, counts)],
                         out=_buffer((sum(counts), B), b))
        st["bytes_out"] += top * B * (W - 1)
        st["bytes_in"] += top * B * (W - 1)
        return _from_bytes(full, x, x.device, st)


def all_gather_cols(x: torch.Tensor, widths, axis: str = "model"
                    ) -> torch.Tensor:
    """Every rank's block of columns, in rank order: ``x`` is this rank's
    ``[..., widths[rank]]`` block of the trailing axis, the result
    ``[..., sum(widths)]`` on ``x``'s device, the same on every rank of
    ``axis``.  The columns cross as the rows of the transposed block (a
    ``[d]`` vector's columns are its rows: no copy)."""
    lead = tuple(x.shape[:-1])
    flat = x.reshape(-1, x.shape[-1])
    rows = flat.reshape(-1, 1) if flat.shape[0] == 1 else \
        flat.T.contiguous()
    full = all_gather_rows(rows, widths, axis)
    return full.T.reshape(lead + (full.shape[0],)).contiguous()


def exchange_rows(x: torch.Tensor, send_counts, recv_counts,
                  axis: str = "client") -> torch.Tensor:
    """All-to-all of rows: ``x`` holds the rows this rank sends, grouped by
    destination rank in rank order (``send_counts[r]`` rows to rank r); the
    result holds the rows received, grouped by source rank in rank order
    (``recv_counts[r]`` from rank r), on ``x``'s device."""
    dist = _dist()
    group, _, me = _group(axis)
    send = [int(c) for c in send_counts]
    recv = [int(c) for c in recv_counts]
    with _Timed(axis) as st:
        b = _as_bytes(x)
        B = b.shape[1]
        if B == 0:
            return _from_bytes(torch.empty((sum(recv), 0),
                                           dtype=torch.uint8), x, x.device,
                               st)
        if _staged(b):
            b = _to_host(b, st)
        out = _buffer((sum(recv), B), b)
        dist.all_to_all_single(out, b, recv, send, group=group)
        st["bytes_out"] += (sum(send) - send[me]) * B
        st["bytes_in"] += (sum(recv) - recv[me]) * B
        return _from_bytes(out, x, x.device, st)


def broadcast(x: torch.Tensor, src: int = 0, axis: str = "client"
              ) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank of ``axis`` (a new tensor of
    ``x``'s shape, dtype and device)."""
    dist = _dist()
    group, W, me = _group(axis)
    with _Timed(axis) as st:
        b = _as_bytes(x.reshape(1, -1))
        b = _to_host(b, st) if _staged(b) else b.clone()
        dist.broadcast(b, _global(group, src), group=group)
        if me == src:
            st["bytes_out"] += b.numel() * (W - 1)
        else:
            st["bytes_in"] += b.numel()
        return _from_bytes(b, x.reshape(1, -1), x.device,
                           st).reshape(x.shape)


# ---------------------------------------------------------------------------
# The tensor-parallel layers' collectives
# ---------------------------------------------------------------------------

def _active(axis: str) -> bool:
    """Whether ``axis`` holds two or more ranks of an active rank mesh."""
    from repro_torch.sharding import partition
    ra = partition.model_axis() if axis == "model" else partition.rank_axis()
    return ra is not None


def _gathered(x: torch.Tensor, axis: str) -> list:
    """Every rank's ``x`` (same shape and dtype on every rank of
    ``axis``), in rank order, on ``x``'s device."""
    dist = _dist()
    group, W, _ = _group(axis)
    with _Timed(axis) as st:
        src = x.detach().contiguous()
        if _staged(src):
            t0 = time.perf_counter()
            src = torch.empty(src.shape, dtype=src.dtype,
                              pin_memory=True).copy_(src)
            st["stage_seconds"] += time.perf_counter() - t0
        outs = [torch.empty(src.shape, dtype=src.dtype, device=src.device,
                            pin_memory=src.is_pinned()) for _ in range(W)]
        dist.all_gather(outs, src, group=group)
        nbytes = src.numel() * src.element_size() * (W - 1)
        st["bytes_out"] += nbytes
        st["bytes_in"] += nbytes
        if src.device != x.device:
            t0 = time.perf_counter()
            outs = [o.to(x.device) for o in outs]
            st["stage_seconds"] += time.perf_counter() - t0
        return outs


def _fold(x: torch.Tensor, axis: str, op) -> torch.Tensor:
    outs = _gathered(x, axis)
    acc = outs[0]
    for o in outs[1:]:
        acc = op(acc, o)
    return acc


class _SumOver(torch.autograd.Function):
    """"g": the sum over the axis's ranks; the backward is the identity
    (the consumer is replicated, so each rank's term takes the whole
    gradient)."""

    @staticmethod
    def forward(ctx, x, axis):
        return _fold(x, axis, torch.add)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyIn(torch.autograd.Function):
    """"f": the identity; the backward sums the ranks' partial
    gradients."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _fold(grad, ctx.axis, torch.add), None


class _MaxOver(torch.autograd.Function):
    """The maximum over the axis's ranks, no gradient."""

    @staticmethod
    def forward(ctx, x, axis):
        out = _fold(x, axis, torch.maximum)
        ctx.mark_non_differentiable(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return None, None


def reduce_sum(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """"g": the sum of every rank's ``x`` over ``axis`` (added in rank
    order, the same bits on every rank); its backward is the identity.
    Without the axis, ``x`` itself."""
    return _SumOver.apply(x, axis) if _active(axis) else x


def copy_in(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """"f": ``x`` itself; its backward sums the gradient over ``axis``.
    Without the axis, ``x`` itself."""
    return _CopyIn.apply(x, axis) if _active(axis) else x


def reduce_max(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """The elementwise maximum of every rank's ``x`` over ``axis``, with no
    gradient.  Without the axis, ``x`` detached."""
    return _MaxOver.apply(x, axis) if _active(axis) else x.detach()
