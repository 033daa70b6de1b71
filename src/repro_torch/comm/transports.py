"""Transport capability flags and stacked-client helpers (port of the part
of ``repro.comm.transports`` the flat engine needs: the flags,
``masked_mean``, ``mask_where`` and ``scatter_rows``).

A :class:`Transport` names one direction's compressor (``kind``) and wire
backend; the flat engine's :class:`repro_torch.comm.flat.FlatTransport`
carries the math.  Ported kinds: ``none``, ``topk``, ``quant``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import CompressorConfig
from repro_torch.kernels import ops

BACKENDS = ("ref", "packed", "pallas")
_COMM_TO_BACKEND = {"dense": "ref", "packed": "packed", "pallas": "pallas"}
KINDS = ("none", "topk", "quant")


def backend_for(comm: str) -> str:
    """Map a ``FedConfig.comm`` mode to a transport backend name."""
    try:
        return _COMM_TO_BACKEND[comm]
    except KeyError:
        raise ValueError(f"unknown comm mode {comm!r}; expected one of "
                         f"{sorted(_COMM_TO_BACKEND)}") from None


def masked_mean(x: torch.Tensor, mask: torch.Tensor, m) -> torch.Tensor:
    """Weighted mean over the leading client axis of ``[n, ...]``:
    ``sum_j mask_j * x_j / m``."""
    return torch.tensordot(mask.to(x.dtype), x, dims=([0], [0])) / m


def mask_where(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Per-client row select on ``[n, ...]``: rows with ``mask > 0`` take
    ``new``, the rest keep ``old``.  ``out=old`` selects in place."""
    m = mask.reshape((mask.shape[0],) + (1,) * (new.dim() - 1))
    return torch.where(m > 0, new, old, out=out)


# unsigned wire dtypes -> the same-width signed views that CUDA's copy, cat
# and index kernels take
SIGNED_VIEWS = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def scatter_rows(tree, idx: torch.Tensor, n: int, unique: bool = True):
    """``[m, ...]`` participant rows -> the full ``[n, ...]`` layout, zeros
    elsewhere.  ``tree`` is a tensor or a payload NamedTuple (every field
    carries the leading client axis).

    Float fields of a cohort with unique ids go through the segment-sum
    kernel (:func:`repro_torch.kernels.ops.segment_rows`), as the
    reference's TPU plan does.  Integer fields (uint16 offsets, uint32
    words) are copied bit for bit by ``index_copy_``, the reference's
    ``.at[idx].set``; so are float fields when ``unique`` is False (a short
    cohort whose padded ids repeat a row: any write wins, where a segment
    sum would double it)."""
    if not isinstance(tree, torch.Tensor):
        return type(tree)(*(scatter_rows(x, idx, n, unique) for x in tree))
    if tree.dtype.is_floating_point and unique:
        return ops.segment_rows(tree, idx, n)
    signed = SIGNED_VIEWS.get(tree.dtype)
    rows = tree if signed is None else tree.view(signed)
    out = rows.new_zeros((n,) + tuple(rows.shape[1:]))
    out.index_copy_(0, idx, rows)
    return out if signed is None else out.view(tree.dtype)


class Transport:
    """One direction's compressor kind and backend, with its capability
    flags."""

    def __init__(self, cfg: CompressorConfig, backend: str = "ref"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected "
                             f"{BACKENDS}")
        if cfg.kind not in KINDS:
            raise NotImplementedError(
                f"compressor kind {cfg.kind!r} is not ported yet; ported: "
                f"{KINDS}")
        self.cfg = cfg
        self.kind = cfg.kind
        self.backend = backend

    @property
    def is_identity(self) -> bool:
        return self.kind == "none"

    @property
    def needs_residual(self) -> bool:
        """Uplink EF14 residual state exists only under real compression."""
        return not self.is_identity

    @property
    def tracks_center(self) -> bool:
        """Downlink EF21 stores the server center x separately from w."""
        return not self.is_identity

    @property
    def needs_key(self) -> bool:
        return False            # no stochastic kind is ported yet


def get_transport(cfg: CompressorConfig, backend: str = "ref") -> Transport:
    return Transport(cfg, backend)
