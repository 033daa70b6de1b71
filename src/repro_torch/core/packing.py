"""Deprecated shim (port of ``repro.core.packing``): the packed-payload wire
formats live in :mod:`repro_torch.comm.payloads`; this module re-exports
their old names for existing callers.  The reference's ``packed_bytes`` has
no counterpart in the port's payload module and is not re-exported."""
from __future__ import annotations

from repro_torch.comm.payloads import (  # noqa: F401
    PackedLeaf,
    _SORT_FREE_MIN,
    _block_threshold,
    block_geometry,
    block_randk_pack,
    block_topk_dense,
    block_topk_pack,
    block_topk_unpack,
    choose_block,
    pack_tree,
    quant_pack,
    quant_unpack,
    unpack_tree,
)
