"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (port of ``repro.kernels``).

* ``topk_block.block_topk`` (``csrc/topk_block.cu``) replaces the Pallas
  kernel at ``repro/kernels/topk_block.py:49``,
* ``scatter_agg.scatter_agg`` (``csrc/scatter_agg.cu``) replaces
  ``repro/kernels/scatter_agg.py:74``,
* ``quantize_ef_pack.quantize_ef_pack`` (``csrc/quantize_ef_pack.cu``)
  replaces ``repro/kernels/quantize_ef_pack.py:70``,
* ``unpack_mma.unpack_mma`` (``csrc/unpack_mma.cu``) replaces
  ``repro/kernels/unpack_mma.py:59``,
* ``scatter_agg.segment_rows`` (``csrc/segment_rows.cu``) replaces
  ``repro/kernels/scatter_agg.py:116``,
* ``quantize_ef.quantize_ef`` (``csrc/quantize_ef.cu``) replaces
  ``repro/kernels/quantize_ef.py:39``,
* ``switch_blend.switch_blend`` (``csrc/switch_blend.cu``) replaces
  ``repro/kernels/switch_blend.py:34``.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises, and adds one to its ``launches`` count.
"""
from __future__ import annotations

from repro_torch.kernels import (quantize_ef, quantize_ef_pack, scatter_agg,
                                 switch_blend, topk_block, unpack_mma)

WRAPPERS = {"block_topk": topk_block.block_topk,
            "scatter_agg": scatter_agg.scatter_agg,
            "quantize_ef_pack": quantize_ef_pack.quantize_ef_pack,
            "unpack_mma": unpack_mma.unpack_mma,
            "segment_rows": scatter_agg.segment_rows,
            "quantize_ef": quantize_ef.quantize_ef,
            "switch_blend": switch_blend.switch_blend}


def launch_counts() -> dict:
    """``{kernel name: launches since the last reset}``."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
