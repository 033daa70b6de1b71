"""The aggregation kernels the flat codecs reduce with (port of
``repro.kernels.ops``).  The reference picks an implementation per shape
through its tuner; the port has one implementation per kernel (the CUDA
kernel of the TPU plan, ``tune.py:83-84``, with the plain version on CPU
tensors), so this module only names the wrappers."""
from __future__ import annotations

from repro_torch.kernels.scatter_agg import scatter_agg  # noqa: F401
from repro_torch.kernels.unpack_mma import unpack_mma as quant_agg  # noqa: F401
