"""PyTorch/CUDA port of the FedSGM reproduction (``repro``), laid out module
for module like the JAX package, which stays the reference.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise (:func:`resolve_device`).  On CUDA tensors the
wire kernels are the hand-written Hopper kernels of
:mod:`repro_torch.kernels`; on CPU tensors their plain PyTorch versions.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  ``cuda`` needs a card -- there is
    no quiet switch to the CPU -- and turns TF32 off for matmuls and
    convolutions, since the reference math is full float32.  ``meta`` (for
    the dry run, ``launch/dryrun.py``, only) computes shapes and no
    values."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}: cuda, cpu or "
                         "meta")
    return dev
