"""Roofline terms of a case on the NVIDIA H100 (port of
``repro.launch.roofline``, whose constants are a TPU's).

  compute term    = FLOPs / peak FLOP/s of the dtype the case computes in
  memory term     = bytes / HBM bandwidth
  collective term = collective bytes / NVLink bandwidth

One table of the card's constants, from NVIDIA's H100 datasheet (SXM5
part, dense rates, at the 700 W power limit).  The reference's terms are
per device, from XLA's compiled, partitioned program (``cost_summary``,
``memory_summary``, ``collective_bytes`` over the HLO text).  The port has
no compiled artefact: the dry run (``launch/dryrun.py``) counts a case's
FLOPs with ``torch.utils.flop_counter`` over the case run on ``meta``
tensors, and its bytes from the inputs' and outputs' shapes, dtypes and
specs.  With no collective in the program, the collective term is None.
"""
from __future__ import annotations

from typing import Dict, Optional

# NVIDIA H100 SXM5 (datasheet): HBM3 bandwidth, dense peaks, NVLink 4
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12           # float32 outside the tensor cores: what
                                # the port runs (TF32 off)
BF16_OPS_PER_S = 989e12         # bf16 tensor cores, dense
NVLINK_BYTES_PER_S = 900e9      # per GPU, all links
PEAK_OPS_PER_S = {"float32": F32_OPS_PER_S, "bfloat16": BF16_OPS_PER_S}

NO_COLLECTIVES = ("the port has no compiled program to read collectives "
                  "from: one process holds whole tensors")


def corrected_collective_bytes(coll: Dict[str, int], trips: int) -> int:
    """The total with loop-body collectives multiplied by the trip count
    (the reference's correction of its HLO tally)."""
    outside = coll["total"] - coll.get("in_loop", 0)
    return int(outside + coll.get("in_loop", 0) * max(trips, 1))


def roofline_terms(flops: float, hbm_bytes: float,
                   coll_bytes: Optional[float], chips: int,
                   dtype: str = "float32") -> Dict[str, object]:
    """All three terms in seconds (per device: ``flops`` and the bytes
    are one device's share, so ``chips`` is already folded in, as in the
    reference) and the dominant one; ``coll_bytes`` None gives a None
    collective term."""
    t_compute = flops / PEAK_OPS_PER_S[dtype]
    t_memory = hbm_bytes / HBM_BYTES_PER_S
    t_coll = None if coll_bytes is None else coll_bytes / NVLINK_BYTES_PER_S
    terms = [("compute", t_compute), ("memory", t_memory)]
    if t_coll is not None:
        terms.append(("collective", t_coll))
    dom = max(terms, key=lambda kv: kv[1])[0]
    return {"compute_s": t_compute, "memory_s": t_memory,
            "collective_s": t_coll, "dominant": dom,
            "peak_ops_per_s": PEAK_OPS_PER_S[dtype],
            "hbm_bytes_per_s": HBM_BYTES_PER_S}


def model_flops(cfg, n_tokens: int) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE); train fwd+bwd."""
    return 6.0 * cfg.n_active_params() * n_tokens


def model_flops_forward(cfg, n_tokens: int) -> float:
    return 2.0 * cfg.n_active_params() * n_tokens
