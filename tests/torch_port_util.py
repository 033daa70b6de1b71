"""Helpers shared by the ``test_torch_*`` files: numpy in, both out."""
from __future__ import annotations

import numpy as np
import pytest
import torch


@pytest.fixture
def one_thread():
    """Run the test on one intra-op thread and restore the old count after.
    Small shapes gain nothing from more threads, and uncapped ones contend
    for the cores with the other test workers, whose timing-bound tests
    (heartbeats, deadlines) can then miss."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(x, dtype=None) -> torch.Tensor:
    """numpy -> CPU tensor (a copy)."""
    out = torch.from_numpy(np.array(x, copy=True))
    return out if dtype is None else out.to(dtype)


def n(x) -> np.ndarray:
    """JAX array or tensor -> numpy (a bf16 tensor as float32, exactly:
    numpy has no bf16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_bits_equal(a, b) -> None:
    """Bit-for-bit equality (``-0.0 != +0.0`` here); None equals only
    None (an absent metric, e.g. ``RoundMetrics.telemetry`` with obs
    off)."""
    if a is None or b is None:
        assert a is None and b is None, (a, b)
        return
    a, b = n(a), n(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.dtype.itemsize == b.dtype.itemsize, (a.dtype, b.dtype)
    view = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
    bad = a.view(view[a.dtype.itemsize]) != b.view(view[b.dtype.itemsize])
    assert not bad.any(), f"{int(bad.sum())} of {bad.size} differ"


def assert_within_ulp(a, b, ulps: int = 1, of=None) -> None:
    """float32 arrays equal to within ``ulps`` units in the last place of
    ``max(|a|, |b|)``, or of ``|of|`` when given (for a difference such as
    ``buf - v``, whose rounding error is an ulp of ``buf``, not of the
    result)."""
    a = n(a).astype(np.float32)
    b = n(b).astype(np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    big = np.maximum(np.abs(a), np.abs(b)) if of is None else \
        np.abs(n(of).astype(np.float32))
    tol = ulps * np.spacing(big).astype(np.float64)
    diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
    bad = diff > tol
    assert not bad.any(), f"{int(bad.sum())} of {bad.size} beyond {ulps} ulp"
