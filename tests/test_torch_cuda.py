"""Card tests: each CUDA kernel against its plain PyTorch version on the
card, at small shapes, and one reduced round on the card against the same
round on the CPU.  Marked ``cuda``; without a card they skip (decided in a
fixture, never at import).  Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: top-k values/indices, words, scales and the EF residual are
bit-equal (the kernels pin every rounding; built with -fmad=false);
``unpack_mma`` sums clients in the same order as its plain version, so it is
bit-equal too; ``scatter_agg`` adds duplicate offsets of one client by
shared-memory atomics, so it is allclose at rtol 1e-6.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.comm import payloads
from repro_torch.kernels.quantize_ef_pack import (quantize_ef_pack,
                                                  quantize_ef_pack_plain)
from repro_torch.kernels.scatter_agg import scatter_agg, scatter_agg_plain
from repro_torch.kernels.topk_block import block_topk, block_topk_plain
from repro_torch.kernels.unpack_mma import unpack_mma, unpack_mma_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _same(a, b):
    if a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("block,k", [(42, 4), (126, 13), (320, 32),
                                     (640, 64), (960, 96)])
def test_block_topk_kernel(dev, block, k):
    g = torch.Generator(device=dev).manual_seed(block)
    x = torch.randn((3, 5, block), generator=g, device=dev)
    x[0, 0] = 0.0
    x[0, 1] = torch.round(x[0, 1] * 2) / 2
    kernels.reset_launches()
    got = block_topk(x, k)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["block_topk"] == 1
    for a, b in zip(got, block_topk_plain(x, k)):
        _same(a, b)


@pytest.mark.parametrize("block", [42, 126, 640, 960])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_ef_pack_kernel(dev, block, bits):
    g = torch.Generator(device=dev).manual_seed(block + bits)
    e = torch.randn((2, 4, block), generator=g, device=dev) * 0.1
    d = torch.randn((2, 4, block), generator=g, device=dev)
    e[0, 0] = 0.0
    d[0, 0] = 0.0
    got = quantize_ef_pack(e, d, bits)
    torch.cuda.synchronize()
    for a, b in zip(got, quantize_ef_pack_plain(e, d, bits)):
        _same(a, b)


@pytest.mark.parametrize("block", [42, 126, 640, 960])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_unpack_mma_kernel(dev, block, bits):
    L = 2 ** (bits - 1) - 1
    rng = np.random.default_rng(block * bits)
    codes = torch.from_numpy(rng.integers(-L, L + 1, size=(3, 4, block)))
    words = payloads.pack_codes(codes, bits).to(dev)
    scale = torch.rand((3, 4), device=dev)
    weight = torch.tensor([1.0, 0.0, 0.5], device=dev)
    got = unpack_mma(words, scale, weight, bits, block)
    torch.cuda.synchronize()
    _same(got, unpack_mma_plain(words, scale, weight, bits, block))


@pytest.mark.parametrize("block,k", [(42, 4), (640, 64), (960, 96)])
def test_scatter_agg_kernel(dev, block, k):
    rng = np.random.default_rng(block)
    vals = torch.from_numpy(
        rng.standard_normal((3, 5, k)).astype(np.float32)).to(dev)
    idx = payloads.to_u16(torch.from_numpy(
        rng.integers(0, block, size=(3, 5, k)))).to(dev)
    weight = torch.tensor([1.0, 0.25, 0.0], device=dev)
    got = scatter_agg(vals, idx, weight, block)
    torch.cuda.synchronize()
    want = scatter_agg_plain(vals, idx, weight, block)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("uplink", ["topk", "quant"])
def test_reduced_round_launches_its_kernels(dev, uplink):
    """A reduced round on the card launches its uplink's two kernels once
    per wire run and no other.  (``chip_smoke.py`` phase 4 holds the same
    round's values against the CPU.)"""
    from repro_torch.engine import rounds
    from repro_torch.launch import train
    args = train.parser().parse_args(["--reduced", "--seq", "16",
                                      "--uplink", uplink])
    state, batch_fn, loss_pair, fed, _, _ = train.setup(args)
    batches = batch_fn(0, torch.Generator(device=dev).manual_seed(0))
    kernels.reset_launches()
    rounds.round_step(state, batches, loss_pair, fed, device=dev)
    torch.cuda.synchronize()
    used = ("block_topk", "scatter_agg") if uplink == "topk" else \
        ("quantize_ef_pack", "unpack_mma")
    n_runs = len(rounds.flat_transports_for(fed, state.spec)[0]
                 .codec.layout.runs)
    assert kernels.launch_counts() == {
        name: n_runs if name in used else 0 for name in kernels.WRAPPERS}
