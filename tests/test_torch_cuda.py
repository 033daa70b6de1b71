"""Card tests: each CUDA kernel against its plain PyTorch version on the
card, at small shapes, reduced rounds on the card against the same rounds
on the CPU (async rounds among them), and the launcher's async and obs
flags on the card.  Marked ``cuda``; without a card they skip (decided in a
fixture, never at import).  Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: top-k values/indices, words, scales and the EF residual are
bit-equal (the kernels pin every rounding; built with -fmad=false);
``unpack_mma`` sums clients in the same order as its plain version, so it is
bit-equal too; ``scatter_agg`` adds in slot order, duplicate offsets
included, as the plain version's ``index_add_`` does on the CPU, so it is
bit-equal to the plain version run on the CPU.  ``segment_rows``
adds rows in order (duplicates included), ``quantize_ef`` pins every
rounding and ``switch_blend`` rounds each step on its own, so all three
are bit-equal to their plain versions.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.comm import payloads
from repro_torch.kernels import ops
from repro_torch.kernels.quantize_ef import quantize_ef
from repro_torch.kernels.quantize_ef_pack import (quantize_ef_pack,
                                                  quantize_ef_pack_plain)
from repro_torch.kernels.ref import quantize_ef_ref
from repro_torch.kernels.scatter_agg import (scatter_agg, scatter_agg_plain,
                                             segment_rows, segment_rows_plain)
from repro_torch.kernels.switch_blend import switch_blend, switch_blend_plain
from repro_torch.kernels import topk_block
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


# (block, k): the reduced and full layouts' shapes (radix select), k = 1,
# k = block, the radix variant's largest shape, and shapes past it (bitonic)
TOPK_CARD_SHAPES = [(42, 4), (126, 13), (320, 32), (640, 64), (960, 96),
                    (960, 1), (128, 128), (1024, 128), (300, 300),
                    (1500, 150)]


def _topk_rows(x):
    """Special rows in place: zeros, magnitude ties in groups, all-equal
    magnitudes, NaNs of two payloads (the lower payload at the lower
    index) beside +-inf and +-0, and magnitudes spread over many
    binades."""
    block = x.shape[-1]
    x[0, 0] = 0.0
    x[0, 1] = torch.round(x[0, 1] * 2) / 2
    x[0, 2] = 1.5
    x[0, 2, ::3] = -1.5
    row = x[0, 3]
    row.view(torch.int32)[block // 3] = 0x7FC00000
    row.view(torch.int32)[block // 2] = 0x7FC00001
    row.view(torch.int32)[1] = 0xFFC1FFFF - 2 ** 32   # a -NaN
    row[2], row[block - 1] = float("inf"), float("-inf")
    row[3], row[4] = -0.0, 0.0
    # magnitudes over many binades: T's exponent far below the row's top
    x[0, 4] = x[0, 4] * torch.pow(10.0, x[1, 4] * 8)


def _check_topk(x, k):
    kernels.reset_launches()
    got = block_topk(x, k)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["block_topk"] == 1
    for a, b in zip(got, block_topk_plain(x, k)):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        _same(a, b)


@pytest.mark.parametrize("block,k", TOPK_CARD_SHAPES)
def test_block_topk_kernel(dev, block, k):
    g = torch.Generator(device=dev).manual_seed(block)
    x = torch.randn((3, 5, block), generator=g, device=dev)
    _topk_rows(x)
    want = "bitonic" if block > 1024 or k > 128 else \
        "radix-vec4" if block % 4 == 0 else "radix-scalar"
    assert topk_block.variant(x, k) == want
    _check_topk(x, k)


def test_block_topk_kernel_nan_payload_order(dev):
    """NaNs tie with each other whatever their payload (index order, ahead
    of +-inf), in each variant: a key built from the payload bits puts
    0x7FC00001 at index 9 ahead of 0x7FC00000 at index 3."""
    for block, k in [(16, 5), (42, 5), (1100, 5), (200, 190)]:
        x = torch.randn((2, 2, block), device=dev)
        x[:, :, 3].view(torch.int32).fill_(0x7FC00000)
        x[:, :, 9].view(torch.int32).fill_(0x7FC00001)
        x[:, :, 5], x[:, :, 12] = float("inf"), float("-inf")
        _check_topk(x, k)
        assert block_topk(x, k)[1][0, 0, :4].tolist() == [3, 9, 5, 12]


@pytest.mark.parametrize("offset", [0, 1, 2, 4])
def test_block_topk_kernel_run_views(dev, offset):
    """Run views of an ``[n, d]`` buffer: a row start that is not 16-byte
    aligned takes scalar loads; the ``[1, nb, block]`` downlink shape and
    a 2-D ``[nb, block]`` view run as well."""
    g = torch.Generator(device=dev).manual_seed(offset)
    buf = torch.randn((3, 7 * 960 + 8), generator=g, device=dev)
    view = buf[:, offset:offset + 7 * 960].reshape(3, 7, 960)
    _topk_rows(view)
    assert topk_block.variant(view, 96) == (
        "radix-vec4" if offset % 4 == 0 else "radix-scalar")
    _check_topk(view, 96)
    _check_topk(view[:1], 96)
    _check_topk(view[1], 96)
    _check_topk(buf[:1, offset:offset + 5 * 640].reshape(1, 5, 640), 64)


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


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("block,k", [(42, 4), (640, 64), (960, 96),
                                     (100, 300)])
def test_scatter_agg_kernel(dev, n, block, k):
    """Duplicate offsets (inside one client's row, and a row of one offset)
    and offsets >= block (dropped), on strided views; bit-equal to the
    plain version on the CPU, which adds in slot order."""
    rng = np.random.default_rng(block + n)
    vals = rng.standard_normal((n, 5, k + 3)).astype(np.float32)
    idx = rng.integers(0, block + 20, size=(n, 5, k + 3)).astype(np.uint16)
    idx[0, 0, :] = idx[0, 0, 0] % block
    idx[-1, 1, : k // 2] = idx[-1, 1, k // 2: 2 * (k // 2)]
    idx[:, 2, 0] = 65535
    weight = rng.random(n).astype(np.float32)
    weight[-1] = 0.25
    # run views of wider device buffers: a free leading stride, the inner
    # [nb, k] contiguous
    vd = torch.from_numpy(vals.reshape(n, -1)).to(dev)[:, 3:3 + 5 * k]
    id_ = payloads.to_u16(torch.from_numpy(idx.astype(np.int64))
                          .reshape(n, -1).to(dev))[:, 1:1 + 5 * k]
    vd, id_ = vd.reshape(n, 5, k), id_.reshape(n, 5, k)
    assert n == 1 or not (vd.is_contiguous() or id_.is_contiguous())
    wd = torch.from_numpy(weight).to(dev)
    want = scatter_agg_plain(vd.cpu(), id_.cpu(), wd.cpu(), block)
    kernels.reset_launches()
    got = scatter_agg(vd, id_, wd, block)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["scatter_agg"] == 1
    _same(got.view(torch.int32), want.view(torch.int32))
    got = scatter_agg(vd.contiguous(), id_.contiguous(), wd, block)
    _same(got.view(torch.int32), want.view(torch.int32))


# (n, D, ids): unique, duplicate, negative and >= n ids; ragged D
@pytest.mark.parametrize("n,D,ids", [(8, 1000, [1, 4, 6, 7]),
                                     (4, 1025, [3, 3, 0, 3]),
                                     (6, 37, [-1, 2, 6, 9, 2]),
                                     (3, 5000, [2])])
def test_segment_rows_kernel(dev, n, D, ids):
    g = torch.Generator(device=dev).manual_seed(D)
    rows = torch.randn((len(ids), D), generator=g, device=dev)
    seg = torch.tensor(ids, device=dev)
    kernels.reset_launches()
    got = segment_rows(rows, seg, n)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["segment_rows"] == 1
    _same(got, segment_rows_plain(rows, seg, n))
    # a strided view of a wider buffer (free leading stride)
    wide = torch.randn((len(ids), D + 3), generator=g, device=dev)
    _same(segment_rows(wide[:, 3:], seg, n),
          segment_rows_plain(wide[:, 3:], seg, n))


@pytest.mark.parametrize("block", [42, 126, 1024, 4000])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_ef_kernel(dev, block, bits):
    g = torch.Generator(device=dev).manual_seed(block + bits)
    e = torch.randn((5, block), generator=g, device=dev) * 0.1
    d = torch.randn((5, block), generator=g, device=dev)
    e[0] = 0.0
    d[0] = 0.0
    d[1] = torch.round(d[1] * 4) / 4
    e[1] = 0.0
    got = quantize_ef(e, d, bits)
    torch.cuda.synchronize()
    for a, b in zip(got, quantize_ef_ref(e, d, bits)):
        _same(a, b)
    v, e_new = ops.quantize_ef_apply(e[:, :37], d[:, :37], bits, block=64)
    for a, b in zip((v, e_new), quantize_ef_ref(
            torch.cat([e[:, :37].reshape(-1), torch.zeros(7, device=dev)])
            .reshape(3, 64),
            torch.cat([d[:, :37].reshape(-1), torch.zeros(7, device=dev)])
            .reshape(3, 64), bits)):
        _same(a, b.reshape(-1)[:185].reshape(5, 37))


@pytest.mark.parametrize("d", [1, 7, 4096, 100_003])
@pytest.mark.parametrize("sigma", [0.0, 0.3, 1.0])
def test_switch_blend_kernel(dev, d, sigma):
    g = torch.Generator(device=dev).manual_seed(d)
    gf = torch.randn(d + 1, generator=g, device=dev)
    gg = torch.randn(d, generator=g, device=dev)
    s = torch.tensor(sigma, device=dev)
    _same(switch_blend(gf[:d], gg, s), switch_blend_plain(gf[:d], gg, s))
    # a misaligned start takes the scalar loop
    _same(switch_blend(gf[1:], gg, s), switch_blend_plain(gf[1:], gg, s))
    tree = ops.switch_blend_tree({"a": gf[:d].reshape(1, d)},
                                 {"a": gg.reshape(1, d)}, s)
    _same(tree["a"], switch_blend_plain(gf[:d], gg, s).reshape(1, d))


@pytest.mark.parametrize("uplink", ["topk", "quant"])
def test_reduced_gather_round_launches_its_kernels(dev, uplink):
    """A reduced gather round (2 of 4 clients) with the same compressor up
    and down launches the encode kernel once per wire run in each
    direction, the reduce kernel once per run, and ``segment_rows`` twice
    (the float payload field and the ``delta_norm`` deltas)."""
    from repro_torch.engine import rounds
    from repro_torch.launch import train
    args = train.parser().parse_args(
        ["--reduced", "--seq", "16", "--clients", "4", "--participating",
         "2", "--participation", "gather", "--comm", "pallas", "--uplink",
         uplink])
    state, batch_fn, loss_pair, fed, _, _ = train.setup(args)
    # the compressed downlink's center starts at w, as init_state sets it
    fed = fed.replace(downlink=fed.uplink)
    state = state._replace(x=state.w)
    batches = batch_fn(0, torch.Generator().manual_seed(0))
    kernels.reset_launches()
    rounds.round_step(state, batches, loss_pair, fed, device=dev)
    torch.cuda.synchronize()
    enc, red = ("block_topk", "scatter_agg") if uplink == "topk" else \
        ("quantize_ef_pack", "unpack_mma")
    n_runs = len(rounds.flat_transports_for(fed, state.spec)[0]
                 .codec.layout.runs)
    want = {name: 0 for name in kernels.WRAPPERS}
    want.update({enc: 2 * n_runs, red: n_runs, "segment_rows": 2})
    assert kernels.launch_counts() == want


@pytest.mark.parametrize("kind", ["topk", "quant"])
def test_reduced_gather_equals_mask_on_card(dev, kind):
    """Two reduced rounds, 2 of 4 clients replayed through the ``fixed``
    sampler, compressed up and down: gather and mask bit-equal on the card
    (``chip_smoke.py`` phase 6 repeats this at full width)."""
    from repro_torch import configs
    from repro_torch.configs.base import (CompressorConfig, FedConfig,
                                          FleetConfig, SwitchConfig)
    from repro_torch.engine import rounds
    from repro_torch.fleet import samplers
    from repro_torch.models import build
    from repro_torch.tasks import lm
    cfg = configs.get_reduced("smollm-360m")
    fns = build(cfg)
    pair = lm.make_loss_pair(fns.forward, cfg, budget=6.0)
    masks = np.array([[1, 0, 1, 0], [0, 1, 1, 0]], np.float32)
    rng = np.random.default_rng(0)
    batches = [lm.LMBatch(
        torch.from_numpy(rng.integers(0, cfg.vocab, (4, 2, 16))).to(dev),
        torch.ones((4, 2, 16), device=dev)) for _ in range(2)]
    cc = CompressorConfig(kind=kind, ratio=0.1, bits=8)
    out = {}
    for mode in ("gather", "mask"):
        fed = FedConfig(n_clients=4, m=2, lr=0.03, uplink=cc, downlink=cc,
                        switch=SwitchConfig(mode="soft", eps=0.0, beta=2.0),
                        comm="pallas", participation=mode,
                        fleet=FleetConfig(sampler="fixed"))
        state = rounds.init_state(
            fns.init(torch.Generator(device=dev).manual_seed(0), cfg,
                     device=dev), fed, device=dev)
        state = state._replace(sampler=samplers.fixed_state(masks, masks))
        mets = []
        for b in batches:
            state, met = rounds.round_step(state, b, pair, fed, device=dev)
            mets.append(met)
        out[mode] = (state, mets)
    (sg, mg), (sm, mm) = out["gather"], out["mask"]
    for name in ("w", "x", "e_up", "wbar_sum"):
        _same(getattr(sg, name).view(torch.int32),
              getattr(sm, name).view(torch.int32))
    for a, b in zip(mg, mm):
        for name in rounds.RoundMetrics._fields:
            if getattr(a, name) is None:     # telemetry, obs off
                assert getattr(b, name) is None
                continue
            _same(getattr(a, name).view(torch.int32),
                  getattr(b, name).view(torch.int32))


@pytest.mark.parametrize("uplink", ["topk", "quant"])
def test_reduced_round_launches_its_kernels(dev, uplink):
    """A reduced round on the card launches its uplink's two kernels once
    per wire run and no other.  (``chip_smoke.py`` phase 4 holds the same
    round's values against the CPU.)"""
    from repro_torch.engine import rounds
    from repro_torch.launch import train
    args = train.parser().parse_args(["--reduced", "--seq", "16",
                                      "--comm", "pallas", "--uplink", uplink])
    state, batch_fn, loss_pair, fed, _, _ = train.setup(args)
    batches = batch_fn(0, torch.Generator().manual_seed(0))
    kernels.reset_launches()
    rounds.round_step(state, batches, loss_pair, fed, device=dev)
    torch.cuda.synchronize()
    used = ("block_topk", "scatter_agg") if uplink == "topk" else \
        ("quantize_ef_pack", "unpack_mma")
    n_runs = len(rounds.flat_transports_for(fed, state.spec)[0]
                 .codec.layout.runs)
    assert kernels.launch_counts() == {
        name: n_runs if name in used else 0 for name in kernels.WRAPPERS}


def test_ops_dispatchers_launch_the_kernels(dev):
    """``ops.scatter_agg`` and ``ops.quant_agg`` on CUDA tensors launch the
    ``scatter_agg`` and ``unpack_mma`` kernels (bit-equal to the plain
    versions on the CPU); a block of 1 is a weighted sum, no launch."""
    g = torch.Generator().manual_seed(5)
    vals = torch.randn((3, 10, 6), generator=g)
    idx = payloads.to_u16(torch.randint(0, 64, (3, 10, 6), generator=g))
    w = torch.tensor([1.0, 0.0, 0.5])
    words, scale, _ = quantize_ef_pack_plain(torch.zeros(3, 10, 64),
                                             torch.randn((3, 10, 64),
                                                         generator=g), 8)
    kernels.reset_launches()
    got = ops.scatter_agg(vals.to(dev), idx.to(dev), w.to(dev), 64)
    _same(got, ops.scatter_agg(vals, idx, w, 64))
    got = ops.quant_agg(words.to(dev), scale[..., 0].to(dev), w.to(dev), 8,
                        64)
    _same(got, ops.quant_agg(words, scale[..., 0], w, 8, 64))
    ops.scatter_agg(vals[..., :1].to(dev), idx[..., :1].to(dev), w.to(dev),
                    1)
    counts = kernels.launch_counts()
    assert counts["scatter_agg"] == 1 and counts["unpack_mma"] == 1
    assert sum(counts.values()) == 2


def _reduced_round(dev, argv, downlink=True, **over):
    """One reduced round (4 clients, seq 16) through the launcher's setup on
    ``dev``, the uplink's compressor changed by ``over`` and, with
    ``downlink``, on the downlink too; from the same weights and batches
    on every device.  Returns the new state and the metrics."""
    import dataclasses
    from repro_torch.comm import flat
    from repro_torch.engine import rounds
    from repro_torch.launch import train
    from repro_torch.tasks import lm
    args = train.parser().parse_args(
        ["--reduced", "--seq", "16", "--device", "cpu"] + argv)
    state, _, pair, fed, cfg, _ = train.setup(args)
    cc = dataclasses.replace(fed.uplink, **{k: v for k, v in over.items()
                                            if k in ("kind", "bits")})
    fed = fed.replace(uplink=cc, downlink=cc if downlink else fed.downlink,
                      **{k: v for k, v in over.items()
                         if k not in ("kind", "bits")})
    state = rounds.init_state(flat.unflatten(state.spec, state.w.to(dev)),
                              fed, device=dev)
    rng = np.random.default_rng(0)
    nc = fed.n_clients
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (nc, 2, 16)))
    mask = torch.zeros((nc, 2, 16))
    mask[..., -2:] = 1.0
    kernels.reset_launches()
    new, met = rounds.round_step(state, lm.LMBatch(toks.to(dev),
                                                   mask.to(dev)),
                                 pair, fed, device=dev)
    return new, met, fed


# (launcher arguments, compressor / FedConfig changes, launches per round
# as multiples of the wire runs, segment_rows launches)
WIRE_ROUNDS = {
    "dense-topk": (["--uplink", "topk"], {}, {}, 0),
    "dense-quant": (["--uplink", "quant"], {}, {}, 0),
    "packed-topk": (["--comm", "packed", "--uplink", "topk"], {},
                    {"scatter_agg": 1}, 0),
    "packed-quant": (["--comm", "packed", "--uplink", "quant"], {},
                     {"unpack_mma": 1}, 0),
    "packed-quant6": (["--comm", "packed", "--uplink", "quant"],
                      {"bits": 6}, {}, 0),
    "packed-topk-gather-sparse": (
        ["--comm", "packed", "--uplink", "topk", "--participating", "2",
         "--participation", "gather"], {"full_eval": False},
        {"scatter_agg": 1}, 2),
}


@pytest.mark.parametrize("case", list(WIRE_ROUNDS))
def test_reduced_wire_round_on_card_matches_cpu(dev, case):
    """A reduced round on the dense and packed wires (fused: full
    participation, or ``full_eval=False``) on the card against the same
    round on the CPU -- f and g_hat at rtol 1e-4, all but 0.1% of w within
    rtol 1e-4 / atol 1e-6 (a top-k member or quant code may flip on the
    last bits of the card's GEMMs) -- launching the reduce kernel once per
    wire run on the packed wires, ``segment_rows`` twice in gather mode,
    and nothing on the dense wire."""
    from repro_torch.comm import flat
    argv, over, per_run, seg = WIRE_ROUNDS[case]
    new, met, fed = _reduced_round(dev, argv, **over)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    runs = len(flat.wire_layout(new.spec, fed.uplink).runs)
    want = {name: 0 for name in kernels.WRAPPERS}
    want.update({name: k * runs for name, k in per_run.items()})
    want["segment_rows"] = seg
    assert counts == want
    cpu, cmet, _ = _reduced_round(torch.device("cpu"), argv, **over)
    np.testing.assert_allclose([float(met.f), float(met.g_hat)],
                               [float(cmet.f), float(cmet.g_hat)],
                               rtol=1e-4)
    far = ~torch.isclose(new.w.cpu(), cpu.w, rtol=1e-4, atol=1e-6)
    assert float(far.float().mean()) <= 1e-3


def test_natural_on_card_equals_cpu(dev):
    """Natural compression without a key, on the card and on the CPU: bit
    for bit, on random draws and at and beside the powers of two and the
    midpoints between them."""
    from repro_torch.configs.base import CompressorConfig
    from repro_torch.core import compression
    rng = np.random.default_rng(6)
    x = (rng.standard_normal(100_000)
         * np.exp(rng.standard_normal(100_000) * 5)).astype(np.float32)
    p = np.ldexp(np.float32(1.0), np.arange(-126, 127)).astype(np.float32)
    near = np.concatenate([v for q in (p, 1.5 * p) for v in
                           (q, np.nextafter(q, 0), np.nextafter(q, np.inf))])
    x = torch.from_numpy(np.concatenate([x, near, -near, [0.0, -0.0]])
                         .astype(np.float32))
    cfg = CompressorConfig(kind="natural")
    _same(compression.compress_leaf(x.to(dev), cfg).view(torch.int32),
          compression.compress_leaf(x, cfg).view(torch.int32))


def test_tree_pallas_quant_reaches_quantize_ef(dev):
    """The tree transport's pallas quant ``compress`` and ``ef_step`` run
    the ``quantize_ef`` kernel, one launch per leaf of rank >= 1."""
    from repro_torch.comm import transports
    from repro_torch.configs.base import CompressorConfig
    t = transports.get_transport(CompressorConfig(kind="quant", block=64),
                                 "pallas")
    g = torch.Generator().manual_seed(8)
    tree = {"a": torch.randn((4, 128), generator=g),
            "b": {"c": torch.randn(96, generator=g),
                  "s": torch.tensor(1.5)}}
    on = {"a": tree["a"].to(dev), "b": {k: v.to(dev)
                                        for k, v in tree["b"].items()}}
    kernels.reset_launches()
    msg, e_new = t.ef_step(on, on)
    assert kernels.launch_counts()["quantize_ef"] == 2
    want_msg, want_e = t.ef_step(tree, tree)
    _same(msg["a"], want_msg["a"])
    _same(e_new["b"]["c"], want_e["b"]["c"])
    _same(t.compress(on)["a"], t.compress(tree)["a"])


def test_reduced_randk_gather_equals_mask_on_card(dev):
    """Packed rand-k up and down, 2 of 4 clients replayed through the
    ``fixed`` sampler: gather and mask bit-equal on the card (each client's
    stream is its own)."""
    from repro_torch.comm import flat
    from repro_torch.configs.base import CompressorConfig, FleetConfig
    from repro_torch.engine import rounds
    from repro_torch.fleet import samplers
    from repro_torch.launch import train
    masks = np.array([[1, 0, 1, 0], [0, 1, 1, 0]], np.float32)
    state0, batch_fn, pair, fed, _, _ = train.setup(train.parser().parse_args(
        ["--reduced", "--seq", "16", "--comm", "packed", "--participating",
         "2"]))
    cc = CompressorConfig(kind="randk", ratio=0.1)
    out = {}
    for mode in ("gather", "mask"):
        f = fed.replace(uplink=cc, downlink=cc, participation=mode,
                        fleet=FleetConfig(sampler="fixed"))
        state = rounds.init_state(flat.unflatten(state0.spec, state0.w), f,
                                  device=dev)
        state = state._replace(sampler=samplers.fixed_state(masks, masks))
        out[mode] = rounds.run_rounds(state, batch_fn, pair, f, T=2,
                                      device=dev)
    (sg, hg), (sm, hm) = out["gather"], out["mask"]
    for name in ("w", "x", "e_up"):
        _same(getattr(sg, name).view(torch.int32),
              getattr(sm, name).view(torch.int32))
    for name in rounds.RoundMetrics._fields:
        if getattr(hg, name) is None:       # telemetry, obs off
            assert getattr(hm, name) is None
            continue
        assert np.array_equal(getattr(hg, name).view(np.uint32),
                              getattr(hm, name).view(np.uint32))


def _ht_weights(n, m):
    """The weighted sampler's Horvitz-Thompson weights for heavy-tailed
    counts (client 0's inclusion caps at 1): not 0/1."""
    from repro_torch.fleet import samplers
    count = torch.tensor([80.0] + [float(3 + 5 * j) for j in range(n - 1)])
    _, w = samplers.weighted_core(torch.tensor(0.3), count / count.sum(), m)
    assert float(w.max()) > 1.0 and ((w > 0) & (w < 1)).any()
    return w


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("block,k", [(42, 4), (640, 64), (960, 96)])
def test_reduce_kernels_at_ht_weights(dev, n, block, k):
    """``scatter_agg`` and ``unpack_mma`` with Horvitz-Thompson weights (not
    0/1): bit-equal to their plain versions (the rounding order of
    ``weight * v`` and of ``weight * scale / L``)."""
    w = _ht_weights(n, n // 2)
    rng = np.random.default_rng(block + n)
    vals = torch.from_numpy(rng.standard_normal((n, 5, k)).astype(np.float32))
    idx = payloads.to_u16(torch.from_numpy(
        rng.integers(0, block, size=(n, 5, k))))
    want = scatter_agg_plain(vals, idx, w, block)
    got = scatter_agg(vals.to(dev), idx.to(dev), w.to(dev), block)
    _same(got.view(torch.int32), want.view(torch.int32))
    L = 127
    codes = torch.from_numpy(rng.integers(-L, L + 1, size=(n, 5, block)))
    words = payloads.pack_codes(codes, 8).to(dev)
    scale = torch.rand((n, 5), device=dev)
    wd = w.to(dev)
    _same(unpack_mma(words, scale, wd, 8, block),
          unpack_mma_plain(words, scale, wd, 8, block))


def test_weighted_fleet_round_on_card_matches_cpu(dev):
    """A reduced gather round (2 of 4) on a ragged fleet with the
    ``weighted`` sampler and 2 fresh rows per client, top-k up and down on
    ``comm="pallas"``, on the card against the CPU: the cohort and the rows
    come from CPU generators, so both draw the same; f and g_hat at rtol
    1e-4, all but 0.1% of w within rtol 1e-4 / atol 1e-6, the kernels
    launched as the layout demands, the weights not 0/1."""
    from repro_torch.comm import flat
    from repro_torch.configs.base import FleetConfig
    from repro_torch.engine import rounds
    from repro_torch.fleet import provision
    from repro_torch.launch import train
    from repro_torch.tasks import lm
    args = train.parser().parse_args(
        ["--reduced", "--seq", "16", "--device", "cpu", "--clients", "4",
         "--participating", "2", "--participation", "gather", "--comm",
         "pallas", "--uplink", "topk"])
    state0, _, pair, fed, cfg, _ = train.setup(args)
    fed = fed.replace(downlink=fed.uplink, fleet=FleetConfig(
        sampler="weighted", batch_size=2, redraw=True))
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 5, 16)))
    mask = torch.zeros((4, 5, 16))
    mask[..., -2:] = 1.0
    count = torch.tensor([5, 1, 2, 1])
    out = {}
    for d in (dev, torch.device("cpu")):
        fleet = provision.from_stacked(lm.LMBatch(toks.to(d), mask.to(d)),
                                       count=count)
        state = rounds.init_state(flat.unflatten(state0.spec,
                                                 state0.w.to(d)), fed,
                                  device=d)
        kernels.reset_launches()
        out[d.type] = rounds.round_step(state, fleet, pair, fed, device=d)
        if d.type == "cuda":
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
    runs = len(flat.wire_layout(state0.spec, fed.uplink).runs)
    want = {name: 0 for name in kernels.WRAPPERS}
    want.update({"block_topk": 2 * runs, "scatter_agg": runs,
                 "segment_rows": 2})
    assert counts == want
    (new, met), (cpu, cmet) = out["cuda"], out["cpu"]
    np.testing.assert_allclose([float(met.f), float(met.g_hat)],
                               [float(cmet.f), float(cmet.g_hat)],
                               rtol=1e-4)
    far = ~torch.isclose(new.w.cpu(), cpu.w, rtol=1e-4, atol=1e-6)
    assert float(far.float().mean()) <= 1e-3
    from repro_torch.fleet import samplers
    _, w, _ = samplers.get_sampler("weighted").sample(
        torch.Generator().manual_seed(fed.seed), fed, fleet=fleet)
    assert ((w > 0) & (w != 1.0)).any()


def test_cmdp_rollout_on_card_matches_cpu(dev):
    """A short CMDP rollout (5 episodes, 30 steps) from the same params and
    draws on the card and on the CPU: every reward, cost and alive flag
    equal, the states within 1e-4 of each episode's largest component (the
    card's sin, cos and tanh round differently in the last place, and the
    dynamics amplify it)."""
    from repro_torch.tasks import cmdp
    params = cmdp.init_params(torch.Generator().manual_seed(0), device="cpu")
    s0, noise = cmdp.rollout_draws(torch.Generator().manual_seed(1), 5, 30)
    cpu = cmdp.rollout(params, s0, noise)
    card = cmdp.rollout(_to(params, dev), s0.to(dev), noise.to(dev))
    for name in ("rewards", "costs", "alive"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name))
    scale = cpu.obs.abs().amax(dim=1, keepdim=True)
    assert float(((card.obs.cpu() - cpu.obs).abs() / scale).max()) <= 1e-4


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def test_cmdp_round_on_card_matches_cpu(dev):
    """One CMDP round on ``comm="pallas"`` (3 clients, 2 episodes of 30
    steps, top-k 0.5 up), card against CPU from the same draws: f, g_hat
    within 1e-4 absolute (the value splice rounds at the surrogates'
    scale), all but 0.1% of w within rtol 1e-4 / atol 1e-6, and the wire
    kernels launched once per run that needs them."""
    from repro_torch.comm import flat
    from repro_torch.configs.base import (CompressorConfig, FedConfig,
                                          SwitchConfig)
    from repro_torch.engine import rounds
    from repro_torch.tasks import cmdp
    fed = FedConfig(n_clients=3, m=3, local_steps=1, lr=1e-2,
                    switch=SwitchConfig(mode="soft", eps=0.0, beta=1.0),
                    uplink=CompressorConfig(kind="topk", ratio=0.5),
                    comm="pallas")
    params = cmdp.init_params(torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(2)
    draws = [cmdp.rollout_draws(gen, 2, 30) for _ in range(3)]
    batch = cmdp.CMDPBatch(torch.stack([d[0] for d in draws]),
                           torch.stack([d[1] for d in draws]),
                           cmdp.client_budgets(3))
    loss_pair = cmdp.make_loss_pair(2, 30)
    out = {}
    for d in (dev, torch.device("cpu")):
        state = rounds.init_state(_to(params, d), fed, device=d)
        kernels.reset_launches()
        out[d.type] = rounds.round_step(
            state, cmdp.CMDPBatch(*(v.to(d) for v in batch)), loss_pair,
            fed, device=d)
        if d.type == "cuda":
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
    runs = flat.wire_layout(flat.spec_of(params), fed.uplink).runs
    want = {name: 0 for name in kernels.WRAPPERS}
    # runs of 1-entry blocks keep their entry (k == block) and reduce as a
    # weighted sum: 2 of the 4 runs launch the kernels
    want.update({"block_topk": sum(r.k < r.block for r in runs),
                 "scatter_agg": sum(r.block > 1 for r in runs)})
    assert want["block_topk"] == want["scatter_agg"] == 2
    assert counts == want
    (new, met), (cpu, cmet) = out["cuda"], out["cpu"]
    np.testing.assert_allclose([float(met.f), float(met.g_hat)],
                               [float(cmet.f), float(cmet.g_hat)],
                               rtol=0, atol=1e-4)
    far = ~torch.isclose(new.w.cpu(), cpu.w, rtol=1e-4, atol=1e-6)
    assert float(far.float().mean()) <= 1e-3


# ---------------------------------------------------------------------------
# Asynchronous buffered rounds on the card
# ---------------------------------------------------------------------------

def test_mask_where_unsigned_leaves_on_card(dev):
    """``transports.mask_where`` on payload NamedTuples with uint16 offsets
    and uint32 words (through their signed views), into a fresh tensor and
    in place (``out=old``): bit-equal to the CPU's select."""
    from repro_torch.comm import transports
    rng = np.random.default_rng(5)
    mask = torch.tensor([1.0, 0.0, 0.25, 0.0])
    new = payloads.FlatPacked(
        torch.from_numpy(rng.standard_normal((4, 7)).astype(np.float32)),
        payloads.to_u16(torch.from_numpy(rng.integers(0, 65536, (4, 7)))))
    old = payloads.FlatPacked(
        torch.from_numpy(rng.standard_normal((4, 7)).astype(np.float32)),
        payloads.to_u16(torch.from_numpy(rng.integers(0, 65536, (4, 7)))))
    words = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (4, 5))
                             ).to(torch.int32).view(torch.uint32)
    qnew = payloads.FlatQuant(words, torch.rand(4, 3))
    qold = payloads.FlatQuant(words.flip(0).contiguous(), torch.rand(4, 3))
    for a, b in ((new, old), (qnew, qold)):
        want = transports.mask_where(mask, a, b)
        da = type(a)(*(x.to(dev) for x in a))
        db = type(b)(*(x.to(dev) for x in b))
        got = transports.mask_where(mask.to(dev), da, db)
        inplace = transports.mask_where(mask.to(dev), da, db, out=db)
        for g, i, w, o in zip(got, inplace, want, db):
            assert g.dtype == w.dtype and i.data_ptr() == o.data_ptr()
            _same(_bits(g), _bits(w))
            _same(_bits(i), _bits(w))


def _bits(x):
    """A same-width signed integer view (floats and unsigned wire
    dtypes)."""
    return x.view({torch.float32: torch.int32, torch.uint16: torch.int16,
                   torch.uint32: torch.int32}.get(x.dtype, x.dtype))


@pytest.mark.parametrize("block,k", [(42, 4), (640, 64), (960, 96)])
def test_stale_reduce_fractional_weights_bit_equal(dev, block, k):
    """The stale merge's reduce: rows parked rounds ago, rows still all
    zero, weights ``w_origin * lambda(s) * deliver`` (fractional, zero on
    most rows) -- ``scatter_agg`` bit-equal to its plain version on the
    CPU, ``unpack_mma`` to its plain version on the card."""
    n = 8
    rng = np.random.default_rng(block)
    s = torch.tensor([1.0, 2.0, 0.0, 3.0, 1.0, 0.0, 4.0, 2.0])
    w = torch.tensor([1.375, 0.62, 0.0, 2.9, 1.0, 0.0, 0.8, 1.1]) \
        * (1.0 + s) ** -1.7 * torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 0.0,
                                            1.0, 0.0])
    vals = rng.standard_normal((n, 5, k)).astype(np.float32)
    offs = rng.integers(0, block, size=(n, 5, k))
    vals[[2, 5]] = 0.0                      # never parked: all zero
    offs[[2, 5]] = 0
    vals = torch.from_numpy(vals)
    idx = payloads.to_u16(torch.from_numpy(offs))
    want = scatter_agg_plain(vals, idx, w, block)
    got = scatter_agg(vals.to(dev), idx.to(dev), w.to(dev), block)
    _same(got.view(torch.int32), want.view(torch.int32))
    L = 127
    codes = torch.from_numpy(rng.integers(-L, L + 1, size=(n, 5, block)))
    codes[[2, 5]] = 0
    words = payloads.pack_codes(codes, 8).to(dev)
    scale = torch.rand((n, 5), device=dev)
    scale[[2, 5]] = 0.0
    wd = w.to(dev)
    _same(unpack_mma(words, scale, wd, 8, block),
          unpack_mma_plain(words, scale, wd, 8, block))


@pytest.mark.parametrize("kind", ["topk", "quant"])
def test_async_rounds_park_and_deliver_on_card(dev, kind):
    """Four reduced async rounds (gather 2 of 4, pallas, max staleness 2,
    departures and arrivals at 1/2), card against CPU from the same weights,
    batches, cohorts and events (all drawn on CPU generators): the counters
    equal, the buffer's origins and occupancy equal, payloads parked and
    delivered, f and g_hat at rtol 1e-4, all but 0.1% of w within rtol
    1e-4 / atol 1e-6; on the card the reduce kernel launches twice a round
    (the fresh messages and the buffer)."""
    from repro_torch.comm import flat
    from repro_torch.configs.base import AsyncConfig
    from repro_torch.engine import async_rounds
    from repro_torch.launch import train
    args = train.parser().parse_args(
        ["--reduced", "--seq", "16", "--device", "cpu", "--clients", "4",
         "--participating", "2", "--participation", "gather", "--comm",
         "pallas", "--uplink", kind])
    state0, batch_fn, pair, fed, _, _ = train.setup(args)
    fed = fed.replace(async_=AsyncConfig(enabled=True, max_staleness=2,
                                         depart=0.5, rejoin=0.5,
                                         staleness="poly"))
    out = {}
    for d in (dev, torch.device("cpu")):
        state = rounds_init(state0, fed, d)
        kernels.reset_launches()
        out[d.type] = async_rounds.async_run_rounds(
            state, lambda t, g: _batch_to(batch_fn(t, g), d), pair, fed, 4,
            device=d)
        if d.type == "cuda":
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
    runs = len(flat.wire_layout(state0.spec, fed.uplink).runs)
    enc, red = ("block_topk", "scatter_agg") if kind == "topk" else \
        ("quantize_ef_pack", "unpack_mma")
    want = {name: 0 for name in kernels.WRAPPERS}
    want.update({enc: 4 * runs, red: 8 * runs, "segment_rows": 8})
    assert counts == want
    (sc, bc, hc), (sh, bh, hh) = out["cuda"], out["cpu"]
    for name in ("fresh", "departed", "merged", "dropped", "occupancy",
                 "max_age"):
        np.testing.assert_array_equal(getattr(hc, name), getattr(hh, name))
    assert hc.departed.sum() > 0 and hc.merged.sum() > 0
    assert torch.equal(bc.origin.cpu(), bh.origin)
    assert torch.equal(bc.occupied.cpu(), bh.occupied)
    np.testing.assert_allclose(hc.round.f, hh.round.f, rtol=1e-4)
    np.testing.assert_allclose(hc.round.g_hat, hh.round.g_hat, rtol=1e-4)
    far = ~torch.isclose(sc.w.cpu(), sh.w, rtol=1e-4, atol=1e-6)
    assert float(far.float().mean()) <= 1e-3


def rounds_init(state0, fed, d):
    from repro_torch.comm import flat
    from repro_torch.engine import rounds
    return rounds.init_state(flat.unflatten(state0.spec, state0.w.to(d)),
                             fed, device=d)


def _batch_to(batch, d):
    from repro_torch.fleet import partitions
    return partitions.rebuild(batch, [x.to(d) for x in
                                      partitions.leaves_of(batch)])


def test_async_obs_launcher_on_card(dev, tmp_path, monkeypatch):
    """The launcher's async, obs, sink and profile flags on the card
    (reduced config): ten rounds of JSONL records with the async counters
    and finite telemetry, and a trace holding the stage spans and the
    card's kernels."""
    import json
    from repro_torch.launch import train
    monkeypatch.chdir(tmp_path)
    train.main(["--reduced", "--seq", "16", "--batch", "1", "--clients",
                "4", "--participating", "2", "--participation", "gather",
                "--comm", "pallas", "--uplink", "topk", "--rounds", "10",
                "--fleet", "--fleet-pool", "3", "--sampler", "markov",
                "--async-buffer", "--staleness", "constraint",
                "--max-staleness", "3", "--depart", "0.5", "--obs",
                "--obs-window", "4", "--sink", "jsonl", "--sink-path",
                "m.jsonl", "--log-level", "warning", "--profile", "0:10"])
    lines = [json.loads(x) for x in (tmp_path / "m.jsonl").read_text()
             .splitlines()]
    assert lines[0]["meta"]["device"].startswith("cuda")
    recs = lines[1:]
    assert [r["round"] for r in recs] == list(range(1, 11))
    assert all(np.isfinite(r["tel_up_ratio"]) and "merged" in r
               for r in recs)
    with open(tmp_path / "profiles" / "trace_0_10.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"round.encode", "round.reduce", "kernel.block_topk",
            "kernel.scatter_agg"} <= names
    assert any(e.get("cat") == "kernel" for e in events)


def _same_bits(a, b):
    assert torch.equal(_bits(a).cpu(), _bits(b).cpu())


SLOT_STEPS = ([0, 1], [2, 3], [1, 4])
# short cohorts: one client sampled, its id repeated as the padding
SHORT_SLOT_STEPS = ([0, 1], [2, 2], [3, 3], [2, 4])


def _slot_encode_steps(d_dev, kind, steps=SLOT_STEPS):
    """Slot-store encodes (6 clients, 2 slots, 2 sampled: every round
    after the first evicts) on ``d_dev``, from the same numpy deltas: the
    messages, flush partials, stats and stores."""
    from repro_torch.comm import flat, transports
    from repro_torch.configs.base import CompressorConfig
    from repro_torch.engine import participation
    from repro_torch.scale import slots
    n_clients, m, d = 6, 2, 128
    spec = flat.spec_of({"w": torch.zeros(d)})
    cc = CompressorConfig(kind=kind, ratio=0.25, block=32, bits=8)
    ft = flat.FlatTransport(transports.get_transport(cc, "pallas"), spec)
    store = slots.init(n_clients, m, d, torch.float32, d_dev)
    rng = np.random.default_rng(0)
    out = []
    for r, ids in enumerate(steps):
        idx = torch.tensor(ids, dtype=torch.int64)
        mask = torch.zeros(n_clients).index_fill_(0, idx, 1.0)
        weights = mask * torch.tensor([1.5, 0.5, 2.0, 1.0, 0.75, 1.25])
        short = len(set(ids)) < m
        part = participation.Participation(
            mask.to(d_dev), idx.to(d_dev), n_clients, m,
            weights.to(d_dev), short, idx)
        deltas = torch.from_numpy(rng.standard_normal((m, d)).astype(
            np.float32)).to(d_dev)
        if short:       # a padded copy computes its client's row
            deltas[1:] = deltas[0]
        full, store, v_flush, stats = slots.encode(ft, store, deltas, part,
                                                   r)
        out.append((full, v_flush, stats,
                    slots.SlotStore(*(x.clone() for x in store))))
    return out


@pytest.mark.parametrize("steps", [SLOT_STEPS, SHORT_SLOT_STEPS],
                         ids=["full", "short"])
@pytest.mark.parametrize("kind", ["topk", "quant"])
def test_slot_store_on_card_equals_cpu(dev, kind, steps):
    """The store's int32 leaves (``index_select`` / ``index_copy`` /
    ``index_fill_`` with a spare entry, the stable ``argsort``), the pool
    rows (copied out, then ``index_copy_`` in place), the messages and the
    flush partials on the card, bit for bit the CPU's; with short cohorts
    too, whose repeated ids write one slot, and the store keeps owner[s]
    == j <=> client_slot[j] == s."""
    card = _slot_encode_steps(dev, kind, steps)
    host = _slot_encode_steps(torch.device("cpu"), kind, steps)
    for (fc, vc, sc, stc), (fh, vh, sh, sth) in zip(card, host):
        for a, b in zip(fc, fh):
            _same_bits(a, b)
        assert (vc is None) == (vh is None)
        if vc is not None:
            _same_bits(vc, vh)
        for a, b in zip(sc, sh):
            _same_bits(a, b)
        for a, b in zip(stc, sth):
            _same_bits(a, b)
        assert stc.owner.dtype == torch.int32
        owner, cslot = stc.owner.tolist(), stc.client_slot.tolist()
        held = [j for j in owner if j >= 0]
        assert len(held) == len(set(held))
        assert all(cslot[j] == s_ for s_, j in enumerate(owner) if j >= 0)
        assert all(owner[s_] == j for j, s_ in enumerate(cslot) if s_ >= 0)
    assert float(card[-1][2].evictions) >= 1.0


@pytest.mark.parametrize("kind", ["topk", "quant"])
def test_cohort_slice_through_reduce_kernels(dev, kind):
    """A cohort's rows are a leading-axis view of the stacked payload (its
    parent's strides): ``scatter_agg`` and ``unpack_mma`` on it equal
    their plain versions on the CPU, and the two-tier reduce equals the
    single tier's within the reordered sum."""
    from repro_torch.comm import flat, transports
    from repro_torch.configs.base import CompressorConfig
    spec = flat.spec_of({"W": torch.zeros(24, 96), "b": torch.zeros(96)})
    cc = CompressorConfig(kind=kind, ratio=0.25, block=32, bits=8)
    t = transports.get_transport(cc, "pallas")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((8, spec.d)).astype(
        np.float32)).to(dev)
    w = torch.from_numpy(rng.uniform(0.5, 2.0, 8).astype(np.float32)).to(dev)
    one = flat.FlatTransport(t, spec)
    msgs = one.codec.pack(x)
    sl = slice(4, 6)
    for r in one.codec.layout.runs:
        if kind == "topk":
            cols = slice(r.koff, r.koff + r.nblocks * r.k)
            vals = msgs.values[sl, cols].reshape(2, r.nblocks, r.k)
            idx = msgs.indices[sl, cols].reshape(2, r.nblocks, r.k)
            assert vals.stride(0) == msgs.values.stride(0)
            got = scatter_agg(vals, idx, w[sl], r.block)
            want = scatter_agg_plain(vals.cpu(), idx.cpu(), w[sl].cpu(),
                                     r.block)
        else:
            words = msgs.words[sl, r.woff:r.woff + r.nblocks * r.W] \
                .reshape(2, r.nblocks, r.W)
            scale = msgs.scale[sl, r.boff:r.boff + r.nblocks]
            assert words.stride(0) == msgs.words.stride(0)
            got = unpack_mma(words, scale, w[sl], 8, r.block)
            want = unpack_mma_plain(words.cpu(), scale.cpu(), w[sl].cpu(),
                                    8, r.block)
        _same_bits(got, want)
    single = one.reduce(msgs, w, 4.0)
    for k in (2, 4):
        tiered = flat.FlatTransport(t, spec, cohorts=k).reduce(msgs, w, 4.0)
        assert torch.allclose(tiered, single, rtol=1e-5, atol=1e-6)


FAMILY_ARCHS = ["qwen3-4b", "minitron-4b", "gemma3-4b", "mamba2-130m",
                "recurrentgemma-2b"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_forward_and_grad_on_card_match_cpu(dev, arch):
    """Each token-only family at its reduced size (seq 64: gemma3's window
    32 masks, Mamba-2 runs two SSD chunks): logits, f, g and the gradient
    of f on the card against the CPU from the same weights and tokens --
    logits and f, g at rtol 1e-4 / atol 1e-5, the gradient at rtol 1e-3 /
    atol 1e-6 (float32 GEMMs and reductions in another order; TF32 off)."""
    from repro_torch import configs
    from repro_torch.comm import flat
    from repro_torch.models import build
    from repro_torch.tasks import lm
    cfg = configs.get_reduced(arch)
    fns = build(cfg)
    params = fns.init(torch.Generator().manual_seed(0), cfg)
    spec = flat.spec_of(params)
    w0 = flat.flatten(spec, params)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64)))
    mask = torch.zeros((2, 64))
    mask[:, -4:] = 1.0
    pair = lm.make_loss_pair(fns.forward, cfg, budget=6.0)
    out = {}
    for d in (dev, torch.device("cpu")):
        w = w0.to(d).requires_grad_(True)
        p = flat.unflatten(spec, w)
        logits = fns.forward(p, cfg, toks.to(d))
        f, g = pair(p, lm.LMBatch(toks.to(d), mask.to(d)))
        f.backward()
        out[d.type] = (logits.detach().cpu(), f.item(), g.item(),
                       w.grad.cpu())
    (lc, fc, gc, dc), (lh, fh, gh, dh) = out["cuda"], out["cpu"]
    assert torch.isfinite(lc).all() and torch.isfinite(dc).all()
    torch.testing.assert_close(lc, lh, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose([fc, gc], [fh, gh], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dc, dh, rtol=1e-3, atol=1e-6)


MOE_ARCHS = ["deepseek-v2-236b", "deepseek-v3-671b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_and_grads_on_card_match_cpu(dev, arch):
    """Each moe arch at its reduced size, seq 40 (routing groups of 64
    over 80 tokens: pad tokens on uniform probabilities): logits, aux (and
    v3's MTP logits), f, g = aux - 6 and the gradients of f and g on the
    card against the CPU from the same weights and tokens, at the
    tolerances of the token-only families' card test (logits, aux and f, g
    at rtol 1e-4 / atol 1e-5, the gradients at rtol 1e-3 / atol 1e-6); the
    top-k choices of every MoE layer equal."""
    from repro_torch import configs
    from repro_torch.comm import flat
    from repro_torch.models import build, moe
    from repro_torch.tasks import lm
    cfg = configs.get_reduced(arch)
    fns = build(cfg)
    params = fns.init(torch.Generator().manual_seed(0), cfg)
    spec = flat.spec_of(params)
    w0 = flat.flatten(spec, params)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)))
    mask = torch.zeros((2, 40))
    mask[:, -4:] = 1.0
    pair = lm.make_loss_pair(fns.forward, cfg, budget=6.0,
                             aux_constraint=True)
    route = moe.route
    out = {}
    for d in (dev, torch.device("cpu")):
        chosen = []

        def recording(router, xg, k):
            probs, gates, idx = route(router, xg, k)
            chosen.append(idx.cpu())
            return probs, gates, idx
        moe.route = recording
        try:
            w = w0.to(d).requires_grad_(True)
            p = flat.unflatten(spec, w)
            outs = [o.detach().cpu() for o in fns.forward(p, cfg, toks.to(d))]
            f, g = pair(p, lm.LMBatch(toks.to(d), mask.to(d)))
            gf, = torch.autograd.grad(f, w, retain_graph=True)
            gg, = torch.autograd.grad(g, w)
        finally:
            moe.route = route
        out[d.type] = (outs, [f.item(), g.item()], gf.cpu(), gg.cpu(),
                       chosen)
    card, host = out["cuda"], out["cpu"]
    for a, b in zip(card[4], host[4]):
        assert torch.equal(a, b)
    for a, b in zip(card[0], host[0]):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(card[1], host[1], rtol=1e-4, atol=1e-5)
    for a, b in zip(card[2:4], host[2:4]):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-6)


MEDIA_ARCHS = ["llama-3.2-vision-90b", "whisper-small"]


@pytest.mark.parametrize("arch", MEDIA_ARCHS)
def test_media_forward_and_grad_on_card_match_cpu(dev, arch):
    """Each media arch at its reduced size (the vlm's cross layers over 8
    media tokens projected from 8192 wide, gated at 0.5; whisper's encoder
    over 16 frames), seq 64: logits, f, g and the gradient of f on the card
    against the CPU from the same weights, tokens and media, at the
    token-only families' tolerances (logits and f, g at rtol 1e-4 / atol
    1e-5, the gradient at rtol 1e-3 / atol 1e-6)."""
    from repro_torch import configs
    from repro_torch.comm import flat
    from repro_torch.models import build
    from repro_torch.tasks import lm
    cfg = configs.get_reduced(arch)
    fns = build(cfg)
    params = fns.init(torch.Generator().manual_seed(0), cfg)
    if cfg.family == "vlm":
        params["blocks"][1]["attn"]["gate"].fill_(0.5)
    spec = flat.spec_of(params)
    w0 = flat.flatten(spec, params)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64)))
    mask = torch.zeros((2, 64))
    mask[:, -4:] = 1.0
    media = torch.from_numpy(rng.standard_normal(
        (2, cfg.n_media_tokens or cfg.n_audio_frames,
         cfg.d_media or cfg.d_model)).astype(np.float32) * 0.02)
    pair = lm.make_loss_pair(fns.forward, cfg, budget=6.0)
    out = {}
    for d in (dev, torch.device("cpu")):
        w = w0.to(d).requires_grad_(True)
        p = flat.unflatten(spec, w)
        logits = fns.forward(p, cfg, toks.to(d), media=media.to(d))
        f, g = pair(p, lm.LMBatch(toks.to(d), mask.to(d), media.to(d)))
        f.backward()
        out[d.type] = (logits.detach().cpu(), f.item(), g.item(),
                       w.grad.cpu())
    (lc, fc, gc, dc), (lh, fh, gh, dh) = out["cuda"], out["cpu"]
    assert torch.isfinite(lc).all() and torch.isfinite(dc).all()
    torch.testing.assert_close(lc, lh, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose([fc, gc], [fh, gh], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dc, dh, rtol=1e-3, atol=1e-6)


# (block, k) of the token-only families' top-k wire runs that the smollm
# layouts do not have: Mamba-2's per-head leaves (24), in_proj (838),
# conv (896); gemma3's and Griffin's 640 / 256 / 1024 / 960 blocks;
# chip_smoke.py phase 15's deepseek-v2 at full width: MLA's kv_norm (512)
# and wkv_a (576), the head at vocab 12,800 (800), the experts' gate and
# up projections (768) and the 16-wide router (16); and whisper-small's
# 12 stacked cross-attention gates
FAMILY_TOPK_BLOCKS = [(24, 2), (838, 84), (896, 90), (256, 26), (1024, 102),
                      (512, 51), (576, 58), (800, 80), (768, 77), (16, 2),
                      (12, 1)]
# the quant wire's blocks of Griffin's layout, of phase 16(a)'s vlm (its
# one cross layer's gate, 1; the head at vocab 16,032, 1002) and of the
# reduced media configs' 2 stacked gates
FAMILY_QUANT_BLOCKS = [640, 960, 256, 1, 1002, 2]


@pytest.mark.parametrize("block,k", FAMILY_TOPK_BLOCKS)
def test_topk_kernels_at_family_blocks(dev, block, k):
    """``block_topk`` (special rows written in) and ``scatter_agg`` with
    non-unit weights (on the top-k payloads of finite rows) at the new
    block layouts: bit-equal to their plain versions."""
    g = torch.Generator(device=dev).manual_seed(block)
    x = torch.randn((3, 7, block), generator=g, device=dev)
    clean = x.clone()
    _topk_rows(x)
    _check_topk(x, k)
    vals, idx = block_topk_plain(clean, k)
    idx = payloads.to_u16(idx)
    w = torch.tensor([1.0, 0.5, 1.75], device=dev)
    want = scatter_agg_plain(vals.cpu(), idx.cpu(), w.cpu(), block)
    got = scatter_agg(vals, idx, w, block)
    _same(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("block", FAMILY_QUANT_BLOCKS)
def test_quant_kernels_at_family_blocks(dev, block):
    """``quantize_ef_pack`` and ``unpack_mma`` (8 bits, non-unit weights)
    at Griffin's quant blocks: bit-equal to their plain versions."""
    g = torch.Generator(device=dev).manual_seed(block)
    e = torch.randn((2, 5, block), generator=g, device=dev) * 0.1
    d = torch.randn((2, 5, block), generator=g, device=dev)
    e[0, 0] = 0.0
    d[0, 0] = 0.0
    got = quantize_ef_pack(e, d, 8)
    for a, b in zip(got, quantize_ef_pack_plain(e, d, 8)):
        _same(a, b)
    words, scale = got[0], got[1][..., 0]
    w = torch.tensor([0.25, 1.5], device=dev)
    _same(unpack_mma(words, scale, w, 8, block),
          unpack_mma_plain(words, scale, w, 8, block))


# ---------------------------------------------------------------------------
# The wire (repro_torch.wire) on the card
# ---------------------------------------------------------------------------

def test_unpack_payload_on_card_round_trips_unsigned(dev):
    """``unpack_payload`` gives tensors on the card; uint32 words and
    uint16 offsets come back bit for bit (through their signed views)."""
    from repro_torch.comm.payloads import FlatPacked, FlatQuant
    from repro_torch.wire import frames
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, 37, dtype=np.uint32)
    words[:2] = [0, 2**32 - 1]
    offs = rng.integers(0, 2**16, 23).astype(np.uint16)
    offs[:2] = [0, 2**16 - 1]
    scale = rng.random(5).astype(np.float32)
    for payload in (FlatQuant(frames.to_tensor(words, dev),
                              frames.to_tensor(scale, dev)),
                    FlatPacked(frames.to_tensor(scale, dev),
                               frames.to_tensor(offs, dev))):
        sig, body = frames.pack_payload(payload)
        back = frames.unpack_payload(sig, body, dev)
        assert type(back) is type(payload)
        for a, b in zip(back, payload):
            assert a.is_cuda and a.dtype == b.dtype
            _same(a, b)
        assert frames.pack_payload(back) == (sig, body)
    assert frames.to_numpy(frames.to_tensor(words, dev)).tolist() == \
        words.tolist()


@pytest.mark.parametrize("kind", ["topk", "quant"])
def test_wire_threads_equal_drive_on_card(dev, kind):
    """A 2-thread ``wire_drive`` on the reduced smollm, pallas top-k or
    8-bit quant up, gather 2 of 4: state and every metric bit-equal to
    ``rounds.drive`` on the card, the wire kernels launched."""
    from repro_torch.configs.base import (CompressorConfig, FedConfig,
                                          SwitchConfig)
    from repro_torch.engine import rounds
    from repro_torch.wire import bootstrap, wire_drive
    fed = FedConfig(n_clients=4, m=2, local_steps=1, lr=0.03,
                    switch=SwitchConfig(mode="soft", eps=0.0, beta=2.0),
                    uplink=CompressorConfig(kind=kind, ratio=0.1),
                    comm="pallas", participation="gather", full_eval=True,
                    lean_metrics=True)
    args = {"n_clients": 4, "batch": 2, "seq": 16}
    params, batches, pair = bootstrap.build_problem("lm", args, dev)
    st_o, mets_o = rounds.drive(rounds.init_state(params, fed, device=dev),
                                batches, pair, fed, 3, device=dev)
    kernels.reset_launches()
    st_w, mets_w, stats = wire_drive(fed, 3, workers=2, spawn="thread",
                                     problem="lm", problem_args=args,
                                     deadline=120.0, device=dev)
    counts = kernels.launch_counts()
    enc, red = (("block_topk", "scatter_agg") if kind == "topk"
                else ("quantize_ef_pack", "unpack_mma"))
    assert counts[enc] > 0 and counts[red] > 0
    assert st_w.w.is_cuda and stats.totals["missing"] == 0
    for name in ("w", "e_up", "wbar_sum", "wbar_weight"):
        _same(getattr(st_o, name), getattr(st_w, name))
    for name in rounds.RoundMetrics._fields:
        a, b = getattr(mets_o, name), getattr(mets_w, name)
        assert (a is None and b is None) or np.array_equal(
            np.asarray(a).view(np.uint32), np.asarray(b).view(np.uint32))


SERVE_CARD_ARCHS = ["qwen3-4b", "gemma3-4b", "llama-3.2-vision-90b",
                    "mamba2-130m", "recurrentgemma-2b", "deepseek-v2-236b",
                    "deepseek-v3-671b", "whisper-small"]


def _cache_leaves(tree):
    """The tensors of a serving cache (NamedTuples, dicts, lists; None
    dropped), on the CPU."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _cache_leaves(v)]
    return [] if tree is None else [tree.cpu()]


@pytest.mark.parametrize("arch", SERVE_CARD_ARCHS)
def test_prefill_and_decode_on_card_match_cpu(dev, arch):
    """Serving at the reduced dense (qk-norm), gemma3 (window 32, a prompt
    of 30 and 8 decode steps: the ring wraps and the window masks), vlm
    (cross caches over 8 media tokens, gated at 0.5), mamba2 (conv windows
    and SSM states), recurrentgemma (recurrent states and the local ring,
    window 32), deepseek v2 / v3 (MLA latents, the MoE FFN at the
    published capacity) and whisper (self caches, 16 frames) configs:
    prefill's logits and caches, then 8 decode steps' logits and the final
    caches on the card against the CPU from the same weights, tokens and
    media, at the forward's card tolerance (rtol 1e-4 / atol 1e-5:
    float32 GEMMs in another order, TF32 off)."""
    from repro_torch import configs
    from repro_torch.models import build
    from repro_torch.wire.bootstrap import tree_to
    cfg = configs.get_reduced(arch)
    fns = build(cfg)
    params = fns.init(torch.Generator().manual_seed(0), cfg)
    if cfg.family == "vlm":
        params["blocks"][1]["attn"]["gate"].fill_(0.5)
    prompt, steps = 30, 8
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, prompt + steps)))
    kw = {}
    if cfg.family in ("vlm", "audio"):
        kw["media"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_media_tokens or cfg.n_audio_frames,
             cfg.d_media or cfg.d_model)).astype(np.float32) * 0.1)

    out = {}
    for d in (dev, torch.device("cpu")):
        p = tree_to(params, d)
        dkw = {k: v.to(d) for k, v in kw.items()}
        with torch.inference_mode():
            logits, cache = fns.prefill(p, cfg, toks[:, :prompt].to(d),
                                        prompt + steps, **dkw)
            got = [logits.cpu()]
            for pos in range(prompt, prompt + steps):
                logits, cache = fns.decode_step(
                    p, cfg, toks[:, pos:pos + 1].to(d), cache, pos)
                got.append(logits.cpu())
        out[d.type] = (got, _cache_leaves(cache))
    for a, b in zip(out["cuda"][0] + out["cuda"][1],
                    out["cpu"][0] + out["cpu"][1]):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


# rounds across ranks: reduced smollm, 2 rounds, each case in this process
# and then in a world of 2 ranks sharing the card over gloo
RANK_CARD_CASES = ["pallas-topk-gather", "pallas-quant-mask",
                   "slots-evict-topk", "dense-topk-mask"]


def test_two_ranks_sharing_the_card_equal_one_process(dev, tmp_path):
    """Two ranks sharing the card over gloo (CUDA tensors; the collectives
    staged through pinned host memory) run each case of
    ``RANK_CARD_CASES`` under a rank mesh: every rank ends with the one
    process's state, metrics and residual, bit for bit."""
    import torch_multidev_world as world_mod
    want = {name: world_mod.run_case(name, "cuda")
            for name in RANK_CARD_CASES}
    torch.cuda.empty_cache()
    ranks = world_mod.spawn_world(2, str(tmp_path), timeout_s=600,
                                  device="cuda", names=RANK_CARD_CASES)
    for r, res in enumerate(ranks):
        assert res["collectives"]["bytes_out"] > 0
        for name in RANK_CARD_CASES:
            got = res["cases"][name]
            assert got.keys() == want[name].keys(), name
            for key, v in want[name].items():
                if isinstance(v, torch.Tensor):
                    assert torch.equal(got[key].reshape(-1).view(
                        torch.uint8), v.reshape(-1).view(torch.uint8)), \
                        f"rank {r} {name} {key}"
                else:
                    assert got[key] == v, f"rank {r} {name} {key}"


def test_split_plan_round_on_shared_card_matches_cpu(dev, tmp_path):
    """Two ranks sharing the card over gloo on a ``(1, 2)`` data x model
    mesh run reduced qwen3-4b's rounds under the split plan (heads, ffn
    and the untied vocab over the model axis; pallas top-k up and down,
    gather, the separate eval): every rank against the same rounds in one
    process on the CPU, from the same weights and tokens (drawn on the
    CPU), by the law of ``test_torch_tensor_parallel.py`` (the card's
    matmuls and the split's sums add in other orders), and the same bits
    on both ranks."""
    import torch_multidev_world as world_mod
    name = "qwen3-topk-gather"
    want = world_mod.run_tp_case(name, "cpu")
    ranks = world_mod.spawn_tp_world((1, 2), str(tmp_path), timeout_s=600,
                                     device="cuda", names=[name])
    for res in ranks:
        got = dict(res["cases"][name])
        assert got.pop("split_plan")
        world_mod.tp_law(got, {k: v for k, v in want.items()
                               if k != "split_plan"}, False)
        assert res["digests"] == ranks[0]["digests"]
        assert res["collectives_by_axis"]["model"]["bytes_out"] > 0


# the wire kernels on the column blocks of a data x model mesh: phase 3's
# layouts (smollm-360m whole, pallas top-k 0.1 and 8-bit quant, 4 rows)
# cut over 2 model ranks as ``comm.flat.column_split`` cuts them
COLUMN_KERNELS = ["block_topk", "quantize_ef_pack", "scatter_agg",
                  "unpack_mma", "segment_rows"]


@pytest.mark.parametrize("kernel", COLUMN_KERNELS)
def test_wire_kernels_on_column_blocks(dev, kernel):
    """Each wire kernel launched on every run of each model rank's column
    block (``comm.flat.local_layout``: the same blocks, offsets from the
    block's first column) of phase 3's full-width layouts, n = 4 rows (m =
    4 of n = 8 for ``segment_rows``), equal to its plain version on the
    same inputs, bit for bit."""
    from repro_torch import configs
    from repro_torch.comm import flat
    from repro_torch.configs.base import CompressorConfig, FedConfig
    from repro_torch.models import build, common
    cfg = configs.get_config("smollm-360m")
    spec = flat.spec_of(common.meta_tree(build(cfg).param_shapes(cfg)))
    quant = kernel in ("quantize_ef_pack", "unpack_mma")
    cc = CompressorConfig(kind="quant", bits=8) if quant else \
        CompressorConfig(kind="topk", ratio=0.1)
    fed = FedConfig(comm="pallas", uplink=cc, downlink=cc)
    fts = flat.flat_transports_for(fed, spec)
    split = flat.column_split(spec, fts, 2)
    g = torch.Generator(device=dev).manual_seed(len(kernel))
    n, w8 = 4, torch.tensor([1.0, 0.0, 0.5, 2.0], device=dev)
    launched = 0
    for r in range(2):
        lo, hi = split.block(r)
        layout, _ = flat.local_layout(fts[0].codec.layout, lo, hi)
        assert sum(run.span for run in layout.runs) == hi - lo
        x = torch.randn((n, hi - lo), generator=g, device=dev)
        kernels.reset_launches()
        if kernel == "segment_rows":
            ids = torch.tensor([1, 2, 5, 7], device=dev)
            _same(ops.segment_rows(x, ids, 8),
                  segment_rows_plain(x, ids, 8))
        for run in layout.runs if kernel != "segment_rows" else ():
            blocks = flat.run_view(x, run)
            if kernel == "block_topk":
                for a, b in zip(ops.block_topk(blocks, run.k),
                                block_topk_plain(blocks, run.k)):
                    _same(a, b)
            elif kernel == "quantize_ef_pack":
                e = torch.randn(blocks.shape, generator=g, device=dev) * 0.1
                for a, b in zip(ops.quantize_ef_pack(e, blocks, 8),
                                quantize_ef_pack_plain(e, blocks, 8)):
                    _same(a, b)
            elif kernel == "scatter_agg":
                vals, idx = block_topk_plain(blocks, run.k)
                idx = payloads.to_u16(idx)
                _same(ops.scatter_agg(vals, idx, w8, run.block).view(
                    torch.int32), scatter_agg_plain(
                        vals.cpu(), idx.cpu(), w8.cpu(),
                        run.block).view(torch.int32))
            else:
                words, scale, _ = quantize_ef_pack_plain(
                    torch.zeros_like(blocks), blocks, 8)
                scale = scale.reshape(words.shape[:-1])
                _same(ops.quant_agg(words, scale, w8, 8, run.block),
                      unpack_mma_plain(words, scale, w8, 8, run.block))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        name = "unpack_mma" if kernel == "unpack_mma" else kernel
        launched += counts[name]
        assert counts[name] == (1 if kernel == "segment_rows"
                                else len(layout.runs))
    assert launched >= 2
