"""The compressor operators (``core/compression``) and the payload formats
of ``comm/payloads`` against the JAX package, from numpy inputs.

Tolerances and why:

* top-k (whole-leaf, block-wise exact and sort-free, the giant-leaf
  threshold), offsets, quant codes and scales, ``_block_threshold``:
  bit-equal, rows of tied magnitudes, +-0 and NaNs included;
* quant values: within 2 ulp of the block scale -- XLA rewrites the
  reference's divide by the levels as a multiply by the reciprocal, the
  port divides (IEEE);
* natural compression with no key: the reference's ``exp2`` on the CPU is
  not exact at most integer exponents (``jnp.exp2(-20.0)`` is 1 ulp below
  2^-20), so its values are within 2^-19 (relative) of the powers of two
  the port gives exactly; the power chosen is the reference's on every
  random draw.  At and beside powers of two and the midpoints between
  them, where the reference's rounded ``log2`` and ``exp2`` can move the
  choice, the port's choice is the one an exact float64 computation
  makes;
* rand-k and natural with a generator: the reference tests' properties
  (exactly k distinct coordinates, values kept, contraction and
  unbiasedness in expectation), since the two packages' random streams
  differ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import payloads as jp
from repro.configs.base import CompressorConfig as JCC
from repro.core import compression as jc
from repro_torch.comm import payloads
from repro_torch.configs.base import CompressorConfig
from repro_torch.core import compression
from torch_port_util import assert_bits_equal, n, one_thread, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _special(x, kind, rng):
    """Write ties, signed zeros or NaNs into the float32 array ``x``."""
    x = x.copy()
    flat = x.reshape(-1)
    if kind == "ties":
        flat[:] = np.round(flat * 2) / 2
    elif kind == "zeros":
        flat[::3] = 0.0
        flat[1::3] = -0.0
    elif kind == "nan":
        flat[rng.choice(flat.size, 5, replace=False)] = np.nan
        flat[1] = -np.nan
        flat[2], flat[3] = np.inf, -np.inf
    return x


SPECIALS = ["random", "ties", "zeros", "nan"]


@pytest.mark.parametrize("special", SPECIALS)
@pytest.mark.parametrize("shape,ratio", [((1000,), 0.1), ((24, 50), 0.25),
                                         ((7,), 0.5), ((3, 5), 1.0)])
def test_leaf_topk_matches_reference(shape, ratio, special):
    rng = np.random.default_rng([SPECIALS.index(special), *shape])
    x = _special(rng.standard_normal(shape).astype(np.float32), special, rng)
    want = jc.compress_leaf(jnp.asarray(x), JCC(kind="topk", ratio=ratio))
    got = compression.compress_leaf(t(x), CompressorConfig(kind="topk",
                                                           ratio=ratio))
    assert_bits_equal(got, want)
    # the client axis as a batch axis: every row as on its own
    xs = np.stack([x, _special(x[::-1].copy(), "ties", rng)])
    rows = compression.compress_leaf(t(xs), CompressorConfig(
        kind="topk", ratio=ratio), batch=1)
    for i in range(2):
        assert_bits_equal(rows[i], jc.compress_leaf(
            jnp.asarray(xs[i]), JCC(kind="topk", ratio=ratio)))


def test_giant_leaf_topk_matches_reference():
    """A leaf above 2^22 elements takes the block-wise threshold variant:
    rows of ties, of NaNs and of +-0 included; the stacked form too."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4097, 1024)).astype(np.float32)
    x[0] = _special(x[0], "nan", rng)
    x[1] = _special(x[1], "ties", rng)
    x[2] = _special(x[2], "zeros", rng)
    x[3, ::2] = -0.0
    cfg = CompressorConfig(kind="topk", ratio=0.1)
    want = jc.compress_leaf(jnp.asarray(x), JCC(kind="topk", ratio=0.1))
    got = compression.compress_leaf(t(x), cfg)
    assert_bits_equal(got, want)
    both = compression.compress_leaf(t(np.stack([x, x])), cfg, batch=1)
    assert_bits_equal(both[1], want)


@pytest.mark.parametrize("special", SPECIALS)
@pytest.mark.parametrize("block,k", [(64, 6), (100, 10), (960, 96), (7, 3)])
def test_block_selection_matches_reference(block, k, special):
    """``_block_threshold`` and both regimes of ``select_topk_blocks``."""
    rng = np.random.default_rng(block * 7 + k)
    x = _special(rng.standard_normal((3, 5, block)).astype(np.float32),
                 special, rng)
    thr_want = jp._block_threshold(jnp.abs(jnp.asarray(x)), k)
    assert_bits_equal(payloads._block_threshold(t(x).abs(), k), thr_want)
    for sort_free in (False, True):
        jv, ji = jp.select_topk_blocks(jnp.asarray(x), k, sort_free)
        v, i = payloads.select_topk_blocks(t(x), k, sort_free)
        assert i.dtype == torch.uint16
        assert_bits_equal(v, jv)
        assert_bits_equal(i, ji)


@pytest.mark.parametrize("shape", [(4, 300), (960,), (), (2, 3, 64)])
def test_block_pack_unpack_dense_match_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = _special(rng.standard_normal(shape).astype(np.float32), "ties", rng)
    jcfg, cfg = JCC(kind="topk", ratio=0.1, block=128), \
        CompressorConfig(kind="topk", ratio=0.1, block=128)
    jpk = jp.block_topk_pack(jnp.asarray(x), jcfg)
    pk = payloads.block_topk_pack(t(x), cfg)
    assert_bits_equal(pk.values, jpk.values)
    assert_bits_equal(pk.indices, jpk.indices)
    assert_bits_equal(payloads.block_topk_unpack(pk, shape, block=None),
                      jp.block_topk_unpack(jpk, shape))
    assert_bits_equal(payloads.block_topk_dense(t(x), cfg),
                      jp.block_topk_dense(jnp.asarray(x), jcfg))
    tree, jtree = {"a": t(x), "b": {"c": t(x) * 2}}, \
        {"a": jnp.asarray(x), "b": {"c": jnp.asarray(x) * 2}}
    got = payloads.unpack_tree(payloads.pack_tree(tree, cfg), tree, cfg)
    want = jp.unpack_tree(jp.pack_tree(jtree, jcfg), jtree, jcfg)
    assert_bits_equal(got["b"]["c"], want["b"]["c"])
    assert payloads.payload_wire_bytes(payloads.pack_tree(tree, cfg)) == \
        jp.payload_wire_bytes(jp.pack_tree(jtree, jcfg))


def _ulp_of_scale(got, want, scale, ulps=2):
    tol = ulps * np.spacing(np.abs(n(scale)).astype(np.float32))
    assert (np.abs(n(got) - n(want)) <= tol).all()


@pytest.mark.parametrize("bits", [2, 4, 6, 8, 16])
@pytest.mark.parametrize("shape,block", [((64, 300), 128), ((1000,), 1024),
                                         ((3, 7), 4), ((), 8)])
def test_quant_matches_reference(shape, block, bits):
    rng = np.random.default_rng(bits * 31 + block)
    x = rng.standard_normal(shape).astype(np.float32)
    if x.size > 4:
        x.reshape(-1)[:4] = 0.0                # a block of zeros, maybe
    jcfg = JCC(kind="quant", bits=bits, block=block)
    cfg = CompressorConfig(kind="quant", bits=bits, block=block)
    jq = jp.quant_pack(jnp.asarray(x), jcfg)
    q = payloads.quant_pack(t(x), cfg)
    assert_bits_equal(q.codes, jq.codes)
    assert_bits_equal(q.scale, jq.scale)
    scale = np.broadcast_to(n(jq.scale), n(jq.codes).shape).reshape(
        shape) if shape else n(jq.scale).reshape(())
    _ulp_of_scale(payloads.quant_unpack(q, shape, torch.float32, cfg),
                  jp.quant_unpack(jq, shape, jnp.float32, jcfg), scale)
    _ulp_of_scale(compression.compress_leaf(t(x), cfg),
                  jc.compress_leaf(jnp.asarray(x), jcfg), scale)
    assert payloads.payload_wire_bytes({"x": q}, bits) == \
        jp.payload_wire_bytes({"x": jq}, bits)


def _natural_exact(x):
    """Natural compression with no key in float64, ``lo`` from ``frexp``:
    the exact answer."""
    mag = np.abs(x.astype(np.float64))
    _, e = np.frexp(np.where(mag > 0, mag, 1.0))
    lo = np.ldexp(1.0, e - 1)
    up = (mag - lo) / lo > 0.5
    return np.where(mag > 0, np.sign(x) * np.where(up, 2 * lo, lo),
                    0.0).astype(np.float32)


def test_natural_no_key_matches_reference():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(200_000)
         * np.exp(rng.standard_normal(200_000) * 5)).astype(np.float32)
    x[:3] = [0.0, -0.0, np.nan]
    got = n(compression.compress_leaf(t(x), CompressorConfig(
        kind="natural")))
    want = np.asarray(jc.compress_leaf(jnp.asarray(x), JCC(kind="natural")))
    np.testing.assert_array_equal(got[:3], 0.0)
    nz = got != 0
    # the port: exact signed powers of two
    assert (np.frexp(np.abs(got[nz]))[0] == 0.5).all()
    # the reference: the same power, within its exp2's error
    np.testing.assert_allclose(want[nz], got[nz], rtol=2 ** -19, atol=0)
    np.testing.assert_array_equal(got, _natural_exact(x))
    # at and beside the powers of two and the midpoints between them
    p = np.ldexp(np.float32(1.0), np.arange(-30, 30)).astype(np.float32)
    near = np.concatenate([v for q in (p, 1.5 * p) for v in
                           (q, np.nextafter(q, 0), np.nextafter(q, np.inf))])
    near = np.concatenate([near, -near]).astype(np.float32)
    got = n(compression.compress_leaf(t(near), CompressorConfig(
        kind="natural")))
    np.testing.assert_array_equal(got, _natural_exact(near))


@pytest.mark.parametrize("d,ratio", [(1000, 0.1), (37, 0.5), (5, 0.9)])
def test_randk_properties(d, ratio):
    """Exactly k distinct coordinates with their values kept; contractive
    in expectation: E||C(x) - x||^2 = (1 - k/d) ||x||^2."""
    rng = np.random.default_rng(d)
    x = t(rng.standard_normal(d).astype(np.float32) + 3.0)   # no zeros
    cfg = CompressorConfig(kind="randk", ratio=ratio)
    k = max(1, int(round(d * ratio)))
    gaps = []
    for s in range(200):
        c = compression.compress_leaf(x, cfg, torch.Generator().manual_seed(s))
        kept = c != 0
        assert int(kept.sum()) == k
        assert torch.equal(c[kept], x[kept])
        gap, total = compression.contraction_gap(x, c)
        gaps.append(gap / total)
    assert abs(np.mean(gaps) - (1 - k / d)) < 0.05
    with pytest.raises(ValueError, match="generator"):
        compression.compress_leaf(x, cfg)


def test_block_randk_pack_properties():
    cfg = CompressorConfig(kind="randk", ratio=0.1, block=64)
    x = t(np.random.default_rng(3).standard_normal((4, 640))
          .astype(np.float32))
    g = torch.Generator().manual_seed(0)
    p = payloads.block_randk_pack(x, cfg, g)
    idx = payloads.u16_to_i64(p.indices)
    assert p.values.shape == (4, 10, 6)
    for row in idx.reshape(-1, 6):
        assert len(set(row.tolist())) == 6
    blocks = x.reshape(4, 10, 64)
    assert torch.equal(p.values, torch.gather(blocks, -1, idx))
    again = payloads.block_randk_pack(x, cfg, torch.Generator().manual_seed(0))
    assert torch.equal(again.indices.view(torch.int16),
                       p.indices.view(torch.int16))


def test_natural_with_generator_unbiased():
    """Unbiased, with values in {lo, 2 lo} of each entry."""
    x = t(np.random.default_rng(4).standard_normal(64).astype(np.float32))
    cfg = CompressorConfig(kind="natural")
    draws = torch.stack([compression.compress_leaf(
        x, cfg, torch.Generator().manual_seed(s)) for s in range(4000)])
    lo = torch.exp2(torch.floor(torch.log2(x.abs())))
    assert ((draws.abs() == lo) | (draws.abs() == 2 * lo)).all()
    np.testing.assert_allclose(n(draws.mean(0)), n(x), rtol=0.06, atol=0.02)


def test_compress_tree_and_message_bytes():
    rng = np.random.default_rng(5)
    tree = {"b": t(rng.standard_normal((8, 40)).astype(np.float32)),
            "a": {"w": t(rng.standard_normal(100).astype(np.float32)),
                  "s": t(np.float32(2.5))}}
    jtree = jax.tree_util.tree_map(lambda v: jnp.asarray(n(v)), tree)
    for kind in ("none", "topk", "quant"):
        cfg = CompressorConfig(kind=kind, ratio=0.2, bits=4, block=16)
        jcfg = JCC(kind=kind, ratio=0.2, bits=4, block=16)
        got = compression.compress(tree, cfg)
        want = jc.compress(jtree, jcfg)
        assert_bits_equal(got["a"]["s"], want["a"]["s"])
        if kind != "quant":
            assert_bits_equal(got["b"], want["b"])
        assert compression.message_bytes(tree, cfg) == \
            jc.message_bytes(jtree, jcfg)
    for kind in ("randk", "natural"):
        assert compression.message_bytes(tree, CompressorConfig(kind=kind)) \
            == jc.message_bytes(jtree, JCC(kind=kind))
