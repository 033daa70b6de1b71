"""Each kernel's plain PyTorch version (what the port's wrapper runs on CPU
tensors) against the JAX package's Pallas kernel, called directly and run as
the JAX tests run it off-TPU (interpret mode).

Tolerances: integer outputs (words, offsets, top-k indices) and top-k
values and scales are bit-equal.  The EF residual ``e' = buf - v`` may
differ by 2 ulp of the row's scale ``max|buf|``: XLA rewrites the
reference's ``codes / L * scale`` as ``codes * (1/L) * scale`` (DESIGN.md
§Transport, EF fusion), two roundings more than the port's IEEE divide, so
``v`` moves by up to ~1.5 ulp and the cancellation in ``buf - v`` keeps
that absolute error (measured: at most 1.19 ulp of the scale on these
inputs).  Sums are allclose at rtol 1e-5 (the reference's own contract for
reordered aggregation).  ``segment_rows`` adds rows in the same order as
the reference's kernel, so it is bit-equal; ``quantize_ef``'s v and e'
are within 2 ulp of the block scale for the reason above (ROADMAP Queue 3);
``switch_blend`` is at rtol 1e-6, since XLA may contract the reference's
multiply-add into an FMA."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.payloads import pack_codes as jax_pack_codes
from repro.comm.payloads import select_topk_blocks as jax_select
from repro.kernels.ops import switch_blend_tree as jax_switch_blend_tree
from repro.kernels.quantize_ef import quantize_ef as jax_quantize_ef
from repro.kernels.quantize_ef_pack import quantize_ef_pack as jax_qef_pack
from repro.kernels.scatter_agg import scatter_agg as jax_scatter_agg
from repro.kernels.scatter_agg import segment_rows as jax_segment_rows
from repro.kernels.switch_blend import switch_blend as jax_switch_blend
from repro.kernels.topk_block import block_topk as jax_block_topk
from repro.kernels.unpack_mma import unpack_mma as jax_unpack_mma
from repro_torch import kernels
from repro_torch.comm import payloads
from repro_torch.kernels import ops, ref
from repro_torch.kernels.quantize_ef import quantize_ef
from repro_torch.kernels.quantize_ef_pack import quantize_ef_pack
from repro_torch.kernels.scatter_agg import scatter_agg, segment_rows
from repro_torch.kernels.switch_blend import switch_blend
from repro_torch.kernels.topk_block import block_topk
from repro_torch.kernels.unpack_mma import unpack_mma
from torch_port_util import (assert_bits_equal,  # noqa: F401
                             assert_within_ulp, one_thread, t)

pytestmark = pytest.mark.usefixtures("one_thread")

# (nblocks, block, k): the reduced config's blocks 42/126 and the full
# config's 960/640/320 at ratio 0.1
TOPK_SHAPES = [(5, 42, 4), (3, 126, 13), (2, 960, 96), (2, 640, 64),
               (2, 320, 32)]



def _rows(nblocks, block, seed, special=True):
    """Normal rows, plus (when there is room) an all-zero row, a row of
    heavy ties, and a row mixing -0.0/+0.0 with a few values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nblocks, block)).astype(np.float32)
    if special and nblocks >= 3:
        x[0] = 0.0
        x[1] = np.round(x[1] * 2) / 2          # magnitudes tie in groups
        x[2] = np.where(rng.random(block) < 0.5, -0.0, 0.0)
        x[2, ::7] = rng.standard_normal(len(x[2, ::7]))
    return x


@pytest.mark.parametrize("nblocks,block,k", TOPK_SHAPES)
def test_block_topk_matches_pallas(nblocks, block, k):
    x = _rows(nblocks, block, seed=block + k)
    vj, ij = jax_block_topk(jnp.asarray(x), k)
    vt, it = block_topk(t(x), k)
    assert it.dtype == torch.int32
    assert_bits_equal(vt, vj)
    assert_bits_equal(it, ij)


def _special_rows(block, seed):
    """NaNs of two payloads (``0x7FC00000`` at a lower index than
    ``0x7FC00001``, and a negative one) beside +-inf and +-0; a row of
    equal magnitudes; a row of +-0; a normal row."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, block)).astype(np.float32)
    bits = x[0].view(np.uint32)
    bits[[2, block // 2, block - 3]] = [0x7FC00000, 0x7FC00001, 0xFFC1FFFF]
    x[0, [1, block - 1]] = [np.inf, -np.inf]
    x[0, [3, 4]] = [-0.0, 0.0]
    x[1] = 1.5
    x[1, ::3] = -1.5
    x[2] = np.where(rng.random(block) < 0.5, -0.0, 0.0)
    return x


@pytest.mark.parametrize("block,k", [(16, 1), (16, 5), (16, 16), (42, 1),
                                     (42, 42), (126, 13), (126, 126),
                                     (960, 1), (960, 96)])
def test_block_topk_special_rows_match_pallas(block, k):
    """NaNs tie whatever their payload (index order, ahead of +-inf),
    -0.0 ties +0.0, equal magnitudes go in index order; k = 1 and
    k = block.  Indices and values bit-equal, except that the reference
    reads a value out by a masked sum, which turns a chosen -0.0 into
    +0.0: zeros are compared by value."""
    x = _special_rows(block, seed=block + k)
    vj, ij = jax_block_topk(jnp.asarray(x), k)
    vt, it = block_topk(t(x), k)
    assert_bits_equal(it, ij)
    assert_bits_equal(vt + 0.0, vj)
    if k >= 5:
        assert it[0, :5].tolist() == [2, block // 2, block - 3, 1,
                                      block - 1]


@pytest.mark.parametrize("block", [42, 126, 960, 640])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_ef_pack_matches_pallas(block, bits):
    rng = np.random.default_rng(block * 10 + bits)
    nblocks = 4
    e = (rng.standard_normal((nblocks, block)) * 0.1).astype(np.float32)
    d = rng.standard_normal((nblocks, block)).astype(np.float32)
    e[0] = 0.0
    d[0] = 0.0                                # scale 0: codes L, v 0
    d[1] = np.round(d[1] * 4) / 4             # exact ties on the grid
    e[1] = 0.0
    wj, sj, ej = jax_qef_pack(jnp.asarray(e), jnp.asarray(d), bits)
    wt, st, et = quantize_ef_pack(t(e), t(d), bits)
    assert wt.dtype == torch.uint32 and wt.shape == wj.shape
    assert_bits_equal(wt, wj)
    assert_bits_equal(st, sj)
    assert_within_ulp(et, ej, 2, 
                      of=np.broadcast_to(np.asarray(sj), e.shape))


@pytest.mark.parametrize("block", [42, 126, 960, 640])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_unpack_mma_matches_pallas(block, bits):
    rng = np.random.default_rng(block + bits)
    n_cl, nblocks = 3, 4
    L = 2 ** (bits - 1) - 1
    codes = rng.integers(-L, L + 1, size=(n_cl, nblocks, block))
    words = np.asarray(jax_pack_codes(jnp.asarray(codes, jnp.int32), bits))
    scale = rng.random((n_cl, nblocks)).astype(np.float32)
    scale[1, 2] = 0.0
    weight = np.array([1.0, 0.0, 0.5], np.float32)
    want = jax_unpack_mma(jnp.asarray(words), jnp.asarray(scale),
                          jnp.asarray(weight), bits, block)
    got = unpack_mma(t(words), t(scale), t(weight), bits, block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("block,k", [(42, 4), (126, 13), (960, 96),
                                     (640, 64)])
def test_scatter_agg_matches_pallas(block, k):
    rng = np.random.default_rng(block)
    n_cl, nblocks = 3, 5
    vals = rng.standard_normal((n_cl, nblocks, k)).astype(np.float32)
    idx = rng.integers(0, block, size=(n_cl, nblocks, k)).astype(np.uint16)
    idx[0, 0, :] = idx[0, 0, 0]               # every slot on one offset
    idx[1, :, 1] = idx[1, :, 0]               # a duplicate in each row
    weight = np.array([1.0, 0.25, 0.0], np.float32)
    want = jax_scatter_agg(jnp.asarray(vals), jnp.asarray(idx),
                           jnp.asarray(weight), block)
    got = scatter_agg(t(vals), t(idx), t(weight), block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dups", [False, True])
@pytest.mark.parametrize("block,k", [(42, 4), (126, 13), (960, 96)])
def test_scatter_agg_drops_offsets_past_the_block(block, k, dups):
    """Offsets >= block (up to 65535) drop, as the reference's one-hot
    drops them; with distinct offsets in a row every output gets one
    product per client, added client by client as in the reference, so
    the sums are bit-equal; with duplicate offsets inside one client's
    row they are reordered sums (allclose, as above)."""
    rng = np.random.default_rng(block + k)
    n_cl, nblocks = 3, 4
    vals = rng.standard_normal((n_cl, nblocks, k)).astype(np.float32)
    idx = np.stack([np.stack([rng.permutation(block + 40)[:k]
                              for _ in range(nblocks)])
                    for _ in range(n_cl)]).astype(np.uint16)
    idx[:, 0, 0] = 65535
    if dups:
        idx[0, 1, 1:] = idx[0, 1, 0]
        idx[2, :, 0] = idx[2, :, 1]
    weight = np.array([1.0, 0.3, 2.0], np.float32)
    want = jax_scatter_agg(jnp.asarray(vals), jnp.asarray(idx),
                           jnp.asarray(weight), block)
    got = scatter_agg(t(vals), t(idx), t(weight), block)
    if dups:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    else:
        assert_bits_equal(got, want)


def test_scatter_agg_plain_adds_in_slot_order():
    """The plain version (the kernel's specification) adds client by
    client and, within a client, slot by slot, duplicates included: the
    sums equal numpy's unbuffered sequential ``add.at`` bit for bit."""
    rng = np.random.default_rng(3)
    n_cl, nblocks, k, block = 3, 4, 64, 40
    vals = (rng.standard_normal((n_cl, nblocks, k))
            * 10.0 ** rng.uniform(-4, 4, (n_cl, nblocks, k))) \
        .astype(np.float32)
    idx = rng.integers(0, block + 8, size=(n_cl, nblocks, k))
    weight = np.array([1.0, 0.7, 3.0], np.float32)
    want = np.zeros((nblocks, block), np.float32)
    for j in range(n_cl):
        for b in range(nblocks):
            keep = idx[j, b] < block
            np.add.at(want[b], idx[j, b][keep], vals[j, b][keep] * weight[j])
    got = scatter_agg(t(vals), payloads.to_u16(t(idx)), t(weight), block)
    assert_bits_equal(got, want)


def test_plain_versions_take_strided_run_views():
    """The wrappers take run views of ``[n, d]`` buffers (free leading
    stride), as the flat codecs pass them, with the same results as
    contiguous copies."""
    rng = np.random.default_rng(0)
    buf = t(rng.standard_normal((3, 5 * 42 + 7)).astype(np.float32))
    view = buf[:, 7:].reshape(3, 5, 42)
    assert not view.is_contiguous()
    for a, b in zip(block_topk(view, 4), block_topk(view.contiguous(), 4)):
        assert torch.equal(a, b)
    zero = torch.zeros_like(view)
    for a, b in zip(quantize_ef_pack(zero, view, 4),
                    quantize_ef_pack(zero.contiguous(), view.contiguous(), 4)):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.uint32
                           else a, b.view(torch.int32)
                           if b.dtype == torch.uint32 else b)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("block", [42, 126, 960])
def test_pack_codes_round_trip_and_reference_words(bits, block):
    rng = np.random.default_rng(bits)
    L = 2 ** (bits - 1) - 1
    codes = rng.integers(-L, L + 1, size=(3, block))
    words = payloads.pack_codes(t(codes), bits)
    assert_bits_equal(words, jax_pack_codes(jnp.asarray(codes, jnp.int32),
                                            bits))
    back = payloads.unpack_codes(words, bits, block)
    assert np.array_equal(back.numpy(), codes)


@pytest.mark.parametrize("block,k", [(42, 4), (126, 13), (126, 126)])
def test_select_topk_blocks_exact_regime_matches_reference(block, k):
    x = _rows(3, block, seed=k)
    jv, ji = jax_select(jnp.asarray(x), k, False)
    v, i = payloads.select_topk_blocks(t(x), k, False)
    assert i.dtype == torch.uint16
    assert_bits_equal(v, jv)
    assert_bits_equal(i, ji)


def test_plain_versions_agree_with_the_oracles():
    """``kernels.ref``: torch.topk on tie-free rows, and the unfused EF14
    step's residual."""
    rng = np.random.default_rng(5)
    x = t(rng.standard_normal((6, 126)).astype(np.float32))
    for a, b in zip(block_topk(x, 13), ref.block_topk_ref(x, 13)):
        assert torch.equal(a, b)
    e = t((rng.standard_normal((4, 960)) * 0.1).astype(np.float32))
    d = t(rng.standard_normal((4, 960)).astype(np.float32))
    _, scale, e_new = quantize_ef_pack(e, d, 8)
    _, e_ref = ref.quantize_ef_ref(e, d, 8)
    assert_within_ulp(e_new, e_ref, 2, of=scale.expand_as(e))


def test_wrappers_on_cpu_do_not_launch():
    kernels.reset_launches()
    x = torch.randn(2, 3, 42)
    block_topk(x, 4)
    quantize_ef_pack(x, x, 8)
    assert set(kernels.launch_counts().values()) == {0}


# (m, n, D, ids): unique ids, duplicates, negative and >= n ids; D not a
# multiple of the reference's 512-column tile
SEGMENT_CASES = [(3, 5, 700, [4, 0, 2]),
                 (4, 4, 513, [1, 1, 3, 1]),
                 (5, 6, 37, [-1, 2, 6, 9, 2]),
                 (1, 3, 1024, [2])]


@pytest.mark.parametrize("m,n,D,ids", SEGMENT_CASES)
def test_segment_rows_matches_pallas(m, n, D, ids):
    rng = np.random.default_rng(m * n + D)
    rows = rng.standard_normal((m, D)).astype(np.float32)
    rows[0, :5] = -0.0
    seg = np.asarray(ids, np.int32)
    want = jax_segment_rows(jnp.asarray(rows), jnp.asarray(seg), n,
                            interpret=True)
    got = segment_rows(t(rows), t(seg), n)
    assert got.dtype == torch.float32 and got.shape == (n, D)
    assert_bits_equal(got, want)
    # the ops entry point takes any leading layout and the int64 ids the
    # engine holds
    got3 = ops.segment_rows(t(rows).reshape(m, 7, -1) if D % 7 == 0 else
                            t(rows), t(seg).to(torch.int64), n)
    assert_bits_equal(got3.reshape(n, D), want)


@pytest.mark.parametrize("block", [42, 126, 1024])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_ef_matches_pallas(block, bits):
    rng = np.random.default_rng(block * 3 + bits)
    nblocks = 4
    e = (rng.standard_normal((nblocks, block)) * 0.1).astype(np.float32)
    d = rng.standard_normal((nblocks, block)).astype(np.float32)
    e[0] = 0.0
    d[0] = 0.0                                # scale 0: v 0, e' 0
    d[1] = np.round(d[1] * 4) / 4             # exact ties on the grid
    e[1] = 0.0
    vj, ej = jax_quantize_ef(jnp.asarray(e), jnp.asarray(d), bits,
                             interpret=True)
    vt, et = quantize_ef(t(e), t(d), bits)
    scale = np.abs(e + d).max(axis=-1, keepdims=True)
    of = np.broadcast_to(scale, e.shape)
    assert_within_ulp(vt, vj, 2, of=of)
    assert_within_ulp(et, ej, 2, of=of)
    assert not vt[0].any() and not et[0].any()


def test_quantize_ef_apply_blocks_any_shape():
    """The ops entry point pads the flattened array to whole blocks, and its
    result is the blocked kernel's on the padded buffer, cut back."""
    rng = np.random.default_rng(11)
    e = t((rng.standard_normal((5, 77)) * 0.1).astype(np.float32))
    d = t(rng.standard_normal((5, 77)).astype(np.float32))
    v, e_new = ops.quantize_ef_apply(e, d, 8, block=128)
    assert v.shape == e_new.shape == (5, 77)
    pad = torch.zeros(4 * 128 - 385)
    vb, eb = quantize_ef(torch.cat([e.reshape(-1), pad]).reshape(4, 128),
                         torch.cat([d.reshape(-1), pad]).reshape(4, 128), 8)
    assert torch.equal(v.reshape(-1), vb.reshape(-1)[:385])
    assert torch.equal(e_new.reshape(-1), eb.reshape(-1)[:385])
    assert torch.equal(v + e_new, e + d)


@pytest.mark.parametrize("d", [1, 4096, 5000])
@pytest.mark.parametrize("sigma", [0.0, 0.25, 1.0])
def test_switch_blend_matches_pallas(d, sigma):
    rng = np.random.default_rng(d)
    gf = rng.standard_normal(d).astype(np.float32)
    gg = rng.standard_normal(d).astype(np.float32)
    s = np.float32(sigma)
    want = jax_switch_blend(jnp.asarray(gf), jnp.asarray(gg), jnp.asarray(s),
                            interpret=True)
    got = switch_blend(t(gf), t(gg), t(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_switch_blend_tree_matches_pallas():
    """The port of ``TestSwitchBlendParity``: the blend over a parameter
    tree keeps every leaf's shape and matches the reference's tree blend."""
    rng = np.random.default_rng(0)
    gf = {"a": rng.standard_normal((130, 7)).astype(np.float32),
          "b": {"c": rng.standard_normal(33).astype(np.float32)}}
    gg = {"a": gf["a"] * 0.3 + 1.0, "b": {"c": gf["b"]["c"] * 0.3 + 1.0}}
    tf = {"a": t(gf["a"]), "b": {"c": t(gf["b"]["c"])}}
    tg = {"a": t(gg["a"]), "b": {"c": t(gg["b"]["c"])}}
    for sigma in (0.0, 0.25, 1.0):
        s = np.float32(sigma)
        want = jax_switch_blend_tree(gf, gg, jnp.asarray(s), block=64,
                                     interpret=True)
        got = ops.switch_blend_tree(tf, tg, t(s))
        assert got["a"].shape == (130, 7) and got["b"]["c"].shape == (33,)
        np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got["b"]["c"].numpy(),
                                   np.asarray(want["b"]["c"]), rtol=1e-6,
                                   atol=1e-7)
