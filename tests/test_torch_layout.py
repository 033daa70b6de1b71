"""The port's flat layout and wire codecs against the JAX package's.

* ``FlatSpec`` / ``WireLayout`` of the FULL smollm-360m, from shapes only
  (``meta`` tensors here, ``jax.eval_shape`` there): leaf order, offsets,
  the 8 runs, K/NB/W totals and ``wire_bytes`` must be equal.
* ``FlatTransport.encode`` / ``reduce`` on the reduced config with the same
  injected residuals and deltas: payloads bit-equal, residuals exact (top-k)
  or within 2 ulp of the block scale (quant, see test_torch_kernels.py),
  ``v_bar`` allclose at rtol 1e-5 (reordered sums: the reference's CPU plan
  for the top-k reduce is a factored one-hot GEMM).
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.comm import flat as jax_flat
from repro.comm import transports as jax_transports
from repro.configs.base import CompressorConfig as JaxCompressorConfig
from repro.models import transformer as jax_transformer
from repro_torch import configs
from repro_torch.comm import flat, transports
from repro_torch.configs.base import CompressorConfig
from repro_torch.models import params_from_numpy, transformer
from torch_port_util import (assert_bits_equal,  # noqa: F401
                             assert_within_ulp, one_thread, t)

pytestmark = pytest.mark.usefixtures("one_thread")


def _jax_spec(cfg):
    shapes = jax.eval_shape(lambda k: jax_transformer.init(k, cfg),
                            jax.random.PRNGKey(0))
    paths = [tuple(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(shapes)[0]]
    return jax_flat.spec_of(shapes), paths



def _meta_params(cfg):
    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return torch.empty(tree, device="meta")
    return walk(transformer.param_shapes(cfg))


def test_full_smollm_flat_spec_matches_reference():
    jspec, jpaths = _jax_spec(jax_configs.get_config("smollm-360m"))
    spec = flat.spec_of(_meta_params(configs.get_config("smollm-360m")))
    assert spec.d == jspec.d == 361_821_120
    assert list(spec.paths) == jpaths
    assert [(l.shape, l.offset, l.size) for l in spec.leaves] == \
        [(l.shape, l.offset, l.size) for l in jspec.leaves]


@pytest.mark.parametrize("kind,bits", [("topk", 8), ("quant", 8),
                                       ("quant", 4), ("quant", 2)])
def test_full_smollm_wire_layout_matches_reference(kind, bits):
    jspec, _ = _jax_spec(jax_configs.get_config("smollm-360m"))
    spec = flat.spec_of(_meta_params(configs.get_config("smollm-360m")))
    jcc = JaxCompressorConfig(kind=kind, ratio=0.1, bits=bits)
    cc = CompressorConfig(kind=kind, ratio=0.1, bits=bits)
    jlay = jax_flat.wire_layout(jspec, jcc)
    lay = flat.wire_layout(spec, cc)
    assert [tuple(r) for r in lay.runs] == [tuple(r) for r in jlay.runs]
    assert [tuple(lw) for lw in lay.leaves] == \
        [tuple(lw) for lw in jlay.leaves]
    assert (lay.K_total, lay.NB_total, lay.W_total) == \
        (jlay.K_total, jlay.NB_total, jlay.W_total)
    assert [r.block for r in lay.runs] == [960, 320, 960, 320, 960, 960,
                                           640, 960]
    jup = jax_flat.FlatTransport(
        jax_transports.get_transport(jcc, "pallas"), jspec)
    up = flat.FlatTransport(transports.get_transport(cc, "pallas"), spec)
    assert up.wire_bytes() == jup.wire_bytes()
    if kind == "topk":
        assert (lay.K_total, lay.NB_total) == (36_182_112, 499_777)
        assert up.wire_bytes() == 6 * lay.K_total
    else:
        assert up.wire_bytes() == 4 * (lay.W_total + lay.NB_total)


def _reduced_params():
    cfg = jax_configs.get_reduced("smollm-360m")
    params = jax.device_get(jax_transformer.init(jax.random.PRNGKey(0), cfg))
    return cfg, params


@pytest.mark.parametrize("kind,bits", [("topk", 8), ("quant", 8),
                                       ("quant", 4)])
def test_reduced_codec_transmit_matches_reference(kind, bits):
    _, jparams = _reduced_params()
    jspec = jax_flat.spec_of(jparams)
    spec = flat.spec_of(params_from_numpy(jparams))
    rng = np.random.default_rng(bits)
    n_cl = 3
    e = (rng.standard_normal((n_cl, spec.d)) * 0.01).astype(np.float32)
    deltas = rng.standard_normal((n_cl, spec.d)).astype(np.float32)
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    m = 2

    jcc = JaxCompressorConfig(kind=kind, ratio=0.1, bits=bits)
    jup = jax_flat.FlatTransport(
        jax_transports.get_transport(jcc, "pallas"), jspec)
    jmsgs, je = jup.encode(jax.numpy.asarray(e), jax.numpy.asarray(deltas),
                           jax.numpy.asarray(mask))
    jv = jup.reduce(jmsgs, jax.numpy.asarray(mask), m)

    cc = CompressorConfig(kind=kind, ratio=0.1, bits=bits)
    up = flat.FlatTransport(transports.get_transport(cc, "pallas"), spec)
    msgs, e_out = up.encode(t(e), t(deltas), t(mask))
    v = up.reduce(msgs, t(mask), m)

    for a, b in zip(msgs, jmsgs):
        assert_bits_equal(a, b)
    if kind == "topk":
        assert_bits_equal(e_out, je)
    else:
        lay = flat.wire_layout(spec, cc)
        scale = np.asarray(jmsgs.scale)
        per_elem = np.concatenate(
            [np.repeat(scale[:, r.boff:r.boff + r.nblocks], r.block, axis=1)
             for r in lay.runs], axis=1)
        assert_within_ulp(e_out, je, 2, of=per_elem)
        assert np.array_equal(e_out.numpy()[1], e[1])   # masked row kept
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
    # decode: exact for top-k; quant's reciprocal rewrite in XLA moves the
    # reference's values by an ulp
    np.testing.assert_allclose(up.codec.decode(msgs).numpy(),
                               np.asarray(jup.codec.decode(jmsgs)),
                               rtol=1e-6 if kind == "quant" else 0, atol=0)
