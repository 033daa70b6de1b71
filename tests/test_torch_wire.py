"""Cross-process federation, ``repro_torch.wire``: the port against the JAX
package's ``repro.wire`` and against its own single-process engine.

* The codec is byte-identical: the same numpy payloads and header fields
  give the same frame bytes in both packages (every payload tag, scalars,
  header extremes), each package decodes the other's frames, and every
  malformed frame raises ``FrameError`` with the reference's own message.
  Tolerance: none (bytes and messages compared for equality).
* ``payload_signature`` / ``row_signature`` equal the reference's for the
  same configs on the reduced smollm's parameters (string equality).
* The port's own law: ``wire_drive`` (threads, 2 workers, both frame
  orders; one ``spawn="process"`` case) is bit-equal to the port's
  ``rounds.drive`` on ``np`` at n = 8, m = 4 -- state w, x, e_up, the
  averaged iterate, the participation generator, and every metric -- on
  the ``packed`` and ``pallas`` wires (the kernels' plain versions here),
  quant4 and top-k, ``fedsgm`` and ``fedsgm-soft``.  Tolerance: none.
* Across packages: with m = n every client is in every cohort, so the
  packages' sampler draws do not matter, and top-k and quant draw nothing;
  one numpy-made NP problem is registered in both registries, and the
  port's ``wire_drive`` is held against the reference's (threads) at
  ``tests/test_torch_gather.py``'s tolerances: per-round f, g_hat, sigma
  at rtol 1e-5, ``feasible`` exactly, the final w and e_up with all but
  0.1% of the coordinates within rtol 1e-4 / atol 1e-6 and every one
  within atol 1e-3.
* Chaos (seeded ``ChaosLink``): duplicated frames are idempotent (bit-equal
  to the oracle), dropped frames count as missing, truncated and corrupt
  frames are rejected while the run completes, delayed frames park with
  their origin age; a restart from a checkpoint continues the oracle's
  trajectory bit for bit; the buffer sidecar's signature pins the
  transport.
* The launcher: ``--wire 2 --device cpu`` equals ``drive`` on the ``lm``
  problem bit for bit; ``--fleet``, ``--async-buffer``, ``--obs`` and
  ``--ef-slots`` end the run with ``SystemExit``.

Sockets bind ephemeral ports (``port=0``), every wait has its own
deadline, and the chaos is seeded, so runs under ``-n 6`` neither collide
nor flake.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.comm import flat as jax_flat
from repro.comm.payloads import FlatPacked as JFlatPacked
from repro.comm.payloads import FlatQuant as JFlatQuant
from repro.configs.base import CompressorConfig as JCompressorConfig
from repro.configs.base import FedConfig as JFedConfig
from repro.configs.base import SwitchConfig as JSwitchConfig
from repro.models import transformer as jax_transformer
from repro.tasks import np_classification as jax_npc
from repro.wire import bootstrap as jax_bootstrap
from repro.wire import coordinator as jax_coordinator
from repro.wire import frames as jframes
from repro.wire import worker as jax_worker
from repro_torch import checkpoint
from repro_torch.comm.payloads import FlatPacked, FlatQuant
from repro_torch.configs.base import (CompressorConfig, FedConfig,
                                      ObsConfig, SwitchConfig)
from repro_torch.engine import async_rounds, rounds
from repro_torch.launch import train
from repro_torch.models import params_from_numpy
from repro_torch.tasks import np_classification as npc
from repro_torch.wire import bootstrap, coordinator, frames, testing
from repro_torch.wire.coordinator import validate_wire_cfg, wire_drive
from repro_torch.wire.worker import client_range
from torch_port_util import assert_bits_equal, t

N = 8
T = 3

KINDS = {
    "quant4": CompressorConfig(kind="quant", bits=4, block=8),
    "topk": CompressorConfig(kind="topk", ratio=0.25, block=8),
}


@pytest.fixture
def one_thread():
    # tiny shapes: one intra-op thread beats contending with the other
    # test workers for the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(strategy="fedsgm", uplink="quant4", **kw):
    mode = "hard" if strategy == "fedsgm" else "soft"
    base = dict(n_clients=N, m=4, local_steps=2, lr=0.1, strategy=strategy,
                switch=SwitchConfig(mode=mode, eps=0.35, beta=2.0),
                uplink=KINDS[uplink], downlink=CompressorConfig(kind="none"),
                participation="gather", full_eval=True, lean_metrics=True,
                comm="packed")
    base.update(kw)
    return FedConfig(**base)


def _oracle(fed, T):
    params, batches, loss_pair = bootstrap.build_problem(
        "np", {"n_clients": fed.n_clients}, device="cpu")
    return rounds.drive(rounds.init_state(params, fed, device="cpu"),
                        batches, loss_pair, fed, T, device="cpu")


def _drive(fed, T, **kw):
    return wire_drive(fed, T, workers=2, spawn=kw.pop("spawn", "thread"),
                      deadline=kw.pop("deadline", 60.0), device="cpu", **kw)


def assert_state_equal(st_o, st_w, label=""):
    for name in ("w", "x", "e_up", "wbar_sum", "wbar_weight"):
        assert_bits_equal(getattr(st_o, name), getattr(st_w, name))
    assert st_o.t == st_w.t, label
    assert torch.equal(st_o.gen.get_state(), st_w.gen.get_state()), label


def assert_metrics_equal(mets_o, mets_w, rows=None):
    for name in rounds.RoundMetrics._fields:
        a = getattr(mets_o, name)
        if a is not None and rows is not None:
            a = a[rows]
        assert_bits_equal(a, getattr(mets_w, name))


# ---------------------------------------------------------------------------
# The codec, byte for byte against the reference
# ---------------------------------------------------------------------------

def _payloads(kind, seed):
    """(the reference's numpy payload, the port's tensor payload)."""
    rng = np.random.default_rng(seed)
    words, blocks = int(rng.integers(1, 65)), int(rng.integers(1, 17))
    if kind == "flatpacked":
        arrs = (rng.random(blocks).astype(np.float32),
                rng.integers(0, 2**16, blocks).astype(np.uint16))
        return JFlatPacked(*arrs), FlatPacked(*map(frames.to_tensor, arrs))
    if kind == "flatquant":
        arrs = (rng.integers(0, 2**32, words, dtype=np.uint32),
                rng.random(2 * blocks).astype(np.float32))
        return JFlatQuant(*arrs), FlatQuant(*map(frames.to_tensor, arrs))
    if kind == "dense":
        arr = rng.standard_normal(words).astype(np.float32)
        return arr, frames.to_tensor(arr)
    if kind == "scalars":
        arrs = (np.float32(rng.standard_normal()),
                np.asarray(rng.integers(-5, 5), np.int64))
        return tuple(np.asarray(a) for a in arrs), tuple(
            frames.to_tensor(np.asarray(a)) for a in arrs)
    arrs = (rng.integers(0, 2**32, words, dtype=np.uint32),
            rng.random((blocks, 3)).astype(np.float32),
            rng.integers(-2**31, 2**31, (2, blocks), dtype=np.int64))
    return arrs, tuple(map(frames.to_tensor, arrs))


PAYLOAD_KINDS = ["flatpacked", "flatquant", "dense", "stack", "scalars"]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", PAYLOAD_KINDS)
def test_payload_bytes_match_reference(kind, seed):
    """The same arrays pack to the same (sig, body) in both packages, and
    each package unpacks the other's body to the same bytes."""
    jp, tp = _payloads(kind, seed)
    jsig, jbody = jframes.pack_payload(jp)
    sig, body = frames.pack_payload(tp)
    assert (sig, body) == (jsig, jbody)
    assert frames.payload_signature(tp) == jframes.payload_signature(jp)
    got = frames.unpack_payload(jsig, jbody)
    want = jframes.unpack_payload(sig, body)
    if isinstance(want, np.ndarray):
        got, want = (got,), (want,)
    assert type(got).__name__ == type(want).__name__ or kind in (
        "stack", "scalars")
    for a, b in zip(got, want):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        a = frames.to_numpy(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == np.asarray(b).tobytes()


HEADERS = [dict(client_id=0, origin_round=0, sigma=0.0, weight=0.0),
           dict(client_id=2**32 - 1, origin_round=-2**31, sigma=1.0,
                weight=8.0),
           dict(client_id=2**31, origin_round=2**31 - 1, sigma=0.3,
                weight=1.375),
           dict(client_id=7, origin_round=-1, sigma=0.73937845,
                weight=2.9)]


@pytest.mark.parametrize("kind", sorted(frames.KIND_NAMES))
@pytest.mark.parametrize("hi", range(len(HEADERS)))
def test_frame_bytes_match_reference(kind, hi):
    """Header fields at their extremes: the same frame bytes, and each
    package decodes the other's frame to the same header and body."""
    h = HEADERS[hi]
    body = bytes(range(kind, kind + 11))
    raw = frames.encode_frame(kind, body, sig="dense|uint8:11", **h)
    assert raw == jframes.encode_frame(kind, body, sig="dense|uint8:11",
                                       **h)
    for decode, data in ((frames.decode_frame, raw),
                         (jframes.decode_frame, raw)):
        header, got = decode(data)
        assert tuple(header) == tuple(jframes.decode_frame(raw)[0])
        assert bytes(got) == body
    assert frames.HEADER_BYTES == jframes.HEADER_BYTES == 30
    assert frames.MAX_FRAME == jframes.MAX_FRAME == 1 << 30


class _Sock:
    """A sink for ``sendall`` / a source for ``recv``."""

    def __init__(self, data=b""):
        self.out = bytearray()
        self.data = bytearray(data)

    def sendall(self, b):
        self.out.extend(b)

    def recv(self, n):
        got = bytes(self.data[:n])
        del self.data[:n]
        return got


def test_stream_io_and_reader_match_reference():
    """``write_frame`` bytes, ``read_frame`` and a ``FrameReader`` fed in
    uneven chunks: the same frames as the reference's."""
    fr = [frames.encode_frame(k, bytes(3 * k), client_id=k, origin_round=k,
                              sig=f"dense|uint8:{3 * k}")
          for k in sorted(frames.KIND_NAMES)]
    a, b = _Sock(), _Sock()
    for f in fr:
        frames.write_frame(a, f)
        jframes.write_frame(b, f)
    assert bytes(a.out) == bytes(b.out)
    src = _Sock(bytes(a.out))
    for f in fr:
        header, body, n = frames.read_frame(src)
        assert (header, body) == jframes.decode_frame(f)
        assert n == len(f) + 4
    assert frames.read_frame(src) is None
    reader, out = frames.FrameReader(), []
    rng = np.random.default_rng(0)
    stream, i = bytes(a.out), 0
    while i < len(stream):
        step = int(rng.integers(1, 40))
        reader.feed(stream[i:i + step])
        out += list(reader.frames())
        i += step
    assert out == fr


def _bad_cases():
    raw = frames.encode_frame(frames.K_UPLINK, b"\x00" * 16, client_id=3,
                              origin_round=5, sig="dense|uint8:16")
    magic = bytearray(raw)
    magic[0] ^= 0xFF
    version = bytearray(raw)
    version[2] = 9
    return {
        "truncated": lambda m: m.decode_frame(
            testing.truncate_frame(raw, cut=4)),
        "short": lambda m: m.decode_frame(raw[:12]),
        "corrupt": lambda m: m.decode_frame(testing.corrupt_frame(raw)),
        "bad_magic": lambda m: m.decode_frame(bytes(magic)),
        "bad_version": lambda m: m.decode_frame(bytes(version)),
        "oversized": lambda m: m.decode_frame(raw + b"trailing-junk"),
        "unknown_tag": lambda m: m.unpack_payload("mystery|float32:4",
                                                  b"\x00" * 16),
        "malformed_leaf": lambda m: m.unpack_payload("dense|float32",
                                                     b"\x00" * 4),
        "body_length": lambda m: m.unpack_payload("dense|float32:4",
                                                  b"\x00" * 12),
        "leaf_count": lambda m: m.unpack_payload(
            "flatpacked|float32:2", b"\x00" * 8),
        "past_max_frame": lambda m: m.read_frame(
            _Sock(m._LEN.pack(m.MAX_FRAME + 1))),
        "mid_frame_eof": lambda m: m.read_frame(_Sock(
            m._LEN.pack(len(raw)) + raw[:10])),
        "reader_past_max": lambda m: list(_fed_reader(m)),
    }


def _fed_reader(m):
    reader = m.FrameReader()
    reader.feed(m._LEN.pack(m.MAX_FRAME + 7))
    return reader.frames()


@pytest.mark.parametrize("case", sorted(_bad_cases()))
def test_malformed_frames_raise_the_reference_error(case):
    """Each malformed input raises ``FrameError`` in both packages, with
    the same message (the same check named, the same values)."""
    fn = _bad_cases()[case]
    with pytest.raises(frames.FrameError) as got:
        fn(frames)
    with pytest.raises(jframes.FrameError) as want:
        fn(jframes)
    assert str(got.value) == str(want.value)


def test_unpacked_leaves_are_copies_on_the_callers_device():
    """``unpack_payload`` gives tensors of its own (writable, not views of
    the frame) on the device asked for; uint16 / uint32 round-trip bit for
    bit through their signed views."""
    words = np.array([0, 1, 2**31, 2**32 - 1], np.uint32)
    offs = np.array([0, 2**15, 2**16 - 1], np.uint16)
    sig, body = frames.pack_payload((frames.to_tensor(words),
                                     frames.to_tensor(offs)))
    w, o = frames.unpack_payload(sig, body, torch.device("cpu"))
    assert (w.dtype, o.dtype) == (torch.uint32, torch.uint16)
    assert frames.to_numpy(w).tolist() == words.tolist()
    assert frames.to_numpy(o).tolist() == offs.tolist()
    w.view(torch.int32).zero_()            # writable, and the body intact
    assert frames.unpack_payload(sig, body)[0].view(torch.int32).any()


# ---------------------------------------------------------------------------
# Signatures against the reference
# ---------------------------------------------------------------------------

SIG_CONFIGS = [("packed", "quant", 8), ("packed", "quant", 4),
               ("packed", "quant", 2), ("pallas", "quant", 8),
               ("packed", "quant", 6), ("dense", "quant", 8),
               ("packed", "topk", 8), ("pallas", "topk", 8),
               ("dense", "topk", 8), ("packed", "randk", 8),
               ("packed", "none", 8), ("dense", "natural", 8)]


@pytest.fixture(scope="module")
def smollm_params():
    jcfg = jax_configs.get_reduced("smollm-360m")
    jparams = jax.device_get(jax_transformer.init(jax.random.PRNGKey(0),
                                                  jcfg))
    return jparams, params_from_numpy(jparams)


@pytest.mark.parametrize("comm,kind,bits", SIG_CONFIGS)
def test_row_signature_matches_reference(comm, kind, bits, smollm_params):
    jparams, params = smollm_params
    kw = dict(n_clients=4, m=2, comm=comm, participation="gather")
    fed = FedConfig(uplink=CompressorConfig(kind=kind, bits=bits), **kw)
    jfed = JFedConfig(uplink=JCompressorConfig(kind=kind, bits=bits), **kw)
    sig = frames.row_signature(params, fed)
    assert sig == jframes.row_signature(jparams, jfed)
    state = rounds.init_state(params, fed, device="cpu")
    assert frames.row_signature(state.spec, fed) == sig
    msgs = async_rounds.wire_msg_struct(state.spec, fed)
    row = msgs[0] if isinstance(msgs, torch.Tensor) else \
        type(msgs)(*(x[0] for x in msgs))
    assert frames.payload_signature(row) == sig


@pytest.mark.parametrize("bits,d", [(2, 64), (4, 64), (8, 64), (2, 69),
                                    (4, 69), (8, 69)])
def test_transport_rows_cross_both_codecs(bits, d):
    """A real packed transport row -- every quantizer width over a
    word-multiple (64) and a non-word-multiple (69) buffer -- crosses both
    packages' codecs byte for byte, under the reference's row
    signature."""
    from repro_torch.comm import flat
    fed = _cfg(uplink="quant4").replace(
        uplink=CompressorConfig(kind="quant", bits=bits, block=8))
    params = {"w": torch.zeros(d)}
    uplink, _ = flat.flat_transports_for(fed, flat.spec_of(params))
    delta = t(np.random.default_rng(d + bits).standard_normal(
        (1, d)).astype(np.float32))
    msgs, _ = uplink._ef_clients(torch.zeros((1, d)), delta, None, None)
    row = type(msgs)(*(x[0] for x in msgs))
    sig, body = frames.pack_payload(row)
    jfed = JFedConfig(n_clients=N, m=4, comm="packed",
                      participation="gather",
                      uplink=JCompressorConfig(kind="quant", bits=bits,
                                               block=8))
    assert sig == jframes.row_signature({"w": jnp.zeros(d)}, jfed)
    back = jframes.unpack_payload(sig, body)
    assert jframes.pack_payload(back) == (sig, body)
    for a, b in zip(frames.unpack_payload(sig, body), row):
        assert_bits_equal(a, b)


@pytest.mark.parametrize("n,workers", [(1, 1), (8, 2), (8, 3), (7, 4),
                                       (64, 8), (5, 5), (13, 6)])
def test_client_ranges_tile_as_the_reference(n, workers):
    ranges = [client_range(n, workers, i) for i in range(workers)]
    assert ranges == [jax_worker.client_range(n, workers, i)
                      for i in range(workers)]
    ids = np.concatenate([np.arange(lo, hi) for lo, hi in ranges])
    assert np.array_equal(ids, np.arange(n))
    with pytest.raises(ValueError, match="outside"):
        client_range(n, workers, workers)


def test_validate_wire_cfg_lists_every_violation():
    fed = _cfg()
    bad = dataclasses.replace(fed, participation="mask", full_eval=False,
                              lean_metrics=False,
                              obs=ObsConfig(enabled=True))
    with pytest.raises(ValueError) as err:
        validate_wire_cfg(bad)
    msg = str(err.value)
    for knob in ("participation", "full_eval", "lean_metrics",
                 "obs.enabled"):
        assert knob in msg
    validate_wire_cfg(fed)        # the pinned surface passes


def test_fed_json_round_trip():
    fed = _cfg(strategy="fedsgm-soft", uplink="topk", seed=3)
    assert bootstrap.fed_from_json(bootstrap.fed_to_json(fed)) == fed
    with pytest.raises(TypeError):
        bootstrap.fed_from_json('{"no_such_knob": 1}')
    with pytest.raises(KeyError, match="unknown wire problem"):
        bootstrap.build_problem("nope", {}, device="cpu")


# ---------------------------------------------------------------------------
# The port's own law: wire == single-process drive, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", ["direct", "reordered"])
def test_two_worker_thread_parity(order, one_thread):
    """fedsgm x quant4-packed, with the frame arrival order forced both
    ways: chaos reorder shuffles every round's uplink frames."""
    fed = _cfg()
    st_o, mets_o = _oracle(fed, T)
    chaos = {"reorder": True} if order == "reordered" else None
    st_w, mets_w, stats = _drive(fed, T, chaos=chaos)
    assert_state_equal(st_o, st_w, order)
    assert_metrics_equal(mets_o, mets_w)
    assert stats.totals["missing"] == 0 and stats.totals["rejected"] == 0
    assert len(stats.rounds) == T


def test_two_worker_subprocess_parity():
    """Real ``python -c`` worker subprocesses over loopback TCP."""
    fed = _cfg()
    st_o, mets_o = _oracle(fed, T)
    st_w, mets_w, stats = _drive(fed, T, spawn="process", deadline=120.0)
    assert_state_equal(st_o, st_w, "subprocess")
    assert_metrics_equal(mets_o, mets_w)
    assert stats.totals["missing"] == 0


@pytest.mark.parametrize("comm", ["packed", "pallas"])
@pytest.mark.parametrize("strategy", ["fedsgm", "fedsgm-soft"])
@pytest.mark.parametrize("uplink", ["quant4", "topk"])
def test_parity_matrix_threads(comm, strategy, uplink, one_thread):
    fed = _cfg(strategy=strategy, uplink=uplink, comm=comm)
    st_o, mets_o = _oracle(fed, T)
    st_w, mets_w, stats = _drive(fed, T)
    assert_state_equal(st_o, st_w, f"{comm}/{strategy}/{uplink}")
    assert_metrics_equal(mets_o, mets_w)
    # the kinds traffic: 2 ACTIVATE + 2 SIGMA out, 2 EVAL + 2 ROUND_DONE +
    # m UPLINK in, every round
    kinds = stats.by_kind
    assert kinds["activate"][0] == kinds["sigma"][0] == 2 * T
    assert kinds["uplink"][0] == fed.m * T
    assert kinds["ef_dump"][0] == 2


def test_identity_uplink_and_compressed_downlink(one_thread):
    """No uplink compression (a dense wire, no residual anywhere) and a
    top-k downlink (the server center tracked)."""
    fed = _cfg(uplink="topk").replace(
        uplink=CompressorConfig(kind="none"), downlink=KINDS["topk"])
    st_o, mets_o = _oracle(fed, T)
    st_w, mets_w, _ = _drive(fed, T)
    assert st_w.e_up is None and st_w.x is not None
    assert_state_equal(st_o, st_w, "identity up")
    assert_metrics_equal(mets_o, mets_w)


# ---------------------------------------------------------------------------
# Across packages: the port's wire against the reference's wire
# ---------------------------------------------------------------------------

_NP = {}


def _np_arrays(n):
    if n not in _NP:
        rng = np.random.default_rng(7)
        x = rng.standard_normal((n, 24, 6)).astype(np.float32)
        y = (rng.random((n, 24)) < 0.3).astype(np.float32)
        _NP[n] = (x, y)
    return _NP[n]


@jax_bootstrap.problem("np_numpy_wire_test")
def _jax_np_problem(args):
    x, y = _np_arrays(int(args["n_clients"]))
    return (jax_npc.init_params(None, x.shape[-1]),
            (jnp.asarray(x), jnp.asarray(y)), jax_npc.loss_pair)


@bootstrap.problem("np_numpy_wire_test")
def _np_problem(args, device):
    x, y = _np_arrays(int(args["n_clients"]))
    return (npc.init_params(x.shape[-1], device=device),
            npc.NPBatch(t(x).to(device), t(y).to(device)), npc.loss_pair)


@pytest.mark.parametrize("uplink", [("topk", 0.25, 8), ("quant", 0.1, 8)])
def test_wire_matches_reference_wire(uplink, one_thread):
    kind, ratio, bits = uplink
    kw = dict(n_clients=4, m=4, local_steps=2, lr=0.1, strategy="fedsgm",
              participation="gather", full_eval=True, lean_metrics=True,
              comm="packed")
    fed = FedConfig(switch=SwitchConfig(mode="soft", eps=0.5, beta=2.0),
                    uplink=CompressorConfig(kind=kind, ratio=ratio,
                                            bits=bits, block=8), **kw)
    jfed = JFedConfig(switch=JSwitchConfig(mode="soft", eps=0.5, beta=2.0),
                      uplink=JCompressorConfig(kind=kind, ratio=ratio,
                                               bits=bits, block=8), **kw)
    st, mets, _ = wire_drive(fed, T, workers=2, spawn="thread",
                             problem="np_numpy_wire_test", deadline=60.0,
                             device="cpu")
    jst, jmets, _ = jax_coordinator.wire_drive(
        jfed, T, workers=2, spawn="thread", problem="np_numpy_wire_test",
        deadline=60.0)
    np.testing.assert_allclose(
        np.stack([mets.f, mets.g_hat, mets.sigma]),
        np.stack([np.asarray(jmets.f), np.asarray(jmets.g_hat),
                  np.asarray(jmets.sigma)]), rtol=1e-5)
    assert np.array_equal(mets.feasible, np.asarray(jmets.feasible))
    assert np.array_equal(mets.up_bytes, np.asarray(jmets.up_bytes))
    jw = np.asarray(jax_flat.flatten(jax_flat.spec_of(jst.w), jst.w))
    for got, want in ((st.w.numpy(), jw),
                      (st.e_up.numpy(), np.asarray(jst.e_up))):
        close = np.isclose(got, want, rtol=1e-4, atol=1e-6)
        assert (~close).mean() <= 1e-3
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert np.abs(st.e_up.numpy()).max() > 0


# ---------------------------------------------------------------------------
# Chaos
# ---------------------------------------------------------------------------

def test_duplicated_frames_are_idempotent(one_thread):
    """dup=1.0 retransmits EVERY uplink frame; dedup by (client id, origin
    round) keeps the run bit-identical to the oracle."""
    fed = _cfg()
    st_o, mets_o = _oracle(fed, T)
    st_w, mets_w, stats = _drive(fed, T, chaos={"dup": 1.0})
    assert_state_equal(st_o, st_w, "dup")
    assert_metrics_equal(mets_o, mets_w)
    duped = sum(w.link.duped for w in stats.workers)
    assert duped > 0 and stats.totals["dup"] == duped
    assert stats.totals["missing"] == 0


def test_dropped_frames_count_as_missing(one_thread):
    _, _, stats = _drive(_cfg(), T, chaos={"drop": 0.5})
    dropped = sum(w.link.dropped for w in stats.workers)
    assert dropped > 0
    assert stats.totals["missing"] == dropped
    assert len(stats.rounds) == T     # the run completed every round


@pytest.mark.parametrize("fault", ["truncate", "corrupt"])
def test_malformed_frames_rejected_run_completes(fault, one_thread):
    _, mets_w, stats = _drive(_cfg(), T, chaos={fault: 1.0})
    counter = {"truncate": "truncated", "corrupt": "corrupted"}[fault]
    injected = sum(getattr(w.link, counter) for w in stats.workers)
    assert injected > 0
    assert stats.totals["rejected"] == injected
    assert len(stats.rounds) == T
    assert np.all(np.isfinite(mets_w.f))


def test_delayed_frames_park_with_origin_age(one_thread):
    """delay=1.0 holds every uplink frame one round: each arrives during
    round t+1, parks with age 1, and merges under the staleness law at the
    next server step."""
    fed = _cfg()
    _, mets, stats = _drive(fed, T + 2,
                            chaos={"delay": 1.0, "delay_rounds": 1})
    delayed = sum(w.link.delayed for w in stats.workers)
    assert delayed > 0
    assert stats.totals["parked"] > 0 and stats.totals["merged_stale"] > 0
    assert set(stats.merge_ages) == {1.0}
    assert stats.totals["missing"] > 0      # every fresh frame was held
    assert np.all(np.isfinite(mets.f))


# ---------------------------------------------------------------------------
# Checkpoint / restart and the sidecar's signature
# ---------------------------------------------------------------------------

def test_restart_continues_oracle_trajectory(tmp_path, one_thread):
    fed = _cfg()
    ckpt = str(tmp_path / "wire_ckpt")
    st_o, mets_o = _oracle(fed, 2 * T)
    _drive(fed, T, ckpt_dir=ckpt, ckpt_every=T)
    assert checkpoint.latest_round(ckpt) == T
    st_w, mets_w, _ = _drive(fed, 2 * T, ckpt_dir=ckpt, resume=True)
    assert_state_equal(st_o, st_w, "restart")
    # the resumed run's metrics cover rounds [T, 2T)
    assert_metrics_equal(mets_o, mets_w, rows=slice(T, 2 * T))


def _coordinator(fed):
    params, _, _ = bootstrap.build_problem("np", {"n_clients": N},
                                           device="cpu")
    return coordinator.Coordinator(params, fed, device="cpu")


def test_buffer_sidecar_signature_pins_transport(tmp_path):
    """The parked-frame sidecar records its payload signature; restore
    under another transport config fails loudly, naming both."""
    fed = _cfg(uplink="quant4")
    other = dataclasses.replace(fed, uplink=KINDS["topk"])
    coord = _coordinator(fed)
    ckpt = str(tmp_path / "buf_ckpt")
    checkpoint.save_buffer(ckpt, 5, coord._host_buffer(),
                           metadata={"payload_sig": coord.row_sig})
    meta = checkpoint.read_metadata(str(tmp_path / "buf_ckpt" /
                                        "round_5_buffer"))
    assert meta["payload_sig"] == coord.row_sig
    assert async_rounds.buffer_from_wire(
        None, coord.state, fed, sig=meta["payload_sig"]) is None
    with pytest.raises(ValueError, match="signature mismatch") as err:
        async_rounds.buffer_from_wire(coord._host_buffer(), coord.state,
                                      other, sig=meta["payload_sig"])
    assert coord.row_sig in str(err.value)
    assert frames.row_signature(coord.spec, other) in str(err.value)
    assert "cfg.uplink" in str(err.value)
    coord.close()


def test_coordinator_rejects_mismatched_uplink_sig():
    """A frame whose payload signature disagrees with this process's
    transport config fails before any decode or merge."""
    coord = _coordinator(_cfg(uplink="quant4"))
    bad = frames.FrameHeader(kind=frames.K_UPLINK, client_id=0,
                             origin_round=0, sigma=0.0, weight=1.0,
                             sig="dense|float32:31")
    with pytest.raises(ValueError, match="signature mismatch"):
        coord._on_uplink(bad, b"\x00" * (31 * 4), None)
    coord.close()


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

LAUNCH = ["--device", "cpu", "--clients", "4", "--participating", "2",
          "--comm", "pallas", "--uplink", "topk", "--rounds", "3", "--seq",
          "16", "--quiet"]


def test_launcher_wire_equals_drive_on_lm(tmp_path):
    """``--wire 2`` (two worker processes, the reduced LM problem) against
    ``drive`` on ``build_problem("lm")`` with the launcher's FedConfig:
    state and every round's f, g_hat, sigma bit-equal."""
    path = tmp_path / "wire.jsonl"
    state = train.main(["--wire", "2", "--sink", "jsonl", "--sink-path",
                        str(path)] + LAUNCH)
    fed = FedConfig(n_clients=4, m=2, local_steps=1, lr=0.03,
                    switch=SwitchConfig(mode="soft", eps=0.0, beta=2.0),
                    uplink=CompressorConfig(kind="topk", ratio=0.1),
                    downlink=CompressorConfig(kind="none"), comm="pallas",
                    participation="gather", full_eval=True,
                    lean_metrics=True)
    params, batches, pair = bootstrap.build_problem(
        "lm", {"n_clients": 4, "batch": 2, "seq": 16}, device="cpu")
    st_o, mets_o = rounds.drive(rounds.init_state(params, fed, device="cpu"),
                                batches, pair, fed, 3, device="cpu")
    for name in ("w", "e_up", "wbar_sum"):
        assert_bits_equal(getattr(st_o, name), getattr(state, name))
    import json
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert recs[0]["meta"]["wire_workers"] == 2
    recs = [r for r in recs[1:] if r["round"] >= 0]
    assert [r["round"] for r in recs] == [0, 1, 2]
    for key in ("f", "g_hat", "sigma"):
        assert [r[key] for r in recs] == [float(v)
                                          for v in getattr(mets_o, key)]
    assert all(r["wire_frames"] > 0 and r["wire_missing"] == 0
               for r in recs)


@pytest.mark.parametrize("flag", [["--fleet"], ["--async-buffer"],
                                  ["--obs"], ["--ef-slots", "2"]])
def test_launcher_refuses_flags_the_wire_cannot_drive(flag):
    with pytest.raises(SystemExit, match="not drivable over the wire"):
        train.main(["--wire", "2"] + flag + LAUNCH)
