"""Checkpoints of the port (``repro_torch.checkpoint``, the staleness-buffer
sidecar of ``engine.async_rounds``, the launcher's ``--ckpt-dir``) against
the JAX package and against the uninterrupted run, on the CPU at the NP
size of ``tests/test_scale.py`` (N = 12, m = 4, E = 2).

Tolerances and why:

* save -> restore -> continue against the uninterrupted run (dense
  residual, slot store, async buffer, client fleet, the launcher's
  resume): bit-equal, state and every metric -- the checkpoint holds every
  leaf bit for bit (the generator's state and the sampler's included);
* the compressed residual against the reference's ``residual_to_wire`` /
  ``residual_from_wire`` on the same e: the payloads bit-equal (top-k
  values and offsets, quant words and scales), the decoded rows bit-equal
  for top-k and within 2 ulp for quant (XLA turns the decode's divide into
  a multiply by the reciprocal; ROADMAP Queue 3);
* a run continued from a compressed residual: within the injected
  compression error of the uncompressed continuation, as the reference's
  own test holds it;
* the key lists of the two packages' files: equal on every field both
  states have.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_checkpoint
from repro.configs.base import (CompressorConfig as JCompressorConfig,
                                FedConfig as JFedConfig,
                                FleetConfig as JFleetConfig,
                                ScaleConfig as JScaleConfig,
                                SwitchConfig as JSwitchConfig)
from repro.engine import rounds as jax_rounds
from repro.fleet import provision as jax_provision
from repro.scale import slots as jax_slots
from repro.tasks import np_classification as jax_npc
from repro_torch import checkpoint
from repro_torch.comm import flat
from repro_torch.comm.payloads import FlatPacked
from repro_torch.configs.base import (AsyncConfig, CompressorConfig,
                                      FedConfig, FleetConfig, ScaleConfig,
                                      SwitchConfig)
from repro_torch.engine import async_rounds, rounds
from repro_torch.fleet import provision
from repro_torch.launch import train
from repro_torch.scale import slots
from repro_torch.tasks import np_classification as npc
from torch_port_util import assert_bits_equal, assert_within_ulp, n, t

EPS = 0.35
N, M = 12, 4
KINDS = {
    "none": dict(kind="none"),
    "topk": dict(kind="topk", ratio=0.25, block=8),
    "quant": dict(kind="quant", bits=8, block=8),
    "randk": dict(kind="randk", ratio=0.25, block=8),
}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def np_data():
    (xs, ys), _ = jax_npc.make_dataset(jax.random.PRNGKey(0), n_clients=N)
    return np.asarray(xs), np.asarray(ys)


def _params():
    return {"w": torch.zeros(30), "b": torch.zeros(())}


def _batch(np_data):
    return npc.NPBatch(t(np_data[0]), t(np_data[1]))


def _cfg(up="topk", down="none", comm="pallas", cap=0, fleet=None,
         async_=None, participation="gather",
         cls=(FedConfig, CompressorConfig, SwitchConfig, ScaleConfig,
              FleetConfig), **kw):
    fed, cc, sw, sc, fl = cls
    extra = {} if async_ is None else {"async_": AsyncConfig(**async_)}
    return fed(n_clients=N, m=M, local_steps=2, lr=0.1,
               switch=sw(mode="hard", eps=EPS), participation=participation,
               uplink=cc(**KINDS[up]), downlink=cc(**KINDS[down]),
               comm=comm, scale=sc(ef_slots=cap), fleet=fl(**(fleet or {})),
               **extra, **kw)


JCLS = (JFedConfig, JCompressorConfig, JSwitchConfig, JScaleConfig,
        JFleetConfig)


def _leaves(x):
    """Every tensor / number of a (nested) state or record, None skipped
    (generators as their state bytes)."""
    if x is None or isinstance(x, flat.FlatSpec):
        return []
    if isinstance(x, torch.Generator):
        return [x.get_state()]
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return [x]
    if isinstance(x, (int, float)):
        return [np.asarray(x)]
    if isinstance(x, dict):
        x = [x[k] for k in sorted(x)]
    return [leaf for v in x for leaf in _leaves(v)]


def _assert_all_bits_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert_bits_equal(x, y)


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------

def test_roundtrip_every_leaf_kind(tmp_path):
    """Float, unsigned wire, integer and 0-d tensors, Python numbers, a
    generator, None and the static spec, in NamedTuples, tuples and
    dicts: restored bit for bit (the generator draws on as the saved
    one)."""
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(5)
    torch.rand(3, generator=gen)
    u16 = t(rng.integers(0, 2 ** 16, (3, 4)).astype(np.uint16))
    u32 = t(rng.integers(0, 2 ** 32, (5,), dtype=np.uint64).astype(
        np.uint32))
    packed = FlatPacked(t(rng.standard_normal((3, 4)).astype(np.float32)),
                        u16)
    tree = {"a": t(rng.standard_normal((4, 3)).astype(np.float32)),
            "b": {"c": torch.arange(5), "d": torch.ones(())},
            "p": packed, "u": u32, "gen": gen, "n": 7, "x": 0.25,
            "none": None, "tup": (torch.tensor([1, 2], dtype=torch.int32),
                                  3),
            "spec": flat.spec_of(_params())}
    checkpoint.save(str(tmp_path / "ck"), tree, {"round": 7})
    back = checkpoint.restore(str(tmp_path / "ck"), tree)
    _assert_all_bits_equal(tree, back)
    assert back["p"].indices.dtype == torch.uint16
    assert back["u"].dtype == torch.uint32 and back["none"] is None
    assert back["spec"] is tree["spec"] and back["n"] == 7
    assert_bits_equal(torch.rand(4, generator=gen),
                      torch.rand(4, generator=back["gen"]))
    assert checkpoint.read_metadata(str(tmp_path / "ck")) == {"round": 7}
    assert checkpoint.read_metadata(str(tmp_path / "absent")) == {}
    with np.load(str(tmp_path / "ck.npz")) as f:
        assert f["p/.indices"].dtype == np.uint16
        assert f["u"].dtype == np.uint32
    keys = json.load(open(tmp_path / "ck.json"))["keys"]
    assert keys == sorted(keys) and "b/c" in keys and "tup/1" in keys


def test_fedstate_roundtrip(tmp_path):
    cfg = _cfg(up="topk", participation="mask").replace(n_clients=3, m=3)
    state = rounds.init_state(_params(), cfg, device="cpu")
    checkpoint.save_round(str(tmp_path), 5, state)
    restored, t5 = checkpoint.restore_round(str(tmp_path), state)
    assert t5 == 5
    _assert_all_bits_equal(state, restored)
    assert restored.x is None and restored.spec is state.spec
    assert checkpoint.restore_round(str(tmp_path / "empty"), state) == \
        (None, None)


def test_gc_keeps_latest(tmp_path):
    params = {"w": torch.ones(3)}
    for r in range(6):
        checkpoint.save_round(str(tmp_path), r, params, keep=2)
    assert checkpoint.latest_round(str(tmp_path)) == 5
    npz = [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    assert sorted(npz) == ["round_4.npz", "round_5.npz"]
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_shape_mismatch_raises(tmp_path):
    checkpoint.save(str(tmp_path / "ck"), {"w": torch.ones(3)})
    with pytest.raises(ValueError, match="mismatch"):
        checkpoint.restore(str(tmp_path / "ck"), {"w": torch.ones(4)})
    meta = {"w": torch.empty(3, device="meta")}
    with pytest.raises(ValueError, match="device"):
        checkpoint.restore(str(tmp_path / "ck"), meta)
    got = checkpoint.restore(str(tmp_path / "ck"), meta, device="cpu")
    assert got["w"].device.type == "cpu"


def test_keys_match_reference(tmp_path):
    """The two packages' round files name every shared field alike (jax's
    path spelling, ``.field`` for a NamedTuple's): the slot store's
    leaves, the averaged iterate's weight, the round and the Markov
    sampler's state (the port's w, x and wbar_sum are flat buffers where
    the reference's are parameter trees, and its generator stands for the
    reference's key)."""
    kw = dict(up="quant", down="topk", cap=6, fleet=dict(sampler="markov"))
    state = rounds.init_state(_params(), _cfg(**kw), device="cpu")
    jstate = jax_rounds.init_state(jax_npc.init_params(None, 30),
                                   _cfg(cls=JCLS, **kw))
    checkpoint.save_round(str(tmp_path / "port"), 1, state)
    jax_checkpoint.save_round(str(tmp_path / "ref"), 1, jstate)
    keys = json.load(open(tmp_path / "port" / "round_1.json"))["keys"]
    jkeys = json.load(open(tmp_path / "ref" / "round_1.json"))["keys"]
    flat_fields = (".w", ".x", ".wbar_sum")
    assert set(keys) - {".gen", *flat_fields} == {
        k for k in jkeys
        if k != ".key" and k.split("/")[0] not in flat_fields}
    assert {".e_up/.pool", ".e_up/.owner", ".e_up/.client_slot", ".sampler",
            ".wbar_weight", ".t", ".w", ".gen"} <= set(keys)


# ---------------------------------------------------------------------------
# save -> restore -> continue equals the uninterrupted run
# ---------------------------------------------------------------------------

CONTINUE = {
    "dense": dict(up="topk", down="quant", participation="mask"),
    "slots": dict(up="topk", down="topk", cap=M),
    "async": dict(up="quant", cap=6,
                  fleet=dict(sampler="markov", avail_stay=0.5),
                  async_=dict(enabled=True, max_staleness=3)),
    "fleet": dict(up="topk", down="quant", cap=M,
                  fleet=dict(sampler="markov", batch_size=8, redraw=True)),
}


def _drive(state, buf, data, cfg, T):
    if cfg.async_.enabled:
        return async_rounds.async_drive(state, data, npc.loss_pair, cfg, T,
                                        device="cpu", buf=buf)
    state, mets = rounds.drive(state, data, npc.loss_pair, cfg, T,
                               device="cpu")
    return state, None, mets


@pytest.mark.parametrize("case", sorted(CONTINUE))
def test_save_restore_continue_equals_straight_run(np_data, tmp_path, case):
    cfg = _cfg(**CONTINUE[case])
    data = _batch(np_data)
    if case == "fleet":
        data = provision.from_stacked(data)

    def fresh():
        state = rounds.init_state(_params(), cfg, device="cpu")
        return state, async_rounds.init_buffer(state, cfg)
    straight, sbuf, smets = _drive(*fresh(), data, cfg, 6)
    state, buf, _ = _drive(*fresh(), data, cfg, 3)
    fleet = data if case == "fleet" else None
    checkpoint.save_round(str(tmp_path), 3, state, fleet=fleet, cfg=cfg)
    checkpoint.save_buffer(str(tmp_path), 3,
                           async_rounds.buffer_wire(buf, state, cfg))

    like, like_buf = fresh()
    restored, t3 = checkpoint.restore_round(str(tmp_path), like,
                                            like_fleet=fleet)
    if fleet is not None:
        restored, fleet_r = restored
        _assert_all_bits_equal(fleet, fleet_r)
        data = fleet_r
    assert t3 == 3 and restored.t == 3
    _assert_all_bits_equal(state, restored)
    wire = checkpoint.restore_buffer(
        str(tmp_path), 3, async_rounds.buffer_wire_struct(restored, cfg),
        device="cpu")
    assert (wire is None) == (buf is None)
    if buf is not None:
        _assert_all_bits_equal(buf, wire)
        assert float(buf.occupied.sum()) > 0     # something is parked
    cont, cbuf, cmets = _drive(
        restored, async_rounds.buffer_from_wire(wire, restored, cfg), data,
        cfg, 3)
    _assert_all_bits_equal(straight, cont)
    _assert_all_bits_equal(sbuf, cbuf)
    last = (smets.round if cfg.async_.enabled else smets)
    got = (cmets.round if cfg.async_.enabled else cmets)
    for f in last._fields:
        if getattr(last, f) is not None:
            assert_bits_equal(getattr(last, f)[3:], getattr(got, f))
    if cfg.scale.ef_slots:
        assert isinstance(cont.e_up, slots.SlotStore)


def test_fleet_metadata_in_sidecar(np_data, tmp_path):
    cfg = _cfg(cap=M, fleet=dict(sampler="markov", batch_size=8,
                                 redraw=True))
    fleet = provision.from_stacked(_batch(np_data))
    state = rounds.init_state(_params(), cfg, device="cpu")
    checkpoint.save_round(str(tmp_path), 1, state, fleet=fleet, cfg=cfg)
    meta = json.load(open(tmp_path / "round_1.json"))["metadata"]
    assert meta["fleet"]["sampler"] == "markov"
    assert meta["fleet"]["count"] == [np_data[0].shape[1]] * N
    jmeta = jax_checkpoint.fleet_metadata(
        jax_provision.from_stacked((jnp.asarray(np_data[0]),
                                    jnp.asarray(np_data[1]))),
        _cfg(cls=JCLS, cap=M, fleet=dict(sampler="markov", batch_size=8,
                                         redraw=True)))
    assert meta["fleet"] == jmeta


def test_gc_keeps_fleet_sidecars_paired(np_data, tmp_path):
    cfg = _cfg(cap=M, async_=dict(enabled=True))
    fleet = provision.from_stacked(_batch(np_data))
    state = rounds.init_state(_params(), cfg, device="cpu")
    buf = async_rounds.init_buffer(state, cfg)
    for r in (1, 2, 3, 4, 5):
        checkpoint.save_round(str(tmp_path), r, state, keep=2, fleet=fleet,
                              cfg=cfg, compress_residual=True,
                              params=_params())
        checkpoint.save_buffer(str(tmp_path), r, buf)
    names = sorted(os.listdir(tmp_path))
    assert "round_4.npz" in names and "round_5_fleet.npz" in names
    assert "round_5_eup.npz" in names and "round_4_buffer.npz" in names
    assert not any(nm.startswith(("round_1", "round_2", "round_3"))
                   for nm in names)
    assert checkpoint.latest_round(str(tmp_path)) == 5


# ---------------------------------------------------------------------------
# The compressed residual
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store", [False, True], ids=["dense", "store"])
@pytest.mark.parametrize("kind,comm", [("topk", "packed"),
                                       ("topk", "pallas"),
                                       ("quant", "packed"),
                                       ("quant", "pallas")])
def test_residual_wire_matches_reference(kind, comm, store):
    rng = np.random.default_rng(3)
    e = rng.standard_normal((6, 31)).astype(np.float32) * 0.1
    e[1, ::4] = 0.0
    cfg = _cfg(up=kind, comm=comm)
    jcfg = _cfg(cls=JCLS, up=kind, comm=comm)
    jparams = jax_npc.init_params(None, 30)
    if store:
        arrays = (e, np.arange(6, dtype=np.int32) - 1,
                  np.arange(6, dtype=np.int32),
                  np.linspace(0.5, 2, 6).astype(np.float32),
                  np.full(N, -1, np.int32))
        e_up = slots.SlotStore(*(t(a) for a in arrays))
        je_up = jax_slots.SlotStore(*(jnp.asarray(a) for a in arrays))
    else:
        e_up, je_up = t(e), jnp.asarray(e)
    wire = checkpoint.residual_to_wire(e_up, _params(), cfg)
    jwire = jax_checkpoint.residual_to_wire(je_up, jparams, jcfg)
    struct = checkpoint.residual_wire_struct(e_up, _params(), cfg)
    for g, w, s in zip(_leaves(wire), jax.tree_util.tree_leaves(jwire),
                       _leaves(struct)):
        assert_bits_equal(g, w)
        assert s.shape == g.shape and s.dtype == g.dtype
    back = checkpoint.residual_from_wire(wire, _params(), cfg, like=e_up)
    jback = jax_checkpoint.residual_from_wire(jwire, jparams, jcfg,
                                              like=je_up)
    got = back.pool if store else back
    want = jback.pool if store else jback
    if kind == "topk":
        assert_bits_equal(got, want)
    else:
        assert_within_ulp(got, want, 2)
    # decode(pack(e)) row by row
    _, up = checkpoint._uplink(_params(), cfg)
    assert_bits_equal(got, up.codec.decode(up.codec.pack(t(e))))


@pytest.mark.parametrize("kind", ["topk", "quant"])
def test_compressed_residual_save_restore_continue(np_data, tmp_path, kind):
    """The restored residual is decode(pack(e)); every other leaf restores
    bit for bit; the continued run tracks the uncompressed continuation
    within the injected compression error."""
    cfg = _cfg(up=kind, comm="packed")
    data = _batch(np_data)
    state, _ = rounds.drive(rounds.init_state(_params(), cfg, device="cpu"),
                            data, npc.loss_pair, cfg, 2, device="cpu")
    ck = str(tmp_path / "ck")
    checkpoint.save_round(ck, 2, state, cfg=cfg, compress_residual=True,
                          params=_params())
    assert os.path.exists(os.path.join(ck, "round_2_eup.npz"))
    with np.load(os.path.join(ck, "round_2.npz")) as f:
        assert not any("e_up" in k for k in f.files)
    like = rounds.init_state(_params(), cfg, device="cpu")
    with pytest.raises(ValueError, match="params and cfg"):
        checkpoint.restore_round(ck, like)
    restored, t2 = checkpoint.restore_round(ck, like, params=_params(),
                                            cfg=cfg)
    assert t2 == 2
    _assert_all_bits_equal(state._replace(e_up=None),
                           restored._replace(e_up=None))
    _, up = checkpoint._uplink(_params(), cfg)
    exp = up.codec.decode(up.codec.pack(state.e_up))
    assert_bits_equal(restored.e_up, exp)
    err = float((state.e_up - exp).abs().max())
    cont_u, _ = rounds.drive(state, data, npc.loss_pair, cfg, 2,
                             device="cpu")
    cont_c, _ = rounds.drive(restored, data, npc.loss_pair, cfg, 2,
                             device="cpu")
    assert torch.isfinite(cont_c.w).all()
    assert float((cont_u.w - cont_c.w).abs().max()) <= max(err, 1e-7)


def test_slot_store_pool_compresses(np_data, tmp_path):
    cfg = _cfg(up="topk", comm="pallas", cap=M)
    state, _ = rounds.drive(rounds.init_state(_params(), cfg, device="cpu"),
                            _batch(np_data), npc.loss_pair, cfg, 3,
                            device="cpu")
    checkpoint.save_round(str(tmp_path), 3, state, cfg=cfg,
                          compress_residual=True, params=_params())
    restored, _ = checkpoint.restore_round(
        str(tmp_path), rounds.init_state(_params(), cfg, device="cpu"),
        params=state.spec, cfg=cfg)
    assert isinstance(restored.e_up, slots.SlotStore)
    for f in ("owner", "stamp", "weight", "client_slot"):
        assert_bits_equal(getattr(restored.e_up, f), getattr(state.e_up, f))
    _, up = checkpoint._uplink(_params(), cfg)
    assert_bits_equal(restored.e_up.pool,
                      up.codec.decode(up.codec.pack(state.e_up.pool)))


def test_no_packed_wire_keeps_the_residual_dense(np_data, tmp_path):
    """rand-k packs from per-client streams (no deterministic re-encode),
    and the dense wire has no packed format: the residual stays in the main
    file and restores without params / cfg."""
    for kw in (dict(up="randk", comm="packed"), dict(up="topk",
                                                     comm="dense")):
        cfg = _cfg(**kw)
        state, _ = rounds.drive(
            rounds.init_state(_params(), cfg, device="cpu"),
            _batch(np_data), npc.loss_pair, cfg, 1, device="cpu")
        ck = str(tmp_path / kw["up"])
        checkpoint.save_round(ck, 1, state, cfg=cfg, compress_residual=True,
                              params=_params())
        assert not os.path.exists(os.path.join(ck, "round_1_eup.npz"))
        restored, _ = checkpoint.restore_round(
            ck, rounds.init_state(_params(), cfg, device="cpu"))
        assert_bits_equal(restored.e_up, state.e_up)
    assert checkpoint.residual_to_wire(None, _params(), cfg) is None
    with pytest.raises(ValueError, match="params and cfg"):
        checkpoint.save_round(ck, 2, state, compress_residual=True)


# ---------------------------------------------------------------------------
# The staleness-buffer sidecar
# ---------------------------------------------------------------------------

def test_buffer_sidecar_boundaries(tmp_path):
    cfg = _cfg(up="quant", async_=dict(enabled=True))
    state = rounds.init_state(_params(), cfg, device="cpu")
    buf = async_rounds.init_buffer(state, cfg)
    assert async_rounds.buffer_wire(buf, state, cfg) is buf
    assert async_rounds.buffer_from_wire(buf, state, cfg) is buf
    # a signature is checked against this process's transport: its own
    # row signature passes, another raises naming both
    from repro_torch.wire import frames
    ours = frames.row_signature(state.spec, cfg)
    assert async_rounds.buffer_from_wire(buf, state, cfg, sig=ours) is buf
    with pytest.raises(ValueError, match="signature mismatch") as err:
        async_rounds.buffer_from_wire(buf, state, cfg, sig="quant/8")
    assert ours in str(err.value) and "'quant/8'" in str(err.value)
    struct = async_rounds.buffer_wire_struct(state, cfg)
    for s, b in zip(_leaves(struct), _leaves(buf)):
        assert s.device.type == "meta"
        assert s.shape == b.shape and s.dtype == b.dtype
    off = cfg.replace(async_=AsyncConfig())
    assert async_rounds.buffer_wire_struct(state, off) is None
    checkpoint.save_buffer(str(tmp_path / "never"), 1, None)
    assert not (tmp_path / "never").exists()
    assert checkpoint.restore_buffer(str(tmp_path), 7, struct) is None
    assert checkpoint.restore_buffer(str(tmp_path), None, struct) is None
    assert checkpoint.restore_buffer(str(tmp_path), 7, None) is None


# ---------------------------------------------------------------------------
# The launcher's --ckpt-dir
# ---------------------------------------------------------------------------

LAUNCH = ["--reduced", "--device", "cpu", "--seq", "8", "--batch", "1",
          "--clients", "4", "--participating", "2", "--participation",
          "gather", "--comm", "pallas", "--ef-slots", "2", "--fleet",
          "--fleet-pool", "3", "--sampler", "markov", "--async-buffer",
          "--sink", "memory"]


def test_launcher_ckpt_dir_resumes_the_straight_run(tmp_path, capsys):
    """A first invocation writes round_10 with its fleet and buffer
    sidecars; a second restores them and runs rounds 11-20, which equal an
    uninterrupted 20-round run bit for bit."""
    ck = str(tmp_path / "ck")
    first = train.main(LAUNCH + ["--rounds", "10", "--ckpt-dir", ck])
    names = set(os.listdir(ck))
    for stem in ("round_10", "round_10_fleet", "round_10_buffer"):
        assert {stem + ".npz", stem + ".json"} <= names
    assert first.t == 10
    capsys.readouterr()
    resumed = train.main(LAUNCH + ["--rounds", "10", "--ckpt-dir", ck])
    out = capsys.readouterr().out
    assert "restored checkpoint at round 10" in out
    assert "restored staleness buffer at round 10" in out
    assert resumed.t == 20 and checkpoint.latest_round(ck) == 20
    straight = train.main(LAUNCH + ["--rounds", "20"])
    _assert_all_bits_equal(straight, resumed)
