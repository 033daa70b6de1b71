"""Rounds across several processes: the port's client axis, and the
model axis of the flat state, over ``torch.distributed`` groups, on the
CPU.

Gloo worlds of W = 2 and W = 4 ranks (``spawn``, rendezvous through a
``FileStore`` in a temporary folder, one intra-op thread a rank; the cases
of one world run in one module-scoped world, ``tests/torch_multidev_world.py``)
run every case under ``launch.mesh.make_rank_mesh("cpu")`` (the client
axis alone) and the data x model meshes ``(1, 2)``, ``(2, 2)`` and
``(1, 4)`` (the flat state split by columns); the test's own process runs
the same cases with no mesh.

Tolerances and why:

* every rank against one process, every case: bit-equal (``w``, ``x``, the
  averaged-iterate sums, every metric, the residual or the slot store
  gathered whole, the wire payloads).  Each rank computes its rows as one
  process computes them, on its columns the same operators work on the
  same blocks, the messages and the per-row eval terms cross ranks as
  bytes, and every rank reduces all of them with the same operations;
* where a column cut falls inside a leaf, the whole-``[d]`` norms add two
  ranks' partial sums of that leaf (``comm.flat.tree_norm``):
  ``delta_norm`` within rtol 1e-6, and a case whose projection onto the
  ball reads such a norm within rtol 1e-5 / atol 1e-7 (the reference's
  tolerance between its mesh and no-mesh runs);
* the reference's ``multidev`` configuration at W ranks, and on the
  ``(2, 2)`` mesh, against the reference's own run over a 4-device mesh of
  the same shape (a subprocess with 4 forced host devices): rtol 1e-5 /
  atol 1e-7, ``owner`` and ``client_slot`` equal;
* the reference's checks (a), (b): ``sharded_take`` and the constraints
  move exact values (bit-equal).
"""
import hashlib
import math
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_multidev_world as world_mod
from repro.tasks import np_classification as jax_npc
from repro_torch.comm import flat
from repro_torch.configs.base import CompressorConfig
from repro_torch.launch import mesh
from repro_torch.scale import shard
from repro_torch.sharding import collectives, partition
from torch_port_util import assert_bits_equal

ROOT = pathlib.Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.multidev
CASE_NAMES = list(world_mod.CASES) + ["np-multidev"]
MESH_IDS = {shape: f"{shape[0]}x{shape[1]}" for shape in world_mod.MESHES}
# sha1 of the torch.distributed calls of world_mod.LOG_CASES on a (W, 1)
# mesh, rank by rank (world_mod.call_log): those the client axis made
# before the model axis existed
CLIENT_AXIS_CALLS = {
    2: ["d59fbaf9f29a46b41b1f13a85ccf7ba27b3e614e",
        "0bde2e399308fb6d87a31d93bf034c99c9a21082"],
    4: ["6c9fd0e6a5156fa776e45fd2b1c843dd32a3504a",
        "a6830c5a76f99273d0c2af817cc3dcc4a1e87793",
        "7049fd330c3405f69b1a37bf68fd89cab18fab3f",
        "e6a7dbdf5114162fa9bbb43a3a54c9e93765a357"],
}

_REFERENCE = """
import sys
import numpy as np, jax, jax.numpy as jnp
assert jax.device_count() == 4, jax.devices()
from repro.comm import flat
from repro.configs.base import (CompressorConfig, FedConfig, FleetConfig,
                                ScaleConfig, SwitchConfig)
from repro.engine import rounds
from repro.fleet import samplers
from repro.sharding import partition
from repro.tasks import np_classification as npc
z = np.load(sys.argv[1])
N, M, T = %d, %d, %d
cohorts = %r
cfg = FedConfig(n_clients=N, m=M, local_steps=2, lr=0.1,
                switch=SwitchConfig(mode="hard", eps=0.35),
                participation="gather",
                uplink=CompressorConfig(kind="topk", ratio=0.25, block=8),
                downlink=CompressorConfig(kind="none"),
                scale=ScaleConfig(ef_slots=N),
                fleet=FleetConfig(sampler="fixed"))
masks = np.zeros((T, N), np.float32)
for r, ids in enumerate(cohorts):
    masks[r, ids] = 1.0
params = {"b": jnp.asarray(z["b"]), "w": jnp.asarray(z["w"])}
shape = tuple(int(v) for v in sys.argv[3].split(","))
mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(shape),
                         ("data", "model")[:len(shape)])
partition.activate_mesh(mesh)
state = rounds.init_state(params, cfg)._replace(
    sampler=samplers.fixed_state(jnp.asarray(masks), jnp.asarray(masks)))
step = jax.jit(lambda s, b: rounds.round_step(s, b, npc.loss_pair, cfg))
for _ in range(T):
    state, _ = step(state, (jnp.asarray(z["xs"]), jnp.asarray(z["ys"])))
partition.activate_mesh(None)
np.savez(sys.argv[2], w=np.asarray(flat.flatten(flat.spec_of(state.w),
                                                 state.w)),
         pool=np.asarray(state.e_up.pool), owner=np.asarray(state.e_up.owner),
         client_slot=np.asarray(state.e_up.client_slot))
""" % (world_mod.NP_N, world_mod.NP_M, world_mod.NP_ROUNDS,
       world_mod.NP_COHORTS)


@pytest.fixture(scope="module")
def np_path(tmp_path_factory):
    """The reference's NP dataset and initial parameters (``multidev``)."""
    (xs, ys), _ = jax_npc.make_dataset(jax.random.PRNGKey(0),
                                       n_clients=world_mod.NP_N)
    params = jax_npc.init_params(jax.random.PRNGKey(1), xs.shape[-1])
    path = str(tmp_path_factory.mktemp("np") / "np.npz")
    np.savez(path, xs=np.asarray(xs), ys=np.asarray(ys),
             w=np.asarray(params["w"]), b=np.asarray(params["b"]))
    return path


def _reference_run(np_path, shape: str):
    """The reference's ``multidev`` run over a 4-device host mesh of
    ``shape`` ("4": the client axis; "2,2": data x model), started as a
    subprocess; yields a function that waits for its arrays."""
    out = np_path.replace("np.npz", f"reference{shape}.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, np_path, out,
                             shape],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    result = {}

    def wait():
        if not result:
            text, _ = proc.communicate(timeout=300)
            assert proc.returncode == 0, text
            result.update(np.load(out))
        return result
    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def reference(np_path):
    """The reference's ``multidev`` run over a 4-device client mesh, beside
    the worlds; the fixture's value waits for it."""
    yield from _reference_run(np_path, "4")


@pytest.fixture(scope="module")
def reference_2x2(np_path):
    """The reference's ``multidev`` run over a ``(2, 2)`` ``("data",
    "model")`` host mesh."""
    yield from _reference_run(np_path, "2,2")


@pytest.fixture(scope="module", params=[2, 4], ids=["W2", "W4"])
def world(request, tmp_path_factory, np_path, reference):
    """``(W, [each rank's results])`` of a world of W gloo ranks."""
    W = request.param
    folder = str(tmp_path_factory.mktemp(f"world{W}"))
    return W, world_mod.spawn_world(W, folder, np_path)


@pytest.fixture(scope="module")
def worlds_2d(tmp_path_factory, np_path, reference_2x2):
    """``get(shape)``: each rank's results of the world on the data x model
    mesh ``shape`` (spawned on first use)."""
    cache = {}

    def get(shape):
        if shape not in cache:
            folder = str(tmp_path_factory.mktemp(f"mesh{MESH_IDS[shape]}"))
            cache[shape] = world_mod.spawn_world(
                shape[0] * shape[1], folder, np_path, shape=shape)
        return cache[shape]
    return get


@pytest.fixture(scope="module")
def single(np_path):
    """Each case in this process, with no mesh (computed on first use)."""
    cache = {}

    def get(name):
        if name not in cache:
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                cache[name] = world_mod.run_np(np_path) \
                    if name == "np-multidev" else world_mod.run_case(name)
            finally:
                torch.set_num_threads(threads)
        return cache[name]
    return get


def _assert_summaries_equal(got: dict, want: dict,
                            close: tuple = ()) -> None:
    """Bit-equal summaries; the keys of ``close`` within rtol 1e-6 (a
    norm that adds two ranks' partials of a leaf), or, with ``"*"`` in
    it, every float within rtol 1e-5 / atol 1e-7 and the rest equal."""
    assert got.keys() == want.keys(), (got.keys(), want.keys())
    for key, v in want.items():
        if "*" in close and isinstance(v, torch.Tensor) and \
                v.dtype.is_floating_point:
            np.testing.assert_allclose(got[key].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=key)
        elif key in close:
            np.testing.assert_allclose(got[key].numpy(), v.numpy(),
                                       rtol=1e-6, atol=0, err_msg=key)
        elif isinstance(v, torch.Tensor) or v is None:
            assert_bits_equal(got[key], v)
        else:
            assert got[key] == v, key


@pytest.mark.parametrize("name", CASE_NAMES)
def test_rounds_bit_equal_to_one_process(world, single, name):
    """Every rank ends the rounds with one process's state and metrics, bit
    for bit: every wire (dense, packed, pallas) with top-k or quant up and
    down, mask and gather, the fused and the separate eval, uneven blocks
    (n = 6, m = 3 over 4 ranks: a rank without sampled rows), a short
    cohort, the weighted-sampler fleet and a full-shard fleet, the slot
    store with evictions, two-tier cohorts, penalty-fedavg, the hard
    switch, lean metrics."""
    W, ranks = world
    want = single(name)
    for r, res in enumerate(ranks):
        try:
            _assert_summaries_equal(res["cases"][name], want)
        except AssertionError as err:
            raise AssertionError(f"W={W} rank {r}: {err}") from None


@pytest.mark.parametrize("name", world_mod.CASES_2D)
@pytest.mark.parametrize("shape", world_mod.MESHES, ids=MESH_IDS.get)
def test_rounds_on_data_model_mesh(worlds_2d, single, shape, name):
    """On a data x model mesh (the flat state split by columns), every rank
    ends the rounds with one process's state and metrics, the split ones
    gathered whole: pallas top-k up and down in gather mode, pallas quant
    up and down in mask mode, the packed and dense wires (dense top-k
    keeps each leaf of 2^22 elements or fewer whole on one rank), the slot
    store with evictions and a short cohort, rand-k, a weighted fleet, the
    separate eval, two-tier cohorts and the projection onto the ball.
    Bit-equal, but for the norms of a leaf cut in two (module
    docstring)."""
    ranks = worlds_2d(shape)
    want = single(name)
    for r, res in enumerate(ranks):
        close = ()
        if res["splits"][name]["straddles"]:
            close = ("*",) if name.startswith("proj-") else \
                ("metric_delta_norm",)
        try:
            _assert_summaries_equal(res["cases"][name], want, close)
        except AssertionError as err:
            raise AssertionError(f"{MESH_IDS[shape]} rank {r}: {err}") \
                from None


@pytest.mark.parametrize("wire", [f"{c}-{k}"
                                  for c, k in world_mod.PAYLOAD_WIRES]
                         + ["dense-topk-giant"])
@pytest.mark.parametrize("shape", world_mod.MESHES, ids=MESH_IDS.get)
def test_payloads_on_columns(worlds_2d, shape, wire):
    """Each wire's EF14 encode on every rank's columns: the payload's
    fields (values and offsets, words and scales, or the dense rows), the
    new residual and the reduce, gathered over the model axis, are one
    process's bit for bit, and the wire bytes count a whole message.
    ``dense-topk-giant``: the dense wire's top-k where every cut falls
    inside a leaf above 2^22 elements (each rank's part of it compressed
    by the sort-free blockwise top-k)."""
    for r, res in enumerate(worlds_2d(shape)):
        got = res["payloads"][wire]
        pairs = got["fields"] + [got["e"], got["reduce"]]
        if wire == "dense-topk-giant":
            assert got["cut_leaves"] == [17 << 18], got["cut_leaves"]
            assert all(a == b for a, b in pairs), (r, pairs)
        else:
            for a, b in pairs:
                assert_bits_equal(a, b)
        assert got["wire_bytes"][0] == got["wire_bytes"][1]


@pytest.mark.parametrize("shape", world_mod.MESHES, ids=MESH_IDS.get)
def test_model_axis_traffic(worlds_2d, shape):
    """The model axis's group carries traffic on every data x model mesh,
    the client axis's only where it holds two or more ranks; the splits
    are the same on every rank, and the cases cut leaves as expected (the
    dense top-k wire only between leaves)."""
    ranks = worlds_2d(shape)
    for res in ranks:
        by = res["collectives_by_axis"]
        assert by["model"]["calls"] > 0 and by["model"]["bytes_out"] > 0
        assert (by["client"]["calls"] > 0) == (shape[0] > 1)
        assert res["splits"] == ranks[0]["splits"]
    splits = ranks[0]["splits"]
    assert not splits["dense-topk-mask"]["straddles"]
    assert splits["pallas-quant-mask"]["straddles"]


def test_np_multidev_2x2_within_reference(worlds_2d, reference_2x2):
    """The reference's ``multidev`` configuration on the port's ``(2, 2)``
    data x model mesh against the reference's own run over a ``(2, 2)``
    ``("data", "model")`` host mesh: w and the pool within rtol 1e-5 /
    atol 1e-7, ``owner`` and ``client_slot`` equal."""
    ref = reference_2x2()
    for res in worlds_2d((2, 2)):
        got = res["cases"]["np-multidev"]
        np.testing.assert_allclose(got["w"].numpy().astype(np.float64),
                                   ref["w"].astype(np.float64), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(got["pool"].numpy().astype(np.float64),
                                   ref["pool"].astype(np.float64), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_array_equal(got["owner"].numpy(), ref["owner"])
        np.testing.assert_array_equal(got["client_slot"].numpy(),
                                      ref["client_slot"])


def test_np_multidev_2x2_bit_equal(worlds_2d, single):
    """The same configuration on the ``(2, 2)`` mesh against one process:
    bit-equal (its cuts fall between the leaves)."""
    want = single("np-multidev")
    for res in worlds_2d((2, 2)):
        _assert_summaries_equal(res["cases"]["np-multidev"], want)


@pytest.mark.parametrize("what", world_mod.REFUSALS_2D)
def test_refusals_on_data_model_mesh(worlds_2d, what):
    """Under a ``(2, 2)`` data x model mesh these still raise
    ``NotImplementedError``, the mesh staying as it was: a ``pod`` axis of
    2, a mesh whose size is not the world's, the telemetry bus,
    asynchronous rounds, checkpoints and the wire runtime."""
    for r, res in enumerate(worlds_2d((2, 2))):
        assert res["refusals"][what], f"rank {r}: {what} ran"


def test_client_axis_calls_unchanged(world):
    """On a ``(W, 1)`` mesh every ``torch.distributed`` call of five cases
    (mask and gather, the dense and pallas wires, the slot store, a fleet,
    the separate eval), the mesh's activation included, is the call the
    client axis made before the model axis existed: the same functions
    on the default group with the same arguments, and no group built."""
    W, ranks = world
    got = [hashlib.sha1("\n".join(res["call_log"][c]
                                  for c in world_mod.LOG_CASES).encode()
                        ).hexdigest() for res in ranks]
    assert got == CLIENT_AXIS_CALLS[W]


def test_projection_is_active(single):
    """The projection cases project: ``w`` differs from the same wire's
    round without the ball."""
    assert not torch.equal(single("proj-dense-topk")["w"],
                           single("dense-topk-mask")["w"])


_WIRES = {"pallas-topk": ("pallas", "topk"), "pallas-quant": ("pallas",
                                                            "quant"),
          "packed-topk": ("packed", "topk"), "dense-topk": ("dense", "topk"),
          "dense-quant": ("dense", "quant"), "dense-randk": ("dense",
                                                           "randk"),
          "packed-randk": ("packed", "randk"),
          "dense-natural": ("dense", "natural")}


@pytest.mark.parametrize("up", sorted(_WIRES))
def test_split_never_cuts_a_unit(up):
    """``comm.flat.column_split`` over 2, 3, 4 and 7 ranks, for a tree with
    a leaf above 2^22 elements, a scalar and small leaves, each wire up
    with quant down: every cut falls on a boundary of both directions'
    compression units (a block of every blockwise operator; the whole
    leaf for the dense wire's top-k at or below 2^22 elements and for
    rand-k), every column block's runs hold whole blocks, and each cut
    lies within one unit of its even share."""
    from repro_torch.configs.base import FedConfig
    meta = dict(device="meta")
    tree = {"big": torch.empty(5, 1 << 20, **meta),
            "emb": torch.empty(96, 40, **meta), "s": torch.empty((), **meta),
            "v": torch.empty(100, **meta), "w": torch.empty(64, 24, **meta)}
    spec = flat.spec_of(tree)
    comm, kind = _WIRES[up]
    cfg = FedConfig(comm=comm, uplink=CompressorConfig(kind=kind, ratio=0.1,
                                                       block=48),
                    downlink=CompressorConfig(kind="quant", bits=4,
                                              block=32))
    fts = flat.flat_transports_for(cfg, spec)
    units = [1] * len(spec.leaves)
    for ft in fts:
        units = [math.lcm(a, b) for a, b in zip(units,
                                                 flat._leaf_units(ft))]
    for size in (2, 3, 4, 7):
        split = flat.column_split(spec, fts, size)
        assert split.cuts[0] == 0 and split.cuts[-1] == spec.d
        assert list(split.cuts) == sorted(split.cuts)
        for r, cut in enumerate(split.cuts[1:-1], 1):
            i = max(j for j, ls in enumerate(spec.leaves)
                    if ls.offset <= cut)
            ls = spec.leaves[i]
            assert (cut - ls.offset) % units[i] == 0, (size, cut, ls)
            target = r * spec.d / size
            j = min(j for j, ls in enumerate(spec.leaves)
                    if ls.offset + ls.size > target)
            assert abs(cut - target) <= units[j], (size, cut)
        for r in range(size):
            for ft in fts:
                if ft.codec is not None:
                    flat.local_layout(ft.codec.layout, *split.block(r))
    if (comm, kind) == ("dense", "topk"):
        # whole leaves at or below 2^22 elements, blocks above
        assert units[1:] == [ls.size for ls in spec.leaves[1:]]
        assert units[0] < spec.leaves[0].size


def test_cases_exercise_their_paths(world):
    """The cases reach what they are named for: evictions in the evicting
    stores, a short cohort (the padded id's client owning one slot), no
    ``delta_norm`` under lean metrics, bytes across ranks."""
    W, ranks = world
    cases = ranks[0]["cases"]
    for name in ("slots-evict-topk", "slots-evict-randk"):
        owned = (cases[name]["owner"] >= 0).sum()
        assert int(owned) == 4, name      # a full store of 4 of 6 clients
    slot = cases["short-cohort-slots"]["client_slot"]
    assert int((slot >= 0).sum()) == 4    # rounds of 2 and 3 distinct ids
    assert float(cases["lean-metrics"]["metric_delta_norm"].abs().sum()) == 0
    assert float(cases["pallas-topk-gather"]["metric_delta_norm"].min()) > 0
    for res in ranks:
        assert res["collectives"]["calls"] > 0
        assert res["collectives"]["bytes_out"] > 0


def test_np_multidev_within_reference(world, reference):
    """The reference's ``multidev`` configuration (slot store in gather mode)
    at W ranks against the reference's own 4-device run: w and the pool
    within rtol 1e-5 / atol 1e-7, ``owner`` and ``client_slot`` equal."""
    W, ranks = world
    ref = reference()
    for res in ranks:
        got = res["cases"]["np-multidev"]
        np.testing.assert_allclose(got["w"].numpy().astype(np.float64),
                                   ref["w"].astype(np.float64), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(got["pool"].numpy().astype(np.float64),
                                   ref["pool"].astype(np.float64), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_array_equal(got["owner"].numpy(), ref["owner"])
        np.testing.assert_array_equal(got["client_slot"].numpy(),
                                      ref["client_slot"])


def test_sharded_take_and_constraints(world):
    """The reference's checks (a), (b) on every rank: ``sharded_take`` from
    a client-split stack gives the exact rows, and ``constrain_fleet`` /
    ``constrain_store`` split values they give back unchanged (the store's
    index vectors stay whole)."""
    W, ranks = world
    for res in ranks:
        s = res["shard"]
        assert s["split"] and s["owner_same"]
        assert_bits_equal(s["taken"], s["want"])
        assert_bits_equal(s["fleet_data"], s["fleet_want"])
        assert_bits_equal(s["fleet_count"], torch.full((world_mod.NP_N,), 4))
        assert_bits_equal(s["pool"], s["pool_want"])


@pytest.mark.parametrize("what", world_mod.REFUSALS)
def test_refusals(world, what):
    """Under a rank mesh these raise ``NotImplementedError``, the mesh
    staying as it was: a rank mesh whose size is not the world's, the
    telemetry bus, asynchronous rounds, checkpoints and the wire
    runtime."""
    W, ranks = world
    for r, res in enumerate(ranks):
        assert res["refusals"][what], f"W={W} rank {r}: {what} ran"


def test_one_process_calls_no_collective(single, tmp_path):
    """With no mesh, and with a one-rank mesh, a round calls no collective
    and is the same round (a one-rank mesh has no rank axis)."""
    collectives.reset_stats()
    want = single("pallas-topk-gather")
    assert collectives.stats()["calls"] == 0
    assert partition.rank_axis() is None
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = mesh.make_rank_mesh("cpu")
        assert mesh.is_rank_mesh(one) and one.devices.shape == (1,)
        partition.activate_mesh(one)
        assert partition.rank_axis() is None
        got = world_mod.run_case("pallas-topk-gather")
    finally:
        partition.activate_mesh(None)
        torch.set_num_threads(threads)
        dist.destroy_process_group()
    assert collectives.stats()["calls"] == 0
    _assert_summaries_equal(got, want)


@pytest.mark.parametrize("leaf", ["tensor", "tree"])
def test_take_and_put_in_one_process(leaf):
    """With no rank mesh ``scale.shard.take`` and ``put`` are
    ``index_select`` and ``index_copy_`` (the one-process path of every
    gathered encode), over a tensor or a tree with a None leaf."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 3, 5, generator=g)
    idx = torch.tensor([0, 2, 5])
    tree = x if leaf == "tensor" else {"a": x, "b": (x[:, 0], None)}
    got = shard.take(tree, idx)
    if leaf == "tensor":
        assert_bits_equal(got, x.index_select(0, idx))
    else:
        assert_bits_equal(got["a"], x.index_select(0, idx))
        assert_bits_equal(got["b"][0], x[:, 0].index_select(0, idx))
        assert got["b"][1] is None
    rows = torch.randn(3, 3, 5, generator=g)
    dest = x.clone()
    assert shard.put(dest, idx, rows) is dest
    assert_bits_equal(dest, x.clone().index_copy_(0, idx, rows))
