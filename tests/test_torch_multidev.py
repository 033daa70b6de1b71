"""Rounds across several processes: the port's client axis over a
``torch.distributed`` group, on the CPU.

Gloo worlds of W = 2 and W = 4 ranks (``spawn``, rendezvous through a
``FileStore`` in a temporary folder, one intra-op thread a rank; the cases
of one W run in one module-scoped world, ``tests/torch_multidev_world.py``)
run every case under ``launch.mesh.make_rank_mesh("cpu")``; the test's own
process runs the same cases with no mesh.

Tolerances and why:

* every rank against one process, every case: bit-equal (``w``, ``x``, the
  averaged-iterate sums, every metric, the residual or the slot store
  gathered whole).  Each rank computes its rows as one process computes
  them, the messages and the per-row eval terms cross ranks as bytes, and
  every rank reduces all of them with the same operations;
* the reference's ``multidev`` configuration at W ranks against the
  reference's own run over a 4-device mesh (a subprocess with 4 forced host
  devices): the reference's own tolerance between its mesh and no-mesh
  runs, rtol 1e-5 / atol 1e-7, ``owner`` and ``client_slot`` equal;
* the reference's checks (a), (b): ``sharded_take`` and the constraints
  move exact values (bit-equal).
"""
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
from repro_torch.launch import mesh
from repro_torch.scale import shard
from repro_torch.sharding import collectives, partition
from torch_port_util import assert_bits_equal

ROOT = pathlib.Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.multidev
CASE_NAMES = list(world_mod.CASES) + ["np-multidev"]

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
mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(4), ("data",))
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


@pytest.fixture(scope="module")
def reference(np_path):
    """The reference's ``multidev`` run over a 4-device host mesh, started
    as a subprocess beside the worlds; the fixture's value waits for it."""
    out = np_path.replace("np.npz", "reference.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, np_path, out],
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


@pytest.fixture(scope="module", params=[2, 4], ids=["W2", "W4"])
def world(request, tmp_path_factory, np_path, reference):
    """``(W, [each rank's results])`` of a world of W gloo ranks."""
    W = request.param
    folder = str(tmp_path_factory.mktemp(f"world{W}"))
    return W, world_mod.spawn_world(W, folder, np_path)


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


def _assert_summaries_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys(), (got.keys(), want.keys())
    for key, v in want.items():
        if isinstance(v, torch.Tensor) or v is None:
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
    staying as it was: a rank mesh with a ``model`` axis of 2, one whose
    size is not the world's, the telemetry bus, asynchronous rounds,
    checkpoints and the wire runtime."""
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
