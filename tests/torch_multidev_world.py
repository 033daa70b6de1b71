"""The worlds of ``tests/test_torch_multidev.py`` and
``tests/test_torch_tensor_parallel.py``: gloo process groups of W CPU
ranks (started by ``spawn``, rendezvous through a ``FileStore``) that run
the port's rounds under a rank mesh -- the client axis alone, or a ``(D,
M)`` ``("data", "model")`` mesh -- and the same rounds in one process.
This module imports no JAX: the ranks load it by name.

The data x model worlds of ``test_torch_multidev.py`` run under
:data:`WHOLE_MODEL`, the logical table that keeps every model whole on
every rank (the flat state split by columns, bit-equal to one process);
the tensor-parallel worlds (:func:`tp_world_main`) under the default
table, which splits the dense family's heads, ffn and vocab.

Every case is reduced smollm-360m (seq 16, batch 2) for 2 rounds, except
``np-multidev``: the reference's ``multidev`` configuration
(``tests/test_scale.py``: NP, N 12, M 4, gather, hard switch 0.35, top-k
0.25 block 8 up, ``ef_slots`` 12, E 2) for 3 rounds on recorded cohorts,
from the reference's dataset (written to ``np.npz`` by the test).
"""
from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
import time

import numpy as np
import torch

SMOLLM = ["--reduced", "--seq", "16"]
MASK = ["--clients", "4"]
GATHER = ["--clients", "6", "--participating", "3", "--participation",
          "gather"]
ROUNDS = 2
# a short cohort (2 of m = 3 sampled) in round 0, a full one in round 1
SHORT_MASKS = [[0, 1, 0, 0, 1, 0], [1, 0, 1, 0, 0, 1]]
NP_N, NP_M, NP_ROUNDS = 12, 4, 3
NP_COHORTS = [[1, 5, 8, 11], [0, 2, 3, 4], [6, 7, 9, 10]]


def _cases() -> dict:
    out = {}
    for comm in ("dense", "packed", "pallas"):
        for kind in ("topk", "quant"):
            for mode, argv in (("mask", MASK), ("gather", GATHER)):
                out[f"{comm}-{kind}-{mode}"] = dict(
                    argv=argv + ["--comm", comm, "--uplink", kind],
                    downlink=True)
    out.update({
        # n = 6 over W ranks: blocks of 3/3 or 2/2/1/1; all 6 fused
        "mask-6-of-6-quant": dict(argv=["--clients", "6", "--comm",
                                        "pallas", "--uplink", "quant"]),
        # partial participation in mask mode: the separate eval
        "mask-3-of-6-topk": dict(argv=["--clients", "6", "--participating",
                                       "3", "--comm", "pallas", "--uplink",
                                       "topk"], downlink=True),
        # the fused eval of the m sampled
        "gather-sparse-eval": dict(argv=GATHER + ["--comm", "pallas",
                                                  "--uplink", "topk"],
                                   downlink=True, fed={"full_eval": False}),
        "short-cohort": dict(argv=GATHER + ["--comm", "pallas", "--uplink",
                                            "topk"], downlink=True,
                             masks=SHORT_MASKS),
        "short-cohort-slots": dict(argv=GATHER + ["--comm", "pallas",
                                                  "--uplink", "quant",
                                                  "--ef-slots", "4"],
                                   masks=SHORT_MASKS),
        "fleet-weighted": dict(argv=GATHER + ["--comm", "pallas", "--uplink",
                                              "topk"], downlink=True,
                               fleet="weighted"),
        # full-shard provisioning (batch_size 0) of a fleet of one batch
        "fleet-full-shards": dict(argv=GATHER + ["--comm", "pallas",
                                                 "--uplink", "quant"],
                                  fleet="stacked"),
        "slots-evict-topk": dict(argv=GATHER + ["--comm", "pallas",
                                                "--uplink", "topk",
                                                "--ef-slots", "4"],
                                 downlink=True),
        # rand-k: the per-client streams and the flush's stream ids
        "slots-evict-randk": dict(argv=GATHER + ["--comm", "packed",
                                                 "--ef-slots", "4"],
                                  kind="randk"),
        "cohorts-2-quant": dict(argv=GATHER + ["--comm", "pallas",
                                               "--uplink", "quant",
                                               "--cohorts", "2"],
                                downlink=True),
        "penalty-fedavg": dict(argv=MASK + ["--comm", "pallas", "--uplink",
                                            "topk", "--strategy",
                                            "penalty-fedavg"]),
        "fedsgm-hard": dict(argv=GATHER + ["--comm", "dense", "--uplink",
                                           "topk", "--switch", "hard"]),
        "lean-metrics": dict(argv=GATHER + ["--comm", "pallas", "--uplink",
                                            "quant", "--lean-metrics"]),
        # the projection onto the ball (its norm over every column): on
        # the dense top-k wire the cuts fall between leaves, on pallas
        # quant inside them
        "proj-dense-topk": dict(argv=MASK + ["--comm", "dense", "--uplink",
                                             "topk"], downlink=True,
                                fed={"proj_radius": PROJ_RADIUS}),
        "proj-pallas-quant": dict(argv=GATHER + ["--comm", "pallas",
                                                 "--uplink", "quant"],
                                  fed={"proj_radius": PROJ_RADIUS}),
    })
    return out


PROJ_RADIUS = 40.0       # below the reduced model's ||w|| (44.5)
CASES = _cases()
REFUSALS = ("mesh-size", "obs", "async", "checkpoint", "wire")
# the data x model meshes and the cases each runs
MESHES = ((1, 2), (2, 2), (1, 4))
CASES_2D = ("pallas-topk-gather", "pallas-quant-mask", "packed-topk-mask",
            "packed-quant-gather", "dense-topk-mask", "dense-quant-gather",
            "slots-evict-topk", "short-cohort-slots", "slots-evict-randk",
            "fleet-weighted", "mask-3-of-6-topk", "cohorts-2-quant",
            "proj-dense-topk", "proj-pallas-quant")
REFUSALS_2D = ("pod", "mesh-size", "obs", "async", "checkpoint", "wire")
# the logical table that keeps the models whole on every model rank (the
# reference's own switch: the tensor axes mapped to None)
WHOLE_MODEL = {"heads": None, "kv_heads": None, "ffn": None, "vocab": None}
# the wires of the payload checks: (comm, kind)
PAYLOAD_WIRES = (("pallas", "topk"), ("pallas", "quant"), ("packed", "topk"),
                 ("packed", "quant"), ("dense", "topk"), ("dense", "quant"),
                 ("packed", "randk"), ("dense", "natural"))
# the payload check's tree with a leaf above 2^22 elements (the dense
# wire's top-k works on it by blocks) between two small leaves
GIANT_TREE = {"a": (40, 24), "big": (17, 1 << 18), "z": (300,)}


def _fleet(fed, cfg, device):
    """A quantity-skewed token fleet with the weighted sampler (phase 9(a)'s
    law at the reduced size)."""
    from repro_torch.configs.base import FleetConfig
    from repro_torch.data import synthetic
    from repro_torch.fleet import provision
    from repro_torch.tasks import lm
    fed = fed.replace(fleet=FleetConfig(
        partitioner="zipf", zipf_a=1.2, cap_factor=4.0, sampler="weighted",
        batch_size=2, redraw=True))
    toks, mask = synthetic.token_stream(torch.Generator().manual_seed(1), 32,
                                        16, cfg.vocab, device=device)
    return fed, provision.build_fleet(torch.Generator().manual_seed(2),
                                      lm.LMBatch(toks, mask), fed)


def _setup(name: str, device: str = "cpu"):
    """``(state, batch_fn, loss_pair, fed)`` of a case on ``device``, under
    whatever mesh is active (``init_state`` splits the residual over the
    ranks)."""
    from repro_torch.comm import flat
    from repro_torch.engine import rounds
    from repro_torch.fleet import provision, samplers
    from repro_torch.launch import train
    from repro_torch.scale import shard
    from repro_torch.sharding import partition
    case = CASES[name]
    state, batch_fn, loss_pair, fed, cfg, _ = train.setup(
        train.parser().parse_args(SMOLLM + ["--device", device]
                                  + case["argv"]))
    fed = fed.replace(**case.get("fed", {}))
    if case.get("kind"):
        fed = fed.replace(uplink=dataclasses.replace(fed.uplink,
                                                     kind=case["kind"]))
    if case.get("downlink"):
        fed = fed.replace(downlink=fed.uplink)
    if case.get("fleet"):
        if case["fleet"] == "weighted":
            fed, fleet = _fleet(fed, cfg, device)
        else:
            fleet = provision.from_stacked(
                batch_fn(0, torch.Generator().manual_seed(5)))
        fleet = shard.constrain_fleet(fleet)
        batch_fn = (lambda t, g: fleet)
    if case.get("masks") is not None:
        fed = fed.replace(fleet=dataclasses.replace(fed.fleet,
                                                    sampler="fixed"))
    state = rounds.init_state(
        flat.unflatten(state.spec, partition.whole(state.w)), fed,
        device=device, plan=state.plan)
    if case.get("masks") is not None:
        masks = np.asarray(case["masks"], np.float32)
        state = state._replace(sampler=samplers.fixed_state(masks, masks))
    return state, batch_fn, loss_pair, fed


def summary(state, hist) -> dict:
    """A state's tensors (the split ones gathered whole) and the
    metrics."""
    from repro_torch.scale import slots
    from repro_torch.sharding import partition
    whole = partition.whole
    out = {"w": whole(state.w), "x": whole(state.x),
           "wbar_sum": whole(state.wbar_sum),
           "wbar_weight": state.wbar_weight, "t": state.t}
    e = state.e_up
    if isinstance(e, slots.SlotStore):
        out["pool"] = whole(e.pool)
        out.update({f: getattr(e, f) for f in
                    ("owner", "stamp", "weight", "client_slot")})
    elif e is not None:
        out["e_up"] = whole(e)
    for f in hist._fields:
        v = getattr(hist, f)
        if v is not None:
            out[f"metric_{f}"] = torch.from_numpy(np.asarray(v))
    return out


def run_case(name: str, device: str = "cpu") -> dict:
    from repro_torch.engine import rounds
    state, batch_fn, loss_pair, fed = _setup(name, device)
    state, hist = rounds.run_rounds(state, batch_fn, loss_pair, fed,
                                    T=ROUNDS, device=device)
    return {k: v.cpu() if isinstance(v, torch.Tensor) else v
            for k, v in summary(state, hist).items()}


def np_setup(np_path: str):
    """The reference's ``multidev`` configuration on its dataset, with the
    recorded cohorts of :data:`NP_COHORTS` (``fixed`` sampler)."""
    from repro_torch.configs.base import (CompressorConfig, FedConfig,
                                          FleetConfig, ScaleConfig,
                                          SwitchConfig)
    from repro_torch.engine import rounds
    from repro_torch.fleet import samplers
    from repro_torch.tasks import np_classification as npc
    z = np.load(np_path)
    cfg = FedConfig(n_clients=NP_N, m=NP_M, local_steps=2, lr=0.1,
                    switch=SwitchConfig(mode="hard", eps=0.35),
                    participation="gather",
                    uplink=CompressorConfig(kind="topk", ratio=0.25, block=8),
                    downlink=CompressorConfig(kind="none"),
                    scale=ScaleConfig(ef_slots=NP_N),
                    fleet=FleetConfig(sampler="fixed"))
    params = {"b": torch.from_numpy(z["b"]), "w": torch.from_numpy(z["w"])}
    masks = np.zeros((NP_ROUNDS, NP_N), np.float32)
    for r, ids in enumerate(NP_COHORTS):
        masks[r, ids] = 1.0
    state = rounds.init_state(params, cfg, device="cpu")
    state = state._replace(sampler=samplers.fixed_state(masks, masks))
    batch = npc.NPBatch(torch.from_numpy(z["xs"]), torch.from_numpy(z["ys"]))
    return state, batch, npc.loss_pair, cfg


def run_np(np_path: str) -> dict:
    from repro_torch.engine import rounds
    state, batch, loss_pair, cfg = np_setup(np_path)
    state, hist = rounds.drive(state, batch, loss_pair, cfg, NP_ROUNDS,
                               device="cpu")
    return summary(state, hist)


def shard_checks() -> dict:
    """The reference's ``multidev`` checks (a) and (b) under the active rank
    mesh: ``sharded_take`` from a client-split stack, ``constrain_fleet`` /
    ``constrain_store`` leaving values as they are (gathered back)."""
    from repro_torch.fleet.provision import Fleet
    from repro_torch.scale import shard, slots
    from repro_torch.sharding import partition
    data = {"x": torch.arange(float(NP_N * 24)).reshape(NP_N, 4, 6)}
    idx = torch.tensor([1, 5, 8, 11])
    split = partition.constrain_leading(data, "client")
    taken = shard.sharded_take(split, idx)
    rows = partition.all_rows(taken["x"], len(idx))
    fleet = Fleet(data["x"], torch.full((NP_N,), 4), torch.full((NP_N,), 4))
    cf = shard.constrain_fleet(fleet)
    store = slots.init(NP_N, NP_N, 16, torch.float32, "cpu")
    store = store._replace(pool=torch.randn(NP_N, 16,
                                            generator=torch.Generator()
                                            .manual_seed(0)))
    cs = shard.constrain_store(store)
    return {"taken": rows, "want": data["x"][idx],
            "split": isinstance(split["x"], partition.ClientShard)
            and isinstance(cf.data, partition.ClientShard)
            and isinstance(cs.pool, partition.ClientShard),
            "fleet_data": partition.gather_leading(cf.data),
            "fleet_count": partition.gather_leading(cf.count),
            "fleet_want": data["x"], "pool": partition.gather_leading(cs.pool),
            "pool_want": store.pool, "owner_same": cs.owner is store.owner}


def split_facts(name: str) -> dict:
    """The column split of a case under the active mesh: its cuts, and
    whether one falls inside a leaf (then the whole-``[d]`` norms add two
    ranks' partials of that leaf)."""
    from repro_torch.comm import flat
    state, _, _, fed = _setup(name)
    cols = flat.columns_for(fed, state.spec)
    if cols is None:
        return {"cuts": None, "straddles": False}
    bounds = {ls.offset for ls in state.spec.leaves}
    return {"cuts": cols.split.cuts,
            "straddles": any(c not in bounds
                             for c in cols.split.cuts[1:-1])}


def _sha1(x: torch.Tensor) -> str:
    return hashlib.sha1(x.contiguous().reshape(-1).view(torch.uint8)
                        .numpy()).hexdigest()


def _payload_case(fed, spec, e, deltas, weights, key,
                  digest: bool = False) -> dict:
    """``fed``'s uplink EF14 encode of ``e + deltas`` on this rank's columns
    against one process (no columns): the payload's fields, the new
    residual and the reduce all-gathered over the model axis, beside the
    one process's (``digest``: the sha1 of their bytes), and both wire
    byte counts."""
    from repro_torch.comm import flat
    from repro_torch.sharding import collectives
    cols = flat.columns_for(fed, spec)
    whole, _ = flat.flat_transports_for(fed, spec)
    mine, _ = flat.flat_transports_for(fed, spec, cols)
    want_msgs, want_e = whole.encode(e.clone(), deltas, weights, key)
    got_msgs, got_e = mine.encode(cols.cut(e).clone(), cols.cut(deltas),
                                  weights, key)
    got = [got_msgs] if mine.codec is None else list(got_msgs)
    want = [want_msgs] if mine.codec is None else list(want_msgs)
    pair = (lambda a, b: (_sha1(a), _sha1(b))) if digest else \
        (lambda a, b: (a, b))
    return {
        "fields": [pair(collectives.all_gather_cols(_signed(a), ws),
                        _signed(b))
                   for a, b, ws in zip(got, want, _field_widths(mine))],
        "e": pair(collectives.all_gather_cols(got_e, cols.split.widths()),
                  want_e),
        "reduce": pair(collectives.all_gather_cols(
            mine.reduce(got_msgs, weights, 3), cols.split.widths()),
            whole.reduce(want_msgs, weights, 3)),
        "wire_bytes": (mine.wire_bytes(), whole.wire_bytes()),
        "cut_leaves": [ls.size for ls in spec.leaves
                       if any(ls.offset < c < ls.offset + ls.size
                              for c in cols.split.cuts)]}


def payload_checks() -> dict:
    """Each wire of :data:`PAYLOAD_WIRES` on this rank's columns against
    one process (:func:`_payload_case`): an EF14 encode of random ``[4,
    d]`` stacks of the reduced model's shape (rand-k and natural drawing
    each row from its stream).  Then ``dense-topk-giant``: the dense
    wire's top-k on ``[2, d]`` stacks of :data:`GIANT_TREE`, whose leaf
    above 2^22 elements every split cuts inside (the sort-free blockwise
    top-k of part of a leaf on each rank), kept as sha1 digests."""
    from repro_torch.comm import flat, transports
    from repro_torch.configs.base import CompressorConfig
    state, _, _, fed = _setup("pallas-topk-mask")
    spec = state.spec
    g = torch.Generator().manual_seed(3)
    e = torch.randn(4, spec.d, generator=g)
    deltas = torch.randn(4, spec.d, generator=g)
    weights = torch.tensor([1.0, 0.0, 2.0, 1.0])
    key = transports.WireKey(7, 1, transports.UPLINK)
    out = {}
    for comm, kind in PAYLOAD_WIRES:
        cc = CompressorConfig(kind=kind, ratio=0.1, bits=4)
        out[f"{comm}-{kind}"] = _payload_case(
            fed.replace(comm=comm, uplink=cc, downlink=cc), spec, e, deltas,
            weights, key)
    spec = flat.spec_of({k: torch.empty(v, device="meta")
                         for k, v in GIANT_TREE.items()})
    cc = CompressorConfig(kind="topk", ratio=0.1)
    e = torch.randn(2, spec.d, generator=g)
    deltas = torch.randn(2, spec.d, generator=g)
    out["dense-topk-giant"] = _payload_case(
        fed.replace(comm="dense", uplink=cc, downlink=cc), spec, e, deltas,
        torch.tensor([1.0, 2.0]), key, digest=True)
    return out


def _signed(x: torch.Tensor) -> torch.Tensor:
    from repro_torch.comm import transports
    signed = transports.SIGNED_VIEWS.get(x.dtype)
    return x if signed is None else x.view(signed)


def _field_widths(ft) -> list:
    """Per message field of a column transport ``ft``, every model rank's
    width of it: the columns on a dense wire, the slots of values and
    offsets, the words and scales of quant."""
    from repro_torch.comm import flat
    split = ft.cols.split
    if ft.codec is None:
        return [split.widths()]
    layout = flat.wire_layout(ft.spec, ft.cfg)
    cuts = [flat.local_layout(layout, *split.block(r))[1]
            for r in range(len(split.cuts) - 1)]
    names = ("words", "blocks") if isinstance(ft.codec, flat._QuantCodec) \
        else ("slots", "slots")
    return [[getattr(c, f)[1] - getattr(c, f)[0] for c in cuts]
            for f in names]


def refusal(what: str, W: int) -> bool:
    """Whether ``what`` raises ``NotImplementedError`` under the active
    rank mesh of ``W`` ranks (the mesh stays active)."""
    from repro_torch import checkpoint
    from repro_torch.configs.base import AsyncConfig, ObsConfig
    from repro_torch.engine import async_rounds, rounds
    from repro_torch.launch import mesh
    from repro_torch.sharding import partition
    from repro_torch.wire import coordinator
    active = partition.current_mesh()
    try:
        if what == "pod":
            partition.activate_mesh(mesh.make_rank_mesh(
                "cpu", shape=(2, W // 4, 2), axes=("pod", "data", "model")))
        elif what == "mesh-size":
            shape = (W - 1,) if active is None or \
                len(active.axis_names) == 1 else (1, W - 1)
            partition.activate_mesh(mesh.make_rank_mesh(
                "cpu", shape=shape, axes=("data", "model")[:len(shape)]))
        else:
            state, batch_fn, loss_pair, fed = _setup("pallas-topk-mask")
            if what == "obs":
                rounds.run_rounds(state, batch_fn, loss_pair,
                                  fed.replace(obs=ObsConfig(enabled=True)),
                                  T=1, device="cpu")
            elif what == "async":
                fed = fed.replace(async_=AsyncConfig(enabled=True))
                async_rounds.async_round_step(
                    state, None, batch_fn(0, torch.Generator()), loss_pair,
                    fed, device="cpu")
            elif what == "checkpoint":
                checkpoint.save(os.devnull, {"w": state.w})
            elif what == "wire":
                coordinator.wire_drive(fed, 1, device="cpu")
    except NotImplementedError:
        return partition.current_mesh() is active
    return False


TRACED = ("all_gather", "all_to_all_single", "broadcast",
          "broadcast_object_list", "new_group")
# the cases whose collective calls on a (W, 1) mesh are pinned
LOG_CASES = ("pallas-topk-mask", "dense-quant-gather", "short-cohort-slots",
             "fleet-weighted", "mask-3-of-6-topk")


def _describe(value):
    """A call argument as plain data: a tensor's shape and dtype, a list's
    entries, a number or string as it is."""
    if isinstance(value, torch.Tensor):
        return (tuple(value.shape), str(value.dtype))
    if isinstance(value, (list, tuple)):
        return [_describe(v) for v in value]
    if isinstance(value, (int, float, str, bool)):
        return value
    return type(value).__name__


def call_log(names, W: int, device: str = "cpu") -> dict:
    """Each case of ``names`` run under a ``(W, 1)`` ``("data", "model")``
    rank mesh with the ``torch.distributed`` calls of :data:`TRACED`
    recorded, the mesh's activation included (in the first case's log):
    every call's function and its bound arguments (tensors as shape and
    dtype, arguments left at None dropped, so a call on the default group
    reads the same whether or not it names it)."""
    import inspect

    import torch.distributed as dist
    from repro_torch.launch import mesh
    from repro_torch.sharding import partition
    log: list = []
    saved = {name: getattr(dist, name) for name in TRACED}

    def wrap(name, fn):
        sig = inspect.signature(fn)

        def traced(*args, **kwargs):
            bound = sig.bind(*args, **kwargs).arguments
            log.append((name, {k: _describe(v) for k, v in bound.items()
                               if v is not None}))
            return fn(*args, **kwargs)
        return traced
    out = {}
    try:
        for name, fn in saved.items():
            setattr(dist, name, wrap(name, fn))
        partition.activate_mesh(mesh.make_rank_mesh(
            device, shape=(W, 1), axes=("data", "model")))
        for case in names:
            run_case(case, device)
            out[case] = repr(log)
            log.clear()
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
    return out


def world_main(rank: int, W: int, store_path: str, out_dir: str,
               np_path, timeout_s: float, device: str = "cpu",
               names=None, shape=None) -> None:
    """One rank: every case under a rank mesh of W ranks on ``device`` --
    the client axis alone, or the ``("data", "model")`` mesh ``shape`` --
    and the checks of that world (``names``: those cases only, on a card
    shared by the ranks); the results to ``out_dir/rank<r>.pt``.

    * a client axis: every case of :data:`CASES`, the reference's
      ``multidev`` configuration, the refusals, the shard checks and the
      collective calls of :data:`LOG_CASES` on a ``(W, 1)`` mesh;
    * a data x model mesh: the cases of :data:`CASES_2D`, each one's
      column split, the payload checks and, on ``(2, 2)``, the
      ``multidev`` configuration and the refusals of
      :data:`REFUSALS_2D`."""
    import torch.distributed as dist
    from repro_torch.launch import mesh
    from repro_torch.sharding import collectives, partition
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, W), rank=rank,
        world_size=W, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        if shape is None:
            partition.activate_mesh(mesh.make_rank_mesh(device))
            assert partition.rank_axis().rank == rank
        else:
            partition.activate_mesh(mesh.make_rank_mesh(
                device, shape=shape, axes=("data", "model")),
                logical=WHOLE_MODEL)
        out = {"cases": {}, "seconds": {}}
        collectives.reset_stats()
        for name in names or (CASES if shape is None else CASES_2D):
            t0 = time.perf_counter()
            out["cases"][name] = run_case(name, device)
            out["seconds"][name] = time.perf_counter() - t0
        out["collectives"] = collectives.stats()
        out["collectives_by_axis"] = collectives.stats_by_axis()
        if names is None and shape is None:
            out["cases"]["np-multidev"] = run_np(np_path)
            out["shard"] = shard_checks()
            out["refusals"] = {what: refusal(what, W) for what in REFUSALS}
            out["call_log"] = call_log(LOG_CASES, W, device)
        elif names is None:
            out["splits"] = {name: split_facts(name) for name in CASES_2D}
            out["payloads"] = payload_checks()
            if tuple(shape) == (2, 2):
                out["cases"]["np-multidev"] = run_np(np_path)
                out["refusals"] = {what: refusal(what, W)
                                   for what in REFUSALS_2D}
        partition.activate_mesh(None)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        partition.activate_mesh(None)
        dist.destroy_process_group()


def spawn_world(W: int, folder: str, np_path=None,
                timeout_s: float = 240.0, device: str = "cpu",
                names=None, shape=None) -> list:
    """Start W ranks by ``spawn`` and wait for them (at most ``timeout_s``
    seconds: then every rank is killed and ``TimeoutError`` raised; a rank
    that fails raises here); :func:`world_main` gives what they run (on
    the data x model mesh ``shape`` when given).  Returns each rank's
    results, in rank order."""
    import torch.multiprocessing as mp
    os.makedirs(folder, exist_ok=True)
    store = os.path.join(folder, "store")
    ctx = mp.start_processes(world_main, args=(W, store, folder, np_path,
                                               timeout_s, device, names,
                                               shape),
                             nprocs=W, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"a world of {W} ranks ran past {timeout_s} s")
    return [torch.load(os.path.join(folder, f"rank{r}.pt"),
                       weights_only=False) for r in range(W)]


# ---------------------------------------------------------------------------
# Tensor parallelism inside the dense family (test_torch_tensor_parallel.py)
# ---------------------------------------------------------------------------

# the dense family's archs, reduced; gemma3 at 4 layers (one whole period
# of its 2:1 pattern in "blocks", stacked, and one layer in "rest")
TP_ARCHS = {"smollm-360m": {}, "qwen3-4b": {}, "minitron-4b": {},
            "gemma3-4b": {"n_layers": 4}}
TP_SEQ, TP_BATCH = 16, 2
# rounds under a split plan: (arch, launcher arguments, config changes,
# compressed downlink[, extras: "fed", FedConfig changes; "fleet":
# "weighted", :func:`_fleet`'s token fleet])
TP_CASES = {
    # the fused eval, an uncompressed wire
    "qwen3-none-mask": ("qwen3-4b", MASK + ["--comm", "pallas",
                                            "--uplink", "none"], {}, False),
    # the separate eval over all 6, top-k up and down
    "qwen3-topk-gather": ("qwen3-4b", GATHER + ["--comm", "pallas",
                                                "--uplink", "topk"], {},
                          True),
    "qwen3-quant-mask-no-remat": ("qwen3-4b", MASK + ["--comm", "pallas",
                                                      "--uplink", "quant"],
                                  {"remat": False}, False),
    # attention whole (3 heads, 1 kv group), ffn and the tied vocab split
    "smollm-quant-mask": ("smollm-360m", MASK + ["--comm", "pallas",
                                                 "--uplink", "quant"], {},
                          False),
    "gemma3-topk-mask": ("gemma3-4b", MASK + ["--comm", "pallas", "--uplink",
                                              "topk"], {"n_layers": 4},
                         False),
    "minitron-none-gather": ("minitron-4b", GATHER + ["--comm", "pallas",
                                                      "--uplink", "none"],
                             {"remat": False}, False),
    # the split plan beside the round's other state layouts: the slot
    # store's pool (4 slots for 6 clients: evictions flush), the packed
    # and the dense wires, the client fleet, the projection onto the ball
    "qwen3-slots-evict-topk": ("qwen3-4b", GATHER + ["--comm", "pallas",
                                                     "--uplink", "topk",
                                                     "--ef-slots", "4"],
                               {}, True),
    "qwen3-packed-topk-mask": ("qwen3-4b", MASK + ["--comm", "packed",
                                                   "--uplink", "topk"], {},
                               True),
    # on the uncompressed wire, held by the exact law (on top-k up and
    # down its g_full at round 2 ends 1.5e-5 from one process's at (1, 4),
    # relative: g, a CE less its budget of 6, is 0.18)
    "qwen3-fleet-weighted-none": ("qwen3-4b", GATHER + ["--comm", "pallas",
                                                        "--uplink", "none"],
                                  {}, False, {"fleet": "weighted"}),
    "smollm-proj-dense-topk": ("smollm-360m", MASK + ["--comm", "dense",
                                                      "--uplink", "topk"],
                               {}, True, {"fed": {"proj_radius":
                                                  PROJ_RADIUS}}),
}
# the case run again under WHOLE_MODEL: bit-equal to one process
TP_WHOLE_CASE = "qwen3-topk-gather"


def tp_config(arch: str, over=None):
    """The reduced config of a dense arch (with :data:`TP_ARCHS`'s changes
    and ``over``)."""
    from repro_torch import configs
    return dataclasses.replace(configs.get_reduced(arch),
                               **{**TP_ARCHS[arch], **(over or {})})


def tp_params(cfg):
    """The port's weights of ``cfg`` on the CPU, seed 0 (the same on every
    rank)."""
    from repro_torch.models import build
    return build(cfg).init(torch.Generator().manual_seed(0), cfg,
                           device="cpu")


def tp_batch(vocab: int):
    """Tokens ``[B, S]`` and a minority mask (its last 4 positions), from
    numpy seed 0."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, vocab, size=(TP_BATCH, TP_SEQ), dtype=np.int64)
    mask = np.zeros((TP_BATCH, TP_SEQ), np.float32)
    mask[:, -4:] = 1.0
    return torch.from_numpy(toks), torch.from_numpy(mask)


def _even_columns(spec):
    """Even column blocks of ``spec`` over the model axis (no wire: every
    column a unit) and this rank's."""
    from repro_torch.comm import flat
    from repro_torch.sharding import partition
    ma = partition.model_axis()
    split = flat.column_split(spec, (), ma.size)
    return flat.Columns(split, *split.block(ma.rank))


def tp_forward_grad(arch: str) -> dict:
    """One loss pair and the gradient of f of a reduced dense arch under the
    active rank mesh's split plan (or, with no model axis, in one process):
    the weights' columns into the tensor layout (against slicing each
    leaf, bit for bit), the forward's logits gathered whole over the vocab
    blocks, f and g, the gradient mapped back to the columns and gathered
    whole, and the sha1 of f, g and the whole leaves' local gradients (the
    same on every model rank)."""
    from repro_torch.comm import flat
    from repro_torch.models import build
    from repro_torch.sharding import collectives, partition
    from repro_torch.tasks import lm
    cfg = tp_config(arch)
    fns = build(cfg)
    params = tp_params(cfg)
    spec = flat.spec_of(params)
    w = flat.flatten(spec, params)
    toks, mask = tp_batch(cfg.vocab)
    pair = lm.make_loss_pair(fns.forward, cfg, budget=6.0)
    plan = fns.tensor_plan(spec)
    out = {"plan": plan.dims}
    if partition.model_axis() is None:
        leaf = w.clone().requires_grad_(True)
        mspec, layout = spec, None
    else:
        cols = _even_columns(spec)
        layout = flat.TensorLayout(spec, cols, plan,
                                   partition.model_axis().rank)
        local = layout.to_tensor(cols.cut(w).clone())
        want = []
        for i, ls in enumerate(spec.leaves):
            x = w[ls.offset:ls.offset + ls.size].reshape(ls.shape)
            dim = plan.dims[i]
            if dim is not None:
                c = ls.shape[dim] // plan.size
                x = x.narrow(dim, partition.model_axis().rank * c, c)
            want.append(x.reshape(-1))
        out["layout_exact"] = torch.equal(local, torch.cat(want))
        leaf = local.requires_grad_(True)
        mspec = layout.spec
    tree = flat.unflatten(mspec, leaf)
    with torch.no_grad():
        logits = fns.forward(tree, cfg, toks)
    # a split plan's logits are this rank's vocab block
    out["logits"] = logits if logits.shape[-1] == cfg.vocab else \
        collectives.all_gather_cols(logits.contiguous(),
                                    [logits.shape[-1]] * plan.size)
    f, g = pair(tree, lm.LMBatch(toks, mask))
    f.backward()
    grad = leaf.grad
    out.update(f=f.detach(), g=g.detach())
    if layout is not None:
        cols_grad = layout.to_columns(grad, torch.empty(layout.cols.width))
        out["grad"] = collectives.all_gather_cols(cols_grad,
                                                  layout.cols.split.widths())
        whole = [grad[ls.offset:ls.offset + ls.size]
                 for ls, dim in zip(mspec.leaves, plan.dims) if dim is None]
        out["sha1"] = {"f": _sha1(f.detach()), "g": _sha1(g.detach()),
                       "whole_grads": _sha1(torch.cat(whole)) if whole
                       else None}
    else:
        out["grad"] = grad
    return out


def tp_collective_checks() -> dict:
    """"f", "g" and the MAX reduce over the model axis on per-rank tensors
    (seeded by the model rank), with their gradients, beside what one
    process computes from every rank's tensors."""
    from repro_torch.sharding import collectives, partition
    ma = partition.model_axis()
    M, me = ma.size, ma.rank

    def draw(r, *shape):
        return torch.randn(*shape, generator=torch.Generator()
                           .manual_seed(100 + r), dtype=torch.float32)
    xs = [draw(r, 3, 5) for r in range(M)]
    cs = [draw(10 + r, 3, 5) for r in range(M)]
    x = xs[me].clone().requires_grad_(True)
    y = collectives.reduce_sum(x)
    (y * cs[me]).sum().backward()
    want_sum = xs[0]
    for v in xs[1:]:
        want_sum = want_sum + v
    out = {"g_value": torch.equal(y.detach(), want_sum),
           "g_grad": torch.equal(x.grad, cs[me])}
    x = xs[me].clone().requires_grad_(True)
    z = collectives.copy_in(x)
    (z * cs[me]).sum().backward()
    want_grad = cs[0]
    for v in cs[1:]:
        want_grad = want_grad + v
    out["f_value"] = torch.equal(z.detach(), xs[me])
    out["f_grad"] = torch.equal(x.grad, want_grad)
    x = xs[me].clone().requires_grad_(True)
    m = collectives.reduce_max(x)
    out["max_value"] = torch.equal(m, torch.stack(xs).amax(0))
    out["max_no_grad"] = not m.requires_grad
    return out


def tp_cross_entropy_checks() -> list:
    """The vocab-parallel CE (``common.cross_entropy`` with ``vocab_lo``)
    on each model rank's block of ``[2, 7, 24]`` logits, with either mask
    and none, beside the whole logits' CE: ``(value, want, grad block,
    want block)`` per mask."""
    from repro_torch.models import common
    from repro_torch.sharding import partition
    ma = partition.model_axis()
    g = torch.Generator().manual_seed(5)
    V = 24
    logits = torch.randn(2, 7, V, generator=g) * 3.0
    targets = torch.randint(0, V, (2, 7), generator=g)
    m = (torch.rand(2, 7, generator=g) < 0.3).to(torch.float32)
    width = V // ma.size
    lo = ma.rank * width
    out = []
    for mask in (m, 1.0 - m, None):
        whole = logits.clone().requires_grad_(True)
        want = common.cross_entropy(whole, targets, mask)
        want.backward()
        block = logits[..., lo:lo + width].clone().requires_grad_(True)
        got = common.cross_entropy(block, targets, mask, vocab_lo=lo)
        got.backward()
        out.append((got.detach(), want.detach(), block.grad,
                    whole.grad[..., lo:lo + width]))
    return out


def tp_setup(name: str, device: str = "cpu"):
    """``(state, batch_fn, loss_pair, fed)`` of a :data:`TP_CASES` case
    under whatever mesh is active (the launcher's setup, so its plan).
    The weights and every round's tokens are drawn on the CPU and moved
    to ``device``, so a card's rounds start from the CPU's (the launcher
    draws on its device: a card's generator gives other values)."""
    from repro_torch.comm import flat
    from repro_torch.engine import rounds
    from repro_torch.launch import train
    from repro_torch.scale import shard
    from repro_torch.sharding import partition
    arch, argv, over, downlink, *extra = TP_CASES[name]
    extra = extra[0] if extra else {}
    args = train.parser().parse_args(["--arch", arch, "--reduced", "--seq",
                                      str(TP_SEQ), "--device", "cpu"]
                                     + argv)
    cfg = tp_config(arch, over)
    state, batch_fn, loss_pair, fed, _, _ = train.setup(args, cfg)
    if downlink:
        fed = fed.replace(downlink=fed.uplink)
    fed = fed.replace(**extra.get("fed", {}))
    if extra.get("fleet") == "weighted":
        fed, fleet = _fleet(fed, cfg, device)
        fleet = shard.constrain_fleet(fleet)
        batch_fn = (lambda t, g: fleet)
    elif device != "cpu":
        host_fn = batch_fn

        def batch_fn(t, g):
            b = host_fn(t, g)
            return b._replace(tokens=b.tokens.to(device),
                              minority_mask=b.minority_mask.to(device))
    if downlink or extra or device != "cpu":
        state = rounds.init_state(
            flat.unflatten(state.spec, partition.whole(state.w).to(device)),
            fed, device=device, plan=state.plan)
    return state, batch_fn, loss_pair, fed


def run_tp_case(name: str, device: str = "cpu") -> dict:
    from repro_torch.engine import rounds
    state, batch_fn, loss_pair, fed = tp_setup(name, device)
    split = state.plan is not None and state.plan.split
    state, hist = rounds.run_rounds(state, batch_fn, loss_pair, fed,
                                    T=ROUNDS, device=device)
    out = {k: v.cpu() if isinstance(v, torch.Tensor) else v
           for k, v in summary(state, hist).items()}
    out["split_plan"] = split
    return out


def tp_law(got: dict, want: dict, exact_wire: bool) -> None:
    """A split plan's rounds against one process (summaries of
    :func:`summary`), ``test_torch_tensor_parallel.py``'s law: the wire
    bytes, ``feasible`` and the integer leaves equal; on an uncompressed
    wire (``exact_wire``) every float within rtol 1e-5 / atol 1e-7;
    otherwise the metrics within rtol 1e-5, all but 0.1% of each other
    float buffer within rtol 1e-4 / atol 1e-6, and each residual row within
    5% of one process's in norm."""
    assert got.keys() == want.keys()
    for key, v in want.items():
        if not isinstance(v, torch.Tensor):
            assert got[key] == v, key
            continue
        a, b = got[key].numpy(), v.numpy()
        if key in ("metric_feasible", "metric_up_bytes",
                   "metric_down_bytes", "wbar_weight") or \
                not v.dtype.is_floating_point:
            np.testing.assert_array_equal(a, b, err_msg=key)
        elif exact_wire:
            np.testing.assert_allclose(a.astype(np.float64),
                                       b.astype(np.float64), rtol=1e-5,
                                       atol=1e-7, err_msg=key)
        elif key.startswith("metric_"):
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=key)
        elif key in ("e_up", "pool"):
            gap = np.linalg.norm((a - b).astype(np.float64), axis=-1)
            size = np.linalg.norm(b.astype(np.float64), axis=-1)
            assert (gap <= 5e-2 * size).all(), (key, gap / size)
        else:
            far = ~np.isclose(a, b, rtol=1e-4, atol=1e-6)
            assert far.mean() <= 1e-3, (key, int(far.sum()), far.size)


def tp_world_main(rank: int, W: int, store_path: str, out_dir: str,
                  timeout_s: float, shape, device: str = "cpu",
                  names=None) -> None:
    """One rank of a tensor-parallel world on the ``("data", "model")``
    mesh ``shape``: the collective and CE checks, each dense arch's
    forward and gradient, every case of :data:`TP_CASES`, then
    :data:`TP_WHOLE_CASE` under :data:`WHOLE_MODEL` (``names``: those
    cases only, on ``device``: a card the ranks share); the results (and
    the sha1 of each case's summary) to ``out_dir/rank<r>.pt``."""
    import torch.distributed as dist
    from repro_torch.launch import mesh
    from repro_torch.sharding import collectives, partition
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, W), rank=rank,
        world_size=W, timeout=datetime.timedelta(seconds=timeout_s))
    rank_mesh = mesh.make_rank_mesh(device, shape=shape,
                                    axes=("data", "model"))
    try:
        partition.activate_mesh(rank_mesh)
        out = {"cases": {}, "seconds": {}}
        if names is None:
            out.update(collectives=tp_collective_checks(),
                       ce=tp_cross_entropy_checks(),
                       forward={a: tp_forward_grad(a) for a in TP_ARCHS})
        collectives.reset_stats()
        for name in names or TP_CASES:
            t0 = time.perf_counter()
            out["cases"][name] = run_tp_case(name, device)
            out["seconds"][name] = time.perf_counter() - t0
        out["collectives_by_axis"] = collectives.stats_by_axis()
        if names is None:
            partition.activate_mesh(rank_mesh, logical=WHOLE_MODEL)
            out["whole_case"] = run_tp_case(TP_WHOLE_CASE)
        out["digests"] = {
            name: _sha1(torch.cat([v.reshape(-1).to(torch.float64)
                                   for v in res.values()
                                   if isinstance(v, torch.Tensor)]))
            for name, res in out["cases"].items()}
        partition.activate_mesh(None)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        partition.activate_mesh(None)
        dist.destroy_process_group()


def spawn_tp_world(shape, folder: str, timeout_s: float = 300.0,
                   device: str = "cpu", names=None) -> list:
    """Start the ranks of :func:`tp_world_main` on the data x model mesh
    ``shape`` by ``spawn`` and wait for them (at most ``timeout_s``
    seconds); each rank's results, in rank order."""
    import torch.multiprocessing as mp
    W = shape[0] * shape[1]
    os.makedirs(folder, exist_ok=True)
    store = os.path.join(folder, "store")
    ctx = mp.start_processes(tp_world_main, args=(W, store, folder,
                                                  timeout_s, tuple(shape),
                                                  device, names),
                             nprocs=W, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"a world of {W} ranks ran past {timeout_s} s")
    return [torch.load(os.path.join(folder, f"rank{r}.pt"),
                       weights_only=False) for r in range(W)]
