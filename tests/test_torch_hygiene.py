"""Hygiene of the port: it imports neither JAX nor the JAX package, its
entry points run on ``cuda`` unless asked for the CPU, and its kernel
wrappers run the plain versions on CPU tensors without counting a launch."""
import ast
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs.base import CompressorConfig, FedConfig, FleetConfig
from repro_torch.engine import rounds
from repro_torch.fleet import samplers
from repro_torch.kernels.quantize_ef import quantize_ef
from repro_torch.kernels.quantize_ef_pack import quantize_ef_pack
from repro_torch.kernels.scatter_agg import scatter_agg, segment_rows
from repro_torch.kernels.switch_blend import switch_blend
from repro_torch.kernels.topk_block import block_topk
from repro_torch.kernels.unpack_mma import unpack_mma
from repro_torch.launch import train

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    assert path.exists()
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(ROOT)} imports {mod}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # tiny shapes: one intra-op thread beats contending with the other
    # test workers for the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fed():
    return FedConfig(n_clients=2, m=2, lr=0.03,
                     uplink=CompressorConfig(kind="quant"), comm="pallas")


def test_launcher_needs_a_card_unless_asked_for_cpu(no_card):
    argv = ["--reduced", "--seq", "8", "--batch", "1", "--clients", "2",
            "--rounds", "1", "--uplink", "quant"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(argv)
    state = train.main(argv + ["--device", "cpu"])
    assert state.w.device.type == "cpu" and state.t == 10
    assert torch.isfinite(state.w).all()


def test_round_step_needs_a_card_unless_asked_for_cpu(no_card):
    args = train.parser().parse_args(["--reduced", "--seq", "8", "--batch",
                                      "1", "--device", "cpu", "--clients",
                                      "2"])
    state, batch_fn, loss_pair, _, _, _ = train.setup(args)
    fed = _fed()
    batches = batch_fn(0, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rounds.round_step(state, batches, loss_pair, fed)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rounds.init_state({"w": torch.zeros(3)}, fed)
    new, met = rounds.round_step(state, batches, loss_pair, fed,
                                 device="cpu")
    assert new.t == 1 and np.isfinite(float(met.f))


def test_not_ported_paths_raise():
    """No reference flag is refused as not ported any more: ``--wire`` runs
    (``repro_torch.wire``), and ends the run with ``SystemExit`` beside a
    flag the wire cannot drive; the slot store, two-tier cohorts,
    ``--client-chunk``, checkpoints, async rounds and obs are ported (they
    set up), and so are the samplers' mid-round events.  The launcher has
    no flag for the tuner, which is not ported."""
    assert train._NOT_PORTED == ()
    args = train.parser().parse_args(
        ["--device", "cpu", "--wire", "2", "--wire-deadline", "9",
         "--wire-heartbeat", "0.5", "--min-quorum", "0.75",
         "--max-respawns", "3"])
    assert (args.wire, args.wire_deadline, args.wire_heartbeat,
            args.min_quorum, args.max_respawns) == (2, 9.0, 0.5, 0.75, 3)
    with pytest.raises(SystemExit, match="--fleet is not drivable"):
        train.main(["--device", "cpu", "--fleet", "--async-buffer",
                    "--wire", "2"])
    assert train.parser().parse_args(["--ckpt-dir", "x"]).ckpt_dir == "x"
    for flag in (["--async-buffer"], ["--obs"],
                 ["--fleet", "--async-buffer", "--obs"],
                 ["--ef-slots", "2", "--participation", "gather"],
                 ["--cohorts", "2"], ["--client-chunk", "1"]):
        args = train.parser().parse_args(
            ["--device", "cpu", "--reduced", "--seq", "8", "--batch", "1",
             "--clients", "2"] + flag)
        state, _, _, fed, _, _ = train.setup(args)
        assert fed.async_.enabled == ("--async-buffer" in flag)
        assert fed.obs.enabled == ("--obs" in flag)
        assert fed.scale.ef_slots == (2 if "--ef-slots" in flag else 0)
        assert fed.scale.cohorts == (2 if "--cohorts" in flag else 1)
        assert fed.client_chunk == (1 if "--client-chunk" in flag else 0)
    for name in ("uniform", "weighted", "markov"):
        fed = _fed().replace(fleet=FleetConfig(sampler=name))
        ev, _ = samplers.get_sampler(name).events(
            torch.Generator().manual_seed(0), fed, torch.ones(2),
            torch.ones(2) if name == "markov" else None)
        assert ev.depart.shape == ev.arrive.shape == (2,)


def test_new_modules_are_scanned():
    """The async engine, obs, scale-out, sharding (its collectives too),
    checkpoint and launch tooling modules are among the files the import
    scan reads."""
    scanned = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("engine/async_rounds.py", "obs/__init__.py", "obs/bus.py",
                "obs/log.py", "obs/sinks.py", "obs/trace.py",
                "checkpoint.py", "scale/__init__.py", "scale/slots.py",
                "scale/shard.py", "sharding/__init__.py",
                "sharding/partition.py", "sharding/collectives.py",
                "core/packing.py",
                "core/error_feedback.py", "models/mamba2.py",
                "models/griffin.py", "configs/qwen3_4b.py",
                "configs/minitron_4b.py", "configs/gemma3_4b.py",
                "configs/mamba2_130m.py", "configs/recurrentgemma_2b.py",
                "wire/__init__.py", "wire/frames.py", "wire/testing.py",
                "wire/bootstrap.py", "wire/supervisor.py", "wire/worker.py",
                "wire/coordinator.py", "models/rules.py", "launch/mesh.py",
                "launch/steps.py", "launch/dryrun.py", "launch/roofline.py"):
        assert f"src/repro_torch/{mod}" in scanned


def test_wire_needs_a_card_unless_asked_for_cpu(no_card):
    """``wire_drive``, ``Coordinator``, ``Worker``, ``run_worker``, the
    worker CLI and the problem builders raise without a card unless asked
    for the CPU; on the CPU one 2-worker thread round runs."""
    from repro_torch.configs.base import SwitchConfig
    from repro_torch.wire import bootstrap, coordinator, worker
    fed = FedConfig(n_clients=4, m=2, lr=0.1, participation="gather",
                    lean_metrics=True, comm="packed",
                    switch=SwitchConfig(eps=0.35),
                    uplink=CompressorConfig(kind="topk", ratio=0.25,
                                            block=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coordinator.wire_drive(fed, 1, spawn="thread")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bootstrap.build_problem("np", {"n_clients": 4})
    params, batches, pair = bootstrap.build_problem(
        "np", {"n_clients": 4}, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coordinator.Coordinator(params, fed)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.Worker(params, fed, batches, pair, range(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.run_worker("127.0.0.1", 9, "np", {}, fed, 1, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.main(["--connect", "127.0.0.1:9", "--fed",
                     bootstrap.fed_to_json(fed), "--workers", "1",
                     "--worker-id", "0"])
    state, mets, stats = coordinator.wire_drive(fed, 1, spawn="thread",
                                                device="cpu")
    assert state.w.device.type == "cpu" and state.t == 1
    assert np.isfinite(mets.f).all() and stats.totals["missing"] == 0


@pytest.mark.parametrize("arch", ["qwen3-4b", "minitron-4b", "gemma3-4b",
                                  "mamba2-130m", "recurrentgemma-2b"])
def test_family_launcher_needs_a_card_unless_asked_for_cpu(no_card, arch):
    """``--arch`` of each token-only family: raises without a card; on the
    CPU, one chunk of ten reduced rounds on the pallas wire."""
    argv = ["--arch", arch, "--reduced", "--seq", "8", "--batch", "1",
            "--clients", "2", "--comm", "pallas", "--uplink", "quant",
            "--rounds", "1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(argv)
    state = train.main(argv + ["--device", "cpu"])
    assert state.w.device.type == "cpu" and state.t == 10
    assert torch.isfinite(state.w).all()


@pytest.mark.parametrize("fleet", [False, True])
def test_async_obs_launcher_needs_a_card_unless_asked_for_cpu(
        no_card, tmp_path, capsys, fleet):
    """``--async-buffer`` with the telemetry bus, the JSONL sink and a
    profile window: raises without a card; on the CPU, ten rounds of
    records with the async counters and the telemetry, one trace."""
    path = tmp_path / "m.jsonl"
    argv = ["--reduced", "--seq", "8", "--batch", "1", "--clients", "4",
            "--participating", "2", "--participation", "gather", "--comm",
            "pallas", "--uplink", "topk", "--rounds", "1", "--async-buffer",
            "--staleness", "constraint", "--max-staleness", "2", "--depart",
            "0.5", "--obs", "--obs-window", "3", "--sink", "jsonl",
            "--sink-path", str(path), "--log-level", "warning",
            "--profile", "0:10"]
    if fleet:
        argv += ["--fleet", "--fleet-pool", "3", "--sampler", "markov"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(argv)
    path.unlink(missing_ok=True)
    cwd = pathlib.Path.cwd()
    try:
        os.chdir(tmp_path)
        state = train.main(argv + ["--device", "cpu"])
    finally:
        os.chdir(cwd)
    assert state.t == 10 and torch.isfinite(state.w).all()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert lines[0]["meta"]["async_buffer"] and lines[0]["meta"]["obs"]
    recs = lines[1:]
    assert [r["round"] for r in recs] == list(range(1, 11))
    assert all("merged" in r and "tel_buf_stale_hist" in r for r in recs)
    assert sum(r["departed"] for r in recs) > 0
    assert (tmp_path / "profiles" / "trace_0_10.json").exists()
    assert capsys.readouterr().out == ""     # --log-level warning


def test_stdout_sink_reports_async_counters(no_card, capsys):
    train.main(["--reduced", "--seq", "8", "--batch", "1", "--clients", "2",
                "--rounds", "1", "--async-buffer", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 11 and "async buffer" in out[0]
    assert all("buffered=" in x and "merged=" in x for x in out[1:])
    train.main(["--reduced", "--seq", "8", "--batch", "1", "--clients", "2",
                "--rounds", "1", "--device", "cpu", "--quiet"])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("sampler", ["weighted", "markov"])
def test_fleet_launcher_needs_a_card_unless_asked_for_cpu(no_card, sampler):
    argv = ["--reduced", "--seq", "8", "--batch", "1", "--clients", "4",
            "--participating", "2", "--participation", "gather", "--comm",
            "pallas", "--uplink", "topk", "--rounds", "1", "--fleet",
            "--fleet-pool", "3", "--sampler", sampler]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(argv)
    state = train.main(argv + ["--device", "cpu"])
    assert state.w.device.type == "cpu" and state.t == 10
    assert torch.isfinite(state.w).all()
    if sampler == "markov":
        assert state.sampler.shape == (4,)


def test_quickstart_needs_a_card_unless_asked_for_cpu(no_card):
    """The quickstart's entry point needs a card; its three parts run on
    the CPU when asked (2 rounds each here)."""
    from repro_torch.examples import quickstart
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.engine_demo(T=2)
    figure1 = [quickstart.run(mode, T=2, device="cpu")
               for mode in ("hard", "soft")]
    assert all(np.isfinite(r["f_wbar"]) for r in figure1)
    sweep = quickstart.fleet_demo(T=2, device="cpu")
    assert [r["alpha"] for r in sweep] == [100.0, 1.0, 0.1]
    assert all(np.isfinite(r["f"]) for r in sweep)
    assert quickstart.engine_demo(T=2, device="cpu")["gather_equals_mask"]


def test_lm_fleet_needs_a_card_unless_asked_for_cpu(no_card):
    from repro_torch.tasks import lm
    fed = _fed().replace(fleet=FleetConfig(batch_size=1, redraw=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.make_fleet(torch.Generator().manual_seed(0), fed, pool=3,
                      seq_len=8, vocab=64)
    fleet = lm.make_fleet(torch.Generator().manual_seed(0), fed, pool=3,
                          seq_len=8, vocab=64, device="cpu")
    assert fleet.data.tokens.shape == (2, 3, 8)
    assert fleet.data.tokens.device.type == "cpu"


def test_token_draws_refuse_a_card_generator():
    """Token draws come from CPU generators only: a generator on any other
    device is refused before it draws."""
    from repro_torch.data import synthetic

    class CardGen:
        device = torch.device("cuda")
    with pytest.raises(ValueError, match="CPU generator"):
        synthetic.token_stream(CardGen(), 1, 8, 64)


def test_gather_launcher_needs_a_card_unless_asked_for_cpu(no_card):
    argv = ["--reduced", "--seq", "8", "--batch", "1", "--clients", "4",
            "--participating", "2", "--participation", "gather", "--comm",
            "pallas", "--uplink", "topk", "--rounds", "1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(argv)
    state = train.main(argv + ["--device", "cpu"])
    assert state.w.device.type == "cpu" and state.t == 10
    assert torch.isfinite(state.w).all()


def test_wrappers_take_plain_versions_on_cpu():
    kernels.reset_launches()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 3, 42)).astype(np.float32))
    vals, idx = block_topk(x, 4)
    words, scale, _ = quantize_ef_pack(x, x, 8)
    unpack_mma(words, scale[..., 0], torch.ones(2), 8, 42)
    scatter_agg(vals, idx.to(torch.int16).view(torch.uint16), torch.ones(2),
                42)
    segment_rows(x[0], torch.tensor([2, 0, 5]), 4)
    quantize_ef(x[0], x[1], 8)
    switch_blend(x[0, 0], x[1, 0], torch.tensor(0.5))
    assert kernels.launch_counts() == {name: 0 for name in kernels.WRAPPERS}


def _run_cmdp(device):
    from repro_torch.examples import cmdp_cartpole
    out = cmdp_cartpole.main(rounds=2, horizon=20, chunk=1, pool=4,
                             device=device)
    assert [r["round"] for r in out] == [1, 2]
    return out


def _run_fair(device):
    from repro_torch.examples import fair_classification
    out = fair_classification.main(T=2, device=device)
    assert [r["alpha"] for r in out["fedsgm"]] == [10.0, 0.5]
    assert [r["rho"] for r in out["penalty"]] == [0.1, 1.0, 10.0]
    return out["fedsgm"] + out["penalty"]


def _run_lm(device):
    from repro_torch.examples import train_lm_federated
    out = train_lm_federated.main(rounds=2, preset="tiny", seq=16, b=2,
                                  device=device)
    return [{"f": v} for v in out["f"]]


@pytest.mark.parametrize("run", [_run_cmdp, _run_fair, _run_lm],
                         ids=["cmdp_cartpole", "fair_classification",
                              "train_lm_federated"])
def test_examples_need_a_card_unless_asked_for_cpu(no_card, run):
    """Each ported example raises without a card, and runs on the CPU when
    asked (2 rounds, small sizes), printing finite values."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run("cuda")
    for rec in run("cpu"):
        assert all(np.isfinite(v) for k, v in rec.items()
                   if isinstance(v, float))
