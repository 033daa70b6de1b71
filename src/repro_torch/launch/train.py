"""Training launcher: FedSGM rounds of the LM task on one device (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --uplink topk --rounds 20                 # the dense wire (default)
    PYTHONPATH=src python -m repro_torch.launch.train --comm packed \\
        --uplink quant                            # packed payloads
    # partial participation: 4 of 8 clients, local steps over the 4 only
    PYTHONPATH=src python -m repro_torch.launch.train --clients 8 \\
        --participating 4 --participation gather --comm pallas --uplink topk
    # a client fleet: 8 pooled sequences per client, minibatches of --batch
    # drawn afresh each round, clients sampled by availability
    PYTHONPATH=src python -m repro_torch.launch.train --fleet \\
        --sampler markov --clients 8 --participating 4 --participation gather
    # asynchronous buffered rounds with the telemetry bus, one JSON line a
    # round, a profiler trace of rounds 10-19
    PYTHONPATH=src python -m repro_torch.launch.train --fleet \\
        --async-buffer --sampler markov --staleness constraint --obs \\
        --sink jsonl --sink-path metrics.jsonl --profile 10:20 --rounds 30
    # 32 clients, 4 a round, their residuals in an 8-slot store, the eval
    # on the 4 and no delta_norm (its [32, d] scatter would not fit on an
    # 80 GB card); round checkpoints under ckpt/ (a rerun resumes from the
    # newest)
    PYTHONPATH=src python -m repro_torch.launch.train --clients 32 \
        --participating 4 --participation gather --comm pallas --ef-slots 8 \
        --sparse-eval --lean-metrics --ckpt-dir ckpt --rounds 10
    # two-tier aggregation over 2 cohorts of 4 clients
    PYTHONPATH=src python -m repro_torch.launch.train --clients 8 \
        --participating 4 --participation gather --comm pallas \
        --uplink quant --cohorts 2
    # the other token-only families: qwen3-4b, minitron-4b, gemma3-4b
    # (dense, qk-norm, 5:1 local:global), mamba2-130m (ssm),
    # recurrentgemma-2b (hybrid); --reduced for the smoke variants
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --clients 8 --participating 4 --participation gather --comm pallas
    # the moe family (MLA, routed experts; deepseek-v3 with MTP), its
    # constraint g the router's load imbalance minus the budget 6
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch deepseek-v2-236b --reduced --device cpu --comm pallas
    # the vlm and audio families (cross-attention layers over media tokens,
    # the whisper encoder-decoder over audio frames): each round's batch
    # carries stub media embeddings drawn with its tokens
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch llama-3.2-vision-90b --reduced --device cpu --comm pallas
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch whisper-small --reduced --device cpu --comm pallas
    # cross-process federation (repro_torch.wire): 2 worker processes over
    # loopback TCP, each owning 2 of the 4 clients, on the reduced LM task
    PYTHONPATH=src python -m repro_torch.launch.train --wire 2 \\
        --clients 4 --participating 2 --comm pallas --uplink topk \\
        --rounds 3 --device cpu

Runs the FULL config on ``cuda`` by default (``--reduced`` for the smoke
variant, ``--device cpu`` for the CPU with the kernels' plain versions).
Rounds run in chunks of 10, as the reference's launcher does, so ``--rounds``
below 10 still runs one chunk of 10.  Without ``--fleet`` each round gets
fresh host batches; with it, each client holds a pool of ``--fleet-pool``
sequences and the rounds provision ``--batch`` of them per client, drawn
afresh every round (``lm.make_fleet``); the vlm and audio archs refuse
``--fleet``, as the reference's launcher does (a fleet pools tokens only),
and draw their media (``normal * 0.02``, ``[n, B, n_media_tokens or
n_audio_frames, d_media or d]``) with each round's tokens.
``--async-buffer`` runs the rounds through ``engine.async_rounds`` (the
buffer carried across chunks); every
round is reported through the ``--sink`` (``repro_torch.obs.sinks``), with
the ``buffered=... merged=...`` counters on async rounds.  ``--ef-slots``
keeps the uplink residuals in a slot store of that capacity
(``repro_torch.scale.slots``; gather mode), ``--cohorts`` makes the uplink's
reduce two-tier, ``--client-chunk`` is accepted for the reference's
command lines (the clients run one after another whatever its value).
``--sparse-eval`` and ``--lean-metrics`` (``FedConfig.full_eval=False``,
``lean_metrics=True``) keep a round's memory in m rather than n: at full
width the ``delta_norm`` metric's ``[n, d]`` gather-mode scatter is 46 GB
at n = 32.
With ``--ckpt-dir`` the run restores the newest round checkpoint there at
start and saves one after every chunk of 10 rounds (``repro_torch.
checkpoint``), with the fleet sidecar under ``--fleet`` and the staleness
buffer's under ``--async-buffer``.  Like the
reference's launcher it keeps the identity downlink; the compressed
downlink is reached through the engine API (``rounds.init_state`` /
``run_rounds`` with a ``FedConfig``).

``--wire K`` runs the rounds over K worker processes instead
(``repro_torch.wire.coordinator.wire_drive``), as the reference's
launcher does: on the reduced LM problem (``wire.bootstrap``'s ``lm``,
whatever ``--reduced`` says), ``--rounds`` rounds (no chunks of 10), on
the pinned config surface (gather participation, the full eval, lean
metrics), so the single-process engine on the same problem and config is
its bit-exact oracle.  ``--fleet``, ``--async-buffer``, ``--obs`` and
``--ef-slots`` are not drivable over the wire and end the run with
``SystemExit``.  ``--wire-heartbeat`` arms the fault-tolerant runtime
(``--min-quorum``, ``--max-respawns``); each round's wire counters reach
the ``--sink``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import checkpoint, configs, resolve_device
from repro_torch.comm import flat
from repro_torch.configs.base import (AsyncConfig, CompressorConfig,
                                      FedConfig, FleetConfig, ObsConfig,
                                      ScaleConfig, SwitchConfig)
from repro_torch.data import synthetic
from repro_torch.engine import async_rounds, rounds
from repro_torch.launch import mesh
from repro_torch.models import build
from repro_torch.obs import log as obs_log
from repro_torch.obs import sinks as obs_sinks
from repro_torch.obs import trace as obs_trace
from repro_torch.sharding import partition
from repro_torch.tasks import lm

# (attribute, flag) of the reference's flags whose paths the port does not
# run: none left
_NOT_PORTED = ()


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    help="a config of repro_torch.configs.ALIASES (the vlm "
                         "and audio archs refuse --fleet)")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced smoke-test config")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--participating", type=int, default=0)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2, help="per-client batch")
    ap.add_argument("--lr", type=float, default=0.03)
    ap.add_argument("--uplink", default="topk",
                    choices=["none", "topk", "quant"])
    ap.add_argument("--ratio", type=float, default=0.1)
    ap.add_argument("--comm", default="dense",
                    choices=["dense", "packed", "pallas"])
    ap.add_argument("--switch", default="soft", choices=["hard", "soft"])
    ap.add_argument("--strategy", default="fedsgm")
    ap.add_argument("--participation", default="mask",
                    choices=["mask", "gather"])
    ap.add_argument("--client-chunk", type=int, default=0,
                    help="the reference's chunked client vmap; the clients "
                         "run one after another here, so every value gives "
                         "the same rounds")
    ap.add_argument("--fleet", action="store_true",
                    help="client fleet: per-client sequence pools, --batch "
                         "of them provisioned per client and round")
    ap.add_argument("--fleet-pool", type=int, default=8,
                    help="token sequences held per client (--fleet)")
    ap.add_argument("--sampler", default="uniform",
                    choices=["uniform", "weighted", "markov"],
                    help="client-sampling law (fleet.samplers)")
    ap.add_argument("--async-buffer", action="store_true",
                    help="asynchronous buffered rounds (engine.async_rounds)"
                         ": clients lost mid-round park their compressed "
                         "uplink in a staleness buffer and merge into a "
                         "later server update")
    ap.add_argument("--staleness", default="constant",
                    choices=["constant", "poly", "constraint"],
                    help="staleness-decay law for buffered uplinks")
    ap.add_argument("--max-staleness", type=int, default=4,
                    help="a buffered uplink may merge up to this age "
                         "(rounds); entries that reach it undelivered "
                         "expire")
    ap.add_argument("--depart", type=float, default=0.25,
                    help="mid-round departure probability for samplers "
                         "without an availability model (markov uses its "
                         "own chain)")
    ap.add_argument("--ef-slots", type=int, default=0,
                    help="capacity of the [cap, d] uplink EF slot store "
                         "(repro_torch.scale.slots) in place of the dense "
                         "[n, d] residual; needs --participation gather "
                         "and cap >= m.  0 keeps the dense residual")
    ap.add_argument("--cohorts", type=int, default=1,
                    help="two-tier payload aggregation: this many edge "
                         "reducers each reduce their cohort's payloads, "
                         "the server sums the partials")
    ap.add_argument("--lean-metrics", action="store_true",
                    help="leave the round's delta_norm metric out (0): in "
                         "gather mode its aggregate scatters the m deltas "
                         "into an [n, d] stack, 4*n*d bytes, which bounds "
                         "n at full width before the residual does")
    ap.add_argument("--sparse-eval", action="store_true",
                    help="evaluate f and g on the m sampled clients' rows, "
                         "fused with their first local step "
                         "(FedConfig.full_eval=False); by default every "
                         "client runs an eval forward")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore the newest round checkpoint here at "
                         "start, save one after every 10 rounds")
    ap.add_argument("--obs", action="store_true",
                    help="telemetry bus (repro_torch.obs): per-round "
                         "optimizer-health counters ride the metrics; off "
                         "is the plain engine, bit for bit")
    ap.add_argument("--obs-window", type=int, default=8,
                    help="trailing window (rounds) for the switching "
                         "fraction telemetry")
    ap.add_argument("--sink", default="stdout",
                    choices=list(obs_sinks.sink_names()),
                    help="per-round metric destination "
                         "(repro_torch.obs.sinks registry)")
    ap.add_argument("--sink-path", default="metrics.jsonl",
                    help="output file for --sink jsonl")
    ap.add_argument("--log-level", default="info",
                    choices=list(obs_log.LEVELS),
                    help="launcher log threshold (repro_torch.obs.log)")
    ap.add_argument("--quiet", action="store_true",
                    help="shorthand for --log-level warning (silences the "
                         "stdout sink's progress lines too)")
    ap.add_argument("--profile", default=None, metavar="START:STOP",
                    help="capture a torch.profiler trace while START <= "
                         "round < STOP (a Chrome/Perfetto JSON under "
                         "profiles/)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="activate the production (2, 16, 16) mesh "
                         "(launch.mesh; needs 512 CUDA devices)")
    ap.add_argument("--wire", type=int, default=0, metavar="K",
                    help="cross-process federation (repro_torch.wire): "
                         "spawn K worker processes over loopback TCP, each "
                         "owning a contiguous client range, on the reduced "
                         "LM problem; the coordinator drives the pinned "
                         "parity surface (gather participation, full eval, "
                         "lean metrics).  Per-round wire counters (frames, "
                         "bytes, frame latency, faults) reach --sink")
    ap.add_argument("--wire-deadline", type=float, default=120.0,
                    help="per-collection deadline (seconds) before a "
                         "missing worker frame is treated as dead or "
                         "droppable")
    ap.add_argument("--wire-heartbeat", type=float, default=0.0,
                    metavar="S",
                    help="arm the fault-tolerant wire runtime "
                         "(repro_torch.wire.supervisor): workers heartbeat "
                         "every S seconds, silence past 3*S declares a "
                         "worker dead; dead workers respawn with EF re-seed "
                         "and round replay, unrecoverable ones degrade the "
                         "round (sampled clients demoted, HT weights "
                         "rescaled mass-conservingly)")
    ap.add_argument("--min-quorum", type=float, default=0.5,
                    help="abort a degraded round when fewer than this "
                         "fraction of the m sampled clients are realized "
                         "(with --wire-heartbeat)")
    ap.add_argument("--max-respawns", type=int, default=2,
                    help="per-worker respawn budget of the wire supervisor "
                         "(with --wire-heartbeat)")
    return ap


def setup(args, cfg=None):
    """Everything a run needs, from parsed arguments: ``(state, batches,
    loss_pair, fed, cfg, device)``; ``batches`` is the per-round batch
    function, or under ``--fleet`` the :class:`repro_torch.fleet.Fleet`.
    ``cfg``, when given, takes the place of the config ``--arch`` names
    (the engine API's way to cut a model's depth: the launcher, like the
    reference's, has no depth flag).  Raises for the reference's paths
    that the port does not run (:data:`_NOT_PORTED`)."""
    for attr, flag in _NOT_PORTED:
        if getattr(args, attr):
            raise NotImplementedError(f"{flag} is not ported yet")
    if cfg is None:
        cfg = configs.get_reduced(args.arch) if args.reduced \
            else configs.get_config(args.arch)
    if args.multi_pod:
        partition.activate_mesh(mesh.make_production_mesh(multi_pod=True))
    media = cfg.family in ("vlm", "audio")
    if args.fleet and media:
        raise SystemExit(
            f"--fleet does not support --arch {args.arch}: lm.make_fleet "
            f"pools tokens only, and the {cfg.family} family needs media "
            "embeddings per client.  Drop --fleet (each round then draws "
            "its media with its tokens) or pick a token-only arch.")
    fns = build(cfg)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = fns.init(gen, cfg, device=dev)
    n = args.clients
    fed = FedConfig(
        n_clients=n, m=args.participating or n, local_steps=args.local_steps,
        lr=args.lr, switch=SwitchConfig(mode=args.switch, eps=0.0, beta=2.0),
        uplink=CompressorConfig(kind=args.uplink, ratio=args.ratio),
        downlink=CompressorConfig(kind="none"), comm=args.comm,
        strategy=args.strategy, participation=args.participation,
        full_eval=not args.sparse_eval, lean_metrics=args.lean_metrics,
        client_chunk=args.client_chunk,
        fleet=FleetConfig(sampler=args.sampler, batch_size=args.batch,
                          redraw=True) if args.fleet else FleetConfig(
                              sampler=args.sampler),
        async_=AsyncConfig(enabled=args.async_buffer,
                           staleness=args.staleness,
                           max_staleness=args.max_staleness,
                           depart=args.depart),
        scale=ScaleConfig(ef_slots=args.ef_slots, cohorts=args.cohorts),
        obs=ObsConfig(enabled=args.obs, window=args.obs_window))
    # MoE models take the router's load imbalance as the constraint g
    loss_pair = lm.make_loss_pair(fns.forward, cfg, budget=6.0,
                                  aux_constraint=cfg.moe is not None)
    # under a rank mesh with a model axis, the leaves the model's layers
    # split over it (none outside the dense family)
    plan = fns.tensor_plan(flat.spec_of(params))
    state = rounds.init_state(params, fed, device=dev, plan=plan)
    del params                  # the state's flat buffer is the model now
    if args.fleet:
        fleet = lm.make_fleet(torch.Generator().manual_seed(1),
                              fed, pool=args.fleet_pool, seq_len=args.seq,
                              vocab=cfg.vocab, hetero=0.5, device=dev)
        return state, fleet, loss_pair, fed, cfg, dev

    def batch_fn(t, g):
        toks, mask = synthetic.client_token_batches(
            g, n, args.batch, args.seq, cfg.vocab, hetero=0.5, device=dev)
        frames = None
        if media:               # the stub frontends' embeddings
            M = cfg.n_media_tokens or cfg.n_audio_frames
            frames = (torch.randn((n, args.batch, M,
                                   cfg.d_media or cfg.d_model),
                                  generator=g) * 0.02).to(dev)
        return lm.LMBatch(tokens=toks, minority_mask=mask, media=frames)

    return state, batch_fn, loss_pair, fed, cfg, dev


def restore(args, state, fed, dev):
    """``--ckpt-dir``: the newest round checkpoint there (and its staleness
    buffer under ``--async-buffer``), else the fresh state.  Returns
    ``(state, buffer, round)``."""
    buf = async_rounds.init_buffer(state, fed)
    if not args.ckpt_dir:
        return state, buf, 0
    restored, t0 = checkpoint.restore_round(args.ckpt_dir, state)
    if restored is None:
        return state, buf, 0
    obs_log.log(f"restored checkpoint at round {t0}")
    wire = checkpoint.restore_buffer(
        args.ckpt_dir, t0, async_rounds.buffer_wire_struct(restored, fed),
        device=dev)
    if wire is not None:
        buf = async_rounds.buffer_from_wire(wire, restored, fed)
        obs_log.log(f"restored staleness buffer at round {t0}")
    return restored, buf, t0


def run_wire(args):
    """``--wire K``: the rounds over K worker processes
    (``repro_torch.wire.coordinator.wire_drive``) on the reduced LM
    problem, as the reference's launcher runs them; returns the final
    state.  The flags the wire cannot drive end the run with
    ``SystemExit``."""
    for on, name in ((args.fleet, "--fleet"),
                     (args.async_buffer, "--async-buffer"),
                     (args.obs, "--obs"), (args.ef_slots, "--ef-slots")):
        if on:
            raise SystemExit(
                f"--wire drives the pinned parity surface of "
                f"repro_torch.wire (coordinator.validate_wire_cfg): {name} "
                "is not drivable over the wire -- drop one of the two flags")
    from repro_torch.wire import coordinator as wire_coordinator
    from repro_torch.wire.supervisor import WireFaultConfig
    dev = resolve_device(args.device)
    cfg = configs.get_reduced(args.arch)
    n = args.clients
    fed = FedConfig(
        n_clients=n, m=args.participating or n,
        local_steps=args.local_steps, lr=args.lr,
        switch=SwitchConfig(mode=args.switch, eps=0.0, beta=2.0),
        uplink=CompressorConfig(kind=args.uplink, ratio=args.ratio),
        downlink=CompressorConfig(kind="none"), comm=args.comm,
        strategy=args.strategy, participation="gather", full_eval=True,
        lean_metrics=True, client_chunk=args.client_chunk,
        fleet=FleetConfig(sampler=args.sampler))
    sink = obs_sinks.get_sink(
        args.sink, **({"path": args.sink_path} if args.sink == "jsonl"
                      else {}))
    sink.open(meta={"arch": cfg.name, "rounds": args.rounds,
                    "comm": args.comm, "strategy": args.strategy,
                    "wire_workers": args.wire, "device": str(dev)})
    resume = bool(args.ckpt_dir
                  and checkpoint.latest_round(args.ckpt_dir) is not None)
    faults = None
    if args.wire_heartbeat > 0:
        faults = WireFaultConfig(heartbeat_s=args.wire_heartbeat,
                                 min_quorum=args.min_quorum,
                                 max_respawns=args.max_respawns)
    t0 = time.time()
    try:
        state, _mets, stats = wire_coordinator.wire_drive(
            fed, args.rounds, workers=args.wire, problem="lm",
            problem_args={"arch": args.arch, "n_clients": n,
                          "batch": args.batch, "seq": args.seq},
            sink=sink, deadline=args.wire_deadline, faults=faults,
            ckpt_dir=args.ckpt_dir, ckpt_every=10 if args.ckpt_dir else 0,
            resume=resume, device=dev,
            progress=lambda t, f, g, s: obs_log.log(
                f"wire round {t}: f={float(f):.4f} g_hat={float(g):.4f} "
                f"sigma={float(s):.2f}"))
    finally:
        sink.close()
    obs_log.log(
        f"wire run done: {args.rounds} rounds of {cfg.name} over "
        f"{args.wire} workers on {dev} in {time.time() - t0:.1f}s "
        f"({stats.totals['frames']} frames, {stats.totals['bytes']} bytes, "
        f"missing={stats.totals['missing']}, "
        f"rejected={stats.totals['rejected']}, "
        f"respawns={stats.totals['respawns']}, "
        f"degraded={stats.totals['degraded']})")
    return state


def main(argv=None):
    args = parser().parse_args(argv)
    obs_log.set_level("warning" if args.quiet else args.log_level)
    if args.wire:
        return run_wire(args)
    profile = obs_trace.ProfileWindow(args.profile)
    state, batches, loss_pair, fed, cfg, dev = setup(args)
    state, buf, start = restore(args, state, fed, dev)
    pool = f", fleet pool {args.fleet_pool}" if args.fleet else ""
    mode = (f", async buffer ({fed.async_.staleness} law, max staleness "
            f"{fed.async_.max_staleness})" if args.async_buffer else "")
    slots = (f", {fed.scale.ef_slots} residual slots"
             if fed.scale.ef_slots else "")
    obs_log.log(f"{cfg.name}: d={state.spec.d} params on {dev}, "
                f"{fed.m} of {fed.n_clients} clients ({fed.participation}, "
                f"{fed.fleet.sampler} sampler{pool}), "
                f"uplink {fed.uplink.kind} on comm={fed.comm}{mode}{slots}",
                flush=True)
    sink = obs_sinks.get_sink(
        args.sink, **({"path": args.sink_path} if args.sink == "jsonl"
                      else {}))
    sink.open(meta={"arch": cfg.name, "rounds": args.rounds,
                    "comm": args.comm, "strategy": args.strategy,
                    "participation": args.participation,
                    "async_buffer": args.async_buffer, "obs": args.obs,
                    "device": str(dev), "start_round": start})
    batch_fn = (lambda t, g: batches) if args.fleet else batches
    t0 = time.time()
    done = start
    try:
        for _ in range(max(args.rounds // 10, 1)):
            profile.tick(done)
            if args.async_buffer:
                state, buf, hist = async_rounds.async_run_rounds(
                    state, batch_fn, loss_pair, fed, T=10, device=dev,
                    buf=buf)
            else:
                state, hist = rounds.run_rounds(state, batch_fn, loss_pair,
                                                fed, T=10, device=dev)
            done += 10
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            for rec in obs_sinks.rows(
                    hist, start_round=done - 10,
                    s_per_round=(time.time() - t0) / (done - start)):
                sink.emit(rec)
            if args.ckpt_dir:
                checkpoint.save_round(
                    args.ckpt_dir, done, state,
                    metadata={"arch": cfg.name},
                    fleet=batches if args.fleet else None, cfg=fed)
                checkpoint.save_buffer(
                    args.ckpt_dir, done,
                    async_rounds.buffer_wire(buf, state, fed))
        profile.close()
    finally:
        sink.close()
    return state


if __name__ == "__main__":
    main()
