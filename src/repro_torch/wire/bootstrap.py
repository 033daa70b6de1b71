"""Deterministic problem bootstrap for wire worker processes (port of
``repro.wire.bootstrap``).

A worker process starts with nothing but its CLI arguments, yet must hold
the same per-client batches and loss function as the coordinator, bit for
bit -- cross-process parity means something only if both sides build the
same problem from the same seeds.  This module is that shared recipe: a
registry of named problem builders (each a pure function of its JSON-able
``args`` and the device), plus the :class:`FedConfig` <-> JSON round-trip
the coordinator uses to ship the federation config to workers.

    >>> params, batches, loss_pair = build_problem(
    ...     "np", {"seed": 0, "n_clients": 8}, device="cpu")

Builders return ``(params, batches, loss_pair)`` with ``batches`` stacked
over the ``[n_clients]`` leading axis -- a worker then slices its own
client rows, the coordinator keeps only ``params``.  Every draw comes from
a CPU ``torch.Generator`` seeded from ``args["seed"]`` and then moves to
the device, so every process (and the card and the CPU) builds the same
world.
"""
from __future__ import annotations

import dataclasses
import json
import random
import socket
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (AsyncConfig, CompressorConfig,
                                      FedConfig, FleetConfig, ObsConfig,
                                      ScaleConfig, SwitchConfig)

_PROBLEMS: Dict[str, Callable] = {}


def problem(name: str):
    """Register a named problem builder: ``fn(args: dict, device) ->
    (params, batches, loss_pair)``, deterministic in ``args``, its tensors
    on ``device``."""
    def deco(fn):
        _PROBLEMS[name] = fn
        return fn
    return deco


def problem_names():
    return sorted(_PROBLEMS)


def build_problem(name: str, args: dict, device="cuda"):
    """Build ``(params, batches, loss_pair)`` for a registered problem on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""
    if name not in _PROBLEMS:
        raise KeyError(f"unknown wire problem {name!r} "
                       f"(registered: {problem_names()})")
    return _PROBLEMS[name](dict(args or {}), resolve_device(device))


def tree_to(tree, device):
    """A nested dict / list of tensors moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


@problem("np")
def _np_problem(args: dict, device):
    """Neyman-Pearson classification on the synthetic breast-cancer-like
    task (repro_torch.tasks.np_classification) -- the standard small test
    problem.  args: seed (default 0), n_clients (default 8), hetero."""
    from repro_torch.tasks import np_classification as npc
    seed = int(args.get("seed", 0))
    n = int(args.get("n_clients", 8))
    hetero = bool(args.get("hetero", False))
    batches, _ = npc.make_dataset(torch.Generator().manual_seed(seed), n,
                                  hetero=hetero, device=device)
    params = npc.init_params(batches.x.shape[-1], device=device)
    return params, batches, npc.loss_pair


@problem("lm")
def _lm_problem(args: dict, device):
    """Reduced-config LM task (repro_torch.tasks.lm over a registered
    architecture): one fixed synthetic token batch per client.  args:
    arch (default smollm-360m), seed, n_clients, batch, seq.  The weights
    are drawn from a CPU generator seeded ``seed``, the tokens from one
    seeded ``seed + 1``."""
    from repro_torch import configs
    from repro_torch.data import synthetic
    from repro_torch.models import build
    from repro_torch.tasks import lm
    arch = args.get("arch", "smollm-360m")
    seed = int(args.get("seed", 0))
    n = int(args.get("n_clients", 4))
    batch = int(args.get("batch", 2))
    seq = int(args.get("seq", 32))
    cfg = configs.get_reduced(arch)
    fns = build(cfg)
    params = tree_to(fns.init(torch.Generator().manual_seed(seed), cfg,
                              device="cpu"), device)
    toks, mask = synthetic.client_token_batches(
        torch.Generator().manual_seed(seed + 1), n, batch, seq, cfg.vocab,
        hetero=0.5, device=device)
    batches = lm.LMBatch(tokens=toks, minority_mask=mask, media=None)
    loss_pair = lm.make_loss_pair(fns.forward, cfg, budget=6.0,
                                  aux_constraint=cfg.moe is not None)
    return params, batches, loss_pair


# ---------------------------------------------------------------------------
# Connect / accept with bounded retry (exponential backoff + jitter)
# ---------------------------------------------------------------------------
# The original spawn/connect was one-shot: a worker raced the coordinator's
# listen() (fine on loopback, fatal cross-host where the endpoint may come
# up seconds later) and the coordinator's accept loop gave every straggler
# the FULL deadline serially.  Both sides now retry on a deterministic
# exponential schedule with seeded jitter; the schedule actually slept is
# returned so the coordinator can surface it in the sink record.

def backoff_schedule(attempts: int, base: float = 0.1, cap: float = 2.0,
                     jitter: float = 0.25, seed: int = 0) -> list:
    """Delays (seconds) before retries 1..attempts-1: ``base * 2**k``
    capped at ``cap``, each scaled by a seeded uniform jitter in
    ``[1-jitter, 1+jitter]`` so a respawned fleet never reconnects in
    lockstep."""
    rng = random.Random(seed)
    out = []
    for k in range(max(0, attempts - 1)):
        d = min(base * (2.0 ** k), cap)
        out.append(d * (1.0 + jitter * (2.0 * rng.random() - 1.0)))
    return out


def connect_with_retry(host: str, port: int, attempts: int = 8,
                       base: float = 0.1, cap: float = 2.0,
                       jitter: float = 0.25, seed: int = 0
                       ) -> tuple[socket.socket, list]:
    """``socket.create_connection`` under :func:`backoff_schedule`.
    Returns ``(sock, delays_slept)``; raises the last ``OSError`` after the
    attempt budget is spent."""
    delays = backoff_schedule(attempts, base, cap, jitter, seed)
    slept: list = []
    last: Optional[Exception] = None
    for attempt in range(max(1, attempts)):
        try:
            sock = socket.create_connection((host, port))
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return sock, slept
        except OSError as e:
            last = e
            if attempt < len(delays):
                time.sleep(delays[attempt])
                slept.append(round(delays[attempt], 4))
    raise OSError(
        f"could not connect to {host}:{port} after {attempts} attempts "
        f"(backoff {[round(d, 3) for d in delays]}): {last}") from last


def accept_with_retry(listener: socket.socket, want: int, deadline: float,
                      liveness: Optional[Callable] = None,
                      poll: float = 0.2) -> tuple[list, list]:
    """Accept ``want`` connections within ``deadline`` seconds total,
    polling in short timeouts instead of granting each straggler the full
    deadline serially.  ``liveness()`` (optional) is polled between
    accepts and may raise to abort early (e.g. a spawned worker process
    already exited).  Returns ``(socks, waits)`` where ``waits`` records
    the per-connection seconds waited (the accept-side retry schedule for
    the sink record)."""
    socks, waits = [], []
    end = time.monotonic() + deadline
    t0 = time.monotonic()
    while len(socks) < want:
        remaining = end - time.monotonic()
        if remaining <= 0:
            raise socket.timeout(
                f"only {len(socks)}/{want} workers connected within "
                f"{deadline}s")
        listener.settimeout(min(poll, remaining))
        try:
            sock, _addr = listener.accept()
        except socket.timeout:
            if liveness is not None:
                liveness()
            continue
        socks.append(sock)
        waits.append(round(time.monotonic() - t0, 4))
        t0 = time.monotonic()
    return socks, waits


# ---------------------------------------------------------------------------
# FedConfig <-> JSON
# ---------------------------------------------------------------------------

_NESTED = {
    "switch": SwitchConfig, "uplink": CompressorConfig,
    "downlink": CompressorConfig, "fleet": FleetConfig,
    "async_": AsyncConfig, "scale": ScaleConfig, "obs": ObsConfig,
}


def fed_to_json(fed: FedConfig) -> str:
    """Serialize a FedConfig (nested frozen dataclasses) to JSON."""
    return json.dumps(dataclasses.asdict(fed), sort_keys=True)


def fed_from_json(text: str) -> FedConfig:
    """Inverse of :func:`fed_to_json`.  Unknown keys fail loudly -- a
    worker running a different repro version must not silently drop config
    knobs and then diverge from the oracle."""
    raw = json.loads(text)
    kw = {}
    for name, value in raw.items():
        if name in _NESTED:
            kw[name] = _NESTED[name](**value)
        else:
            kw[name] = value
    return FedConfig(**kw)
