"""Worker supervision for the wire runtime: liveness, recovery, quorum
(port of ``repro.wire.supervisor``, plain Python).

The paper's partial-participation analysis is the reason a crashed worker
is NOT a run-killing error: FedSGM's bounds decouple optimization progress
from sampling noise, so a dead worker's clients are *forced
non-participants* -- demote them, recompute the round's Horvitz-Thompson
weights over the realized cohort (total HT mass conserved exactly), and
keep going.  This module holds the pieces the coordinator threads
together:

* :class:`WireFaultConfig` -- the fault-tolerance surface: heartbeat
  period/timeout, the participation quorum below which a round aborts,
  and the per-worker respawn budget.
* :class:`Supervisor` -- owns the spawn recipes (subprocess argv or
  thread factory) and the listener; respawns a dead worker with a bounded
  budget and hands the fresh connection back to the coordinator, which
  re-seeds the worker's EF residual rows (``EF_LOAD``) and replays the
  in-flight round's ``ACTIVATE``/``SIGMA``.
* :class:`ChaosProcess` -- process-level fault injection for the soak:
  SIGKILL / SIGSTOP a random live worker mid-phase, by seeded
  probability.  (Connection- and frame-level faults live in
  :mod:`repro_torch.wire.testing`; this one kills real processes.)

The degradation ladder (DESIGN.md §Wire fault tolerance):

1. liveness  -- heartbeats + socket EOF detect the death,
2. recovery  -- respawn within budget, re-seed EF, replay the round;
   a worker that rejoins before the eval deadline costs the round
   *nothing* (bit-identical to the no-fault trajectory),
3. degradation -- past the deadline its sampled clients are demoted and
   the realized cohort's weights are rescaled (mass-conserving),
4. abort     -- only when the realized cohort falls below
   ``min_quorum * m``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import signal
import socket
import subprocess
import threading
from typing import Callable, Optional

from repro_torch.wire import bootstrap


@dataclasses.dataclass(frozen=True)
class WireFaultConfig:
    """The wire runtime's fault-tolerance knobs.

    * ``heartbeat_s`` -- worker heartbeat period (seconds); 0 disables
      heartbeats, leaving socket EOF as the only death signal (a SIGKILLed
      process still closes its socket; a SIGSTOPped one does not -- only
      the heartbeat timeout catches a *wedged* worker).
    * ``heartbeat_timeout`` -- silence (no frame of any kind) after which
      a worker is declared dead; 0 derives ``3 * heartbeat_s``.
    * ``min_quorum`` -- abort the round (RuntimeError) when the realized
      cohort drops below ``ceil(min_quorum * m)`` participants.
    * ``max_respawns`` -- per-worker respawn budget; past it the worker
      stays dead and its clients are demoted every round.
    * ``eval_grace`` -- extra collection window (seconds) granted after a
      successful respawn, so the revived worker's replayed round can
      still make the eval barrier.
    * ``respawn_window`` -- how long a respawned worker gets to connect
      back before the respawn is abandoned (process spawn pays the full
      interpreter + jit warmup here).
    """

    heartbeat_s: float = 0.0
    heartbeat_timeout: float = 0.0
    min_quorum: float = 0.5
    max_respawns: int = 2
    eval_grace: float = 10.0
    respawn_window: float = 60.0

    def timeout(self) -> float:
        if self.heartbeat_timeout > 0:
            return self.heartbeat_timeout
        return 3.0 * self.heartbeat_s if self.heartbeat_s > 0 else 0.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "WireFaultConfig":
        return cls(**json.loads(text))


class Supervisor:
    """Respawn dead workers with a bounded per-worker budget.

    ``spawn_fn(worker_id, life) -> handle`` starts one worker life (a
    ``subprocess.Popen`` or a started ``threading.Thread``); ``life`` is 0
    for the initial spawn and increments per respawn, so thread recipes
    can vary the chaos seed per life.  The supervisor owns the listener
    for respawn accepts; the initial accept stays with ``wire_drive`` (it
    accepts all K workers in one retry loop)."""

    def __init__(self, listener: socket.socket, faults: WireFaultConfig,
                 workers: int, spawn_fn: Callable, stats=None):
        self.listener = listener
        self.faults = faults
        self.workers = workers
        self.spawn_fn = spawn_fn
        self.stats = stats
        self.handles: dict = {}
        self.lives = {i: 0 for i in range(workers)}
        self.kills: list = []           # [(round, phase, worker_id, signal)]
        self._lock = threading.Lock()

    # -- bookkeeping --------------------------------------------------------

    def register(self, worker_id: int, handle) -> None:
        """Record a worker's initial (life-0) handle."""
        self.handles[worker_id] = handle

    def handle_alive(self, worker_id: int) -> bool:
        h = self.handles.get(worker_id)
        if h is None:
            return False
        if isinstance(h, subprocess.Popen):
            return h.poll() is None
        return h.is_alive()

    def live_workers(self) -> list:
        return [i for i in range(self.workers) if self.handle_alive(i)]

    # -- process-level signals (ChaosProcess, stuck-worker cleanup) ---------

    def kill(self, worker_id: int, sig: int = signal.SIGKILL) -> bool:
        """Signal a worker *process* (no-op False for threads/dead)."""
        h = self.handles.get(worker_id)
        if not isinstance(h, subprocess.Popen) or h.poll() is not None:
            return False
        try:
            os.kill(h.pid, sig)
        except (OSError, ProcessLookupError):
            return False
        return True

    def _reap_handle(self, worker_id: int) -> None:
        h = self.handles.get(worker_id)
        if isinstance(h, subprocess.Popen) and h.poll() is None:
            # SIGSTOPped or wedged: clear it out before the fresh spawn
            h.kill()
            h.wait()

    # -- the respawn path ---------------------------------------------------

    def respawn(self, worker_id: int) -> Optional[socket.socket]:
        """One bounded respawn attempt: kill whatever is left of the old
        life, start a fresh one, and accept its connection.  Returns the
        new socket, or None when the budget is spent or the fresh worker
        never connected (the handle is then reaped, so a half-spawn never
        leaks)."""
        with self._lock:
            if self.lives[worker_id] >= self.faults.max_respawns:
                return None
            self.lives[worker_id] += 1
            life = self.lives[worker_id]
        self._reap_handle(worker_id)
        handle = self.spawn_fn(worker_id, life)
        self.handles[worker_id] = handle
        try:
            socks, _waits = bootstrap.accept_with_retry(
                self.listener, 1, self.faults.respawn_window)
        except socket.timeout:
            self._reap_handle(worker_id)
            return None
        if self.stats is not None:
            self.stats.totals["respawns"] += 1
        return socks[0]

    def shutdown(self) -> None:
        for i in range(self.workers):
            self._reap_handle(i)


class ChaosProcess:
    """Kill real worker processes mid-phase, by seeded probability.

    ``spec`` keys:

    * ``kill`` -- per-phase-entry probability of SIGKILLing one random
      live worker (abrupt death: socket closes, state lost),
    * ``stop`` -- probability of SIGSTOP instead (a *wedged* worker: the
      socket stays open and silent, so only the heartbeat timeout can
      declare it dead; the supervisor SIGKILLs it at respawn),
    * ``phase`` -- ``"eval"`` / ``"uplink"`` / ``"any"``: which phase
      entries draw a fault (default ``"any"``),
    * ``max_kills`` -- optional total fault budget.

    Deterministic in ``seed``.  Process spawn only -- thread-mode death is
    injected worker-side via the ``die_*`` chaos keys of
    :mod:`repro_torch.wire.testing`."""

    def __init__(self, spec: dict, seed: int = 0):
        self.spec = dict(spec or {})
        self.rng = random.Random(seed)
        self.supervisor: Optional[Supervisor] = None
        self.kills: list = []

    def bind(self, supervisor: Supervisor) -> None:
        self.supervisor = supervisor

    def on_phase(self, phase: str, round_t: int) -> None:
        """The coordinator's phase hook: maybe kill one live worker."""
        sup = self.supervisor
        if sup is None:
            return
        want = self.spec.get("phase", "any")
        if want != "any" and phase != want:
            return
        budget = self.spec.get("max_kills")
        if budget is not None and len(self.kills) >= int(budget):
            return
        u = self.rng.random()
        p_kill = float(self.spec.get("kill", 0.0))
        p_stop = float(self.spec.get("stop", 0.0))
        if u >= p_kill + p_stop:
            return
        live = sup.live_workers()
        if not live:
            return
        victim = live[self.rng.randrange(len(live))]
        sig = signal.SIGKILL if u < p_kill else signal.SIGSTOP
        if sup.kill(victim, sig):
            self.kills.append((round_t, phase, victim,
                               signal.Signals(sig).name))
            sup.kills.append((round_t, phase, victim,
                              signal.Signals(sig).name))
