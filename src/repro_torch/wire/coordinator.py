"""The wire coordinator: the server side of cross-process federation (port
of ``repro.wire.coordinator``).

One coordinator owns the :class:`repro_torch.engine.rounds.FedState` and
drives the round machinery of :mod:`repro_torch.engine.rounds` over K
worker processes (or threads), each holding a contiguous range of client
ids and speaking the frame protocol of :mod:`repro_torch.wire.frames` over
loopback TCP.

Per round t (two phases, because the switch weight sigma_t needs the GLOBAL
constraint eval before any client can start its local steps):

1. :func:`repro_torch.engine.rounds.sample_round` on the state's CPU
   generator (the draw ``drive`` makes), then one ``ACTIVATE`` frame per
   worker carrying the flat model, the worker's mask and weight rows and
   the round's uplink key leaf,
2. collect one ``EVAL`` frame per worker (a missing eval is a dead
   worker, not a droppable payload), aggregate the (f, g) rows and compute
   sigma_t once (:func:`switch_stage`) -- the same scalars feed the
   workers (the ``SIGMA`` frame) and the server update,
3. collect per-client ``UPLINK`` frames until every worker's
   ``ROUND_DONE`` (or the round deadline).  Frames are deduped by (client
   id, origin round); malformed frames (truncation, CRC) are rejected with
   a counter; a frame whose payload signature does not match this
   process's transport config fails loudly
   (:func:`repro_torch.engine.async_rounds.buffer_from_wire`); frames from
   an EARLIER round park in the host-side staleness buffer with their
   origin-round age (older than ``cfg.async_.max_staleness`` drops),
4. the decoded payload rows, scattered into the ``[n]``-stacked template
   (the layout in which the oracle's gather round reduces), go to the
   device; parked frames merge under the strategy's staleness law; and
   :func:`server_stage` ends in :func:`repro_torch.engine.rounds.
   finish_round` -- the oracle round's own tail on the flat ``[d]``
   buffer.

Parity contract: with no faults injected, the (state, metrics) trajectory
is bit-identical to the single-process ``rounds.drive`` under the pinned
config (gather participation, ``full_eval=True``, ``lean_metrics=True``,
async buffer off, dense EF residual, obs off; :func:`validate_wire_cfg`)
-- ``tests/test_torch_wire.py`` holds the line on the CPU, and
``chip_smoke.py`` on the card.

Checkpoint/restart: ``EF_REQ``/``EF_DUMP`` assemble the workers' residual
rows into the saved state; the parked-frame buffer saves beside it
(``checkpoint.save_buffer``) with its payload signature in the sidecar
metadata, and restore refuses a sidecar whose signature does not match
this process's transport.  On resume, ``EF_LOAD`` re-seeds each worker's
residual rows.  The dedup window -- every ``(client_id, origin_round)``
still within ``max_staleness`` of the checkpointed round -- persists in
the buffer sidecar metadata, so a frame merged before the restart cannot
re-park after it.

Fault tolerance (opt-in via a :class:`repro_torch.wire.supervisor.
WireFaultConfig`; without one, every failure is a hard error): worker
death is detected by socket EOF/reset and -- for *wedged* workers whose
socket stays open -- by heartbeat timeout; a dead worker is respawned
within a bounded budget, its EF residual rows re-seeded from the
coordinator's last collected snapshot (or the newest checkpoint), and the
in-flight round's ``ACTIVATE``/``SIGMA`` replayed -- a worker that rejoins
inside the grace window costs the round nothing.  Past the grace window
its sampled clients are DEMOTED: the round runs on the realized cohort
with the Horvitz-Thompson weights rescaled so the total HT mass is
conserved (``w_r = w * survivors * sum(w)/sum(w*survivors)``, float32; the
recorded realized (mask, weights) replayed through the ``fixed`` sampler
reproduces the degraded round bit for bit in the single-process oracle).
Below ``min_quorum * m`` realized participants the round aborts.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import selectors
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import checkpoint, resolve_device
from repro_torch.comm import flat
from repro_torch.configs.base import FedConfig
from repro_torch.core import theory
from repro_torch.engine import async_rounds, participation, rounds, strategies
from repro_torch.engine.async_rounds import StaleBuffer
from repro_torch.fleet.partitions import leaves_of, rebuild
from repro_torch.obs import log as obs_log
from repro_torch.sharding import partition
from repro_torch.wire import bootstrap, frames
from repro_torch.wire import worker as worker_mod
from repro_torch.wire.supervisor import ChaosProcess, Supervisor, WireFaultConfig


def validate_wire_cfg(cfg: FedConfig) -> None:
    """The wire drive's pinned config surface.  Everything here is a parity
    precondition: each knob below would make the coordinator's staged round
    diverge from (or crash against) the single-process oracle it must
    reproduce bit for bit."""
    bad = []
    if cfg.participation != "gather":
        bad.append("participation must be 'gather' (workers compute only "
                   "their sampled rows; the mask-mode oracle runs local "
                   "steps on all n rows)")
    if not cfg.full_eval:
        bad.append("full_eval must be True (the sigma phase needs the "
                   "global eval; full_eval=False takes the fused "
                   "eval/step-1 path the staged wire round cannot split)")
    if not cfg.lean_metrics:
        bad.append("lean_metrics must be True (the coordinator never holds "
                   "dense per-client deltas, so the delta_norm diagnostic "
                   "cannot be computed server-side)")
    if cfg.async_.enabled:
        bad.append("async_.enabled must be False (the wire has its own "
                   "staleness buffer, fed by genuinely late frames)")
    if cfg.scale.ef_slots:
        bad.append("scale.ef_slots must be 0 (EF residual rows live on the "
                   "workers; the slot store is a single-process layout)")
    if cfg.obs.enabled:
        bad.append("obs.enabled must be False (telemetry reduces over "
                   "buffers the coordinator does not hold; wire telemetry "
                   "flows through the sink records instead)")
    if bad:
        raise ValueError("config not drivable over the wire:\n  - "
                         + "\n  - ".join(bad))


@dataclasses.dataclass
class WireStats:
    """What the wire did, beyond the engine metrics: per-round records
    (also emitted to the sink) plus cumulative fault/traffic counters."""
    rounds: list = dataclasses.field(default_factory=list)
    totals: dict = dataclasses.field(default_factory=lambda: {
        "frames": 0, "bytes": 0, "dup": 0, "rejected": 0, "parked": 0,
        "merged_stale": 0, "dropped_stale": 0, "missing": 0,
        "heartbeats": 0, "recovered": 0, "respawns": 0, "degraded": 0,
        "demoted": 0, "dropped_demoted": 0})
    latencies_s: list = dataclasses.field(default_factory=list)
    merge_ages: list = dataclasses.field(default_factory=list)
    drop_ages: list = dataclasses.field(default_factory=list)
    workers: list = dataclasses.field(default_factory=list)
    recovery_s: list = dataclasses.field(default_factory=list)
    accept_waits: list = dataclasses.field(default_factory=list)
    # round -> {"mask", "weights", "demoted"}: the realized cohort actually
    # driven (recorded whenever faults are enabled), in the exact float32
    # bits the server step consumed -- replaying it through the ``fixed``
    # sampler IS the degraded-round parity oracle
    realized: dict = dataclasses.field(default_factory=dict)
    # frame kind name -> [frames, bytes] received and sent by the
    # coordinator (the length prefix counted)
    by_kind: dict = dataclasses.field(default_factory=dict)
    # host seconds the coordinator spent in socket recv calls
    recv_s: float = 0.0

    def count(self, kind: int, nbytes: int) -> None:
        ent = self.by_kind.setdefault(frames.KIND_NAMES.get(kind, hex(kind)),
                                      [0, 0])
        ent[0] += 1
        ent[1] += nbytes


def _zeros(struct):
    """Host numpy zeros with the shapes and dtypes of a ``meta`` tensor or
    payload of them (``async_rounds.wire_msg_struct``)."""
    if isinstance(struct, torch.Tensor):
        return np.zeros(tuple(struct.shape), frames.NP_DTYPES[struct.dtype])
    return type(struct)(*(_zeros(x) for x in struct))


def _leaves(payload):
    return [payload] if isinstance(payload, (torch.Tensor, np.ndarray)) \
        else list(payload)


def _to_device(payload, device):
    """Host numpy payload (a tensor's or a payload NamedTuple's leaves) ->
    tensors on ``device``."""
    if isinstance(payload, np.ndarray):
        return frames.to_tensor(payload, device)
    return type(payload)(*(frames.to_tensor(x, device) for x in payload))


class _Conn:
    """One worker connection: the socket, its incremental frame reader, and
    the client range the worker announced in HELLO."""

    def __init__(self, sock):
        self.sock = sock
        self.reader = frames.FrameReader()
        self.gids: Optional[np.ndarray] = None
        self.lo = self.hi = -1
        self.worker_id = -1
        self.closed = False
        self.dead = False               # declared dead by the fault layer
        self.got_eval = False
        self.done_round = -1
        self.ef_rows = None             # CPU tensor [hi - lo, d] (EF_DUMP)
        self.ef_epoch = -1
        self.last_seen = time.monotonic()
        self.death_ts = 0.0             # set at death, cleared on recovery


def switch_stage(part, f_ev, g_ev, strat, fed):
    """The round's scalar aggregates and switch weight, computed ONCE: the
    same bits go to the workers (sigma in the SIGMA frame) and into the
    server step.  ``part`` carries the realized cohort's weights.  Returns
    ``(f_part, g_hat, g_full, f_full, sigma)``."""
    aggs = rounds._eval_aggregates(part, f_ev, g_ev, False, fed.m)
    return (*aggs, strat.switch_weight(aggs[1], fed))


def server_stage(state, part, samp_state, msgs, w_fresh, aggs, sigma, strat,
                 fed, spec, uplink, downlink, stale_msgs=None, w_stale=None):
    """The oracle round's tail: the fresh payload-domain reduce of the
    ``[n]``-stacked messages (plus the staleness-buffer merge when parked
    frames deliver), then ``rounds.finish_round`` on the flat buffer.
    Returns ``(state, metrics)``; the state's ``e_up`` is None (the
    residual rows live on the workers)."""
    wf = state.w
    v_bar = uplink.reduce(msgs, w_fresh, fed.m)
    if stale_msgs is not None:
        v_bar = v_bar + uplink.reduce(stale_msgs, w_stale, fed.m)
    return rounds.finish_round(state, strat, fed, spec, wf, part, None,
                               v_bar, None, uplink, downlink, samp_state,
                               *aggs, sigma)


class Coordinator:
    """See the module docstring.  Construct with the model and config on
    ``device`` (``cuda`` unless the caller asks for the CPU), call
    :meth:`serve` with connected workers; :func:`wire_drive` wraps the
    listener + spawn + serve lifecycle."""

    def __init__(self, params, fed: FedConfig, *, deadline: float = 30.0,
                 sink=None, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 0, stats: Optional[WireStats] = None,
                 faults: Optional[WireFaultConfig] = None,
                 supervisor: Optional[Supervisor] = None,
                 on_phase: Optional[Callable] = None, device="cuda"):
        validate_wire_cfg(fed)
        self.device = resolve_device(device)
        self.params = params
        self.fed = fed
        self.deadline = float(deadline)
        self.sink = sink
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = int(ckpt_every)
        self.stats = stats if stats is not None else WireStats()
        self.faults = faults
        self.supervisor = supervisor
        self.on_phase = on_phase        # chaos hook: fn(phase, round_t)
        self.demoted: dict = {}         # round -> set of demoted client ids
        self.round_weights: dict = {}   # round -> realized [n] HT weights

        self.spec = flat.spec_of(params)
        self.strat = strategies.get_strategy(fed.strategy)
        self.strat.validate(fed)
        self.uplink, self.downlink = flat.flat_transports_for(fed, self.spec)
        self.row_sig = frames.row_signature(self.spec, fed)
        self.msg_struct = async_rounds.wire_msg_struct(self.spec, fed)

        state = rounds.init_state(params, fed, device=self.device)
        # EF residual rows live on the workers; the coordinator's state
        # carries None and re-assembles the [n, d] stack only at
        # checkpoint/finish time (EF_REQ/EF_DUMP)
        self.has_residual = state.e_up is not None
        self.state = state._replace(e_up=None)
        del state
        self.t = 0

        n = fed.n_clients
        self.buf_msgs = _zeros(self.msg_struct)
        self.buf_origin = np.zeros(n, np.int32)
        self.buf_sigma = np.zeros(n, np.float32)
        self.buf_weight = np.zeros(n, np.float32)
        self.buf_occupied = np.zeros(n, np.float32)
        self.seen: set = set()          # (client_id, origin_round) dedup
        self._sigma_ts: dict = {}       # round -> SIGMA send time
        self._ef_epoch = 0

        self.sel = selectors.DefaultSelector()
        self.conns: list = []
        self.metrics: list = []

    # -- connection setup ---------------------------------------------------

    def attach(self, socks: list) -> None:
        """Register connected worker sockets and collect their HELLOs;
        verifies the announced client ranges tile [0, n) exactly."""
        for sock in socks:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # blocking sockets + recv-after-select: reads never stall (we
            # only recv what select reported) and large ACTIVATE sendall
            # calls cannot fail with a partial write
            sock.settimeout(None)
            conn = _Conn(sock)
            self.sel.register(sock, selectors.EVENT_READ, conn)
            self.conns.append(conn)
        self._collect(lambda: all(c.gids is not None for c in self.conns),
                      what="worker HELLO")
        self.conns.sort(key=lambda c: c.lo)
        covered = np.concatenate([c.gids for c in self.conns])
        want = np.arange(self.fed.n_clients)
        if covered.shape != want.shape or not np.array_equal(covered, want):
            raise RuntimeError(
                f"worker client ranges {[(c.lo, c.hi) for c in self.conns]} "
                f"do not tile [0, {self.fed.n_clients}) -- every client id "
                "must be owned by exactly one worker")
        # spawn index i owns client_range(i), which is monotone in i, so
        # the lo-sorted order IS the supervisor's worker-id order
        for i, conn in enumerate(self.conns):
            conn.worker_id = i
            conn.last_seen = time.monotonic()

    # -- the fault layer ----------------------------------------------------

    def _phase(self, phase: str, t: int) -> None:
        """Phase-entry hook: the chaos injector (and anything else riding
        ``on_phase``) fires here, BEFORE the phase's frames go out."""
        if self.on_phase is not None:
            self.on_phase(phase, t)

    def _mark_dead(self, conn: _Conn, why: str) -> None:
        """Declare a worker dead: unregister + close its socket and stamp
        the death time (recovery latency measures from here)."""
        if conn.dead:
            return
        conn.dead = True
        conn.death_ts = time.monotonic()
        try:
            self.sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        obs_log.log(f"wire: worker {conn.worker_id} "
                    f"[{conn.lo},{conn.hi}) dead: {why}", level="warning")

    def _send(self, conn: _Conn, frame: bytes) -> bool:
        """Write one frame; with faults enabled a send failure marks the
        worker dead instead of crashing the coordinator."""
        if conn.dead or conn.closed:
            return False
        try:
            n = frames.write_frame(conn.sock, frame)
        except OSError as e:
            if self.faults is None:
                raise
            self._mark_dead(conn, f"send failed: {e!r}")
            return False
        self.stats.count(frame[3], n)
        return True

    def _ef_seed_rows(self, conn: _Conn):
        """The EF residual rows a respawned worker restarts from: the last
        collected snapshot (exact pre-round bits under ``ckpt_every=1``),
        else the newest checkpoint's, else zeros (EF self-heals: the drift
        is bounded by the compressor's residual error)."""
        if not self.has_residual:
            return None
        if conn.ef_rows is not None:
            return conn.ef_rows
        if self.ckpt_dir:
            like = rounds.init_state(self.params, self.fed,
                                     device=self.device)
            state, _t0 = checkpoint.restore_round(self.ckpt_dir, like)
            if state is not None and state.e_up is not None:
                return state.e_up[conn.lo:conn.hi]
        return torch.zeros((conn.hi - conn.lo, self.spec.d),
                           dtype=self.spec.dtype)

    def _revive(self, t: int, activate: dict,
                sigma_frame: Optional[bytes] = None,
                skip: frozenset = frozenset()) -> list:
        """Respawn every dead worker still within its budget, re-seed its
        EF rows, and replay the in-flight round's control frames (the
        replayed uplinks are byte-identical recomputations, absorbed by
        dedup).  ``skip`` holds worker ids already demoted this round --
        reviving them mid-round would change the realized cohort after
        sigma shipped; they rejoin at the next round's barrier."""
        if self.supervisor is None:
            return []
        revived = []
        for conn in self.conns:
            if not conn.dead or conn.worker_id in skip:
                continue
            sock = self.supervisor.respawn(conn.worker_id)
            if sock is None:
                continue
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(None)
            conn.sock = sock
            conn.reader = frames.FrameReader()
            conn.dead = False
            conn.closed = False
            conn.got_eval = False
            conn.last_seen = time.monotonic()
            self.sel.register(sock, selectors.EVENT_READ, conn)
            rows = self._ef_seed_rows(conn)
            if rows is not None:
                sig, body = frames.pack_payload(rows)
                self._send(conn, frames.encode_frame(
                    frames.K_EF_LOAD, body, origin_round=t, sig=sig))
            self._send(conn, activate[conn.worker_id])
            if sigma_frame is not None:
                self._send(conn, sigma_frame)
            revived.append(conn)
            obs_log.log(f"wire: worker {conn.worker_id} respawned "
                        f"(life {self.supervisor.lives[conn.worker_id]}), "
                        f"round {t} replayed", level="warning")
        return revived

    def _check_liveness(self) -> None:
        """Heartbeat-timeout sweep: a socket that is open but silent past
        the configured window is a wedged worker (SIGSTOP, infinite loop);
        EOF detection alone never catches it."""
        timeout = self.faults.timeout() if self.faults else 0.0
        if timeout <= 0:
            return
        now = time.monotonic()
        for conn in self.conns:
            if not (conn.dead or conn.closed) \
                    and now - conn.last_seen > timeout:
                self._mark_dead(
                    conn, f"heartbeat timeout ({timeout:.1f}s silent)")

    # -- the collection pump ------------------------------------------------

    def _collect(self, until: Callable[[], bool], *, what: str,
                 round_ctx: Optional[dict] = None,
                 hard: bool = True,
                 deadline: Optional[float] = None) -> bool:
        """Pump frames from all workers until ``until()`` or the deadline
        (``deadline`` overrides the coordinator default -- the post-revive
        grace window).  ``hard=True`` raises on timeout (control frames are
        mandatory); ``hard=False`` returns False (payload frames are
        droppable)."""
        end = time.monotonic() + (self.deadline if deadline is None
                                  else deadline)
        while not until():
            self._check_liveness()
            if all(c.closed or c.dead for c in self.conns):
                if hard:
                    closed = [(c.lo, c.hi) for c in self.conns]
                    raise RuntimeError(
                        f"all workers {closed} disconnected while the "
                        f"coordinator was still waiting for {what}")
                return False
            remaining = end - time.monotonic()
            if remaining <= 0:
                if hard:
                    raise RuntimeError(
                        f"wire deadline ({self.deadline}s) waiting for "
                        f"{what} -- a worker is dead or wedged")
                return False
            for key, _ in self.sel.select(timeout=min(remaining, 0.05)):
                conn = key.data
                t_recv = time.perf_counter()
                try:
                    data = conn.sock.recv(1 << 20)
                except BlockingIOError:       # spurious readiness
                    continue
                except OSError as e:
                    if self.faults is None:
                        raise
                    self._mark_dead(conn, f"recv failed: {e!r}")
                    continue
                finally:
                    self.stats.recv_s += time.perf_counter() - t_recv
                if not data:
                    # EOF: frames already buffered stay valid; whether the
                    # close is clean (post-FINISH) or a crash is decided by
                    # whoever is still waiting on this worker
                    conn.closed = True
                    self.sel.unregister(conn.sock)
                    if self.faults is not None:
                        conn.dead = True
                        if not conn.death_ts:
                            conn.death_ts = time.monotonic()
                    continue
                conn.last_seen = time.monotonic()
                conn.reader.feed(data)
                for raw in conn.reader.frames():
                    self._dispatch(conn, raw, round_ctx)
        return True

    def _dispatch(self, conn: _Conn, raw: bytes,
                  round_ctx: Optional[dict]) -> None:
        self.stats.totals["frames"] += 1
        self.stats.totals["bytes"] += len(raw) + 4      # + length prefix
        try:
            header, body = frames.decode_frame(raw)
        except frames.FrameError as e:
            self.stats.totals["rejected"] += 1
            if round_ctx is not None:
                round_ctx["rejected"] += 1
            obs_log.log(f"wire: rejecting frame: {e}", level="warning")
            return
        kind = header.kind
        self.stats.count(kind, len(raw) + 4)
        if kind == frames.K_HEARTBEAT:
            # liveness beacon: the ``last_seen`` stamp already happened at
            # recv time, so the frame itself is pure telemetry
            self.stats.totals["heartbeats"] += 1
            return
        if kind == frames.K_HELLO:
            gids = frames.to_numpy(frames.unpack_payload(header.sig, body))
            conn.gids = gids
            conn.lo, conn.hi = int(gids[0]), int(gids[-1]) + 1
        elif kind == frames.K_EVAL:
            if round_ctx is not None and header.origin_round == self.t:
                f_ev, g_ev = frames.unpack_payload(header.sig, body)
                round_ctx["f_ev"][conn.lo:conn.hi] = frames.to_numpy(f_ev)
                round_ctx["g_ev"][conn.lo:conn.hi] = frames.to_numpy(g_ev)
                conn.got_eval = True
                if conn.death_ts:
                    # a respawned life made the barrier: full recovery
                    self.stats.totals["recovered"] += 1
                    self.stats.recovery_s.append(
                        time.monotonic() - conn.death_ts)
                    conn.death_ts = 0.0
        elif kind == frames.K_UPLINK:
            self._on_uplink(header, body, round_ctx)
        elif kind == frames.K_ROUND_DONE:
            conn.done_round = max(conn.done_round, header.origin_round)
        elif kind == frames.K_EF_DUMP:
            conn.ef_rows = (frames.unpack_payload(header.sig, body)
                            if header.sig else None)
            conn.ef_epoch = self._ef_epoch
        else:
            raise frames.FrameError(
                "coordinator received unexpected "
                f"{frames.KIND_NAMES.get(kind, hex(kind))} frame "
                f"(client {header.client_id}, round {header.origin_round})")

    def _on_uplink(self, header, body: bytes,
                   round_ctx: Optional[dict]) -> None:
        if header.sig != self.row_sig:
            # thread the frame's signature through the shared validation
            # (raises ValueError naming both signatures and the knobs)
            async_rounds.buffer_from_wire(None, self.state, self.fed,
                                          sig=header.sig)
        payload = frames.unpack_payload(header.sig, body)
        cid, origin = header.client_id, header.origin_round
        if (cid, origin) in self.seen:
            self.stats.totals["dup"] += 1
            if round_ctx is not None:
                round_ctx["dup"] += 1
            return
        dem = self.demoted.get(origin)
        if dem and cid in dem:
            # the round already ran on a realized cohort excluding this
            # client; merging its late payload would double-count the mass
            # the rescale reassigned to the survivors
            self.stats.totals["dropped_demoted"] += 1
            return
        self.seen.add((cid, origin))
        sent = self._sigma_ts.get(origin)
        if sent is not None:
            self.stats.latencies_s.append(time.monotonic() - sent)
        if origin == self.t and round_ctx is not None:
            for stack, row in zip(_leaves(round_ctx["msgs"]),
                                  _leaves(payload)):
                stack[cid] = frames.to_numpy(row)
            round_ctx["received"][cid] = True
        elif origin < self.t:
            self._park(header, payload, round_ctx)
        else:
            raise frames.FrameError(
                f"uplink from client {cid} claims FUTURE round {origin} "
                f"(coordinator is at round {self.t}) -- protocol bug")

    def _park(self, header, payload, round_ctx: Optional[dict]) -> None:
        """A genuinely late frame: into the staleness buffer with its
        origin-round metadata, or dropped past ``max_staleness``."""
        cid, origin = header.client_id, header.origin_round
        age = self.t - origin
        if age > self.fed.async_.max_staleness:
            self.stats.totals["dropped_stale"] += 1
            self.stats.drop_ages.append(age)
            if round_ctx is not None:
                round_ctx["dropped_stale"] += 1
            return
        for stack, row in zip(_leaves(self.buf_msgs), _leaves(payload)):
            stack[cid] = frames.to_numpy(row)
        # a survivor frame from a degraded round parks with that round's
        # RESCALED weight (the frame header carries the pre-demotion one
        # the ACTIVATE shipped), so the staleness merge conserves the same
        # HT mass the realized round established
        rw = self.round_weights.get(origin)
        self.buf_origin[cid] = origin
        self.buf_sigma[cid] = header.sigma
        self.buf_weight[cid] = header.weight if rw is None \
            else float(rw[cid])
        self.buf_occupied[cid] = 1.0
        self.stats.totals["parked"] += 1
        if round_ctx is not None:
            round_ctx["parked"] += 1

    # -- one round ----------------------------------------------------------

    def _eval_barrier(self, t: int, ctx: dict, activate: dict) -> None:
        """Faults-enabled eval collection: soft deadline, then one revive
        pass (respawn + EF re-seed + ACTIVATE replay) with a grace window;
        a worker with no eval past that is dead for this round and its
        sampled clients get demoted."""
        def done():
            return all(c.got_eval or c.dead for c in self.conns)
        self._collect(done, what=f"round-{t} evals", round_ctx=ctx,
                      hard=False)
        for c in self.conns:
            if not c.got_eval and not c.dead:
                self._mark_dead(c, f"round-{t} eval deadline")
        if any(c.dead for c in self.conns):
            if self._revive(t, activate):
                self._collect(done, what=f"round-{t} evals (revived)",
                              round_ctx=ctx, hard=False,
                              deadline=self.faults.eval_grace)
            for c in self.conns:
                if not c.got_eval and not c.dead:
                    self._mark_dead(c, f"round-{t} eval grace expired")
        if all(c.dead for c in self.conns):
            raise RuntimeError(
                f"round {t}: every worker is dead and none could be "
                "respawned (budget spent or respawn_window exceeded)")

    def _demote_dead(self, mask: np.ndarray) -> set:
        """Sampled clients owned by workers that are (still) dead."""
        out: set = set()
        for c in self.conns:
            if not c.dead:
                continue
            for g in range(c.lo, c.hi):
                if mask[g] > 0:
                    out.add(g)
        return out

    def round(self) -> None:
        t = self.t
        state = self.state
        fed = self.fed
        dev = self.device
        # stage 1: the oracle's own draw on the state's CPU generator
        part, samp_state = rounds.sample_round(state, fed)
        mask = frames.to_numpy(part.mask)
        w_agg = frames.to_numpy(participation.agg_weights(part))
        wf = frames.to_numpy(state.w)
        # the reference's uplink key leaf (uint32[2]): here the seed and
        # the round the workers' WireKey(seed, t, UPLINK) is made of
        key_np = np.asarray([fed.seed & 0xFFFFFFFF, t & 0xFFFFFFFF],
                            np.uint32)

        ctx = {
            "f_ev": np.zeros(fed.n_clients, np.float32),
            "g_ev": np.zeros(fed.n_clients, np.float32),
            "msgs": _zeros(self.msg_struct),
            "received": np.zeros(fed.n_clients, bool),
            "dup": 0, "rejected": 0, "parked": 0, "dropped_stale": 0,
        }
        frames0 = self.stats.totals["frames"]
        bytes0 = self.stats.totals["bytes"]
        recv0 = self.stats.recv_s
        kinds0 = {k: list(v) for k, v in self.stats.by_kind.items()}
        recovered0 = self.stats.totals["recovered"]
        respawns0 = self.stats.totals["respawns"]

        self._phase("eval", t)
        activate = {}
        for conn in self.conns:
            conn.got_eval = False
            sig, body = frames.pack_payload(
                (wf, mask[conn.lo:conn.hi].astype(np.float32),
                 w_agg[conn.lo:conn.hi].astype(np.float32), key_np))
            fr = frames.encode_frame(frames.K_ACTIVATE, body,
                                     origin_round=t, sig=sig)
            del body
            activate[conn.worker_id] = fr
            self._send(conn, fr)
        del wf
        if self.faults is None:
            self._collect(lambda: all(c.got_eval for c in self.conns),
                          what=f"round-{t} evals", round_ctx=ctx)
        else:
            self._eval_barrier(t, ctx, activate)

        # demotion: workers still dead past the barrier force their
        # sampled clients out of the round; rescale the survivors' HT
        # weights so total mass is conserved exactly (float32 bits, the
        # same bits the fixed-sampler oracle replays)
        demoted = self._demote_dead(mask)
        mask_r, w_r = mask, w_agg
        if demoted:
            mask_r = mask.copy()
            mask_r[sorted(demoted)] = 0.0
            m_real = int((mask_r > 0).sum())
            need = max(1, math.ceil(self.faults.min_quorum * fed.m))
            if m_real < need:
                raise RuntimeError(
                    f"round {t} lost quorum: {m_real}/{fed.m} sampled "
                    f"clients realized after demoting {sorted(demoted)} "
                    f"(min_quorum {self.faults.min_quorum} needs {need})")
            surv = (mask_r > 0).astype(np.float32)
            w_surv = (w_agg * surv).astype(np.float32)
            scale = np.float32(w_agg.sum()) / np.float32(w_surv.sum())
            w_r = (w_surv * scale).astype(np.float32)
            part = participation.finalize(frames.to_tensor(mask_r),
                                          frames.to_tensor(w_r), fed, dev)
            self.demoted[t] = set(demoted)
            self.round_weights[t] = w_r
            self.stats.totals["degraded"] += 1
            self.stats.totals["demoted"] += len(demoted)
        if self.faults is not None:
            self.stats.realized[t] = {
                "mask": np.asarray(mask_r, np.float32).tolist(),
                "weights": np.asarray(w_r, np.float32).tolist(),
                "demoted": sorted(demoted)}

        *aggs, sigma = switch_stage(
            part, frames.to_tensor(ctx["f_ev"], dev),
            frames.to_tensor(ctx["g_ev"], dev), self.strat, fed)
        self._sigma_ts[t] = time.monotonic()
        self._phase("uplink", t)
        sigma_frame = frames.encode_frame(
            frames.K_SIGMA, origin_round=t, sigma=float(sigma))
        dead_eval = frozenset(c.worker_id for c in self.conns if c.dead)
        for conn in self.conns:
            self._send(conn, sigma_frame)

        def done_up():
            return all(c.done_round >= t or c.dead for c in self.conns)
        self._collect(done_up, what=f"round-{t} uplinks", round_ctx=ctx,
                      hard=False)
        if self.faults is not None and any(
                c.dead and c.worker_id not in dead_eval
                for c in self.conns):
            # mid-uplink death: one revive pass (EF re-seed + full round
            # replay; the recomputed frames are byte-identical, dedup
            # absorbs the resent half), then a grace window.  Whatever is
            # STILL missing takes the conservative zero-weight path below
            # -- sigma already shipped for this cohort, so a post-sigma
            # rescale would bias the update it was computed for.
            if self._revive(t, activate, sigma_frame, skip=dead_eval):
                self._collect(done_up, what=f"round-{t} uplinks (revived)",
                              round_ctx=ctx, hard=False,
                              deadline=self.faults.eval_grace)
        del activate

        sampled = mask_r > 0
        missing = int(np.sum(sampled & ~ctx["received"]))
        self.stats.totals["missing"] += missing
        # with every frame in, the oracle's own weight tensor feeds the
        # reduce
        w_fresh = participation.agg_weights(part)
        if missing:
            w_fresh = frames.to_tensor(
                (w_r * ctx["received"].astype(np.float32)).astype(
                    np.float32), dev)

        stale_msgs = w_stale = None
        merged = 0
        if self.buf_occupied.any():
            ages = (t - self.buf_origin).astype(np.float32)
            lam = self.strat.staleness_weight(
                frames.to_tensor(ages, dev),
                frames.to_tensor(self.buf_sigma, dev), aggs[1], fed)
            w_stale = frames.to_tensor(self.buf_weight, dev) * lam \
                * frames.to_tensor(self.buf_occupied, dev)
            stale_msgs = _to_device(self.buf_msgs, dev)
            merged = int(self.buf_occupied.sum())
            self.stats.totals["merged_stale"] += merged
            self.stats.merge_ages.extend(
                ages[self.buf_occupied > 0].tolist())
            self._clear_buffer()

        msgs = _to_device(ctx.pop("msgs"), dev)
        self.state, mets = server_stage(
            state, part, samp_state, msgs, w_fresh, aggs, sigma,
            self.strat, fed, self.spec, self.uplink, self.downlink,
            stale_msgs, w_stale)
        del msgs, stale_msgs
        self.metrics.append(mets)
        self.t = t + 1
        old = t - fed.async_.max_staleness - 1
        self._sigma_ts.pop(old, None)
        self.demoted.pop(old, None)
        self.round_weights.pop(old, None)

        lat = self.stats.latencies_s
        rec = {
            "round": t, "f": float(mets.f), "g_hat": float(mets.g_hat),
            "sigma": float(mets.sigma),
            "wire_frames": self.stats.totals["frames"] - frames0,
            "wire_bytes": self.stats.totals["bytes"] - bytes0,
            "wire_frame_ms": (1e3 * float(np.mean(lat[-fed.m:]))
                              if lat else 0.0),
            "wire_recv_ms": 1e3 * (self.stats.recv_s - recv0),
            # this round's [frames, bytes] by kind, both directions
            "wire_kinds": {k: [v[0] - kinds0.get(k, [0, 0])[0],
                               v[1] - kinds0.get(k, [0, 0])[1]]
                           for k, v in self.stats.by_kind.items()
                           if v != kinds0.get(k)},
            "wire_missing": missing, "wire_dup": ctx["dup"],
            "wire_rejected": ctx["rejected"], "wire_parked": ctx["parked"],
            "wire_merged_stale": merged,
            "wire_dropped_stale": ctx["dropped_stale"],
        }
        if self.faults is not None:
            rec.update({
                "wire_degraded": int(bool(demoted)),
                "wire_demoted": len(demoted),
                "wire_recovered":
                    self.stats.totals["recovered"] - recovered0,
                "wire_respawns": self.stats.totals["respawns"] - respawns0,
                # conserved by construction (pinned in tests): the realized
                # weights carry the full cohort's HT mass
                "wire_ht_mass": float(np.float32(np.asarray(w_r).sum())),
            })
            if demoted:
                # realized-design diagnostics through the theory hooks: the
                # thinned inclusion law (uniform over the survivors' pool)
                n_alive = sum(c.hi - c.lo for c in self.conns
                              if not c.dead)
                m_real = int((mask_r > 0).sum())
                if n_alive > 0:
                    pi = np.full(n_alive, m_real / n_alive)
                    q = np.full(n_alive, 1.0 / n_alive)
                    rec["wire_ht_variance"] = float(
                        theory.ht_variance(pi, q))
                    rec["wire_eff_ratio"] = float(
                        theory.effective_ratio(pi, q, max(m_real, 1)))
        self.stats.rounds.append(rec)
        if self.sink is not None:
            self.sink.emit(rec)

        if (self.ckpt_dir and self.ckpt_every
                and (t + 1) % self.ckpt_every == 0):
            self.save_checkpoint(t + 1)

    def _clear_buffer(self) -> None:
        for stack in _leaves(self.buf_msgs):
            stack[...] = 0
        self.buf_origin[...] = 0
        self.buf_sigma[...] = 0.0
        self.buf_weight[...] = 0.0
        self.buf_occupied[...] = 0.0

    def _host_buffer(self) -> StaleBuffer:
        """The parked-frame buffer as a :class:`StaleBuffer` of CPU
        tensors (the checkpoint sidecar's form)."""
        return StaleBuffer(msgs=_to_device(self.buf_msgs, None),
                           origin=frames.to_tensor(self.buf_origin),
                           sigma=frames.to_tensor(self.buf_sigma),
                           weight=frames.to_tensor(self.buf_weight),
                           occupied=frames.to_tensor(self.buf_occupied))

    # -- EF residual assembly / checkpointing -------------------------------

    def _assemble_ef(self):
        """The workers' last dumped residual rows as the ``[n, d]`` stack
        on the device (None when the uplink keeps no residual).  A dead
        worker's range keeps its last collected rows (drift bounded by the
        compressor's residual error; exact when the previous collect was
        this round's pre-round snapshot)."""
        if not self.has_residual:
            return None
        e_full = torch.zeros((self.fed.n_clients, self.spec.d),
                             dtype=self.spec.dtype, device=self.device)
        for conn in self.conns:
            if conn.ef_rows is not None:
                e_full[conn.lo:conn.hi] = conn.ef_rows.to(self.device)
        return e_full

    def collect_ef(self):
        """EF_REQ every worker; assemble their residual rows into the full
        ``[n, d]`` stack (None when the uplink keeps no residual)."""
        self._ef_epoch += 1
        for conn in self.conns:
            self._send(conn, frames.encode_frame(
                frames.K_EF_REQ, origin_round=self.t))
        self._collect(
            lambda: all(c.ef_epoch == self._ef_epoch or c.dead
                        for c in self.conns),
            what="EF residual dumps")
        return self._assemble_ef()

    def save_checkpoint(self, done_t: int) -> None:
        e_full = self.collect_ef()
        checkpoint.save_round(self.ckpt_dir, done_t,
                              self.state._replace(e_up=e_full),
                              metadata={"wire": True,
                                        "workers": len(self.conns)})
        # the dedup window rides in the sidecar: every (client, origin)
        # the staleness law could still accept after a restart
        window = sorted((int(c), int(o)) for c, o in self.seen
                        if done_t - o <= self.fed.async_.max_staleness)
        checkpoint.save_buffer(self.ckpt_dir, done_t, self._host_buffer(),
                               metadata={"payload_sig": self.row_sig,
                                         "seen": [list(p) for p in window]})

    def _buffer_struct(self) -> StaleBuffer:
        n = self.fed.n_clients

        def meta(dtype):
            return torch.empty((n,), dtype=dtype, device="meta")
        return StaleBuffer(msgs=self.msg_struct, origin=meta(torch.int32),
                           sigma=meta(torch.float32),
                           weight=meta(torch.float32),
                           occupied=meta(torch.float32))

    def resume(self) -> bool:
        """Restore the newest checkpoint: state + parked-frame buffer
        (signature-validated), then EF_LOAD each worker's residual rows.
        Returns True when a checkpoint was found."""
        like = rounds.init_state(self.params, self.fed, device=self.device)
        state, t0 = checkpoint.restore_round(self.ckpt_dir, like)
        del like
        if state is None:
            return False
        e_up, state = state.e_up, state._replace(e_up=None)
        self.state, self.t = state, int(t0)
        for conn in self.conns:
            if e_up is None:
                continue
            sig, body = frames.pack_payload(e_up[conn.lo:conn.hi])
            self._send(conn, frames.encode_frame(
                frames.K_EF_LOAD, body, origin_round=self.t, sig=sig))
        wire = checkpoint.restore_buffer(self.ckpt_dir, t0,
                                         self._buffer_struct(),
                                         device="cpu")
        if wire is not None:
            meta = checkpoint.read_metadata(
                os.path.join(self.ckpt_dir, f"round_{t0}_buffer"))
            wire = async_rounds.buffer_from_wire(
                wire, self.state, self.fed, sig=meta.get("payload_sig"))
            self.buf_msgs = _zeros(self.msg_struct)
            for stack, row in zip(_leaves(self.buf_msgs),
                                  _leaves(wire.msgs)):
                stack[...] = frames.to_numpy(row)
            self.buf_origin = frames.to_numpy(wire.origin).copy()
            self.buf_sigma = frames.to_numpy(wire.sigma).copy()
            self.buf_weight = frames.to_numpy(wire.weight).copy()
            self.buf_occupied = frames.to_numpy(wire.occupied).copy()
            for cid in np.flatnonzero(self.buf_occupied > 0):
                self.seen.add((int(cid), int(self.buf_origin[cid])))
            # the persisted dedup window: frames merged before the restart
            # whose origin the staleness law would still accept cannot
            # re-park as duplicates in the resumed life
            for cid, origin in meta.get("seen", []):
                self.seen.add((int(cid), int(origin)))
        return True

    # -- lifecycle ----------------------------------------------------------

    def serve(self, T: int, progress: Optional[Callable] = None):
        """Drive rounds ``[self.t, T)``, then FINISH the workers and
        assemble the final state (EF rows re-attached).  Returns
        ``(state, metrics, stats)`` with the metrics as host numpy arrays
        stacked ``[T - t0]``, as ``rounds.drive`` returns them."""
        while self.t < T:
            self.round()
            if progress is not None:
                m = self.metrics[-1]
                progress(self.t, m.f, m.g_hat, m.sigma)
        self._ef_epoch += 1
        for conn in self.conns:
            self._send(conn, frames.encode_frame(
                frames.K_FINISH, origin_round=self.t))
        self._collect(
            lambda: all(c.ef_epoch == self._ef_epoch or c.dead
                        for c in self.conns),
            what="final EF dumps")
        state = self.state._replace(e_up=self._assemble_ef())
        mets = rounds._stack(self.metrics) if self.metrics else None
        return state, mets, self.stats

    def close(self) -> None:
        for conn in self.conns:
            try:
                self.sel.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
            conn.sock.close()
        self.sel.close()


# ---------------------------------------------------------------------------
# Spawn + drive
# ---------------------------------------------------------------------------

def _worker_chaos(chaos: Optional[dict], life: int) -> Optional[dict]:
    """Respawned lives shed their injected faults unless the spec opts in
    with ``persistent: true`` -- a ``die_round`` relived every life would
    keep the worker dead until its respawn budget drained."""
    if life > 0 and not (chaos or {}).get("persistent"):
        return None
    return chaos


def wire_drive(fed: FedConfig, T: int, workers: int = 2, *,
               problem: str = "np", problem_args: Optional[dict] = None,
               spawn: str = "process", chaos=None, deadline: float = 30.0,
               host: str = "127.0.0.1", port: int = 0, sink=None,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
               resume: bool = False, progress: Optional[Callable] = None,
               faults: Optional[WireFaultConfig] = None,
               proc_chaos: Optional[dict] = None, chaos_seed: int = 0,
               device="cuda"):
    """Run T federated rounds over the real wire on ``device`` (``cuda``
    unless the caller asks for the CPU): spawn K workers
    (``spawn='process'``: ``python -c`` worker subprocesses running
    :func:`repro_torch.wire.worker.main` with ``PYTHONPATH`` set to this
    package's ``src``, the coordinator's device and its intra-op thread
    count; ``spawn='thread'``: in-process threads over real loopback
    sockets, sharing the problem and the device), serve the rounds, and
    return ``(state, metrics, stats)``.

    ``chaos`` is a fault spec dict applied to every worker, or a per-worker
    list of them (None entries = no faults); see
    :class:`repro_torch.wire.testing.ChaosLink` (frame faults) and the
    worker's ``die_*`` keys (thread-mode deaths).  ``resume=True`` restarts
    from the newest checkpoint in ``ckpt_dir`` (state + parked-frame buffer
    + dedup window + worker EF rows via EF_LOAD).

    ``faults`` (a :class:`repro_torch.wire.supervisor.WireFaultConfig`)
    arms the fault-tolerant runtime: heartbeat liveness, bounded respawn +
    round replay, quorum-gated degraded rounds.  ``proc_chaos`` (process
    spawn only, needs ``faults``) arms
    :class:`repro_torch.wire.supervisor.ChaosProcess`, SIGKILL/SIGSTOPing
    live workers mid-phase with ``chaos_seed`` determinism.  Both sides'
    connect/accept run under the bounded-backoff schedule; the accept waits
    surface in ``stats.accept_waits`` and the sink's opening record."""
    partition.refuse_ranks("the wire runtime")
    if spawn not in ("process", "thread"):
        raise ValueError(f"spawn must be 'process' or 'thread', "
                         f"got {spawn!r}")
    if proc_chaos is not None:
        if faults is None:
            raise ValueError("proc_chaos kills real workers; arm the "
                             "supervisor with faults=WireFaultConfig(...)")
        if spawn != "process":
            raise ValueError("proc_chaos sends real signals; it needs "
                             "spawn='process' (thread-mode deaths are the "
                             "worker chaos die_* keys)")
    chaos_list = chaos if isinstance(chaos, (list, tuple)) \
        else [chaos] * workers
    if len(chaos_list) != workers:
        raise ValueError(f"chaos list has {len(chaos_list)} entries for "
                         f"{workers} workers")
    dev = resolve_device(device)
    hb = faults.heartbeat_s if faults is not None else 0.0
    params, batches, loss_pair = bootstrap.build_problem(
        problem, dict(problem_args or {}, n_clients=fed.n_clients), dev)
    if spawn == "process":
        batches = None      # the worker processes build their own

    stats = WireStats()
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    procs, threads, errors = [], [], []
    coord = supervisor = None
    try:
        listener.bind((host, port))
        listener.listen(workers)
        actual_port = listener.getsockname()[1]

        if spawn == "process":
            src_root = os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))
            env = dict(os.environ)
            env["PYTHONPATH"] = src_root + os.pathsep \
                + env.get("PYTHONPATH", "")
            # the coordinator's intra-op thread count: CPU rows then reduce
            # as they do in this process
            env["OMP_NUM_THREADS"] = str(torch.get_num_threads())

            def spawn_fn(i, life):
                # -c instead of -m: the package __init__ imports .worker,
                # so runpy would warn about re-executing an
                # already-imported module
                argv = [sys.executable, "-c",
                        "import sys; from repro_torch.wire import worker; "
                        "worker.main(sys.argv[1:])",
                        "--connect", f"{host}:{actual_port}",
                        "--problem", problem,
                        "--problem-args", json.dumps(problem_args or {}),
                        "--fed", bootstrap.fed_to_json(fed),
                        "--workers", str(workers), "--worker-id", str(i),
                        "--chaos-seed", str(i + 101 * life),
                        "--device", dev.type]
                wk_chaos = _worker_chaos(chaos_list[i], life)
                if wk_chaos:
                    argv += ["--chaos", json.dumps(wk_chaos)]
                if hb > 0:
                    argv += ["--heartbeat", str(hb)]
                p = subprocess.Popen(argv, env=env)
                procs.append(p)
                return p
        else:
            def run_thread(i, wk_chaos, seed):
                try:
                    lo, hi = worker_mod.client_range(
                        fed.n_clients, workers, i)
                    rows = rebuild(batches, [x[lo:hi]
                                             for x in leaves_of(batches)])
                    wk = worker_mod.Worker(
                        params, fed, rows, loss_pair, np.arange(lo, hi),
                        chaos=wk_chaos, chaos_seed=seed, heartbeat_s=hb,
                        device=dev)
                    stats.workers.append(wk)
                    sock, _slept = bootstrap.connect_with_retry(
                        host, actual_port, seed=i)
                    with sock:
                        wk.run(sock)
                except BaseException as e:   # surfaced by wire_drive
                    errors.append((i, e))

            def spawn_fn(i, life):
                th = threading.Thread(
                    target=run_thread,
                    args=(i, _worker_chaos(chaos_list[i], life),
                          i + 101 * life),
                    daemon=True)
                th.start()
                threads.append(th)
                return th

        if faults is not None:
            supervisor = Supervisor(listener, faults, workers, spawn_fn,
                                    stats=stats)
        for i in range(workers):
            handle = spawn_fn(i, 0)
            if supervisor is not None:
                supervisor.register(i, handle)

        def liveness():
            if errors:
                i, e = errors[0]
                raise RuntimeError(
                    f"worker thread {i} died during connect: {e!r}") from e
            for p in procs:
                rc = p.poll()
                if rc is not None and rc != 0:
                    raise RuntimeError(
                        f"a worker process exited with status {rc} "
                        "before connecting")

        try:
            socks, waits = bootstrap.accept_with_retry(
                listener, workers, deadline, liveness)
        except socket.timeout as e:
            detail = "; ".join(f"worker {i}: {err!r}" for i, err in errors)
            raise RuntimeError(
                str(e) + (f" ({detail})" if detail else "")) from e
        stats.accept_waits = [float(w) for w in waits]

        chaos_proc = None
        if proc_chaos is not None:
            chaos_proc = ChaosProcess(proc_chaos, seed=chaos_seed)
            chaos_proc.bind(supervisor)

        coord = Coordinator(
            params, fed, deadline=deadline, sink=sink, ckpt_dir=ckpt_dir,
            ckpt_every=ckpt_every, stats=stats, faults=faults,
            supervisor=supervisor,
            on_phase=chaos_proc.on_phase if chaos_proc else None,
            device=dev)
        coord.attach(socks)
        if sink is not None:
            open_rec = {"round": -1, "wire_workers": workers,
                        "wire_accept_waits_s": stats.accept_waits}
            if faults is not None:
                open_rec["wire_faults"] = json.loads(faults.to_json())
            sink.emit(open_rec)
        if resume:
            if not ckpt_dir:
                raise ValueError("resume=True needs ckpt_dir")
            coord.resume()
        state, mets, stats = coord.serve(T, progress=progress)
        if faults is None:
            for th in threads:
                th.join(timeout=deadline)
            for i, p in enumerate(procs):
                if p.wait(timeout=deadline) != 0:
                    raise RuntimeError(
                        f"worker process {i} exited with status "
                        f"{p.returncode}")
            if errors:
                i, e = errors[0]
                raise RuntimeError(f"worker thread {i} died: {e!r}") from e
        else:
            # a faulted run ends with killed processes / dead threads by
            # design; only errors the fault model does not produce are
            # still bugs worth crashing over
            for th in threads:
                th.join(timeout=1.0)
            fatal = [(i, e) for i, e in errors
                     if not isinstance(e, (OSError, frames.FrameError))]
            if fatal:
                i, e = fatal[0]
                raise RuntimeError(
                    f"worker thread {i} died with a non-wire error: "
                    f"{e!r}") from e
        return state, mets, stats
    finally:
        if coord is not None:
            coord.close()
        if supervisor is not None:
            supervisor.shutdown()
        listener.close()
        _reap(procs, threads)


def _reap(procs, threads) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for th in threads:
        th.join(timeout=1.0)
