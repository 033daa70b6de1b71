"""The fault-tolerant wire runtime of the port (``repro_torch.wire.
supervisor``, after ``tests/test_faults.py``).

* backoff and retry: the jittered schedules equal the reference's for the
  same seeds (float equality); connect retries against a late listener;
  the accept deadline and the liveness abort;
* the degraded-cohort machinery: sub-m ``mask_indices`` padding with the
  first sampled index, ``FixedSampler`` replay, ``WireFaultConfig``'s json
  round-trip and heartbeat-timeout law;
* ``ChaosLink``: its seeded fault schedule writes the same bytes as the
  reference's for the same frames and seed; connection-level faults
  (close-mid-frame EOF, a silent stall, control-frame drop and corrupt);
* kill + recover: a worker PROCESS SIGKILLed (``ChaosProcess``) at round
  1's eval is respawned, its EF rows re-seeded from the pre-round snapshot
  and the round replayed -- bit-identical to the clean single-process
  oracle; a thread worker dying mid-eval likewise;
* degraded rounds: with no respawn budget the dead worker's sampled
  clients are demoted and the survivors' HT weights rescaled -- bit-equal
  to ``rounds.drive`` under the ``fixed`` sampler replaying the realized
  cohorts, with the HT mass of every round equal (float32);
* a round below ``min_quorum * m`` aborts loudly; a stalled worker (socket
  open, nothing moving) is caught by its heartbeat and recovered to full
  parity; a mid-frame uplink death never corrupts the stream;
* the dedup window rides the checkpoint sidecar and is restored by
  ``Coordinator.resume``.

Every state and metric comparison is bit for bit.  Sockets bind ephemeral
ports and every wait has its own deadline.
"""
import dataclasses
import os
import random
import socket
import threading
import time

import numpy as np
import pytest
import torch

from repro.wire import bootstrap as jax_bootstrap
from repro.wire import testing as jax_testing
from repro_torch import checkpoint
from repro_torch.configs.base import FleetConfig
from repro_torch.engine import participation, rounds
from repro_torch.fleet.samplers import fixed_state, get_sampler
from repro_torch.wire import bootstrap, frames, testing
from repro_torch.wire.coordinator import Coordinator, wire_drive
from repro_torch.wire.supervisor import WireFaultConfig
from test_torch_wire import (N, _cfg, _oracle, assert_metrics_equal,
                             assert_state_equal)
from torch_port_util import assert_bits_equal

T = 3
DIE_EVAL = {"die_round": 1, "die_phase": "eval"}


@pytest.fixture(autouse=True)
def one_thread():
    # tiny shapes: one intra-op thread beats contending with the other
    # test workers for the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _drive(fed, T, **kw):
    return wire_drive(fed, T, workers=2, spawn=kw.pop("spawn", "thread"),
                      device="cpu", **kw)


# ---------------------------------------------------------------------------
# Backoff / retry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("attempts", [1, 2, 8])
def test_backoff_schedule_equals_reference(attempts, seed):
    kw = dict(base=0.1, cap=2.0, jitter=0.25, seed=seed)
    assert bootstrap.backoff_schedule(attempts, **kw) == \
        jax_bootstrap.backoff_schedule(attempts, **kw)


def test_schedule_deterministic_and_bounded():
    a = bootstrap.backoff_schedule(8, base=0.1, cap=2.0, jitter=0.25, seed=3)
    assert a == bootstrap.backoff_schedule(8, base=0.1, cap=2.0,
                                           jitter=0.25, seed=3)
    assert len(a) == 7
    for k, d in enumerate(a):
        nominal = min(0.1 * 2.0 ** k, 2.0)
        assert 0.75 * nominal <= d <= 1.25 * nominal, (k, d)
    assert a != bootstrap.backoff_schedule(8, seed=4)
    assert bootstrap.backoff_schedule(1) == []


def test_connect_retries_until_listener_appears():
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.bind(("127.0.0.1", 0))     # bound, NOT listening yet
    port = listener.getsockname()[1]

    def arm():
        time.sleep(0.25)
        listener.listen(1)

    th = threading.Thread(target=arm, daemon=True)
    th.start()
    try:
        sock, slept = bootstrap.connect_with_retry(
            "127.0.0.1", port, attempts=20, base=0.05, cap=0.2, seed=7)
        sock.close()
    finally:
        th.join(timeout=5.0)
        listener.close()
    assert not th.is_alive()
    assert slept, "the first attempt hits a port that is not listening"


def test_connect_exhausts_budget():
    probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()                       # nothing is listening here
    with pytest.raises(OSError, match="after 2 attempts"):
        bootstrap.connect_with_retry("127.0.0.1", port, attempts=2,
                                     base=0.01, cap=0.02)


def test_accept_deadline_names_the_shortfall():
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.bind(("127.0.0.1", 0))
    listener.listen(2)
    try:
        with pytest.raises(socket.timeout, match="0/1"):
            bootstrap.accept_with_retry(listener, 1, deadline=0.3,
                                        poll=0.05)
    finally:
        listener.close()


def test_accept_liveness_aborts_early():
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.bind(("127.0.0.1", 0))
    listener.listen(2)

    def dead_worker():
        raise RuntimeError("worker 0 exited with code 1")

    t0 = time.monotonic()
    try:
        with pytest.raises(RuntimeError, match="exited"):
            bootstrap.accept_with_retry(listener, 1, deadline=30.0,
                                        liveness=dead_worker, poll=0.05)
    finally:
        listener.close()
    assert time.monotonic() - t0 < 5.0, "liveness must beat the deadline"


# ---------------------------------------------------------------------------
# Degraded-cohort machinery
# ---------------------------------------------------------------------------

def test_mask_indices_pads_with_first_sampled():
    mask = torch.tensor([0, 0, 0, 1, 0, 1, 0, 0], dtype=torch.float32)
    idx = participation.mask_indices(mask, 4).tolist()
    assert idx == [3, 5, 3, 3]
    assert 0 not in idx, "client 0 must not be clobbered when unsampled"
    full = torch.tensor([0, 1, 0, 1, 1, 0, 1, 0], dtype=torch.float32)
    assert participation.mask_indices(full, 4).tolist() == [1, 3, 4, 6]


def test_fixed_sampler_replays_recorded_rows():
    fed = _cfg().replace(fleet=FleetConfig(sampler="fixed"))
    masks = np.zeros((2, 8), np.float32)
    weights = np.zeros((2, 8), np.float32)
    masks[0, [1, 4]] = 1.0
    weights[0, [1, 4]] = 2.5
    masks[1, [0, 2, 6]] = 1.0
    weights[1, [0, 2, 6]] = 7.0 / 3.0
    samp = get_sampler("fixed")
    s = fixed_state(masks, weights)
    for t in range(2):
        mask, w, s = samp.sample(None, fed, s)
        assert np.array_equal(mask.numpy(), masks[t])
        assert np.array_equal(w.numpy(), weights[t])
    with pytest.raises(ValueError, match="matching"):
        fixed_state(np.zeros((2, 8)), np.zeros((3, 8)))


def test_fault_config_json_roundtrip_and_timeout_law():
    cfg = WireFaultConfig(heartbeat_s=0.5, min_quorum=0.75, max_respawns=3)
    assert cfg.timeout() == pytest.approx(1.5)   # 3 x heartbeat_s
    assert dataclasses.replace(cfg, heartbeat_timeout=4.0).timeout() == \
        pytest.approx(4.0)
    assert WireFaultConfig().timeout() == 0.0
    assert WireFaultConfig.from_json(cfg.to_json()) == cfg


# ---------------------------------------------------------------------------
# ChaosLink
# ---------------------------------------------------------------------------

class _Sink:
    def __init__(self):
        self.out = bytearray()

    def sendall(self, b):
        self.out.extend(b)


@pytest.mark.parametrize("spec", [
    {"drop": 0.2, "dup": 0.2, "truncate": 0.1, "corrupt": 0.1,
     "delay": 0.2, "delay_rounds": 2, "reorder": True},
    {"dup": 0.5, "only_client": 3, "reorder": True},
    {"corrupt": 0.3, "delay": 0.3}])
def test_chaos_schedule_equals_reference(spec):
    """Frames through both packages' ChaosLinks with one seed: the same
    bytes reach the socket and the same faults are counted."""
    links = [testing.ChaosLink(_Sink(), spec, seed=5),
             jax_testing.ChaosLink(_Sink(), spec, seed=5)]
    for t in range(6):
        for c in range(5):
            fr = frames.encode_frame(frames.K_UPLINK, bytes([t, c]) * 9,
                                     client_id=c, origin_round=t,
                                     sig="dense|uint8:18")
            for link in links:
                link.send(fr, t, c)
        for link in links:
            link.send_now(frames.encode_frame(frames.K_ROUND_DONE,
                                              origin_round=t))
            link.flush(t)
    for link in links:
        link.drain()
    a, b = links
    assert bytes(a.sock.out) == bytes(b.sock.out) and a.sock.out
    for name in ("sent", "dropped", "duped", "truncated", "corrupted",
                 "delayed"):
        assert getattr(a, name) == getattr(b, name), name


def _frame():
    return frames.encode_frame(frames.K_HEARTBEAT, client_id=5)


def test_close_mid_frame_leaves_partial_then_eof():
    a, b = socket.socketpair()
    try:
        link = testing.ChaosLink(a, {"close_mid_frame": 1.0}, seed=0)
        link.send_now(_frame())
        assert link.closed == 1 and link.stalled
        b.settimeout(2.0)
        got = b.recv(1 << 16)
        full = frames._LEN.pack(len(_frame())) + _frame()
        assert 0 < len(got) < len(full), "must be a PARTIAL frame"
        assert b.recv(1 << 16) == b"", "then a hard EOF"
        link.send_now(_frame())             # inert afterwards, no raise
        link.send(_frame(), 0, 5)
        link.flush(0)
        assert link.sent == 0
    finally:
        b.close()


def test_stall_goes_silent_with_socket_open():
    a, b = socket.socketpair()
    try:
        link = testing.ChaosLink(a, {"stall": 1.0}, seed=0)
        link.send_now(_frame())
        assert link.stalls == 1 and link.stalled
        b.setblocking(False)
        with pytest.raises(BlockingIOError):
            b.recv(1)               # nothing arrived, nothing closed
    finally:
        a.close()
        b.close()


def test_send_now_drop_and_corrupt():
    a, b = socket.socketpair()
    try:
        link = testing.ChaosLink(a, {"drop": 1.0}, seed=1)
        link.send_now(_frame())
        assert link.dropped == 1 and link.sent == 0
        # delay has no round clock on the immediate path: it drops
        link.spec = {"delay": 1.0}
        link.send_now(_frame())
        assert link.dropped == 2
        link.spec = {"corrupt": 1.0}
        link.send_now(_frame())
        assert link.corrupted == 1 and link.sent == 1
        b.settimeout(2.0)
        reader = frames.FrameReader()
        reader.feed(b.recv(1 << 16))
        with pytest.raises(frames.FrameError, match="CRC mismatch"):
            for raw in reader.frames():
                frames.decode_frame(raw)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# Kill + recover: respawn, EF re-seed, round replay -- clean-oracle parity
# ---------------------------------------------------------------------------

def _round1_kill_seed() -> int:
    """A ChaosProcess seed whose eval-phase draws spare round 0 and kill
    at round 1 (kill probability 0.5)."""
    for seed in range(1000):
        rng = random.Random(seed)
        if rng.random() >= 0.5 and rng.random() < 0.5:
            return seed
    raise AssertionError("no seed")


def test_process_sigkill_recovers_bit_equal(tmp_path):
    """A worker process SIGKILLed at round 1's eval: respawned within the
    budget, its EF rows re-seeded from the pre-round snapshot
    (``ckpt_every=1``), the round replayed -- the run equals the clean
    oracle bit for bit."""
    fed = _cfg()
    faults = WireFaultConfig(max_respawns=1, eval_grace=60.0,
                             respawn_window=60.0)
    state, mets, stats = _drive(
        fed, T, spawn="process", deadline=60.0, faults=faults,
        proc_chaos={"kill": 0.5, "phase": "eval", "max_kills": 1},
        chaos_seed=_round1_kill_seed(), ckpt_dir=str(tmp_path),
        ckpt_every=1)
    assert stats.totals["respawns"] == 1
    assert stats.totals["recovered"] == 1 and stats.totals["degraded"] == 0
    ostate, omets = _oracle(fed, T)
    assert_state_equal(ostate, state, "sigkill")
    assert_metrics_equal(omets, mets)


@pytest.fixture(scope="module")
def recover_run(tmp_path_factory):
    """Worker 1 (a thread) dies mid-eval of round 1; the supervisor
    respawns it, re-seeds EF from the round-boundary snapshot
    (``ckpt_every=1`` makes it the exact pre-round residual) and replays
    the round."""
    fed = _cfg()
    ckpt_dir = str(tmp_path_factory.mktemp("recover_ckpt"))
    faults = WireFaultConfig(max_respawns=1, eval_grace=15.0,
                             respawn_window=30.0)
    state, mets, stats = _drive(
        fed, T, chaos=[None, dict(DIE_EVAL)], deadline=10.0, faults=faults,
        ckpt_dir=ckpt_dir, ckpt_every=1)
    return fed, state, mets, stats, ckpt_dir


def test_thread_death_recovers_bit_equal(recover_run):
    fed, state, mets, stats, _ = recover_run
    ostate, omets = _oracle(fed, T)
    assert_state_equal(ostate, state, "recover")
    assert_metrics_equal(omets, mets)
    assert stats.totals["respawns"] == 1 and stats.totals["recovered"] == 1
    assert stats.totals["degraded"] == 0 and stats.totals["missing"] == 0
    assert stats.totals["rejected"] == 0
    assert len(stats.recovery_s) == 1 and stats.recovery_s[0] > 0
    assert sorted(stats.realized) == list(range(T))
    assert all(not stats.realized[t]["demoted"] for t in range(T))


def test_dedup_window_rides_the_sidecar(recover_run):
    fed, _, _, _, ckpt_dir = recover_run
    t_last = checkpoint.latest_round(ckpt_dir)
    meta = checkpoint.read_metadata(
        os.path.join(ckpt_dir, f"round_{t_last}_buffer"))
    window = {(int(c), int(o)) for c, o in meta["seen"]}
    assert window, "merged (client, origin) pairs must be persisted"
    assert all(t_last - o <= fed.async_.max_staleness for _, o in window)
    params, _, _ = bootstrap.build_problem("np", {"n_clients": N},
                                           device="cpu")
    coord = Coordinator(params, fed, ckpt_dir=ckpt_dir, device="cpu")
    assert coord.resume() and coord.t == t_last
    assert window <= coord.seen
    coord.close()


# ---------------------------------------------------------------------------
# Degraded rounds: demotion + exact HT reweighting -- fixed-sampler parity
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def degraded_run(tmp_path_factory):
    """Respawn budget 0: worker 1's death makes every later round run
    degraded over the realized cohort with rescaled HT weights.  The
    port's round-1 cohort holds three of worker 1's clients, so a quorum
    of 1 in 4 keeps the run going (the default 0.5 aborts it, as
    ``test_below_quorum_aborts_loudly`` expects of a quorum not met)."""
    fed = _cfg()
    faults = WireFaultConfig(max_respawns=0, eval_grace=2.0,
                             min_quorum=0.25)
    # ckpt_every=1: the dead worker's residual rows in the final state are
    # its last collected snapshot, the rows the oracle ends with
    state, mets, stats = _drive(
        fed, T, chaos=[None, dict(DIE_EVAL)], deadline=8.0, faults=faults,
        ckpt_dir=str(tmp_path_factory.mktemp("degraded_ckpt")),
        ckpt_every=1)
    return fed, state, mets, stats


def test_degraded_rounds_equal_realized_cohort_oracle(degraded_run):
    fed, state, mets, stats = degraded_run
    masks = np.asarray([stats.realized[t]["mask"] for t in range(T)],
                       np.float32)
    weights = np.asarray([stats.realized[t]["weights"] for t in range(T)],
                         np.float32)
    fed2 = fed.replace(fleet=dataclasses.replace(fed.fleet,
                                                 sampler="fixed"))
    params, batches, loss_pair = bootstrap.build_problem(
        "np", {"n_clients": fed.n_clients}, device="cpu")
    ost = rounds.init_state(params, fed2, device="cpu")._replace(
        sampler=fixed_state(masks, weights))
    ostate, omets = rounds.drive(ost, batches, loss_pair, fed2, T,
                                 device="cpu")
    for name in ("w", "x", "e_up", "wbar_sum", "wbar_weight"):
        assert_bits_equal(getattr(ostate, name), getattr(state, name))
    # g_full / f_full are NOT comparable: the dead worker's full-eval rows
    # are zero on the wire side while the oracle evaluates them
    for name in ("f", "g_hat", "sigma", "feasible", "up_bytes"):
        assert_bits_equal(getattr(omets, name), getattr(mets, name))


def test_ht_mass_conserved(degraded_run):
    fed, _, _, stats = degraded_run
    masses = [np.float32(np.asarray(stats.realized[t]["weights"],
                                    np.float32).sum()) for t in range(T)]
    assert all(m == masses[0] for m in masses), masses
    deg = [t for t in range(T) if stats.realized[t]["demoted"]]
    assert deg, "the budget-0 run must actually degrade"
    assert stats.totals["degraded"] == len(deg)
    assert stats.totals["respawns"] == 0
    for t in deg:
        rec = stats.rounds[t]
        assert rec["wire_degraded"] == 1 and rec["wire_ht_mass"] == masses[0]
        mask = np.asarray(stats.realized[t]["mask"])
        assert all(mask[c] == 0 for c in stats.realized[t]["demoted"])
        assert 0 < int(mask.sum()) < fed.m
        assert "wire_ht_variance" in rec and "wire_eff_ratio" in rec


def test_below_quorum_aborts_loudly():
    faults = WireFaultConfig(max_respawns=0, eval_grace=2.0, min_quorum=1.0)
    with pytest.raises(RuntimeError, match="lost quorum"):
        _drive(_cfg(), T, chaos=[None, dict(DIE_EVAL)], deadline=8.0,
               faults=faults)


# ---------------------------------------------------------------------------
# Heartbeats catch stalls; a mid-frame death never corrupts the stream
# ---------------------------------------------------------------------------

def test_stalled_worker_caught_by_heartbeat_and_recovered(tmp_path):
    fed = _cfg()
    chaos = [None, {"die_round": 1, "die_phase": "eval",
                    "die_mode": "stall", "stall_s": 3.0}]
    faults = WireFaultConfig(heartbeat_s=0.2, max_respawns=1,
                             eval_grace=15.0, respawn_window=30.0)
    state, mets, stats = _drive(fed, T, chaos=chaos, deadline=10.0,
                                faults=faults, ckpt_dir=str(tmp_path),
                                ckpt_every=1)
    # the socket never closed: only the heartbeat timeout can have
    # declared the worker dead
    assert stats.totals["respawns"] == 1
    assert stats.totals["heartbeats"] > 0
    ostate, omets = _oracle(fed, T)
    assert_state_equal(ostate, state, "stall")
    assert_metrics_equal(omets, mets)


def test_mid_frame_uplink_death_completes_cleanly():
    chaos = [None, {"die_round": 1, "die_phase": "uplink",
                    "die_mode": "mid_frame"}]
    faults = WireFaultConfig(max_respawns=0, eval_grace=2.0)
    _, mets, stats = _drive(_cfg(), T, chaos=chaos, deadline=8.0,
                            faults=faults)
    # the half-written frame is discarded at EOF: no decode error, no merge
    # of garbage -- the round closes over whatever arrived
    assert stats.totals["rejected"] == 0
    # post-sigma losses take the zero-weight path, so round 1 is short
    assert stats.rounds[1]["wire_missing"] > 0
    assert np.isfinite(mets.f).all()
    masses = [np.float32(np.asarray(stats.realized[t]["weights"],
                                    np.float32).sum()) for t in range(T)]
    assert all(m == masses[0] for m in masses)
