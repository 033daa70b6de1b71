"""The wire client worker: one process (or thread) holding a contiguous
range of clients, speaking the frame protocol to the coordinator (port of
``repro.wire.worker``).

Per round the worker is driven entirely by coordinator frames:

1. ``ACTIVATE`` (round t): carries the flat model buffer ``wf``, this
   worker's clients' participation mask bits and HT weights, and a key
   leaf (``uint32[2]``: the seed and round the uplink's
   :class:`repro_torch.comm.transports.WireKey` is made of).  The worker
   evaluates ALL its clients' ``(f_j, g_j)`` through
   :func:`repro_torch.engine.rounds.eval_clients` -- the helper the
   single-process round runs, over the same rows -- and replies with one
   ``EVAL`` frame.
2. ``SIGMA``: the switch weight the coordinator computed from the global
   eval.  The worker runs the E local steps for its *sampled* clients
   (:func:`repro_torch.engine.rounds.local_deltas`), EF14-encodes them
   through ``FlatTransport._ef_clients`` with the round's uplink
   ``WireKey(cfg.seed, t, UPLINK)`` and the GLOBAL client ids (so the
   random kinds draw each client's own stream, as the oracle's gather
   encode does), updates its residual rows, and ships one ``UPLINK`` frame
   per sampled client followed by ``ROUND_DONE``.
3. ``EF_REQ`` / ``FINISH``: dump the EF residual rows (checkpointing, the
   final state); ``EF_LOAD`` restores them on a coordinator resume.

Rows are not padded to the gather width m, as the reference pads them: the
port's ``local_deltas`` is a row loop, and the encode kernels (and their
plain versions) work row by row, so a worker's k sampled rows come out
bit-equal to the same rows of the oracle's ``[m, d]`` batch
(``tests/test_torch_wire.py`` holds it on every wire).  A round needs no
more rows than the worker's sampled clients.

CLI (spawned by the coordinator)::

    python -m repro_torch.wire.worker --connect 127.0.0.1:PORT \\
        --problem np --fed '<json>' --workers 2 --worker-id 0 \\
        [--chaos '<json>'] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import random
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.comm import flat, transports
from repro_torch.engine import rounds, strategies
from repro_torch.fleet.partitions import leaves_of, rebuild
from repro_torch.wire import bootstrap, frames, testing


def client_range(n: int, workers: int, worker_id: int) -> tuple[int, int]:
    """Contiguous ``[lo, hi)`` client-id range for one worker (remainder
    clients go to the leading workers)."""
    if not (0 <= worker_id < workers):
        raise ValueError(f"worker_id {worker_id} outside [0, {workers})")
    base, rem = divmod(n, workers)
    lo = worker_id * base + min(worker_id, rem)
    hi = lo + base + (1 if worker_id < rem else 0)
    return lo, hi


def select_rows(batches, idx: torch.Tensor):
    """Rows ``idx`` of a stacked batch (a NamedTuple, a plain tuple or a
    single tensor; ``None`` fields kept)."""
    return rebuild(batches, [x.index_select(0, idx.to(x.device))
                             for x in leaves_of(batches)])


def _row(msgs, i: int):
    if isinstance(msgs, torch.Tensor):
        return msgs[i]
    return type(msgs)(*(x[i] for x in msgs))


class _LockedSock:
    """Socket proxy serializing ``sendall``: the heartbeat thread and the
    protocol loop (plus a ChaosLink holding this proxy) write frames
    concurrently, and an interleaved write would desynchronize the
    length-prefixed stream.  Reads stay lock-free (single reader)."""

    def __init__(self, sock):
        self._sock = sock
        self._lock = threading.Lock()

    def sendall(self, data):
        with self._lock:
            return self._sock.sendall(data)

    def __getattr__(self, name):
        return getattr(self._sock, name)


class Worker:
    """The worker state machine (see the module docstring), on ``device``
    (``cuda`` unless the caller asks for the CPU; ``batch_rows`` must live
    there).

    Built either from in-memory objects (thread spawn, tests) or via
    :func:`run_worker` from CLI arguments (process spawn)."""

    def __init__(self, params, fed, batch_rows, loss_pair, gids,
                 chaos: Optional[dict] = None, chaos_seed: int = 0,
                 heartbeat_s: float = 0.0, device="cuda"):
        self.device = resolve_device(device)
        self.fed = fed
        self.loss_pair = loss_pair
        self.gids = np.asarray(gids, np.int64)
        self.batch_rows = batch_rows
        self.spec = flat.spec_of(params)
        self.uplink, _ = flat.flat_transports_for(fed, self.spec)
        self.strat = strategies.get_strategy(fed.strategy)
        self.chaos = chaos
        self.chaos_seed = chaos_seed
        self.heartbeat_s = float(heartbeat_s)
        # seeded, separate from ChaosLink's frame-fault stream: the die_*
        # keys model this worker LIFE's death (repro_torch.wire.supervisor
        # respawns a fresh life with a fresh seed)
        self._die_rng = random.Random(chaos_seed ^ 0x5EED)
        self.e_rows = None
        if self.uplink.needs_residual:
            self.e_rows = torch.zeros((len(self.gids), self.spec.d),
                                      dtype=self.spec.dtype,
                                      device=self.device)

    # -- the stages ---------------------------------------------------------

    def _eval(self, wf):
        return rounds.eval_clients(flat.unflatten(self.spec, wf),
                                   self.batch_rows, self.loss_pair,
                                   len(self.gids))

    def _delta_stage(self, wf, sigma, local_b, e_part, t: int, ids):
        """E local steps on the sampled rows, then their EF14 encode:
        ``(msgs, e_stack)``, as the oracle's gather round computes them."""
        deltas = rounds.local_deltas(wf, self.spec, self.strat, sigma,
                                     local_b, self.loss_pair, self.fed,
                                     len(ids))
        if self.uplink.is_identity:
            return deltas, e_part
        key = transports.WireKey(self.fed.seed, t, transports.UPLINK)
        return self.uplink._ef_clients(
            e_part, deltas, key, ids if self.uplink.needs_key else None)

    # -- the protocol loop --------------------------------------------------

    def run(self, sock) -> None:
        sock = _LockedSock(sock)
        link = testing.make_link(sock, self.chaos, seed=self.chaos_seed)
        self.link = link        # exposed for fault-injection ground truth
        self._hb_stop = threading.Event()
        if self.heartbeat_s > 0:
            threading.Thread(target=self._beat, args=(sock,),
                             daemon=True).start()
        try:
            self._run(sock, link)
        finally:
            self._hb_stop.set()

    def _beat(self, sock) -> None:
        """Heartbeat thread: a header-only K_HEARTBEAT every period, so a
        silent-but-alive worker is distinguishable from a wedged one."""
        while not self._hb_stop.wait(self.heartbeat_s):
            try:
                frames.write_frame(sock, frames.encode_frame(
                    frames.K_HEARTBEAT, client_id=int(self.gids[0])))
            except OSError:
                return

    # -- injected deaths (thread-mode chaos; see wire.supervisor) -----------

    def _should_die(self, t: int, phase: str) -> bool:
        c = self.chaos or {}
        if c.get("die_phase", "eval") != phase:
            return False
        if c.get("die_round") is not None:
            return int(c["die_round"]) == t
        rate = float(c.get("die_rate", 0.0))
        return rate > 0 and self._die_rng.random() < rate

    def _die(self, sock, t: int) -> None:
        """This life ends.  ``die_mode``: ``close`` (abrupt socket close),
        ``mid_frame`` (half a frame then close -- the receiver sees a
        length prefix whose bytes never finish), ``stall`` (go silent with
        the socket open: only a heartbeat timeout can catch it)."""
        self._hb_stop.set()
        mode = (self.chaos or {}).get("die_mode", "close")
        if mode == "mid_frame":
            raw = frames.encode_frame(
                frames.K_EVAL, b"\x00" * 64, client_id=int(self.gids[0]),
                origin_round=t, sig="dense|uint8:64")
            data = frames._LEN.pack(len(raw)) + raw
            try:
                sock.sendall(data[: len(data) // 2])
            except OSError:
                pass
        elif mode == "stall":
            time.sleep(float((self.chaos or {}).get("stall_s", 60.0)))
        try:
            sock.close()
        except OSError:
            pass

    def _run(self, sock, link) -> None:
        sig, body = frames.pack_payload(self.gids.astype(np.int64))
        frames.write_frame(sock, frames.encode_frame(
            frames.K_HELLO, body, client_id=int(self.gids[0]), sig=sig))
        wf = mask_rows = weight_rows = None
        t = -1
        while True:
            got = frames.read_frame(sock)
            if got is None:
                return                      # coordinator went away
            header, body, _ = got
            if header.kind == frames.K_FINISH:
                self._send_ef(sock, t)
                link.drain()
                return
            if header.kind == frames.K_EF_REQ:
                self._send_ef(sock, t)
            elif header.kind == frames.K_EF_LOAD:
                self.e_rows = frames.unpack_payload(header.sig, body,
                                                    self.device)
            elif header.kind == frames.K_ACTIVATE:
                t = header.origin_round
                if self._should_die(t, "eval"):
                    self._die(sock, t)
                    return
                wf, mask_rows, weight_rows, _key = frames.unpack_payload(
                    header.sig, body)
                wf = wf.to(self.device)
                f_ev, g_ev = self._eval(wf)
                sig, ebody = frames.pack_payload((f_ev, g_ev))
                frames.write_frame(sock, frames.encode_frame(
                    frames.K_EVAL, ebody, client_id=int(self.gids[0]),
                    origin_round=t, sig=sig))
            elif header.kind == frames.K_SIGMA:
                die = self._should_die(t, "uplink")
                self._uplink_round(sock, link, t, wf, header.sigma,
                                   mask_rows, weight_rows, die=die)
                if die:
                    self._die(sock, t)
                    return
            else:
                raise frames.FrameError(
                    f"worker received unexpected "
                    f"{frames.KIND_NAMES.get(header.kind, hex(header.kind))} "
                    f"frame (round {header.origin_round})")

    def _uplink_round(self, sock, link, t, wf, sigma, mask_rows,
                      weight_rows, die: bool = False) -> None:
        lidx = np.flatnonzero(frames.to_numpy(mask_rows) > 0)
        weights = frames.to_numpy(weight_rows)
        # die mid-uplink: ship only the first half of this round's frames,
        # then the caller closes the socket -- the respawned life's replay
        # recomputes byte-identical frames and dedup absorbs the overlap
        send_n = (len(lidx) + 1) // 2 if die else len(lidx)
        if len(lidx):
            sel = torch.as_tensor(lidx, dtype=torch.int64,
                                  device=self.device)
            local_b = select_rows(self.batch_rows, sel)
            e_part = None if self.e_rows is None else \
                self.e_rows.index_select(0, sel)
            sigma_t = torch.tensor(sigma, dtype=torch.float32,
                                   device=self.device)
            msgs, e_stack = self._delta_stage(
                wf, sigma_t, local_b, e_part, t,
                [int(g) for g in self.gids[lidx]])
            if self.e_rows is not None and e_stack is not None:
                self.e_rows.index_copy_(0, sel, e_stack)
            for i, li in enumerate(lidx[:send_n]):
                sig, body = frames.pack_payload(_row(msgs, i))
                link.send(frames.encode_frame(
                    frames.K_UPLINK, body, client_id=int(self.gids[li]),
                    origin_round=t, sigma=float(sigma),
                    weight=float(weights[li]), sig=sig),
                    t, int(self.gids[li]))
        if die:
            return
        # flush unconditionally: chaos-held frames from earlier rounds must
        # release even on rounds where none of this worker's clients sampled
        link.flush(t)
        frames.write_frame(sock, frames.encode_frame(
            frames.K_ROUND_DONE, client_id=int(self.gids[0]),
            origin_round=t))

    def _send_ef(self, sock, t: int) -> None:
        if self.e_rows is None:
            frames.write_frame(sock, frames.encode_frame(
                frames.K_EF_DUMP, client_id=int(self.gids[0]),
                origin_round=t))
            return
        sig, body = frames.pack_payload(self.e_rows)
        frames.write_frame(sock, frames.encode_frame(
            frames.K_EF_DUMP, body, client_id=int(self.gids[0]),
            origin_round=t, sig=sig))


def run_worker(host: str, port: int, problem: str, problem_args: dict,
               fed, workers: int, worker_id: int,
               chaos: Optional[dict] = None,
               chaos_seed: Optional[int] = None,
               heartbeat_s: float = 0.0, device="cuda") -> None:
    """Bootstrap the shared problem on ``device`` (``cuda`` unless the
    caller asks for the CPU), slice this worker's client rows, and run the
    protocol loop against ``host:port``.  Connects under the bounded retry
    schedule (seeded by worker id, so a respawned fleet's reconnects are
    jittered apart)."""
    dev = resolve_device(device)
    params, batches, loss_pair = bootstrap.build_problem(
        problem, dict(problem_args or {}, n_clients=fed.n_clients), dev)
    lo, hi = client_range(fed.n_clients, workers, worker_id)
    batch_rows = rebuild(batches, [x[lo:hi] for x in leaves_of(batches)])
    worker = Worker(params, fed, batch_rows, loss_pair,
                    np.arange(lo, hi), chaos=chaos,
                    chaos_seed=worker_id if chaos_seed is None
                    else chaos_seed,
                    heartbeat_s=heartbeat_s, device=dev)
    del params              # the worker keeps only the model's layout
    sock, _slept = bootstrap.connect_with_retry(host, port, seed=worker_id)
    with sock:
        worker.run(sock)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="repro_torch.wire client "
                                             "worker")
    ap.add_argument("--connect", required=True, metavar="HOST:PORT")
    ap.add_argument("--problem", default="np",
                    help=f"bootstrap problem ({bootstrap.problem_names()})")
    ap.add_argument("--problem-args", default="{}",
                    help="JSON args for the problem builder")
    ap.add_argument("--fed", required=True,
                    help="FedConfig JSON (bootstrap.fed_to_json)")
    ap.add_argument("--workers", type=int, required=True)
    ap.add_argument("--worker-id", type=int, required=True)
    ap.add_argument("--chaos", default=None,
                    help="JSON fault-injection spec (repro_torch.wire."
                         "testing)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="chaos RNG seed (default: worker id; the "
                         "supervisor varies it per respawned life)")
    ap.add_argument("--heartbeat", type=float, default=0.0,
                    help="heartbeat period in seconds (0 disables)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the worker's rounds run (the coordinator's "
                         "device)")
    args = ap.parse_args(argv)
    host, port = args.connect.rsplit(":", 1)
    run_worker(host, int(port), args.problem,
               json.loads(args.problem_args),
               bootstrap.fed_from_json(args.fed),
               args.workers, args.worker_id,
               chaos=json.loads(args.chaos) if args.chaos else None,
               chaos_seed=args.chaos_seed, heartbeat_s=args.heartbeat,
               device=args.device)


if __name__ == "__main__":
    main()
