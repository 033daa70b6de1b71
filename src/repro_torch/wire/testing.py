"""Fault injection for the wire: a chaos layer between a worker's encoded
frames and its socket (port of ``repro.wire.testing``, plain Python, the
same seeded fault schedule).

:class:`ChaosLink` sits on the worker's *uplink* sends (control frames --
hello / eval / round_done -- bypass it, so the round machinery itself
stays alive and every fault is attributable to a payload frame).  Per
frame, a seeded RNG draws one fault:

* ``drop``     -- the frame is never sent (a lost packet / dead client),
* ``dup``      -- the frame is sent twice (a retransmit race; the
  coordinator must dedup by client id + origin round),
* ``truncate`` -- the body is cut short, with the outer length prefix
  kept consistent so the stream never desyncs -- the header still claims
  the full body, so the receiver's decode fails with an actionable
  "truncated frame" error,
* ``corrupt``  -- one body byte is flipped (CRC failure at decode),
* ``delay``    -- the frame is held for ``delay_rounds`` rounds and
  released during a later round's collection window: a genuinely *late*
  frame, which must park in the coordinator's StaleBuffer with its
  origin-round age.

``reorder=True`` additionally shuffles each round's surviving frames
before they hit the socket, forcing arbitrary arrival order.

Beyond per-frame payload faults, the link also models *connection-level*
failure and covers *control/downlink* frames:

* :meth:`ChaosLink.send_now` -- the immediate-send path (control frames,
  coordinator downlink): the same single-fault law, applied at write time
  instead of the round flush,
* ``close_mid_frame`` -- half a frame's bytes then a hard socket close:
  the receiver holds a length prefix whose body never finishes (the
  mid-frame EOF a SIGKILL produces),
* ``stall`` -- the link goes permanently silent with the socket open: the
  wedged-worker signature only a heartbeat timeout can catch.

Everything is deterministic in ``seed`` -- fault patterns are
reproducible, so tests can assert exact counter values.  Worker-life
deaths (``die_round`` / ``die_rate`` / ``die_phase`` / ``die_mode``) are
read by :class:`repro_torch.wire.worker.Worker` itself, and process-level
kills live in :class:`repro_torch.wire.supervisor.ChaosProcess` -- one spec
dict carries all three layers.
"""
from __future__ import annotations

import random
from typing import Optional

from repro_torch.wire import frames


def truncate_frame(frame: bytes, cut: int = 1) -> bytes:
    """Cut ``cut`` bytes off a frame's tail.  The outer length prefix
    (added at send) stays consistent with the shortened bytes, so the
    receiver reads a complete-looking frame whose header claims more body
    than arrived -- decode must reject it as truncated."""
    cut = max(1, min(cut, len(frame) - 1))
    return frame[:-cut]


def corrupt_frame(frame: bytes, pos: Optional[int] = None) -> bytes:
    """Flip one byte in the sig/body region (after the fixed header), so
    lengths stay valid and only the CRC check can catch it.  Frames with
    no bytes past the header get their last header byte (the CRC itself)
    flipped instead."""
    if pos is None:
        pos = frames.HEADER_BYTES if len(frame) > frames.HEADER_BYTES \
            else len(frame) - 1
    pos = min(pos, len(frame) - 1)
    return frame[:pos] + bytes([frame[pos] ^ 0xFF]) + frame[pos + 1:]


class ChaosLink:
    """Wraps a socket's uplink sends with seeded fault injection.

    ``spec`` keys (all optional; probabilities in [0, 1]):

    * ``drop`` / ``dup`` / ``truncate`` / ``corrupt`` / ``delay`` --
      per-frame fault probabilities (drawn in that priority order),
    * ``close_mid_frame`` / ``stall`` -- connection-level faults, drawn
      in the same single draw: half a frame then a hard close, or
      permanent silence with the socket left open,
    * ``delay_rounds`` -- how many rounds a delayed frame is held
      (default 1),
    * ``reorder`` -- bool: shuffle each round's outgoing frames,
    * ``only_client`` -- restrict faults to this client id (other
      clients' frames pass through untouched).

    Counters (``sent`` / ``dropped`` / ``duped`` / ``truncated`` /
    ``corrupted`` / ``delayed`` / ``closed`` / ``stalls``) record what was
    injected, so tests can cross-check the coordinator's observed fault
    statistics against the ground truth."""

    _FAULTS = ("drop", "dup", "truncate", "corrupt", "delay",
               "close_mid_frame", "stall")

    def __init__(self, sock, spec: dict, seed: int = 0):
        self.sock = sock
        self.spec = dict(spec or {})
        self.rng = random.Random(seed)
        self._queue = []        # this round's outgoing frames
        self._held = []         # [(release_round, frame_bytes), ...]
        self.stalled = False    # connection fault fired: link is inert
        self.sent = 0
        self.dropped = 0
        self.duped = 0
        self.truncated = 0
        self.corrupted = 0
        self.delayed = 0
        self.closed = 0
        self.stalls = 0

    def _fault(self) -> Optional[str]:
        u = self.rng.random()
        acc = 0.0
        for name in self._FAULTS:
            acc += float(self.spec.get(name, 0.0))
            if u < acc:
                return name
        return None

    def _pick(self, client_id: int) -> Optional[str]:
        only = self.spec.get("only_client")
        if only is not None and client_id != only:
            return None
        return self._fault()

    def _conn_fault(self, fault: str, frame: bytes) -> None:
        """Fire a connection-level fault; the link is inert afterwards."""
        self.stalled = True
        if fault == "close_mid_frame":
            self.closed += 1
            data = frames._LEN.pack(len(frame)) + frame
            try:
                self.sock.sendall(data[: max(1, len(data) // 2)])
                self.sock.close()
            except OSError:
                pass
        else:
            self.stalls += 1    # socket stays open, nothing more leaves

    def _write(self, frame: bytes) -> None:
        if self.stalled:
            return
        try:
            frames.write_frame(self.sock, frame)
            self.sent += 1
        except OSError:
            self.stalled = True         # peer closed us mid-run

    def send(self, frame: bytes, round_t: int, client_id: int) -> None:
        """Queue one uplink frame, applying at most one fault."""
        if self.stalled:
            return
        fault = self._pick(client_id)
        if fault == "drop":
            self.dropped += 1
            return
        if fault == "dup":
            self.duped += 1
            self._queue.append(frame)
            self._queue.append(frame)
            return
        if fault == "truncate":
            self.truncated += 1
            self._queue.append(truncate_frame(
                frame, cut=1 + self.rng.randrange(4)))
            return
        if fault == "corrupt":
            self.corrupted += 1
            self._queue.append(corrupt_frame(frame))
            return
        if fault == "delay":
            self.delayed += 1
            hold = int(self.spec.get("delay_rounds", 1))
            self._held.append((round_t + hold, frame))
            return
        if fault in ("close_mid_frame", "stall"):
            self._conn_fault(fault, frame)
            return
        self._queue.append(frame)

    def send_now(self, frame: bytes, client_id: int = 0) -> None:
        """The immediate-send path for control and downlink frames: the
        same single-fault law as :meth:`send`, applied at write time (a
        control frame never waits for a round flush, so ``delay`` -- which
        needs the round clock -- degrades to ``drop`` here)."""
        if self.stalled:
            return
        fault = self._pick(client_id)
        if fault in ("drop", "delay"):
            self.dropped += 1
            return
        if fault == "dup":
            self.duped += 1
            self._write(frame)
            self._write(frame)
            return
        if fault == "truncate":
            self.truncated += 1
            self._write(truncate_frame(frame, cut=1 + self.rng.randrange(4)))
            return
        if fault == "corrupt":
            self.corrupted += 1
            self._write(corrupt_frame(frame))
            return
        if fault in ("close_mid_frame", "stall"):
            self._conn_fault(fault, frame)
            return
        self._write(frame)

    def flush(self, round_t: int) -> None:
        """Release this round's queue (shuffled under ``reorder``) plus any
        held frames whose release round has arrived."""
        due = [f for (r, f) in self._held if r <= round_t]
        self._held = [(r, f) for (r, f) in self._held if r > round_t]
        batch = due + self._queue
        self._queue = []
        if self.spec.get("reorder"):
            self.rng.shuffle(batch)
        for frame in batch:
            self._write(frame)

    def drain(self) -> None:
        """Force out everything still held (end of run), so delayed frames
        past the last round are not silently lost by the shim itself."""
        batch = [f for (_, f) in self._held] + self._queue
        self._held, self._queue = [], []
        for frame in batch:
            self._write(frame)


class _DirectLink:
    """The no-chaos link: frames go straight to the socket."""

    def __init__(self, sock):
        self.sock = sock

    def send(self, frame: bytes, round_t: int, client_id: int) -> None:
        frames.write_frame(self.sock, frame)

    def send_now(self, frame: bytes, client_id: int = 0) -> None:
        frames.write_frame(self.sock, frame)

    def flush(self, round_t: int) -> None:
        pass

    def drain(self) -> None:
        pass


def make_link(sock, chaos: Optional[dict], seed: int = 0):
    """A ChaosLink when a chaos spec is given, else the direct link."""
    if chaos:
        return ChaosLink(sock, chaos, seed=seed)
    return _DirectLink(sock)
