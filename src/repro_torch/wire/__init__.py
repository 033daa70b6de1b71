"""repro_torch.wire -- cross-process federation over real sockets (port of
``repro.wire``).

The engine's rounds (repro_torch.engine) are a single-process program;
this package stretches them across process boundaries without changing
their math: K worker processes (or threads) each own a contiguous client
range, run the SAME stage helpers (``rounds.eval_clients`` /
``rounds.local_deltas`` / ``FlatTransport._ef_clients``) over their rows,
and ship the encoded payloads -- the packed uint32 words and uint16
offsets exactly as the transport produced them -- to a coordinator over
length-prefixed framed TCP.

* ``frames``      -- the framed wire codec, byte for byte the JAX
  package's: header (client id, origin round, sigma, HT weight, payload
  signature, CRC-32) + raw payload bytes; truncation and corruption fail
  loudly, never desynchronize,
* ``worker``      -- the client worker state machine + CLI
  (``python -m repro_torch.wire.worker``),
* ``coordinator`` -- cohort activation, per-round deadline collection,
  dedup, staleness-buffer parking of late frames, the server step ending
  in ``rounds.finish_round``, and checkpoint/restart (:func:`wire_drive`
  is the entry point),
* ``bootstrap``   -- the shared problem registry + FedConfig json codec,
  so coordinator and workers build the same world from CLI arguments,
* ``testing``     -- fault injection (:class:`ChaosLink`:
  drop/dup/truncate/corrupt/delay/reorder frame faults, plus
  connection-level close-mid-frame / stall),
* ``supervisor``  -- the fault-tolerant runtime: :class:`WireFaultConfig`
  (heartbeats, quorum, respawn budget), :class:`Supervisor` (bounded
  worker respawn + EF re-seed + round replay), :class:`ChaosProcess`
  (SIGKILL/SIGSTOP injection).

Entry points (``wire_drive``, ``Coordinator``, ``Worker``, ``run_worker``,
the worker CLI) run on ``cuda`` unless given ``device="cpu"``
(``--device cpu``), and raise without a card.

Parity contract: with no faults, ``wire_drive`` is bit-identical to the
single-process ``rounds.drive`` on the pinned config surface
(:func:`coordinator.validate_wire_cfg`).  Degraded rounds (dead workers'
clients demoted, HT weights rescaled mass-conservingly) are bit-identical
to the same oracle driven with the realized cohort through the ``fixed``
sampler.  ``tests/test_torch_wire.py`` and ``tests/test_torch_wire_faults.py``
hold both lines.
"""
from repro_torch.wire import (bootstrap, coordinator, frames, supervisor,
                              testing, worker)
from repro_torch.wire.bootstrap import (accept_with_retry, backoff_schedule,
                                        build_problem, connect_with_retry,
                                        fed_from_json, fed_to_json, problem,
                                        problem_names)
from repro_torch.wire.coordinator import (Coordinator, WireStats,
                                          validate_wire_cfg, wire_drive)
from repro_torch.wire.frames import (FrameError, FrameHeader, FrameReader,
                                     decode_frame, encode_frame,
                                     pack_payload, payload_signature,
                                     read_frame, row_signature,
                                     unpack_payload, write_frame)
from repro_torch.wire.supervisor import (ChaosProcess, Supervisor,
                                         WireFaultConfig)
from repro_torch.wire.testing import ChaosLink, corrupt_frame, truncate_frame
from repro_torch.wire.worker import Worker, client_range, run_worker

__all__ = [
    "ChaosLink", "ChaosProcess", "Coordinator", "FrameError", "FrameHeader",
    "FrameReader", "Supervisor", "WireFaultConfig", "WireStats", "Worker",
    "accept_with_retry", "backoff_schedule", "bootstrap", "build_problem",
    "client_range", "connect_with_retry", "coordinator", "corrupt_frame",
    "decode_frame", "encode_frame", "fed_from_json", "fed_to_json",
    "frames", "pack_payload", "payload_signature", "problem",
    "problem_names", "read_frame", "row_signature", "run_worker",
    "supervisor", "testing", "truncate_frame", "unpack_payload",
    "validate_wire_cfg", "wire_drive", "worker", "write_frame",
]
