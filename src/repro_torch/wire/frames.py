"""The framed wire codec: length-prefixed messages over a byte stream (port
of ``repro.wire.frames``, byte for byte).

Layout of one frame on the wire (network byte order throughout)::

    [u32 frame_len] [header 30B] [sig utf-8] [body]

    header = magic u16 | version u8 | kind u8 | client_id u32 |
             origin_round i32 | sigma f32 | weight f32 |
             sig_len u16 | body_len u32 | crc u32

* ``client_id`` / ``origin_round``: which client produced the payload and
  in which round -- the dedup key and the staleness age source of a late
  frame (``age = t_now - origin_round``).
* ``sigma`` / ``weight``: the switch weight and the Horvitz-Thompson
  weight at the origin round, the per-entry metadata of
  :class:`repro_torch.engine.async_rounds.StaleBuffer`.
* ``sig``: the payload's kind and shape signature
  (:func:`payload_signature`); a worker configured differently fails at
  decode, not at reduce.
* ``crc``: CRC-32 (zlib) over ``sig + body``.  Truncated or corrupted
  frames raise :class:`FrameError` naming the failing check; the outer
  length prefix stays authoritative, so one bad frame never
  desynchronizes the stream.

The body is the payload's leaves as raw little-endian bytes in field order
-- for the packed formats of :mod:`repro_torch.comm.payloads` the uint32
words and uint16 offsets exactly as the transport produced them.  Leaves
are torch tensors (any device) or numpy arrays; they cross through numpy,
unsigned tensors through their same-width signed views, and
:func:`unpack_payload` gives tensors on the caller's device.  The same
header fields and payload arrays give the same bytes as the JAX package's
codec, and each package decodes the other's frames.
"""
from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.comm.payloads import FlatPacked, FlatQuant

MAGIC = 0xF5ED                    # "FED" with a twist; rejects non-frames
VERSION = 1
MAX_FRAME = 1 << 30               # 1 GiB sanity bound on frame_len

# frame kinds ---------------------------------------------------------------
K_HELLO = 0x01      # worker -> coord: my contiguous client ids (body: stack)
K_ACTIVATE = 0x02   # coord -> worker: round start (wf, mask, weights, key)
K_EVAL = 0x03       # worker -> coord: per-client (f, g) eval rows
K_SIGMA = 0x04      # coord -> worker: switch weight for this round (header)
K_UPLINK = 0x05     # worker -> coord: ONE client's encoded payload
K_ROUND_DONE = 0x06  # worker -> coord: all uplinks for this round sent
K_EF_REQ = 0x07     # coord -> worker: dump your EF residual rows
K_EF_DUMP = 0x08    # worker -> coord: EF residual rows (body: stack)
K_EF_LOAD = 0x09    # coord -> worker: restore EF residual rows (resume)
K_FINISH = 0x0A     # coord -> worker: run over, dump EF and exit
K_HEARTBEAT = 0x0B  # worker -> coord: liveness beacon (header only)

KIND_NAMES = {
    K_HELLO: "hello", K_ACTIVATE: "activate", K_EVAL: "eval",
    K_SIGMA: "sigma", K_UPLINK: "uplink", K_ROUND_DONE: "round_done",
    K_EF_REQ: "ef_req", K_EF_DUMP: "ef_dump", K_EF_LOAD: "ef_load",
    K_FINISH: "finish", K_HEARTBEAT: "heartbeat",
}

_HEADER = struct.Struct("!HBBIiffHII")
HEADER_BYTES = _HEADER.size

# torch dtype -> numpy dtype of the same bytes (the wire dtypes)
NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
             torch.float16: np.float16, torch.int64: np.int64,
             torch.int32: np.int32, torch.int16: np.int16,
             torch.int8: np.int8, torch.uint8: np.uint8,
             torch.bool: np.bool_, torch.uint16: np.uint16,
             torch.uint32: np.uint32}
# unsigned dtypes -> the signed views they cross numpy through
_SIGNED = {torch.uint16: (torch.int16, np.int16),
           torch.uint32: (torch.int32, np.int32)}
_TORCH_OF_NP = {np.dtype(v): k for k, v in NP_DTYPES.items()}


class FrameError(ValueError):
    """A frame failed a structural check (truncation, CRC, bad magic...).

    The message names the failing check and the offending values."""


class FrameHeader(NamedTuple):
    kind: int
    client_id: int
    origin_round: int
    sigma: float
    weight: float
    sig: str


# ---------------------------------------------------------------------------
# numpy <-> torch, bit for bit
# ---------------------------------------------------------------------------

def to_numpy(leaf) -> np.ndarray:
    """A tensor (any device) or array as a numpy array of the same bytes
    and dtype."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    x = leaf.detach()
    signed = _SIGNED.get(x.dtype)
    if signed is not None:
        return x.view(signed[0]).cpu().numpy().view(NP_DTYPES[x.dtype])
    return x.cpu().numpy()


def to_tensor(arr: np.ndarray, device=None) -> torch.Tensor:
    """A numpy array as a tensor of the same bytes on ``device`` (the CPU
    when None): a copy, never a view of ``arr``'s buffer."""
    dt = _TORCH_OF_NP.get(arr.dtype)
    if dt is None:
        raise FrameError(f"no torch dtype for payload leaf dtype {arr.dtype}")
    signed = _SIGNED.get(dt)
    src = arr if signed is None else arr.view(signed[1])
    t = torch.from_numpy(np.array(src, copy=True))
    if signed is not None:
        t = t.view(dt)
    return t if device is None else t.to(device)


# ---------------------------------------------------------------------------
# Payload (frame body) serialization
# ---------------------------------------------------------------------------
# The signature tags the payload container and each leaf's dtype/shape:
#   flatquant|uint32:138|float32:18       one client's FlatQuant row
#   flatpacked|float32:40|uint16:40       one client's FlatPacked row
#   dense|float32:69                      uncompressed delta row
#   stack|float32:8|float32:8             generic tuple of arrays (control)
# Dims are 'x'-joined (float32:4x8); a 0-d scalar has an empty dim string.

_TAGS = ("flatpacked", "flatquant", "dense", "stack")


def _leaves_and_tag(payload):
    if isinstance(payload, FlatPacked):
        return "flatpacked", list(payload)
    if isinstance(payload, FlatQuant):
        return "flatquant", list(payload)
    if isinstance(payload, (tuple, list)):
        return "stack", list(payload)
    return "dense", [payload]


def _dtype_name(leaf) -> str:
    if isinstance(leaf.dtype, torch.dtype):
        try:
            return np.dtype(NP_DTYPES[leaf.dtype]).name
        except KeyError:
            raise FrameError(f"no wire dtype for {leaf.dtype}") from None
    return np.dtype(leaf.dtype).name


def _leaf_sig(leaf) -> str:
    dims = "x".join(str(int(s)) for s in leaf.shape)
    return f"{_dtype_name(leaf)}:{dims}"


def payload_signature(payload) -> str:
    """Canonical kind/shape signature of a payload (tensors, arrays, or
    ``meta`` tensors of one) -- the frame header's ``sig`` field."""
    tag, leaves = _leaves_and_tag(payload)
    return "|".join([tag] + [_leaf_sig(leaf) for leaf in leaves])


def _parse_sig(sig: str):
    parts = sig.split("|")
    tag = parts[0]
    if tag not in _TAGS:
        raise FrameError(
            f"unknown payload tag {tag!r} in signature {sig!r} "
            f"(expected one of {_TAGS})")
    leaves = []
    for part in parts[1:]:
        try:
            name, dims = part.split(":")
            dtype = np.dtype(name)
            shape = tuple(int(d) for d in dims.split("x")) if dims else ()
        except (ValueError, TypeError) as e:
            raise FrameError(
                f"malformed leaf {part!r} in signature {sig!r}: {e}") from e
        leaves.append((dtype, shape))
    return tag, leaves


def pack_payload(payload) -> tuple[str, bytes]:
    """Serialize a payload to ``(sig, body)``: leaves as raw bytes in field
    order, shapes recorded in the signature."""
    tag, leaves = _leaves_and_tag(payload)
    sig = "|".join([tag] + [_leaf_sig(leaf) for leaf in leaves])
    body = b"".join(
        np.ascontiguousarray(to_numpy(leaf)).tobytes() for leaf in leaves)
    return sig, body


def unpack_payload(sig: str, body: bytes, device=None):
    """Inverse of :func:`pack_payload`: rebuild the payload from its
    signature and body bytes, its leaves tensors on ``device`` (the CPU
    when None), byte for byte what was sent."""
    tag, leaf_sigs = _parse_sig(sig)
    want = sum(dt.itemsize * int(np.prod(shape, dtype=np.int64))
               for dt, shape in leaf_sigs)
    if len(body) != want:
        raise FrameError(
            f"payload body length mismatch for signature {sig!r}: "
            f"expected {want} bytes, got {len(body)} (truncated frame?)")
    arrays, off = [], 0
    for dt, shape in leaf_sigs:
        count = int(np.prod(shape, dtype=np.int64))
        arr = np.frombuffer(body, dtype=dt, count=count,
                            offset=off).reshape(shape)
        arrays.append(to_tensor(arr, device))
        off += dt.itemsize * count
    if tag == "flatpacked":
        if len(arrays) != 2:
            raise FrameError(f"flatpacked payload needs 2 leaves, "
                             f"signature {sig!r} has {len(arrays)}")
        return FlatPacked(*arrays)
    if tag == "flatquant":
        if len(arrays) != 2:
            raise FrameError(f"flatquant payload needs 2 leaves, "
                             f"signature {sig!r} has {len(arrays)}")
        return FlatQuant(*arrays)
    if tag == "dense":
        if len(arrays) != 1:
            raise FrameError(f"dense payload needs 1 leaf, "
                             f"signature {sig!r} has {len(arrays)}")
        return arrays[0]
    return tuple(arrays)


def row_signature(params, cfg) -> str:
    """The payload signature of ONE client's uplink message row under this
    process's transport config -- what every ``K_UPLINK`` frame from a
    correctly configured worker carries.  ``params`` is the parameter tree
    (or its :class:`repro_torch.comm.flat.FlatSpec`); the rows come from
    ``async_rounds.wire_msg_struct`` (the flat wire layout as ``meta``
    tensors), stripped of the leading client axis."""
    from repro_torch.comm import flat
    from repro_torch.engine import async_rounds
    spec = params if isinstance(params, flat.FlatSpec) else \
        flat.spec_of(params)
    msgs = async_rounds.wire_msg_struct(spec, cfg)
    if isinstance(msgs, torch.Tensor):
        return payload_signature(msgs[0])
    return payload_signature(type(msgs)(*(x[0] for x in msgs)))


# ---------------------------------------------------------------------------
# Frame encode / decode
# ---------------------------------------------------------------------------

def _crc(sig_b: bytes, body) -> int:
    """CRC-32 of ``sig_b + body`` without building the concatenation."""
    return zlib.crc32(body, zlib.crc32(sig_b)) & 0xFFFFFFFF


def encode_frame(kind: int, body: bytes = b"", *, client_id: int = 0,
                 origin_round: int = 0, sigma: float = 0.0,
                 weight: float = 0.0, sig: str = "") -> bytes:
    """One frame's bytes (header + sig + body), WITHOUT the outer length
    prefix -- :func:`write_frame` adds it at send time."""
    sig_b = sig.encode("utf-8")
    if len(sig_b) > 0xFFFF:
        raise FrameError(f"payload signature too long ({len(sig_b)} bytes; "
                         "the sig_len field is uint16)")
    header = _HEADER.pack(MAGIC, VERSION, kind, client_id & 0xFFFFFFFF,
                          origin_round, float(sigma), float(weight),
                          len(sig_b), len(body), _crc(sig_b, body))
    return b"".join((header, sig_b, body))


def decode_frame(data: bytes) -> tuple[FrameHeader, bytes]:
    """Parse and validate one frame's bytes.  Raises :class:`FrameError`
    naming the failing check on truncation, bad magic/version, length
    mismatch, or CRC failure."""
    if len(data) < HEADER_BYTES:
        raise FrameError(
            f"truncated frame: {len(data)} bytes is shorter than the "
            f"{HEADER_BYTES}-byte header")
    (magic, version, kind, client_id, origin_round, sigma, weight,
     sig_len, body_len, crc) = _HEADER.unpack_from(data)
    if magic != MAGIC:
        raise FrameError(f"bad magic 0x{magic:04X} (expected 0x{MAGIC:04X}) "
                         "-- not a repro.wire frame, or stream desync")
    if version != VERSION:
        raise FrameError(f"frame version {version} unsupported "
                         f"(this process speaks version {VERSION})")
    want = HEADER_BYTES + sig_len + body_len
    if len(data) < want:
        raise FrameError(
            f"truncated frame: header claims {sig_len}B sig + {body_len}B "
            f"body ({want}B total), got {len(data)}B on the wire")
    if len(data) > want:
        raise FrameError(
            f"oversized frame: header claims {want}B total, got "
            f"{len(data)}B on the wire")
    sig_b = data[HEADER_BYTES:HEADER_BYTES + sig_len]
    body = data[HEADER_BYTES + sig_len:want]
    got_crc = _crc(sig_b, body)
    if got_crc != crc:
        raise FrameError(
            f"CRC mismatch on {KIND_NAMES.get(kind, hex(kind))} frame "
            f"(client {client_id}, round {origin_round}): header says "
            f"0x{crc:08X}, payload hashes to 0x{got_crc:08X} -- frame "
            "corrupted in transit, rejecting")
    try:
        sig = sig_b.decode("utf-8")
    except UnicodeDecodeError as e:
        raise FrameError(f"payload signature is not valid utf-8: {e}") from e
    return FrameHeader(kind, client_id, origin_round, sigma, weight,
                       sig), body


# ---------------------------------------------------------------------------
# Stream I/O
# ---------------------------------------------------------------------------

_LEN = struct.Struct("!I")


def write_frame(sock, frame: bytes) -> int:
    """Send one encoded frame with its length prefix (one ``sendall``, so a
    lock around the socket's ``sendall`` keeps frames whole); returns the
    bytes sent."""
    data = b"".join((_LEN.pack(len(frame)), frame))
    sock.sendall(data)
    return len(data)


def _recv_exact(sock, n: int) -> Optional[bytes]:
    """Read exactly n bytes; None on clean EOF at a frame boundary."""
    chunks, got = [], 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            if got == 0:
                return None
            raise FrameError(
                f"connection closed mid-frame ({got}/{n} bytes read)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(sock) -> Optional[tuple[FrameHeader, bytes, int]]:
    """Blocking read of one frame: ``(header, body, wire_bytes)`` or None on
    clean EOF.  Raises :class:`FrameError` on a malformed frame."""
    raw = _recv_exact(sock, _LEN.size)
    if raw is None:
        return None
    (frame_len,) = _LEN.unpack(raw)
    if frame_len > MAX_FRAME:
        raise FrameError(f"frame length {frame_len} exceeds the "
                         f"{MAX_FRAME}-byte bound (stream desync?)")
    data = _recv_exact(sock, frame_len)
    if data is None:
        raise FrameError("connection closed between length prefix and frame")
    header, body = decode_frame(data)
    return header, body, _LEN.size + frame_len


class FrameReader:
    """Incremental frame extraction over a socket read after ``select``:
    feed raw bytes in, pull complete frames' bytes out.  The coordinator
    keeps one per worker connection, so a slow sender never blocks the
    collection loop; malformed frames surface as :class:`FrameError` from
    the caller's :func:`decode_frame` without desynchronizing the
    stream."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> None:
        self._buf.extend(data)

    def frames(self):
        """Yield the raw bytes of each complete frame buffered so far."""
        while True:
            if len(self._buf) < _LEN.size:
                return
            (frame_len,) = _LEN.unpack_from(self._buf)
            if frame_len > MAX_FRAME:
                raise FrameError(
                    f"frame length {frame_len} exceeds the {MAX_FRAME}-byte "
                    "bound (stream desync?)")
            total = _LEN.size + frame_len
            if len(self._buf) < total:
                return
            with memoryview(self._buf) as mv, mv[_LEN.size:total] as part:
                data = bytes(part)
            del self._buf[:total]
            yield data
