"""Length-prefixed JSON framing over local sockets.

Port of ``dlaf_tpu/fleet/transport.py``, byte for byte the same frames:
each message is a 4-byte big-endian unsigned length followed by that many
bytes of UTF-8 JSON (``json.dumps`` with its default separators). JSON,
not pickle: no code crosses the process boundary. Framing makes a torn
message impossible: a frame arrives whole or the connection is dead.
Arrays ride inside the JSON through the serve wire codec
(:func:`dlaf_tpu_torch.serve.queue.array_to_wire`); this module only moves
bytes.

Failures: EOF, mid-frame or on a frame boundary, raises
:class:`TransportClosed` (the router's fast worker-death signal); a socket
timeout BETWEEN frames raises :class:`TransportIdle` (the worker loop's
tick to check its drain flag), while a timeout mid-frame keeps reading:
the peer writes frames whole, so a half-received frame means bytes in
flight, not bytes lost.
"""

from __future__ import annotations

import json
import socket
import struct

#: Hard per-frame bound. A longer frame is a protocol error (a corrupt
#: stream or the wrong peer), not a big request.
MAX_FRAME_BYTES = 256 << 20

_LEN = struct.Struct(">I")


class TransportClosed(ConnectionError):
    """The peer closed the connection (EOF), at a frame boundary or
    mid-frame. The router treats either as worker death."""


class TransportIdle(TimeoutError):
    """No frame STARTED within the socket timeout. Nothing was consumed;
    the stream is intact: check your flags and call recv again."""


def _recv_exact(sock: socket.socket, n: int, *, idle_ok: bool) -> bytes:
    """Read exactly ``n`` bytes. ``idle_ok`` governs only the first byte:
    a timeout with nothing read raises :class:`TransportIdle`; once a byte
    arrived, timeouts keep reading (dropping a partial frame would
    desynchronise the framing for good)."""
    chunks = []
    got = 0
    while got < n:
        try:
            chunk = sock.recv(n - got)
        except socket.timeout:
            if idle_ok and got == 0:
                raise TransportIdle("no frame within the socket timeout")
            continue
        if not chunk:
            raise TransportClosed(f"peer closed the connection ({got}/{n} bytes of the "
                                  "current read)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_msg(sock: socket.socket, obj: dict) -> None:
    """Frame and send one JSON message (whole from the reader's view: one
    ``sendall`` of length and payload)."""
    payload = json.dumps(obj).encode("utf-8")
    if len(payload) > MAX_FRAME_BYTES:
        raise ValueError(f"fleet frame of {len(payload)} bytes exceeds "
                         f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def recv_msg(sock: socket.socket, *, idle_ok: bool = False) -> dict:
    """Receive one framed JSON message (module docstring for the
    :class:`TransportClosed` / :class:`TransportIdle` split)."""
    (length,) = _LEN.unpack(_recv_exact(sock, _LEN.size, idle_ok=idle_ok))
    if length > MAX_FRAME_BYTES:
        raise TransportClosed(f"frame length {length} exceeds MAX_FRAME_BYTES="
                              f"{MAX_FRAME_BYTES} — corrupt stream or wrong peer")
    return json.loads(_recv_exact(sock, length, idle_ok=False).decode("utf-8"))
