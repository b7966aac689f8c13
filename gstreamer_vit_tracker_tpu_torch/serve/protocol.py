"""Wire protocol for the multi-stream tracking service.

Dependency-free length-prefixed framing over a stream socket:

    message := u32-LE body_len | body
    body    := json_header utf-8 | b"\\n" | raw_payload

The JSON header carries the op and its small fields; the payload carries
raw frame bytes (the hot data never round-trips through JSON).  Frame
byte layouts match the package's array conventions (ops/preprocess.py):

    nv12 : H*W luma bytes, then (H/2)*(W/2)*2 interleaved UV bytes
    yuy2 : H * (W*2) packed bytes (Y0 U Y1 V)
    rgb  : H*W*3 interleaved bytes

This is the port's own copy of
``gstreamer_vit_tracker_tpu/serve/protocol.py`` (numpy and sockets only),
held equal to the original by ``tests/test_torch_weights.py``: a client of
either package talks to a server of the other.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Dict, Tuple

import numpy as np

MAX_BODY = 64 * 1024 * 1024   # one 4K RGB frame is ~24 MB; 64 MB is ample

FORMATS = ("nv12", "yuy2", "rgb")


def frame_nbytes(fmt: str, h: int, w: int) -> int:
    if fmt == "nv12":
        return h * w + (h // 2) * (w // 2) * 2
    if fmt == "yuy2":
        return h * w * 2
    if fmt == "rgb":
        return h * w * 3
    raise ValueError(f"unknown frame format {fmt!r}")


def frame_to_bytes(fmt: str, frame) -> bytes:
    """Serialise a frame in the package's array convention to payload bytes."""
    if fmt == "nv12":
        y, uv = frame
        return (np.ascontiguousarray(y, np.uint8).tobytes()
                + np.ascontiguousarray(uv, np.uint8).tobytes())
    return np.ascontiguousarray(frame, np.uint8).tobytes()


def frame_from_bytes(fmt: str, h: int, w: int, payload: bytes):
    """Payload bytes -> numpy frame (tuple of planes for nv12)."""
    want = frame_nbytes(fmt, h, w)
    if len(payload) != want:
        raise ValueError(
            f"frame payload is {len(payload)} bytes, expected {want} "
            f"for {fmt} {w}x{h}")
    buf = np.frombuffer(payload, np.uint8)
    if fmt == "nv12":
        y = buf[:h * w].reshape(h, w)
        uv = buf[h * w:].reshape(h // 2, w // 2, 2)
        return y, uv
    if fmt == "yuy2":
        return buf.reshape(h, w * 2)
    return buf.reshape(h, w, 3)


def send_msg(sock: socket.socket, header: Dict, payload: bytes = b"") -> None:
    head = json.dumps(header, separators=(",", ":")).encode()
    body_len = len(head) + 1 + len(payload)
    if body_len > MAX_BODY:
        raise ValueError(f"message body {body_len} exceeds MAX_BODY")
    # One sendall of the small parts, then the payload: avoids concatenating
    # a multi-MB frame into a fresh buffer per message.
    sock.sendall(struct.pack("<I", body_len) + head + b"\n")
    if payload:
        sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_msg(sock: socket.socket,
             max_body: int = MAX_BODY) -> Tuple[Dict, bytes]:
    """Receive one framed message.

    ``max_body`` bounds the declared body length BEFORE any allocation: a
    garbage 4-byte header from a buggy/hostile client raises ValueError
    immediately instead of triggering a multi-GB read.  Servers should pass
    a bound derived from their actual frame geometry (TrackServer does:
    frame_nbytes + header slack), not the permissive module default.
    A body with no header/payload separator or a non-JSON header also
    raises ValueError — callers treat any ValueError as a protocol
    violation and close the connection.
    """
    raw = _recv_exact(sock, 4)
    (body_len,) = struct.unpack("<I", raw)
    if body_len > min(max_body, MAX_BODY):
        raise ValueError(
            f"declared message body {body_len} exceeds limit "
            f"{min(max_body, MAX_BODY)}")
    body = _recv_exact(sock, body_len)
    sep = body.find(b"\n")
    if sep < 0:
        raise ValueError("malformed message: no header separator")
    try:
        header = json.loads(body[:sep].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"malformed message header: {e}") from e
    if not isinstance(header, dict):
        raise ValueError("malformed message header: not a JSON object")
    return header, body[sep + 1:]
