"""Multi-stream tracking service: TCP front-end over the SlotEngine.

Port of ``gstreamer_vit_tracker_tpu/serve/server.py``.  Concurrency model
(one box, one card, S slots):

* one handler thread per client connection (blocking request/response:
  a client never has two in-flight requests, so its slot's frame buffer
  row is never written while a tick that counts it reads it);
* ONE tick thread owns the engine: it waits for pending updates,
  lingers ``batch_window_ms`` so concurrent streams coalesce into the
  same batched step, then enqueues one step and hands the unread result
  to a pool of ``pipeline_depth`` fetch threads, which fan the packed
  rows back out.  More concurrent clients therefore means better device
  efficiency, the inverse of a lock-per-request design.

On the card the frame buffers are pinned host memory, so a tick's upload
of all S frames is one asynchronous copy per plane.

Fault story: a step that throws (device loss) triggers
``engine.recover()``; waiting clients get ``{"ok": false}`` with a
re-init-required flag when their slot postdates the last snapshot.
"""

from __future__ import annotations

import queue
import socket
import sys
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import protocol
from .engine import SlotEngine


class _Waiter:
    __slots__ = ("event", "result", "error")

    def __init__(self):
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[str] = None


class TrackServer:
    """Serve ``engine`` on a TCP socket (loopback by default)."""

    def __init__(self, engine: SlotEngine, height: int, width: int,
                 host: str = "127.0.0.1", port: int = 0,
                 batch_window_ms: float = 2.0,
                 update_timeout_s: float = 60.0,
                 pipeline_depth: int = 2):
        self.engine = engine
        self.h, self.w = height, width
        self.batch_window_s = batch_window_ms / 1000.0
        self.update_timeout_s = update_timeout_s
        # How many enqueued-but-unread ticks may be outstanding.  At
        # depth >= 2 the read of tick N's packed result overlaps tick
        # N+1's enqueue and device step instead of serialising; depth 1 is
        # strictly synchronous.
        self.pipeline_depth = max(1, int(pipeline_depth))
        # Wire-protocol body bound derived from the ACTUAL frame geometry
        # (one frame payload + generous JSON-header slack) — a malformed
        # length prefix is rejected before any allocation (protocol.recv_msg)
        # instead of trusting the permissive module-level MAX_BODY.
        self.max_body = protocol.frame_nbytes(
            engine.frame_format, height, width) + 4096

        # One (S, ...) buffer per plane of the engine's format, pinned on
        # the card path so the tick's upload is asynchronous.  Handlers
        # write rows through the numpy views; the engine reads the tensors.
        s = engine.slots
        pin = engine.device.type == "cuda"
        shapes = {"nv12": ((s, height, width),
                           (s, height // 2, width // 2, 2)),
                  "yuy2": ((s, height, width * 2),),
                  "rgb": ((s, height, width, 3),)}[engine.frame_format]
        self._buf = tuple(
            torch.zeros(shape, dtype=torch.uint8, pin_memory=pin)
            for shape in shapes)
        self._rows = tuple(t.numpy() for t in self._buf)

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: Dict[int, _Waiter] = {}
        self._dead_slots: set = set()   # lost in a recovery; need re-init
        self._running = False
        self._ticks = 0
        self._faults = 0
        self._t0 = time.monotonic()

        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()[:2]
        self._threads: list = []

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._running = True
        # Bounded handoff queue: the tick thread blocks on put() once
        # pipeline_depth ticks are dispatched-but-unfetched, so the state
        # chain never runs unboundedly ahead of the fetches.
        self._fetch_q: "queue.Queue" = queue.Queue(maxsize=self.pipeline_depth)
        targets = [self._accept_loop, self._tick_loop]
        targets += [self._fetch_loop] * self.pipeline_depth
        for target in targets:
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        with self._cond:
            self._running = False
            self._cond.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass

    def serve_forever(self) -> None:
        self.start()
        try:
            while self._running:
                time.sleep(0.5)
        except KeyboardInterrupt:
            self.stop()

    # -- accept/handler threads ----------------------------------------------

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _handle(self, conn: socket.socket) -> None:
        owned: set = set()
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while self._running:
                try:
                    header, payload = protocol.recv_msg(conn,
                                                        max_body=self.max_body)
                except (ConnectionError, OSError):
                    return
                except ValueError as e:
                    # Protocol violation (garbage length prefix, non-JSON
                    # header): log it and drop THIS connection; other
                    # clients' handler threads are unaffected.
                    print(f"[serve] protocol violation, closing connection: "
                          f"{e}", file=sys.stderr)
                    return
                reply, rpayload = self._dispatch(header, payload, owned)
                try:
                    protocol.send_msg(conn, reply, rpayload)
                except OSError:
                    return
        finally:
            # A dropped client frees its slots: slot leaks would otherwise
            # exhaust the pool (the engine's state rows are simply masked
            # until the slot is re-allocated).
            with self.engine.lock:
                for s in owned:
                    self.engine.release(s)
            try:
                conn.close()
            except OSError:
                pass

    # -- request dispatch ------------------------------------------------------

    def _dispatch(self, header: Dict, payload: bytes, owned: set):
        op = header.get("op")
        try:
            if op == "hello":
                e = self.engine
                return {"ok": True, "format": e.frame_format,
                        "height": self.h, "width": self.w,
                        "slots": e.slots,
                        "free": int((~e.occupied).sum()),
                        "frame_nbytes": protocol.frame_nbytes(
                            e.frame_format, self.h, self.w)}, b""
            if op == "init":
                return self._op_init(header, payload, owned)
            if op == "update":
                return self._op_update(header, payload, owned)
            if op == "release":
                slot = int(header["slot"])
                if slot not in owned:
                    return {"ok": False, "error": "slot not owned"}, b""
                with self.engine.lock:
                    self.engine.release(slot)
                owned.discard(slot)
                self._dead_slots.discard(slot)
                return {"ok": True}, b""
            if op == "stats":
                return {"ok": True, "ticks": self._ticks,
                        "faults": self._faults,
                        "active": int(self.engine.occupied.sum()),
                        "uptime_s": round(time.monotonic() - self._t0, 3)}, b""
            return {"ok": False, "error": f"unknown op {op!r}"}, b""
        except Exception as e:     # noqa: BLE001 — protocol boundary: any
            # bad request (wrong payload size, bogus bbox) must become a
            # structured error, not a dead handler thread.
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}, b""

    def _op_init(self, header: Dict, payload: bytes, owned: set):
        frame = protocol.frame_from_bytes(self.engine.frame_format, self.h,
                                          self.w, payload)
        bbox = [float(v) for v in header["bbox"]]
        if len(bbox) != 4 or bbox[2] <= 0 or bbox[3] <= 0:
            return {"ok": False, "error": f"bad bbox {bbox}"}, b""
        with self.engine.lock:
            slot = self.engine.alloc()
            try:
                self._write_frame(slot, frame)
                self.engine.init_slot(
                    slot, tuple(t[slot] for t in self._buf), bbox)
            except Exception:
                self.engine.release(slot)
                raise
        owned.add(slot)
        self._dead_slots.discard(slot)
        return {"ok": True, "slot": slot}, b""

    def _op_update(self, header: Dict, payload: bytes, owned: set):
        slot = int(header["slot"])
        if slot not in owned:
            return {"ok": False, "error": "slot not owned"}, b""
        if slot in self._dead_slots:
            return {"ok": False, "error": "slot lost in recovery",
                    "reinit": True}, b""
        frame = protocol.frame_from_bytes(self.engine.frame_format, self.h,
                                          self.w, payload)
        waiter = _Waiter()
        with self._cond:
            self._write_frame(slot, frame)
            self._pending[slot] = waiter
            self._cond.notify()
        if not waiter.event.wait(self.update_timeout_s):
            return {"ok": False, "error": "tick timeout"}, b""
        if waiter.error is not None:
            return {"ok": False, "error": waiter.error,
                    "reinit": slot in self._dead_slots}, b""
        x, y, w, h, score = (float(v) for v in waiter.result)
        return {"ok": True, "bbox": [x, y, w, h], "score": score}, b""

    def _write_frame(self, slot: int, frame) -> None:
        planes = frame if isinstance(frame, tuple) else (frame,)
        for rows, plane in zip(self._rows, planes):
            rows[slot] = plane

    # -- the batching tick -------------------------------------------------------
    #
    # The tick thread only ENQUEUES the step (engine.step_async) and hands
    # the (batch, unread PackedTick) pair to a pool of fetcher threads; the
    # read of the packed result overlaps the next tick's collect, enqueue
    # and device step instead of serialising with it.  Result contract:
    # every waiter still receives the packed row computed FROM ITS OWN
    # FRAME (never a stale tick's); only the delivery overlaps later
    # ticks' device work.

    def _tick_loop(self) -> None:
        while True:
            with self._cond:
                while self._running and not self._pending:
                    self._cond.wait(0.25)
                if not self._running:
                    for w in self._pending.values():
                        w.error = "server stopping"
                        w.event.set()
                    self._pending.clear()
                    for _ in range(self.pipeline_depth):
                        self._fetch_q.put(None)   # release fetcher threads
                    return
            # Linger so concurrent streams coalesce into one batched step —
            # unless every occupied slot has already reported.
            deadline = time.monotonic() + self.batch_window_s
            while time.monotonic() < deadline:
                with self._lock:
                    if len(self._pending) >= int(self.engine.occupied.sum()):
                        break
                time.sleep(0.0005)
            with self._lock:
                batch = dict(self._pending)
                self._pending.clear()
                tick_active = np.zeros(self.engine.slots, bool)
                tick_active[list(batch)] = True
            try:
                with self.engine.lock:
                    packed_dev = self.engine.step_async(self._buf, tick_active)
                self._ticks += 1
            except Exception as e:   # noqa: BLE001 — dispatch-time fault
                self._fault(batch, e)
                continue
            # Blocks once pipeline_depth ticks are outstanding: bounded
            # staleness.
            self._fetch_q.put((batch, packed_dev))

    def _fetch_loop(self) -> None:
        while True:
            item = self._fetch_q.get()
            if item is None:
                return
            batch, packed_dev = item
            try:
                packed = np.asarray(packed_dev)
            except Exception as e:   # noqa: BLE001 — device fault
                self._fault(batch, e)
                continue
            for slot, w in batch.items():
                w.result = packed[slot]
                w.event.set()

    def _fault(self, batch, e: Exception) -> None:
        """Device fault on an enqueue or a fetch: recover the engine,
        fail this tick's waiters cleanly.  With several ticks in flight
        each failed fetch lands here; recover() is idempotent (params from
        the host master, state from the last snapshot) and lost-slot
        accounting only marks slots on their first loss."""
        self._faults += 1
        with self.engine.lock:
            lost = self.engine.recover()
        self._dead_slots.update(lost)
        for slot, w in batch.items():
            w.error = f"device fault: {type(e).__name__}"
            w.event.set()
