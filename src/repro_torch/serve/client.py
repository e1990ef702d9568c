"""Stdlib client for the serving front end (tests, smoke script, CLI).

:class:`ServeClient` speaks the strict v2 wire schema to a
:class:`repro_torch.serve.server.ServeFrontEnd` over plain ``http.client``
plus a minimal RFC 6455 WebSocket (raw socket) for ``/v2/stream`` —
the replay side of ``--stream`` traffic and of ``chip_smoke.py``'s
wire phase.  Responses come back as plain JSON dicts; :class:`ServeHTTPError`
carries shed/validation error bodies (status, ``Retry-After``).
"""
from __future__ import annotations

import base64
import http.client
import json
import os
import select
import socket
import struct
import time

from repro_torch.serve.protocol import request_to_wire

__all__ = ["ServeClient", "ServeHTTPError"]


class ServeHTTPError(RuntimeError):
    """Non-2xx response; carries the status, parsed error body, and the
    ``Retry-After`` hint (seconds, None if absent)."""

    def __init__(self, status: int, body: dict,
                 retry_after: float | None = None):
        super().__init__(
            f"HTTP {status}: {body.get('error', body)}")
        self.status = int(status)
        self.body = body
        self.retry_after = retry_after


class ServeClient:
    """Synchronous client; one instance per thread.

    ``query``/``query_batch`` accept either wire dicts or
    :class:`repro_torch.serve.query.Request` objects (encoded via
    :func:`repro_torch.serve.protocol.request_to_wire`).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 8080, *,
                 timeout: float = 300.0):
        self.host, self.port = host, int(port)
        self.timeout = timeout

    # -- plumbing ----------------------------------------------------------
    def _request(self, method: str, path: str, obj=None):
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout)
        try:
            body = None if obj is None else json.dumps(obj)
            conn.request(method, path, body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            raw = resp.read()
            if resp.getheader("Content-Type", "").startswith(
                    "application/json"):
                payload = json.loads(raw.decode())
            else:
                payload = raw.decode()
            if resp.status >= 400:
                ra = resp.getheader("Retry-After")
                raise ServeHTTPError(
                    resp.status,
                    payload if isinstance(payload, dict)
                    else {"error": payload},
                    retry_after=None if ra is None else float(ra))
            return payload
        finally:
            conn.close()

    @staticmethod
    def _wire(req) -> dict:
        return req if isinstance(req, dict) else request_to_wire(req)

    def wait_ready(self, timeout: float = 60.0) -> dict:
        """Poll ``/healthz`` until the server answers (connection
        retries swallowed) — the startup handshake for a server started
        in another process."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                return self.healthz()
            except (ConnectionError, OSError, ServeHTTPError):
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.1)

    # -- endpoints ---------------------------------------------------------
    def query(self, req) -> dict:
        return self._request("POST", "/v2/query", self._wire(req))

    def query_batch(self, reqs) -> list[dict]:
        out = self._request("POST", "/v2/batch", {
            "v": 2, "requests": [self._wire(r) for r in reqs]})
        return out["results"]

    def flush(self) -> dict:
        return self._request("POST", "/v2/flush", {})

    def healthz(self) -> dict:
        return self._request("GET", "/healthz")

    def stats(self) -> dict:
        return self._request("GET", "/stats")

    def metrics(self) -> str:
        return self._request("GET", "/metrics")

    # -- WebSocket streaming ----------------------------------------------
    def stream(self, reqs, arrivals=None, *,
               timeout: float | None = None) -> list[dict]:
        """Replay ``reqs`` over one ``/v2/stream`` WebSocket — open-loop
        at ``arrivals`` offsets (seconds, monotone) when given, as fast
        as possible otherwise — then collect every response.  Requests
        are tagged with sequential ``"id"``s; the returned list is in
        *request* order (responses arrive in completion order and are
        re-sorted by id)."""
        wires = [dict(self._wire(r)) for r in reqs]
        for i, w in enumerate(wires):
            w.setdefault("id", i)
        sock = socket.create_connection(
            (self.host, self.port), timeout=timeout or self.timeout)
        try:
            self._ws_handshake(sock)
            responses: dict[object, dict] = {}
            t0 = time.monotonic()
            for i, w in enumerate(wires):
                if arrivals is not None:
                    delay = t0 + arrivals[i] - time.monotonic()
                    while delay > 0:
                        # drain early completions while we wait
                        got = self._ws_poll(sock, min(delay, 0.05))
                        if got is not None:
                            responses[got.get("id")] = got
                        delay = t0 + arrivals[i] - time.monotonic()
                self._ws_send(sock, json.dumps(w).encode())
            while len(responses) < len(wires):
                got = self._ws_recv_json(sock)
                if got is None:
                    raise ConnectionError(
                        f"stream closed with {len(wires) - len(responses)}"
                        " responses outstanding")
                responses[got.get("id")] = got
            self._ws_send(sock, b"", opcode=0x8)
            return [responses[w["id"]] for w in wires]
        finally:
            sock.close()

    def _ws_handshake(self, sock) -> None:
        key = base64.b64encode(os.urandom(16)).decode()
        sock.sendall((
            f"GET /v2/stream HTTP/1.1\r\nHost: {self.host}:{self.port}\r\n"
            "Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = sock.recv(4096)
            if not chunk:
                raise ConnectionError("server closed during WS handshake")
            buf += chunk
        status = buf.split(b"\r\n", 1)[0]
        if b"101" not in status:
            raise ConnectionError(f"WS handshake refused: {status!r}")

    @staticmethod
    def _ws_send(sock, payload: bytes, *, opcode: int = 0x1) -> None:
        # client->server frames must be masked (RFC 6455 §5.1)
        mask = os.urandom(4)
        head = bytes([0x80 | opcode])
        n = len(payload)
        if n < 126:
            head += bytes([0x80 | n])
        elif n < (1 << 16):
            head += bytes([0x80 | 126]) + struct.pack(">H", n)
        else:
            head += bytes([0x80 | 127]) + struct.pack(">Q", n)
        body = bytes(c ^ mask[i % 4] for i, c in enumerate(payload))
        sock.sendall(head + mask + body)

    @staticmethod
    def _read_exact(sock, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed mid-frame")
            buf += chunk
        return buf

    def _ws_recv_json(self, sock) -> dict | None:
        """One server message as JSON; None on close frame."""
        message = b""
        while True:
            b0, b1 = self._read_exact(sock, 2)
            opcode, fin = b0 & 0x0F, b0 & 0x80
            length = b1 & 0x7F
            if length == 126:
                (length,) = struct.unpack(">H", self._read_exact(sock, 2))
            elif length == 127:
                (length,) = struct.unpack(">Q", self._read_exact(sock, 8))
            payload = self._read_exact(sock, length)
            if opcode == 0x8:
                return None
            if opcode in (0x9, 0xA):       # ping/pong — ignore
                continue
            message += payload
            if fin:
                return json.loads(message.decode())

    def _ws_poll(self, sock, timeout: float) -> dict | None:
        """A response if one arrives within ``timeout``, else None.
        Readability is tested with ``select`` so an empty wait never
        leaves the stream desynced mid-frame."""
        readable, _, _ = select.select([sock], [], [], max(timeout, 0.0))
        if not readable:
            return None
        return self._ws_recv_json(sock)
