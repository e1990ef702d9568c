"""Asyncio HTTP/WebSocket front end over the worker pool — the "host".

The scale-out entry point, the serving analogue of AIA's RISC-V host:
remote callers speak the strict v2 JSON wire schema
(:mod:`repro_torch.serve.protocol`) to a :class:`ServeFrontEnd`, which admits
(or sheds) each query, routes it through the pool's consistent-hash
ring (:mod:`repro_torch.serve.worker`), bridges the worker's thread-side
:class:`repro_torch.serve.query.QueryHandle` onto the event loop, and streams
results back.  Pure stdlib: ``asyncio`` sockets, a minimal HTTP/1.1
parser, and an RFC 6455 WebSocket endpoint — no framework dependency to
gate on.

Endpoints
---------
* ``POST /v2/query`` — one wire request; the response is the wire
  result (or an error body with a non-2xx status).
* ``POST /v2/batch`` — ``{"v": 2, "requests": [...]}``; the whole list
  is routed to ONE worker and admitted atomically in list order
  (:meth:`repro_torch.serve.queue.AdmissionQueue.submit_many`), then flushed —
  which is exactly the in-process ``answer_batch`` grouping, so served
  batch results are bitwise-identical to a same-seed ``answer_batch``.
  Responses come back in request order.
* ``GET /v2/stream`` (WebSocket) — each text frame is one wire request;
  result frames come back in *completion* order carrying the request's
  ``"id"``.  The temporal-filtering client: ``stream_id`` queries stay
  pinned to one worker across frames.
* ``GET /healthz`` — liveness + per-worker up/down.
* ``GET /stats`` — pool stats JSON (engine/plan-cache/queue counters).
* ``GET /metrics`` — Prometheus text: front-end admission metrics plus
  every live worker's engine telemetry.
* ``POST /v2/flush`` — make everything pending dispatchable now.

Load shedding
-------------
Admission control runs *before* a query touches any queue:

* **per-tenant token bucket** (``quota_qps``/``quota_burst``, keyed by
  the request's ``tenant`` field) — over-quota requests get **429**
  with a ``Retry-After`` header telling the client when a token will
  exist.  Shedding at the front door is the overload story: the
  admitted subset keeps bounded latency instead of every caller
  timing out in a collapsing queue.
* **backpressure** (``max_pending``) — a hard cap on queries admitted
  but unresolved across the pool; beyond it requests get **503** +
  ``Retry-After`` regardless of tenant.

Worker death: a query whose worker dies before dispatch
(``WorkerDied.resubmit``) is transparently resubmitted to the next
live worker on the ring; death mid-group fails the request loudly with
a 500 error body naming the worker.
"""
from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import struct
import threading

from repro_torch.serve.protocol import (
    WIRE_VERSION, WireError, error_body, parse_wire_request,
    result_to_wire)
from repro_torch.serve.query import QueryStatus
from repro_torch.serve.sched import TokenBucket
from repro_torch.serve.worker import WorkerDied, WorkerPool

__all__ = ["ServeFrontEnd", "start_in_thread"]

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
_MAX_BODY = 64 << 20        # 64 MiB: MRF masks are big, DoS bodies bigger
_MAX_HEADERS = 100


class _Shed(Exception):
    """Internal: request shed at admission (quota or backpressure)."""

    def __init__(self, code: int, reason: str, retry_after: float):
        super().__init__(reason)
        self.code = code
        self.reason = reason
        self.retry_after = retry_after


class ServeFrontEnd:
    """The serving front end; see the module docstring.

    ``quota_qps=None`` disables per-tenant quotas (every request is
    admitted up to ``max_pending``).  ``port=0`` binds an ephemeral
    port — read it back from :attr:`port` after :meth:`start`.
    """

    def __init__(self, pool: WorkerPool, *, host: str = "127.0.0.1",
                 port: int = 8080, quota_qps: float | None = None,
                 quota_burst: float | None = None, max_pending: int = 256):
        self.pool = pool
        self.host, self._port_arg = host, int(port)
        self.quota_qps = quota_qps
        self.quota_burst = quota_burst if quota_burst is not None else \
            max(1.0, quota_qps or 0.0)
        self.max_pending = int(max_pending)
        self._buckets: dict[str, TokenBucket] = {}
        self._pending = 0
        self.shed = {"quota": 0, "backpressure": 0}
        self.served = 0
        self._server: asyncio.base_events.Server | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._stopping: asyncio.Event | None = None

    # -- lifecycle ---------------------------------------------------------
    @property
    def port(self) -> int:
        if self._server is None:
            return self._port_arg
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stopping = asyncio.Event()
        self._server = await asyncio.start_server(
            self._on_connection, self.host, self._port_arg)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if self._stopping is not None:
            self._stopping.set()

    # -- admission ---------------------------------------------------------
    def _bucket(self, tenant: str) -> TokenBucket:
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = TokenBucket(
                rate=self.quota_qps, burst=self.quota_burst)
        return b

    def _admit(self, query, n: float = 1.0) -> None:
        """Charge admission for ``n`` queries or shed (raises _Shed)."""
        if self._pending + n > self.max_pending:
            self.shed["backpressure"] += int(n)
            raise _Shed(503, "backpressure: too many queries in flight",
                        retry_after=0.5)
        if self.quota_qps is not None:
            tenant = getattr(query, "tenant", None) or "default"
            retry = self._bucket(tenant).try_take(n)
            if retry > 0:
                self.shed["quota"] += int(n)
                raise _Shed(
                    429, f"tenant {tenant!r} is over quota "
                    f"({self.quota_qps}/s)", retry_after=retry)

    # -- handle bridging ---------------------------------------------------
    def _bridge(self, handle) -> asyncio.Future:
        """A thread-side QueryHandle as an awaitable resolving to the
        handle itself once terminal (never raising — the caller reads
        status/error off the handle)."""
        loop = self._loop
        fut = loop.create_future()

        def done(h, fut=fut, loop=loop):
            def resolve():
                if not fut.done():
                    fut.set_result(h)
            try:
                loop.call_soon_threadsafe(resolve)
            except RuntimeError:
                pass  # loop already closed — server shutting down
        handle.add_done_callback(done)
        return fut

    async def _run_query(self, query):
        """Route, submit, await; resubmits across workers while the
        failure says it is safe to.  Returns the terminal handle."""
        exclude: set[str] = set()
        while True:
            worker, handle = self.pool.submit(query, exclude=exclude)
            h = await self._bridge(handle)
            err = h._error
            if (h.status is QueryStatus.FAILED
                    and isinstance(err, WorkerDied) and err.resubmit
                    and len(exclude) + 1 < len(self.pool.workers)):
                exclude.add(worker.name)
                continue
            return h

    @staticmethod
    def _handle_to_wire(h, rid) -> tuple[int, dict]:
        if h.status is QueryStatus.DONE:
            return 200, result_to_wire(h._result, id=rid)
        if h.status is QueryStatus.CANCELLED:
            body = {"error": "query cancelled", "v": WIRE_VERSION}
        else:
            body = error_body(h._error)
        if rid is not None:
            body["id"] = rid
        return 500, body

    async def _serve_one(self, obj) -> tuple[int, dict, dict]:
        try:
            query, rid = parse_wire_request(obj)
            self._admit(query)
        except WireError as exc:
            return exc.code, exc.body, {}
        except _Shed as exc:
            return exc.code, {
                "error": str(exc), "v": WIRE_VERSION,
                "retry_after_s": exc.retry_after,
            }, {"Retry-After": f"{max(exc.retry_after, 0.001):.3f}"}
        self._pending += 1
        try:
            h = await self._run_query(query)
        except (KeyError, ValueError) as exc:
            # the wire schema can't know model internals: an unknown
            # network/node only surfaces when routing normalizes the
            # query against the registry — still the client's fault
            body = error_body(exc)
            if rid is not None:
                body["id"] = rid
            return 400, body, {}
        finally:
            self._pending -= 1
        code, body = self._handle_to_wire(h, rid)
        if code == 200:
            self.served += 1
        return code, body, {}

    async def _serve_batch(self, obj) -> tuple[int, dict, dict]:
        if (not isinstance(obj, dict) or obj.get("v") != WIRE_VERSION
                or not isinstance(obj.get("requests"), list)):
            return 400, {"error": 'batch body must be {"v": 2, '
                         '"requests": [...]}', "v": WIRE_VERSION}, {}
        try:
            parsed = [parse_wire_request(r) for r in obj["requests"]]
        except WireError as exc:
            return exc.code, exc.body, {}
        if not parsed:
            return 200, {"v": WIRE_VERSION, "results": []}, {}
        try:
            self._admit(parsed[0][0], n=len(parsed))
        except _Shed as exc:
            return exc.code, {
                "error": str(exc), "v": WIRE_VERSION,
                "retry_after_s": exc.retry_after,
            }, {"Retry-After": f"{max(exc.retry_after, 0.001):.3f}"}
        self._pending += len(parsed)
        try:
            # one worker, atomic list-order admission, then flush: the
            # bitwise answer_batch-identity contract (module docstring)
            worker = self.pool.worker_for(parsed[0][0])
            handles = worker.queue.submit_many([q for q, _ in parsed])
            worker.queue.flush()
            hs = [await self._bridge(h) for h in handles]
        except (KeyError, ValueError) as exc:
            # unknown network/node surfaced by routing normalization
            return 400, error_body(exc), {}
        finally:
            self._pending -= len(parsed)
        results = []
        for h, (_, rid) in zip(hs, parsed):
            code, body = self._handle_to_wire(h, rid)
            if code == 200:
                self.served += 1
            results.append(body)
        return 200, {"v": WIRE_VERSION, "results": results}, {}

    # -- plain endpoints ---------------------------------------------------
    def _healthz(self) -> tuple[int, dict, dict]:
        up = {n: not w.dead for n, w in self.pool.workers.items()}
        code = 200 if any(up.values()) else 503
        return code, {"ok": any(up.values()), "workers": up,
                      "pending": self._pending}, {}

    def _stats(self) -> tuple[int, dict, dict]:
        return 200, {
            "v": WIRE_VERSION, "pending": self._pending,
            "served": self.served, "shed": dict(self.shed),
            "workers": self.pool.stats()}, {}

    def _metrics_text(self) -> str:
        lines = [
            "# TYPE serve_front_pending gauge",
            f"serve_front_pending {self._pending}",
            "# TYPE serve_front_served_total counter",
            f"serve_front_served_total {self.served}",
            "# TYPE serve_front_shed_total counter",
        ]
        lines += [f'serve_front_shed_total{{reason="{r}"}} {n}'
                  for r, n in sorted(self.shed.items())]
        for w in self.pool.workers.values():
            if not w.dead:
                text = w.engine.telemetry.prometheus()
                if text:
                    lines.append(text.rstrip("\n"))
        return "\n".join(lines) + "\n"

    # -- HTTP plumbing -----------------------------------------------------
    async def _on_connection(self, reader, writer) -> None:
        try:
            while True:
                head = await self._read_head(reader)
                if head is None:
                    break
                method, path, headers = head
                if (path == "/v2/stream"
                        and "websocket" in headers.get(
                            "upgrade", "").lower()):
                    await self._websocket(reader, writer, headers)
                    return
                body = b""
                n = int(headers.get("content-length", 0))
                if n:
                    if n > _MAX_BODY:
                        await self._respond(writer, 413, {
                            "error": "body too large", "v": WIRE_VERSION})
                        break
                    body = await reader.readexactly(n)
                keep = headers.get("connection", "").lower() != "close"
                code, payload, extra = await self._route(
                    method, path, body)
                await self._respond(writer, code, payload, extra,
                                    keep_alive=keep)
                if not keep:
                    break
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _read_head(self, reader):
        line = await reader.readline()
        if not line:
            return None
        try:
            method, path, _version = line.decode("latin1").split()
        except ValueError:
            raise ConnectionError("malformed request line")
        headers: dict[str, str] = {}
        for _ in range(_MAX_HEADERS):
            raw = await reader.readline()
            if raw in (b"\r\n", b"\n", b""):
                break
            name, _, value = raw.decode("latin1").partition(":")
            headers[name.strip().lower()] = value.strip()
        else:
            raise ConnectionError("too many headers")
        return method, path.split("?", 1)[0], headers

    async def _route(self, method: str, path: str,
                     body: bytes) -> tuple[int, object, dict]:
        if path == "/healthz":
            return self._healthz()
        if path == "/stats":
            return self._stats()
        if path == "/metrics":
            return 200, self._metrics_text(), {}
        if method != "POST":
            return 405, {"error": f"{method} {path} not supported",
                         "v": WIRE_VERSION}, {}
        try:
            obj = json.loads(body.decode() or "null")
        except (ValueError, UnicodeDecodeError):
            return 400, {"error": "body is not valid JSON",
                         "v": WIRE_VERSION}, {}
        try:
            if path == "/v2/query":
                return await self._serve_one(obj)
            if path == "/v2/batch":
                return await self._serve_batch(obj)
            if path == "/v2/flush":
                self.pool.flush()
                return 200, {"v": WIRE_VERSION, "flushed": True}, {}
        except Exception as exc:
            # last-resort containment: a handler bug must produce a 500
            # body, never a silently dropped connection
            return 500, error_body(exc), {}
        return 404, {"error": f"no such endpoint {path!r}",
                     "v": WIRE_VERSION}, {}

    async def _respond(self, writer, code: int, payload, extra=None, *,
                       keep_alive: bool = True) -> None:
        if isinstance(payload, str):
            data, ctype = payload.encode(), "text/plain; version=0.0.4"
        else:
            data = json.dumps(payload).encode()
            ctype = "application/json"
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  405: "Method Not Allowed", 413: "Payload Too Large",
                  429: "Too Many Requests", 500: "Internal Server Error",
                  503: "Service Unavailable"}.get(code, "Status")
        head = [f"HTTP/1.1 {code} {reason}",
                f"Content-Type: {ctype}",
                f"Content-Length: {len(data)}",
                f"Connection: {'keep-alive' if keep_alive else 'close'}"]
        head += [f"{k}: {v}" for k, v in (extra or {}).items()]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + data)
        await writer.drain()

    # -- WebSocket (RFC 6455) ----------------------------------------------
    async def _websocket(self, reader, writer, headers) -> None:
        key = headers.get("sec-websocket-key")
        if not key:
            await self._respond(writer, 400, {
                "error": "missing Sec-WebSocket-Key", "v": WIRE_VERSION})
            return
        accept = base64.b64encode(hashlib.sha1(
            (key + _WS_GUID).encode()).digest()).decode()
        writer.write((
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {accept}\r\n\r\n").encode())
        await writer.drain()
        send_lock = asyncio.Lock()
        tasks: set[asyncio.Task] = set()

        async def send_json(obj) -> None:
            async with send_lock:
                await self._ws_send(writer, json.dumps(obj).encode())

        async def serve(obj) -> None:
            try:
                code, body, extra = await self._serve_one(obj)
            except Exception as exc:
                # a handler bug must still answer this frame's id —
                # dropping it would hang the client's collect loop
                code, body, extra = 500, error_body(exc), {}
            if extra.get("Retry-After"):
                body.setdefault("retry_after_s",
                                float(extra["Retry-After"]))
            if isinstance(obj, dict) and "id" in obj:
                body.setdefault("id", obj["id"])
            body.setdefault("status", code)
            await send_json(body)

        try:
            while True:
                frame = await self._ws_recv(reader)
                if frame is None:          # close frame or EOF
                    break
                try:
                    obj = json.loads(frame.decode())
                except (ValueError, UnicodeDecodeError):
                    await send_json({"error": "frame is not valid JSON",
                                     "v": WIRE_VERSION, "status": 400})
                    continue
                t = asyncio.ensure_future(serve(obj))
                tasks.add(t)
                t.add_done_callback(tasks.discard)
            if tasks:                      # drain in-flight before close
                await asyncio.gather(*tasks, return_exceptions=True)
            async with send_lock:
                await self._ws_send(writer, b"", opcode=0x8)
        except (asyncio.IncompleteReadError, ConnectionError):
            for t in tasks:
                t.cancel()

    @staticmethod
    async def _ws_recv(reader) -> bytes | None:
        """One complete message (handles continuation frames); None on
        close/EOF.  Client frames must be masked (RFC 6455 §5.1)."""
        message = b""
        while True:
            try:
                b0, b1 = await reader.readexactly(2)
            except asyncio.IncompleteReadError:
                return None
            opcode, fin = b0 & 0x0F, b0 & 0x80
            masked, length = b1 & 0x80, b1 & 0x7F
            if length == 126:
                (length,) = struct.unpack(
                    ">H", await reader.readexactly(2))
            elif length == 127:
                (length,) = struct.unpack(
                    ">Q", await reader.readexactly(8))
            mask = await reader.readexactly(4) if masked else b""
            payload = await reader.readexactly(length)
            if mask:
                payload = bytes(
                    c ^ mask[i % 4] for i, c in enumerate(payload))
            if opcode == 0x8:              # close
                return None
            if opcode == 0x9:              # ping — unanswered pings are
                continue                   # fine for a localhost client
            message += payload
            if fin:
                return message

    @staticmethod
    async def _ws_send(writer, payload: bytes, *, opcode: int = 0x1) -> None:
        head = bytes([0x80 | opcode])
        n = len(payload)
        if n < 126:
            head += bytes([n])
        elif n < (1 << 16):
            head += bytes([126]) + struct.pack(">H", n)
        else:
            head += bytes([127]) + struct.pack(">Q", n)
        writer.write(head + payload)
        await writer.drain()


def start_in_thread(pool: WorkerPool, **kwargs) -> ServeFrontEnd:
    """Run a :class:`ServeFrontEnd` on a daemon-thread event loop;
    returns once the socket is listening (read :attr:`ServeFrontEnd.
    port` for the bound port).  Stop it with ``fe.stop_thread()``.
    The in-process form used by tests and ``chip_smoke.py`` — the CLI's
    ``--serve`` runs the loop in the main thread instead."""
    fe = ServeFrontEnd(pool, **kwargs)
    started = threading.Event()

    async def main() -> None:
        await fe.start()
        started.set()
        await fe._stopping.wait()
        await fe.stop()

    thread = threading.Thread(
        target=lambda: asyncio.run(main()), name="serve-front-end",
        daemon=True)
    thread.start()
    if not started.wait(timeout=30):
        raise RuntimeError("server failed to start within 30s")

    def stop_thread(timeout: float | None = 30) -> None:
        loop = fe._loop
        if loop is not None and not loop.is_closed():
            try:
                loop.call_soon_threadsafe(fe._stopping.set)
            except RuntimeError:
                pass
        thread.join(timeout)

    fe.stop_thread = stop_thread  # type: ignore[attr-defined]
    return fe
