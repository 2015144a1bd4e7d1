"""Optional stdlib HTTP adapter over :class:`ScenarioServer` (port of
``repro.serve.httpd``).

Transport is in-process first (DESIGN.md §12): this module is a thin
JSON shim for clients that cannot import the package — it owns no
scheduling state and every route delegates to the same server object the
in-process handle uses. Enabled behind the ``repro_torch.launch.serve --http`` flag.

Routes (all JSON):

* ``POST /submit``  — one request object or a list; replies with ids
* ``POST /drain``   — run the scheduler until the queue is empty
* ``POST /step``    — run exactly one batch
* ``POST /ack?id=<rid>``       — release one retained response
* ``GET /response?id=<rid>``   — the response for one request
* ``GET /progress?id=<rid>``   — per-chunk progress events
* ``GET /accounting``          — serving counters
* ``GET /healthz``             — liveness
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

from .server import ScenarioServer

__all__ = ["serve_http"]


def _json_default(o):
    import numpy as np
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.integer, np.floating, np.bool_)):
        return o.item()
    raise TypeError(f"not JSON serializable: {type(o).__name__}")


def _make_handler(server: ScenarioServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):   # quiet by default
            pass

        def _reply(self, code: int, payload) -> None:
            body = json.dumps(payload, default=_json_default).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"null")

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/healthz":
                return self._reply(200, {"ok": True})
            if url.path == "/accounting":
                return self._reply(200, server.accounting())
            rid = parse_qs(url.query).get("id", [""])[0]
            if url.path == "/response":
                resp = server.response(rid)
                if resp is None:
                    return self._reply(404, {"error": f"no response for "
                                                      f"id {rid!r}"})
                return self._reply(200, resp.to_wire())
            if url.path == "/progress":
                return self._reply(200, {"id": rid,
                                         "events": server.progress(rid)})
            return self._reply(404, {"error": f"unknown path {url.path}"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path == "/ack":
                rid = parse_qs(url.query).get("id", [""])[0]
                resp = server.ack(rid)
                if resp is None:
                    return self._reply(404, {"error": f"no response for "
                                                      f"id {rid!r}"})
                return self._reply(200, resp.to_wire())
            if self.path == "/submit":
                try:
                    payload = self._read_json()
                except (ValueError, json.JSONDecodeError) as e:
                    return self._reply(400, {"error": str(e)})
                reqs = payload if isinstance(payload, list) else [payload]
                ids = [server.submit(r) for r in reqs]
                return self._reply(200, {"ids": ids})
            if self.path == "/drain":
                return self._reply(200, {"answered": server.drain()})
            if self.path == "/step":
                return self._reply(200, {"answered": server.step()})
            return self._reply(404, {"error": f"unknown path {self.path}"})

    return Handler


def serve_http(server: ScenarioServer, host: str = "127.0.0.1",
               port: int = 0, *, background: bool = False
               ) -> Tuple[ThreadingHTTPServer, Optional[threading.Thread]]:
    """Bind the HTTP adapter; ``port=0`` picks a free port (read it back
    from ``httpd.server_address``). With ``background=True`` the accept
    loop runs on a daemon thread and the pair ``(httpd, thread)`` is
    returned immediately — call ``httpd.shutdown()`` to stop."""
    httpd = ThreadingHTTPServer((host, port), _make_handler(server))
    if not background:
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
        return httpd, None
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread
