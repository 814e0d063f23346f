"""Minimal HTTP front end for `SamplerService` (stdlib and numpy only, as
the JAX package's nicediffusion_tpu/serving/http.py, of which this is a copy).

Endpoints:

  GET  /healthz   -> {"ok": true, "warm": bool}
  GET  /stats     -> SamplerService.stats()
  POST /sample    body {"labels": [int, ...]?, "n": int?, "seed": int?,
                        "encoding": "b64npz" | "list"}
                  -> {"shape": [n, H, W, C],
                      "images": base64(npz{images}) | nested lists}

Images are float32 in [-1, 1] (the model's native output range); clients
rescale to pixels as (x + 1) * 127.5, the sampling entry point's convention
(scripts/sample.py).

The handler threads only enqueue into the service and block on the Future;
device work stays on the service's single worker thread.

One difference from the JAX package's front end: the listening socket's
backlog is ``socket.SOMAXCONN``, not socketserver's default of 5. With 5, a
burst of more concurrent connections than that (64 closed-loop clients of a
serve batch of 64) overflows the accept queue, the kernel drops the SYNs and
the clients retry a second or more later, so the batches go out a third
full (PERF.md, "The serving daemon").
"""

from __future__ import annotations

import base64
import io
import json
import socket
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

__all__ = ["make_server", "serve_forever", "decode_images"]


def _encode(images: np.ndarray, encoding: str):
    if encoding == "list":
        return images.tolist()
    if encoding == "b64npz":
        buf = io.BytesIO()
        np.savez_compressed(buf, images=images)
        return base64.b64encode(buf.getvalue()).decode("ascii")
    raise ValueError(f"unknown encoding {encoding!r}")


def decode_images(payload: dict) -> np.ndarray:
    """Client-side helper: invert the /sample response encoding."""
    images = payload["images"]
    if isinstance(images, str):
        buf = io.BytesIO(base64.b64decode(images))
        return np.load(buf)["images"]
    return np.asarray(images, dtype=np.float32)


class _Handler(BaseHTTPRequestHandler):
    service = None  # set by make_server
    request_timeout: float | None = None

    # silence per-request stderr logging (the daemon reports through
    # /stats, not access lines)
    def log_message(self, *args):
        pass

    def _reply(self, code: int, obj: dict):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._reply(200, {"ok": True, "warm": self.service.stats()["warm"]})
        elif self.path == "/stats":
            self._reply(200, self.service.stats())
        else:
            self._reply(404, {"error": f"no such path {self.path}"})

    def do_POST(self):
        if self.path != "/sample":
            self._reply(404, {"error": f"no such path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            fut = self.service.submit(
                labels=req.get("labels"), n=req.get("n"),
                seed=req.get("seed"),
            )
            images = fut.result(timeout=self.request_timeout)
            self._reply(200, {
                "shape": list(images.shape),
                "images": _encode(images, req.get("encoding", "b64npz")),
            })
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e)})
        except Exception as e:
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})


class _Server(ThreadingHTTPServer):
    request_queue_size = socket.SOMAXCONN  # the listen backlog


def make_server(service, host: str = "127.0.0.1", port: int = 0,
                request_timeout: float | None = None) -> ThreadingHTTPServer:
    """Bind a ThreadingHTTPServer over `service` (port 0 = ephemeral).

    Caller owns the lifecycle: `server.serve_forever()` (or run it on a
    thread) and `server.shutdown()`; close the service separately.
    """
    handler = type(
        "Handler", (_Handler,),
        {"service": service, "request_timeout": request_timeout},
    )
    return _Server((host, port), handler)


def serve_forever(service, host: str = "127.0.0.1", port: int = 8000):
    server = make_server(service, host, port)
    try:
        server.serve_forever()
    finally:
        server.shutdown()
        service.close()
