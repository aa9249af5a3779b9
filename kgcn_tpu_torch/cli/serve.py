"""HTTP inference server of the port — the counterpart of
``kgcn_tpu/cli/serve.py``, with the same endpoints, status codes and flags.

    python -m kgcn_tpu_torch.cli.serve --config example_config/solubility_cls.json [--cpu]

Endpoints:
  GET  /healthz   → {"status": "ok", "ready": …, "requests": …}
  POST /predict   → body: jbl-schema JSON ({"feature": [...], "adj": …} or
                    {"dense_adj": …}); response: {"prediction": …,
                    "num": …, "latency_ms": …}

``--checkpoint`` (or the config's ``load_model`` / ``save_model_path``)
may name a checkpoint of the port or a flax-msgpack one that ``kgcn_tpu``
wrote.  ``--export PATH`` serves a ``torch.export`` artifact written by
``train`` with ``export_model`` (``runtime/serve.ExportPredictor``);
``--dynamic-batching`` coalesces concurrent requests into one device call
(``runtime/serve.DynamicBatcher``; ``--batch-window-ms``,
``--max-batch-graphs``), over a checkpoint only, not an export, as in
``kgcn_tpu``.  Runs on the GPU unless ``--cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from kgcn_tpu_torch.runtime.serve import (DynamicBatcher, ExportPredictor,
                                          Predictor)


class Server(ThreadingHTTPServer):
    """A thread per connection, and a listen backlog that holds a burst of
    concurrent clients (the standard library's 5 resets the rest, and
    dynamic batching exists for such bursts)."""

    request_queue_size = 256
    daemon_threads = True


def make_handler(predictor):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path in ("/healthz", "/health", "/"):
                self._send(200, predictor.health())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/predict":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                self._send(200, predictor.predict(payload))
            except FileNotFoundError as e:
                self._send(503, {"error": f"checkpoint not found: {e}"})
            except Exception as e:  # surface the failure to the client
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):
            print(f"[serve] {self.address_string()} {fmt % args}")

    return Handler


def build_server(config: dict, *, host: str = "0.0.0.0", port: int = 8901,
                 checkpoint: str | None = None, export: str | None = None,
                 dynamic_batching: bool = False, window_ms: float = 5.0,
                 max_graphs: int = 256, device=None):
    """Construct (server, predictor) without blocking.  ``device`` is None
    (the GPU) or "cpu".  Dynamic batching wraps a checkpoint's
    ``Predictor``; an export is served as it is."""
    predictor = (ExportPredictor(export, config, device=device) if export
                 else Predictor(config, checkpoint=checkpoint, device=device))
    if dynamic_batching and not export:
        predictor = DynamicBatcher(predictor, window_ms=window_ms,
                                   max_graphs=max_graphs)
    server = Server((host, port), make_handler(predictor))
    return server, predictor


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="kgcn-tpu-torch inference server")
    p.add_argument("--config", required=True, help="training config JSON")
    p.add_argument("--checkpoint", default=None, help="checkpoint override")
    p.add_argument("--export", default=None,
                   help="serve a torch.export artifact instead of a checkpoint")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8901)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--dynamic-batching", action="store_true",
                   help="coalesce concurrent requests into one device call")
    p.add_argument("--batch-window-ms", type=float, default=5.0)
    p.add_argument("--max-batch-graphs", type=int, default=256)
    args = p.parse_args(argv)
    with open(args.config) as f:
        config = json.load(f)
    server, _ = build_server(
        config, host=args.host, port=args.port,
        checkpoint=args.checkpoint, export=args.export,
        dynamic_batching=args.dynamic_batching,
        window_ms=args.batch_window_ms, max_graphs=args.max_batch_graphs,
        device="cpu" if args.cpu else None,
    )
    print(f"[serve] listening on {args.host}:{args.port} "
          f"(model={config.get('model.py', 'gcn')})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
