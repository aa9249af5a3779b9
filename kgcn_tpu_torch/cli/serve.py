"""HTTP inference server of the port — the counterpart of
``kgcn_tpu/cli/serve.py``, with the same endpoints, status codes and flags.

    python -m kgcn_tpu_torch.cli.serve --config example_config/solubility_cls.json [--cpu]

Endpoints:
  GET  /healthz   → {"status": "ok", "ready": …, "requests": …}
  POST /predict   → body: jbl-schema JSON ({"feature": [...], "adj": …} or
                    {"dense_adj": …}); response: {"prediction": …,
                    "num": …, "latency_ms": …}

Runs on the GPU unless ``--cpu`` is given.  ``--export`` and
``--dynamic-batching`` are not ported yet and raise.
"""
from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from kgcn_tpu_torch.runtime.serve import Predictor


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
                 dynamic_batching: bool = False, device=None):
    """Construct (server, predictor) without blocking.  ``device`` is None
    (the GPU) or "cpu"."""
    if export:
        raise NotImplementedError(
            "--export (serving an exported artifact) is not yet ported "
            "(ROADMAP.md queue A)"
        )
    if dynamic_batching:
        raise NotImplementedError(
            "--dynamic-batching is not yet ported (ROADMAP.md queue A)"
        )
    predictor = Predictor(config, checkpoint=checkpoint, device=device)
    server = ThreadingHTTPServer((host, port), make_handler(predictor))
    return server, predictor


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="kgcn-tpu-torch inference server")
    p.add_argument("--config", required=True, help="training config JSON")
    p.add_argument("--checkpoint", default=None, help="checkpoint override")
    p.add_argument("--export", default=None,
                   help="serve an exported artifact (not yet ported)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8901)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--dynamic-batching", action="store_true",
                   help="coalesce concurrent requests (not yet ported)")
    # accepted for the JAX CLI's command lines; used with --dynamic-batching
    p.add_argument("--batch-window-ms", type=float, default=5.0)
    p.add_argument("--max-batch-graphs", type=int, default=256)
    args = p.parse_args(argv)
    with open(args.config) as f:
        config = json.load(f)
    server, _ = build_server(
        config, host=args.host, port=args.port,
        checkpoint=args.checkpoint, export=args.export,
        dynamic_batching=args.dynamic_batching,
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
