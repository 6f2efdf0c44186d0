"""Standalone HTTP serving shell of the port (stdlib; counterpart of
``midd_tpu/serve/server.py`` with the same contract, run.py:174-226):

- ``GET /``        -> {"message", "status", "endpoints"}
- ``GET /health``  -> {"status", "device", "models_loaded": {4 bools}, "serving_mode",
  "fused_failures"}
- ``GET /ui``      -> the single-page web UI (text/html)
- ``POST /denoise`` multipart/form-data with a ``file`` field (or a raw image
  body) -> {"diffusion","nafnet","expert","hybrid"}: base64 PNG, or null for
  a path that failed; HTTP 500 {"detail": ...} on request-level errors; HTTP
  503 {"detail": ...} with ``Retry-After: 1`` when bounded admission
  (``--max-queue``) refuses the request.

Run: ``python -m midd_tpu_torch.serve.server --port 8000`` (on the GPU;
``--device cpu`` runs on the CPU), e.g. with ``--batching --adaptive
--max-queue 6``, ``--int8`` (static int8 convolutions in the diffusion
UNets, calibrated at startup), ``--img-size 1024``, or ``--dp`` / ``--tp``
/ ``--sp N`` (data-, tensor- and spatial-parallel serving over the local
cards; on one card each is a no-op, as in the JAX server), or ``--aot DIR``
(the serving programs compiled ahead of time into DIR at the first start and
loaded from there on later starts; ``MIDD_TPU_TORCH_CACHE_DIR`` moves the
compiler's cache).
"""

from __future__ import annotations

import email.parser
import email.policy
import json
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from midd_tpu_torch.serve.batching import QueueFull
from midd_tpu_torch.serve.codec import decode_to_tensor
from midd_tpu_torch.serve.engine import EngineConfig, InferenceEngine
from midd_tpu_torch.serve.static_ui import UI_HTML


def parse_multipart_file(body: bytes, content_type: str) -> Optional[bytes]:
    """Extract the first file field from a multipart/form-data body."""
    parser = email.parser.BytesParser(policy=email.policy.HTTP)
    msg = parser.parsebytes(b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body)
    if not msg.is_multipart():
        return None
    for part in msg.iter_parts():
        if "form-data" in part.get("Content-Disposition", ""):
            return part.get_payload(decode=True)
    return None


class _Handler(BaseHTTPRequestHandler):
    engine: InferenceEngine  # set by make_server
    img_size: int = 512

    def _send(self, data: bytes, content_type: str, status: int = 200, headers=()):
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Access-Control-Allow-Origin", "*")  # run.py:166-172
        for key, value in headers:
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(data)

    def _json(self, obj, status: int = 200, headers=()):
        self._send(json.dumps(obj).encode(), "application/json", status, headers)

    def do_GET(self):  # noqa: N802
        if self.path == "/ui":
            self._send(UI_HTML.encode(), "text/html; charset=utf-8")
        elif self.path == "/":
            self._json({
                "message": "X-Ray Denoising API with Hybrid Routing",
                "status": "running",
                "endpoints": {"denoise": "/denoise", "health": "/health"},
            })
        elif self.path == "/health":
            self._json(self.engine.health())
        else:
            self._json({"detail": "Not Found"}, 404)

    def do_POST(self):  # noqa: N802
        if self.path != "/denoise":
            self._json({"detail": "Not Found"}, 404)
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "")
            if ctype.startswith("multipart/form-data"):
                file_bytes = parse_multipart_file(body, ctype)
            else:
                file_bytes = body  # a raw image body is accepted too
            if not file_bytes:
                raise ValueError("no file field in request")
            x, original_size = decode_to_tensor(file_bytes, self.img_size)
            self._json(self.engine.process_all(x, original_size))
        except QueueFull as e:  # bounded admission: a retryable refusal
            self._json({"detail": str(e)}, 503, headers=[("Retry-After", "1")])
        except Exception as e:  # noqa: BLE001  request-level boundary (run.py:210-213)
            traceback.print_exc()
            self._json({"detail": str(e)}, 500)

    def log_message(self, fmt, *args):
        pass


def make_server(host: str = "0.0.0.0", port: int = 8000,
                engine: Optional[InferenceEngine] = None,
                engine_config: Optional[EngineConfig] = None) -> ThreadingHTTPServer:
    engine = engine or InferenceEngine(engine_config or EngineConfig())

    class Handler(_Handler):
        pass

    Handler.engine = engine
    Handler.img_size = engine.cfg.img_size
    return ThreadingHTTPServer((host, port), Handler)


def serve_forever(host="0.0.0.0", port=8000, engine_config=None):
    server = make_server(host, port, engine_config=engine_config)
    print(f"serving on http://{host}:{port}")
    print(f"serving mode: {json.dumps(server.RequestHandlerClass.engine.serving_mode())}")
    server.serve_forever()


def _parse_eps(v):
    if v is None or v == "auto":
        return v
    s = str(v)
    return tuple(int(i) for i in s.split(",")) if "," in s else int(s)


def config_from_args(argv=None):
    """The server's command line -> (its parsed arguments, the
    ``EngineConfig`` it serves)."""
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--img-size", type=int, default=512)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--bf16", action="store_true", help="all four models compute in bf16")
    ap.add_argument("--turbo", default="auto",
                    help="standalone rollout eps setting: 'auto' (the (0,2,6,7) "
                         "schedule at 8 steps), an int k (1 = exact) or comma indices")
    ap.add_argument("--turbo-hybrid", default=None,
                    help="hybrid rollout eps setting (int k or comma indices); "
                         "default auto: '0,2,6,7' at 8 steps, else 2")
    ap.add_argument("--exact", action="store_true",
                    help="reference-exact fp32 serving: exact rollouts on both "
                         "paths, fp32 UNet evals, TF32 off")
    ap.add_argument("--int8", action="store_true",
                    help="int8 convolutions in the diffusion UNets, their scales "
                         "calibrated at startup (not exact)")
    ap.add_argument("--dp", action="store_true",
                    help="data-parallel serving: batch rows split over the local cards")
    ap.add_argument("--tp", action="store_true",
                    help="tensor-parallel serving: large conv kernels split over the local "
                         "cards (output channels)")
    ap.add_argument("--sp", type=int, default=0, metavar="N",
                    help="spatial-parallel serving: image rows sharded over N "
                         "devices (batch-1 latency; 0 = off, -1 = auto)")
    ap.add_argument("--fused", action="store_true",
                    help="all four paths of a request in one fused function, "
                         "sharing the hybrid's backends where their weights are the same")
    ap.add_argument("--batching", action="store_true",
                    help="coalesce concurrent requests into size-bucketed batches")
    ap.add_argument("--buckets", default=None, metavar="B1,B2,...",
                    help="explicit batch buckets (default auto: 1,2,4,8 up to 256², else 1)")
    ap.add_argument("--adaptive", action="store_true",
                    help="load-adaptive turbo: when --queue-depth requests wait, the "
                         "rollout paths run their turbo schedules (with --batching)")
    ap.add_argument("--queue-depth", type=int, default=3, help="adaptive escalation threshold")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded admission: 503 beyond this many waiting requests "
                         "(with --batching)")
    ap.add_argument("--aot", default=None, metavar="DIR",
                    help="pinned serving programs: compile them into DIR at the first start, "
                         "load them from there on later starts (one-device engines; see "
                         "EngineConfig.aot_dir)")
    args = ap.parse_args(argv)
    cfg = EngineConfig(
        img_size=args.img_size,
        ckpt_dir=args.ckpt_dir,
        device=args.device,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        turbo_eps_reuse=1 if args.exact else _parse_eps(args.turbo),
        hybrid_turbo_eps_reuse=1 if args.exact else _parse_eps(args.turbo_hybrid),
        diffusion_eval_bf16=not args.exact,
        hybrid_rollout_bf16=not args.exact,
        quantize_int8="static" if args.int8 else False,
        batching=args.batching,
        fused_request=args.fused or None,
        batch_buckets=tuple(int(b) for b in args.buckets.split(",")) if args.buckets else "auto",
        data_parallel=args.dp,
        tensor_parallel=args.tp,
        spatial_parallel=args.sp != 0,
        sp_size=args.sp if args.sp > 0 else None,
        adaptive_turbo=args.adaptive,
        adaptive_queue_depth=args.queue_depth,
        max_queue_depth=args.max_queue,
        aot_dir=args.aot,
    )
    return args, cfg


def main(argv=None):
    import torch

    args, cfg = config_from_args(argv)
    if args.exact:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    serve_forever(args.host, args.port, engine_config=cfg)


if __name__ == "__main__":
    main()
