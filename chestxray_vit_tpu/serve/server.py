"""Minimal HTTP inference server around :class:`Predictor`.

POST /predict          body: raw PNG/JPEG bytes → JSON findings
POST /predict?maps=1   → findings + attention-rollout map (grid floats)
GET  /healthz          → {"status": "ok"}
GET  /metrics          → request/error counts + latency quantiles (JSON)

Stdlib-only (ThreadingHTTPServer). Concurrent requests coalesce into
shared device forwards through :class:`serve.batcher.MicroBatcher` — N
simultaneous clients cost ~N/batch_size dispatches, not N. Start with:

    python -m chestxray_vit_tpu.serve.server --model-dir outputs/model
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from chestxray_vit_tpu.serve.batcher import MicroBatcher
from chestxray_vit_tpu.serve.inference import Predictor

# NIH natives are 1024² PNGs (< 1 MB); anything past this is not an X-ray
MAX_BODY_BYTES = 32 * 1024 * 1024

# Serving accelerators as one preset (value-pinned in tests): int8-static +
# tome at batch 32, the shape auto_accel_config picks (crossover set on the
# previous accelerator; not re-measured on the H100 yet).
SERVE_PRESETS = {
    "fast_serve": {"batch_size": 32, "quantize": "static", "tome_r": 16,
                   "tome_schedule": "decreasing"},
}


class ServerStats:
    """Thread-safe request counters + a latency ring buffer for /metrics
    (the production-observability surface; stdlib-only)."""

    def __init__(self, window: int = 512):
        import threading
        import time as _time
        self._lock = threading.Lock()
        self._lat = [0.0] * window
        self._n = 0
        self.requests = 0
        self.errors = 0
        self._t0 = _time.time()

    def observe(self, seconds: float, error: bool = False) -> None:
        with self._lock:
            self.requests += 1
            self.errors += error
            self._lat[self._n % len(self._lat)] = seconds
            self._n += 1

    def snapshot(self) -> dict:
        import time as _time
        with self._lock:
            lat = sorted(self._lat[:min(self._n, len(self._lat))])
            q = (lambda p: round(
                lat[min(int(len(lat) * p), len(lat) - 1)] * 1e3, 1)
                ) if lat else (lambda p: None)
            return {
                "requests_total": self.requests,
                "errors_total": self.errors,
                "latency_ms": {"p50": q(0.5), "p95": q(0.95),
                               "p99": q(0.99)},
                "uptime_seconds": round(_time.time() - self._t0, 1),
            }


def make_handler(predictor: Predictor, max_body: int = MAX_BODY_BYTES,
                 batcher: Optional[MicroBatcher] = None,
                 stats: Optional[ServerStats] = None):
    batcher = batcher or MicroBatcher(predictor)
    stats = stats or ServerStats()

    class Handler(BaseHTTPRequestHandler):
        # socket read timeout: a stalled/trickling client can't pin a
        # handler thread indefinitely
        timeout = 60

        def log_message(self, *args):  # quiet
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.rstrip("/") == "/healthz" or self.path == "/":
                return self._json(200, {"status": "ok",
                                        "classes": predictor.classes})
            if self.path.rstrip("/") == "/metrics":
                return self._json(200, stats.snapshot())
            return self._json(404, {"error": "not found"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path.rstrip("/") != "/predict":
                return self._json(404, {"error": "not found"})
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                return self._json(400, {"error": "bad Content-Length"})
            if length <= 0:
                return self._json(400, {"error": "empty body"})
            if length > max_body:
                # drain a bounded amount so overshoots up to 2x the cap
                # still see the 413; a huge declared length just gets the
                # connection cut (never read the full client-declared size
                # — that lets one request hold the thread for an arbitrary
                # upload)
                remaining = min(length, max_body)
                while remaining > 0:
                    chunk = self.rfile.read(min(remaining, 1 << 20))
                    if not chunk:
                        break
                    remaining -= len(chunk)
                self.close_connection = True
                return self._json(413, {
                    "error": f"body exceeds {max_body} bytes"})
            data = self.rfile.read(length)
            query = parse_qs(url.query)
            with_maps = query.get("maps", ["0"])[-1] == "1"
            import time as _time
            t0 = _time.perf_counter()
            try:
                res = batcher.predict(data, with_maps=with_maps)
            except Exception as e:                     # noqa: BLE001
                stats.observe(_time.perf_counter() - t0, error=True)
                return self._json(500, {"error": str(e)})
            stats.observe(_time.perf_counter() - t0)
            payload = {
                "findings": predictor.top_findings(res.probs,
                                                   k=len(res.probs)),
            }
            if with_maps and res.attn_map is not None:
                payload["attention_map"] = res.attn_map.tolist()
            return self._json(200, payload)

    return Handler


def serve(predictor: Predictor, host: str = "127.0.0.1", port: int = 8000,
          block: bool = True) -> ThreadingHTTPServer:
    server = ThreadingHTTPServer((host, port), make_handler(predictor))
    if block:
        print(f"[server] listening on http://{host}:{server.server_port}")
        server.serve_forever()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def auto_accel_config(batch_size: int) -> dict:
    """Batch-size auto-pick of the serving accelerators: the int8-static +
    token-merging stack at batch >= 32, plain bf16 below (small batches
    are dispatch-dominated). The b32 crossover was set on the previous
    accelerator and is not re-measured on the H100 yet (ROADMAP Speed
    item 6). Returns the config overrides for this batch size."""
    if batch_size >= 32:
        return {"quantize": "static", "tome_r": 16,
                "tome_schedule": "decreasing"}
    return {"quantize": None, "tome_r": 0, "tome_schedule": "constant"}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--preset", choices=("fast_serve",), default=None,
                    help="serving accelerators as one flag: fast_serve = "
                         "batch 32 + int8 static + tome r=16 decreasing "
                         "(see auto_accel_config for the batch crossover). "
                         "Explicit flags override preset values")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--placement", choices=("host", "device"), default="host",
                    help="where crop/pad/resize runs (inference.Predictor)")
    ap.add_argument("--quantize", nargs="?", const="dynamic",
                    choices=("dynamic", "static"), default=None,
                    help="serve the int8 forward (per-channel int8 "
                         "weights — models/quantized.py). 'dynamic' "
                         "(the default when the flag is bare): per-token "
                         "activation scales, accuracy-safest; 'static': "
                         "calibrated per-site scales — the fully fusable "
                         "path")
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="shard each micro-batch over the first N devices "
                         "(0/1 = single-device; requires batch-size "
                         "divisible by N)")
    ap.add_argument("--compilation-cache", default=None,
                    help="persistent XLA compile cache dir — server cold "
                         "starts skip the bucket recompiles")
    ap.add_argument("--tome-r", type=int, default=None,
                    help="merge the r most-similar token pairs per layer "
                         "(token merging — opt-in speed/quality tradeoff; "
                         "validate fidelity on your data). Composes with "
                         "--quantize")
    ap.add_argument("--tome-schedule", choices=("constant", "decreasing"),
                    default=None,
                    help="distribute the r*L merge budget over layers: "
                         "'decreasing' front-loads merging in early "
                         "layers and tapers to zero at depth (avoids the "
                         "deep-layer clamp on long stacks, e.g. ViT-L)")
    ap.add_argument("--calibration", nargs="*", default=None,
                    help="PNG/JPEG files for --quantize static activation "
                         "calibration; 'synthetic' opts into the seeded "
                         "noise fallback without the warning (or persist "
                         "real-data scales once with `cli quantize`)")
    ap.add_argument("--auto-accel", action="store_true",
                    help="pick the forward stack by batch size "
                         "(auto_accel_config): int8 "
                         "static + tome r=16 decreasing at batch >= 32, "
                         "plain bf16 below. Mutually exclusive with "
                         "explicit --quantize/--tome-r/--preset")
    ns = ap.parse_args(argv)
    if ns.auto_accel:
        if (ns.quantize is not None or ns.tome_r is not None
                or ns.tome_schedule is not None or ns.preset):
            ap.error("--auto-accel picks the stack itself — drop "
                     "--quantize/--tome-r/--tome-schedule/--preset")
        batch = ns.batch_size if ns.batch_size is not None else 8
        picked = auto_accel_config(batch)
        ns.quantize = picked["quantize"]
        ns.tome_r = picked["tome_r"]
        ns.tome_schedule = picked["tome_schedule"]
        stack = (f"int8-{picked['quantize']} + tome r={picked['tome_r']} "
                 f"{picked['tome_schedule']}" if picked["quantize"]
                 else "plain bf16")
        print(f"[server] auto-accel: batch {batch} "
              f"{'>=' if batch >= 32 else '<'} 32 crossover -> {stack}",
              flush=True)
    # preset expansion: explicit flags win over preset values, preset
    # values win over the plain defaults
    preset = SERVE_PRESETS.get(ns.preset, {})
    ns.batch_size = (ns.batch_size if ns.batch_size is not None
                     else preset.get("batch_size", 8))
    ns.quantize = (ns.quantize if ns.quantize is not None
                   else preset.get("quantize"))
    ns.tome_r = (ns.tome_r if ns.tome_r is not None
                 else preset.get("tome_r", 0))
    ns.tome_schedule = (ns.tome_schedule if ns.tome_schedule is not None
                        else preset.get("tome_schedule", "constant"))
    calibration = None
    if ns.calibration is not None:
        if ns.calibration == ["synthetic"]:
            calibration = "synthetic"
        elif not ns.calibration:
            raise SystemExit("--calibration was given but matched no "
                             "files — pass PNG/JPEG paths or 'synthetic'")
        else:
            calibration = [open(p, "rb").read() for p in ns.calibration]
    from chestxray_vit_tpu.utils.compilation_cache import (
        enable_compilation_cache)
    enable_compilation_cache(ns.compilation_cache)
    predictor = Predictor.from_model_dir(ns.model_dir,
                                         batch_size=ns.batch_size,
                                         placement=ns.placement,
                                         quantize=ns.quantize,
                                         data_parallel=ns.data_parallel,
                                         tome_r=ns.tome_r,
                                         tome_schedule=ns.tome_schedule,
                                         calibration=calibration)
    print("[server] warming up (compiling batch buckets)...", flush=True)
    predictor.warmup()
    serve(predictor, ns.host, ns.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
