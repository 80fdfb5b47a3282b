"""Serving + attention-map tests."""

import io

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

from chestxray_vit_tpu.config import ModelConfig
from chestxray_vit_tpu.models import vit
from chestxray_vit_tpu.serve import attention_maps as am
from chestxray_vit_tpu.serve.inference import Predictor


def tiny_cfg(**kw):
    base = dict(img_size=32, patch_size=16, hidden_size=64, num_layers=2,
                num_heads=4, mlp_dim=128, num_classes=5, dtype="float32",
                attention_impl="xla")
    base.update(kw)
    return ModelConfig(**base)


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr, "L").save(buf, format="PNG")
    return buf.getvalue()


def test_attention_rollout_shapes_and_range(rng):
    cfg = tiny_cfg()
    params = vit.init_params(jax.random.key(0), cfg)
    x = jnp.asarray(rng.standard_normal((3, 32, 32, 3)), jnp.float32)
    logits, maps = am.compute_rollout(params, x, cfg)
    assert logits.shape == (3, 5)
    assert maps.shape == (3, 2, 2)          # (32/16)² grid
    assert float(maps.min()) >= 0.0 and float(maps.max()) <= 1.0


def test_rollout_math_identity_attention():
    """With identity attention the rollout must be (normalized) identity —
    CLS attends only to itself, patch saliency is flat zero."""
    l, b, h, s = 2, 1, 2, 5
    eye = jnp.broadcast_to(jnp.eye(s), (l, b, h, s, s))
    maps = am.attention_rollout(eye)
    np.testing.assert_allclose(np.asarray(maps), 0.0, atol=1e-6)


def test_rollout_peaked_attention():
    """All queries attending patch 3 → the map peaks at patch 3."""
    l, b, h, s = 1, 1, 1, 5
    a = np.full((l, b, h, s, s), 1e-6, np.float32)
    a[..., 3] = 1.0
    a = a / a.sum(-1, keepdims=True)
    maps = am.attention_rollout(jnp.asarray(a))
    flat = np.asarray(maps).reshape(-1)
    assert flat.argmax() == 2                # patch index 3 → patch-grid 2


def test_grad_cam_shapes_and_differentiates_classes(rng):
    cfg = tiny_cfg()
    params = vit.init_params(jax.random.key(1), cfg)
    x = jnp.asarray(rng.standard_normal((2, 32, 32, 3)), jnp.float32)
    logits, maps0 = am.grad_cam(params, x, cfg, class_idx=0)
    _, maps1 = am.grad_cam(params, x, cfg, class_idx=1)
    assert maps0.shape == (2, 2, 2)
    assert np.isfinite(np.asarray(maps0)).all()
    ref = vit.apply(params, x, cfg)
    np.testing.assert_allclose(np.asarray(logits), np.asarray(ref), atol=1e-5)
    assert not np.allclose(np.asarray(maps0), np.asarray(maps1))


def test_upsample_map():
    maps = jnp.asarray(np.random.default_rng(0).random((2, 2, 2)),
                       jnp.float32)
    up = am.upsample_map(maps, 8)
    assert up.shape == (2, 8, 8)


def test_predictor_end_to_end(rng):
    cfg = tiny_cfg()
    params = vit.init_params(jax.random.key(2), cfg)
    pred = Predictor(params, cfg, classes=list("ABCDE"), batch_size=4,
                     canvas_size=64)
    blobs = [_png(rng.integers(0, 255, (48, 64), np.uint8))
             for _ in range(6)]             # 6 images → 2 micro-batches
    out = pred.predict_bytes(blobs)
    assert out.probs.shape == (6, 5)
    assert ((out.probs >= 0) & (out.probs <= 1)).all()
    np.testing.assert_allclose(out.probs, 1 / (1 + np.exp(-out.logits)),
                               atol=1e-5)
    top = pred.top_findings(out.probs[0], k=3)
    assert len(top) == 3 and top[0]["probability"] >= top[1]["probability"]


def test_predictor_with_maps(rng):
    cfg = tiny_cfg()
    params = vit.init_params(jax.random.key(3), cfg)
    pred = Predictor(params, cfg, batch_size=2, canvas_size=64)
    blobs = [_png(rng.integers(0, 255, (64, 64), np.uint8))
             for _ in range(3)]
    out = pred.predict_bytes(blobs, with_maps=True)
    assert out.maps.shape == (3, 2, 2)


def test_predictor_matches_training_preprocess(rng):
    """Predictor's fused preprocessing == host pipeline + apply."""
    from chestxray_vit_tpu.data import geometry as geo
    from chestxray_vit_tpu.data.pipeline import host_resize
    from chestxray_vit_tpu.ops.preprocess import normalize_u8
    cfg = tiny_cfg()
    params = vit.init_params(jax.random.key(4), cfg)
    gray = rng.integers(0, 255, (48, 64), np.uint8)
    pred = Predictor(params, cfg, batch_size=1, canvas_size=64)
    out = pred.predict_bytes([_png(gray)])
    hr = host_resize(gray, geo.full_image_box(64, 48), 32)
    imgs = normalize_u8(jnp.asarray(hr[None]))
    ref_logits = np.asarray(vit.apply(params, imgs, cfg))
    np.testing.assert_allclose(out.logits, ref_logits, atol=0.15, rtol=0.05)


def test_predictor_save_load_roundtrip(tmp_path, rng):
    from chestxray_vit_tpu.config import Config, TrainConfig
    from chestxray_vit_tpu.train.checkpoint import save_model
    cfg = tiny_cfg()
    params = vit.init_params(jax.random.key(5), cfg)
    full = Config(model=cfg, train=TrainConfig())
    save_model(str(tmp_path / "m"), params, full.to_json(), list("ABCDE"))
    pred = Predictor.from_model_dir(str(tmp_path / "m"), batch_size=2)
    assert pred.classes == list("ABCDE")
    blob = _png(rng.integers(0, 255, (64, 64), np.uint8))
    out = pred.predict_bytes([blob])
    assert out.probs.shape == (1, 5)


def test_visualize_overlay_and_panel(tmp_path, rng):
    from chestxray_vit_tpu.serve import visualize as V
    gray = rng.integers(0, 255, (64, 64), np.uint8)
    sal = rng.random((4, 4)).astype(np.float32)
    out = V.overlay_heatmap(gray, sal)
    assert out.shape == (64, 64, 3) and out.dtype == np.uint8
    p1 = V.save_overlay(str(tmp_path / "ov.png"), gray, sal)
    p2 = V.save_prediction_panel(
        str(tmp_path / "panel.png"), gray, sal,
        [{"label": "Mass", "probability": 0.9}])
    import os
    assert os.path.exists(p1) and os.path.exists(p2)
    # upsample is monotone: hottest grid cell stays hottest region
    gy, gx = np.unravel_index(sal.argmax(), sal.shape)
    up = V._bilinear_upsample(sal, 64, 64)
    uy, ux = np.unravel_index(up.argmax(), up.shape)
    assert abs(uy // 16 - gy) <= 1 and abs(ux // 16 - gx) <= 1


def test_http_server_end_to_end(rng):
    """Real HTTP round-trips against the serving endpoint."""
    import json
    import urllib.request
    from chestxray_vit_tpu.serve.server import serve

    cfg = tiny_cfg()
    params = vit.init_params(jax.random.key(6), cfg)
    pred = Predictor(params, cfg, classes=list("ABCDE"), batch_size=2,
                     canvas_size=64)
    server = serve(pred, host="127.0.0.1", port=0, block=False)
    base = f"http://127.0.0.1:{server.server_port}"
    try:
        health = json.loads(urllib.request.urlopen(base + "/healthz").read())
        assert health["status"] == "ok" and health["classes"] == list("ABCDE")

        blob = _png(rng.integers(0, 255, (64, 64), np.uint8))
        req = urllib.request.Request(base + "/predict", data=blob,
                                     method="POST")
        out = json.loads(urllib.request.urlopen(req).read())
        assert len(out["findings"]) == 5
        assert 0.0 <= out["findings"][0]["probability"] <= 1.0

        req = urllib.request.Request(base + "/predict?maps=1", data=blob,
                                     method="POST")
        out = json.loads(urllib.request.urlopen(req).read())
        assert np.asarray(out["attention_map"]).shape == (2, 2)

        # probes: empty body and wrong route
        req = urllib.request.Request(base + "/predict", data=b"",
                                     method="POST")
        try:
            urllib.request.urlopen(req)
            raise AssertionError("expected 400")
        except urllib.error.HTTPError as e:
            assert e.code == 400
        try:
            urllib.request.urlopen(base + "/nope")
            raise AssertionError("expected 404")
        except urllib.error.HTTPError as e:
            assert e.code == 404

        # oversize body → 413 (the cap guards the threaded read)
        from chestxray_vit_tpu.serve import server as srv
        big = urllib.request.Request(
            base + "/predict", data=b"x" * (srv.MAX_BODY_BYTES + 1),
            method="POST")
        try:
            urllib.request.urlopen(big)
            raise AssertionError("expected 413")
        except urllib.error.HTTPError as e:
            assert e.code == 413

        # maps must be parsed from the query string, not substring-matched:
        # a stray 'maps=1' in another parameter's value doesn't trigger maps
        req = urllib.request.Request(base + "/predict?note=maps%3D1",
                                     data=blob, method="POST")
        out = json.loads(urllib.request.urlopen(req).read())
        assert "attention_map" not in out
        req = urllib.request.Request(base + "/predict?maps=0", data=blob,
                                     method="POST")
        out = json.loads(urllib.request.urlopen(req).read())
        assert "attention_map" not in out

        # /metrics reflects the traffic above
        m = json.loads(urllib.request.urlopen(base + "/metrics").read())
        assert m["requests_total"] >= 4        # the successful predicts
        assert m["errors_total"] == 0
        assert m["latency_ms"]["p50"] > 0
        assert m["uptime_seconds"] >= 0
    finally:
        server.shutdown()


def test_microbatcher_coalesces_and_matches(rng):
    """Concurrent submits resolve to the same results as solo predicts, and
    the group runs FEWER device forwards than requests (coalescing)."""
    import threading
    from chestxray_vit_tpu.serve.batcher import MicroBatcher

    cfg = tiny_cfg()
    params = vit.init_params(jax.random.key(6), cfg)
    pred = Predictor(params, cfg, classes=list("ABCDE"), batch_size=8,
                     canvas_size=64)
    calls = {"n": 0}
    orig = pred.forward_staged

    def counting(staged, valid, with_maps=False):
        # the batcher's device half — one call per coalesced group
        calls["n"] += 1
        return orig(staged, valid, with_maps=with_maps)

    pred.forward_staged = counting

    blobs = [_png(rng.integers(0, 255, (64, 64), np.uint8))
             for _ in range(8)]
    solo = [pred.predict_bytes([b]).probs[0] for b in blobs]
    calls["n"] = 0

    batcher = MicroBatcher(pred, max_wait_ms=150.0)
    barrier = threading.Barrier(8)
    results = [None] * 8

    def worker(i):
        barrier.wait()
        results[i] = batcher.predict(blobs[i]).probs

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    batcher.close()

    for i in range(8):
        np.testing.assert_allclose(results[i], solo[i], atol=1e-5)
    assert calls["n"] <= 4                  # 8 requests coalesced


def test_microbatcher_pipeline_off_matches(rng):
    """pipeline=False (serialized stage+forward on one thread) resolves
    the same results as the default two-stage pipeline."""
    import threading
    from chestxray_vit_tpu.serve.batcher import MicroBatcher

    cfg = tiny_cfg()
    params = vit.init_params(jax.random.key(6), cfg)
    pred = Predictor(params, cfg, classes=list("ABCDE"), batch_size=4,
                     canvas_size=64)
    blobs = [_png(rng.integers(0, 255, (64, 64), np.uint8))
             for _ in range(6)]
    out = {}
    for mode in (True, False):
        batcher = MicroBatcher(pred, max_wait_ms=100.0, pipeline=mode)
        barrier = threading.Barrier(len(blobs))
        res = [None] * len(blobs)

        def worker(i, b=batcher, bar=barrier, r=res):
            bar.wait()
            r[i] = b.predict(blobs[i]).probs

        ts = [threading.Thread(target=worker, args=(i,))
              for i in range(len(blobs))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        batcher.close()
        out[mode] = res
    for a, b in zip(out[True], out[False]):
        assert a is not None and b is not None
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_microbatcher_mixed_maps_and_errors(rng):
    from chestxray_vit_tpu.serve.batcher import MicroBatcher

    cfg = tiny_cfg()
    params = vit.init_params(jax.random.key(6), cfg)
    pred = Predictor(params, cfg, classes=list("ABCDE"), batch_size=4,
                     canvas_size=64)
    batcher = MicroBatcher(pred, max_wait_ms=50.0)
    blob = _png(rng.integers(0, 255, (64, 64), np.uint8))
    f_plain = batcher.submit(blob, with_maps=False)
    f_maps = batcher.submit(blob, with_maps=True)
    plain = f_plain.result(timeout=60)
    mapped = f_maps.result(timeout=60)
    assert plain.attn_map is None
    assert mapped.attn_map is not None and mapped.attn_map.shape == (2, 2)
    np.testing.assert_allclose(plain.probs, mapped.probs, atol=1e-5)
    batcher.close()
    import pytest as _pytest
    with _pytest.raises(RuntimeError):
        batcher.submit(blob)


def test_predictor_placements_agree(rng):
    """'host' (C++/PIL resize, u8 ship) and 'device' (fused MXU preprocess)
    stagings produce matching probabilities (resamplers differ by ≤2.5/255
    per pixel — PARITY §2.1 ROI row — so logits agree loosely, rankings
    tightly)."""
    cfg = tiny_cfg()
    params = vit.init_params(jax.random.key(4), cfg)
    blobs = [_png(rng.integers(0, 255, (48, 64), np.uint8))
             for _ in range(3)]
    out_h = Predictor(params, cfg, batch_size=4, canvas_size=64,
                      placement="host").predict_bytes(blobs)
    out_d = Predictor(params, cfg, batch_size=4, canvas_size=64,
                      placement="device").predict_bytes(blobs)
    assert out_h.probs.shape == out_d.probs.shape == (3, 5)
    np.testing.assert_allclose(out_h.probs, out_d.probs, atol=0.05)


def test_bucket_sizes():
    """Partial chunks pad to the nearest power-of-two bucket, not the full
    batch — bounded compile count, right-sized forwards."""
    from chestxray_vit_tpu.serve.inference import Predictor
    p = Predictor.__new__(Predictor)        # bucket math needs no model
    p._min_bucket = 1
    assert p._bucket(1, 8) == 1
    assert p._bucket(2, 8) == 2
    assert p._bucket(3, 8) == 4
    assert p._bucket(8, 8) == 8
    assert p._bucket(5, 4) == 4             # never above batch_size


def test_warmup_compiles_all_buckets(rng):
    """warmup() must run for both placements without touching decode."""
    cfg = tiny_cfg()
    params = vit.init_params(jax.random.key(5), cfg)
    for placement in ("host", "device"):
        pred = Predictor(params, cfg, batch_size=4, canvas_size=64,
                         placement=placement)
        pred.warmup()
        pred.warmup(with_maps=True)
        # post-warmup predictions still correct
        blob = _png(rng.integers(0, 255, (32, 32), np.uint8))
        out = pred.predict_bytes([blob])
        assert out.probs.shape == (1, 5)


def test_server_main_flags():
    """The serve CLI exposes --placement and validates choices."""
    import pytest as _pytest
    from chestxray_vit_tpu.serve import server as srv
    with _pytest.raises(SystemExit):
        srv.main(["--model-dir", "x", "--placement", "gpu"])   # bad choice


def test_static_synthetic_calibration_warns_and_opts_in(capsys):
    """quantize='static' with no calibration falls back to seeded noise —
    LOUDLY; calibration='synthetic' is the explicit,
    silent opt-in, and an empty calibration set is rejected outright."""
    cfg = tiny_cfg()
    params = vit.init_params(jax.random.key(0), cfg)

    Predictor(params, cfg, batch_size=2, quantize="static")
    err = capsys.readouterr().err
    assert "WARNING" in err and "synthetic" in err

    Predictor(params, cfg, batch_size=2, quantize="static",
              calibration="synthetic")
    assert "WARNING" not in capsys.readouterr().err

    with pytest.raises(ValueError, match="EMPTY calibration"):
        Predictor(params, cfg, batch_size=2, quantize="static",
                  calibration=[])

    # real images calibrate silently, and the two explicit modes produce
    # the same artifact structure
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (32, 32), np.uint8) for _ in range(4)]
    pred = Predictor(params, cfg, batch_size=2, quantize="static",
                     calibration=imgs)
    assert "WARNING" not in capsys.readouterr().err
    assert "act" in pred._qparams["blocks"]


def test_microbatcher_close_with_wedged_device_fails_futures():
    """close() must resolve EVERY in-flight future even when the device
    thread is wedged inside a hung forward. Before the fix the stager
    could block forever in the hand-off queue's put() — close()'s drain
    ran before the put landed, so that group's futures never resolved and
    callers blocked in predict() hung forever."""
    import threading
    import time

    from chestxray_vit_tpu.serve.batcher import MicroBatcher

    release = threading.Event()
    forwards_started = threading.Event()

    class WedgedPredictor:
        batch_size = 1

        def stage_chunk(self, chunk):
            return ("staged", len(chunk))

        def forward_staged(self, staged, valid, with_maps=False):
            forwards_started.set()
            release.wait(timeout=60)   # simulate a hung device dispatch
            raise RuntimeError("wedged")

    batcher = MicroBatcher(WedgedPredictor(), max_wait_ms=1.0,
                           pipeline=True)
    # 5 single-request groups: one wedged in the device thread, two queued
    # in the hand-off queue, one blocking the stager's put, one queued
    futs = [batcher.submit(b"x") for _ in range(5)]
    assert forwards_started.wait(timeout=10)
    time.sleep(0.3)                    # let the stager reach the full put

    t0 = time.monotonic()
    batcher.close()                    # must NOT hang
    assert time.monotonic() - t0 < 30
    # the group INSIDE the wedged forward can only resolve when the
    # forward returns — unwedge it; every other group must already have
    # been failed by close()/the stager's closed-aware hand-off
    release.set()
    for f in futs:
        with pytest.raises(RuntimeError):
            f.result(timeout=10)       # resolved (exception), not hung


def test_serve_preset_fast_serve_expands_and_flags_override():
    """--preset fast_serve pins the measured b>=32 accel shape
    (serve.server.auto_accel_config); explicit flags win over the preset."""
    from chestxray_vit_tpu.serve.server import SERVE_PRESETS

    assert SERVE_PRESETS["fast_serve"] == {
        "batch_size": 32, "quantize": "static", "tome_r": 16,
        "tome_schedule": "decreasing"}

    # exercise the expansion logic through parse_args the way main() does
    import argparse

    from chestxray_vit_tpu.serve import server as srv
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=("fast_serve",), default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--quantize", nargs="?", const="dynamic",
                    choices=("dynamic", "static"), default=None)
    ap.add_argument("--tome-r", type=int, default=None)
    ap.add_argument("--tome-schedule",
                    choices=("constant", "decreasing"), default=None)

    def resolve(argv):
        ns = ap.parse_args(argv)
        preset = srv.SERVE_PRESETS.get(ns.preset, {})
        return (ns.batch_size if ns.batch_size is not None
                else preset.get("batch_size", 8),
                ns.quantize if ns.quantize is not None
                else preset.get("quantize"),
                ns.tome_r if ns.tome_r is not None
                else preset.get("tome_r", 0),
                ns.tome_schedule if ns.tome_schedule is not None
                else preset.get("tome_schedule", "constant"))

    assert resolve([]) == (8, None, 0, "constant")
    assert resolve(["--preset", "fast_serve"]) == (
        32, "static", 16, "decreasing")
    assert resolve(["--preset", "fast_serve", "--tome-r", "0",
                    "--batch-size", "64"]) == (
        64, "static", 0, "decreasing")


def test_auto_accel_picks_by_measured_crossover():
    """--auto-accel: the decision
    helper returns the fast_serve accel shape at the measured b>=32
    crossover and plain bf16 below it; combining --auto-accel with an
    explicit stack flag is rejected (ambiguous)."""
    from chestxray_vit_tpu.serve import server as srv

    assert srv.auto_accel_config(32) == {
        "quantize": "static", "tome_r": 16, "tome_schedule": "decreasing"}
    assert srv.auto_accel_config(64)["quantize"] == "static"
    for b in (1, 8, 16, 31):
        assert srv.auto_accel_config(b) == {
            "quantize": None, "tome_r": 0, "tome_schedule": "constant"}

    import pytest as _pytest
    for extra in (["--tome-r", "4"], ["--quantize", "static"],
                  ["--preset", "fast_serve"]):
        with _pytest.raises(SystemExit):
            srv.main(["--model-dir", "x", "--auto-accel", *extra])


def test_predictor_small_batch_accel_guidance(capsys):
    """The batch crossover is enforced at runtime: an accel stack at
    batch < 16 prints the guidance; bf16 small batch and accel at b>=32
    stay silent."""
    cfg = tiny_cfg()
    params = vit.init_params(jax.random.key(0), cfg)

    Predictor(params, cfg, batch_size=8, quantize="dynamic")
    assert "batch_size>=32" in capsys.readouterr().err

    Predictor(params, cfg, batch_size=8, tome_r=2)
    assert "batch_size>=32" in capsys.readouterr().err

    Predictor(params, cfg, batch_size=8)                 # plain bf16: quiet
    assert "[predictor] NOTE" not in capsys.readouterr().err

    Predictor(params, cfg, batch_size=32, quantize="dynamic")
    assert "[predictor] NOTE" not in capsys.readouterr().err
