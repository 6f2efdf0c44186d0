"""The port's micro-batching queue (mirrors tests/test_batching.py): requests
that arrive together coalesce into one padded call per model, a failing
model answers None, load-adaptive turbo escalates under queue pressure,
bounded admission refuses with QueueFull; and the engine's batched outputs
equal its unbatched ones (1e-5, exact fp32) and the JAX batched engine's on
the same ``.pth`` files (1e-3).

Every batcher is stopped in a ``finally``, every future waits at most 30 s.
"""

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest


from midd_tpu import config as jcfg
from midd_tpu.serve.engine import EngineConfig as JEngineConfig
from midd_tpu.serve.engine import InferenceEngine as JEngine
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.serve.batching import MicroBatcher, QueueFull
from midd_tpu_torch.serve.engine import MODEL_NAMES, EngineConfig, InferenceEngine
from tests.test_torch_serve import _small, _tiny, _write_checkpoints
from tests.torch_port_util import image

WAIT = 30.0
EXACT = dict(turbo_eps_reuse=1, hybrid_turbo_eps_reuse=1,
             diffusion_eval_bf16=False, hybrid_rollout_bf16=False)


def test_batcher_coalesces_concurrent_requests():
    calls = []

    def fn(x):
        calls.append(int(x.shape[0]))
        return x * 2.0

    batcher = MicroBatcher({"m": fn}, buckets=(1, 2, 4), max_wait_ms=50)
    try:
        xs = [np.full((1, 4, 4, 1), i, np.float32) for i in range(4)]
        futs = [batcher.submit(x) for x in xs]
        outs = [f.result(timeout=WAIT) for f in futs]
    finally:
        batcher.stop()
    for i, out in enumerate(outs):
        np.testing.assert_allclose(out["m"], xs[i] * 2.0)
    assert batcher.stats["requests"] == 4
    assert batcher.stats["batches"] <= 3
    assert all(c in (1, 2, 4) for c in calls)
    assert len(batcher.wait_ms) == 4 and min(batcher.wait_ms) >= 0.0


def test_batcher_pads_to_bucket_by_repeating_the_last_request():
    seen = []

    def fn(x):
        seen.append(x.copy())
        return x

    batcher = MicroBatcher({"m": fn}, buckets=(4,), max_wait_ms=1)
    try:
        out = batcher.process(np.full((1, 2, 2, 1), 3.0, np.float32), timeout=WAIT)
    finally:
        batcher.stop()
    assert [s.shape[0] for s in seen] == [4]  # padded 1 -> 4
    assert (seen[0] == 3.0).all()
    assert out["m"].shape == (1, 2, 2, 1)


def test_batcher_isolates_model_failure():
    def bad(x):
        raise RuntimeError("boom")

    batcher = MicroBatcher({"good": lambda x: x + 1, "bad": bad}, buckets=(1,), max_wait_ms=1)
    try:
        out = batcher.process(np.zeros((1, 2, 2, 1), np.float32), timeout=WAIT)
    finally:
        batcher.stop()
    assert out["bad"] is None
    np.testing.assert_allclose(out["good"], np.ones((1, 2, 2, 1)))


def test_fused_failure_falls_back_to_the_per_model_functions_and_is_counted():
    def fused(x):
        raise RuntimeError("fused boom")

    batcher = MicroBatcher({"m": lambda x: x + 1}, buckets=(1,), max_wait_ms=1, fused_fn=fused)
    try:
        out = batcher.process(np.zeros((1, 2, 2, 1), np.float32), timeout=WAIT)
    finally:
        batcher.stop()
    np.testing.assert_allclose(out["m"], np.ones((1, 2, 2, 1)))
    assert batcher.stats["fused_failures"] == 1


def test_adaptive_turbo_escalates_under_queue_pressure():
    """turbo_fns run instead of the exact ones when the queue depth after a
    batch was collected reaches turbo_queue_depth; both tiers serve."""
    calls = {"exact": 0, "turbo": 0}

    def exact(x):
        calls["exact"] += 1
        time.sleep(0.05)  # a slow device lets the queue build
        return x + 1.0

    def turbo(x):
        calls["turbo"] += 1
        return x + 2.0

    mb = MicroBatcher({"m": exact}, buckets=(1,), max_wait_ms=0.0,
                      turbo_fns={"m": turbo}, turbo_queue_depth=2)
    try:
        xs = [np.full((1, 4, 4, 1), i, np.float32) for i in range(8)]
        futs = [mb.submit(x) for x in xs]
        outs = [f.result(timeout=WAIT) for f in futs]
    finally:
        mb.stop()
    assert calls["turbo"] > 0 and calls["exact"] > 0
    assert mb.stats["turbo_batches"] == calls["turbo"]
    deltas = {float(o["m"][0, 0, 0, 0] - x[0, 0, 0, 0]) for o, x in zip(outs, xs)}
    assert deltas == {1.0, 2.0}


def test_bounded_admission_rejects_when_full():
    def slow(x):
        time.sleep(0.1)
        return x

    mb = MicroBatcher({"m": slow}, buckets=(1,), max_wait_ms=0.0, max_queue_depth=2)
    try:
        rejected, futs = 0, []
        for _ in range(12):
            try:
                futs.append(mb.submit(np.zeros((1, 4, 4, 1), np.float32)))
            except QueueFull:
                rejected += 1
        assert rejected > 0
        assert mb.stats["rejected"] == rejected
        for f in futs:
            assert f.result(timeout=WAIT)["m"] is not None
    finally:
        mb.stop()


def test_bounded_admission_counts_hold_under_contention():
    """More submitting threads than cores, a short switch interval: every
    submission is either served or counted as rejected, never both or
    neither, and the queue never held more than its bound."""
    depth, seen = 3, []

    def fn(x):
        seen.append(mb._q.qsize())
        time.sleep(0.002)
        return x

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    mb = MicroBatcher({"m": fn}, buckets=(1, 2), max_wait_ms=0.5, max_queue_depth=depth)
    try:
        def client(i):
            served = rejected = 0
            for _ in range(10):
                try:
                    mb.submit(np.full((1, 2, 2, 1), i, np.float32)).result(timeout=WAIT)
                    served += 1
                except QueueFull:
                    rejected += 1
            return served, rejected

        with ThreadPoolExecutor(max_workers=32) as pool:
            results = list(pool.map(client, range(32), timeout=WAIT * 4))
    finally:
        sys.setswitchinterval(old)
        mb.stop()
    served = sum(r[0] for r in results)
    rejected = sum(r[1] for r in results)
    assert served + rejected == 320
    assert mb.stats["requests"] == served and mb.stats["rejected"] == rejected
    assert max(seen) <= depth
    assert not mb._thread.is_alive()


def test_stop_fails_the_requests_still_queued():
    release = threading.Event()

    def blocked(x):
        release.wait(timeout=WAIT)
        return x

    mb = MicroBatcher({"m": blocked}, buckets=(1,), max_wait_ms=0.0)
    first = mb.submit(np.zeros((1, 2, 2, 1), np.float32))
    time.sleep(0.05)  # the collector holds the first request
    queued = mb.submit(np.zeros((1, 2, 2, 1), np.float32))
    stopper = threading.Thread(target=mb.stop, daemon=True)
    stopper.start()
    release.set()
    stopper.join(timeout=WAIT)
    assert not stopper.is_alive() and not mb._thread.is_alive()
    assert first.result(timeout=WAIT)["m"] is not None
    with pytest.raises(RuntimeError, match="batcher stopped"):
        queued.result(timeout=WAIT)


@pytest.mark.parametrize("img_size,buckets,want", [
    (16, "auto", [1, 2, 4, 8]),
    (256, "auto", [1, 2, 4, 8]),
    (512, "auto", [1]),
    (512, (1, 2), [1, 2]),  # explicit buckets are honoured as given
])
def test_buckets_by_image_size(img_size, buckets, want):
    """"auto" resolves as the JAX engine does (midd_tpu/serve/engine.py:962-965):
    (1, 2, 4, 8) up to 256², (1,) above."""
    eng = InferenceEngine(EngineConfig(**{**_small(tcfg), "img_size": img_size}, ckpt_dir="/nonexistent",
                                       batching=True, batch_buckets=buckets, device="cpu"))
    try:
        assert eng.batcher.buckets == want
    finally:
        eng.close()


def _concurrently(process, xs):
    with ThreadPoolExecutor(max_workers=len(xs)) as pool:
        return list(pool.map(lambda x: process(x, timeout=WAIT), xs, timeout=WAIT))


def test_batched_engine_equals_unbatched_per_request():
    """Three requests coalesce into one bucket-4 batch (padded by one); each
    request's four outputs equal the unbatched engine's for that image."""
    rng = np.random.default_rng(3)
    xs = [image(rng, 1, 16, 16, 1) for _ in range(3)]
    kw = dict(**_small(tcfg), **EXACT, ckpt_dir="/nonexistent", device="cpu")
    single = InferenceEngine(EngineConfig(**kw))
    batched = InferenceEngine(EngineConfig(**kw, batching=True, batch_buckets=(1, 4),
                                           batch_max_wait_ms=500.0))
    try:
        outs = _concurrently(batched.batcher.process, xs)
        assert batched.batcher.stats["max_batch"] > 1
        for x, out in zip(xs, outs):
            for name in MODEL_NAMES:
                np.testing.assert_allclose(out[name], single.fns[name](x), atol=1e-5, err_msg=name)
    finally:
        batched.close()
        single.close()


def test_port_batched_engine_matches_jax_batched_engine(tmp_path):
    rng = np.random.default_rng(17)
    _write_checkpoints(str(tmp_path), rng)
    xs = [image(rng, 1, 32, 32, 1) for _ in range(3)]
    kw = dict(**_tiny(tcfg), **EXACT, ckpt_dir=str(tmp_path), batching=True, batch_buckets=(1, 2, 4),
              batch_max_wait_ms=500.0)
    teng = InferenceEngine(EngineConfig(**kw, device="cpu"))
    jeng = JEngine(JEngineConfig(**{**kw, **_tiny(jcfg)}, persistent_cache=False))
    try:
        got = _concurrently(teng.batcher.process, xs)
        want = _concurrently(jeng.batcher.process, xs)
        for g, w in zip(got, want):
            for name in MODEL_NAMES:
                assert g[name].shape == w[name].shape == (1, 32, 32, 1)
                np.testing.assert_allclose(g[name], w[name], atol=1e-3, err_msg=name)
    finally:
        teng.close()
        jeng.batcher.stop()


def test_adaptive_engine_serves_turbo_tiers_that_fit_the_rollout():
    """The turbo tier's schedule is checked against its path's rollout: at 2
    requested steps (0, 2, 7) does not fit and the tier takes k = 2, as in
    the JAX engine; the tier's outputs are that rollout's."""
    kw = dict(**_small(tcfg), **EXACT, ckpt_dir="/nonexistent", device="cpu")
    eng = InferenceEngine(EngineConfig(**kw, batching=True, adaptive_turbo=True))
    ref = InferenceEngine(EngineConfig(**{**kw, "turbo_eps_reuse": 2, "hybrid_turbo_eps_reuse": 2}))
    try:
        assert set(eng.turbo_fns) == {"diffusion", "hybrid"}
        assert set(eng.batcher.turbo_fns) == {"diffusion", "hybrid"}
        x = image(np.random.default_rng(8), 1, 16, 16, 1)
        for name in ("diffusion", "hybrid"):
            np.testing.assert_allclose(eng.turbo_fns[name](x), ref.fns[name](x), atol=1e-6, err_msg=name)
        assert eng.serving_mode()["adaptive_turbo"] == {
            "queue_depth": 3, "diffusion_eps": [0, 2, 7], "hybrid_eps": [0, 2, 7]}
    finally:
        eng.close()
        ref.close()
