"""Open-loop single-image requests through ``ServingEngine.submit``.

Independent users of a classification service: requests arrive on a
schedule whatever the system does, so a stall makes later requests wait.

Parameters (the workload file's ``params``):
  rate          requests a second offered, a fixed number
  batch_size    ``ServingEngine``'s batch shape
  max_delay_ms  how long its batcher waits for a batch to fill
  pool          distinct uint8 images, made from the seed (``images.py``)
  scale         the images' dequantisation scale (zero point 0): the
                ``Interpreter`` takes uint8 with ``input_scale``
  sample        requests whose rows the check compares, drawn from the seed
  drain_s       how long after the last arrival unanswered requests wait

Arrivals: ``rate * seconds`` exponential gaps drawn once from a fixed
stream (the same set for every seed), scaled to span ``seconds`` exactly,
and put in an order drawn from the seed; each request's image is drawn
from the seed. Each request's latency runs from its due time to its row
reaching the caller (its future resolving). A request still unanswered
``drain_s`` after the close counts as failed and as slower than any other.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from portbench import images, system
from portbench.stats import percentile

ARRIVALS_STREAM = "open-loop-arrivals"


def schedule(rate, seconds, seed):
    """Due times (s from the window's start) of ``rate * seconds``
    requests: a fixed set of exponential gaps in an order drawn from
    ``seed``; the first is due at 0 and the set spans ``seconds``."""
    n = max(1, round(rate * seconds))
    gaps = np.random.default_rng(system.derive(0, ARRIVALS_STREAM)) \
        .exponential(1.0, n)
    gaps *= seconds / gaps.sum()
    gaps = gaps[np.random.default_rng(system.derive(seed, "order"))
                .permutation(n)]
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


class Traffic:
    def __init__(self, config, params, seed, device, tracer, model=None):
        from compute_engine_tpu_torch.runtime.serving import ServingEngine

        self.p, self.seed, self.tracer = params, seed, tracer
        self.scale = float(params["scale"])
        self.weights, self.interp, self.setup_steps = system.build(
            config, seed, device, input_scale=self.scale, model=model)
        t = time.perf_counter()
        h, w = config["input_size"]
        g = system.generator(seed, "inputs", device)
        self.pool = images.uint8_images(int(params["pool"]), h, w,
                                        config["channels"], g,
                                        device).cpu().numpy()
        self.engine = ServingEngine(self.interp,
                                    batch_size=int(params["batch_size"]),
                                    max_delay_ms=float(params["max_delay_ms"]))
        self.setup_steps["inputs"] = time.perf_counter() - t
        # One full batch captures the forward's graph on the batcher.
        futures = [self.engine.submit(self.pool[i % len(self.pool)])
                   for i in range(int(params["batch_size"]))]
        for f in futures:
            f.result(timeout=600)
        self.setup_steps["warm_up"] = time.perf_counter() - t - \
            self.setup_steps["inputs"]
        self.device = device
        self.kept = []

    def run(self, seconds):
        tracer, engine, pool = self.tracer, self.engine, self.pool
        due = schedule(float(self.p["rate"]), seconds, self.seed)
        n = len(due)
        which = np.random.default_rng(system.derive(self.seed, "images")) \
            .integers(0, len(pool), n)
        sampled = np.zeros(n, bool)
        sampled[np.random.default_rng(system.derive(self.seed, "sample"))
                .choice(n, min(int(self.p["sample"]), n), replace=False)] = 1
        done_at = np.full(n, np.nan)
        lag = np.zeros(n)
        finished = threading.Semaphore(0)

        def on_done(i):
            def record(fut):
                if fut.exception() is None:  # a failed batch never answers
                    done_at[i] = time.perf_counter()
                finished.release()
            return record

        kept = []
        stats0 = dataclasses.asdict(engine.stats)
        t0 = time.perf_counter()
        for i in range(n):
            at = t0 + due[i]
            while True:
                now = time.perf_counter()
                if now >= at:
                    break
                time.sleep(at - now)
            with tracer.span("portbench/submit"):
                fut = engine.submit(pool[which[i]])
            lag[i] = now - at
            fut.add_done_callback(on_done(i))
            if sampled[i]:
                kept.append((int(which[i]), fut))
            tracer.calls = engine.stats.batches
            tracer.tick(now - t0)
        tracer.close()
        closed = time.perf_counter()
        deadline = closed + float(self.p["drain_s"])
        for _ in range(n):
            left = max(0.0, deadline - time.perf_counter())
            if not finished.acquire(timeout=left):
                break
        latency = (done_at - (t0 + due)) * 1e3
        failed = int(np.isnan(latency).sum())
        latency = np.where(np.isnan(latency), np.inf, latency)
        self.kept = [(i, f) for i, f in kept if f.done()
                     and f.exception() is None]
        grown = {k: v - stats0[k]
                 for k, v in dataclasses.asdict(engine.stats).items()}
        batches = grown["batches"]
        return {"start": t0, "attempted": n, "failed": failed,
                "forwards": batches,
                "metrics": {"latency_p50_ms": percentile(latency, 50),
                            "latency_p95_ms": percentile(latency, 95)},
                "notes": {"generator_lag_ms_p50_max": (
                              float(np.median(lag) * 1e3),
                              float(lag.max() * 1e3)),
                          "p50_ms_by_third": [
                              float(np.median(t))
                              for t in np.array_split(latency, 3)],
                          "drain_s": time.perf_counter() - closed,
                          "serving_ms_per_batch": {
                              k: grown[k] / max(batches, 1)
                              for k in grown if k.endswith("_ms")},
                          "requests_per_batch": (grown["requests"]
                                                 / max(batches, 1))}}

    def free(self):
        """Stops the batcher and drops the program's state."""
        self.engine.close()
        self.engine = self.interp = None

    def dequantised(self, idx):
        """The pool images ``idx`` dequantised as the configuration states
        (``scale`` times the uint8 value), float32 on the device."""
        u8 = torch.from_numpy(self.pool[np.asarray(idx)]).to(self.device)
        return u8.to(torch.float32) * torch.tensor(self.scale,
                                                   dtype=torch.float32)

    def checked(self, group=128):
        """``(images, rows)`` groups of the sampled requests."""
        out = []
        for a in range(0, len(self.kept), group):
            part = self.kept[a:a + group]
            rows = torch.from_numpy(np.stack([f.result() for _, f in part]))
            out.append((self.dequantised([i for i, _ in part]), rows))
        return out
