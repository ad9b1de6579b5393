"""One synchronous caller, one host image a call: the direct library call.

Parameters (the workload file's ``params``):
  batch   images a call (1: LCE's own users' call)
  pool    distinct uint8 images on the host, made from the seed
          (``images.py``)
  scale   the dequantisation scale (zero point 0): the ``Interpreter``
          takes uint8 with ``input_scale``
  sample  calls whose logits the check compares, drawn from the seed

The caller sends the pool's images in an order drawn from the seed and
takes each call's logits back with ``.cpu()`` before the next call. A
call's latency runs from the moment it is made to its logits on the host;
the percentiles are over every call of the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import images, system
from portbench.stats import Reservoir, percentile


class Traffic:
    def __init__(self, config, params, seed, device, tracer, model=None):
        self.batch = int(params["batch"])
        self.seed, self.tracer, self.device = seed, tracer, device
        self.scale = float(params["scale"])
        self.weights, self.interp, self.setup_steps = system.build(
            config, seed, device, input_scale=self.scale, model=model)
        t = time.perf_counter()
        h, w = config["input_size"]
        g = system.generator(seed, "inputs", device)
        self.pool = images.uint8_images(
            int(params["pool"]) * self.batch, h, w, config["channels"], g,
            device).reshape(-1, self.batch, h, w,
                            config["channels"]).cpu().numpy()
        self.order = np.random.default_rng(system.derive(seed, "order")) \
            .permutation(len(self.pool))
        self.sample = Reservoir(int(params["sample"]),
                                system.derive(seed, "sample"))
        self.setup_steps["inputs"] = time.perf_counter() - t
        for _ in range(3):  # compiles the one input shape
            self.interp(self.pool[0]).cpu()
        self.setup_steps["warm_up"] = time.perf_counter() - t - \
            self.setup_steps["inputs"]

    def run(self, seconds):
        tracer, interp, pool, order = (self.tracer, self.interp, self.pool,
                                       self.order)
        latency = []
        calls = 0
        t0 = time.perf_counter()
        while True:
            i = int(order[calls % len(order)])
            start = time.perf_counter()
            with tracer.span("portbench/call"):
                out = interp(pool[i])
                with tracer.span("portbench/to_host"):
                    host = out.cpu()
            end = time.perf_counter()
            latency.append((end - start) * 1e3)
            calls += 1
            tracer.calls = calls
            self.sample.offer(lambda: (i, host))
            tracer.tick(end - t0)
            if end - t0 >= seconds:
                break
        tracer.close()
        return {"start": t0, "attempted": calls * self.batch, "failed": 0,
                "forwards": calls,
                "metrics": {"latency_p50_ms": percentile(latency, 50),
                            "latency_p95_ms": percentile(latency, 95)}}

    def free(self):
        self.interp = None

    def checked(self):
        """``(images, logits)`` of the sampled calls, the images dequantised
        as the configuration states, float32 on the device."""
        scale = torch.tensor(self.scale, dtype=torch.float32)
        return [(torch.from_numpy(self.pool[i]).to(self.device)
                 .to(torch.float32) * scale, host)
                for i, host in self.sample.items]
