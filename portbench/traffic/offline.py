"""Offline batches: one caller runs ``Interpreter.__call__`` back to back.

Parameters (the workload file's ``params``):
  batch   images a call
  pool    distinct float32 batches, made on the device from the seed
          (``images.py``) and used in turn (images decoded on the card, as
          NVIDIA DALI does)
  sample  calls whose logits the check compares, a uniform sample of the
          window's calls drawn from the seed

Each call's logits are brought to the host (``.cpu()``) before the next
call. ``images_per_s`` is the images of every call of the window over the
window's seconds, the window ending with the call that crosses
``seconds``.
"""

from __future__ import annotations

import time

from portbench import images, system
from portbench.stats import Reservoir


class Traffic:
    def __init__(self, config, params, seed, device, tracer, model=None):
        self.batch, self.n_pool = int(params["batch"]), int(params["pool"])
        self.seed, self.tracer = seed, tracer
        self.weights, self.interp, self.setup_steps = system.build(
            config, seed, device, model=model)
        t = time.perf_counter()
        h, w = config["input_size"]
        g = system.generator(seed, "inputs", device)
        self.pool = images.float_images(
            self.n_pool * self.batch, h, w, config["channels"], g,
            device).reshape(self.n_pool, self.batch, h, w, -1)
        self.sample = Reservoir(int(params["sample"]),
                                system.derive(seed, "sample"))
        self.setup_steps["inputs"] = time.perf_counter() - t
        for i in range(self.n_pool):  # compiles the one input shape
            self.interp(self.pool[i]).cpu()
        self.setup_steps["warm_up"] = time.perf_counter() - t - \
            self.setup_steps["inputs"]

    def run(self, seconds):
        tracer, interp, pool = self.tracer, self.interp, self.pool
        calls = 0
        t0 = time.perf_counter()
        while True:
            i = calls % self.n_pool
            with tracer.span("portbench/call"):
                out = interp(pool[i])
                with tracer.span("portbench/to_host"):
                    host = out.cpu()
            calls += 1
            tracer.calls = calls
            self.sample.offer(lambda: (i, host))
            elapsed = time.perf_counter() - t0
            tracer.tick(elapsed)
            if elapsed >= seconds:
                break
        tracer.close()
        images = calls * self.batch
        return {"start": t0, "attempted": images, "failed": 0,
                "forwards": calls,
                "metrics": {"images_per_s": images / elapsed}}

    def free(self):
        """Drops the program's state; the inputs stay for the check."""
        self.interp = None

    def checked(self):
        """``(images, logits)`` groups of the sampled calls: the float32
        images on the device and the logits the calls returned."""
        return [(self.pool[i], host) for i, host in self.sample.items]
