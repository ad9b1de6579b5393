"""Multi-process execution of the port on ``torch.distributed`` (Gloo on
the CPU), against the JAX package: real OS processes form one process group,
each runs its slice of the global batch, and every process must hold the
whole single-process result; and a worker's death, seen through
``ProcessLivenessSource``, re-shards a ``MultiHostServer``
(``tests/test_multiprocess.py``'s two cases; the JAX two-process run is
marked slow there, so JAX's side here is its single-process forward).

Tolerances: within ``FLOAT32_MODEL_TOL`` with equal top-1 of JAX's
``packed_apply``; within 1e-5 of the port's single-process forward
(``tests/test_multiprocess.py:53``)."""

import subprocess
import sys
import time

import numpy as np
import torch

import jax.numpy as jnp

from compute_engine_tpu.models import convert_model as jconvert
from compute_engine_tpu.models import init_model as jinit
from compute_engine_tpu.models import packed_apply as japply
from compute_engine_tpu.models import tiny_quicknet as jtiny_quicknet

from compute_engine_tpu_torch.converter import save_artifact
from compute_engine_tpu_torch.models import (convert_model, init_model,
                                             packed_apply, tiny_quicknet)
from compute_engine_tpu_torch.runtime.health import ProcessLivenessSource

import _torch_parity as parity


def test_two_process_sharded_inference(tmp_path):
    """Two real processes, Gloo, a batch of 8 split across them, each
    splitting its half over two slots of its CPU."""
    from compute_engine_tpu_torch.runtime.multiprocess import launch_workers

    tiny = dict(section_filters=(32, 64), section_blocks=(1, 1),
                num_classes=16, input_size=32)
    spec = tiny_quicknet(**tiny)
    layers = convert_model(spec, init_model(spec, seed=0, randomize_bn=True))
    artifact = str(tmp_path / "tiny.npz")
    save_artifact(artifact, layers, spec.name)

    procs, outs = launch_workers(
        2, artifact=artifact, model="tiny:32,64:1,1:16:32",
        out_dir=str(tmp_path), batch=8, seed=0, local_device_count=2,
        device="cpu")
    for p in procs:
        stdout, _ = p.communicate(timeout=120)
        assert p.returncode == 0, stdout.decode()
        assert b"gloo on cpu" in stdout

    x = np.random.default_rng(0).normal(0, 1, (8, 32, 32, 3)).astype(
        np.float32)
    want = packed_apply(spec, layers, x, compute_dtype=torch.float32,
                        device="cpu")
    jspec = jtiny_quicknet(**tiny)
    jlayers = jconvert(jspec, jinit(jspec, seed=0, randomize_bn=True))
    jwant = np.asarray(japply(jspec, jlayers, jnp.asarray(x),
                              compute_dtype=jnp.float32))
    for out in outs:
        got = np.load(out)
        parity.assert_outputs_close(got, want, atol=1e-5, rtol=1e-5)
        parity.assert_outputs_close(got, jwant, **parity.FLOAT32_MODEL_TOL)


def test_worker_death_triggers_loss_and_reshard():
    """Kill a worker process mid-serving: the liveness source stops pumping
    its heartbeats, the monitor fires a loss event, and the server re-shards
    onto the survivors while it goes on answering."""
    from compute_engine_tpu_torch.runtime.distributed_serving import (
        MultiHostServer)

    spec = tiny_quicknet((32,), (1,), num_classes=8, input_size=32)
    layers = convert_model(spec, init_model(spec, seed=1, randomize_bn=True))
    host_devices = {"h0": ["cpu"] * 2, "h1": ["cpu"] * 2}

    workers = {h: subprocess.Popen([sys.executable, "-c",
                                    "import time; time.sleep(600)"])
               for h in host_devices}
    server = MultiHostServer(spec, layers, host_devices=host_devices,
                             batch_size=4, heartbeat_timeout_s=0.6,
                             compute_dtype=torch.float32)
    source = ProcessLivenessSource(server.monitor, workers,
                                   poll_interval_s=0.05)
    try:
        x = np.random.default_rng(42).normal(0, 1, (32, 32, 3)).astype(
            np.float32)
        probs = server.predict(x, timeout=60)
        assert probs.shape == (8,)
        assert server.monitor.alive_hosts() == ["h0", "h1"]
        assert server._interp.mesh.devices.size == 4
        before = server.reshard_count

        workers["h1"].kill()
        workers["h1"].wait(timeout=10)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and server.monitor.is_alive("h1"):
            time.sleep(0.05)
        assert not server.monitor.is_alive("h1"), \
            "worker death never became a loss event"
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and server.reshard_count == before:
            time.sleep(0.05)
        assert server.reshard_count > before
        assert not server.degraded

        again = server.predict(x, timeout=60)
        np.testing.assert_allclose(again, probs, atol=1e-6)
        # The rebuilt mesh holds only the surviving host's slots.
        assert server._interp.mesh.devices.size == 2
    finally:
        source.close()
        server.close()
        for w in workers.values():
            if w.poll() is None:
                w.kill()
                w.wait(timeout=10)
