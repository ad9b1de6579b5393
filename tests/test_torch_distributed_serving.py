"""Multi-host serving composition of the port on eight ``cpu`` slots,
against the JAX package on its 8-device CPU mesh: sharded inference,
continuous batching, and health-driven re-sharding
(``tests/test_distributed_serving.py``'s two cases).

Tolerance: the port's output against JAX's within ``FLOAT32_MODEL_TOL`` with
equal top-1 (the float layers of the two packages round in different
places)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from compute_engine_tpu.models import convert_model as jconvert
from compute_engine_tpu.models import init_model as jinit
from compute_engine_tpu.models import tiny_quicknet as jtiny_quicknet
from compute_engine_tpu.runtime.distributed_serving import (
    MultiHostServer as JMultiHostServer,
    ShardedInterpreter as JShardedInterpreter,
)

from compute_engine_tpu_torch.models import (convert_model, init_model,
                                             packed_apply, tiny_quicknet)
from compute_engine_tpu_torch.runtime.distributed_serving import (
    MultiHostServer, ShardedInterpreter)

import _torch_parity as parity

TINY = dict(section_filters=(32,), section_blocks=(1,), num_classes=5,
            input_size=16)


def _artifacts():
    spec, jspec = tiny_quicknet(**TINY), jtiny_quicknet(**TINY)
    layers = convert_model(spec, init_model(spec, seed=7, randomize_bn=True))
    jlayers = jconvert(jspec, jinit(jspec, seed=7, randomize_bn=True))
    return spec, jspec, layers, jlayers


def test_sharded_interpreter_matches_jax():
    spec, jspec, layers, jlayers = _artifacts()
    x = parity.images(42, 8, size=(16, 16))
    jwant = np.asarray(JShardedInterpreter(
        jspec, jlayers, dp=4, tp=2, compute_dtype=jnp.float32)(x))
    interp = ShardedInterpreter(spec, layers, dp=4, tp=2,
                                compute_dtype=torch.float32,
                                devices=["cpu"] * 8)
    assert interp.data_parallelism == 4
    assert interp.mesh.shape == {"data": 4, "model": 2}
    got = interp(x)
    parity.assert_outputs_close(got, jwant, **parity.FLOAT32_MODEL_TOL)
    want = packed_apply(spec, layers, x, compute_dtype=torch.float32,
                        device="cpu")
    parity.assert_outputs_close(got, want, atol=1e-5)


def test_multihost_server_end_to_end():
    """Serve, lose a host (its heartbeat backdated past the timeout),
    re-shard onto the survivor, keep serving, recover: in both packages,
    with the same requests and the same answers."""
    spec, jspec, layers, jlayers = _artifacts()
    rng = np.random.default_rng(42)
    imgs = [rng.normal(0, 1, (16, 16, 3)).astype(np.float32)
            for _ in range(12)]
    jdevs = jax.devices()
    jhosts = {"h0": jdevs[:4], "h1": jdevs[4:]}
    hosts = {"h0": ["cpu"] * 4, "h1": ["cpu"] * 4}
    results = {}
    for name, cls, host_devices, dtype in (
            ("jax", JMultiHostServer, jhosts, jnp.float32),
            ("port", MultiHostServer, hosts, torch.float32)):
        with cls(spec if name == "port" else jspec,
                 layers if name == "port" else jlayers,
                 host_devices=host_devices, tp=1, batch_size=8,
                 max_delay_ms=20, heartbeat_timeout_s=3600,
                 compute_dtype=dtype) as server:
            outs = [f.result(timeout=30)
                    for f in [server.submit(im) for im in imgs]]
            assert all(o.shape == (5,) for o in outs)

            server.monitor.heartbeat("h0")
            server.monitor._last_seen["h1"] = server.monitor._clock() - 7200
            server.monitor.check_now()
            assert server.monitor.alive_hosts() == ["h0"]
            assert server.reshard_count >= 1
            assert server._interp.mesh.devices.size == 4
            after = server.predict(imgs[0], timeout=30)

            server.monitor.heartbeat("h1")
            server.monitor.check_now()
            assert server._interp.mesh.devices.size == 8
            assert not server.degraded
        results[name] = (np.stack(outs), after)
    parity.assert_outputs_close(results["port"][0], results["jax"][0],
                                **parity.FLOAT32_MODEL_TOL)
    parity.assert_outputs_close(results["port"][1][None],
                                results["jax"][1][None],
                                **parity.FLOAT32_MODEL_TOL)
