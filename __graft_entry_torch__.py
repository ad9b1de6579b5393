"""Entry points of the PyTorch port: the flagship forward and a dry run over
several device slots, the counterparts of ``__graft_entry__.py``'s
``entry`` and ``dryrun_multichip``.

Both run on the card unless ``device="cpu"`` is asked for, and raise
without one. Nothing here imports JAX or the JAX package.

    python3 -c "import __graft_entry_torch__ as g; fn, (x,) = g.entry(); \\
        print(fn(x).shape); g.dryrun_multichip(2)"
"""

import threading
import time

import numpy as np
import torch

TINY_FILTERS = (64, 128)
TINY_CLASSES = 16
TINY_SIZE = 32


def entry(device="cuda"):
    """(fn, example_args): the port's QuickNet forward, ``kernel="auto"``,
    random weights from seed 0 (``randomize_bn=True``), and a zeros batch
    (8, 224, 224, 3) float32 on the device. ``fn`` is an ``Interpreter``:
    on the card the compiled forward (one CUDA graph per input shape and
    dtype, as JAX's forward is jittable), on the CPU the eager one."""
    from compute_engine_tpu_torch.models import (convert_model, get_model,
                                                 init_model)
    from compute_engine_tpu_torch.runtime import Interpreter

    spec = get_model("quicknet")
    layers = convert_model(spec, init_model(spec, seed=0, randomize_bn=True))
    fn = Interpreter(spec, layers, kernel="auto", device=device)
    x = torch.zeros((8, 224, 224, 3), dtype=torch.float32, device=fn.device)
    return fn, (x,)


def tiny_spec():
    """The dry run's tiny QuickNet: filters (64, 128), one block a section,
    16 classes, 32x32 inputs."""
    from compute_engine_tpu_torch.models.zoo import (ModelSpec,
                                                     _quicknet_forward)

    def tiny(b, x):
        return _quicknet_forward(b, x, section_filters=TINY_FILTERS,
                                 section_blocks=(1, 1),
                                 num_classes=TINY_CLASSES)

    return ModelSpec("tiny_quicknet_dryrun", tiny,
                     input_size=(TINY_SIZE, TINY_SIZE),
                     num_classes=TINY_CLASSES)


def mesh_shape(n_devices):
    """(dp, tp) of the dry run over ``n_devices`` slots, as JAX's."""
    dp = max(n_devices // 2, 1)
    return dp, n_devices // dp


def sharded_step(spec, layers, slots, compute_dtype=torch.bfloat16):
    """One forward of ``spec`` over a (dp, tp) mesh of ``slots`` through
    ``ShardedInterpreter`` (``kernel="auto"``) on a batch of 2 * dp normal
    draws from seed 0: returns the interpreter and the output on the CPU."""
    from compute_engine_tpu_torch.parallel import make_mesh
    from compute_engine_tpu_torch.runtime.distributed_serving import (
        ShardedInterpreter)

    dp, tp = mesh_shape(len(slots))
    mesh = make_mesh((dp, tp), devices=slots)
    interp = ShardedInterpreter(spec, layers, mesh=mesh, kernel="auto",
                                compute_dtype=compute_dtype)
    x = np.random.default_rng(0).normal(
        0, 1, (2 * dp, TINY_SIZE, TINY_SIZE, 3)).astype(np.float32)
    return interp, interp(x).cpu()


def dryrun_multichip(n_devices, device="cuda", compute_dtype=torch.bfloat16):
    """Run the inference step over ``n_devices`` slots on tiny shapes, as
    JAX's dry run does: distinct cards where the visible ones cover them,
    else the first card (or the CPU) repeated (``device_slots``).

    * the tiny QuickNet through ``ShardedInterpreter`` at dp = max(n // 2,
      1), tp = n // dp (on four cards case C at (2, 2): NCCL, one graph per
      card);
    * the three ``tp_bconv2d`` modes over one "model" axis of every slot,
      held ``torch.equal`` to one another;
    * a ``MultiHostServer`` that re-shards when host "b"'s heartbeat lapses
      and keeps answering.

    Returns what ran: the mesh, the case, the output and the reshards."""
    from compute_engine_tpu_torch.models import convert_model, init_model
    from compute_engine_tpu_torch.parallel.mesh import device_slots

    slots, where = device_slots(n_devices, device)
    spec = tiny_spec()
    layers = convert_model(spec, init_model(spec, seed=0, randomize_bn=True))
    interp, out = sharded_step(spec, layers, slots, compute_dtype)
    dp, tp = mesh_shape(n_devices)
    assert out.shape == (2 * dp, TINY_CLASSES), out.shape
    assert bool(torch.isfinite(out).all())
    result = {"slots": where, "mesh": (dp, tp), "case": interp.case,
              "plan": interp.plan, "out": out}
    del interp
    result["tp_modes"] = _dryrun_tp_modes(slots)
    result["reshards"] = _dryrun_serving_reshard(slots)
    return result


def _dryrun_tp_modes(slots):
    """The three TP modes (gather / sharded / pipelined) of ``tp_bconv2d``
    over one "model" axis spanning every slot, from quantized inputs through
    the exact integer conv ("mxu"): the three results equal. Returns their
    shape."""
    from compute_engine_tpu_torch.core import BConv2DParams, Padding, bitpack
    from compute_engine_tpu_torch.core.transforms import fuse_output_transform
    from compute_engine_tpu_torch.ops import quantize
    from compute_engine_tpu_torch.parallel import make_mesh, tp_bconv2d

    n_devices = len(slots)
    rng = np.random.default_rng(1)
    c_in, c_out = 32, 32 * n_devices  # divisible by every axis size
    n = 2 * n_devices
    xf = rng.normal(0, 1, (n, 8, 8, c_in)).astype(np.float32)
    pf = bitpack(torch.from_numpy(
        rng.choice([-1.0, 1.0], (c_out, 3, 3, c_in)).astype(np.float32)))
    tr = fuse_output_transform(
        rng.uniform(0.1, 2.0, c_out).astype(np.float32),
        rng.uniform(-1, 1, c_out).astype(np.float32), 9 * c_in)
    params = BConv2DParams(channels_in=c_in, stride=(1, 1),
                           padding=Padding.SAME, pad_value=1)
    mesh = make_mesh((1, n_devices), devices=slots)
    home = slots[0]
    xq = quantize(torch.from_numpy(xf).to(home))
    pf = pf.to(home)
    results = {mode: tp_bconv2d(xq, pf, tr, params, mesh,
                                output_kind="float", kernel="mxu",
                                mode=mode).join(home)
               for mode in ("gather", "sharded", "pipelined")}
    assert torch.equal(results["gather"], results["sharded"])
    assert torch.equal(results["gather"], results["pipelined"])
    assert bool(torch.isfinite(results["gather"]).all())
    return tuple(results["gather"].shape)


def _dryrun_serving_reshard(slots):
    """Serve through ``MultiHostServer`` (``ShardedInterpreter`` and
    continuous batching) over hosts "a" and "b", let "b"'s heartbeat lapse,
    and check that the server re-shards onto "a"'s slots and keeps
    answering. Returns the reshards counted."""
    from compute_engine_tpu_torch.models import (convert_model, init_model,
                                                 tiny_quicknet)
    from compute_engine_tpu_torch.runtime.distributed_serving import (
        MultiHostServer)

    spec = tiny_quicknet(section_filters=(32, 64), section_blocks=(1, 1),
                         num_classes=TINY_CLASSES, input_size=TINY_SIZE)
    layers = convert_model(spec, init_model(spec, seed=0, randomize_bn=True))
    half = max(len(slots) // 2, 1)
    host_devices = {"a": slots[:half], "b": slots[half:] or slots[:1]}
    img = np.random.default_rng(0).normal(
        0, 1, (TINY_SIZE, TINY_SIZE, 3)).astype(np.float32)
    # A global batch of 8 divides every dp the server can land on.
    with MultiHostServer(spec, layers, host_devices=host_devices, tp=1,
                         batch_size=8, max_delay_ms=5.0,
                         heartbeat_timeout_s=0.5) as srv:
        b_alive, stop = threading.Event(), threading.Event()
        b_alive.set()

        def pump():
            while not stop.wait(0.05):
                srv.monitor.heartbeat("a")
                if b_alive.is_set():
                    srv.monitor.heartbeat("b")

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        try:
            out = srv.predict(img, timeout=300)
            assert np.isfinite(out).all() and out.shape == (TINY_CLASSES,)
            dp0 = srv._interp.data_parallelism
            # Host "b" dies. Gate on the state after the loss, not a bare
            # count: a long capture can starve the pump and cause a
            # transient lapse of both hosts and a recovery first.
            base = srv.reshard_count
            b_alive.clear()
            deadline = time.monotonic() + 60
            while ((srv.monitor.alive_hosts() != ["a"]
                    or srv.reshard_count <= base)
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            assert srv.reshard_count > base, \
                "host loss did not trigger re-shard"
            assert srv.monitor.alive_hosts() == ["a"]
            out2 = srv.predict(img, timeout=300)
            assert np.isfinite(out2).all()
            assert srv._interp.data_parallelism <= dp0
            return srv.reshard_count
        finally:
            stop.set()
            t.join(timeout=2)
