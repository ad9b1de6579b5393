"""Multi-process distributed execution on ``torch.distributed``: the
counterpart of ``compute_engine_tpu.runtime.multiprocess``
(``jax.distributed``).

N real OS processes form one process group and run the same packed-
inference program, each on its slice of a global batch, and every process
ends with the whole result, which must equal single-process execution. On
the card a rank takes ``cuda:<rank % cards>`` and the group uses NCCL; on
the CPU (``--device cpu``) the group uses Gloo, so the flow runs without a
card. Without a card and without ``--device cpu`` a worker raises: it never
carries on on the CPU. NCCL puts one rank on each card; two ranks on one
card take Gloo, with their outputs staged through the host for the gather.

Each rank's forward is compiled on the card, as JAX jits the worker's
forward: ``Interpreter`` (one CUDA graph per batch shape) or, with
``--local-device-count``, ``ShardedInterpreter`` over the rank's slots; the
``all_gather`` of the outputs stays outside the graphs.

``worker_main`` is the per-process entry (also
``python -m compute_engine_tpu_torch.runtime.multiprocess``);
``launch_workers`` spawns a local N-process group of them.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

__all__ = ["initialize_worker", "worker_main", "launch_workers",
           "free_port"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_worker(coordinator: str, num_processes: int, process_id: int,
                      device: str = "cuda", backend: str | None = None):
    """Join the process group at ``coordinator`` ("host:port") and return
    this rank's device: ``cuda:<process_id % cards>`` (raises without a
    card) or the CPU. ``backend`` defaults to NCCL on the card and Gloo on
    the CPU."""
    import torch
    import torch.distributed as dist

    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return dev


def _spec(model):
    from ..models.zoo import get_model, tiny_quicknet

    if model.startswith("tiny:"):
        _, filters, blocks, classes, size = model.split(":")
        return tiny_quicknet(
            tuple(int(f) for f in filters.split(",")),
            tuple(int(b) for b in blocks.split(",")),
            num_classes=int(classes), input_size=int(size))
    return get_model(model)


def worker_main(argv=None):
    """Per-process entry: packed inference on this rank's slice of the
    seeded global batch, gathered so that every rank holds the whole result,
    written to ``--out`` (``.npy``)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--local-device-count", type=int, default=None,
                   help="slots of this rank's device over which its slice is "
                        "split further (a (n, 1) mesh); default one")
    p.add_argument("--artifact", required=True)
    p.add_argument("--model", required=True,
                   help="zoo model name, or tiny:<filters>:<blocks>:<classes>"
                        ":<size> for a reduced QuickNet")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="default: nccl on the card, gloo on the CPU")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from ..converter import load_artifact
    from .distributed_serving import ShardedInterpreter
    from .interpreter import Interpreter

    dev = initialize_worker(args.coordinator, args.num_processes,
                            args.process_id, args.device, args.backend)
    try:
        spec = _spec(args.model)
        _, _, layers = load_artifact(args.artifact)
        if args.batch % args.num_processes:
            raise ValueError(f"batch {args.batch} not divisible by "
                             f"{args.num_processes} processes")
        # Every process draws the same global batch and takes its slice.
        rng = np.random.default_rng(args.seed)
        x = rng.normal(0, 1, (args.batch, *spec.input_size, 3)).astype(
            np.float32)
        per = args.batch // args.num_processes
        x_local = torch.from_numpy(
            x[args.process_id * per:(args.process_id + 1) * per]).to(dev)
        if args.local_device_count:
            forward = ShardedInterpreter(
                spec, layers, dp=args.local_device_count,
                compute_dtype=torch.float32,
                devices=[dev] * args.local_device_count)
        else:
            forward = Interpreter(spec, layers, compute_dtype=torch.float32,
                                  device=dev)
        out = forward(x_local)
        # Gloo gathers host tensors: stage a card's output through the host.
        backend = dist.get_backend()
        staged = (out.cpu() if backend == "gloo" else out).contiguous()
        parts = [torch.empty_like(staged) for _ in range(args.num_processes)]
        dist.all_gather(parts, staged)
        result = torch.cat(parts).cpu().numpy()
    finally:
        dist.destroy_process_group()
    np.save(args.out, result)
    print(f"process {args.process_id}: {backend} on {dev}, wrote "
          f"{result.shape} -> {args.out}", flush=True)


def launch_workers(num_processes: int, *, artifact: str, model: str,
                   out_dir: str, batch: int = 8, seed: int = 0,
                   local_device_count: int | None = None, extra_env=None,
                   device: str = "cuda", backend: str | None = None):
    """Spawn a local N-process group of ``worker_main``s.

    Returns (procs, out_paths); callers wait() and load the outputs.
    """
    coordinator = f"127.0.0.1:{free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    if extra_env:
        env.update(extra_env)
    procs, outs = [], []
    for pid in range(num_processes):
        out = os.path.join(out_dir, f"out_{pid}.npy")
        cmd = [sys.executable, "-m",
               "compute_engine_tpu_torch.runtime.multiprocess",
               "--coordinator", coordinator,
               "--num-processes", str(num_processes),
               "--process-id", str(pid),
               "--artifact", artifact, "--model", model,
               "--batch", str(batch), "--seed", str(seed),
               "--out", out, "--device", device]
        if local_device_count:
            cmd += ["--local-device-count", str(local_device_count)]
        if backend:
            cmd += ["--backend", backend]
        procs.append(subprocess.Popen(cmd, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
        outs.append(out)
    return procs, outs


if __name__ == "__main__":
    worker_main()
