"""The port stands alone and never falls back quietly to the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from compute_engine_tpu_torch.core import BConv2DParams, Padding
from compute_engine_tpu_torch.core.transforms import OutputTransform
from compute_engine_tpu_torch.kernels import _build, residual
from compute_engine_tpu_torch.kernels import bgemm as bgemm_mod
from compute_engine_tpu_torch.models import (convert_model, init_model,
                                             packed_apply, tiny_quicknet)
from compute_engine_tpu_torch.runtime import Interpreter
from compute_engine_tpu_torch.runtime.benchmark import benchmark_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import compute_engine_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "compute_engine_tpu",
                                    "tensorflow", "keras", "PIL"))
print(len(names), bad)
print(sorted(names))
"""


NEW_MODULES = ["converter.cli", "converter.graph_import",
               "converter.keras_import", "ops.detection", "runtime.evaluate",
               "runtime.health", "runtime.serving", "utils", "utils.native",
               "utils.profiling", "kernels.debug", "parallel",
               "parallel.mesh", "parallel.sharding", "parallel.collective",
               "parallel.partition", "runtime.distributed_serving",
               "runtime.multiprocess", "scripts", "scripts.accuracy_fixtures",
               "scripts.baseline_matrix", "scripts.section_profile",
               "scripts.tp_scaling_report", "examples", "examples.e2e_smoke",
               "runtime.compiled", "kernels.counts"]


def test_port_imports_no_jax():
    """Every module of the port (and chip_smoke.py) imports neither jax nor
    the JAX package, nor TensorFlow or PIL, which the importers and the
    directory loader import inside the functions that need them. A
    subprocess, since this process has them loaded."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    counts, names = out.stdout.strip().splitlines()
    n_modules, bad = counts.split(" ", 1)
    assert int(n_modules) >= 32
    assert bad.strip() == "[]"
    for name in NEW_MODULES:
        assert f"'compute_engine_tpu_torch.{name}'" in names, name


@pytest.mark.parametrize("name", [
    "FloatBuilder", "CalibrateBuilder", "ConvertBuilder", "PackedBuilder",
    "Int8Tensor", "float_apply", "calibrate_model", "convert_model"])
def test_models_export_the_int8_pipeline(name):
    """The names the JAX package's ``models`` exports for the int8 pipeline,
    each defined in the port's own builder module."""
    import compute_engine_tpu_torch.models as models

    assert name in models.builder.__all__
    assert getattr(models, name).__module__ == (
        "compute_engine_tpu_torch.models.builder")


def test_port_sources_name_no_jax_import():
    """No source of the port, chip_smoke.py included, has an import of jax
    or of the JAX package (the subprocess test above shows it at run time;
    this one also reaches imports inside functions)."""
    import ast

    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "compute_engine_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) >= 35
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not {"jax", "jaxlib", "compute_engine_tpu"} & set(roots), (
                path, node.lineno)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_chip_smoke_fails_without_card():
    _no_card()
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_raise_without_card():
    _no_card()
    spec = tiny_quicknet(num_classes=4)
    layers = convert_model(spec, init_model(spec, seed=0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Interpreter(spec, layers)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        packed_apply(spec, layers, np.zeros((1, 32, 32, 3), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmark_model(spec, batch=1)
    with pytest.raises(ValueError, match="no CPU mode"):
        benchmark_model(spec, batch=1, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmark_model(spec, batch=1, int8_pipeline=True)
    with pytest.raises(ValueError, match="no CPU mode"):
        benchmark_model(spec, batch=1, int8_pipeline=True, device="cpu")


def test_tools_raise_without_card():
    """The tools and the example run on the card by default and raise
    without one: none measures the CPU in its place."""
    _no_card()
    from compute_engine_tpu_torch.examples import e2e_smoke
    from compute_engine_tpu_torch.scripts import (accuracy_fixtures,
                                                  baseline_matrix,
                                                  section_profile,
                                                  tp_scaling_report)

    spec = tiny_quicknet(num_classes=4)
    for call in (lambda: baseline_matrix.bench_config(spec, 1),
                 lambda: baseline_matrix.bench_serving(spec),
                 lambda: section_profile.profile(1),
                 lambda: tp_scaling_report.dp_scaling(spec),
                 lambda: tp_scaling_report.tp_modes(),
                 lambda: e2e_smoke.run(),
                 lambda: accuracy_fixtures.train_model("quicknet")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_cli_calibration_and_serving_raise_without_card(tmp_path):
    """The CLI's calibration, and an engine over an interpreter on the card,
    raise without a card: neither runs its batches on the CPU instead."""
    _no_card()
    from compute_engine_tpu_torch.converter.cli import main
    from compute_engine_tpu_torch.runtime.serving import ServingEngine

    out = tmp_path / "q.npz"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--model", "quicknet_small", "--output", str(out),
              "--int8-calib-batches", "1"])
    assert not out.exists()
    spec = tiny_quicknet(num_classes=4)
    layers = convert_model(spec, init_model(spec, seed=0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(Interpreter(spec, layers), batch_size=2)

    calls = []

    class OnTheCard:
        """Stands for an interpreter on the card (which cannot be built
        here): the engine must stage its batch for that device or fail."""
        device = torch.device("cuda")

        def __call__(self, x):
            calls.append(x.device)
            return x

    with ServingEngine(OnTheCard(), batch_size=2, max_delay_ms=1) as eng:
        fut = eng.submit(np.zeros((4, 4, 3), np.float32))
        with pytest.raises(Exception):  # torch's own, from the device
            fut.result(timeout=30)
    assert calls == []  # no batch reached infer_fn from the CPU
    assert eng.stats.batches == 0


def _block_args(device):
    c = 32
    x = torch.zeros((1, 4, 4, c), device=device)
    pf = torch.zeros((c, 3, 3, 1), dtype=torch.int32, device=device)
    tr = OutputTransform(multiplier=np.ones(c, np.float32),
                         bias=np.zeros(c, np.float32))
    params = BConv2DParams(channels_in=c, padding=Padding.SAME, pad_value=1)
    return x, pf, tr, params


def test_cuda_wrapper_refuses_cpu_tensors():
    """The launch path takes CUDA tensors or raises: it never runs the plain
    version in the kernel's place, and counts nothing."""
    x, pf, tr, _ = _block_args("cpu")
    before = residual.binary_residual_block.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        residual._launch(x, pf, tr, has_residual=True)
    assert residual.binary_residual_block.launches == before


def test_wrapper_has_no_fallback_for_other_devices():
    x, pf, tr, params = _block_args("meta")
    with pytest.raises(ValueError, match="no residual block kernel"):
        residual.binary_residual_block(x, pf, tr, params)


def test_cpu_tensors_take_the_plain_version_without_counting():
    x, pf, tr, params = _block_args("cpu")
    before = residual.binary_residual_block.launches
    got = residual.binary_residual_block(x, pf, tr, params)
    want = residual.binary_residual_block_plain(x, pf, tr, params)
    assert torch.equal(got, want)
    assert residual.binary_residual_block.launches == before


def test_build_lists_repo_sources_and_fails_loudly(monkeypatch, tmp_path):
    assert {"residual_block", "bgemm"} <= set(_build.sources())
    assert _build.BUILD_DIR == os.path.join(REPO, "compute_engine_tpu_torch",
                                            "build")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "compute_engine_tpu_torch/build/" in f.read().split()
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(OSError):
        _build.load("residual_block")
    assert os.listdir(tmp_path) == []  # no half-written library is left
    failing = tmp_path / "failing-nvcc"
    failing.write_text("#!/bin/sh\necho 'error: no card here'\nexit 1\n")
    failing.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(failing))
    with pytest.raises(RuntimeError, match="(?s)nvcc failed.*no card here"):
        _build.build_all()
    assert os.listdir(tmp_path) == ["failing-nvcc"]


def _gemm_args(device):
    lhs = torch.zeros((3, 2), dtype=torch.int32, device=device)
    rhs = torch.zeros((2, 5), dtype=torch.int32, device=device)
    return lhs, rhs


def _gemm_counts():
    return bgemm_mod.bgemm.launches, bgemm_mod.bgemm.splitk_launches


@pytest.mark.parametrize("max_block_kw", [1024, 1])
def test_bgemm_launch_refuses_cpu_tensors(max_block_kw):
    lhs, rhs = _gemm_args("cpu")
    before = _gemm_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        bgemm_mod._launch(lhs, rhs, None, None, None, 0, 0, "accum",
                          max_block_kw)
    assert _gemm_counts() == before


@pytest.mark.parametrize("out_kind", ["accum", "bitpacked"])
def test_bgemm_cpu_tensors_take_the_plain_version_without_counting(out_kind):
    lhs, rhs = _gemm_args("cpu")
    thr = np.zeros(5, np.int32)
    before = _gemm_counts()
    for max_block_kw in (1024, 1):  # one pass or split-K on the card
        got = bgemm_mod.bgemm(lhs, rhs, thresholds=thr, out_kind=out_kind,
                              max_block_kw=max_block_kw)
        want = bgemm_mod.bgemm_plain(lhs, rhs, thresholds=thr,
                                     out_kind=out_kind)
        assert torch.equal(got, want)
    assert _gemm_counts() == before


def test_bgemm_has_no_fallback_for_other_devices():
    lhs, rhs = _gemm_args("meta")
    with pytest.raises(ValueError, match="no bgemm kernel"):
        bgemm_mod.bgemm(lhs, rhs, out_kind="accum")


def test_multi_device_entry_points_raise_without_card(tmp_path):
    """A mesh, a sharded interpreter and a multi-host server default to the
    visible cards and raise without one; a worker asked for the card raises
    rather than run on the CPU."""
    _no_card()
    from compute_engine_tpu_torch.converter import save_artifact
    from compute_engine_tpu_torch.parallel import make_mesh
    from compute_engine_tpu_torch.runtime.distributed_serving import (
        MultiHostServer, ShardedInterpreter)
    from compute_engine_tpu_torch.runtime.multiprocess import launch_workers

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((2, 1), devices=["cuda:0", "cuda:0"])
    spec = tiny_quicknet(num_classes=4)
    layers = convert_model(spec, init_model(spec, seed=0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedInterpreter(spec, layers, tp=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiHostServer(spec, layers)
    artifact = str(tmp_path / "t.npz")
    save_artifact(artifact, layers, spec.name)
    procs, outs = launch_workers(1, artifact=artifact,
                                 model="tiny:32,64:1,1:4:32",
                                 out_dir=str(tmp_path))
    stdout, _ = procs[0].communicate(timeout=120)
    assert procs[0].returncode != 0
    assert b"no CUDA device" in stdout
    assert not os.path.exists(outs[0])
