"""Nothing under ``portbench/`` imports JAX or the JAX package, and the
references and counts import nothing of the port either: each import's
top-level name (the part before the first dot) is compared whole, since
the port's name begins with the JAX package's. The CPU-sized models
(``tiny/``) build the port's models and may import it."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import harness, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "compute_engine_tpu"}
PORT = "compute_engine_tpu_torch"


def _modules():
    for dirpath, _, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".", 1)[0]


MODULES = sorted(_modules())


@pytest.mark.parametrize("path", MODULES,
                         ids=[os.path.relpath(p, spec.HERE) for p in MODULES])
def test_no_forbidden_import(path):
    names = set(_imports(path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    rel = os.path.relpath(path, spec.HERE)
    if rel.startswith(("reference", "counts")):
        assert PORT not in names and "portbench" in names | {"portbench"}
        assert names <= {"__future__", "contextlib", "math", "torch",
                         "portbench"}, names


def test_the_scan_sees_every_module():
    rels = {os.path.relpath(p, spec.HERE) for p in MODULES}
    assert {"run.py", "harness.py", os.path.join("reference", "plain.py"),
            os.path.join("traffic", "open_loop.py"),
            os.path.join("tiny", "quicknet.py")} <= rels


def test_loaded_forbidden_compares_whole_names():
    assert harness.loaded_forbidden([PORT, f"{PORT}.models", "numpy"]) == []
    assert harness.loaded_forbidden(["jax.numpy", "compute_engine_tpu.ops",
                                     "flax"]) == [
        "compute_engine_tpu", "flax", "jax"]


def test_run_without_a_card_fails_and_prints_nothing():
    root = spec.ROOT
    proc = subprocess.run(
        [sys.executable, os.path.join("portbench", "run.py"), "--workload",
         "quicknet-offline-b128", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=root, capture_output=True, text=True,
        timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_a_run_of_the_port_loads_no_jax():
    """Importing the harness and the port, and building a tiny system,
    loads neither JAX nor the JAX package."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "from portbench import harness, system, check;"
        "from portbench.tests.conftest import tiny;"
        "cfg, model = tiny('quicknet');"
        "system.build(cfg, 1, 'cpu', model=model);"
        "print(harness.loaded_forbidden())")
    proc = subprocess.run([sys.executable, "-c", code, spec.ROOT],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
