#!/usr/bin/env bash
# CI entry point of the port: a compile check, the port's tests on the CPU
# (each against the JAX package), and the card's drive when a card is listed.
#
# Usage: compute_engine_tpu_torch/scripts/ci.sh [--gpu]
#   --gpu makes the card stage required: without a card the run fails.
set -euo pipefail
cd "$(dirname "$0")/../.."
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"

echo "== compile check =="
python -m compileall -q compute_engine_tpu_torch chip_smoke.py

echo "== the port's tests (CPU) =="
JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py -q

echo "== the card =="
if nvidia-smi -L 2>/dev/null | grep -q '^GPU '; then
    python3 chip_smoke.py
elif [[ "${1:-}" == "--gpu" ]]; then
    echo "ERROR: --gpu asked for, but nvidia-smi lists no card" >&2
    exit 1
else
    echo "(no card listed: skipped)"
fi
echo "CI OK"
